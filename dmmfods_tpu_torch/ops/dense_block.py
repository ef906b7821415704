"""A whole dense block in one launch (K4), and a dense block's parameters as
the BN-folded stacks its kernels take: the port of
``dmmfods_tpu/ops/pallas/dense_block.py``.

K4 computes K2's function (:mod:`.dense_block_strip`) with K2's rounding.
It differs in where it runs and how: it serves every batch size on the small
planes of the 128x192 working resolution, and it runs a whole block in one
launch, a thread-block cluster per image looping over the layers
(``csrc/dense_block.cu``) on K2's layer bodies, the bf16 one on the tensor
cores with the weights of :func:`.dense_block_strip.pack_layer_weights`.

* :func:`dense_block` is the wrapper. For a CUDA tensor it launches the
  kernel (or raises); for a CPU tensor it runs the plain version.
* :func:`dense_block_reference` is the plain version, the textbook loop on
  the folded stacks (K2's, the same function). The CPU tests hold it against
  JAX's ``dense_block_pallas`` in interpret mode, and ``chip_smoke.py`` holds
  the kernel against it on the card.
* :func:`pick_group` and :func:`eligible` are JAX's gate, kept as they are
  (the TPU's VMEM budget, its 128-lane alignment and the dtype's bytes), so
  that the port runs K4 on exactly the blocks where the JAX model runs its
  kernel on a TPU; :func:`eligible` adds the kernel's own limits on growth
  and K (:func:`.dense_block_strip.within_limits`: growth <= 48, K <= 192,
  which DenseNet-121's and DenseNet-161's blocks meet). A block past them
  runs the plain loop, by shape.
* :func:`block_plan` mirrors the kernel's launch plan: its tile, its
  clusters and how the bf16 body deals a tile over its warps in the
  block's layout (:func:`.dense_block_strip.layout`). The C entry
  ``dmm_dense_block_plan`` reports the plan the kernel makes, and
  ``chip_smoke.py`` holds the two together.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..tracing import LaunchCount
from .dense_block_strip import (dense_block_strip_reference, layout, run_block_kernel,
                                within_limits)
from .fused import fold_bn

K4_LAUNCHES = LaunchCount()

# JAX's VMEM budget of a sample group (a number of the gate, not of the card)
GROUP_BUDGET_BYTES = 20 * 1024 * 1024

# K4's plain version is K2's: the two kernels compute one function
dense_block_reference = dense_block_strip_reference

# K4's tiles (csrc/dense_block.cu), largest first; its cluster cap (the
# portable cluster size); the layer body's warps
BLOCK_TILES = ((8, 16), (8, 12), (4, 6))
MAX_CLUSTER = 8
WARPS = 8


class BlockPlan(NamedTuple):
    """K4's launch plan for a batch of one plane (:func:`block_plan`)."""

    tile: Tuple[int, int]      # (TH, TW)
    tiles: int                 # tiles an image
    cluster: int               # blocks an image: the cluster
    m16_1x1: int               # the bf16 body's m16 tiles over the tile's halo
    m16_3x3: int               # and over its output pixels, the last padded
    units: int                 # the 3x3's (m16 tile, n8 pair) units
    warp_units: int            # the most of them a warp runs
    smem: int                  # the bf16 kernel's dynamic shared memory, bytes
    warps: Tuple[Tuple[Tuple[int, int], ...], ...]   # each warp's units

    def c_fields(self):
        """The fields ``dmm_dense_block_plan`` reports, in its order."""
        return (*self.tile, self.tiles, self.cluster, self.m16_1x1, self.m16_3x3,
                self.units, self.warp_units, self.smem)


def mma_smem(th, tw, kp=128, gp=32):
    """The bf16 layer body's dynamic shared memory for a ``th`` x ``tw`` tile
    in the padded layout ``(kp, gp)`` (``LayerMma::kSmem`` of
    ``csrc/dense_layer_mma.cuh``): a two-slot ring of the halo's 32-channel
    chunk beside 32 rows of w1 (or four taps of w3, whichever is larger),
    then y2 over the halo; rows padded by 8 bf16."""
    halo = (th + 2) * (tw + 2)
    stage = -(-halo // 16) * 16 * (32 + 8) * 2 + 32 * (kp + 8) * 2
    return max(2 * stage, 4 * kp * (gp + 8) * 2) + halo * (kp + 8) * 2


def block_plan(batch, h, w, sms, growth=32, k=128):
    """K4's launch plan for ``batch`` images of ``h`` x ``w`` with ``growth``
    and bottleneck ``k`` on a card of ``sms`` SMs, as ``csrc/dense_block.cu``
    makes it. The tile is the one of ``BLOCK_TILES`` with the least padded
    halo work (its tiles times the 1x1's M, the halo padded to 16 rows), the
    larger on a tie. The cluster is the most blocks an image, up to
    ``MAX_CLUSTER`` and ``ceil(sms / batch)``, that divide its tiles. The
    3x3's units are (m16 tile, n8 pair of the layout's padded G: two pairs
    at G 32, three at G 48); each warp runs ``warp_units`` of them, all of
    one m16 tile (one A fragment): as few a warp as the 8 warps allow, as
    few warps to a tile as that allows."""
    kp, gp = layout(growth, k)

    def halo_m16(th, tw):
        return -(-(th + 2) * (tw + 2) // 16)

    def tiles_of(th, tw):
        return -(-h // th) * -(-w // tw)

    costs = [tiles_of(th, tw) * 16 * halo_m16(th, tw) for th, tw in BLOCK_TILES]
    th, tw = BLOCK_TILES[costs.index(min(costs))]
    tiles = tiles_of(th, tw)
    want = min(-(-sms // batch), MAX_CLUSTER)
    cluster = next((c for c in range(want, 1, -1) if tiles % c == 0), 1)
    m16_3x3 = -(-th * tw // 16)
    pairs = gp // 16
    units = m16_3x3 * pairs
    warp_units = -(-units // WARPS)
    per_tile = pairs // warp_units            # warps sharing an m16 tile
    warps = tuple(
        tuple((i // per_tile, (i % per_tile) * warp_units + j) for j in range(warp_units))
        if i // per_tile < m16_3x3 else () for i in range(WARPS))
    return BlockPlan((th, tw), tiles, cluster, halo_m16(th, tw), m16_3x3, units,
                     warp_units, mma_smem(th, tw, kp, gp), warps)


def fold_block_params(block):
    """An eval ``DenseBlock``'s layers -> padded, BN-folded stacks, float32.

    Returns a dict of tensors on the block's device, with ``L`` layers,
    ``K = bn_size * growth``, ``C_max = c0 + L * growth``:

      g1, b1: (L, C_max)          folded norm1, zero beyond each layer's width
      w1:     (L, C_max, K)       conv1 as (in, out), zero beyond the width
      g2, b2: (L, K)              folded norm2
      w3:     (L, 3, 3, K, growth) conv2 as (ky, kx, in, out)

    The layouts are the JAX function's, so the two compare directly.
    """
    layers = list(block.children())
    first = layers[0]
    c0 = first.conv1.in_channels
    k = first.conv1.out_channels
    growth = first.conv2.out_channels
    n = len(layers)
    c_max = c0 + n * growth
    device = first.conv1.weight.device
    g1 = torch.zeros(n, c_max, device=device)
    b1 = torch.zeros(n, c_max, device=device)
    w1 = torch.zeros(n, c_max, k, device=device)
    g2 = torch.empty(n, k, device=device)
    b2 = torch.empty(n, k, device=device)
    w3 = torch.empty(n, 3, 3, k, growth, device=device)
    with torch.no_grad():
        for l, layer in enumerate(layers):
            width = c0 + l * growth
            n1, n2 = layer.norm1, layer.norm2
            g1[l, :width], b1[l, :width] = fold_bn(
                n1.weight, n1.bias, n1.running_mean, n1.running_var, n1.eps)
            w1[l, :width] = layer.conv1.weight.reshape(k, width).t()
            g2[l], b2[l] = fold_bn(n2.weight, n2.bias, n2.running_mean,
                                   n2.running_var, n2.eps)
            w3[l] = layer.conv2.weight.permute(2, 3, 1, 0)
    return {"g1": g1, "b1": b1, "w1": w1, "g2": g2, "b2": b2, "w3": w3}


def pick_group(batch, h, w, dtype_bytes=2, *, num_layers, c0, growth, bn_size):
    """JAX's sample group: the smallest G in (1, 2, 4, 8, 16) that divides
    the batch, makes the packed tile ``G * h * w`` a multiple of 128 pixels,
    and fits the buffer, the weights and the activations in
    ``GROUP_BUDGET_BYTES``. None when no G works."""
    r = h * w
    if c0 % 8 != 0 or growth % 8 != 0:
        return None
    k = bn_size * growth
    c_max = c0 + num_layers * growth
    weights = (num_layers * (c_max * k + 9 * k * growth) * dtype_bytes
               + num_layers * (2 * c_max + 2 * k) * 4)
    for g in (1, 2, 4, 8, 16):
        if batch % g != 0 or (g * r) % 128 != 0:
            continue
        rows = g * r
        buf = 2 * c_max * rows * dtype_bytes
        act = rows * max(c_max, k) * dtype_bytes * 3
        if buf + weights + act <= GROUP_BUDGET_BYTES:
            return g
    return None


def eligible(num_layers, c0, growth, bn_size, h, w, dtype_bytes=2, batch=1,
             kernel_limits=True):
    """Whether the block runs as K4: some sample group works (JAX's
    decision) and, with ``kernel_limits`` (the port's), the kernel takes its
    growth and K (:func:`.dense_block_strip.within_limits`)."""
    return ((not kernel_limits or within_limits(growth, bn_size))
            and pick_group(batch, h, w, dtype_bytes, num_layers=num_layers,
                           c0=c0, growth=growth, bn_size=bn_size) is not None)


def dense_block(x, folded, packed=None):
    """The dense block of ``folded`` on ``x``: ``(B, H, W, c0)`` NHWC ->
    ``(B, H, W, C_max)``, ``folded`` as from :func:`fold_block_params`,
    ``packed`` its ``pack_layer_weights`` made beforehand or None (a bf16
    call then packs).

    On a CUDA device ``x`` must be a contiguous NHWC tensor in float32 or
    bfloat16 and ``K <= 192``, ``G <= 48``; the whole block is one launch on
    the current stream, and a failure raises. On the CPU the plain version
    runs.
    """
    return run_block_kernel(x, folded, "dmm_dense_block", K4_LAUNCHES, packed)
