"""A whole dense block in one launch (K4), and a dense block's parameters as
the BN-folded stacks its kernels take: the port of
``dmmfods_tpu/ops/pallas/dense_block.py``.

K4 computes K2's function (:mod:`.dense_block_strip`) with K2's rounding.
It differs in where it runs and how: it serves every batch size on the small
planes of the 128x192 working resolution, and it runs a whole block in one
launch, a thread-block cluster per image looping over the layers
(``csrc/dense_block.cu``).

* :func:`dense_block` is the wrapper. For a CUDA tensor it launches the
  kernel (or raises); for a CPU tensor it runs the plain version.
* :func:`dense_block_reference` is the plain version, the textbook loop on
  the folded stacks (K2's, the same function). The CPU tests hold it against
  JAX's ``dense_block_pallas`` in interpret mode, and ``chip_smoke.py`` holds
  the kernel against it on the card.
* :func:`pick_group` and :func:`eligible` are JAX's gate, kept as they are
  (the TPU's VMEM budget, its 128-lane alignment and the dtype's bytes), so
  that the port runs K4 on exactly the blocks where the JAX model runs its
  kernel on a TPU. The CUDA kernel itself takes any block shape; this gate
  is a choice of where to use it, not a limit of it.
"""

from __future__ import annotations

import torch

from .dense_block_strip import dense_block_strip_reference, run_block_kernel
from .fused import LaunchCount, fold_bn

K4_LAUNCHES = LaunchCount()

# JAX's VMEM budget of a sample group (a number of the gate, not of the card)
GROUP_BUDGET_BYTES = 20 * 1024 * 1024

# K4's plain version is K2's: the two kernels compute one function
dense_block_reference = dense_block_strip_reference


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


def eligible(num_layers, c0, growth, bn_size, h, w, dtype_bytes=2, batch=1):
    """Whether the block runs as K4: some sample group works."""
    return pick_group(batch, h, w, dtype_bytes, num_layers=num_layers,
                      c0=c0, growth=growth, bn_size=bn_size) is not None


def dense_block(x, folded):
    """The dense block of ``folded`` on ``x``: ``(B, H, W, c0)`` NHWC ->
    ``(B, H, W, C_max)``, ``folded`` as from :func:`fold_block_params`.

    On a CUDA device ``x`` must be a contiguous NHWC tensor in float32 or
    bfloat16 and ``K <= 128``, ``G <= 32``; the whole block is one launch on
    the current stream, and a failure raises. On the CPU the plain version
    runs.
    """
    return run_block_kernel(x, folded, "dmm_dense_block", K4_LAUNCHES)
