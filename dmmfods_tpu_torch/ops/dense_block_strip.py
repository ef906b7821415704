"""A whole dense block at inference on a batch-1 plane, two ways: the port
of ``dmmfods_tpu/ops/pallas/dense_block_strip.py``, which holds both.

For each layer ``l`` (``width = c0 + l * G``), with BN folded:

    act = ReLU(feats[..., :width] * g1 + b1)          in the activation dtype
    y2  = ReLU((act @ w1) * g2 + b2)                  in the activation dtype
    feats = cat(feats, conv3x3(y2, w3, zero padding))

* :func:`dense_block_strip` (K2, the counterpart of JAX's
  ``dense_block_strip_carry``) is the wrapper of ``csrc/dense_block_strip.cu``:
  the block's output buffer is allocated once and each of the L layer
  launches writes its slab into it, so no concat is ever copied. In bfloat16
  its layers run on the tensor cores, with w1 and w3 laid out by
  :func:`pack_layer_weights` (as K4's and K5's bf16 kernels take them too).
* :func:`dense_block_strip_recompute` (K5, the counterpart of JAX's
  ``dense_block_strip``) is the wrapper of ``csrc/dense_block_recompute.cu``:
  the same function in one launch, the plane cut into independent row
  strips (:func:`plan_strips`) that recompute their halo, on K2's layer
  bodies and tile.
* :func:`dense_block_strip_reference` is the plain PyTorch version of both,
  the textbook loop on the folded stacks. The CPU tests hold it against the
  JAX kernels (interpret mode), and ``chip_smoke.py`` holds the kernels
  against it on the card.
* :func:`pick_rs_carry`, :func:`pick_rs` and :func:`eligible` are JAX's gate
  of its two strip kernels, kept as they are (the TPU's VMEM budget, its
  16-column tiling and the dtype's bytes) so that the port runs K2 and K5 on
  exactly the blocks where the JAX model runs its strip kernels. They say
  nothing about the card; the CUDA kernels take any block shape.

For a CUDA tensor the wrappers launch their kernel (or raise); for a CPU
tensor they run the plain version. All take ``x`` as ``(B, H, W, c0)`` NHWC
(K5: ``B = 1``), ``folded`` as returned by
:func:`.dense_block.fold_block_params` and optionally ``packed``, the bf16
kernels' ``pack_layer_weights(folded)`` made beforehand (the eval
``DenseBlock`` keeps it beside its folded stacks; without it a bf16 call
packs), and return ``(B, H, W, C_max)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .fused import _DTYPE_CODES, LaunchCount

K2_LAUNCHES = LaunchCount()
K5_LAUNCHES = LaunchCount()

# the kernels' shared-memory plan (csrc/dense_layer_tile.cuh: kKMax, kGMax)
MAX_BOTTLENECK = 128
MAX_GROWTH = 32
# The blocks of a layer body an SM holds: the tensor-core body
# (csrc/dense_layer_mma.cuh, bf16) two, the CUDA-core body
# (csrc/dense_layer_tile.cuh, f32) one
BLOCKS_PER_SM = {torch.bfloat16: 2, torch.float32: 1}
# K2's bf16 layer kernel (csrc/dense_block_strip.cu): its tile, the blocks
# of it an SM holds, and the prefix channels of a chunk
LAYER_TILE = (8, 16)
LAYER_BLOCKS_PER_SM = BLOCKS_PER_SM[torch.bfloat16]
LAYER_CHUNK = 32
# K5's output tile (csrc/dense_block_recompute.cu: kTH, kTW), K2's
TILE_ROWS, TILE_COLS = LAYER_TILE

# JAX's VMEM budget of a strip (a number of the gate, not of the card)
STRIP_BUDGET_BYTES = 90 * 1024 * 1024

_KEYS = ("g1", "b1", "w1", "g2", "b2", "w3")


def _shapes(x, folded):
    """``(L, c0, growth, K, c_max)`` after checking every operand."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, c0), got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be one of {list(_DTYPE_CODES)}, got {x.dtype}")
    missing = [k for k in _KEYS if k not in folded]
    if missing:
        raise ValueError(f"folded lacks {missing}")
    w3 = folded["w3"]
    if w3.dim() != 5 or tuple(w3.shape[1:3]) != (3, 3):
        raise ValueError(f"w3 must be (L, 3, 3, K, G), got {tuple(w3.shape)}")
    n, _, _, k, growth = w3.shape
    c0 = x.shape[-1]
    c_max = c0 + n * growth
    want = {"g1": (n, c_max), "b1": (n, c_max), "w1": (n, c_max, k),
            "g2": (n, k), "b2": (n, k)}
    for name, shape in want.items():
        if tuple(folded[name].shape) != shape:
            raise ValueError(f"{name} must be {shape} for c0={c0}, got "
                             f"{tuple(folded[name].shape)}")
    for name in _KEYS:
        if folded[name].dtype != torch.float32:
            raise TypeError(f"folded {name} must be float32, got {folded[name].dtype}")
        if folded[name].device != x.device:
            raise ValueError(f"folded {name} is on {folded[name].device}, x on {x.device}")
    return n, c0, growth, k, c_max


def dense_block_strip_reference(x, folded):
    """The plain version: the layer loop with ``torch.cat``, computed in
    ``x``'s dtype, rounding where the kernel rounds (``act``, ``y2`` and each
    new slab). In f32 it is exact up to summation order; the kernel keeps
    ``y1`` in f32 where this version, in bf16, rounds it once."""
    n, c0, growth, k, _ = _shapes(x, folded)
    dt = x.dtype
    feats = x.permute(0, 3, 1, 2)                       # NCHW view
    for l in range(n):
        width = c0 + l * growth
        g1 = folded["g1"][l, :width, None, None]
        b1 = folded["b1"][l, :width, None, None]
        act = torch.relu(feats.float() * g1 + b1).to(dt)
        w1 = folded["w1"][l, :width].t().reshape(k, width, 1, 1).to(dt)
        y1 = F.conv2d(act, w1)
        y2 = torch.relu(y1.float() * folded["g2"][l, :, None, None]
                        + folded["b2"][l, :, None, None]).to(dt)
        w3 = folded["w3"][l].permute(3, 2, 0, 1).to(dt)  # (G, K, 3, 3)
        feats = torch.cat([feats, F.conv2d(y2, w3, padding=1)], dim=1)
    return feats.permute(0, 2, 3, 1).contiguous()


def pick_rs_carry(h, num_layers, w, c0, growth, k, dtype_bytes=2):
    """JAX's strip height for its carry kernel: the first RS of (64, 48, 40,
    32, 24, 20, 16, 8) that divides ``h``, is at least ``L + 2`` and fits its
    working set in ``STRIP_BUDGET_BYTES``; None when none does."""
    c_max = c0 + num_layers * growth
    for rs in (64, 48, 40, 32, 24, 20, 16, 8):
        if h % rs != 0 or rs < num_layers + 2:
            continue
        r = (rs + num_layers + 2) * w
        r2 = (rs + 2) * w
        buf = r * c_max * dtype_bytes
        act = r2 * c_max * 4
        y1 = r2 * k * 4
        y2cat = r2 * 3 * k * dtype_bytes
        ctr = r2 * 3 * growth * 4
        io = (rs * w * c0 + rs * w * c_max) * dtype_bytes
        weights = num_layers * (c_max * k + 3 * k * 3 * growth) * dtype_bytes
        if buf + act + y1 + y2cat + ctr + io + weights <= STRIP_BUDGET_BYTES:
            return rs
    return None


def pick_rs(h, num_layers, w, c0, growth, k, dtype_bytes=2):
    """JAX's strip height for its recompute kernel: the first RS of (64, 48,
    40, 32, 24, 20, 16, 8) that divides ``h``, is at least ``L`` and fits
    its window of ``RS + 2 L`` rows in ``STRIP_BUDGET_BYTES``; None when
    none does."""
    c_max = c0 + num_layers * growth
    for rs in (64, 48, 40, 32, 24, 20, 16, 8):
        if h % rs != 0 or rs < num_layers:
            continue
        r = (rs + 2 * num_layers) * w
        buf = r * c_max * dtype_bytes
        act = r * c_max * 4
        y1 = r * k * 4
        y2cat = r * 3 * k * dtype_bytes
        ctr = r * 3 * growth * 4
        io = (3 * rs * w * c0 + 2 * rs * w * c_max) * dtype_bytes
        weights = num_layers * (c_max * k + 3 * k * 3 * growth) * dtype_bytes
        if buf + act + y1 + y2cat + ctr + io + weights <= STRIP_BUDGET_BYTES:
            return rs
    return None


def eligible(batch, h, w, c0, growth, num_layers, bn_size, dtype_bytes=2, carry=False):
    """JAX's gate of its strip kernels: batch 1, ``c0`` and ``growth``
    multiples of 8, ``w`` a multiple of 16 (bf16) or 8, and a strip height
    from :func:`pick_rs_carry` (``carry``, K2) or :func:`pick_rs` (K5)."""
    picker = pick_rs_carry if carry else pick_rs
    return (batch == 1 and c0 % 8 == 0 and growth % 8 == 0
            and w % (16 if dtype_bytes == 2 else 8) == 0
            and picker(h, num_layers, w, c0, growth, bn_size * growth,
                       dtype_bytes) is not None)


def plan_strips(h, w, num_layers, sms, blocks_per_sm):
    """K5's geometry on a card of ``sms`` SMs whose layer body fits
    ``blocks_per_sm`` blocks an SM (``BLOCKS_PER_SM`` of the dtype):
    ``(rows, strips, blocks)``.

    Two strips of ``ceil(h / 2)`` rows rounded up to the tile's 8 (one strip
    where the plane is a single tile row), run by ``blocks`` blocks of one
    cooperative launch, all resident at once (at most ``blocks_per_sm`` an
    SM) and none without a tile of the first layer, shared out evenly over
    the strips. Halo rows are the only extra work, so the fewest strips pay
    the least; one strip over the whole plane would be K4's whole-image
    schedule with a barrier across the grid.
    """
    half = -(-h // 2)
    rows = max(TILE_ROWS, -(-half // TILE_ROWS) * TILE_ROWS)
    strips = -(-h // rows)
    first_layer_tiles = (-(-min(rows + 2 * (num_layers - 1), h) // TILE_ROWS)
                         * -(-w // TILE_COLS))
    return rows, strips, min(sms * blocks_per_sm, strips * first_layer_tiles)


def pack_layer_weights(folded):
    """The bf16 kernels' (K2, K4, K5) w1 and w3 from ``folded``'s: ``w1``
    ``(L, C_max, K)`` -> ``(L, cp, 128)`` with ``cp`` = C_max rounded up to
    ``LAYER_CHUNK``, ``w3`` ``(L, 3, 3, K, G)`` -> ``(L, 9, 128, 32)``, in
    bf16 with zeros in the padding: every chunk of 32 rows is in bounds, and
    K and G are the tensor-core tiles' multiples."""
    w1, w3 = folded["w1"], folded["w3"]
    n, c_max, k = w1.shape
    growth = w3.shape[-1]
    cp = -(-c_max // LAYER_CHUNK) * LAYER_CHUNK
    w1p = w1.new_zeros(n, cp, MAX_BOTTLENECK)
    w1p[:, :c_max, :k] = w1
    w3p = w3.new_zeros(n, 9, MAX_BOTTLENECK, MAX_GROWTH)
    w3p[:, :, :k, :growth] = w3.reshape(n, 9, k, growth)
    return w1p.to(torch.bfloat16), w3p.to(torch.bfloat16)


def layer_plan(h, w, sms):
    """K2's bf16 launch plan for an ``h`` x ``w`` plane on a card of ``sms``
    SMs: ``(tiles, waves)``, its 8x16 tiles a layer and their waves of
    ``LAYER_BLOCKS_PER_SM`` blocks on each SM."""
    rows, cols = LAYER_TILE
    tiles = -(-h // rows) * -(-w // cols)
    return tiles, tiles / (sms * LAYER_BLOCKS_PER_SM)


def dense_block_strip(x, folded, packed=None):
    """K2: the dense block of ``folded`` on ``x`` (see the module docstring).

    On a CUDA device ``x`` must be a contiguous NHWC tensor in float32 or
    bfloat16 and ``K <= 128``, ``G <= 32``; the kernels launch on the current
    stream and a failure raises. On the CPU the plain version runs.
    """
    return run_block_kernel(x, folded, "dmm_dense_block_strip", K2_LAUNCHES, packed)


def _check_packed(folded, packed):
    """Raise unless ``packed`` is ``pack_layer_weights(folded)``'s layout."""
    n, c_max, _ = folded["w1"].shape
    want = ((n, -(-c_max // LAYER_CHUNK) * LAYER_CHUNK, MAX_BOTTLENECK),
            (n, 9, MAX_BOTTLENECK, MAX_GROWTH))
    for name, t, shape in zip(("w1", "w3"), packed, want):
        if (tuple(t.shape) != shape or t.dtype != torch.bfloat16
                or t.device != folded["w1"].device or not t.is_contiguous()):
            raise ValueError(f"packed {name} must be a contiguous bfloat16 {shape} on "
                             f"{folded['w1'].device}, got a {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")


def dense_block_strip_recompute(x, folded, packed=None):
    """K5: the dense block of ``folded`` on a batch-1 ``x`` as independent
    strips that recompute their halo, in one launch (see the module
    docstring). The same operands and limits as :func:`dense_block_strip`,
    with ``B = 1``; on the CPU the plain version runs."""
    if x.dim() == 4 and x.shape[0] != 1:
        raise ValueError(f"K5 runs a batch-1 plane, got x {tuple(x.shape)}")
    return run_block_kernel(x, folded, "dmm_dense_block_recompute", K5_LAUNCHES, packed,
                            scratch=_recompute_scratch)


def _recompute_scratch(x, num_layers, c0, growth, k, c_max):
    """K5's trailing arguments: the strips' private halo rows (L above and L
    below each strip) and their barrier counters, then the strip height and
    the grid, planned for ``x``'s card and dtype."""
    _, h, w, _ = x.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    rows, strips, blocks = plan_strips(h, w, num_layers, sms, BLOCKS_PER_SM[x.dtype])
    halo = torch.empty((strips, 2 * num_layers, w, c_max), dtype=x.dtype, device=x.device)
    arrive = torch.empty(strips, dtype=torch.int32, device=x.device)
    return halo, arrive, rows, blocks


def run_block_kernel(x, folded, entry, count, packed=None, scratch=None):
    """What K2, K4 and K5 share around their kernels: check the operands,
    take the plain version on the CPU, else allocate the output buffer,
    launch the C entry point ``entry`` of the kernel library on the current
    stream, raise on its error and add one to ``count``. ``packed`` is the
    bf16 kernels' w1 and w3 made beforehand, or None; ``scratch``, where
    given, maps ``(x, L, c0, G, K, C_max)`` to the arguments that follow the
    common ones (tensors, passed by pointer, and ints)."""
    n, c0, growth, k, c_max = _shapes(x, folded)
    if packed is not None:
        _check_packed(folded, packed)
    if x.device.type == "cpu":
        return dense_block_strip_reference(x, folded)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be a contiguous NHWC tensor")
    if k > MAX_BOTTLENECK or growth > MAX_GROWTH:
        raise ValueError(f"the kernel takes K <= {MAX_BOTTLENECK} and growth <= "
                         f"{MAX_GROWTH}, got K={k}, growth={growth}")

    from . import _build

    lib = _build.load()
    bsz, h, w, _ = x.shape
    out = torch.empty((bsz, h, w, c_max), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    ops = {name: folded[name].contiguous() for name in ("g1", "b1", "g2", "b2")}
    if x.dtype != torch.bfloat16:
        w1, w3 = folded["w1"].contiguous(), folded["w3"].contiguous()
    else:
        w1, w3 = packed if packed is not None else pack_layer_weights(folded)
    with torch.cuda.device(x.device):
        extra = scratch(x, n, c0, growth, k, c_max) if scratch else ()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, entry)(
            x.data_ptr(), out.data_ptr(), ops["g1"].data_ptr(), ops["b1"].data_ptr(),
            w1.data_ptr(), ops["g2"].data_ptr(), ops["b2"].data_ptr(), w3.data_ptr(),
            bsz, h, w, c0, n, growth, k, _DTYPE_CODES[x.dtype], stream,
            *(a.data_ptr() if torch.is_tensor(a) else a for a in extra))
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {rc}")
    count.add()
    return out
