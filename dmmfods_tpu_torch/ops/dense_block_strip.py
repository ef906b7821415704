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
  exactly the blocks where the JAX model runs its strip kernels, and
  :func:`eligible` adds the CUDA kernels' own limits (:func:`within_limits`:
  ``growth <= MAX_GROWTH``, ``K <= MAX_BOTTLENECK``), which every DenseNet
  of the repo meets: DenseNet-121, -169 and -201 (growth 32, K 128) in the
  layer bodies' narrow layout, DenseNet-161 (growth 48, K 192) in the wide
  one (``LAYOUTS``). A block past them runs the plain loop, by shape.

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

# The layer bodies' padded (K, G) layouts, narrowest first
# (csrc/dense_layer_tile.cuh: kLayoutK, kLayoutG): a block runs in the
# narrowest that holds its K and growth, and nothing runs past the widest.
# (128, 32) holds DenseNet-121, -169 and -201, (192, 48) DenseNet-161.
LAYOUTS = ((128, 32), (192, 48))
MAX_BOTTLENECK, MAX_GROWTH = LAYOUTS[-1]
# The blocks of a layer body at K5's and K2's 8x16 tile an SM holds, by
# layout and dtype: the tensor-core body (csrc/dense_layer_mma.cuh, bf16)
# two at (128, 32) (97 KB of shared memory) and one at (192, 48) (154 KB),
# the CUDA-core body (csrc/dense_layer_tile.cuh, f32) one (132 / 173 KB)
BLOCKS_PER_SM = {(128, 32): {torch.bfloat16: 2, torch.float32: 1},
                 (192, 48): {torch.bfloat16: 1, torch.float32: 1}}
# K2's bf16 layer kernel (csrc/dense_block_strip.cu): its tile and the
# prefix channels of a chunk
LAYER_TILE = (8, 16)
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


def layout(growth, k):
    """The layer bodies' padded ``(K, G)`` for a block of bottleneck ``k``
    and ``growth``: the first of ``LAYOUTS`` that holds both. Raises past the
    widest."""
    for kp, gp in LAYOUTS:
        if k <= kp and growth <= gp:
            return kp, gp
    raise ValueError(f"the kernels take K <= {MAX_BOTTLENECK} and growth <= {MAX_GROWTH}, "
                     f"got K={k}, growth={growth}")


def within_limits(growth, bn_size):
    """Whether the layer bodies of K2, K4 and K5 take the block (some layout
    holds it): ``growth <= MAX_GROWTH`` and ``K = bn_size * growth <=
    MAX_BOTTLENECK``."""
    return growth <= MAX_GROWTH and bn_size * growth <= MAX_BOTTLENECK


def eligible(batch, h, w, c0, growth, num_layers, bn_size, dtype_bytes=2, carry=False,
             kernel_limits=True):
    """JAX's gate of its strip kernels: batch 1, ``c0`` and ``growth``
    multiples of 8, ``w`` a multiple of 16 (bf16) or 8, and a strip height
    from :func:`pick_rs_carry` (``carry``, K2) or :func:`pick_rs` (K5); with
    ``kernel_limits`` (the port's decision) also the kernels' own limits
    (:func:`within_limits`), without it JAX's decision alone."""
    picker = pick_rs_carry if carry else pick_rs
    return (batch == 1 and c0 % 8 == 0 and growth % 8 == 0
            and (not kernel_limits or within_limits(growth, bn_size))
            and w % (16 if dtype_bytes == 2 else 8) == 0
            and picker(h, num_layers, w, c0, growth, bn_size * growth,
                       dtype_bytes) is not None)


def plan_strips(h, w, num_layers, sms, blocks_per_sm):
    """K5's geometry on a card of ``sms`` SMs whose layer body fits
    ``blocks_per_sm`` blocks an SM (``BLOCKS_PER_SM`` of the layout and
    dtype):
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
    """The bf16 kernels' (K2, K4, K5) w1 and w3 from ``folded``'s, in the
    layout ``(KP, GP)`` of the block (:func:`layout`): ``w1`` ``(L, C_max,
    K)`` -> ``(L, cp, KP)`` with ``cp`` = C_max rounded up to
    ``LAYER_CHUNK``, ``w3`` ``(L, 3, 3, K, G)`` -> ``(L, 9, KP, GP)``, in
    bf16 with zeros in the padding: every chunk of 32 rows is in bounds, and
    K and G are the tensor-core tiles' multiples. DenseNet-121's blocks pack
    to ``(L, cp, 128)`` and ``(L, 9, 128, 32)``, DenseNet-161's to ``(L, cp,
    192)`` and ``(L, 9, 192, 48)``. Raises past the widest layout."""
    w1, w3 = folded["w1"], folded["w3"]
    n, c_max, k = w1.shape
    growth = w3.shape[-1]
    kp, gp = layout(growth, k)
    cp = -(-c_max // LAYER_CHUNK) * LAYER_CHUNK
    w1p = w1.new_zeros(n, cp, kp)
    w1p[:, :c_max, :k] = w1
    w3p = w3.new_zeros(n, 9, kp, gp)
    w3p[:, :, :k, :growth] = w3.reshape(n, 9, k, growth)
    return w1p.to(torch.bfloat16), w3p.to(torch.bfloat16)


def layer_plan(h, w, sms, growth=32, k=128):
    """K2's bf16 launch plan for an ``h`` x ``w`` plane on a card of ``sms``
    SMs: ``(tiles, waves)``, its 8x16 tiles a layer and their waves of the
    blocks of the layout of ``(k, growth)`` an SM holds (``BLOCKS_PER_SM``)
    on each SM."""
    rows, cols = LAYER_TILE
    tiles = -(-h // rows) * -(-w // cols)
    return tiles, tiles / (sms * BLOCKS_PER_SM[layout(growth, k)][torch.bfloat16])


def dense_block_strip(x, folded, packed=None):
    """K2: the dense block of ``folded`` on ``x`` (see the module docstring).

    On a CUDA device ``x`` must be a contiguous NHWC tensor in float32 or
    bfloat16 and ``K <= 192``, ``G <= 48`` (``MAX_BOTTLENECK``,
    ``MAX_GROWTH``); the kernels launch on the current stream and a failure
    raises. On the CPU the plain version runs.
    """
    return run_block_kernel(x, folded, "dmm_dense_block_strip", K2_LAUNCHES, packed)


def _check_packed(folded, packed):
    """Raise unless ``packed`` is ``pack_layer_weights(folded)``'s layout."""
    n, c_max, k = folded["w1"].shape
    kp, gp = layout(folded["w3"].shape[-1], k)
    want = ((n, -(-c_max // LAYER_CHUNK) * LAYER_CHUNK, kp), (n, 9, kp, gp))
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
    per_sm = BLOCKS_PER_SM[layout(growth, k)][x.dtype]
    rows, strips, blocks = plan_strips(h, w, num_layers, sms, per_sm)
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
    layout(growth, k)                       # raises past the widest layout

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
