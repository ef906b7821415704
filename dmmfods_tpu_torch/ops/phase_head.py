"""The heat-map head: K3, the counterpart of
``dmmfods_tpu/ops/pallas/phase_head.py::phase_space_head_strip``, and the
phase-space head of ``dmmfods_tpu/ops/fused.py`` in plain PyTorch.

    a      = ReLU(cat(up2(x_lo), raw) * g0 + b0)      in the activation dtype
    h      = ReLU(conv3x3(a, w0) * g1 + b1)            in the activation dtype
    logits = conv5x5(h, w1)

with ``up2`` the nearest 2x upsample and BN folded into ``(g, b)``.

* :func:`phase_head` is K3's wrapper. For a CUDA tensor it runs the
  hand-written kernel ``csrc/phase_head.cu`` (or raises), which never writes
  the upsample, the concat or the mid tensor to device memory and runs
  refine0 in phase space, with the weights of :func:`kernel_weights`:
  :func:`fold_phase_head_weights`'s in f32 for float32 activations (CUDA
  cores), and for bfloat16 the same rounded once to bf16 and laid out for
  the tensor cores by :func:`pack_phase_head_weights`. For a CPU tensor it
  runs the plain version.
* :func:`phase_head_reference` is K3's plain PyTorch version from the same
  folded constants. The CPU tests hold it against the JAX strip head, and
  ``chip_smoke.py`` holds the kernel against it on the card.

Both take ``x_lo`` ``(B, H/2, W/2, c_up)`` and ``raw`` ``(B, H, W, rc)``
NHWC, ``w0`` ``(c_mid, c_up + rc, 3, 3)`` and ``w1`` ``(n_cls, c_mid, 5, 5)``
in torch's order, and return ``(B, H, W, n_cls)`` logits in ``x_lo``'s dtype.

The phase-space head (no kernel; JAX's eval ``phase_space_head``) runs the
same head at low resolution, on NCHW tensors as the model holds them: BN0 +
ReLU of ``x_lo`` at low resolution and of ``raw`` at full, ``raw``
space-to-depth'd, refine0 as one 2x2 conv into the window grid ``P`` (``(B,
4 c_mid, hh + 1, hw + 1)``, the four output phases stacked on the channels:
:func:`phase_head_conv0`), then BN1 + ReLU over each phase's slice of ``P``
and refine1 as a 3x3 conv over each slice, summed (:func:`phase_head_refine1`,
JAX's ``slices`` form, which on the H100 beat its ``single`` form:
``PERF.md``), and a depth-to-space of the logits alone.
:func:`phase_space_weights` folds refine0 and refine1 into that form.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..tracing import LaunchCount
from .fused import _DTYPE_CODES

K3_LAUNCHES = LaunchCount()

# The bf16 kernel's layouts (csrc/phase_head.cu tc::HeadLayout), picked by
# shape, the first that takes it: (source channels c_up + 4 rc rounded up to
# 16, mid channels padded, mid channels a pass). DenseNet-121's head takes the
# first, DenseNet-161's (c_mid 96, source 208) the second, in two passes of
# 48 mid channels over the resident source.
LAYOUTS_BF16 = ((192, 64, 64), (256, 96, 48))
# c_mid and the bf16 source at most the widest layout's (the float32 kernel,
# csrc/phase_head.cu phase_head_kernel, takes the same c_mid); classes at
# most kNCMax
MAX_MID = LAYOUTS_BF16[-1][1]
MAX_SOURCE_BF16 = LAYOUTS_BF16[-1][0]
MAX_CLASSES = 8
# the kernels' output tiles (rows, columns): bf16 tc::kTH, tc::kTW; float32
# kTH, kTW. Each tile stages all of refine0's weights once.
TILE_BF16 = (16, 32)
TILE_F32 = (8, 16)

# the 3x3 taps dy of the upsampled input that land on low-res window row r
# for output phase u: {(u, r): dy}, as dmmfods_tpu/ops/fused.py::_COLLAPSE
_COLLAPSE = {(0, 0): (-1,), (0, 1): (0, 1), (1, 0): (-1, 0), (1, 1): (1,)}


def bf16_layout(c_src, c_mid):
    """The bf16 kernel's layout for a source of ``c_src`` channels and
    ``c_mid`` mid channels (an entry of ``LAYOUTS_BF16``), None if no layout
    takes it."""
    cp = -(-c_src // 16) * 16
    return next((lay for lay in LAYOUTS_BF16 if cp <= lay[0] and c_mid <= lay[1]), None)


def within_limits(c_src, c_mid, n_cls, dtype):
    """Whether K3 takes a head of this shape in ``dtype``: c_mid <=
    ``MAX_MID``, at most ``MAX_CLASSES`` classes and, in bfloat16, a layout
    for the source."""
    if c_mid > MAX_MID or n_cls > MAX_CLASSES:
        return False
    return dtype != torch.bfloat16 or bf16_layout(c_src, c_mid) is not None


# taps of a 3x3 (or 5x5) kernel as 3 (dy + 1) + dx + 1 (5 (dy + 2) + dx + 2);
# the index one past the last is a zero tap
def _refine0_taps():
    """The taps each entry of the phase-space refine0 weight gathers, for
    window tap (r, s) and output phase p, in that order: the upsampled
    part's (JAX's sum order, padded with the zero tap to four) and the raw
    part's per raw phase ph."""
    up, raw = [], []
    for r in (0, 1):
        for s in (0, 1):
            for p in range(4):
                u, v = divmod(p, 2)
                taps = [3 * (dy + 1) + dx + 1 for dy in _COLLAPSE[(u, r)]
                        for dx in _COLLAPSE[(v, s)]]
                up.append(taps + [9] * (4 - len(taps)))
                for ph in range(4):
                    pu, pv = divmod(ph, 2)
                    dy, dx = 2 * r + pu - 2 + u, 2 * s + pv - 2 + v
                    raw.append(3 * (dy + 1) + dx + 1
                               if -1 <= dy <= 1 and -1 <= dx <= 1 else 9)
    return up, raw


def _refine1_taps():
    """The refine1 tap of each entry of the block-space weight, for block
    offset (br, bs), input phase (pu, pv) and output phase (up, vp)."""
    taps = []
    for br in (-1, 0, 1):
        for bs in (-1, 0, 1):
            for pu in (0, 1):
                for pv in (0, 1):
                    for up in (0, 1):
                        for vp in (0, 1):
                            dy, dx = 2 * br + pu - up, 2 * bs + pv - vp
                            taps.append(5 * (dy + 2) + dx + 2
                                        if -2 <= dy <= 2 and -2 <= dx <= 2 else 25)
    return taps


@functools.lru_cache(maxsize=None)
def _taps(name, device):
    """The tap tables as index tensors on ``device``, kept (made outside
    inference mode, so that a fold under autograd may save them)."""
    table = {"refine0": _refine0_taps, "refine1": lambda: (_refine1_taps(),)}[name]()
    with torch.inference_mode(False):
        return tuple(torch.tensor(t, device=device) for t in table)


def fold_phase_head_weights(w0, c_up):
    """refine0 in phase space: the refine0 half of
    ``dmmfods_tpu/ops/fused.py::fold_phase_head_weights``, in f32, summing the
    upsampled part's taps in JAX's order (differentiable in ``w0``).

    ``w0`` is refine0's weight ``(c_mid, c_up + rc, 3, 3)`` (torch order).
    Returns ``w0p`` ``(2, 2, c_up + 4 rc, 4 c_mid)``: a 2x2 window conv over
    the zero-padded low-res grid whose input channels are ``[up | s2d raw]``
    (raw pixel ``(2i + pu, 2j + pv)`` at channels ``c_up + (2 pu + pv) rc``)
    and whose outputs stack the four phases ``p = 2u + v`` of refine0 at full
    resolution. The JAX layout, so the two compare directly.
    """
    c_mid, c_in = w0.shape[:2]
    rc = c_in - c_up
    w = w0.float().permute(2, 3, 1, 0).reshape(9, c_in, c_mid)
    w = torch.cat([w, w.new_zeros(1, c_in, c_mid)])
    up_idx, raw_idx = _taps("refine0", w.device)
    g = w[up_idx.flatten(), :c_up].reshape(16, 4, c_up, c_mid)
    w_up = (g[:, 0] + g[:, 1] + g[:, 2] + g[:, 3]).reshape(2, 2, 4, c_up, c_mid)
    w_raw = w[raw_idx, c_up:].reshape(2, 2, 4, 4, rc, c_mid)    # (r, s, p, ph, k, n)
    w0p = torch.cat([w_up.permute(0, 1, 3, 2, 4),
                     w_raw.permute(0, 1, 3, 4, 2, 5).reshape(2, 2, 4 * rc, 4, c_mid)], dim=2)
    return w0p.reshape(2, 2, c_up + 4 * rc, 4 * c_mid)


def fold_refine1_weights(w1):
    """refine1 in block space: the refine1 half of
    ``dmmfods_tpu/ops/fused.py::fold_phase_head_weights``, in f32
    (differentiable in ``w1``).

    ``w1`` is refine1's weight ``(n_cls, c_mid, 5, 5)`` (torch order).
    Returns ``w1p`` ``(3, 3, 4 c_mid, 4 n_cls)``: a 3x3 conv over the
    low-res grid from the four phases of the mid tensor (input channels
    ``(2 pu + pv) c_mid + c``) to the four phases of the logits (output
    channels ``(2 up + vp) n_cls + n``). The JAX layout."""
    n_cls, c_mid = w1.shape[:2]
    w = w1.float().permute(2, 3, 1, 0).reshape(25, c_mid, n_cls)
    w = torch.cat([w, w.new_zeros(1, c_mid, n_cls)])
    (idx,) = _taps("refine1", w.device)
    w1p = w[idx].reshape(3, 3, 4, 4, c_mid, n_cls).permute(0, 1, 2, 4, 3, 5)
    return w1p.reshape(3, 3, 4 * c_mid, 4 * n_cls)


def phase_space_weights(w0, w1, c_up):
    """The phase-space head's two conv weights, in torch's order and f32,
    from refine0's ``w0`` and refine1's ``w1`` (differentiable in both):

      w0t (4 c_mid, c_up + 4 rc, 2, 2)   :func:`fold_phase_head_weights`'s
          w0p, its raw channels in ``F.pixel_unshuffle``'s order
          (``c_up + 4 k + ph``);
      w4t (4 n_cls, 4 c_mid, 4, 4)       :func:`fold_refine1_weights`'s w1p
          with input phase (pu, pv)'s block at taps ``pu..pu + 2`` x
          ``pv..pv + 2`` (the 4x4 conv of JAX's ``single`` form), its outputs
          in ``F.pixel_shuffle``'s order (``4 n + 2 up + vp``).
    """
    w0p = fold_phase_head_weights(w0, c_up)
    c_src, cm4 = w0p.shape[2:]
    rc = (c_src - c_up) // 4
    raw = w0p[:, :, c_up:].reshape(2, 2, 4, rc, cm4).transpose(2, 3).reshape(2, 2, 4 * rc, cm4)
    w0t = torch.cat([w0p[:, :, :c_up], raw], dim=2).permute(3, 2, 0, 1)
    w1p = fold_refine1_weights(w1)
    n_cls = w1p.shape[-1] // 4
    w4 = w1p.new_zeros(4, 4, 4, cm4 // 4, 4, n_cls)
    w1p = w1p.reshape(3, 3, 4, cm4 // 4, 4, n_cls)
    for pu in (0, 1):
        for pv in (0, 1):
            p = 2 * pu + pv
            w4[pu:pu + 3, pv:pv + 3, p] = w1p[:, :, p]
    w4t = w4.permute(5, 4, 2, 3, 0, 1).reshape(4 * n_cls, cm4, 4, 4)
    return (w0t.contiguous(memory_format=torch.channels_last),
            w4t.contiguous(memory_format=torch.channels_last))


def phase_head_conv0(a, rn, w0t):
    """The window grid ``P`` ``(B, 4 c_mid, hh + 1, hw + 1)`` from the BN0 +
    ReLU'd ``a`` ``(B, c_up, hh, hw)`` at low resolution and ``rn`` ``(B,
    rc, H, W)`` at full (JAX's ``phase_head_conv0``)."""
    src = torch.cat([a, F.pixel_unshuffle(rn, 2).contiguous(
        memory_format=torch.channels_last)], dim=1)
    return F.conv2d(src, w0t.to(a.dtype), padding=1)


def phase_head_refine1(P, g1, b1, w4t, hh, hw):
    """``P`` -> ``(B, n_cls, H, W)`` logits (JAX's ``phase_head_refine1``,
    the ``slices`` form): BN1 (folded, ``(c_mid,)`` f32) + ReLU of each
    phase's slice of ``P`` and a 3x3 conv of it with its block of ``w4t``,
    summed, then the depth-to-space of the logits."""
    dt = P.dtype
    cm = P.shape[1] // 4
    g, b = g1.to(dt)[:, None, None], b1.to(dt)[:, None, None]
    out = None
    for p in range(4):
        pu, pv = divmod(p, 2)
        hp = torch.relu(torch.addcmul(b, P[:, p * cm:(p + 1) * cm, pu:pu + hh, pv:pv + hw], g))
        part = F.conv2d(hp, w4t[:, p * cm:(p + 1) * cm, pu:pu + 3, pv:pv + 3].to(dt),
                        padding=1)
        out = part if out is None else out + part
    return F.pixel_shuffle(out, 2).contiguous(memory_format=torch.channels_last)


def phase_space_head(x_lo, raw, *, g0, b0, g1, b1, w0t, w4t):
    """The eval head in phase space (JAX's ``phase_space_head``): ``x_lo``
    ``(B, c_up, hh, hw)`` and ``raw`` ``(B, rc, 2 hh, 2 hw)`` NCHW, BN folded
    into ``(g0, b0)`` ``(c_up + rc,)`` and ``(g1, b1)`` ``(c_mid,)`` in f32
    and applied in the activation dtype, ``(w0t, w4t)`` from
    :func:`phase_space_weights`. Returns ``(B, n_cls, 2 hh, 2 hw)``."""
    dt = x_lo.dtype
    c_up = x_lo.shape[1]
    hh, hw = x_lo.shape[-2:]
    g0, b0 = g0.to(dt)[:, None, None], b0.to(dt)[:, None, None]
    a = torch.relu(torch.addcmul(b0[:c_up], x_lo, g0[:c_up]))
    rn = torch.relu(torch.addcmul(b0[c_up:], raw, g0[c_up:]))
    return phase_head_refine1(phase_head_conv0(a, rn, w0t), g1, b1, w4t, hh, hw)


def pack_phase_head_weights(w0p, w1):
    """The bf16 kernel's weights: ``w0p`` ``(2, 2, c_src, 4 c_mid)`` from
    :func:`fold_phase_head_weights` (f32) and refine1's ``w1`` ``(n_cls,
    c_mid, 5, 5)`` (torch order) -> ``(w0k, w1k)`` in bf16, zero-padded:

      w0k (4, 4 cp, cmp)   phase p = 2u + v; row (2r + s) cp + c; column n
      w1k (25, cmp, 8)     tap 5 ky + kx; row c; column class

    with ``cp`` = c_src rounded up to 16 and ``cmp`` the mid channels of the
    kernel's layout for the shape (:func:`bf16_layout`: 64, or 96 read in two
    passes of 48 columns). ``w0p`` is rounded to bf16 here, once (the
    kernel's one extra rounding). Raises on a shape no layout takes."""
    _, _, c_src, cm4 = w0p.shape
    c_mid = cm4 // 4
    n_cls = w1.shape[0]
    layout = bf16_layout(c_src, c_mid)
    if layout is None or n_cls > MAX_CLASSES:
        raise ValueError(f"no bf16 layout of K3 takes c_src {c_src}, c_mid {c_mid} and "
                         f"{n_cls} classes (layouts {LAYOUTS_BF16}, classes <= {MAX_CLASSES})")
    cmp = layout[1]
    cp = -(-c_src // 16) * 16
    w0k = w0p.new_zeros(4, 4, cp, cmp)
    w0k[:, :, :c_src, :c_mid] = w0p.reshape(4, c_src, 4, c_mid).permute(2, 0, 1, 3)
    w1k = w1.new_zeros(5, 5, cmp, 8, dtype=torch.float32)
    w1k[:, :, :c_mid, :n_cls] = w1.float().permute(2, 3, 1, 0)
    return (w0k.reshape(4, 4 * cp, cmp).to(torch.bfloat16).contiguous(),
            w1k.reshape(25, cmp, 8).to(torch.bfloat16).contiguous())


def kernel_weights(w0, w1, c_up, dtype):
    """The kernel's refine0 and refine1 weights for activations of
    ``dtype``, from ``w0`` ``(c_mid, c_up + rc, 3, 3)`` and ``w1`` ``(n_cls,
    c_mid, 5, 5)``: refine0 collapsed into phase space in f32 from the
    weights rounded to ``dtype`` (as the plain version uses them), then for
    bfloat16 packed by :func:`pack_phase_head_weights`; for float32 ``w0p``
    and ``w1`` as ``(5, 5, c_mid, n_cls)``. What :func:`phase_head` takes as
    ``weights`` to skip this fold."""
    w0p = fold_phase_head_weights(w0.to(dtype), c_up)
    if dtype == torch.bfloat16:
        return pack_phase_head_weights(w0p, w1.to(dtype))
    return w0p.contiguous(), w1.permute(2, 3, 1, 0).to(dtype).contiguous()


def _shapes(x_lo, raw, g0, b0, w0, g1, b1, w1):
    """``(c_up, rc, c_mid, n_cls)`` after checking every operand."""
    if x_lo.dim() != 4 or raw.dim() != 4:
        raise ValueError(f"x_lo and raw must be NHWC, got {tuple(x_lo.shape)} "
                         f"and {tuple(raw.shape)}")
    bsz, hh, hw, c_up = x_lo.shape
    if tuple(raw.shape[:3]) != (bsz, 2 * hh, 2 * hw):
        raise ValueError(f"raw must be (B, 2 hh, 2 hw, rc) = ({bsz}, {2 * hh}, "
                         f"{2 * hw}, rc), got {tuple(raw.shape)}")
    if x_lo.dtype != raw.dtype or x_lo.dtype not in _DTYPE_CODES:
        raise TypeError(f"x_lo and raw must share a dtype of {list(_DTYPE_CODES)}, "
                        f"got {x_lo.dtype} and {raw.dtype}")
    rc = raw.shape[-1]
    c_in = c_up + rc
    if w0.dim() != 4 or tuple(w0.shape[1:]) != (c_in, 3, 3):
        raise ValueError(f"w0 must be (c_mid, {c_in}, 3, 3), got {tuple(w0.shape)}")
    c_mid = w0.shape[0]
    if w1.dim() != 4 or tuple(w1.shape[1:]) != (c_mid, 5, 5):
        raise ValueError(f"w1 must be (n_cls, {c_mid}, 5, 5), got {tuple(w1.shape)}")
    for name, t, c in (("g0", g0, c_in), ("b0", b0, c_in), ("g1", g1, c_mid),
                       ("b1", b1, c_mid)):
        if tuple(t.shape) != (c,):
            raise ValueError(f"{name} must be ({c},), got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    tensors = (x_lo, raw, g0, b0, w0, g1, b1, w1)
    if any(t.device != x_lo.device for t in tensors):
        raise ValueError("all operands must be on one device, got "
                         f"{sorted({str(t.device) for t in tensors})}")
    return c_up, rc, c_mid, w1.shape[0]


def phase_head_reference(x_lo, raw, *, g0, b0, w0, g1, b1, w1):
    """The plain version: upsample, concat, BN0-ReLU, 3x3, BN1-ReLU, 5x5,
    computed in ``x_lo``'s dtype with the BN folds applied in f32 and
    rounded, as the kernel rounds."""
    _shapes(x_lo, raw, g0, b0, w0, g1, b1, w1)
    dt = x_lo.dtype
    up = F.interpolate(x_lo.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
    x = torch.cat([up, raw.permute(0, 3, 1, 2)], dim=1)
    a = torch.relu(x.float() * g0[:, None, None] + b0[:, None, None]).to(dt)
    mid = F.conv2d(a, w0.to(dt), padding=1)
    h = torch.relu(mid.float() * g1[:, None, None] + b1[:, None, None]).to(dt)
    return F.conv2d(h, w1.to(dt), padding=2).permute(0, 2, 3, 1).contiguous()


def phase_head(x_lo, raw, *, g0, b0, w0, g1, b1, w1, weights=None):
    """The head's logits (see the module docstring).

    On a CUDA device ``x_lo`` and ``raw`` must be contiguous NHWC tensors in
    float32 or bfloat16 within the kernel's limits (:func:`within_limits`:
    ``c_mid <= 96``, ``n_cls <= 8`` and, in bfloat16, ``c_up + 4 rc <=
    256``); the kernel launches on the current stream and a failure raises.
    ``weights``, where given, is :func:`kernel_weights` of ``w0`` and ``w1``
    for ``x_lo``'s dtype, folded beforehand. On the CPU the plain version
    runs.
    """
    c_up, rc, c_mid, n_cls = _shapes(x_lo, raw, g0, b0, w0, g1, b1, w1)
    if x_lo.device.type == "cpu":
        return phase_head_reference(x_lo, raw, g0=g0, b0=b0, w0=w0, g1=g1, b1=b1,
                                    w1=w1)
    if x_lo.device.type != "cuda":
        raise ValueError(f"no kernel for device {x_lo.device}")
    if not (x_lo.is_contiguous() and raw.is_contiguous()):
        raise ValueError("x_lo and raw must be contiguous NHWC tensors")
    dt = x_lo.dtype
    if not within_limits(c_up + 4 * rc, c_mid, n_cls, dt):
        raise ValueError(f"the kernel takes c_mid <= {MAX_MID}, n_cls <= {MAX_CLASSES} and, "
                         f"in bf16, c_up + 4 rc <= {MAX_SOURCE_BF16}; got c_mid {c_mid}, "
                         f"n_cls {n_cls}, c_up + 4 rc {c_up + 4 * rc} in {dt}")

    from . import _build

    lib = _build.load()
    bsz, hh, hw, _ = x_lo.shape
    out = torch.empty((bsz, 2 * hh, 2 * hw, n_cls), dtype=x_lo.dtype,
                      device=x_lo.device)
    if out.numel() == 0:
        return out
    w0k, w1k = weights if weights is not None else kernel_weights(w0, w1, c_up, dt)
    if w0k.dtype != dt or w0k.device != x_lo.device:
        raise ValueError(f"weights must be kernel_weights(w0, w1, c_up, {dt}) on "
                         f"{x_lo.device}, got {w0k.dtype} on {w0k.device}")
    g0, b0, g1, b1 = (t.contiguous() for t in (g0, b0, g1, b1))
    with torch.cuda.device(x_lo.device):
        stream = torch.cuda.current_stream(x_lo.device).cuda_stream
        err = lib.dmm_phase_head(
            x_lo.data_ptr(), raw.data_ptr(), g0.data_ptr(), b0.data_ptr(),
            w0k.data_ptr(), g1.data_ptr(), b1.data_ptr(), w1k.data_ptr(),
            out.data_ptr(), bsz, hh, hw, c_up, rc, c_mid, n_cls,
            _DTYPE_CODES[dt], stream)
    if err != 0:
        raise RuntimeError(f"phase_head kernel launch failed: cudaError {err}")
    K3_LAUNCHES.add()
    return out
