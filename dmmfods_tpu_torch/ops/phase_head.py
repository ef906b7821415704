"""The heat-map head at inference (K3): the counterpart of
``dmmfods_tpu/ops/pallas/phase_head.py::phase_space_head_strip``.

    a      = ReLU(cat(up2(x_lo), raw) * g0 + b0)      in the activation dtype
    h      = ReLU(conv3x3(a, w0) * g1 + b1)            in the activation dtype
    logits = conv5x5(h, w1)

with ``up2`` the nearest 2x upsample and BN folded into ``(g, b)``.

* :func:`phase_head` is the wrapper. For a CUDA tensor it runs the
  hand-written kernel ``csrc/phase_head.cu`` (or raises), which never writes
  the upsample, the concat or the mid tensor to device memory and runs
  refine0 in phase space, with the weights of :func:`kernel_weights`:
  :func:`fold_phase_head_weights`'s in f32 for float32 activations (CUDA
  cores), and for bfloat16 the same rounded once to bf16 and laid out for
  the tensor cores by :func:`pack_phase_head_weights`. For a CPU tensor it
  runs the plain version.
* :func:`phase_head_reference` is the plain PyTorch head from the same
  folded constants. The CPU tests hold it against the JAX strip head, and
  ``chip_smoke.py`` holds the kernel against it on the card.

Both take ``x_lo`` ``(B, H/2, W/2, c_up)`` and ``raw`` ``(B, H, W, rc)``
NHWC, ``w0`` ``(c_mid, c_up + rc, 3, 3)`` and ``w1`` ``(n_cls, c_mid, 5, 5)``
in torch's order, and return ``(B, H, W, n_cls)`` logits in ``x_lo``'s dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .fused import _DTYPE_CODES, LaunchCount

K3_LAUNCHES = LaunchCount()

# the kernel's shared-memory plan (csrc/phase_head.cu: kCMMax, kNCMax; the
# bf16 kernel's tc::kCSrcMax on c_up + 4 rc, a multiple of 16)
MAX_MID = 64
MAX_CLASSES = 8
MAX_SOURCE_BF16 = 192
# the kernels' output tiles (rows, columns): bf16 tc::kTH, tc::kTW; float32
# kTH, kTW. Each tile stages all of refine0's weights once.
TILE_BF16 = (16, 32)
TILE_F32 = (8, 16)

# the 3x3 taps dy of the upsampled input that land on low-res window row r
# for output phase u: {(u, r): dy}, as dmmfods_tpu/ops/fused.py::_COLLAPSE
_COLLAPSE = {(0, 0): (-1,), (0, 1): (0, 1), (1, 0): (-1, 0), (1, 1): (1,)}


def fold_phase_head_weights(w0, c_up):
    """refine0 in phase space: the refine0 half of
    ``dmmfods_tpu/ops/fused.py::fold_phase_head_weights``, in f32.

    ``w0`` is refine0's weight ``(c_mid, c_up + rc, 3, 3)`` (torch order).
    Returns ``w0p`` ``(2, 2, c_up + 4 rc, 4 c_mid)``: a 2x2 window conv over
    the zero-padded low-res grid whose input channels are ``[up | s2d raw]``
    (raw pixel ``(2i + pu, 2j + pv)`` at channels ``c_up + (2 pu + pv) rc``)
    and whose outputs stack the four phases ``p = 2u + v`` of refine0 at full
    resolution. The JAX layout, so the two compare directly.
    """
    w = w0.float().permute(2, 3, 1, 0)               # (3, 3, c_in, c_mid)
    c_mid = w.shape[-1]
    rc = w.shape[2] - c_up
    w_up, w_raw = w[:, :, :c_up], w[:, :, c_up:]
    w0p = w.new_zeros(2, 2, c_up + 4 * rc, 4, c_mid)
    for u in (0, 1):
        for v in (0, 1):
            p = 2 * u + v
            for r in (0, 1):
                for s in (0, 1):
                    w0p[r, s, :c_up, p] = sum(w_up[dy + 1, dx + 1]
                                              for dy in _COLLAPSE[(u, r)]
                                              for dx in _COLLAPSE[(v, s)])
                    for pu in (0, 1):
                        dy = 2 * r + pu - 2 + u
                        for pv in (0, 1):
                            dx = 2 * s + pv - 2 + v
                            if -1 <= dy <= 1 and -1 <= dx <= 1:
                                ch = c_up + (2 * pu + pv) * rc
                                w0p[r, s, ch:ch + rc, p] = w_raw[dy + 1, dx + 1]
    return w0p.reshape(2, 2, c_up + 4 * rc, 4 * c_mid)


def pack_phase_head_weights(w0p, w1):
    """The bf16 kernel's weights: ``w0p`` ``(2, 2, c_src, 4 c_mid)`` from
    :func:`fold_phase_head_weights` (f32) and refine1's ``w1`` ``(n_cls,
    c_mid, 5, 5)`` (torch order) -> ``(w0k, w1k)`` in bf16, zero-padded:

      w0k (4, 4 cp, 64)   phase p = 2u + v; row (2r + s) cp + c; column n
      w1k (25, 64, 8)     tap 5 ky + kx; row c; column class

    with ``cp`` = c_src rounded up to 16. ``w0p`` is rounded to bf16 here,
    once (the kernel's one extra rounding)."""
    _, _, c_src, cm4 = w0p.shape
    c_mid = cm4 // 4
    n_cls = w1.shape[0]
    cp = -(-c_src // 16) * 16
    w0k = w0p.new_zeros(4, 4, cp, 64)
    w0k[:, :, :c_src, :c_mid] = w0p.reshape(4, c_src, 4, c_mid).permute(2, 0, 1, 3)
    w1k = w1.new_zeros(5, 5, 64, 8, dtype=torch.float32)
    w1k[:, :, :c_mid, :n_cls] = w1.float().permute(2, 3, 1, 0)
    return (w0k.reshape(4, 4 * cp, 64).to(torch.bfloat16).contiguous(),
            w1k.reshape(25, 64, 8).to(torch.bfloat16).contiguous())


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
    float32 or bfloat16, ``c_mid <= 64``, ``n_cls <= 8`` and, in bfloat16,
    ``c_up + 4 rc <= 192``; the kernel launches on the current stream and a
    failure raises. ``weights``, where given, is :func:`kernel_weights` of
    ``w0`` and ``w1`` for ``x_lo``'s dtype, folded beforehand. On the CPU the
    plain version runs.
    """
    c_up, rc, c_mid, n_cls = _shapes(x_lo, raw, g0, b0, w0, g1, b1, w1)
    if x_lo.device.type == "cpu":
        return phase_head_reference(x_lo, raw, g0=g0, b0=b0, w0=w0, g1=g1, b1=b1,
                                    w1=w1)
    if x_lo.device.type != "cuda":
        raise ValueError(f"no kernel for device {x_lo.device}")
    if not (x_lo.is_contiguous() and raw.is_contiguous()):
        raise ValueError("x_lo and raw must be contiguous NHWC tensors")
    if c_mid > MAX_MID or n_cls > MAX_CLASSES:
        raise ValueError(f"the kernel takes c_mid <= {MAX_MID} and n_cls <= "
                         f"{MAX_CLASSES}, got {c_mid} and {n_cls}")
    dt = x_lo.dtype
    if dt == torch.bfloat16 and c_up + 4 * rc > MAX_SOURCE_BF16:
        raise ValueError(f"the bf16 kernel takes c_up + 4 rc <= {MAX_SOURCE_BF16}, "
                         f"got {c_up + 4 * rc}")

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
