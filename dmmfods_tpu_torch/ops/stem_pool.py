"""The encoder stem and pool0 in one pass (K6): the counterpart of
``dmmfods_tpu/ops/pallas/stem_pool.py::stem_pool_strip``.

    out = maxpool3x3/s2/p1(ReLU(conv7x7/s2/p3(x) * gamma + beta))

with conv0's weight ``w7`` as ``(7, 7, C, F)`` and norm0 folded into
``(gamma, beta)``. Rounding, as the JAX kernel's: conv0 from inputs and
weights in ``x``'s dtype, accumulated in f32; the BN fold, ReLU and the max
in f32; one cast to ``x``'s dtype at the end.

* :func:`stem_pool` is the wrapper. For a CUDA tensor it launches the
  hand-written kernel ``csrc/stem_pool.cu`` (or raises); the stem plane never
  reaches device memory. bfloat16 runs conv0 on the tensor cores from the
  weight packed by :func:`pack_stem_weights` (given, or packed per call);
  float32, the check type, runs the CUDA-core body. For a CPU tensor it runs
  the plain version.
* :func:`stem_pool_reference` is the plain version (conv2d, BN, ReLU,
  max_pool2d). The CPU tests hold it against the JAX kernel in interpret
  mode and against the model's unfused stem; ``chip_smoke.py`` holds the
  kernel against it on the card.
* :func:`pick_rs` and :func:`eligible` are JAX's regime, kept as they are
  (its strip heights and VMEM cost model), so that the port's gate engages
  on the same shapes. :func:`s2d_conv0_weight` is JAX's space-to-depth form
  of conv0; the CUDA kernel computes the direct form and does not need it.

Shapes: ``x`` ``(B, H, W, C)`` NHWC, ``1 <= C <= 8``, -> ``(B, HQ, WQ, F)``
with ``HQ = ceil(ceil(H / 2) / 2)`` (the same along W).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .fused import _DTYPE_CODES, LaunchCount

K6_LAUNCHES = LaunchCount()

MAX_CHANNELS = 8   # the kernel's shared-memory plan (csrc/stem_pool.cu: kCMax)
GEMM_TILE = 16     # K and F of the packed weight round up to the mma.sync k16 / n16
# JAX's VMEM budget of a strip (a number of the gate, not of the card)
STRIP_BUDGET_BYTES = 100 * 1024 * 1024


def s2d_conv0_weight(w7, c, f):
    """A ``(7, 7, C, F)`` stride-2 conv weight in its space-to-depth form
    ``(4, 4, 4C, F)``: tap ``(dy, dx)`` of the 7x7 kernel reads source pixel
    ``2i + dy - 3``, block offset ``floor((dy - 3) / 2)`` in [-2, 1] with
    phase ``(dy - 3) & 1``; the s2d channel order is ``(py * 2 + px) * C``."""
    w4 = w7.new_zeros((4, 4, 4 * c, f))
    for a in range(4):
        for b in range(4):
            for py in (0, 1):
                for px in (0, 1):
                    dy = 2 * (a - 2) + py + 3
                    dx = 2 * (b - 2) + px + 3
                    if 0 <= dy < 7 and 0 <= dx < 7:
                        ch = (py * 2 + px) * c
                        w4[a, b, ch:ch + c, :] = w7[dy, dx]
    return w4


def pick_rs(hq, wq, c, f, dtype_bytes=2):
    """JAX's strip height: the largest RS in (16, 8, 4) dividing ``hq`` whose
    working set (its cost model, calibrated on the TPU) fits
    ``STRIP_BUDGET_BYTES``. None when none does."""
    for rs in (16, 8, 4):
        if hq % rs:
            continue
        r = (2 * rs + 4) * wq
        stack = r * f * 112
        src = 2 * r * 4 * c * 4
        x4 = r * 64 * c * dtype_bytes
        io = 3 * (2 * rs * 2 * wq * 4 * c) * dtype_bytes + (
            rs * wq * f * dtype_bytes)
        wts = 64 * c * f * dtype_bytes
        if stack + src + x4 + io + wts <= STRIP_BUDGET_BYTES:
            return rs
    return None


def eligible(batch, h, w, c, f, dtype_bytes=2):
    """JAX's regime of the fused stem: batch 1, H and W multiples of 4, W/4
    a multiple of the dtype's sublane tile, 1 <= C <= 8, and a strip height."""
    tile = 16 if dtype_bytes == 2 else 8
    return (
        batch == 1
        and h % 4 == 0 and w % 4 == 0 and (w // 4) % tile == 0
        and 1 <= c <= 8
        and pick_rs(h // 4, w // 4, c, f, dtype_bytes) is not None
    )


def _check(x, w7, gamma, beta):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be one of {list(_DTYPE_CODES)}, got {x.dtype}")
    c = x.shape[-1]
    if w7.dim() != 4 or tuple(w7.shape[:3]) != (7, 7, c):
        raise ValueError(f"w7 must be (7, 7, {c}, F), got {tuple(w7.shape)}")
    f = w7.shape[-1]
    for name, t in (("gamma", gamma), ("beta", beta)):
        if tuple(t.shape) != (f,):
            raise ValueError(f"{name} must be ({f},), got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    tensors = (x, w7, gamma, beta)
    if any(t.device != x.device for t in tensors):
        raise ValueError("all operands must be on one device, got "
                         f"{sorted({str(t.device) for t in tensors})}")
    return c, f


def packed_shape(c, f):
    """``(K_pad, F_pad)`` of :func:`pack_stem_weights` for ``C`` inputs and
    ``F`` features: ``49 C`` and ``F`` rounded up to 16."""
    return -(-49 * c // GEMM_TILE) * GEMM_TILE, -(-f // GEMM_TILE) * GEMM_TILE


def pack_stem_weights(w7, dtype=torch.bfloat16):
    """conv0's ``(7, 7, C, F)`` weight as the bf16 kernel's GEMM B operand:
    ``(K_pad, F_pad)`` row-major with row ``k = (dy * 7 + dx) * C + c`` (the
    order of ``w7.reshape(49 * C, F)``), zeros in every pad entry (see
    :func:`packed_shape`). Only bfloat16 has a packed form."""
    if dtype != torch.bfloat16:
        raise TypeError(f"only bfloat16 packs conv0's weight, got {dtype}")
    if w7.dim() != 4 or tuple(w7.shape[:2]) != (7, 7):
        raise ValueError(f"w7 must be (7, 7, C, F), got {tuple(w7.shape)}")
    c, f = w7.shape[2:]
    packed = torch.zeros(packed_shape(c, f), dtype=dtype, device=w7.device)
    packed[:49 * c, :f] = w7.reshape(49 * c, f)
    return packed


def _check_packed(x, c, f, packed):
    """Raise unless ``packed`` is :func:`pack_stem_weights`'s layout for a
    bfloat16 ``x`` of ``C`` channels and ``F`` features."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"a packed weight goes with bfloat16 x, got x {x.dtype}")
    shape = packed_shape(c, f)
    if (tuple(packed.shape) != shape or packed.dtype != torch.bfloat16
            or packed.device != x.device or not packed.is_contiguous()):
        raise ValueError(f"packed must be a contiguous bfloat16 {shape} on {x.device}, "
                         f"got a {packed.dtype} {tuple(packed.shape)} on {packed.device}")


def stem_pool_reference(x, w7, gamma, beta):
    """The plain version: conv0, BN, ReLU and the max pool in f32 from
    ``x``'s dtype, cast to it once at the end."""
    _check(x, w7, gamma, beta)
    dt = x.dtype
    w = w7.to(dt).float().permute(3, 2, 0, 1)                 # (F, C, 7, 7)
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w, stride=2, padding=3)
    y = torch.relu(y * gamma[:, None, None] + beta[:, None, None])
    return F.max_pool2d(y, 3, 2, 1).to(dt).permute(0, 2, 3, 1).contiguous()


def stem_pool(x, w7, gamma, beta, packed=None):
    """conv0 + norm0 + ReLU + pool0 of ``x`` in one pass (see the module
    docstring). ``packed`` is ``pack_stem_weights(w7)`` made beforehand, for
    a bfloat16 ``x`` only, or None (bfloat16 then packs per call).

    On a CUDA device ``x`` must be a contiguous NHWC tensor in float32 or
    bfloat16 with ``C <= 8``; the kernel launches on the current stream and a
    failure raises. On the CPU the plain version runs (a ``packed`` given is
    checked, then not used).
    """
    c, f = _check(x, w7, gamma, beta)
    if packed is not None:
        _check_packed(x, c, f, packed)
    if x.device.type == "cpu":
        return stem_pool_reference(x, w7, gamma, beta)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be a contiguous NHWC tensor")
    if c > MAX_CHANNELS:
        raise ValueError(f"the kernel takes C <= {MAX_CHANNELS}, got C={c}")

    from . import _build

    lib = _build.load()
    bsz, h, w, _ = x.shape
    hq, wq = ((h + 1) // 2 + 1) // 2, ((w + 1) // 2 + 1) // 2
    out = torch.empty((bsz, hq, wq, f), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if x.dtype == torch.bfloat16:
        w7 = packed if packed is not None else pack_stem_weights(w7)
        if w7.data_ptr() % 16:
            raise ValueError("packed must start on a 16-byte boundary")
    else:
        w7 = w7.to(x.dtype).contiguous()
    gamma, beta = gamma.contiguous(), beta.contiguous()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.dmm_stem_pool(
            x.data_ptr(), w7.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            out.data_ptr(), bsz, h, w, c, f, _DTYPE_CODES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"stem_pool kernel launch failed: cudaError {rc}")
    K6_LAUNCHES.add()
    return out
