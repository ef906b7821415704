"""Eval BatchNorm + ReLU in one pass, on operands folded beforehand.

    out = max(0, x * scale[c] + shift[c])

with ``(scale, shift)`` a BN's running stats folded in f32
(:func:`bn_relu_operands`). The JAX package leaves eval BN-ReLU to XLA, which
fuses the affine transform and the ReLU into one pass; no Pallas kernel is
replaced here.

* :func:`bn_relu` is the wrapper. For a CUDA tensor it launches the
  hand-written kernel ``csrc/bn_relu.cu`` (or raises): one read of ``x``, one
  write of ``out``, the arithmetic in f32 (one FMA) and one rounding to
  ``x``'s dtype. For a CPU tensor it runs the plain version.
* :func:`bn_relu_reference` is the plain version: the same f32 arithmetic in
  PyTorch (a multiply and an add), rounded once.
* :func:`bn_relu_operands` folds a BN module's running stats to the
  kernel's ``(scale, shift)``.

``x`` is ``(B, C, H, W)`` in shape; the kernel takes it ``channels_last`` in
memory, as the model holds every activation, in float32 or bfloat16, and
returns ``out`` in the same layout and dtype.

Counters: :data:`BN_RELU_LAUNCHES` (kernel launches) and :data:`BN_FOLDS`
(every fold the model's one cache of eval operands makes, in any form: the
plain path's, the kernels' and the phase-space head's,
``models/dense_unet_lidar.py`` ``eval_operands``): one forward on a warm
cache adds the number of BN-ReLU sites on the plain path to the first and
nothing to the second.
"""

from __future__ import annotations

import torch

from ..tracing import LaunchCount
from .fused import _DTYPE_CODES, fold_bn

BN_RELU_LAUNCHES = LaunchCount()
BN_FOLDS = LaunchCount()


def bn_relu_operands(norm):
    """``norm``'s running stats folded to the kernel's contiguous f32
    ``(scale, shift)``: ``BN(x) = x * scale + shift``."""
    scale, shift = fold_bn(norm.weight, norm.bias, norm.running_mean, norm.running_var,
                           norm.eps)
    return scale.contiguous(), shift.contiguous()


def bn_relu_reference(x, scale, shift):
    """The plain version: ``relu(x * scale + shift)`` per channel (dim 1), in
    f32 from ``x``'s values, rounded once to ``x``'s dtype. For a float32
    ``x`` it is the model's per-call eval BN and ReLU bit for bit."""
    y = torch.relu(x.float() * scale[:, None, None] + shift[:, None, None])
    return y.to(x.dtype)


def _check(x, scale, shift):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, C, H, W), got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be one of {list(_DTYPE_CODES)}, got {x.dtype}")
    c = x.shape[1]
    for name, t in (("scale", scale), ("shift", shift)):
        if (t.shape != (c,) or t.dtype != torch.float32 or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 ({c},) on {x.device}, "
                             f"got a {t.dtype} {tuple(t.shape)} on {t.device}")


def bn_relu(x, scale, shift):
    """``max(0, x * scale[c] + shift[c])``: the kernel for a CUDA ``x``,
    which must be channels_last in memory and start on a 16-byte boundary
    (else ValueError); the plain version for a CPU ``x``, in any layout.
    ``scale`` and ``shift`` are contiguous float32 ``(C,)`` on ``x``'s device
    (:func:`bn_relu_operands`). The kernel launches on the current stream,
    and its failure raises."""
    _check(x, scale, shift)
    if x.device.type == "cpu":
        return bn_relu_reference(x, scale, shift)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("x must be channels_last in memory: "
                         f"got strides {x.stride()} for shape {tuple(x.shape)}")
    if x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary")

    from . import _build

    lib = _build.load()
    out = torch.empty_like(x)       # x is dense: empty_like keeps its strides
    if out.numel() == 0:
        return out
    device = x.device.index
    rc = lib.dmm_bn_relu(x.data_ptr(), scale.data_ptr(), shift.data_ptr(), out.data_ptr(),
                         x.numel(), x.shape[1], _DTYPE_CODES[x.dtype], device,
                         torch._C._cuda_getCurrentRawStream(device))
    if rc != 0:
        raise RuntimeError(f"bn_relu kernel launch failed: cudaError {rc}")
    BN_RELU_LAUNCHES.add()
    return out
