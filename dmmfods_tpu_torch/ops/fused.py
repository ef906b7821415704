"""Fused concat + BN + ReLU + 1x1 conv: the mid-fusion op (K1).

A 1x1 conv over a channel concat splits over the two halves of its input:

    ReLU(BN(cat(a, b))) @ W  ==  ReLU(BN_a(a)) @ W[:Ca]  +  ReLU(BN_b(b)) @ W[Ca:]

so the concat never has to exist in memory. This is the counterpart of
``dmmfods_tpu/ops/fused.py::concat_bn_relu_conv1x1``:

* :func:`concat_bn_relu_conv1x1` is the wrapper. For a CUDA tensor it
  launches the hand-written kernel ``csrc/concat_bn_relu_conv1x1.cu`` (or
  raises); for a CPU tensor it runs the plain version below.
* :func:`concat_bn_relu_conv1x1_reference` is the plain PyTorch version. The
  CPU tests hold it against the JAX function, and ``chip_smoke.py`` holds the
  kernel against it on the card.

Both take and return NHWC tensors, like the JAX function.
"""

from __future__ import annotations

import threading

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class LaunchCount:
    """How many times a kernel was launched: a plain integer, behind a lock
    because the serving worker thread and its caller may both launch."""

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0

    def add(self) -> None:
        with self._lock:
            self.value += 1

    def reset(self) -> None:
        with self._lock:
            self.value = 0


K1_LAUNCHES = LaunchCount()


def fold_bn(scale, bias, mean, var, eps):
    """Fold BN running stats into a per-channel ``(gamma, beta)`` in f32:
    ``BN(x) = x * gamma + beta`` with ``gamma = scale / sqrt(var + eps)``."""
    gamma = scale.float() * torch.rsqrt(var.float() + eps)
    beta = bias.float() - mean.float() * gamma
    return gamma, beta


def concat_bn_relu_conv1x1_reference(a, b, *, scale, bias, mean, var, weight,
                                     eps=1e-5):
    """The plain version: ``ReLU(BN(cat(a, b))) @ W`` as two matmuls.

    Args:
      a: ``(B, H, W, Ca)``, b: ``(B, H, W, Cb)`` in one dtype.
      scale/bias/mean/var: BN params and running stats over ``Ca + Cb``.
      weight: the 1x1 conv weight, ``(Cout, Ca + Cb[, 1, 1])`` (torch order).
    Returns ``(B, H, W, Cout)`` in ``a``'s dtype. The BN fold and ReLU run in
    f32 and round to ``a``'s dtype; the matmuls run in that dtype, as the
    JAX function's plain path does.
    """
    ca = a.shape[-1]
    gamma, beta = fold_bn(scale, bias, mean, var, eps)
    dt = a.dtype
    an = torch.relu(a.float() * gamma[:ca] + beta[:ca]).to(dt)
    bn = torch.relu(b.float() * gamma[ca:] + beta[ca:]).to(dt)
    w = weight.reshape(weight.shape[0], -1).t().to(dt)   # (Ca + Cb, Cout)
    return an @ w[:ca] + bn @ w[ca:]


def _check(a, b, scale, bias, mean, var, weight):
    if a.dim() != 4 or b.dim() != 4 or a.shape[:3] != b.shape[:3]:
        raise ValueError(f"a and b must be (B, H, W, C) over the same pixels, "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODES:
        raise TypeError(f"a and b must share a dtype of {list(_DTYPE_CODES)}, "
                        f"got {a.dtype} and {b.dtype}")
    k = a.shape[-1] + b.shape[-1]
    if weight.dim() not in (2, 4) or weight.shape[1] != k or (
            weight.dim() == 4 and tuple(weight.shape[2:]) != (1, 1)):
        raise ValueError(f"weight must be (Cout, {k}) or (Cout, {k}, 1, 1), "
                         f"got {tuple(weight.shape)}")
    for name, t in (("scale", scale), ("bias", bias), ("mean", mean), ("var", var)):
        if t.shape != (k,):
            raise ValueError(f"{name} must be ({k},), got {tuple(t.shape)}")
    tensors = (a, b, scale, bias, mean, var, weight)
    if any(t.device != a.device for t in tensors):
        raise ValueError("all operands must be on one device, got "
                         f"{sorted({str(t.device) for t in tensors})}")


def concat_bn_relu_conv1x1(a, b, *, scale, bias, mean, var, weight, eps=1e-5):
    """``ReLU(BN(cat(a, b), folded running stats)) @ W`` without the concat.

    Same arguments as :func:`concat_bn_relu_conv1x1_reference`. On a CUDA
    device ``a`` and ``b`` must be contiguous NHWC tensors in float32 or
    bfloat16; the kernel launches on the current stream, and its failure
    raises. On the CPU the plain version runs.
    """
    _check(a, b, scale, bias, mean, var, weight)
    if a.device.type == "cpu":
        return concat_bn_relu_conv1x1_reference(
            a, b, scale=scale, bias=bias, mean=mean, var=var, weight=weight,
            eps=eps)
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous NHWC tensors")

    from . import _build

    lib = _build.load()
    bsz, h, w_, ca = a.shape
    cb = b.shape[-1]
    cout = weight.shape[0]
    rows = bsz * h * w_
    out = torch.empty((bsz, h, w_, cout), dtype=a.dtype, device=a.device)
    if rows == 0:
        return out
    gamma, beta = fold_bn(scale, bias, mean, var, eps)
    gamma, beta = gamma.contiguous(), beta.contiguous()
    w2 = weight.reshape(cout, ca + cb).to(a.dtype).contiguous()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.dmm_concat_bn_relu_conv1x1(
            a.data_ptr(), b.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            w2.data_ptr(), out.data_ptr(), rows, ca, cb, cout,
            _DTYPE_CODES[a.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"concat_bn_relu_conv1x1 kernel launch failed: "
                           f"cudaError {rc}")
    K1_LAUNCHES.add()
    return out
