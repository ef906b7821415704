"""Fused concat + BN + ReLU + 1x1 conv: the mid-fusion op (K1).

A 1x1 conv over a channel concat splits over the two halves of its input:

    ReLU(BN(cat(a, b))) @ W  ==  ReLU(BN_a(a)) @ W[:Ca]  +  ReLU(BN_b(b)) @ W[Ca:]

so the concat never has to exist in memory. This is the counterpart of
``dmmfods_tpu/ops/fused.py::concat_bn_relu_conv1x1``:

* :func:`concat_bn_relu_conv1x1` is the wrapper. For a CUDA tensor it
  launches the hand-written kernel ``csrc/concat_bn_relu_conv1x1.cu`` (or
  raises); for a CPU tensor it runs the plain version below. bfloat16 runs
  the tensor-core body on the weight packed by :func:`pack_fuse_weights`;
  float32, the check type, runs the CUDA-core body.
* :func:`fuse_operands` makes the kernel's operands once per fold: the BN
  stats folded to ``(gamma, beta)`` in f32 and, for bfloat16, the packed
  weight. The eval ``ConcatFuse`` keeps them; without them the wrapper makes
  them per call.
* :func:`concat_bn_relu_conv1x1_reference` is the plain PyTorch version. The
  CPU tests hold it against the JAX function, and ``chip_smoke.py`` holds the
  kernel against it on the card.

Both take and return NHWC tensors, like the JAX function.
"""

from __future__ import annotations

import torch

from ..tracing import LaunchCount

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

K1_LAUNCHES = LaunchCount()

GEMM_TILE = 16     # Cout of the packed weight rounds up to two mma.sync n8 tiles


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


def packed_shape(k, cout):
    """``(K, N_pad)`` of :func:`pack_fuse_weights` for ``K = Ca + Cb`` inputs
    and ``Cout`` outputs: ``N_pad`` is ``Cout`` rounded up to 16."""
    return k, -(-cout // GEMM_TILE) * GEMM_TILE


def pack_fuse_weights(weight, dtype=torch.bfloat16):
    """The 1x1 conv weight ``(Cout, K[, 1, 1])`` as the bf16 kernel's GEMM B
    operand: ``(K, N_pad)`` row-major, ``weight.reshape(Cout, K).t()`` in
    its unpadded block and zeros in the pad columns (see
    :func:`packed_shape`). Only bfloat16 has a packed form."""
    if dtype != torch.bfloat16:
        raise TypeError(f"only bfloat16 packs the 1x1 weight, got {dtype}")
    if weight.dim() not in (2, 4):
        raise ValueError(f"weight must be (Cout, K[, 1, 1]), got {tuple(weight.shape)}")
    cout, k = weight.shape[:2]
    packed = torch.zeros(packed_shape(k, cout), dtype=dtype, device=weight.device)
    packed[:, :cout] = weight.reshape(cout, k).t()
    return packed


def fuse_operands(scale, bias, mean, var, weight, eps, dtype):
    """K1's ``(gamma, beta, packed)`` for inputs of ``dtype``: the BN stats
    folded in f32 (:func:`fold_bn`) and, for bfloat16, the packed weight
    (None for float32, whose kernel reads the conv weight as it is)."""
    gamma, beta = fold_bn(scale, bias, mean, var, eps)
    packed = pack_fuse_weights(weight) if dtype == torch.bfloat16 else None
    return gamma.contiguous(), beta.contiguous(), packed


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


def _check_operands(a, k, cout, operands):
    """Raise unless ``operands`` is :func:`fuse_operands`' ``(gamma, beta,
    packed)`` for ``a``'s dtype and device, ``K`` inputs and ``Cout``
    outputs, with ``packed`` on a 16-byte boundary."""
    gamma, beta, packed = operands
    for name, t in (("gamma", gamma), ("beta", beta)):
        if (tuple(t.shape) != (k,) or t.dtype != torch.float32 or t.device != a.device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 ({k},) on {a.device}, "
                             f"got a {t.dtype} {tuple(t.shape)} on {t.device}")
    if a.dtype != torch.bfloat16:
        if packed is not None:
            raise TypeError(f"a packed weight goes with bfloat16 inputs, got {a.dtype}")
        return
    shape = packed_shape(k, cout)
    if (packed is None or tuple(packed.shape) != shape or packed.dtype != torch.bfloat16
            or packed.device != a.device or not packed.is_contiguous()):
        got = (None if packed is None else
               f"a {packed.dtype} {tuple(packed.shape)} on {packed.device}")
        raise ValueError(f"packed must be a contiguous bfloat16 {shape} on {a.device}, "
                         f"got {got}")
    if packed.data_ptr() % 16:
        raise ValueError("packed must start on a 16-byte boundary")


def concat_bn_relu_conv1x1(a, b, *, scale, bias, mean, var, weight, eps=1e-5,
                           operands=None):
    """``ReLU(BN(cat(a, b), folded running stats)) @ W`` without the concat.

    Same arguments as :func:`concat_bn_relu_conv1x1_reference`, and
    ``operands``: ``fuse_operands(...)`` made beforehand for ``a``'s dtype,
    or None (then they are made per call). On a CUDA device ``a`` and ``b``
    must be contiguous NHWC tensors in float32 or bfloat16; the kernel
    launches on the current stream, and its failure raises. On the CPU the
    plain version runs (``operands`` given are checked, then not used).
    """
    _check(a, b, scale, bias, mean, var, weight)
    k, cout = a.shape[-1] + b.shape[-1], weight.shape[0]
    if operands is not None:
        _check_operands(a, k, cout, operands)
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
    rows = bsz * h * w_
    out = torch.empty((bsz, h, w_, cout), dtype=a.dtype, device=a.device)
    if rows == 0:
        return out
    if operands is None:
        operands = fuse_operands(scale, bias, mean, var, weight, eps, a.dtype)
    gamma, beta, packed = operands
    # bfloat16: the packed (K, N_pad) weight; float32: the (Cout, K) weight
    w = packed if packed is not None else weight.reshape(cout, k).to(a.dtype).contiguous()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.dmm_concat_bn_relu_conv1x1(
            a.data_ptr(), b.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            w.data_ptr(), out.data_ptr(), rows, ca, cb, cout,
            _DTYPE_CODES[a.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"concat_bn_relu_conv1x1 kernel launch failed: "
                           f"cudaError {rc}")
    K1_LAUNCHES.add()
    return out
