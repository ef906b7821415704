"""A whole dense block at inference (K2): the counterpart of
``dmmfods_tpu/ops/pallas/dense_block_strip.py::dense_block_strip_carry``.

For each layer ``l`` (``width = c0 + l * G``), with BN folded:

    act = ReLU(feats[..., :width] * g1 + b1)          in the activation dtype
    y2  = ReLU((act @ w1) * g2 + b2)                  in the activation dtype
    feats = cat(feats, conv3x3(y2, w3, zero padding))

* :func:`dense_block_strip` is the wrapper. For a CUDA tensor it runs the
  hand-written kernel ``csrc/dense_block_strip.cu`` (or raises): the block's
  output buffer is allocated once and each layer writes its slab into it, so
  no concat is ever copied. For a CPU tensor it runs the plain version.
* :func:`dense_block_strip_reference` is the plain PyTorch version, the
  textbook loop on the folded stacks. The CPU tests hold it against the JAX
  kernel (interpret mode), and ``chip_smoke.py`` holds the kernel against it
  on the card.

Both take ``x`` as ``(B, H, W, c0)`` NHWC and ``folded`` as returned by
:func:`.dense_block.fold_block_params`, and return ``(B, H, W, C_max)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .fused import _DTYPE_CODES, LaunchCount

K2_LAUNCHES = LaunchCount()

# the kernels' shared-memory plan (csrc/dense_layer_tile.cuh: kKMax, kGMax)
MAX_BOTTLENECK = 128
MAX_GROWTH = 32

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


def dense_block_strip(x, folded):
    """The dense block of ``folded`` on ``x`` (see the module docstring).

    On a CUDA device ``x`` must be a contiguous NHWC tensor in float32 or
    bfloat16 and ``K <= 128``, ``G <= 32``; the kernels launch on the current
    stream and a failure raises. On the CPU the plain version runs.
    """
    return run_block_kernel(x, folded, "dmm_dense_block_strip", K2_LAUNCHES)


def run_block_kernel(x, folded, entry, count):
    """What K2 and K4 share around their kernels: check the operands, take
    the plain version on the CPU, else allocate the output buffer, launch the
    C entry point ``entry`` of the kernel library on the current stream,
    raise on its error and add one to ``count``."""
    n, c0, growth, k, c_max = _shapes(x, folded)
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
    w1 = folded["w1"].to(x.dtype).contiguous()
    w3 = folded["w3"].to(x.dtype).contiguous()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, entry)(
            x.data_ptr(), out.data_ptr(), ops["g1"].data_ptr(), ops["b1"].data_ptr(),
            w1.data_ptr(), ops["g2"].data_ptr(), ops["b2"].data_ptr(), w3.data_ptr(),
            bsz, h, w, c0, n, growth, k, _DTYPE_CODES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {rc}")
    count.add()
    return out
