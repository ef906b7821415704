"""The kernel gates of the port know their CUDA kernels' limits
(``dmmfods_tpu_torch/ops/dense_block_strip.py::eligible``,
``ops/dense_block.py::eligible``, ``models/dense_unet_lidar.py::Head``).

The layer body of K2, K4 and K5 takes growth <= 48 and K <= 192, in two
padded layouts: (K 128, G 32) for DenseNet-121, -169 and -201, (K 192, G
48) for DenseNet-161 (``ops/dense_block_strip.py::LAYOUTS``). So on every
DenseNet-161 dense block the port's strip and K4 gates give JAX's decision,
held here against the JAX package's own gates in bf16 and f32, every
DenseNet-121 decision stays JAX's, and growth 64 (K 256) is refused by
shape: the plain loop runs there. K3 takes c_mid <= 96 and, in bf16, a
source c_up + 4 rc <= 256 (two layouts, ``ops/phase_head.py::LAYOUTS_BF16``):
its gate takes DenseNet-121's and DenseNet-161's heads (c_mid 96, source
208) in both dtypes, as JAX's gate (``kernel_limits=False``) does, refuses a
head past those limits (the phase-space head runs there), and takes nothing
with ``use_fused_kernels`` off. On the CPU the kernels' wrappers run their
plain versions, so an eval growth-48 block is held against the model's
plain loop, with the wrappers spied on to show they are called."""

import pytest
import torch

from dmmfods_tpu.ops.pallas import dense_block as jax_k4
from dmmfods_tpu.ops.pallas import dense_block_strip as jax_k2
from dmmfods_tpu_torch.models import dense_unet_lidar as pm
from dmmfods_tpu_torch.ops import dense_block as k4
from dmmfods_tpu_torch.ops import dense_block_strip as k2
from dmmfods_tpu_torch.ops.phase_head import MAX_MID, MAX_SOURCE_BF16, bf16_layout

BN_SIZE = 4
# 1280x1920 at batch 1: DenseNet-161's four dense blocks (h, w, c0, layers)
# and those of JAX's strip gates take in (bf16, f32): both kernels blocks 1
# and 2 in bf16; in f32 the carry kernel (K2) both, the recompute kernel
# (K5) block 1 only; none blocks 3 and 4
DENSENET161_STRIP = {"block1": (320, 480, 96, 6), "block2": (160, 240, 192, 12),
                     "block3": (80, 120, 384, 36), "block4": (40, 60, 1056, 24)}
DENSENET161_STRIP_TAKEN = {True: {2: ("block1", "block2"), 4: ("block1", "block2")},
                           False: {2: ("block1", "block2"), 4: ("block1",)}}
DENSENET121_STRIP = {"block1": (320, 480, 64, 6), "block2": (160, 240, 128, 12)}
# 128x192 blocks (h, w, c0, layers) and the batches JAX's sample-group rule
# takes each at in bf16, of (1, 8, 32, 256)
DENSENET121_K4 = {"block1": ((32, 48, 64, 6), (1, 8, 32, 256)),
                  "block2": ((16, 24, 128, 12), (1, 8, 32, 256)),
                  "block3": ((8, 12, 256, 24), (8, 32, 256)),
                  "block4": ((4, 6, 512, 16), (32, 256))}
# DenseNet-161's at 128x192: JAX's rule takes blocks 1 and 2 at every batch
# in bf16 and f32, blocks 3 and 4 at none
DENSENET161_K4 = {"block1": ((32, 48, 96, 6), (1, 8, 32, 256)),
                  "block2": ((16, 24, 192, 12), (1, 8, 32, 256)),
                  "block3": ((8, 12, 384, 36), ()), "block4": ((4, 6, 1056, 24), ())}


@pytest.mark.parametrize("carry", [True, False])
@pytest.mark.parametrize("block", list(DENSENET161_STRIP))
def test_strip_gate_refuses_densenet161(block, carry):
    """The strip gate on a DenseNet-161 block at 1280x1920 refuses it where
    JAX's refuses it and takes it where JAX's takes it, in bf16 and f32:
    growth 48 and K 192 are within the kernels' limits."""
    h, w, c0, layers = DENSENET161_STRIP[block]
    assert k2.within_limits(48, BN_SIZE)
    assert k2.layout(48, BN_SIZE * 48) == (192, 48)
    for dtype_bytes in (2, 4):
        want = block in DENSENET161_STRIP_TAKEN[carry][dtype_bytes]
        got = k2.eligible(1, h, w, c0, 48, layers, BN_SIZE, dtype_bytes, carry=carry)
        assert got == jax_k2.eligible(1, h, w, c0, 48, layers, BN_SIZE, dtype_bytes,
                                      carry=carry) == want, (block, dtype_bytes)
        assert got == k2.eligible(1, h, w, c0, 48, layers, BN_SIZE, dtype_bytes, carry=carry,
                                  kernel_limits=False)


@pytest.mark.parametrize("carry", [True, False])
@pytest.mark.parametrize("block", list(DENSENET121_STRIP))
def test_strip_gate_still_takes_densenet121(block, carry):
    h, w, c0, layers = DENSENET121_STRIP[block]
    assert k2.eligible(1, h, w, c0, 32, layers, BN_SIZE, 2, carry=carry)
    assert k2.layout(32, BN_SIZE * 32) == (128, 32)


def test_k4_gate_refuses_densenet161_and_keeps_densenet121():
    """K4's gate at 128x192: on DenseNet-161's blocks it gives JAX's
    decision at b1, b8, b32 and b256 in bf16 and f32 (blocks 1 and 2 taken,
    3 and 4 refused); DenseNet-121's decisions are unchanged."""
    for name, ((h, w, c0, layers), batches) in DENSENET161_K4.items():
        for dtype_bytes in (2, 4):
            for batch in (1, 8, 32, 256):
                got = k4.eligible(layers, c0, 48, BN_SIZE, h, w, dtype_bytes, batch=batch)
                assert got == jax_k4.eligible(layers, c0, 48, BN_SIZE, h, w, dtype_bytes,
                                              batch=batch) == (batch in batches), (
                    name, dtype_bytes, batch)
    for name, ((h, w, c0, layers), batches) in DENSENET121_K4.items():
        for batch in (1, 8, 32, 256):
            assert k4.eligible(layers, c0, 32, BN_SIZE, h, w, 2, batch=batch) == (
                batch in batches), (name, batch)


@pytest.mark.parametrize("gate", ["strip", "k4"])
def test_growth64_is_refused(gate):
    """Growth 64 (K 256) is past the widest layout: the port's gate refuses
    a block JAX's takes, and the bf16 packing raises."""
    assert not k2.within_limits(64, BN_SIZE)
    with pytest.raises(ValueError):
        k2.layout(64, 256)
    assert k2.within_limits(48, 4) and not k2.within_limits(48, 5)   # K 240
    if gate == "strip":
        h, w, c0, layers = 320, 480, 64, 6
        assert jax_k2.eligible(1, h, w, c0, 64, layers, BN_SIZE, 2, carry=True)
        assert not k2.eligible(1, h, w, c0, 64, layers, BN_SIZE, 2, carry=True)
        assert k2.eligible(1, h, w, c0, 64, layers, BN_SIZE, 2, carry=True,
                           kernel_limits=False)
    else:
        h, w, c0, layers = 32, 48, 64, 6
        assert jax_k4.eligible(layers, c0, 64, BN_SIZE, h, w, 2, batch=8)
        assert not k4.eligible(layers, c0, 64, BN_SIZE, h, w, 2, batch=8)
    folded = {"w1": torch.zeros(2, 64 + 2 * 64, 256), "w3": torch.zeros(2, 3, 3, 256, 64)}
    with pytest.raises(ValueError):
        k2.pack_layer_weights(folded)


def _spy(monkeypatch, name, calls):
    fn = getattr(pm, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)

    monkeypatch.setattr(pm, name, spy)


@pytest.mark.parametrize("path", ["k4", "strip"])
def test_growth48_eval_block_runs_the_plain_loop(monkeypatch, path):
    """An eval growth-48 block at a shape JAX's gate takes (K4: 1x8x16,
    one 128-pixel sample group; strip: a batch-1 plane with the strip
    threshold lowered to it) calls its kernel's wrapper (``dense_block``,
    ``dense_block_strip``), whose plain version runs on the CPU, and equals
    the model's plain loop (atol 5e-4, the dispatch tests' tolerance for
    BN folded into the kernels' stacks); its packed pair is the wide
    layout's."""
    layers, c0, growth = 2, 16, 48
    h, w = 8, 16
    block = pm.DenseBlock(layers, c0, BN_SIZE, growth, 0.0,
                          impl="pallas" if path == "k4" else "concat")
    pm.reset_parameters(block, torch.Generator().manual_seed(7))
    block.eval()
    if path == "strip":
        monkeypatch.setattr(pm, "STRIP_MIN_PIXELS", h * w)
    calls = []
    for name in ("dense_block", "dense_block_strip", "dense_block_strip_recompute"):
        _spy(monkeypatch, name, calls)
    x = torch.randn(1, c0, h, w, generator=torch.Generator().manual_seed(8))
    assert k4.pick_group(1, h, w, 4, num_layers=layers, c0=c0, growth=growth,
                         bn_size=BN_SIZE) is not None
    with torch.no_grad():
        got = block(x)
        want = x
        for layer in block.children():
            want = torch.cat([want, layer(want)], dim=1)
    assert calls == ["dense_block" if path == "k4" else "dense_block_strip"]
    assert got.shape == (1, c0 + layers * growth, h, w)
    torch.testing.assert_close(got, want, atol=5e-4, rtol=0)
    w1p, w3p = block._operands["kernels", x.dtype][1][1]
    assert tuple(w1p.shape) == (layers, 128, 192) and tuple(w3p.shape) == (layers, 9, 192, 48)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, device="meta", dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_head_gate_knows_the_kernel_limits(dtype):
    """At 1280x1920 batch 1 in eval: DenseNet-121's head (c_up 128, 4 raw
    channels, c_mid 64) and DenseNet-161's (c_up 192, c_mid 96: source 208)
    take K3, as JAX's gate does; c_mid 128, 9 classes and, in bf16 only, a
    source past 256 do not; with ``use_fused_kernels`` off nothing does."""
    x_lo, raw = _meta(1, 128, 640, 960, dtype=dtype), _meta(1, 4, 1280, 1920, dtype=dtype)
    x_lo161 = _meta(1, 192, 640, 960, dtype=dtype)
    x_lo_wide = _meta(1, MAX_SOURCE_BF16 - 16 + 4, 640, 960, dtype=dtype)  # source 260
    assert MAX_MID == 96 and MAX_SOURCE_BF16 == 256
    assert bf16_layout(128 + 4 * 4, 64) == (192, 64, 64)
    assert bf16_layout(192 + 4 * 4, 96) == (256, 96, 48)
    for head, x in ((pm.Head(128, 4, 64, 3), x_lo), (pm.Head(192, 4, 96, 3), x_lo161)):
        head.eval()
        assert head._kernel_eligible(x, raw)
        assert head._kernel_eligible(x, raw) == head._kernel_eligible(x, raw, kernel_limits=False)
    assert not pm.Head(128, 4, 128, 3).eval()._kernel_eligible(x_lo, raw)
    assert pm.Head(128, 4, 128, 3).eval()._kernel_eligible(x_lo, raw, kernel_limits=False)
    assert not pm.Head(128, 4, 64, 9).eval()._kernel_eligible(x_lo, raw)
    assert pm.Head(244, 4, 64, 3).eval()._kernel_eligible(x_lo_wide, raw) == (
        dtype == torch.float32)
    for head, x in ((pm.Head(128, 4, 64, 3, use_fused=False), x_lo),
                    (pm.Head(192, 4, 96, 3, use_fused=False), x_lo161)):
        head.eval()
        assert not head._kernel_eligible(x, raw)
        assert not head._kernel_eligible(x, raw, kernel_limits=False)
    assert not pm.Head(128, 4, 64, 3, fused_max_pixels=1280 * 1920 - 1).eval(
        )._kernel_eligible(x_lo, raw)
