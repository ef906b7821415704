"""The kernel gates of the port know their CUDA kernels' limits
(``dmmfods_tpu_torch/ops/dense_block_strip.py::eligible``,
``ops/dense_block.py::eligible``, ``models/dense_unet_lidar.py::Head``).

JAX's gates take DenseNet-161's blocks (growth 48, so K = 192) and head
(c_mid 96); the CUDA kernels take growth <= 32, K <= 128 and c_mid <= 64.
So the port's gates refuse those shapes and the plain loop or head runs
there, chosen by shape, while every decision on DenseNet-121 stays JAX's.
That is an open gap, not a match: with ``kernel_limits=False`` each gate
gives JAX's decision alone, which these tests hold against the JAX
package's own gates, so the gap stays visible until the kernels widen.
On the CPU the kernels' wrappers run their plain versions, so a growth-48
block is held against the plain loop bit for bit, with the wrappers spied
on to show they are not called."""

import pytest
import torch

from dmmfods_tpu.ops.pallas import dense_block as jax_k4
from dmmfods_tpu.ops.pallas import dense_block_strip as jax_k2
from dmmfods_tpu_torch.models import dense_unet_lidar as pm
from dmmfods_tpu_torch.ops import dense_block as k4
from dmmfods_tpu_torch.ops import dense_block_strip as k2
from dmmfods_tpu_torch.ops.phase_head import MAX_MID, MAX_SOURCE_BF16

BN_SIZE = 4
# 1280x1920 at batch 1, mid fusion before block 3: blocks 1 and 2 of both
# streams (h, w, c0, layers)
DENSENET161_STRIP = {"block1": (320, 480, 96, 6), "block2": (160, 240, 192, 12)}
DENSENET121_STRIP = {"block1": (320, 480, 64, 6), "block2": (160, 240, 128, 12)}
# 128x192 blocks (h, w, c0, layers) and the batches JAX's sample-group rule
# takes each at in bf16, of (1, 8, 32, 256)
DENSENET121_K4 = {"block1": ((32, 48, 64, 6), (1, 8, 32, 256)),
                  "block2": ((16, 24, 128, 12), (1, 8, 32, 256)),
                  "block3": ((8, 12, 256, 24), (8, 32, 256)),
                  "block4": ((4, 6, 512, 16), (32, 256))}


@pytest.mark.parametrize("carry", [True, False])
@pytest.mark.parametrize("block", list(DENSENET161_STRIP))
def test_strip_gate_refuses_densenet161(block, carry):
    h, w, c0, layers = DENSENET161_STRIP[block]
    assert not k2.eligible(1, h, w, c0, 48, layers, BN_SIZE, 2, carry=carry)
    assert not k2.eligible(1, h, w, c0, 48, layers, BN_SIZE, 4, carry=carry)
    # JAX's own gate takes it (the gap): the limits refuse it
    assert not k2.within_limits(48, BN_SIZE)
    assert (k2.pick_rs_carry if carry else k2.pick_rs)(
        h, layers, w, c0, 48, BN_SIZE * 48) is not None
    assert k2.eligible(1, h, w, c0, 48, layers, BN_SIZE, 2, carry=carry, kernel_limits=False)
    for dtype_bytes in (2, 4):
        assert k2.eligible(1, h, w, c0, 48, layers, BN_SIZE, dtype_bytes, carry=carry,
                           kernel_limits=False) == jax_k2.eligible(
            1, h, w, c0, 48, layers, BN_SIZE, dtype_bytes, carry=carry)


@pytest.mark.parametrize("carry", [True, False])
@pytest.mark.parametrize("block", list(DENSENET121_STRIP))
def test_strip_gate_still_takes_densenet121(block, carry):
    h, w, c0, layers = DENSENET121_STRIP[block]
    assert k2.eligible(1, h, w, c0, 32, layers, BN_SIZE, 2, carry=carry)


def test_k4_gate_refuses_densenet161_and_keeps_densenet121():
    assert k4.pick_group(32, 32, 48, 2, num_layers=6, c0=96, growth=48,
                         bn_size=BN_SIZE) is not None
    assert not k4.eligible(6, 96, 48, BN_SIZE, 32, 48, 2, batch=32)
    # JAX's gate takes it (the gap)
    assert k4.eligible(6, 96, 48, BN_SIZE, 32, 48, 2, batch=32, kernel_limits=False)
    assert jax_k4.eligible(6, 96, 48, BN_SIZE, 32, 48, 2, batch=32)
    for name, ((h, w, c0, layers), batches) in DENSENET121_K4.items():
        for batch in (1, 8, 32, 256):
            assert k4.eligible(layers, c0, 32, BN_SIZE, h, w, 2, batch=batch) == (
                batch in batches), (name, batch)


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
    threshold lowered to it) equals the plain loop bit for bit and calls no
    kernel wrapper."""
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
    assert calls == []
    assert got.shape == (1, c0 + layers * growth, h, w)
    assert torch.equal(got, want)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, device="meta", dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_head_gate_knows_the_kernel_limits(dtype):
    """At 1280x1920 batch 1 in eval: DenseNet-121's head (c_up 128, 4 raw
    channels, c_mid 64) takes K3; DenseNet-161's (c_up 192, c_mid 96) does
    not; c_mid 64 with c_up 192 only in f32 (in bf16 c_up + 4 rc = 208)."""
    x_lo, raw = _meta(1, 128, 640, 960, dtype=dtype), _meta(1, 4, 1280, 1920, dtype=dtype)
    x_lo161 = _meta(1, 192, 640, 960, dtype=dtype)
    assert pm.Head(128, 4, 64, 3).eval()._kernel_eligible(x_lo, raw)
    assert 96 > MAX_MID and 192 + 4 * 4 > MAX_SOURCE_BF16
    assert not pm.Head(192, 4, 96, 3).eval()._kernel_eligible(x_lo161, raw)
    # JAX's gate alone takes DenseNet-161's head (the gap)
    assert pm.Head(192, 4, 96, 3).eval()._kernel_eligible(x_lo161, raw, kernel_limits=False)
    assert not pm.Head(128, 4, 96, 3).eval()._kernel_eligible(x_lo, raw)
    assert not pm.Head(128, 4, 64, 9).eval()._kernel_eligible(x_lo, raw)
    assert pm.Head(192, 4, 64, 3).eval()._kernel_eligible(x_lo161, raw) == (
        dtype == torch.float32)
