"""K6, the port's fused stem + pool0 (``dmmfods_tpu_torch/ops/stem_pool.py``):
``s2d_conv0_weight`` against JAX's; the plain version against JAX's
``stem_pool_strip`` in interpret mode (the same code path the TPU runs) for
the RGB, LiDAR and early-fusion channel counts, and against the port's
unfused stem (conv0, norm0, ReLU, pool0); the port's gate against JAX's
``_stem_pool_ok`` off the TPU; the wrapper's argument checks; and that a CPU
tensor takes the plain version. All in f32. BN biases are drawn with both
signs, as in ``tests/test_pallas_stem_pool.py``: a positive beta exposes a
pool padding that contributes ReLU(beta). Tolerance: atol 5e-4 / rtol 1e-4,
the JAX kernel test's own, for f32 summation-order noise over 49*C taps.
The bf16 kernel's operands are checked here: ``pack_stem_weights``' layout
at the model's and the kernel's largest channel counts, the kernel's GEMM
form (an im2col against the packed weight, in f32) against the plain
version, and the wrapper's checks of a packed weight (the ``Encoder``'s kept
operands: ``tests/test_torch_eval_operands.py``). The kernel itself runs
only on the card: ``test_kernel_matches_plain_on_cuda`` skips without one,
and ``chip_smoke.py`` checks it at 1280x1920 and 128x192."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dmmfods_tpu.models import dense_unet_lidar as jm
from dmmfods_tpu.ops.pallas import stem_pool as jax_k6
from dmmfods_tpu_torch.models import dense_unet_lidar as pm
from dmmfods_tpu_torch.ops import stem_pool as k6
from dmmfods_tpu_torch.ops.fused import fold_bn

TOL = dict(atol=5e-4, rtol=1e-4)


def _case(rng, batch, h, w, c, f):
    return dict(
        x=rng.normal(size=(batch, h, w, c)).astype(np.float32),
        w7=(rng.normal(size=(7, 7, c, f)) * 0.2).astype(np.float32),
        gamma=rng.normal(size=(f,)).astype(np.float32),
        beta=rng.normal(size=(f,)).astype(np.float32))


def _torch(case):
    return [torch.from_numpy(case[k]) for k in ("x", "w7", "gamma", "beta")]


def test_s2d_weight_matches_jax():
    rng = np.random.default_rng(0)
    for c, f in ((3, 8), (1, 16), (4, 5)):
        w7 = rng.normal(size=(7, 7, c, f)).astype(np.float32)
        want = np.asarray(jax_k6.s2d_conv0_weight(jnp.asarray(w7), c, f))
        got = k6.s2d_conv0_weight(torch.from_numpy(w7), c, f)
        assert got.shape == want.shape == (4, 4, 4 * c, f)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("c,f,h,w,rs", [
    (3, 8, 32, 64, 4),    # RGB stream, two strips
    (1, 8, 32, 64, 8),    # LiDAR stream, one strip
    (4, 16, 64, 64, 8),   # early fusion, two strips
])
def test_plain_version_matches_jax_kernel(c, f, h, w, rs):
    case = _case(np.random.default_rng(c * 100 + h), 1, h, w, c, f)
    want = np.asarray(jax_k6.stem_pool_strip(
        *(jnp.asarray(case[k]) for k in ("x", "w7", "gamma", "beta")), rs=rs,
        interpret=True))
    got = k6.stem_pool_reference(*_torch(case))
    assert got.shape == want.shape == (1, h // 4, w // 4, f)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("batch,h,w,c", [(1, 64, 128, 3), (2, 30, 46, 4)])
def test_plain_version_matches_the_unfused_stem(batch, h, w, c):
    """The encoder's own stem in f32 (conv0, the eval BN, ReLU, pool0), also
    on a plane that is not a multiple of 4."""
    rng = np.random.default_rng(batch)
    spec = pm.ModelSpec(growth_rate=8, block_config=(1,), num_init_features=12)
    encoder = pm.Encoder(spec, c).eval()
    norm = encoder.norm0
    with torch.no_grad():
        encoder.conv0.weight.copy_(torch.from_numpy(
            rng.normal(0, 0.2, (12, c, 7, 7)).astype(np.float32)))
        for t, lo, hi in ((norm.weight, -1, 1), (norm.bias, -1, 1),
                          (norm.running_mean, -0.5, 0.5), (norm.running_var, 0.5, 1.5)):
            t.copy_(torch.from_numpy(rng.uniform(lo, hi, 12).astype(np.float32)))
        x = torch.from_numpy(rng.normal(size=(batch, c, h, w)).astype(np.float32))
        weight, folded = pm._plain_form((encoder.conv0, norm), x.dtype)
        want = torch.nn.functional.max_pool2d(
            pm._bn_relu(pm._conv(x, encoder.conv0, weight), norm, folded), 3, 2, 1)
        gamma, beta = fold_bn(norm.weight, norm.bias, norm.running_mean,
                              norm.running_var, norm.eps)
        got = k6.stem_pool_reference(x.permute(0, 2, 3, 1).contiguous(),
                                     encoder.conv0.weight.permute(2, 3, 1, 0), gamma, beta)
    assert got.shape == (batch, -(-h // 4), -(-w // 4), 12)
    torch.testing.assert_close(got, want.permute(0, 2, 3, 1), atol=1e-5, rtol=1e-5)


def test_pick_rs_and_eligible_match_jax():
    for hq, wq in ((320, 480), (32, 48), (16, 32), (8, 16), (10, 24), (7, 16)):
        for c, f, nbytes in ((3, 64, 2), (1, 64, 4), (4, 16, 2), (8, 96, 4)):
            assert k6.pick_rs(hq, wq, c, f, nbytes) == jax_k6.pick_rs(hq, wq, c, f, nbytes)
    for batch, h, w, c, f, nbytes in [
            (1, 1280, 1920, 3, 64, 2), (1, 1280, 1920, 1, 64, 2), (2, 1280, 1920, 3, 64, 2),
            (1, 1282, 1920, 3, 64, 2), (1, 1280, 1928, 3, 64, 2), (1, 128, 192, 3, 64, 2),
            (1, 128, 192, 4, 64, 4), (1, 64, 96, 3, 16, 2), (1, 64, 96, 3, 16, 4),
            (1, 64, 128, 9, 16, 4), (1, 64, 128, 1, 16, 4)]:
        assert k6.eligible(batch, h, w, c, f, nbytes) == \
            jax_k6.eligible(batch, h, w, c, f, nbytes), (batch, h, w, c, f, nbytes)


@pytest.mark.parametrize("sel", ["off", "auto", "on", "force"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gate_matches_jax_off_the_tpu(sel, dtype):
    """JAX's gate with ``backend="cpu"`` (its TPU quarantine does not apply
    there), for batch 1 and 2, eval and train, eligible and ineligible
    shapes: the port's gate, which has no quarantine, agrees."""
    jspec = jm.ModelSpec(num_init_features=16, stem_pool_strip=sel,
                         dtype=jnp.dtype(dtype))
    pspec = pm.ModelSpec(num_init_features=16, stem_pool_strip=sel,
                         dtype=getattr(torch, dtype))
    shapes = [(64, 128, 3), (64, 128, 1), (64, 96, 4), (66, 128, 3), (64, 100, 3),
              (1280, 1920, 3)]
    for b in (1, 2):
        for h, w, c in shapes:
            for train in (False, True):
                assert pm._stem_pool_ok(pspec, b, h, w, c, train) == \
                    jm._stem_pool_ok(jspec, b, h, w, c, train, backend="cpu"), \
                    (sel, dtype, b, h, w, c, train)
    assert pm._stem_pool_ok(pspec, 1, 64, 128, 3, False) == (sel in ("on", "force"))


@pytest.mark.parametrize("sel", ["", "none", "yes"])
def test_spec_rejects_unknown_stem_pool_strip(sel):
    """A value outside auto/off/on/force raises instead of picking a stem."""
    with pytest.raises(ValueError, match="stem_pool_strip"):
        pm.ModelSpec(stem_pool_strip=sel)


def test_encoder_dispatch(monkeypatch):
    """``on``: K6 at batch 1 in eval, with the pre-pool size on ``shapes``;
    batch 2, train mode and ``auto`` run the unfused stem."""
    spec = pm.ModelSpec(growth_rate=8, block_config=(2, 2), num_init_features=16,
                        stem_pool_strip="on")
    encoder = pm.Encoder(spec, 3).eval()
    unfused = pm.Encoder(dataclasses.replace(spec, stem_pool_strip="auto"), 3).eval()
    unfused.load_state_dict(encoder.state_dict())
    calls = []

    def spy(*args):
        calls.append(tuple(args[0].shape))
        return k6.stem_pool(*args)

    monkeypatch.setattr(pm, "stem_pool", spy)
    x = torch.rand(2, 3, 64, 128, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got, skips, shapes = encoder(x[:1])
        want, want_skips, want_shapes = unfused(x[:1])
        assert calls == [(1, 64, 128, 3)]
        encoder(x)
        encoder.train()(x[:1])
    assert calls == [(1, 64, 128, 3)]
    assert shapes == want_shapes == [(32, 64), (16, 32)]
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(skips[0], want_skips[0], atol=1e-5, rtol=1e-5)


def test_cpu_tensor_takes_the_plain_version():
    x, w7, gamma, beta = _torch(_case(np.random.default_rng(6), 2, 20, 28, 3, 8))
    before = k6.K6_LAUNCHES.value
    got = k6.stem_pool(x, w7, gamma, beta)
    assert k6.K6_LAUNCHES.value == before
    assert got.shape == (2, 5, 7, 8)
    torch.testing.assert_close(got, k6.stem_pool_reference(x, w7, gamma, beta),
                               atol=0, rtol=0)


@pytest.mark.parametrize("case,error", [
    ("rank", ValueError), ("dtype", TypeError), ("taps", ValueError),
    ("channels", ValueError), ("gamma", ValueError), ("beta_dtype", TypeError),
    ("devices", ValueError), ("no_kernel", ValueError),
])
def test_wrapper_rejects(case, error):
    x, w7, gamma, beta = _torch(_case(np.random.default_rng(7), 1, 16, 16, 3, 8))
    if case == "rank":
        x = x[0]
    elif case == "dtype":
        x = x.half()
    elif case == "taps":
        w7 = w7[:5]
    elif case == "channels":
        x = x[..., :2]
    elif case == "gamma":
        gamma = gamma[:4]
    elif case == "beta_dtype":
        beta = beta.double()
    elif case == "devices":
        w7 = w7.to("meta")
    elif case == "no_kernel":
        x, w7, gamma, beta = (t.to("meta") for t in (x, w7, gamma, beta))
    with pytest.raises(error):
        k6.stem_pool(x, w7, gamma, beta)


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(8)
    # bf16 runs the tensor-core body, with the weight packed beforehand, at
    # every C the model feeds it and the largest, on ragged planes
    bf16_cases = [((1, 37 + 4 * c, 58, c, f), torch.bfloat16, 1e-2)
                  for c in (1, 3, 4, 8) for f in (64, 40)]
    for (batch, h, w, c, f), dtype, bound in [
            ((2, 37, 58, 4, 40), torch.float32, 1e-4),
            ((1, 128, 192, 3, 64), torch.float32, 1e-4),
            ((1, 128, 192, 1, 64), torch.bfloat16, 1e-2)] + bf16_cases:
        x, w7, gamma, beta = (t.cuda() for t in _torch(_case(rng, batch, h, w, c, f)))
        w7 = w7.to(dtype).float()
        packed = k6.pack_stem_weights(w7) if dtype == torch.bfloat16 else None
        before = k6.K6_LAUNCHES.value
        got = k6.stem_pool(x.to(dtype), w7, gamma, beta, packed)
        torch.cuda.synchronize()
        assert k6.K6_LAUNCHES.value == before + 1
        want = k6.stem_pool_reference(x.to(dtype).float(), w7, gamma, beta)
        err = (got.float() - want).abs().max().item()
        assert err <= bound * want.abs().max().item()
        with pytest.raises(ValueError):   # the kernel takes contiguous NHWC only
            k6.stem_pool(x.transpose(1, 2), w7, gamma, beta)


@pytest.mark.parametrize("f", [64, 40, 8])
@pytest.mark.parametrize("c", [1, 3, 4, 8])
def test_pack_stem_weights(c, f):
    """The bf16 kernel's B operand: ``(K_pad, F_pad)`` with 49*C and F
    rounded up to 16, the unpadded block ``w7``'s ``(49*C, F)`` reshape in
    bf16 (row ``(dy * 7 + dx) * C + c``), zeros in every pad entry."""
    w7 = torch.from_numpy(np.random.default_rng(c * 10 + f).normal(
        size=(7, 7, c, f)).astype(np.float32))
    packed = k6.pack_stem_weights(w7)
    k_pad, f_pad = -(-49 * c // 16) * 16, -(-f // 16) * 16
    assert packed.shape == (k_pad, f_pad) == k6.packed_shape(c, f)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert {1: 64, 3: 160, 4: 208, 8: 400}[c] == k_pad
    assert torch.equal(packed[:49 * c, :f], w7.to(torch.bfloat16).reshape(49 * c, f))
    assert torch.equal(packed[7 * 3 * c + 4 * c + 1 if c > 1 else 7 * 3 + 4, :f],
                       w7[3, 4, 1 if c > 1 else 0].to(torch.bfloat16))
    pad = torch.ones_like(packed, dtype=torch.bool)
    pad[:49 * c, :f] = False
    assert (packed[pad] == 0).all() and packed[pad].numel() == k_pad * f_pad - 49 * c * f
    with pytest.raises(TypeError):
        k6.pack_stem_weights(w7, torch.float32)


def _stem_gemm(x, packed, c, f, gamma, beta):
    """The bf16 kernel's form in f32: an im2col ``(B, H2 * W2, K_pad)`` of
    ``x`` (row ``(dy * 7 + dx) * C + c``, zeros past 49*C), times the unpacked
    weight, BN and ReLU, 0 outside the stem plane as the pool's padding, and
    the 3x3/s2 max over the padded stem plane."""
    batch, h, w, _ = x.shape
    h2, w2 = -(-h // 2), -(-w // 2)
    k_pad = packed.shape[0]
    xp = torch.nn.functional.pad(x, (0, 0, 3, 3 + 2 * h2 - h, 3, 3 + 2 * w2 - w))
    cols = torch.zeros(batch, h2, w2, k_pad)
    for dy in range(7):
        for dx in range(7):
            k = (dy * 7 + dx) * c
            cols[..., k:k + c] = xp[:, dy:dy + 2 * h2:2, dx:dx + 2 * w2:2, :]
    stem = cols.reshape(batch, h2 * w2, k_pad) @ packed.float()
    stem = torch.relu(stem[..., :f] * gamma + beta).reshape(batch, h2, w2, f)
    hq, wq = -(-h2 // 2), -(-w2 // 2)
    padded = torch.zeros(batch, 2 * hq + 1, 2 * wq + 1, f)      # 0: the max's identity
    padded[:, 1:h2 + 1, 1:w2 + 1] = stem
    out = torch.zeros(batch, hq, wq, f)
    for a in range(3):
        for b in range(3):
            out = torch.maximum(out, padded[:, a:a + 2 * hq:2, b:b + 2 * wq:2])
    return out


@pytest.mark.parametrize("batch,c,f,h,w", [
    (1, 3, 8, 32, 64), (1, 1, 8, 32, 64), (1, 4, 16, 64, 64),   # the JAX-parity shapes
    (2, 3, 40, 30, 46),                                          # not a multiple of 4
])
def test_gemm_form_matches_plain(batch, c, f, h, w):
    """The im2col GEMM against the packed weight, in f32, equals the plain
    version: the packing's row order and padding, and the pool's 0 padding,
    are the plain function. Weights exact in bf16, so packing loses
    nothing."""
    case = _case(np.random.default_rng(c * 7 + h), batch, h, w, c, f)
    x, w7, gamma, beta = _torch(case)
    w7 = w7.to(torch.bfloat16).float()
    got = _stem_gemm(x, k6.pack_stem_weights(w7), c, f, gamma, beta)
    want = k6.stem_pool_reference(x, w7, gamma, beta)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("case,error", [
    ("shape", ValueError), ("dtype", ValueError), ("device", ValueError),
    ("f32_x", TypeError),
])
def test_wrapper_rejects_packed(case, error):
    """A packed weight of the wrong shape, dtype or device, or with a float32
    ``x``, raises (on the CPU too, where the plain version then runs)."""
    x, w7, gamma, beta = _torch(_case(np.random.default_rng(9), 1, 16, 16, 3, 8))
    packed = k6.pack_stem_weights(w7)
    x = x.to(torch.bfloat16)
    if case == "shape":
        packed = packed[:, :8].contiguous()
    elif case == "dtype":
        packed = packed.float()
    elif case == "device":
        packed = packed.to("meta")
    elif case == "f32_x":
        x = x.float()
    with pytest.raises(error):
        k6.stem_pool(x, w7, gamma, beta, packed)
    x = x.to(torch.bfloat16)
    got = k6.stem_pool(x, w7, gamma, beta, k6.pack_stem_weights(w7))
    torch.testing.assert_close(got, k6.stem_pool_reference(x, w7, gamma, beta), atol=0, rtol=0)
