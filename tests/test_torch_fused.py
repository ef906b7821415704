"""K1, the fused concat+BN+ReLU+1x1 of the port
(``dmmfods_tpu_torch/ops/fused.py``): its plain version against the JAX
``concat_bn_relu_conv1x1`` (the jnp path it takes on the CPU), the wrapper's
argument checks, and that a CPU tensor takes the plain version. The bf16
kernel's operands are checked here: ``pack_fuse_weights``' layout, the
kernel's GEMM form (K padded per stream, the normalized operands, the
unpacked weight) against the plain version, and the wrapper's checks of
``operands`` (the eval ``ConcatFuse``'s kept operands:
``tests/test_torch_eval_operands.py``). The kernel itself runs only on
the card: ``test_kernel_matches_plain_on_cuda`` skips without one, and
``chip_smoke.py`` checks it at the serving shapes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dmmfods_tpu.ops import fused as jax_fused
from dmmfods_tpu_torch.ops import fused

BF16 = torch.bfloat16


def _operands(rng, batch, h, w, ca, cb, cout):
    k = ca + cb
    return dict(
        a=rng.normal(size=(batch, h, w, ca)).astype(np.float32),
        b=rng.normal(size=(batch, h, w, cb)).astype(np.float32),
        scale=rng.uniform(0.5, 1.5, k).astype(np.float32),
        bias=rng.normal(0, 0.1, k).astype(np.float32),
        mean=rng.normal(0, 0.1, k).astype(np.float32),
        var=rng.uniform(0.5, 1.5, k).astype(np.float32),
        kernel=rng.normal(0, np.sqrt(2 / k), (1, 1, k, cout)).astype(np.float32),
    )


def _torch_args(ops, device="cpu", dtype=torch.float32):
    t = {k: torch.from_numpy(v).to(device) for k, v in ops.items()}
    weight = t.pop("kernel")[0, 0].t().contiguous()       # HWIO -> (Cout, Ca+Cb)
    return (t.pop("a").to(dtype), t.pop("b").to(dtype)), dict(t, weight=weight)


@pytest.mark.parametrize("shape", [
    (2, 16, 24, 128, 128, 128),   # the serving shape's channels
    (2, 5, 7, 12, 20, 24),        # ragged channels
])
def test_plain_version_matches_jax(shape):
    ops = _operands(np.random.default_rng(0), *shape)
    want = np.asarray(jax_fused.concat_bn_relu_conv1x1(
        jnp.asarray(ops["a"]), jnp.asarray(ops["b"]),
        scale=ops["scale"], bias=ops["bias"], mean=ops["mean"], var=ops["var"],
        kernel=ops["kernel"], use_pallas=False))
    (a, b), kw = _torch_args(ops)
    got = fused.concat_bn_relu_conv1x1_reference(a, b, **kw).numpy()
    assert got.shape == want.shape == shape[:3] + (shape[-1],)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_cpu_tensor_takes_the_plain_version():
    (a, b), kw = _torch_args(_operands(np.random.default_rng(1), 1, 4, 6, 8, 8, 16))
    before = fused.K1_LAUNCHES.value
    got = fused.concat_bn_relu_conv1x1(a, b, **kw)
    assert fused.K1_LAUNCHES.value == before
    torch.testing.assert_close(got, fused.concat_bn_relu_conv1x1_reference(a, b, **kw),
                               atol=0, rtol=0)
    # a 4-D (Cout, Cin, 1, 1) conv weight is taken as it is
    kw4 = dict(kw, weight=kw["weight"][:, :, None, None])
    torch.testing.assert_close(fused.concat_bn_relu_conv1x1(a, b, **kw4), got,
                               atol=0, rtol=0)


def _bad(case):
    (a, b), kw = _torch_args(_operands(np.random.default_rng(2), 1, 4, 6, 8, 8, 16))
    if case == "pixels":
        b = b[:, :3]
    elif case == "rank":
        a = a[0]
    elif case == "dtype_mix":
        b = b.double()
    elif case == "dtype":
        a, b = a.half(), b.half()
    elif case == "weight_in":
        kw["weight"] = kw["weight"][:, :15]
    elif case == "weight_taps":
        kw["weight"] = kw["weight"][:, :, None, None].expand(-1, -1, 3, 3)
    elif case == "stats":
        kw["var"] = kw["var"][:15]
    elif case == "devices":
        kw["mean"] = kw["mean"].to("meta")
    elif case == "no_kernel":
        a, b = a.to("meta"), b.to("meta")
        kw = {k: v.to("meta") for k, v in kw.items()}
    return a, b, kw


@pytest.mark.parametrize("case,error", [
    ("pixels", ValueError), ("rank", ValueError), ("dtype_mix", TypeError),
    ("dtype", TypeError), ("weight_in", ValueError), ("weight_taps", ValueError),
    ("stats", ValueError), ("devices", ValueError), ("no_kernel", ValueError),
])
def test_wrapper_rejects(case, error):
    a, b, kw = _bad(case)
    with pytest.raises(error):
        fused.concat_bn_relu_conv1x1(a, b, **kw)


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    from dmmfods_tpu_torch.ops import _build

    lib = _build.load()
    # bf16 on operands packed beforehand: the serving shape, the 1280x1920
    # fuse, a row count that is not a multiple of the 128-row tile (1,599),
    # and one width that is not a multiple of 8, which runs the CUDA-core body
    bf16_cases = [((2, 16, 24, 128, 128, 128), True), ((1, 80, 120, 256, 256, 256), True),
                  ((3, 13, 41, 128, 128, 128), True), ((1, 25, 40, 12, 20, 24), False)]
    for shape, dtype, bound, packed in [((2, 16, 24, 128, 128, 128), BF16, 1e-2, False),
                                        ((1, 25, 40, 48, 16, 40), torch.float32, 1e-4, False)
                                        ] + [(s, BF16, 1e-2, True) for s, _ in bf16_cases]:
        ops = _operands(np.random.default_rng(3), *shape)
        (a, b), kw = _torch_args(ops, "cuda", dtype)
        kw["weight"] = kw["weight"].to(dtype).float()
        if packed:
            kw["operands"] = _fuse_operands(kw, dtype)
            mma = dict(bf16_cases)[shape]
            assert (lib.dmm_concat_bn_relu_conv1x1_tile_n(*shape[3:]) != 0) == mma
        before = fused.K1_LAUNCHES.value
        got = fused.concat_bn_relu_conv1x1(a, b, **kw)
        torch.cuda.synchronize()
        assert fused.K1_LAUNCHES.value == before + 1
        want = fused.concat_bn_relu_conv1x1_reference(
            a.float(), b.float(), **{k: v for k, v in kw.items() if k != "operands"})
        err = (got.float() - want).abs().max().item()
        assert err <= bound * want.abs().max().item()
        with pytest.raises(ValueError):   # the kernel takes contiguous NHWC only
            fused.concat_bn_relu_conv1x1(a.transpose(1, 2), b.transpose(1, 2), **kw)


def _fuse_operands(kw, dtype):
    return fused.fuse_operands(kw["scale"], kw["bias"], kw["mean"], kw["var"], kw["weight"],
                               1e-5, dtype)


@pytest.mark.parametrize("ca,cb,cout", [(128, 128, 128), (256, 256, 256), (48, 16, 40),
                                        (8, 8, 8)])
def test_pack_fuse_weights(ca, cb, cout):
    """The bf16 kernel's B operand: ``(K, N_pad)`` with Cout rounded up to
    16, the unpadded block ``weight.reshape(Cout, K).t()`` in bf16, zeros in
    every pad entry."""
    k = ca + cb
    weight = torch.from_numpy(np.random.default_rng(k + cout).normal(
        size=(cout, k, 1, 1)).astype(np.float32))
    packed = fused.pack_fuse_weights(weight)
    n_pad = -(-cout // 16) * 16
    assert packed.shape == (k, n_pad) == fused.packed_shape(k, cout)
    assert packed.dtype == BF16 and packed.is_contiguous()
    assert torch.equal(packed[:, :cout], weight.reshape(cout, k).t().to(BF16))
    assert (packed[:, cout:] == 0).all() and packed[:, cout:].numel() == k * (n_pad - cout)
    with pytest.raises(TypeError):
        fused.pack_fuse_weights(weight, torch.float32)


def _pad_k(c):
    return -(-c // 32) * 32


def _gemm_form(a, b, gamma, beta, packed, cout):
    """The bf16 kernel's form: each stream's channels padded to a multiple of
    32 (zero gamma, beta and weight rows), x * gamma + beta and ReLU in f32
    rounded once to ``a``'s dtype, the weight unpacked in K order a then b,
    f32 accumulation. Returns the output and the normalized operands."""
    ca, cb = a.shape[-1], b.shape[-1]
    rows = a.numel() // ca
    ka, kb = _pad_k(ca), _pad_k(cb)
    src = torch.zeros(rows, ka + kb)
    src[:, :ca] = a.reshape(rows, ca).float()
    src[:, ka:ka + cb] = b.reshape(rows, cb).float()
    g = torch.zeros(ka + kb)
    be = torch.zeros(ka + kb)
    w = torch.zeros(ka + kb, packed.shape[1])
    for lo, n, off in ((0, ca, 0), (ka, cb, ca)):
        g[lo:lo + n], be[lo:lo + n] = gamma[off:off + n], beta[off:off + n]
        w[lo:lo + n] = packed[off:off + n].float()
    normalized = torch.relu(src * g + be).to(a.dtype)
    out = (normalized.float() @ w)[:, :cout]
    return out.reshape(*a.shape[:-1], cout), normalized, (ka, kb)


@pytest.mark.parametrize("shape", [
    (2, 16, 24, 128, 128, 128),   # the serving shape's channels
    (2, 5, 7, 12, 20, 24),        # ragged channels
    (1, 10, 12, 256, 256, 256),   # the 1280x1920 fuse's channels
])
def test_gemm_form_matches_plain(shape):
    """In f32, the GEMM form on the weight in its packed layout equals the
    plain version (the padding, the K order and the packing are the plain
    function); in bf16, its normalized operands are the plain version's
    ``an`` and ``bn`` bit for bit, zeros in the padding."""
    ops = _operands(np.random.default_rng(4), *shape)
    (a, b), kw = _torch_args(ops)
    ca, cb, cout = shape[3:]
    gamma, beta, _ = _fuse_operands(kw, torch.float32)
    packed = kw["weight"].reshape(cout, ca + cb).t()        # the packed layout in f32
    got, _, _ = _gemm_form(a, b, gamma, beta, packed, cout)
    want = fused.concat_bn_relu_conv1x1_reference(a, b, **kw)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)

    a16, b16 = a.to(BF16), b.to(BF16)
    _, _, packed16 = _fuse_operands(kw, BF16)
    got16, normalized, (ka, kb) = _gemm_form(a16, b16, gamma, beta, packed16, cout)
    an = torch.relu(a16.float() * gamma[:ca] + beta[:ca]).to(BF16).reshape(-1, ca)
    bn = torch.relu(b16.float() * gamma[ca:] + beta[ca:]).to(BF16).reshape(-1, cb)
    assert torch.equal(normalized[:, :ca], an) and torch.equal(normalized[:, ka:ka + cb], bn)
    assert (normalized[:, ca:ka] == 0).all() and (normalized[:, ka + cb:] == 0).all()
    # the plain version rounds each of its two bf16 matmuls and their sum, the
    # GEMM form once: chip_smoke.py's bf16 bound
    want16 = fused.concat_bn_relu_conv1x1_reference(a16, b16, **kw).float()
    assert (got16 - want16).abs().max() <= 1e-2 * want16.abs().max()


@pytest.mark.parametrize("case,error", [
    ("gamma_shape", ValueError), ("beta_dtype", ValueError), ("gamma_device", ValueError),
    ("packed_shape", ValueError), ("packed_dtype", ValueError), ("packed_device", ValueError),
    ("packed_missing", ValueError), ("packed_unaligned", ValueError), ("f32_inputs", TypeError),
])
def test_wrapper_rejects_operands(case, error):
    """``operands`` of the wrong shape, dtype or device, a packed weight that
    is missing for bf16, off a 16-byte boundary or given with f32 inputs,
    raise (on the CPU too, where the plain version then runs)."""
    (a, b), kw = _torch_args(_operands(np.random.default_rng(7), 1, 4, 6, 8, 8, 16))
    a, b = a.to(BF16), b.to(BF16)
    gamma, beta, packed = _fuse_operands(kw, BF16)
    if case == "gamma_shape":
        gamma = gamma[:15]
    elif case == "beta_dtype":
        beta = beta.double()
    elif case == "gamma_device":
        gamma = gamma.to("meta")
    elif case == "packed_shape":
        packed = packed[:, :8].contiguous()
    elif case == "packed_dtype":
        packed = packed.float()
    elif case == "packed_device":
        packed = packed.to("meta")
    elif case == "packed_missing":
        packed = None
    elif case == "packed_unaligned":
        flat = torch.zeros(packed.numel() + 1, dtype=BF16)
        flat[1:] = packed.reshape(-1)
        packed = flat[1:].view(packed.shape)
        assert packed.data_ptr() % 16 and torch.equal(packed, _fuse_operands(kw, BF16)[2])
    elif case == "f32_inputs":
        a, b = a.float(), b.float()
    with pytest.raises(error):
        fused.concat_bn_relu_conv1x1(a, b, **kw, operands=(gamma, beta, packed))
    got = fused.concat_bn_relu_conv1x1(a.to(BF16), b.to(BF16), **kw,
                                       operands=_fuse_operands(kw, BF16))
    torch.testing.assert_close(got, fused.concat_bn_relu_conv1x1_reference(
        a.to(BF16), b.to(BF16), **kw), atol=0, rtol=0)
