"""K1, the fused concat+BN+ReLU+1x1 of the port
(``dmmfods_tpu_torch/ops/fused.py``): its plain version against the JAX
``concat_bn_relu_conv1x1`` (the jnp path it takes on the CPU), the wrapper's
argument checks, and that a CPU tensor takes the plain version. The kernel
itself runs only on the card: ``test_kernel_matches_plain_on_cuda`` skips
without one, and ``chip_smoke.py`` checks it at the serving shapes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dmmfods_tpu.ops import fused as jax_fused
from dmmfods_tpu_torch.ops import fused


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
    for shape, dtype, bound in [((2, 16, 24, 128, 128, 128), torch.bfloat16, 1e-2),
                                ((1, 25, 40, 48, 16, 40), torch.float32, 1e-4)]:
        ops = _operands(np.random.default_rng(3), *shape)
        (a, b), kw = _torch_args(ops, "cuda", dtype)
        kw["weight"] = kw["weight"].to(dtype).float()
        before = fused.K1_LAUNCHES.value
        got = fused.concat_bn_relu_conv1x1(a, b, **kw)
        torch.cuda.synchronize()
        assert fused.K1_LAUNCHES.value == before + 1
        want = fused.concat_bn_relu_conv1x1_reference(a.float(), b.float(), **kw)
        err = (got.float() - want).abs().max().item()
        assert err <= bound * want.abs().max().item()
        with pytest.raises(ValueError):   # the kernel takes contiguous NHWC only
            fused.concat_bn_relu_conv1x1(a.transpose(1, 2), b.transpose(1, 2), **kw)
