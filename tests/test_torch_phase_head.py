"""K3, the head of the port (``dmmfods_tpu_torch/ops/phase_head.py``): the
plain version against the JAX strip head (``phase_space_head(...,
refine1_impl="strip")``, the Pallas kernel in interpret mode off the TPU),
the kernel's phase-space refine0 weights (``fold_phase_head_weights``)
against JAX's, the eval ``Head``'s dispatch against its plain form, the
wrapper's argument checks, and that a CPU tensor takes the plain version.
All in f32 at batch 1; tolerance atol 2e-4, the JAX head test's own (the JAX
side sums its collapsed phase-space weights in another order). The kernel itself runs
only on the card: ``test_kernel_matches_plain_on_cuda`` skips without one,
and ``chip_smoke.py`` checks it at the 1280x1920 shape."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dmmfods_tpu.ops import fused as jax_fused
from dmmfods_tpu_torch.models import dense_unet_lidar as pm
from dmmfods_tpu_torch.ops import phase_head as k3
from dmmfods_tpu_torch.ops.fused import fold_bn

ATOL = 2e-4


def _case(rng, hh, hw, c_up, rc, c_mid, n_cls):
    """numpy inputs, HWIO kernels and BN dicts of one head."""
    def bn(c):
        return ({"scale": rng.normal(size=c).astype(np.float32),
                 "bias": rng.normal(size=c).astype(np.float32)},
                {"mean": rng.normal(size=c).astype(np.float32),
                 "var": (np.abs(rng.normal(size=c)) + 0.5).astype(np.float32)})

    n0, s0 = bn(c_up + rc)
    n1, s1 = bn(c_mid)
    return dict(
        x_lo=rng.normal(size=(1, hh, hw, c_up)).astype(np.float32),
        raw=rng.normal(size=(1, 2 * hh, 2 * hw, rc)).astype(np.float32),
        w0=(rng.normal(size=(3, 3, c_up + rc, c_mid)) * 0.1).astype(np.float32),
        w1=(rng.normal(size=(5, 5, c_mid, n_cls)) * 0.1).astype(np.float32),
        n0=n0, s0=s0, n1=n1, s1=s1)


def _port_args(case):
    t = torch.from_numpy
    g0, b0 = fold_bn(t(case["n0"]["scale"]), t(case["n0"]["bias"]),
                     t(case["s0"]["mean"]), t(case["s0"]["var"]), 1e-5)
    g1, b1 = fold_bn(t(case["n1"]["scale"]), t(case["n1"]["bias"]),
                     t(case["s1"]["mean"]), t(case["s1"]["var"]), 1e-5)
    return (t(case["x_lo"]), t(case["raw"])), dict(
        g0=g0, b0=b0, w0=t(case["w0"]).permute(3, 2, 0, 1).contiguous(),
        g1=g1, b1=b1, w1=t(case["w1"]).permute(3, 2, 0, 1).contiguous())


@pytest.mark.parametrize("hh,hw,c_up,rc,c_mid,n_cls", [
    (8, 12, 32, 4, 16, 3),      # tests/test_fused.py's head at B = 1
    (16, 10, 24, 3, 20, 2),     # other widths, two strips
])
def test_plain_version_matches_jax_strip_head(hh, hw, c_up, rc, c_mid, n_cls):
    case = _case(np.random.default_rng(0), hh, hw, c_up, rc, c_mid, n_cls)
    want = np.asarray(jax_fused.phase_space_head(
        jnp.asarray(case["x_lo"]), jnp.asarray(case["raw"]), norm0=case["n0"],
        norm0_stats=case["s0"], refine0_kernel=case["w0"], norm1=case["n1"],
        norm1_stats=case["s1"], refine1_kernel=case["w1"], refine1_impl="strip"))
    (x_lo, raw), kw = _port_args(case)
    got = k3.phase_head_reference(x_lo, raw, **kw).numpy()
    assert got.shape == want.shape == (1, 2 * hh, 2 * hw, n_cls)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("c_up,rc", [(32, 4), (5, 3)])
def test_fold_phase_head_weights_matches_jax(c_up, rc):
    rng = np.random.default_rng(5)
    w0 = (rng.normal(size=(3, 3, c_up + rc, 16)) * 0.1).astype(np.float32)
    w1 = (rng.normal(size=(5, 5, 16, 3)) * 0.1).astype(np.float32)
    want, _ = jax_fused.fold_phase_head_weights(w0, w1, c_up, rc)
    got = k3.fold_phase_head_weights(torch.from_numpy(w0).permute(3, 2, 0, 1), c_up)
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (2, 2, c_up + 4 * rc, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def test_eval_head_dispatch_matches_plain_form(monkeypatch):
    """Above the gate the eval head runs K3's wrapper (its plain version on
    the CPU); below it, in train mode or at batch 2, the plain form."""
    rng = np.random.default_rng(1)
    case = _case(rng, 6, 9, 12, 4, 8, 3)
    head = pm.Head(12, 4, 8, 3)
    (x_lo, raw), kw = _port_args(case)
    with torch.no_grad():
        for norm, n, s in ((head.norm0, "n0", "s0"), (head.norm1, "n1", "s1")):
            norm.weight.copy_(torch.from_numpy(case[n]["scale"]))
            norm.bias.copy_(torch.from_numpy(case[n]["bias"]))
            norm.running_mean.copy_(torch.from_numpy(case[s]["mean"]))
            norm.running_var.copy_(torch.from_numpy(case[s]["var"]))
        head.refine0.weight.copy_(kw["w0"])
        head.refine1.weight.copy_(kw["w1"])
    head.eval()
    calls = []

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return k3.phase_head(*args, **kwargs)

    monkeypatch.setattr(pm, "phase_head", spy)
    x_nchw, raw_nchw = x_lo.permute(0, 3, 1, 2), raw.permute(0, 3, 1, 2)
    with torch.no_grad():
        plain = head(x_nchw, raw_nchw)
        assert calls == []                       # 216 px <= HEAD_KERNEL_MIN_PIXELS
        monkeypatch.setattr(pm, "HEAD_KERNEL_MIN_PIXELS", 12 * 18 - 1)
        got = head(x_nchw, raw_nchw)
        assert calls == [(1, 6, 9, 12)]
        head(x_nchw.expand(2, -1, -1, -1), raw_nchw.expand(2, -1, -1, -1))
        head.train()(x_nchw, raw_nchw)
    assert len(calls) == 1
    assert got.shape == (1, 3, 12, 18)
    torch.testing.assert_close(got, plain, atol=ATOL, rtol=0)
    torch.testing.assert_close(
        got.permute(0, 2, 3, 1), k3.phase_head_reference(x_lo, raw, **kw), atol=0, rtol=0)


def test_cpu_tensor_takes_the_plain_version():
    (x_lo, raw), kw = _port_args(_case(np.random.default_rng(2), 3, 5, 6, 2, 4, 3))
    before = k3.K3_LAUNCHES.value
    got = k3.phase_head(x_lo, raw, **kw)
    assert k3.K3_LAUNCHES.value == before
    assert got.shape == (1, 6, 10, 3)
    torch.testing.assert_close(got, k3.phase_head_reference(x_lo, raw, **kw),
                               atol=0, rtol=0)


@pytest.mark.parametrize("case,error", [
    ("rank", ValueError), ("raw_size", ValueError), ("dtype_mix", TypeError),
    ("dtype", TypeError), ("w0_in", ValueError), ("w1_taps", ValueError),
    ("g1", ValueError), ("fold_dtype", TypeError), ("devices", ValueError),
    ("no_kernel", ValueError),
])
def test_wrapper_rejects(case, error):
    (x_lo, raw), kw = _port_args(_case(np.random.default_rng(3), 3, 5, 6, 2, 4, 3))
    if case == "rank":
        x_lo = x_lo[0]
    elif case == "raw_size":
        raw = raw[:, :5]
    elif case == "dtype_mix":
        raw = raw.double()
    elif case == "dtype":
        x_lo, raw = x_lo.half(), raw.half()
    elif case == "w0_in":
        kw["w0"] = kw["w0"][:, :7]
    elif case == "w1_taps":
        kw["w1"] = kw["w1"][:, :, 1:4, 1:4]
    elif case == "g1":
        kw["g1"] = kw["g1"][:3]
    elif case == "fold_dtype":
        kw["b0"] = kw["b0"].double()
    elif case == "devices":
        kw["w1"] = kw["w1"].to("meta")
    elif case == "no_kernel":
        x_lo, raw = x_lo.to("meta"), raw.to("meta")
        kw = {k: v.to("meta") for k, v in kw.items()}
    with pytest.raises(error):
        k3.phase_head(x_lo, raw, **kw)


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    for shape, dtype, bound in [((13, 21, 40, 3, 20, 3), torch.float32, 1e-4),
                                ((40, 60, 128, 4, 64, 3), torch.bfloat16, 1e-2)]:
        (x_lo, raw), kw = _port_args(_case(np.random.default_rng(4), *shape))
        kw = {k: v.cuda() for k, v in kw.items()}
        kw["w0"] = kw["w0"].to(dtype).float()
        kw["w1"] = kw["w1"].to(dtype).float()
        x_lo, raw = x_lo.cuda().to(dtype), raw.cuda().to(dtype)
        before = k3.K3_LAUNCHES.value
        got = k3.phase_head(x_lo, raw, **kw)
        torch.cuda.synchronize()
        assert k3.K3_LAUNCHES.value == before + 1
        want = k3.phase_head_reference(x_lo.float(), raw.float(), **kw)
        err = (got.float() - want).abs().max().item()
        assert err <= bound * want.abs().max().item()
        with pytest.raises(ValueError):   # the kernel takes contiguous NHWC only
            k3.phase_head(x_lo.transpose(1, 2).contiguous().transpose(1, 2), raw, **kw)
