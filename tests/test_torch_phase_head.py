"""K3, the head of the port (``dmmfods_tpu_torch/ops/phase_head.py``): the
plain version against the JAX strip head (``phase_space_head(...,
refine1_impl="strip")``, the Pallas kernel in interpret mode off the TPU),
the kernel's phase-space refine0 weights (``fold_phase_head_weights``)
against JAX's, the bf16 kernel's weight layout (``pack_phase_head_weights``)
against the fold in both of its layouts (DenseNet-121's narrow one and the
wide one of DenseNet-161's c_mid 96 and source 208), the eval ``Head``'s
dispatch against its plain form, the wrapper's argument checks, and that a
CPU tensor takes the plain version. All in f32 at batch 1; tolerance atol
2e-4, the JAX head test's own (the JAX side sums its collapsed phase-space
weights in another order). The kernel itself runs only on the card:
``test_kernel_matches_plain_on_cuda`` skips without one, and
``chip_smoke.py`` checks it at DenseNet-121's and DenseNet-161's 1280x1920
heads (the ``Head``'s kept operands: ``tests/test_torch_eval_operands.py``)."""

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
    (8, 12, 192, 4, 96, 3),     # DenseNet-161's head widths (source 208)
    (8, 13, 200, 3, 90, 5),     # wide and ragged: source 212, c_mid 90, odd width
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


def _unpack_phase_head_weights(w0k, w1k, c_src, c_mid, n_cls):
    """pack_phase_head_weights undone, in f32: (w0p, w1) in the layouts it
    took."""
    cp, cmp = w0k.shape[1] // 4, w0k.shape[2]
    w0 = w0k.float().reshape(4, 4, cp, cmp)[:, :, :c_src, :c_mid]
    w0p = w0.permute(1, 2, 0, 3).reshape(2, 2, c_src, 4 * c_mid)
    w1 = w1k.float().reshape(5, 5, cmp, 8)[:, :, :c_mid, :n_cls].permute(3, 2, 0, 1)
    return w0p, w1


@pytest.mark.parametrize("c_up,rc,c_mid,n_cls,cmp", [
    (128, 4, 64, 3, 64),        # DenseNet-121's 1280x1920 head: the narrow layout
    (40, 3, 20, 3, 64),         # c_src 52 -> 64, c_mid and classes padded
    (40, 3, 64, 8, 64),
    (192, 4, 96, 3, 96),        # DenseNet-161's head: the wide layout (two passes of 48)
    (200, 3, 90, 5, 96),        # c_src 212 -> 224, c_mid 90 -> 96
    (192, 4, 64, 3, 96),        # c_mid 64 on a source past 192: the wide layout, padded
])
def test_pack_phase_head_weights_unpacks_to_fold(c_up, rc, c_mid, n_cls, cmp):
    """The bf16 kernel's layouts hold fold_phase_head_weights's w0p rounded
    once to bf16 and w1 exactly, with zeros in every padding, c_mid padded
    to the mid channels of the layout that takes the shape."""
    rng = np.random.default_rng(9)
    w0 = torch.from_numpy(rng.normal(size=(c_mid, c_up + rc, 3, 3)).astype(np.float32))
    w1 = torch.from_numpy(rng.normal(size=(n_cls, c_mid, 5, 5)).astype(np.float32))
    w1 = w1.to(torch.bfloat16)
    w0p = k3.fold_phase_head_weights(w0.to(torch.bfloat16), c_up)
    w0k, w1k = k3.pack_phase_head_weights(w0p, w1)
    c_src = c_up + 4 * rc
    cp = -(-c_src // 16) * 16
    assert k3.bf16_layout(c_src, c_mid)[1] == cmp
    assert w0k.dtype == w1k.dtype == torch.bfloat16
    assert tuple(w0k.shape) == (4, 4 * cp, cmp) and tuple(w1k.shape) == (25, cmp, 8)
    got0, got1 = _unpack_phase_head_weights(w0k, w1k, c_src, c_mid, n_cls)
    torch.testing.assert_close(got0, w0p.to(torch.bfloat16).float(), atol=0, rtol=0)
    torch.testing.assert_close(got1, w1.float(), atol=0, rtol=0)
    # nothing outside the unpacked entries
    assert (w0k != 0).sum() == (got0 != 0).sum()
    assert (w1k != 0).sum() == (got1 != 0).sum()
    # one element by hand: phase p = 2u + v, tap (r, s), channel c, output n
    r, s, c, p, n = 1, 0, c_src - 1, 3, c_mid - 1
    assert w0k[p, (2 * r + s) * cp + c, n] == w0p[r, s, c, p * c_mid + n].to(torch.bfloat16)
    assert w1k[5 * 4 + 2, c_mid - 1, n_cls - 1] == w1[n_cls - 1, c_mid - 1, 4, 2]


@pytest.mark.parametrize("c_up,rc,c_mid,n_cls", [(256, 4, 64, 3), (40, 3, 128, 3),
                                                 (40, 3, 20, 9)])
def test_pack_refuses_shapes_no_layout_takes(c_up, rc, c_mid, n_cls):
    """A source past 256 channels, c_mid past 96 or more than 8 classes: no
    bf16 layout, so packing raises (and the gate sends the head elsewhere)."""
    w0 = torch.zeros(c_mid, c_up + rc, 3, 3)
    assert not k3.within_limits(c_up + 4 * rc, c_mid, n_cls, torch.bfloat16)
    with pytest.raises(ValueError):
        k3.pack_phase_head_weights(k3.fold_phase_head_weights(w0, c_up),
                                   torch.zeros(n_cls, c_mid, 5, 5))


def test_kernel_weights_per_dtype():
    """kernel_weights: for float32 the f32 fold and w1 as (5, 5, c_mid,
    n_cls); for bfloat16 the fold of the bf16-rounded weights, packed."""
    rng = np.random.default_rng(10)
    w0 = torch.from_numpy(rng.normal(size=(16, 36, 3, 3)).astype(np.float32))
    w1 = torch.from_numpy(rng.normal(size=(3, 16, 5, 5)).astype(np.float32))
    f0, f1 = k3.kernel_weights(w0, w1, 32, torch.float32)
    torch.testing.assert_close(f0, k3.fold_phase_head_weights(w0, 32), atol=0, rtol=0)
    torch.testing.assert_close(f1, w1.permute(2, 3, 1, 0), atol=0, rtol=0)
    b0, b1 = k3.kernel_weights(w0, w1, 32, torch.bfloat16)
    want0, want1 = k3.pack_phase_head_weights(
        k3.fold_phase_head_weights(w0.to(torch.bfloat16), 32), w1.to(torch.bfloat16))
    torch.testing.assert_close(b0, want0, atol=0, rtol=0)
    torch.testing.assert_close(b1, want1, atol=0, rtol=0)


def test_eval_head_dispatch_matches_plain_form(monkeypatch):
    """Above the gate the eval head runs K3's wrapper (its plain version on
    the CPU); below it and at batch 2 the phase-space head, in train mode
    the plain head, never K3; each equal to the plain head (``use_fused =
    False``, the upsample, concat and convs) on the same weights."""
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
    plain_head = pm.Head(12, 4, 8, 3, use_fused=False)
    plain_head.load_state_dict(head.state_dict())
    head.eval()
    plain_head.eval()
    calls = []

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return k3.phase_head(*args, **kwargs)

    monkeypatch.setattr(pm, "phase_head", spy)
    x_nchw, raw_nchw = x_lo.permute(0, 3, 1, 2), raw.permute(0, 3, 1, 2)
    x2, raw2 = x_nchw.expand(2, -1, -1, -1), raw_nchw.expand(2, -1, -1, -1)
    with torch.no_grad():
        plain = plain_head(x_nchw, raw_nchw)
        plain2 = plain_head(x2, raw2)
        below = head(x_nchw, raw_nchw)
        assert calls == []                       # 216 px <= HEAD_KERNEL_MIN_PIXELS
        monkeypatch.setattr(pm, "HEAD_KERNEL_MIN_PIXELS", 12 * 18 - 1)
        got = head(x_nchw, raw_nchw)
        assert calls == [(1, 6, 9, 12)]
        batch2 = head(x2, raw2)
        train = head.train()(x_nchw, raw_nchw)
        plain_train = plain_head.train()(x_nchw, raw_nchw)
    assert calls == [(1, 6, 9, 12)]
    assert got.shape == (1, 3, 12, 18)
    torch.testing.assert_close(got, plain, atol=ATOL, rtol=0)
    torch.testing.assert_close(
        got.permute(0, 2, 3, 1), k3.phase_head_reference(x_lo, raw, **kw), atol=0, rtol=0)
    torch.testing.assert_close(below, plain, atol=ATOL, rtol=0)
    torch.testing.assert_close(batch2, plain2, atol=ATOL, rtol=0)
    torch.testing.assert_close(train, plain_train, atol=0, rtol=0)


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
                                ((40, 60, 128, 4, 64, 3), torch.bfloat16, 1e-2),
                                ((13, 21, 40, 3, 20, 3), torch.bfloat16, 1e-2),
                                ((13, 21, 40, 3, 64, 8), torch.bfloat16, 1e-2),
                                ((40, 60, 192, 4, 96, 3), torch.bfloat16, 1e-2),
                                ((40, 60, 192, 4, 96, 3), torch.float32, 1e-4),
                                ((13, 21, 200, 3, 90, 5), torch.bfloat16, 1e-2),
                                ((9, 17, 240, 4, 96, 3), torch.bfloat16, 1e-2)]:
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
