"""The port's phase-space head (``dmmfods_tpu_torch/ops/phase_head.py``
``phase_space_*`` and ``Head`` in ``models/dense_unet_lidar.py``) and the
``gpu.use_fused_kernels`` switch, against the JAX package, in f32 on the CPU
(JAX at matmul precision "highest").

* The block-space refine1 weight ``w1p`` against JAX's
  ``fold_phase_head_weights``, exactly (each entry is one tap or zero).
* The phase-space eval head and its window grid ``P`` against JAX's
  ``phase_space_head`` (its ``slices`` form, the one the port runs) and
  ``phase_head_conv0``.
* The eval ``Head`` against ``jm.Head(use_fused=True)`` at batch 2 and at
  batch 1 below ``HEAD_KERNEL_MIN_PIXELS``, with ``F.interpolate`` spied on:
  the upsample never runs.
* The train ``Head`` (the plain head) against JAX's ``_phase_head_train``:
  the logits, the gradients with respect to ``x_lo``, ``raw`` and the four
  modules' parameters as one vector (2e-3, as the train step's), and the
  running stats of norm0 and norm1 at 1e-4 (relative, per tensor), with
  ``num_batches_tracked`` counted once.
* ``gpu.use_fused_kernels = False``: the tiny model's eval logits against
  JAX's model built with ``tpu.use_fused_kernels = False``, with K1's and
  K3's wrappers spied on (neither is called, with the K3 gate lowered).

Tolerance atol/rtol 1e-4 (the JAX side folds its BN and sums its phase-space
weights in another order) unless a test says otherwise."""

import dataclasses
import math
from collections.abc import Mapping

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from dmmfods_tpu.config import get_config as jax_get_config
from dmmfods_tpu.models import dense_unet_lidar as jm
from dmmfods_tpu.ops import fused as jax_fused
from dmmfods_tpu_torch.config import get_config
from dmmfods_tpu_torch.models import dense_unet_lidar as pm
from dmmfods_tpu_torch.models.weights import state_dict_from_jax
from dmmfods_tpu_torch.ops import phase_head as k3
from dmmfods_tpu_torch.ops.fused import fold_bn

TOL = dict(atol=1e-4, rtol=1e-4)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _nchw(x):
    return _t(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _randomize(tree, rng):
    """Every leaf of a JAX variable tree drawn anew as numpy f32: conv kernels
    kaiming-scaled over their fan-in, BN scale and var in [0.5, 1.5], bias
    and mean N(0, 0.1)."""
    def draw(name, shape):
        if name == "kernel":
            return rng.normal(0, math.sqrt(2 / math.prod(shape[:-1])), shape)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape)
        return rng.normal(0, 0.1, shape)

    return {k: _randomize(v, rng) if isinstance(v, Mapping)
            else draw(k, v.shape).astype(np.float32) for k, v in tree.items()}


def _head_case(seed, b, hh, hw, c_up, rc, c_mid, n_cls):
    """Inputs, a JAX Head and its randomised variables."""
    rng = np.random.default_rng(seed)
    x_lo = rng.normal(size=(b, hh, hw, c_up)).astype(np.float32)
    raw = rng.uniform(0, 1, (b, 2 * hh, 2 * hw, rc)).astype(np.float32)
    jmod = jm.Head(mid_features=c_mid, num_classes=n_cls, dtype=jnp.float32, use_fused=True)
    init = jax.jit(lambda key: jmod.init(key, x_lo, raw, False))(jax.random.PRNGKey(0))
    variables = _randomize({c: init[c] for c in ("params", "batch_stats")}, rng)
    return x_lo, raw, jmod, variables


def _port_head(variables, c_up, rc, c_mid, n_cls, **kwargs):
    """The port's Head with the JAX variables (HWIO kernels to torch's order)."""
    head = pm.Head(c_up, rc, c_mid, n_cls, **kwargs)
    sd = {}
    for m, leaves in variables["params"].items():
        for k, v in leaves.items():
            sd[f"{m}.{'weight' if k in ('kernel', 'scale') else 'bias'}"] = (
                _t(np.transpose(v, (3, 2, 0, 1))) if k == "kernel" else _t(v))
    for m, leaves in variables["batch_stats"].items():
        sd[f"{m}.running_mean"], sd[f"{m}.running_var"] = _t(leaves["mean"]), _t(leaves["var"])
    missing, unexpected = head.load_state_dict(sd, strict=False)
    assert unexpected == [] and all(k.endswith("num_batches_tracked") for k in missing)
    return head.to(memory_format=torch.channels_last)


@pytest.mark.parametrize("c_mid,n_cls", [(16, 3), (7, 5)])
def test_fold_refine1_weights_matches_jax(c_mid, n_cls):
    rng = np.random.default_rng(21)
    w0 = rng.normal(size=(3, 3, 12, c_mid)).astype(np.float32)
    w1 = rng.normal(size=(5, 5, c_mid, n_cls)).astype(np.float32)
    _, want = jax_fused.fold_phase_head_weights(w0, w1, 8, 4)
    got = k3.fold_refine1_weights(_t(w1).permute(3, 2, 0, 1))
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (3, 3, 4 * c_mid, 4 * n_cls)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _folded(variables):
    p, s = variables["params"], variables["batch_stats"]
    g0, b0 = fold_bn(_t(p["norm0"]["scale"]), _t(p["norm0"]["bias"]), _t(s["norm0"]["mean"]),
                     _t(s["norm0"]["var"]), 1e-5)
    g1, b1 = fold_bn(_t(p["norm1"]["scale"]), _t(p["norm1"]["bias"]), _t(s["norm1"]["mean"]),
                     _t(s["norm1"]["var"]), 1e-5)
    return g0, b0, g1, b1


def _jax_eval(x_lo, raw, variables, impl):
    def head(x, r, p, s):
        return jax_fused.phase_space_head(
            x, r, norm0=p["norm0"], norm0_stats=s["norm0"],
            refine0_kernel=p["refine0"]["kernel"], norm1=p["norm1"], norm1_stats=s["norm1"],
            refine1_kernel=p["refine1"]["kernel"], refine1_impl=impl)

    return np.asarray(jax.jit(head)(x_lo, raw, variables["params"], variables["batch_stats"]))


@pytest.mark.parametrize("shape", [(2, 5, 7, 12, 4, 8, 3), (1, 6, 9, 20, 3, 10, 2)])
def test_phase_space_head_matches_jax(shape):
    """The eval phase-space head against JAX's ``slices`` form, and the
    window grid ``P`` against JAX's."""
    b, hh, hw, c_up, rc, c_mid, n_cls = shape
    x_lo, raw, _, variables = _head_case(3, *shape)
    g0, b0, g1, b1 = _folded(variables)
    p = variables["params"]
    w0t, w4t = k3.phase_space_weights(_t(p["refine0"]["kernel"]).permute(3, 2, 0, 1),
                                      _t(p["refine1"]["kernel"]).permute(3, 2, 0, 1), c_up)
    a = torch.relu(_nchw(x_lo) * g0[:c_up, None, None] + b0[:c_up, None, None])
    rn = torch.relu(_nchw(raw) * g0[c_up:, None, None] + b0[c_up:, None, None])
    P = k3.phase_head_conv0(a, rn, w0t)
    got = _nhwc(k3.phase_head_refine1(P, g1, b1, w4t, hh, hw))
    want = _jax_eval(x_lo, raw, variables, "slices")
    assert got.shape == want.shape == (b, 2 * hh, 2 * hw, n_cls)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(_nhwc(k3.phase_space_head(
        _nchw(x_lo), _nchw(raw), g0=g0, b0=b0, g1=g1, b1=b1, w0t=w0t, w4t=w4t)), want, **TOL)
    w0p, _ = jax_fused.fold_phase_head_weights(p["refine0"]["kernel"], p["refine1"]["kernel"],
                                               c_up, rc)
    P_jax = jax_fused.phase_head_conv0(jnp.asarray(_nhwc(a)), jnp.asarray(_nhwc(rn)), w0p,
                                       jnp.float32)
    np.testing.assert_allclose(_nhwc(P), np.asarray(P_jax), **TOL)


@pytest.mark.parametrize("b,hh,hw", [(2, 6, 9), (1, 8, 12)])
def test_eval_head_matches_jax_fused_head(monkeypatch, b, hh, hw):
    """The eval Head below K3's gate (batch 2, and batch 1 on a plane of at
    most ``HEAD_KERNEL_MIN_PIXELS`` pixels) runs the phase-space head: equal
    to ``jm.Head(use_fused=True)``, no upsample, no K3."""
    x_lo, raw, jmod, variables = _head_case(5, b, hh, hw, 16, 4, 8, 3)
    want = np.asarray(jmod.apply(variables, x_lo, raw, False))
    head = _port_head(variables, 16, 4, 8, 3).eval()
    calls = []
    monkeypatch.setattr(F, "interpolate", lambda *a, **k: calls.append("interpolate"))
    monkeypatch.setattr(pm, "phase_head", lambda *a, **k: calls.append("K3"))
    with torch.no_grad():
        got = _nhwc(head(_nchw(x_lo), _nchw(raw)))
    assert calls == []
    assert 4 * hh * hw <= pm.HEAD_KERNEL_MIN_PIXELS
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("b,hh,hw", [(2, 6, 9), (1, 8, 12)])
def test_train_head_matches_jax_phase_head_train(monkeypatch, b, hh, hw):
    """The train Head, the plain head, against JAX's ``_phase_head_train``:
    logits, the gradients (x_lo, raw and the four modules' parameters, one
    vector, 2e-3) and norm0's and norm1's running stats after the step
    (1e-4)."""
    c_up, rc, c_mid, n_cls = 16, 4, 8, 3
    x_lo, raw, jmod, variables = _head_case(7, b, hh, hw, c_up, rc, c_mid, n_cls)
    ct = np.random.default_rng(8).normal(size=(b, 2 * hh, 2 * hw, n_cls)).astype(np.float32)

    def loss(params, x, r):
        out, updated = jmod.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                  x, r, True, mutable=["batch_stats"])
        return jnp.sum(out * ct), (out, updated["batch_stats"])

    grads, (want, stats) = jax.jit(jax.grad(loss, argnums=(0, 1, 2), has_aux=True))(
        variables["params"], x_lo, raw)
    head = _port_head(variables, c_up, rc, c_mid, n_cls).train()
    calls = []
    interpolate = F.interpolate
    monkeypatch.setattr(F, "interpolate",
                        lambda *a, **k: calls.append("interpolate") or interpolate(*a, **k))
    x = _nchw(x_lo).requires_grad_()
    r = _nchw(raw).requires_grad_()
    out = head(x, r)
    (out * _nchw(ct)).sum().backward()
    assert calls == ["interpolate"]
    np.testing.assert_allclose(_nhwc(out), np.asarray(want), **TOL)

    pairs = [(x.grad, _t(np.asarray(grads[1])).permute(0, 3, 1, 2)),
             (r.grad, _t(np.asarray(grads[2])).permute(0, 3, 1, 2))]
    for name, module in head.named_children():
        jp = grads[0][name]
        pairs.append((module.weight.grad, _t(np.asarray(jp["kernel"])).permute(3, 2, 0, 1)
                      if "kernel" in jp else _t(np.asarray(jp["scale"]))))
        if "bias" in jp:
            pairs.append((module.bias.grad, _t(np.asarray(jp["bias"]))))
    assert len(pairs) == 8
    num = sum(float(((got - w) ** 2).sum()) for got, w in pairs)
    den = sum(float((w ** 2).sum()) for _, w in pairs)
    assert (num / den) ** 0.5 <= 2e-3

    for name in ("norm0", "norm1"):
        norm = getattr(head, name)
        assert int(norm.num_batches_tracked) == 1
        for buf, key in ((norm.running_mean, "mean"), (norm.running_var, "var")):
            ref = _t(np.asarray(stats[name][key]))
            assert float((buf - ref).norm() / ref.norm()) <= 1e-4, (name, key)


def _tiny_model(tmp_path, fused):
    """The tiny mid-fusion JAX model and the port's loaded with the same
    random weights, both in f32 with ``use_fused_kernels`` set to ``fused``."""
    jcfg, pcfg = jax_get_config(str(tmp_path)), get_config(str(tmp_path))
    for cfg in (jcfg, pcfg):
        cfg.model.growth_rate = 8
        cfg.model.block_config = (2, 2, 2, 2)
        cfg.model.num_init_features = 16
    jcfg.tpu.compute_dtype = pcfg.gpu.compute_dtype = "float32"
    jcfg.tpu.use_fused_kernels = pcfg.gpu.use_fused_kernels = fused
    jspec, pspec = jm.ModelSpec.from_config(jcfg), pm.ModelSpec.from_config(pcfg)
    assert jspec.use_fused_kernels == pspec.use_fused_kernels == fused
    jmodule = jm.DenseUNetLidar(jspec)
    rng = np.random.default_rng(17)
    rgb = rng.uniform(0, 1, (1, 64, 96, 3)).astype(np.float32)
    lidar = rng.uniform(0, 1, (1, 64, 96, 1)).astype(np.float32)
    init = jax.jit(lambda key: jmodule.init(key, rgb, lidar, False))(jax.random.PRNGKey(0))
    variables = _randomize({c: init[c] for c in ("params", "batch_stats")}, rng)
    port = pm.DenseUNetLidar(pspec)
    port.load_state_dict(state_dict_from_jax(variables, pspec), strict=True)
    return jmodule, variables, port.eval(), rgb, lidar


def test_no_fused_kernels_matches_jax_without_them(tmp_path, monkeypatch):
    """``gpu.use_fused_kernels = False``: eval runs the plain concat and head
    (K1's and K3's wrappers never called, even with K3's gate lowered to
    this plane) and gives JAX's logits with ``tpu.use_fused_kernels =
    False``."""
    jmodule, variables, port, rgb, lidar = _tiny_model(tmp_path, fused=False)
    want = np.asarray(jax.jit(lambda v: jmodule.apply(v, rgb, lidar, False))(variables))
    calls = []

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(pm, "concat_bn_relu_conv1x1", spy("K1", pm.concat_bn_relu_conv1x1))
    monkeypatch.setattr(pm, "phase_head", spy("K3", pm.phase_head))
    monkeypatch.setattr(pm, "phase_space_head", spy("phase", pm.phase_space_head))
    monkeypatch.setattr(pm, "HEAD_KERNEL_MIN_PIXELS", 64)
    assert not port.concat_module.use_fused and not port.dec_out_to_heat_maps.use_fused
    with torch.no_grad():
        got = port(_t(rgb), _t(lidar)).numpy()
    assert calls == []
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, **TOL)
    # the same weights with the switch on: K1 and K3 (the gate lowered)
    fused = pm.DenseUNetLidar(dataclasses.replace(port.spec, use_fused_kernels=True))
    fused.load_state_dict(port.state_dict())
    with torch.no_grad():
        on = fused.eval()(_t(rgb), _t(lidar)).numpy()
    assert calls == ["K1", "K3"]
    np.testing.assert_allclose(on, want, **TOL)
