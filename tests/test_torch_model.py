"""The port's model (``dmmfods_tpu_torch/models``) against the JAX model.

Weights and BN running stats are randomised with numpy from a seed, given to
the JAX module, and carried into the port by ``state_dict_from_jax``; both
run the same inputs in f32 on the CPU (JAX at matmul precision "highest",
set by ``conftest.py``) in eval mode, the JAX side with its config defaults
(``use_fused_kernels=True``: the fused concat's jnp path and the phase-space
head). Tolerance: atol 1e-4 / rtol 1e-4, f32 summation-order noise.
"""

import math
from collections.abc import Mapping

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dmmfods_tpu.config import get_config as jax_get_config
from dmmfods_tpu.models import dense_unet_lidar as jm
from dmmfods_tpu.models import torch_port
from dmmfods_tpu_torch.config import get_config
from dmmfods_tpu_torch.models import dense_unet_lidar as pm
from dmmfods_tpu_torch.models.weights import state_dict_from_jax

H, W, BATCH = 64, 96, 2
TOL = dict(atol=1e-4, rtol=1e-4)


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _rebuild(tree, fn, prefix=()):
    return {k: _rebuild(v, fn, prefix + (k,)) if isinstance(v, Mapping)
            else fn(prefix + (k,), v) for k, v in tree.items()}


def _randomize(variables, seed):
    """Every param and BN running stat nontrivial, as numpy f32 arrays: conv
    kernels kaiming-scaled over their fan-in (activations stay O(1) through
    the depth), BN scale/var in [0.5, 1.5], bias/mean N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def draw(path, value):
        shape, name = tuple(value.shape), path[-1]
        if name == "kernel":
            arr = rng.normal(0, math.sqrt(2 / math.prod(shape[:-1])), shape)
        elif name in ("scale", "var"):
            arr = rng.uniform(0.5, 1.5, shape)
        else:
            arr = rng.normal(0, 0.1, shape)
        return arr.astype(np.float32)

    return {c: _rebuild(variables[c], draw) for c in ("params", "batch_stats")}


def _load(module, variables, transposed=()):
    """Independent of ``state_dict_from_jax``: JAX variables of a sub-module
    into the port module with the same child names."""
    names = {"kernel": "weight", "scale": "weight", "bias": "bias",
             "mean": "running_mean", "var": "running_var"}
    sd = {}
    for collection in ("params", "batch_stats"):
        for path, value in _leaves(variables.get(collection, {})):
            value = np.asarray(value, np.float32)
            if path[-1] == "kernel":
                value = (np.transpose(np.flip(value, (0, 1)), (2, 3, 0, 1))
                         if path[:-1] in transposed
                         else np.transpose(value, (3, 2, 0, 1)))
            sd[".".join(path[:-1] + (names[path[-1]],))] = torch.from_numpy(
                np.ascontiguousarray(value))
    missing, unexpected = module.load_state_dict(sd, strict=False)
    assert unexpected == [] and all(k.endswith("num_batches_tracked") for k in missing)
    return module.eval()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _jax_init(module, *args):
    return jax.jit(lambda key: module.init(key, *args))(jax.random.PRNGKey(0))


def _tiny_configs(tmp, cbn=2, s2=1):
    """The JAX and port configs of one tiny architecture, both in f32."""
    out = []
    for cfg in (jax_get_config(str(tmp)), get_config(str(tmp))):
        cfg.model.growth_rate = 8
        cfg.model.block_config = (2, 2, 2, 2)
        cfg.model.num_init_features = 16
        cfg.model.concat_before_block_num = cbn
        cfg.model.stream_2_in_channels = s2
        out.append(cfg)
    out[0].tpu.compute_dtype = "float32"
    out[1].gpu.compute_dtype = "float32"
    return out


def _model_case(tmp, cbn, s2, seed):
    """A randomised tiny JAX model, its eval logits, and the port's model
    loaded with the same weights."""
    jcfg, pcfg = _tiny_configs(tmp, cbn, s2)
    jspec = jm.ModelSpec.from_config(jcfg)
    assert jspec.use_fused_kernels
    jmodule = jm.DenseUNetLidar(jspec)
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(0, 1, (BATCH, H, W, 3)).astype(np.float32)
    lidar = rng.uniform(0, 1, (BATCH, H, W, 1)).astype(np.float32) if s2 else None
    variables = _randomize(_jax_init(jmodule, rgb, lidar, False), seed)
    logits = np.asarray(jax.jit(lambda v, a, b: jmodule.apply(v, a, b, False))(
        variables, rgb, lidar))
    pspec = pm.ModelSpec.from_config(pcfg)
    port = pm.DenseUNetLidar(pspec)
    port.load_state_dict(state_dict_from_jax(variables, pspec), strict=True)
    return dict(jspec=jspec, variables=variables, rgb=rgb, lidar=lidar,
                logits=logits, port=port.eval())


@pytest.fixture(scope="module")
def mid(tmp_path_factory):
    return _model_case(tmp_path_factory.mktemp("mid"), cbn=2, s2=1, seed=7)


def _port_logits(case):
    lidar = None if case["lidar"] is None else torch.from_numpy(case["lidar"])
    with torch.no_grad():
        return case["port"](torch.from_numpy(case["rgb"]), lidar).numpy()


def test_mid_fusion_logits_match_jax(mid):
    got = _port_logits(mid)
    assert got.shape == (BATCH, H, W, 3)
    assert np.abs(mid["logits"]).max() > 0.1        # not a vanishing signal
    np.testing.assert_allclose(got, mid["logits"], **TOL)


def test_weights_round_trip_through_torch_port(mid):
    """``state_dict_from_jax`` loaded with strict=True (fixture); the port's
    state_dict maps back onto every JAX variable with nothing left over."""
    variables, missing = torch_port.load_full_torch_model(
        mid["variables"], mid["port"].state_dict(), mid["jspec"])
    assert [k for k in missing if not k.endswith("num_batches_tracked")] == []
    for collection in ("params", "batch_stats"):
        want = dict(_leaves(mid["variables"][collection]))
        got = dict(_leaves(variables[collection]))
        assert got.keys() == want.keys()
        for path, value in want.items():
            np.testing.assert_array_equal(np.asarray(got[path]), value,
                                          err_msg="/".join(path))


def test_state_dict_from_jax_rejects_a_wrong_spec(mid):
    wrong = pm.ModelSpec(growth_rate=8, block_config=(2, 2, 2, 2),
                         num_init_features=16, concat_before_block_num=3)
    with pytest.raises(KeyError):
        state_dict_from_jax(mid["variables"], wrong)


@pytest.mark.parametrize("target", [(10, 13), (9, 14)])   # output_padding (1,0), (0,1)
def test_conv_transpose_matches_jax(target):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 7, 6)).astype(np.float32)
    jmod = jm.ConvTransposeToShape(features=4, dtype=jnp.float32)
    variables = _randomize({"params": _jax_init(jmod, x, target)["params"],
                            "batch_stats": {}}, 1)
    kernel = variables["params"]["kernel"]
    assert not np.allclose(kernel, kernel[::-1]) and not np.allclose(kernel, kernel[:, ::-1])
    want = np.asarray(jmod.apply(variables, x, target))
    port = _load(pm.ConvTransposeToShape(6, 4), variables, transposed={()})
    with torch.no_grad():
        got = _nhwc(port(_nchw(x), target))
    assert got.shape == want.shape == (2,) + target + (4,)
    np.testing.assert_allclose(got, want, **TOL)
    with pytest.raises(ValueError):
        port(_nchw(x), (target[0] + 2, target[1]))


def test_decoder_stage_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 4, 6, 8)).astype(np.float32)
    skip = rng.normal(size=(2, 4, 6, 8)).astype(np.float32)
    target = (7, 12)
    jmod = jm.DecoderStage(features=8, dtype=jnp.float32)
    variables = _randomize(_jax_init(jmod, x, skip, target, False), 2)
    want = np.asarray(jmod.apply(variables, x, skip, target, False))
    port = torch.nn.ModuleDict({"stage": pm.DecoderStage(16, 8),
                                "transp_conv": pm.ConvTransposeToShape(8, 8)})
    renamed = {c: {"stage": {k: v for k, v in tree.items() if k != "transp_conv"}}
               for c, tree in variables.items()}
    renamed["params"]["transp_conv"] = variables["params"]["transp_conv"]
    _load(port, renamed, transposed={("transp_conv",)})
    with torch.no_grad():
        got = _nhwc(port["transp_conv"](port["stage"](_nchw(x), _nchw(skip)), target))
    np.testing.assert_allclose(got, want, **TOL)


def test_concat_fuse_matches_jax():
    """Eval: the fused op (K1's plain version on the CPU). Train: batch-stat
    BN over the concat, output and running-stat update."""
    rng = np.random.default_rng(3)
    a = rng.normal(size=(2, 4, 6, 16)).astype(np.float32)
    b = rng.normal(size=(2, 4, 6, 16)).astype(np.float32)
    jmod = jm.ConcatFuse(num_features=16, dtype=jnp.float32, use_fused=True)
    variables = _randomize(_jax_init(jmod, a, b, False), 3)
    port = _load(pm.ConcatFuse(16), variables)
    with torch.no_grad():
        np.testing.assert_allclose(_nhwc(port(_nchw(a), _nchw(b))),
                                   np.asarray(jmod.apply(variables, a, b, False)), **TOL)
        want, updated = jmod.apply(variables, a, b, True, mutable=["batch_stats"])
        got = _nhwc(port.train()(_nchw(a), _nchw(b)))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_allclose(port.norm.running_mean.numpy(),
                               np.asarray(updated["batch_stats"]["norm"]["mean"]), **TOL)
    np.testing.assert_allclose(port.norm.running_var.numpy(),
                               np.asarray(updated["batch_stats"]["norm"]["var"]), **TOL)


def test_head_matches_jax_phase_space_head():
    rng = np.random.default_rng(4)
    x_lo = rng.normal(size=(2, 8, 12, 16)).astype(np.float32)
    raw = rng.uniform(0, 1, (2, 16, 24, 4)).astype(np.float32)
    jmod = jm.Head(mid_features=8, num_classes=3, dtype=jnp.float32, use_fused=True)
    variables = _randomize(_jax_init(jmod, x_lo, raw, False), 4)
    want = np.asarray(jmod.apply(variables, x_lo, raw, False))
    port = _load(pm.Head(16, 4, 8, 3), variables)
    with torch.no_grad():
        got = _nhwc(port(_nchw(x_lo), _nchw(raw)))
    assert got.shape == (2, 16, 24, 3)
    np.testing.assert_allclose(got, want, **TOL)


def test_densenet121_parameter_count(tmp_path):
    bundle = pm.densenet121_u_lidar(config=get_config(str(tmp_path)))
    assert bundle.num_params == 22_409_544
    assert bundle.spec.fusion == "mid" and bundle.spec.dtype == torch.bfloat16
    assert not bundle.module.training
    with pytest.raises(NotImplementedError):
        pm.densenet121_u_lidar(pretrained=True, config=get_config(str(tmp_path)))


@pytest.mark.slow
@pytest.mark.parametrize("cbn,s2", [(1, 0), (1, 1)], ids=["no", "early"])
def test_no_and_early_fusion_logits_match_jax(tmp_path, cbn, s2):
    case = _model_case(tmp_path, cbn, s2, seed=11)
    np.testing.assert_allclose(_port_logits(case), case["logits"], **TOL)


@pytest.mark.slow
def test_densenet121_logits_match_jax_at_128x192(tmp_path):
    jcfg = jax_get_config(str(tmp_path))
    jcfg.tpu.compute_dtype = "float32"
    jspec = jm.ModelSpec.from_config(jcfg)
    jmodule = jm.DenseUNetLidar(jspec)
    rng = np.random.default_rng(5)
    rgb = rng.uniform(0, 1, (1, 128, 192, 3)).astype(np.float32)
    lidar = rng.uniform(0, 1, (1, 128, 192, 1)).astype(np.float32)
    variables = _randomize(_jax_init(jmodule, rgb, lidar, False), 5)
    want = np.asarray(jax.jit(lambda v: jmodule.apply(v, rgb, lidar, False))(variables))
    pcfg = get_config(str(tmp_path))
    pcfg.gpu.compute_dtype = "float32"
    pspec = pm.ModelSpec.from_config(pcfg)
    port = pm.DenseUNetLidar(pspec)
    port.load_state_dict(state_dict_from_jax(variables, pspec), strict=True)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(rgb), torch.from_numpy(lidar)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
