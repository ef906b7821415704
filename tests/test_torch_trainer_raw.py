"""The port's raw-record steps (``dmmfods_tpu_torch/trainer.py``:
``make_train_step_raw`` / ``_ht``, ``make_eval_step_ht`` / ``_raw``) against
the JAX package's, in f32 on the CPU.

The JAX tests' tiny mid-fusion model (growth 8, blocks (2, 2, 2, 2), 16
initial features) at 32x64 (320x640 full resolution), on a raw batch of two
frames (1,024 points and 8 boxes a frame, from the port's
``make_raw_batch``, equal to JAX's). JAX's host-splat step takes its state 0
to state 1; each step then runs once from state 1 on both sides, the port's
through ``state_dict_from_jax`` and ``optimizer_state_from_jax``, at the
tolerances of ``tests/test_torch_trainer.py`` for one step from the same
state: the loss at rtol 1e-5, the running stats at 1e-4 (relative, per
tensor), every parameter within 2.5 lr and at most 0.1% of them beyond
1e-4; metrics that threshold logits within the few pixels a logit near the
threshold may flip. Tier-1 holds the host-splat train step (whose JAX step
the fixture compiles anyway) and both eval twins against JAX; the train
steps in every ``splat_mode`` are in the slow tier (a JAX train-step
compile of 14 s or more on the CPU each)."""

import numpy as np
import pytest
import torch

import jax

from dmmfods_tpu import trainer as jax_trainer
from dmmfods_tpu.config import get_config as jax_get_config
from dmmfods_tpu.models import dense_unet_lidar as jm
from dmmfods_tpu_torch import trainer
from dmmfods_tpu_torch.config import get_config
from dmmfods_tpu_torch.data.synthetic import make_raw_batch
from dmmfods_tpu_torch.models import dense_unet_lidar as pm
from dmmfods_tpu_torch.models.weights import optimizer_state_from_jax, state_dict_from_jax

BATCH, H, W = 2, 32, 64
FULL = dict(full_height=H * 10, full_width=W * 10)
RAW = dict(max_points=1024, max_boxes=8)
LR = 1e-3


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The JAX and port configs, JAX's model, both raw batches, and JAX's
    states 0 and 1 (one host-splat step)."""
    tmp = tmp_path_factory.mktemp("raw")
    jcfg, pcfg = jax_get_config(str(tmp)), get_config(str(tmp))
    for cfg in (jcfg, pcfg):
        cfg.model.growth_rate = 8
        cfg.model.block_config = (2, 2, 2, 2)
        cfg.model.num_init_features = 16
    jcfg.tpu.compute_dtype = "float32"
    pcfg.gpu.compute_dtype = "float32"
    jmodule = jm.DenseUNetLidar(jm.ModelSpec.from_config(jcfg))
    host = make_raw_batch(BATCH, H, W, seed=0, splat="host", **RAW)
    device = make_raw_batch(BATCH, H, W, seed=0, splat="device", **RAW)
    variables = jax.jit(lambda key: jmodule.init(key, host[0], host[1], False))(
        jax.random.PRNGKey(0))
    tx = jax_trainer.make_optimizer(jcfg)
    state0 = jax_trainer.TrainState(params=variables["params"],
                                    batch_stats=variables["batch_stats"],
                                    opt_state=tx.init(variables["params"]))
    ht_step = jax_trainer.make_train_step_ht(jmodule, tx, jcfg, donate=False, **FULL)
    state1, _ = ht_step(state0, *host)
    return dict(jcfg=jcfg, pcfg=pcfg, jmodule=jmodule, tx=tx, host=host, device=device,
                state1=state1, ht_step=ht_step, pspec=pm.ModelSpec.from_config(pcfg))


def _state_dict(tiny, state):
    return state_dict_from_jax({"params": state.params, "batch_stats": state.batch_stats},
                               tiny["pspec"])


def _port_state(tiny):
    """The port's module and optimizer at JAX's state 1."""
    module = pm.DenseUNetLidar(tiny["pspec"])
    module.load_state_dict(_state_dict(tiny, tiny["state1"]))
    optimizer = trainer.make_optimizer(tiny["pcfg"], module.parameters())
    optimizer.load_state_dict(
        optimizer_state_from_jax(tiny["state1"].opt_state, module, tiny["pcfg"]))
    return trainer.TrainState(module, optimizer)


def _assert_metrics(got, want, rtol=1e-5):
    pixels = BATCH * H * W
    want = jax.tree.map(np.asarray, want)
    np.testing.assert_allclose(got["loss"].numpy(), want["loss"], rtol=rtol)
    np.testing.assert_allclose(got["loss_per_class"].numpy(), want["loss_per_class"],
                               rtol=rtol)
    np.testing.assert_allclose(got["acc_per_class"].numpy(), want["acc_per_class"],
                               rtol=0, atol=4 / pixels + 1e-7)
    np.testing.assert_allclose(got["iou_per_class"].numpy(), want["iou_per_class"],
                               rtol=0, atol=1e-2)
    np.testing.assert_array_equal(got["iou_nans"].numpy(), want["iou_nans"])


def _assert_state(module, want):
    params = dict(module.named_parameters())
    beyond, total = 0, 0
    for key, value in module.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        if key in params:
            diff = (value - want[key]).abs()
            beyond += int((diff > 1e-4).sum())
            total += diff.numel()
            assert diff.max() <= 2.5 * LR, key
        else:
            err = float((value - want[key]).norm() / want[key].norm())
            assert err <= 1e-4, (key, err)
    assert beyond <= 1e-3 * total, (beyond, total)


@pytest.mark.parametrize("variant", [
    "ht",
    # each a JAX train-step compile of 14 s or more on the CPU
    pytest.param("raw_nearest_pooled", marks=pytest.mark.slow),
    pytest.param("raw_nearest", marks=pytest.mark.slow),
    pytest.param("raw_last", marks=pytest.mark.slow)])
def test_train_step_from_jax_state_matches(tiny, variant):
    """One step from JAX's state 1 on the same raw batch: host-splat LiDAR
    with the heat maps rasterized in the step (``ht``), or points splatted
    in the step in each ``splat_mode`` (``raw_*``)."""
    state = _port_state(tiny)
    if variant == "ht":
        jstep = tiny["ht_step"]
        step = trainer.make_train_step_ht(state.module, state.optimizer, tiny["pcfg"], **FULL)
        batch = tiny["host"]
    else:
        mode = variant[len("raw_"):]
        jstep = jax_trainer.make_train_step_raw(tiny["jmodule"], tiny["tx"], tiny["jcfg"],
                                                donate=False, splat_mode=mode, **FULL)
        step = trainer.make_train_step_raw(state.module, state.optimizer, tiny["pcfg"],
                                           splat_mode=mode, **FULL)
        batch = tiny["device"]
    want_state, want = jstep(tiny["state1"], *batch)
    state, got = step(state, *(_t(x) for x in batch))
    _assert_metrics(got, want)
    _assert_state(state.module, _state_dict(tiny, want_state))


@pytest.mark.parametrize("variant", ["ht", "raw"])
def test_eval_step_matches_jax(tiny, variant):
    state = _port_state(tiny)
    if variant == "ht":
        jstep = jax_trainer.make_eval_step_ht(tiny["jmodule"], tiny["jcfg"], **FULL)
        step = trainer.make_eval_step_ht(state.module, tiny["pcfg"], **FULL)
        batch = tiny["host"]
    else:
        jstep = jax_trainer.make_eval_step_raw(tiny["jmodule"], tiny["jcfg"], **FULL)
        step = trainer.make_eval_step_raw(state.module, tiny["pcfg"], **FULL)
        batch = tiny["device"]
    want = jax.tree.map(np.asarray, jstep(tiny["state1"], *batch))
    got = step(state, *(_t(x) for x in batch))
    assert set(got) == set(want) and not state.module.training
    _assert_metrics(got, want)
    np.testing.assert_allclose(got["ap_per_class"].numpy(), want["ap_per_class"], rtol=1e-5)


def test_eval_step_ht_is_the_eval_step_on_rasterized_maps(tiny):
    """``make_eval_step_ht`` is ``make_eval_step`` on the maps that
    ``rasterize_heatmaps_direct`` makes of the boxes, bit for bit."""
    state = _port_state(tiny)
    image, lidar, boxes = (_t(x) for x in tiny["host"])
    got = trainer.make_eval_step_ht(state.module, tiny["pcfg"], **FULL)(state, image, lidar,
                                                                       boxes)
    heat = trainer._make_heatmap_rasterizer(**FULL)(image, boxes)
    assert heat.shape == (BATCH, H, W, 3)
    want = trainer.make_eval_step(state.module, tiny["pcfg"])(state, image, lidar, heat)
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_ht_steps_learn(tiny):
    """Ten host-splat steps on one raw batch lower the loss."""
    state = _port_state(tiny)
    step = trainer.make_train_step_ht(state.module, state.optimizer, tiny["pcfg"], **FULL)
    batch = [_t(x) for x in tiny["host"]]
    losses = []
    for _ in range(10):
        state, m = step(state, *batch)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
