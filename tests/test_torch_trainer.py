"""The port's train and eval steps (``dmmfods_tpu_torch/trainer.py``), its
optimizer (``optim.py``) and ``optimizer_state_from_jax`` against the JAX
package, in f32 on the CPU (JAX at matmul precision "highest").

The optimizer is optax's update with optax's f32 constants, its products
and sums fused where optax rounds each (an ulp or two apart); it is held at
rtol 1e-6 over five steps on a random parameter tree.

The steps run the JAX tests' tiny mid-fusion model (growth 8, blocks
(2, 2, 2, 2), 16 initial features) on ``make_batch(batch_size=2, h=32,
w=64, seed=0)``, from the same weights (``state_dict_from_jax``), with the
default Adam and with AMSGrad plus weight decay. Tolerances, from f32
noise measured on this model: train-mode BN over the 4 pixels a channel
of block 4 makes the step-0 gradients of both packages differ from an f64
run by ~7e-4 (relative, per tensor); the two packages' gradients differ by
less than 2e-3 as a whole. Adam turns a gradient element whose sign is
noise into a step of +-lr, so

* one step from the same state (JAX's state k, optimizer state through
  ``optimizer_state_from_jax``) matches JAX's state k + 1: the loss at
  rtol 1e-5, the running stats at 1e-4 (relative, per tensor), and every
  parameter element within 1e-4 but at most 0.1% of them, which stay within
  2.5 lr;
* three steps in a row track JAX's losses at rtol 5e-4, and its per-class
  losses at 3e-3 (the trajectories part from those flips on: step 3 of the
  AMSGrad run differs by 2.9e-4);
* metrics that threshold the logits (IoU, accuracy, the AP bins) may flip a
  few pixels: accuracy within 4 pixels, IoU within 1e-2, the AP bin counts'
  running sums within 4 (a bin is 2**-15 wide in probability).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from dmmfods_tpu import losses as jax_losses
from dmmfods_tpu import trainer as jax_trainer
from dmmfods_tpu.config import get_config as jax_get_config
from dmmfods_tpu.data.synthetic import make_batch
from dmmfods_tpu.models import dense_unet_lidar as jm
from dmmfods_tpu_torch import losses, trainer
from dmmfods_tpu_torch.config import get_config
from dmmfods_tpu_torch.models import dense_unet_lidar as pm
from dmmfods_tpu_torch.models.weights import (_torch_leaves, optimizer_state_from_jax,
                                               state_dict_from_jax)
from dmmfods_tpu_torch.ops.fused import fuse_operands

STEPS = 3
BATCH, H, W = 2, 32, 64
LR = 1e-3


def _t(x):
    return torch.from_numpy(np.array(x))


def _set_optimizer(cfg, variant):
    if variant == "amsgrad_weight_decay":
        cfg.optimizer.amsgrad = True
        cfg.optimizer.weight_decay = 1e-2


def _tiny_configs(tmp, variant="adam"):
    """The JAX and port configs of the tiny mid-fusion model, in f32."""
    out = []
    for cfg in (jax_get_config(str(tmp)), get_config(str(tmp))):
        cfg.model.growth_rate = 8
        cfg.model.block_config = (2, 2, 2, 2)
        cfg.model.num_init_features = 16
        _set_optimizer(cfg, variant)
        out.append(cfg)
    out[0].tpu.compute_dtype = "float32"
    out[1].gpu.compute_dtype = "float32"
    return out


# ---------------------------------------------------------------------------
# the optimizer on a random parameter tree
# ---------------------------------------------------------------------------

TREE_SHAPES = {"conv": {"kernel": (3, 3, 4, 8)}, "norm": {"scale": (8,), "bias": (8,)},
               "head": {"kernel": (5, 7)}}
LEAVES = [("conv", "kernel"), ("norm", "scale"), ("norm", "bias"), ("head", "kernel")]


def _tree(rng, scale=1.0):
    return {m: {k: (rng.normal(0, 1, s) * scale).astype(np.float32) for k, s in leaves.items()}
            for m, leaves in TREE_SHAPES.items()}


def _flat(tree):
    return [np.asarray(tree[m][k]) for m, k in LEAVES]


def _optimizer_case(variant, seed=0):
    """Initial params, five steps of gradients (step 2 gives "head" no
    gradient: zeros for optax) and the config. AMSGrad's gradients shrink
    after a large first one, where its running max matters."""
    rng = np.random.default_rng(seed)
    params = _tree(rng)
    scales = [10.0, 0.1, 0.2, 0.05, 0.3] if variant.startswith("amsgrad") else [1.0] * 5
    grads = [_tree(rng, s) for s in scales]
    grads[2]["head"]["kernel"] = None
    cfg = get_config()
    cfg.optimizer.amsgrad = variant.startswith("amsgrad")
    cfg.optimizer.weight_decay = 1e-2 if variant.endswith("weight_decay") else 0
    return params, grads, cfg


def _optax_run(cfg, params, grads, lr_change=None):
    tx = jax_trainer.make_optimizer(cfg)
    state = tx.init(params)
    update = jax.jit(tx.update)
    for i, g in enumerate(grads):
        if lr_change is not None and i == lr_change[0]:
            state = jax_trainer.set_learning_rate(state, lr_change[1])
        g = jax.tree.map(lambda x, p: np.zeros_like(p) if x is None else x, g, params,
                         is_leaf=lambda x: x is None)
        updates, state = update(g, state, params)
        params = optax.apply_updates(params, updates)
    return _flat(params)


def _port_run(optimizer_factory, params, grads, lr_change=None):
    tensors = [torch.tensor(p, requires_grad=True) for p in _flat(params)]
    optimizer = optimizer_factory(tensors)
    for i, g in enumerate(grads):
        if lr_change is not None and i == lr_change[0]:
            trainer.set_learning_rate(optimizer, lr_change[1])
        for t, gi in zip(tensors, [g[m][k] for m, k in LEAVES]):
            t.grad = None if gi is None else torch.from_numpy(gi)
        optimizer.step()
    return [t.detach().numpy() for t in tensors]


@pytest.mark.parametrize("variant", ["adam", "amsgrad", "weight_decay",
                                     "amsgrad_weight_decay"])
def test_optimizer_matches_optax(variant):
    params, grads, cfg = _optimizer_case(variant)
    want = _optax_run(cfg, params, grads)
    got = _port_run(lambda ps: trainer.make_optimizer(cfg, ps), params, grads)
    for g, w, p in zip(got, want, _flat(params)):
        assert np.abs(w - p).max() > 1e-3                  # it moved
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-8)
    if variant == "amsgrad":
        # torch's own AMSGrad keeps the max of the raw second moment: it
        # leaves the tolerance on these shrinking gradients
        theirs = _port_run(lambda ps: torch.optim.Adam(ps, lr=LR, amsgrad=True), params, grads)
        assert max(np.abs(t - w).max() for t, w in zip(theirs, want)) > 1e-4


def test_set_learning_rate_mid_run_matches_optax():
    params, grads, cfg = _optimizer_case("adam", seed=1)
    want = _optax_run(cfg, params, grads, lr_change=(2, 1e-4))
    got = _port_run(lambda ps: trainer.make_optimizer(cfg, ps), params, grads,
                    lr_change=(2, 1e-4))
    unchanged = _port_run(lambda ps: trainer.make_optimizer(cfg, ps), params, grads)
    for g, w, u in zip(got, want, unchanged):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-8)
        assert np.abs(u - w).max() > 1e-4


# ---------------------------------------------------------------------------
# the steps on the tiny mid-fusion model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny JAX model, its batch and its initial variables."""
    jcfg, pcfg = _tiny_configs(tmp_path_factory.mktemp("tiny"))
    jmodule = jm.DenseUNetLidar(jm.ModelSpec.from_config(jcfg))
    batch = make_batch(batch_size=BATCH, h=H, w=W, seed=0)
    variables = jax.jit(lambda key: jmodule.init(key, *batch[:2], False))(
        jax.random.PRNGKey(0))
    return dict(jmodule=jmodule, batch=batch, variables=variables,
                pspec=pm.ModelSpec.from_config(pcfg))


@pytest.fixture(scope="module", params=["adam", "amsgrad_weight_decay"])
def run(request, tmp_path_factory, tiny):
    """JAX's train step for STEPS steps and its eval step after them, with
    every state kept."""
    jcfg, pcfg = _tiny_configs(tmp_path_factory.mktemp("trainer"), request.param)
    jmodule, batch, variables = tiny["jmodule"], tiny["batch"], tiny["variables"]
    tx = jax_trainer.make_optimizer(jcfg)
    state = jax_trainer.TrainState(params=variables["params"],
                                   batch_stats=variables["batch_stats"],
                                   opt_state=tx.init(variables["params"]))
    step = jax_trainer.make_train_step(jmodule, tx, jcfg, donate=False)
    states, step_metrics = [state], []
    for _ in range(STEPS):
        state, m = step(state, *batch)
        states.append(state)
        step_metrics.append(jax.tree.map(np.asarray, m))
    eval_metrics = jax.tree.map(np.asarray,
                                jax_trainer.make_eval_step(jmodule, jcfg)(state, *batch))
    return dict(variant=request.param, jcfg=jcfg, pcfg=pcfg, jmodule=jmodule,
                batch=batch, states=states, metrics=step_metrics, eval=eval_metrics,
                pspec=pm.ModelSpec.from_config(pcfg))


def _state_dict(run, k):
    s = run["states"][k]
    return state_dict_from_jax({"params": s.params, "batch_stats": s.batch_stats},
                               run["pspec"])


def _port_state(run, k):
    """The port's module and optimizer at JAX's state ``k``."""
    module = pm.DenseUNetLidar(run["pspec"])
    module.load_state_dict(_state_dict(run, k))
    optimizer = trainer.make_optimizer(run["pcfg"], module.parameters())
    if k:
        optimizer.load_state_dict(
            optimizer_state_from_jax(run["states"][k].opt_state, module, run["pcfg"]))
    return trainer.TrainState(module, optimizer)


def _batch(run):
    return [_t(x) for x in run["batch"]]


def _assert_metrics(got, want, rtol, class_rtol=None):
    """The step metrics: the loss at ``rtol``, the per-class losses at
    ``class_rtol`` (``rtol`` if None), the thresholded ones within the few
    pixels a logit near a threshold may flip."""
    pixels = BATCH * H * W
    np.testing.assert_allclose(got["loss"].numpy(), want["loss"], rtol=rtol)
    np.testing.assert_allclose(got["loss_per_class"].numpy(), want["loss_per_class"],
                               rtol=class_rtol or rtol)
    np.testing.assert_allclose(got["acc_per_class"].numpy(), want["acc_per_class"],
                               rtol=0, atol=4 / pixels + 1e-7)
    np.testing.assert_allclose(got["iou_per_class"].numpy(), want["iou_per_class"],
                               rtol=0, atol=1e-2)
    np.testing.assert_array_equal(got["iou_nans"].numpy(), want["iou_nans"])
    for key in ("loss", "loss_per_class", "iou_per_class", "iou_nans", "acc_per_class"):
        assert got[key].dtype == torch.float32 and not got[key].requires_grad


def test_train_steps_track_jax(run):
    state = _port_state(run, 0)
    step = trainer.make_train_step(state.module, state.optimizer, run["pcfg"])
    for k in range(STEPS):
        state, got = step(state, *_batch(run))
        _assert_metrics(got, run["metrics"][k], rtol=5e-4, class_rtol=3e-3)
    assert state.module.training
    assert run["metrics"][-1]["loss"] < run["metrics"][0]["loss"]


@pytest.mark.parametrize("k", range(STEPS))
def test_step_from_jax_state_matches(run, k):
    """Step k + 1 from JAX's state k: at k >= 1 the optimizer resumes a
    mid-training optax state through ``optimizer_state_from_jax``."""
    state = _port_state(run, k)
    state, got = trainer.make_train_step(state.module, state.optimizer, run["pcfg"])(
        state, *_batch(run))
    _assert_metrics(got, run["metrics"][k], rtol=1e-5)
    want = _state_dict(run, k + 1)
    params = dict(state.module.named_parameters())
    beyond, total = 0, 0
    for key, value in state.module.state_dict().items():
        if key.endswith("num_batches_tracked"):
            assert int(value) == 1
        elif key in params:
            diff = (value - want[key]).abs()
            beyond += int((diff > 1e-4).sum())
            total += diff.numel()
            assert diff.max() <= 2.5 * LR, key
        else:
            err = float((value - want[key]).norm() / want[key].norm())
            assert err <= 1e-4, (key, err)
    assert beyond <= 1e-3 * total, (beyond, total)
    for p in params.values():
        assert state.optimizer.state[p]["step"] == k + 1


def test_step_gradients_match_jax(tiny):
    """Step 0's gradients, autograd against ``jax.grad``, as one vector."""
    jmodule, (rgb, lidar, ht), variables = tiny["jmodule"], tiny["batch"], tiny["variables"]

    def loss(params):
        logits, _ = jmodule.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                  rgb, lidar, True, mutable=["batch_stats"])
        return jnp.sum(jax_losses.bce_with_logits(logits.astype(jnp.float32), ht))

    grads = jax.jit(jax.grad(loss))(variables["params"])
    want = {key: t for _, key, t in _torch_leaves(grads, "params")}
    module = pm.DenseUNetLidar(tiny["pspec"])
    module.load_state_dict(state_dict_from_jax(variables, tiny["pspec"]))
    logits = module.train()(_t(rgb), _t(lidar)).float()
    losses.bce_with_logits_sum(logits, _t(ht)).backward()
    named = dict(module.named_parameters())
    assert set(named) == set(want)
    num = sum(float(((named[k].grad - w) ** 2).sum()) for k, w in want.items())
    den = sum(float((w ** 2).sum()) for w in want.values())
    assert (num / den) ** 0.5 <= 2e-3


def test_eval_step_matches_jax(run):
    state = _port_state(run, STEPS)
    got = trainer.make_eval_step(state.module, run["pcfg"])(state, *_batch(run))
    want = run["eval"]
    assert set(got) == set(want)
    assert not state.module.training
    _assert_metrics(got, want, rtol=1e-5)
    np.testing.assert_allclose(got["ap_per_class"].numpy(), want["ap_per_class"], rtol=1e-5)
    counts = got["ap_bin_counts"]
    assert counts.dtype == torch.int32 and tuple(counts.shape) == want["ap_bin_counts"].shape
    # a pixel whose probability moves across a bin edge moves one count:
    # the counts' running sums over the bins stay within a few pixels
    moved = np.cumsum(counts.numpy().astype(np.int64) - want["ap_bin_counts"], axis=-1)
    assert moved[..., -1].tolist() == [[0] * 3] * 2
    assert np.abs(moved).max() <= 4


def test_optimizer_state_from_jax_rejects_a_mismatch(run):
    state = _port_state(run, 1)
    other = get_config()
    _set_optimizer(other, "adam" if run["variant"] != "adam" else "amsgrad_weight_decay")
    with pytest.raises(ValueError, match="amsgrad"):
        optimizer_state_from_jax(run["states"][1].opt_state, state.module, other)
    wrong = pm.DenseUNetLidar(dataclasses.replace(run["pspec"], block_config=(2, 2, 2, 3)))
    with pytest.raises(KeyError):
        optimizer_state_from_jax(run["states"][1].opt_state, wrong, run["pcfg"])


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------


def _tiny_port(tmp_path, **gpu):
    _, pcfg = _tiny_configs(tmp_path)
    pcfg.gpu.update(gpu)
    module = pm.DenseUNetLidar(pm.ModelSpec.from_config(pcfg)).to(
        memory_format=torch.channels_last)
    return pcfg, module


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_after_training_equals_a_fresh_model(tmp_path, monkeypatch, dtype):
    """The eval folds kept per module (K4's stacks, K6's stem and K1's
    operands) see the optimizer's updates and the train steps' running
    stats: after an eval, three train steps and another eval, the logits
    equal bit for bit those of a fresh model that loaded the trained
    ``state_dict``. The opt-ins and batch 1 put K4 and K6 on the eval path,
    whose plain versions on the CPU read the kept folds."""
    pcfg, module = _tiny_port(tmp_path, compute_dtype=dtype, dense_block_impl="pallas",
                              stem_pool_strip="on")
    calls = []

    def spy(fn):
        def wrapped(*args):
            calls.append(fn.__name__)
            return fn(*args)
        return wrapped

    monkeypatch.setattr(pm, "dense_block", spy(pm.dense_block))
    monkeypatch.setattr(pm, "stem_pool", spy(pm.stem_pool))
    rgb, lidar, ht = (_t(x) for x in make_batch(batch_size=2, h=64, w=128, seed=1))
    forward = trainer.make_forward(module, pcfg)
    before = forward(rgb[:1], lidar[:1])
    assert calls.count("dense_block") == 3 and calls.count("stem_pool") == 2
    optimizer = trainer.make_optimizer(pcfg, module.parameters())
    state = trainer.TrainState(module, optimizer)
    step = trainer.make_train_step(module, optimizer, pcfg)
    for _ in range(3):
        state, m = step(state, rgb, lidar, ht)
        assert torch.isfinite(m["loss"])
    assert len(calls) == 5                       # no kernel in train mode
    after = forward(rgb[:1], lidar[:1])
    assert len(calls) == 10 and after.dtype == getattr(torch, dtype)
    fresh = pm.DenseUNetLidar(module.spec).to(memory_format=torch.channels_last)
    fresh.load_state_dict(module.state_dict())
    assert torch.equal(after, trainer.make_forward(fresh, pcfg)(rgb[:1], lidar[:1]))
    assert not torch.equal(before, after)
    norm, conv = module.concat_module.norm, module.concat_module.conv
    kept = module.concat_module._fuse_operands(getattr(torch, dtype))
    folded = fuse_operands(norm.weight, norm.bias, norm.running_mean, norm.running_var,
                           conv.weight, norm.eps, getattr(torch, dtype))
    for a, b in zip(kept, folded):
        assert (a is None and b is None) or torch.equal(a, b)


def test_custom_loss_fn_and_the_logged_bce(tmp_path):
    """A custom ``loss_fn`` is the loss; the per-class breakdown stays BCE."""
    pcfg, module = _tiny_port(tmp_path)
    optimizer = trainer.make_optimizer(pcfg, module.parameters())
    state = trainer.TrainState(module, optimizer)
    step = trainer.make_train_step(module, optimizer, pcfg,
                                   loss_fn=lambda l, t: 2 * losses.bce_with_logits_sum(l, t))
    batch = [_t(x) for x in make_batch(batch_size=2, h=32, w=64, seed=2)]
    _, m = step(state, *batch)
    torch.testing.assert_close(m["loss"], 2 * m["loss_per_class"].sum(), rtol=1e-5, atol=0)
    evaluated = trainer.make_eval_step(module, pcfg, loss_fn=lambda l, t: 3 * l.sum())(
        state, *batch)
    assert evaluated["loss_per_class"].min() > 0


def test_single_stream_step_ignores_lidar(tmp_path):
    _, pcfg = _tiny_configs(tmp_path)
    pcfg.model.concat_before_block_num = 1
    pcfg.model.stream_2_in_channels = 0
    module = pm.DenseUNetLidar(pm.ModelSpec.from_config(pcfg))
    optimizer = trainer.make_optimizer(pcfg, module.parameters())
    state = trainer.TrainState(module, optimizer)
    rgb, lidar, ht = (_t(x) for x in make_batch(batch_size=2, h=32, w=64, seed=3))
    _, m = trainer.make_train_step(module, optimizer, pcfg)(state, rgb, None, ht)
    assert torch.isfinite(m["loss"])
    m = trainer.make_eval_step(module, pcfg)(state, rgb, lidar, ht)
    assert torch.isfinite(m["loss"])


def test_steps_reject_another_state(tmp_path):
    pcfg, module = _tiny_port(tmp_path)
    optimizer = trainer.make_optimizer(pcfg, module.parameters())
    other = trainer.TrainState(pm.DenseUNetLidar(module.spec), optimizer)
    rgb, lidar, ht = (_t(x) for x in make_batch(batch_size=1, h=32, w=64, seed=4))
    with pytest.raises(ValueError, match="another module"):
        trainer.make_train_step(module, optimizer, pcfg)(other, rgb, lidar, ht)
    with pytest.raises(ValueError, match="another module"):
        trainer.make_eval_step(module, pcfg)(other, rgb, lidar, ht)


@pytest.mark.slow
def test_densenet121_training_matches_the_jax_pin(tmp_path):
    """Full DenseNet-121 (mid fusion) at 64x96 b4 in f32 from the JAX
    bundle's weights: the port's step-0 loss is JAX's train-mode loss and
    the verify drive's pin, 44133.4, within 1e-4 relative; 12 steps lower
    it."""
    jcfg = jax_get_config(str(tmp_path))
    jcfg.tpu.compute_dtype = "float32"
    bundle = jm.densenet121_u_lidar(config=jcfg, init_hw=(64, 96))
    rgb, lidar, ht = make_batch(4, 64, 96)
    logits, _ = jax.jit(lambda v: bundle.module.apply(
        v, rgb, lidar, True, mutable=["batch_stats"]))(bundle.variables)
    jax_loss = float(jnp.sum(jax_losses.bce_with_logits(logits.astype(jnp.float32), ht)))
    pcfg = get_config(str(tmp_path))
    pcfg.gpu.compute_dtype = "float32"
    port = pm.densenet121_u_lidar(config=pcfg, device="cpu")
    port.module.load_state_dict(state_dict_from_jax(bundle.variables, port.spec))
    optimizer = trainer.make_optimizer(pcfg, port.module.parameters())
    state = trainer.create_train_state(port, optimizer)
    step = trainer.make_train_step(port.module, optimizer, pcfg)
    got = []
    for _ in range(12):
        state, m = step(state, _t(rgb), _t(lidar), _t(ht))
        got.append(float(m["loss"]))
    assert abs(got[0] - jax_loss) <= 1e-4 * jax_loss
    assert abs(got[0] - 44133.4) <= 1e-4 * 44133.4
    assert np.isfinite(got).all() and got[-1] < got[0]
