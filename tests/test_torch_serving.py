"""The port's ``InferenceEngine`` (``dmmfods_tpu_torch/serving.py``) on the
CPU: bucket padding, chunking past the largest bucket, the worker's request
coalescing and the on-device sigmoid, each against ``sigmoid(model(x))`` on
the unpadded input; and, in the slow tier, against the JAX engine on the
same weights."""

import numpy as np
import pytest
import torch

from dmmfods_tpu_torch.config import get_config
from dmmfods_tpu_torch.models.dense_unet_lidar import (
    DenseUNetLidar, ModelBundle, ModelSpec)
from dmmfods_tpu_torch.serving import InferenceEngine

H, W = 64, 96


def _tiny_config(tmp):
    cfg = get_config(str(tmp))
    cfg.gpu.compute_dtype = "float32"
    cfg.model.growth_rate = 8
    cfg.model.block_config = (2, 2, 2, 2)
    cfg.model.num_init_features = 16
    cfg.dataset.images.size = (3, W, H)   # (C, W, H)
    return cfg


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    cfg = _tiny_config(tmp_path_factory.mktemp("serve"))
    spec = ModelSpec.from_config(cfg)
    module = DenseUNetLidar(spec, generator=torch.Generator().manual_seed(3))
    return ModelBundle(module=module.to(memory_format=torch.channels_last).eval(),
                       config=cfg, spec=spec)


def _frames(rng, n):
    return (rng.uniform(0, 1, (n, H, W, 3)).astype(np.float32),
            rng.uniform(0, 1, (n, H, W, 1)).astype(np.float32))


def _direct(bundle, rgb, lidar):
    with torch.no_grad():
        return torch.sigmoid(bundle.module(torch.from_numpy(rgb),
                                           torch.from_numpy(lidar))).numpy()


def test_run_pads_and_chunks(bundle):
    engine = InferenceEngine(bundle, buckets=(1, 4, 8))
    rng = np.random.default_rng(0)
    for n in (3, 11):                  # bucket 4; chunks of 8 and 3 (bucket 4)
        rgb, lidar = _frames(rng, n)
        before = engine.device_batches
        out = engine.run(rgb, lidar)
        assert out.shape == (n, H, W, 3) and out.dtype == np.float32
        assert ((out >= 0) & (out <= 1)).all()
        np.testing.assert_allclose(out, _direct(bundle, rgb, lidar), atol=1e-5)
        assert engine.device_batches - before == -(-n // 8)


def test_worker_coalesces_and_serves_every_request(bundle):
    engine = InferenceEngine(bundle, buckets=(1, 4, 8))
    engine.warmup()
    assert engine.device_batches == 3
    rng = np.random.default_rng(1)
    requests = [_frames(rng, n) for n in (1, 3, 9)]
    # queued before start, so the worker takes all 13 frames as one group:
    # device batches of 8 and 5 (bucket 8)
    futures = [engine.submit(rgb, lidar) for rgb, lidar in requests]
    engine.start()
    results = [f.result(timeout=120) for f in futures]
    engine.stop()
    assert engine.device_batches == 3 + 2
    for (rgb, lidar), out in zip(requests, results):
        assert out.shape == (rgb.shape[0], H, W, 3)
        np.testing.assert_allclose(out, _direct(bundle, rgb, lidar), atol=1e-5)


def test_worker_fails_only_the_bad_request(bundle):
    engine = InferenceEngine(bundle, buckets=(2,))
    rng = np.random.default_rng(2)
    good = _frames(rng, 1)
    bad = engine.submit(np.zeros((1, H, W, 5), np.float32))   # wrong channel count
    ok = engine.submit(*good)
    engine.start()
    with pytest.raises(Exception):
        bad.result(timeout=120)
    np.testing.assert_allclose(ok.result(timeout=120), _direct(bundle, *good), atol=1e-5)
    engine.stop()


def test_logits_without_decode(bundle):
    engine = InferenceEngine(bundle, buckets=(2,), decode=False)
    rgb, lidar = _frames(np.random.default_rng(4), 2)
    with torch.no_grad():
        want = bundle.module(torch.from_numpy(rgb), torch.from_numpy(lidar)).numpy()
    np.testing.assert_allclose(engine.run(rgb, lidar), want, atol=1e-5)


def test_serves_in_eval_mode_after_a_train_step(tmp_path):
    """A train step leaves the module in train mode; the engine still serves
    the eval forward: its logits equal ``make_forward``'s bit for bit, and
    the run changes no buffer of the module (no batch statistics)."""
    from dmmfods_tpu_torch import trainer

    cfg = _tiny_config(tmp_path)
    spec = ModelSpec.from_config(cfg)
    module = DenseUNetLidar(spec, generator=torch.Generator().manual_seed(5)).to(
        memory_format=torch.channels_last)
    bundle = ModelBundle(module=module, config=cfg, spec=spec)
    engine = InferenceEngine(bundle, buckets=(2,), decode=False)
    rng = np.random.default_rng(6)
    rgb, lidar = _frames(rng, 2)
    heat = rng.uniform(0, 1, (2, H, W, 3)).astype(np.float32)
    optimizer = trainer.make_optimizer(cfg, module.parameters())
    step = trainer.make_train_step(module, optimizer, cfg)
    step(trainer.TrainState(module, optimizer), torch.from_numpy(rgb),
         torch.from_numpy(lidar), torch.from_numpy(heat))
    assert module.training
    buffers = {name: b.clone() for name, b in module.named_buffers()}
    served = engine.run(rgb, lidar)
    for name, b in module.named_buffers():
        assert torch.equal(b, buffers[name]), name
    want = trainer.make_forward(module, cfg)(torch.from_numpy(rgb), torch.from_numpy(lidar))
    assert np.array_equal(served, want.numpy())


@pytest.mark.slow
def test_matches_the_jax_engine(tmp_path):
    import jax

    from dmmfods_tpu.config import get_config as jax_get_config
    from dmmfods_tpu.models import dense_unet_lidar as jm
    from dmmfods_tpu.serving import InferenceEngine as JaxEngine
    from dmmfods_tpu_torch.models.weights import state_dict_from_jax

    jcfg = jax_get_config(str(tmp_path))
    jcfg.tpu.compute_dtype = "float32"
    jcfg.model.growth_rate = 8
    jcfg.model.block_config = (2, 2, 2, 2)
    jcfg.model.num_init_features = 16
    jcfg.dataset.images.size = (3, W, H)
    jspec = jm.ModelSpec.from_config(jcfg)
    jmodule = jm.DenseUNetLidar(jspec)
    zeros = (np.zeros((1, H, W, 3), np.float32), np.zeros((1, H, W, 1), np.float32))
    variables = jmodule.init(jax.random.PRNGKey(0), *zeros, False)
    jax_engine = JaxEngine(jm.ModelBundle(module=jmodule, variables=variables,
                                          config=jcfg, spec=jspec), buckets=(1, 4))

    cfg = _tiny_config(tmp_path)
    spec = ModelSpec.from_config(cfg)
    module = DenseUNetLidar(spec)
    module.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, variables), spec), strict=True)
    engine = InferenceEngine(ModelBundle(module=module.eval(), config=cfg, spec=spec),
                             buckets=(1, 4))
    rgb, lidar = _frames(np.random.default_rng(5), 3)
    np.testing.assert_allclose(engine.run(rgb, lidar), jax_engine.run(rgb, lidar),
                               atol=1e-4)
