"""The port's ``InferenceEngine`` (``dmmfods_tpu_torch/serving.py``) on the
CPU: bucket padding, chunking past the largest bucket, the worker's request
coalescing and the on-device sigmoid, each against ``sigmoid(model(x))`` on
the unpadded input; the host blocks (input staging, result blocks on loan,
copy-out), which run on the CPU over ordinary memory; and, in the slow
tier, against the JAX engine on the same weights. One test needs a card:
the blocks page-locked."""

import sys
import threading

import numpy as np
import pytest
import torch

from dmmfods_tpu_torch.config import get_config
from dmmfods_tpu_torch.models.dense_unet_lidar import (
    DenseUNetLidar, ModelBundle, ModelSpec)
from dmmfods_tpu_torch.serving import RESULT_BLOCKS, InferenceEngine

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


def _lent_copied(engine):
    stats = engine.stats()
    return stats["results_lent"], stats["results_copied"]


def test_held_results_are_never_overwritten(bundle):
    """Six results held, more than the blocks on loan: each still equals a
    fresh run of its input, and no two share memory."""
    engine = InferenceEngine(bundle, buckets=(2, 4))
    rng = np.random.default_rng(7)
    inputs = [_frames(rng, 3) for _ in range(RESULT_BLOCKS + 2)]
    held = [engine.run(rgb, lidar) for rgb, lidar in inputs]
    assert _lent_copied(engine) == (RESULT_BLOCKS, 2)
    for i, ((rgb, lidar), out) in enumerate(zip(inputs, held)):
        np.testing.assert_array_equal(out, engine.run(rgb, lidar))
        np.testing.assert_allclose(out, _direct(bundle, rgb, lidar), atol=1e-5)
        assert not any(np.shares_memory(out, other) for other in held[:i])


def test_blocks_come_back_when_results_are_dropped(bundle):
    engine = InferenceEngine(bundle, buckets=(4,))
    rng = np.random.default_rng(8)
    for k in range(RESULT_BLOCKS + 3):
        rgb, lidar = _frames(rng, 3)
        out = engine.run(rgb, lidar)
        np.testing.assert_allclose(out, _direct(bundle, rgb, lidar), atol=1e-5)
        del out
        stats = engine.stats()
        assert _lent_copied(engine) == (k + 1, 0)
        if k == 0:
            pinned = stats["pinned_bytes"]
        assert stats["pinned_bytes"] == pinned
    assert len(engine._host._loans[(H, W, 3)].blocks) == 1


def test_with_every_block_on_loan_results_are_copied_out(bundle):
    engine = InferenceEngine(bundle, buckets=(4,))
    rng = np.random.default_rng(9)
    held = [engine.run(*_frames(rng, 2)) for _ in range(RESULT_BLOCKS)]
    pinned = engine.stats()["pinned_bytes"]
    rgb, lidar = _frames(rng, 4)
    want = _direct(bundle, rgb, lidar)
    for _ in range(2):
        out = engine.run(rgb, lidar)
        assert out.base is None            # the caller's own array
        np.testing.assert_allclose(out, want, atol=1e-5)
    assert _lent_copied(engine) == (RESULT_BLOCKS, 2)
    # one staging block of bucket 4, never lent
    assert engine.stats()["pinned_bytes"] == pinned + 4 * H * W * 3 * 4
    del held
    np.testing.assert_allclose(engine.run(rgb, lidar), want, atol=1e-5)
    assert _lent_copied(engine) == (RESULT_BLOCKS + 1, 2)


def test_a_request_past_the_largest_bucket_comes_back_as_one_copied_array(bundle):
    engine = InferenceEngine(bundle, buckets=(1, 4))
    rgb, lidar = _frames(np.random.default_rng(10), 10)   # chunks of 4, 4 and 2 (bucket 4)
    out = engine.run(rgb, lidar)
    assert out.shape == (10, H, W, 3) and out.base is None
    assert _lent_copied(engine) == (0, 3)
    chunks = [engine.run(rgb[s:s + 4], lidar[s:s + 4]) for s in (0, 4, 8)]
    assert _lent_copied(engine) == (3, 3)
    np.testing.assert_array_equal(out, np.concatenate(chunks))


def test_the_worker_gives_each_request_its_slice_whatever_order_they_are_dropped(bundle):
    """Rounds of three requests, each round one device batch on one result
    block: every other round keeps the middle request's slice and drops the
    others, last served first; the rounds between drop all three, on another
    thread. Blocks come back and are lent again, and every kept slice keeps
    its heat maps."""
    engine = InferenceEngine(bundle, buckets=(8,))
    rng = np.random.default_rng(11)
    kept = []
    for k in range(2 * RESULT_BLOCKS):
        requests = [_frames(rng, n) for n in (1, 3, 2)]
        futures = [engine.submit(rgb, lidar) for rgb, lidar in requests]
        engine.start()                 # all three queued: one group
        results = [f.result(timeout=120) for f in futures]
        engine.stop()
        del futures
        for (rgb, lidar), out in zip(requests, results):
            np.testing.assert_allclose(out, _direct(bundle, rgb, lidar), atol=1e-5)
        if k % 2 == 0:
            kept.append((requests[1], results[1]))
            del results[2], results[0]
        else:
            dropper = threading.Thread(target=results.clear)
            dropper.start()
            dropper.join(timeout=60)
            assert not dropper.is_alive()
        del results
    # rounds 0, 2, 4, 6 keep a block each, so round 7 finds all four on loan
    assert _lent_copied(engine) == (2 * RESULT_BLOCKS - 1, 1)
    for (rgb, lidar), out in kept:
        np.testing.assert_allclose(out, _direct(bundle, rgb, lidar), atol=1e-5)


def test_a_chunked_call_writes_its_input_block_again_only_after_the_copy(bundle):
    """11 frames in bucket 4: three chunks through one input block per
    input, each written only after waiting on the event of the last upload
    from it (on the CPU a stand-in event: this checks the order, not the
    CUDA event), and the answer equal to the model's."""
    engine = InferenceEngine(bundle, buckets=(4,))
    host, order = engine._host, []

    class Event:
        def __init__(self, k):
            self.k = k

        def synchronize(self):
            order.append(("wait", self.k))

    def uploaded(keys):
        k = sum(1 for step in order if step[0] == "upload")
        order.append(("upload", k))
        for key in keys:
            host._inputs[key][1] = Event(k)

    stage = host.stage

    def staged(key, arrays, start, n, rows):
        block = stage(key, arrays, start, n, rows)
        order.append(("write", key[0], start, block.data_ptr()))
        return block

    host.uploaded, host.stage = uploaded, staged
    rgb, lidar = _frames(np.random.default_rng(12), 11)
    np.testing.assert_allclose(engine.run(rgb, lidar), _direct(bundle, rgb, lidar), atol=1e-5)
    writes = [s for s in order if s[0] == "write"]
    assert len({w[3] for w in writes if w[1] == "rgb"}) == 1
    assert [s[:3] for s in order] == [
        ("write", "rgb", 0), ("write", "lidar", 0), ("upload", 0),
        ("wait", 0), ("write", "rgb", 4), ("wait", 0), ("write", "lidar", 4), ("upload", 1),
        ("wait", 1), ("write", "rgb", 8), ("wait", 1), ("write", "lidar", 8), ("upload", 2)]


def test_clients_dropping_results_on_their_own_threads_while_the_worker_lends(bundle):
    """Six clients, each keeping every third answer to the end and dropping
    the others on its own thread (where the block's return runs), the
    interpreter switching threads every microsecond: every answer equals the
    model's, the kept ones too at the end, and the blocks held stay within
    the pool's size."""
    engine = InferenceEngine(bundle, buckets=(1, 2, 4))
    rng = np.random.default_rng(13)
    inputs = [_frames(rng, n) for n in (1, 2, 1, 3)]
    want = [_direct(bundle, rgb, lidar) for rgb, lidar in inputs]
    kept, wrong = [], []

    def client(c):
        for i in range(6):
            j = (i + c) % len(inputs)
            out = engine.submit(*inputs[j]).result(timeout=120)
            if not np.allclose(out, want[j], atol=1e-5):
                wrong.append((c, i))
            if i % 3 == 0:
                kept.append((j, out))
            del out

    engine.start()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        clients = [threading.Thread(target=client, args=(c,)) for c in range(6)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    engine.stop()
    assert not any(t.is_alive() for t in clients)
    assert not wrong
    for j, out in kept:
        np.testing.assert_allclose(out, want[j], atol=1e-5)
    stats = engine.stats()
    assert stats["results_lent"] + stats["results_copied"] == stats["device_batches"]
    assert stats["results_lent"] >= RESULT_BLOCKS
    assert len(engine._host._loans[(H, W, 3)].blocks) <= RESULT_BLOCKS


@pytest.mark.cuda
def test_the_blocks_are_page_locked_on_cuda(tmp_path):
    """On a card: every host block of the engine is page-locked, a lent
    result lies in one of them, and ``pinned_bytes`` is their sum."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: page-locked memory needs CUDA")
    cfg = _tiny_config(tmp_path)
    cfg.gpu.use_fused_kernels = False      # no kernel build: the engine's copies only
    spec = ModelSpec.from_config(cfg)
    module = DenseUNetLidar(spec, generator=torch.Generator().manual_seed(3))
    module = module.to("cuda", memory_format=torch.channels_last).eval()
    engine = InferenceEngine(ModelBundle(module=module, config=cfg, spec=spec), buckets=(2, 4))
    engine.warmup()
    rng = np.random.default_rng(14)
    rgb, lidar = _frames(rng, 3)
    out = engine.run(rgb, lidar)
    engine.run(*_frames(rng, 6))           # past the largest bucket: the staging block
    blocks = engine._host.blocks()
    assert len(blocks) == 4                # RGB and LiDAR input, staging, one result
    assert all(b.is_pinned() for b in blocks)
    assert torch.from_numpy(out).is_pinned()
    assert any(b.data_ptr() <= out.ctypes.data < b.data_ptr() + b.nbytes for b in blocks)
    assert engine.stats()["pinned_bytes"] == sum(b.nbytes for b in blocks)
    assert _lent_copied(engine) == (1, 2)
    with torch.no_grad():
        want = torch.sigmoid(module(torch.from_numpy(rgb).cuda(), torch.from_numpy(lidar).cuda()))
    np.testing.assert_allclose(out, want.cpu().numpy(), atol=1e-4)


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
