"""The port's span recorder and counters (``dmmfods_tpu_torch/tracing.py``)
on the CPU, with the tiny engine of ``test_torch_serving.py``: the no-op
while nothing records, what a span holds, the engine's spans and request
records and their nesting, ``InferenceEngine.stats()``, the train step's
phases under ``torch.profiler``, and the spans' times against the
profiler's own ranges."""

import gc
import importlib
import os
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dmmfods_tpu_torch import tracing
from dmmfods_tpu_torch.config import get_config
from dmmfods_tpu_torch.models.dense_unet_lidar import DenseUNetLidar, ModelBundle, ModelSpec
from dmmfods_tpu_torch.serving import InferenceEngine

H, W = 64, 96

# the tiny model's stages under model/forward: mid fusion before block 2
STAGES = ["model/stream_2", "model/encoder.stem", "model/encoder.block1",
          "model/encoder.transition1", "model/fuse", "model/encoder.block2",
          "model/encoder.transition2", "model/encoder.block3", "model/encoder.transition3",
          "model/encoder.block4", "model/decoder", "model/head"]

# where the benchmark and chip_smoke.py read each kernel's launch counter,
# and the BN-ReLU pass's launches and folds (chip_smoke.py)
COUNTERS = [("fused", "K1_LAUNCHES"), ("dense_block_strip", "K2_LAUNCHES"),
            ("phase_head", "K3_LAUNCHES"), ("dense_block", "K4_LAUNCHES"),
            ("dense_block_strip", "K5_LAUNCHES"), ("stem_pool", "K6_LAUNCHES"),
            ("bn_relu", "BN_RELU_LAUNCHES"), ("bn_relu", "BN_FOLDS")]


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
    cfg = _tiny_config(tmp_path_factory.mktemp("trace"))
    spec = ModelSpec.from_config(cfg)
    module = DenseUNetLidar(spec, generator=torch.Generator().manual_seed(3))
    return ModelBundle(module=module.to(memory_format=torch.channels_last).eval(),
                       config=cfg, spec=spec)


@pytest.fixture(autouse=True)
def recorder():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


def _frames(rng, n):
    return (rng.uniform(0, 1, (n, H, W, 3)).astype(np.float32),
            rng.uniform(0, 1, (n, H, W, 1)).astype(np.float32))


def _gc_allocations(fn, n=1000):
    """Objects the collector tracks that ``n`` calls of ``fn`` allocate."""
    gc.disable()
    try:
        before = gc.get_count()[0]
        for _ in range(n):
            fn()
        return gc.get_count()[0] - before
    finally:
        gc.enable()


def _children(spans):
    out = {}
    for s in sorted(spans, key=lambda s: s.start):
        out.setdefault(s.parent, []).append(s)
    return out


@pytest.mark.parametrize("make", [tracing.span, tracing.no_span])
def test_off_a_span_is_the_shared_noop_and_allocates_nothing(make):
    assert not tracing.enabled()
    span = make("engine/pad", frames=3)
    assert span is tracing.NOOP
    with span as inner:
        inner.set(padded=1)

    def call():
        with make("engine/pad", frames=3) as s:
            s.set(padded=1)

    assert _gc_allocations(call) == 0
    tracing.record("engine/request", 1, 2, id=1)
    assert tracing.spans() == []


def test_a_span_holds_its_times_thread_parent_and_attributes():
    tracing.enable()
    assert tracing.enabled()
    t0 = tracing.now()
    with tracing.span("outer", bucket=8) as outer:
        outer.set(frames=5)
        with tracing.span("inner"):
            pass
        done = threading.Event()

        def other():
            with tracing.span("elsewhere"):
                done.set()

        worker = threading.Thread(target=other)
        worker.start()
        worker.join(timeout=60)
        assert done.is_set() and not worker.is_alive()
    tracing.disable()
    with tracing.span("after"):
        pass
    got = {s.name: s for s in tracing.spans()}
    assert set(got) == {"outer", "inner", "elsewhere"}
    outer, inner, elsewhere = got["outer"], got["inner"], got["elsewhere"]
    assert outer.attrs == {"bucket": 8, "frames": 5}
    assert t0 <= outer.start <= inner.start <= inner.end <= outer.end
    assert inner.parent == outer.id and outer.parent is None
    # a span's parent is the span open on its own thread
    assert elsewhere.parent is None and elsewhere.tid != outer.tid == inner.tid
    assert outer.tid == threading.get_ident()


def test_the_buffer_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 3)
    tracing.enable()
    for i in range(5):
        with tracing.span(f"s{i}"):
            pass
    assert [s.name for s in tracing.spans()] == ["s0", "s1", "s2"]
    assert tracing.dropped() == 2
    tracing.clear()
    assert tracing.spans() == [] and tracing.dropped() == 0


def test_threads_at_once_lose_no_span_and_keep_their_own_parents(monkeypatch):
    """More recording threads than cores, switching every microsecond: every
    span is kept or counted as dropped, ids are unique, and each inner
    span's parent is its own thread's outer span."""
    threads_n, per_thread = 2 * (os.cpu_count() or 1) + 2, 500
    monkeypatch.setattr(tracing, "MAX_SPANS", threads_n * per_thread)   # of 2x as many
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        tracing.enable()

        def work():
            for _ in range(per_thread // 2):
                with tracing.span("outer"):
                    with tracing.span("inner"):
                        pass

        threads = [threading.Thread(target=work) for _ in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    spans = tracing.spans()
    assert len(spans) == threads_n * per_thread and tracing.dropped() == 0
    assert len({s.id for s in spans}) == len(spans)
    outer = {s.id: s.tid for s in spans if s.name == "outer"}
    assert all(outer[s.parent] == s.tid for s in spans if s.name == "inner")
    with tracing.span("one more"):
        pass
    assert tracing.dropped() == 1


@pytest.mark.parametrize("how", ["enabled", "profiled"])
def test_run_records_one_batch_with_its_steps_in_order(bundle, how):
    """``run`` at 5 frames, buckets (1, 4, 8): one ``engine/batch`` (bucket
    8, 3 frames of padding) whose children are the engine's steps and
    ``model/forward``, whose children are the model's stages; recorded with
    the recorder enabled, or, with it off, under a ``torch.profiler``."""
    engine = InferenceEngine(bundle, buckets=(1, 4, 8))
    rgb, lidar = _frames(np.random.default_rng(0), 5)
    if how == "enabled":
        tracing.enable()
        engine.run(rgb, lidar)
        tracing.disable()
    else:
        with profile(activities=[ProfilerActivity.CPU]):
            assert tracing.enabled()
            engine.run(rgb, lidar)
        assert not tracing.enabled()
    spans = tracing.spans()
    children = _children(spans)
    batches = [s for s in spans if s.name == "engine/batch"]
    assert len(batches) == 1
    batch = batches[0]
    assert batch.parent is None
    assert batch.attrs["buckets"] == (8,) and batch.attrs["frames"] == 5
    assert batch.attrs["padded"] == 3
    steps = children[batch.id]
    # no engine/device_wait on the CPU: there is no device to wait for
    assert [s.name for s in steps] == ["engine/pad", "engine/h2d", "model/forward",
                                      "engine/d2h", "engine/deliver"]
    for a, b in zip(steps, steps[1:]):
        assert a.end <= b.start
    forward = steps[2]
    assert [s.name for s in children[forward.id]] == STAGES
    assert all(batch.start <= s.start <= s.end <= batch.end for s in steps)
    requests = [s for s in spans if s.name == "engine/request"]
    assert len(requests) == 1 and requests[0].attrs["frames"] == 5
    assert batch.attrs["requests"] == (requests[0].attrs["id"],)


def test_submit_from_two_threads_records_requests_take_and_group(bundle):
    engine = InferenceEngine(bundle, buckets=(1, 4, 8))
    rng = np.random.default_rng(1)
    inputs = [_frames(rng, n) for n in (1, 2, 3, 1)]
    tracing.enable()
    engine.start()
    clients, served_frames = {}, []

    def client(k):
        clients[k] = threading.get_ident()
        for rgb, lidar in inputs[2 * k:2 * k + 2]:
            served_frames.append(engine.submit(rgb, lidar).result(timeout=120).shape[0])

    threads = [threading.Thread(target=client, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert sorted(served_frames) == [1, 1, 2, 3]
    engine.stop()
    tracing.disable()
    spans = tracing.spans()
    requests = [s for s in spans if s.name == "engine/request"]
    ids = [s.attrs["id"] for s in requests]
    assert len(requests) == 4 and len(set(ids)) == 4
    assert {s.tid for s in requests} == set(clients.values())
    for s in requests:
        assert s.start <= s.attrs["taken"] <= s.end and s.parent is None
    assert sorted(s.attrs["frames"] for s in requests) == [1, 1, 2, 3]
    batches = [s for s in spans if s.name == "engine/batch"]
    worker = {s.tid for s in batches}
    assert len(worker) == 1 and not worker & set(clients.values())
    names = {s.name for s in spans if s.tid in worker}
    assert {"engine/take", "engine/group", "engine/pad", "model/forward"} <= names
    children = _children(spans)
    served = []
    for b in batches:
        assert children[b.id][0].name == "engine/group"
        served += b.attrs["requests"]
    assert sorted(served) == sorted(ids)
    # waiting for traffic lies outside every batch
    for take in (s for s in spans if s.name == "engine/take"):
        assert take.parent is None


@pytest.mark.parametrize("calls", [("run", (3, 11)), ("submit", (1, 3, 9))])
def test_stats_count_requests_frames_padding_and_batches_per_bucket(bundle, calls):
    kind, sizes = calls
    engine = InferenceEngine(bundle, buckets=(1, 4, 8))
    engine.warmup()
    assert engine.device_batches == 3
    rng = np.random.default_rng(2)
    requests = [_frames(rng, n) for n in sizes]
    # host blocks, in bytes a row of one channel: warm-up stages every bucket
    # through the input blocks (3 + 1 channels), sized for bucket 8; a
    # copy-out goes through one staging block of the largest bucket it met
    # (3 channels); a result block on loan is sized for its bucket
    row = H * W * 4
    if kind == "run":
        for rgb, lidar in requests:
            engine.run(rgb, lidar)
        # 3 -> bucket 4 (1 padded), lent; 11 -> 8, and 3 in bucket 4 (1
        # padded), both copied out (a call past the largest bucket)
        want = {1: (1, 0, 0, 0, 0, 0), 4: (3, 6, 2, 1, 1, 4 * 3 * row),
                8: (2, 8, 0, 0, 1, 8 * (4 + 3) * row)}
    else:
        # queued before the worker starts: one group of 13 frames, device
        # batches of 8 and of 5 in bucket 8 (3 padded), copied out
        futures = [engine.submit(rgb, lidar) for rgb, lidar in requests]
        engine.start()
        for f in futures:
            f.result(timeout=120)
        engine.stop()
        want = {1: (1, 0, 0, 0, 0, 0), 4: (1, 0, 0, 0, 0, 0),
                8: (3, 13, 3, 0, 2, 8 * (4 + 3) * row)}
    stats = engine.stats()
    keys = ("device_batches", "frames", "padded_frames", "results_lent", "results_copied",
            "pinned_bytes")
    assert stats["buckets"] == {b: dict(zip(keys, v)) for b, v in want.items()}
    assert stats["requests"] == len(sizes) and stats["frames"] == sum(sizes)
    for i, k in enumerate(keys):
        assert stats[k] == sum(v[i] for v in want.values()), k
    assert stats["device_batches"] == engine.device_batches


def test_train_step_phases_show_under_the_profiler_with_the_recorder_off(tmp_path):
    from dmmfods_tpu_torch import trainer

    cfg = _tiny_config(tmp_path)
    spec = ModelSpec.from_config(cfg)
    module = DenseUNetLidar(spec, generator=torch.Generator().manual_seed(5)).to(
        memory_format=torch.channels_last)
    optimizer = trainer.make_optimizer(cfg, module.parameters())
    step = trainer.make_train_step(module, optimizer, cfg)
    rng = np.random.default_rng(6)
    rgb, lidar = _frames(rng, 2)
    heat = rng.uniform(0, 1, (2, H, W, 3)).astype(np.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(trainer.TrainState(module, optimizer), torch.from_numpy(rgb),
             torch.from_numpy(lidar), torch.from_numpy(heat))
    names = {ev.name for ev in prof.events()}
    assert {"train_step/forward", "train_step/loss", "train_step/backward",
            "train_step/metrics"} <= names


def test_spans_lie_on_their_profiler_ranges(bundle):
    """On the thread that runs the profiler, each recorded span holds its
    own ``record_function`` range, all under one offset between
    :func:`tracing.now`'s clock and the profiler's; mapped by it, each span
    lies within 200 us of its range."""
    engine = InferenceEngine(bundle, buckets=(8,))
    rgb, lidar = _frames(np.random.default_rng(3), 8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("warm"):     # a session's first range opens slowly
            pass
        engine.run(rgb, lidar)
    ranges = {}
    for ev in sorted(prof.events(), key=lambda ev: ev.time_range.start):
        ranges.setdefault(ev.name, []).append(ev.time_range)
    spans = [s for s in sorted(tracing.spans(), key=lambda s: s.start)
             if s.name not in ("warm", "engine/request")]
    assert len(spans) == 6 + len(STAGES)   # batch, pad, h2d, forward, d2h, deliver
    pairs, seen = [], {}
    for s in spans:
        k = seen[s.name] = seen.get(s.name, -1) + 1
        pairs.append((s.start * 1e-3, s.end * 1e-3, ranges[s.name][k], s.name))
    # the offsets (us) under which every range lies inside its span
    lo = max(r.end - end for _, end, r, _ in pairs)
    hi = min(r.start - start for start, _, r, _ in pairs)
    assert lo <= hi + 5           # 5 us for the two clocks' rounding
    offset = (lo + hi) / 2
    for start, end, r, name in pairs:
        assert abs(start + offset - r.start) < 200, name
        assert abs(end + offset - r.end) < 200, name


@pytest.mark.parametrize("module, name", COUNTERS)
def test_launch_counters_are_the_recorders_counter_type(module, name):
    counter = getattr(importlib.import_module(f"dmmfods_tpu_torch.ops.{module}"), name)
    assert isinstance(counter, tracing.LaunchCount) and isinstance(counter.value, int)
