"""The program's spans in the benchmark (``gpubench/program_spans.py``) and
the five metrics that read them, on a synthetic trace with synthetic spans
worked out by hand: the clocks' offset, the labels of the idle gaps (a
client's request and a thread that ran no batch take none), each reader's
number, and ``None`` without spans; then the tiny harness, traced and not,
with the program's recorder and without it."""

from __future__ import annotations

import json
import random
import sys
import types

import pytest

from conftest import ROOT, run as run_cell
from gpubench import program_spans as ps
from gpubench import spec
from gpubench import trace as tr
from gpubench.loops import RunRecord

OFFSET = -1000.0           # the profiler's clock less the spans' (s)
WORKER, CLIENT, OTHER = 2, 1, 3
NEW = {"d121-score-b256": {"engine.host_ms.score", "engine.idle_ms.score"},
       "d161-cam-1280x1920": {"engine.host_ms.stream", "engine.idle_ms.stream",
                              "model.idle_ms.stream"}}

# (id, parent, thread, name, start, end) on the profiler's clock, seconds
SPANS = [
    (1, None, WORKER, "engine/take", -0.01, 0.049),
    (2, None, WORKER, "engine/batch", 0.049, 0.45),
    (3, 2, WORKER, "engine/group", 0.05, 0.06),
    (4, 2, WORKER, "engine/pad", 0.06, 0.08),
    (5, 2, WORKER, "engine/h2d", 0.08, 0.10),
    (6, 2, WORKER, "model/forward", 0.10, 0.30),
    (7, 6, WORKER, "model/encoder.stem", 0.11, 0.15),
    (8, 6, WORKER, "model/head", 0.20, 0.28),
    (9, 2, WORKER, "engine/device_wait", 0.30, 0.35),
    (10, 2, WORKER, "engine/d2h", 0.35, 0.40),
    (11, 2, WORKER, "engine/deliver", 0.40, 0.45),
    (12, None, WORKER, "engine/take", 0.45, 0.499),
    (13, None, WORKER, "engine/batch", 0.499, 0.70),
    (14, 13, WORKER, "engine/pad", 0.50, 0.55),
    (15, 14, WORKER, "inner", 0.505, 0.515),
    (16, 13, WORKER, "model/forward", 0.55, 0.65),
    (17, 13, WORKER, "engine/d2h", 0.65, 0.70),
    # a batch open at the slice's close: in the idle metrics' count, not
    # in the host time's
    (18, None, WORKER, "engine/batch", 0.95, 1.5),
    (19, 18, WORKER, "engine/pad", 0.96, 1.4),
    # a request open on the client over the worker's gap at 0.52
    (20, None, CLIENT, "engine/request", 0.515, 0.95),
    # a thread that ran no batch
    (21, None, OTHER, "model/head", 0.518, 0.59),
    # an earlier run's spans, long before this window
    (30, None, WORKER, "engine/batch", -50.0, -49.8),
    (31, 30, WORKER, "model/forward", -49.95, -49.85),
]
# the benchmark's engine.forward wrapper around each of this run's forwards
ANCHORS = [(0.0999, 0.3001, ps.ANCHOR), (0.5499, 0.6501, ps.ANCHOR)]
DEVICE = [(0.02, 0.07, "k"), (0.09, 0.12, "k"), (0.14, 0.31, "k"), (0.38, 0.52, "k"),
          (0.60, 1.0, "k")]
# the gaps: 0-0.02 under engine/take, 0.07-0.09 engine/pad, 0.12-0.14
# model/encoder.stem, 0.31-0.38 engine/device_wait, 0.52-0.60 engine/pad
LABELS = {"engine/take": 0.02, "engine/pad": 0.10, "model/encoder.stem": 0.02,
          "engine/device_wait": 0.07}


def _recorded():
    return [types.SimpleNamespace(id=i, parent=p, tid=t, name=n, attrs={},
                                  start=round((s - OFFSET) * 1e9), end=round((e - OFFSET) * 1e9))
            for i, p, t, n, s, e in SPANS]


def _run(loop, monkeypatch, spans=_recorded):
    monkeypatch.setattr(ps, "recorded", spans)
    cell = spec.load_cell(ROOT, "d121-score-b256" if loop == "score" else "d161-cam-1280x1920")
    trace = tr.Trace(window=(0.0, 1.0), device=list(DEVICE), host=list(ANCHORS))
    return RunRecord(cell=cell, loop=loop, window_s=1.0, attempted=2, failed=0, frames=2,
                     trace=trace)


def _metric(name):
    return spec.load_reader(ROOT / "gpubench" / "metrics" / f"{name}.py")


def test_the_offset_puts_each_forward_in_its_wrapper():
    offset = ps.clock_offset(_recorded(), ANCHORS)
    assert offset == pytest.approx(OFFSET, abs=1e-8)
    assert ps.clock_offset(_recorded(), []) is None


@pytest.mark.parametrize("late", [0.0, 0.007, -0.02])
def test_the_device_copies_correct_anchors_off_by_milliseconds(monkeypatch, late):
    """Host-clock anchors ``late`` seconds off: the pageable device-to-host
    copies, each ending just before its ``engine/d2h`` span, put the spans
    back."""
    run = _run("stream", monkeypatch)
    run.trace.host = [(s + late, e + late, name) for s, e, name in ANCHORS]
    copy = "Memcpy DtoH (Device -> Pageable)"
    ends = [x - ps.AFTER for x in (0.40, 0.70)]
    run.trace.device = sorted(run.trace.device + [(0.37, ends[0], copy), (0.66, ends[1], copy)])
    assert ps.clock_offset(_recorded(), run.trace.host) == pytest.approx(OFFSET + late,
                                                                         abs=1e-8)
    d2h = {s.id: (s.start, s.end) for s in ps.of(run) if s.name == ps.D2H}
    assert d2h == {10: pytest.approx((0.35, 0.40)), 17: pytest.approx((0.65, 0.70))}


@pytest.mark.parametrize("drift, knee", [(0.0, 0.0), (0.001, 0.0), (-0.006, 0.0),
                                         (0.0, 0.01)])
def test_the_map_follows_the_devices_drift(drift, knee):
    """The device's clock runs ``drift`` faster than the spans' (s a s), and
    ``knee`` more from the trace's second second on; the host ends each
    ``engine/d2h`` span 0-0.4 ms after its copy; the first guess is 9 ms
    off. Every copy then lies inside its mapped span, which ends at most
    0.4 ms after it; neither a copy far from any span nor a short one just
    before a batch's own is paired."""
    rng = random.Random(7)
    spans, copies = [], []
    for i in range(30):
        t = 5000.0 + 0.09 * i                 # the spans' clock, s
        post, length = rng.uniform(0, 4e-4), rng.uniform(0.012, 0.02)
        spans.append(types.SimpleNamespace(name=ps.D2H, start=round((t - length - 0.003) * 1e9),
                                           end=round(t * 1e9)))
        rel = t - 5000.0
        on_device = rel + drift * rel + knee * max(0.0, rel - 1.0)
        copies.append((on_device - post - length, on_device - post,
                       "Memcpy DtoH (Device -> Pageable)"))
    stray = [(1.0, 1.01, "Memcpy DtoH (Device -> Pageable)"),
             (copies[12][0] - 0.02, copies[12][0] - 0.015, "Memcpy DtoH (Device -> Pageable)")]
    knots = ps.device_map(spans, sorted(copies + stray), -5000.0 + 0.009)
    assert len(knots) == 30
    for s, (cs, ce, _) in zip(spans, copies):
        start, end = (x * 1e-9 + ps.shift(knots, x * 1e-9) for x in (s.start, s.end))
        assert start <= cs and ce < end <= ce + 4.5e-4


def test_without_copies_the_map_is_the_first_guess():
    assert ps.device_map([], [(0.0, 1.0, "k")], 3.0) == [(0.0, 3.0)]
    assert ps.shift([(0.0, 3.0)], 12.0) == 3.0
    assert ps.shift([(1.0, 3.0), (2.0, 5.0)], 1.25) == pytest.approx(3.5)


@pytest.mark.parametrize("bench", [[], [(0.065, 0.46, "gpubench/engine.run")]])
def test_gaps_are_labelled_by_the_workers_innermost_span(monkeypatch, bench):
    """The program's spans label the gaps, a client's request and a thread
    that ran no batch aside; a benchmark range that opens inside them, as
    one on another clock may, takes no label from them."""
    run = _run("stream", monkeypatch)
    outside_spans = [(0.70, 0.96, "gpubench/engine.run")]   # from 0.70 to batch 3 at 0.95
    run.trace.host = sorted(run.trace.host + bench + outside_spans)
    spans = ps.of(run)
    assert not {30, 31} & {s.id for s in spans}      # the earlier run's left out
    assert len(spans) == len(SPANS) - 2
    totals = dict(tr.gaps_by_label(run.trace))
    assert totals == {k: pytest.approx(v) for k, v in LABELS.items()}
    # the benchmark's ranges stay only where no program span is open
    assert [h for h in run.trace.host if h[2].startswith("gpubench/")] == [
        (pytest.approx(0.70), pytest.approx(0.95), "gpubench/engine.run")]
    assert ps.of(run) is spans and len(run.trace.host) == 19 + 1   # once


@pytest.mark.parametrize("loop, name, want", [
    ("score", "engine.host_ms.score", (0.14 + 0.09) / 2 * 1e3),
    ("stream", "engine.host_ms.stream", (0.15 + 0.09) / 2 * 1e3),
    ("score", "engine.idle_ms.score", 0.10 / 3 * 1e3),
    ("stream", "engine.idle_ms.stream", 0.10 / 3 * 1e3),
    ("stream", "model.idle_ms.stream", 0.02 / 2 * 1e3),
])
def test_each_reader_by_hand(monkeypatch, loop, name, want):
    # host: batch 1 group 0.01, pad 0.02, h2d 0.02, d2h 0.05, deliver 0.05;
    # batch 2 pad 0.05 less its child's 0.01, d2h 0.05
    read = _metric(name)
    assert read(_run(loop, monkeypatch)) == pytest.approx(want)
    other = "stream" if loop == "score" else "score"
    assert read(_run(other, monkeypatch)) is None
    assert read(_run(loop, monkeypatch, spans=lambda: None)) is None     # no recorder
    assert read(_run(loop, monkeypatch, spans=lambda: [])) is None       # nothing recorded
    no_trace = _run(loop, monkeypatch)
    no_trace.trace = None
    assert read(no_trace) is None


def test_every_new_metric_is_listed_for_its_cell():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    listed = {m["name"]: m for m in bench["per_layer"]}
    for cell, names in NEW.items():
        for name in names:
            assert listed[name]["workloads"] == [cell]


@pytest.mark.parametrize("workload", sorted(NEW))
def test_a_traced_run_reads_the_new_metrics_and_an_untraced_one_is_unchanged(
        tiny_root, workload):
    from dmmfods_tpu_torch import tracing

    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    e2e = {m["name"] for m in bench["end_to_end"] if workload in m.get("workloads", [workload])}
    tracing.clear()
    result, _ = run_cell(tiny_root, workload, trace=0)
    assert set(result["metrics"]) == e2e and "breakdown" not in result
    assert tracing.spans() == []              # the recorder stayed off
    result, _ = run_cell(tiny_root, workload, trace=1)
    assert NEW[workload] <= set(result["metrics"])
    assert all(result["metrics"][m]["value"] >= 0 for m in NEW[workload])
    tracing.clear()


def test_a_program_without_the_recorder_runs_and_reads_none_of_them(tiny_root, monkeypatch):
    monkeypatch.setitem(sys.modules, "dmmfods_tpu_torch.tracing", None)
    for workload, names in NEW.items():
        result, _ = run_cell(tiny_root, workload, trace=1)
        assert result["correct"] and not names & set(result["metrics"])
        assert all(not label.startswith(("engine/", "model/"))
                   for label, _ in result["breakdown"]["idle_gaps"])
