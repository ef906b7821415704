"""The trace arithmetic and the device readers on a synthetic trace: busy
time, idle gaps and their labels, the idle shares, and the roofline shares
worked out by hand."""

from __future__ import annotations

import json

import pytest

from _bench import ROOT
from gpubench import flops, spec
from gpubench import trace as tr
from gpubench.loops import RunRecord

K2 = "void tc::dense_layer_mma_kernel<192, 48>(...)"
K3 = "void tc::phase_head_mma_kernel<256, 96, 48>(...)"
EW = "void at::native::vectorized_elementwise_kernel<4>(...)"
COPY = "Memcpy HtoD (Pageable -> Device)"


def _trace():
    # window 0..10 s; device busy 1..3 (overlapping ops) and 5..6
    return tr.Trace(window=(0.0, 10.0),
                    device=[(1.0, 2.0, K2), (1.5, 3.0, K3), (5.0, 6.0, EW), (9.5, 11.0, COPY)],
                    host=[(0.0, 4.0, "gpubench/engine.run"), (0.5, 1.2, "gpubench/engine.forward"),
                          (4.5, 8.0, "train_step/backward")])


def test_busy_and_idle_gaps():
    t = _trace()
    assert tr.busy_s(t) == pytest.approx(2.0 + 1.0 + 0.5)
    assert tr.idle_gaps(t) == [(0.0, 1.0), (3.0, 5.0), (6.0, 9.5)]
    assert tr.label_at(t, 0.8) == "gpubench/engine.forward"
    assert tr.label_at(t, 3.0) == "gpubench/engine.run"
    assert tr.label_at(t, 9.0) == "no host span"


def test_gap_labels_follow_the_span_open_when_the_gap_began():
    totals = dict(tr.gaps_by_label(_trace()))
    # 0..1 opens under engine.run (0..4), not engine.forward (0.5..1.2);
    # 3..5 under engine.run; 6..9.5 under train_step/backward (4.5..8)
    assert totals == {"gpubench/engine.run": pytest.approx(3.0),
                      "train_step/backward": pytest.approx(3.5)}


def test_classes_and_top_ops():
    t = _trace()
    assert tr.kernel_class(K2) == "K2" and tr.kernel_class(K3) == "K3"
    assert tr.kernel_class(EW) == "elementwise" and tr.kernel_class(COPY) == "copies and fills"
    assert tr.by_class(t)["K3"] == pytest.approx(1.5)
    assert tr.top_ops(t)[0] == [K3, pytest.approx(1.5)]
    assert tr.intersect([(0, 2), (3, 5)], [(1, 4)]) == pytest.approx(2.0)


def _metric(name):
    return spec.load_reader(ROOT / "gpubench" / "metrics" / f"{name}.py")


def _cell(name="d161-cam-1280x1920"):
    return spec.load_cell(ROOT, name)


def test_idle_shares():
    t = _trace()
    for name, cell, loop in (("idle_share.score", "d121-score-b256", "score"),
                             ("idle_share.stream", "d161-cam-1280x1920", "stream")):
        run = RunRecord(cell=_cell(cell), loop=loop, window_s=10, attempted=1, failed=0,
                        frames=1, trace=t)
        assert _metric(name)(run) == pytest.approx(100 * (1 - 3.5 / 10))
        run.loop = "score" if loop == "stream" else "stream"
        assert _metric(name)(run) is None


def test_rooflines():
    cell = _cell()
    arch = cell.arch
    t = tr.Trace(window=(0.0, 1.0), device=[(0.0, 0.02, K2), (0.1, 0.105, K3)], host=[])
    run = RunRecord(cell=cell, loop="stream", window_s=1, attempted=1, failed=0, frames=1,
                    trace=t, forwards_traced=2,
                    forward_launches=[{"K1": 1, "K2": 4, "K3": 1}] * 3)
    want_k2 = 100 * 2 * flops.k2_bound_s(arch, 1280, 1920, 1) / 0.02
    assert _metric("k2_roofline")(run) == pytest.approx(want_k2)
    assert _metric("k3_roofline")(run) == pytest.approx(
        100 * 2 * flops.k3_bound_s(arch, 1280, 1920) / 0.005)
    # a forward whose launches disagree with the blocks and head counted
    # from shapes: the bound would be another call's, so neither reads
    run.forward_launches = [{"K1": 1, "K2": 4, "K3": 1}, {"K1": 1, "K2": 2, "K3": 2}]
    assert _metric("k2_roofline")(run) is None and _metric("k3_roofline")(run) is None
    run.forward_launches = [{"K1": 1, "K2": 0, "K3": 0}]
    assert _metric("k2_roofline")(run) is None and _metric("k3_roofline")(run) is None


def test_every_metric_has_a_reader_and_every_reader_a_metric():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = {m["name"] for group in ("end_to_end", "per_layer") for m in bench[group]}
    files = {p.stem for p in (ROOT / "gpubench" / "metrics").glob("*.py")}
    assert names == files
