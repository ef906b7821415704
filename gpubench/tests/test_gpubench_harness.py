"""The harness on the CPU at a tiny size: the last line's format in every
cell of ``BENCHMARK.json``, a cell, a metric and a model family added from
data files alone, answers that are dicts of arrays carried from the engine
to the numbers, the command's refusals, each fault a cell can have turning
``correct`` false, and the profiler's stop after a stream's drain."""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import subprocess
import sys
import time

import pytest
import torch

from _bench import CELLS, ROOT, copy_benchmark, harness_code, run, shrink

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def add_mix_cell(root):
    """A throwaway stream cell of the repository's data kind: requests of
    1, 2 and 4 frames from three clients, coalesced into buckets of 1, 4 and
    8, at the test's size; ``"mix"``."""
    base = root / "gpubench"
    t = json.loads((base / "traffic" / "cam-b1-1280x1920-2clients.json").read_text())
    t.update(frames_per_request=[1, 2, 4], buckets=[1, 4, 8], clients=3, reference_chunk=8,
             why="a throwaway mix")
    (base / "traffic" / "mix.json").write_text(json.dumps(t))
    (base / "limits" / "mix.json").write_text(
        (base / "limits" / "d161-cam-1280x1920.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "mix", "config": "densenet121-mid2", "traffic": "mix",
                               "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct_and_its_line_has_the_contracts_keys(tiny_root, workload):
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    for trace in (0, 1):
        result, lines = run(tiny_root, workload, trace=trace)
        keys = list(result)
        assert keys[:5] == RESULT_KEYS and keys[-1] == "checks"
        assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
        group = "per_layer" if trace else "end_to_end"
        listed = {m["name"]: m for m in bench[group]
                  if workload in m.get("workloads", [workload])}
        assert set(result["metrics"]) <= set(listed)
        if not trace:
            assert set(result["metrics"]) == set(listed)
        for name, m in result["metrics"].items():
            assert m["unit"] == listed[name]["unit"] and isinstance(m["value"], float)
        for name, c in result["checks"].items():
            assert c["value"] <= c["limit"], name
        if trace:
            assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
            assert result["device"]["window_s"] > 0
        json.loads(json.dumps(result))
        assert lines[-len(result["checks"]):] == [
            line for line in lines if line.startswith("check ")]


def test_a_new_cell_and_metric_need_only_new_files_and_entries(tmp_path):
    root = copy_benchmark(tmp_path)
    shrink(root)
    code_before = harness_code()
    base = root / "gpubench"
    traffic = json.loads((base / "traffic" / "score-b256-128x192.json").read_text())
    traffic.update(batch=4, buckets=[4], why="a throwaway cell")
    (base / "traffic" / "score-b4-throwaway.json").write_text(json.dumps(traffic))
    (base / "limits" / "throwaway-score-b4.json").write_text(
        (base / "limits" / "d121-score-b256.json").read_text())
    (base / "metrics" / "frames_per_call.py").write_text(
        "def read(run):\n"
        "    return run.frames / run.attempted if run.attempted else None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "throwaway-score-b4", "config": "densenet161-mid3",
                               "traffic": "score-b4-throwaway", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "frames_per_call", "unit": "frames", "better": "higher",
                               "source": "host_clock", "layer": "engine", "moves": "score_fps",
                               "workloads": ["throwaway-score-b4"]})
    for m in bench["end_to_end"]:
        if m["name"] == "score_fps":
            m["workloads"].append("throwaway-score-b4")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    result, _ = run(root, "throwaway-score-b4", trace=0)
    assert result["correct"] and set(result["metrics"]) == {"score_fps", "setup_s"}
    result, _ = run(root, "throwaway-score-b4", trace=1)
    assert result["metrics"]["frames_per_call"]["value"] == 4.0
    assert "score_mfu" not in result["metrics"]           # listed for its own cell only
    assert code_before == harness_code()


def test_the_command_refuses_without_a_card():
    proc = subprocess.run([sys.executable, "gpubench/run.py", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    copy_benchmark(tmp_path)
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, time; sys.path[:0] = ['.']; from gpubench.run import run_cell; "
         f"run_cell('.', {CELLS[0]!r}, 1, 1.0, 0, 'cpu', time.perf_counter())"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONNOUSERSITE": "1"})
    assert proc.returncode != 0 and "dmmfods_tpu_torch" in proc.stderr


# -- faults: the timed path broken underneath, ``correct`` must come out false


def _fault(out, how):
    out = out.clone()
    if how == "half_batch":              # half the batch left out, the rest repeated
        half = max(1, out.shape[0] // 2)
        out[half:] = out[:out.shape[0] - half]
    elif how == "answer":                # one answer altered where it is produced
        corner = (0,) + (slice(0, 4),) * min(2, out.dim() - 1)
        out[corner] = 1 - out[corner]
    return out


def _break_engine(monkeypatch, how):
    """Each device batch's answer (an array, or each array of a dict)
    broken as ``how`` says."""
    from dmmfods_tpu_torch.serving import InferenceEngine

    forward = InferenceEngine.forward

    def broken(self, rgb, lidar):
        out = forward(self, rgb, lidar)
        if isinstance(out, dict):
            return {k: _fault(v, how) for k, v in out.items()}
        return _fault(out, how)

    monkeypatch.setattr(InferenceEngine, "forward", broken)


def _largest_bucket(workload):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    traffic = next(w["traffic"] for w in bench["workloads"] if w["name"] == workload)
    return max(json.loads((ROOT / "gpubench" / "traffic" / f"{traffic}.json").read_text())
               ["buckets"])


# every cell's answer altered, and half of each device batch left out where
# a batch holds more than one frame; then the same in a request mix
FAULTS = [(w, how) for w in CELLS for how in ("half_batch", "answer")
          if how == "answer" or _largest_bucket(w) > 1] + [("mix", "half_batch"),
                                                           ("mix", "answer")]


@pytest.mark.parametrize("workload,how", FAULTS)
def test_a_broken_serving_path_is_not_correct(tiny_root, monkeypatch, workload, how):
    add_mix_cell(tiny_root)
    _break_engine(monkeypatch, how)
    result, _ = run(tiny_root, workload, seconds=1.5)
    assert result["correct"] is False


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(tiny_root, workload):
    """The fp8 control, the reference with fp8 convs in the program's place,
    fails the cell's limits (here at the test's size)."""
    from gpubench import check, spec
    from gpubench.loops import LOOPS

    cell = spec.load_cell(tiny_root, workload)
    loop = LOOPS[cell.traffic["loop"]](cell, 2**31 + 99, "cpu")
    loop.setup(1.0)
    loop.window(1.0, False)
    loop.release()
    correct, rows = check.judge(loop.numbers(loop.control_readings()), cell.limits["numbers"])
    assert not correct, rows


def test_a_request_mix_is_served_and_judged_request_by_request(tiny_root):
    add_mix_cell(tiny_root)
    result, lines = run(tiny_root, "mix", seconds=2.0)
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 6 and "served_fps" not in result["metrics"]


def test_the_requests_give_every_seed_the_same_sizes_and_keep_a_fair_sample():
    from gpubench import inputs

    def draw(seed, n=600):
        r = inputs.Requests(seed, [1, 4, 8], 32, 5)
        out = [r.next() for _ in range(n)]
        return r, [k for _, _, k, _ in out], [o for _, o, _, _ in out]

    a, a_size, a_off = draw(2**31 + 1)
    b, b_size, _ = draw(2**31 + 2)
    assert sorted(a_size) == sorted(b_size) == sorted([1, 4, 8] * 200)
    assert a_size != b_size and all(0 <= o <= 32 - k for o, k in zip(a_off, a_size))
    assert draw(2**31 + 1)[1:] == (a_size, a_off)          # the same seed, the same requests
    held = a.held()
    assert len(held) == 6 and a.longest == a_size.index(8) and a.longest in held
    assert max(held) > 300                                  # the sample reaches late requests


# -- model families: a new one from new files alone, and answers that are
# dicts of fixed-size arrays

SECOND_FAMILY = '''"""A second family over the same program: the Dense U-Net judged by the
largest mean gap of a kept answer's heat maps, reading K1's launches alone."""

from pathlib import Path

import numpy as np

from gpubench import spec

_unet = spec.load_family(Path(__file__).resolve().parents[2], "dense_unet_lidar")
build, reference, make_state_dict = _unet.build, _unet.reference, _unet.make_state_dict
reference_answers, frames, take = _unet.reference_answers, _unet.frames, _unet.take
flops_per_frame, param_count, tiny = _unet.flops_per_frame, _unet.param_count, _unet.tiny


def numbers(pairs):
    gaps = [float(np.abs(got.astype(np.float64) - ref).mean()) for got, ref in pairs.values()]
    return {"heat_mean_abs": max(gaps) if gaps else float("nan")}


def counters():
    return {"K1": _unet.counters()["K1"]}
'''


def test_a_new_family_needs_only_new_files_and_entries(tmp_path):
    """A family file, its configuration, traffic, limits, a metric and a
    workload entry: the cell runs traced and untraced, judged by the
    family's own number and reading its counters alone, and no byte of the
    harness's code changes."""
    root = copy_benchmark(tmp_path)
    code_before = harness_code()
    base = root / "gpubench"
    (base / "families" / "unet_mean_gap.py").write_text(SECOND_FAMILY)
    config = json.loads((base / "configs" / "densenet121-mid2.json").read_text())
    config.update(name="d121-mean-gap", family="unet_mean_gap")
    (base / "configs" / "d121-mean-gap.json").write_text(json.dumps(config))
    traffic = json.loads((base / "traffic" / "score-b256-128x192.json").read_text())
    (base / "traffic" / "score-mean-gap.json").write_text(json.dumps(traffic))
    (base / "limits" / "mean-gap-score.json").write_text(json.dumps(
        {"why": "a test", "numbers": {"heat_mean_abs": {"limit": 0.01}}}))
    (base / "metrics" / "counters_read.py").write_text(
        "def read(run):\n"
        "    return float(len(set().union(*run.forward_launches))) if run.forward_launches "
        "else None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "mean-gap-score", "config": "d121-mean-gap",
                               "traffic": "score-mean-gap", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "counters_read", "unit": "counters", "better": "higher",
                               "source": "program_counter", "layer": "model",
                               "moves": "score_fps", "workloads": ["mean-gap-score"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    shrink(root)
    assert json.loads((base / "configs" / "d121-mean-gap.json").read_text())["model"][
        "growth_rate"] == 8                                 # cut by the family's tiny

    for trace in (0, 1):
        result, lines = run(root, "mean-gap-score", trace=trace)
        assert result["correct"] is True, lines
        assert set(result["checks"]) == {"heat_mean_abs"}
        assert result["checks"]["heat_mean_abs"]["value"] >= 0.0
    assert result["metrics"]["counters_read"]["value"] == 1.0     # K1 alone
    result, _ = run(root, CELLS[0])              # the family beside it is untouched
    assert result["correct"] is True and "heat_mean_abs" not in result["checks"]
    assert code_before == harness_code()


STUB_FAMILY = '''"""A stand-in family whose answer is a dict of fixed-size arrays, as a
detector's decoded set: per frame, the K best pixels of a per-pixel score
(a 4 -> 1 linear map of RGB + LiDAR through a sigmoid), their boxes and
their scores."""

import numpy as np
import torch
from torch import nn

from gpubench import inputs

K = 5


class Net(nn.Module):
    def __init__(self, arch, quant=None):
        super().__init__()
        self.mix, self.quant = nn.Linear(4, 1), quant

    def forward(self, rgb, lidar):
        x = torch.cat([rgb, lidar], -1).float()
        if self.quant == "fp8":
            x = x.to(torch.float8_e4m3fn).float()
        score = torch.sigmoid(self.mix(x)[..., 0])
        n, h, w = score.shape
        top = score.reshape(n, -1).topk(K, dim=1)
        ys, xs = top.indices // w, top.indices % w
        return {"boxes": torch.stack([xs, ys, xs + 1, ys + 1], -1).float(),
                "scores": top.values}


class Bundle:
    def __init__(self, module):
        self.module = module


def build(config, device):
    return Bundle(Net(config["model"]).to(device))


def reference(arch, quant=None):
    return Net(arch, quant)


def make_state_dict(arch, seed, device):
    g = inputs.generator(seed, inputs.WEIGHTS, device)
    w = torch.randn(5, generator=g, device=device)
    return {"mix.weight": w[:4].view(1, 4), "mix.bias": w[4:]}


def reference_answers(net, rgb, lidar, chunk):
    with torch.no_grad():
        out = net(torch.as_tensor(rgb), torch.as_tensor(lidar))
    return {k: v.numpy() for k, v in out.items()}


def frames(answer):
    return answer["scores"].shape[0]


def take(answer, idx):
    return {k: v[list(idx)].copy() for k, v in answer.items()}


def numbers(pairs):
    out = {"box_max_abs": 0.0, "score_max_abs": 0.0}
    for got, ref in pairs.values():
        for name, key in (("box_max_abs", "boxes"), ("score_max_abs", "scores")):
            if got[key].shape != ref[key].shape:
                return {k: float("nan") for k in out}
            out[name] = max(out[name], float(np.abs(got[key] - ref[key]).max()))
    return out if pairs else {k: float("nan") for k in out}


def flops_per_frame(arch, h, w, train=False):
    return 2 * 4 * h * w


def counters():
    return {}


def param_count(arch):
    return 5


def tiny(config):
    return config
'''


class StubEngine:
    """The engine's surface as the loops use it, over a module whose
    answers are dicts of tensors: ``run`` and ``submit`` give dicts of host
    arrays, each device batch through ``forward``."""

    def __init__(self, bundle, *, buckets, height, width):
        self.module, self.device_batches, self.pool = bundle.module, 0, None

    def forward(self, rgb, lidar):
        self.device_batches += 1
        with torch.no_grad():
            return self.module(rgb, lidar)

    def warmup(self):
        pass

    def run(self, rgb, lidar):
        out = self.forward(torch.as_tensor(rgb), torch.as_tensor(lidar))
        return {k: v.numpy() for k, v in out.items()}

    def start(self):
        self.pool = concurrent.futures.ThreadPoolExecutor(1)

    def submit(self, rgb, lidar):
        return self.pool.submit(self.run, rgb, lidar)

    def stop(self):
        self.pool.shutdown(wait=True)


def _add_stub_cells(root):
    """The stand-in family's configuration, a score and a stream cell over
    it, and their limits: the comparison is exact."""
    base = root / "gpubench"
    (base / "families" / "dict_answers.py").write_text(STUB_FAMILY)
    (base / "configs" / "stub.json").write_text(json.dumps(
        {"name": "stub", "family": "dict_answers", "model": {}}))
    common = dict(height=16, width=24, reference_chunk=4)
    (base / "traffic" / "stub-score.json").write_text(json.dumps(dict(
        common, loop="score", buckets=[4], batch=4, pool_batches=2, kept_frames_per_call=2)))
    (base / "traffic" / "stub-stream.json").write_text(json.dumps(dict(
        common, loop="stream", buckets=[1, 2], frames_per_request=[1, 2], clients=2,
        pool_frames=8, kept_requests=4)))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for kind in ("score", "stream"):
        (base / "limits" / f"stub-{kind}.json").write_text(json.dumps(
            {"numbers": {"box_max_abs": {"limit": 0.0}, "score_max_abs": {"limit": 0.0}}}))
        bench["workloads"].append({"name": f"stub-{kind}", "config": "stub",
                                   "traffic": f"stub-{kind}", "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.mark.parametrize("kind", ["score", "stream"])
def test_answers_that_are_dicts_of_arrays_are_kept_read_and_judged(tiny_root, monkeypatch,
                                                                   kind):
    from gpubench import check, spec
    from gpubench.loops import LOOPS

    _add_stub_cells(tiny_root)
    monkeypatch.setattr("dmmfods_tpu_torch.serving.InferenceEngine", StubEngine)
    cell = spec.load_cell(tiny_root, f"stub-{kind}")

    def judged(seed):
        loop = LOOPS[kind](cell, seed, "cpu")
        loop.setup(0.5)
        rec = loop.window(0.5, False)
        loop.release()
        assert rec.attempted > 0 and rec.failed == 0
        assert loop.kept and all(set(v) == {"boxes", "scores"} for v in loop.kept.values())
        pairs = loop.readings()
        for got, ref in pairs.values():
            assert got["boxes"].shape == ref["boxes"].shape
            assert got["boxes"].shape[1:] == (5, 4) and got["scores"].shape[1:] == (5,)
        return check.judge(loop.numbers(pairs), cell.limits["numbers"])

    correct, rows = judged(2**31 + 31)
    assert correct and [r[0] for r in rows] == ["box_max_abs", "score_max_abs"]
    run = StubEngine.run

    def altered(self, rgb, lidar):                # the first frame's best score altered
        out = run(self, rgb, lidar)
        out["scores"][0, 0] += 0.25
        return out

    monkeypatch.setattr(StubEngine, "run", altered)
    correct, rows = judged(2**31 + 32)
    assert not correct and dict((r[0], r[1]) for r in rows)["score_max_abs"] > 0


# -- the profiler's stop in a stream cell


def test_a_profiler_stopped_after_the_drain_reads_the_same_slice(tiny_root, monkeypatch):
    """The profiler now stops after the requests out at the close are back;
    what it records past the close (the drain's spans and operations) is
    outside the slice. Every per-layer metric reads the same on the run's
    trace and spans as on those cut at the close, which a profiler stopped
    there would have held."""
    from dmmfods_tpu_torch import tracing
    from gpubench import program_spans as ps
    from gpubench import spec
    from gpubench import trace as tr
    from gpubench.loops import LOOPS, Tracer

    closed_at = []
    close = Tracer.close

    def close_and_note(self):
        close(self)
        closed_at.append(time.perf_counter_ns())

    monkeypatch.setattr(Tracer, "close", close_and_note)
    workload = next(w for w in CELLS if spec.load_cell(tiny_root, w).traffic["loop"] == "stream")
    cell = spec.load_cell(tiny_root, workload)
    tracing.clear()
    loop = LOOPS["stream"](cell, 2**31 + 41, "cpu")
    loop.setup(1.5)
    Tracer(loop.device).warm()
    rec = loop.window(1.5, True)
    spans = ps.recorded()
    tracing.clear()
    assert len(closed_at) == 1
    assert any(s.start > closed_at[0] for s in spans)    # the drain, recorded past the close

    hi = rec.trace.window[1]

    def read(trace, recorded):
        monkeypatch.setattr(ps, "recorded", lambda: recorded)
        run = dataclasses.replace(rec, trace=trace)
        return {m.name: m.reader(run) for m in cell.metrics
                if not m.end_to_end and m.applies_to(cell.name)}

    after_drain = read(tr.Trace(rec.trace.window, list(rec.trace.device), list(rec.trace.host)),
                       spans)
    at_close = read(tr.Trace(rec.trace.window, [d for d in rec.trace.device if d[0] < hi],
                             [h for h in rec.trace.host if h[0] < hi]),
                    [s for s in spans if s.start <= closed_at[0]])
    assert after_drain == at_close
    assert any(v is not None for v in after_drain.values())
