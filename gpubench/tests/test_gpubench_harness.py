"""The harness on the CPU at a tiny size: the last line's format, a cell and
a metric added from data files alone, the command's refusals, and each
fault a cell can have turning ``correct`` false."""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import ROOT, copy_benchmark, run, shrink

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]
CELLS = ["d121-score-b256", "d161-cam-1280x1920"]


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
    code_before = {p: p.read_bytes() for p in (ROOT / "gpubench").glob("*.py")}
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
    assert code_before == {p: p.read_bytes() for p in (ROOT / "gpubench").glob("*.py")}


def test_the_command_refuses_without_a_card():
    proc = subprocess.run([sys.executable, "gpubench/run.py", "--workload", "d121-score-b256",
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
         "run_cell('.', 'd121-score-b256', 1, 1.0, 0, 'cpu', time.perf_counter())"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONNOUSERSITE": "1"})
    assert proc.returncode != 0 and "dmmfods_tpu_torch" in proc.stderr


# -- faults: the timed path broken underneath, ``correct`` must come out false


def _break_engine(monkeypatch, how):
    from dmmfods_tpu_torch.serving import InferenceEngine

    forward = InferenceEngine.forward

    def broken(self, rgb, lidar):
        out = forward(self, rgb, lidar).clone()
        if how == "half_batch":              # half the batch left out, the rest repeated
            half = max(1, out.shape[0] // 2)
            out[half:] = out[:out.shape[0] - half]
        elif how == "answer":                # one answer altered where it is produced
            out[0, :4, :4] = 1 - out[0, :4, :4]
        return out

    monkeypatch.setattr(InferenceEngine, "forward", broken)


@pytest.mark.parametrize("workload,how", [
    ("d121-score-b256", "half_batch"), ("d121-score-b256", "answer"),
    ("d161-cam-1280x1920", "answer"), ("mix", "half_batch"), ("mix", "answer"),
])
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
