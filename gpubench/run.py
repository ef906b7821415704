"""Run one cell of the benchmark once.

    python3 gpubench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json`` (beside this folder): a model
configuration under a traffic mix, read from the files named in
``gpubench/spec.py``. The run builds the program (``dmmfods_tpu_torch``) on
the card, makes its weights and inputs from the seed, warms up the cell's
shapes, measures for ``--seconds`` seconds, then frees the program and holds
what the window produced against the plain reference of the configuration's
model family (``gpubench/families/``). The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each compared number
beside its limit, which standard error also ends with.

It exits non-zero, and prints no result, without a CUDA device (or with
fewer than the cell asks for), when the program cannot be imported, and when
JAX or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dmmfods_tpu")
HOST_CPUS = 4      # the cores a run is pinned to, and torch's host threads


def process_age_s():
    """Seconds since this process started, from ``/proc`` (10 ms ticks);
    the time since this module was first read where that is unavailable."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_START


def bytes_written():
    """This process's bytes sent to storage and written through write calls
    (``/proc/self/io``), or ``None`` where that is unavailable."""
    try:
        with open("/proc/self/io") as f:
            fields = dict(line.split(": ") for line in f.read().splitlines())
        return int(fields["write_bytes"]), int(fields["wchar"])
    except (OSError, KeyError, ValueError):
        return None


def loaded_forbidden():
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & set(FORBIDDEN))


def _num(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def power_limit():
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def pin_host(torch):
    """Pin the process to a fixed set of ``HOST_CPUS`` cores (the first of
    those it may use) and torch to as many host threads, so that the
    program's host work does not move between cores or spread over all of
    them; the cores pinned, as a list."""
    try:
        cpus = sorted(os.sched_getaffinity(0))[:HOST_CPUS]
        os.sched_setaffinity(0, cpus)
    except (AttributeError, OSError):
        cpus = list(range(min(HOST_CPUS, os.cpu_count() or 1)))
    torch.set_num_threads(len(cpus))
    return cpus


def run_cell(root, workload, seed, seconds, trace, device, process_start):
    """One run of one cell on ``device``: ``(result dict, stderr lines)``.
    ``process_start`` is the process's start on the ``perf_counter`` clock."""
    import torch

    from gpubench import check, spec
    from gpubench.loops import LOOPS

    t_imports = time.perf_counter() - process_start
    cell = spec.load_cell(root, workload)
    loop = LOOPS[cell.traffic["loop"]](cell, seed, device)
    if loop.device.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(loop.device)
    loop.setup(seconds)
    if trace:
        from gpubench.loops import Tracer

        loop._part("profiler", lambda: Tracer(loop.device).warm())
    gc.collect()
    gc.freeze()          # set-up's objects are never scanned again
    gc.disable()         # no collection pauses inside the window
    try:
        rec = loop.window(seconds, trace)
    finally:
        gc.enable()
        gc.unfreeze()
    rec.setup_s = loop.t_window - process_start
    memory_peak = (torch.cuda.max_memory_allocated(loop.device)
                   if loop.device.type == "cuda" else 0)
    loop.release()
    t = time.perf_counter()
    numbers = loop.numbers(loop.readings())
    reference_s = time.perf_counter() - t
    correct, rows = check.judge(numbers, cell.limits["numbers"])
    correct = correct and rec.failed == 0

    metrics = {}
    for m in cell.metrics:
        if m.end_to_end == bool(trace) or not m.applies_to(cell.name):
            continue
        value = m.reader(rec)
        if value is None:
            if m.end_to_end:
                raise RuntimeError(f"{cell.name} lists end-to-end metric {m.name}, "
                                   "whose reader found nothing")
            continue
        metrics[m.name] = {"value": float(value), "unit": m.unit}

    kind = torch.cuda.get_device_name(loop.device) if loop.device.type == "cuda" else "cpu"
    result = {"correct": bool(correct), "attempted": int(rec.attempted),
              "failed": int(rec.failed), "metrics": metrics,
              "device": {"platform": "gpu" if loop.device.type == "cuda" else "cpu",
                         "kind": kind, "count": cell.chips,
                         "memory_peak_bytes": int(memory_peak)}}
    if rec.trace is not None:
        from gpubench import trace as tr

        result["device"]["busy_s"] = tr.busy_s(rec.trace)
        result["device"]["window_s"] = rec.trace.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(rec.trace),
                               "idle_gaps": tr.gaps_by_label(rec.trace)}
    result["checks"] = {name: {"value": _num(v), "limit": _num(lim)} for name, v, lim in rows}

    parts = dict(loop.parts, imports=t_imports)
    lines = [f"setup_s {rec.setup_s:.4f}: " + ", ".join(
                 f"{k} {v:.4f}" for k, v in parts.items())
             + f"; reference after the window {reference_s:.4f} s (not set-up)",
             f"window {rec.window_s:.4f} s, attempted {rec.attempted}, failed {rec.failed}, "
             f"frames {rec.frames}"]
    lines += rec.notes
    if rec.trace is not None:
        from gpubench import trace as tr

        lines.append("device time by class in the traced window: " + ", ".join(
            f"{k} {v:.6f} s" for k, v in tr.by_class(rec.trace).items()))
    lines += [f"check {name} {v!r} <= limit {lim!r}: {'ok' if v <= lim else 'FAIL'}"
              for name, v, lim in rows]
    return result, lines


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    process_start = time.perf_counter() - process_age_s()
    sys.path.insert(0, str(ROOT))

    from gpubench import spec

    cell = spec.load_cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    cpus = pin_host(torch)
    print(f"card: {power_limit()}; host cores {cpus}", file=sys.stderr)
    result, lines = run_cell(ROOT, args.workload, args.seed, args.seconds, args.trace,
                             "cuda:0", process_start)
    found = loaded_forbidden()
    if found:
        print(f"the run loaded {found}: nothing that runs here may load JAX or the JAX "
              "package", file=sys.stderr)
        return 3
    written = bytes_written()
    if written is not None:
        lines.insert(0, f"this process wrote {written[0]} bytes to storage ({written[1]} "
                        "through write calls)")
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
