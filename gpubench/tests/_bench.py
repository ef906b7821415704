"""Helpers of the benchmark's CPU tests: the repository on the path, and a
copy of the benchmark's data cut to the tests' size, which the harness runs
on the CPU: each configuration by its model family's ``tiny``, 64x96
frames, small batches and pools.

A module of its own, not ``conftest.py``, so that a pytest session that also
collects another directory's ``conftest.py`` imports neither in place of
the other.
"""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpubench import spec  # noqa: E402

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def configs(root=ROOT):
    """``{config name: configuration}`` of the files on disk."""
    return {p.stem: json.loads(p.read_text())
            for p in sorted((Path(root) / "gpubench" / "configs").glob("*.json"))}


def family(config, root=ROOT):
    return spec.load_family(root, config["family"])


def tiny_config(config, dtype="float32", root=ROOT):
    """``config`` cut by its family's ``tiny``, computing in ``dtype``."""
    c = family(config, root).tiny(config)
    c["gpu"] = dict(c["gpu"], compute_dtype=dtype)
    return c


def shrink(root: Path, dtype="float32"):
    """Cut the copy at ``root`` to the tiny size, in place."""
    for path in (root / "gpubench" / "configs").glob("*.json"):
        path.write_text(json.dumps(tiny_config(json.loads(path.read_text()), dtype, root)))
    for path in (root / "gpubench" / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        t["height"], t["width"] = 64, 96
        if t["loop"] == "score":
            t.update(batch=8, buckets=[8], pool_batches=2)
        else:
            t.update(pool_frames=16, kept_requests=6)
        path.write_text(json.dumps(t))


def copy_benchmark(dest: Path) -> Path:
    """``BENCHMARK.json`` and the benchmark's data files (no tests, no
    caches) under ``dest``; the harness's code stays the repository's."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "gpubench", dest / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests", "*.pyc"))
    return dest


def harness_code(root=ROOT):
    """The bytes of the harness's code: ``gpubench/*.py`` and the family
    files."""
    base = Path(root) / "gpubench"
    return {p: p.read_bytes() for p in sorted([*base.glob("*.py"),
                                               *base.glob("families/*.py")])}


def run(root, workload, seed=2**31 + 11, seconds=1.0, trace=0):
    """One run of a cell on the CPU: ``(result, stderr lines)``."""
    from gpubench.run import run_cell

    return run_cell(root, workload, seed, seconds, trace, "cpu", time.perf_counter())
