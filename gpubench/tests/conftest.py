"""Shared set-up of the benchmark's CPU tests: the repository on the path,
and a copy of the benchmark's data at a tiny size (DenseNet widths cut to
growth 8, blocks (2, 2, 2, 2), 16 initial features; 64x96 frames; small
batches and pools), which the harness runs on the CPU.

Run: ``python -m pytest gpubench/tests -q`` (about a minute; needs no card).
The repository's ``pytest tests/`` does not collect these.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_ARCH = dict(growth_rate=8, block_config=[2, 2, 2, 2], num_init_features=16)


def shrink(root: Path, dtype="float32"):
    """Cut the copy at ``root`` to the tiny size, in place."""
    for path in (root / "gpubench" / "configs").glob("*.json"):
        c = json.loads(path.read_text())
        c["model"].update(TINY_ARCH)
        c["gpu"]["compute_dtype"] = dtype
        path.write_text(json.dumps(c))
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


@pytest.fixture
def tiny_root(tmp_path):
    root = copy_benchmark(tmp_path)
    shrink(root)
    return root


def run(root, workload, seed=2**31 + 11, seconds=1.0, trace=0):
    """One run of a cell on the CPU: ``(result, stderr lines)``."""
    import time

    from gpubench.run import run_cell

    return run_cell(root, workload, seed, seconds, trace, "cpu", time.perf_counter())
