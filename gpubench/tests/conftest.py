"""Fixtures of the benchmark's CPU tests; the helpers are in ``_bench.py``.

Run: ``python -m pytest gpubench/tests -q`` (a few minutes; needs no card).
The repository's ``pytest tests/`` does not collect these.
"""

from __future__ import annotations

import pytest

from _bench import copy_benchmark, shrink


@pytest.fixture
def tiny_root(tmp_path):
    root = copy_benchmark(tmp_path)
    shrink(root)
    return root
