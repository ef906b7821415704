"""What a run reads from disk, found by name under the benchmark's root (the
directory that holds ``BENCHMARK.json``):

* ``gpubench/configs/<config>.json``: a model configuration as it is run;
* ``gpubench/traffic/<traffic>.json``: a traffic mix, whose ``loop`` names
  the loop that drives it (``score``, ``stream`` or ``train``) and whose
  other keys are that loop's parameters;
* ``gpubench/limits/<cell>.json``: the limit of each number the cell's
  correctness check compares, with the readings it was set from;
* ``gpubench/metrics/<metric>.py``: one reader per metric, ``read(run)``
  returning a number or ``None`` when the run holds nothing to read.

A new cell or metric is new files and new entries in ``BENCHMARK.json``;
no code here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Optional

PACKAGE = "gpubench"


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    end_to_end: bool
    workloads: Optional[list]
    reader: object

    def applies_to(self, cell_name: str) -> bool:
        return self.workloads is None or cell_name in self.workloads


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    metrics: list            # of Metric: the end-to-end ones, then the per-layer ones
    root: Path

    @property
    def arch(self) -> dict:
        return self.config["model"]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_reader(path: Path):
    """The ``read`` function of a metric's file."""
    spec = importlib.util.spec_from_file_location(f"{PACKAGE}_metric_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load_cell(root, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    root = Path(root)
    bench = _json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}; it has "
                       f"{[w['name'] for w in bench['workloads']]}")
    base = root / PACKAGE
    config = _json(base / "configs" / f"{entry['config']}.json")
    traffic = _json(base / "traffic" / f"{entry['traffic']}.json")
    limits = _json(base / "limits" / f"{name}.json")
    metrics = []
    for group, e2e in (("end_to_end", True), ("per_layer", False)):
        for m in bench[group]:
            metrics.append(Metric(m["name"], m["unit"], m["better"], m["source"], e2e,
                                  m.get("workloads"),
                                  load_reader(base / "metrics" / f"{m['name']}.py")))
    return Cell(name=name, chips=int(entry["chips"]), config=config, traffic=traffic,
                limits=limits, metrics=metrics, root=root)
