"""What a run reads from disk, found by name under the benchmark's root (the
directory that holds ``BENCHMARK.json``):

* ``gpubench/configs/<config>.json``: a model configuration as it is run,
  whose ``family`` names its model family;
* ``gpubench/families/<family>.py``: everything the harness knows of one
  family of models, as module-level names (the loops, the run and the
  tests call these and name no family):

  - ``build(config, device)``: the program's model bundle, as
    ``InferenceEngine`` takes it (the one place that imports the program's
    model code);
  - ``reference(arch, quant=None)``: the plain reference module, float32,
    importing nothing of the program; ``quant="fp8"`` gives the control;
  - ``make_state_dict(arch, seed, device)``: the seeded weights both load;
  - ``reference_answers(net, rgb, lidar, chunk)``: what each frame's answer
    is held to, on the host, frames first;
  - ``frames(answer)``, ``take(answer, idx)``: the frames an engine answer
    holds, and a copy of some of them (an answer is an array or a dict of
    fixed-size arrays, frames first);
  - ``numbers(pairs)``: the numbers that decide ``correct``, under the
    names of the cell's limits file, from ``{key: (answer, reference)}``;
  - ``flops_per_frame(arch, h, w, train=False)``: the operations of a frame;
  - ``counters()``: the program's launch counters, ``{name: counter}``,
    that the loops read around each forward;
  - ``param_count(arch)``;
  - ``tiny(config)``: the configuration cut to the CPU tests' size;
* ``gpubench/traffic/<traffic>.json``: a traffic mix, whose ``loop`` names
  the loop that drives it (``score``, ``stream`` or ``train``) and whose
  other keys are that loop's parameters;
* ``gpubench/limits/<cell>.json``: the limit of each number the cell's
  correctness check compares, with the readings it was set from;
* ``gpubench/metrics/<metric>.py``: one reader per metric, ``read(run)``
  returning a number or ``None`` when the run holds nothing to read.

A new cell, metric or model family is new files and new entries in
``BENCHMARK.json``; no code here names one.
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
    family: object           # the module of gpubench/families/<family>.py

    @property
    def arch(self) -> dict:
        return self.config["model"]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(path: Path):
    """The ``read`` function of a metric's file."""
    return _load(path, f"{PACKAGE}_metric_{path.stem}").read


def load_family(root, name: str):
    """The module of the family file ``name`` under ``root``."""
    return _load(Path(root) / PACKAGE / "families" / f"{name}.py", f"{PACKAGE}_family_{name}")


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
                limits=limits, metrics=metrics, root=root,
                family=load_family(root, config["family"]))
