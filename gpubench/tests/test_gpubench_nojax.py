"""Nothing the benchmark runs loads JAX or the JAX package, in any cell of
``BENCHMARK.json``, and the plain reference of every configuration's model
family (with its weights, answers and counts) loads nothing of the program
either: checked in fresh interpreters, by whole top-level module names."""

from __future__ import annotations

import json
import subprocess
import sys

from _bench import ROOT

SETUP_ON_CPU = """
import json, sys, tempfile, time
from pathlib import Path
sys.path[:0] = [{root!r}, {tests!r}]
from _bench import CELLS, copy_benchmark, shrink
root = copy_benchmark(Path(tempfile.mkdtemp()))
shrink(root)
import gpubench.run, gpubench.calibrate
from gpubench import spec
from gpubench.loops import LOOPS
for name in CELLS:
    cell = spec.load_cell(root, name)
    loop = LOOPS[cell.traffic["loop"]](cell, 1, "cpu")
    loop.setup(0.5)
    loop.window(0.5, False)      # also stops a stream cell's worker thread
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""

REFERENCE_ONLY = """
import json, sys
sys.path[:0] = [{root!r}, {tests!r}]
import gpubench.reference, gpubench.flops, gpubench.trace, gpubench.check, gpubench.inputs
from _bench import configs, family, tiny_config
for config in configs().values():
    fam, arch = family(config), tiny_config(config)["model"]
    net = fam.reference(arch).eval()
    net.load_state_dict(fam.make_state_dict(arch, 1, "cpu"))
    rgb, lidar = gpubench.inputs.make_frames(1, 1, 64, 96, "cpu")
    fam.reference_answers(net, rgb.numpy(), lidar.numpy(), 1)
    fam.param_count(arch), fam.flops_per_frame(arch, 64, 96)
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def _top_level_modules(code):
    proc = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT),
                                                             tests=str(ROOT / "gpubench/tests"))],
                          capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_a_cells_setup_loads_no_jax():
    loaded = _top_level_modules(SETUP_ON_CPU)
    assert "dmmfods_tpu_torch" in loaded and "gpubench" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "dmmfods_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    loaded = _top_level_modules(REFERENCE_ONLY)
    assert not loaded & {"jax", "jaxlib", "flax", "dmmfods_tpu", "dmmfods_tpu_torch"}
