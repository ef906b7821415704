"""The port imports no JAX. Checked in a fresh interpreter, since this test
process has JAX loaded already (``conftest.py``): import every module of
``dmmfods_tpu_torch`` and ``chip_smoke``, run a tiny forward on the CPU, and
look at ``sys.modules``."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_PROGRAM = """
import importlib, pkgutil, sys
import torch
import dmmfods_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dmmfods_tpu_torch.__path__,
                                                "dmmfods_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from dmmfods_tpu_torch.models.dense_unet_lidar import DenseUNetLidar, ModelSpec
spec = ModelSpec(growth_rate=4, block_config=(1, 1), num_init_features=8)
with torch.no_grad():
    out = DenseUNetLidar(spec).eval()(torch.rand(1, 32, 32, 3), torch.rand(1, 32, 32, 1))
assert out.shape == (1, 32, 32, 3), out.shape
assert "jax" not in sys.modules and "flax" not in sys.modules, sorted(
    m for m in sys.modules if m.split(".")[0] in ("jax", "flax"))
print(" ".join(sorted(names)))
"""


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", _PROGRAM], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    imported = set(proc.stdout.split())
    for name in ("config", "ops.fused", "ops._build", "models.dense_unet_lidar",
                 "models.weights", "serving"):
        assert "dmmfods_tpu_torch." + name in imported, proc.stdout
