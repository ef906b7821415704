"""The port imports no JAX and nothing of the JAX package. Checked in a
fresh interpreter, since this test process has both loaded already
(``conftest.py``): import every module of ``dmmfods_tpu_torch`` and
``chip_smoke``, build a config, run a tiny forward, train step and eval step
on the CPU, make a raw-record batch (the host splat) and take a host-splat
raw-record step on it, and look at ``sys.modules``."""

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
from dmmfods_tpu_torch.config import EDict, create_config
from dmmfods_tpu_torch.models.dense_unet_lidar import DenseUNetLidar, ModelSpec
assert ModelSpec.from_config(EDict(create_config("host"))).dense_block_strip == "auto"
for opt_in in ({}, {"dense_block_impl": "pallas", "stem_pool_strip": "on",
                    "dense_block_strip": "on"}):
    spec = ModelSpec(growth_rate=8, block_config=(1, 1), num_init_features=8, **opt_in)
    with torch.no_grad():
        out = DenseUNetLidar(spec).eval()(torch.rand(1, 64, 64, 3), torch.rand(1, 64, 64, 1))
    assert out.shape == (1, 64, 64, 3), out.shape
from dmmfods_tpu_torch import trainer
cfg = EDict(create_config("host"))
module = DenseUNetLidar(ModelSpec(growth_rate=8, block_config=(1, 1), num_init_features=8))
optimizer = trainer.make_optimizer(cfg, module.parameters())
state = trainer.TrainState(module, optimizer)
batch = (torch.rand(2, 64, 64, 3), torch.rand(2, 64, 64, 1), torch.rand(2, 64, 64, 3))
state, metrics = trainer.make_train_step(module, optimizer, cfg)(state, *batch)
assert torch.isfinite(metrics["loss"])
assert sorted(trainer.make_eval_step(module, cfg)(state, *batch)) == sorted(
    list(metrics) + ["ap_per_class", "ap_bin_counts"])
from dmmfods_tpu_torch.data.synthetic import make_raw_batch
image, lidar, boxes = (torch.from_numpy(x) for x in make_raw_batch(2, 32, 48, splat="host"))
assert image.shape == (2, 32, 48, 3) and lidar.shape == (2, 32, 48, 1), lidar.shape
state, metrics = trainer.make_train_step_ht(module, optimizer, cfg, full_height=320,
                                            full_width=480)(state, image, lidar, boxes)
assert torch.isfinite(metrics["loss"])
assert "jax" not in sys.modules and "flax" not in sys.modules, sorted(
    m for m in sys.modules if m.split(".")[0] in ("jax", "flax"))
assert not [m for m in sys.modules if m.split(".")[0] == "dmmfods_tpu"], sorted(
    m for m in sys.modules if m.split(".")[0] == "dmmfods_tpu")
print(" ".join(sorted(names)))
"""


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", _PROGRAM], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    imported = set(proc.stdout.split())
    for name in ("config", "ops.fused", "ops._build", "ops.dense_block",
                 "ops.dense_block_strip", "ops.phase_head", "ops.stem_pool",
                 "models.dense_unet_lidar", "models.weights", "serving", "losses",
                 "metrics", "optim", "trainer", "ops.preprocess", "data.native_io",
                 "data.host_preprocess", "data.synthetic"):
        assert "dmmfods_tpu_torch." + name in imported, proc.stdout
