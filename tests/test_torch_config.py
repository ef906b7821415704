"""The port's own config (``dmmfods_tpu_torch/config.py``) against the JAX
package's, and the port's constructors' default device.

The port keeps its own copy of the JAX default tree and of its attribute
dict; these tests hold the copy to the original: the same tree value for
value (``dir.current_run`` is a timestamp, set equal), a config saved by the
JAX package loads in the port and gains the ``gpu`` section, a port config
round-trips through its file and the JAX package reads it back. The
constructors build on the card unless told otherwise, and without one they
raise rather than build on the CPU."""

import copy
import json

import pytest
import torch

from dmmfods_tpu import config as jax_config
from dmmfods_tpu.utils.edict import EDict as JaxEDict
from dmmfods_tpu_torch import config
from dmmfods_tpu_torch.models import dense_unet_lidar as pm


def _plain(tree):
    """A tree as its json file holds it (tuples become lists)."""
    return json.loads(json.dumps(tree))


def test_default_tree_is_the_jax_tree_plus_gpu(tmp_path):
    want = jax_config.create_config(str(tmp_path))
    got = config.create_config(str(tmp_path))
    assert got.pop("gpu") == config.GPU_DEFAULTS
    got["dir"]["current_run"] = want["dir"]["current_run"]
    assert got == want
    assert _plain(got) == _plain(want)


def test_default_host_dir_is_the_jax_one(monkeypatch, tmp_path):
    monkeypatch.setenv("HOME", str(tmp_path))
    want = jax_config.create_config()
    got = config.create_config()
    assert got["dir"]["hosting"] == want["dir"]["hosting"] == str(tmp_path / "dmmfods_runs")


def test_get_config_without_a_file_is_the_default(tmp_path):
    got = config.get_config(str(tmp_path))
    want = jax_config.get_config(str(tmp_path))
    assert isinstance(got, config.EDict)
    assert got.gpu == config.GPU_DEFAULTS
    assert got.gpu.dense_block_strip == "auto"
    del got["gpu"]
    got.dir.current_run = want.dir.current_run
    assert got == want


def test_jax_saved_config_loads_and_gains_gpu(tmp_path):
    saved = jax_config.get_config(str(tmp_path))
    saved.model.growth_rate = 8
    saved.tpu.dense_block_strip = "on"           # the JAX key: kept, never read
    jax_config.save_config(saved)
    got = config.get_config(str(tmp_path))
    assert got.gpu == config.GPU_DEFAULTS
    assert got.tpu == _plain(saved.tpu)
    del got["gpu"]
    assert got.to_dict() == _plain(saved.to_dict())
    spec = pm.ModelSpec.from_config(config.get_config(str(tmp_path)))
    assert spec.dense_block_strip == "auto"


def test_port_config_round_trips(tmp_path):
    cfg = config.get_config(str(tmp_path))
    cfg.gpu.dense_block_strip = "on"
    cfg.gpu.compute_dtype = "float32"
    cfg.model.concat_before_block_num = 3
    config.save_config(cfg)
    back = config.get_config(str(tmp_path))
    assert back.to_dict() == _plain(cfg.to_dict())
    assert back.gpu.dense_block_strip == "on"
    spec = pm.ModelSpec.from_config(back)
    assert (spec.dense_block_strip, spec.dtype, spec.concat_before_block_num) == \
        ("on", torch.float32, 3)
    # the JAX package reads the port's file too, gpu section and all
    assert jax_config.get_config(str(tmp_path)).to_dict() == back.to_dict()


def test_fused_kernel_keys_default_load_and_round_trip(tmp_path):
    """``gpu.use_fused_kernels`` and ``gpu.fused_head_max_pixels`` default to
    JAX's ``tpu`` values, a saved port config without them gains them on
    load, and set values survive a save and load into ``ModelSpec``."""
    cfg = config.get_config(str(tmp_path))
    jax_tpu = jax_config.create_config(str(tmp_path))["tpu"]
    assert cfg.gpu.use_fused_kernels is jax_tpu["use_fused_kernels"] is True
    assert cfg.gpu.fused_head_max_pixels == 1 << 62
    spec = pm.ModelSpec.from_config(cfg)
    assert spec.use_fused_kernels is True and spec.fused_head_max_pixels == 1 << 62
    del cfg.gpu["use_fused_kernels"], cfg.gpu["fused_head_max_pixels"]
    cfg.gpu.dense_block_strip = "on"
    config.save_config(cfg)
    older = config.get_config(str(tmp_path))
    assert older.gpu == {**config.GPU_DEFAULTS, "dense_block_strip": "on"}
    older.gpu.use_fused_kernels = False
    older.gpu.fused_head_max_pixels = 98304
    config.save_config(older)
    back = config.get_config(str(tmp_path))
    assert back.to_dict() == _plain(older.to_dict())
    spec = pm.ModelSpec.from_config(back)
    assert (spec.use_fused_kernels, spec.fused_head_max_pixels, spec.dense_block_strip) == \
        (False, 98304, "on")
    model = pm.DenseUNetLidar(pm.ModelSpec(growth_rate=8, block_config=(2, 2, 2, 2),
                                           num_init_features=16, use_fused_kernels=False,
                                           fused_head_max_pixels=98304))
    assert not model.concat_module.use_fused
    head = model.dec_out_to_heat_maps
    assert not head.use_fused and head.fused_max_pixels == 98304


def test_save_config_writes_the_tree(tmp_path):
    tree = config.create_config(str(tmp_path))
    config.save_config(config.EDict(tree))
    with open(tmp_path / "DMMFODS" / "dmmfods_tpu" / "configs" / "config.json") as f:
        assert json.load(f) == _plain(tree)


def test_set_current_run_matches_jax(tmp_path):
    got = config.set_current_run(config.get_config(str(tmp_path)), "run-1")
    want = jax_config.set_current_run(jax_config.get_config(str(tmp_path)), "run-1")
    assert got.dir.current_run == want.dir.current_run
    assert got.dir.current_run.summary.endswith("experiments/run-1/summary")


def test_edict_behaves_as_the_jax_one():
    tree = {"a": {"b": [1, {"c": 2}], "t": (3, {"d": 4})}, "e": 5}
    got, want = config.EDict(tree), JaxEDict(tree)
    assert got == want and got.to_dict() == want.to_dict()
    assert got.a.b[1].c == 2 and got.a.t[1].d == 4 and isinstance(got.a.t, tuple)
    got.f = {"g": 6}
    assert isinstance(got.f, config.EDict) and got.f.g == 6
    del got.f
    assert not hasattr(got, "f")
    with pytest.raises(AttributeError):
        del got.f
    deep = copy.deepcopy(got)
    deep.a.b[1].c = 7
    assert got.a.b[1].c == 2 and isinstance(deep, config.EDict)
    assert isinstance(got.copy(), config.EDict) and got.copy() == got


@pytest.mark.parametrize("constructor", [
    pm.densenet121_u_lidar, pm.densenet161_u_lidar, pm.densenet169_u_lidar,
    pm.densenet201_u_lidar])
def test_constructors_build_on_the_card_by_default(monkeypatch, tmp_path, constructor):
    """Without ``device`` a constructor builds on the card; with no CUDA
    device it raises instead of building a CPU model."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        constructor(config=config.get_config(str(tmp_path)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        constructor(config=config.get_config(str(tmp_path)), device="cuda:0")
