"""Config for the PyTorch/CUDA port.

The default tree is the JAX package's (``dmmfods_tpu/config.py``), value for
value, kept here as the port's own copy, with one section added: ``gpu``,
the port's runtime settings. A config saved by the JAX package loads here
and gains the ``gpu`` section. The ``tpu`` section stays as it is; the port
reads nothing from it. A setting that a JAX config makes under ``tpu``
(``dense_block_impl``, ``dense_block_strip``, ``stem_pool_strip``) a port
config makes under ``gpu``, with the same meaning:

* ``compute_dtype``: dtype of activations, convs and the kernels.
* ``dense_block_impl``: per dense block (a comma-separated list, its last
  entry repeated), ``pallas`` runs the block as the whole-block kernel K4
  where K4's gate holds (eval, no dropout, JAX's sample-group rule); the
  XLA lowerings ``concat``, ``buffer`` and ``vjp`` run the plain loop.
* ``dense_block_strip``: which strip kernel runs a batch-1 dense block on a
  big plane, where JAX's strip gate takes it: ``auto`` and ``carry`` run
  K2 (the card is the port's accelerator, as the TPU is JAX's), ``on`` runs
  the halo-recompute kernel K5, ``off`` neither. Other values raise.
* ``stem_pool_strip``: ``on`` runs each encoder's stem + pool0 as the fused
  kernel K6 in eval at batch 1 on the shapes JAX's gate takes (``force``,
  JAX's override of its TPU quarantine, means the same); ``auto`` (as in
  JAX, measured neutral there) and ``off`` run the plain stem. Other values
  raise.
* ``use_fused_kernels`` (JAX's ``tpu.use_fused_kernels``): in eval, the
  mid-fusion concat runs as K1 and the head as K3 (batch 1, big planes) or
  in phase space. Off, both run their plain forms (upsample, concat, BN,
  convs). Train mode runs the plain forms either way (JAX's phase-space
  train head is not ported). The block and stem kernels keep their own
  switches.
* ``fused_head_max_pixels`` (JAX's ``tpu.fused_head_max_pixels``): the
  head runs as above only on output planes of at most this many pixels.

The defaults run K1, the phase-space head (K3 at batch 1 on big planes) and
K2 on the big batch-1 blocks, and neither K4, K5 nor K6. A saved config
lacking a ``gpu`` key gains its default on load.
"""

from __future__ import annotations

import copy
import json
import os
from datetime import datetime
from os.path import isfile, join
from pathlib import Path
from typing import Any, Mapping

GPU_DEFAULTS = {
    # dtype of activations, convs and the kernels; params and BN running
    # stats stay float32. "float32" for parity tests.
    "compute_dtype": "bfloat16",
    # the JAX default of tpu.dense_block_impl: no block selects K4
    "dense_block_impl": "concat,concat,buffer,buffer",
    # the JAX default of tpu.dense_block_strip: the carry kernel K2
    "dense_block_strip": "auto",
    # the JAX default of tpu.stem_pool_strip: K6 off
    "stem_pool_strip": "auto",
    # the JAX defaults of tpu.use_fused_kernels and tpu.fused_head_max_pixels:
    # K1 and the phase-space head (K3 at batch 1 on big planes) on every plane
    "use_fused_kernels": True,
    "fused_head_max_pixels": 1 << 62,
}


class EDict(dict):
    """``dict`` with attribute access; nested dicts are converted
    recursively (the JAX package's ``utils/edict.py::EDict``)."""

    def __init__(self, mapping: Mapping[str, Any] | None = None, **kwargs: Any):
        super().__init__()
        if mapping is not None:
            for key, value in mapping.items():
                self[key] = value
        for key, value in kwargs.items():
            self[key] = value

    @staticmethod
    def _convert(value: Any) -> Any:
        if isinstance(value, EDict):
            return value
        if isinstance(value, Mapping):
            return EDict(value)
        if isinstance(value, (list, tuple)):
            converted = [EDict._convert(v) for v in value]
            return type(value)(converted) if isinstance(value, tuple) else converted
        return value

    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, EDict._convert(value))

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as exc:  # AttributeError expected by hasattr() etc.
            raise AttributeError(key) from exc

    def __delattr__(self, key: str) -> None:
        try:
            del self[key]
        except KeyError as exc:
            raise AttributeError(key) from exc

    def copy(self) -> "EDict":
        return EDict(self)

    def __deepcopy__(self, memo: dict) -> "EDict":
        out = EDict()
        memo[id(self)] = out
        for key, value in self.items():
            dict.__setitem__(out, copy.deepcopy(key, memo), copy.deepcopy(value, memo))
        return out

    def to_dict(self) -> dict:
        """Plain-``dict`` (recursive) view, e.g. for JSON serialization."""

        def plain(value: Any) -> Any:
            if isinstance(value, dict):
                return {k: plain(v) for k, v in value.items()}
            if isinstance(value, (list, tuple)):
                return [plain(v) for v in value]
            return value

        return plain(self)


def load_config(loading_dir, file_name):
    """The json config at ``loading_dir/file_name`` as a dict, else ``None``."""
    json_file = join(loading_dir, file_name)
    if isfile(json_file):
        with open(json_file, "r") as jf:
            return json.load(jf)
    return None


def save_config(config, file_name="config.json"):
    """Save ``config`` as indented json under ``config.dir.configs``."""
    Path(config.dir.configs).mkdir(exist_ok=True, parents=True)
    tree = config.to_dict() if isinstance(config, EDict) else config
    with open(os.path.join(config.dir.configs, file_name), "w") as jf:
        json.dump(tree, jf, indent=4)


def create_config(host_dir=""):
    """The default config tree: the JAX package's ``create_config``, value
    for value, plus the ``gpu`` section."""
    if not host_dir:
        host_dir = os.path.join(os.path.expanduser("~"), "dmmfods_runs")

    config = {"dir": {"hosting": host_dir}}
    config["scripts"] = {
        "model": "dense_unet_lidar.py",
        "utils": "config.py",
        "agent": "dense_unet_agent.py",
        "dataset": "waymo.py",
        "setup": "cli",
    }
    config["model"] = {
        "growth_rate": 32,
        "block_config": (6, 12, 24, 16),
        "num_init_features": 64,
        "stream_1_in_channels": 3,
        "stream_2_in_channels": 1,
        "concat_before_block_num": 2,
        "num_layers_before_blocks": 4,
        "bn_size": 4,
        "drop_rate": 0,
        "num_classes": 3,
        "memory_efficient": False,
    }
    config["loss"] = {
        "type": "bce",
        "alpha": 1,
        "gamma": 2,
        "logits": True,
        "reduce": False,
        "skip_v_every_n_its": False,
        "skip_p_every_n_its": False,
        "skip_b_every_n_its": False,
    }
    config["loader"] = {
        "mode": "train",
        "batch_size": None,
        "pin_memory": True,
        "num_workers": 4,
        "async_loading": True,
        "drop_last": False,
    }
    config["optimizer"] = {
        "type": "Adam",
        "learning_rate": 1e-3,
        "beta1": 0.9,
        "beta2": 0.999,
        "eps": 1e-08,
        "amsgrad": False,
        "weight_decay": 0,
        "lr_scheduler": {"want": False, "every_n_epochs": 30, "gamma": 0.1},
    }
    config["dataset"] = {
        "batch_size": 32,
        "label": {"1": "TYPE_VEHICLE", "2": "TYPE_PEDESTRIAN", "4": "TYPE_CYCLIST"},
        "images": {"original.size": (3, 1920, 1280), "size": (3, 192, 128)},
        "datatypes": ["images", "lidar", "labels", "heat_maps"],
        "file_list_name": "file_list.json",
    }
    config["agent"] = {
        "seed": 123,
        "max_epoch": 100,
        "iou_threshold": 0.7,
        "checkpoint": {
            "epoch": "epoch",
            "train_iteration": "train_iteration",
            "val_iteration": "val_iteration",
            "best_val_iou": "best_val_iou",
            "state_dict": "state_dict",
            "optimizer": "optimizer",
        },
        "best_checkpoint_name": "best_checkpoint",
    }
    # the JAX runtime's section: kept so that a config round-trips between
    # the packages; the port never reads it
    config["tpu"] = {
        "compute_dtype": "bfloat16",
        "param_dtype": "float32",
        "use_fused_kernels": True,
        "dense_block_impl": "concat,concat,buffer,buffer",
        "mesh": {"data": -1, "spatial": 1, "model": 1},
        "shard_channel_threshold": 256,
        "remat": False,
        "prefetch_depth": 2,
        "donate": True,
        "device_preprocess": False,
        "splat": "host",
        "max_points": 32768,
        "splat_threads": 2,
        "native_prefetch": True,
    }
    config["gpu"] = dict(GPU_DEFAULTS)

    # the run directories, rooted at host_dir where the JAX package roots them
    config["dir"]["root"] = join(config["dir"]["hosting"], "DMMFODS", "dmmfods_tpu")
    for subdir in ["agents", "graphs", "utils", "datasets", "configs", "experiments"]:
        config["dir"][subdir] = join(config["dir"]["root"], subdir)
    config["dir"]["graphs"] = {"models": join(config["dir"]["graphs"], "models")}
    config["dir"]["data"] = {
        "root": join(config["dir"]["hosting"], "data"),
        "file_lists": join(config["dir"]["root"], "data"),
    }
    current_run = datetime.now().strftime("%Y-%m-%d-%H-%M")
    config["dir"]["current_run"] = {
        "summary": join(config["dir"]["experiments"], current_run, "summary"),
        "checkpoints": join(config["dir"]["experiments"], current_run, "checkpoints"),
    }
    return config


def get_config(host_dir="", file_name="config.json"):
    """Load the saved config, or create the default; either way with a
    ``gpu`` section holding every key of ``GPU_DEFAULTS`` (a config saved by
    the JAX package has no section, an older port config lacks later keys)."""
    config = load_config(join(host_dir, "DMMFODS", "dmmfods_tpu", "configs"), file_name)
    if config is None:
        config = create_config(host_dir)
    config = EDict(config)
    config.gpu = {**GPU_DEFAULTS, **config.get("gpu", {})}
    return config


def set_current_run(config, current_run):
    """Point the run directories at a named run."""
    exp = config.dir.experiments
    config.dir.current_run.summary = join(exp, current_run, "summary")
    config.dir.current_run.checkpoints = join(exp, current_run, "checkpoints")
    return config
