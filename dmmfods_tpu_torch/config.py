"""Config for the PyTorch/CUDA port.

The default tree is the JAX package's (``dmmfods_tpu/config.py``), value for
value, with one section added: ``gpu``, the port's runtime settings. The
``tpu`` section stays as it is; the port reads nothing from it.
"""

from __future__ import annotations

from dmmfods_tpu import config as _reference

GPU_DEFAULTS = {
    # dtype of activations, convs and the kernels; params and BN running
    # stats stay float32. "float32" for parity tests.
    "compute_dtype": "bfloat16",
}


def get_config(host_dir="", file_name="config.json"):
    """Load the saved config, or create the default; either way with a
    ``gpu`` section (a config saved by the JAX package has none)."""
    config = _reference.get_config(host_dir, file_name)
    if "gpu" not in config:
        config.gpu = dict(GPU_DEFAULTS)
    return config
