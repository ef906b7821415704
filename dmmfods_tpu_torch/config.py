"""Config for the PyTorch/CUDA port.

The default tree is the JAX package's (``dmmfods_tpu/config.py``), value for
value, with one section added: ``gpu``, the port's runtime settings. The
``tpu`` section stays as it is; the port reads nothing from it. A setting
that a JAX config makes under ``tpu`` (``dense_block_impl``,
``stem_pool_strip``) a port config makes under ``gpu``, with the same
meaning:

* ``compute_dtype``: dtype of activations, convs and the kernels.
* ``dense_block_impl``: per dense block (a comma-separated list, its last
  entry repeated), ``pallas`` runs the block as the whole-block kernel K4
  where K4's gate holds (eval, no dropout, JAX's sample-group rule); the
  XLA lowerings ``concat``, ``buffer`` and ``vjp`` run the plain loop.
* ``stem_pool_strip``: ``on`` runs each encoder's stem + pool0 as the fused
  kernel K6 in eval at batch 1 on the shapes JAX's gate takes (``force``,
  JAX's override of its TPU quarantine, means the same); ``auto`` (as in
  JAX, measured neutral there) and ``off`` run the plain stem. Other values
  raise.

The defaults run neither K4 nor K6.
"""

from __future__ import annotations

from dmmfods_tpu import config as _reference

GPU_DEFAULTS = {
    # dtype of activations, convs and the kernels; params and BN running
    # stats stay float32. "float32" for parity tests.
    "compute_dtype": "bfloat16",
    # the JAX default of tpu.dense_block_impl: no block selects K4
    "dense_block_impl": "concat,concat,buffer,buffer",
    # the JAX default of tpu.stem_pool_strip: K6 off
    "stem_pool_strip": "auto",
}


def get_config(host_dir="", file_name="config.json"):
    """Load the saved config, or create the default; either way with a
    ``gpu`` section (a config saved by the JAX package has none)."""
    config = _reference.get_config(host_dir, file_name)
    if "gpu" not in config:
        config.gpu = dict(GPU_DEFAULTS)
    return config
