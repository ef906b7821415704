"""dmmfods_tpu_torch: the PyTorch/CUDA port of dmmfods_tpu for NVIDIA Hopper.

The JAX package ``dmmfods_tpu`` is the reference this port is held against.
The port keeps its file names (``config.py``, ``ops/fused.py``,
``models/dense_unet_lidar.py``, ``serving.py``), its NHWC public layout and
the reference's torch module names, and imports no JAX. Its hand-written
CUDA kernels live under ``csrc/`` and are built at first use.
"""

from .config import get_config

__all__ = ["get_config"]
