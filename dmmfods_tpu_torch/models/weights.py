"""JAX variables -> the port's ``state_dict``.

The inverse of ``dmmfods_tpu/models/torch_port.py::load_full_torch_model``:
it takes the JAX model's ``{"params", "batch_stats"}`` trees as nested dicts
of numpy arrays and returns a ``state_dict`` that
:class:`~dmmfods_tpu_torch.models.dense_unet_lidar.DenseUNetLidar` loads
with ``strict=True``.

* conv kernels HWIO -> OIHW;
* transposed-conv kernels, which JAX keeps spatially flipped in HWIO,
  -> unflipped IOHW;
* BN ``scale``/``bias`` -> ``weight``/``bias``, ``mean``/``var`` ->
  ``running_mean``/``running_var``, and ``num_batches_tracked`` = 0.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from .dense_unet_lidar import DenseUNetLidar, ModelSpec

_LEAF_NAMES = {
    "params": {"kernel": "weight", "scale": "weight", "bias": "bias"},
    "batch_stats": {"mean": "running_mean", "var": "running_var"},
}


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _module_path(path: Tuple[str, ...]) -> Tuple[str, ...]:
    """A JAX module path (without the leaf name) -> the torch module path."""
    top, rest = path[0], path[1:]
    if top == "features_stem":                      # conv0 / norm0
        return ("features",) + rest
    if top.startswith("features_"):                 # denseblockN / transitionN
        return ("features", top[len("features_"):]) + rest
    if top == "stream_2_features":
        return (top,) + (rest[1:] if rest[:1] == ("stem",) else rest)
    m = re.fullmatch(r"up(\d+)", top)
    if m:
        if rest == ("transp_conv",):
            return ("decoder", f"Transposed_Convolution_{m.group(1)}")
        return ("decoder", f"Transposed_Convolution_Sequence_{m.group(1)}") + rest
    if top in ("concat_module", "dec_out_to_heat_maps"):
        return path
    raise KeyError(f"no port module for JAX path {'/'.join(path)}")


def _convert(module_path, leaf, value: np.ndarray) -> np.ndarray:
    if leaf != "kernel":
        return value
    if module_path[-1].startswith("Transposed_Convolution_"):
        return np.transpose(np.flip(value, (0, 1)), (2, 3, 0, 1))
    return np.transpose(value, (3, 2, 0, 1))


def state_dict_from_jax(variables: Mapping, spec: ModelSpec) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for ``spec`` from JAX ``variables``.

    Raises ``KeyError`` if the keys differ from those of
    ``DenseUNetLidar(spec)``, and ``ValueError`` on a shape mismatch."""
    out: Dict[str, torch.Tensor] = {}
    for collection, names in _LEAF_NAMES.items():
        for path, value in _leaves(variables.get(collection, {})):
            module_path = _module_path(path[:-1])
            arr = _convert(module_path, path[-1], np.array(value, np.float32))
            key = ".".join(module_path + (names[path[-1]],))
            out[key] = torch.from_numpy(np.ascontiguousarray(arr))
            if path[-1] == "scale":
                out[".".join(module_path + ("num_batches_tracked",))] = (
                    torch.tensor(0, dtype=torch.long))

    with torch.device("meta"):
        expected = DenseUNetLidar(spec).state_dict()
    missing = sorted(set(expected) - set(out))
    unexpected = sorted(set(out) - set(expected))
    if missing or unexpected:
        raise KeyError(f"JAX variables do not fit the port's model: missing "
                       f"{missing[:10]}, unexpected {unexpected[:10]}")
    for key, tensor in out.items():
        if tensor.shape != expected[key].shape:
            raise ValueError(f"shape mismatch at {key}: JAX gives "
                             f"{tuple(tensor.shape)}, the port wants "
                             f"{tuple(expected[key].shape)}")
    return out
