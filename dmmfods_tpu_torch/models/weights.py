"""JAX training state -> the port's ``state_dict`` and optimizer state.

:func:`state_dict_from_jax` is the inverse of
``dmmfods_tpu/models/torch_port.py::load_full_torch_model``: it takes the
JAX model's ``{"params", "batch_stats"}`` trees as nested dicts of numpy
arrays and returns a ``state_dict`` that
:class:`~dmmfods_tpu_torch.models.dense_unet_lidar.DenseUNetLidar` loads
with ``strict=True``.

* conv kernels HWIO -> OIHW;
* transposed-conv kernels, which JAX keeps spatially flipped in HWIO,
  -> unflipped IOHW;
* BN ``scale``/``bias`` -> ``weight``/``bias``, ``mean``/``var`` ->
  ``running_mean``/``running_var``, and ``num_batches_tracked`` = 0.

:func:`optimizer_state_from_jax` carries the optax state of the JAX
trainer's ``make_optimizer`` into :class:`~dmmfods_tpu_torch.optim.Adam`:
its moments are trees shaped like ``params`` and take the same mapping.
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


def _torch_leaves(tree: Mapping, collection: str):
    """``(JAX leaf name, torch key, f32 tensor)`` of each leaf of a JAX
    ``collection`` tree (or a tree shaped like it), in the port's layout."""
    names = _LEAF_NAMES[collection]
    for path, value in _leaves(tree):
        module_path = _module_path(path[:-1])
        arr = _convert(module_path, path[-1], np.array(value, np.float32))
        yield (path[-1], ".".join(module_path + (names[path[-1]],)),
               torch.from_numpy(np.ascontiguousarray(arr)))


def state_dict_from_jax(variables: Mapping, spec: ModelSpec) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for ``spec`` from JAX ``variables``.

    Raises ``KeyError`` if the keys differ from those of
    ``DenseUNetLidar(spec)``, and ``ValueError`` on a shape mismatch."""
    out: Dict[str, torch.Tensor] = {}
    for collection in _LEAF_NAMES:
        for leaf, key, tensor in _torch_leaves(variables.get(collection, {}), collection):
            out[key] = tensor
            if leaf == "scale":
                out[key[:-len("weight")] + "num_batches_tracked"] = (
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


def _find_state(state, field: str):
    """The first optax state in ``state`` (a chain's tuple of states, or one
    state) that has ``field``, else None."""
    if hasattr(state, field):
        return state
    if isinstance(state, (tuple, list)):
        for inner in state:
            found = _find_state(inner, field)
            if found is not None:
                return found
    return None


def optimizer_state_from_jax(opt_state, module: torch.nn.Module, config) -> dict:
    """The ``state_dict`` of the port's ``make_optimizer(config,
    module.parameters())`` from the optax state of the JAX trainer's
    ``make_optimizer(config)``: ``inject_hyperparams`` of Adam or AMSGrad,
    behind ``add_decayed_weights`` when ``config.optimizer.weight_decay`` is
    set. The injected learning rate (which StepLR may have changed) becomes
    the group's ``lr``; the count each parameter's ``step``; ``mu``, ``nu``
    and AMSGrad's ``nu_max`` each parameter's moments, in its layout.

    Raises ``ValueError`` if the state is not of that optimizer, and
    ``KeyError`` if its trees do not fit ``module``'s parameters."""
    opt = config.optimizer
    amsgrad = bool(opt.get("amsgrad", False))
    inject = _find_state(opt_state, "hyperparams")
    moments = None if inject is None else _find_state(inject.inner_state, "mu")
    if moments is None or hasattr(moments, "nu_max") != amsgrad:
        raise ValueError(f"not the optax state of make_optimizer with amsgrad={amsgrad}: "
                         f"{type(opt_state).__name__}")
    names = [name for name, _ in module.named_parameters()]
    fields = ("mu", "nu", "nu_max") if amsgrad else ("mu", "nu")
    trees = {field: {key: tensor for _, key, tensor in
                     _torch_leaves(getattr(moments, field), "params")}
             for field in fields}
    for field, tree in trees.items():
        if set(tree) != set(names):
            raise KeyError(f"optax {field} does not fit the module's parameters: missing "
                           f"{sorted(set(names) - set(tree))[:10]}, unexpected "
                           f"{sorted(set(tree) - set(names))[:10]}")
    step = int(np.asarray(moments.count))
    state = {i: {"step": step, **{field: trees[field][name] for field in fields}}
             for i, name in enumerate(names)}
    group = dict(lr=float(np.asarray(inject.hyperparams["learning_rate"])),
                 betas=(opt.beta1, opt.beta2), eps=opt.eps,
                 weight_decay=opt.get("weight_decay", 0) or 0.0, amsgrad=amsgrad,
                 params=list(range(len(names))))
    return {"state": state, "param_groups": [group]}
