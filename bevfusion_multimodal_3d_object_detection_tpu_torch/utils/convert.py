"""Carry a JAX model's variables into the port's modules.

`load_jax_variables(model, variables)` takes the JAX detector's
``{"params", "batch_stats"}`` tree as numpy arrays (folded or unfolded
camera, matching the model's ``fold_bn``) and loads it into the port's
modules, whose names follow the flax tree:

- Conv kernel HWIO -> Conv2d weight OIHW;
- Dense kernel (in, out) -> Linear weight (out, in);
- BatchNorm scale / bias / mean / var -> weight / bias / running_mean /
  running_var.

It is strict: a key of the tree with no place in the model, or a parameter
or buffer of the model the tree leaves unset, raises.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

_BN_PARAMS = {"scale": "weight", "bias": "bias"}
_BN_STATS = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree: Dict, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for name, sub in tree.items():
        if isinstance(sub, dict):
            yield from _leaves(sub, prefix + (name,))
        else:
            yield prefix + (name,), sub


def _target(model: nn.Module, path: Tuple[str, ...], collection: str):
    """(state_dict key, numpy -> torch layout function) for one leaf."""
    mod_path, leaf = ".".join(path[:-1]), path[-1]
    try:
        module = model.get_submodule(mod_path)
    except AttributeError:
        raise KeyError(f"{collection}/{'/'.join(path)}: no module {mod_path!r} in the model") from None
    if isinstance(module, nn.modules.batchnorm._BatchNorm):
        table = _BN_PARAMS if collection == "params" else _BN_STATS
        if leaf in table:
            return f"{mod_path}.{table[leaf]}", lambda a: a
    elif collection == "params" and isinstance(module, nn.Conv2d):
        if leaf == "kernel":
            return f"{mod_path}.weight", lambda a: a.transpose(3, 2, 0, 1)
        if leaf == "bias":
            return f"{mod_path}.bias", lambda a: a
    elif collection == "params" and isinstance(module, nn.Linear):
        if leaf == "kernel":
            return f"{mod_path}.weight", lambda a: a.T
        if leaf == "bias":
            return f"{mod_path}.bias", lambda a: a
    raise KeyError(
        f"{collection}/{'/'.join(path)}: no counterpart in {type(module).__name__} {mod_path!r}"
    )


def load_jax_variables(model: nn.Module, variables: Dict) -> nn.Module:
    """Load a JAX-layout variables tree into `model` (in place); returns it."""
    state = model.state_dict()
    new: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, value in _leaves(variables.get(collection, {})):
            key, to_torch = _target(model, path, collection)
            value = np.asarray(value)  # f64 stays f64 until the model's dtype
            value = value if value.dtype == np.float64 else value.astype(np.float32)
            arr = np.array(to_torch(value), order="C")
            if tuple(arr.shape) != tuple(state[key].shape):
                raise ValueError(
                    f"{collection}/{'/'.join(path)} -> {key}: shape "
                    f"{arr.shape} != {tuple(state[key].shape)}"
                )
            new[key] = torch.from_numpy(arr).to(state[key].dtype)
    missing = sorted(
        k for k in state if k not in new and not k.endswith("num_batches_tracked")
    )
    if missing:
        raise KeyError(f"variables leave model keys unset: {missing}")
    for k, v in state.items():
        new.setdefault(k, v)
    model.load_state_dict(new, strict=True)
    return model
