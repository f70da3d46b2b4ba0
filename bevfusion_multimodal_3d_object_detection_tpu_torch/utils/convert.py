"""Carry variables and optimizer state between a JAX model and the port.

The port's modules are named after the flax tree, and one table per module
type gives each torch parameter or buffer its flax leaf and layout:

- Conv kernel HWIO <-> Conv2d weight OIHW, DHWIO <-> Conv3d weight OIDHW;
- Dense kernel (in, out) <-> Linear weight (out, in);
- BatchNorm scale / bias (``params``) and mean / var (``batch_stats``) <->
  weight / bias / running_mean / running_var;
- LayerNorm scale / bias <-> weight / bias;
- a parameter a module holds itself (the attention fusion's positional
  embeddings) <-> the ``params`` leaf of the same name, as it is.

`load_jax_variables(model, variables)` loads the JAX detector's
``{"params", "batch_stats"}`` tree (numpy, folded or unfolded camera to match
the model's ``fold_bn``) into the model, and `export_jax_variables(model)` is
its inverse; the two round-trip bit for bit. Both are strict: a leaf with no
place on the other side raises.

`opt_state_to_jax` / `opt_state_from_jax` map the port's
`train.loop.Optimizer` to the state of the JAX package's ``make_optimizer``
tx (``train/loop.py:46-88``) in flax's ``to_state_dict`` form, for the
optimizer's own configuration:

- ``chain(clip_by_global_norm, adamw)``: ``{"0": {}, "1": adamw}``; without
  the clip, ``adamw`` alone;
- ``adamw`` = ``chain(scale_by_adam, add_decayed_weights,
  scale_by_learning_rate)``: ``{"0": {"count", "mu", "nu"}, "1": {},
  "2": {"count"} under a schedule, else {}}``. ``mu`` / ``nu`` are AdamW's
  ``exp_avg`` / ``exp_avg_sq`` in the parameters' JAX layout; ``count``
  (int32) is the number of updates, torch's per-parameter ``step``;
- ``MultiSteps`` (gradient accumulation): ``{"mini_step", "gradient_step",
  "inner_opt_state", "acc_grads", "skip_state": {}}``.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn


def _same(a: np.ndarray) -> np.ndarray:
    return a


# torch leaf -> (collection, flax leaf, torch -> JAX layout, JAX -> torch layout)
_Layout = Dict[str, Tuple[str, str, Callable, Callable]]
_BN: _Layout = {
    "weight": ("params", "scale", _same, _same),
    "bias": ("params", "bias", _same, _same),
    "running_mean": ("batch_stats", "mean", _same, _same),
    "running_var": ("batch_stats", "var", _same, _same),
}
_CONV: _Layout = {
    "weight": ("params", "kernel", lambda a: a.transpose(2, 3, 1, 0), lambda a: a.transpose(3, 2, 0, 1)),
    "bias": ("params", "bias", _same, _same),
}
_CONV3D: _Layout = {
    "weight": ("params", "kernel", lambda a: a.transpose(2, 3, 4, 1, 0),
               lambda a: a.transpose(4, 3, 0, 1, 2)),
    "bias": ("params", "bias", _same, _same),
}
_DENSE: _Layout = {
    "weight": ("params", "kernel", lambda a: a.T, lambda a: a.T),
    "bias": ("params", "bias", _same, _same),
}
_LAYER_NORM: _Layout = {
    "weight": ("params", "scale", _same, _same),
    "bias": ("params", "bias", _same, _same),
}


def _layout(module: nn.Module) -> _Layout:
    if isinstance(module, nn.modules.batchnorm._BatchNorm):
        return _BN
    if isinstance(module, nn.Conv2d):
        return _CONV
    if isinstance(module, nn.Conv3d):
        return _CONV3D
    if isinstance(module, nn.Linear):
        return _DENSE
    if isinstance(module, nn.LayerNorm):
        return _LAYER_NORM
    # parameters a module holds itself keep their name and layout
    return {name: ("params", name, _same, _same) for name in module._parameters}


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
    for torch_leaf, (coll, flax_leaf, _, to_torch) in _layout(module).items():
        if coll == collection and flax_leaf == leaf:
            return f"{mod_path}.{torch_leaf}" if mod_path else torch_leaf, to_torch
    raise KeyError(
        f"{collection}/{'/'.join(path)}: no counterpart in {type(module).__name__} {mod_path!r}"
    )


def _source(model: nn.Module, key: str):
    """(collection, flax path, torch -> JAX layout function) of one
    state_dict key."""
    mod_path, leaf = _split(key)
    entry = _layout(model.get_submodule(mod_path)).get(leaf)
    if entry is None:
        raise KeyError(f"{key}: no counterpart in the JAX tree")
    collection, flax_leaf, to_jax, _ = entry
    return collection, _path(mod_path) + (flax_leaf,), to_jax


def _split(key: str) -> Tuple[str, str]:
    """A state_dict key -> (module path, leaf); the root module's path is ''."""
    mod_path, _, leaf = key.rpartition(".")
    return mod_path, leaf


def _path(mod_path: str) -> Tuple[str, ...]:
    return tuple(mod_path.split(".")) if mod_path else ()


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A copy of a tensor as numpy on the host (never a view of a CPU
    parameter, which later steps would change); f64 stays f64, anything
    else is f32."""
    dtype = torch.float64 if t.dtype == torch.float64 else torch.float32
    return t.detach().to("cpu", dtype, copy=True).numpy()


def _host(t: torch.Tensor, to_jax: Callable, empty: bool) -> np.ndarray:
    """A tensor in JAX layout on the host: a copy of its values or, with
    `empty`, an uninitialised array of that shape and dtype (no data moves)."""
    if empty:
        dtype = np.float64 if t.dtype == torch.float64 else np.float32
        return np.empty(to_jax(np.broadcast_to(np.zeros((), dtype), tuple(t.shape))).shape, dtype)
    return np.ascontiguousarray(to_jax(_numpy(t)))


def _put(tree: Dict, path: Tuple[str, ...], value) -> None:
    for part in path[:-1]:
        tree = tree.setdefault(part, {})
    tree[path[-1]] = value


def _get(tree: Dict, path: Tuple[str, ...]):
    for part in path:
        tree = tree[part]
    return tree


def load_jax_variables(model: nn.Module, variables: Dict) -> nn.Module:
    """Load a JAX-layout variables tree into `model` (in place); returns it."""
    state = model.state_dict()
    new: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, value in _leaves(variables.get(collection, {})):
            key, to_torch = _target(model, path, collection)
            value = np.asarray(value)  # f64 stays f64 until the model's dtype
            value = value if value.dtype == np.float64 else value.astype(np.float32, copy=False)
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


def export_jax_variables(model: nn.Module, empty: bool = False,
                         state: Optional[Dict[str, torch.Tensor]] = None) -> Dict:
    """The model's ``{"params", "batch_stats"}`` tree in JAX layout, numpy
    (f32, or f64 for a float64 model) on the host. With `empty` the leaves
    are uninitialised arrays of the same shapes and dtypes: a restore's
    template. `state`, a copy of the model's state_dict (a checkpoint's
    host snapshot), is read in place of the model's own."""
    out: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for key, value in (model.state_dict() if state is None else state).items():
        if key.endswith("num_batches_tracked"):
            continue
        collection, path, to_jax = _source(model, key)
        _put(out[collection], path, _host(value, to_jax, empty))
    return out


def _param_paths(optimizer, model: nn.Module) -> List[Tuple[Tuple[str, ...], Callable, Callable]]:
    """(flax path in ``params``, torch -> JAX, JAX -> torch) of each of the
    optimizer's parameters, in its order; every model parameter must be one."""
    names = {id(p): n for n, p in model.named_parameters()}
    if len(optimizer.params) != len(names) or any(id(p) not in names for p in optimizer.params):
        raise ValueError("the optimizer must hold every parameter of the model, and no other")
    out = []
    for p in optimizer.params:
        mod_path, leaf = _split(names[id(p)])
        collection, flax_leaf, to_jax, to_torch = _layout(model.get_submodule(mod_path))[leaf]
        assert collection == "params"
        out.append((_path(mod_path) + (flax_leaf,), to_jax, to_torch))
    return out


def opt_state_to_jax(optimizer, model: nn.Module, empty: bool = False, moments: Optional[Tuple] = None) -> Dict:
    """The optimizer's state as the ``to_state_dict`` tree of the JAX tx (see
    the module docstring); numpy on the host, counts int32 0-d arrays. With
    `empty` the moment and accumulator leaves are uninitialised arrays of
    their shapes and dtypes: a restore's template. `moments`, a pair of
    values, stands in place of the ``mu`` and ``nu`` trees (a directory
    checkpoint's skeleton, whose moments lie in flat shards)."""
    paths = _param_paths(optimizer, model)

    def tree(tensors) -> Dict:
        out: Dict = {}
        for (path, to_jax, _), t in zip(paths, tensors):
            _put(out, path, _host(t, to_jax, empty))
        return out

    params = optimizer.params
    states = [optimizer.adamw.state.get(p, {}) for p in params]
    if any(int(s["step"]) != optimizer.updates for s in states if s):
        raise ValueError("AdamW's step disagrees with the optimizer's update count")
    if empty:
        mu = nu = acc = params  # only their shapes are read
    elif moments is not None:
        mu = nu = None
        acc = optimizer._acc if optimizer._acc is not None else [torch.zeros_like(p) for p in params]
    else:
        mu = [s["exp_avg"] if s else torch.zeros_like(p) for s, p in zip(states, params)]
        nu = [s["exp_avg_sq"] if s else torch.zeros_like(p) for s, p in zip(states, params)]
        acc = optimizer._acc if optimizer._acc is not None else [torch.zeros_like(p) for p in params]
    count = np.asarray(optimizer.updates, np.int32)
    mu_tree, nu_tree = moments if moments is not None else (tree(mu), tree(nu))
    adamw = {"0": {"count": count, "mu": mu_tree, "nu": nu_tree}, "1": {},
             "2": {"count": count.copy()} if optimizer.scheduled else {}}
    inner = {"0": {}, "1": adamw} if optimizer.max_norm is not None else adamw
    if optimizer.every_k == 1:
        return inner
    return {
        "mini_step": np.asarray(optimizer.mini_step, np.int32),
        "gradient_step": count.copy(),
        "inner_opt_state": inner,
        "acc_grads": tree(acc),
        "skip_state": {},
    }


def opt_state_from_jax(optimizer, model: nn.Module, state: Dict, moments: bool = True) -> None:
    """Load a JAX tx state (`opt_state_to_jax`'s form) into the optimizer, in
    place: AdamW's moments and step, the update count that the schedule
    reads, and `MultiSteps`' micro-step and running mean. Without `moments`
    AdamW's state is left alone and ``mu`` / ``nu`` are not read (a
    skeleton's counts and running mean)."""
    paths = _param_paths(optimizer, model)
    inner = state["inner_opt_state"] if optimizer.every_k > 1 else state
    adamw = inner["1"] if optimizer.max_norm is not None else inner
    count = int(adamw["0"]["count"])
    counts = {"adam": count}
    if optimizer.scheduled:
        counts["schedule"] = int(adamw["2"]["count"])
    if optimizer.every_k > 1:
        counts["gradient_step"] = int(state["gradient_step"])
    if len(set(counts.values())) != 1:
        raise ValueError(f"the optimizer state's counts disagree: {counts}")

    def tensors(tree: Dict) -> List[torch.Tensor]:
        return [
            torch.from_numpy(np.array(to_torch(np.asarray(_get(tree, path))), order="C")).to(p)
            for (path, _, to_torch), p in zip(paths, optimizer.params)
        ]

    # torch keeps AdamW's step on the host, in the default float type
    step_dtype = torch.float64 if torch.get_default_dtype() == torch.float64 else torch.float32
    for p, mu, nu in zip(optimizer.params, tensors(adamw["0"]["mu"]) if moments else (),
                         tensors(adamw["0"]["nu"]) if moments else ()):
        optimizer.adamw.state[p] = {
            "step": torch.tensor(float(count), dtype=step_dtype), "exp_avg": mu, "exp_avg_sq": nu,
        }
    optimizer.updates = count
    if optimizer.every_k > 1:
        optimizer.mini_step = int(state["mini_step"])
        optimizer._acc = tensors(state["acc_grads"]) if optimizer.mini_step else None


def flat_layout(optimizer, model: nn.Module) -> Dict:
    """How the optimizer's parameters lie end to end in one flat vector (the
    order and torch shapes that ZeRO-1 shards): each one's flax path in
    ``params`` ("/"-joined), its torch shape, and the axis order that takes
    it to the JAX layout (``np.transpose(torch_array, perm)``)."""
    out: Dict[str, List] = {"paths": [], "shapes": [], "perms": []}
    for p, (path, to_jax, _) in zip(optimizer.params, _param_paths(optimizer, model)):
        probe = np.empty(tuple(range(2, 2 + p.dim())), np.int8)  # distinct sizes name the axes
        out["paths"].append("/".join(path))
        out["shapes"].append(list(p.shape))
        out["perms"].append([s - 2 for s in to_jax(probe).shape])
    return out
