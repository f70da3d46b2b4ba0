"""Checkpoint I/O in flax's msgpack layout, read and written without flax.

Port of ``bevfusion_multimodal_3d_object_detection_tpu/train/checkpoint.py``
(the msgpack backend). A payload is the ``to_state_dict`` form of the JAX
package's: nested dicts with string keys (tuples as ``"0"``, ``"1"``...,
optax's NamedTuples by field name, an empty state as ``{}``) and numpy
leaves. `msgpack_serialize` gives the bytes of
``flax.serialization.msgpack_serialize`` on such a tree:

- an ndarray is ext type 1 and a numpy scalar ext type 3, each holding the
  packed ``(shape, dtype name, C-order bytes)``
  (flax ``serialization.py:249-315``);
- every dict's keys are sorted (flax copies the tree with
  ``jax.tree_util.tree_map``, which sorts them).

flax splits arrays above 2**30 bytes into chunks; this detector's largest
array is 164 MB, so the chunked form is neither written nor read.

`save_checkpoint` writes ``<path>.tmp`` and renames it over `path`;
`load_checkpoint` merges the file into a template with the JAX package's
strict=False semantics (`_tolerant_merge`). The orbax backends need JAX and
stay with the JAX package (the training CLI refuses them).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import msgpack
import numpy as np

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


def _ndarray_to_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    return msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes("C")), use_bin_type=True)


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode()), count=-1, offset=0).reshape(
        shape, order="C")


def _ext_pack(x):
    if isinstance(x, np.ndarray):
        return msgpack.ExtType(_EXT_NDARRAY, _ndarray_to_bytes(x))
    if isinstance(x, np.generic):
        return msgpack.ExtType(_EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(x)))
    raise TypeError(f"cannot serialize {type(x).__name__}")


def _ext_unpack(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    return msgpack.ExtType(code, data)


def _sorted(tree: Any) -> Any:
    """A copy of `tree` with every dict's keys sorted, as flax packs it."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_sorted(v) for v in tree]
    return tree


def msgpack_serialize(tree: Dict[str, Any]) -> bytes:
    """flax's ``msgpack_serialize`` of a state dict with numpy leaves."""
    return msgpack.packb(_sorted(tree), default=_ext_pack, strict_types=True)


def msgpack_restore(data: bytes) -> Dict[str, Any]:
    """flax's ``msgpack_restore``: the state dict, arrays read-only views of
    `data`."""
    return msgpack.unpackb(data, ext_hook=_ext_unpack, raw=False)


def is_committed_checkpoint(p: Path) -> bool:
    """True for a ``.msgpack`` file or a bare directory name (an orbax
    checkpoint the JAX package wrote); False for a ``.tmp`` staging file or
    an orbax staging directory, which a crash mid-save leaves behind."""
    if ".orbax-checkpoint-tmp" in p.name:
        return False
    return p.suffix in ("", ".msgpack")


def latest_checkpoint(save_dir: str, prefix: str = "checkpoint_epoch_") -> Tuple[Optional[str], int]:
    """(path, epoch) of the newest committed epoch checkpoint in `save_dir`,
    or (None, -1)."""
    d = Path(save_dir)
    if not d.exists():
        return None, -1
    best, best_epoch = None, -1
    for p in d.glob(f"{prefix}*"):
        if not is_committed_checkpoint(p):
            continue
        stem = p.stem if p.suffix else p.name
        try:
            epoch = int(stem.replace(prefix, "").split(".")[0])
        except ValueError:
            continue
        if epoch > best_epoch:
            best, best_epoch = p, epoch
    return (str(best), best_epoch) if best else (None, -1)


def save_checkpoint(path: str, payload: Dict[str, Any]) -> None:
    """Write `payload` (a state dict with numpy leaves) to `path` through a
    ``.tmp`` file renamed over it, so a crash never leaves a truncated
    checkpoint under the final name."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_suffix(p.suffix + ".tmp")
    tmp.write_bytes(msgpack_serialize(payload))
    tmp.replace(p)


def _tolerant_merge(template: Any, state: Any, path: str = "", keep_on_shape_mismatch: bool = False) -> Any:
    """strict=False restore semantics (the reference loads with strict=False,
    eval.py:211): keys in both are restored, keys only in the template keep
    their values, extra checkpoint keys are ignored. A shape mismatch or a
    dict where an array belongs (or the reverse) raises unless
    `keep_on_shape_mismatch`, which warns and keeps the template's value."""

    def mismatch(what: str):
        if not keep_on_shape_mismatch:
            raise ValueError(f"checkpoint {what} at {path or '/'} (pass keep_on_shape_mismatch=True "
                             "to keep the current values)")
        print(f"Warning: checkpoint {what} at {path or '/'}; keeping current values")
        return template

    if isinstance(template, dict):
        if not isinstance(state, dict):
            return mismatch(f"structure mismatch: {type(state).__name__} where the model expects a dict")
        return {
            k: _tolerant_merge(v, state[str(k)], f"{path}/{k}", keep_on_shape_mismatch)
            if str(k) in state else v
            for k, v in template.items()
        }
    if state is None:
        return template
    if isinstance(state, dict):
        return mismatch("structure mismatch: a dict where the model expects an array")
    arr, t_arr = np.asarray(state), np.asarray(template)
    if arr.shape != t_arr.shape:
        return mismatch(f"shape mismatch: {arr.shape} where the model expects {t_arr.shape}")
    return arr.astype(t_arr.dtype, copy=False)  # no copy where the dtype already matches


def fill_kept(restored: Any, template: Any, current: Callable[[], Any]) -> Any:
    """`restored` (a merge into `template`) with each leaf that the merge
    kept from the template (the same object) taken from ``current()``, which
    is called only if there is such a leaf. A template of uninitialised
    arrays, which gives only keys, shapes and dtypes, then restores as one
    of the current values would."""
    cur = []

    def walk(r, t, path):
        if isinstance(t, dict):
            return {k: walk(r[k], v, path + (k,)) for k, v in t.items()}
        if r is not t:
            return r
        if not cur:
            cur.append(current())
        value = cur[0]
        for k in path:
            value = value[k]
        return value

    return walk(restored, template, ())


def load_checkpoint(path: str, template: Dict[str, Any],
                    keep_on_shape_mismatch: bool = False) -> Dict[str, Any]:
    """The checkpoint at `path` merged into `template` (a state dict with
    numpy leaves): the template's keys, dtypes and shapes, the file's
    values."""
    p = Path(path)
    if p.is_dir():
        raise NotImplementedError(f"{path} is an orbax checkpoint, which stays with the JAX package")
    raw = msgpack_restore(p.read_bytes())
    return _tolerant_merge(template, raw, keep_on_shape_mismatch=keep_on_shape_mismatch)
