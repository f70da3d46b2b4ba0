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
strict=False semantics (`_tolerant_merge`).

The backends ``orbax`` and ``orbax_async`` (``train.checkpoint.backend``)
write a directory instead, in a layout of the port's own: orbax writes
OCDBT through tensorstore, both of which need JAX. The directory holds
msgpack files of the codec above:

- ``meta.msgpack``: ``format``, ``backend``, ``payload`` (the scalars:
  ``step``, ``epoch``, ``best_map``), ``opt_state_files`` (n) and, where the
  AdamW moments are sharded, ``moments`` (their flat layout: each
  parameter's flax path, torch shape and axis order to the JAX layout, in
  ZeRO-1's order; ``numel``, ``shard_numel``, ``dtype``) and ``opt_state``,
  the JAX-layout optimizer state with the strings ``"exp_avg"`` and
  ``"exp_avg_sq"`` in place of the ``mu`` and ``nu`` trees;
- ``variables.msgpack``: ``params`` and ``batch_stats``;
- ``opt_state.<i>-of-<n>.msgpack``: unsharded (n = 1), the whole JAX-layout
  ``opt_state``; sharded, ZeRO-1 shard i: ``lo``, ``hi`` and the flat slices
  ``exp_avg`` and ``exp_avg_sq`` of ``[lo, hi)``, written by the rank that
  holds it (`parallel.zero`);
- ``COMMITTED``: the commit marker, written last.

Every file is written into the staging directory ``<name>.tmp-step<step>``
(one name for every rank); global rank 0 waits until every rank has
written, writes the marker and renames the staging directory into place,
replacing a checkpoint of the same name as orbax's ``force=True`` does (the
old one first renamed aside: a half-replaced directory is never under the
final name). The ranks agree through the process group's store, never a
collective, so the write may run on a background thread (``orbax_async``:
one write in flight, `wait_for_checkpoints` the fence, which re-raises the
writer's error). `is_committed_checkpoint` accepts only a directory with
the marker (or a JAX orbax directory, which `load_checkpoint` refuses,
naming the way through msgpack). A directory restores strictly: a key
missing on either side, or a shape that differs, raises and names the key;
a dtype that differs is cast to the template's.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple, Union

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
    """True for a ``.msgpack`` file, a bare-named directory with the commit
    marker, or a bare-named orbax directory of the JAX package (which
    `load_checkpoint` refuses with the way through msgpack, rather than a
    resume silently starting over); False for a ``.tmp`` staging file, a
    staging directory of either package, or a directory without the marker,
    which a crash mid-save leaves behind."""
    if ".orbax-checkpoint-tmp" in p.name:
        return False
    if p.is_dir():
        return p.suffix == "" and ((p / COMMIT_MARKER).exists() or is_jax_orbax_directory(p))
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


def save_checkpoint(path: str, payload: Dict[str, Any], backend: str = "msgpack") -> None:
    """Write `payload` (a state dict with numpy leaves) to `path` through a
    ``.tmp`` file renamed over it, so a crash never leaves a truncated
    checkpoint under the final name. Under ``orbax`` or ``orbax_async`` a
    directory checkpoint, this process writing all of it (the Trainer
    writes a multi-process one, `train.loop.Trainer.save_checkpoint`);
    ``orbax_async`` copies the payload, returns, and writes in the
    background (`wait_for_checkpoints`)."""
    if backend in DIRECTORY_BACKENDS:
        background = backend == "orbax_async"
        if background:  # the caller may change its arrays once this returns
            payload = _copy_tree(payload)
        _WRITER.save(path, payload_files(payload, backend), int(payload.get("step", 0)), background)
        return
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


def load_checkpoint(path: str, template: Dict[str, Any], backend: str = "msgpack",
                    keep_on_shape_mismatch: bool = False) -> Dict[str, Any]:
    """The checkpoint at `path` merged into `template` (a state dict with
    numpy leaves): the template's keys, dtypes and shapes, the file's
    values. The path decides the format (a directory or a msgpack file);
    `backend` is taken for the JAX package's signature. A directory reads
    only the parts the template's top-level keys name, every ZeRO-1 shard
    of the moments included, and restores them strictly (see the module
    docstring) unless `keep_on_shape_mismatch`."""
    p = Path(path)
    if p.is_dir():
        raw = read_directory(p, tuple(template))
        if not keep_on_shape_mismatch:
            for k in template:
                if k not in raw:
                    raise ValueError(f"checkpoint {path} lacks /{k}")
                _check_structure(template[k], raw[k], f"/{k}")
        return _tolerant_merge(template, raw, keep_on_shape_mismatch=keep_on_shape_mismatch)
    raw = msgpack_restore(p.read_bytes())
    return _tolerant_merge(template, raw, keep_on_shape_mismatch=keep_on_shape_mismatch)


# -- directory checkpoints -----------------------------------------------------

DIRECTORY_BACKENDS = ("orbax", "orbax_async")
FORMAT = "bevfusion-port-directory-checkpoint"
COMMIT_MARKER = "COMMITTED"
STAGING = ".tmp-step"
META, VARIABLES = "meta.msgpack", "variables.msgpack"
_VARIABLE_KEYS = ("params", "batch_stats")
COMMIT_TIMEOUT_S = 600.0


def opt_state_file(index: int, count: int) -> str:
    return f"opt_state.{index}-of-{count}.msgpack"


def is_jax_orbax_directory(p: Path) -> bool:
    """Whether `p` holds a checkpoint that the JAX package's orbax wrote."""
    return (p / "_CHECKPOINT_METADATA").exists() or (p / "manifest.ocdbt").exists()


def _copy_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    return np.array(tree, copy=True)


def payload_files(payload: Dict[str, Any], backend: str, moments: Optional[Dict] = None,
                  opt_state_files: int = 1) -> Dict[str, Any]:
    """The files (name -> tree) of a directory checkpoint of `payload`,
    but for the moment shards. With `moments` (the flat layout, see the
    module docstring) ``payload["opt_state"]`` is the skeleton and the
    moments lie in `opt_state_files` shard files that their ranks write
    (`shard_file`); without, the whole ``opt_state`` is one file."""
    scalars = {k: v for k, v in payload.items() if k not in _VARIABLE_KEYS + ("opt_state",)}
    meta: Dict[str, Any] = {"format": FORMAT, "backend": backend, "payload": scalars,
                            "opt_state_files": opt_state_files if "opt_state" in payload else 0}
    files: Dict[str, Any] = {META: meta, VARIABLES: {k: payload[k] for k in _VARIABLE_KEYS if k in payload}}
    if moments is not None:
        meta.update(moments=moments, opt_state=payload["opt_state"])
    elif "opt_state" in payload:
        files[opt_state_file(0, 1)] = payload["opt_state"]
    return files


def shard_file(lo: int, hi: int, exp_avg: np.ndarray, exp_avg_sq: np.ndarray) -> Dict[str, Any]:
    """A ZeRO-1 shard's file: the flat moments of ``[lo, hi)``."""
    return {"lo": int(lo), "hi": int(hi), "exp_avg": exp_avg, "exp_avg_sq": exp_avg_sq}


def read_meta(path: Union[str, Path]) -> Dict[str, Any]:
    """A committed directory checkpoint's ``meta.msgpack``. A JAX orbax
    directory, or a directory without the commit marker, raises."""
    p = Path(path)
    if is_jax_orbax_directory(p):
        raise ValueError(
            f"{path} is an orbax checkpoint of the JAX package; the port cannot read orbax's format (it needs "
            "JAX). Convert it with the JAX package: bevfusion_multimodal_3d_object_detection_tpu.train.checkpoint."
            "load_checkpoint(path, template), then save_checkpoint(out, restored, backend=\"msgpack\"), and "
            "restore the .msgpack file"
        )
    if not (p / COMMIT_MARKER).exists():
        raise FileNotFoundError(f"{path} is not a committed checkpoint: it has no {COMMIT_MARKER} marker")
    meta = msgpack_restore((p / META).read_bytes())
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path}/{META} is not a directory checkpoint of the port (format {meta.get('format')!r})")
    return meta


def check_moment_layout(meta: Dict[str, Any], layout: Dict[str, Any], path: str = "") -> None:
    """Raise, naming the first parameter that differs, unless the flat
    layout of `meta`'s moments is `layout` (`utils.convert.flat_layout`)."""
    have = meta["moments"]
    for i, (name, shape) in enumerate(zip(layout["paths"], layout["shapes"])):
        if i >= len(have["paths"]):
            raise ValueError(f"checkpoint {path} moments lack /params/{name}")
        if (have["paths"][i], list(have["shapes"][i])) != (name, list(shape)):
            raise ValueError(f"checkpoint {path} moments hold /params/{have['paths'][i]} of shape "
                             f"{tuple(have['shapes'][i])} where the model has /params/{name} of shape {tuple(shape)}")
    if len(have["paths"]) > len(layout["paths"]):
        raise ValueError(f"checkpoint {path} moments hold /params/{have['paths'][len(layout['paths'])]}, "
                         "which the model lacks")


def read_moments(path: Union[str, Path], meta: Dict[str, Any], lo: int, hi: int) -> Tuple[np.ndarray, np.ndarray]:
    """``[lo, hi)`` of the flat ``exp_avg`` and ``exp_avg_sq``, whatever
    world cut the shard files: only the files that overlap it are read."""
    p, moments, n = Path(path), meta["moments"], meta["opt_state_files"]
    total, size = moments["numel"], moments["shard_numel"]
    out = [np.empty(hi - lo, np.dtype(moments["dtype"])) for _ in range(2)]
    for i in range(n):
        f_lo, f_hi = min(i * size, total), min((i + 1) * size, total)
        a, b = max(lo, f_lo), min(hi, f_hi)
        if a >= b:
            continue
        name = opt_state_file(i, n)
        shard = msgpack_restore((p / name).read_bytes())
        if (int(shard["lo"]), int(shard["hi"])) != (f_lo, f_hi):
            raise ValueError(f"{path}/{name} holds [{shard['lo']}, {shard['hi']}) where the layout puts "
                             f"[{f_lo}, {f_hi})")
        for dst, key in zip(out, ("exp_avg", "exp_avg_sq")):
            dst[a - lo:b - lo] = shard[key][a - f_lo:b - f_lo]
    return out[0], out[1]


def _moment_trees(moments: Dict[str, Any], flat: np.ndarray) -> Dict[str, Any]:
    """The JAX-layout ``params``-shaped tree of one flat moment vector."""
    tree: Dict[str, Any] = {}
    offset = 0
    for name, shape, perm in zip(moments["paths"], moments["shapes"], moments["perms"]):
        size = int(np.prod(shape, dtype=np.int64))
        leaf = np.ascontiguousarray(flat[offset:offset + size].reshape(shape).transpose(perm))
        node = tree
        parts = name.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf
        offset += size
    return tree


def _fill(skeleton: Any, values: Dict[str, Any]) -> Any:
    if isinstance(skeleton, dict):
        return {k: _fill(v, values) for k, v in skeleton.items()}
    return values[skeleton] if isinstance(skeleton, str) else skeleton


def read_opt_state(path: Union[str, Path], meta: Dict[str, Any]) -> Dict[str, Any]:
    """The whole JAX-layout ``opt_state`` of a directory checkpoint (every
    shard read where the moments are sharded)."""
    p = Path(path)
    if "moments" not in meta:
        return msgpack_restore((p / opt_state_file(0, 1)).read_bytes())
    mu, nu = read_moments(p, meta, 0, meta["moments"]["numel"])
    return _fill(meta["opt_state"], {"exp_avg": _moment_trees(meta["moments"], mu),
                                     "exp_avg_sq": _moment_trees(meta["moments"], nu)})


def read_directory(path: Union[str, Path], parts=("params", "batch_stats", "opt_state")) -> Dict[str, Any]:
    """A directory checkpoint's payload: its scalars and the `parts` it holds."""
    p = Path(path)
    meta = read_meta(p)
    out = dict(meta["payload"])
    if any(k in parts for k in _VARIABLE_KEYS):
        variables = msgpack_restore((p / VARIABLES).read_bytes())
        out.update({k: v for k, v in variables.items() if k in parts})
    if "opt_state" in parts and meta["opt_state_files"]:
        out["opt_state"] = read_opt_state(p, meta)
    return out


def _check_structure(template: Any, state: Any, path: str) -> None:
    if isinstance(template, dict) != isinstance(state, dict):
        what = lambda x: "a dict" if isinstance(x, dict) else "an array"
        raise ValueError(f"checkpoint structure mismatch at {path}: {what(state)} where the model expects "
                         f"{what(template)}")
    if isinstance(template, dict):
        keys = {str(k): k for k in template}
        for k in state:
            if k not in keys:
                raise ValueError(f"checkpoint has {path}/{k}, which the model lacks")
        for k, tk in keys.items():
            if k not in state:
                raise ValueError(f"checkpoint lacks {path}/{k}")
            _check_structure(template[tk], state[k], f"{path}/{k}")


@dataclass(frozen=True)
class Peers:
    """The ranks that write one checkpoint together: this one's global rank,
    their number, and the store they agree through (the process group's)."""

    store: Any
    rank: int
    world: int


def process_group_peers() -> Optional[Peers]:
    """Every process of the initialized process group, agreeing through its
    rendezvous store (thread-safe, and no collective: a background writer
    never drives the training group's communicators); None for one process."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return None
    store = dist.PrefixStore("checkpoint/", dist.distributed_c10d._get_default_store())
    return Peers(store, dist.get_rank(), dist.get_world_size())


def _remove(p: Path) -> None:
    if p.is_dir() and not p.is_symlink():
        shutil.rmtree(p)
    elif p.exists() or p.is_symlink():
        p.unlink()


def _write_files(directory: Path, files) -> None:
    """Write `files` (name -> tree, or a callable that builds them, called
    here) into `directory`."""
    for name, tree in (files() if callable(files) else files).items():
        (directory / name).write_bytes(msgpack_serialize(tree))


def _commit(staging: Path, path: Path) -> None:
    """Mark `staging` committed and rename it to `path`, an existing
    checkpoint there first renamed aside and then removed."""
    (staging / COMMIT_MARKER).write_bytes(b"")
    aside = staging.with_name(staging.name + ".old")
    if path.exists() or path.is_symlink():
        _remove(aside)
        os.replace(path, aside)
    os.replace(staging, path)
    _remove(aside)


def _await(store, key: str, failed: str, count: int = 0) -> None:
    """Wait until `key` is set (or, with `count`, has been added to that
    many times); raise if `failed` is set first, or after the timeout."""
    deadline = time.monotonic() + COMMIT_TIMEOUT_S
    while not (store.add(key, 0) >= count if count else store.check([key])):
        if store.check([failed]):
            raise RuntimeError(f"checkpoint write failed on another rank: {store.get(failed).decode()}")
        if time.monotonic() > deadline:
            raise TimeoutError(f"checkpoint: waited {COMMIT_TIMEOUT_S:.0f} s for {key}")
        time.sleep(0.002)


def write_directory(path: Path, files: Union[Dict[str, Any], Callable[[], Dict[str, Any]]], step: int,
                    peers: Optional[Peers] = None, key: str = "") -> None:
    """Write this rank's `files` (or what the callable returns, built here)
    into the staging directory and commit them with `peers` (see the module
    docstring). Returns on every rank once the checkpoint is committed."""
    staging = path.with_name(f"{path.name}{STAGING}{step}")
    lead = peers is None or peers.rank == 0
    failed = f"{key}/failed"
    try:
        if lead:
            _remove(staging)
            staging.mkdir(parents=True)
            if peers is not None:
                peers.store.set(f"{key}/staged", b"1")
        else:
            _await(peers.store, f"{key}/staged", failed)
        _write_files(staging, files)
        if peers is not None:
            peers.store.add(f"{key}/written", 1)
            if lead:
                _await(peers.store, f"{key}/written", failed, count=peers.world)
        if lead:
            _commit(staging, path)
            if peers is not None:
                peers.store.set(f"{key}/committed", b"1")
        else:
            _await(peers.store, f"{key}/committed", failed)
    except BaseException as e:
        if peers is not None and not peers.store.check([failed]):
            peers.store.set(failed, f"rank {peers.rank}: {e!r}".encode())
        raise


class DirectoryWriter:
    """Writes directory checkpoints, in the caller's thread or, one at a
    time, on a background thread."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._saves = 0

    def wait(self) -> None:
        """Block until the write in flight is committed; re-raise its error."""
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join()
        error, self._error = self._error, None
        if error is not None:
            raise error

    def save(self, path: str, files, step: int, background: bool = False, peers: Optional[Peers] = None) -> None:
        """`write_directory`, after the write in flight; with `background`
        on a thread, returning at once. Every one of `peers` calls it for
        every checkpoint, in the same order."""
        self.wait()
        key = f"{self._saves}/{Path(path).name}/{step}"
        self._saves += 1
        if not background:
            write_directory(Path(path), files, step, peers, key)
            return

        def run():
            try:
                write_directory(Path(path), files, step, peers, key)
            except BaseException as e:  # noqa: BLE001 - re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=run, name="checkpoint-writer")
        self._thread.start()


_WRITER = DirectoryWriter()


def write_checkpoint(path: str, files, step: int, background: bool = False, peers: Optional[Peers] = None) -> None:
    """This rank's part of a directory checkpoint, committed with `peers`
    (`DirectoryWriter.save` on the process's one writer)."""
    _WRITER.save(path, files, step, background, peers)


def wait_for_checkpoints() -> None:
    """Block until the background write in flight (``orbax_async``) is
    committed; re-raise the writer's error. A no-op without one."""
    _WRITER.wait()
