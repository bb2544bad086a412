"""Fault-tolerant checkpointing: npz shards + manifest, async save,
device-agnostic restore.

Layout of a checkpoint directory (the reference's, so that a checkpoint
written by either package restores in the other):
    <dir>/step_000123/
        manifest.json       {step, n_shards, leaves {key: shape, dtype,
                             shard}, extra}
        shard_<i>.npz       host numpy arrays (full, unsharded)
    <dir>/LATEST            atomic pointer file (write-temp + rename)

A leaf's key is its path in the tree joined with ``/``: dict keys (in
sorted order, as the reference flattens them), NamedTuple fields by name,
list and tuple items as ``[i]``; ``None`` holds no leaf. Saves are
step-atomic: a crash mid-save leaves LATEST pointing at the previous
complete checkpoint. ``AsyncSaver`` copies device to host on the caller's
thread (consistency) and writes on a worker thread.

On a mesh (a state of DTensors, ``launch.shardings.place``) a checkpoint
holds each leaf's global tensor, gathered on every rank (a collective:
every rank of the world calls ``save``) and copied to the host and
written by rank 0 alone (the others drop each gathered leaf at once); the
files are the same as an unsharded state's. ``restore(shardings=)``
places each leaf on its mesh, whatever the mesh it was saved from.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..launch.shardings import full, place_tensor

_SEP = "/"

# dtypes numpy's npz container can't hold: stored as a raw bit-pattern
# view (uint16, uint8) with the dtype's name in the manifest, both as the
# reference stores them
_VIEWED = {"bfloat16": (torch.bfloat16, np.uint16),
           "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8),
           "float8_e5m2": (torch.float8_e5m2, np.uint8)}
_BY_TORCH = {t: name for name, (t, _) in _VIEWED.items()}
# the integer of each width that both numpy and torch hold
_BITS = {2: (torch.int16, np.int16), 1: (torch.uint8, np.uint8)}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _leaves(tree, path=()):
    """(key, leaf) over ``tree`` in the reference's flattening order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    elif _is_namedtuple(tree):
        for f in tree._fields:
            yield from _leaves(getattr(tree, f), path + (f,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (f"[{i}]",))
    else:
        yield _SEP.join(path), tree


def _rebuild(tree, fn, path=()):
    """``tree`` with each leaf replaced by ``fn(key, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return type(tree)((k, _rebuild(v, fn, path + (str(k),)))
                          for k, v in tree.items())
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(getattr(tree, f), fn, path + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, fn, path + (f"[{i}]",))
                          for i, v in enumerate(tree))
    return fn(_SEP.join(path), tree)


def _writes() -> bool:
    """Whether this process writes checkpoints: rank 0 of a world, or a
    process that is in none."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a host array fit for npz, and its dtype's name."""
    if not isinstance(leaf, torch.Tensor):
        a = np.asarray(leaf)
        return a, str(a.dtype)
    t = full(leaf).detach().cpu()
    if t.dtype in _BY_TORCH:
        name = _BY_TORCH[t.dtype]
        disk = _VIEWED[name][1]
        return t.view(_BITS[t.element_size()][0]).numpy().view(disk), name
    a = t.numpy()
    return a, str(a.dtype)


def _join_gathers(tree) -> None:
    """What a rank that does not write does of a save: it joins each
    DTensor leaf's gather (a collective, in ``_leaves``'s order, as the
    writer gathers) and drops the global tensor at once, so that no host
    copy of the state is made off the writer."""
    for _, leaf in _leaves(tree):
        full(leaf)


def _snapshot(leaf):
    """A host copy of a leaf that later in-place updates cannot reach."""
    if isinstance(leaf, torch.Tensor):
        return full(leaf).detach().to("cpu", copy=True)
    return np.array(leaf)


def _from_disk(v: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name in _VIEWED:
        return torch.from_numpy(v.view(_BITS[v.itemsize][1])).view(
            _VIEWED[dtype_name][0])
    return torch.from_numpy(v)


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None,
         shard_mb: int = 512) -> str:
    """Synchronous atomic save. Returns the checkpoint path. In a world of
    ranks every rank calls it; rank 0 writes, and every rank returns once
    the checkpoint is complete."""
    if _writes():
        flat = {k: _host(v) for k, v in _leaves(tree)}
        path = _write(ckpt_dir, step, flat, extra, shard_mb)
    else:
        _join_gathers(tree)
        path = os.path.join(ckpt_dir, f"step_{step:08d}")
    if dist.is_initialized():
        dist.barrier()
    return path


def _write(ckpt_dir: str, step: int, flat: dict, extra: dict | None,
           shard_mb: int) -> str:
    """Write the host arrays ``flat`` (key -> (array, dtype name)) as the
    checkpoint of ``step`` and point LATEST at it."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        shards: list[list[str]] = [[]]
        size = 0
        limit = shard_mb * 1024 * 1024
        for k, (v, _) in flat.items():
            if size > limit:
                shards.append([])
                size = 0
            shards[-1].append(k)
            size += v.nbytes
        manifest = {
            "step": step,
            "n_shards": len(shards),
            "leaves": {k: {"shape": list(flat[k][0].shape),
                           "dtype": flat[k][1], "shard": si}
                       for si, keys in enumerate(shards) for k in keys},
            "extra": extra or {},
        }
        for si, keys in enumerate(shards):
            np.savez(os.path.join(tmp, f"shard_{si}.npz"),
                     **{k: flat[k][0] for k in keys})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    # atomic LATEST pointer
    ptr_tmp = os.path.join(ckpt_dir, ".LATEST_tmp")
    with open(ptr_tmp, "w") as f:
        f.write(os.path.basename(final))
    os.replace(ptr_tmp, os.path.join(ckpt_dir, "LATEST"))
    return final


class AsyncSaver:
    """Double-buffered async checkpointing: the device->host copy happens on
    the caller thread (so the snapshot is consistent), serialization+IO on a
    worker. A second save while one is in flight blocks until it finishes
    (bounded memory)."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self.last_path: str | None = None
        self._err: BaseException | None = None

    def save(self, ckpt_dir: str, step: int, tree, extra=None):
        """On a mesh every rank calls this (the snapshot gathers each
        DTensor); only rank 0 writes, and nothing waits for it but its
        own ``wait``."""
        self.wait()
        if not _writes():
            _join_gathers(tree)
            return
        # in ``_leaves``'s order, as the other ranks join the gathers
        snap = [(k, _snapshot(v)) for k, v in _leaves(tree)]

        def work():
            try:
                flat = {k: _host(v) for k, v in snap}
                self.last_path = _write(ckpt_dir, step, flat, extra, 512)
            except BaseException as e:  # surfaced on next wait()
                self._err = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err


def latest_step(ckpt_dir: str) -> int | None:
    ptr = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    if not os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
        return None
    return int(name.split("_")[1])


def restore(ckpt_dir: str, tree_like, step: int | None = None,
            shardings=None) -> tuple[Any, dict]:
    """Restore into the structure of ``tree_like``: each leaf as a new
    tensor of the checkpoint's dtype, on the device of its ``tree_like``
    leaf (the host for a leaf that is not a tensor). ``shardings``, a tree
    of the same structure (``launch.shardings.state_shardings``), places
    each leaf it gives a ``NamedSharding`` as a DTensor on that sharding's
    mesh (every rank of the mesh calls ``restore``); its None leaves
    restore as above."""
    placed = {} if shardings is None else dict(_leaves(shardings))
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data: dict[str, np.ndarray] = {}
    for si in range(manifest["n_shards"]):
        with np.load(os.path.join(path, f"shard_{si}.npz")) as z:
            data.update({k: z[k] for k in z.files})

    def leaf_of(key, like):
        if key not in data:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = data[key]
        want = tuple(like.shape)
        if tuple(arr.shape) != want:
            raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} "
                             f"vs model {want}")
        t = _from_disk(arr, manifest["leaves"][key]["dtype"])
        if key in placed:
            return place_tensor(t, placed[key])
        return t.to(like.device) if isinstance(like, torch.Tensor) else t

    return _rebuild(tree_like, leaf_of), manifest["extra"]
