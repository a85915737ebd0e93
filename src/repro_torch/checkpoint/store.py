"""Flat-file checkpoint store with a pytree manifest (ports
:mod:`repro.checkpoint.store`).

Layout:  <dir>/step_<n:09d>/manifest.json + one ``leaf_<i:05d>.npy`` per
leaf, the JAX package's own.  A tree is nested dicts, lists, tuples and
named tuples (``TrainState``, ``AdamWState``) with tensors, numpy arrays or
numbers as leaves.  It is flattened as JAX flattens a pytree: dict keys in
sorted order, sequences and named-tuple fields in order; a leaf's key
joins the dict keys, field names and indices on its path with ``/``
(``params/blocks/attn/wq``).  So leaf ``i`` and its key are the same in
both packages, and each restores the other's snapshot.  Leaves are saved
from host copies; bfloat16 leaves are refused (numpy has no bfloat16
without ``ml_dtypes``, and the train state holds fp32 masters).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree: Any, path: tuple = ()) -> list[tuple[tuple, Any]]:
    """(path, leaf) pairs in JAX's pytree order; None is an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in _flatten(tree[k], path + (k,))]
    if _is_namedtuple(tree):
        return [pl for f in tree._fields for pl in _flatten(getattr(tree, f), path + (f,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, x in enumerate(tree) for pl in _flatten(x, path + (i,))]
    return [(path, tree)]


def _unflatten(template: Any, leaves: list) -> Any:
    """``template``'s structure with ``leaves`` (in flatten order) as values."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}   # the template's own key order
        if _is_namedtuple(t):
            return type(t)(*(build(getattr(t, f)) for f in t._fields))
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(template)


def _key(path: tuple) -> str:
    return "/".join(str(p) for p in path) or "leaf"


def _to_numpy(leaf) -> np.ndarray:
    """A host copy (never a view of a tensor that training mutates)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("checkpoint: bfloat16 leaves are not supported (numpy has no "
                            "bfloat16); save the fp32 masters")
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def save_tree(tree: Any, directory: str, step: int) -> str:
    """Synchronous save; returns the checkpoint path.

    Crash-safe: leaves stream into a ``.tmp`` staging directory that is
    published over ``path`` only once every leaf and the manifest have
    landed.  A failed leaf write removes the staging directory, and
    re-saving an existing step replaces the old snapshot whole.
    """
    path = os.path.join(directory, f"step_{step:09d}")
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    try:
        manifest = {"step": step, "leaves": []}
        for i, (p, leaf) in enumerate(_flatten(tree)):
            arr = _to_numpy(leaf)
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"].append({"key": _key(p), "file": fname, "dtype": str(arr.dtype),
                                       "shape": list(arr.shape)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)  # atomic publish
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return path


def _steps(directory: str) -> list[int]:
    return [int(name.split("_")[1]) for name in os.listdir(directory)
            if name.startswith("step_") and not name.endswith(".tmp")]


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return max(steps) if steps else None


def restore_tree(template: Any, directory: str, step: int, device=None) -> Any:
    """Restore into ``template``'s structure (its leaf values are ignored),
    as tensors on ``device`` (default: the CPU).  The snapshot's leaf count
    and keys must be the template's."""
    path = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    meta = manifest["leaves"]
    flat = _flatten(template)
    if len(flat) != len(meta):
        raise ValueError(f"checkpoint has {len(meta)} leaves, template {len(flat)}")
    keys = [_key(p) for p, _ in flat]
    if keys != [m["key"] for m in meta]:
        bad = next(i for i, (k, m) in enumerate(zip(keys, meta)) if k != m["key"])
        raise ValueError(f"checkpoint leaf {bad} is {meta[bad]['key']!r}, template {keys[bad]!r}")
    leaves = [torch.from_numpy(np.load(os.path.join(path, m["file"]))).to(device or "cpu")
              for m in meta]
    return _unflatten(template, leaves)


class CheckpointManager:
    """Periodic, optionally-async checkpointing with retention."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, tree: Any, step: int) -> None:
        # Snapshot to host synchronously (training mutates the tensors in
        # place), write to disk on a worker thread (overlaps with compute).
        host_tree = _unflatten(tree, [_to_numpy(leaf) for _, leaf in _flatten(tree)])
        self.wait()

        def _write():
            save_tree(host_tree, self.directory, step)
            self._gc()

        if self.async_save:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()

    def restore_latest(self, template: Any, device=None):
        self.wait()
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return restore_tree(template, self.directory, step, device), step

    def _gc(self) -> None:
        for s in sorted(_steps(self.directory))[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"), ignore_errors=True)
