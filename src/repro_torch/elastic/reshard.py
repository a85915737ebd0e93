"""Data redistribution: stage 3 of the paper's pipeline, as placement records.

Ports :mod:`repro.elastic.reshard`.  The JAX package moves each leaf's
shards between devices with ``jax.device_put`` and counts the bytes from
``addressable_shards``.  Here every slot of the mesh lies on the one
card, so no byte has anywhere to go: each leaf stays one tensor on the
card, and a :class:`Placement` records which slot holds which shard
bounds (``NamedSharding.devices_indices_map``'s, see
:mod:`repro_torch.parallel.sharding`).  :func:`reshard_tree` returns the
new placement; :func:`transfer_stats` counts stayed and moved bytes
between two placements, the way the JAX one reads the shards of the old
and new arrays; :func:`predicted_transfer_stats` and
:class:`PytreeBytesModel` predict the same numbers from shapes alone, as
the engine's ``bytes_model``.  A shard "stays" when a slot that held the
same bounds before holds them after.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.parallel.sharding import (
    Mesh,
    NamedSharding,
    ShardingContext,
    mesh_of,
    param_shardings,
)

from .node_group import device_slots


@dataclass(frozen=True)
class Placement:
    """Where one leaf lies on a slot mesh: (slot id, shard bounds) per slot,
    bounds as ``((start, stop), ...)`` per dimension."""

    shape: tuple[int, ...]
    itemsize: int
    shards: tuple[tuple[int, tuple], ...]


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def _index_key(index: tuple, shape: tuple[int, ...]) -> tuple:
    """Normalize a shard's index slices to ((start, stop), ...) bounds."""
    return tuple(
        (s.start or 0, s.stop if s.stop is not None else dim)
        for s, dim in zip(index, shape)
    )


def _key_nbytes(key: tuple, itemsize: int) -> int:
    return math.prod(hi - lo for lo, hi in key) * itemsize if key else itemsize


def place(leaf: Any, sharding: NamedSharding) -> Placement:
    """The placement of a leaf (anything with ``.shape`` and ``.dtype``)
    under ``sharding``."""
    shape = tuple(leaf.shape)
    return Placement(shape, _itemsize(leaf.dtype), tuple(
        (slot.id, _index_key(idx, shape))
        for slot, idx in sharding.devices_indices_map(shape).items()
    ))


def _leaves(tree: Any) -> list:
    """A flat dict's values in sorted key order (the pytree order), or a
    sequence's items."""
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    return list(tree)


def _count_transfers(
    old_map: dict[tuple, set[int]],
    new_placements: Sequence[tuple[int, tuple]],
    itemsize: int,
) -> tuple[int, int, int]:
    """(total, stayed, moved) bytes over new (slot-id, index-key) pairs."""
    stayed = moved = total = 0
    for slot_id, key in new_placements:
        nbytes = _key_nbytes(key, itemsize)
        total += nbytes
        if slot_id in old_map.get(key, set()):
            stayed += nbytes
        else:
            moved += nbytes
    return total, stayed, moved


def _holders(placement: Placement) -> dict[tuple, set[int]]:
    out: dict[tuple, set[int]] = {}
    for slot_id, key in placement.shards:
        out.setdefault(key, set()).add(slot_id)
    return out


def reshard_tree(tree: Any, mesh: Mesh, spec_tree: Any) -> dict:
    """The placement of every leaf of a flat dict ``tree`` on ``mesh``.

    ``spec_tree`` is one spec for all leaves (``None``: replicated) or a
    dict of specs keyed like ``tree``.  The tensors themselves stay where
    they are: one card holds every slot.
    """
    if isinstance(spec_tree, dict):
        specs = spec_tree
    else:
        specs = {k: tuple(spec_tree or ()) for k in tree}
    return {k: place(x, NamedSharding(mesh, specs[k])) for k, x in tree.items()}


def transfer_stats(old_tree: Any, new_tree: Any) -> dict[str, int]:
    """Bytes that moved vs stayed local between two placement trees.

    Args:
        old_tree: :class:`Placement` per leaf before the reshard.
        new_tree: the same leaves' placements after it.
    Returns:
        ``{"bytes_total", "bytes_stayed", "bytes_moved"}`` summed over
        all leaves (zeros for an empty tree).
    """
    stayed = moved = total = 0
    for old, new in zip(_leaves(old_tree), _leaves(new_tree)):
        t, s, m = _count_transfers(_holders(old), new.shards, old.itemsize)
        total += t
        stayed += s
        moved += m
    return {"bytes_total": total, "bytes_stayed": stayed, "bytes_moved": moved}


def predicted_transfer_stats(
    tree: Any, old_shardings: Any, new_shardings: Any
) -> dict[str, int]:
    """Predict :func:`transfer_stats` from shapes and shardings alone.

    Args:
        tree: shape/dtype carriers (``ParamShape`` or tensors; no data
            is read), a flat dict or a sequence.
        old_shardings: :class:`NamedSharding` per leaf (same structure),
            or a single one applied to all leaves.
        new_shardings: same, for the target placement.
    Returns:
        ``{"bytes_total", "bytes_stayed", "bytes_moved"}``.
    """
    leaves = _leaves(tree)

    def _as_list(shardings, which):
        flat = ([shardings] if isinstance(shardings, NamedSharding)
                else _leaves(shardings))
        if len(flat) == 1 and len(leaves) > 1:
            return flat * len(leaves)
        if len(flat) != len(leaves):
            raise ValueError(
                f"{which} shardings have {len(flat)} leaves for a tree of "
                f"{len(leaves)} — bytes would be silently undercounted"
            )
        return flat

    old_list = _as_list(old_shardings, "old")
    new_list = _as_list(new_shardings, "new")
    return transfer_stats([place(x, s) for x, s in zip(leaves, old_list)],
                          [place(x, s) for x, s in zip(leaves, new_list)])


@dataclass
class PytreeBytesModel:
    """Exact stage-3 bytes model for a model's parameter pytree.

    Callable as ``(ns_ranks, nt_ranks) -> bytes_moved``, the
    ``ReconfigEngine.bytes_model`` protocol: it resolves the model's
    parameter shardings on 1-D ``("data",)`` meshes of both rank counts
    (slots in pool order, matching
    :meth:`~repro_torch.elastic.runtime.ElasticRuntime.mesh`) and
    predicts the reshard's bytes via :func:`predicted_transfer_stats`,
    on logical slots ``0..k-1`` that hold no memory (on the ``meta``
    device); rank counts are slot counts.
    """

    model: Any                       # repro_torch.models.Model
    _cache: dict = field(default_factory=dict, repr=False)

    def _shardings(self, k: int) -> dict:
        if k not in self._cache:
            ctx = ShardingContext(mesh=mesh_of(device_slots(k, "meta")))
            shapes, specs = self._abstract()
            self._cache[k] = param_shardings(shapes, specs, ctx)
        return self._cache[k]

    def _abstract(self):
        if "abstract" not in self._cache:
            self._cache["abstract"] = self.model.abstract_params()
        return self._cache["abstract"]

    def __call__(self, ns: int, nt: int) -> int:
        return self.stats(ns, nt)["bytes_moved"]

    def total_bytes(self, ranks: int) -> int:
        """Full parameter-pytree bytes — the checkpoint snapshot size
        (independent of the rank count: the union of shards is the
        pytree); equals ``param_bytes_for_arch`` of the model's arch."""
        shapes, _ = self._abstract()
        return int(sum(s.nbytes for s in shapes.values()))

    def stats(self, ns: int, nt: int) -> dict:
        """Full per-link prediction ``{"bytes_total", "bytes_stayed",
        "bytes_moved"}`` for an ``ns -> nt`` resize."""
        if ns == nt or ns <= 0 or nt <= 0:
            return {"bytes_total": 0, "bytes_stayed": 0, "bytes_moved": 0}
        shapes, _ = self._abstract()
        return predicted_transfer_stats(
            shapes, self._shardings(ns), self._shardings(nt)
        )
