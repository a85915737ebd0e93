"""Logical-axis sharding rules and their resolution on a slot mesh.

The part of :mod:`repro.parallel.sharding` that stage 3 of the elastic
loop needs: the rule tables, ``_fit_axes`` and ``resolve_spec`` for
weights (the same greedy choice of mesh axes per dimension, and the same
fallback pass that keeps a weight fully sharded), and ``param_specs``
over a model's shape-only params.  A spec is a tuple with one entry per dimension:
``None``, a mesh axis name, or a tuple of names (what ``PartitionSpec``
holds).

The mesh is a :class:`Mesh` of logical slots (``repro_torch.elastic``),
not a ``jax.sharding.Mesh``; :class:`NamedSharding` gives each slot's
shard bounds as ``jax.sharding.NamedSharding.devices_indices_map`` does.
No activation constraint and no tensor-parallel layer is ported here
(ROADMAP.md A16): one card computes the whole step.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

# ---------------------------------------------------------------------------
# Rule tables (the JAX package's, unchanged)
# ---------------------------------------------------------------------------

# Weights: TP over 'model' on the obvious dims, ZeRO-3/FSDP over 'data' on
# the embed dim.  'layers' is the scan axis and never sharded.
WEIGHT_RULES: dict[str, Any] = {
    "vocab": "model",
    "mlp": "model",
    "heads": "model",
    "kv_heads": "model",      # dropped automatically when kv < |model|
    "q_per_kv": None,
    "head_dim": None,
    "embed": "data",
    "embed_out": "data",
    "experts": "model",
    "layers": None,
    "ssm_inner": "model",
    "ssm_state": None,
    "ssm_heads": "model",
    "conv": None,
    "xlstm_inner": "model",
    "xlstm_heads": "model",
    "gate": None,
}

# Activations, per execution shape.  'train': batch-parallel over
# (pod, data); 'decode': batch over (pod, data) + KV cache sequence over
# 'model' (context parallelism); 'long': batch too small to shard, the
# sequence/KV dims carry all parallelism.  Kept as data: nothing in the
# port resolves an activation spec until tensor parallelism (A16).
ACT_RULES: dict[str, dict[str, Any]] = {
    "train": {
        "batch": ("pod", "data"),
        "exp_capacity": ("pod", "data"),
        "seq": None,
        "residual_seq": "model",   # Megatron-style sequence parallelism
        "kv_seq": None,
        "embed": None,
        "heads": "model",
        "kv_heads": "model",
        "q_per_kv": None,
        "head_dim": None,
        "mlp": "model",
        "vocab": "model",
        "experts": "model",
        "ssm_inner": "model",
        "ssm_heads": "model",
        "ssm_state": None,
        "xlstm_inner": "model",
        "xlstm_heads": "model",
    },
    "decode": {
        "batch": ("pod", "data"),
        "exp_capacity": ("pod", "data"),
        "seq": None,
        "residual_seq": None,
        "kv_seq": "model",
        "embed": None,
        "heads": "model",
        "kv_heads": None,
        "q_per_kv": None,
        "head_dim": None,
        "mlp": "model",
        "vocab": "model",
        "experts": "model",
        "ssm_inner": "model",
        "ssm_heads": "model",
        "ssm_state": None,
        "xlstm_inner": "model",
        "xlstm_heads": "model",
    },
    "long": {
        "batch": None,
        "exp_capacity": ("pod", "data"),
        "seq": ("pod", "data"),
        "residual_seq": ("pod", "data"),
        "kv_seq": ("pod", "data", "model"),
        "embed": None,
        "heads": "model",
        "kv_heads": None,
        "q_per_kv": None,
        "head_dim": None,
        "mlp": "model",
        "vocab": "model",
        "experts": "model",
        "ssm_inner": "model",
        "ssm_heads": "model",
        "ssm_state": None,
        "xlstm_inner": "model",
        "xlstm_heads": "model",
    },
}


# ---------------------------------------------------------------------------
# Slot mesh and named shardings
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Mesh:
    """Slots laid out on named axes, row-major (``devices`` is flat)."""

    devices: tuple
    axis_names: tuple[str, ...]
    shape: tuple[int, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} for axes {self.axis_names}")
        if math.prod(self.shape) != len(self.devices):
            raise ValueError(f"mesh shape {self.shape} for {len(self.devices)} slots")

    @property
    def size(self) -> int:
        return len(self.devices)

    def axis_sizes(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    def coords(self, flat_index: int) -> dict[str, int]:
        """A slot's coordinate along every axis (row-major)."""
        out = {}
        for name, n in reversed(list(zip(self.axis_names, self.shape))):
            flat_index, out[name] = divmod(flat_index, n)
        return out


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a :class:`Mesh`: which part of a tensor each slot holds."""

    mesh: Mesh
    spec: tuple

    def devices_indices_map(self, shape: tuple[int, ...]) -> dict[Any, tuple[slice, ...]]:
        """slot -> one slice per dimension, as JAX's map of the same name:
        a dimension split over axes (a, b) is cut into ``|a| * |b|``
        chunks of ``ceil(dim / n)`` rows, the slot's coordinate on a
        major, on b minor; unsplit dimensions are whole."""
        sizes = self.mesh.axis_sizes()
        spec = tuple(self.spec) + (None,) * (len(shape) - len(self.spec))
        out = {}
        for i, slot in enumerate(self.mesh.devices):
            coords = self.mesh.coords(i)
            idx = []
            for entry, dim in zip(spec, shape):
                axes = _entry_axes(entry)
                if not axes:
                    idx.append(slice(None))
                    continue
                n, pos = 1, 0
                for ax in axes:
                    n, pos = n * sizes[ax], pos * sizes[ax] + coords[ax]
                chunk = -(-dim // n)
                idx.append(slice(min(pos * chunk, dim), min((pos + 1) * chunk, dim)))
            out[slot] = tuple(idx)
        return out


# ---------------------------------------------------------------------------
# Resolution
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShardingContext:
    mesh: Mesh


def _fit_axes(rule: Any, dim: int, mesh: Mesh, taken: set[str]) -> tuple[str, ...]:
    """Greedy left-to-right selection of mesh axes for one dimension of a
    weight: an axis is taken only where it keeps the split divisible (the
    JAX package's jit argument shardings reject uneven dims)."""
    if rule is None:
        return ()
    axes = (rule,) if isinstance(rule, str) else tuple(rule)
    sizes = mesh.axis_sizes()
    out: list[str] = []
    shards = 1
    for ax in axes:
        if ax not in sizes or ax in taken:
            continue
        nxt = shards * sizes[ax]
        if dim % nxt == 0:
            out.append(ax)
            shards = nxt
            taken.add(ax)
    return tuple(out)


def resolve_spec(logical_axes: tuple, shape: tuple[int, ...], ctx: ShardingContext) -> tuple:
    """Map a weight's logical axes -> a spec tuple for a tensor of ``shape``
    (``resolve_spec(..., kind="weight")`` of the JAX package)."""
    assert len(logical_axes) == len(shape), (logical_axes, shape)
    taken: set[str] = set()
    entries: list = []
    for name, dim in zip(logical_axes, shape):
        rule = None if name is None else WEIGHT_RULES.get(name)
        entries.append(list(_fit_axes(rule, dim, ctx.mesh, taken)))
    # Fallback pass: keep weights fully sharded even when the natural dim
    # doesn't divide: place unused mesh axes on the largest remaining
    # divisible dim (a storage sharding, ZeRO-style).
    sizes = ctx.mesh.axis_sizes()
    for ax in ("model", "data", "pod"):
        if ax not in sizes or ax in taken:
            continue
        cands = [
            (shape[i], i)
            for i in range(len(shape))
            if logical_axes[i] != "layers"
            and shape[i] % (sizes[ax] * math.prod(sizes[a] for a in entries[i])) == 0
        ]
        if not cands:
            continue
        _, best = max(cands)
        entries[best].append(ax)
        taken.add(ax)
    return tuple(tuple(e) if len(e) > 1 else (e[0] if e else None) for e in entries)


def param_specs(shapes: dict, specs: dict, ctx: ShardingContext) -> dict:
    """Weight spec per param, from shape carriers (anything with
    ``.shape``: :class:`~repro_torch.models.common.ParamShape` or a
    tensor) and their logical axes."""
    return {k: resolve_spec(tuple(specs[k]), tuple(s.shape), ctx)
            for k, s in shapes.items()}


def param_shardings(shapes: dict, specs: dict, ctx: ShardingContext) -> dict:
    """:class:`NamedSharding` per param on ``ctx.mesh``."""
    return {k: NamedSharding(ctx.mesh, spec)
            for k, spec in param_specs(shapes, specs, ctx).items()}


def mesh_of(devices, axes: tuple[str, ...] = ("data",),
            shape: Optional[tuple[int, ...]] = None) -> Mesh:
    """A :class:`Mesh` over ``devices`` (1-D over all of them by default)."""
    devices = tuple(devices)
    return Mesh(devices, tuple(axes), tuple(shape) if shape is not None else (len(devices),))
