"""Logical-axis sharding rules and their resolution, on a slot mesh or on
the ranks of a ``torch.distributed`` world.

Ports :mod:`repro.parallel.sharding`: the rule tables, ``_fit_axes`` and
``resolve_spec`` for weights (the greedy choice of mesh axes per
dimension, divisible only, and the fallback pass that keeps a weight
fully sharded) and for activations (``dim >= shards``), the context
(``ShardingContext`` with its mode and overrides, ``use_sharding``,
``current_context``) and ``constrain``.  A spec is a tuple with one entry
per dimension: ``None``, a mesh axis name, or a tuple of names (what
``PartitionSpec`` holds).

Two kinds of mesh carry the same axis names and sizes:

* :class:`Mesh`, logical slots (``repro_torch.elastic``), whose
  :class:`NamedSharding` gives each slot's shard bounds as
  ``jax.sharding.NamedSharding.devices_indices_map`` does; stage 3 of
  the elastic loop places state on it;
* :class:`ProcessMesh`, the ranks of a process group, one process per
  rank (``repro_torch.launch.mesh.make_host_mesh``): each axis has its
  ``torch.distributed`` group, and a tensor on a rank is that rank's
  shard.  Training across ranks (``repro_torch.train.steps``) and the
  tensor/sequence and expert parallel layers (``repro_torch.models.layers``)
  run on it; ``constrain`` moves a local tensor between two layouts over
  its groups (:mod:`repro_torch.parallel.collectives`).  Serving runs on
  it too, in the ``decode`` and ``long`` modes (``repro_torch.train``'s
  ``build_serve_step``: the cache's sequence split over the ranks); and
  the dry run builds one on ``torch.distributed``'s ``fake`` backend
  (:mod:`repro_torch.launch.dryrun`), whose collectives move nothing.
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass, field
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
# sequence/KV dims carry all parallelism.
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
        return _coords(self.axis_names, self.shape, flat_index)


def _coords(axis_names, shape, flat: int) -> dict[str, int]:
    out = {}
    for name, n in reversed(list(zip(axis_names, shape))):
        flat, out[name] = divmod(flat, n)
    return out


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry, major first."""
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
                axes = spec_axes(entry)
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
# Process mesh
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ProcessMesh(Mesh):
    """The ranks of a ``torch.distributed`` world on named axes, seen from
    one rank: a :class:`Mesh` whose slots are the ranks (``devices`` is
    ``range(world)``, row-major, so rank = the flat index of its
    coordinates).

    ``groups`` holds, for each axis, the process group of the ranks that
    share every other coordinate with this one, ordered by their
    coordinate on the axis (``torch.distributed.new_group`` over sorted
    ranks).  ``comm_bytes`` counts what the collectives of
    :mod:`repro_torch.parallel.collectives` moved on this rank, by
    (operation, axis): an all-gather's output, a reduce-scatter's input,
    an all-reduce's tensor; ``comm_calls`` how many calls moved them."""

    rank: int
    groups: dict
    backend: str
    device: Any
    comm_bytes: dict = field(default_factory=dict, compare=False)
    comm_calls: dict = field(default_factory=dict, compare=False)

    def coords(self, rank: Optional[int] = None) -> dict[str, int]:
        """A rank's coordinate along every axis (this rank's by default)."""
        return super().coords(self.rank if rank is None else rank)

    def replicated_axes(self, spec: tuple) -> tuple[str, ...]:
        """The axes a tensor under ``spec`` is whole over (none of its
        dimensions is split over them)."""
        used = {a for e in spec for a in spec_axes(e)}
        return tuple(a for a in self.axis_names if a not in used)

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (0 on an axis the mesh lacks),
        ``jax.lax.axis_index``."""
        return self.coords().get(axis, 0)

    def axis_size(self, axis: str) -> int:
        return self.axis_sizes().get(axis, 1)

    def count(self, op: str, axis: str, nbytes: int):
        key = (op, axis)
        self.comm_bytes[key] = self.comm_bytes.get(key, 0) + nbytes
        self.comm_calls[key] = self.comm_calls.get(key, 0) + 1

    def shard_slices(self, spec: tuple, shape: tuple[int, ...]) -> tuple[slice, ...]:
        """This rank's block of a tensor of ``shape`` under ``spec``
        (:meth:`NamedSharding.devices_indices_map`).  Raises where a split
        is uneven (the port splits evenly only)."""
        sizes = self.axis_sizes()
        for entry, dim in zip(spec, shape):
            n = math.prod(sizes[a] for a in spec_axes(entry))
            if dim % n:
                raise ValueError(f"{dim} does not split evenly over {spec_axes(entry)} "
                                 f"(shape {tuple(shape)}, spec {tuple(spec)})")
        return NamedSharding(self, tuple(spec)).devices_indices_map(tuple(shape))[self.rank]

    def shard_shape(self, spec: tuple, shape: tuple[int, ...]) -> tuple[int, ...]:
        """The shape of this rank's block (:meth:`shard_slices`)."""
        return tuple(len(range(*sl.indices(d)))
                     for sl, d in zip(self.shard_slices(spec, shape), shape))


# ---------------------------------------------------------------------------
# Resolution
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShardingContext:
    mesh: Any                                 # Mesh or ProcessMesh
    mode: str = "train"                       # key into ACT_RULES
    weight_overrides: dict = field(default_factory=dict)
    act_overrides: dict = field(default_factory=dict)
    # While a mesh train step runs, its ``repro_torch.train.ParamLayout``:
    # the model then reads its params as the rank's storage shards and
    # gathers each where it uses it (``repro_torch.models.layers.compute_params``).
    layout: Any = field(default=None, compare=False)

    def weight_rule(self, name: str):
        if name in self.weight_overrides:
            return self.weight_overrides[name]
        return WEIGHT_RULES.get(name)

    def act_rule(self, name: str):
        if name in self.act_overrides:
            return self.act_overrides[name]
        return ACT_RULES[self.mode].get(name)


_LOCAL = threading.local()


def current_context() -> Optional[ShardingContext]:
    return getattr(_LOCAL, "ctx", None)


@contextlib.contextmanager
def use_sharding(ctx: Optional[ShardingContext]):
    """Make ``ctx`` the current context of this thread for the block."""
    prev = current_context()
    _LOCAL.ctx = ctx
    try:
        yield ctx
    finally:
        _LOCAL.ctx = prev


def carry_context(fn):
    """``fn``, run under the context current now wherever it is called.

    The port runs eagerly, and autograd runs the backward of CUDA tensors
    (a remat'ed block's recompute among it) on a thread of its own, where
    this thread's context is not current: the blocks that
    ``torch.utils.checkpoint`` recomputes are wrapped in this."""
    ctx = current_context()
    if ctx is None:
        return fn

    def run(*args, **kwargs):
        with use_sharding(ctx):
            return fn(*args, **kwargs)

    return run


def _fit_axes(rule: Any, dim: int, mesh, taken: set[str], divisible: bool = True
              ) -> tuple[str, ...]:
    """Greedy left-to-right selection of mesh axes for one dimension.

    ``divisible=True`` for weights: an axis is taken only where it keeps
    the split divisible (the JAX package's jit argument shardings reject
    uneven dims).  Activations only need ``dim >= shards``."""
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
        ok = (dim % nxt == 0) if divisible else (dim >= nxt)
        if ok:
            out.append(ax)
            shards = nxt
            taken.add(ax)
    return tuple(out)


def resolve_spec(logical_axes: tuple, shape: tuple[int, ...], ctx: ShardingContext,
                 kind: str = "weight") -> tuple:
    """Map logical axes -> a spec tuple for a tensor of ``shape``, under
    the weight rules (``kind="weight"``: divisible splits, then the
    fallback pass) or the context's activation rules (any other kind:
    ``dim >= shards``), as the JAX package's ``resolve_spec``."""
    assert len(logical_axes) == len(shape), (logical_axes, shape)
    taken: set[str] = set()
    entries: list = []
    rule_fn = ctx.weight_rule if kind == "weight" else ctx.act_rule
    divisible = kind == "weight"
    for name, dim in zip(logical_axes, shape):
        rule = None if name is None else rule_fn(name)
        entries.append(list(_fit_axes(rule, dim, ctx.mesh, taken, divisible)))
    if divisible:
        # Fallback pass: keep weights fully sharded even when the natural
        # dim doesn't divide: place unused mesh axes on the largest
        # remaining divisible dim (a storage sharding, ZeRO-style).
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


def param_sharding(params: dict, specs: dict, ctx: ShardingContext) -> dict:
    """:class:`NamedSharding` per param of a flat (params, logical-spec)
    pair, read from the params' shapes (the JAX package's
    ``param_sharding``)."""
    return param_shardings(params, specs, ctx)


def mesh_of(devices, axes: tuple[str, ...] = ("data",),
            shape: Optional[tuple[int, ...]] = None) -> Mesh:
    """A :class:`Mesh` over ``devices`` (1-D over all of them by default)."""
    devices = tuple(devices)
    return Mesh(devices, tuple(axes), tuple(shape) if shape is not None else (len(devices),))


def constrain(x, logical_axes: tuple, src_axes: tuple):
    """Move the local tensor ``x`` from the layout of ``src_axes`` into the
    layout of ``logical_axes``, both resolved as activations under the
    current context (``jax.lax.with_sharding_constraint`` by logical
    axes); a no-op outside a context or where the two specs agree.

    On a :class:`ProcessMesh`, per dimension, the axes that the source
    spec has and the target lacks are all-gathered (minor first), then the
    axes the target adds are taken by a slice at this rank's coordinate:
    an all-gather toward replicated, a slice toward sharded.  Autograd
    transposes each move (a reduce-scatter, a zero pad).  The global
    shape is ``x``'s with every sharded dimension multiplied out; the
    port splits dimensions evenly only, and raises where the target
    would not."""
    ctx = current_context()
    if ctx is None:
        return x
    from repro_torch.parallel import collectives

    mesh = ctx.mesh
    sizes = mesh.axis_sizes()
    # the source layout at x's global shape: every axis its rules name
    # that the mesh has, taken greedily (what resolution gives when the
    # split is even)
    taken: set[str] = set()
    src = []
    for name in src_axes:
        rule = None if name is None else ctx.act_rule(name)
        axes = () if rule is None else ((rule,) if isinstance(rule, str) else tuple(rule))
        picked = tuple(a for a in axes if a in sizes and a not in taken)
        taken.update(picked)
        src.append(picked)
    shape = tuple(d * math.prod(sizes[a] for a in e) for d, e in zip(x.shape, src))
    if tuple(spec_axes(e) for e in resolve_spec(tuple(src_axes), shape, ctx, "act")) != tuple(src):
        raise ValueError(f"{tuple(x.shape)} is not an even split of {src_axes} on {sizes}")
    dst = [spec_axes(e) for e in resolve_spec(tuple(logical_axes), shape, ctx, "act")]
    return collectives.redistribute(x, mesh, tuple(src), tuple(dst))
