"""ReconfigEngine: the single owner of the reconfiguration pipeline.

The paper describes ONE cooperative pipeline (spawn rounds → tree sync →
binary connect → reorder → final intercomm, plus TS/ZS/SS shrinks); this
module is its single implementation point:

* a **strategy registry** — the built-in spawning strategies (SEQUENTIAL,
  SEQUENTIAL_PER_NODE, SINGLE, PARALLEL_HYPERCUBE, PARALLEL_DIFFUSIVE,
  plus the topology-aware ``topo`` and two-phase ``dmr-async`` specs)
  register themselves here, and third-party strategies can too, so the
  simulator, the elastic runtime, the trainer, and the benchmarks all
  dispatch through one table instead of hand-stitching strategy×method
  matrices;
* an **event timeline** — every plan is executed as an explicit list of
  typed stage events with start/end times charged by a ``CostModel``.
  ASYNC overlap is a *property of the timeline*: each event carries an
  ``overlap_fraction`` (how much of it can hide under application
  compute) and the timeline a contention factor, so downtime is never
  arithmetic re-derived per consumer.  Stage-3 data movement is a
  first-class term: events carry ``bytes_moved`` and the engine charges
  them through a pluggable *bytes model* (see ``ReconfigEngine``);
* an **execution protocol** — backends (the cost simulator, the live
  NodeGroup runtime) receive the same :class:`ReconfigPlan` objects and
  apply them to their substrate while the engine charges the timeline.

Stages map onto the paper: SPAWN (§4.1/§4.2), SYNC (§4.3), CONNECT
(§4.4), REORDER (§4.5 Eq. 9), FINAL (the sources↔children intercomm),
REDISTRIBUTION (stage 3), TERMINATE/ZOMBIFY/RESPAWN/TEARDOWN (§4.6-4.7
TS/ZS/SS shrink mechanisms), and CHECKPOINT/RESTORE (the full-stop
checkpoint/restart baseline malleability is measured against, plus
failure recovery from the last checkpoint).

Scope: timelines price what a reconfiguration *costs*.  What the
resulting allocation *earns* per application step — the other half of
the time-to-result trade — is priced by the companion
:mod:`repro_torch.malleability.throughput` step-time model, which the scenario
executors accrue between charged events.  Keeping the two scopes
separate means a shared :class:`TransitionCache` never depends on the
throughput model in force.
"""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable, Iterable, Optional, Protocol, Sequence, Union

from .connect import binary_connection_schedule, extend_graph_with_connection
from .diffusive import plan_diffusive
from .hypercube import plan_hypercube
from .reorder import global_order
from .sequential import plan_sequential
from .shrink import ClusterState
from .shrink import plan_shrink as _plan_shrink_actions
from .sync import EventGraph, build_sync_graph
from .topology import Topology, split_bytes_by_class
from .types import SOURCE_GID, Method, ShrinkKind, ShrinkPlan, SpawnPlan, Strategy

if TYPE_CHECKING:  # runtime import would be circular (malleability → core)
    from repro_torch.malleability.cost_model import CostModel


# =============================================================== timeline ==
class Stage(enum.Enum):
    """Typed reconfiguration stages (paper §4 + §4.6-4.7 shrinks)."""

    QUEUE = "queue"              # RMS arbitration: waiting behind an
    #                              in-flight reconfiguration (ours or a
    #                              co-scheduled job's) before stage 2 starts
    SPAWN = "spawn"
    SYNC = "sync"
    CONNECT = "connect"
    REORDER = "reorder"
    FINAL = "final"
    REDISTRIBUTION = "redistribution"
    TERMINATE = "terminate"      # TS: doomed node-confined worlds exit
    ZOMBIFY = "zombify"          # ZS: ranks sleep, nodes stay pinned
    RESPAWN = "respawn"          # SS: the replacement world comes up
    TEARDOWN = "teardown"        # SS: old world finalize + dealloc
    # Fault-tolerance stages (appended last: the vectorized layer's int8
    # stage codes follow declaration order, so earlier codes are stable).
    CHECKPOINT = "checkpoint"    # snapshot streamed to the checkpoint store
    RESTORE = "restore"          # snapshot read back from the store


@dataclass(frozen=True)
class TimelineEvent:
    """One charged stage interval on the reconfiguration timeline.

    ``overlap_fraction`` is the share of this event's work that can
    proceed under application compute when the job runs ASYNC (MaM's
    binary model is the special case 1.0 for spawn, 0.0 elsewhere).
    ``bytes_moved`` / ``bytes_stayed`` are the stage-3 data volumes this
    event accounts for per link — moved bytes cross devices, stayed
    bytes are re-validated on the device that already holds them —
    (non-zero only on REDISTRIBUTION events today).  ``bytes_cross_rack``
    is the portion of ``bytes_moved`` whose source and destination nodes
    sit in different racks of the engine's :class:`~repro_torch.core.topology
    .Topology` (0 without a topology: everything is one rack), and
    ``bytes_cross_pod`` the slice of that portion additionally crossing
    pods (0 unless the topology defines pods), so
    :attr:`bytes_by_class` recovers the full distance-class split.
    ``bytes_checkpointed`` is the snapshot volume streamed to the
    checkpoint store (non-zero only on CHECKPOINT events); RESTORE
    events carry the bytes read back in ``bytes_moved``/``bytes_stayed``
    (store traffic, excluded from the timeline's stage-3 byte sums).
    """

    stage: Stage
    start: float
    end: float
    label: str = ""
    overlap_fraction: float = 0.0
    bytes_moved: int = 0
    bytes_stayed: int = 0
    bytes_cross_rack: int = 0
    bytes_cross_pod: int = 0
    bytes_checkpointed: int = 0

    @property
    def bytes_by_class(self) -> dict[str, int]:
        """Stage-3 bytes per distance class (sums to stayed + moved)."""
        return split_bytes_by_class(self.bytes_stayed, self.bytes_moved,
                                    self.bytes_cross_rack,
                                    self.bytes_cross_pod)

    @property
    def duration(self) -> float:
        return self.end - self.start

    @property
    def overlappable(self) -> bool:
        """True when any part of this event can hide under compute."""
        return self.overlap_fraction > 0.0

    def hidden_under_compute(self, contention: float = 1.0) -> float:
        """Seconds of this event that ASYNC execution hides from the app.

        The hidden portion (``duration * overlap_fraction``) shares the
        network and launcher daemons with compute, so hiding a fraction
        ``f`` still costs ``f * (contention - 1)`` of the duration in
        lost application progress: the effective hidden time is
        ``duration * f * (2 - contention)``, clamped to ``[0, d*f]``.
        ``contention=1`` is perfect hiding; ``contention>=2`` means the
        overlap buys nothing.
        """
        f = min(max(self.overlap_fraction, 0.0), 1.0)
        eff = f * max(0.0, 2.0 - max(contention, 1.0))
        return self.duration * min(eff, f)


@dataclass(frozen=True)
class Timeline:
    """An executed plan: ordered stage events + derived cost queries.

    Both ``ExpansionReport.downtime`` and ``ReconfigRecord.downtime_s``
    read off this object, so the two layers cannot disagree.
    ``contention`` is the CostModel's overlap-contention factor, captured
    at build time so downtime queries need no cost model.
    """

    events: tuple[TimelineEvent, ...] = ()
    contention: float = 1.0

    @property
    def total(self) -> float:
        """Wall time of the whole reconfiguration."""
        return max((e.end for e in self.events), default=0.0)

    @property
    def bytes_moved(self) -> int:
        """Total stage-3 cross-link bytes charged across all events.

        RESTORE events are excluded from all four stage-3 sums: their
        bytes come off the checkpoint store, not a peer rank, and are
        reported separately as :attr:`bytes_restored`.
        """
        return sum(e.bytes_moved for e in self.events
                   if e.stage is not Stage.RESTORE)

    @property
    def bytes_stayed(self) -> int:
        """Total stage-3 local-link bytes charged across all events."""
        return sum(e.bytes_stayed for e in self.events
                   if e.stage is not Stage.RESTORE)

    @property
    def bytes_cross_rack(self) -> int:
        """Total stage-3 rack-crossing bytes charged across all events."""
        return sum(e.bytes_cross_rack for e in self.events
                   if e.stage is not Stage.RESTORE)

    @property
    def bytes_cross_pod(self) -> int:
        """Total stage-3 pod-crossing bytes charged across all events."""
        return sum(e.bytes_cross_pod for e in self.events
                   if e.stage is not Stage.RESTORE)

    @property
    def bytes_checkpointed(self) -> int:
        """Total snapshot bytes streamed to the checkpoint store."""
        return sum(e.bytes_checkpointed for e in self.events)

    @property
    def bytes_restored(self) -> int:
        """Total bytes read back from the store (RESTORE events)."""
        return sum(e.bytes_stayed + e.bytes_moved for e in self.events
                   if e.stage is Stage.RESTORE)

    @property
    def restored_s(self) -> float:
        """Seconds spent reading state back from the checkpoint store."""
        return self.span(Stage.RESTORE)

    @property
    def bytes_by_class(self) -> dict[str, int]:
        """Stage-3 bytes per distance class across all events."""
        return split_bytes_by_class(self.bytes_stayed, self.bytes_moved,
                                    self.bytes_cross_rack,
                                    self.bytes_cross_pod)

    @property
    def queued_s(self) -> float:
        """Seconds spent queued behind in-flight reconfigurations."""
        return self.span(Stage.QUEUE)

    def span(self, stage: Stage) -> float:
        """Summed duration of every event of ``stage``."""
        return sum(e.duration for e in self.events if e.stage is stage)

    def downtime(self, asynchronous: bool = False) -> float:
        """App-visible stall in seconds.

        Synchronous jobs stall for the whole timeline.  ASYNC jobs hide
        each event's ``overlap_fraction`` under compute, degraded by the
        timeline's contention factor (see
        :meth:`TimelineEvent.hidden_under_compute`).  QUEUE spans are
        never downtime: while a reconfiguration waits its turn the job
        keeps stepping at its current size (they do count toward
        ``total``, the makespan view).
        """
        if not asynchronous:
            return self.total - self.queued_s
        return self.total - self.queued_s - sum(
            e.hidden_under_compute(self.contention)
            for e in self.events
            if e.stage is not Stage.QUEUE
        )

    def as_rows(self) -> list[dict]:
        """Timeline as plain dict rows (for tables/CSV)."""
        return [
            {
                "stage": e.stage.value,
                "label": e.label,
                "start_s": e.start,
                "end_s": e.end,
                "duration_s": e.duration,
                "overlap_fraction": e.overlap_fraction,
                "overlappable": e.overlappable,
                "bytes_moved": e.bytes_moved,
                "bytes_stayed": e.bytes_stayed,
                "bytes_cross_rack": e.bytes_cross_rack,
                "bytes_cross_pod": e.bytes_cross_pod,
                "bytes_checkpointed": e.bytes_checkpointed,
            }
            for e in self.events
        ]


class _TimelineBuilder:
    """Appends events back-to-back (the pipeline stages are serial)."""

    def __init__(self, contention: float = 1.0) -> None:
        self._events: list[TimelineEvent] = []
        self._t = 0.0
        self._contention = contention

    def add(self, stage: Stage, duration: float, label: str = "",
            overlap_fraction: float = 0.0, bytes_moved: int = 0,
            bytes_stayed: int = 0, bytes_cross_rack: int = 0,
            bytes_cross_pod: int = 0, bytes_checkpointed: int = 0) -> None:
        if duration <= 0.0:
            return
        self._events.append(
            TimelineEvent(stage, self._t, self._t + duration, label,
                          overlap_fraction, bytes_moved, bytes_stayed,
                          bytes_cross_rack, bytes_cross_pod,
                          bytes_checkpointed)
        )
        self._t += duration

    def extend(self, events: Sequence[TimelineEvent]) -> None:
        for e in events:
            self.add(e.stage, e.duration, e.label, e.overlap_fraction,
                     e.bytes_moved, e.bytes_stayed, e.bytes_cross_rack,
                     e.bytes_cross_pod, e.bytes_checkpointed)

    def build(self) -> Timeline:
        return Timeline(events=tuple(self._events), contention=self._contention)


# ======================================================= strategy registry ==
PlannerFn = Callable[[int, int, Union[int, Sequence[int]], Method], SpawnPlan]

StrategyLike = Union[Strategy, str]


@dataclass(frozen=True)
class StrategySpec:
    """One registered spawning strategy.

    ``planner`` has the normalized signature ``(ns, nt, cores, method)``
    where ``cores`` is either C (homogeneous cores-per-node) or the
    per-node A vector.  ``topology_aware`` strategies additionally drive
    *placement*: when the engine carries a :class:`~repro_torch.core.topology
    .Topology`, :meth:`ReconfigEngine.select_expansion_nodes` places
    their expansion groups rack-local-first and
    :meth:`ReconfigEngine.select_release_nodes` shrinks them so whole
    racks are vacated; topology-blind strategies keep the greedy
    lowest-id / highest-id orders.
    """

    key: str                      # registry key, e.g. "hypercube"
    planner: PlannerFn
    parallel: bool = False        # pays sync/connect/reorder phases (§4.3-4.5)
    homogeneous_only: bool = False
    topology_aware: bool = False  # placement honours the engine's Topology
    two_phase: bool = False       # DMR-style async grant acceptance: the
    #                               spawn/sync/connect legs of an expansion
    #                               fully overlap compute (phase 1), only the
    #                               commit (reorder/final/redistribution)
    #                               stays on the critical path
    description: str = ""


_STRATEGY_REGISTRY: dict[str, StrategySpec] = {}


def strategy_key(strategy: StrategyLike) -> str:
    """Normalize a Strategy enum or plain string to its registry key."""
    return strategy.value if isinstance(strategy, Strategy) else str(strategy)


def register_strategy(spec: StrategySpec, *, overwrite: bool = False) -> StrategySpec:
    """Register a spawning strategy (third-party strategies welcome).

    Args:
        spec: the strategy spec; ``spec.key`` becomes the registry key.
        overwrite: replace an existing entry instead of raising.
    Returns:
        The spec, for chaining.
    Raises:
        ValueError: on a duplicate key without ``overwrite``.
    """
    if spec.key in _STRATEGY_REGISTRY and not overwrite:
        raise ValueError(f"strategy {spec.key!r} already registered")
    _STRATEGY_REGISTRY[spec.key] = spec
    return spec


def get_strategy(strategy: StrategyLike) -> StrategySpec:
    """Look up a registered spec by enum or key (KeyError lists known)."""
    key = strategy_key(strategy)
    try:
        return _STRATEGY_REGISTRY[key]
    except KeyError:
        raise KeyError(
            f"unknown strategy {key!r}; registered: {sorted(_STRATEGY_REGISTRY)}"
        ) from None


def registered_strategies() -> tuple[StrategySpec, ...]:
    """All specs in registration order (built-ins first)."""
    return tuple(_STRATEGY_REGISTRY.values())


# ---- cores normalization helpers -------------------------------------------
def as_core_vector(cores: Union[int, Sequence[int]], nt: int) -> list[int]:
    """C scalar -> per-node A vector wide enough for NT ranks.

    Args:
        cores: homogeneous cores-per-node C, or an explicit A vector
            (returned as a list unchanged).
        nt: target rank count the vector must cover.
    Returns:
        The per-node allocation vector.
    """
    if isinstance(cores, int):
        n_nodes = -(-nt // cores)
        return [cores] * n_nodes
    return [int(c) for c in cores]


def running_vector(a_vec: Sequence[int], ns: int) -> list[int]:
    """Pack the NS sources greedily into the allocation vector (R).

    Args:
        a_vec: per-node allocation vector A.
        ns: number of currently running source ranks.
    Returns:
        Per-node running counts R (same length prefix semantics as A).
    Raises:
        ValueError: if the sources do not fit in A.
    """
    out = []
    remaining = ns
    for a in a_vec:
        take = min(a, remaining)
        out.append(take)
        remaining -= take
    if remaining:
        raise ValueError("sources do not fit in the allocation vector")
    return out


def _cross_share(total: int, parts: Sequence[tuple[int, bool]]) -> int:
    """Portion of ``total`` bytes belonging to the cross-marked parts.

    ``parts`` is ``(weight, is_cross)`` per destination, in a
    deterministic order; ``total`` is distributed proportionally to the
    weights with exact integer arithmetic (cumulative shares), so the
    cross and non-cross portions always sum to ``total`` — the invariant
    the ``bytes_by_class`` reports rely on.
    """
    weight_sum = sum(w for w, _ in parts)
    if total <= 0 or weight_sum <= 0:
        return 0
    out = 0
    cum = 0
    prev = 0
    for w, is_cross in parts:
        cum += w
        share = total * cum // weight_sum
        if is_cross:
            out += share - prev
        prev = share
    return out


def _class_shares(total: int,
                  parts: Sequence[tuple[int, int]]) -> tuple[int, int]:
    """Rack- and pod-crossing portions of ``total`` bytes.

    Three-way generalization of :func:`_cross_share`: ``parts`` is
    ``(weight, category)`` per destination where category 0 is
    rack-local, 1 crosses racks inside the pod, and 2 crosses pods.
    The cumulative integer boundaries are identical to
    :func:`_cross_share` with ``is_cross = category >= 1``, so the
    returned ``cross_rack`` total is bit-for-bit what the 2-way split
    reported, and ``cross_pod <= cross_rack`` always holds (the pod
    share is a refinement of the rack share).
    """
    weight_sum = sum(w for w, _ in parts)
    if total <= 0 or weight_sum <= 0:
        return 0, 0
    xrack = 0
    xpod = 0
    cum = 0
    prev = 0
    for w, cat in parts:
        cum += w
        share = total * cum // weight_sum
        if cat >= 1:
            xrack += share - prev
        if cat >= 2:
            xpod += share - prev
        prev = share
    return xrack, xpod


def _as_homogeneous(cores: Union[int, Sequence[int]]) -> int:
    if isinstance(cores, int):
        return cores
    widths = {int(c) for c in cores}
    if len(widths) != 1:
        raise ValueError(
            "hypercube strategy requires homogeneous allocations; "
            "use PARALLEL_DIFFUSIVE (paper §4.2)"
        )
    return widths.pop()


# ---- built-in planners (normalized signatures) ------------------------------
def _plan_seq(ns: int, nt: int, cores, method: Method) -> SpawnPlan:
    return plan_sequential(ns, nt, as_core_vector(cores, nt), method)


def _plan_per_node(ns: int, nt: int, cores, method: Method) -> SpawnPlan:
    return plan_sequential(ns, nt, as_core_vector(cores, nt), method, per_node=True)


def _plan_single(ns: int, nt: int, cores, method: Method) -> SpawnPlan:
    return plan_sequential(ns, nt, as_core_vector(cores, nt), method, single=True)


def _plan_hypercube(ns: int, nt: int, cores, method: Method) -> SpawnPlan:
    return plan_hypercube(ns, nt, _as_homogeneous(cores), method)


def _plan_diffusive(ns: int, nt: int, cores, method: Method) -> SpawnPlan:
    a_vec = as_core_vector(cores, nt)
    return plan_diffusive(a_vec, running_vector(a_vec, ns), method)


register_strategy(StrategySpec(
    key=Strategy.SEQUENTIAL.value, planner=_plan_seq,
    description="one collective spawn; multi-node world (classic Merge)"))
register_strategy(StrategySpec(
    key=Strategy.SEQUENTIAL_PER_NODE.value, planner=_plan_per_node,
    description="one spawn per node, serial ([14]); O(nodes) latency"))
register_strategy(StrategySpec(
    key=Strategy.SINGLE.value, planner=_plan_single,
    description="rank 0 spawns alone, informs the rest (MaM Single)"))
register_strategy(StrategySpec(
    key=Strategy.PARALLEL_HYPERCUBE.value, planner=_plan_hypercube,
    parallel=True, homogeneous_only=True,
    description="§4.1 hypercube: (C+1)^s growth, homogeneous pools"))
register_strategy(StrategySpec(
    key=Strategy.PARALLEL_DIFFUSIVE.value, planner=_plan_diffusive,
    parallel=True,
    description="§4.2 iterative diffusive: heterogeneous pools"))


# ================================================================== plans ==
@dataclass(frozen=True)
class RedistributionSpec:
    """Stage-3 data movement: which final ranks receive which data shards.

    ``layout`` maps final global rank -> (group_id, local_rank); the
    elastic runtime turns this into a device permutation + resharding
    plan; the simulator charges bytes/bandwidth for it.

    ``bytes_total`` is the resolved cross-link data volume for THIS
    event (from the engine's bytes model, or ``bytes_per_rank *
    |nt - ns|`` as the scalar fallback); it is what the timeline charges
    as a REDISTRIBUTION event and what ``bytes_moved`` reports read.
    ``bytes_stayed`` is the local-link volume (shards a surviving device
    already holds) when the bytes model reports the per-link split —
    moved-bytes-only models leave it 0 and reproduce the aggregate
    single-bandwidth charge exactly.  ``bytes_cross_rack`` is the part
    of ``bytes_total`` resolved (against the engine's topology and the
    plan's node placement) to cross racks; 0 without a topology.
    ``bytes_cross_pod`` is the slice of that portion additionally
    crossing pods; 0 unless the topology defines pods.
    """

    layout: tuple[tuple[int, int], ...]
    ns: int
    nt: int
    bytes_per_rank: int = 0
    bytes_total: int = 0
    bytes_stayed: int = 0
    bytes_cross_rack: int = 0
    bytes_cross_pod: int = 0

    @property
    def bytes_by_class(self) -> dict[str, int]:
        """Stage-3 bytes per distance class (sums to stayed + total)."""
        return split_bytes_by_class(self.bytes_stayed, self.bytes_total,
                                    self.bytes_cross_rack,
                                    self.bytes_cross_pod)


@dataclass(frozen=True)
class CheckpointSpec:
    """Checkpoint-store traffic of one reconfiguration.

    ``bytes_checkpointed`` is the snapshot streamed TO the store
    (charged as a CHECKPOINT event, hidden under compute by
    ``cm.ckpt_overlap`` when the job runs ASYNC); ``bytes_restored`` is
    read BACK from it (a RESTORE event — always on the critical path:
    the app is down until its state is back).  Restore bytes are charged
    on the cross link without a distance-class split: the store is a
    shared filesystem outside the rack tree.
    """

    bytes_checkpointed: int = 0
    bytes_restored: int = 0


@dataclass(frozen=True)
class ReconfigPlan:
    """Full output of the process-management stage.

    Self-contained: carries everything a backend or the timeline builder
    needs (including doomed world sizes for shrink charging), so it can
    be executed by any backend without consulting cluster state again.
    """

    kind: str                      # "expand" | "shrink" | "checkpoint"
    #                              # | "restart" | "noop"
    method: Method
    strategy: StrategyLike
    asynchronous: bool
    ns: int = 0
    nt: int = 0
    spawn: Optional[SpawnPlan] = None
    shrink: Optional[ShrinkPlan] = None
    sync_graph: Optional[EventGraph] = None
    connect_rounds: int = 0
    redistribution: Optional[RedistributionSpec] = None
    shrink_world_sizes: tuple[int, ...] = ()   # sizes of TS-doomed worlds
    queue_delay_s: float = 0.0     # RMS arbitration wait before stage 2
    # Cluster node id of each allocation-vector entry (expansions):
    # ``node_ids[i]`` is where A-vector slot ``i`` lives.  Backends
    # acquire the plan's NEW nodes from this list (in order) instead of
    # greedily, which is what makes placement a priced, first-class
    # decision; empty means "no explicit placement" (greedy fallback).
    node_ids: tuple[int, ...] = ()
    # Checkpoint-store traffic: set on "checkpoint"/"restart" plans and
    # on failure shrinks that recover from the last checkpoint.
    checkpoint: Optional[CheckpointSpec] = None


@dataclass(frozen=True)
class ReconfigOutcome:
    """One executed reconfiguration: the plan + its charged timeline."""

    plan: ReconfigPlan
    timeline: Timeline

    @property
    def total_s(self) -> float:
        """Timeline wall time in seconds."""
        return self.timeline.total

    @property
    def downtime_s(self) -> float:
        """App-visible stall (honours the plan's ASYNC flag)."""
        return self.timeline.downtime(self.plan.asynchronous)

    @property
    def bytes_moved(self) -> int:
        """Stage-3 cross-link bytes charged on the timeline."""
        return self.timeline.bytes_moved

    @property
    def bytes_stayed(self) -> int:
        """Stage-3 local-link bytes charged on the timeline."""
        return self.timeline.bytes_stayed

    @property
    def bytes_cross_rack(self) -> int:
        """Stage-3 rack-crossing bytes charged on the timeline."""
        return self.timeline.bytes_cross_rack

    @property
    def bytes_cross_pod(self) -> int:
        """Stage-3 pod-crossing bytes charged on the timeline."""
        return self.timeline.bytes_cross_pod

    @property
    def bytes_by_class(self) -> dict[str, int]:
        """Stage-3 bytes per distance class charged on the timeline."""
        return self.timeline.bytes_by_class

    @property
    def queued_s(self) -> float:
        """RMS arbitration wait charged on the timeline (QUEUE spans)."""
        return self.timeline.queued_s

    @property
    def bytes_checkpointed(self) -> int:
        """Snapshot bytes streamed to the checkpoint store."""
        return self.timeline.bytes_checkpointed

    @property
    def bytes_restored(self) -> int:
        """Bytes read back from the store (RESTORE events)."""
        return self.timeline.bytes_restored

    @property
    def restored_s(self) -> float:
        """Seconds spent in RESTORE events."""
        return self.timeline.restored_s


class ExecutionBackend(Protocol):
    """A substrate that applies plans (live NodeGroups, bookkeeping, ...)."""

    def apply_expand(self, plan: ReconfigPlan) -> None: ...

    def apply_shrink(self, plan: ReconfigPlan) -> None: ...


# ======================================================= timeline builders ==
def _is_parallel(plan: SpawnPlan) -> bool:
    if isinstance(plan.strategy, Strategy):
        spec = _STRATEGY_REGISTRY.get(plan.strategy.value)
    else:  # third-party plans carry their registry key
        spec = _STRATEGY_REGISTRY.get(str(plan.strategy))
    if spec is not None:
        return spec.parallel
    return plan.strategy in (Strategy.PARALLEL_HYPERCUBE, Strategy.PARALLEL_DIFFUSIVE)


def _spawn_events(tb: _TimelineBuilder, plan: SpawnPlan, cm: "CostModel",
                  topology: Optional[Topology] = None,
                  node_ids: Sequence[int] = ()) -> None:
    """Spawn phase per strategy; events overlap by ``cm.spawn_overlap``.

    When the cost model prices spawn by topology (``gamma_rack`` /
    ``gamma_pod`` set) AND the caller supplies the cluster layout plus
    the plan's slot -> node placement, every launcher-tree edge is
    charged a distance penalty: the class between the SPAWNING rank's
    node and the target node (stages 1-2 are no longer a flat latency).
    Unpriced models — or plans without explicit placement — take the
    historical arithmetic verbatim, so existing numbers are bit-for-bit
    unchanged.
    """
    if not plan.groups:
        return
    f = cm.spawn_overlap
    priced = (topology is not None and len(node_ids) > 0
              and cm.spawn_topology_priced)

    def _node(slot: int) -> Optional[int]:
        return node_ids[slot] if 0 <= slot < len(node_ids) else None

    root_slot = next((i for i, r in enumerate(plan.running) if r > 0), 0)

    def _penalty(parent_slot: int, child_slot: int) -> float:
        assert topology is not None
        pn, cn = _node(parent_slot), _node(child_slot)
        if pn is None or cn is None:
            return 0.0
        return cm.spawn_distance_penalty(topology.distance_class(pn, cn))

    if plan.strategy in (Strategy.SEQUENTIAL, Strategy.SINGLE):
        g = plan.groups[0]
        dur = cm.spawn_call(g.size, len(g.nodes_spanned()))
        if priced:
            # One collective launch rooted at the sources: the call waits
            # for its farthest target node.
            dur += max(
                (_penalty(root_slot, slot) for slot in g.nodes_spanned()),
                default=0.0,
            )
        if plan.strategy is Strategy.SINGLE:
            # rank 0 informs the rest afterwards (MaM Single strategy)
            dur += cm.t_token * math.ceil(math.log2(max(plan.ns, 2)))
        tb.add(Stage.SPAWN, dur, label="collective spawn", overlap_fraction=f)
        return
    if plan.strategy is Strategy.SEQUENTIAL_PER_NODE:
        for g in plan.groups:
            dur = cm.spawn_call(g.size, 1)
            if priced:
                dur += _penalty(root_slot, g.node)
            tb.add(Stage.SPAWN, dur,
                   label=f"spawn node {g.node}", overlap_fraction=f)
        return
    # Parallel strategies: rounds of concurrent single-node spawns.
    by_gid = {g.gid: g for g in plan.groups}

    def _parent_slot(g) -> int:
        if g.parent_gid == SOURCE_GID:
            return root_slot
        parent = by_gid.get(g.parent_gid)
        return parent.node if parent is not None else root_slot

    initial_nodes = sum(1 for r in plan.running if r > 0)
    for s in range(1, plan.steps + 1):
        round_groups = plan.groups_in_step(s)
        if not round_groups:
            continue
        oversub = plan.method is Method.BASELINE and any(
            g.node < initial_nodes for g in round_groups
        )
        if priced:
            dur = cm.concurrent_round_priced(
                [(g.size, 1, _penalty(_parent_slot(g), g.node))
                 for g in round_groups],
                oversubscribed=oversub,
            )
        else:
            dur = cm.concurrent_round(
                [(g.size, 1) for g in round_groups], oversubscribed=oversub
            )
        tb.add(Stage.SPAWN, dur, label=f"round {s} ({len(round_groups)} groups)",
               overlap_fraction=f)


def _sync_event(tb: _TimelineBuilder, plan: SpawnPlan, cm: "CostModel") -> None:
    """§4.3 three-stage synchronization along the spawn tree.

    Critical path: deepest leaf sends up through ``depth`` levels (token +
    per-group barrier each), source barriers, then the release token walks
    back down the same depth.
    """
    if not _is_parallel(plan) or not plan.groups:
        return
    depth = plan.steps
    max_group = max(plan.group_sizes)
    per_level = cm.t_token + cm.barrier(max_group) + cm.comm_split(max_group)
    ports = cm.t_port  # opened concurrently by all acceptor roots
    dur = ports + per_level + depth * 2 * (cm.t_token + cm.barrier(max_group))
    tb.add(Stage.SYNC, dur, label=f"tree sync depth {depth}",
           overlap_fraction=cm.sync_overlap)


def _connect_events(tb: _TimelineBuilder, plan: SpawnPlan, cm: "CostModel") -> None:
    """§4.4 binary connection: ceil(log2 G) rounds of pairwise merges."""
    if not _is_parallel(plan):
        return
    sizes = {g.gid: g.size for g in plan.groups}
    for i, rnd in enumerate(binary_connection_schedule(len(plan.groups))):
        round_cost = 0.0
        for acc, conn in rnd.pairs:
            merged = sizes[acc] + sizes[conn]
            round_cost = max(round_cost, cm.connect_merge(merged))
            sizes[acc] = merged
            del sizes[conn]
        tb.add(Stage.CONNECT, round_cost,
               label=f"connect round {i + 1} ({len(rnd.pairs)} merges)",
               overlap_fraction=cm.connect_overlap)


def expansion_timeline(
    plan: SpawnPlan, cm: "CostModel", bytes_total: int = 0,
    queue_delay_s: float = 0.0, bytes_stayed: int = 0,
    bytes_cross_rack: int = 0, bytes_cross_pod: int = 0,
    topology: Optional[Topology] = None,
    node_ids: Sequence[int] = (),
) -> Timeline:
    """Charge one expansion as the paper's serial stage pipeline.

    Args:
        plan: the spawn plan to execute.
        cm: latency/bandwidth model (also supplies per-stage overlap
            fractions and the contention factor).
        bytes_total: stage-3 cross-link data volume; when positive a
            REDISTRIBUTION event carrying ``bytes_moved`` is appended.
        queue_delay_s: RMS arbitration wait before stage 2 starts (an
            in-flight reconfiguration must drain first); charged as a
            leading QUEUE event that counts toward ``total`` but never
            toward downtime.
        bytes_stayed: stage-3 local-link volume (shards surviving
            devices already hold), charged against ``cm.bw_local``.
        bytes_cross_rack: the rack-crossing portion of ``bytes_total``,
            charged against ``cm.bw_cross_rack`` (the rest rides the
            intra-rack link).
        bytes_cross_pod: the pod-crossing slice of ``bytes_cross_rack``,
            charged against ``cm.bw_cross_pod``.
        topology: cluster layout for topology-priced spawn (stages 1-2
            launcher-tree edges charged by distance class); only
            consulted when ``cm.spawn_topology_priced`` is set.
        node_ids: cluster node id per allocation-vector slot (see
            :class:`ReconfigPlan`); required for topology-priced spawn.
    Returns:
        The charged :class:`Timeline`.
    """
    tb = _TimelineBuilder(contention=cm.overlap_contention)
    if queue_delay_s > 0.0:
        tb.add(Stage.QUEUE, queue_delay_s, label="queued behind in-flight reconfig")
    _spawn_events(tb, plan, cm, topology=topology, node_ids=node_ids)
    _sync_event(tb, plan, cm)
    _connect_events(tb, plan, cm)
    parallel = _is_parallel(plan)
    if parallel:
        tb.add(Stage.REORDER, cm.comm_split(sum(plan.group_sizes)),
               label="Eq. 9 reorder split")
    # Final sources<->children intercomm (all strategies pay a merge of the
    # full target world; the classic strategies do it inside the spawn call
    # via the intercommunicator MPI_Comm_spawn returns).
    final = cm.connect_merge(plan.nt) if parallel else cm.beta_connect * plan.nt
    tb.add(Stage.FINAL, final, label="final intercomm merge")
    _redistribution_event(tb, cm, bytes_total, bytes_stayed, bytes_cross_rack,
                          bytes_cross_pod)
    return tb.build()


def _redistribution_event(tb: _TimelineBuilder, cm: "CostModel",
                          bytes_total: int, bytes_stayed: int,
                          bytes_cross_rack: int = 0,
                          bytes_cross_pod: int = 0) -> None:
    """Append the stage-3 event, priced per distance class (no bytes,
    no event)."""
    if bytes_total <= 0 and bytes_stayed <= 0:
        return
    xrack = min(max(0, bytes_cross_rack), max(0, bytes_total))
    xpod = min(max(0, bytes_cross_pod), xrack)
    if xrack > 0:
        label = (f"redistribute {bytes_total - xrack} B intra-rack + "
                 f"{xrack} B cross-rack + {max(0, bytes_stayed)} B local")
        if xpod > 0:
            label += f" ({xpod} B of it cross-pod)"
    elif bytes_stayed > 0:
        label = f"redistribute {bytes_total} B cross + {bytes_stayed} B local"
    else:
        label = f"redistribute {bytes_total} B"
    tb.add(Stage.REDISTRIBUTION,
           cm.redistribution(bytes_total, bytes_stayed, xrack, xpod),
           label=label, overlap_fraction=cm.redist_overlap,
           bytes_moved=bytes_total, bytes_stayed=max(0, bytes_stayed),
           bytes_cross_rack=xrack, bytes_cross_pod=xpod)


def _checkpoint_event(tb: _TimelineBuilder, cm: "CostModel",
                      snapshot_bytes: int) -> None:
    """Append the store-write event (no bytes, no event)."""
    if snapshot_bytes <= 0:
        return
    tb.add(Stage.CHECKPOINT, cm.checkpoint(snapshot_bytes),
           label=f"checkpoint {snapshot_bytes} B",
           overlap_fraction=cm.ckpt_overlap,
           bytes_checkpointed=snapshot_bytes)


def _restore_event(tb: _TimelineBuilder, cm: "CostModel",
                   restore_bytes: int) -> None:
    """Append the store-read event (no bytes, no event).

    The bytes ride the event's ``bytes_moved`` slot but the store sits
    outside the rack tree, so no distance-class split is attempted and
    the Timeline reports them as ``bytes_restored``, not stage-3 moved
    bytes.  Restores never overlap compute: the app is down until its
    state is back.
    """
    if restore_bytes <= 0:
        return
    tb.add(Stage.RESTORE, cm.restore(restore_bytes),
           label=f"restore {restore_bytes} B from checkpoint",
           bytes_moved=restore_bytes)


def shrink_timeline(
    kind: ShrinkKind,
    cm: "CostModel",
    *,
    ns: int = 0,
    nt: int = 0,
    doomed_world_sizes: Optional[Sequence[int]] = None,
    respawn_plan: Optional[SpawnPlan] = None,
    bytes_total: int = 0,
    queue_delay_s: float = 0.0,
    bytes_stayed: int = 0,
    bytes_cross_rack: int = 0,
    bytes_cross_pod: int = 0,
    restore_bytes: int = 0,
) -> Timeline:
    """Charge one shrink by mechanism (§4.6-4.7).

    * TS — release tokens to doomed worlds; they exit; root updates its
      structure.  No spawning at all (the paper's headline).
    * ZS — same token path, but ranks only go to sleep; nodes stay pinned.
    * SS — the Baseline path: spawn the NT-sized world (optionally with a
      parallel strategy: pass ``respawn_plan``), tear the old world down.

    ``bytes_total`` > 0 (cross link) or ``bytes_stayed`` > 0 (local
    link) appends a REDISTRIBUTION event (survivors absorb the doomed
    ranks' shards) after the mechanism's own events.
    ``queue_delay_s`` > 0 prepends a QUEUE event (RMS arbitration wait,
    e.g. a preemption arriving while another reconfiguration is in
    flight) that counts toward ``total`` but never toward downtime.
    ``restore_bytes`` > 0 appends a trailing RESTORE event: the shrink
    is a node *failure* and the survivors re-read the lost shards from
    the last checkpoint instead of receiving them from the (dead) doomed
    ranks.
    """
    tb = _TimelineBuilder(contention=cm.overlap_contention)
    if queue_delay_s > 0.0:
        tb.add(Stage.QUEUE, queue_delay_s, label="queued behind in-flight reconfig")
    doomed = list(doomed_world_sizes or [])
    if kind is ShrinkKind.TS:
        dur = cm.ts_terminate(doomed or [1]) + cm.t_token
        tb.add(Stage.TERMINATE, dur,
               label=f"TS terminate {len(doomed) or 1} worlds")
    elif kind is ShrinkKind.ZS:
        tb.add(Stage.ZOMBIFY, cm.t_token * 2, label="ZS mark + ack")
    else:  # SS
        if respawn_plan is not None:
            tb.extend(expansion_timeline(respawn_plan, cm).events)
            tb.add(Stage.TEARDOWN, cm.t_teardown_per_proc * ns,
                   label="old world finalize")
        else:
            # No respawn plan: estimate the target node count from the doomed
            # world widths (worlds are node-confined, so a world size is a
            # node width); with no width information degenerate to 1
            # proc/node.
            width = max(doomed) if doomed else 1
            tb.add(
                Stage.RESPAWN,
                cm.ss_respawn(nt, max(1, -(-nt // width)), ns),
                label="SS respawn",
            )
    _redistribution_event(tb, cm, bytes_total, bytes_stayed, bytes_cross_rack,
                          bytes_cross_pod)
    _restore_event(tb, cm, restore_bytes)
    return tb.build()


def checkpoint_timeline(
    cm: "CostModel", *, snapshot_bytes: int, queue_delay_s: float = 0.0
) -> Timeline:
    """Charge one standalone checkpoint: a single CHECKPOINT event.

    The write streams to the store at ``cm.bw_ckpt`` after the
    ``cm.alpha_ckpt`` setup; ``cm.ckpt_overlap`` of it hides under
    compute when the job runs ASYNC (the snapshot is a host copy, the
    write happens behind the step loop).
    """
    tb = _TimelineBuilder(contention=cm.overlap_contention)
    if queue_delay_s > 0.0:
        tb.add(Stage.QUEUE, queue_delay_s, label="queued behind in-flight reconfig")
    _checkpoint_event(tb, cm, snapshot_bytes)
    return tb.build()


def restart_timeline(
    cm: "CostModel",
    *,
    ns: int,
    nt: int,
    nodes: int,
    snapshot_bytes: int,
    restore_bytes: int,
    queue_delay_s: float = 0.0,
) -> Timeline:
    """Charge one full-stop checkpoint/restart — the rigid baseline.

    The application checkpoints, stops entirely, is respawned at the
    target size, and reads its state back:

    * CHECKPOINT — ``snapshot_bytes`` streamed to the store (only this
      leg can hide under compute, by ``cm.ckpt_overlap``);
    * RESPAWN — one SS full-stop respawn charge
      (:meth:`CostModel.ss_respawn`: spawn the NT-sized world over
      ``nodes`` nodes + tear the NS-sized old world down + the world
      split — teardown is *inside* the formula, so no separate TEARDOWN
      event is charged);
    * RESTORE — ``restore_bytes`` read back from the store onto the new
      world, always on the critical path.

    This is what malleable shrinks are measured against: same start and
    end allocation, but the whole state makes a store round-trip and
    every rank restarts.
    """
    tb = _TimelineBuilder(contention=cm.overlap_contention)
    if queue_delay_s > 0.0:
        tb.add(Stage.QUEUE, queue_delay_s, label="queued behind in-flight reconfig")
    _checkpoint_event(tb, cm, snapshot_bytes)
    tb.add(Stage.RESPAWN, cm.ss_respawn(nt, max(1, nodes), ns),
           label=f"full-stop respawn {ns} -> {nt} ranks")
    _restore_event(tb, cm, restore_bytes)
    return tb.build()


# ================================================================== engine ==
@dataclass
class ReconfigEngine:
    """Plans and executes reconfigurations through the strategy registry.

    One engine per job.  All four consumer layers sit on top of it:
    :class:`repro_torch.core.MalleabilityManager` (facade),
    :mod:`repro_torch.malleability.simulator` (timeline-charging backend),
    :class:`repro_torch.elastic.ElasticRuntime` (live NodeGroup backend), and
    the benchmark drivers (registry iteration).
    """

    method: Method = Method.MERGE
    strategy: StrategyLike = Strategy.PARALLEL_HYPERCUBE
    asynchronous: bool = False
    bytes_per_rank: int = 0
    cost_model: Optional["CostModel"] = None
    # Cluster layout (node -> rack -> pod).  When set, stage-3 bytes are
    # resolved to the distance class between their source and
    # destination nodes (intra_node / intra_rack / cross_rack) and
    # topology-aware strategies place expansions rack-local-first and
    # shrink whole racks (see select_expansion_nodes /
    # select_release_nodes).  None behaves as a single rack: every moved
    # byte is intra_rack, reproducing the 2-class local/cross pricing.
    topology: Optional[Topology] = None
    # Stage-3 bytes model: ``f(ns_ranks, nt_ranks) -> bytes_moved`` (an
    # int charged on the cross link), or — for per-link pricing — a
    # mapping with ``bytes_stayed`` / ``bytes_moved`` keys (the
    # ``predicted_transfer_stats`` shape); a model exposing a ``stats``
    # attribute (e.g. repro_torch.elastic.reshard.PytreeBytesModel) is asked
    # through it.  Analytic device-free models live in
    # repro_torch.malleability.cost_model (replicated_bytes_model /
    # fsdp_bytes_model / replicated_link_model).  When None the scalar
    # ``bytes_per_rank`` fallback is charged instead.
    bytes_model: Optional[Callable[[int, int], Union[int, dict]]] = None
    # Fault tolerance: when True, failure shrinks (``plan_shrink(...,
    # failed=True)``) append a RESTORE event — the survivors re-read the
    # lost shards from the last checkpoint (the dead ranks cannot ship
    # them) — priced through :meth:`restore_bytes_on_fail`.  False keeps
    # failures priced exactly like voluntary shrinks (the historical
    # behaviour, bit for bit).
    restore_on_fail: bool = False

    def __post_init__(self) -> None:
        if self.cost_model is None:
            # Runtime-local import: core must stay importable without
            # triggering the malleability package at module load.
            from repro_torch.malleability.cost_model import MN5

            self.cost_model = MN5

    # ------------------------------------------------------------ placement --
    def select_expansion_nodes(
        self,
        used: Iterable[int],
        free: Iterable[int],
        need: int,
        *,
        strategy: Optional[StrategyLike] = None,
    ) -> list[int]:
        """Pick which free nodes an expansion acquires, in fill order.

        Topology-aware strategies (with a topology configured) place
        rack-local-first and pack fresh racks whole (see
        :func:`repro_torch.core.topo.place_rack_local`); everything else keeps
        the greedy lowest-id order both backends have always used, so
        plans and timelines are unchanged for existing strategies.
        """
        spec = get_strategy(strategy if strategy is not None else self.strategy)
        if self.topology is not None and spec.topology_aware:
            from .topo import place_rack_local

            return place_rack_local(self.topology, set(used), set(free), need)
        return sorted(free)[:need]

    def select_release_nodes(
        self,
        used: Iterable[int],
        n_release: int,
        *,
        strategy: Optional[StrategyLike] = None,
    ) -> list[int]:
        """Pick which nodes a target-count shrink returns to the RMS.

        Topology-aware strategies vacate whole racks first (see
        :func:`repro_torch.core.topo.vacate_racks`); everything else releases
        the highest node ids, the runtime's historical order.
        """
        spec = get_strategy(strategy if strategy is not None else self.strategy)
        if self.topology is not None and spec.topology_aware:
            from .topo import vacate_racks

            return vacate_racks(self.topology, set(used), n_release)
        return sorted(used)[-n_release:] if n_release > 0 else []

    def allocation_arg(self, widths: Sequence[int]) -> Union[int, list[int]]:
        """Planner ``cores`` argument for a node set's width vector.

        Homogeneous-only strategies get the scalar width on a uniform
        allocation; on an uneven one they get the vector anyway, so the
        planner raises its §4.2 guidance error ("use
        PARALLEL_DIFFUSIVE") instead of silently mis-planning.  BOTH
        executors build their planner input here — the sim == live
        invariant depends on them never diverging.
        """
        out = [int(w) for w in widths]
        if (get_strategy(self.strategy).homogeneous_only
                and len(set(out)) == 1):
            return out[0]
        return out

    # ------------------------------------------------------------- planning --
    def redistribution_stats(self, ns: int, nt: int) -> tuple[int, int]:
        """Per-link stage-3 volumes ``(bytes_stayed, bytes_moved)``.

        Consults ``bytes_model`` when set — through its ``stats``
        attribute if it has one, else by calling it and accepting either
        a plain int (moved bytes; stayed unknown, charged 0 — the
        pre-split aggregate behaviour) or a mapping carrying
        ``bytes_stayed`` / ``bytes_moved``.  Without a model, falls back
        to the scalar ``bytes_per_rank * |nt - ns|`` on the cross link.
        """
        if self.bytes_model is None:
            return 0, max(0, self.bytes_per_rank * abs(nt - ns))
        stats_fn = getattr(self.bytes_model, "stats", None)
        out = stats_fn(ns, nt) if callable(stats_fn) else self.bytes_model(ns, nt)
        if isinstance(out, dict):
            return (max(0, int(out.get("bytes_stayed", 0))),
                    max(0, int(out.get("bytes_moved", 0))))
        return 0, max(0, int(out))

    def redistribution_bytes(self, ns: int, nt: int) -> int:
        """Stage-3 cross-link (moved) bytes for an ``ns -> nt`` resize."""
        return self.redistribution_stats(ns, nt)[1]

    def checkpoint_bytes(self, ns: int) -> int:
        """Snapshot size of the job's full state at ``ns`` ranks.

        A bytes model exposing a ``total_bytes`` attribute (the analytic
        models in :mod:`repro_torch.malleability.cost_model` and
        :class:`repro_torch.elastic.reshard.PytreeBytesModel` all do) is asked
        for the pytree total; otherwise the scalar fallback charges
        ``bytes_per_rank`` per rank — every rank snapshots its share.
        """
        if self.bytes_model is not None:
            total_fn = getattr(self.bytes_model, "total_bytes", None)
            if callable(total_fn):
                return max(0, int(total_fn(ns)))
        return max(0, self.bytes_per_rank * max(0, ns))

    def restore_bytes_on_fail(self, ns: int, nt: int) -> int:
        """Bytes re-read from the last checkpoint after losing ranks.

        Survivors keep their own shards; only the doomed ranks' share of
        the snapshot — ``(ns - nt) / ns`` of it, exact integer floor —
        must come back from the store.
        """
        if ns <= 0 or nt >= ns:
            return 0
        return self.checkpoint_bytes(ns) * (ns - nt) // ns

    def _expand_cross_bytes(
        self, spawn: SpawnPlan, node_ids: Sequence[int], moved: int
    ) -> tuple[int, int]:
        """(rack-, pod-)crossing portions of an expansion's moved bytes.

        Each spawned rank receives its proportional share of the moved
        volume; a destination node whose rack holds NO source rank can
        only be fed across racks, and — when the topology defines pods —
        one whose pod holds no source rank is fed across pods.  Exact
        integer arithmetic (cumulative shares), so the per-class volumes
        always sum to ``moved``.  Without a topology or explicit
        placement everything is one rack.
        """
        if self.topology is None or moved <= 0 or not node_ids:
            return 0, 0
        topo = self.topology
        src_slots = [
            i for i, r in enumerate(spawn.running)
            if r > 0 and i < len(node_ids)
        ]
        src_racks = {topo.rack_of(node_ids[i]) for i in src_slots}
        src_pods = (
            {topo.pod_of(node_ids[i]) for i in src_slots}
            if topo.pod_sizes else set()
        )

        def _cat(node: int) -> int:
            if topo.rack_of(node) in src_racks:
                return 0
            if topo.pod_sizes and topo.pod_of(node) not in src_pods:
                return 2
            return 1

        parts = [
            (s, _cat(node_ids[i]))
            for i, s in enumerate(spawn.to_spawn)
            if s > 0 and i < len(node_ids)
        ]
        return _class_shares(moved, parts)

    def _shrink_cross_bytes(
        self, state: ClusterState, shrink: ShrinkPlan, moved: int
    ) -> tuple[int, int]:
        """(rack-, pod-)crossing portions of a shrink's moved bytes.

        Survivors absorb the doomed ranks' shards proportionally, one
        part per (world, node) a surviving rank sits on — a multi-node
        initial world spanning racks is accounted node by node — and a
        destination node whose rack (pod) holds NO doomed node receives
        its share across racks (pods).
        """
        if self.topology is None or moved <= 0:
            return 0, 0
        topo = self.topology
        doomed = set(shrink.doomed_wids())
        victim_nodes = [
            n for a in shrink.actions if a.wid in doomed for n in a.nodes
        ]
        victim_racks = {topo.rack_of(n) for n in victim_nodes}
        if not victim_racks:
            return 0, 0
        victim_pods = (
            {topo.pod_of(n) for n in victim_nodes}
            if topo.pod_sizes else set()
        )

        def _cat(node: int) -> int:
            if topo.rack_of(node) in victim_racks:
                return 0
            if topo.pod_sizes and topo.pod_of(node) not in victim_pods:
                return 2
            return 1

        survivors = sorted(
            (w for w in state.worlds.values() if w.wid not in doomed),
            key=lambda w: (min(w.nodes), w.wid),
        )
        parts = []
        for w in survivors:
            for node in sorted({r.node for r in w.ranks}):
                n_ranks = sum(1 for r in w.ranks if r.node == node)
                parts.append((n_ranks, _cat(node)))
        return _class_shares(moved, parts)

    def plan_expand(
        self,
        ns: int,
        nt: int,
        cores: Union[int, Sequence[int]],
        *,
        strategy: Optional[StrategyLike] = None,
        method: Optional[Method] = None,
        queue_delay_s: float = 0.0,
        node_ids: Sequence[int] = (),
    ) -> ReconfigPlan:
        """Plan an NS -> NT expansion onto the given allocation.

        Args:
            ns: current rank count (sources).
            nt: target rank count.
            cores: C (homogeneous cores/node) or the per-node A vector
                (heterogeneous, requires a vector-capable strategy).
            strategy: override this engine's strategy for one plan.
            method: override this engine's method for one plan.
            queue_delay_s: RMS arbitration wait charged as a leading
                QUEUE timeline event (see :func:`expansion_timeline`).
            node_ids: cluster node id of each allocation-vector entry
                (source nodes first, then the placement order from
                :meth:`select_expansion_nodes`).  Backends acquire the
                new nodes from this list, and stage-3 bytes resolve
                their distance class through it; empty keeps the greedy
                single-rack behaviour.
        Returns:
            A self-contained :class:`ReconfigPlan` (spawn plan, sync
            graph, connect rounds, resolved per-class redistribution
            bytes).
        """
        spec = get_strategy(strategy if strategy is not None else self.strategy)
        m = method if method is not None else self.method
        spawn = spec.planner(ns, nt, cores, m)
        graph = None
        rounds = 0
        if spec.parallel and spawn.groups:
            graph = build_sync_graph(spawn)
            extend_graph_with_connection(graph, spawn)
            rounds = len(binary_connection_schedule(len(spawn.groups)))
        stayed, moved = self.redistribution_stats(ns, nt)
        xrack, xpod = self._expand_cross_bytes(spawn, node_ids, moved)
        redistribution = RedistributionSpec(
            layout=tuple(global_order(spawn)) if spawn.groups else (),
            ns=ns,
            nt=nt,
            bytes_per_rank=self.bytes_per_rank,
            bytes_total=moved,
            bytes_stayed=stayed,
            bytes_cross_rack=xrack,
            bytes_cross_pod=xpod,
        )
        return ReconfigPlan(
            kind="expand",
            method=m,
            strategy=spawn.strategy,
            asynchronous=self.asynchronous or spec.two_phase,
            ns=ns,
            nt=nt,
            spawn=spawn,
            sync_graph=graph,
            connect_rounds=rounds,
            redistribution=redistribution,
            queue_delay_s=max(0.0, queue_delay_s),
            node_ids=tuple(node_ids),
        )

    def plan_shrink(
        self,
        state: ClusterState,
        release_nodes: Optional[Sequence[int]] = None,
        release_cores: Optional[dict] = None,
        *,
        queue_delay_s: float = 0.0,
        failed: bool = False,
    ) -> ReconfigPlan:
        """Plan a shrink against live cluster bookkeeping.

        Args:
            state: the job's :class:`ClusterState`.
            release_nodes: node ids to release (TS path), or None.
            release_cores: core counts to release instead, or None.
            queue_delay_s: RMS arbitration wait charged as a leading
                QUEUE timeline event (see :func:`shrink_timeline`).
            failed: the released nodes died rather than being returned
                voluntarily.  With :attr:`restore_on_fail` set, the plan
                carries a :class:`CheckpointSpec` whose
                ``bytes_restored`` (:meth:`restore_bytes_on_fail`) is
                charged as a trailing RESTORE event — recovery from the
                last checkpoint.
        Returns:
            A :class:`ReconfigPlan` with the shrink actions, doomed
            world sizes (captured so the timeline can be charged later
            without re-reading possibly-mutated state), and resolved
            redistribution bytes.
        """
        shrink = _plan_shrink_actions(state, release_nodes, release_cores)
        doomed_sizes = tuple(
            state.worlds[wid].size
            for wid in shrink.doomed_wids()
            if wid in state.worlds
        )
        zombified = sum(
            len(a.ranks) for a in shrink.actions if a.kind.value == "zombify_ranks"
        )
        ns = sum(w.size for w in state.worlds.values())
        nt = max(0, ns - sum(doomed_sizes) - zombified)
        stayed, moved = self.redistribution_stats(ns, nt)
        xrack, xpod = self._shrink_cross_bytes(state, shrink, moved)
        ckpt = None
        if failed and self.restore_on_fail:
            ckpt = CheckpointSpec(
                bytes_restored=self.restore_bytes_on_fail(ns, nt))
        return ReconfigPlan(
            kind="shrink",
            method=self.method,
            strategy=self.strategy,
            asynchronous=self.asynchronous,
            ns=ns,
            nt=nt,
            shrink=shrink,
            shrink_world_sizes=doomed_sizes,
            redistribution=RedistributionSpec(
                layout=(),
                ns=ns,
                nt=nt,
                bytes_per_rank=self.bytes_per_rank,
                bytes_total=moved,
                bytes_stayed=stayed,
                bytes_cross_rack=xrack,
                bytes_cross_pod=xpod,
            ),
            queue_delay_s=max(0.0, queue_delay_s),
            checkpoint=ckpt,
        )

    def plan_checkpoint(
        self, ns: int, *, queue_delay_s: float = 0.0
    ) -> ReconfigPlan:
        """Plan a standalone checkpoint of the full state at ``ns`` ranks.

        No allocation change (``nt == ns``); the timeline is a single
        CHECKPOINT event sized by :meth:`checkpoint_bytes`.
        """
        return ReconfigPlan(
            kind="checkpoint",
            method=self.method,
            strategy=self.strategy,
            asynchronous=self.asynchronous,
            ns=ns,
            nt=ns,
            checkpoint=CheckpointSpec(
                bytes_checkpointed=self.checkpoint_bytes(ns)),
            queue_delay_s=max(0.0, queue_delay_s),
        )

    def plan_restart(
        self,
        ns: int,
        nt: int,
        *,
        queue_delay_s: float = 0.0,
        node_ids: Sequence[int] = (),
    ) -> ReconfigPlan:
        """Plan a full-stop checkpoint/restart to ``nt`` ranks.

        The rigid baseline: checkpoint everything, stop, respawn the
        NT-sized world (SS), read everything back.  ``node_ids`` is the
        target placement (the new world's nodes, in acquisition order);
        the respawn call fans out over ``len(node_ids)`` nodes (``nt``
        single-rank nodes when empty).
        """
        total = self.checkpoint_bytes(ns)
        return ReconfigPlan(
            kind="restart",
            method=self.method,
            strategy=self.strategy,
            asynchronous=self.asynchronous,
            ns=ns,
            nt=nt,
            checkpoint=CheckpointSpec(
                bytes_checkpointed=total, bytes_restored=total),
            queue_delay_s=max(0.0, queue_delay_s),
            node_ids=tuple(node_ids),
        )

    # ------------------------------------------------------------- timeline --
    def timeline(self, plan: ReconfigPlan) -> Timeline:
        """Charge a plan as an event timeline with this engine's CostModel.

        The plan's resolved ``redistribution.bytes_total`` is charged as
        a REDISTRIBUTION event, so ``est_wall`` prices data movement for
        every consumer reading this timeline.
        """
        cm = self.cost_model
        assert cm is not None  # resolved in __post_init__
        bytes_total = (
            plan.redistribution.bytes_total if plan.redistribution else 0
        )
        bytes_stayed = (
            plan.redistribution.bytes_stayed if plan.redistribution else 0
        )
        bytes_cross_rack = (
            plan.redistribution.bytes_cross_rack if plan.redistribution else 0
        )
        bytes_cross_pod = (
            plan.redistribution.bytes_cross_pod if plan.redistribution else 0
        )
        if plan.kind == "expand":
            assert plan.spawn is not None
            spec = _STRATEGY_REGISTRY.get(strategy_key(plan.strategy))
            if spec is not None and spec.two_phase:
                # Two-phase (DMR-style) expansion: the grant-acceptance
                # legs hide under compute entirely, subject to the same
                # contention degradation every overlapped event pays.
                cm = cm.with_overlap(spawn=1.0, sync=1.0, connect=1.0)
            return expansion_timeline(
                plan.spawn, cm, bytes_total=bytes_total,
                queue_delay_s=plan.queue_delay_s, bytes_stayed=bytes_stayed,
                bytes_cross_rack=bytes_cross_rack,
                bytes_cross_pod=bytes_cross_pod,
                topology=self.topology, node_ids=plan.node_ids,
            )
        if plan.kind == "shrink":
            assert plan.shrink is not None
            return shrink_timeline(
                plan.shrink.kind,
                cm,
                ns=plan.ns,
                nt=plan.nt,
                doomed_world_sizes=list(plan.shrink_world_sizes) or [1],
                bytes_total=bytes_total,
                queue_delay_s=plan.queue_delay_s,
                bytes_stayed=bytes_stayed,
                bytes_cross_rack=bytes_cross_rack,
                bytes_cross_pod=bytes_cross_pod,
                restore_bytes=(
                    plan.checkpoint.bytes_restored if plan.checkpoint else 0
                ),
            )
        if plan.kind == "checkpoint":
            ck = plan.checkpoint or CheckpointSpec()
            return checkpoint_timeline(
                cm, snapshot_bytes=ck.bytes_checkpointed,
                queue_delay_s=plan.queue_delay_s,
            )
        if plan.kind == "restart":
            ck = plan.checkpoint or CheckpointSpec()
            return restart_timeline(
                cm,
                ns=plan.ns,
                nt=plan.nt,
                nodes=len(plan.node_ids) or max(1, plan.nt),
                snapshot_bytes=ck.bytes_checkpointed,
                restore_bytes=ck.bytes_restored,
                queue_delay_s=plan.queue_delay_s,
            )
        return Timeline()

    # ------------------------------------------------------------- execution --
    def execute(
        self, plan: ReconfigPlan, backend: Optional[ExecutionBackend] = None
    ) -> ReconfigOutcome:
        """Charge the timeline, then let the backend apply the plan.

        Args:
            plan: a plan from :meth:`plan_expand` / :meth:`plan_shrink`.
            backend: optional substrate (live runtime, bookkeeping twin)
                that receives ``apply_expand`` / ``apply_shrink``.
        Returns:
            The :class:`ReconfigOutcome` (plan + charged timeline).
        """
        tl = self.timeline(plan)
        if backend is not None:
            if plan.kind == "expand":
                backend.apply_expand(plan)
            elif plan.kind == "shrink":
                backend.apply_shrink(plan)
            elif plan.kind == "restart":
                # Optional on the protocol: only substrates that can do
                # a full stop + respawn implement it ("checkpoint" plans
                # change no allocation, so they never reach a backend).
                apply_restart = getattr(backend, "apply_restart", None)
                if apply_restart is not None:
                    apply_restart(plan)
        return ReconfigOutcome(plan=plan, timeline=tl)
