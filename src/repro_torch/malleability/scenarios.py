"""Declarative workload scenarios shared by every consumer layer.

A :class:`Scenario` is a pure-data trace of RMS events (grow / shrink /
fail / straggler / checkpoint / restart) against a node pool.  The SAME
object drives:

* the **simulator** — :func:`run_scenario_sim` walks the trace against a
  device-free :class:`ClusterState`, planning each reconfiguration
  through the :class:`~repro_torch.core.engine.ReconfigEngine` and charging
  its event timeline;
* the **elastic runtime / trainer** — :meth:`repro_torch.elastic.rms.SimulatedRMS
  .from_scenario` feeds the identical trace into the live NodeGroup
  backend (:func:`run_scenario_live` for bookkeeping-only runs,
  :class:`~repro_torch.elastic.trainer.ElasticTrainer` for full training);
* the **benchmarks** — iterate :func:`registered_scenarios` instead of
  hard-coding event scripts.

Because both executors plan through the same engine and read cost off
the same timeline, their downtime numbers agree *exactly* — that is the
dedup the engine exists for.

Built-in scenarios model the paper's two testbeds: steady expand/shrink
cycles and burst arrivals (MN5-style homogeneous pools, §5.2), node
failures and straggler churn (the dynamic-awareness motivation, §1), and
heterogeneous-core pools (NASP-style alternating node widths, §5.3).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field, replace
from typing import TYPE_CHECKING, Callable, Iterable, Optional

if TYPE_CHECKING:  # circular at runtime: throughput imports this module
    from .throughput import ThroughputModel

from repro_torch.core import (
    TOPO_KEY,
    ClusterState,
    Method,
    ReconfigEngine,
    ShrinkKind,
    Strategy,
    Topology,
    apply_shrink,
    strategy_key,
)
from repro_torch.core.topology import split_bytes_by_class

from .cost_model import (
    MN5,
    NASP,
    CostModel,
    replicated_bytes_model,
    replicated_link_model,
)

# Event kinds (string-typed so scenarios stay pure data; they map 1:1 to
# repro_torch.elastic.rms.EventKind values).
GROW = "grow"
SHRINK = "shrink"
FAIL = "fail"
STRAGGLER = "straggler"
CHECKPOINT = "checkpoint"
RESTART = "restart"


@dataclass(frozen=True)
class ScenarioEvent:
    """One RMS decision at a given application step.

    ``queue_delay_s`` is RMS arbitration wait: seconds this resize sat
    queued behind an in-flight reconfiguration (its own job's previous
    event in the same drain, or a co-scheduled job's — see
    :mod:`repro_torch.malleability.policies`).  Both executors charge it as a
    leading QUEUE timeline event, so it raises ``est_wall`` (makespan)
    but never downtime.

    A SHRINK may name explicit victim ``nodes``, or instead give a
    ``target_nodes`` total with no victims: then victim choice is the
    engine's placement decision (highest-id nodes for the classics,
    whole racks first for topology-aware strategies), identically in
    both executors.

    A CHECKPOINT snapshots the full state in place (no allocation
    change); a RESTART is the rigid full-stop baseline — checkpoint,
    stop every world, respawn at ``target_nodes`` (the current count
    when 0), restore from the store.
    """

    step: int
    kind: str                       # grow | shrink | fail | straggler
    #                                 | checkpoint | restart
    target_nodes: int = 0           # GROW: new total; SHRINK: shrink-to
    #                                 total; RESTART: post-restart total
    nodes: tuple[int, ...] = ()     # SHRINK/FAIL/STRAGGLER: victim node ids
    queue_delay_s: float = 0.0      # RMS arbitration wait before stage 2


@functools.lru_cache(maxsize=None)
def param_bytes_for_arch(arch: str) -> int:
    """Total parameter-pytree bytes for a registered architecture config.

    Resolved from the port's shape-only params
    (:meth:`repro_torch.models.Model.abstract_params`) — no weights are
    allocated.  Used by scenarios to size stage-3 redistribution.
    """
    from repro_torch.configs import arch_config  # local: keep the import light
    from repro_torch.models.model import abstract_params

    shapes, _ = abstract_params(arch_config(arch))
    return int(sum(s.nbytes for s in shapes.values()))


@dataclass(frozen=True)
class Scenario:
    """A declarative workload trace over a node pool.

    ``arch`` / ``param_bytes`` size the pytree the trace reshards: the
    default engine charges stage-3 data movement from them, so the same
    trace sweeps redistribution pressure as the model config changes.
    """

    name: str
    description: str
    initial_nodes: int
    events: tuple[ScenarioEvent, ...]
    cores_per_node: int = 1          # homogeneous node width (== devices/node
    #                                  when executed on the live runtime)
    core_pool: tuple[int, ...] = ()  # heterogeneous A vector; the live
    #                                  DevicePool partitions its devices with
    #                                  the same uneven widths (node_widths)
    steps: int = 20                  # application steps the trace spans
    profile: str = "mn5"             # default cost-model profile
    arch: str = ""                   # model config whose pytree the trace moves
    param_bytes: int = 0             # explicit pytree size (overrides arch)
    contention: float = 0.0          # >0 overrides the cost model's overlap
    #                                  contention (multi-job interference
    #                                  degrades how well ASYNC hides work)
    redist_bw_local: float = 0.0     # per-link stage-3 bandwidths; >0 splits
    redist_bw_cross: float = 0.0     # the profile's aggregate redist_bw and
    #                                  switches the default engine to the
    #                                  link-aware (stayed+moved) bytes model
    redist_bw_intra_rack: float = 0.0  # >0 additionally splits the moved
    #                                  bytes per rack distance: intra-rack
    #                                  transfers price here, rack-crossing
    #                                  ones at redist_bw_cross
    rack_sizes: tuple[int, ...] = ()  # nodes per rack (prefix node numbering,
    #                                  uneven allowed); non-empty makes the
    #                                  trace topology-aware: the default
    #                                  engine carries the Topology and the
    #                                  "topo" strategy places against it
    pod_sizes: tuple[int, ...] = ()  # optional racks per pod (prefix order)
    redist_bw_cross_pod: float = 0.0  # >0 prices the pod-crossing slice of
    #                                  the rack-crossing bytes on its own
    #                                  (slowest) link; 0 keeps cross_pod at
    #                                  the cross_rack bandwidth — the
    #                                  3-class numbers, bit for bit
    gamma_rack: float = 0.0          # >0 prices stages 1-2 by topology: per
    gamma_pod: float = 0.0           # launcher-tree edge, rack-crossing
    #                                  spawns pay +gamma_rack and pod-crossing
    #                                  ones +gamma_rack+gamma_pod on top of
    #                                  the flat latency; 0 keeps spawn flat
    restore_on_fail: bool = False    # FAIL recovery re-reads the dead nodes'
    #                                  shard of the last checkpoint: the
    #                                  recovery shrink carries a trailing
    #                                  RESTORE event (bytes_restored)

    @property
    def heterogeneous(self) -> bool:
        return bool(self.core_pool)

    @property
    def topology_aware(self) -> bool:
        """True when the trace declares a rack layout."""
        return bool(self.rack_sizes)

    @property
    def link_aware(self) -> bool:
        """True when the trace prices stage 3 per link (split bandwidths)."""
        return (self.redist_bw_local > 0.0 or self.redist_bw_cross > 0.0
                or self.redist_bw_intra_rack > 0.0
                or self.redist_bw_cross_pod > 0.0)

    def topology(self) -> Optional[Topology]:
        """The declared :class:`~repro_torch.core.Topology`, or ``None``.

        The rack tree must cover the trace's peak node count — a
        smaller tree would leave placement/pricing undefined for the
        outer nodes — and on a heterogeneous trace it must match the
        ``core_pool`` width vector node for node (the live
        ``DevicePool`` enforces the same), so mismatches raise.
        """
        if not self.rack_sizes:
            return None
        topo = Topology(rack_sizes=self.rack_sizes, pod_sizes=self.pod_sizes)
        if topo.n_nodes < self.max_nodes():
            raise ValueError(
                f"scenario {self.name!r}: topology covers {topo.n_nodes} "
                f"nodes but the trace peaks at {self.max_nodes()}"
            )
        if self.core_pool and topo.n_nodes != len(self.core_pool):
            raise ValueError(
                f"scenario {self.name!r}: topology covers {topo.n_nodes} "
                f"nodes but core_pool has {len(self.core_pool)}"
            )
        return topo

    def pool_nodes(self) -> int:
        """Node count of the pool BOTH executors run against.

        This is exactly the pool :func:`scenario_pool` builds — the
        ``core_pool`` length, the topology's node count (spare whole
        racks beyond the trace's peak are legitimate), or the peak
        itself.  The simulator sizes its free set identically, so
        placement ranks the same candidate nodes as the live runtime
        (the sim == live invariant would silently break otherwise).
        """
        if self.core_pool:
            return len(self.core_pool)
        topo = self.topology()
        if topo is not None:
            return topo.n_nodes
        return self.max_nodes()

    def max_nodes(self) -> int:
        """Peak node count along the trace (sizes pools/device counts)."""
        count = peak = self.initial_nodes
        for ev in sorted(self.events, key=lambda e: e.step):
            if ev.kind == GROW:
                count = max(count, ev.target_nodes)
            elif ev.kind == RESTART:
                count = ev.target_nodes or count
            elif ev.kind == CHECKPOINT:
                pass  # snapshot in place: no allocation change
            else:
                count = max(1, count - len(ev.nodes))
            peak = max(peak, count)
        return peak

    def cost_model(self) -> CostModel:
        cm = NASP if self.profile == "nasp" else MN5
        if self.contention > 0.0:
            cm = cm.with_overlap(contention=self.contention)
        if self.link_aware:
            cm = cm.with_link_bandwidths(
                local=self.redist_bw_local or None,
                cross=self.redist_bw_cross or None,
            )
            if self.redist_bw_intra_rack > 0.0 or self.redist_bw_cross_pod > 0.0:
                # Three (or four) distance classes: intra-rack moves
                # price here, rack-crossing moves keep the (slower)
                # cross link, and pod-crossing ones the slowest link.
                cm = cm.with_class_bandwidths(
                    intra_rack=self.redist_bw_intra_rack or None,
                    cross_rack=self.redist_bw_cross or None,
                    cross_pod=self.redist_bw_cross_pod or None,
                )
        if self.gamma_rack > 0.0 or self.gamma_pod > 0.0:
            cm = replace(cm, gamma_rack=self.gamma_rack or None,
                         gamma_pod=self.gamma_pod or None)
        return cm

    def resolved_param_bytes(self) -> int:
        """Pytree bytes the trace reshards: explicit ``param_bytes``, or
        the ``arch`` config's parameter bytes, or 0 (no data movement)."""
        if self.param_bytes:
            return self.param_bytes
        if self.arch:
            return param_bytes_for_arch(self.arch)
        return 0

    def default_engine(self, strategy=None, method=None) -> ReconfigEngine:
        """Engine every executor uses for this trace (the dedup point).

        Topology-aware traces default to the ``topo`` strategy (their
        rack tree rides on the engine either way, so every strategy's
        stage-3 bytes resolve distance classes); heterogeneous pools
        require a vector-capable strategy (§4.2); a sized pytree wires
        the replicated analytic bytes model so each reconfiguration
        charges stage-3 data movement.  ``strategy`` / ``method``
        override the defaults for sweeps (e.g. the benchmark
        ``policy_sweep`` running each policy trace under every
        registered strategy).
        """
        if strategy is None:
            if self.topology_aware:
                strategy = TOPO_KEY
            elif self.heterogeneous:
                strategy = Strategy.PARALLEL_DIFFUSIVE
            else:
                strategy = Strategy.PARALLEL_HYPERCUBE
        pb = self.resolved_param_bytes()
        bytes_model = None
        if pb:
            # Per-link traces charge both transfer classes; aggregate
            # traces keep the moved-only model (bit-for-bit the
            # pre-split numbers).
            bytes_model = (replicated_link_model(pb) if self.link_aware
                           else replicated_bytes_model(pb))
        return ReconfigEngine(
            method=Method.MERGE if method is None else method,
            strategy=strategy,
            cost_model=self.cost_model(),
            bytes_model=bytes_model,
            topology=self.topology(),
            restore_on_fail=self.restore_on_fail,
        )

    def with_cores_per_node(self, cpn: int) -> "Scenario":
        return replace(self, cores_per_node=cpn, core_pool=())

    def with_model(self, arch: str = "", param_bytes: int = 0) -> "Scenario":
        """Same trace, different pytree size (sweeps redistribution)."""
        return replace(self, arch=arch, param_bytes=param_bytes)


# ================================================================ registry ==
_SCENARIO_REGISTRY: dict[str, Scenario] = {}


def register_scenario(scenario: Scenario, *, overwrite: bool = False) -> Scenario:
    if scenario.name in _SCENARIO_REGISTRY and not overwrite:
        raise ValueError(f"scenario {scenario.name!r} already registered")
    _SCENARIO_REGISTRY[scenario.name] = scenario
    return scenario


def get_scenario(name: str) -> Scenario:
    try:
        return _SCENARIO_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; registered: {sorted(_SCENARIO_REGISTRY)}"
        ) from None


def registered_scenarios() -> tuple[Scenario, ...]:
    return tuple(_SCENARIO_REGISTRY.values())


# ================================================================ builders ==
def steady_cycle(
    name: str = "steady-cycle",
    low: int = 1,
    high: int = 4,
    cycles: int = 2,
    period: int = 5,
    cores_per_node: int = 1,
    arch: str = "",
    param_bytes: int = 0,
) -> Scenario:
    """Steady expand/shrink cycles: low -> high -> low, repeated.

    The malleable-batch workload of §5: the job breathes with cluster
    load, exercising both the parallel expansion and the TS shrink path.
    ``arch`` / ``param_bytes`` size the pytree each cycle reshards.
    """
    events: list[ScenarioEvent] = []
    step = period
    for _ in range(cycles):
        events.append(ScenarioEvent(step=step, kind=GROW, target_nodes=high))
        step += period
        # shrink back down to `low` by releasing the highest node ids
        events.append(ScenarioEvent(
            step=step, kind=SHRINK, nodes=tuple(range(low, high))))
        step += period
    return Scenario(
        name=name,
        description=f"{cycles}x expand {low}->{high} then TS-shrink back",
        initial_nodes=low,
        cores_per_node=cores_per_node,
        events=tuple(events),
        steps=step + period,
        arch=arch,
        param_bytes=param_bytes,
    )


def burst_arrival(
    name: str = "burst-arrival",
    start: int = 1,
    burst: int = 8,
    cores_per_node: int = 1,
) -> Scenario:
    """A sudden grant of many nodes, then staged halving reclamation.

    Stresses exactly what the parallel strategies are for: one large
    expansion (log-depth spawn rounds) followed by staged TS shrinks as
    the RMS takes half the remaining nodes back per wave.  Halving keeps
    every settled node count a divisor of the burst width, so the trace
    also runs through live data-parallel training (batch % nodes == 0).
    """
    events = [ScenarioEvent(step=3, kind=GROW, target_nodes=burst)]
    step, count = 8, burst
    while count > start:
        nxt = max(start, count // 2)
        events.append(ScenarioEvent(
            step=step, kind=SHRINK, nodes=tuple(range(nxt, count))))
        count = nxt
        step += 3
    return Scenario(
        name=name,
        description=f"burst {start}->{burst}, then halving TS reclaim waves",
        initial_nodes=start,
        cores_per_node=cores_per_node,
        events=tuple(events),
        steps=step + 2,
    )


def node_failures(
    name: str = "node-failures",
    nodes: int = 8,
    failure_waves: tuple[tuple[int, ...], ...] = ((4, 5, 6, 7), (2, 3)),
    cores_per_node: int = 1,
) -> Scenario:
    """Grow once, then lose whole groups of nodes to correlated failures
    (a rack or switch dying takes several nodes at once).

    §1's dynamic-awareness case: node-confined worlds mean each failed
    node kills exactly one group, and recovery is a forced TS shrink of
    that wave.  The default waves settle at 8 -> 4 -> 2 nodes so the
    trace also runs through live data-parallel training.
    """
    events = [ScenarioEvent(step=2, kind=GROW, target_nodes=nodes)]
    for i, wave in enumerate(failure_waves):
        events.append(ScenarioEvent(step=6 + 4 * i, kind=FAIL, nodes=tuple(wave)))
    return Scenario(
        name=name,
        description=f"grow to {nodes}, then {len(failure_waves)} failure waves",
        initial_nodes=1,
        cores_per_node=cores_per_node,
        events=tuple(events),
        steps=6 + 4 * len(failure_waves) + 2,
    )


def straggler_churn(
    name: str = "straggler-churn",
    nodes: int = 4,
    churns: int = 2,
    cores_per_node: int = 1,
) -> Scenario:
    """Repeatedly drop the slowest node and immediately replace it.

    Straggler mitigation as continuous reconfiguration: at each churn
    step the slow group is TS-shrunk out AND the job grows back to the
    target width in the same reconfiguration drain (the settled node
    count never changes, so live training shards cleanly throughout).
    """
    events = [ScenarioEvent(step=2, kind=GROW, target_nodes=nodes)]
    step = 5
    for i in range(churns):
        # the live pool hands back the lowest free node id, so dropping
        # node (nodes-1-i) keeps sim and live trajectories identical
        events.append(ScenarioEvent(step=step, kind=STRAGGLER, nodes=(nodes - 1 - i,)))
        events.append(ScenarioEvent(step=step, kind=GROW, target_nodes=nodes))
        step += 3
    return Scenario(
        name=name,
        description=f"{churns}x same-step straggler drop + replacement at {nodes} nodes",
        initial_nodes=1,
        cores_per_node=cores_per_node,
        events=tuple(events),
        steps=step + 2,
    )


def heterogeneous_pool(
    name: str = "hetero-nasp",
    nodes: int = 8,
    widths: tuple[int, ...] = (20, 32),
    profile: str = "nasp",
    arch: str = "",
    param_bytes: int = 0,
    redist_bw_local: float = 0.0,
    redist_bw_cross: float = 0.0,
) -> Scenario:
    """NASP-style heterogeneous pool (§5.3): alternating node widths.

    Requires the diffusive strategy (§4.2).  Runs through BOTH executors:
    the live ``DevicePool`` partitions its devices with the same uneven
    ``node_widths`` vector, and because worlds stay node-confined,
    shrinks return complete uneven nodes to the pool.  ``arch`` /
    ``param_bytes`` size the pytree the trace reshards; split
    ``redist_bw_local`` / ``redist_bw_cross`` bandwidths price stage 3
    per link (see :func:`~repro_torch.malleability.cost_model
    .replicated_link_model`).
    """
    pool = tuple(widths[i % len(widths)] for i in range(nodes))
    events = (
        ScenarioEvent(step=2, kind=GROW, target_nodes=nodes),
        ScenarioEvent(step=8, kind=SHRINK, nodes=tuple(range(nodes // 2, nodes))),
        ScenarioEvent(step=12, kind=GROW, target_nodes=nodes - 1),
    )
    return Scenario(
        name=name,
        description=f"heterogeneous {widths} pool, grow/shrink/regrow",
        initial_nodes=1,
        core_pool=pool,
        events=events,
        steps=16,
        profile=profile,
        arch=arch,
        param_bytes=param_bytes,
        redist_bw_local=redist_bw_local,
        redist_bw_cross=redist_bw_cross,
    )


def topology_nasp(name: str = "topo-nasp") -> Scenario:
    """2-rack uneven pool with placement-sensitive reconfigurations.

    Rack 0 holds nodes {0,1} (2 devices each), rack 1 holds {2,3,4}
    (1,1,2 devices) — uneven racks AND uneven widths.  The trace forces
    every placement decision the ``topo`` strategy exists for:

    * grow to the full pool, then a shrink **to a target count** (victim
      choice is the strategy's): ``topo`` vacates whole rack 0 and tops
      up from rack 1 — a shrink that must cross racks, returning
      rack-granular capacity to the RMS;
    * the regrow then lands **rack-local** (node 4, next to the
      survivors in rack 1) where the greedy classics would take node 0
      and re-fragment the vacated rack.

    Rank counts along the trace (2, 8, 2, 4) all divide a batch of 8,
    so the full ElasticTrainer loop runs it on 8 host devices.
    """
    return Scenario(
        name=name,
        description="2-rack uneven pool: rack-vacating shrink + "
                    "rack-local regrow (topo placement)",
        initial_nodes=1,
        core_pool=(2, 2, 1, 1, 2),
        rack_sizes=(2, 3),
        events=(
            ScenarioEvent(step=2, kind=GROW, target_nodes=5),
            ScenarioEvent(step=6, kind=SHRINK, target_nodes=2),
            ScenarioEvent(step=10, kind=GROW, target_nodes=3),
        ),
        steps=13,
        profile="nasp",
    )


def topology_redist(name: str = "topo-redist") -> Scenario:
    """Move a real pytree across racks under 3-class link pricing.

    The same 2-rack uneven pool as :func:`topology_nasp`, now resharding
    xlstm_125m's parameters with three distinct bandwidths: replicas
    re-validated in place ride the 25 GB/s intra-node link, rack-local
    copies the 10 GB/s intra-rack fabric, and rack-crossing copies the
    2.5 GB/s inter-rack Ethernet.  The burst grow ships 4 of its 6
    replicas across racks (rack 1 opens fresh), the rack-vacating shrink
    leaves the survivors' replicas in place (intra_node only), and the
    regrow is where placement pays: ``topo`` lands rack-local next to
    the survivors (intra_rack bytes) while the greedy classics reopen
    the vacated rack and pay cross_rack bandwidth for the same copies —
    the ``table_topology`` benchmark prints exactly that column.  Rank
    counts (2, 8, 2, 4) divide a batch of 8 on 8 host devices, so the
    full trainer loop replays it.
    """
    return Scenario(
        name=name,
        description="2-rack uneven pool resharding xlstm_125m under "
                    "intra_node/intra_rack/cross_rack pricing",
        initial_nodes=1,
        core_pool=(2, 2, 1, 1, 2),
        rack_sizes=(2, 3),
        events=(
            ScenarioEvent(step=2, kind=GROW, target_nodes=5),
            ScenarioEvent(step=6, kind=SHRINK, target_nodes=2),
            ScenarioEvent(step=10, kind=GROW, target_nodes=3),
        ),
        steps=13,
        arch="xlstm_125m",
        redist_bw_local=25.0e9,
        redist_bw_cross=2.5e9,
        redist_bw_intra_rack=10.0e9,
    )


def topology_pods(name: str = "topo-pods") -> Scenario:
    """Pod-aware pricing: 3 racks in 2 pods, 4-class links + priced spawn.

    Pod 0 holds racks 0-1 (nodes {0,1} and {2}), pod 1 holds rack 2
    (nodes {3,4}) — uniform 1-wide nodes so EVERY strategy (including
    the hypercube) runs the trace.  The burst grow from node 0 must open
    rack 1 (same pod) and rack 2 (the other pod), so its stage-3 shares
    split across all four distance classes and its stages 1-2 launcher
    tree pays per-edge ``gamma_rack`` / ``gamma_pod`` penalties; the
    shrink vacates the far pod whole (survivor replicas stay put); the
    regrow reopens it and pays the pod link again.
    """
    return Scenario(
        name=name,
        description="2-pod/3-rack pool: 4-class link pricing + "
                    "topology-priced spawn",
        initial_nodes=1,
        cores_per_node=1,
        rack_sizes=(2, 1, 2),
        pod_sizes=(2, 1),
        events=(
            ScenarioEvent(step=2, kind=GROW, target_nodes=5),
            ScenarioEvent(step=6, kind=SHRINK, nodes=(3, 4)),
            ScenarioEvent(step=10, kind=GROW, target_nodes=4),
        ),
        steps=13,
        arch="xlstm_125m",
        redist_bw_local=25.0e9,
        redist_bw_cross=2.5e9,
        redist_bw_intra_rack=10.0e9,
        redist_bw_cross_pod=1.0e9,
        gamma_rack=0.002,
        gamma_pod=0.004,
    )


def ckpt_cycle(
    name: str = "ckpt-cycle",
    nodes: int = 4,
    checkpoints: int = 3,
    period: int = 3,
    param_bytes: int = 1 << 30,
) -> Scenario:
    """Periodic full-state checkpoints riding a steady grow/shrink trace.

    The fault-tolerance cadence of a long malleable run: grow once,
    snapshot the pytree every ``period`` steps (a CHECKPOINT event
    prices the stream through the cost model's checkpoint link, hidden
    behind compute per its ``ckpt_overlap``), then TS-shrink back.
    Node counts (1, ``nodes``, ``nodes/2``) divide a batch of 8, so the
    full ElasticTrainer loop replays the trace and actually persists
    each snapshot through its :class:`~repro_torch.checkpoint.CheckpointManager`.
    """
    events = [ScenarioEvent(step=2, kind=GROW, target_nodes=nodes)]
    step = 2 + period
    for _ in range(checkpoints):
        events.append(ScenarioEvent(step=step, kind=CHECKPOINT))
        step += period
    events.append(ScenarioEvent(
        step=step, kind=SHRINK, nodes=tuple(range(nodes // 2, nodes))))
    return Scenario(
        name=name,
        description=f"{checkpoints}x periodic checkpoint at {nodes} nodes, "
                    "then TS shrink",
        initial_nodes=1,
        events=tuple(events),
        steps=step + period,
        param_bytes=param_bytes,
    )


def node_fail_wave(
    name: str = "node-fail-wave",
    nodes: int = 8,
    failure_waves: tuple[tuple[int, ...], ...] = ((4, 5, 6, 7), (2, 3)),
    param_bytes: int = 1 << 30,
) -> Scenario:
    """Correlated failure waves recovered from the last checkpoint.

    :func:`node_failures` with the fault-tolerance story attached: a
    checkpoint lands before the first wave, and ``restore_on_fail``
    makes every recovery shrink re-read the dead nodes' shard of that
    snapshot — a trailing RESTORE event priced per distance class, so
    ``est_wall`` now includes recovery I/O, not just the TS teardown.
    The waves settle at 8 -> 4 -> 2 nodes (live-trainable widths).
    """
    events = [ScenarioEvent(step=2, kind=GROW, target_nodes=nodes),
              ScenarioEvent(step=4, kind=CHECKPOINT)]
    for i, wave in enumerate(failure_waves):
        events.append(ScenarioEvent(step=6 + 4 * i, kind=FAIL, nodes=tuple(wave)))
    return Scenario(
        name=name,
        description=f"grow to {nodes}, checkpoint, then "
                    f"{len(failure_waves)} failure waves restoring lost shards",
        initial_nodes=1,
        events=tuple(events),
        steps=6 + 4 * len(failure_waves) + 2,
        param_bytes=param_bytes,
        restore_on_fail=True,
    )


def restart_vs_shrink(
    name: str = "restart-vs-shrink",
    nodes: int = 4,
    param_bytes: int = 1 << 30,
) -> Scenario:
    """The same resize twice: full-stop restart, then malleable shrink.

    The paper's head-to-head in one trace: the job gives back half its
    nodes first as a rigid checkpoint/stop/respawn/restore cycle
    (RESTART), regrows, then does the identical resize as a malleable
    TS shrink.  Comparing the two records' ``est_wall_s`` shows what
    dynamic-awareness buys — the restart pays the full snapshot back
    through the checkpoint link while the shrink moves nothing (the
    replicated model keeps survivor state in place) — under every
    registered strategy, since both mechanisms are strategy-independent.
    Node counts (1, 4, 2) divide a batch of 8 for the live trainer.
    """
    return Scenario(
        name=name,
        description=f"the same {nodes}->{nodes // 2} resize as full-stop "
                    "restart, then as malleable TS shrink",
        initial_nodes=1,
        events=(
            ScenarioEvent(step=2, kind=GROW, target_nodes=nodes),
            ScenarioEvent(step=5, kind=RESTART, target_nodes=nodes // 2),
            ScenarioEvent(step=8, kind=GROW, target_nodes=nodes),
            ScenarioEvent(step=11, kind=SHRINK,
                          nodes=tuple(range(nodes // 2, nodes))),
        ),
        steps=14,
        param_bytes=param_bytes,
    )


# The fault-tolerance family: every scenario whose trace exercises the
# checkpoint/restore path (benchmarks' ``table_faults`` iterates this).
FAULT_SCENARIO_NAMES = ("ckpt-cycle", "node-fail-wave", "restart-vs-shrink")


def registered_fault_scenarios() -> tuple[Scenario, ...]:
    """The registered fault-tolerance scenarios, in table order."""
    return tuple(get_scenario(n) for n in FAULT_SCENARIO_NAMES)


for _sc in (
    steady_cycle(),
    burst_arrival(),
    node_failures(),
    straggler_churn(),
    heterogeneous_pool(),
    # The same steady cycle under redistribution pressure: stage-3 moves
    # a real model config's parameter pytree, so est_wall is dominated by
    # data movement rather than spawning — swap `arch` to sweep it.
    steady_cycle(name="redist-cycle", arch="stablelm_3b"),
    # Uneven widths x real pytree bytes x per-link pricing: a small
    # (2,1,2,1) pool — sized so the full ElasticTrainer loop can run it
    # on a handful of host devices — resharding xlstm_125m's parameters
    # with the local link 10x faster than the cross-group Ethernet, so
    # bytes_stayed and bytes_moved are charged at different bandwidths.
    heterogeneous_pool(
        name="hetero-redist", nodes=4, widths=(2, 1), arch="xlstm_125m",
        redist_bw_local=25.0e9, redist_bw_cross=2.5e9,
    ),
    # Topology-aware traces: placement becomes the strategy's decision
    # and stage-3 bytes price per rack distance class.
    topology_nasp(),
    topology_redist(),
    topology_pods(),
    # Fault-tolerance family: checkpoint cadence, checkpoint-backed
    # failure recovery, and the rigid restart-vs-malleable-shrink
    # head-to-head (see FAULT_SCENARIO_NAMES).
    ckpt_cycle(),
    node_fail_wave(),
    restart_vs_shrink(),
):
    register_scenario(_sc)


# =============================================================== executors ==
@dataclass(frozen=True)
class ScenarioRecord:
    """One reconfiguration along a scenario run (either executor)."""

    step: int
    kind: str                  # expand | shrink | fail | straggler
    #                            | checkpoint | restart
    mechanism: str             # strategy value, TS/ZS/SS value, or ckpt
    nodes_before: int
    nodes_after: int
    est_wall_s: float          # timeline total
    downtime_s: float          # timeline downtime
    bytes_moved: int = 0       # stage-3 cross-link bytes charged on the timeline
    queued_s: float = 0.0      # RMS arbitration wait charged (QUEUE span)
    bytes_stayed: int = 0      # stage-3 local-link bytes charged on the timeline
    bytes_cross_rack: int = 0  # rack-crossing portion of bytes_moved
    bytes_cross_pod: int = 0   # pod-crossing slice of bytes_cross_rack
    bytes_checkpointed: int = 0  # snapshot bytes streamed to the store
    bytes_restored: int = 0    # bytes read back from the store (RESTORE)
    restored_s: float = 0.0    # RESTORE span charged on the timeline
    time_to_result_s: float = -1.0  # est_wall_s + the modeled compute
    #                            segment since the previous charged event
    #                            (executors accrue it when run with
    #                            throughput=; sentinel -1 resolves to
    #                            est_wall_s, so without a model the sum
    #                            over a run IS the makespan, bit for bit)

    def __post_init__(self) -> None:
        if self.time_to_result_s < 0.0:
            object.__setattr__(self, "time_to_result_s", self.est_wall_s)

    @property
    def bytes_by_class(self) -> dict[str, int]:
        """Stage-3 bytes per distance class (sums to stayed + moved)."""
        return split_bytes_by_class(self.bytes_stayed, self.bytes_moved,
                                    self.bytes_cross_rack,
                                    self.bytes_cross_pod)


def record_parity_key(rec) -> tuple:
    """THE canonical per-event parity tuple for sim == live checks.

    Every agreement gate (the test suite, the example's smoke check)
    compares records through this one function, so adding a field to
    :class:`ScenarioRecord` extends every gate at once instead of
    silently weakening whichever copy was not updated.
    """
    return (rec.step, rec.kind, rec.mechanism, rec.nodes_before,
            rec.nodes_after, rec.est_wall_s, rec.downtime_s, rec.bytes_moved,
            rec.queued_s, rec.bytes_stayed, rec.bytes_cross_rack,
            rec.bytes_cross_pod, rec.bytes_checkpointed, rec.bytes_restored,
            rec.restored_s, rec.time_to_result_s)


@dataclass
class _SimCluster:
    """Device-free twin of the live runtime's bookkeeping.

    Mirrors :class:`repro_torch.elastic.ElasticRuntime` exactly — same world
    creation order, same greedy lowest-free-node acquisition — so the
    engine sees identical plans and charges identical timelines.
    """

    scenario: Scenario
    engine: ReconfigEngine
    state: ClusterState = field(default_factory=ClusterState)

    def __post_init__(self) -> None:
        pool = self.scenario.pool_nodes()
        self._free = set(range(pool))
        initial = list(range(self.scenario.initial_nodes))
        self._free -= set(initial)
        cpn = [self._width(n) for n in initial]
        self.state.add_world(initial, cpn, is_initial=True)

    def _width(self, node: int) -> int:
        if self.scenario.core_pool:
            return self.scenario.core_pool[node]
        return self.scenario.cores_per_node

    @property
    def n_nodes(self) -> int:
        return len(self.state.nodes_in_use())

    def ranks_in_use(self) -> int:
        return sum(w.size for w in self.state.worlds.values())

    def expand(self, target_nodes: int,
               queue_delay_s: float = 0.0) -> ScenarioRecord:
        before = self.n_nodes
        ns = self.ranks_in_use()
        need = target_nodes - before
        if need > len(self._free):
            # Same error, same message shape as ElasticRuntime.expand:
            # an overcommitting trace must fail identically in both
            # executors, never silently truncate in one of them.
            raise RuntimeError(
                f"device pool exhausted: expand to {target_nodes} nodes "
                f"needs {need} free nodes, pool has {len(self._free)}"
            )
        used_sorted = sorted(self.state.nodes_in_use())
        # Placement mirrors the live runtime exactly: the engine picks
        # which free nodes the expansion lands on (greedy lowest-id for
        # the classics, rack-local-first for topology-aware strategies).
        new_nodes = self.engine.select_expansion_nodes(
            used_sorted, self._free, need)
        nodes_all = used_sorted + new_nodes
        nt = ns + sum(self._width(n) for n in new_nodes)
        cores = self._cores_arg(nodes_all)
        plan = self.engine.plan_expand(
            ns, nt, cores, queue_delay_s=queue_delay_s, node_ids=nodes_all)
        outcome = self.engine.execute(plan)
        assert plan.spawn is not None
        in_use = self.state.nodes_in_use()
        queue = [n for n in plan.node_ids if n not in in_use]
        for g in plan.spawn.groups:
            # The NodeGroup substrate keeps worlds node-confined even for
            # classic strategies whose plan spawns one multi-node group
            # (their cost timeline is unchanged — one big spawn call);
            # the group is split one world per node, exactly as the live
            # runtime's apply_expand does, taking nodes in the plan's
            # placement order.
            remaining = g.size
            while remaining > 0:
                node = queue.pop(0) if queue else min(self._free)
                self._free.discard(node)
                take = min(self._width(node), remaining)
                self.state.add_world([node], [take])
                remaining -= take
        self.state.expansions_done += 1
        return ScenarioRecord(
            step=-1, kind="expand",
            mechanism=strategy_key(plan.spawn.strategy),
            nodes_before=before, nodes_after=self.n_nodes,
            est_wall_s=outcome.total_s, downtime_s=outcome.downtime_s,
            bytes_moved=outcome.bytes_moved, queued_s=outcome.queued_s,
            bytes_stayed=outcome.bytes_stayed,
            bytes_cross_rack=outcome.bytes_cross_rack,
            bytes_cross_pod=outcome.bytes_cross_pod,
            bytes_checkpointed=outcome.bytes_checkpointed,
            bytes_restored=outcome.bytes_restored,
            restored_s=outcome.restored_s,
        )

    def _cores_arg(self, nodes: list[int]):
        """Planner allocation argument in node order, normalized by the
        shared :meth:`ReconfigEngine.allocation_arg` rule both
        executors use."""
        return self.engine.allocation_arg([self._width(n) for n in nodes])

    def pick_release(self, n_release: int) -> list[int]:
        """Victims for a target-count shrink (the engine's decision)."""
        return self.engine.select_release_nodes(
            sorted(self.state.nodes_in_use()), n_release)

    def shrink_nodes(self, victims: list[int], kind: str,
                     queue_delay_s: float = 0.0) -> ScenarioRecord:
        before = self.n_nodes
        plan = self.engine.plan_shrink(self.state, release_nodes=victims,
                                       queue_delay_s=queue_delay_s,
                                       failed=(kind == FAIL))
        outcome = self.engine.execute(plan)
        assert plan.shrink is not None
        apply_shrink(self.state, plan.shrink)
        self._free.update(plan.shrink.nodes_returned)
        return ScenarioRecord(
            step=-1, kind=kind, mechanism=plan.shrink.kind.value,
            nodes_before=before, nodes_after=self.n_nodes,
            est_wall_s=outcome.total_s, downtime_s=outcome.downtime_s,
            bytes_moved=outcome.bytes_moved, queued_s=outcome.queued_s,
            bytes_stayed=outcome.bytes_stayed,
            bytes_cross_rack=outcome.bytes_cross_rack,
            bytes_cross_pod=outcome.bytes_cross_pod,
            bytes_checkpointed=outcome.bytes_checkpointed,
            bytes_restored=outcome.bytes_restored,
            restored_s=outcome.restored_s,
        )

    def checkpoint(self, queue_delay_s: float = 0.0) -> ScenarioRecord:
        """Charge one full-state checkpoint (no allocation change),
        mirroring :meth:`repro_torch.elastic.ElasticRuntime.checkpoint`."""
        before = self.n_nodes
        plan = self.engine.plan_checkpoint(self.ranks_in_use(),
                                           queue_delay_s=queue_delay_s)
        outcome = self.engine.execute(plan)
        return ScenarioRecord(
            step=-1, kind="checkpoint", mechanism="ckpt",
            nodes_before=before, nodes_after=self.n_nodes,
            est_wall_s=outcome.total_s, downtime_s=outcome.downtime_s,
            queued_s=outcome.queued_s,
            bytes_checkpointed=outcome.bytes_checkpointed,
        )

    def restart(self, target_nodes: int,
                queue_delay_s: float = 0.0) -> ScenarioRecord:
        """Full-stop checkpoint/restart, mirroring
        :meth:`repro_torch.elastic.ElasticRuntime.restart` exactly: same
        lowest-id-prefix placement over the momentarily-all-free pool,
        same error messages, same record fields."""
        before = self.n_nodes
        if target_nodes <= 0:
            raise ValueError("restart() requires target_nodes >= 1")
        candidates = sorted(set(self.state.nodes_in_use()) | self._free)
        if target_nodes > len(candidates):
            raise RuntimeError(
                f"device pool exhausted: restart to {target_nodes} nodes "
                f"exceeds the {len(candidates)} nodes available"
            )
        new_nodes = candidates[:target_nodes]
        ns = self.ranks_in_use()
        nt = sum(self._width(n) for n in new_nodes)
        plan = self.engine.plan_restart(ns, nt, queue_delay_s=queue_delay_s,
                                        node_ids=new_nodes)
        outcome = self.engine.execute(plan)
        # Full stop: every world dies and its nodes free up, then one
        # node-confined world per target node comes back — the same
        # rebuild ElasticRuntime.apply_restart performs.
        for wid in list(self.state.worlds):
            w = self.state.worlds.pop(wid)
            self._free.update(w.nodes)
        for node in new_nodes:
            self._free.discard(node)
            self.state.add_world([node], [self._width(node)])
        return ScenarioRecord(
            step=-1, kind="restart", mechanism="ss",
            nodes_before=before, nodes_after=self.n_nodes,
            est_wall_s=outcome.total_s, downtime_s=outcome.downtime_s,
            queued_s=outcome.queued_s,
            bytes_checkpointed=outcome.bytes_checkpointed,
            bytes_restored=outcome.bytes_restored,
            restored_s=outcome.restored_s,
        )


def dispatch_event(
    cluster, kind: str, *, nodes: tuple[int, ...] = (), target_nodes: int = 0,
    queue_delay_s: float = 0.0,
) -> Iterable[ScenarioRecord]:
    """THE event-to-action mapping, shared by every executor.

    ``cluster`` is anything with ``n_nodes``, ``state``, ``expand``,
    ``shrink_nodes``, ``pick_release``, ``checkpoint`` and ``restart``
    — the device-free sim cluster,
    or a live runtime behind :class:`RuntimeAdapter` (used by both
    :func:`run_scenario_live` and :class:`repro_torch.elastic.ElasticTrainer`).

    A SHRINK with no explicit victim ``nodes`` but a smaller
    ``target_nodes`` lets the engine choose the victims
    (``pick_release``): highest ids for the classics, whole racks first
    for topology-aware strategies."""
    if kind == GROW:
        if target_nodes > cluster.n_nodes:
            yield cluster.expand(target_nodes, queue_delay_s=queue_delay_s)
    elif kind == SHRINK:
        victims = [n for n in nodes if n in cluster.state.nodes_in_use()]
        if not victims and not nodes and 0 < target_nodes < cluster.n_nodes:
            victims = list(cluster.pick_release(cluster.n_nodes - target_nodes))
            vset = set(victims)
            blockers = sorted(
                w.wid for w in cluster.state.worlds.values()
                if set(w.nodes) & vset and not set(w.nodes) <= vset
            )
            if blockers:
                # A victim inside a multi-node world can only be
                # zombified (§4.7): its node stays pinned and the
                # declared target is silently missed.  Fail loudly —
                # identically in both executors — instead.
                raise ValueError(
                    f"shrink to {target_nodes} nodes cannot be met: "
                    f"victims {victims} partially overlap multi-node "
                    f"worlds {blockers} (ZS would pin their nodes); "
                    "name explicit victim nodes instead"
                )
        if victims:
            yield cluster.shrink_nodes(victims, kind="shrink",
                                       queue_delay_s=queue_delay_s)
    elif kind in (FAIL, STRAGGLER):
        for n in nodes:
            if n in cluster.state.nodes_in_use():
                yield cluster.shrink_nodes([n], kind=kind,
                                           queue_delay_s=queue_delay_s)
    elif kind == CHECKPOINT:
        yield cluster.checkpoint(queue_delay_s=queue_delay_s)
    elif kind == RESTART:
        yield cluster.restart(target_nodes or cluster.n_nodes,
                              queue_delay_s=queue_delay_s)
    else:
        raise ValueError(f"unknown scenario event kind {kind!r}")


def _dispatch(cluster, ev: ScenarioEvent) -> Iterable[ScenarioRecord]:
    return dispatch_event(cluster, ev.kind, nodes=ev.nodes,
                          target_nodes=ev.target_nodes,
                          queue_delay_s=ev.queue_delay_s)


class RuntimeAdapter:
    """Present a live :class:`~repro_torch.elastic.ElasticRuntime` through the
    dispatch interface, converting its records to :class:`ScenarioRecord`."""

    def __init__(self, runtime) -> None:
        self._rt = runtime

    @property
    def state(self):
        return self._rt.state

    @property
    def n_nodes(self) -> int:
        return self._rt.n_nodes

    @staticmethod
    def _convert(rec) -> ScenarioRecord:
        return ScenarioRecord(
            step=-1, kind=rec.kind, mechanism=rec.mechanism,
            nodes_before=rec.nodes_before, nodes_after=rec.nodes_after,
            est_wall_s=rec.est_wall_s, downtime_s=rec.downtime_s,
            bytes_moved=rec.bytes_moved, queued_s=rec.queued_s,
            bytes_stayed=rec.bytes_stayed,
            bytes_cross_rack=rec.bytes_cross_rack,
            bytes_cross_pod=rec.bytes_cross_pod,
            bytes_checkpointed=rec.bytes_checkpointed,
            bytes_restored=rec.bytes_restored,
            restored_s=rec.restored_s,
        )

    def expand(self, target_nodes: int,
               queue_delay_s: float = 0.0) -> ScenarioRecord:
        return self._convert(
            self._rt.expand(target_nodes, queue_delay_s=queue_delay_s))

    def pick_release(self, n_release: int) -> list[int]:
        """Victims for a target-count shrink (the engine's decision)."""
        return self._rt.engine.select_release_nodes(
            sorted(self._rt.state.nodes_in_use()), n_release)

    def shrink_nodes(self, victims: list[int], kind: str,
                     queue_delay_s: float = 0.0) -> ScenarioRecord:
        if kind == FAIL and len(victims) == 1:
            rec = self._rt.fail_node(victims[0], queue_delay_s=queue_delay_s)
        elif kind == STRAGGLER and len(victims) == 1:
            rec = self._rt.drop_straggler(victims[0],
                                          queue_delay_s=queue_delay_s)
        else:
            rec = self._rt.shrink_nodes(victims, queue_delay_s=queue_delay_s)
        return self._convert(rec)

    def checkpoint(self, queue_delay_s: float = 0.0) -> ScenarioRecord:
        return self._convert(
            self._rt.checkpoint(queue_delay_s=queue_delay_s))

    def restart(self, target_nodes: int,
                queue_delay_s: float = 0.0) -> ScenarioRecord:
        return self._convert(
            self._rt.restart(target_nodes, queue_delay_s=queue_delay_s))


def resolve_engine(
    scenario: Scenario,
    engine: Optional[ReconfigEngine] = None,
    *,
    strategy=None,
    cost_model=None,
) -> ReconfigEngine:
    """THE executor-shared engine resolution (the normalized keywords).

    Every ``run_scenario_*`` executor accepts the same keyword-only
    ``strategy=`` / ``cost_model=`` overrides and resolves them here:
    no ``engine`` builds the scenario's default (with the strategy
    override applied); an explicit ``engine`` is re-targeted with
    ``dataclasses.replace``, so overrides compose identically whichever
    executor — or :func:`repro_torch.malleability.policies.run_multijob_sim` —
    forwarded them.
    """
    if engine is None:
        engine = scenario.default_engine(strategy=strategy)
    elif strategy is not None:
        engine = replace(engine, strategy=strategy)
    if cost_model is not None:
        engine = replace(engine, cost_model=cost_model)
    return engine


def _segment_clock(
    scenario: Scenario, throughput: "Optional[ThroughputModel]",
) -> Optional[Callable[[int], float]]:
    """Memoized modeled step time per allocation node count.

    THE shared width resolution for segment accrual: every executor —
    object, vectorized, live — and :func:`~repro_torch.malleability.throughput
    .time_to_result` price a ``count``-node allocation as the node-id
    prefix of the model's ``node_widths`` (falling back to the
    scenario's ``core_pool`` / ``cores_per_node``), so the accrued
    ``time_to_result_s`` agrees bit for bit across paths.  ``None``
    when no model is given (accrual off).
    """
    if throughput is None:
        return None
    memo: dict[int, float] = {}

    def step_time(count: int) -> float:
        t = memo.get(count)
        if t is None:
            t = memo[count] = throughput.step_time(throughput.widths_for(
                count, core_pool=scenario.core_pool,
                default_width=scenario.cores_per_node))
        return t

    return step_time


def run_scenario_sim(
    scenario: Scenario,
    engine: Optional[ReconfigEngine] = None,
    *,
    strategy=None,
    cost_model=None,
    throughput: "Optional[ThroughputModel]" = None,
) -> list[ScenarioRecord]:
    """Execute a scenario on the timeline-charging simulator backend.

    ``strategy=`` / ``cost_model=`` are the normalized keyword overrides
    (see :func:`resolve_engine`); passing ``engine`` positionally keeps
    working.  ``throughput=`` accrues each record's modeled compute
    segment — ``(steps since the last charged event) x
    step_time(allocation before the event)`` — into
    ``time_to_result_s`` on top of the charged wall.
    """
    engine = resolve_engine(scenario, engine, strategy=strategy,
                            cost_model=cost_model)
    cluster = _SimCluster(scenario=scenario, engine=engine)
    records: list[ScenarioRecord] = []
    step_time = _segment_clock(scenario, throughput)
    last = 0
    for ev in sorted(scenario.events, key=lambda e: e.step):
        for rec in _dispatch(cluster, ev):
            if step_time is None:
                records.append(replace(rec, step=ev.step))
            else:
                seg = (ev.step - last) * step_time(rec.nodes_before)
                last = ev.step
                records.append(replace(
                    rec, step=ev.step,
                    time_to_result_s=rec.time_to_result_s + seg))
    return records


# ==================================================== vectorized fast path ==
class TransitionCache:
    """Memoized transition charging for :func:`run_scenario_vectorized`.

    Keyed by ``(kind, nodes_before, nodes_after, queue_delay_s)``: under
    the fast path's eligibility gates (uniform node widths, no topology,
    prefix-range node usage) that tuple fully determines the charged
    record, so a churn trace that revisits the same resize pays for it
    once.  Sharing one cache across several runs is only valid when
    every run charges with the same cost context (same widths, cost
    model, strategy, method, bytes model) — :func:`repro_torch.malleability
    .policies.monte_carlo_sweep` does exactly that for its seed
    replicas.
    """

    def __init__(self) -> None:
        self._fields: dict[tuple, dict] = {}
        self.hits = 0
        self.misses = 0

    def charge_fields(self, scenario: Scenario, engine: ReconfigEngine,
                      kind: str, before: int, after: int,
                      queue_delay_s: float) -> dict:
        """The cached record's field dict (``step`` pinned to ``-1``).

        The hot stamping loop binds a copy of it onto a bare
        ``ScenarioRecord.__new__`` instance and overwrites ``step`` —
        bypassing both ``dataclasses.replace`` and the frozen
        dataclass ``__init__`` (sixteen ``object.__setattr__`` calls),
        which together dominated the 100k-event profile.
        """
        key = (kind, before, after, queue_delay_s)
        fields = self._fields.get(key)
        if fields is not None:
            self.hits += 1
            return fields
        self.misses += 1
        rec = _charge_transition(scenario, engine, kind, before, after,
                                 queue_delay_s)
        fields = dict(rec.__dict__)
        fields["step"] = -1
        self._fields[key] = fields
        return fields

    def charge(self, scenario: Scenario, engine: ReconfigEngine, kind: str,
               before: int, after: int, queue_delay_s: float) -> ScenarioRecord:
        rec = ScenarioRecord.__new__(ScenarioRecord)
        rec.__dict__.update(self.charge_fields(
            scenario, engine, kind, before, after, queue_delay_s))
        return rec


def _charge_transition(scenario: Scenario, engine: ReconfigEngine, kind: str,
                       before: int, after: int,
                       queue_delay_s: float) -> ScenarioRecord:
    """Charge one uniform-width prefix-range transition (cache miss).

    Hot shapes take the closed-form chargers from
    :mod:`repro_torch.core.vectorized` (a MERGE hypercube expansion, a TS
    shrink of single-node worlds) — the same event sequence the planner
    and builder would emit, without constructing the plan.  Everything
    else synthesizes the canonical prefix-range cluster at ``before``
    nodes and dispatches through the object path, so the cached record
    is the object path's record.
    """
    from repro_torch.core.vectorized import (
        charge_stats,
        hypercube_expand_charges,
        queue_charge,
        redistribution_charge,
        ts_shrink_charges,
    )

    cm = engine.cost_model
    assert cm is not None  # resolved in ReconfigEngine.__post_init__
    C = scenario.cores_per_node
    ns, nt = before * C, after * C
    if kind == "expand":
        analytic = (engine.method is Method.MERGE
                    and strategy_key(engine.strategy) == "hypercube")
        mechanism = strategy_key(engine.strategy)
    else:
        # Tier-A victims are whole single-node worlds, so the shrink
        # planner always resolves to TS (§4.6) whatever the strategy.
        analytic = True
        mechanism = ShrinkKind.TS.value
    if analytic:
        if kind == "expand":
            mech = hypercube_expand_charges(cm, ns, nt, C)
        else:
            mech = ts_shrink_charges(cm, [C] * (before - after))
        stayed, moved = engine.redistribution_stats(ns, nt)
        charges = (queue_charge(queue_delay_s) + mech
                   + redistribution_charge(cm, moved, stayed))
        st = charge_stats(charges, contention=cm.overlap_contention,
                          asynchronous=engine.asynchronous)
        return ScenarioRecord(
            step=-1, kind=kind, mechanism=mechanism,
            nodes_before=before, nodes_after=after,
            est_wall_s=st.total, downtime_s=st.downtime,
            bytes_moved=st.bytes_moved, queued_s=st.queued,
            bytes_stayed=st.bytes_stayed,
            bytes_cross_rack=st.bytes_cross_rack,
            bytes_cross_pod=st.bytes_cross_pod,
        )
    cluster = _SimCluster(scenario=scenario, engine=engine)
    for n in range(scenario.initial_nodes, before):
        cluster._free.discard(n)
        cluster.state.add_world([n], [cluster._width(n)])
    if kind == "expand":
        return cluster.expand(after, queue_delay_s=queue_delay_s)
    return cluster.shrink_nodes(list(range(after, before)), kind=kind,
                                queue_delay_s=queue_delay_s)


def _vector_plan(scenario: Scenario,
                 engine: ReconfigEngine) -> Optional[list[tuple]]:
    """Compile a trace to ``(step, kind, before, after, qd)`` transitions.

    Returns None when the trace leaves the fast path's domain — uneven
    node widths, a topology-carrying engine (placement-priced plans),
    or any event whose node usage stops being the prefix range
    ``0..count-1`` (e.g. a mid-range failure) — in which case the caller
    must walk the object path.  The gates are exactly the invariants
    that make ``(kind, before, after, qd)`` determine the record.
    """
    if scenario.core_pool or engine.topology is not None:
        return None
    if engine.restore_on_fail:
        # FAIL recovery charges a trailing RESTORE leg the closed-form
        # chargers do not model; walk the object path.
        return None
    # Only a declared rack tree can cap the pool below the trace's peak
    # (pool_nodes() otherwise IS the peak, which no grow can exceed) —
    # checking topology() directly skips an O(events) max_nodes() scan.
    topo = scenario.topology()
    pool = topo.n_nodes if topo is not None else None
    floor = max(1, scenario.initial_nodes)
    count = scenario.initial_nodes
    out: list[tuple] = []
    for ev in sorted(scenario.events, key=lambda e: e.step):
        if ev.kind == GROW:
            if ev.target_nodes <= count:
                continue
            if pool is not None and ev.target_nodes > pool:
                return None  # object path raises "device pool exhausted"
            out.append((ev.step, "expand", count, ev.target_nodes,
                        ev.queue_delay_s))
            count = ev.target_nodes
        elif ev.kind == SHRINK:
            nodes = ev.nodes
            if nodes:
                lo = count - len(nodes)
                if lo >= floor and nodes == tuple(range(lo, count)):
                    after = lo  # contiguous top range, all in use
                else:
                    victims = [n for n in nodes if n < count]
                    if not victims:
                        continue
                    after = count - len(victims)
                    if (after < floor or min(victims) != after
                            or len(set(victims)) != len(victims)):
                        # Not exactly the top range {after..count-1}:
                        # the prefix invariant would break.
                        return None
            else:
                if not 0 < ev.target_nodes < count:
                    continue
                if ev.target_nodes < floor:
                    return None  # pick_release would split the initial world
                after = ev.target_nodes
            out.append((ev.step, "shrink", count, after, ev.queue_delay_s))
            count = after
        elif ev.kind in (FAIL, STRAGGLER):
            for n in ev.nodes:
                if n >= count:
                    continue
                if n != count - 1 or count - 1 < floor:
                    return None  # mid-range victim breaks the prefix
                out.append((ev.step, ev.kind, count, count - 1,
                            ev.queue_delay_s))
                count -= 1
        else:
            return None  # unknown kind: let the object path raise
    return out


def run_scenario_vectorized(
    scenario: Scenario, engine: Optional[ReconfigEngine] = None,
    cache: Optional[TransitionCache] = None,
    *,
    strategy=None,
    cost_model=None,
    throughput: "Optional[ThroughputModel]" = None,
) -> list[ScenarioRecord]:
    """Execute a scenario through the vectorized transition engine.

    Produces records **bit-for-bit identical** to
    :func:`run_scenario_sim` (pinned over the full registry by
    ``tests/test_vectorized.py``) by compiling the trace to count-state
    transitions, charging each distinct transition once (closed-form
    where the shape allows, object-path synthesis otherwise) and
    stamping cached records per event.  Traces outside the fast path's
    domain fall back to the object walk wholesale, so this is a safe
    drop-in for every scenario.

    Pass a shared :class:`TransitionCache` to amortize charging across
    runs that share a cost context (e.g. Monte-Carlo seed replicas).
    ``strategy=`` / ``cost_model=`` are the normalized keyword overrides
    (see :func:`resolve_engine`).  ``throughput=`` accrues modeled
    compute segments exactly as :func:`run_scenario_sim` does — the
    cached field dicts stay model-independent (they carry the sentinel
    ``time_to_result_s == est_wall_s``) and the segment is added at
    stamping time, so a shared cache stays valid across models.
    """
    engine = resolve_engine(scenario, engine, strategy=strategy,
                            cost_model=cost_model)
    plan = _vector_plan(scenario, engine)
    if plan is None:
        return run_scenario_sim(scenario, engine, throughput=throughput)
    cache = cache if cache is not None else TransitionCache()
    # Hot loop: hits read the cache dict directly (no method-call
    # overhead); only misses go through charge_fields for the full
    # charging + bookkeeping path.
    charge_fields = cache.charge_fields
    lookup = cache._fields.get
    new = ScenarioRecord.__new__
    out: list[ScenarioRecord] = []
    append = out.append
    hits = 0
    step_time = _segment_clock(scenario, throughput)
    if step_time is not None:
        # Plan steps are sorted and one record is stamped per tuple, so
        # each record's accrued segment is its step delta times the
        # step time of the allocation it left — vectorized as one
        # np.diff product.  ``tolist()`` matters: Python floats keep
        # record reprs (and the churn-trace parity digest) byte-stable.
        from repro_torch.core.vectorized import segment_times

        seg = segment_times([p[0] for p in plan],
                            [step_time(p[2]) for p in plan]).tolist()
        for i, (step, kind, before, after, qd) in enumerate(plan):
            fields = lookup((kind, before, after, qd))
            if fields is None:
                fields = charge_fields(scenario, engine, kind, before,
                                       after, qd)
            else:
                hits += 1
            rec = new(ScenarioRecord)
            d = rec.__dict__
            d.update(fields)
            d["step"] = step
            d["time_to_result_s"] = fields["time_to_result_s"] + seg[i]
            append(rec)
        cache.hits += hits
        return out
    for step, kind, before, after, qd in plan:
        fields = lookup((kind, before, after, qd))
        if fields is None:
            fields = charge_fields(scenario, engine, kind, before, after, qd)
        else:
            hits += 1
        rec = new(ScenarioRecord)
        d = rec.__dict__
        d.update(fields)
        d["step"] = step
        append(rec)
    cache.hits += hits
    return out


def scenario_pool(scenario: Scenario, devices=None):
    """Build the live :class:`~repro_torch.elastic.node_group.DevicePool` a
    scenario expects: uniform ``cores_per_node``-wide nodes, or the
    scenario's uneven ``core_pool`` width vector, carrying the trace's
    declared rack topology (if any).  ``devices=None`` fabricates
    bookkeeping-only fake device objects sized to the pool.
    """
    from repro_torch.elastic.node_group import DevicePool

    topo = scenario.topology()
    if scenario.core_pool:
        if devices is None:
            devices = [object() for _ in range(sum(scenario.core_pool))]
        return DevicePool(devices=devices, node_widths=scenario.core_pool,
                          topology=topo)
    cpn = scenario.cores_per_node
    if topo is not None:
        # Uniform widths, but the rack tree fixes the node count (it may
        # exceed the trace's peak: spare whole racks are legitimate).
        widths = (cpn,) * topo.n_nodes
        if devices is None:
            devices = [object() for _ in range(sum(widths))]
        return DevicePool(devices=devices, node_widths=widths, topology=topo)
    if devices is None:
        devices = [object() for _ in range(scenario.max_nodes() * cpn)]
    return DevicePool(devices=devices, devices_per_node=cpn)


def check_scenario_pool(scenario: Scenario, pool) -> None:
    """Raise unless a caller-supplied pool can replay ``scenario`` in
    lockstep with the simulator.

    Both executors derive plans from node widths, so a pool whose
    widths disagree with the scenario's (``core_pool``, or the uniform
    ``cores_per_node``) would not error — it would silently produce
    different timelines and break the sim == live parity every consumer
    relies on.  Fail loudly instead.
    """
    n = scenario.max_nodes()
    if pool.n_nodes < n:
        raise ValueError(
            f"scenario {scenario.name!r} peaks at {n} nodes but the pool "
            f"only has {pool.n_nodes}"
        )
    widths = tuple(pool.node_widths[:n])
    expect = (tuple(scenario.core_pool[:n]) if scenario.core_pool
              else (scenario.cores_per_node,) * n)
    if widths != expect:
        raise ValueError(
            f"pool widths {widths} do not match scenario "
            f"{scenario.name!r} widths {expect}; the live runtime would "
            "plan different timelines than the simulator"
        )
    topo = scenario.topology()
    if topo is not None and pool.topology != topo:
        raise ValueError(
            f"pool topology {pool.topology} does not match scenario "
            f"{scenario.name!r} topology {topo}; placement and "
            "distance-class pricing would silently diverge from the "
            "simulator"
        )


def run_scenario_live(
    scenario: Scenario,
    pool=None,
    engine: Optional[ReconfigEngine] = None,
    *,
    strategy=None,
    cost_model=None,
    throughput: "Optional[ThroughputModel]" = None,
) -> list[ScenarioRecord]:
    """Execute a scenario against the live NodeGroup runtime.

    Bookkeeping-only (fake devices by default): exercises the identical
    engine/backend path the :class:`ElasticTrainer` uses, without JAX
    compilation, so tests can assert sim/live timeline agreement cheaply.
    Heterogeneous traces run too: the pool is partitioned with the
    scenario's uneven ``core_pool`` width vector.  ``strategy=`` /
    ``cost_model=`` are the normalized keyword overrides (see
    :func:`resolve_engine`); ``throughput=`` accrues modeled compute
    segments into ``time_to_result_s`` exactly as the simulator does.
    """
    from repro_torch.elastic.runtime import ElasticRuntime

    engine = resolve_engine(scenario, engine, strategy=strategy,
                            cost_model=cost_model)
    if pool is None:
        pool = scenario_pool(scenario)
    else:
        check_scenario_pool(scenario, pool)
    rt = ElasticRuntime(pool=pool, initial_nodes=scenario.initial_nodes,
                        engine=engine)
    adapter = RuntimeAdapter(rt)
    records: list[ScenarioRecord] = []
    step_time = _segment_clock(scenario, throughput)
    last = 0
    for ev in sorted(scenario.events, key=lambda e: e.step):
        for rec in _dispatch(adapter, ev):
            if step_time is None:
                records.append(replace(rec, step=ev.step))
            else:
                seg = (ev.step - last) * step_time(rec.nodes_before)
                last = ev.step
                records.append(replace(
                    rec, step=ev.step,
                    time_to_result_s=rec.time_to_result_s + seg))
    return records
