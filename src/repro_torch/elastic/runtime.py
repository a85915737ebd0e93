"""ElasticRuntime: the paper's reconfiguration pipeline on live state
(ports :mod:`repro.elastic.runtime`).

A live :class:`~repro_torch.core.engine.ExecutionBackend`: the
:class:`~repro_torch.core.engine.ReconfigEngine` plans every resize through its
strategy registry and charges the event timeline; this backend applies
the same plan objects to real device groups:

  1. feasibility        — the (simulated) RMS grants/reclaims nodes;
  2. process management — a SpawnPlan brings NodeGroups up (hypercube for
                          homogeneous pools, diffusive for heterogeneous /
                          uneven-width pools), TS terminates whole groups;
  3. data redistribution— the caller reshards its pytrees onto the new
                          mesh (see :mod:`repro_torch.elastic.reshard`);
  4. resume             — the caller's step goes on (nothing is compiled
                          per mesh here).

Reconfiguration *cost* is read off the engine's timeline: the slots are
logical and one card computes every world (see
:mod:`repro_torch.elastic.node_group`), so every record carries the
modelled wall time an MPI cluster would observe (the cost model's
profile), not a time measured on the card — the same timeline the
simulator reports, by construction.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

from repro_torch.core import (
    ClusterState,
    Method,
    ReconfigEngine,
    ReconfigPlan,
    Strategy,
    apply_shrink,
    strategy_key,
)
from repro_torch.core.topology import split_bytes_by_class
from repro_torch.malleability import MN5, CostModel
from repro_torch.parallel.sharding import Mesh, mesh_of

from .node_group import DevicePool, NodeGroup


@dataclass(frozen=True)
class ReconfigRecord:
    """One reconfiguration as observed by the live runtime.

    Every cost field is a read of the engine's charged timeline — the
    same timeline the simulator reports — so the two layers agree by
    construction.
    """

    kind: str                  # expand | shrink | fail | straggler
    #                          # | checkpoint | restart
    mechanism: str             # strategy or TS/ZS/SS (ckpt for checkpoints)
    nodes_before: int
    nodes_after: int
    est_wall_s: float          # timeline total (simulated reconfiguration cost)
    downtime_s: float          # timeline downtime (partial ASYNC overlap)
    steps: int = 0             # spawn rounds (expansions)
    groups: int = 0
    nodes_returned: tuple[int, ...] = ()
    nodes_pinned: tuple[int, ...] = ()
    bytes_moved: int = 0       # stage-3 cross-link bytes charged on the timeline
    queued_s: float = 0.0      # RMS arbitration wait charged (QUEUE span)
    bytes_stayed: int = 0      # stage-3 local-link bytes charged on the timeline
    bytes_cross_rack: int = 0  # rack-crossing portion of bytes_moved
    bytes_cross_pod: int = 0   # pod-crossing slice of bytes_cross_rack
    bytes_checkpointed: int = 0  # snapshot bytes streamed to the store
    bytes_restored: int = 0    # bytes read back from the store (RESTORE)
    restored_s: float = 0.0    # RESTORE span charged on the timeline

    @property
    def bytes_by_class(self) -> dict[str, int]:
        """Stage-3 bytes per distance class (sums to stayed + moved)."""
        return split_bytes_by_class(self.bytes_stayed, self.bytes_moved,
                                    self.bytes_cross_rack,
                                    self.bytes_cross_pod)


class ElasticRuntime:
    """Owns the NodeGroup registry and rebuilds meshes across resizes.

    Args:
        pool: slot pool partitioned into nodes (defaults to one slot on
            the card, one node).
        method / strategy / cost_model / asynchronous: engine knobs —
            only valid when no explicit ``engine`` is passed.
        initial_nodes: nodes acquired for the initial world.
        engine: a configured :class:`ReconfigEngine` (e.g. carrying a
            bytes model); mutually exclusive with the engine knobs.
    """

    def __init__(
        self,
        pool: Optional[DevicePool] = None,
        method: Method = Method.MERGE,
        strategy: Strategy = Strategy.PARALLEL_HYPERCUBE,
        cost_model: CostModel = MN5,
        asynchronous: bool = False,
        initial_nodes: int = 1,
        engine: Optional[ReconfigEngine] = None,
    ):
        self.pool = pool or DevicePool()
        if engine is not None:
            overridden = [
                name for name, value, default in (
                    ("method", method, Method.MERGE),
                    ("strategy", strategy, Strategy.PARALLEL_HYPERCUBE),
                    ("cost_model", cost_model, MN5),
                    ("asynchronous", asynchronous, False),
                )
                if value is not default and value != default
            ]
            if overridden:
                raise ValueError(
                    f"pass {overridden} on the engine, not the runtime: an "
                    "explicit `engine` already carries those knobs and the "
                    "runtime would silently ignore them"
                )
        if (engine is not None and engine.topology is not None
                and self.pool.topology is not None
                and engine.topology != self.pool.topology):
            raise ValueError(
                "engine and pool carry different topologies; placement "
                "and distance-class pricing would silently disagree"
            )
        if (engine is not None and engine.topology is not None
                and engine.topology.n_nodes < self.pool.n_nodes):
            raise ValueError(
                f"engine topology covers {engine.topology.n_nodes} nodes "
                f"but the pool partitions into {self.pool.n_nodes}; "
                "placement and distance-class pricing would fall off the "
                "rack tree mid-reconfiguration"
            )
        if (engine is not None and engine.topology is None
                and self.pool.topology is not None):
            # Adopt the pool's layout so an engine built without one
            # still prices distance classes over the real rack tree —
            # on a runtime-local copy, never by mutating the caller's
            # engine (which may outlive this pool).
            engine = dataclasses.replace(engine, topology=self.pool.topology)
        self.engine = engine or ReconfigEngine(
            method=method,
            strategy=strategy,
            asynchronous=asynchronous,
            cost_model=cost_model,
            topology=self.pool.topology,
        )
        self.cost_model = self.engine.cost_model
        self.state = ClusterState()
        self.groups: dict[int, NodeGroup] = {}   # wid -> NodeGroup
        self.history: list[ReconfigRecord] = []
        # initial allocation: one world; if it spans several nodes it is the
        # paper's problematic multi-node initial MCW (handled by §4.6 logic).
        nodes, devs = [], []
        for _ in range(initial_nodes):
            node, d = self.pool.acquire_any()
            nodes.append(node)
            devs.append(d)
        w = self.state.add_world(nodes, [len(d) for d in devs], is_initial=True)
        self.groups[w.wid] = NodeGroup(gid=w.wid, node=nodes[0], devices=tuple(
            dev for group in devs for dev in group
        ))

    # ------------------------------------------------------------------ mesh --
    @property
    def n_nodes(self) -> int:
        """Nodes currently in use by live worlds."""
        return len(self.state.nodes_in_use())

    @property
    def devices(self) -> list:
        """All live devices in Eq. 9 order (node-contiguous, gid ascending)."""
        ordered = sorted(self.groups.values(), key=lambda g: (min(
            self.state.worlds[g.gid].nodes), g.gid))
        return [d for g in ordered for d in g.devices]

    def mesh(self, axes: tuple[str, ...] = ("data",), shape: Optional[tuple[int, ...]] = None) -> Mesh:
        """Build a Mesh over the live slots (Eq. 9 order).

        Args:
            axes: mesh axis names (default the 1-D ``("data",)`` mesh).
            shape: optional slot-grid shape; defaults to 1-D over all
                live slots.
        Returns:
            A slot :class:`~repro_torch.parallel.sharding.Mesh` (not a
            ``jax.sharding.Mesh``) that stage 3 places state on.
        """
        return mesh_of(self.devices, axes, shape)

    # -------------------------------------------------- backend protocol --
    def apply_expand(self, plan: ReconfigPlan) -> None:
        """Bring up NodeGroups for the spawned groups (node-confined).

        Parallel strategies spawn node-confined groups 1:1; a classic
        strategy's single multi-node group is split one NodeGroup per
        node (the substrate's releasable unit), mirroring the simulator
        backend — the charged timeline still prices the plan's own spawn
        structure.  A plan carrying explicit ``node_ids`` (placement is
        the strategy's decision) has its new nodes acquired in exactly
        that order; without them the historical greedy lowest-id order
        applies.
        """
        assert plan.spawn is not None
        in_use = self.state.nodes_in_use()
        queue = [n for n in plan.node_ids if n not in in_use]
        for g in plan.spawn.groups:
            remaining = g.size
            while remaining > 0:
                if queue:
                    node = queue.pop(0)
                    devs = self.pool.acquire(node)
                else:
                    node, devs = self.pool.acquire_any()
                take = min(len(devs), remaining)
                w = self.state.add_world([node], [take])
                self.groups[w.wid] = NodeGroup(gid=w.wid, node=node, devices=devs)
                remaining -= take
        self.state.expansions_done += 1

    def apply_shrink(self, plan: ReconfigPlan) -> None:
        """Terminate doomed worlds, return their devices to the pool."""
        assert plan.shrink is not None
        doomed_wids = plan.shrink.doomed_wids()
        doomed_nodes = {
            wid: self.state.worlds[wid].nodes
            for wid in doomed_wids
            if wid in self.state.worlds
        }
        apply_shrink(self.state, plan.shrink)
        for wid in doomed_wids:
            group = self.groups.pop(wid, None)
            if group is not None:
                for node in doomed_nodes.get(wid, (group.node,)):
                    self.pool.release(node)

    # ---------------------------------------------------------------- expand --
    def ranks_in_use(self) -> int:
        """Live ranks (== devices) across all worlds."""
        return sum(w.size for w in self.state.worlds.values())

    def expand(self, target_nodes: int, *,
               queue_delay_s: float = 0.0) -> ReconfigRecord:
        """Grow the job to ``target_nodes`` NodeGroup-confined nodes.

        Plans through the engine's strategy registry against the pool's
        actual per-node width vector (uniform or uneven), applies the
        plan to the device pool, and charges the event timeline
        (including the stage-3 bytes from the engine's bytes model, if
        configured).  New nodes are taken lowest-id-first, the same
        greedy order the simulator backend uses, so both executors see
        identical A vectors and charge identical timelines.

        Args:
            target_nodes: new total node count (must exceed the current).
            queue_delay_s: RMS arbitration wait (the grant was queued
                behind an in-flight reconfiguration); charged as a
                leading QUEUE timeline event.
        Returns:
            The appended :class:`ReconfigRecord`.
        Raises:
            ValueError: if ``target_nodes`` does not grow the job.
            RuntimeError: if the pool has too few free nodes.
        """
        before = self.n_nodes
        if target_nodes <= before:
            raise ValueError("expand() requires target_nodes > current nodes")
        need = target_nodes - before
        free = self.pool.free
        if need > len(free):
            raise RuntimeError(
                f"device pool exhausted: expand to {target_nodes} nodes "
                f"needs {need} free nodes, pool has {len(free)}"
            )
        used_sorted = sorted(self.state.nodes_in_use())
        # Placement is the strategy's decision: greedy lowest-id for the
        # classics (the historical order), rack-local-first for
        # topology-aware strategies on a topologized engine.
        new_nodes = self.engine.select_expansion_nodes(used_sorted, free, need)
        nodes_all = used_sorted + new_nodes
        ns = self.ranks_in_use()
        nt = ns + sum(self.pool.width(n) for n in new_nodes)
        cores = self._cores_arg(nodes_all)
        plan = self.engine.plan_expand(ns, nt, cores,
                                       queue_delay_s=queue_delay_s,
                                       node_ids=nodes_all)
        outcome = self.engine.execute(plan, backend=self)

        spawn = plan.spawn
        assert spawn is not None
        rec = ReconfigRecord(
            kind="expand",
            mechanism=strategy_key(spawn.strategy),
            nodes_before=before,
            nodes_after=self.n_nodes,
            est_wall_s=outcome.total_s,
            downtime_s=outcome.downtime_s,
            steps=spawn.steps,
            groups=len(spawn.groups),
            bytes_moved=outcome.bytes_moved,
            queued_s=outcome.queued_s,
            bytes_stayed=outcome.bytes_stayed,
            bytes_cross_rack=outcome.bytes_cross_rack,
            bytes_cross_pod=outcome.bytes_cross_pod,
            bytes_checkpointed=outcome.bytes_checkpointed,
            bytes_restored=outcome.bytes_restored,
            restored_s=outcome.restored_s,
        )
        self.history.append(rec)
        return rec

    def _cores_arg(self, nodes: list[int]):
        """Planner allocation argument: the pool's A vector over
        ``nodes`` (node-id order), normalized by the shared
        :meth:`ReconfigEngine.allocation_arg` rule both executors use."""
        return self.engine.allocation_arg(
            [self.pool.width(n) for n in nodes])

    # ---------------------------------------------------------------- shrink --
    def shrink(self, n_nodes_to_release: int, kind: str = "shrink") -> ReconfigRecord:
        """TS-shrink ``n_nodes_to_release`` nodes chosen by the strategy.

        Victim choice is the engine's placement decision: highest-id
        nodes for the classics (the historical order), whole racks first
        for topology-aware strategies on a topologized engine.

        Args:
            n_nodes_to_release: how many nodes to return to the pool.
            kind: record label (``shrink`` / ``fail`` / ``straggler``).
        Returns:
            The appended :class:`ReconfigRecord`.
        """
        victims = self.engine.select_release_nodes(
            sorted(self.state.nodes_in_use()), n_nodes_to_release)
        return self.shrink_nodes(victims, kind=kind)

    def shrink_nodes(self, victims: list[int], kind: str = "shrink", *,
                     queue_delay_s: float = 0.0) -> ReconfigRecord:
        """TS-shrink specific node ids out of the job (see :meth:`shrink`).

        A ``kind="fail"`` shrink on an engine with ``restore_on_fail``
        additionally charges recovery of the lost shards from the last
        checkpoint (a trailing RESTORE event).
        """
        before = self.n_nodes
        plan = self.engine.plan_shrink(self.state, release_nodes=victims,
                                       queue_delay_s=queue_delay_s,
                                       failed=(kind == "fail"))
        outcome = self.engine.execute(plan, backend=self)
        assert plan.shrink is not None
        rec = ReconfigRecord(
            kind=kind,
            mechanism=plan.shrink.kind.value,
            nodes_before=before,
            nodes_after=self.n_nodes,
            est_wall_s=outcome.total_s,
            downtime_s=outcome.downtime_s,
            nodes_returned=plan.shrink.nodes_returned,
            nodes_pinned=plan.shrink.nodes_pinned,
            bytes_moved=outcome.bytes_moved,
            queued_s=outcome.queued_s,
            bytes_stayed=outcome.bytes_stayed,
            bytes_cross_rack=outcome.bytes_cross_rack,
            bytes_cross_pod=outcome.bytes_cross_pod,
            bytes_checkpointed=outcome.bytes_checkpointed,
            bytes_restored=outcome.bytes_restored,
            restored_s=outcome.restored_s,
        )
        self.history.append(rec)
        return rec

    # ---------------------------------------------------------- fault tolerance --
    def checkpoint(self, *, queue_delay_s: float = 0.0) -> ReconfigRecord:
        """Charge one full-state checkpoint (no allocation change).

        The snapshot size comes from the engine's bytes model
        (:meth:`~repro_torch.core.ReconfigEngine.checkpoint_bytes`); callers
        that actually persist state (the trainer's
        :class:`~repro_torch.checkpoint.CheckpointManager`) do so alongside
        this record.
        """
        before = self.n_nodes
        plan = self.engine.plan_checkpoint(self.ranks_in_use(),
                                           queue_delay_s=queue_delay_s)
        outcome = self.engine.execute(plan, backend=self)
        rec = ReconfigRecord(
            kind="checkpoint",
            mechanism="ckpt",
            nodes_before=before,
            nodes_after=self.n_nodes,
            est_wall_s=outcome.total_s,
            downtime_s=outcome.downtime_s,
            queued_s=outcome.queued_s,
            bytes_checkpointed=outcome.bytes_checkpointed,
        )
        self.history.append(rec)
        return rec

    def apply_restart(self, plan: ReconfigPlan) -> None:
        """Full stop + respawn: every world exits, the new one comes up.

        All nodes return to the pool first; the replacement world is
        then acquired in ``plan.node_ids`` order, one node-confined
        group per node (the same shape an initial allocation has, so
        subsequent TS shrinks work unchanged).
        """
        for wid in list(self.state.worlds):
            w = self.state.worlds.pop(wid)
            self.groups.pop(wid, None)
            for node in w.nodes:
                self.pool.release(node)
        for node in plan.node_ids:
            devs = self.pool.acquire(node)
            w = self.state.add_world([node], [len(devs)])
            self.groups[w.wid] = NodeGroup(gid=w.wid, node=node, devices=devs)

    def restart(self, target_nodes: int, *,
                queue_delay_s: float = 0.0) -> ReconfigRecord:
        """Full-stop checkpoint/restart to ``target_nodes`` nodes.

        The rigid baseline head-to-head against malleable resizing:
        checkpoint the whole state, stop every world, respawn at the
        target size (SS), restore from the store.  The new allocation
        takes the lowest-id ``target_nodes`` nodes of the whole pool
        (everything is momentarily free) — deterministic in both
        executors.
        """
        before = self.n_nodes
        if target_nodes <= 0:
            raise ValueError("restart() requires target_nodes >= 1")
        candidates = sorted(set(self.state.nodes_in_use()) | set(self.pool.free))
        if target_nodes > len(candidates):
            raise RuntimeError(
                f"device pool exhausted: restart to {target_nodes} nodes "
                f"exceeds the {len(candidates)} nodes available"
            )
        new_nodes = candidates[:target_nodes]
        ns = self.ranks_in_use()
        nt = sum(self.pool.width(n) for n in new_nodes)
        plan = self.engine.plan_restart(ns, nt, queue_delay_s=queue_delay_s,
                                        node_ids=new_nodes)
        outcome = self.engine.execute(plan, backend=self)
        rec = ReconfigRecord(
            kind="restart",
            mechanism="ss",
            nodes_before=before,
            nodes_after=self.n_nodes,
            est_wall_s=outcome.total_s,
            downtime_s=outcome.downtime_s,
            queued_s=outcome.queued_s,
            bytes_checkpointed=outcome.bytes_checkpointed,
            bytes_restored=outcome.bytes_restored,
            restored_s=outcome.restored_s,
        )
        self.history.append(rec)
        return rec

    # ------------------------------------------------------------------ fault --
    def fail_node(self, node: int, *, queue_delay_s: float = 0.0) -> ReconfigRecord:
        """Node failure == an RMS-forced TS shrink of that node's group.

        The paper's mechanism doubles as the recovery path: because every
        world is node-confined, losing a node loses exactly one group; the
        surviving groups keep a consistent state and the runtime simply
        reconfigures without it.
        """
        return self.shrink_nodes([node], kind="fail", queue_delay_s=queue_delay_s)

    def drop_straggler(self, node: int, *,
                       queue_delay_s: float = 0.0) -> ReconfigRecord:
        """Straggler mitigation: TS-shrink the slow group out of the job."""
        return self.shrink_nodes([node], kind="straggler",
                                 queue_delay_s=queue_delay_s)
