"""Latency model for MPI process-management primitives.

The constants are calibrated so the simulated §5 experiments land inside
the paper's reported envelopes (MN5 112-core nodes over InfiniBand,
NASP 20/52-core nodes over Ethernet):

  * parallel Merge expansion overhead  <= 1.13x (MN5) / 1.25x (NASP)
  * parallel Baseline expansion        up to ~1.73x (MN5)
  * TS shrink speedup                  >= 1387x (MN5) / >= 20x (NASP)

The *structure* of each formula is what matters for the reproduction —
`MPI_Comm_spawn` setup dominated by a per-call constant, per-node tree
launch, contention between concurrent calls at the launcher daemon,
log-depth connect phase — the constants just place us in the measured
regime.  All times in seconds.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from functools import cached_property
from typing import Mapping


@dataclass(frozen=True)
class CostModel:
    # -- MPI_Comm_spawn ------------------------------------------------------
    alpha_spawn: float = 0.20       # per spawn-call setup (PMIx exchange)
    beta_proc_local: float = 8.0e-4  # per process launched on one node
    gamma_tree: float = 5.0e-3      # per tree-hop of the daemon broadcast
    delta_contend: float = 8.0e-4   # serialization between concurrent calls
    oversub_penalty: float = 1.6    # slowdown while procs > cores on a node
    # Topology-priced spawn: optional per-call surcharges when the
    # launcher tree crosses a rack (gamma_rack) or additionally a pod
    # (gamma_pod, on top of the rack hop) between the spawning rank's
    # node and the spawned group's node.  Both default to None = the
    # historical flat-latency spawn charge, bit for bit; engines only
    # take the priced path when at least one is set.
    gamma_rack: float | None = None
    gamma_pod: float | None = None

    # -- ports / name service --------------------------------------------------
    t_port: float = 2.0e-3          # MPI_Open_port + MPI_Publish_name
    t_lookup: float = 1.0e-3        # MPI_Lookup_name

    # -- point-to-point / collectives -------------------------------------------
    t_token: float = 5.0e-6         # one sync token (send/recv)
    t_barrier_hop: float = 1.0e-5   # MPI_Barrier per log2(p) hop

    # -- connect / merge / split --------------------------------------------------
    alpha_connect: float = 2.0e-3   # MPI_Comm_accept/connect handshake
    beta_connect: float = 1.0e-6    # MPI_Intercomm_merge per rank
    alpha_split: float = 2.0e-3     # MPI_Comm_split setup
    beta_split: float = 5.0e-7      # per rank

    # -- termination paths ---------------------------------------------------------
    t_term_base: float = 2.0e-4     # TS: terminate token + world exit
    t_term_per_proc: float = 1.0e-7
    t_teardown_per_proc: float = 1.0e-3  # SS: old-world MPI_Finalize + RMS dealloc

    # -- data redistribution --------------------------------------------------------
    redist_bw: float = 10.0e9       # aggregate bytes/s between old and new ranks
    redist_alpha: float = 5.0e-3    # per-event setup (plan exchange, buffer pin)
    # Per-distance-class bandwidths generalizing the PR-4 local/cross
    # split (see repro_torch.core.topology.DISTANCE_CLASSES).  Bytes that stay
    # on a surviving device (``bytes_stayed``) ride the ``intra_node``
    # link (``redist_bw_local``); bytes that cross devices split between
    # ``intra_rack`` and ``cross_rack`` by the topology distance between
    # their source and destination nodes.  The class-specific bandwidths
    # fall back ``intra_rack``/``cross_rack`` -> ``redist_bw_cross`` ->
    # aggregate ``redist_bw`` (and ``cross_pod`` -> ``cross_rack``), so
    # the 2- and 3-class defaults (and the fully unset model) reproduce
    # the pre-topology numbers bit for bit.
    redist_bw_local: float | None = None
    redist_bw_cross: float | None = None
    redist_bw_intra_rack: float | None = None
    redist_bw_cross_rack: float | None = None
    redist_bw_cross_pod: float | None = None

    # -- checkpoint / restore ---------------------------------------------------
    # The full-stop alternative the malleable paths beat: a CHECKPOINT
    # stage writes the job's snapshot to the store, a RESTORE stage reads
    # it back.  Writes stream to a shared store at ``ckpt_bw`` (falls
    # back to the aggregate ``redist_bw``) after a per-snapshot setup
    # ``ckpt_alpha`` (falls back to ``redist_alpha``); restores are
    # priced through :meth:`redistribution` — per distance class, like
    # any stage-3 transfer.  ``ckpt_overlap`` is the async-checkpoint
    # fraction: snapshots are host copies written behind compute, so the
    # default 1.0 hides the whole write when the job runs ASYNC (restores
    # never hide — the app is down until its state is back).
    ckpt_bw: float | None = None
    ckpt_alpha: float | None = None
    ckpt_overlap: float = 1.0

    # -- partial overlap (stage x compute) -------------------------------------------
    # Fraction of each stage that can proceed under application compute when
    # the job runs ASYNC.  The defaults reproduce MaM's binary model (the
    # whole spawn phase hides, nothing else does); DMR-style partial overlap
    # is expressed by lowering spawn_overlap / raising the others.
    spawn_overlap: float = 1.0
    sync_overlap: float = 0.0
    connect_overlap: float = 0.0
    redist_overlap: float = 0.0
    # Contention factor for overlapped work: the hidden portion shares the
    # network/daemons with compute, so hiding a fraction f of an event still
    # costs f*(overlap_contention - 1) of its duration in lost app progress.
    # 1.0 = perfect hiding (the binary model); 2.0 = overlap buys nothing.
    overlap_contention: float = 1.0

    # ---------------------------------------------------------------- primitives --
    def spawn_call(self, procs: int, nodes: int) -> float:
        """One MPI_Comm_spawn launching ``procs`` over ``nodes`` nodes.

        The RMS launcher fans out over nodes in a tree and starts each
        node's processes locally, so per-node process count (not the
        total) is the linear term.
        """
        if procs <= 0:
            return 0.0
        per_node = math.ceil(procs / max(nodes, 1))
        return (
            self.alpha_spawn
            + self.beta_proc_local * per_node
            + self.gamma_tree * math.ceil(math.log2(nodes + 1))
        )

    def concurrent_round(self, calls: list[tuple[int, int]], oversubscribed: bool = False) -> float:
        """Spawn calls issued simultaneously by different parents.

        Calls proceed in parallel; the shared launcher daemon serializes a
        small per-call slice (delta_contend).
        """
        if not calls:
            return 0.0
        slowest = max(self.spawn_call(p, k) for p, k in calls)
        if oversubscribed:
            slowest *= self.oversub_penalty
        return slowest + self.delta_contend * (len(calls) - 1)

    @property
    def spawn_topology_priced(self) -> bool:
        """True when spawn calls carry distance-class surcharges."""
        return self.gamma_rack is not None or self.gamma_pod is not None

    def spawn_distance_penalty(self, distance_class: str) -> float:
        """Launcher-tree surcharge for one spawn call by distance class.

        ``intra_node`` / ``intra_rack`` spawns stay at the flat charge;
        a ``cross_rack`` spawn pays ``gamma_rack``; a ``cross_pod``
        spawn pays ``gamma_rack + gamma_pod`` (the pod hop rides on top
        of the rack hop).  Unset gammas contribute 0.0.
        """
        if distance_class in ("intra_node", "intra_rack"):
            return 0.0
        rack = self.gamma_rack or 0.0
        if distance_class == "cross_rack":
            return rack
        if distance_class == "cross_pod":
            return rack + (self.gamma_pod or 0.0)
        raise ValueError(f"unknown distance class {distance_class!r}")

    def concurrent_round_priced(
        self, calls: list[tuple[int, int, float]],
        oversubscribed: bool = False,
    ) -> float:
        """`concurrent_round` with a per-call distance surcharge.

        Each call is ``(procs, nodes, penalty_s)``.  With every penalty
        at 0.0 this reproduces :meth:`concurrent_round` exactly
        (``x + 0.0 == x`` for the non-negative charges involved).
        """
        if not calls:
            return 0.0
        slowest = max(self.spawn_call(p, k) + pen for p, k, pen in calls)
        if oversubscribed:
            slowest *= self.oversub_penalty
        return slowest + self.delta_contend * (len(calls) - 1)

    def barrier(self, procs: int) -> float:
        return self.t_barrier_hop * max(1, math.ceil(math.log2(max(procs, 2))))

    def connect_merge(self, merged_ranks: int) -> float:
        return self.alpha_connect + self.beta_connect * merged_ranks + self.t_lookup

    def comm_split(self, ranks: int) -> float:
        return self.alpha_split + self.beta_split * ranks

    def ts_terminate(self, worlds: list[int]) -> float:
        """TS: one release token per doomed world, worlds exit in parallel."""
        if not worlds:
            return 0.0
        return self.t_token + self.t_term_base + self.t_term_per_proc * max(worlds)

    def ss_respawn(self, nt: int, nodes: int, ns: int) -> float:
        """SS: spawn the smaller world, tear the old one down."""
        return (
            self.spawn_call(nt, nodes)
            + self.t_teardown_per_proc * ns
            + self.comm_split(nt)
        )

    # Bandwidth resolution is cached per instance: timeline charging
    # asks for the same resolved links on every event, and the fallback
    # chains below would otherwise be re-walked per event.  The model is
    # frozen, so a cached value can never go stale (``replace()`` makes
    # a fresh instance with an empty cache); ``functools.cached_property``
    # writes straight into ``__dict__``, bypassing the frozen guard.
    @cached_property
    def bw_local(self) -> float:
        """Resolved intra_node bandwidth (aggregate unless split)."""
        return self.redist_bw if self.redist_bw_local is None else self.redist_bw_local

    @cached_property
    def bw_cross(self) -> float:
        """Resolved cross-group bandwidth (aggregate unless split)."""
        return self.redist_bw if self.redist_bw_cross is None else self.redist_bw_cross

    @cached_property
    def bw_intra_rack(self) -> float:
        """Resolved intra_rack bandwidth (cross link unless split further)."""
        return (self.bw_cross if self.redist_bw_intra_rack is None
                else self.redist_bw_intra_rack)

    @cached_property
    def bw_cross_rack(self) -> float:
        """Resolved cross_rack bandwidth (cross link unless split further)."""
        return (self.bw_cross if self.redist_bw_cross_rack is None
                else self.redist_bw_cross_rack)

    @cached_property
    def bw_cross_pod(self) -> float:
        """Resolved cross_pod bandwidth (cross_rack link unless split)."""
        return (self.bw_cross_rack if self.redist_bw_cross_pod is None
                else self.redist_bw_cross_pod)

    @cached_property
    def class_bandwidths(self) -> dict[str, float]:
        """All four distance classes resolved once (cached)."""
        return {
            "intra_node": self.bw_local,
            "intra_rack": self.bw_intra_rack,
            "cross_rack": self.bw_cross_rack,
            "cross_pod": self.bw_cross_pod,
        }

    def bw_for_class(self, distance_class: str) -> float:
        """Bandwidth pricing one :data:`~repro_torch.core.topology
        .DISTANCE_CLASSES` entry (unknown classes raise)."""
        try:
            return self.class_bandwidths[distance_class]
        except KeyError:
            raise ValueError(
                f"unknown distance class {distance_class!r}"
            ) from None

    def redistribution_by_class(self, bytes_by_class: Mapping[str, int]) -> float:
        """Stage-3 wall time: each byte priced on its distance class.

        Zero bytes across every class means no redistribution event at
        all (no setup charge).  The *moved* classes (``intra_rack`` /
        ``cross_rack`` / ``cross_pod``) collapse into fewer divisions
        whenever their bandwidths are equal — floating-point
        associativity would otherwise make a cost-neutral rack or pod
        split drift in the last ulp, and the 2-class (and 3-class)
        models must reproduce the pre-generalization charges bit for
        bit.  The collapse merges *integer* byte counts, so it is
        exact.
        """
        for cls in bytes_by_class:
            if cls not in ("intra_node", "intra_rack", "cross_rack",
                           "cross_pod"):
                self.bw_for_class(cls)      # unknown classes always raise
        if all(b <= 0 for b in bytes_by_class.values()):
            return 0.0
        stayed = max(0, bytes_by_class.get("intra_node", 0))
        intra = max(0, bytes_by_class.get("intra_rack", 0))
        cross = max(0, bytes_by_class.get("cross_rack", 0))
        pod = max(0, bytes_by_class.get("cross_pod", 0))
        total = self.redist_alpha + stayed / self.bw_local
        if self.bw_cross_pod == self.bw_cross_rack:
            cross += pod        # exact int merge: pod rides the rack link
            pod = 0
        if self.bw_intra_rack == self.bw_cross_rack:
            total += (intra + cross) / self.bw_cross_rack
        else:
            total += intra / self.bw_intra_rack + cross / self.bw_cross_rack
        if pod:
            total += pod / self.bw_cross_pod
        return total

    @cached_property
    def bw_ckpt(self) -> float:
        """Resolved checkpoint-store bandwidth (aggregate unless split)."""
        return self.redist_bw if self.ckpt_bw is None else self.ckpt_bw

    @cached_property
    def alpha_ckpt(self) -> float:
        """Resolved per-snapshot setup charge."""
        return self.redist_alpha if self.ckpt_alpha is None else self.ckpt_alpha

    def checkpoint(self, snapshot_bytes: int) -> float:
        """CHECKPOINT wall time: stream one snapshot to the store.

        Zero bytes means no event at all (no setup charge), mirroring
        :meth:`redistribution_by_class`.
        """
        if snapshot_bytes <= 0:
            return 0.0
        return self.alpha_ckpt + snapshot_bytes / self.bw_ckpt

    def restore(self, moved_bytes: int, stayed_bytes: int = 0,
                cross_rack_bytes: int = 0, cross_pod_bytes: int = 0) -> float:
        """RESTORE wall time: read a snapshot back from the store.

        Restores are stage-3 transfers in reverse — shards stream from
        the store onto the surviving (or respawned) ranks — so they are
        priced through :meth:`redistribution`, per distance class.  The
        default call charges everything on the cross link (the store is
        a shared filesystem outside the rack tree); callers that resolve
        store locality can pass the class split.
        """
        return self.redistribution(moved_bytes, stayed_bytes,
                                   cross_rack_bytes, cross_pod_bytes)

    def redistribution(self, moved_bytes: int, stayed_bytes: int = 0,
                       cross_rack_bytes: int = 0,
                       cross_pod_bytes: int = 0) -> float:
        """Stage-3 wall time: per-class pricing of one redistribution.

        ``moved_bytes`` cross device boundaries; the ``cross_rack_bytes``
        portion of them additionally crosses racks and is charged on the
        ``cross_rack`` link, the rest on ``intra_rack``; the
        ``cross_pod_bytes`` slice of the rack-crossing portion further
        leaves its pod and rides the ``cross_pod`` link.  ``stayed_bytes``
        are shards a surviving device already holds, re-validated over
        the (usually much faster) ``intra_node`` link.  With the default
        2-class model (no per-rack split) the moved classes all price at
        the cross-link bandwidth, so ``cross_rack_bytes`` /
        ``cross_pod_bytes`` splits are cost-neutral there and the charge
        is bit-for-bit the PR-4 local/cross number — and with
        ``stayed_bytes == 0``, the original aggregate charge
        ``redist_alpha + moved / redist_bw``.
        """
        xrack = min(max(0, cross_rack_bytes), max(0, moved_bytes))
        xpod = min(max(0, cross_pod_bytes), xrack)
        return self.redistribution_by_class({
            "intra_node": max(0, stayed_bytes),
            "intra_rack": max(0, moved_bytes) - xrack,
            "cross_rack": xrack - xpod,
            "cross_pod": xpod,
        })

    def with_link_bandwidths(
        self, *, local: float | None = None, cross: float | None = None
    ) -> "CostModel":
        """Copy of this model with split per-link redistribution bandwidths."""
        return replace(
            self,
            redist_bw_local=self.redist_bw_local if local is None else local,
            redist_bw_cross=self.redist_bw_cross if cross is None else cross,
        )

    def with_class_bandwidths(
        self,
        *,
        intra_node: float | None = None,
        intra_rack: float | None = None,
        cross_rack: float | None = None,
        cross_pod: float | None = None,
    ) -> "CostModel":
        """Copy of this model with per-distance-class stage-3 bandwidths."""
        return replace(
            self,
            redist_bw_local=(self.redist_bw_local if intra_node is None
                             else intra_node),
            redist_bw_intra_rack=(self.redist_bw_intra_rack if intra_rack is None
                                  else intra_rack),
            redist_bw_cross_rack=(self.redist_bw_cross_rack if cross_rack is None
                                  else cross_rack),
            redist_bw_cross_pod=(self.redist_bw_cross_pod if cross_pod is None
                                 else cross_pod),
        )

    def with_overlap(
        self,
        *,
        spawn: float | None = None,
        sync: float | None = None,
        connect: float | None = None,
        redistribution: float | None = None,
        contention: float | None = None,
    ) -> "CostModel":
        """Copy of this model with different partial-overlap parameters."""
        return replace(
            self,
            spawn_overlap=self.spawn_overlap if spawn is None else spawn,
            sync_overlap=self.sync_overlap if sync is None else sync,
            connect_overlap=self.connect_overlap if connect is None else connect,
            redist_overlap=(
                self.redist_overlap if redistribution is None else redistribution
            ),
            overlap_contention=(
                self.overlap_contention if contention is None else contention
            ),
        )

    def scaled(self, factor: float) -> "CostModel":
        """Uniformly slower interconnect/daemons (used for NASP)."""
        return replace(
            self,
            alpha_spawn=self.alpha_spawn * factor,
            beta_proc_local=self.beta_proc_local * factor,
            gamma_tree=self.gamma_tree * factor,
            delta_contend=self.delta_contend * factor,
            alpha_connect=self.alpha_connect * factor,
            beta_connect=self.beta_connect * factor,
            t_port=self.t_port * factor,
            t_lookup=self.t_lookup * factor,
            t_token=self.t_token * factor,
            t_barrier_hop=self.t_barrier_hop * factor,
            t_term_base=self.t_term_base * factor,
            redist_bw=self.redist_bw / factor,
            redist_bw_local=(
                None if self.redist_bw_local is None
                else self.redist_bw_local / factor
            ),
            redist_bw_cross=(
                None if self.redist_bw_cross is None
                else self.redist_bw_cross / factor
            ),
            redist_bw_intra_rack=(
                None if self.redist_bw_intra_rack is None
                else self.redist_bw_intra_rack / factor
            ),
            redist_bw_cross_rack=(
                None if self.redist_bw_cross_rack is None
                else self.redist_bw_cross_rack / factor
            ),
            redist_bw_cross_pod=(
                None if self.redist_bw_cross_pod is None
                else self.redist_bw_cross_pod / factor
            ),
            gamma_rack=(
                None if self.gamma_rack is None else self.gamma_rack * factor
            ),
            gamma_pod=(
                None if self.gamma_pod is None else self.gamma_pod * factor
            ),
            redist_alpha=self.redist_alpha * factor,
            ckpt_bw=(None if self.ckpt_bw is None else self.ckpt_bw / factor),
            ckpt_alpha=(
                None if self.ckpt_alpha is None else self.ckpt_alpha * factor
            ),
        )


# ---------------------------------------------------------------------------
# Analytic stage-3 bytes models (device-free).
#
# A *bytes model* maps one reconfiguration (ns source ranks -> nt target
# ranks) to the bytes that cross rank boundaries during stage 3.  The
# :class:`~repro_torch.core.engine.ReconfigEngine` charges the result as a
# REDISTRIBUTION timeline event.  These two closed forms bracket the real
# placements; :class:`repro_torch.elastic.reshard.PytreeBytesModel` computes the
# exact value for a live model's sharded pytree.
# ---------------------------------------------------------------------------
def replicated_bytes_model(param_bytes: int):
    """Bytes model for fully replicated state (pure data parallelism).

    Every target rank holds the full ``param_bytes`` replica, so a grow
    ships one copy to each new rank and a shrink moves nothing (survivor
    replicas already suffice).

    Args:
        param_bytes: total size of the replicated pytree in bytes.
    Returns:
        ``f(ns, nt) -> int`` usable as ``ReconfigEngine.bytes_model``.
    """

    def bytes_moved(ns: int, nt: int) -> int:
        if ns <= 0 or nt <= ns:
            return 0
        return param_bytes * (nt - ns)

    # Checkpoint snapshot size: one full replica, regardless of rank count.
    bytes_moved.total_bytes = lambda ranks: max(0, param_bytes)  # type: ignore[attr-defined]
    return bytes_moved


def fsdp_bytes_model(param_bytes: int):
    """Bytes model for fully sharded state (ZeRO-3/FSDP over all ranks).

    Every rank holds 1/ranks of the state; any resize redraws every shard
    boundary, so (conservatively) the whole pytree is in flight for both
    grows and shrinks.

    Args:
        param_bytes: total size of the sharded pytree in bytes.
    Returns:
        ``f(ns, nt) -> int`` usable as ``ReconfigEngine.bytes_model``.
    """

    def bytes_moved(ns: int, nt: int) -> int:
        if ns <= 0 or nt <= 0 or nt == ns:
            return 0
        return param_bytes

    # Checkpoint snapshot size: the shards cover the pytree exactly once.
    bytes_moved.total_bytes = lambda ranks: max(0, param_bytes)  # type: ignore[attr-defined]
    return bytes_moved


def replicated_link_model(param_bytes: int):
    """Link-aware replicated model: reports *both* transfer classes.

    Same placement assumptions as :func:`replicated_bytes_model`, but the
    returned callable yields a ``{"bytes_stayed", "bytes_moved"}`` dict
    (the :func:`repro_torch.elastic.reshard.predicted_transfer_stats` shape):
    a grow ships one replica to each new rank (moved, cross link) while
    every survivor re-validates its own replica (stayed, local link);
    a shrink leaves the survivors' replicas in place (stayed only).

    Use this with split ``redist_bw_local`` / ``redist_bw_cross``
    bandwidths; with the default single-bandwidth model, prefer
    :func:`replicated_bytes_model`, which charges moved bytes only and
    reproduces the pre-split aggregate numbers bit-for-bit.

    Args:
        param_bytes: total size of the replicated pytree in bytes.
    Returns:
        ``f(ns, nt) -> dict`` usable as ``ReconfigEngine.bytes_model``.
    """

    def transfer(ns: int, nt: int) -> dict:
        if ns <= 0 or nt <= 0 or nt == ns:
            return {"bytes_stayed": 0, "bytes_moved": 0}
        if nt > ns:
            return {
                "bytes_stayed": param_bytes * ns,
                "bytes_moved": param_bytes * (nt - ns),
            }
        return {"bytes_stayed": param_bytes * nt, "bytes_moved": 0}

    # Checkpoint snapshot size: one full replica, regardless of rank count.
    transfer.total_bytes = lambda ranks: max(0, param_bytes)  # type: ignore[attr-defined]
    return transfer


# MareNostrum 5: 112-core nodes, MPICH 4.2 over InfiniBand (CH4:OFI).
MN5 = CostModel()

# NASP: 20/52-core nodes, MPICH 3.4 over 10 Gbit Ethernet (CH3:Nemesis) —
# slower launcher and transport, and a much slower termination path (CH3
# progress engine + Ethernet name service), which is why the paper's TS
# speedup bound drops from 1387x (MN5) to 20x.
NASP = replace(CostModel().scaled(4.0), t_term_base=3.0e-2)
