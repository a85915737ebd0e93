"""Vectorized timeline engine: array-charged events + analytic chargers.

The object path (:mod:`repro_torch.core.engine`) charges one
:class:`~repro_torch.core.engine.TimelineEvent` at a time and answers cost
queries by iterating Python objects.  That is the right shape for a
single reconfiguration, but mega-scale sweeps (100k-event churn traces,
1000-replica Monte-Carlo policy sweeps over 10k-node pods) need the same
numbers thousands of times per second.  This module provides the array
layer those sweeps run on:

* :class:`EventArrays` — a trace's events as one structured numpy array
  (stage code, start/end, overlap fraction, stage-3 bytes per distance
  class).  ``total`` / ``span`` / ``downtime`` / per-class byte totals
  are computed with array ops that reproduce the object path's
  accumulation order **bit-for-bit** (sequential ``accumulate`` /
  ``cumsum`` reductions, never pairwise re-association), and
  :meth:`EventArrays.to_timeline` reconstructs the plain
  :class:`~repro_torch.core.engine.Timeline` object view unchanged.
* :class:`Charge` / :func:`charge_stats` — duration-typed events before
  placement on the clock, and the exact scalar reduction the
  :class:`~repro_torch.core.engine._TimelineBuilder` + Timeline pair would
  perform on them (same ``t + d`` placement, same ``end - start``
  re-reads), for cache-miss charging where numpy call overhead would
  dominate 40-event reductions.
* Analytic chargers for the hot transition shapes — a MERGE hypercube
  expansion (:func:`hypercube_expand_charges`) and a TS shrink
  (:func:`ts_shrink_charges`) — that emit the identical event sequence
  the planner + builder would, in closed form: no GroupSpec lists, no
  sync graph, no per-pair connect walk.  A 1 -> 10000 node expansion
  charges in microseconds instead of building a 9999-group plan.

The contract every consumer relies on: for any plan the object path can
charge, the vectorized path produces the same floats and ints, bit for
bit.  ``tests/test_vectorized.py`` pins that over the full scenario
registry and on randomized plans.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import TYPE_CHECKING, Iterable, Sequence

import numpy as np

from .engine import Stage, Timeline, TimelineEvent
from .topology import split_bytes_by_class

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.malleability.cost_model import CostModel

# Stage <-> int8 code, in enum declaration order (stable across runs;
# CHECKPOINT/RESTORE were appended last, so earlier codes are unchanged).
STAGE_ORDER: tuple[Stage, ...] = tuple(Stage)
STAGE_CODE: dict[Stage, int] = {s: i for i, s in enumerate(STAGE_ORDER)}
_QUEUE_CODE = STAGE_CODE[Stage.QUEUE]
_RESTORE_CODE = STAGE_CODE[Stage.RESTORE]

# One row per charged event.  This is the on-disk/in-memory shape of a
# timeline; labels ride separately (object-view garnish, never math).
EVENT_DTYPE = np.dtype(
    [
        ("stage", np.int8),
        ("start", np.float64),
        ("end", np.float64),
        ("overlap_fraction", np.float64),
        ("bytes_moved", np.int64),
        ("bytes_stayed", np.int64),
        ("bytes_cross_rack", np.int64),
        ("bytes_cross_pod", np.int64),
        ("bytes_checkpointed", np.int64),
    ]
)


def _seq_sum(values: np.ndarray) -> float:
    """Strict left-to-right float sum (what ``sum()`` over events does).

    ``np.add.accumulate`` (like ``cumsum``) produces every prefix, so it
    is forced into the same sequential association as the object path's
    Python ``sum`` — unlike ``np.sum`` / ``np.add.reduceat``, whose
    pairwise re-association changes low-order bits at modest lengths.
    """
    if values.size == 0:
        return 0.0
    return float(np.add.accumulate(values)[-1])


@dataclass(frozen=True)
class Charge:
    """One stage duration before placement on the clock."""

    stage: Stage
    duration: float
    overlap_fraction: float = 0.0
    bytes_moved: int = 0
    bytes_stayed: int = 0
    bytes_cross_rack: int = 0
    bytes_cross_pod: int = 0
    label: str = ""
    bytes_checkpointed: int = 0


@dataclass(frozen=True)
class ChargeStats:
    """Scalar cost summary of one charged transition."""

    total: float
    downtime: float
    queued: float
    bytes_moved: int
    bytes_stayed: int
    bytes_cross_rack: int
    bytes_cross_pod: int
    bytes_checkpointed: int = 0
    bytes_restored: int = 0
    restored_s: float = 0.0


def charge_stats(
    charges: Iterable[Charge], *, contention: float = 1.0,
    asynchronous: bool = False,
) -> ChargeStats:
    """Reduce charges exactly as builder + Timeline would.

    Replays the builder's clock placement (skip non-positive durations,
    ``end = t + d``) and the Timeline's queries, which re-read each
    duration as ``end - start`` — kept verbatim so a float where
    ``(t + d) - t != d`` still reproduces the object path bit-for-bit.
    """
    t = 0.0
    queued = 0.0
    hidden_sum = 0.0
    moved = stayed = xrack = xpod = 0
    checkpointed = restored = 0
    restored_s = 0.0
    factor = max(0.0, 2.0 - max(contention, 1.0))
    for c in charges:
        if c.duration <= 0.0:
            continue
        end = t + c.duration
        d_eff = end - t
        t = end
        if c.stage is Stage.QUEUE:
            queued += d_eff
        else:
            f = min(max(c.overlap_fraction, 0.0), 1.0)
            hidden_sum += d_eff * min(f * factor, f)
        if c.stage is Stage.RESTORE:
            # Store traffic, not stage-3 movement (Timeline's exclusion).
            restored += c.bytes_stayed + c.bytes_moved
            restored_s += d_eff
        else:
            moved += c.bytes_moved
            stayed += c.bytes_stayed
            xrack += c.bytes_cross_rack
            xpod += c.bytes_cross_pod
        checkpointed += c.bytes_checkpointed
    downtime = t - queued
    if asynchronous:
        downtime = downtime - hidden_sum
    return ChargeStats(total=t, downtime=downtime, queued=queued,
                       bytes_moved=moved, bytes_stayed=stayed,
                       bytes_cross_rack=xrack, bytes_cross_pod=xpod,
                       bytes_checkpointed=checkpointed,
                       bytes_restored=restored, restored_s=restored_s)


@dataclass(frozen=True)
class EventArrays:
    """A charged timeline as one structured numpy array.

    ``data`` has dtype :data:`EVENT_DTYPE`; ``labels`` (optional, may be
    shorter than ``data``) carries the object view's event labels so
    :meth:`to_timeline` round-trips losslessly.  All cost queries are
    array reductions that match :class:`~repro_torch.core.engine.Timeline`
    bit-for-bit.
    """

    data: np.ndarray
    contention: float = 1.0
    labels: tuple[str, ...] = ()

    def __len__(self) -> int:
        return int(self.data.shape[0])

    # ------------------------------------------------------------ builders --
    @classmethod
    def from_timeline(cls, tl: Timeline) -> "EventArrays":
        """Array view of an existing object timeline."""
        data = np.empty(len(tl.events), dtype=EVENT_DTYPE)
        for i, e in enumerate(tl.events):
            data[i] = (STAGE_CODE[e.stage], e.start, e.end,
                       e.overlap_fraction, e.bytes_moved, e.bytes_stayed,
                       e.bytes_cross_rack, e.bytes_cross_pod,
                       e.bytes_checkpointed)
        return cls(data=data, contention=tl.contention,
                   labels=tuple(e.label for e in tl.events))

    @classmethod
    def from_charges(
        cls, charges: Sequence[Charge], contention: float = 1.0
    ) -> "EventArrays":
        """Place charges back-to-back on the clock (builder semantics).

        Non-positive durations are dropped, exactly as
        ``_TimelineBuilder.add`` drops them; ``cumsum`` accumulates the
        clock sequentially, matching the builder's ``t += duration``.
        """
        kept = [c for c in charges if c.duration > 0.0]
        data = np.empty(len(kept), dtype=EVENT_DTYPE)
        durs = np.array([c.duration for c in kept], dtype=np.float64)
        ends = np.cumsum(durs)
        data["stage"] = np.array([STAGE_CODE[c.stage] for c in kept],
                                 dtype=np.int8)
        data["end"] = ends
        data["start"] = np.concatenate((np.zeros(1), ends[:-1])) \
            if kept else np.zeros(0)
        data["overlap_fraction"] = [c.overlap_fraction for c in kept]
        data["bytes_moved"] = [c.bytes_moved for c in kept]
        data["bytes_stayed"] = [c.bytes_stayed for c in kept]
        data["bytes_cross_rack"] = [c.bytes_cross_rack for c in kept]
        data["bytes_cross_pod"] = [c.bytes_cross_pod for c in kept]
        data["bytes_checkpointed"] = [c.bytes_checkpointed for c in kept]
        return cls(data=data, contention=contention,
                   labels=tuple(c.label for c in kept))

    # ------------------------------------------------------------- queries --
    @property
    def durations(self) -> np.ndarray:
        """Per-event durations, re-read as ``end - start`` (object rule)."""
        return self.data["end"] - self.data["start"]

    @property
    def total(self) -> float:
        """Wall time of the whole reconfiguration."""
        if len(self) == 0:
            return 0.0
        return float(self.data["end"].max())

    def span(self, stage: Stage) -> float:
        """Summed duration of every event of ``stage``."""
        mask = self.data["stage"] == STAGE_CODE[stage]
        return _seq_sum(self.durations[mask])

    def span_by_stage(self) -> dict[Stage, float]:
        """Every stage's span, one masked sequential reduction each."""
        durs = self.durations
        codes = self.data["stage"]
        return {
            s: _seq_sum(durs[codes == STAGE_CODE[s]]) for s in STAGE_ORDER
        }

    @property
    def queued_s(self) -> float:
        return self.span(Stage.QUEUE)

    @property
    def _stage3_mask(self) -> np.ndarray:
        """Events whose bytes are stage-3 movement (RESTORE excluded)."""
        return self.data["stage"] != _RESTORE_CODE

    @property
    def bytes_moved(self) -> int:
        return int(self.data["bytes_moved"][self._stage3_mask].sum())

    @property
    def bytes_stayed(self) -> int:
        return int(self.data["bytes_stayed"][self._stage3_mask].sum())

    @property
    def bytes_cross_rack(self) -> int:
        return int(self.data["bytes_cross_rack"][self._stage3_mask].sum())

    @property
    def bytes_cross_pod(self) -> int:
        return int(self.data["bytes_cross_pod"][self._stage3_mask].sum())

    @property
    def bytes_checkpointed(self) -> int:
        return int(self.data["bytes_checkpointed"].sum())

    @property
    def bytes_restored(self) -> int:
        """Bytes read back from the store (RESTORE events only)."""
        mask = self.data["stage"] == _RESTORE_CODE
        return int(self.data["bytes_stayed"][mask].sum()
                   + self.data["bytes_moved"][mask].sum())

    @property
    def restored_s(self) -> float:
        return self.span(Stage.RESTORE)

    @property
    def bytes_by_class(self) -> dict[str, int]:
        """Stage-3 bytes per distance class (sums to stayed + moved)."""
        return split_bytes_by_class(self.bytes_stayed, self.bytes_moved,
                                    self.bytes_cross_rack,
                                    self.bytes_cross_pod)

    def downtime(self, asynchronous: bool = False) -> float:
        """App-visible stall; mirrors ``Timeline.downtime`` exactly."""
        if not asynchronous:
            return self.total - self.queued_s
        f = np.clip(self.data["overlap_fraction"], 0.0, 1.0)
        factor = max(0.0, 2.0 - max(self.contention, 1.0))
        hidden = self.durations * np.minimum(f * factor, f)
        mask = self.data["stage"] != _QUEUE_CODE
        return self.total - self.queued_s - _seq_sum(hidden[mask])

    # ---------------------------------------------------------- object view --
    def to_timeline(self) -> Timeline:
        """Reconstruct the plain object timeline (thin view contract)."""
        labels = self.labels + ("",) * (len(self) - len(self.labels))
        events = tuple(
            TimelineEvent(
                stage=STAGE_ORDER[int(row["stage"])],
                start=float(row["start"]),
                end=float(row["end"]),
                label=labels[i],
                overlap_fraction=float(row["overlap_fraction"]),
                bytes_moved=int(row["bytes_moved"]),
                bytes_stayed=int(row["bytes_stayed"]),
                bytes_cross_rack=int(row["bytes_cross_rack"]),
                bytes_cross_pod=int(row["bytes_cross_pod"]),
                bytes_checkpointed=int(row["bytes_checkpointed"]),
            )
            for i, row in enumerate(self.data)
        )
        return Timeline(events=events, contention=self.contention)


# ==================================================== analytic chargers ==
@lru_cache(maxsize=None)
def hypercube_connect_max_merges(n_groups: int) -> tuple[int, ...]:
    """Largest merged-group size (in initial-group units) per §4.4 round.

    Positional replay of :func:`repro_torch.core.connect
    .binary_connection_schedule` over equal-sized groups: each round
    pairs group ``i`` with ``groups - 1 - i``, survivors re-pack to
    ids ``0..new_groups-1``, so a flat array indexed by gid suffices.
    Because :meth:`CostModel.connect_merge` is affine and increasing in
    the merged rank count, the round's charged cost is the cost of its
    largest merge — this cache turns the object path's per-pair walk
    into one lookup.
    """
    sizes = np.ones(n_groups, dtype=np.int64)
    out: list[int] = []
    groups = n_groups
    while groups > 1:
        middle = groups // 2
        new_groups = groups - middle
        merged = sizes[:middle] + sizes[new_groups:groups][::-1]
        out.append(int(merged.max()))
        sizes = np.concatenate((merged, sizes[middle:new_groups]))
        groups = new_groups
    return tuple(out)


@lru_cache(maxsize=None)
def hypercube_round_budgets(ns: int, n_groups: int, cores: int) -> tuple[int, ...]:
    """Groups spawned per round of a MERGE hypercube expansion.

    Mirrors :func:`repro_torch.core.hypercube.plan_hypercube`'s spawner loop:
    every live rank spawns one ``cores``-sized group per round, so the
    spawner count starts at ``ns`` and grows by ``budget * cores``.
    """
    budgets: list[int] = []
    spawners = ns
    gid = 0
    while gid < n_groups:
        budget = min(spawners, n_groups - gid)
        budgets.append(budget)
        gid += budget
        spawners += budget * cores
    return tuple(budgets)


def hypercube_expand_charges(
    cm: "CostModel", ns: int, nt: int, cores: int
) -> list[Charge]:
    """Closed-form event sequence of a MERGE hypercube expansion.

    Emits exactly the events ``expansion_timeline(plan_hypercube(ns, nt,
    cores, MERGE), cm)`` would charge — same expressions, same order —
    without building the plan: spawn rounds (uniform ``cores``-sized
    groups, so each concurrent round costs the single-call charge plus
    the launcher-contention term), the §4.3 tree sync, the §4.4 connect
    rounds priced at their largest merge, the Eq. 9 reorder split, and
    the final intercomm merge.  Only valid for homogeneous widths and an
    unpriced (topology-free) spawn; callers gate on that.
    """
    if ns <= 0 or ns % cores or nt % cores:
        raise ValueError(
            f"hypercube requires NS ({ns}) and NT ({nt}) divisible by C ({cores})"
        )
    n_groups = nt // cores - ns // cores
    if n_groups <= 0:
        return []
    charges: list[Charge] = []
    f = cm.spawn_overlap
    base = cm.spawn_call(cores, 1)
    budgets = hypercube_round_budgets(ns, n_groups, cores)
    for s, budget in enumerate(budgets, start=1):
        charges.append(Charge(
            Stage.SPAWN, base + cm.delta_contend * (budget - 1), f,
            label=f"round {s} ({budget} groups)",
        ))
    depth = len(budgets)
    per_level = cm.t_token + cm.barrier(cores) + cm.comm_split(cores)
    sync = cm.t_port + per_level + depth * 2 * (cm.t_token + cm.barrier(cores))
    charges.append(Charge(Stage.SYNC, sync, cm.sync_overlap,
                          label=f"tree sync depth {depth}"))
    for i, m in enumerate(hypercube_connect_max_merges(n_groups)):
        charges.append(Charge(Stage.CONNECT, cm.connect_merge(m * cores),
                              cm.connect_overlap,
                              label=f"connect round {i + 1}"))
    charges.append(Charge(Stage.REORDER, cm.comm_split(n_groups * cores),
                          label="Eq. 9 reorder split"))
    charges.append(Charge(Stage.FINAL, cm.connect_merge(nt),
                          label="final intercomm merge"))
    return charges


def ts_shrink_charges(
    cm: "CostModel", doomed_world_sizes: Sequence[int]
) -> list[Charge]:
    """Closed-form TS shrink: release tokens, doomed worlds exit."""
    doomed = list(doomed_world_sizes) or [1]
    dur = cm.ts_terminate(doomed) + cm.t_token
    return [Charge(Stage.TERMINATE, dur,
                   label=f"TS terminate {len(doomed)} worlds")]


def redistribution_charge(
    cm: "CostModel", bytes_total: int, bytes_stayed: int,
    bytes_cross_rack: int = 0, bytes_cross_pod: int = 0,
) -> list[Charge]:
    """Stage-3 charge with the engine's exact clamping (may be empty)."""
    if bytes_total <= 0 and bytes_stayed <= 0:
        return []
    xrack = min(max(0, bytes_cross_rack), max(0, bytes_total))
    xpod = min(max(0, bytes_cross_pod), xrack)
    return [Charge(
        Stage.REDISTRIBUTION,
        cm.redistribution(bytes_total, bytes_stayed, xrack, xpod),
        overlap_fraction=cm.redist_overlap,
        bytes_moved=bytes_total, bytes_stayed=max(0, bytes_stayed),
        bytes_cross_rack=xrack, bytes_cross_pod=xpod,
        label=f"redistribute {bytes_total} B",
    )]


def queue_charge(queue_delay_s: float) -> list[Charge]:
    """Leading RMS-arbitration wait (empty when zero)."""
    if queue_delay_s <= 0.0:
        return []
    return [Charge(Stage.QUEUE, queue_delay_s,
                   label="queued behind in-flight reconfig")]


def checkpoint_charge(cm: "CostModel", snapshot_bytes: int) -> list[Charge]:
    """Store-write charge with the engine's exact gating (may be empty)."""
    if snapshot_bytes <= 0:
        return []
    return [Charge(Stage.CHECKPOINT, cm.checkpoint(snapshot_bytes),
                   overlap_fraction=cm.ckpt_overlap,
                   bytes_checkpointed=snapshot_bytes,
                   label=f"checkpoint {snapshot_bytes} B")]


def restore_charge(cm: "CostModel", restore_bytes: int) -> list[Charge]:
    """Store-read charge; bytes count as restored, never stage-3 moved."""
    if restore_bytes <= 0:
        return []
    return [Charge(Stage.RESTORE, cm.restore(restore_bytes),
                   bytes_moved=restore_bytes,
                   label=f"restore {restore_bytes} B from checkpoint")]


def segment_times(steps: Sequence[int],
                  step_times: Sequence[float]) -> np.ndarray:
    """Per-transition modeled compute segments for a sorted plan.

    ``steps`` are the plan's (non-decreasing) event steps and
    ``step_times[i]`` the modeled seconds per application step of the
    allocation transition ``i`` leaves behind; the segment charged to
    transition ``i`` is the steps elapsed since the previous transition
    (since step 0 for the first) times that rate.  Same-step transitions
    get a zero delta, matching the object path's per-record accrual.
    IEEE float64 product, so the result is bit-identical to the
    equivalent Python-float arithmetic.
    """
    deltas = np.diff(np.asarray(steps, dtype=np.int64), prepend=0)
    return deltas * np.asarray(step_times, dtype=np.float64)


def restart_charges(
    cm: "CostModel", ns: int, nt: int, nodes: int,
    snapshot_bytes: int, restore_bytes: int,
) -> list[Charge]:
    """Closed-form full-stop checkpoint/restart event sequence.

    Emits exactly what :func:`repro_torch.core.engine.restart_timeline`
    charges: checkpoint, one SS respawn (teardown is inside
    ``ss_respawn``), restore.
    """
    return [
        *checkpoint_charge(cm, snapshot_bytes),
        Charge(Stage.RESPAWN, cm.ss_respawn(nt, max(1, nodes), ns),
               label=f"full-stop respawn {ns} -> {nt} ranks"),
        *restore_charge(cm, restore_bytes),
    ]
