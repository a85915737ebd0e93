"""Timeline-charging backend for reconfiguration cost (paper §5).

The phase math lives in :mod:`repro_torch.core.engine`: every plan is executed
as an explicit event timeline (spawn rounds, tree synchronization, binary
connection rounds, reordering, final intercomm; TS/ZS/SS for shrinks)
charged with the :class:`CostModel`.  This module is the report-shaped
view over those timelines — :class:`ExpansionReport` / :class:`ShrinkReport`
read *every* number (per-phase spans, total, ASYNC downtime) off the
timeline, so they can never disagree with the elastic runtime's
:class:`~repro_torch.elastic.runtime.ReconfigRecord`, which reads the same one.

The event structure mirrors §4.6's task lists, so per-phase output is
directly comparable to the paper's discussion (e.g. "overhead grows when
more than 8 groups are created": that is the connect phase growing with
ceil(log2 G) unbalanced rounds).

Reports price reconfiguration only.  The symmetric question — what each
step of the horizon costs under the allocation a reconfiguration leaves
behind — belongs to :mod:`repro_torch.malleability.throughput`; the scenario
executors compose the two into ``time_to_result_s`` so a cheap shrink
that halves step throughput stops looking like a good trade.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Union

from repro_torch.core import (
    ShrinkKind,
    SpawnPlan,
    Stage,
    Timeline,
    expansion_timeline,
    shrink_timeline,
    strategy_key,
)
from repro_torch.core.types import Method, Strategy

from .cost_model import CostModel


@dataclass(frozen=True)
class ExpansionReport:
    """Per-phase breakdown of one charged expansion timeline."""

    strategy: Union[Strategy, str]
    method: Method
    ns: int
    nt: int
    t_spawn: float
    t_sync: float
    t_connect: float
    t_reorder: float
    t_final: float
    total: float
    downtime: float      # app-visible stall (== total unless Async overlaps)
    steps: int
    groups: int
    timeline: Timeline = field(default_factory=Timeline, repr=False, compare=False)
    t_redist: float = 0.0
    bytes_moved: int = 0
    t_queue: float = 0.0
    bytes_stayed: int = 0
    bytes_cross_rack: int = 0
    bytes_cross_pod: int = 0

    def as_row(self) -> dict:
        """Report as a flat dict row (benchmark CSV shape)."""
        return {
            "strategy": strategy_key(self.strategy),
            "method": self.method.value,
            "ns": self.ns,
            "nt": self.nt,
            "queue_s": round(self.t_queue, 6),
            "spawn_s": round(self.t_spawn, 6),
            "sync_s": round(self.t_sync, 6),
            "connect_s": round(self.t_connect, 6),
            "reorder_s": round(self.t_reorder, 6),
            "final_s": round(self.t_final, 6),
            "redist_s": round(self.t_redist, 6),
            "total_s": round(self.total, 6),
            "downtime_s": round(self.downtime, 6),
            "bytes_moved": self.bytes_moved,
            "bytes_stayed": self.bytes_stayed,
            "bytes_cross_rack": self.bytes_cross_rack,
            "bytes_cross_pod": self.bytes_cross_pod,
            "steps": self.steps,
            "groups": self.groups,
        }


@dataclass(frozen=True)
class ShrinkReport:
    """Total + mechanism detail of one charged shrink timeline."""

    kind: ShrinkKind
    total: float
    nodes_returned: int
    nodes_pinned: int
    detail: dict = field(default_factory=dict)
    timeline: Timeline = field(default_factory=Timeline, repr=False, compare=False)
    bytes_moved: int = 0
    bytes_stayed: int = 0
    bytes_cross_rack: int = 0
    bytes_cross_pod: int = 0
    bytes_restored: int = 0   # shards re-read from the last checkpoint
    restored_s: float = 0.0   # RESTORE span charged on the timeline


def simulate_expansion(
    plan: SpawnPlan, cm: CostModel, asynchronous: bool = False,
    bytes_total: int = 0, queue_delay_s: float = 0.0, bytes_stayed: int = 0,
    bytes_cross_rack: int = 0, bytes_cross_pod: int = 0,
) -> ExpansionReport:
    """Charge one expansion plan and report its per-phase breakdown.

    Args:
        plan: the spawn plan to charge.
        cm: cost model (latencies, bandwidths, overlap fractions).
        asynchronous: report ASYNC downtime (partial overlap) instead of
            the full wall time.
        bytes_total: stage-3 cross-link data volume to charge as a
            REDISTRIBUTION event (0 skips the event).
        queue_delay_s: RMS arbitration wait charged as a leading QUEUE
            event (0 skips the event).
        bytes_stayed: stage-3 local-link volume (per-link pricing).
        bytes_cross_rack: rack-crossing portion of ``bytes_total``
            (distance-class pricing; the rest rides the intra-rack link).
        bytes_cross_pod: pod-crossing slice of ``bytes_cross_rack``.
    Returns:
        An :class:`ExpansionReport` whose every field is a read of the
        charged :class:`~repro_torch.core.Timeline`.
    """
    tl = expansion_timeline(plan, cm, bytes_total=bytes_total,
                            queue_delay_s=queue_delay_s,
                            bytes_stayed=bytes_stayed,
                            bytes_cross_rack=bytes_cross_rack,
                            bytes_cross_pod=bytes_cross_pod)
    return ExpansionReport(
        strategy=plan.strategy,
        method=plan.method,
        ns=plan.ns,
        nt=plan.nt,
        t_spawn=tl.span(Stage.SPAWN),
        t_sync=tl.span(Stage.SYNC),
        t_connect=tl.span(Stage.CONNECT),
        t_reorder=tl.span(Stage.REORDER),
        t_final=tl.span(Stage.FINAL),
        total=tl.total,
        downtime=tl.downtime(asynchronous),
        steps=plan.steps,
        groups=len(plan.groups),
        timeline=tl,
        t_redist=tl.span(Stage.REDISTRIBUTION),
        bytes_moved=tl.bytes_moved,
        t_queue=tl.queued_s,
        bytes_stayed=tl.bytes_stayed,
        bytes_cross_rack=tl.bytes_cross_rack,
        bytes_cross_pod=tl.bytes_cross_pod,
    )


def simulate_shrink(
    kind: ShrinkKind,
    cm: CostModel,
    ns: int,
    nt: int,
    doomed_world_sizes: list[int] | None = None,
    respawn_plan: SpawnPlan | None = None,
    nodes_returned: int = 0,
    nodes_pinned: int = 0,
    bytes_total: int = 0,
    bytes_stayed: int = 0,
    bytes_cross_rack: int = 0,
    bytes_cross_pod: int = 0,
    restore_bytes: int = 0,
) -> ShrinkReport:
    """Charge one shrink by mechanism (TS / ZS / SS) off its timeline.

    ``bytes_total`` > 0 (cross link) or ``bytes_stayed`` > 0 (local
    link) additionally charges the survivors' absorption of the doomed
    ranks' shards as a REDISTRIBUTION event; ``bytes_cross_rack`` is the
    rack-crossing portion of ``bytes_total`` (distance-class pricing).
    ``restore_bytes`` > 0 charges recovering that much of the last
    checkpoint as a trailing RESTORE event (failure recovery).
    """
    tl = shrink_timeline(
        kind,
        cm,
        ns=ns,
        nt=nt,
        doomed_world_sizes=doomed_world_sizes,
        respawn_plan=respawn_plan,
        bytes_total=bytes_total,
        bytes_stayed=bytes_stayed,
        bytes_cross_rack=bytes_cross_rack,
        bytes_cross_pod=bytes_cross_pod,
        restore_bytes=restore_bytes,
    )
    if kind is ShrinkKind.TS:
        detail = {"worlds_terminated": len(doomed_world_sizes or [])}
    elif kind is ShrinkKind.ZS:
        detail = {"zombified": ns - nt}
    elif respawn_plan is not None:
        detail = {"respawn_total_s": tl.total - tl.span(Stage.TEARDOWN)}
    else:
        detail = {}
    return ShrinkReport(
        kind=kind,
        total=tl.total,
        nodes_returned=nodes_returned,
        nodes_pinned=nodes_pinned,
        detail=detail,
        timeline=tl,
        bytes_moved=tl.bytes_moved,
        bytes_stayed=tl.bytes_stayed,
        bytes_cross_rack=tl.bytes_cross_rack,
        bytes_cross_pod=tl.bytes_cross_pod,
        bytes_restored=tl.bytes_restored,
        restored_s=tl.restored_s,
    )


def simulate_redistribution(cm: CostModel, total_bytes: int,
                            stayed_bytes: int = 0,
                            cross_rack_bytes: int = 0,
                            cross_pod_bytes: int = 0) -> float:
    """Stage-3 wall time for one redistribution (setup + per-class bw)."""
    return cm.redistribution(total_bytes, stayed_bytes, cross_rack_bytes,
                             cross_pod_bytes)
