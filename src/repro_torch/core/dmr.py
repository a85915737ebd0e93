"""DMR-style asynchronous two-phase spawning strategy (``"dmr-async"``).

Iserte et al.'s DMR API decouples a resize into two phases: the RMS
*grants* the new allocation and the job *accepts* it asynchronously —
new processes are spawned, synchronized, and connected while the old
world keeps computing — and only the final commit (rank reorder, the
sources↔children intercomm, data redistribution) interrupts the
application.  This module registers that behaviour as an ordinary
strategy:

* **spawn structure** — the best parallel plan for the allocation:
  hypercube rounds (§4.1) on homogeneous pools, iterative diffusive
  rounds (§4.2) on heterogeneous ones, re-tagged with this strategy's
  registry key.  Event durations are identical to that underlying plan;
* **two-phase charging** — the spec's ``two_phase`` flag makes the
  engine charge the plan with full spawn/sync/connect overlap
  (``CostModel.with_overlap(spawn=1.0, sync=1.0, connect=1.0)``) and
  force ``asynchronous=True`` on the plan, so the grant-acceptance legs
  hide under compute — degraded by the ordinary contention factor —
  while REORDER/FINAL/REDISTRIBUTION stay on the critical path.

Consequently expansion *downtime* never exceeds the synchronous
baseline on the same allocation (strictly less whenever contention
leaves room to hide work), while *total* reconfiguration wall time is
unchanged — exactly the DMR trade: acceptance off the critical path,
commit still paid.  Shrinks are unaffected (TS shrinks carry no spawn
legs to hide).
"""
from __future__ import annotations

from dataclasses import replace
from typing import Iterable, Union

from .diffusive import plan_diffusive
from .engine import (
    StrategySpec,
    as_core_vector,
    register_strategy,
    running_vector,
)
from .hypercube import plan_hypercube
from .types import Method, SpawnPlan

DMR_KEY = "dmr-async"


def plan_dmr(
    ns: int,
    nt: int,
    cores: Union[int, Iterable[int]],
    method: Method = Method.MERGE,
) -> SpawnPlan:
    """Two-phase spawn plan (normalized ``(ns, nt, cores, method)``).

    Homogeneous allocations take the hypercube rounds, heterogeneous
    ones the iterative diffusive rounds; either way the plan is
    re-tagged ``"dmr-async"`` so the engine's timeline charger applies
    the two-phase overlap.
    """
    a_vec = as_core_vector(
        cores if isinstance(cores, int) else list(cores), nt
    )
    widths = set(a_vec)
    if len(widths) == 1:
        plan = plan_hypercube(ns, nt, widths.pop(), method)
    else:
        plan = plan_diffusive(a_vec, running_vector(a_vec, ns), method)
    return replace(plan, strategy=DMR_KEY)


register_strategy(StrategySpec(
    key=DMR_KEY,
    planner=plan_dmr,
    parallel=True,
    two_phase=True,
    description=("DMR two-phase async spawn: grant accepted off the "
                 "critical path (spawn/sync/connect fully overlapped), "
                 "only the commit interrupts compute"),
))
