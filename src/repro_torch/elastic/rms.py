"""Simulated Resource Management System (DRM side of the paper).

Ports :mod:`repro.elastic.rms`; it is plain Python.

Two halves:

* the **event source** (this module): :class:`SimulatedRMS` emits
  grow/shrink/failure/straggler events against which the elastic runtime
  reconfigures — scripted, scenario-fed, or *policy*-generated;
* the **policy engine** (:mod:`repro_torch.malleability.policies`, re-exported
  here): an RMS-side :class:`~repro_torch.malleability.policies.ClusterState`
  (one shared node pool + per-job allocations) with pluggable
  :class:`~repro_torch.malleability.policies.RmsPolicy` implementations —
  :class:`~repro_torch.malleability.policies.BackfillPolicy` (idle nodes flow
  to malleable jobs, reclaimed under queue pressure),
  :class:`~repro_torch.malleability.policies.PreemptionPolicy` (priority jobs
  force-shrink lower-priority ones, composing with in-flight
  reconfigurations), and
  :class:`~repro_torch.malleability.policies.ChurnPolicy` (seeded long-horizon
  grow/shrink cycling) — plus a multi-job arbiter
  (:func:`~repro_torch.malleability.policies.arbitrate_jobs`) that charges
  several jobs' timelines against one pool.

Policies *generate* declarative
:class:`~repro_torch.malleability.scenarios.Scenario` traces, so the existing
sim/live machinery consumes policy output unchanged:
``SimulatedRMS.from_policy(policy, cluster)`` is exactly
``from_scenario(policy.generate(cluster).scenario(job))``.
"""
from __future__ import annotations

import enum
import warnings
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Iterator

if TYPE_CHECKING:  # annotations only; the runtime names are shimmed below
    from repro_torch.malleability.policies import ClusterState, RmsPolicy

# The policy subsystem used to be re-exported from here (in the JAX
# package; the port keeps the same names).  Each name resolves through a
# thin PEP 562 shim that emits ONE DeprecationWarning, then caches the
# real object into this module's globals so later lookups are free and
# silent.
_DEPRECATED_POLICY_EXPORTS = frozenset({
    "ArbitratedJob",
    "BackfillPolicy",
    "ChurnPolicy",
    "ClusterState",
    "JobSpec",
    "MultiJobOutcome",
    "PolicyTrace",
    "PreemptionPolicy",
    "PriorityArrival",
    "RigidArrival",
    "RmsPolicy",
    "arbitrate_jobs",
    "registered_policy_scenarios",
    "run_multijob_sim",
})


def __getattr__(name: str):
    if name in _DEPRECATED_POLICY_EXPORTS:
        warnings.warn(
            f"importing {name!r} from repro_torch.elastic.rms is deprecated; "
            f"use repro_torch.malleability.policies.{name}",
            DeprecationWarning, stacklevel=2)
        from repro_torch.malleability import policies

        value = getattr(policies, name)
        globals()[name] = value     # warn exactly once per name
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ArbitratedJob",
    "BackfillPolicy",
    "ChurnPolicy",
    "ClusterState",
    "Event",
    "EventKind",
    "JobSpec",
    "MultiJobOutcome",
    "PolicyTrace",
    "PreemptionPolicy",
    "PriorityArrival",
    "RigidArrival",
    "RmsPolicy",
    "SimulatedRMS",
    "arbitrate_jobs",
    "registered_policy_scenarios",
    "run_multijob_sim",
]


class EventKind(enum.Enum):
    GROW = "grow"            # RMS grants extra nodes
    SHRINK = "shrink"        # RMS reclaims nodes
    FAIL = "fail"            # a node died: forced TS shrink + recovery
    STRAGGLER = "straggler"  # a node is slow: voluntarily TS-shrink it out
    CHECKPOINT = "checkpoint"  # snapshot full state in place (no resize)
    RESTART = "restart"      # rigid full stop: checkpoint, respawn, restore
    NOOP = "noop"


@dataclass(frozen=True)
class Event:
    step: int
    kind: EventKind
    nodes: tuple[int, ...] = ()     # affected node ids (SHRINK/FAIL/STRAGGLER)
    target_nodes: int = 0           # new total node count (GROW/RESTART)
    queue_delay_s: float = 0.0      # RMS arbitration wait (QUEUE stage)


@dataclass
class SimulatedRMS:
    """Scripted, scenario-fed, or policy-generated event source."""

    script: list[Event] = field(default_factory=list)

    def events_until(self, step: int) -> Iterator[Event]:
        due = [e for e in self.script if e.step <= step]
        self.script = [e for e in self.script if e.step > step]
        yield from due

    @staticmethod
    def scripted(events: list[tuple[int, EventKind, tuple | int]]) -> "SimulatedRMS":
        out = []
        for step, kind, arg in events:
            if kind is EventKind.GROW:
                out.append(Event(step=step, kind=kind, target_nodes=int(arg)))
            else:
                nodes = (arg,) if isinstance(arg, int) else tuple(arg)
                out.append(Event(step=step, kind=kind, nodes=nodes))
        return SimulatedRMS(script=out)

    @staticmethod
    def from_scenario(scenario) -> "SimulatedRMS":
        """Feed a declarative :class:`repro_torch.malleability.scenarios.Scenario`
        trace through the live event loop — the exact trace the simulator
        executes, so timeline-derived downtimes agree across both paths."""
        out = [
            Event(
                step=e.step,
                kind=EventKind(e.kind),
                nodes=tuple(e.nodes),
                target_nodes=e.target_nodes,
                queue_delay_s=e.queue_delay_s,
            )
            for e in sorted(scenario.events, key=lambda e: e.step)
        ]
        return SimulatedRMS(script=out)

    @staticmethod
    def from_policy(policy: RmsPolicy, cluster: ClusterState,
                    job: str | None = None) -> "SimulatedRMS":
        """Run an RMS policy and feed its generated trace to the runtime.

        Args:
            policy: any :class:`RmsPolicy` (backfill / preemption /
                churn / third-party).
            cluster: the RMS-side cluster view the policy schedules on.
            job: which job's trace to follow (defaults to the policy
                trace's primary — its first — job).
        Returns:
            A :class:`SimulatedRMS` scripted with the policy's decisions
            for that job.
        """
        trace = policy.generate(cluster)
        name = job if job is not None else trace.primary_job
        return SimulatedRMS.from_scenario(trace.scenario(name))
