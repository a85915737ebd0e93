"""RMS policy engine: WHO grows, WHO shrinks, and WHEN.

The paper's contribution is the *mechanism* — parallel spawning makes a
resize cheap.  The policy literature (Iserte et al., "Resource
Optimization with MPI Process Malleability"; Chadha et al., "Extending
SLURM for Dynamic Resource-Aware Adaptive Batch Scheduling") shows the
makespan wins come from the scheduler exploiting that cheapness.  This
module is the policy side of the reproduction:

* :class:`ClusterState` — the RMS's ledger: one shared node pool plus
  per-job allocations (distinct from :class:`repro_torch.core.ClusterState`,
  which is a single job's *world* bookkeeping).  Build it from a live
  :class:`~repro_torch.elastic.node_group.DevicePool` via :meth:`from_pool` to
  schedule over the same pool the runtime partitions.
* :class:`RmsPolicy` implementations — :class:`BackfillPolicy` (idle
  nodes flow to malleable jobs and are reclaimed under queue pressure),
  :class:`PreemptionPolicy` (priority arrivals force-shrink
  lower-priority jobs, composing with in-flight reconfigurations), and
  :class:`ChurnPolicy` (seeded long-horizon grow/shrink cycling).
* :func:`arbitrate_jobs` — the multi-job path: several jobs' traces are
  charged against ONE pool; conflicts surface as queued RESIZE events
  (deferred steps + ``queue_delay_s`` QUEUE spans) and degraded overlap
  (the scenario's ``contention`` override).

Every policy *generates* a declarative
:class:`~repro_torch.malleability.scenarios.Scenario`, so the existing
sim/live machinery consumes policy output unchanged — the parity the
rest of the repo pins (sim == live per event) holds for policy traces
for free.
"""
from __future__ import annotations

import math
import random
import warnings
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Protocol, Sequence, Tuple, runtime_checkable

from repro_torch.core import Topology

from .cost_model import MN5, CostModel
from .scenarios import (
    CHECKPOINT,
    GROW,
    RESTART,
    SHRINK,
    Scenario,
    ScenarioEvent,
    TransitionCache,
    param_bytes_for_arch,
    register_scenario,
    run_scenario_sim,
    run_scenario_vectorized,
    steady_cycle,
)
from .throughput import ThroughputModel


# ============================================================= cluster view ==
@dataclass(frozen=True)
class JobSpec:
    """One job as the RMS sees it (limits + scheduling class)."""

    name: str
    min_nodes: int = 1               # guaranteed floor (never reclaimed below)
    max_nodes: int = 8               # grant ceiling
    priority: int = 0                # higher preempts lower
    malleable: bool = True           # rigid jobs neither grow nor shrink
    initial_nodes: int = 0           # 0 -> min_nodes
    arch: str = ""                   # pytree the job reshards on resize
    param_bytes: int = 0             # explicit pytree size (overrides arch)

    def __post_init__(self) -> None:
        if self.min_nodes < 1 or self.max_nodes < self.min_nodes:
            raise ValueError(
                f"job {self.name!r}: need 1 <= min_nodes <= max_nodes, "
                f"got [{self.min_nodes}, {self.max_nodes}]"
            )

    def start_nodes(self) -> int:
        return self.initial_nodes or self.min_nodes


@dataclass
class ClusterState:
    """RMS-side cluster ledger: a shared node pool + per-job allocations.

    NOT :class:`repro_torch.core.ClusterState` (one job's world/rank
    bookkeeping): this is the scheduler's view ACROSS jobs.  Policies
    read it to decide who grows/shrinks; they never mutate it — a policy
    run is a pure function from this view to a trace.

    ``topology`` is the pool's node -> rack -> pod tree (when known):
    policy-generated scenarios inherit it, so their traces replay with
    topology-aware placement and distance-class stage-3 pricing — the
    dynamic-resource-aware-SLURM view where the scheduler knows the
    rack layout it is granting from.
    """

    total_nodes: int
    jobs: tuple[JobSpec, ...] = ()
    allocations: Dict[str, int] = field(default_factory=dict)
    topology: Optional[Topology] = None

    def __post_init__(self) -> None:
        if self.total_nodes <= 0:
            raise ValueError("total_nodes must be positive")
        if self.topology is not None and self.topology.n_nodes < self.total_nodes:
            raise ValueError(
                f"topology covers {self.topology.n_nodes} nodes but the "
                f"pool holds {self.total_nodes}"
            )
        names = [j.name for j in self.jobs]
        if len(names) != len(set(names)):
            raise ValueError(f"duplicate job names: {names}")
        for j in self.jobs:
            self.allocations.setdefault(j.name, j.start_nodes())
        if self.allocated() > self.total_nodes:
            raise ValueError(
                f"over-committed: {self.allocated()} nodes allocated on a "
                f"{self.total_nodes}-node pool"
            )

    @classmethod
    def from_pool(cls, pool, jobs: Sequence[JobSpec] = ()) -> "ClusterState":
        """Schedule over a live :class:`~repro_torch.elastic.node_group.DevicePool`
        (or anything with ``n_nodes``): the policy layer then sees exactly
        the pool the elastic runtime partitions — its rack topology
        included, when the pool carries one."""
        return cls(total_nodes=pool.n_nodes, jobs=tuple(jobs),
                   topology=getattr(pool, "topology", None))

    # ---- queries -----------------------------------------------------------
    def spec(self, name: str) -> JobSpec:
        for j in self.jobs:
            if j.name == name:
                return j
        raise KeyError(f"unknown job {name!r}")

    def allocated(self) -> int:
        return sum(self.allocations.values())

    def idle_nodes(self) -> int:
        return self.total_nodes - self.allocated()

    def malleable_jobs(self) -> tuple[JobSpec, ...]:
        return tuple(j for j in self.jobs if j.malleable)

    def primary_malleable(self) -> JobSpec:
        mall = self.malleable_jobs()
        if not mall:
            raise ValueError("cluster has no malleable job to schedule")
        return mall[0]

    def clamp_grant(self, job: JobSpec, requested: int) -> int:
        """Clamp a grant to the job's limits AND the pool's capacity.

        A policy may *request* anything (e.g. backfill offering a job
        more nodes than the pool holds); the grant is what fits:
        ``[min_nodes, min(max_nodes, pool minus other jobs)]``.  Never
        raises — an oversized request clamps, it does not crash.
        """
        others = self.allocated() - self.allocations.get(job.name, 0)
        cap = min(job.max_nodes, self.total_nodes - others)
        return max(job.min_nodes, min(requested, cap))


# ============================================================ policy output ==
@dataclass
class PolicyTrace:
    """A policy run's output: per-job declarative event traces.

    ``scenario(job)`` materializes one job's trace as a plain
    :class:`Scenario` — the same object the simulator, the live runtime,
    the trainer, and the benchmarks already consume.
    """

    policy: str
    cluster_nodes: int
    initial: Dict[str, int]                       # job -> starting nodes
    events: Dict[str, Tuple[ScenarioEvent, ...]]  # job -> trace
    steps: int
    specs: Dict[str, JobSpec] = field(default_factory=dict)
    topology: Optional[Topology] = None           # pool layout, if known

    @property
    def primary_job(self) -> str:
        return next(iter(self.initial))

    def scenario(self, job: Optional[str] = None, *, name: str = "",
                 description: str = "", **overrides) -> Scenario:
        job = job if job is not None else self.primary_job
        if job not in self.events:
            raise KeyError(
                f"no trace for job {job!r}; traced: {sorted(self.events)}")
        spec = self.specs.get(job)
        kwargs: Dict[str, Any] = dict(
            arch=spec.arch if spec else "",
            param_bytes=spec.param_bytes if spec else 0,
        )
        if self.topology is not None:
            # The generated trace inherits the pool's rack layout, so
            # replays place and price against the real topology.
            kwargs["rack_sizes"] = self.topology.rack_sizes
            kwargs["pod_sizes"] = self.topology.pod_sizes
        kwargs.update(overrides)
        return Scenario(
            name=name or f"{self.policy}:{job}",
            description=description or (
                f"{self.policy} policy trace for job {job!r} on a "
                f"{self.cluster_nodes}-node pool"),
            initial_nodes=self.initial[job],
            events=self.events[job],
            steps=self.steps,
            **kwargs,
        )

    def scenarios(self) -> Dict[str, Scenario]:
        return {job: self.scenario(job) for job in self.events}


@runtime_checkable
class RmsPolicy(Protocol):
    """A scheduling policy: cluster view in, declarative traces out."""

    name: str

    def generate(self, cluster: ClusterState) -> PolicyTrace: ...


# ---- shared helpers ---------------------------------------------------------
def _resize(step: int, current: int, target: int) -> ScenarioEvent:
    """One RMS resize decision as a scenario event.

    Grows name the new total; shrinks name the victim node ids — always
    the TOP ids, which keeps sim and live node trajectories identical
    (both acquire lowest-free first) and live slot order a prefix of
    the pool's slots.
    """
    if target > current:
        return ScenarioEvent(step=step, kind=GROW, target_nodes=target)
    if target < current:
        return ScenarioEvent(step=step, kind=SHRINK,
                             nodes=tuple(range(target, current)))
    raise ValueError("resize to the current size is a no-op")


def _check_arrival_window(arrivals, start_step: int, horizon: int,
                          policy: str) -> None:
    """Reject arrivals the stepped walk would silently never see."""
    for a in arrivals:
        if not start_step <= a.step < horizon:
            raise ValueError(
                f"{policy}: arrival at step {a.step} is outside the "
                f"scheduled window [start_step={start_step}, "
                f"horizon={horizon}) and would be silently ignored")


def _trial_walls(events: Sequence[ScenarioEvent], template: Scenario) -> List[float]:
    """Per-event charged wall times (queue-free), via a throwaway sim run."""
    stripped = tuple(replace(e, queue_delay_s=0.0)
                     for e in sorted(events, key=lambda e: e.step))
    trial = replace(
        template,
        name=template.name + "__trial",
        events=stripped,
        steps=max((e.step for e in stripped), default=0) + 2,
    )
    recs = run_scenario_sim(trial)
    if len(recs) != len(stripped):
        raise ValueError(
            f"trace for {template.name!r} has ineffective events "
            f"({len(stripped)} events, {len(recs)} records); per-event "
            "walls are ambiguous")
    return [r.est_wall_s for r in recs]


def charge_in_flight_queueing(scenario: Scenario) -> Scenario:
    """Charge same-step successors as queued behind the in-flight event.

    When two events land on one application step (a preemption arriving
    mid-grow, a composed drop+regrow), the second cannot start until the
    first's reconfiguration drains: its ``queue_delay_s`` becomes the
    sum of the earlier same-step events' charged walls.  Single-event
    steps are untouched; a scenario without step collisions is returned
    unchanged.
    """
    events = tuple(sorted(scenario.events, key=lambda e: e.step))
    if len({e.step for e in events}) == len(events):
        return scenario
    walls = _trial_walls(events, scenario)
    out = []
    for i, ev in enumerate(events):
        acc = sum(walls[j] for j in range(i) if events[j].step == ev.step)
        out.append(replace(ev, queue_delay_s=acc) if acc > 0 else ev)
    return replace(scenario, events=tuple(out))


def _predicted_wall(template: Scenario, event: ScenarioEvent,
                    cost_model: Optional[CostModel] = None,
                    prelude: Tuple[ScenarioEvent, ...] = (),
                    throughput: Optional[ThroughputModel] = None,
                    horizon_steps: int = 0) -> float:
    """Charged wall of ONE candidate event via a throwaway sim run.

    The decision engine behind mechanism choices: the candidate is
    charged by the same engine both executors use, so "which path is
    cheaper" is answered with the numbers the timeline would actually
    show, not a side formula that could drift.  ``prelude`` events set
    up the cluster state the candidate fires from (e.g. a grow, so the
    job holds node-confined worlds like a real trace would); only the
    LAST record — the candidate's — is returned.  With a
    ``throughput=`` model, the remaining ``horizon_steps`` are priced
    at the candidate's landing allocation and added in, so candidates
    that end on different sizes compete on predicted time-to-result,
    not on reconfiguration wall alone.
    """
    events = tuple(prelude) + (replace(event, queue_delay_s=0.0),)
    trial = replace(
        template,
        name=template.name + "__decide",
        events=events,
        steps=max(e.step for e in events) + 2,
    )
    recs = run_scenario_sim(trial, cost_model=cost_model)
    wall = recs[-1].est_wall_s
    if throughput is not None and horizon_steps > 0:
        widths = throughput.widths_for(
            recs[-1].nodes_after, core_pool=template.core_pool,
            default_width=template.cores_per_node)
        wall += horizon_steps * throughput.step_time(widths)
    return wall


# ================================================================= policies ==
@dataclass(frozen=True)
class RigidArrival:
    """A rigid (non-malleable) batch job entering the queue."""

    step: int
    nodes: int
    duration: int
    priority: int = 0


@dataclass(frozen=True)
class BackfillPolicy:
    """Idle nodes flow to malleable jobs; queue pressure reclaims them.

    The EASY-backfill intuition under malleability (Iserte et al.): a
    malleable job soaks up whatever the rigid queue is not using, down
    to its guaranteed ``min_nodes`` floor when rigid jobs need the
    space.  A rigid arrival starts as soon as the pool minus that floor
    fits it (the malleable job is force-shrunk to make room); otherwise
    it waits in FIFO order.  Grants are clamped by
    :meth:`ClusterState.clamp_grant` — a job whose ``max_nodes`` exceeds
    the pool simply receives the pool, never an error.
    """

    arrivals: Tuple[RigidArrival, ...] = ()
    horizon: int = 40
    start_step: int = 2
    name: str = "backfill"

    def generate(self, cluster: ClusterState) -> PolicyTrace:
        job = cluster.primary_malleable()
        _check_arrival_window(self.arrivals, self.start_step, self.horizon,
                              self.name)
        alloc = cluster.allocations[job.name]
        events: List[ScenarioEvent] = []
        queue: List[RigidArrival] = []
        running: List[List[int]] = []          # [end_step, nodes]
        arrivals = sorted(self.arrivals, key=lambda a: a.step)
        for step in range(self.start_step, self.horizon):
            running = [r for r in running if r[0] > step]
            queue.extend(a for a in arrivals if a.step == step)
            rigid_used = sum(r[1] for r in running)
            waiting: List[RigidArrival] = []
            for a in queue:     # FIFO: start whatever fits above the floor
                if a.nodes <= cluster.total_nodes - rigid_used - job.min_nodes:
                    running.append([step + a.duration, a.nodes])
                    rigid_used += a.nodes
                else:
                    waiting.append(a)
            queue = waiting
            target = cluster.clamp_grant(job, cluster.total_nodes - rigid_used)
            if target != alloc:
                events.append(_resize(step, alloc, target))
                alloc = target
        return PolicyTrace(
            policy=self.name,
            cluster_nodes=cluster.total_nodes,
            initial={job.name: cluster.allocations[job.name]},
            events={job.name: tuple(events)},
            steps=self.horizon + 2,
            specs={job.name: job},
            topology=cluster.topology,
        )


@dataclass(frozen=True)
class PriorityArrival:
    """A high-priority job demanding nodes NOW (preemption source)."""

    step: int
    nodes: int
    duration: int
    priority: int = 100


@dataclass(frozen=True)
class PreemptionPolicy:
    """Priority arrivals force-shrink lower-priority malleable jobs.

    The malleable job grows opportunistically into idle nodes; when a
    higher-priority job arrives, the policy immediately reclaims down to
    whatever still fits beside the preemptor.  A preemption landing on a
    step where the victim already has a reconfiguration in flight (the
    opportunistic grow at the same step) COMPOSES with it instead of
    cancelling: the forced shrink is emitted at the same step, queued
    behind the in-flight event's charged wall
    (:func:`charge_in_flight_queueing`), so both executors see the grow
    drain first and the preemption pay its QUEUE span.

    ``mechanism`` picks HOW the victim gives nodes back: ``"shrink"``
    (the default — malleable TS shrink, the historical trace bit for
    bit), ``"restart"`` (rigid full-stop checkpoint/restart at the
    smaller size — what a non-malleable job would do), or ``"auto"``
    (charge both candidates through the engine and emit whichever
    predicts the smaller ``est_wall`` — the dynamic-awareness decision
    rule).  ``decision_cost_model`` overrides the cost model the
    ``"auto"`` comparison charges with (e.g. the actual cluster's
    measured constants), without touching the trace's replay pricing.
    With a ``throughput=`` model, the ``"auto"`` comparison prices the
    steps remaining to the horizon at each candidate's landing
    allocation on top of the reconfiguration wall — predicted
    time-to-result, not downtime alone.  (Both mechanisms currently
    land on the same target size, so the added term is symmetric and
    today's decisions are unchanged; it starts discriminating the
    moment a mechanism lands elsewhere, e.g. a restart that rounds to
    a power-of-two world.)
    """

    arrivals: Tuple[PriorityArrival, ...] = ()
    horizon: int = 24
    start_step: int = 2
    name: str = "preemption"
    mechanism: str = "shrink"        # shrink | restart | auto
    decision_cost_model: Optional[CostModel] = None
    throughput: Optional[ThroughputModel] = None

    def _preempt_event(self, job: JobSpec, step: int, alloc: int,
                       target: int) -> ScenarioEvent:
        """The reclaim event for one forced ``alloc -> target`` resize."""
        if self.mechanism == "shrink":
            return _resize(step, alloc, target)
        restart_ev = ScenarioEvent(step=step, kind=RESTART,
                                   target_nodes=target)
        if self.mechanism == "restart":
            return restart_ev
        if self.mechanism != "auto":
            raise ValueError(
                f"{self.name}: unknown mechanism {self.mechanism!r}; "
                "expected 'shrink', 'restart' or 'auto'")
        # The trial replays the job's actual shape at decision time: it
        # grew into ``alloc`` node-confined worlds, so the shrink
        # candidate prices as a real TS teardown, not a zombification
        # of one big initial world.
        template = Scenario(
            name=f"{self.name}:{job.name}",
            description="preemption mechanism decision trial",
            initial_nodes=1,
            events=(),
            steps=step + 2,
            arch=job.arch,
            param_bytes=job.param_bytes,
        )
        prelude = (
            (ScenarioEvent(step=max(0, step - 1), kind=GROW,
                           target_nodes=alloc),)
            if alloc > 1 else ()
        )
        shrink_ev = _resize(step, alloc, target)
        cm = self.decision_cost_model
        remaining = max(0, self.horizon - step)
        t_shrink = _predicted_wall(template, shrink_ev, cost_model=cm,
                                   prelude=prelude,
                                   throughput=self.throughput,
                                   horizon_steps=remaining)
        t_restart = _predicted_wall(template, restart_ev, cost_model=cm,
                                    prelude=prelude,
                                    throughput=self.throughput,
                                    horizon_steps=remaining)
        return shrink_ev if t_shrink <= t_restart else restart_ev

    def generate(self, cluster: ClusterState) -> PolicyTrace:
        job = cluster.primary_malleable()
        _check_arrival_window(self.arrivals, self.start_step, self.horizon,
                              self.name)
        alloc = cluster.allocations[job.name]
        events: List[ScenarioEvent] = []
        running: List[List[int]] = []          # [end_step, nodes]
        arrivals = sorted(self.arrivals, key=lambda a: a.step)
        for step in range(self.start_step, self.horizon):
            running = [r for r in running if r[0] > step]
            used = sum(r[1] for r in running)
            # Opportunistic growth first: the job is mid-cycle when a
            # same-step preemptor lands.
            target = cluster.clamp_grant(job, cluster.total_nodes - used)
            if target != alloc:
                events.append(_resize(step, alloc, target))
                alloc = target
            for a in (a for a in arrivals if a.step == step):
                if a.priority <= job.priority:
                    continue                   # not allowed to preempt us
                # Even a preemptor cannot take the victim's guaranteed
                # floor or more than the pool still holds: the grant is
                # trimmed so the ledger never over-commits.
                grant = min(a.nodes,
                            cluster.total_nodes - used - job.min_nodes)
                if grant <= 0:
                    continue                   # nothing reclaimable
                running.append([step + a.duration, grant])
                used += grant
                target = cluster.clamp_grant(job, cluster.total_nodes - used)
                if target < alloc:
                    events.append(self._preempt_event(job, step, alloc, target))
                    alloc = target
        trace = PolicyTrace(
            policy=self.name,
            cluster_nodes=cluster.total_nodes,
            initial={job.name: cluster.allocations[job.name]},
            events={job.name: tuple(events)},
            steps=self.horizon + 2,
            specs={job.name: job},
            topology=cluster.topology,
        )
        # Resolve mid-cycle compositions into QUEUE charges.
        queued = charge_in_flight_queueing(trace.scenario(job.name))
        trace.events[job.name] = queued.events
        return trace


@dataclass(frozen=True)
class ChurnPolicy:
    """Seeded long-horizon grow/shrink cycling (RMS allocation churn).

    Every ``period`` steps the RMS moves the malleable job to a fresh
    uniformly-drawn target in ``[min_nodes, min(max_nodes, pool)]``
    (never the current size, so every decision is a real RESIZE).  The
    trace is a pure function of ``seed`` — identical seeds yield
    identical traces, which is what lets a 200-event churn run be pinned
    by tests and replayed bit-for-bit in CI.
    """

    decisions: int = 200
    period: int = 1
    seed: int = 0
    start_step: int = 2
    name: str = "churn"

    def generate(self, cluster: ClusterState) -> PolicyTrace:
        job = cluster.primary_malleable()
        lo = job.min_nodes
        hi = min(job.max_nodes, cluster.total_nodes)
        if hi <= lo:
            raise ValueError(
                f"churn needs headroom: job {job.name!r} is pinned at "
                f"{lo} nodes on this pool")
        rng = random.Random(self.seed)
        alloc = cluster.allocations[job.name]
        events: List[ScenarioEvent] = []
        step = self.start_step
        for _ in range(self.decisions):
            # Stream-identical O(1) draw: ``random.choice(seq)`` consumes
            # exactly one ``_randbelow(len(seq))``, and ``randrange(n)``
            # is that same call, so indexing the ``hi - lo`` non-current
            # candidates and skipping past ``alloc`` reproduces the
            # historical list-based choice bit-for-bit without
            # materializing the list (``hi`` can be a 10k-node pod).
            if lo <= alloc <= hi:
                target = lo + rng.randrange(hi - lo)
                if target >= alloc:
                    target += 1
            else:  # alloc outside the band: every candidate is drawable
                target = lo + rng.randrange(hi - lo + 1)
            events.append(_resize(step, alloc, target))
            alloc = target
            step += self.period
        return PolicyTrace(
            policy=self.name,
            cluster_nodes=cluster.total_nodes,
            initial={job.name: cluster.allocations[job.name]},
            events={job.name: tuple(events)},
            steps=step + 2,
            specs={job.name: job},
            topology=cluster.topology,
        )


@dataclass(frozen=True)
class CheckpointIntervalPolicy:
    """Young/Daly checkpoint cadence: ``T_opt = sqrt(2 * C * MTBF)``.

    The adaptive fault-tolerance policy: instead of resizing, it decides
    WHEN to snapshot.  The checkpoint cost ``C`` is priced by the SAME
    cost model that charges the timeline (``cm.checkpoint`` over the
    job's pytree), so a bigger model or a slower store link directly
    stretches the interval, and a shorter MTBF tightens it — the
    classic first-order optimum balancing snapshot overhead against
    expected rework.  The generated trace is a pure CHECKPOINT cadence
    the existing sim/live machinery replays unchanged.

    ``step_time_s`` defaults to the historical 1 s/step; give the
    policy a ``throughput=`` model instead and the cadence tracks the
    job's actual allocation — a wide grant shortens the step, which
    stretches the interval in *steps* exactly as Young/Daly says it
    should.
    """

    mtbf_s: float = 3600.0           # mean time between failures
    step_time_s: float = 1.0         # seconds of compute per app step
    horizon: int = 40
    start_step: int = 2
    cost_model: Optional[CostModel] = None   # pricing for C (default MN5)
    name: str = "ckpt-interval"
    throughput: Optional[ThroughputModel] = None

    def resolved_step_time_s(self, nodes: int = 0) -> float:
        """Seconds per app step: modeled when a ``throughput`` model and
        a real allocation are given, the flat ``step_time_s`` otherwise.
        """
        if self.throughput is None or nodes <= 0:
            return self.step_time_s
        return self.throughput.step_time(self.throughput.widths_for(nodes))

    def interval_steps(self, job: JobSpec, nodes: int = 0) -> int:
        """Young/Daly optimum, floored at one step.

        A zero-byte pytree prices ``C = 0`` and degenerates to
        checkpointing every step — harmless, but callers sizing real
        jobs should give the spec an ``arch`` or ``param_bytes``.
        ``nodes`` is the job's current allocation, used to resolve the
        modeled step time when a ``throughput`` model is set.
        """
        cm = self.cost_model if self.cost_model is not None else MN5
        pb = job.param_bytes or (
            param_bytes_for_arch(job.arch) if job.arch else 0)
        cost = cm.checkpoint(pb)
        t_opt = math.sqrt(2.0 * cost * self.mtbf_s)
        return max(1, round(t_opt / self.resolved_step_time_s(nodes)))

    def generate(self, cluster: ClusterState) -> PolicyTrace:
        job = cluster.primary_malleable()
        every = self.interval_steps(job, cluster.allocations[job.name])
        events = tuple(
            ScenarioEvent(step=s, kind=CHECKPOINT)
            for s in range(self.start_step + every, self.horizon, every)
        )
        return PolicyTrace(
            policy=self.name,
            cluster_nodes=cluster.total_nodes,
            initial={job.name: cluster.allocations[job.name]},
            events={job.name: events},
            steps=self.horizon + 2,
            specs={job.name: job},
            topology=cluster.topology,
        )


@dataclass(frozen=True)
class TrafficPolicy:
    """Request-traffic autoscaler: a rate trace + SLO targets in,
    grow/shrink decisions out.

    The serving-plane policy (ROADMAP item 1): instead of batch RESIZE
    events, the RMS watches a **request-rate trace** (requests arriving
    per application step) and sizes the decode pool so the SLO holds.
    The demand model is Little's law plus a backlog-drain term:

    * each admitted request occupies one decode slot for ``hold_steps``
      steps, so steady-state demand is ``rate * hold_steps`` slots;
    * a worker serves ``slots_per_worker / hold_steps`` requests per
      step; arrivals beyond that accumulate as ``backlog``, and the SLO
      requires draining it within ``slo_queue_steps`` steps — an extra
      ``backlog * hold_steps / slo_queue_steps`` slots of demand.

    The slot demand is fitted UP the ``allowed_sizes`` ladder (decode
    worker counts that shard the service's batch — like trainer world
    sizes, powers of two here), then clamped by
    :meth:`ClusterState.clamp_grant`.  Grows fire **immediately** (an
    SLO breach is paid in tail latency every step it persists), carrying
    ``grant_delay_s`` as their QUEUE span — the RMS arbitration wait for
    the grant, charged on the timeline like every other queue delay.
    Shrinks wait for ``cooldown`` consecutive below-target steps, the
    standard anti-flapping hysteresis.

    A policy run is a pure function of the rate trace, so its
    :class:`PolicyTrace` — and the registered serve scenarios built from
    it — replay bit-identically through sim, live, and trainer
    executors.  The serving loop (:func:`repro_torch.serving.run_serve`)
    replays the SAME rate trace for its arrivals, so latency and
    queueing are emergent from the decisions made here.
    """

    rates: Tuple[float, ...] = ()     # requests arriving per step
    slots_per_worker: int = 5         # concurrent decode slots per worker
    hold_steps: int = 8               # steps one request occupies a slot
    slo_queue_steps: float = 4.0      # drain backlog within this many steps
    allowed_sizes: Tuple[int, ...] = (1, 2, 4, 8)
    cooldown: int = 2                 # below-target steps before a shrink
    grant_delay_s: float = 0.0        # RMS arbitration wait per grow grant
    name: str = "traffic"

    def __post_init__(self) -> None:
        if not self.rates:
            raise ValueError("traffic policy needs a non-empty rate trace")
        if min(self.rates) < 0:
            raise ValueError("request rates cannot be negative")
        if self.slots_per_worker < 1 or self.hold_steps < 1:
            raise ValueError("slots_per_worker and hold_steps must be >= 1")
        if self.slo_queue_steps <= 0:
            raise ValueError("slo_queue_steps must be positive")
        if self.cooldown < 1:
            raise ValueError("cooldown must be >= 1")
        if not self.allowed_sizes or sorted(self.allowed_sizes) != list(
                self.allowed_sizes):
            raise ValueError("allowed_sizes must be ascending and non-empty")

    def demand_workers(self, rate: float, backlog: float) -> int:
        """Workers needed for one step's rate + backlog (before the ladder)."""
        slots = (rate * self.hold_steps
                 + backlog * self.hold_steps / self.slo_queue_steps)
        return max(1, math.ceil(slots / self.slots_per_worker))

    def generate(self, cluster: ClusterState) -> PolicyTrace:
        job = cluster.primary_malleable()
        alloc = cluster.allocations[job.name]
        backlog = 0.0
        below = 0
        events: List[ScenarioEvent] = []
        for step, rate in enumerate(self.rates):
            served = alloc * self.slots_per_worker / self.hold_steps
            backlog = max(0.0, backlog + rate - served)
            need = self.demand_workers(rate, backlog)
            fitted = next((s for s in self.allowed_sizes if s >= need),
                          self.allowed_sizes[-1])
            target = cluster.clamp_grant(job, fitted)
            if target > alloc:
                ev = _resize(step, alloc, target)
                if self.grant_delay_s > 0.0:
                    ev = replace(ev, queue_delay_s=self.grant_delay_s)
                events.append(ev)
                alloc = target
                below = 0
            elif target < alloc:
                below += 1
                if below >= self.cooldown:
                    events.append(_resize(step, alloc, target))
                    alloc = target
                    below = 0
            else:
                below = 0
        return PolicyTrace(
            policy=self.name,
            cluster_nodes=cluster.total_nodes,
            initial={job.name: cluster.allocations[job.name]},
            events={job.name: tuple(events)},
            steps=len(self.rates) + 2,
            specs={job.name: job},
            topology=cluster.topology,
        )


# ======================================================= multi-job arbiter ==
@dataclass(frozen=True)
class ArbitratedJob:
    """One job's share of an arbitrated multi-job workload."""

    name: str
    scenario: Scenario
    queued_events: int      # emitted with queue_delay_s > 0
    deferred_events: int    # pushed to a later step by capacity
    clamped_events: int     # grow target cut down to fit the pool
    dropped_events: int     # arbitration made them no-ops


@dataclass(frozen=True)
class MultiJobOutcome:
    """Arbitration result: per-job scenarios + interference accounting."""

    pool_nodes: int
    jobs: Tuple[ArbitratedJob, ...]
    interfered: Tuple[str, ...]

    @property
    def scenarios(self) -> Dict[str, Scenario]:
        return {j.name: j.scenario for j in self.jobs}

    def job(self, name: str) -> ArbitratedJob:
        for j in self.jobs:
            if j.name == name:
                return j
        raise KeyError(name)


def arbitrate_jobs(
    jobs: Sequence[Tuple[str, Scenario]],
    pool_nodes: int,
    *,
    contention: float = 1.25,
    defer_slack: int = 16,
) -> MultiJobOutcome:
    """Charge several jobs' timelines against ONE shared node pool.

    Walks the merged trace step by step, tracking every job's
    allocation.  Interference surfaces exactly the two ways a real RMS
    shows it:

    * **queued RESIZE events** — a grow that does not fit is deferred to
      the first step with capacity; an event landing on a step where
      another reconfiguration is already in flight is emitted with
      ``queue_delay_s`` equal to the in-flight events' charged wall
      (a QUEUE span on its timeline, raising makespan but not downtime);
    * **degraded overlap** — jobs that interfered get the ``contention``
      override on their scenario, so ASYNC hiding buys them less
      (the existing contention factor, per PR 2).

    Grow targets are clamped to the capacity the other jobs leave;
    within a step, scheduled events run in job order and deferred events
    retry after them.  Deferred grows still starved ``defer_slack``
    steps past the last scheduled event are dropped.  Queue delays the
    input traces already carry (e.g. a preemption composed by
    :func:`charge_in_flight_queueing`) are preserved; cross-job waits
    are added on top.

    Args:
        jobs: ``(name, scenario)`` pairs in arrival (priority) order.
        pool_nodes: the shared pool's node count.
        contention: overlap-contention assigned to interfered jobs.
        defer_slack: extra steps a starved grow may wait before dropping.
    Returns:
        A :class:`MultiJobOutcome`; each per-job scenario is standalone
        (private node numbering) and runs through the existing sim/live
        machinery unchanged.
    """
    names = [name for name, _ in jobs]
    if len(names) != len(set(names)):
        raise ValueError(f"duplicate job names: {names}")
    by_name = dict(jobs)
    allocs = {name: sc.initial_nodes for name, sc in jobs}
    if sum(allocs.values()) > pool_nodes:
        raise ValueError(
            f"over-committed: jobs start with {sum(allocs.values())} nodes "
            f"on a {pool_nodes}-node pool")

    sched: Dict[int, List[Tuple[str, ScenarioEvent]]] = {}
    for name, sc in jobs:
        for ev in sorted(sc.events, key=lambda e: e.step):
            sched.setdefault(ev.step, []).append((name, ev))
    last_step = (max(sched) if sched else 0) + defer_slack

    emitted: Dict[str, List[ScenarioEvent]] = {name: [] for name in names}
    emission_order: Dict[int, List[Tuple[str, int]]] = {}
    deferred: List[Tuple[str, ScenarioEvent, bool]] = []  # (job, ev, counted)
    stats = {name: {"queued": 0, "deferred": 0, "clamped": 0, "dropped": 0}
             for name in names}
    interfered: set[str] = set()

    def emit(step: int, name: str, ev: ScenarioEvent) -> None:
        emitted[name].append(ev)
        emission_order.setdefault(step, []).append((name, len(emitted[name]) - 1))

    step = 0
    while step <= last_step and (sched or deferred):
        retries, deferred = deferred, []
        todo = [(n, ev, False) for n, ev in sched.pop(step, [])] + retries
        for name, ev, counted in todo:
            alloc = allocs[name]
            if ev.kind == GROW:
                capacity = pool_nodes - (sum(allocs.values()) - alloc)
                target = min(ev.target_nodes, capacity)
                if ev.target_nodes <= alloc:
                    stats[name]["dropped"] += 1      # already satisfied
                    continue
                if target <= alloc:
                    # capacity-starved: the RESIZE queues for a later step
                    if not counted:
                        stats[name]["deferred"] += 1
                        interfered.add(name)
                    if step < last_step:
                        deferred.append((name, ev, True))
                    else:
                        stats[name]["dropped"] += 1
                    continue
                if target < ev.target_nodes:
                    stats[name]["clamped"] += 1
                    interfered.add(name)
                emit(step, name, ScenarioEvent(
                    step=step, kind=GROW, target_nodes=target,
                    queue_delay_s=ev.queue_delay_s))
                allocs[name] = target
            else:   # shrink / fail / straggler: victims are top private ids
                victims = tuple(n for n in ev.nodes if n < alloc)
                if not victims:
                    stats[name]["dropped"] += 1
                    continue
                emit(step, name, ScenarioEvent(
                    step=step, kind=ev.kind, nodes=victims,
                    queue_delay_s=ev.queue_delay_s))
                allocs[name] = alloc - len(victims)
        step += 1
    assert not deferred     # the step == last_step iteration drops inline

    # Charged walls per emitted event (queue-free), for QUEUE spans.
    walls = {
        name: (_trial_walls(emitted[name], by_name[name]) if emitted[name] else [])
        for name in names
    }
    for step, ems in emission_order.items():
        if len({name for name, _ in ems}) > 1:
            interfered.update(name for name, _ in ems)
        acc = 0.0
        for name, idx in ems:
            if acc > 0.0:
                # Added on top of any wait the input trace already carried
                # (e.g. a preemption composed by charge_in_flight_queueing).
                emitted[name][idx] = replace(
                    emitted[name][idx],
                    queue_delay_s=emitted[name][idx].queue_delay_s + acc)
                stats[name]["queued"] += 1
                interfered.add(name)
            acc += walls[name][idx]

    out = []
    for name, sc in jobs:
        evs = tuple(emitted[name])
        steps = max(sc.steps, max((e.step for e in evs), default=0) + 2)
        arb = replace(
            sc, events=evs, steps=steps,
            contention=(contention if name in interfered else sc.contention),
        )
        s = stats[name]
        out.append(ArbitratedJob(
            name=name, scenario=arb, queued_events=s["queued"],
            deferred_events=s["deferred"], clamped_events=s["clamped"],
            dropped_events=s["dropped"],
        ))
    return MultiJobOutcome(pool_nodes=pool_nodes, jobs=tuple(out),
                           interfered=tuple(sorted(interfered)))


def run_multijob_sim(
    jobs: Sequence[Tuple[str, Scenario]],
    pool_nodes: int,
    *,
    contention: float = 1.25,
    vectorized: bool = True,
    strategy=None,
    cost_model=None,
    throughput: Optional[ThroughputModel] = None,
):
    """Arbitrate and simulate a multi-job workload on one pool.

    Returns ``(records, outcome)``: per-job
    :class:`~repro_torch.malleability.scenarios.ScenarioRecord` lists from the
    timeline-charging simulator, plus the :class:`MultiJobOutcome` whose
    scenarios produced them.  ``vectorized=True`` (the default) runs
    each arbitrated trace through :func:`~repro_torch.malleability.scenarios
    .run_scenario_vectorized` — bit-for-bit the same records, charged
    through the memoizing transition engine; caches are per trace (each
    job carries its own cost context and contention override).
    ``strategy=`` / ``cost_model=`` are the normalized keyword overrides
    shared with every ``run_scenario_*`` executor
    (:func:`~repro_torch.malleability.scenarios.resolve_engine`), applied to
    each arbitrated job's engine; ``throughput=`` accrues each job's
    modeled compute segments into its records' ``time_to_result_s``.
    """
    outcome = arbitrate_jobs(jobs, pool_nodes, contention=contention)
    runner = run_scenario_vectorized if vectorized else run_scenario_sim
    records = {
        name: runner(sc, strategy=strategy, cost_model=cost_model,
                     throughput=throughput)
        for name, sc in outcome.scenarios.items()
    }
    return records, outcome


# =================================================== Monte-Carlo sweeps ==
@dataclass(frozen=True)
class MonteCarloSweep:
    """Per-replica cost distributions of a seeded policy sweep."""

    policy: str
    n_replicas: int
    makespans: Tuple[float, ...]   # per replica: sum of est_wall_s
    downtimes: Tuple[float, ...]   # per replica: sum of downtime_s
    reconfigs: int                 # records charged across all replicas
    cache_hits: int
    cache_misses: int

    def summary(self) -> dict:
        """Distribution summary (mean/min/max) as a flat dict row."""
        def _stats(xs: Tuple[float, ...], tag: str) -> dict:
            return {
                f"{tag}_mean_s": sum(xs) / len(xs) if xs else 0.0,
                f"{tag}_min_s": min(xs, default=0.0),
                f"{tag}_max_s": max(xs, default=0.0),
            }

        row = {"policy": self.policy, "replicas": self.n_replicas,
               "reconfigs": self.reconfigs}
        row.update(_stats(self.makespans, "makespan"))
        row.update(_stats(self.downtimes, "downtime"))
        return row


def monte_carlo_sweep(
    policy, n_replicas: int, *args,
    cluster: Optional[ClusterState] = None, seed: int = 0,
) -> MonteCarloSweep:
    """Seeded Monte-Carlo sweep of a policy's cost distribution.

    Runs ``n_replicas`` replicas of ``policy`` — seeds ``seed ..
    seed + n - 1`` via ``dataclasses.replace(policy, seed=s)``, so the
    policy must carry a ``seed`` field (e.g. :class:`ChurnPolicy`) —
    against ``cluster`` (default: the 8-node single-malleable-job pool
    the registered churn trace uses).  Every replica's trace runs
    through :func:`~repro_torch.malleability.scenarios.run_scenario_vectorized`
    with ONE shared :class:`~repro_torch.malleability.scenarios
    .TransitionCache`: the replicas differ only in their event
    sequences, never in cost context, so transitions seen by any
    replica price the rest for free.  This is what makes 1000-replica
    sweeps over 10k-node pods finish in seconds.

    ``cluster`` and ``seed`` are keyword-only (the normalized executor
    signature); a positional third argument is still accepted as
    ``cluster`` for one release, with a :class:`DeprecationWarning`.
    """
    if args:
        if len(args) > 1 or cluster is not None:
            raise TypeError(
                "monte_carlo_sweep takes at most one positional cluster "
                "(deprecated); pass cluster= and seed= by keyword")
        warnings.warn(
            "passing cluster positionally to monte_carlo_sweep is "
            "deprecated; use monte_carlo_sweep(policy, n, cluster=...)",
            DeprecationWarning, stacklevel=2)
        cluster = args[0]
    if cluster is None:
        cluster = ClusterState(
            total_nodes=8,
            jobs=(JobSpec("train", min_nodes=1, max_nodes=8),),
        )
    job = cluster.primary_malleable().name
    cache = TransitionCache()
    makespans: List[float] = []
    downtimes: List[float] = []
    reconfigs = 0
    for s in range(seed, seed + n_replicas):
        trace = replace(policy, seed=s).generate(cluster)
        sc = trace.scenario(job, name=f"{policy.name}-mc-{s}")
        recs = run_scenario_vectorized(sc, cache=cache)
        reconfigs += len(recs)
        makespans.append(sum(r.est_wall_s for r in recs))
        downtimes.append(sum(r.downtime_s for r in recs))
    return MonteCarloSweep(
        policy=policy.name, n_replicas=n_replicas,
        makespans=tuple(makespans), downtimes=tuple(downtimes),
        reconfigs=reconfigs, cache_hits=cache.hits,
        cache_misses=cache.misses,
    )


# ================================================= registered policy traces ==
def backfill_pressure(name: str = "backfill-pressure") -> Scenario:
    """8-node pool: the malleable job soaks up idle nodes, two rigid
    arrivals reclaim them in waves, and the grant returns as they drain
    (2 -> 8 -> 4 -> 2 -> 6 -> 8)."""
    cluster = ClusterState(
        total_nodes=8,
        jobs=(JobSpec("train", min_nodes=2, max_nodes=8),),
    )
    policy = BackfillPolicy(
        arrivals=(RigidArrival(step=8, nodes=4, duration=8),
                  RigidArrival(step=12, nodes=2, duration=8)),
        horizon=26,
    )
    return policy.generate(cluster).scenario(
        "train", name=name,
        description="backfill grants + reclamation under rigid queue pressure",
    )


def priority_preempt(name: str = "priority-preempt") -> Scenario:
    """Two priority arrivals preempt the malleable job; the second lands
    on the same step as its regrow, so the forced shrink queues behind
    the in-flight reconfiguration (a QUEUE span on its timeline)."""
    cluster = ClusterState(
        total_nodes=8,
        jobs=(JobSpec("train", min_nodes=1, max_nodes=6, priority=0,
                      initial_nodes=2),),
    )
    policy = PreemptionPolicy(
        arrivals=(PriorityArrival(step=6, nodes=4, duration=6),
                  PriorityArrival(step=12, nodes=6, duration=6)),
        horizon=22,
    )
    return policy.generate(cluster).scenario(
        "train", name=name,
        description="priority preemption, incl. one mid-reconfiguration",
    )


def churn_trace(name: str = "churn-200", decisions: int = 200,
                seed: int = 7) -> Scenario:
    """Long-horizon seeded churn: 200 RESIZE decisions on an 8-node pool."""
    cluster = ClusterState(
        total_nodes=8,
        jobs=(JobSpec("train", min_nodes=1, max_nodes=8),),
    )
    policy = ChurnPolicy(decisions=decisions, seed=seed)
    return policy.generate(cluster).scenario(
        "train", name=name,
        description=f"{decisions} seeded grow/shrink churn decisions "
                    f"(seed={seed})",
    )


def two_job_interference(name: str = "two-job-interference") -> Scenario:
    """Two identical breathing jobs arbitrated on one 8-node pool.

    Job B's grows collide with job A's peak: they defer until A shrinks,
    then emit queued behind A's same-step reconfiguration — the
    registered scenario is B's arbitrated trace, carrying both a QUEUE
    span and the degraded-overlap contention override.
    """
    a = steady_cycle(name="ij-a", low=2, high=6, cycles=2, period=4)
    b = steady_cycle(name="ij-b", low=2, high=6, cycles=2, period=4)
    outcome = arbitrate_jobs([("a", a), ("b", b)], pool_nodes=8)
    sc = outcome.job("b").scenario
    return replace(
        sc, name=name,
        description="job B of a two-job pool: grows deferred + queued "
                    "behind job A, overlap degraded by contention",
    )


POLICY_SCENARIO_NAMES = (
    "backfill-pressure",
    "priority-preempt",
    "churn-200",
    "two-job-interference",
)

for _sc in (backfill_pressure(), priority_preempt(), churn_trace(),
            two_job_interference()):
    register_scenario(_sc)


def registered_policy_scenarios() -> tuple[Scenario, ...]:
    """The policy-generated traces in the scenario registry."""
    from .scenarios import get_scenario

    return tuple(get_scenario(n) for n in POLICY_SCENARIO_NAMES)


# ================================================ registered serve traces ==
# Nominal in-flight KV footprint for the registered traces' default
# engines (check_matrix, the nightly sweep, the trainer replay): a fixed
# pytree size so every resize charges stage-3 bytes deterministically.
# The serving loop (repro_torch.serving.run_serve) swaps in the LIVE
# KVPageTable-backed bytes model instead, pricing the actual resident
# pages at each resize.
_SERVE_KV_BYTES = 48 << 20

# The three traffic traces, single-sourced: the TrafficPolicy sizes the
# pool from them AND repro_torch.serving replays them as request arrivals, so
# policy decisions and serving-side queueing always see the same load.
SERVE_TRAFFIC: Dict[str, TrafficPolicy] = {
    # Diurnal breathing: overnight trickle -> morning ramp -> midday
    # peak -> evening decay.  2 -> 4 -> 8 -> 4 -> 2 workers.
    "serve-diurnal": TrafficPolicy(
        rates=(1.0,) * 6 + (2.0,) * 6 + (4.0,) * 8 + (2.0,) * 6 + (1.0,) * 6),
    # Flash crowd: an 8x spike out of nowhere.  One burst grow 2 -> 8
    # (the parallel-spawn story), held past the spike while the backlog
    # drains, then released.  Runs on a 2-rack pool, so the burst opens
    # rack 1 and KV migration pays cross-rack bytes.
    "serve-flashcrowd": TrafficPolicy(
        rates=(1.0,) * 5 + (8.0,) * 6 + (1.0,) * 10),
    # Tail-latency SLO breach: a slow climb that crosses the SLO line
    # twice (staged grows, each waiting grant_delay_s on the RMS
    # arbiter — a QUEUE span on the timeline), then a deep off-peak
    # shrink.  Longer cooldown: SLO pools shed capacity reluctantly.
    "serve-slo": TrafficPolicy(
        rates=(1.0,) * 4 + (1.5,) * 5 + (3.5,) * 6 + (0.5,) * 6,
        grant_delay_s=0.5, cooldown=3),
}


def _serve_cluster(topology: Optional[Topology] = None) -> ClusterState:
    """The 8-node pool every serve trace autoscales over.

    ``min_nodes=2``: the service starts as one two-node world, and a
    shrink below 2 would have to SPLIT that world — the victim node
    would be zombified (§4.7: pinned, not returned) and the engine's
    rank count would diverge from the page table's worker count.  The
    floor keeps every serve shrink on the clean whole-world TS path.
    """
    return ClusterState(
        total_nodes=8,
        jobs=(JobSpec("serve", min_nodes=2, max_nodes=8, initial_nodes=2,
                      param_bytes=_SERVE_KV_BYTES),),
        topology=topology,
    )


def serve_diurnal(name: str = "serve-diurnal") -> Scenario:
    """Diurnal decode-pool breathing: 2 -> 4 -> 8 -> 4 -> 2 workers."""
    trace = SERVE_TRAFFIC["serve-diurnal"].generate(_serve_cluster())
    return trace.scenario(
        "serve", name=name,
        description="decode pool breathing with diurnal request traffic "
                    "(2 -> 4 -> 8 -> 4 -> 2 workers)",
    )


def serve_flashcrowd(name: str = "serve-flashcrowd") -> Scenario:
    """Flash crowd on a 2-rack pool: burst grow 2 -> 8, backlog-drain
    hold, then release — KV migration priced per distance class."""
    trace = SERVE_TRAFFIC["serve-flashcrowd"].generate(
        _serve_cluster(topology=Topology(rack_sizes=(4, 4))))
    return trace.scenario(
        "serve", name=name,
        description="8x flash crowd on a 2-rack decode pool: burst grow "
                    "opens rack 1, KV pages pay cross-rack bandwidth",
        redist_bw_local=25.0e9,
        redist_bw_cross=2.5e9,
        redist_bw_intra_rack=10.0e9,
    )


def serve_slo(name: str = "serve-slo") -> Scenario:
    """Tail-latency SLO climb: two staged grows (each queued behind the
    RMS arbiter's grant delay), then a deep off-peak shrink."""
    trace = SERVE_TRAFFIC["serve-slo"].generate(_serve_cluster())
    return trace.scenario(
        "serve", name=name,
        description="SLO-breach climb 2 -> 4 -> 8 with queued grants, "
                    "then a deep off-peak shrink",
    )


SERVE_SCENARIO_NAMES = (
    "serve-diurnal",
    "serve-flashcrowd",
    "serve-slo",
)

for _sc in (serve_diurnal(), serve_flashcrowd(), serve_slo()):
    register_scenario(_sc)


def registered_serve_scenarios() -> tuple[Scenario, ...]:
    """The traffic-policy serve traces in the scenario registry."""
    from .scenarios import get_scenario

    return tuple(get_scenario(n) for n in SERVE_SCENARIO_NAMES)
