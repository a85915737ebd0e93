"""Closed-loop scheduler optimizer: policies that *choose*, at SLURM scale.

The policy layer (:mod:`.policies`) emits traces; nothing in the repo
optimized over them (ROADMAP item 1).  This module closes the loop, in
the shape of Chadha et al.'s dynamic-resource-aware SLURM scheduler and
Iserte et al.'s DMR resource optimization:

* :class:`WorkloadTrace` / :func:`generate_workload` — seeded SLURM-like
  workloads: tens of mixed rigid/malleable jobs and hundreds of
  arrival/resize events on one shared pool.  Two generated workloads are
  registered as ordinary scenarios (``slurm-mix``, ``slurm-burst``), so
  the whole sim/live/vectorized parity machinery replays them unchanged;
* :class:`SchedulerKnobs` — the policy knobs a dynamic RMS tunes:
  backfill hysteresis, the preemption-priority cutoff, and the
  placement grant quantum;
* :func:`evaluate_schedule` — runs the closed scheduling loop for one
  knob setting, arbitrates the resulting per-job traces on the shared
  pool (:func:`~.policies.run_multijob_sim` — the N-job path), charges
  them through the vectorized fast path, and scores the
  :class:`ScheduleObjective` (weighted reconfiguration makespan + mean
  queue time + idle-capacity penalty, all in seconds);
* :func:`rigid_baseline` — the rigid-cluster control: every malleable
  job must request its peak (``max_nodes``) up front and hold it for
  the whole horizon, so rigid arrivals queue behind over-provisioned
  grants.  Zero reconfiguration cost, terrible queue time — the
  trade the paper's malleability case argues against;
* :func:`optimize_schedule` — the seeded search loop: a deterministic
  grid over the knob space plus seeded random restarts, every candidate
  evaluated through the vectorized chargers, first-best kept (same seed
  -> same chosen knobs -> same score, pinned by ``tests/test_api.py``).
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

from .scenarios import Scenario, ScenarioEvent, register_scenario
from .throughput import ThroughputModel, time_to_result
from .policies import (
    ClusterState,
    JobSpec,
    MultiJobOutcome,
    RigidArrival,
    _resize,
    run_multijob_sim,
)


# ============================================================== workloads ==
@dataclass(frozen=True)
class WorkloadTrace:
    """A SLURM-like workload: one pool, many jobs, a step horizon.

    ``step_s`` converts application steps to seconds (queue waits and
    the idle-capacity penalty are charged in seconds, so they compose
    with the engine's charged reconfiguration walls).  The trace is
    pure data — scheduling decisions live in :class:`SchedulerKnobs`.
    """

    name: str
    pool_nodes: int
    malleable: Tuple[JobSpec, ...]
    arrivals: Tuple[RigidArrival, ...]
    horizon: int
    step_s: float = 1.0
    start_step: int = 2

    def __post_init__(self) -> None:
        if not self.malleable:
            raise ValueError(f"workload {self.name!r} needs a malleable job")
        floors = sum(j.min_nodes for j in self.malleable)
        if floors > self.pool_nodes:
            raise ValueError(
                f"workload {self.name!r}: malleable floors ({floors}) "
                f"exceed the pool ({self.pool_nodes})")

    def horizon_s(self) -> float:
        return self.horizon * self.step_s

    def cluster(self) -> ClusterState:
        """The RMS ledger view of this workload's pool."""
        return ClusterState(total_nodes=self.pool_nodes,
                            jobs=self.malleable)


def generate_workload(
    name: str,
    *,
    pool_nodes: int = 32,
    n_malleable: int = 6,
    n_rigid: int = 24,
    horizon: int = 96,
    seed: int = 0,
    step_s: float = 1.0,
    burstiness: float = 0.0,
) -> WorkloadTrace:
    """Seeded SLURM-like workload generator (pure function of ``seed``).

    Malleable jobs draw floors/ceilings and priorities from the seeded
    stream; rigid arrivals draw size, duration, priority, and arrival
    step — uniformly over the horizon, or clumped into bursts as
    ``burstiness`` rises toward 1 (flash-crowd pressure).  Identical
    seeds yield identical workloads, which is what lets the registered
    workload scenarios and the bench rows be pinned in CI.
    """
    if not 0.0 <= burstiness <= 1.0:
        raise ValueError("burstiness must be in [0, 1]")
    rng = random.Random(seed)
    jobs: List[JobSpec] = []
    budget = pool_nodes
    for i in range(n_malleable):
        lo = rng.randint(1, 2)
        hi = min(pool_nodes, lo + rng.randint(2, max(3, pool_nodes // 3)))
        budget -= lo
        if budget < (n_malleable - i - 1):
            lo, hi = 1, max(2, hi // 2)  # keep floors feasible on the pool
        jobs.append(JobSpec(
            name=f"mall-{i}", min_nodes=lo, max_nodes=hi,
            priority=rng.randint(0, 40), malleable=True,
        ))
    window = max(1, horizon - 8)
    n_bursts = max(1, n_rigid // 6)
    burst_steps = sorted(rng.randint(2, window) for _ in range(n_bursts))
    arrivals: List[RigidArrival] = []
    for _ in range(n_rigid):
        if rng.random() < burstiness:
            step = min(window, rng.choice(burst_steps) + rng.randint(0, 2))
        else:
            step = rng.randint(2, window)
        arrivals.append(RigidArrival(
            step=step,
            nodes=rng.randint(1, max(2, pool_nodes // 5)),
            duration=rng.randint(3, max(4, horizon // 12)),
            priority=rng.randint(0, 100),
        ))
    arrivals.sort(key=lambda a: (a.step, -a.priority, a.nodes))
    return WorkloadTrace(
        name=name, pool_nodes=pool_nodes, malleable=tuple(jobs),
        arrivals=tuple(arrivals), horizon=horizon, step_s=step_s,
    )


# ================================================================== knobs ==
@dataclass(frozen=True)
class SchedulerKnobs:
    """The policy knobs the closed loop searches over.

    * ``backfill_threshold`` — grow hysteresis: an opportunistic grow is
      only emitted when it gains at least this many nodes (higher ->
      fewer, larger reconfigurations: less makespan, more idle);
    * ``preempt_priority`` — arrivals at or above this priority may
      force-shrink malleable jobs to start immediately (lower -> less
      queueing, more forced shrinks);
    * ``placement_quantum`` — grants move in multiples of this many
      nodes (the placement-weight coarsening: whole-chassis grants cut
      churn at some utilization cost).
    """

    backfill_threshold: int = 1
    preempt_priority: int = 80
    placement_quantum: int = 1

    def __post_init__(self) -> None:
        if self.backfill_threshold < 1 or self.placement_quantum < 1:
            raise ValueError("thresholds and quanta must be >= 1")


#: The deterministic grid :func:`optimize_schedule` always covers.
KNOB_GRID: Tuple[SchedulerKnobs, ...] = tuple(
    SchedulerKnobs(backfill_threshold=t, preempt_priority=p,
                   placement_quantum=q)
    for t in (1, 2, 4)
    for p in (50, 80, 1000)     # 1000: preemption effectively off
    for q in (1, 2, 4)
)


# ============================================================ the schedule ==
@dataclass(frozen=True)
class ScheduleObjective:
    """Weighted scheduling objective, every term in seconds (lower wins).

    ``makespan_s`` is the summed charged reconfiguration wall across all
    malleable jobs (QUEUE spans included), ``mean_queue_s`` the mean
    rigid-arrival wait, and the idle term prices unallocated capacity
    over the horizon.

    When :func:`evaluate_schedule` is given a ``throughput=`` model, the
    makespan term it scores is the modeled **time-to-result** instead —
    reconfiguration walls *plus* modeled compute for every horizon step
    under the allocation in force — so ``w_makespan`` starts pricing
    what an allocation earns, not just what resizing costs.  With the
    model disabled (the default) the scored number is the same summed
    ``est_wall_s`` as before, bit for bit.
    """

    w_makespan: float = 1.0
    w_queue: float = 1.0
    w_idle: float = 0.25

    def score(self, *, makespan_s: float, mean_queue_s: float,
              utilization: float, horizon_s: float) -> float:
        return (self.w_makespan * makespan_s
                + self.w_queue * mean_queue_s
                + self.w_idle * (1.0 - utilization) * horizon_s)


@dataclass(frozen=True)
class ScheduleOutcome:
    """One evaluated candidate: knobs -> charged schedule -> score."""

    workload: str
    knobs: Optional[SchedulerKnobs]     # None for the rigid baseline
    strategy: str
    score: float
    makespan_s: float                   # summed reconfiguration est_wall
    downtime_s: float                   # summed reconfiguration downtime
    expand_downtime_s: float            # the expansions' share of it
    mean_queue_s: float                 # mean rigid-arrival wait
    utilization: float                  # mean allocated fraction of the pool
    reconfigs: int                      # charged records across all jobs
    time_to_result_s: float = 0.0       # modeled; == makespan_s, no model
    scenarios: Dict[str, Scenario] = field(default_factory=dict)
    multijob: Optional[MultiJobOutcome] = None


def _walk_schedule(
    trace: WorkloadTrace, knobs: Optional[SchedulerKnobs]
) -> tuple[Dict[str, List[ScenarioEvent]], List[int], float, Dict[str, int]]:
    """The closed scheduling loop: one deterministic step walk.

    Returns ``(events per malleable job, rigid wait steps, utilization,
    initial allocations)``.  ``knobs=None`` runs the rigid-cluster
    control: malleable jobs are pinned at their peak request
    (``max_nodes``, greedily clamped to the pool) and never resize, and
    arrivals only start when capacity is free — no backfill, no
    preemption.
    """
    jobs = trace.malleable
    allocs: Dict[str, int] = {}
    if knobs is None:
        remaining = trace.pool_nodes
        for j in jobs:
            grant = max(j.min_nodes, min(
                j.max_nodes, remaining - sum(
                    k.min_nodes for k in jobs if k.name not in allocs
                    and k.name != j.name)))
            allocs[j.name] = grant
            remaining -= grant
    else:
        allocs = {j.name: j.start_nodes() for j in jobs}
    events: Dict[str, List[ScenarioEvent]] = {j.name: [] for j in jobs}
    by_prio = sorted(jobs, key=lambda j: (-j.priority, j.name))
    reclaim_order = sorted(jobs, key=lambda j: (j.priority, j.name))

    running: List[List[int]] = []            # [end_step, nodes]
    queue: List[RigidArrival] = []
    waits: List[int] = []
    used_steps = 0.0

    def free() -> int:
        return (trace.pool_nodes - sum(r[1] for r in running)
                - sum(allocs.values()))

    def reclaim(step: int, need: int, quantum: int) -> int:
        """Force-shrink malleables toward their floors; returns freed."""
        freed = 0
        for j in reclaim_order:
            if freed >= need:
                break
            surplus = allocs[j.name] - j.min_nodes
            take = min(surplus, need - freed)
            take -= take % quantum if take < surplus else 0
            if take <= 0:
                continue
            events[j.name].append(
                _resize(step, allocs[j.name], allocs[j.name] - take))
            allocs[j.name] -= take
            freed += take
        return freed

    for step in range(trace.start_step, trace.horizon):
        running = [r for r in running if r[0] > step]
        queue.extend(a for a in trace.arrivals if a.step == step)
        still_waiting: List[RigidArrival] = []
        for a in queue:                      # FIFO admission
            if a.nodes <= free():
                running.append([step + a.duration, a.nodes])
                waits.append(step - a.step)
                continue
            if knobs is not None and a.priority >= knobs.preempt_priority:
                deficit = a.nodes - free()
                reclaim(step, deficit, 1)
                if a.nodes <= free():
                    running.append([step + a.duration, a.nodes])
                    waits.append(step - a.step)
                    continue
            still_waiting.append(a)
        queue = still_waiting
        if knobs is not None:
            if queue:
                # Queue pressure: shed toward floors so the FIFO head
                # fits as soon as rigid capacity drains.
                reclaim(step, queue[0].nodes - free(),
                        knobs.placement_quantum)
            else:
                # Backfill: idle nodes flow to malleable jobs, highest
                # priority first, in placement-quantum multiples, only
                # past the hysteresis threshold.
                for j in by_prio:
                    idle = free()
                    if idle <= 0:
                        break
                    gain = min(j.max_nodes - allocs[j.name], idle)
                    gain -= gain % knobs.placement_quantum
                    if gain >= knobs.backfill_threshold:
                        events[j.name].append(
                            _resize(step, allocs[j.name],
                                    allocs[j.name] + gain))
                        allocs[j.name] += gain
        used_steps += sum(r[1] for r in running) + sum(allocs.values())
    waits.extend(trace.horizon - a.step for a in queue)  # never admitted
    span = max(1, trace.horizon - trace.start_step)
    utilization = used_steps / (trace.pool_nodes * span)
    initial = ({j.name: j.start_nodes() for j in jobs} if knobs is not None
               else allocs)
    return events, waits, utilization, initial


def _job_scenarios(trace: WorkloadTrace,
                   events: Dict[str, List[ScenarioEvent]],
                   initial: Dict[str, int],
                   tag: str) -> List[Tuple[str, Scenario]]:
    out = []
    for j in trace.malleable:
        out.append((j.name, Scenario(
            name=f"{trace.name}:{tag}:{j.name}",
            description=(f"malleable job {j.name!r} of workload "
                         f"{trace.name!r} ({tag} schedule)"),
            initial_nodes=initial[j.name],
            events=tuple(events[j.name]),
            steps=trace.horizon + 2,
        )))
    return out


def evaluate_schedule(
    trace: WorkloadTrace,
    knobs: Optional[SchedulerKnobs],
    *,
    strategy=None,
    cost_model=None,
    objective: ScheduleObjective = ScheduleObjective(),
    contention: float = 1.25,
    keep_scenarios: bool = False,
    throughput: Optional[ThroughputModel] = None,
) -> ScheduleOutcome:
    """Run the closed loop for one knob setting and score it.

    The walk's per-job traces are arbitrated on the shared pool
    (:func:`~.policies.run_multijob_sim` — cross-job QUEUE spans and
    contention degradation included) and charged through the vectorized
    fast path; ``strategy=`` / ``cost_model=`` are the normalized
    executor overrides.  ``knobs=None`` scores the rigid-cluster
    control (see :func:`rigid_baseline`).  ``throughput=`` switches the
    objective's makespan term to modeled time-to-result (each job's
    reconfiguration walls plus per-step modeled compute over the whole
    horizon — see :func:`~.throughput.time_to_result`); ``None`` keeps
    the old ``est_wall_s`` sum bit for bit.
    """
    from repro_torch.core import strategy_key

    events, waits, utilization, initial = _walk_schedule(trace, knobs)
    tag = "rigid" if knobs is None else "dyn"
    jobs = _job_scenarios(trace, events, initial, tag)
    records, outcome = run_multijob_sim(
        jobs, trace.pool_nodes, contention=contention,
        strategy=strategy, cost_model=cost_model, throughput=throughput)
    makespan = sum(r.est_wall_s for recs in records.values() for r in recs)
    downtime = sum(r.downtime_s for recs in records.values() for r in recs)
    expand_down = sum(r.downtime_s for recs in records.values()
                      for r in recs if r.kind == "expand")
    reconfigs = sum(len(recs) for recs in records.values())
    mean_queue = (sum(waits) / len(waits) if waits else 0.0) * trace.step_s
    if throughput is None:
        ttr = makespan
    else:
        ttr = sum(
            time_to_result(records[name], outcome.scenarios[name], throughput)
            for name in records)
    score = objective.score(
        makespan_s=ttr, mean_queue_s=mean_queue,
        utilization=utilization, horizon_s=trace.horizon_s())
    strat = (strategy_key(strategy) if strategy is not None
             else jobs[0][1].default_engine().strategy)
    return ScheduleOutcome(
        workload=trace.name, knobs=knobs,
        strategy=strategy_key(strat),
        score=score, makespan_s=makespan, downtime_s=downtime,
        expand_downtime_s=expand_down, mean_queue_s=mean_queue,
        utilization=utilization, reconfigs=reconfigs,
        time_to_result_s=ttr,
        scenarios=(dict(outcome.scenarios) if keep_scenarios else {}),
        multijob=(outcome if keep_scenarios else None),
    )


def rigid_baseline(
    trace: WorkloadTrace,
    *,
    strategy=None,
    cost_model=None,
    objective: ScheduleObjective = ScheduleObjective(),
    throughput: Optional[ThroughputModel] = None,
) -> ScheduleOutcome:
    """Score the rigid-cluster control for a workload.

    Malleable jobs must request their peak (``max_nodes``) up front —
    a rigid cluster cannot grow a running job — and hold it for the
    whole horizon; rigid arrivals wait for free capacity with no
    backfill or preemption.  Reconfiguration cost is zero by
    construction; the queue and idle terms are what the closed loop is
    optimized against.  With ``throughput=``, the peak-pinned
    allocations still accrue modeled compute — the rigid control is
    fast per step but starves the queue.
    """
    return evaluate_schedule(trace, None, strategy=strategy,
                             cost_model=cost_model, objective=objective,
                             throughput=throughput)


# ================================================================= search ==
@dataclass(frozen=True)
class OptimizerResult:
    """The search's verdict for one workload x strategy."""

    workload: str
    strategy: str
    best: ScheduleOutcome
    baseline: ScheduleOutcome
    evaluated: int
    scores: Tuple[float, ...]          # every candidate, evaluation order

    @property
    def beats_baseline(self) -> bool:
        return self.best.score < self.baseline.score


def optimize_schedule(
    trace: WorkloadTrace,
    *,
    strategy=None,
    cost_model=None,
    objective: ScheduleObjective = ScheduleObjective(),
    grid: Sequence[SchedulerKnobs] = KNOB_GRID,
    n_random: int = 8,
    seed: int = 0,
    throughput: Optional[ThroughputModel] = None,
) -> OptimizerResult:
    """Grid + seeded random restarts over the knob space (deterministic).

    Every candidate is evaluated through :func:`evaluate_schedule`
    (arbitrated N-job traces, vectorized charging); the first-seen best
    score wins, so identical seeds choose identical knobs and scores.
    ``throughput=`` makes every candidate (and the rigid control) score
    modeled time-to-result instead of reconfiguration makespan — the
    search then optimizes the number the paper's malleability case
    rests on.
    """
    rng = random.Random(seed)
    candidates = list(grid)
    for _ in range(n_random):
        candidates.append(SchedulerKnobs(
            backfill_threshold=rng.randint(1, 6),
            preempt_priority=rng.choice((30, 50, 65, 80, 95, 1000)),
            placement_quantum=rng.choice((1, 2, 3, 4)),
        ))
    best: Optional[ScheduleOutcome] = None
    scores: List[float] = []
    for knobs in candidates:
        out = evaluate_schedule(
            trace, knobs, strategy=strategy, cost_model=cost_model,
            objective=objective, throughput=throughput)
        scores.append(out.score)
        if best is None or out.score < best.score:
            best = out
    assert best is not None
    baseline = rigid_baseline(trace, strategy=strategy,
                              cost_model=cost_model, objective=objective,
                              throughput=throughput)
    return OptimizerResult(
        workload=trace.name, strategy=best.strategy, best=best,
        baseline=baseline, evaluated=len(candidates),
        scores=tuple(scores),
    )


# ================================================= registered workloads ==
#: The generated workloads the bench gate and check_matrix replay.
WORKLOAD_TRACES: Dict[str, WorkloadTrace] = {
    # Steady mixed pressure: 8 malleable jobs breathing around 64 rigid
    # arrivals spread over the horizon (~100 resize decisions under the
    # default knobs — the SLURM-scale trace).
    "slurm-mix": generate_workload(
        "slurm-mix", pool_nodes=32, n_malleable=8, n_rigid=64,
        horizon=160, seed=11),
    # Flash-crowd pressure: arrivals clump into bursts, so admission
    # leans on preemptive reclamation.
    "slurm-burst": generate_workload(
        "slurm-burst", pool_nodes=16, n_malleable=5, n_rigid=40,
        horizon=96, seed=23, burstiness=0.8),
}

WORKLOAD_SCENARIO_NAMES = tuple(WORKLOAD_TRACES)


def _register_workload_scenarios() -> None:
    """Register each workload's busiest arbitrated job trace.

    The default-knob schedule is walked once at import (same pattern as
    the policy traces); the malleable job with the most resize events
    becomes the registered scenario, so check_matrix and the nightly
    sim == live sweep replay SLURM-scale traces under every strategy.
    """
    for name, trace in WORKLOAD_TRACES.items():
        out = evaluate_schedule(trace, SchedulerKnobs(),
                                keep_scenarios=True)
        busiest = max(out.scenarios.values(), key=lambda s: len(s.events))
        register_scenario(replace(
            busiest, name=name,
            description=(f"busiest malleable job of the {name!r} "
                         f"workload ({len(trace.malleable)} malleable "
                         f"jobs, {len(trace.arrivals)} rigid arrivals "
                         f"on {trace.pool_nodes} nodes), arbitrated"),
        ))


_register_workload_scenarios()


def registered_workload_scenarios() -> tuple[Scenario, ...]:
    """The workload-derived traces in the scenario registry."""
    from .scenarios import get_scenario

    return tuple(get_scenario(n) for n in WORKLOAD_SCENARIO_NAMES)
