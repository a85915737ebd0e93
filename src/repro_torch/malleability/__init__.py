"""Malleability runtime: event-driven reconfiguration simulation.

Executes :class:`repro_torch.core.SpawnPlan` / :class:`repro_torch.core.ShrinkPlan`
objects against a calibrated MPI cost model to estimate reconfiguration
wall time, reproducing the paper's §5 experiments on this CPU-only host.

Three submodules:

* :mod:`.cost_model` — :class:`CostModel` latency/bandwidth constants
  (profiles :data:`MN5` / :data:`NASP`), the partial-overlap knobs
  (per-stage overlap fractions + contention factor), and the analytic
  stage-3 bytes models (:func:`replicated_bytes_model` /
  :func:`fsdp_bytes_model`);
* :mod:`.simulator` — report-shaped views (:class:`ExpansionReport` /
  :class:`ShrinkReport`) over the engine's charged timelines;
* :mod:`.scenarios` — declarative workload traces (:class:`Scenario`),
  their registry, and the sim/live executors that agree exactly on
  every timeline-derived number, bytes included;
* :mod:`.policies` — the RMS policy engine (backfill / preemption /
  churn + the multi-job arbiter) whose generated traces land in the
  same registry (re-exported by :mod:`repro_torch.elastic.rms`);
* :mod:`.optimizer` — the closed scheduling loop: SLURM-scale
  :class:`WorkloadTrace` generation, the weighted
  :class:`ScheduleObjective`, and the seeded knob search
  (:func:`optimize_schedule`) against the rigid-cluster baseline;
* :mod:`.throughput` — the per-allocation step-time model
  (:class:`ThroughputModel`: roofline compute/memory/collective terms,
  width-weighted batch shares on uneven pools, calibrated contention)
  the executors accrue into ``time_to_result_s`` and the optimizer
  scores instead of reconfiguration makespan.

See ``docs/cost-model.md`` and ``docs/scenarios.md`` for guides.
"""
from .cost_model import (
    MN5,
    NASP,
    CostModel,
    fsdp_bytes_model,
    replicated_bytes_model,
    replicated_link_model,
)
from .optimizer import (
    KNOB_GRID,
    WORKLOAD_SCENARIO_NAMES,
    WORKLOAD_TRACES,
    OptimizerResult,
    ScheduleObjective,
    ScheduleOutcome,
    SchedulerKnobs,
    WorkloadTrace,
    evaluate_schedule,
    generate_workload,
    optimize_schedule,
    registered_workload_scenarios,
    rigid_baseline,
)
from .policies import (
    SERVE_SCENARIO_NAMES,
    SERVE_TRAFFIC,
    ArbitratedJob,
    BackfillPolicy,
    CheckpointIntervalPolicy,
    ChurnPolicy,
    JobSpec,
    MonteCarloSweep,
    MultiJobOutcome,
    PolicyTrace,
    PreemptionPolicy,
    PriorityArrival,
    RigidArrival,
    RmsPolicy,
    TrafficPolicy,
    arbitrate_jobs,
    backfill_pressure,
    charge_in_flight_queueing,
    churn_trace,
    monte_carlo_sweep,
    priority_preempt,
    registered_policy_scenarios,
    registered_serve_scenarios,
    run_multijob_sim,
    serve_diurnal,
    serve_flashcrowd,
    serve_slo,
    two_job_interference,
)
from .scenarios import (
    FAULT_SCENARIO_NAMES,
    RuntimeAdapter,
    Scenario,
    ScenarioEvent,
    ScenarioRecord,
    TransitionCache,
    burst_arrival,
    ckpt_cycle,
    dispatch_event,
    get_scenario,
    heterogeneous_pool,
    node_fail_wave,
    node_failures,
    param_bytes_for_arch,
    record_parity_key,
    register_scenario,
    registered_fault_scenarios,
    registered_scenarios,
    resolve_engine,
    restart_vs_shrink,
    run_scenario_live,
    run_scenario_sim,
    run_scenario_vectorized,
    scenario_pool,
    steady_cycle,
    straggler_churn,
    topology_nasp,
    topology_pods,
    topology_redist,
)
from .simulator import (
    ExpansionReport,
    ShrinkReport,
    simulate_expansion,
    simulate_redistribution,
    simulate_shrink,
)
from .throughput import (
    ThroughputModel,
    batch_shares,
    flops_per_token_for_arch,
    time_to_result,
)

__all__ = [
    "FAULT_SCENARIO_NAMES",
    "KNOB_GRID",
    "MN5",
    "NASP",
    "SERVE_SCENARIO_NAMES",
    "SERVE_TRAFFIC",
    "WORKLOAD_SCENARIO_NAMES",
    "WORKLOAD_TRACES",
    "ArbitratedJob",
    "BackfillPolicy",
    "CheckpointIntervalPolicy",
    "ChurnPolicy",
    "CostModel",
    "ExpansionReport",
    "JobSpec",
    "MonteCarloSweep",
    "MultiJobOutcome",
    "OptimizerResult",
    "PolicyTrace",
    "PreemptionPolicy",
    "PriorityArrival",
    "RigidArrival",
    "RmsPolicy",
    "RuntimeAdapter",
    "Scenario",
    "ScenarioEvent",
    "ScenarioRecord",
    "ScheduleObjective",
    "ScheduleOutcome",
    "SchedulerKnobs",
    "ShrinkReport",
    "ThroughputModel",
    "TrafficPolicy",
    "TransitionCache",
    "WorkloadTrace",
    "arbitrate_jobs",
    "backfill_pressure",
    "batch_shares",
    "burst_arrival",
    "charge_in_flight_queueing",
    "churn_trace",
    "ckpt_cycle",
    "dispatch_event",
    "evaluate_schedule",
    "flops_per_token_for_arch",
    "fsdp_bytes_model",
    "generate_workload",
    "get_scenario",
    "heterogeneous_pool",
    "monte_carlo_sweep",
    "node_fail_wave",
    "node_failures",
    "optimize_schedule",
    "param_bytes_for_arch",
    "priority_preempt",
    "record_parity_key",
    "register_scenario",
    "registered_fault_scenarios",
    "registered_policy_scenarios",
    "registered_scenarios",
    "registered_serve_scenarios",
    "registered_workload_scenarios",
    "replicated_bytes_model",
    "replicated_link_model",
    "resolve_engine",
    "restart_vs_shrink",
    "rigid_baseline",
    "run_multijob_sim",
    "run_scenario_live",
    "run_scenario_sim",
    "run_scenario_vectorized",
    "scenario_pool",
    "serve_diurnal",
    "serve_flashcrowd",
    "serve_slo",
    "simulate_expansion",
    "simulate_redistribution",
    "simulate_shrink",
    "steady_cycle",
    "straggler_churn",
    "time_to_result",
    "topology_nasp",
    "topology_pods",
    "topology_redist",
    "two_job_interference",
]
