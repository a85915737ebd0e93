"""repro_torch.api — the port's stable import surface.

The same 133 names as :mod:`repro.api` (``API_SNAPSHOT.txt``), each
resolving to the port's counterpart, so user code written against the
JAX package's surface runs on PyTorch by changing the package name:

* the device-free layers (the engine/strategy core, scenarios, policies,
  the scheduler optimizer, the throughput model, the serving plane:
  the port's copies ``repro_torch.core``, ``repro_torch.malleability``,
  ``repro_torch.serving``) import eagerly;
* the layers that hold tensors or reach the kernels (the checkpoint
  store, the elastic runtime, models, data, sharding, training, the
  launch helpers) resolve lazily on first attribute access, as the JAX
  package's JAX-backed names do, so ``import repro_torch.api`` builds no
  kernel and initialises no CUDA context.

Naming note: :class:`ClusterState` here is the RMS-side ledger
(:mod:`repro_torch.malleability.policies`), as in :mod:`repro.api`; the
engine-internal world ledger of the same name stays at
:class:`repro_torch.core.ClusterState`.
"""
from __future__ import annotations

from importlib import import_module

# ---- engine / strategy core (device-free) ----------------------------------
from repro_torch.core import (
    DISTANCE_CLASSES,
    DMR_KEY,
    TOPO_KEY,
    CheckpointSpec,
    Method,
    ReconfigEngine,
    ReconfigOutcome,
    ReconfigPlan,
    ShrinkKind,
    SpawnPlan,
    Stage,
    Strategy,
    StrategySpec,
    Timeline,
    TimelineEvent,
    Topology,
    checkpoint_timeline,
    get_strategy,
    plan_diffusive,
    plan_dmr,
    plan_hypercube,
    plan_sequential,
    plan_topo,
    register_strategy,
    registered_strategies,
    restart_timeline,
    running_vector,
    shrink_timeline,
    strategy_key,
)

# ---- cost models, scenarios, executors (device-free) -----------------------
from repro_torch.malleability import (
    FAULT_SCENARIO_NAMES,
    MN5,
    NASP,
    CostModel,
    ExpansionReport,
    Scenario,
    ScenarioEvent,
    ScenarioRecord,
    ShrinkReport,
    TransitionCache,
    fsdp_bytes_model,
    get_scenario,
    param_bytes_for_arch,
    record_parity_key,
    register_scenario,
    registered_fault_scenarios,
    registered_scenarios,
    replicated_bytes_model,
    replicated_link_model,
    resolve_engine,
    run_scenario_live,
    run_scenario_sim,
    run_scenario_vectorized,
    scenario_pool,
    simulate_expansion,
    simulate_redistribution,
    simulate_shrink,
)

# ---- RMS policies + the multi-job arbiter (device-free) --------------------
from repro_torch.malleability import (
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
    charge_in_flight_queueing,
    churn_trace,
    monte_carlo_sweep,
    registered_policy_scenarios,
    registered_serve_scenarios,
    run_multijob_sim,
)
from repro_torch.malleability.policies import POLICY_SCENARIO_NAMES, ClusterState

# ---- the closed scheduling loop (device-free) ------------------------------
from repro_torch.malleability import (
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

# ---- throughput model / time-to-result (device-free) -----------------------
from repro_torch.malleability import (
    ThroughputModel,
    batch_shares,
    flops_per_token_for_arch,
    time_to_result,
)

# ---- elastic serving plane (device-free) -----------------------------------
from repro_torch.serving import (
    EXECUTORS,
    ContinuousBatcher,
    KVBytesModel,
    KVPageTable,
    PageSpec,
    Request,
    ServeConfig,
    ServePhase,
    ServeReport,
    check_serve_agreement,
    run_serve,
    serve_config,
    serve_parity_key,
)

# ---- layers that hold tensors or build kernels: resolved lazily -----------
# name -> providing module.  Kept out of the eager imports so
# `import repro_torch.api` stays cheap and leaves the card alone; each is
# imported on first access, and none of them touches the card until it
# is called.
_LAZY_EXPORTS: dict[str, str] = {
    # checkpoint store
    "CheckpointManager": "repro_torch.checkpoint",
    # elastic runtime
    "DevicePool": "repro_torch.elastic",
    "ElasticRuntime": "repro_torch.elastic",
    "ElasticTrainer": "repro_torch.elastic.trainer",
    "reshard_tree": "repro_torch.elastic",
    "transfer_stats": "repro_torch.elastic",
    # RMS event source (its package imports the elastic runtime)
    "Event": "repro_torch.elastic.rms",
    "EventKind": "repro_torch.elastic.rms",
    "SimulatedRMS": "repro_torch.elastic.rms",
    # model / data / config
    "Model": "repro_torch.models",
    "arch_config": "repro_torch.configs",
    "smoke_config": "repro_torch.configs",
    "SyntheticTokens": "repro_torch.data",
    "make_batch_on_mesh": "repro_torch.data",
    # sharding + training
    "ShardingContext": "repro_torch.parallel.sharding",
    "param_sharding": "repro_torch.parallel.sharding",
    "use_sharding": "repro_torch.parallel.sharding",
    "TrainState": "repro_torch.train.steps",
    "build_init_fn": "repro_torch.train.steps",
    "build_train_step": "repro_torch.train.steps",
    "train_state_shardings": "repro_torch.train.steps",
    # launchers
    "make_host_mesh": "repro_torch.launch.mesh",
    "run_elastic": "repro_torch.launch.serve",
}


def __getattr__(name: str):
    module = _LAZY_EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(import_module(module), name)
    globals()[name] = value     # cache: subsequent lookups are plain
    return value


def __dir__() -> list[str]:
    return sorted(set(globals()) | set(_LAZY_EXPORTS))


__all__ = [
    # engine / strategy core
    "DISTANCE_CLASSES",
    "DMR_KEY",
    "TOPO_KEY",
    "CheckpointSpec",
    "Method",
    "ReconfigEngine",
    "ReconfigOutcome",
    "ReconfigPlan",
    "ShrinkKind",
    "SpawnPlan",
    "Stage",
    "Strategy",
    "StrategySpec",
    "Timeline",
    "TimelineEvent",
    "Topology",
    "checkpoint_timeline",
    "get_strategy",
    "plan_diffusive",
    "plan_dmr",
    "plan_hypercube",
    "plan_sequential",
    "plan_topo",
    "register_strategy",
    "registered_strategies",
    "restart_timeline",
    "running_vector",
    "shrink_timeline",
    "strategy_key",
    # cost models, scenarios, executors
    "FAULT_SCENARIO_NAMES",
    "MN5",
    "NASP",
    "CostModel",
    "ExpansionReport",
    "Scenario",
    "ScenarioEvent",
    "ScenarioRecord",
    "ShrinkReport",
    "TransitionCache",
    "fsdp_bytes_model",
    "get_scenario",
    "param_bytes_for_arch",
    "record_parity_key",
    "register_scenario",
    "registered_fault_scenarios",
    "registered_scenarios",
    "replicated_bytes_model",
    "replicated_link_model",
    "resolve_engine",
    "run_scenario_live",
    "run_scenario_sim",
    "run_scenario_vectorized",
    "scenario_pool",
    "simulate_expansion",
    "simulate_redistribution",
    "simulate_shrink",
    # policies + arbiter
    "POLICY_SCENARIO_NAMES",
    "SERVE_SCENARIO_NAMES",
    "SERVE_TRAFFIC",
    "ArbitratedJob",
    "BackfillPolicy",
    "CheckpointIntervalPolicy",
    "ChurnPolicy",
    "ClusterState",
    "JobSpec",
    "MonteCarloSweep",
    "MultiJobOutcome",
    "PolicyTrace",
    "PreemptionPolicy",
    "PriorityArrival",
    "RigidArrival",
    "RmsPolicy",
    "TrafficPolicy",
    "arbitrate_jobs",
    "charge_in_flight_queueing",
    "churn_trace",
    "monte_carlo_sweep",
    "registered_policy_scenarios",
    "registered_serve_scenarios",
    "run_multijob_sim",
    # scheduler optimizer
    "KNOB_GRID",
    "WORKLOAD_SCENARIO_NAMES",
    "WORKLOAD_TRACES",
    "OptimizerResult",
    "ScheduleObjective",
    "ScheduleOutcome",
    "SchedulerKnobs",
    "WorkloadTrace",
    "evaluate_schedule",
    "generate_workload",
    "optimize_schedule",
    "registered_workload_scenarios",
    "rigid_baseline",
    # throughput model / time-to-result
    "ThroughputModel",
    "batch_shares",
    "flops_per_token_for_arch",
    "time_to_result",
    # serving plane
    "EXECUTORS",
    "ContinuousBatcher",
    "KVBytesModel",
    "KVPageTable",
    "PageSpec",
    "Request",
    "ServeConfig",
    "ServePhase",
    "ServeReport",
    "check_serve_agreement",
    "run_serve",
    "serve_config",
    "serve_parity_key",
    # lazy
    *sorted(_LAZY_EXPORTS),
]
