"""Core: the paper's contribution — parallel spawning strategies for
dynamic-aware (malleable) distributed jobs.

Faithful implementations of:
  * Hypercube strategy            (§4.1, Eqs. 1-3)   -> :mod:`.hypercube`
  * Iterative Diffusive strategy  (§4.2, Eqs. 4-8)   -> :mod:`.diffusive`
  * Group synchronization         (§4.3)             -> :mod:`.sync`
  * Binary connection             (§4.4)             -> :mod:`.connect`
  * Rank reordering               (§4.5, Eq. 9)      -> :mod:`.reorder`
  * TS/ZS/SS shrink planning      (§4.6-4.7)         -> :mod:`.shrink`
  * MaM-style manager facade      (§3)               -> :mod:`.manager`
  * Cluster topology + distance classes              -> :mod:`.topology`
  * Topology-aware spawning strategy ("topo")        -> :mod:`.topo`
  * DMR-style async two-phase strategy ("dmr-async") -> :mod:`.dmr`
"""
from .connect import (
    ConnectRound,
    binary_connection_schedule,
    extend_graph_with_connection,
    required_ports,
    simulate_merges,
)
from .diffusive import plan_diffusive
from .engine import (
    CheckpointSpec,
    ExecutionBackend,
    ReconfigEngine,
    ReconfigOutcome,
    ReconfigPlan,
    RedistributionSpec,
    Stage,
    StrategySpec,
    Timeline,
    TimelineEvent,
    as_core_vector,
    checkpoint_timeline,
    expansion_timeline,
    get_strategy,
    register_strategy,
    registered_strategies,
    restart_timeline,
    running_vector,
    shrink_timeline,
    strategy_key,
)
from .hypercube import nodes_at_step, plan_hypercube, procs_at_step, steps_required
from .manager import MalleabilityManager
from .sequential import plan_sequential
from .reorder import global_order, node_of_rank, reorder_key
from .shrink import ClusterState, apply_shrink, plan_initial_world_shrink, plan_shrink
from .sync import (
    EventGraph,
    Event,
    assert_ports_before_release,
    build_sync_graph,
    port_openers,
    spawn_children,
)
from .topology import DISTANCE_CLASSES, Topology
from .vectorized import (
    Charge,
    ChargeStats,
    EventArrays,
    charge_stats,
    checkpoint_charge,
    hypercube_expand_charges,
    queue_charge,
    redistribution_charge,
    restart_charges,
    restore_charge,
    ts_shrink_charges,
)
# Importing .topo / .dmr registers the "topo" and "dmr-async" strategies
# in the engine registry (ordinary third-party-style registrations).
from .topo import TOPO_KEY, place_rack_local, plan_topo, vacate_racks
from .dmr import DMR_KEY, plan_dmr
from .types import (
    SOURCE_GID,
    GroupSpec,
    Method,
    RankInfo,
    ShrinkAction,
    ShrinkActionKind,
    ShrinkKind,
    ShrinkPlan,
    SpawnPlan,
    StepTrace,
    Strategy,
    World,
)

__all__ = [
    "DISTANCE_CLASSES",
    "DMR_KEY",
    "SOURCE_GID",
    "TOPO_KEY",
    "Charge",
    "ChargeStats",
    "CheckpointSpec",
    "ClusterState",
    "Topology",
    "ConnectRound",
    "Event",
    "EventArrays",
    "EventGraph",
    "ExecutionBackend",
    "GroupSpec",
    "MalleabilityManager",
    "Method",
    "RankInfo",
    "ReconfigEngine",
    "ReconfigOutcome",
    "ReconfigPlan",
    "RedistributionSpec",
    "Stage",
    "StrategySpec",
    "Timeline",
    "TimelineEvent",
    "ShrinkAction",
    "ShrinkActionKind",
    "ShrinkKind",
    "ShrinkPlan",
    "SpawnPlan",
    "StepTrace",
    "Strategy",
    "World",
    "apply_shrink",
    "as_core_vector",
    "assert_ports_before_release",
    "binary_connection_schedule",
    "build_sync_graph",
    "charge_stats",
    "checkpoint_charge",
    "checkpoint_timeline",
    "expansion_timeline",
    "extend_graph_with_connection",
    "get_strategy",
    "global_order",
    "hypercube_expand_charges",
    "node_of_rank",
    "nodes_at_step",
    "place_rack_local",
    "plan_diffusive",
    "plan_dmr",
    "plan_hypercube",
    "plan_initial_world_shrink",
    "plan_sequential",
    "plan_shrink",
    "plan_topo",
    "port_openers",
    "procs_at_step",
    "queue_charge",
    "redistribution_charge",
    "register_strategy",
    "registered_strategies",
    "reorder_key",
    "required_ports",
    "restart_charges",
    "restart_timeline",
    "restore_charge",
    "running_vector",
    "shrink_timeline",
    "simulate_merges",
    "spawn_children",
    "steps_required",
    "strategy_key",
    "ts_shrink_charges",
    "vacate_racks",
]
