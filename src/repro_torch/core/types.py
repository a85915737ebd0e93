"""Core datatypes for the parallel-spawning malleability framework.

Terminology follows the paper (Martín-Álvarez et al., "Parallel Spawning
Strategies for Dynamic-Aware MPI Applications"):

* *source* processes — the NS ranks alive before a reconfiguration.
* *target* processes — the NT ranks alive after it.
* *group*  — one spawned process-group; by construction each group's
  world (its MCW in MPI terms) is confined to a single node, which is
  what enables Termination Shrinkage (TS).
* *method* — BASELINE (spawn all NT, drop sources) or MERGE (reuse
  sources, spawn only the difference).
* *strategy* — how the spawn phase is executed.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional, Union

SOURCE_GID = -1  # pseudo group-id of the initial (source) group


class Method(enum.Enum):
    """Process-management method (MaM §3)."""

    BASELINE = "baseline"  # spawn NT fresh ranks, terminate the NS sources
    MERGE = "merge"        # reuse sources, spawn/terminate only the delta


class Strategy(enum.Enum):
    """Spawning strategy (MaM §3 + this paper §4)."""

    SEQUENTIAL = "sequential"            # one collective spawn call (classic Merge)
    SEQUENTIAL_PER_NODE = "per_node"     # one spawn call per node, serial ([14])
    SINGLE = "single"                    # only rank 0 spawns, informs the rest
    PARALLEL_HYPERCUBE = "hypercube"     # §4.1 (homogeneous allocations)
    PARALLEL_DIFFUSIVE = "diffusive"     # §4.2 (heterogeneous allocations)


class ShrinkKind(enum.Enum):
    """Shrinkage mechanisms compared in the paper (§1, §4.7)."""

    SS = "spawn_shrinkage"        # respawn the whole job smaller (Baseline)
    ZS = "zombie_shrinkage"       # excess ranks sleep; nodes stay pinned
    TS = "termination_shrinkage"  # whole node-confined worlds terminate


@dataclass(frozen=True)
class GroupSpec:
    """One spawned process group (one `MPI_Comm_spawn` in the paper).

    Attributes:
      gid:         group identifier, 0..G-1 in node order (§4.1/§4.2).
      node:        node index the group is confined to.
      size:        number of ranks in the group (== S[node] for diffusive,
                   == C for hypercube).
      step:        spawning round (1-based; round 0 is the initial state).
      parent_gid:  gid of the group whose member issued the spawn
                   (SOURCE_GID for the initial group).
      parent_rank: local rank of the spawning member inside its group.
    """

    gid: int
    node: int
    size: int
    step: int
    parent_gid: int
    parent_rank: int
    # Nodes the group's world spans.  Parallel strategies always produce
    # node-confined groups (len == 1, the TS-enabling invariant); the
    # classic SEQUENTIAL spawn produces one world spanning many nodes,
    # which is exactly what makes TS impossible for it.
    spans: tuple[int, ...] = ()

    def nodes_spanned(self) -> tuple[int, ...]:
        return self.spans if self.spans else (self.node,)


@dataclass(frozen=True)
class StepTrace:
    """Per-step bookkeeping matching the paper's Eqs. 1-8 / Table 2.

    t: total processes existing at END of step  (Eq. 2 / Eq. 4)
    g: processes generated during the step      (Eq. 5)
    lam: lambda_s, start index into S for the NEXT step (Eq. 6)
    T: total occupied nodes at end of step      (Eq. 1 / Eq. 7)
    G: new nodes added during the step          (Eq. 8)
    """

    s: int
    t: int
    g: int
    lam: int
    T: int
    G: int


@dataclass(frozen=True)
class SpawnPlan:
    """Complete description of one parallel spawn phase.

    The plan is purely declarative: the simulator executes it with a cost
    model, the elastic runtime executes it against real device groups.
    """

    method: Method
    # Built-in plans carry the Strategy enum; third-party registered
    # strategies (e.g. repro_torch.core.topo) carry their registry key string.
    # Normalize with repro_torch.core.strategy_key when a label is needed.
    strategy: Union[Strategy, str]
    nodes: int                     # N, nodes in the target allocation
    cores: tuple[int, ...]         # A vector (cores per node)
    running: tuple[int, ...]       # R vector (ranks running per node)
    to_spawn: tuple[int, ...]      # S vector (ranks to spawn per node)
    groups: tuple[GroupSpec, ...]  # all spawned groups, gid order
    steps: int                     # spawn rounds used
    trace: tuple[StepTrace, ...]   # per-step closed-form bookkeeping
    ns: int                        # source processes
    nt: int                        # target processes

    @property
    def group_sizes(self) -> tuple[int, ...]:
        return tuple(g.size for g in self.groups)

    def groups_in_step(self, s: int) -> list[GroupSpec]:
        return [g for g in self.groups if g.step == s]


@dataclass
class RankInfo:
    """Per-rank bookkeeping the root of each world maintains (§4.7)."""

    rank: int
    node: int
    zombie: bool = False


@dataclass
class World:
    """A node-confined communicator (one MCW) tracked by the global root.

    §4.7: the global root keeps, for each MCW, the nodelist where it
    executes; each world root keeps active/zombie status per rank.
    """

    wid: int
    nodes: tuple[int, ...]          # nodes this world spans (len==1 unless initial)
    ranks: list[RankInfo] = field(default_factory=list)
    is_initial: bool = False        # the job-start MCW (may span many nodes)

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def active_ranks(self) -> list[RankInfo]:
        return [r for r in self.ranks if not r.zombie]

    @property
    def all_zombie(self) -> bool:
        return all(r.zombie for r in self.ranks)


class ShrinkActionKind(enum.Enum):
    TERMINATE_WORLD = "terminate_world"   # TS: world exits, nodes returned
    ZOMBIFY_RANKS = "zombify_ranks"       # ZS: ranks sleep, node NOT returned
    AWAKEN_AND_TERMINATE = "awaken_and_terminate"  # all-zombie world -> TS (§4.7)
    MIGRATE_ROOT = "migrate_root"         # global root hand-off (§4.7)
    PARALLEL_RESPAWN = "parallel_respawn" # initial multi-node MCW fix (§4.6)
    POSTPONE = "postpone"                 # defer the initial-MCW problem (§4.6)


@dataclass(frozen=True)
class ShrinkAction:
    kind: ShrinkActionKind
    wid: Optional[int] = None
    ranks: tuple[int, ...] = ()
    nodes: tuple[int, ...] = ()
    new_root_wid: Optional[int] = None


@dataclass(frozen=True)
class ShrinkPlan:
    kind: ShrinkKind                   # dominant mechanism used
    actions: tuple[ShrinkAction, ...]
    nodes_returned: tuple[int, ...]    # nodes actually handed back to the RMS
    nodes_pinned: tuple[int, ...]      # nodes that stay pinned by zombies

    def doomed_wids(self) -> tuple[int, ...]:
        """Worlds this plan terminates (the single source both the engine's
        timeline charging and the live backend's node release consume)."""
        return tuple(
            a.wid
            for a in self.actions
            if a.wid is not None
            and a.kind in (ShrinkActionKind.TERMINATE_WORLD,
                           ShrinkActionKind.AWAKEN_AND_TERMINATE)
        )
