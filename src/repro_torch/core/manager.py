"""MalleabilityManager — the MaM-equivalent facade (paper §3, §4.6).

A thin application-facing wrapper over :class:`repro_torch.core.engine.ReconfigEngine`:
it holds the job-wide configuration (method, strategy, ASYNC flag, data
volume) plus the live :class:`ClusterState`, and delegates all planning
to the engine's strategy registry.  The four malleability stages:

  1. reconfiguration feasibility (delegated to the RMS / caller),
  2. process management        (spawn plan or shrink plan — the engine),
  3. data redistribution       (a declarative spec the elastic runtime
                                or the simulator executes),
  4. resume.

Methods and strategies mirror MaM: BASELINE / MERGE methods, combined
with SEQUENTIAL / SEQUENTIAL_PER_NODE / SINGLE / PARALLEL_HYPERCUBE /
PARALLEL_DIFFUSIVE spawning strategies and the ASYNC overlap flag.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

from .engine import (
    ReconfigEngine,
    ReconfigPlan,
    RedistributionSpec,  # noqa: F401  (re-exported: historical home)
)
from .sequential import plan_sequential  # noqa: F401  (re-exported: historical home)
from .shrink import ClusterState
from .types import Method, Strategy


@dataclass
class MalleabilityManager:
    """User-facing facade, one per job (mirrors MaM's init/config API)."""

    method: Method = Method.MERGE
    strategy: Strategy = Strategy.PARALLEL_HYPERCUBE
    asynchronous: bool = False
    bytes_per_rank: int = 0
    state: ClusterState = field(default_factory=ClusterState)

    @property
    def engine(self) -> ReconfigEngine:
        return ReconfigEngine(
            method=self.method,
            strategy=self.strategy,
            asynchronous=self.asynchronous,
            bytes_per_rank=self.bytes_per_rank,
        )

    # -- stage 2: process management --------------------------------------------
    def plan_expand(
        self,
        ns: int,
        nt: int,
        cores: Sequence[int] | int,
    ) -> ReconfigPlan:
        """Plan an NS -> NT expansion onto the given allocation.

        ``cores`` is either C (homogeneous, enables the hypercube) or the
        per-node A vector (heterogeneous, requires the diffusive strategy).
        """
        return self.engine.plan_expand(ns, nt, cores)

    def plan_shrink(self, release_nodes=None, release_cores=None) -> ReconfigPlan:
        return self.engine.plan_shrink(self.state, release_nodes, release_cores)
