"""Classic (non-parallel) spawning strategies used as baselines (MaM §3).

* SEQUENTIAL: ONE collective ``MPI_Comm_spawn`` creating every new rank
  at once; the spawned world spans all target nodes — fast to expand but
  structurally incapable of TS (the paper's motivation).
* SEQUENTIAL_PER_NODE: one spawn per node, issued serially by the root
  ([14]'s approach) — node-confined worlds but O(nodes) latency.
* SINGLE: only rank 0 drives the spawn (MaM's Single strategy).
"""
from __future__ import annotations

from typing import Sequence

from .types import SOURCE_GID, GroupSpec, Method, SpawnPlan, StepTrace, Strategy


def plan_sequential(
    ns: int,
    nt: int,
    cores: Sequence[int],
    method: Method,
    per_node: bool = False,
    single: bool = False,
) -> SpawnPlan:
    """Build the spawn plan for the classic strategies (see module doc)."""
    cores = tuple(int(c) for c in cores)
    n_nodes = len(cores)
    spawn_total = nt - ns if method is Method.MERGE else nt
    if spawn_total < 0:
        raise ValueError("expansion planner called for a shrink")
    running: list[int] = []
    remaining = ns
    for c in cores:
        take = min(c, remaining)
        running.append(take)
        remaining -= take
    s_vec = [a - r for a, r in zip(cores, running)] if method is Method.MERGE else list(cores)

    groups: list[GroupSpec] = []
    if per_node:
        gid = 0
        for node, size in enumerate(s_vec):
            if size <= 0:
                continue
            groups.append(
                GroupSpec(
                    gid=gid,
                    node=node,
                    size=size,
                    step=gid + 1,  # serial: one round each
                    parent_gid=SOURCE_GID,
                    parent_rank=0,
                )
            )
            gid += 1
    elif spawn_total > 0:
        spanned = tuple(i for i, s in enumerate(s_vec) if s > 0)
        groups.append(
            GroupSpec(
                gid=0,
                node=spanned[0] if spanned else 0,
                size=spawn_total,
                step=1,
                parent_gid=SOURCE_GID,
                parent_rank=0,
                spans=spanned,
            )
        )

    strategy = (
        Strategy.SEQUENTIAL_PER_NODE if per_node else (Strategy.SINGLE if single else Strategy.SEQUENTIAL)
    )
    steps = len(groups) if per_node else (1 if groups else 0)
    trace = [StepTrace(s=0, t=ns, g=0, lam=0, T=sum(1 for r in running if r), G=0)]
    t = ns
    for i, g in enumerate(groups):
        t += g.size
        trace.append(StepTrace(s=i + 1, t=t, g=g.size, lam=0, T=0, G=0))
    return SpawnPlan(
        method=method,
        strategy=strategy,
        nodes=n_nodes,
        cores=cores,
        running=tuple(running),
        to_spawn=tuple(s_vec),
        groups=tuple(groups),
        steps=steps,
        trace=tuple(trace),
        ns=ns,
        nt=nt,
    )
