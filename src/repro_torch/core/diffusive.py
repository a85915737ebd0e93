"""Iterative Diffusive parallel spawning strategy (paper §4.2).

Handles heterogeneous allocations: nodes may contribute different core
counts, so spawned groups have variable sizes.  The allocation is
described by three vectors over the ``N`` nodes:

    A_i  cores assigned to the job on node i
    R_i  ranks of the job already running on node i
    S_i  ranks to spawn on node i,  S_i = A_i - R_i

Each round ``s`` the ``t_{s-1}`` live processes consume the next
contiguous ``t_{s-1}`` entries of ``S`` (one entry per live process, in
canonical process order); every positive entry spawns one node-confined
group of that size:

    t_s      = t_{s-1} + g_s,            t_0 = sum(R)      [Eq. 4]
    g_s      = sum_{i=lam_{s-1}}^{min(N,lam_s)-1} S_i      [Eq. 5]
    lam_s    = lam_{s-1} + t_{s-1},      lam_0 = 0         [Eq. 6]
    T_s      = T_{s-1} + G_s,            T_0 = I           [Eq. 7]
    G_s      = #{ i in range : R_i == 0 and S_i > 0 }      [Eq. 8]

NOTE on the paper's Table 2: iterating Eq. 6 gives lam = [0, 2, 8, 48]
for the worked example; the table prints lam_2 = 7 and lam_3 = 47, an
off-by-one typo propagated through the last two rows (all other columns
-- t, g, T, G -- match Eq. 4-8 exactly, as our tests assert).
"""
from __future__ import annotations

from collections.abc import Sequence

from .types import SOURCE_GID, GroupSpec, Method, SpawnPlan, StepTrace, Strategy


def plan_diffusive(
    cores: Sequence[int],
    running: Sequence[int],
    method: Method = Method.MERGE,
) -> SpawnPlan:
    """Build the iterative diffusive spawn plan from vectors A and R.

    For BASELINE the sources do not persist into the target world, so the
    full allocation is spawned fresh (S = A) while the R vector still
    provides the round-0 spawner pool.
    """
    if len(cores) != len(running):
        raise ValueError("A and R vectors must have equal length")
    n_nodes = len(cores)
    a_vec = [int(a) for a in cores]
    r_vec = [int(r) for r in running]
    if any(a < 0 for a in a_vec) or any(r < 0 for r in r_vec):
        raise ValueError("A and R must be non-negative")
    ns = sum(r_vec)
    if ns <= 0:
        raise ValueError("need at least one source process")

    if method is Method.MERGE:
        s_vec = [max(0, a - r) for a, r in zip(a_vec, r_vec)]
        if any(a < r for a, r in zip(a_vec, r_vec)):
            raise ValueError(
                "negative S entries: mixed shrink+expand must route the "
                "shrink part through the shrink planner first"
            )
    else:
        s_vec = list(a_vec)  # spawn the whole target allocation fresh

    # Canonical spawner order: sources first (node order, then local rank),
    # then spawned groups by gid.
    spawners: list[tuple[int, int]] = [(SOURCE_GID, r) for r in range(ns)]
    groups: list[GroupSpec] = []
    initial_nodes = sum(1 for r in r_vec if r > 0)
    trace: list[StepTrace] = [
        StepTrace(s=0, t=ns, g=0, lam=0, T=initial_nodes, G=0)
    ]
    gid = 0
    step = 0
    lam_prev = 0
    t_prev = ns
    remaining = sum(s_vec)
    while lam_prev < n_nodes and remaining > 0:
        step += 1
        lam_s = lam_prev + t_prev                       # Eq. 6
        lo, hi = lam_prev, min(n_nodes, lam_s)          # Eq. 5 index range
        g_s = 0
        G_s = 0
        new_groups: list[GroupSpec] = []
        for offset, i in enumerate(range(lo, hi)):
            if s_vec[i] <= 0:
                continue  # null S entries are disregarded (paper §4.2)
            pg, pr = spawners[offset]
            new_groups.append(
                GroupSpec(
                    gid=gid,
                    node=i,
                    size=s_vec[i],
                    step=step,
                    parent_gid=pg,
                    parent_rank=pr,
                )
            )
            gid += 1
            g_s += s_vec[i]
            if r_vec[i] == 0:                           # Eq. 8 condition
                G_s += 1
        groups.extend(new_groups)
        for g in new_groups:
            spawners.extend((g.gid, r) for r in range(g.size))
        prev = trace[-1]
        trace.append(
            StepTrace(s=step, t=prev.t + g_s, g=g_s, lam=lam_s, T=prev.T + G_s, G=G_s)
        )
        lam_prev = lam_s
        t_prev = prev.t + g_s
        remaining -= g_s

    nt = sum(s_vec) + (ns if method is Method.MERGE else 0)
    return SpawnPlan(
        method=method,
        strategy=Strategy.PARALLEL_DIFFUSIVE,
        nodes=n_nodes,
        cores=tuple(a_vec),
        running=tuple(r_vec),
        to_spawn=tuple(s_vec),
        groups=tuple(groups),
        steps=step,
        trace=tuple(trace),
        ns=ns,
        nt=nt,
    )
