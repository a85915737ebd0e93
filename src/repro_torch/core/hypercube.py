"""Hypercube parallel spawning strategy (paper §4.1).

Homogeneous allocations only: every node contributes exactly ``C`` cores,
and every spawned group has size ``C``.  In each round every live process
issues one spawn (``MPI_Comm_spawn`` over ``MPI_COMM_SELF`` in the paper)
creating one ``C``-sized group on a fresh node, so the node count grows by
the factor ``C + 1`` per round:

    T_s = (C+1)^s * I - I   (Baseline)        [Eq. 1]
    T_s = (C+1)^s * I       (Merge)           [Eq. 1]
    t_s = C * T_s                              [Eq. 2]
    s   = ceil( ln(N / I) / ln(C + 1) )        [Eq. 3]

with I = NS / C initial nodes and N = NT / C target nodes.
"""
from __future__ import annotations

import math

from .types import SOURCE_GID, GroupSpec, Method, SpawnPlan, StepTrace, Strategy


def steps_required(n_nodes: int, initial_nodes: int, cores: int) -> int:
    """Closed-form number of spawning rounds, Eq. 3.

    ``N`` target nodes, ``I`` initial nodes, ``C`` cores per node.
    """
    if n_nodes <= initial_nodes:
        return 0
    return math.ceil(
        math.log(n_nodes / initial_nodes) / math.log(cores + 1) - 1e-12
    )


def nodes_at_step(s: int, initial_nodes: int, cores: int, method: Method) -> int:
    """Cumulative spawnable node capacity at step ``s`` (Eq. 1)."""
    total = (cores + 1) ** s * initial_nodes
    if method is Method.BASELINE:
        total -= initial_nodes
    return total


def procs_at_step(s: int, initial_nodes: int, cores: int, method: Method) -> int:
    """Eq. 2: processes = C * nodes."""
    return cores * nodes_at_step(s, initial_nodes, cores, method)


def plan_hypercube(
    ns: int, nt: int, cores: int, method: Method = Method.MERGE
) -> SpawnPlan:
    """Build the full hypercube spawn plan for NS -> NT ranks.

    Requires ``NS % C == 0`` and ``NT % C == 0`` (paper precondition).
    Group ids are assigned in spawn order, which by construction is node
    order, so Eq. 9's reordering yields node-contiguous global ranks.
    """
    if ns % cores or nt % cores:
        raise ValueError(
            f"hypercube requires NS ({ns}) and NT ({nt}) divisible by C ({cores})"
        )
    if ns <= 0:
        raise ValueError("need at least one source process")
    initial_nodes = ns // cores
    n_nodes = nt // cores
    if method is Method.MERGE:
        n_groups = n_nodes - initial_nodes
    else:
        # Baseline replaces the sources: spawn the full target allocation.
        n_groups = n_nodes
    if n_groups < 0:
        raise ValueError("hypercube plans expansions; use the shrink planner")

    # Target nodes: fresh nodes first (I..N-1); Baseline additionally
    # re-populates the source nodes 0..I-1 last (transient oversubscription,
    # which the paper observes as the Baseline overhead in Fig. 4a).  For a
    # Baseline *shrink* (N < I) every target node is source-occupied.
    fresh = list(range(initial_nodes, n_nodes))
    node_of_gid = fresh + (
        list(range(min(initial_nodes, n_nodes))) if method is Method.BASELINE else []
    )
    assert len(node_of_gid) == n_groups

    # Canonical spawner order: source ranks first, then groups by gid, each
    # by local rank.  Every spawner creates at most one group per round.
    spawners: list[tuple[int, int]] = [(SOURCE_GID, r) for r in range(ns)]
    groups: list[GroupSpec] = []
    trace: list[StepTrace] = [
        StepTrace(s=0, t=ns, g=0, lam=0, T=initial_nodes, G=0)
    ]
    gid = 0
    step = 0
    while gid < n_groups:
        step += 1
        budget = min(len(spawners), n_groups - gid)  # final-round truncation
        new_groups: list[GroupSpec] = []
        for i in range(budget):
            pg, pr = spawners[i]
            new_groups.append(
                GroupSpec(
                    gid=gid,
                    node=node_of_gid[gid],
                    size=cores,
                    step=step,
                    parent_gid=pg,
                    parent_rank=pr,
                )
            )
            gid += 1
        groups.extend(new_groups)
        for g in new_groups:
            spawners.extend((g.gid, r) for r in range(g.size))
        prev = trace[-1]
        g_s = sum(g.size for g in new_groups)
        G_s = len({g.node for g in new_groups} - set(range(initial_nodes)))
        trace.append(
            StepTrace(
                s=step,
                t=prev.t + g_s,
                g=g_s,
                lam=0,  # lambda is a diffusive-only concept
                T=prev.T + G_s,
                G=G_s,
            )
        )

    # Cross-check the constructive plan against the closed forms (Eqs. 1-3).
    expected_steps = steps_required(n_nodes, initial_nodes, cores)
    if method is Method.BASELINE:
        # Baseline spawns N (not N-I) groups; capacity check uses Eq. 1's
        # Baseline branch: (C+1)^s * I - I >= N.
        expected_steps = 0
        while nodes_at_step(expected_steps, initial_nodes, cores, method) < n_nodes:
            expected_steps += 1
    if step != expected_steps:
        raise AssertionError(
            f"constructive plan used {step} steps, closed form says {expected_steps}"
        )

    n_vec = max(n_nodes, initial_nodes)
    a_vec = [cores] * n_nodes + [0] * (n_vec - n_nodes)
    # R records where the sources actually run during the reconfiguration
    # (drives oversubscription detection); for BASELINE they nonetheless
    # do not persist into the target world (handled via plan.method).
    r_vec = [cores] * initial_nodes + [0] * (n_vec - initial_nodes)
    if method is Method.MERGE:
        s_vec = [a - r for a, r in zip(a_vec, r_vec)]
    else:
        s_vec = [cores] * n_nodes + [0] * (n_vec - n_nodes)

    return SpawnPlan(
        method=method,
        strategy=Strategy.PARALLEL_HYPERCUBE,
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
