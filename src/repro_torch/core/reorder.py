"""Rank reordering after the binary connection (paper §4.5, Eq. 9).

Binary connections are racy in the order intercommunicators arrive, so
the merged communicator's ranks are not node-ordered.  A final
``MPI_Comm_split`` with the key

    new_rank = world_rank + sum_j R_j + sum_{j < group_id} S_j      (Eq. 9)

restores a deterministic node-contiguous order:  sources keep their
original ranks 0..NS-1, and spawned group ``gid`` occupies the block
right after all sources and all lower-gid groups.  In the elastic JAX
runtime this same key fixes the device order of the rebuilt mesh.
"""
from __future__ import annotations

from .types import Method, SpawnPlan


def reorder_key(world_rank: int, sum_running: int, group_sizes, group_id: int) -> int:
    """Eq. 9 for one spawned process.

    ``world_rank`` is the process's rank inside its own group world,
    ``sum_running`` is sum(R) (ranks existing before the resize), and
    ``group_sizes[j]`` is S_j, the size of spawned group j.
    """
    return world_rank + sum_running + sum(group_sizes[j] for j in range(group_id))


def global_order(plan: SpawnPlan) -> list[tuple[int, int]]:
    """Final (group_id, local_rank) layout for the whole target world.

    Index in the returned list == final global rank.  For MERGE the
    sources (group_id == -1) keep ranks 0..NS-1; for BASELINE the sources
    vanish and the R-sum contribution is zero by construction (R == 0 in
    the plan's vectors).
    """
    sizes = plan.group_sizes
    sum_running = plan.ns if plan.method is Method.MERGE else 0
    total = sum_running + sum(sizes)
    layout: list[tuple[int, int] | None] = [None] * total
    if plan.method is Method.MERGE:
        for r in range(plan.ns):
            layout[r] = (-1, r)
    for g in plan.groups:
        for local in range(g.size):
            key = reorder_key(local, sum_running, sizes, g.gid)
            if layout[key] is not None:
                raise AssertionError(f"Eq. 9 key collision at rank {key}")
            layout[key] = (g.gid, local)
    if any(entry is None for entry in layout):
        raise AssertionError("Eq. 9 keys do not cover 0..NT-1")
    return layout  # type: ignore[return-value]


def node_of_rank(plan: SpawnPlan) -> list[int]:
    """Node hosting each final global rank (node-contiguity check)."""
    node_by_gid = {g.gid: g.node for g in plan.groups}
    out: list[int] = []
    src_nodes: list[int] = []
    if plan.method is Method.MERGE:
        # Source ranks sit on the initially running nodes, R[i] ranks each,
        # in node order.
        for i, r in enumerate(plan.running):
            src_nodes.extend([i] * r)
    for gid, local in global_order(plan):
        out.append(src_nodes[local] if gid == -1 else node_by_gid[gid])
    return out
