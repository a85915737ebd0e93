"""Shrink planning: TS / ZS / SS decision logic (paper §4.6-§4.7).

The whole point of the parallel spawning strategies is that every spawned
world is confined to one node, so shrinking can *terminate* worlds and
hand their nodes back to the RMS (Termination Shrinkage) instead of
respawning everything (SS) or leaving zombies that pin nodes (ZS).

State model (mirrors the paper's root-rank bookkeeping):

* the global root keeps ``{world -> nodelist}``;
* each world root keeps per-rank ``(node, zombie?)`` flags;
* the initial world may span several nodes and cannot be partially
  returned — §4.6 enumerates how that is handled (we implement the
  paper's adopted policy: postpone until a shrink actually needs it).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .types import (
    RankInfo,
    ShrinkAction,
    ShrinkActionKind,
    ShrinkKind,
    ShrinkPlan,
    World,
)


@dataclass
class ClusterState:
    """Worlds currently alive in the job + global-root bookkeeping."""

    worlds: dict[int, World] = field(default_factory=dict)
    global_root_wid: int = 0
    expansions_done: int = 0  # §4.6: history matters for the initial MCW
    _next_wid: int = 0

    # ---- construction helpers -------------------------------------------------
    def add_world(self, nodes, ranks_per_node, is_initial=False) -> World:
        wid = self._next_wid
        self._next_wid += 1
        ranks: list[RankInfo] = []
        rank = 0
        for node, count in zip(nodes, ranks_per_node):
            for _ in range(count):
                ranks.append(RankInfo(rank=rank, node=node))
                rank += 1
        w = World(wid=wid, nodes=tuple(nodes), ranks=ranks, is_initial=is_initial)
        self.worlds[wid] = w
        if len(self.worlds) == 1:
            self.global_root_wid = wid
        return w

    # ---- queries ---------------------------------------------------------------
    def nodes_in_use(self) -> set[int]:
        return {n for w in self.worlds.values() for n in w.nodes}

    def worlds_on_node(self, node: int) -> list[World]:
        return [w for w in self.worlds.values() if node in w.nodes]

    def total_active_ranks(self) -> int:
        return sum(len(w.active_ranks) for w in self.worlds.values())


def plan_shrink(state: ClusterState, release_nodes=None, release_cores=None) -> ShrinkPlan:
    """Decide shrink actions for an RMS request.

    Args:
      state: live cluster bookkeeping.
      release_nodes: node ids the RMS wants back entirely.
      release_cores: {node: n_cores} partial within-node releases (§4.6
        last bullet: excess ranks become zombies, ZS).

    Returns a :class:`ShrinkPlan`; the caller applies it via
    :func:`apply_shrink`.
    """
    release_nodes = set(release_nodes or ())
    release_cores = dict(release_cores or {})
    actions: list[ShrinkAction] = []
    returned: list[int] = []
    pinned: list[int] = []
    used_ts = used_zs = False

    # --- whole-node releases ---------------------------------------------------
    doomed_wids: set[int] = set()
    for wid, w in state.worlds.items():
        span = set(w.nodes)
        if not span:
            continue
        if span <= release_nodes:
            doomed_wids.add(wid)
    for wid in sorted(doomed_wids):
        w = state.worlds[wid]
        if w.all_zombie:
            # §4.7: a fully-zombie world is awakened so it can terminate.
            actions.append(
                ShrinkAction(ShrinkActionKind.AWAKEN_AND_TERMINATE, wid=wid, nodes=w.nodes)
            )
        else:
            actions.append(
                ShrinkAction(ShrinkActionKind.TERMINATE_WORLD, wid=wid, nodes=w.nodes)
            )
        returned.extend(w.nodes)
        used_ts = True

    # Root migration (§4.7): if the global root's world terminates, hand
    # the structure to the lowest-wid surviving world.
    if state.global_root_wid in doomed_wids:
        survivors = sorted(set(state.worlds) - doomed_wids)
        if survivors:
            actions.append(
                ShrinkAction(
                    ShrinkActionKind.MIGRATE_ROOT,
                    wid=state.global_root_wid,
                    new_root_wid=survivors[0],
                )
            )

    # --- nodes requested but not fully coverable by dying worlds ---------------
    for node in sorted(release_nodes):
        holders = [w for w in state.worlds.values() if node in w.nodes and w.wid not in doomed_wids]
        for w in holders:
            if len(w.nodes) > 1:
                # §4.7 last paragraph: a multi-node MCW asked to give up a
                # subset of its nodes cannot use TS -> fall back to ZS for
                # the ranks on that node; the node stays pinned.
                zr = tuple(r.rank for r in w.ranks if r.node == node and not r.zombie)
                if zr:
                    actions.append(
                        ShrinkAction(ShrinkActionKind.ZOMBIFY_RANKS, wid=w.wid, ranks=zr, nodes=(node,))
                    )
                    used_zs = True
                pinned.append(node)

    # --- partial within-node core releases (ZS; §4.6 last bullet) --------------
    for node, n_cores in sorted(release_cores.items()):
        remaining = n_cores
        for w in sorted(state.worlds_on_node(node), key=lambda w: -w.wid):
            if w.wid in doomed_wids or remaining <= 0:
                continue
            candidates = [r for r in w.ranks if r.node == node and not r.zombie]
            take = candidates[len(candidates) - min(remaining, len(candidates)):]
            if not take:
                continue
            remaining -= len(take)
            if len(take) == len([r for r in w.ranks if not r.zombie]) and len(w.nodes) == 1:
                # Whole (single-node) world zombified -> §4.7 upgrades to TS.
                actions.append(
                    ShrinkAction(
                        ShrinkActionKind.AWAKEN_AND_TERMINATE, wid=w.wid, nodes=w.nodes
                    )
                )
                returned.extend(w.nodes)
                used_ts = True
            else:
                actions.append(
                    ShrinkAction(
                        ShrinkActionKind.ZOMBIFY_RANKS,
                        wid=w.wid,
                        ranks=tuple(r.rank for r in take),
                        nodes=(node,),
                    )
                )
                used_zs = True
                if node not in pinned:
                    pinned.append(node)

    kind = ShrinkKind.TS if used_ts and not used_zs else (
        ShrinkKind.ZS if used_zs and not used_ts else
        (ShrinkKind.TS if used_ts else ShrinkKind.ZS)
    )
    return ShrinkPlan(
        kind=kind,
        actions=tuple(actions),
        nodes_returned=tuple(sorted(set(returned))),
        nodes_pinned=tuple(sorted(set(pinned) - set(returned))),
    )


def plan_initial_world_shrink(state: ClusterState, nodes_to_return: int) -> ShrinkAction:
    """§4.6: policy for the multi-node *initial* MCW (postpone approach).

    * no expansion yet                  -> PARALLEL_RESPAWN (recreate the job
      with the parallel strategy so worlds become node-confined, then TS);
    * request smaller than the initial allocation -> POSTPONE (return only
      expanded nodes, keep initial MCW intact);
    * request >= initial allocation     -> the whole initial MCW terminates
      (TERMINATE_WORLD), remainder comes from the expanded set.
    """
    initial = next((w for w in state.worlds.values() if w.is_initial), None)
    if initial is None or len(initial.nodes) <= 1:
        return ShrinkAction(ShrinkActionKind.POSTPONE)
    if state.expansions_done == 0:
        return ShrinkAction(ShrinkActionKind.PARALLEL_RESPAWN, wid=initial.wid)
    if nodes_to_return < len(initial.nodes):
        return ShrinkAction(ShrinkActionKind.POSTPONE, wid=initial.wid)
    return ShrinkAction(
        ShrinkActionKind.TERMINATE_WORLD, wid=initial.wid, nodes=initial.nodes
    )


def apply_shrink(state: ClusterState, plan: ShrinkPlan) -> ClusterState:
    """Mutate ``state`` according to ``plan`` (returns it for chaining)."""
    for act in plan.actions:
        if act.kind in (ShrinkActionKind.TERMINATE_WORLD, ShrinkActionKind.AWAKEN_AND_TERMINATE):
            state.worlds.pop(act.wid, None)
        elif act.kind is ShrinkActionKind.ZOMBIFY_RANKS:
            w = state.worlds[act.wid]
            chosen = set(act.ranks)
            for r in w.ranks:
                if r.rank in chosen:
                    r.zombie = True
        elif act.kind is ShrinkActionKind.MIGRATE_ROOT:
            if act.new_root_wid is not None:
                state.global_root_wid = act.new_root_wid
    return state
