"""Synchronization between process groups (paper §4.3).

After the parallel spawn, every group only knows its parent and its own
children (edges of the spawn tree).  Before any ``MPI_Comm_connect`` may
run, every port must already be open; the paper guarantees this with a
three-stage protocol executed over the spawn tree:

  1. *Subcommunicator creation* — per group, the root plus every member
     that spawned children split off a coordination subcommunicator.
  2. *Upside synchronization* — members wait for a token from each child
     group (Irecv+Waitall), the subcommunicator barriers, then the group
     root notifies its parent.  A group's token therefore implies its
     whole subtree is ready.
  3. *Downside synchronization* — the root receives the release token
     from its parent, the subcommunicator barriers, and members forward
     the token to their children.

We model this as an explicit happens-before event graph.  The graph is
used twice: tests verify the structural guarantee (every port_open
precedes every connect), and the malleability simulator assigns latencies
to events and takes the critical path to estimate reconfiguration time.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .types import SOURCE_GID, SpawnPlan

# Event kinds
SPAWNED = "spawned"          # group exists (end of its MPI_Comm_spawn)
PORT_OPEN = "port_open"      # root opened its port + published the name
UP_READY = "up_ready"        # subtree ready; root has sent token to parent
DOWN = "down"                # group released by its parent
CONNECT = "connect"          # one accept/connect pair of the binary phase
MERGED = "merged"            # per-round merge completed
FINAL_ACCEPT = "final_accept"  # sources <-> merged-children intercomm


@dataclass(frozen=True)
class Event:
    kind: str
    gid: int            # group the event belongs to (SOURCE_GID for sources)
    round: int = -1     # binary-connection round, if applicable
    peer: int = -1      # peer group, if applicable

    def __str__(self) -> str:  # compact label for debugging
        extra = f"@r{self.round}" if self.round >= 0 else ""
        peer = f"->{self.peer}" if self.peer >= 0 else ""
        return f"{self.kind}({self.gid}{peer}){extra}"


@dataclass
class EventGraph:
    """DAG of events with happens-before edges (u precedes v)."""

    events: list[Event] = field(default_factory=list)
    edges: dict[Event, list[Event]] = field(default_factory=dict)
    _index: set[Event] = field(default_factory=set)

    def add(self, ev: Event) -> Event:
        if ev not in self._index:
            self._index.add(ev)
            self.events.append(ev)
            self.edges[ev] = []
        return ev

    def before(self, u: Event, v: Event) -> None:
        self.add(u)
        self.add(v)
        self.edges[u].append(v)

    def predecessors(self) -> dict[Event, list[Event]]:
        preds: dict[Event, list[Event]] = {e: [] for e in self.events}
        for u, vs in self.edges.items():
            for v in vs:
                preds[v].append(u)
        return preds

    def topological(self) -> list[Event]:
        preds = self.predecessors()
        indeg = {e: len(ps) for e, ps in preds.items()}
        ready = [e for e in self.events if indeg[e] == 0]
        order: list[Event] = []
        while ready:
            e = ready.pop()
            order.append(e)
            for v in self.edges[e]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    ready.append(v)
        if len(order) != len(self.events):
            raise ValueError("event graph has a cycle")
        return order

    def reachable_from(self, src: Event) -> set[Event]:
        seen: set[Event] = set()
        stack = [src]
        while stack:
            e = stack.pop()
            for v in self.edges[e]:
                if v not in seen:
                    seen.add(v)
                    stack.append(v)
        return seen


def spawn_children(plan: SpawnPlan) -> dict[int, list[int]]:
    """Map gid (or SOURCE_GID) -> list of child gids in the spawn tree."""
    children: dict[int, list[int]] = {SOURCE_GID: []}
    for g in plan.groups:
        children.setdefault(g.gid, [])
        children.setdefault(g.parent_gid, []).append(g.gid)
    return children


def port_openers(plan: SpawnPlan) -> set[int]:
    """Groups whose root opens a port before spawning (paper §4.6, item 1).

    Children with ``group_id < G/2`` open ports for the binary connection
    (acceptor ids only shrink across rounds, and merged groups adopt the
    acceptor's id, so this single precomputed set covers every round);
    the source root always opens the port for the final intercomm.
    """
    n_groups = len(plan.groups)
    return {SOURCE_GID} | {g.gid for g in plan.groups if g.gid < n_groups // 2}


def build_sync_graph(plan: SpawnPlan) -> EventGraph:
    """Event graph for spawn + 3-stage synchronization (no connection yet)."""
    g = EventGraph()
    children = spawn_children(plan)
    by_gid = {gs.gid: gs for gs in plan.groups}
    openers = port_openers(plan)

    src_spawned = g.add(Event(SPAWNED, SOURCE_GID))
    g.before(src_spawned, g.add(Event(PORT_OPEN, SOURCE_GID)))

    # Spawn dependencies: a group exists only after its parent existed (and,
    # for non-source parents, after the parent opened its own port, matching
    # the listing order: open_port -> spawn).
    for gs in plan.groups:
        ev = g.add(Event(SPAWNED, gs.gid))
        parent_spawned = Event(SPAWNED, gs.parent_gid)
        g.before(parent_spawned, ev)
        if gs.gid in openers:
            g.before(ev, g.add(Event(PORT_OPEN, gs.gid)))

    # Upside: group ready after itself spawned (+port open) and all
    # children ready.
    def up_event(gid: int) -> Event:
        return Event(UP_READY, gid)

    for gid in [SOURCE_GID] + [gs.gid for gs in plan.groups]:
        up = g.add(up_event(gid))
        g.before(Event(SPAWNED, gid), up)
        if gid in openers:
            g.before(Event(PORT_OPEN, gid), up)
        for child in children.get(gid, []):
            g.before(up_event(child), up)

    # Downside: source releases after its own up_ready; each group's down
    # waits for its parent's down.
    src_down = g.add(Event(DOWN, SOURCE_GID))
    g.before(Event(UP_READY, SOURCE_GID), src_down)
    # Process groups in spawn order so parents are handled first.
    for gs in sorted(plan.groups, key=lambda x: x.step):
        down = g.add(Event(DOWN, gs.gid))
        parent_down = Event(DOWN, gs.parent_gid)
        g.before(parent_down, down)

    del by_gid
    return g


def assert_ports_before_release(graph: EventGraph, plan: SpawnPlan) -> None:
    """Structural guarantee of §4.3: every DOWN event is preceded by every
    PORT_OPEN event (so no connect — which only happens after DOWN — can
    race a port)."""
    opens = [e for e in graph.events if e.kind == PORT_OPEN]
    downs = [e for e in graph.events if e.kind == DOWN]
    for po in opens:
        reach = graph.reachable_from(po)
        for d in downs:
            if d not in reach:
                raise AssertionError(f"{po} does not precede {d}: port race!")
