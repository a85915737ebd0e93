"""Binary connection between spawned groups (paper §4.4, Listing 2).

Once all ports are known to be open, the G spawned groups merge pairwise
in ceil(log2 G) rounds.  Each round with ``groups`` active ids:

    middle     = groups // 2
    new_groups = groups - middle
    id <  middle      -> MPI_Comm_accept  (keeps its id)
    id >= new_groups  -> MPI_Comm_connect to id' = groups - id - 1,
                         then adopts id'
    middle == id < new_groups (odd count) -> idles this round

so after the round exactly ``new_groups`` ids remain; the process repeats
until one group holds every spawned rank.
"""
from __future__ import annotations

from dataclasses import dataclass

from .sync import CONNECT, DOWN, MERGED, PORT_OPEN, Event, EventGraph
from .types import SpawnPlan


@dataclass(frozen=True)
class ConnectRound:
    index: int
    # (acceptor_id, connector_id) pairs; ids are *current* ids, i.e. the
    # representative (lowest/acceptor) id of each already-merged set.
    pairs: tuple[tuple[int, int], ...]
    idle: tuple[int, ...]


def binary_connection_schedule(n_groups: int) -> list[ConnectRound]:
    """Pairing schedule of §4.4 for ``n_groups`` spawned groups."""
    rounds: list[ConnectRound] = []
    groups = n_groups
    idx = 0
    while groups > 1:
        middle = groups // 2
        new_groups = groups - middle
        pairs = tuple((i, groups - 1 - i) for i in range(middle))
        idle = tuple(range(middle, new_groups)) if groups % 2 else ()
        rounds.append(ConnectRound(index=idx, pairs=pairs, idle=idle))
        groups = new_groups
        idx += 1
    return rounds


def simulate_merges(n_groups: int) -> dict[int, list[int]]:
    """Run the schedule symbolically; return final {representative: members}.

    Verifies the §4.4 invariant that the procedure converges to a single
    group containing every original gid exactly once.
    """
    members: dict[int, list[int]] = {i: [i] for i in range(n_groups)}
    for rnd in binary_connection_schedule(n_groups):
        merged: dict[int, list[int]] = {}
        consumed: set[int] = set()
        for acc, conn in rnd.pairs:
            merged[acc] = members[acc] + members[conn]
            consumed.update((acc, conn))
        for i in rnd.idle:
            merged[i] = members[i]
            consumed.add(i)
        # ids not mentioned this round keep their sets (only happens when
        # n==1 upfront).
        for i, m in members.items():
            if i not in consumed:
                merged[i] = m
        members = merged
    return members


def required_ports(n_groups: int) -> set[int]:
    """Ids that act as acceptor in at least one round.

    Equals {0 .. n_groups//2 - 1}, the ``group_id < (groups-I)/2`` port-
    opening condition in Listing 4 — asserted by tests.
    """
    ports: set[int] = set()
    for rnd in binary_connection_schedule(n_groups):
        ports.update(acc for acc, _ in rnd.pairs)
    return ports


def extend_graph_with_connection(graph: EventGraph, plan: SpawnPlan) -> EventGraph:
    """Append binary-connection events to a §4.3 sync graph.

    Every pair's CONNECT waits on: both participants' DOWN release, the
    acceptor's PORT_OPEN, and both participants' previous-round MERGED
    event.  This encodes Listing 2's loop structure.
    """
    n_groups = len(plan.groups)
    schedule = binary_connection_schedule(n_groups)
    # representative id -> MERGED event of the round it last participated in
    last_merge: dict[int, Event] = {}

    def down_of(gid: int) -> Event:
        return Event(DOWN, gid)

    for rnd in schedule:
        for acc, conn in rnd.pairs:
            c = graph.add(Event(CONNECT, conn, round=rnd.index, peer=acc))
            m = graph.add(Event(MERGED, acc, round=rnd.index, peer=conn))
            graph.before(Event(PORT_OPEN, acc), c)
            for gid in (acc, conn):
                graph.before(down_of(gid), c)
                if gid in last_merge:
                    graph.before(last_merge[gid], c)
            graph.before(c, m)
            last_merge[acc] = m
            last_merge.pop(conn, None)
    return graph
