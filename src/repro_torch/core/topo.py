"""Topology-aware spawning strategy: rack-local placement, rack-vacating
shrinks.

The paper's two testbeds differ mainly in node layout, and its shrink
advantage comes from returning whole allocation units to the RMS.  This
module makes that a *strategy* decision:

* **spawn structure** — groups are spawned with the iterative diffusive
  rounds (§4.2: the vector-capable parallel strategy), so the charged
  spawn/sync/connect timeline is identical to ``diffusive`` for the same
  allocation vector.  What changes is *which nodes end up in the
  vector*:
* **expansion placement** (:func:`place_rack_local`) — free nodes inside
  racks the job already occupies come first (most-occupied rack first),
  then fresh racks are packed whole (pod-local and fullest-first), so
  later shrinks can vacate complete racks;
* **shrink placement** (:func:`vacate_racks`) — victims are chosen so
  whole racks empty first, handing the RMS back rack-granular capacity
  exactly as TS hands back node-granular worlds.

Registered under the key ``"topo"`` through the ordinary third-party
extension point (:func:`repro_torch.core.engine.register_strategy`): the
simulator, the live runtime, the trainer, and the benchmarks all pick it
up from the registry with no further wiring.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Iterable, Union

from .diffusive import plan_diffusive
from .engine import (
    StrategySpec,
    as_core_vector,
    register_strategy,
    running_vector,
)
from .topology import Topology
from .types import Method, SpawnPlan

TOPO_KEY = "topo"


# ------------------------------------------------------------- placement --
def place_rack_local(
    topology: Topology,
    used: set[int],
    free: set[int],
    need: int,
) -> list[int]:
    """Choose ``need`` free nodes for an expansion, rack-local-first.

    Order of preference:

    1. free nodes in racks the job already occupies (most-occupied rack
       first, node ids ascending within a rack) — new groups land next
       to their sources;
    2. fresh racks, packed whole: racks in pods the job already touches
       first, then racks with the most free nodes (a fresh rack the
       expansion can fill completely stays whole for a later
       rack-granular shrink), rack id as the final tiebreak;
    3. any remaining free nodes in id order (safety net — only reachable
       when the topology does not cover every pool node).

    Returns the chosen node ids in fill order (the plan's allocation
    vector tail).  Raises if the pool cannot satisfy the request.
    """
    if need <= 0:
        return []
    remaining_free = set(free)
    chosen: list[int] = []

    occupancy: dict[int, int] = {}
    for n in used:
        rack = topology.rack_of(n)
        occupancy[rack] = occupancy.get(rack, 0) + 1

    def take_rack(rack: int) -> None:
        for n in topology.nodes_in_rack(rack):
            if len(chosen) >= need:
                return
            if n in remaining_free:
                chosen.append(n)
                remaining_free.discard(n)

    for rack in sorted(occupancy, key=lambda r: (-occupancy[r], r)):
        take_rack(rack)
        if len(chosen) >= need:
            return chosen

    used_pods = {topology.pod_of_rack(r) for r in occupancy}

    def fresh_key(rack: int) -> tuple[int, int, int]:
        n_free = sum(
            1 for n in topology.nodes_in_rack(rack) if n in remaining_free
        )
        return (0 if topology.pod_of_rack(rack) in used_pods else 1,
                -n_free, rack)

    fresh = [r for r in range(topology.n_racks) if r not in occupancy]
    for rack in sorted(fresh, key=fresh_key):
        take_rack(rack)
        if len(chosen) >= need:
            return chosen

    for n in sorted(remaining_free):
        if len(chosen) >= need:
            return chosen
        chosen.append(n)
    if len(chosen) < need:
        raise RuntimeError(
            f"placement needs {need} free nodes, pool has {len(free)}"
        )
    return chosen


def vacate_racks(
    topology: Topology,
    used: set[int],
    n_release: int,
) -> list[int]:
    """Choose ``n_release`` victims so whole racks empty first.

    Whole racks whose used-node count fits the remaining release budget
    go first (fewest used nodes first — the cheapest racks to hand back
    complete — rack id descending as the tiebreak, matching the default
    highest-id-first release flavour); any remainder comes from the
    least-occupied surviving rack, highest node ids first.  Returns the
    victim ids sorted ascending (the shrink planner takes a set).

    Deliberately fewest-first, NOT best-fit: when the budget exactly
    matches a larger rack's occupancy, this policy still empties the
    small racks and fragments the large one — trading one fragmented
    rack for keeping the job's biggest rack partially occupied, which
    is what lets the next expansion land rack-local
    (:func:`place_rack_local`) instead of reopening a vacated rack
    cross-rack.  A placement optimizer weighing the two objectives
    against the trace is a ROADMAP follow-up.
    """
    if n_release <= 0:
        return []
    by_rack: dict[int, list[int]] = {}
    for n in sorted(used):
        by_rack.setdefault(topology.rack_of(n), []).append(n)

    victims: list[int] = []
    remaining = min(n_release, len(used))
    racks = sorted(by_rack, key=lambda r: (len(by_rack[r]), -r))
    for rack in racks:
        if remaining <= 0:
            break
        if len(by_rack[rack]) <= remaining:
            victims.extend(by_rack[rack])
            remaining -= len(by_rack[rack])
            by_rack[rack] = []
    if remaining > 0:
        rest = sorted((r for r in racks if by_rack[r]),
                      key=lambda r: (len(by_rack[r]), -r))
        for rack in rest:
            if remaining <= 0:
                break
            take = by_rack[rack][len(by_rack[rack]) - remaining:]
            victims.extend(take)
            remaining -= len(take)
    return sorted(victims)


# --------------------------------------------------------------- planner --
def plan_topo(
    ns: int,
    nt: int,
    cores: Union[int, Iterable[int]],
    method: Method = Method.MERGE,
) -> SpawnPlan:
    """Topology-aware spawn plan (normalized ``(ns, nt, cores, method)``).

    The allocation vector arrives already in placement order (sources
    first, then :func:`place_rack_local`'s fill order — the engine's
    ``select_expansion_nodes`` produced it), so the spawn structure is
    the iterative diffusive plan over that vector, re-tagged with this
    strategy's registry key.  Charged cost equals ``diffusive`` on the
    same vector; what the strategy changes is where the vector's nodes
    live — and therefore which distance class every stage-3 byte pays.
    """
    a_vec = as_core_vector(
        cores if isinstance(cores, int) else list(cores), nt
    )
    plan = plan_diffusive(a_vec, running_vector(a_vec, ns), method)
    return replace(plan, strategy=TOPO_KEY)


register_strategy(StrategySpec(
    key=TOPO_KEY,
    planner=plan_topo,
    parallel=True,
    topology_aware=True,
    description=("diffusive spawn rounds with rack/pod-local placement; "
                 "shrinks vacate whole racks"),
))
