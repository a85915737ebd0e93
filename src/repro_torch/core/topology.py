"""Cluster topology: the node -> rack -> pod tree placement prices against.

The paper's two testbeds differ mainly in node layout (§5.1: MN5's
InfiniBand fat-tree vs NASP's flat 10 GbE), and its shrink advantage
comes from returning *whole* allocation units to the RMS.  This module
gives the stack a first-class layout object:

* :class:`Topology` — an explicit tree over node ids.  Racks may be
  uneven (different node counts), and racks may optionally be grouped
  into pods; node ids are assigned to racks in prefix order, exactly how
  :class:`~repro_torch.elastic.node_group.DevicePool` numbers its nodes.
* **distance classes** — every (source node, destination node) pair
  resolves to one of :data:`DISTANCE_CLASSES`; the
  :class:`~repro_torch.malleability.cost_model.CostModel` prices each class
  with its own bandwidth, and the
  :class:`~repro_torch.core.engine.ReconfigEngine` charges every stage-3 byte
  on the class between its source and destination ranks.

A pool without an explicit topology behaves as ONE rack: every moved
byte is ``intra_rack``, which is exactly the PR-4 local/cross split
(``intra_rack`` falls back to the cross-link bandwidth), so untopologized
configurations reproduce the previous numbers bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass

# Stage-3 transfer classes, nearest first.  ``intra_node`` is data a
# surviving device already holds (the former ``bytes_stayed`` /
# local-link volume); ``intra_rack`` / ``cross_rack`` split the former
# cross-link ``bytes_moved`` by whether the transfer leaves its rack;
# ``cross_pod`` is the slice of ``cross_rack`` that additionally leaves
# its pod (only ever non-zero on a topology with ``pod_sizes`` set).
DISTANCE_CLASSES: tuple[str, ...] = (
    "intra_node", "intra_rack", "cross_rack", "cross_pod")


def split_bytes_by_class(bytes_stayed: int, bytes_moved: int,
                         bytes_cross_rack: int,
                         bytes_cross_pod: int = 0) -> dict[str, int]:
    """The canonical stayed/moved/cross-rack/cross-pod class split.

    Every ``bytes_by_class`` report (timeline events, timelines,
    redistribution specs, runtime and scenario records) delegates here,
    so the class accounting can only ever change in one place.  The
    values always sum to ``bytes_stayed + bytes_moved``.

    ``bytes_cross_pod`` is a *refinement* of ``bytes_cross_rack`` (a
    pod-crossing transfer necessarily crosses racks), so the reported
    ``cross_rack`` entry is the pod-local remainder.
    """
    return {
        "intra_node": bytes_stayed,
        "intra_rack": bytes_moved - bytes_cross_rack,
        "cross_rack": bytes_cross_rack - bytes_cross_pod,
        "cross_pod": bytes_cross_pod,
    }


@dataclass(frozen=True)
class Topology:
    """Node -> rack -> pod tree with prefix node numbering.

    Args:
        rack_sizes: nodes per rack (uneven widths allowed); rack ``r``
            owns the next ``rack_sizes[r]`` node ids in order, mirroring
            how ``DevicePool`` assigns devices to nodes.
        pod_sizes: optional racks per pod (prefix assignment over rack
            ids); must sum to ``len(rack_sizes)`` when given.  Pods are
            a placement preference (the ``topo`` strategy opens fresh
            racks pod-locally) *and* a pricing boundary: with pods set,
            rack-crossing transfers that also leave their pod resolve
            to the ``cross_pod`` class.  Without pods every rack is its
            own pod and ``cross_pod`` never appears — the 3-class
            behaviour, bit for bit.
    """

    rack_sizes: tuple[int, ...]
    pod_sizes: tuple[int, ...] = ()

    def __post_init__(self) -> None:
        if not self.rack_sizes or any(s <= 0 for s in self.rack_sizes):
            raise ValueError(
                f"rack_sizes must be non-empty positive ints, got "
                f"{self.rack_sizes}"
            )
        if self.pod_sizes:
            if any(s <= 0 for s in self.pod_sizes):
                raise ValueError(
                    f"pod_sizes must be positive ints, got {self.pod_sizes}"
                )
            if sum(self.pod_sizes) != len(self.rack_sizes):
                raise ValueError(
                    f"pod_sizes {self.pod_sizes} must cover the "
                    f"{len(self.rack_sizes)} racks exactly"
                )

    # ---- constructors -------------------------------------------------------
    @classmethod
    def uniform(cls, n_racks: int, nodes_per_rack: int,
                racks_per_pod: int = 0) -> "Topology":
        """Evenly-sized racks (and optionally pods); the MN5-like case."""
        if n_racks <= 0 or nodes_per_rack <= 0:
            raise ValueError("n_racks and nodes_per_rack must be positive")
        pods: tuple[int, ...] = ()
        if racks_per_pod:
            if n_racks % racks_per_pod:
                raise ValueError(
                    f"{n_racks} racks do not divide into pods of "
                    f"{racks_per_pod}"
                )
            pods = (racks_per_pod,) * (n_racks // racks_per_pod)
        return cls(rack_sizes=(nodes_per_rack,) * n_racks, pod_sizes=pods)

    @classmethod
    def single_rack(cls, n_nodes: int) -> "Topology":
        """Everything in one rack: the degenerate (pre-topology) layout."""
        return cls(rack_sizes=(n_nodes,))

    # ---- queries ------------------------------------------------------------
    @property
    def n_nodes(self) -> int:
        return sum(self.rack_sizes)

    @property
    def n_racks(self) -> int:
        return len(self.rack_sizes)

    def rack_of(self, node: int) -> int:
        """Rack id owning ``node`` (raises on out-of-range ids)."""
        if node < 0:
            raise ValueError(f"negative node id {node}")
        offset = 0
        for rack, size in enumerate(self.rack_sizes):
            offset += size
            if node < offset:
                return rack
        raise ValueError(
            f"node {node} outside this {self.n_nodes}-node topology"
        )

    def nodes_in_rack(self, rack: int) -> tuple[int, ...]:
        """Node ids owned by ``rack``, ascending."""
        start = sum(self.rack_sizes[:rack])
        return tuple(range(start, start + self.rack_sizes[rack]))

    def pod_of_rack(self, rack: int) -> int:
        """Pod id owning ``rack`` (rack id itself when pods are unset)."""
        if not 0 <= rack < self.n_racks:
            raise ValueError(f"rack {rack} outside {self.n_racks} racks")
        if not self.pod_sizes:
            return rack
        offset = 0
        for pod, size in enumerate(self.pod_sizes):
            offset += size
            if rack < offset:
                return pod
        raise AssertionError("pod_sizes validated to cover all racks")

    def pod_of(self, node: int) -> int:
        return self.pod_of_rack(self.rack_of(node))

    def distance_class(self, src_node: int, dst_node: int) -> str:
        """Transfer class between two nodes (one of DISTANCE_CLASSES).

        ``cross_pod`` is only ever returned when ``pod_sizes`` is set:
        without pods, ``pod_of_rack`` degenerates to the rack id, which
        would misclassify every rack crossing as a pod crossing.
        """
        if src_node == dst_node:
            return "intra_node"
        if self.rack_of(src_node) == self.rack_of(dst_node):
            return "intra_rack"
        if self.pod_sizes and self.pod_of(src_node) != self.pod_of(dst_node):
            return "cross_pod"
        return "cross_rack"
