"""NodeGroups: the releasable allocation unit of the elastic runtime.

Ports :mod:`repro.elastic.node_group`.  A NodeGroup is the analogue of
the paper's node-confined MCW — a set of slots that is acquired and
released *as a unit*, which is exactly the property TS shrinkage needs.
A slot (:class:`Slot`) is a logical device: an integer id and the
``torch.device`` it computes on.  One card holds every slot of a pool
(:func:`device_slots`), as the JAX package's tests fabricate host
devices: the pool is the cluster's bookkeeping, and the card computes
each world's whole batch.  Nodes need not be the same
width: the pool accepts an explicit per-node width vector (the paper's
§5.3 NASP testbed alternates 20- and 32-core nodes), and because worlds
stay node-confined, a shrink still returns *complete* nodes to the RMS
whatever their width.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch

from repro_torch.core.topology import Topology
from repro_torch.device import DeviceLike, resolve_device


@dataclass(frozen=True)
class Slot:
    """One logical device: its id in the pool and where it computes."""

    id: int
    device: torch.device


def device_slots(n: int, device: DeviceLike = None) -> list[Slot]:
    """``n`` slots with ids ``0..n-1``, all on ``device`` (``None``: the
    card, through :func:`~repro_torch.device.resolve_device`)."""
    dev = resolve_device(device)
    return [Slot(i, dev) for i in range(n)]


@dataclass(frozen=True)
class NodeGroup:
    """One node-confined worker group (the paper's per-node MCW)."""

    gid: int                 # group id (stable across its lifetime)
    node: int                # node index in the cluster
    devices: tuple[Any, ...]  # slots owned by this group

    @property
    def size(self) -> int:
        return len(self.devices)


class DevicePool:
    """Partition of a list of slots into "nodes", uniform or uneven.

    The pool plays the RMS's role of owning idle nodes: `acquire` hands a
    node's devices to a new group, `release` (the TS path) returns them.

    Args:
        devices: slots to partition (default: one slot on the card,
            ``device_slots(1)``).
        devices_per_node: uniform node width; node ``i`` owns devices
            ``[i*w, (i+1)*w)`` (leftover devices are ignored).
        node_widths: explicit per-node width vector (the heterogeneous
            A vector, e.g. ``(20, 32, 20, 32)``); node ``i`` owns the
            next ``node_widths[i]`` devices in pool order.  Mutually
            exclusive with a non-default ``devices_per_node``; raises
            if the vector needs more devices than the pool holds.
        topology: optional :class:`~repro_torch.core.topology.Topology`
            (node -> rack -> pod tree) over this pool's node ids; must
            cover every node exactly.  Placement-aware engines read it
            via :meth:`rack_of`; ``None`` behaves as a single rack.
    """

    def __init__(
        self,
        devices: Sequence[Any] | None = None,
        devices_per_node: int = 1,
        node_widths: Optional[Sequence[int]] = None,
        topology: Optional[Topology] = None,
    ):
        devices = list(devices if devices is not None else device_slots(1))
        if node_widths is not None:
            if devices_per_node != 1:
                raise ValueError(
                    "pass either devices_per_node or node_widths, not both"
                )
            widths = [int(w) for w in node_widths]
            if not widths or any(w <= 0 for w in widths):
                raise ValueError(
                    f"node_widths must be a non-empty sequence of positive "
                    f"ints, got {tuple(node_widths)}"
                )
            if sum(widths) > len(devices):
                raise ValueError(
                    f"node_widths {tuple(widths)} needs {sum(widths)} "
                    f"devices, pool only has {len(devices)}"
                )
        else:
            if devices_per_node <= 0:
                raise ValueError("devices_per_node must be positive")
            widths = [devices_per_node] * (len(devices) // devices_per_node)
        self.node_widths: tuple[int, ...] = tuple(widths)
        if topology is not None and topology.n_nodes != len(widths):
            raise ValueError(
                f"topology covers {topology.n_nodes} nodes but the pool "
                f"partitions into {len(widths)}; rack_sizes must match "
                "the node count exactly"
            )
        self.topology: Optional[Topology] = topology
        self.nodes: dict[int, tuple[Any, ...]] = {}
        offset = 0
        for i, w in enumerate(widths):
            self.nodes[i] = tuple(devices[offset:offset + w])
            offset += w
        self.free: set[int] = set(self.nodes)

    @property
    def n_nodes(self) -> int:
        return len(self.nodes)

    @property
    def uniform(self) -> bool:
        """True when every node has the same width (the MN5 case)."""
        return len(set(self.node_widths)) <= 1

    @property
    def devices_per_node(self) -> int:
        """Uniform node width; raises on an uneven pool (use ``width``)."""
        widths = set(self.node_widths)
        if len(widths) > 1:
            raise ValueError(
                f"pool is uneven ({self.node_widths}); devices_per_node is "
                "undefined — use width(node) / node_widths instead"
            )
        return widths.pop() if widths else 1

    def width(self, node: int) -> int:
        """Devices owned by ``node`` (its entry in the A vector)."""
        return len(self.nodes[node])

    def rack_of(self, node: int) -> int:
        """Rack owning ``node`` (0 for the whole pool without a topology)."""
        if node not in self.nodes:
            raise KeyError(node)
        return 0 if self.topology is None else self.topology.rack_of(node)

    def total_devices(self) -> int:
        return sum(self.node_widths)

    def acquire(self, node: int) -> tuple[Any, ...]:
        if node not in self.free:
            raise RuntimeError(f"node {node} is not free")
        self.free.discard(node)
        return self.nodes[node]

    def acquire_any(self) -> tuple[int, tuple[Any, ...]]:
        if not self.free:
            raise RuntimeError("device pool exhausted")
        node = min(self.free)
        return node, self.acquire(node)

    def release(self, node: int) -> None:
        if node not in self.nodes:
            raise KeyError(node)
        self.free.add(node)
