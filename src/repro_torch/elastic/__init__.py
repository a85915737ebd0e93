"""Elastic runtime: the paper's control plane driving the train state on
the card (ports :mod:`repro.elastic`).

NodeGroups are the releasable hardware unit (the paper's node-confined
MCWs) over logical slots that all lie on one card; expansion runs a
parallel spawn plan to bring groups up, shrink terminates whole groups
(TS) and returns their slots, and the data-redistribution stage records
the params' new placement on the rebuilt slot mesh and its bytes.
"""
from .node_group import DevicePool, NodeGroup, Slot, device_slots
from .reshard import (
    Placement,
    PytreeBytesModel,
    predicted_transfer_stats,
    reshard_tree,
    transfer_stats,
)
from .rms import Event, EventKind, SimulatedRMS
from .runtime import ElasticRuntime, ReconfigRecord
from .trainer import ElasticTrainer, StepRecord

__all__ = [
    "DevicePool",
    "ElasticRuntime",
    "ElasticTrainer",
    "Event",
    "EventKind",
    "NodeGroup",
    "Placement",
    "PytreeBytesModel",
    "ReconfigRecord",
    "SimulatedRMS",
    "Slot",
    "StepRecord",
    "device_slots",
    "predicted_transfer_stats",
    "reshard_tree",
    "transfer_stats",
]
