"""Logical-axis sharding on a slot mesh (ports :mod:`repro.parallel.sharding`'s rules)."""
from .sharding import (
    ACT_RULES,
    WEIGHT_RULES,
    Mesh,
    NamedSharding,
    ShardingContext,
    mesh_of,
    param_shardings,
    param_specs,
    resolve_spec,
)

__all__ = [
    "ACT_RULES",
    "WEIGHT_RULES",
    "Mesh",
    "NamedSharding",
    "ShardingContext",
    "mesh_of",
    "param_shardings",
    "param_specs",
    "resolve_spec",
]
