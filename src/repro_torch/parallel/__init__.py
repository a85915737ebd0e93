"""Logical-axis sharding (ports :mod:`repro.parallel.sharding`) on a slot
mesh or on the ranks of a ``torch.distributed`` world, and the
collectives the mesh path runs over."""
from .sharding import (
    ACT_RULES,
    WEIGHT_RULES,
    Mesh,
    NamedSharding,
    ProcessMesh,
    ShardingContext,
    constrain,
    current_context,
    mesh_of,
    param_sharding,
    param_shardings,
    param_specs,
    resolve_spec,
    use_sharding,
)

__all__ = [
    "ACT_RULES",
    "WEIGHT_RULES",
    "Mesh",
    "NamedSharding",
    "ProcessMesh",
    "ShardingContext",
    "constrain",
    "current_context",
    "mesh_of",
    "param_sharding",
    "param_shardings",
    "param_specs",
    "resolve_spec",
    "use_sharding",
]
