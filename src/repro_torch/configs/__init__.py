"""Assigned architecture configs (exact sizes from public literature).

Every arch is selectable via ``--arch <id>``; ``smoke_config`` returns a
reduced same-family variant for CPU tests; ``input_shapes`` enumerates
the four assigned input-shape cells per arch (with documented skips).
"""
from .registry import (
    ARCHS,
    SHAPES,
    arch_config,
    input_shapes,
    shape_skip_reason,
    smoke_config,
)

__all__ = [
    "ARCHS",
    "SHAPES",
    "arch_config",
    "input_shapes",
    "shape_skip_reason",
    "smoke_config",
]
