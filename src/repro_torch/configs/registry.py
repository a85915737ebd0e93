"""Registry of the ten assigned architectures and their shape cells."""
from __future__ import annotations

import importlib
from dataclasses import dataclass

from repro_torch.models.common import ModelConfig

ARCHS: tuple[str, ...] = (
    "zamba2_1p2b",
    "stablelm_3b",
    "yi_34b",
    "command_r_plus_104b",
    "gemma2_9b",
    "phi35_moe_42b",
    "llama4_scout_17b",
    "musicgen_medium",
    "qwen2_vl_7b",
    "xlstm_125m",
)

# Canonical --arch aliases (hyphenated ids from the assignment).
ALIASES = {
    "zamba2-1.2b": "zamba2_1p2b",
    "stablelm-3b": "stablelm_3b",
    "yi-34b": "yi_34b",
    "command-r-plus-104b": "command_r_plus_104b",
    "gemma2-9b": "gemma2_9b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "llama4-scout-17b-a16e": "llama4_scout_17b",
    "musicgen-medium": "musicgen_medium",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "xlstm-125m": "xlstm_125m",
}


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str       # train | prefill | decode | long_decode


SHAPES: tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "long_decode"),
)

# Archs with a sub-quadratic path for long_500k (SSM / hybrid / local+global
# alternating).  Pure full-attention archs skip that cell (DESIGN.md).
LONG_OK = {"zamba2_1p2b", "gemma2_9b", "xlstm_125m"}


def arch_config(name: str) -> ModelConfig:
    name = ALIASES.get(name, name)
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS) + sorted(ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.CONFIG


def smoke_config(name: str) -> ModelConfig:
    name = ALIASES.get(name, name)
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.SMOKE


def shape_skip_reason(arch: str, shape: ShapeCell) -> str | None:
    arch = ALIASES.get(arch, arch)
    if shape.kind == "long_decode" and arch not in LONG_OK:
        return "pure full-attention arch: 500k dense decode has no sub-quadratic path (DESIGN.md shape/skip policy)"
    return None


def input_shapes(arch: str) -> list[ShapeCell]:
    return [s for s in SHAPES if shape_skip_reason(arch, s) is None]
