"""input_specs(): abstract stand-ins for every (arch x shape) cell's inputs.

Ports :mod:`repro.launch.specs`: the same keys, shapes and dtypes, as
tensors on the ``meta`` device (the counterpart of
``jax.ShapeDtypeStruct``: shapes and dtypes, nothing allocated).  They
are global shapes; the dry run cuts each to a rank's shard.  Modality
frontends ([audio]/[vlm]) are stubs: the spec supplies precomputed
frame/patch embeddings.
"""
from __future__ import annotations

import torch

from repro_torch.configs.registry import ShapeCell
from repro_torch.models.common import ModelConfig


def _abstract(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def sharding_mode(shape: ShapeCell) -> str:
    """The activation rules a cell runs under: a prefill in train mode, as
    the JAX package's prefill cell does."""
    return {"train": "train", "prefill": "train",
            "decode": "decode", "long_decode": "long"}[shape.kind]


def train_batch_specs(cfg: ModelConfig, batch: int, seq: int) -> dict:
    out = {"labels": _abstract((batch, seq), torch.int32)}
    if cfg.embed_inputs:
        out["embeds"] = _abstract((batch, seq, cfg.d_model), torch.float32)
    else:
        out["tokens"] = _abstract((batch, seq), torch.int32)
    if cfg.mrope_sections:
        out["positions"] = _abstract((3, batch, seq), torch.int32)
    return out


def decode_tok_specs(cfg: ModelConfig, batch: int) -> dict:
    out = {"cache_pos": _abstract((), torch.int32)}
    if cfg.embed_inputs:
        out["embeds"] = _abstract((batch, 1, cfg.d_model), torch.float32)
    else:
        out["tokens"] = _abstract((batch, 1), torch.int32)
    if cfg.mrope_sections:
        out["positions"] = _abstract((3, batch, 1), torch.int32)
    else:
        out["positions"] = _abstract((batch, 1), torch.int32)
    return out


def input_specs(cfg: ModelConfig, shape: ShapeCell) -> dict:
    """All abstract inputs for the given cell (excluding model state)."""
    if shape.kind in ("train", "prefill"):
        return train_batch_specs(cfg, shape.global_batch, shape.seq_len)
    return decode_tok_specs(cfg, shape.global_batch)
