"""Decoder assembly: the dense branches of :mod:`repro.models.transformer`.

Training/prefill walk the stacked per-layer params with a Python loop
(the JAX package's ``lax.scan``); decode walks the layers over per-layer
cache slices.  Families other than the dense ones raise
``NotImplementedError`` naming their ROADMAP.md item.

Families ported:
  dense   — [attn, mlp] x L     (gemma2: alternating sliding window + softcap)
  audio / vlm — the dense stack over precomputed embeddings / M-RoPE
"""
from __future__ import annotations

from typing import Optional

import torch

from .common import ModelConfig, ParamBuilder, stack_params, torch_dtype
from .layers import attention, init_attention, init_mlp, init_rmsnorm, mlp, rmsnorm

DENSE_FAMILIES = ("dense", "audio", "vlm")
_TODO = {
    "moe": "MoE layers are not ported yet: ROADMAP.md A12",
    "hybrid": "the hybrid Mamba2 family is not ported yet: ROADMAP.md A13",
    "ssm": "the xLSTM family is not ported yet: ROADMAP.md A14",
}


def _require_dense(cfg: ModelConfig):
    if cfg.family not in DENSE_FAMILIES:
        raise NotImplementedError(_TODO.get(cfg.family, f"unknown family {cfg.family!r}"))


# ---------------------------------------------------------------------------
# Per-layer inits
# ---------------------------------------------------------------------------


def _init_dense_layer(generator: torch.Generator, cfg: ModelConfig):
    b = ParamBuilder(generator, torch_dtype(cfg.param_dtype))
    init_rmsnorm(b, "ln_attn", cfg.d_model)
    init_attention(b, "attn", cfg)
    init_rmsnorm(b, "ln_mlp", cfg.d_model)
    init_mlp(b, "mlp", cfg.d_model, cfg.d_ff)
    return b.build()


def init_blocks(generator: torch.Generator, cfg: ModelConfig) -> tuple[dict, dict]:
    """Stacked block params (leading ``layers`` axis) + their logical axes."""
    _require_dense(cfg)
    stacked, st_specs = stack_params(
        [_init_dense_layer(generator, cfg) for _ in range(cfg.n_layers)]
    )
    return ({f"blocks/{k}": v for k, v in stacked.items()},
            {f"blocks/{k}": v for k, v in st_specs.items()})


# ---------------------------------------------------------------------------
# Forward (train / prefill): loop over layers
# ---------------------------------------------------------------------------


def _layer_windows(cfg: ModelConfig) -> Optional[list[int]]:
    """Per-layer sliding window sizes (0 = full attention)."""
    if not cfg.sliding_window:
        return None
    if cfg.alt_local_global:
        return [cfg.sliding_window if i % 2 == 0 else 0 for i in range(cfg.n_layers)]
    return [cfg.sliding_window] * cfg.n_layers


def _split_stacked(params: dict, prefix: str, dtype=None) -> dict:
    """Extract a sub-dict; optionally cast floating params to the compute
    dtype once here (a no-op for params already in it)."""
    plen = len(prefix)
    out = {k[plen:]: v for k, v in params.items() if k.startswith(prefix)}
    if dtype is not None:
        out = {k: (v.to(dtype) if v.is_floating_point() else v) for k, v in out.items()}
    return out


def _dense_block(layer_params, cfg, x, positions, window, collect_kv):
    h = rmsnorm(layer_params, "ln_attn", x, cfg.norm_eps)
    attn_out, kv = attention(
        layer_params, "attn", cfg, h, positions, window=window,
        collect_kv=collect_kv,
    )
    x = x + attn_out
    h = rmsnorm(layer_params, "ln_mlp", x, cfg.norm_eps)
    x = x + mlp(layer_params, "mlp", h)
    return x, kv


def forward_blocks(params, cfg: ModelConfig, x, positions, collect_kv=False):
    """x: (B,S,d) post-embedding.  Returns (y, caches-or-None); caches are
    ``(k, v)``, each stacked over layers: (L, B, S, KV, hd)."""
    _require_dense(cfg)
    stacked = _split_stacked(params, "blocks/", cfg.compute_dtype)
    windows = _layer_windows(cfg)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in stacked.items()}
        window = None if windows is None else windows[i]
        x, kv = _dense_block(lp, cfg, x, positions, window, collect_kv)
        if collect_kv:
            ks.append(kv[0])
            vs.append(kv[1])
    if collect_kv:
        return x, (torch.stack(ks), torch.stack(vs))
    return x, None


# ---------------------------------------------------------------------------
# Decode: layer loop over per-layer cache slices
# ---------------------------------------------------------------------------


def decode_blocks(params, cfg: ModelConfig, x, positions, cache: dict, cache_pos: int):
    """One decode step.  x: (B,1,d).  cache: stacked per-layer dict, written
    in place (the JAX package returns a new one).  Returns (y, cache)."""
    _require_dense(cfg)
    stacked = _split_stacked(params, "blocks/")
    windows = _layer_windows(cfg)
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in stacked.items()}
        layer_cache = {"k": cache["k"][i], "v": cache["v"][i]}
        window = None if windows is None else windows[i]
        h = rmsnorm(lp, "ln_attn", x, cfg.norm_eps)
        attn_out, _ = attention(
            lp, "attn", cfg, h, positions, window=window,
            cache=layer_cache, cache_pos=cache_pos,
        )
        x = x + attn_out
        h = rmsnorm(lp, "ln_mlp", x, cfg.norm_eps)
        x = x + mlp(lp, "mlp", h)
    return x, cache


# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------


def init_cache_shapes(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """Abstract cache spec: name -> (shape, dtype, logical_axes, fill).

    Where the JAX package gives gemma2's local layers window-sized ring
    caches (a window shorter than ``max_len``), this raises: not ported.
    """
    _require_dense(cfg)
    if cfg.alt_local_global and 0 < cfg.sliding_window < max_len:
        raise NotImplementedError(
            "ring KV caches (gemma2 local layers) are not ported yet: ROADMAP.md A11")
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    kv_axes = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    return {"k": (shape, cfg.dtype, kv_axes, 0.0), "v": (shape, cfg.dtype, kv_axes, 0.0)}
