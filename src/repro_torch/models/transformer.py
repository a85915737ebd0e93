"""Decoder assembly: the dense, hybrid and xLSTM branches of
:mod:`repro.models.transformer`.

Training/prefill walk the stacked per-layer params with a Python loop
(the JAX package's ``lax.scan``); decode walks the layers over per-layer
cache slices.  With ``cfg.remat`` and grad enabled, each dense block runs
under ``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint`` with
``nothing_saveable``): its activations are recomputed in the backward.
Families not ported yet raise ``NotImplementedError`` naming their
ROADMAP.md item.

Families ported:
  dense   — [attn, mlp] x L     (gemma2: alternating sliding window + softcap)
  audio / vlm — the dense stack over precomputed embeddings / M-RoPE
  hybrid  — zamba2: Mamba2 backbone + ONE shared attn+mlp block applied
            after every ``attn_every``-th layer (weights shared)
  ssm     — xLSTM: units of ``xlstm_slstm_every - 1`` mLSTM blocks and one
            sLSTM block, stacked over units
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from .common import ModelConfig, ParamBuilder, stack_params, torch_dtype
from .layers import attention, init_attention, init_mlp, init_moe, init_rmsnorm, mlp, rmsnorm
from .ssm import init_mamba2, mamba2_block, mamba2_state_shapes
from .xlstm import (
    init_mlstm_block,
    init_slstm_block,
    mlstm_block,
    mlstm_state_shapes,
    slstm_block,
    slstm_state_shapes,
)

DENSE_FAMILIES = ("dense", "audio", "vlm")
_TODO = {
    "moe": "MoE layers are not ported yet: ROADMAP.md A12",
}
MLSTM_STATES = ("mlstm_S", "mlstm_n", "mlstm_m")
SLSTM_STATES = ("slstm_c", "slstm_n", "slstm_h", "slstm_m")


def _require_ported(cfg: ModelConfig):
    if cfg.family not in DENSE_FAMILIES + ("hybrid", "ssm"):
        raise NotImplementedError(_TODO.get(cfg.family, f"unknown family {cfg.family!r}"))


# ---------------------------------------------------------------------------
# Per-layer inits
# ---------------------------------------------------------------------------


def _init_dense_layer(generator: Optional[torch.Generator], cfg: ModelConfig):
    b = ParamBuilder(generator, torch_dtype(cfg.param_dtype))
    init_rmsnorm(b, "ln_attn", cfg.d_model)
    init_attention(b, "attn", cfg)
    init_rmsnorm(b, "ln_mlp", cfg.d_model)
    if cfg.family == "moe":
        init_moe(b, "moe", cfg)
    else:
        init_mlp(b, "mlp", cfg.d_model, cfg.d_ff)
    return b.build()


def _init_mamba_layer(generator: Optional[torch.Generator], cfg: ModelConfig):
    b = ParamBuilder(generator, torch_dtype(cfg.param_dtype))
    init_rmsnorm(b, "ln", cfg.d_model)
    init_mamba2(b, "mamba", cfg)
    return b.build()


def _init_xlstm_unit(generator: Optional[torch.Generator], cfg: ModelConfig):
    """One unit: (xlstm_slstm_every - 1) mLSTM blocks + 1 sLSTM block."""
    b = ParamBuilder(generator, torch_dtype(cfg.param_dtype))
    for i in range(cfg.xlstm_slstm_every - 1):
        init_rmsnorm(b, f"ln_m{i}", cfg.d_model)
        init_mlstm_block(b, f"mlstm{i}", cfg)
    init_rmsnorm(b, "ln_s", cfg.d_model)
    init_slstm_block(b, "slstm", cfg)
    return b.build()


def _n_units(cfg: ModelConfig) -> int:
    return cfg.n_layers // max(cfg.xlstm_slstm_every, 1)


def init_blocks(generator: Optional[torch.Generator], cfg: ModelConfig) -> tuple[dict, dict]:
    """Stacked block params (leading ``layers`` axis: layers, or xLSTM
    units) + their logical axes; for the hybrid family also the shared
    block's (not stacked).  ``generator=None`` gives :class:`ParamShape`
    records for every family, moe included."""
    if generator is not None:
        _require_ported(cfg)
    if cfg.family == "ssm":
        per_layer = [_init_xlstm_unit(generator, cfg) for _ in range(_n_units(cfg))]
    else:
        init_layer = _init_mamba_layer if cfg.family == "hybrid" else _init_dense_layer
        per_layer = [init_layer(generator, cfg) for _ in range(cfg.n_layers)]
    stacked, st_specs = stack_params(per_layer)
    params = {f"blocks/{k}": v for k, v in stacked.items()}
    specs = {f"blocks/{k}": v for k, v in st_specs.items()}
    if cfg.family == "hybrid":
        shared, sh_specs = _init_dense_layer(generator, cfg)
        params.update({f"shared_attn/{k}": v for k, v in shared.items()})
        specs.update({f"shared_attn/{k}": v for k, v in sh_specs.items()})
    return params, specs


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
    """x: (B,S,d) post-embedding.  Returns (y, caches-or-None).

    With ``collect_kv``, caches holds every entry of ``init_cache_shapes``
    that the prompt fills, stacked over layers: dense ``k``/``v``
    (L, B, S, KV, hd); hybrid ``ssm`` (L, B, H, N, P) fp32 and ``conv``
    (L, B, K-1, C), the states a decode step continues from, and the
    shared block's ``attn_k``/``attn_v`` (n_attn, B, S, KV, hd); xLSTM
    ``mlstm_S``/``mlstm_n``/``mlstm_m`` (n_units, every-1, B, H, ...) and
    ``slstm_c/n/h/m`` (n_units, B, H, dh), all fp32."""
    _require_ported(cfg)
    if cfg.family == "hybrid":
        return _forward_hybrid(params, cfg, x, positions, collect_kv)
    if cfg.family == "ssm":
        return _forward_xlstm(params, cfg, x, collect_kv)
    stacked = _split_stacked(params, "blocks/", cfg.compute_dtype)
    # unbind, not v[i]: its backward stacks the layers' grads in one
    # tensor, where L selects would each add a full-size zero tensor
    layers = {k: v.unbind(0) for k, v in stacked.items()}
    windows = _layer_windows(cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in layers.items()}
        window = None if windows is None else windows[i]
        if remat:
            x, kv = checkpoint(_dense_block, lp, cfg, x, positions, window, collect_kv,
                               use_reentrant=False)
        else:
            x, kv = _dense_block(lp, cfg, x, positions, window, collect_kv)
        if collect_kv:
            ks.append(kv[0])
            vs.append(kv[1])
    if collect_kv:
        return x, {"k": torch.stack(ks), "v": torch.stack(vs)}
    return x, None


def _applies_shared_attn(cfg: ModelConfig, i: int) -> bool:
    """The shared block follows layer i when i % attn_every == attn_every - 1."""
    every = max(cfg.attn_every, 1)
    return i % every == every - 1


def _forward_hybrid(params, cfg: ModelConfig, x, positions, collect_kv):
    stacked = _split_stacked(params, "blocks/", cfg.compute_dtype)
    shared = _split_stacked(params, "shared_attn/", cfg.compute_dtype)
    collected = {n: [] for n in ("ssm", "conv", "attn_k", "attn_v")}
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in stacked.items()}
        h = rmsnorm(lp, "ln", x, cfg.norm_eps)
        out, st = mamba2_block(lp, "mamba", cfg, h, collect_state=collect_kv)
        x = x + out
        if collect_kv:
            collected["ssm"].append(st["ssm"])
            collected["conv"].append(st["conv"])
        if _applies_shared_attn(cfg, i):
            x, kv = _dense_block(shared, cfg, x, positions, None, collect_kv)
            if collect_kv:
                collected["attn_k"].append(kv[0])
                collected["attn_v"].append(kv[1])
    if collect_kv:
        return x, {n: torch.stack(v) for n, v in collected.items() if v}
    return x, None


def _forward_xlstm(params, cfg: ModelConfig, x, collect_kv):
    stacked = _split_stacked(params, "blocks/", cfg.compute_dtype)
    every = max(cfg.xlstm_slstm_every, 1)
    mstates = {n: [] for n in MLSTM_STATES}
    sstates = {n: [] for n in SLSTM_STATES}
    for u in range(_n_units(cfg)):
        lp = {k: v[u] for k, v in stacked.items()}
        unit = []
        for i in range(every - 1):
            h = rmsnorm(lp, f"ln_m{i}", x, cfg.norm_eps)
            out, st = mlstm_block(lp, f"mlstm{i}", cfg, h, collect_state=collect_kv)
            x = x + out
            unit.append(st)
        h = rmsnorm(lp, "ln_s", x, cfg.norm_eps)
        out, st = slstm_block(lp, "slstm", cfg, h, collect_state=collect_kv)
        x = x + out
        if collect_kv:
            for j, name in enumerate(mstates):
                mstates[name].append(torch.stack([s[j] for s in unit]))
            for name, val in zip(SLSTM_STATES, st):
                sstates[name].append(val)
    if collect_kv:
        return x, {n: torch.stack(v) for n, v in (mstates | sstates).items()}
    return x, None


# ---------------------------------------------------------------------------
# Decode: layer loop over per-layer cache slices
# ---------------------------------------------------------------------------


def decode_blocks(params, cfg: ModelConfig, x, positions, cache: dict, cache_pos: int):
    """One decode step.  x: (B,1,d).  cache: stacked per-layer dict, written
    in place (the JAX package returns a new one).  Returns (y, cache)."""
    _require_ported(cfg)
    if cfg.family == "hybrid":
        return _decode_hybrid(params, cfg, x, positions, cache, cache_pos), cache
    if cfg.family == "ssm":
        return _decode_xlstm(params, cfg, x, cache), cache
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


def _decode_hybrid(params, cfg: ModelConfig, x, positions, cache: dict, cache_pos: int):
    stacked = _split_stacked(params, "blocks/")
    shared = _split_stacked(params, "shared_attn/")
    slot = 0
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in stacked.items()}
        h = rmsnorm(lp, "ln", x, cfg.norm_eps)
        st = {"ssm": cache["ssm"][i], "conv": cache["conv"][i]}
        out, new_st = mamba2_block(lp, "mamba", cfg, h, state=st)
        cache["ssm"][i] = new_st["ssm"]
        cache["conv"][i] = new_st["conv"].to(cache["conv"].dtype)
        x = x + out
        if _applies_shared_attn(cfg, i):
            layer_cache = {"k": cache["attn_k"][slot], "v": cache["attn_v"][slot]}
            h = rmsnorm(shared, "ln_attn", x, cfg.norm_eps)
            attn_out, _ = attention(shared, "attn", cfg, h, positions,
                                    cache=layer_cache, cache_pos=cache_pos)
            x = x + attn_out
            h = rmsnorm(shared, "ln_mlp", x, cfg.norm_eps)
            x = x + mlp(shared, "mlp", h)
            slot += 1
    return x


def _decode_xlstm(params, cfg: ModelConfig, x, cache: dict):
    stacked = _split_stacked(params, "blocks/")
    every = max(cfg.xlstm_slstm_every, 1)
    for u in range(_n_units(cfg)):
        lp = {k: v[u] for k, v in stacked.items()}
        for i in range(every - 1):
            h = rmsnorm(lp, f"ln_m{i}", x, cfg.norm_eps)
            st = tuple(cache[n][u, i] for n in MLSTM_STATES)
            out, new_st = mlstm_block(lp, f"mlstm{i}", cfg, h, state=st)
            for name, val in zip(MLSTM_STATES, new_st):
                cache[name][u, i] = val
            x = x + out
        h = rmsnorm(lp, "ln_s", x, cfg.norm_eps)
        out, new_st = slstm_block(lp, "slstm", cfg, h,
                                  state=tuple(cache[n][u] for n in SLSTM_STATES))
        for name, val in zip(SLSTM_STATES, new_st):
            cache[name][u] = val
        x = x + out
    return x


# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------


def init_cache_shapes(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """Abstract cache spec: name -> (shape, dtype, logical_axes, fill).

    Where the JAX package gives gemma2's local layers window-sized ring
    caches (a window shorter than ``max_len``), this raises: not ported.
    """
    _require_ported(cfg)
    dt = cfg.dtype
    kv_axes = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    if cfg.family == "hybrid":
        ssm = mamba2_state_shapes(cfg, batch)
        L = cfg.n_layers
        shape = (L // max(cfg.attn_every, 1), batch, max_len, cfg.n_kv_heads, cfg.hd)
        return {
            "ssm": ((L,) + ssm["ssm"], "float32",
                    ("layers", "batch", "ssm_heads", "ssm_state", None), 0.0),
            "conv": ((L,) + ssm["conv"], dt, ("layers", "batch", None, "ssm_inner"), 0.0),
            "attn_k": (shape, dt, kv_axes, 0.0),
            "attn_v": (shape, dt, kv_axes, 0.0),
        }
    if cfg.family == "ssm":
        every = max(cfg.xlstm_slstm_every, 1)
        lead = (_n_units(cfg), every - 1)
        m = mlstm_state_shapes(cfg, batch)
        out = {
            "mlstm_S": (lead + m["S"], "float32",
                        ("layers", None, "batch", "xlstm_heads", None, None), 0.0),
            "mlstm_n": (lead + m["n"], "float32",
                        ("layers", None, "batch", "xlstm_heads", None), 0.0),
            # the stabiliser starts at -inf, as the chunked scan's does
            "mlstm_m": (lead + m["m"], "float32",
                        ("layers", None, "batch", "xlstm_heads"), float("-inf")),
        }
        s = slstm_state_shapes(cfg, batch)[0]
        for name in SLSTM_STATES:
            out[name] = ((_n_units(cfg),) + s, "float32",
                         ("layers", "batch", "xlstm_heads", None), 0.0)
        return out
    if cfg.alt_local_global and 0 < cfg.sliding_window < max_len:
        raise NotImplementedError(
            "ring KV caches (gemma2 local layers) are not ported yet: ROADMAP.md A11")
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": (shape, dt, kv_axes, 0.0), "v": (shape, dt, kv_axes, 0.0)}
