"""Decoder assembly: the dense, hybrid and xLSTM branches of
:mod:`repro.models.transformer`.

Training/prefill walk the stacked per-layer params with a Python loop
(the JAX package's ``lax.scan``); decode walks the layers over per-layer
cache slices (gemma2's local layers over window-sized ring caches, where
the cache outgrows the window).  With ``cfg.remat`` and grad enabled, each step of the
layer loop runs under ``torch.utils.checkpoint`` (the JAX package's
``jax.checkpoint`` of its scan body, with ``nothing_saveable``): a dense
block; a Mamba2 layer with the shared block when it follows; an xLSTM
unit.  Its activations are recomputed in the backward.

While a mesh train step runs (the context carries the step's
``ParamLayout``, :func:`repro_torch.train.loss_and_grads`), the params
are the rank's fp32 storage shards, and each unit gathers its own
layer's slice of every stacked leaf into its compute layout at its
start, inside the function ``checkpoint`` wraps, as the JAX package's
FSDP gathers run inside its scan body
(:func:`repro_torch.models.layers.compute_params`).  The layer axis is
never sharded, so a layer's slice of a storage shard is local
(``ParamLayout.layer_slice``, whose backward adds each layer's gradient
into the stacked gradient as soon as it is reduce-scattered, as JAX's
scan writes its stacked cotangent).  Each slice is cast to the compute
dtype in the unit, just before its gather, where JAX casts the whole
stacked shard once before the scan: the same bytes move and the same
numbers come out, and no bf16 copy of the whole shard is held.  Under
remat the recompute gathers the unit again (``nothing_saveable``), and
each gather's transpose reduce-scatters the layer's gradient in fp32: a
rank then holds at most one unit's gathered weights, besides the
embedding, the head, the final norm and zamba2's shared block, which is
gathered once before the loop (JAX's scan closes over it).  Without
remat autograd saves every layer's gathered weights for its backward, as
JAX's scan saves them as residuals: there is no such bound.  Without a
layout the loops read the params as given.

Under a sharding context whose model axis m is above 1 (every family),
the residual stream between blocks is sequence-sharded over 'model'
(``residual_seq``, Megatron-SP): the embedding hands each rank its S/m
rows and every block's output projection reduce-scatters back into them
(the recurrent blocks' too, :mod:`repro_torch.models.ssm` and
:mod:`repro_torch.models.xlstm`), so the norms run on the rank's own rows
and remat saves 1/m of each carry (``repro_torch.models.layers``).

Families:
  dense   — [attn, mlp] x L     (gemma2: alternating sliding window + softcap)
  moe     — [attn, moe] x L     (optional shared expert)
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

from repro_torch.parallel.sharding import carry_context

from .common import ModelConfig, ParamBuilder, stack_params, torch_dtype
from .layers import (attention, compute_params, init_attention, init_mlp, init_moe, init_rmsnorm,
                     mlp, moe, rmsnorm, step_layout)
from .ssm import init_mamba2, mamba2_block, mamba2_state_shapes
from .xlstm import (
    init_mlstm_block,
    init_slstm_block,
    mlstm_block,
    mlstm_state_shapes,
    slstm_block,
    slstm_state_shapes,
)

DENSE_FAMILIES = ("dense", "moe", "audio", "vlm")
# Cache entries that hold attention keys / values, (n, B, S_max, KV, hd);
# "k_loc" / "v_loc" are gemma2's rings of ``sliding_window`` slots.
KV_ENTRIES = ("k", "v", "k_loc", "v_loc", "attn_k", "attn_v")
MLSTM_STATES = ("mlstm_S", "mlstm_n", "mlstm_m")
SLSTM_STATES = ("slstm_c", "slstm_n", "slstm_h", "slstm_m")


def _check_family(cfg: ModelConfig):
    if cfg.family not in DENSE_FAMILIES + ("hybrid", "ssm"):
        raise ValueError(f"unknown family {cfg.family!r}")


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
    records for every family."""
    if generator is not None:
        _check_family(cfg)
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


def local_layers(cfg: ModelConfig) -> list[int]:
    """The layers that attend within a window while the others attend to
    every position (gemma2's alternation; its even layers): those whose
    ``_layer_windows`` entry is > 0.  Empty without the alternation."""
    if not cfg.alt_local_global:
        return []
    return [i for i, w in enumerate(_layer_windows(cfg) or []) if w > 0]


def _split_stacked(params: dict, prefix: str, dtype=None) -> dict:
    """Extract a sub-dict; optionally cast floating params to the compute
    dtype once here (a no-op for params already in it)."""
    plen = len(prefix)
    out = {k[plen:]: v for k, v in params.items() if k.startswith(prefix)}
    if dtype is not None:
        out = {k: (v.to(dtype) if v.is_floating_point() else v) for k, v in out.items()}
    return out


def _block_params(params: dict, prefix: str, dtype) -> dict:
    """The params under ``prefix`` as the layers read them: cast to
    ``dtype`` once, or on a mesh step gathered from the storage shards."""
    if step_layout() is None:
        return _split_stacked(params, prefix, dtype)
    return compute_params(_split_stacked(params, prefix), prefix, dtype)


def _layer_params(params: dict, prefix: str, dtype):
    """``at(i)``: layer ``i``'s slices of the stacked leaves under
    ``prefix``, to be taken where the layer runs.  Off a mesh step each
    leaf is cast to ``dtype`` once and unbound; on one, each slice is cut
    from the storage shard as it is (``ParamLayout.layer_slice``: its
    gradient lands in the stacked gradient when the layer's backward
    ends) and is cast and gathered in its unit (:func:`_unit`)."""
    layout = step_layout()
    if layout is not None:
        stacked = _split_stacked(params, prefix)
        return lambda i: {k: layout.layer_slice(prefix + k, v, i) for k, v in stacked.items()}
    # unbind, not v[i]: its backward stacks the layers' grads in one
    # tensor, where L selects would each add a full-size zero tensor
    layers = {k: v.unbind(0) for k, v in _split_stacked(params, prefix, dtype).items()}
    return lambda i: {k: v[i] for k, v in layers.items()}


def _unit(fn, prefix: str, dtype):
    """``fn(lp, *args)`` with ``lp``, one layer's param slices, first put in
    their compute layout (:func:`~repro_torch.models.layers.compute_params`;
    as given off a mesh step), under the context current now: the
    function a layer loop runs, through ``checkpoint`` under remat, whose
    recompute then gathers again."""
    def run(lp, *args):
        return fn(compute_params(lp, prefix, dtype), *args)

    return carry_context(run)


def _dense_block(layer_params, cfg, x, positions, window, collect_kv):
    h = rmsnorm(layer_params, "ln_attn", x, cfg.norm_eps)
    attn_out, kv = attention(
        layer_params, "attn", cfg, h, positions, window=window,
        collect_kv=collect_kv,
    )
    x = x + attn_out
    h = rmsnorm(layer_params, "ln_mlp", x, cfg.norm_eps)
    return x + _ffn(layer_params, cfg, h), kv


def _ffn(layer_params, cfg, h):
    """The block's feed-forward: the MoE layer in the moe family, else the MLP."""
    if cfg.family == "moe":
        return moe(layer_params, "moe", cfg, h)
    return mlp(layer_params, "mlp", h)


def forward_blocks(params, cfg: ModelConfig, x, positions, collect_kv=False):
    """x: (B,S,d) post-embedding.  Returns (y, caches-or-None).

    With ``collect_kv``, caches holds every entry of ``init_cache_shapes``
    that the prompt fills, stacked over layers: dense and moe ``k``/``v``
    (L, B, S, KV, hd), every layer's (``Model.prefill`` hands gemma2's
    local layers' to their rings); hybrid ``ssm`` (L, B, H, N, P) fp32 and ``conv``
    (L, B, K-1, C), the states a decode step continues from, and the
    shared block's ``attn_k``/``attn_v`` (n_attn, B, S, KV, hd); xLSTM
    ``mlstm_S``/``mlstm_n``/``mlstm_m`` (n_units, every-1, B, H, ...) and
    ``slstm_c/n/h/m`` (n_units, B, H, dh), all fp32."""
    _check_family(cfg)
    if cfg.family == "hybrid":
        return _forward_hybrid(params, cfg, x, positions, collect_kv)
    if cfg.family == "ssm":
        return _forward_xlstm(params, cfg, x, collect_kv)
    layer_at = _layer_params(params, "blocks/", cfg.compute_dtype)
    block = _unit(_dense_block, "blocks/", cfg.compute_dtype)
    windows = _layer_windows(cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = layer_at(i)
        window = None if windows is None else windows[i]
        if remat:
            x, kv = checkpoint(block, lp, cfg, x, positions, window, collect_kv,
                               use_reentrant=False)
        else:
            x, kv = block(lp, cfg, x, positions, window, collect_kv)
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


def _hybrid_layer(lp, shared, cfg, x, positions, with_attn, collect_kv):
    """One Mamba2 layer, then the shared block when it follows this layer:
    (x, the layer's {ssm, conv} state or None, the shared block's (k, v) or
    None)."""
    h = rmsnorm(lp, "ln", x, cfg.norm_eps)
    out, st = mamba2_block(lp, "mamba", cfg, h, collect_state=collect_kv)
    x = x + out
    kv = None
    if with_attn:
        x, kv = _dense_block(shared, cfg, x, positions, None, collect_kv)
    return x, st, kv


def _forward_hybrid(params, cfg: ModelConfig, x, positions, collect_kv):
    layer_at = _layer_params(params, "blocks/", cfg.compute_dtype)
    shared = _block_params(params, "shared_attn/", cfg.compute_dtype)
    layer = _unit(_hybrid_layer, "blocks/", cfg.compute_dtype)
    remat = cfg.remat and torch.is_grad_enabled()
    collected = {n: [] for n in ("ssm", "conv", "attn_k", "attn_v")}
    for i in range(cfg.n_layers):
        args = (layer_at(i), shared, cfg, x, positions, _applies_shared_attn(cfg, i), collect_kv)
        if remat:
            x, st, kv = checkpoint(layer, *args, use_reentrant=False)
        else:
            x, st, kv = layer(*args)
        if collect_kv:
            collected["ssm"].append(st["ssm"])
            collected["conv"].append(st["conv"])
            if kv is not None:
                collected["attn_k"].append(kv[0])
                collected["attn_v"].append(kv[1])
    if collect_kv:
        return x, {n: torch.stack(v) for n, v in collected.items() if v}
    return x, None


def _xlstm_unit(lp, cfg, x, collect_kv):
    """One unit: (every - 1) mLSTM blocks, then the sLSTM block: (x, the
    mLSTM blocks' final states, the sLSTM's final state)."""
    unit = []
    for i in range(max(cfg.xlstm_slstm_every, 1) - 1):
        h = rmsnorm(lp, f"ln_m{i}", x, cfg.norm_eps)
        out, st = mlstm_block(lp, f"mlstm{i}", cfg, h, collect_state=collect_kv)
        x = x + out
        unit.append(st)
    h = rmsnorm(lp, "ln_s", x, cfg.norm_eps)
    out, st = slstm_block(lp, "slstm", cfg, h, collect_state=collect_kv)
    return x + out, unit, st


def _forward_xlstm(params, cfg: ModelConfig, x, collect_kv):
    unit_at = _layer_params(params, "blocks/", cfg.compute_dtype)
    run = _unit(_xlstm_unit, "blocks/", cfg.compute_dtype)
    remat = cfg.remat and torch.is_grad_enabled()
    mstates = {n: [] for n in MLSTM_STATES}
    sstates = {n: [] for n in SLSTM_STATES}
    for u in range(_n_units(cfg)):
        lp = unit_at(u)
        if remat:
            x, unit, st = checkpoint(run, lp, cfg, x, collect_kv, use_reentrant=False)
        else:
            x, unit, st = run(lp, cfg, x, collect_kv)
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


def _decode_layer_params(params: dict, prefix: str):
    """``at(i)``: layer ``i``'s params under ``prefix`` for a decode step:
    the stacked leaves' slices as given, or, while a serving step on a
    mesh runs (its params the rank's storage shards), each slice gathered
    into its compute layout where the layer runs (no cast: serving params
    are in the compute dtype already)."""
    stacked = _split_stacked(params, prefix)
    layout = step_layout()
    if layout is None:
        return lambda i: {k: v[i] for k, v in stacked.items()}
    return lambda i: compute_params(
        {k: layout.layer_slice(prefix + k, v, i) for k, v in stacked.items()}, prefix)


def decode_blocks(params, cfg: ModelConfig, x, positions, cache: dict, cache_pos: int):
    """One decode step.  x: (B,1,d).  cache: stacked per-layer dict, written
    in place (the JAX package returns a new one).  Returns (y, cache).
    With ``k_loc`` in the cache (gemma2), the local (even) layers read and
    write their ring slots, the global ones ``k``/``v``.  Under a serving
    context on a mesh the cache is the rank's shard
    (``Model.cache_layouts``) and the params its storage shards, each
    layer's gathered in the loop."""
    _check_family(cfg)
    if cfg.family == "hybrid":
        return _decode_hybrid(params, cfg, x, positions, cache, cache_pos), cache
    if cfg.family == "ssm":
        return _decode_xlstm(params, cfg, x, cache), cache
    layer_at = _decode_layer_params(params, "blocks/")
    windows = _layer_windows(cfg)
    rings = set(local_layers(cfg)) if "k_loc" in cache else set()
    loc_slot = glob_slot = 0
    for i in range(cfg.n_layers):
        lp = layer_at(i)
        if i in rings:
            layer_cache = {"k": cache["k_loc"][loc_slot], "v": cache["v_loc"][loc_slot],
                           "ring": True}
            loc_slot += 1
        else:
            layer_cache = {"k": cache["k"][glob_slot], "v": cache["v"][glob_slot]}
            glob_slot += 1
        window = None if windows is None else windows[i]
        h = rmsnorm(lp, "ln_attn", x, cfg.norm_eps)
        attn_out, _ = attention(
            lp, "attn", cfg, h, positions, window=window,
            cache=layer_cache, cache_pos=cache_pos,
        )
        x = x + attn_out
        h = rmsnorm(lp, "ln_mlp", x, cfg.norm_eps)
        x = x + _ffn(lp, cfg, h)
    return x, cache


def _decode_hybrid(params, cfg: ModelConfig, x, positions, cache: dict, cache_pos: int):
    layer_at = _decode_layer_params(params, "blocks/")
    shared = _block_params(params, "shared_attn/", None)
    slot = 0
    for i in range(cfg.n_layers):
        lp = layer_at(i)
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
    unit_at = _decode_layer_params(params, "blocks/")
    every = max(cfg.xlstm_slstm_every, 1)
    for u in range(_n_units(cfg)):
        lp = unit_at(u)
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

    gemma2 (``alt_local_global`` with ``0 < sliding_window < max_len``):
    its local (even) layers only ever see the last ``sliding_window``
    tokens and get window-sized ring caches ``k_loc``/``v_loc``, its global
    (odd) layers ``k``/``v`` of ``max_len``, as in the JAX package.
    """
    _check_family(cfg)
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
        n_loc = len(local_layers(cfg))
        ring = (n_loc, batch, cfg.sliding_window, cfg.n_kv_heads, cfg.hd)
        shape = (cfg.n_layers - n_loc, batch, max_len, cfg.n_kv_heads, cfg.hd)
        return {"k_loc": (ring, dt, kv_axes, 0.0), "v_loc": (ring, dt, kv_axes, 0.0),
                "k": (shape, dt, kv_axes, 0.0), "v": (shape, dt, kv_axes, 0.0)}
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": (shape, dt, kv_axes, 0.0), "v": (shape, dt, kv_axes, 0.0)}
