"""Transformer layer primitives: norm, RoPE/M-RoPE, GQA attention
(full / sliding-window / soft-capped, plain or ring KV cache), the GLU MLP
and the capacity-routed MoE layer.

Ports :mod:`repro.models.layers` without a sharding context, where
``constrain``, ``column_parallel_in`` and ``row_parallel_out`` reduce to
plain matmuls and ``moe`` to ``_moe_dense``.  Attention's score/softmax/PV
part runs in :func:`repro_torch.kernels.ops.flash_attention`: the
hand-written kernel on CUDA tensors, its plain version on CPU tensors.
The MoE layer's expert products are batched matmuls, as the JAX package's
are einsums.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

from .common import ModelConfig, ParamBuilder

# ---------------------------------------------------------------------------
# Norm
# ---------------------------------------------------------------------------


def init_rmsnorm(b: ParamBuilder, name: str, d: int):
    b.add(f"{name}/scale", (d,), ("embed",), init="ones")


def rmsnorm(params, name: str, x, eps: float = 1e-6):
    scale = params[f"{name}/scale"].float()
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * scale
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE / M-RoPE
# ---------------------------------------------------------------------------


def _rope_freqs(head_dim: int, theta: float, device):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=device) / half))


def rope(x, positions, theta: float = 10_000.0, sections: tuple[int, ...] = ()):
    """Rotary embedding.

    x: (B, S, H, D); positions: (B, S) int, or (3, B, S) for M-RoPE with
    ``sections`` (t, h, w) summing to D//2 (Qwen2-VL §2.1).
    """
    half = x.shape[-1] // 2
    freqs = _rope_freqs(x.shape[-1], theta, x.device)        # (half,)
    if sections:
        assert sum(sections) == half, (sections, half)
        assert positions.dim() == 3
        # Each frequency channel uses the position id of its section.
        sec_id = torch.repeat_interleave(
            torch.arange(len(sections), device=x.device),
            torch.tensor(sections, device=x.device),
        )                                                    # (half,) in {0,1,2}
        pos = positions.float()                              # (3, B, S)
        angle = pos[sec_id].permute(1, 2, 0) * freqs         # (B, S, half)
    else:
        angle = positions.float()[..., None] * freqs         # (B, S, half)
    cos = torch.cos(angle)[:, :, None, :]
    sin = torch.sin(angle)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, optional sliding window + logit softcap)
# ---------------------------------------------------------------------------


def init_attention(b: ParamBuilder, name: str, cfg: ModelConfig):
    d, hd = cfg.d_model, cfg.hd
    b.add(f"{name}/wq", (d, cfg.n_heads, hd), ("embed", "heads", "head_dim"))
    b.add(f"{name}/wk", (d, cfg.n_kv_heads, hd), ("embed", "kv_heads", "head_dim"))
    b.add(f"{name}/wv", (d, cfg.n_kv_heads, hd), ("embed", "kv_heads", "head_dim"))
    b.add(f"{name}/wo", (cfg.n_heads, hd, d), ("heads", "head_dim", "embed"))


def _attend(cfg: ModelConfig, q, k, v, *, causal: bool, window: int):
    """q (B,S,H,hd); k/v (B,S_k,KV,hd) -> (B,S,H,hd), through
    :func:`ops.flash_attention`, which picks the path by the tensors'
    device alone."""
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              causal=causal, window=window, softcap=cfg.attn_softcap)
    return out.transpose(1, 2)


def attention(
    params,
    name: str,
    cfg: ModelConfig,
    x,                       # (B, S, d)
    positions,               # (B, S) or (3, B, S) for M-RoPE
    *,
    window: Optional[int] = None,   # None | int; <=0 means full
    cache: Optional[dict] = None,   # {"k": (B, S_max, KV, hd), "v": ..., "ring": bool} decode
    cache_pos: Optional[int] = None,  # write offset (a host int)
    collect_kv: bool = False,       # prefill: also return this step's (k, v)
):
    """GQA attention; returns (out, aux).

    ``aux`` is the cache dict in decode mode (written in place, where the
    JAX package returns an updated copy), the fresh ``(k, v)`` pair when
    ``collect_kv`` (prefill), else None.  A ring cache (``"ring": True``,
    window-sized) is written at ``cache_pos % S_max``.
    """
    B, S, d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = x.dtype
    win = int(window) if window is not None and int(window) > 0 else 0

    q = (x @ params[f"{name}/wq"].to(dt).reshape(d, H * hd)).reshape(B, S, H, hd)
    k = (x @ params[f"{name}/wk"].to(dt).reshape(d, KV * hd)).reshape(B, S, KV, hd)
    v = (x @ params[f"{name}/wv"].to(dt).reshape(d, KV * hd)).reshape(B, S, KV, hd)
    q = rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    k = rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    fresh_kv = (k, v) if collect_kv else None

    if cache is not None:
        if S != 1:
            raise NotImplementedError("decode with a cache takes one token per step")
        S_k = cache["k"].shape[1]
        ring = bool(cache.get("ring", False))
        # In-place write: the JAX package's dynamic_update_slice returns a
        # new cache; here the caller's cache tensors are updated.  A ring
        # writes at pos % S_k: slot j then holds position
        # pos - ((pos - j) mod S_k), the last S_k tokens.
        w = cache_pos % S_k if ring else cache_pos
        cache["k"][:, w:w + 1] = k.to(cache["k"].dtype)
        cache["v"][:, w:w + 1] = v.to(cache["v"].dtype)
        # The reference mask admits k_pos <= q_pos and, with a window,
        # k_pos > q_pos - window, where q_pos == cache_pos for one token
        # (every caller passes positions == cache_pos); a ring's admits
        # every slot whose position is >= 0, slots 0..min(pos, S_k - 1).
        # Attend over exactly those cache rows, non-causally (softmax does
        # not depend on the order of the keys).
        if ring:
            lo, hi = 0, min(cache_pos, S_k - 1) + 1
        else:
            lo, hi = (max(0, cache_pos - win + 1) if win else 0), cache_pos + 1
        k_att = cache["k"][:, lo:hi].to(dt)
        v_att = cache["v"][:, lo:hi].to(dt)
        out = _attend(cfg, q, k_att, v_att, causal=False, window=0)
        aux = cache
    else:
        out = _attend(cfg, q, k, v, causal=True, window=win)
        aux = fresh_kv

    out = out.reshape(B, S, H * hd) @ params[f"{name}/wo"].to(dt).reshape(H * hd, d)
    return out, aux


# ---------------------------------------------------------------------------
# GLU MLP
# ---------------------------------------------------------------------------


def init_mlp(b: ParamBuilder, name: str, d: int, d_ff: int):
    b.add(f"{name}/wi_gate", (d, d_ff), ("embed", "mlp"))
    b.add(f"{name}/wi_up", (d, d_ff), ("embed", "mlp"))
    b.add(f"{name}/wo", (d_ff, d), ("mlp", "embed"))


def mlp(params, name: str, x):
    dt = x.dtype
    gate = x @ params[f"{name}/wi_gate"].to(dt)
    up = x @ params[f"{name}/wi_up"].to(dt)
    h = F.silu(gate) * up
    return h @ params[f"{name}/wo"].to(dt)


# ---------------------------------------------------------------------------
# MoE (top-k routing with capacity buffers, GShard-style)
# ---------------------------------------------------------------------------


def init_moe(b: ParamBuilder, name: str, cfg: ModelConfig):
    """The router, the E experts' GLU weights and the optional shared expert."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    b.add(f"{name}/router", (d, E), ("embed", "experts"))
    b.add(f"{name}/wi_gate", (E, d, ff), ("experts", "embed", "mlp"))
    b.add(f"{name}/wi_up", (E, d, ff), ("experts", "embed", "mlp"))
    b.add(f"{name}/wo", (E, ff, d), ("experts", "mlp", "embed"))
    if cfg.n_shared_experts:
        init_mlp(b, f"{name}/shared", d, cfg.d_ff * cfg.n_shared_experts)


def top_k(logits: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of the last axis, largest
    first and, among equal values, the lower index first, as
    ``jax.lax.top_k`` orders them (``torch.topk`` promises no order among
    ties, and tied bf16 router logits decide the slots)."""
    values, indices = torch.sort(logits, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def moe_route(params, name: str, cfg: ModelConfig, xt):
    """Routing of ``_moe_dense`` for tokens xt (T, d): (weights (T, k) in
    xt's dtype, expert (T*k,), slot (T*k,), keep (T*k,), capacity).  The
    capacity is per call, ``max(int(T k capacity_factor / E), 1)``; the
    (T*k) assignments take slots in token order, by a cumsum, and those
    past the capacity go to the scratch slot ``capacity`` with keep False."""
    E, k = cfg.n_experts, cfg.top_k
    T = xt.shape[0]
    logits = (xt @ params[f"{name}/router"].to(xt.dtype)).float()
    weights, experts = top_k(logits, k)                        # (T, k)
    weights = torch.softmax(weights, dim=-1).to(xt.dtype)
    capacity = max(int(T * k * cfg.capacity_factor / E), 1)
    expert = experts.reshape(-1)                               # (T*k,)
    pos_in_expert = torch.cumsum(F.one_hot(expert, E), dim=0) - 1
    slot = pos_in_expert.gather(1, expert[:, None])[:, 0]
    keep = slot < capacity
    return weights, expert, torch.where(keep, slot, capacity), keep, capacity


def moe(params, name: str, cfg: ModelConfig, x):
    """Top-k expert routing with per-expert capacity buffers:
    ``repro.models.layers._moe_dense`` (what ``moe`` runs without a
    sharding context).  x (B, S, d) -> (B, S, d)."""
    B, S, d = x.shape
    dt = x.dtype
    T, k = B * S, cfg.top_k
    xt = x.reshape(T, d)
    weights, expert, slot, keep, capacity = moe_route(params, name, cfg, xt)

    # Scatter tokens to (E, C+1, d); row `capacity` absorbs dropped tokens.
    token = torch.arange(T, device=x.device).repeat_interleave(k)
    buf = torch.zeros((cfg.n_experts, capacity + 1, d), dtype=dt, device=x.device)
    buf = buf.index_put((expert, slot), xt[token], accumulate=True)
    gate = torch.bmm(buf, params[f"{name}/wi_gate"].to(dt))
    up = torch.bmm(buf, params[f"{name}/wi_up"].to(dt))
    out_buf = torch.bmm(F.silu(gate) * up, params[f"{name}/wo"].to(dt))

    # Gather back, weighted by router probability; dropped tokens get 0.
    gathered = torch.where(keep[:, None], out_buf[expert, slot], 0)
    out = (gathered * weights.reshape(-1, 1)).reshape(T, k, d).sum(dim=1)
    if cfg.n_shared_experts:
        out = out + mlp(params, f"{name}/shared", x).reshape(T, d)
    return out.reshape(B, S, d)
