"""Transformer layer primitives: norm, RoPE/M-RoPE, GQA attention
(full / sliding-window / soft-capped) and the GLU MLP.

Ports :mod:`repro.models.layers` without a sharding context, where
``constrain``, ``column_parallel_in`` and ``row_parallel_out`` reduce to
plain matmuls.  Attention's score/softmax/PV part runs in
:func:`repro_torch.kernels.ops.flash_attention`: the hand-written kernel
on CUDA tensors, its plain version on CPU tensors.
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
    cache: Optional[dict] = None,   # {"k": (B, S_max, KV, hd), "v": ...} decode
    cache_pos: Optional[int] = None,  # write offset (a host int)
    collect_kv: bool = False,       # prefill: also return this step's (k, v)
):
    """GQA attention; returns (out, aux).

    ``aux`` is the cache dict in decode mode (written in place, where the
    JAX package returns an updated copy), the fresh ``(k, v)`` pair when
    ``collect_kv`` (prefill), else None.
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
        # In-place write: the JAX package's dynamic_update_slice returns a
        # new cache; here the caller's cache tensors are updated.
        cache["k"][:, cache_pos:cache_pos + 1] = k.to(cache["k"].dtype)
        cache["v"][:, cache_pos:cache_pos + 1] = v.to(cache["v"].dtype)
        # The reference mask admits k_pos <= q_pos and, with a window,
        # k_pos > q_pos - window, where q_pos == cache_pos for one token
        # (every caller passes positions == cache_pos).  Attend over
        # exactly those cache rows, non-causally.
        lo = max(0, cache_pos - win + 1) if win else 0
        k_att = cache["k"][:, lo:cache_pos + 1].to(dt)
        v_att = cache["v"][:, lo:cache_pos + 1].to(dt)
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
