"""Transformer layer primitives: norm, RoPE/M-RoPE, GQA attention
(full / sliding-window / soft-capped, plain or ring KV cache), the GLU MLP
and the capacity-routed MoE layer; and the tensor-parallel helpers the
recurrent blocks (:mod:`repro_torch.models.ssm`,
:mod:`repro_torch.models.xlstm`) share with them.

Ports :mod:`repro.models.layers`.  Attention's score/softmax/PV part runs
in :func:`repro_torch.kernels.ops.flash_attention`: the hand-written
kernel on CUDA tensors, its plain version on CPU tensors.  The MoE
layer's expert products are batched matmuls, as the JAX package's are
einsums.

Without a sharding context (and on a mesh whose model axis is 1) the
projections are plain matmuls and ``moe`` is ``_moe_dense``.  Under a
context on a :class:`~repro_torch.parallel.sharding.ProcessMesh` whose
model axis m is above 1, a rank holds the weights in the layout
:func:`compute_spec` gives them, in every mode.  In ``train`` mode (and
a prefill, which runs in it, as JAX's prefill cell does) the residual
stream is sequence-sharded over ``model`` (Megatron-SP,
``residual_seq``):

* ``column_parallel_in`` all-gathers the input's sequence once for the
  block's projections (its backward reduce-scatters);
  ``row_parallel_out`` multiplies by the rank's rows and reduce-scatters
  the partial sums into the sequence-sharded layout (its backward
  all-gathers);
* ``attention`` runs the rank's H/m query heads and, where m divides
  ``n_kv_heads``, its KV/m heads, through the same kernel; where it does
  not (phi3.5's smoke config: 2 KV heads over 4), K and V are computed
  whole on every rank and each rank keeps the KV heads its query heads
  read, where JAX's constraint drops the axis;
* ``mlp`` is tensor parallel over d_ff;
* ``moe`` runs ``_moe_shard_map``'s expert parallelism where m divides
  ``n_experts``: routing and the capacity buffer per data shard (the
  capacity from its own Tl tokens), only the rank's E/m experts, one
  all-gather of their outputs over ``model``;
* the recurrent blocks run the rank's heads where m divides their head
  count: a param whose columns concatenate several parts (Mamba2's
  ``in_proj`` ``[z | x | B | C | dt]``, mLSTM's ``up`` ``[xm | z]``)
  is whole in the compute layout and the block takes its own columns
  (:func:`take_columns`, :func:`first_local_head`); autograd's zeros
  outside them are summed away by the param's reduce-scatter.

In the serving modes, ``decode`` and ``long`` (JAX's ``ACT_RULES``), one
token a step: the residual (B, 1, d) is whole over ``model``, so
``column_parallel_in`` gathers nothing and ``row_parallel_out``
all-reduces the rank's partial product over ``model`` (the MLP, the
recurrent blocks and attention's ``wo`` alike); ``moe`` keeps
``_moe_shard_map``'s per-data-shard capacity, as JAX takes its
``shard_map`` whatever the mode.  Attention decodes context-parallel: the
cache's sequence (``kv_seq``) is split over ``model`` in ``decode`` mode
and over (pod, data, model) in ``long`` mode, and every KV head's rows
of a rank's slice are on that rank.  A rank computes every head of the
new token's q, k and v (``wq``, ``wk``, ``wv`` are whole in these modes,
:func:`compute_spec`, as GSPMD computes them under those rules),
writes the token's K and V where its slice holds the written slot,
attends every query head over the admitted rows of its slice through
:func:`repro_torch.kernels.ops.flash_attention_lse` (no admitted row:
output 0, log-sum-exp -inf, no launch), and merges the ranks' partial
outputs by one all-gather of (o, lse) over the split axes and the sum
weighted by exp(lse_r - logsumexp_r lse_r); ``wo`` then takes the rank's
heads.  The serving layout needs the batch split over every axis its
rule names and the cache's sequence over every axis of ``kv_seq`` the
batch leaves (``repro_torch.models.Model.cache_layouts`` raises
otherwise, with the cause).

Where JAX's ``shard_map`` paths fall back to an einsum and a constraint
(m not dividing d_model or n_heads), the port computes that projection
whole on every rank of the model axis (the weight replicated there):
the numbers are the same, only the work is repeated.  The port has no
GSPMD behind those fallbacks, so two more cases differ in how they are
refused, not in their numbers: the model axis must divide the sequence
(``Model.forward`` raises) and, where it divides d_model, d_ff
(:func:`compute_spec` raises).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import constrain, current_context

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
        sec_id = torch.tensor([i for i, n in enumerate(sections) for _ in range(n)],
                              device=x.device)               # (half,) in {0,1,2}
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
    # the rank's heads: H/m and KV/m under tensor parallelism, else all;
    # in a serving mode the rank computes every head's q, k, v (whole
    # wq, wk, wv) and its output projection's heads Ho (wo's rows)
    Hl, KVl = params[f"{name}/wq"].shape[1], params[f"{name}/wk"].shape[1]
    Ho = params[f"{name}/wo"].shape[0]

    q, k, v = column_parallel_in(x, [
        params[f"{name}/wq"].to(dt).reshape(d, Hl * hd),
        params[f"{name}/wk"].to(dt).reshape(d, KVl * hd),
        params[f"{name}/wv"].to(dt).reshape(d, KVl * hd)])
    S = q.shape[1]          # the whole sequence, gathered over 'model'
    q = q.reshape(B, S, Hl, hd)
    k = k.reshape(B, S, KVl, hd)
    v = v.reshape(B, S, KVl, hd)
    q = rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    k = rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    fresh_kv = (k, v) if collect_kv else None

    if cache is not None and S != 1:
        raise NotImplementedError("decode with a cache takes one token per step")
    split = _kv_split() if cache is not None else None
    if split is not None:
        out = _decode_split(cfg, q, k, v, cache, cache_pos, win, *split)
        aux = cache
    elif cache is not None:
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
        if Hl < H and KVl == KV:
            k, v = _kv_for_local_heads(cfg, Hl, k, v)
        out = _attend(cfg, q, k, v, causal=True, window=win)
        aux = fresh_kv

    if out.shape[2] > Ho:      # this rank's heads of a whole output
        h0 = first_local_head(Ho, H)
        out = out[:, :, h0:h0 + Ho]
    out = row_parallel_out(out.reshape(B, S, Ho * hd),
                           params[f"{name}/wo"].to(dt).reshape(Ho * hd, d), Ho < H)
    return out, aux


def _kv_for_local_heads(cfg: ModelConfig, Hl: int, k, v):
    """K and V (B, S, KV, hd), whole, cut to the heads this rank's Hl
    query heads read (query head h reads KV head h // (H / KV)): one head
    when one group holds every local query head, else one per query head
    (a GQA ratio of 1)."""
    G = cfg.n_heads // cfg.n_kv_heads
    first = current_context().mesh.axis_index("model") * Hl
    if G % Hl == 0:
        sel = slice(first // G, first // G + 1)
        return k[:, :, sel], v[:, :, sel]
    idx = torch.arange(first, first + Hl, device=k.device) // G
    return k[:, :, idx], v[:, :, idx]


def _row_parallel_ctx():
    """(ctx, m) when the current context's mesh has a 'model' axis of
    m > 1, in any mode, else None.  JAX also asks that m divide the
    contracted dim and, in train mode, the sequence: the first decides
    each projection's layout in :func:`compute_spec`, the second
    ``Model.forward`` requires."""
    ctx = current_context()
    if ctx is None:
        return None
    m = ctx.mesh.axis_sizes().get("model", 1)
    return None if m <= 1 else (ctx, m)


def _seq_parallel(rp) -> bool:
    """Megatron-SP (the sequence-sharded residual): train mode on a model
    axis above 1 (``rp`` from :func:`_row_parallel_ctx`)."""
    return rp is not None and rp[0].mode == "train"


def rule_axes(ctx, name: str) -> tuple[str, ...]:
    """The axes of ``ctx.mesh`` that the activation rule of ``name`` names,
    major first."""
    rule = ctx.act_rule(name)
    axes = () if rule is None else ((rule,) if isinstance(rule, str) else tuple(rule))
    return tuple(a for a in axes if a in ctx.mesh.axis_sizes())


def kv_seq_axes(ctx) -> tuple[str, ...]:
    """The axes a serving cache's sequence is split over: those of
    ``kv_seq``'s rule that the batch's does not take (the cache's batch
    axis comes first)."""
    batch = set(rule_axes(ctx, "batch"))
    return tuple(a for a in rule_axes(ctx, "kv_seq") if a not in batch)


def _kv_split():
    """(mesh, axes) when a serving context splits the cache's sequence
    over ``axes`` (more than one rank), else None."""
    ctx = current_context()
    if ctx is None or ctx.mode == "train":
        return None
    axes = kv_seq_axes(ctx)
    sizes = ctx.mesh.axis_sizes()
    if math.prod(sizes[a] for a in axes) <= 1:
        return None
    return ctx.mesh, axes


def _decode_split(cfg: ModelConfig, q, k, v, cache: dict, cache_pos: int, win: int, mesh,
                  axes: tuple):
    """One token's attention over a cache whose sequence is split over
    ``axes`` (context parallel): q (B,1,H,hd), k/v (B,1,KV,hd), every
    head of the new token (the serving layout's wq, wk, wv are whole);
    the cache's (B, S_k/n, KV, hd) slice, every KV head.  Returns
    (B,1,H,hd), the merged output of every head (the caller keeps its
    own)."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    B = q.shape[0]
    if q.shape[2] != H or k.shape[2] != KV:
        raise ValueError(f"split-cache decode needs every head of q, k, v (wq, wk, wv whole, "
                         f"the serving layout of compute_spec); got {q.shape[2]} of {H} query "
                         f"and {k.shape[2]} of {KV} KV heads")
    sizes, coords = mesh.axis_sizes(), mesh.coords()
    part = 0
    for a in axes:
        part = part * sizes[a] + coords[a]
    Sc = cache["k"].shape[1]
    S_k = Sc * math.prod(sizes[a] for a in axes)
    off = part * Sc
    ring = bool(cache.get("ring", False))
    w = cache_pos % S_k if ring else cache_pos
    if off <= w < off + Sc:      # this rank's slice holds the written slot
        cache["k"][:, w - off:w - off + 1] = k.to(cache["k"].dtype)
        cache["v"][:, w - off:w - off + 1] = v.to(cache["v"].dtype)
    # the admitted rows, as on one device (see attention), cut to the slice
    if ring:
        lo, hi = 0, min(cache_pos, S_k - 1) + 1
    else:
        lo, hi = (max(0, cache_pos - win + 1) if win else 0), cache_pos + 1
    lo, hi = max(lo, off) - off, min(hi, off + Sc) - off
    if hi > lo:
        o, lse = ops.flash_attention_lse(
            q.transpose(1, 2), cache["k"][:, lo:hi].to(q.dtype).transpose(1, 2),
            cache["v"][:, lo:hi].to(q.dtype).transpose(1, 2), causal=False, window=0,
            softcap=cfg.attn_softcap)
    else:
        o = q.new_zeros((B, H, 1, hd))
        lse = torch.full((B, H, 1), float("-inf"), dtype=torch.float32, device=q.device)
    # one gather of (o, lse) over each split axis, then the weighted sum
    part = torch.cat([o.float(), lse[..., None]], dim=-1)[None]    # (1,B,H,1,hd+1)
    for a in axes:
        part = coll.all_gather(part, mesh, a, 0)
    o_r, lse_r = part[..., :hd], part[..., hd]
    top = lse_r.amax(dim=0)
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    wgt = torch.exp(lse_r - top)             # exp(-inf) = 0: a rank with no admitted row
    out = (wgt[..., None] * o_r).sum(dim=0) / wgt.sum(dim=0)[..., None]
    return out.to(q.dtype).transpose(1, 2)   # (B,1,H,hd)


def row_parallel_out(x, w, contract_sharded: bool):
    """y = x @ w into the sequence-sharded residual layout.

    x: (B, S, K) whole over the sequence; w: (K, d).  With the
    contraction sharded over 'model' (``contract_sharded``: the rank's K
    rows) the partial sums are reduce-scattered over the sequence in one
    collective (Megatron-SP's g-bar; backward: all-gather); with K whole
    the product is complete on every rank and each keeps its sequence
    slice.  In a serving mode (one token, the residual whole over
    'model') the partial sums are all-reduced instead.  Without a model
    axis, x @ w."""
    out = x @ w
    rp = _row_parallel_ctx()
    if rp is None:
        return out
    mesh = rp[0].mesh
    if not _seq_parallel(rp):   # a serving mode: the residual is whole over 'model'
        return coll.all_reduce(out, mesh, "model") if contract_sharded else out
    if contract_sharded:
        return coll.reduce_scatter(out, mesh, "model", 1)
    return coll.take(out, mesh, "model", 1)


def column_parallel_in(x, weights: list):
    """Column-parallel projections under SP: ONE all-gather of the
    sequence-sharded input feeds every projection in the block (its
    backward is a reduce-scatter).  x: (B, S/m, d); weights: (d, F_i)
    local (the rank's columns, or whole).  Returns [(B, S, F_i)].
    Without a model axis, or in a serving mode (x whole), plain
    matmuls."""
    rp = _row_parallel_ctx()
    if _seq_parallel(rp):
        x = coll.all_gather(x, rp[0].mesh, "model", 1)
    return [x @ w for w in weights]


# The recurrent blocks' params that are split over 'model' in the compute
# layout, by block and leaf: the logical axis split (the heads, or the
# channels in head order).  The rest of each block is whole: its norms,
# and the params whose columns concatenate parts (Mamba2's in_proj
# [z | x | B | C | dt] and conv [x | B | C], mLSTM's up [xm | z] and
# w_if [i | f], sLSTM's gate-major (4, H, dh) w_in and bias), of which
# the block takes its own columns.
_RECURRENT_SPLIT = {
    "mamba": {"A_log": "ssm_heads", "D": "ssm_heads", "dt_bias": "ssm_heads",
              "norm_scale": "ssm_inner", "out_proj": "ssm_inner"},
    "mlstm": {"wq": "xlstm_heads", "wk": "xlstm_heads", "wv": "xlstm_heads",
              "out_scale": "xlstm_inner", "down": "xlstm_inner"},
    "slstm": {"r": "xlstm_heads", "ff_gate": "mlp", "ff_up": "mlp", "ff_down": "mlp"},
}


def _recurrent_heads(cfg: ModelConfig, block: str) -> int:
    if block == "mamba":
        return cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    return cfg.n_heads


def compute_spec(name: str, logical_axes: tuple, shape: tuple, cfg: ModelConfig,
                 m: int, mode: str = "train") -> tuple:
    """The layout a param of ``shape`` is computed in on a model axis of
    m: per dimension "model" (the rank's 1/m of it) or None (whole).

    Query heads (and ``wo``'s heads) split where m divides d_model and
    n_heads, KV heads where it also divides n_kv_heads; d_ff where it
    divides d_model; experts where it divides n_experts (their d_ff is
    then whole); the vocabulary where it divides it.  The recurrent
    blocks split their heads where m divides their head count (Mamba2's
    SSM heads, the xLSTM's heads) and the sLSTM's FFN where m divides its
    width (``_RECURRENT_SPLIT``).  The rest (norms, the router, the
    recurrent params whose columns concatenate parts) is whole.  Raises
    where m divides d_model but not a dense MLP's d_ff: JAX's
    ``shard_map`` falls back to GSPMD there, which the port has no
    counterpart of.

    In a serving mode (``decode``, ``long``) attention's ``wq``, ``wk``
    and ``wv`` are whole: every rank computes the new token's query, key
    and value heads, as JAX's GSPMD does under those modes' rules (no
    ``kv_heads`` split, the cache split by sequence), and attends every
    query head over its slice of the cache; ``wo`` stays split by heads."""
    if m <= 1:
        return (None,) * len(logical_axes)
    parts = name.split("/")
    if mode != "train" and parts[-2:-1] == ["attn"] and parts[-1] in ("wq", "wk", "wv"):
        return (None,) * len(logical_axes)
    block = parts[-2].rstrip("0123456789") if len(parts) > 1 else ""
    if block in _RECURRENT_SPLIT:
        axis = _RECURRENT_SPLIT[block].get(parts[-1])
        if axis is None:
            return (None,) * len(logical_axes)
        dim = logical_axes.index(axis)
        n = shape[dim] if axis == "mlp" else _recurrent_heads(cfg, block)
        return tuple("model" if i == dim and n % m == 0 else None
                     for i in range(len(logical_axes)))
    d = cfg.d_model
    heads = d % m == 0 and cfg.n_heads % m == 0
    split = {
        "heads": heads,
        "kv_heads": heads and cfg.n_kv_heads % m == 0,
        "vocab": cfg.vocab % m == 0,
    }
    expert_weight = "experts" in logical_axes and "mlp" in logical_axes
    if expert_weight:
        split["experts"] = cfg.n_experts % m == 0
    elif "mlp" in logical_axes and d % m == 0:
        ff = shape[logical_axes.index("mlp")]
        if ff % m:
            raise ValueError(f"{name}: a model axis of {m} divides d_model {d} but not "
                             f"d_ff {ff}")
        split["mlp"] = True
    return tuple("model" if split.get(a) else None for a in logical_axes)


def compute_params(params: dict, prefix: str = "", dtype=None) -> dict:
    """``params`` (keys under ``prefix``, the prefix stripped) as the
    layers read them.

    While a mesh train step runs, the context carries its
    :class:`~repro_torch.train.ParamLayout` and ``params`` are the rank's
    storage shards, or one layer's slices of them: each is gathered here
    into its :func:`compute_spec` layout, cast to ``dtype`` first where the
    layout casts it, in sorted order, so every rank issues the same
    collectives.  Otherwise ``params`` are returned as given."""
    layout = step_layout()
    if layout is None:
        return params
    return {k: layout.to_compute(prefix + k, params[k], dtype) for k in sorted(params)}


def step_layout():
    """The ``ParamLayout`` of the mesh train step that runs now (its
    params are the rank's storage shards), else None."""
    ctx = current_context()
    return None if ctx is None else ctx.layout


def first_local_head(n_local: int, n: int) -> int:
    """The first of this rank's ``n_local`` of a block's ``n`` heads: its
    share of the model axis where they are split (``n_local < n``), else
    0."""
    if n_local == n:
        return 0
    return current_context().mesh.axis_index("model") * n_local


def take_columns(w: torch.Tensor, spans: list) -> torch.Tensor:
    """The columns ``[start, start + n)`` of each ``(start, n)`` span of
    ``w``'s last dimension, in order, as one tensor; ``w`` itself where
    the spans, joined, are all of it."""
    merged: list = []
    for start, n in spans:
        if merged and merged[-1][0] + merged[-1][1] == start:
            merged[-1] = (merged[-1][0], merged[-1][1] + n)
        else:
            merged.append((start, n))
    if merged == [(0, w.shape[-1])]:
        return w
    return torch.cat([w[..., s:s + n] for s, n in merged], dim=-1)


# ---------------------------------------------------------------------------
# GLU MLP
# ---------------------------------------------------------------------------


def init_mlp(b: ParamBuilder, name: str, d: int, d_ff: int):
    b.add(f"{name}/wi_gate", (d, d_ff), ("embed", "mlp"))
    b.add(f"{name}/wi_up", (d, d_ff), ("embed", "mlp"))
    b.add(f"{name}/wo", (d_ff, d), ("mlp", "embed"))


def mlp(params, name: str, x):
    """GLU MLP; tensor parallel over d_ff on a model axis that divides
    d_model (the weights then hold the rank's columns of ``wi_*`` and
    rows of ``wo``)."""
    dt = x.dtype
    gate, up = column_parallel_in(
        x, [params[f"{name}/wi_gate"].to(dt), params[f"{name}/wi_up"].to(dt)])
    h = F.silu(gate) * up
    rp = _row_parallel_ctx()
    return row_parallel_out(h, params[f"{name}/wo"].to(dt),
                            rp is not None and x.shape[-1] % rp[1] == 0)


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
    """Top-k expert routing with per-expert capacity buffers.

    Under a context whose model axis m > 1 divides n_experts,
    :func:`_moe_shard_map` (expert parallel, capacity per data shard), in
    every mode, as JAX takes its ``shard_map`` whatever the mode.
    Otherwise ``_moe_dense`` over every token of the global batch (what
    ``moe`` runs without a sharding context): on a mesh, the tokens are
    all-gathered over 'data' (and, in train mode, the sequence over
    'model') first and the rank's own come back out.  x (B, S, d) ->
    (B, S, d)."""
    ctx = current_context()
    if ctx is None:
        return _moe_dense(params, name, cfg, x)
    m = ctx.mesh.axis_sizes().get("model", 1)
    if _row_parallel_ctx() is not None and cfg.n_experts % m == 0:
        return _moe_shard_map(params, name, cfg, x, ctx)
    if ctx.mode != "train":   # one token a step, the batch split over its rule's axes
        split = ((rule_axes(ctx, "batch"), (), ()), ((), (), ()))
        y = _moe_dense(params, name, cfg, coll.redistribute(x, ctx.mesh, *split))
        return coll.redistribute(y, ctx.mesh, *split[::-1])
    src = ("batch", "residual_seq", "embed") if m > 1 else ("batch", "seq", "embed")
    whole = (None, "seq", "embed")
    y = _moe_dense(params, name, cfg, constrain(x, whole, src))
    return constrain(y, src, whole)


def _moe_shard_map(params, name: str, cfg: ModelConfig, x, ctx):
    """Expert parallelism (``repro.models.layers._moe_shard_map``): x is
    the rank's (B/data, S/m, d) residual shard; its sequence is gathered
    over 'model', so the ranks of a model group route the same Tl tokens
    of their data shard, each with the capacity
    ``max(int(Tl k capacity_factor / E), 1)`` (not the global batch's),
    compute only their E/m experts, and all-gather the experts' outputs
    (E, cap + 1, d) over 'model' to combine them; each keeps its sequence
    slice.  The shared expert, if any, runs through :func:`mlp`."""
    mesh = ctx.mesh
    sp = ctx.mode == "train"    # a serving mode's token is whole over 'model'
    xg = constrain(x, ("batch", "seq", "embed"), ("batch", "residual_seq", "embed")) if sp else x
    Bl, Sl, d = xg.shape
    dt = xg.dtype
    Tl, k = Bl * Sl, cfg.top_k
    xt = xg.reshape(Tl, d)
    weights, expert, slot, keep, cap = moe_route(params, name, cfg, xt)
    token = torch.arange(Tl, device=x.device).repeat_interleave(k)
    buf = torch.zeros((cfg.n_experts, cap + 1, d), dtype=dt, device=x.device)
    buf = buf.index_put((expert, slot), xt[token], accumulate=True)
    wg = params[f"{name}/wi_gate"].to(dt)        # (E/m, d, ff): the rank's experts
    E_loc = wg.shape[0]
    my = buf.narrow(0, mesh.axis_index("model") * E_loc, E_loc)
    out_loc = torch.bmm(F.silu(torch.bmm(my, wg)) * torch.bmm(my, params[f"{name}/wi_up"].to(dt)),
                        params[f"{name}/wo"].to(dt))
    out_all = coll.all_gather(out_loc, mesh, "model", 0)   # (E, cap + 1, d)
    gathered = torch.where(keep[:, None], out_all[expert, slot], 0)
    y = (gathered * weights.reshape(-1, 1)).reshape(Tl, k, d).sum(dim=1)
    y = y.reshape(Bl, Sl, d)
    if sp:
        y = constrain(y, ("batch", "residual_seq", "embed"), ("batch", "seq", "embed"))
    if cfg.n_shared_experts:
        y = y + mlp(params, f"{name}/shared", x)
    return y


def _moe_dense(params, name: str, cfg: ModelConfig, x):
    """``repro.models.layers._moe_dense``: every token of x routed with one
    capacity for the call.  x (B, S, d) -> (B, S, d)."""
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
