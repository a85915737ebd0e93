"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, chunked
parallel form) and sLSTM (scalar memory, sequential recurrence).

Ports :mod:`repro.models.xlstm`.  The chunked mLSTM scan of a prompt
goes through :func:`repro_torch.kernels.ops.mlstm_scan`: the hand-written
kernel on CUDA tensors, :func:`mlstm_chunked` (re-exported here under its
JAX name) on CPU tensors.  An mLSTM decode step is plain PyTorch on every
device, as in the JAX package, which has no kernel for it.  The sLSTM
runs its recurrence as a Python loop over the sequence (the JAX
package's ``lax.scan``; it has no kernel either).

Under a sharding context whose model axis m divides the head
count H, both blocks are tensor parallel over their heads, in the
Megatron-SP layout of :mod:`repro_torch.models.layers`: the input (B,
S/m, d) is gathered over the sequence once (``column_parallel_in``) and
the output's partial sums reduce-scattered back (``row_parallel_out``).
The mLSTM takes ``up``'s xm columns whole (they are the contraction of
q, k, v and the gates) and z's for its heads, computes q, k, v and the
two gates of its H/m heads, scans them and multiplies by its rows of
``down``.  The sLSTM takes the gate-major columns of ``w_in`` and
``bias`` of its heads and runs the recurrence on them (``r`` is
block-diagonal over heads); its FFN needs every feature, so the rank's
(B, S, d/m) output is all-gathered over 'model' on the feature dim, and
the FFN is then tensor parallel over its width where m divides it (else
whole, each rank keeping its sequence slice).  In a serving mode
(``decode``, ``long``) a decode step keeps the same head split on the
whole token, its recurrent states the rank's heads of the cache's (the
cache splits ``xlstm_heads`` over 'model'), and the row-parallel
products are all-reduced.  Where m does not divide H, a block runs whole
on every rank.  Without a context (or on a model
axis of 1) no collective runs.

Shapes: B batch, S seq, H heads, D = K = V head dim, Q chunk.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import abstract, ops
from repro_torch.kernels.abstract import is_abstract
from repro_torch.kernels.ref import mlstm_chunked
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import current_context

from .common import ModelConfig, ParamBuilder
from .layers import column_parallel_in, first_local_head, row_parallel_out, take_columns

__all__ = ["mlstm_chunked", "mlstm_decode_step", "init_mlstm_block", "mlstm_block",
           "mlstm_state_shapes", "init_slstm_block", "slstm_block", "slstm_state_shapes"]


def mlstm_decode_step(state, q, k, v, i_gate, f_gate):
    """One decode step.  state: (S (B,H,D,D), n (B,H,D), m (B,H)) fp32;
    q,k,v (B,H,D); gates (B,H).  Returns (h (B,H,D), new_state)."""
    S_p, n_p, m_p = state
    qf = q.float() / math.sqrt(q.shape[-1])
    kf = k.float()
    logf = F.logsigmoid(f_gate.float())
    ig = i_gate.float()
    m_new = torch.maximum(logf + m_p, ig)
    scale_old = torch.exp(logf + m_p - m_new)
    wt = torch.exp(ig - m_new)
    S_new = S_p * scale_old[:, :, None, None] + wt[:, :, None, None] * torch.einsum(
        "bhk,bhv->bhkv", kf, v.float())
    n_new = n_p * scale_old[:, :, None] + wt[:, :, None] * kf
    num = torch.einsum("bhk,bhkv->bhv", qf, S_new)
    den = torch.einsum("bhk,bhk->bh", qf, n_new)
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return h.to(q.dtype), (S_new, n_new, m_new)


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------


def init_mlstm_block(b: ParamBuilder, name: str, cfg: ModelConfig):
    d = cfg.d_model
    dp = int(cfg.xlstm_proj_factor * d)
    b.add(f"{name}/up", (d, 2 * dp), ("embed", "xlstm_inner"))
    b.add(f"{name}/wq", (dp, dp), ("xlstm_inner", "xlstm_heads"))
    b.add(f"{name}/wk", (dp, dp), ("xlstm_inner", "xlstm_heads"))
    b.add(f"{name}/wv", (dp, dp), ("xlstm_inner", "xlstm_heads"))
    b.add(f"{name}/w_if", (dp, 2 * cfg.n_heads), ("xlstm_inner", "xlstm_heads"))
    b.add(f"{name}/out_scale", (dp,), ("xlstm_inner",), init="ones")
    b.add(f"{name}/down", (dp, d), ("xlstm_inner", "embed"))


def mlstm_block(params, name: str, cfg: ModelConfig, x, state=None,
                collect_state: bool = False):
    """x (B,S,d) -> (y (B,S,d), new_state); under tensor parallelism x and
    y are the rank's (B,S/m,d).  state: None (a prompt) or
    (S, n, m) (one decode step).  new_state is the updated (S, n, m) in
    decode; with ``collect_state`` on a prompt, the scan's final (S, n, m),
    which a decode step continues from; else None."""
    d = x.shape[-1]
    dt_ = x.dtype
    dp = int(cfg.xlstm_proj_factor * d)
    H = cfg.n_heads
    D = dp // H
    Hl = params[f"{name}/wq"].shape[-1] // D    # the rank's heads
    h0 = first_local_head(Hl, H)

    (up,) = column_parallel_in(x, [take_columns(params[f"{name}/up"].to(dt_),
                                                [(0, dp), (dp + h0 * D, Hl * D)])])
    B, S = up.shape[:2]     # the whole sequence, gathered over 'model'
    xm, z = torch.split(up, [dp, Hl * D], dim=-1)
    q = (xm @ params[f"{name}/wq"].to(dt_)).reshape(B, S, Hl, D)
    k = (xm @ params[f"{name}/wk"].to(dt_)).reshape(B, S, Hl, D)
    v = (xm @ params[f"{name}/wv"].to(dt_)).reshape(B, S, Hl, D)
    # In the compute dtype, as in the JAX package; the scan takes them to fp32.
    # Views of one (B,S,2Hl) tensor, handed to the scan kernel without a copy.
    gates = xm @ take_columns(params[f"{name}/w_if"].to(dt_), [(h0, Hl), (H + h0, Hl)])
    i_gate, f_gate = torch.split(gates, Hl, dim=-1)

    new_state = None
    if state is None:
        h, final = ops.mlstm_scan(q, k, v, i_gate, f_gate, chunk=cfg.xlstm_chunk)
        if collect_state:
            new_state = final
    else:
        h1, new_state = mlstm_decode_step(state, q[:, 0], k[:, 0], v[:, 0],
                                          i_gate[:, 0], f_gate[:, 0])
        h = h1[:, None]
    h = h.reshape(B, S, Hl * D)
    h = h * F.silu(z)
    h = h * params[f"{name}/out_scale"].to(dt_)
    return row_parallel_out(h, params[f"{name}/down"].to(dt_), Hl < H), new_state


def mlstm_state_shapes(cfg: ModelConfig, batch: int) -> dict:
    dp = int(cfg.xlstm_proj_factor * cfg.d_model)
    H = cfg.n_heads
    D = dp // H
    return {"S": (batch, H, D, D), "n": (batch, H, D), "m": (batch, H)}


# ---------------------------------------------------------------------------
# sLSTM block (sequential scalar recurrence with block-diagonal R)
# ---------------------------------------------------------------------------


def init_slstm_block(b: ParamBuilder, name: str, cfg: ModelConfig):
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    b.add(f"{name}/w_in", (d, 4 * d), ("embed", "xlstm_inner"))
    b.add(f"{name}/r", (4, H, dh, dh), (None, "xlstm_heads", None, None),
          scale=1.0 / math.sqrt(dh))
    b.add(f"{name}/bias", (4 * d,), ("xlstm_inner",), init="zeros")
    ff = _ffn_width(d)
    b.add(f"{name}/ff_gate", (d, ff), ("embed", "mlp"))
    b.add(f"{name}/ff_up", (d, ff), ("embed", "mlp"))
    b.add(f"{name}/ff_down", (ff, d), ("mlp", "embed"))


def _ffn_width(d: int) -> int:
    """The sLSTM FFN's width: proj factor 4/3, per the paper's sLSTM block."""
    return max(int(4 * d / 3), 1)


def slstm_block(params, name: str, cfg: ModelConfig, x, state=None,
                collect_state: bool = False):
    """sLSTM with exp gating and a stabiliser state; x (B,S,d) (under
    tensor parallelism the rank's (B,S/m,d), and so is y).  state:
    None (zeros) or (c, n, h, m), each (B,H,dh) fp32.  Returns (y, new_state):
    the final (c, n, h, m) when a state was given or ``collect_state``;
    else None."""
    d = x.shape[-1]
    dt_ = x.dtype
    H = cfg.n_heads
    dh = d // H
    Hl = params[f"{name}/r"].shape[1]               # the rank's heads
    h0 = first_local_head(Hl, H)
    cols = [(g * d + h0 * dh, Hl * dh) for g in range(4)]   # gate-major (4, H, dh)

    (pre,) = column_parallel_in(x, [take_columns(params[f"{name}/w_in"].to(dt_), cols)])
    B, S = pre.shape[:2]    # the whole sequence, gathered over 'model'
    pre = pre + take_columns(params[f"{name}/bias"].to(dt_), cols)
    pre = pre.reshape(B, S, 4, Hl, dh).float()
    R = params[f"{name}/r"].float()                      # (4,Hl,dh,dh)

    if state is None:
        c, n, h, m = (torch.zeros((B, Hl, dh), dtype=torch.float32, device=x.device)
                      for _ in range(4))
    else:
        c, n, h, m = state

    hs, (c, n, h, m) = _slstm_scan(pre, R, (c, n, h, m))
    y = hs.reshape(B, S, Hl * dh).to(dt_)
    if Hl < H:   # the FFN reads every feature
        y = coll.all_gather(y, current_context().mesh, "model", 2)

    # post-recurrence gated FFN; jax.nn.gelu's default is the tanh approximation.
    w_down = params[f"{name}/ff_down"].to(dt_)
    gate = y @ params[f"{name}/ff_gate"].to(dt_)
    upv = y @ params[f"{name}/ff_up"].to(dt_)
    hmid = F.gelu(gate, approximate="tanh") * upv
    out = row_parallel_out(hmid, w_down, w_down.shape[0] < _ffn_width(d))
    new_state = (c, n, h, m) if (state is not None or collect_state) else None
    return out, new_state


def _slstm_scan(pre, R, state):
    """The sLSTM recurrence: pre (B,S,4,Hl,dh) fp32 gate preactivations
    (z, i, f, o), R (4,Hl,dh,dh) fp32, state (c, n, h, m) each (B,Hl,dh).
    Returns (h of every step (B,S,Hl,dh), the final (c, n, h, m)).  On
    abstract tensors, :class:`_SlstmScanAbstract`."""
    if is_abstract(pre):
        hs, *final = _SlstmScanAbstract.apply(pre, R, *state)
        return hs, tuple(final)
    c, n, h, m = state
    B, _, _, Hl, dh = pre.shape
    # R as (Hl, dh, 4 dh) once: each step's h R is one batched product over
    # the heads, with no copy of R a step for its backward to keep
    Rh = R.permute(1, 2, 0, 3).reshape(Hl, dh, 4 * dh)
    hs = []
    for pre_t in pre.unbind(1):
        rec = torch.bmm(h.transpose(0, 1), Rh).reshape(Hl, B, 4, dh).permute(1, 2, 0, 3)
        zt, it, ft, ot = (pre_t + rec).unbind(1)
        zt, ot = torch.tanh(zt), torch.sigmoid(ot)
        m_new = torch.maximum(ft + m, it)                # stabiliser
        i_p = torch.exp(it - m_new)
        f_p = torch.exp(ft + m - m_new)
        c = f_p * c + i_p * zt
        n = f_p * n + i_p
        h = ot * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), (c, n, h, m)


# What the recurrence's autograd keeps for the backward, a step, beside
# the stacked output: this many (B, Hl, dh) fp32 tensors
# (tests/test_torch_dryrun.py holds the abstract recurrence's bytes to the
# loop's on real tensors).
SLSTM_SAVED_PER_STEP = 14


def _slstm_flops(B: int, S: int, Hl: int, dh: int) -> int:
    """The recurrence's products, a step ``h R``: 2 B 4 Hl dh dh."""
    return 2 * B * S * 4 * Hl * dh * dh


class _SlstmScanAbstract(torch.autograd.Function):
    """The recurrence on abstract tensors (the dry run): the loop's
    outputs and, under grad, tensors of the bytes its autograd keeps (R's
    copy as one batched operand, and ``SLSTM_SAVED_PER_STEP`` step tensors,
    each rounded to the CUDA allocator's 512-byte blocks), without running S steps of Python (the
    JAX package's dry run counts its ``lax.scan`` body times its trip
    count the same way).  Its FLOPs are recorded as the loop's: ``h R``
    each step, forward; in the backward both operands' products, but the
    first step's h when the initial state takes no gradient."""

    @staticmethod
    def forward(ctx, pre, R, c, n, h, m):
        B, S, _, Hl, dh = pre.shape
        step = math.ceil(B * Hl * dh * 4 / 512) * 512 // 4
        if any(ctx.needs_input_grad):   # R's (Hl, dh, 4 dh) copy and the steps' tensors
            ctx.held = (R.new_empty(R.shape), pre.new_empty((S * SLSTM_SAVED_PER_STEP * step,)))
        ctx.shapes = (pre.shape, R.shape, h.shape, ctx.needs_input_grad[2:])
        abstract.record("slstm_recurrence", _slstm_flops(B, S, Hl, dh), launches=0)
        return (pre.new_empty((B, S, Hl, dh)),) + tuple(pre.new_empty((B, Hl, dh))
                                                      for _ in range(4))

    @staticmethod
    def backward(ctx, dhs, dc, dn, dh_, dm):
        pre_shape, R_shape, state_shape, state_grad = ctx.shapes
        B, S, _, Hl, dh = pre_shape
        flops = 2 * _slstm_flops(B, S, Hl, dh)
        if not state_grad[2]:
            flops -= _slstm_flops(B, 1, Hl, dh)
        abstract.record("slstm_recurrence_bwd", flops, launches=0)
        grads = (dhs.new_empty(pre_shape), dhs.new_empty(R_shape),
                 *(dhs.new_empty(state_shape) if g else None for g in state_grad))
        del ctx.held   # the loop's saved tensors go as its backward passes them
        return grads


def slstm_state_shapes(cfg: ModelConfig, batch: int) -> tuple:
    H = cfg.n_heads
    dh = cfg.d_model // H
    s = (batch, H, dh)
    return (s, s, s, s)
