"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, chunked
parallel form) and sLSTM (scalar memory, sequential recurrence).

Ports :mod:`repro.models.xlstm`.  The chunked mLSTM scan of a prompt
goes through :func:`repro_torch.kernels.ops.mlstm_scan`: the hand-written
kernel on CUDA tensors, :func:`mlstm_chunked` (re-exported here under its
JAX name) on CPU tensors.  An mLSTM decode step is plain PyTorch on every
device, as in the JAX package, which has no kernel for it.  The sLSTM
runs its recurrence as a Python loop over the sequence (the JAX
package's ``lax.scan``; it has no kernel either).

Under a train-mode sharding context whose model axis m divides the head
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
whole, each rank keeping its sequence slice).  Where m does not divide
H, a block runs whole on every rank.  Without a context (or on a model
axis of 1) no collective runs.

Shapes: B batch, S seq, H heads, D = K = V head dim, Q chunk.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
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

    hs = []
    for t in range(S):
        pre_t = pre[:, t]
        rec = torch.einsum("bhj,ghjk->bghk", h, R)      # (B,4,Hl,dh)
        zt = torch.tanh(pre_t[:, 0] + rec[:, 0])
        it = pre_t[:, 1] + rec[:, 1]
        ft = pre_t[:, 2] + rec[:, 2]
        ot = torch.sigmoid(pre_t[:, 3] + rec[:, 3])
        m_new = torch.maximum(ft + m, it)                # stabiliser
        i_p = torch.exp(it - m_new)
        f_p = torch.exp(ft + m - m_new)
        c = f_p * c + i_p * zt
        n = f_p * n + i_p
        h = ot * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    y = torch.stack(hs, dim=1).reshape(B, S, Hl * dh).to(dt_)
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


def slstm_state_shapes(cfg: ModelConfig, batch: int) -> tuple:
    H = cfg.n_heads
    dh = cfg.d_model // H
    s = (batch, H, dh)
    return (s, s, s, s)
