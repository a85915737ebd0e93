"""Mamba2 (SSD) mixing layer — the zamba2 backbone block.

Ports :mod:`repro.models.ssm`.  The chunked scan of a prompt goes
through :func:`repro_torch.kernels.ops.ssd_scan`: the hand-written kernel
on CUDA tensors, :func:`ssd_chunked` (re-exported here under its JAX
name) on CPU tensors.  A decode step is plain PyTorch on every device,
as in the JAX package, which has no kernel for it.

Under a train-mode sharding context whose model axis m divides the
number of SSM heads H, the block is tensor parallel over its heads, in
the Megatron-SP layout of :mod:`repro_torch.models.layers`: its input
(B, S/m, d) is gathered over the sequence once (``column_parallel_in``);
the rank multiplies by its columns of the whole ``in_proj`` (z and x for
its d_in/m channels, B and C whole, dt for its H/m heads), runs the
causal conv on those channels and the scan on its heads with B and C
whole, forms the gated RMSNorm's mean over d_in from its sum of squares
all-reduced over 'model', and reduce-scatters its rows' partial
products with ``out_proj`` (``row_parallel_out``).  B and C are shared
by every head, so each rank's gradient for them is a part, summed by the
reduce-scatter that is ``in_proj``'s gather's transpose.  Where m does
not divide H, every rank computes the whole block and keeps its
sequence slice.  Without a context (or on a model axis of 1) no
collective runs.

Shapes: B batch, S seq, H ssm heads, P head dim, N state dim, Q chunk.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssd_chunked
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import current_context

from .common import ModelConfig, ParamBuilder
from .layers import column_parallel_in, first_local_head, row_parallel_out, take_columns

__all__ = ["ssd_chunked", "ssd_decode_step", "init_mamba2", "mamba2_block",
           "mamba2_state_shapes"]


def ssd_decode_step(state, x, dt, A, Bmat, Cmat):
    """Single-token SSD update.  state: (B,H,N,P) fp32; x: (B,H,P);
    dt: (B,H); Bmat/Cmat: (B,N).  Returns (y (B,H,P), new_state)."""
    dtf = dt.float()
    decay = torch.exp(dtf * A.float())                                 # (B,H)
    outer = torch.einsum("bn,bhp->bhnp", Bmat.float(), x.float())
    new_state = state * decay[:, :, None, None] + dtf[:, :, None, None] * outer
    y = torch.einsum("bn,bhnp->bhp", Cmat.float(), new_state)
    return y.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# Mamba2 block (in_proj -> conv -> SSD -> gate -> out_proj)
# ---------------------------------------------------------------------------


def init_mamba2(b: ParamBuilder, name: str, cfg: ModelConfig):
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    H = d_in // cfg.ssm_head_dim
    N = cfg.ssm_state
    b.add(f"{name}/in_proj", (d, 2 * d_in + 2 * N + H), ("embed", "ssm_inner"))
    b.add(f"{name}/conv_w", (cfg.ssm_conv_width, d_in + 2 * N), ("conv", "ssm_inner"))
    b.add(f"{name}/conv_b", (d_in + 2 * N,), ("ssm_inner",), init="zeros")
    b.add(f"{name}/A_log", (H,), ("ssm_heads",), init="zeros")
    b.add(f"{name}/D", (H,), ("ssm_heads",), init="ones")
    b.add(f"{name}/dt_bias", (H,), ("ssm_heads",), init="zeros")
    b.add(f"{name}/norm_scale", (d_in,), ("ssm_inner",), init="ones")
    b.add(f"{name}/out_proj", (d_in, d), ("ssm_inner", "embed"))


def _causal_conv(x, w, b, state=None):
    """Causal depthwise conv; x (B,S,C), w (K,C).  With ``state`` (B,K-1,C)
    runs one decode step (S==1) and returns the updated state.

    A sum of K shifted slices, as in the JAX package (``F.conv1d`` would
    run an fp32 conv through cuDNN in TF32 on the card)."""
    K = w.shape[0]
    if state is None:
        xp = torch.cat([x.new_zeros((x.shape[0], K - 1, x.shape[2])), x], dim=1)
        out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(K))
        return F.silu(out + b), None
    xp = torch.cat([state.to(x.dtype), x], dim=1)                      # (B,K,C)
    out = sum(xp[:, i:i + 1] * w[i] for i in range(K))
    return F.silu(out + b), xp[:, 1:]


def _conv_tail(xbc, K: int):
    """The decode conv state after a prompt: its last K-1 pre-conv rows,
    left-padded with zeros when the prompt is shorter.  A copy: a view
    would keep the layer's whole in_proj output alive until the prefill
    ends."""
    B, S, C = xbc.shape
    if S >= K - 1:
        return xbc[:, S - (K - 1):].clone()
    return torch.cat([xbc.new_zeros((B, K - 1 - S, C)), xbc], dim=1)


def mamba2_block(params, name: str, cfg: ModelConfig, x, state=None,
                 collect_state: bool = False):
    """x: (B,S,d) (under tensor parallelism the rank's (B,S/m,d), and so
    is y).  state: None (a prompt) or dict {ssm, conv} (one decode
    step).  Returns (y (B,S,d), new_state): the updated {ssm, conv} in
    decode; with ``collect_state`` on a prompt, the {ssm, conv} a decode
    step would continue from (the scan's final state and the conv tail);
    else None."""
    d = x.shape[-1]
    dt_ = x.dtype
    d_in = cfg.ssm_expand * d
    H = d_in // cfg.ssm_head_dim
    P = cfg.ssm_head_dim
    N = cfg.ssm_state
    # the rank's heads (all of them without tensor parallelism) and channels
    Hl = params[f"{name}/A_log"].shape[0]
    h0 = first_local_head(Hl, H)
    c0, cl = h0 * P, Hl * P

    (proj,) = column_parallel_in(x, [take_columns(
        params[f"{name}/in_proj"].to(dt_),
        [(c0, cl), (d_in + c0, cl), (2 * d_in, 2 * N), (2 * d_in + 2 * N + h0, Hl)])])
    B, S = proj.shape[:2]   # the whole sequence, gathered over 'model'
    z, xbc, dt_raw = torch.split(proj, [cl, cl + 2 * N, Hl], dim=-1)
    conv_cols = [(c0, cl), (d_in, 2 * N)]
    conv_w = take_columns(params[f"{name}/conv_w"].to(dt_), conv_cols)
    conv_b = take_columns(params[f"{name}/conv_b"].to(dt_), conv_cols)
    conv_state = state["conv"] if state is not None else None
    conv_out, new_conv = _causal_conv(xbc, conv_w, conv_b, conv_state)
    # Views into conv_out, handed to the scan kernel without a copy.
    xs, Bmat, Cmat = torch.split(conv_out, [cl, N, N], dim=-1)
    xh = xs.reshape(B, S, Hl, P)
    dt = F.softplus(dt_raw.float() + params[f"{name}/dt_bias"].float())   # (B,S,Hl)
    A = -torch.exp(params[f"{name}/A_log"].float())                     # (Hl,)

    new_state = None
    if state is None:
        y, final = ops.ssd_scan(xh, dt, A, Bmat, Cmat, chunk=cfg.ssm_chunk)
        if collect_state:
            new_state = {"ssm": final, "conv": _conv_tail(xbc, conv_w.shape[0])}
    else:
        y1, new_ssm = ssd_decode_step(state["ssm"], xh[:, 0], dt[:, 0], A,
                                      Bmat[:, 0], Cmat[:, 0])
        y = y1[:, None]
        new_state = {"ssm": new_ssm, "conv": new_conv}
    y = y + xh * params[f"{name}/D"].to(dt_)[None, None, :, None]
    y = y.reshape(B, S, cl)

    # gated RMSNorm (Mamba-2's norm-before-out), its mean over all d_in
    yf = y.float() * F.silu(z.float())
    if Hl < H:   # the rank's sum of squares, summed over 'model'
        mesh = current_context().mesh
        var = coll.all_reduce(torch.sum(torch.square(yf), dim=-1, keepdim=True),
                              mesh, "model") / d_in
    else:
        var = torch.mean(torch.square(yf), dim=-1, keepdim=True)
    yf = yf * torch.rsqrt(var + cfg.norm_eps)
    y = (yf * params[f"{name}/norm_scale"].float()).to(dt_)
    return row_parallel_out(y, params[f"{name}/out_proj"].to(dt_), Hl < H), new_state


def mamba2_state_shapes(cfg: ModelConfig, batch: int) -> dict:
    d_in = cfg.ssm_expand * cfg.d_model
    H = d_in // cfg.ssm_head_dim
    return {
        "ssm": (batch, H, cfg.ssm_state, cfg.ssm_head_dim),
        "conv": (batch, cfg.ssm_conv_width - 1, d_in + 2 * cfg.ssm_state),
    }
