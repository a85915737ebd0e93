"""Plain PyTorch versions of the kernels (the CPU path and the oracles).

Each function computes what its JAX counterpart computes
(:mod:`repro.kernels.ref`; ``ssd_chunked`` is ``repro.models.ssm``'s),
in fp32, on any device; the CUDA kernels are held against them on the
card.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0, softcap: float = 0.0):
    """q (B,H,Sq,D); k/v (B,KV,Sk,D); returns (B,H,Sq,D).  fp32 math.

    Scale 1/sqrt(D); tanh softcap before the mask; causal ``k_pos <= q_pos``
    and window ``k_pos > q_pos - window`` count from 0 at the top left; a
    fully masked row gives 0; the output has q's dtype.
    """
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    group = H // KV
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) / math.sqrt(D)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)  # fully-masked rows
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


def ssd_ref(x, dt, A, Bmat, Cmat):
    """Sequential SSD recurrence (the definitional oracle).

    x (B,S,H,P); dt (B,S,H); A (H,); Bmat/Cmat (B,S,N).
    Returns y (B,S,H,P) in x's dtype, final state (B,H,N,P) in fp32.
    """
    B, S, H, P = x.shape
    N = Bmat.shape[-1]
    xf, dtf, Bf, Cf, Af = x.float(), dt.float(), Bmat.float(), Cmat.float(), A.float()
    state = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * Af)                                  # (B,H)
        outer = torch.einsum("bn,bhp->bhnp", Bf[:, t], xf[:, t])
        state = state * decay[:, :, None, None] + dtf[:, t, :, None, None] * outer
        ys.append(torch.einsum("bn,bhnp->bhp", Cf[:, t], state))
    return torch.stack(ys, dim=1).to(x.dtype), state


def ssd_chunked(x, dt, A, Bmat, Cmat, chunk: int):
    """Chunked SSD: y_t = C_t . S_t,  S_t = exp(A dt_t) S_{t-1} + dt_t B_t x_t^T.

    The plain version of the SSD kernel (``repro.models.ssm.ssd_chunked``):
    x (B,S,H,P); dt (B,S,H) positive (post-softplus); A (H,) negative;
    Bmat/Cmat (B,S,N), shared across heads.  Returns y (B,S,H,P) in x's
    dtype and the final state (B,H,N,P) in fp32.

    Where S is not a multiple of ``chunk`` (the JAX function asserts), the
    tail is padded with dt = x = B = C = 0 and y cut back: a padded step
    neither decays the state nor adds to it, so this is exact.
    """
    B, S, H, P = x.shape
    N = Bmat.shape[-1]
    Q = chunk
    pad = (-S) % Q
    xf, dtf, Bf, Cf = x.float(), dt.float(), Bmat.float(), Cmat.float()
    if pad:
        xf = F.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        Bf = F.pad(Bf, (0, 0, 0, pad))
        Cf = F.pad(Cf, (0, 0, 0, pad))
    nc = (S + pad) // Q
    xq = xf.reshape(B, nc, Q, H, P)
    dtq = dtf.reshape(B, nc, Q, H)
    Bq = Bf.reshape(B, nc, Q, N)
    Cq = Cf.reshape(B, nc, Q, N)

    dA = dtq * A.float()                                  # (B,nc,Q,H), negative
    cum = torch.cumsum(dA, dim=2)                         # within-chunk log decay

    # intra-chunk: decay(i,j) = exp(cum_i - cum_j) for j <= i.  Masked with
    # where(): above the diagonal cum_i - cum_j > 0 and exp can overflow.
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,Q,Q,H)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    decay = torch.where(mask[None, None, :, :, None], torch.exp(diff),
                        torch.zeros((), device=x.device))
    cb = torch.einsum("bcin,bcjn->bcij", Cq, Bq)
    w = cb[..., None] * decay * dtq[:, :, None, :, :]     # (B,nc,Q,Q,H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w, xq)

    # chunk summaries: the state each chunk contributes, decayed to its end
    total = cum[:, :, -1:, :]                             # (B,nc,1,H)
    rem = torch.exp(total - cum)
    contrib = torch.einsum("bcjh,bcjn,bcjhp->bchnp", rem * dtq, Bq, xq)

    # inter-chunk scan: the state before each chunk
    chunk_decay = torch.exp(total[:, :, 0, :])            # (B,nc,H)
    state = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + contrib[:, c]
    prev_states = torch.stack(prev, dim=1)                # (B,nc,H,N,P)

    y_inter = torch.einsum("bcin,bchnp->bcihp", Cq, prev_states) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(B, nc * Q, H, P)[:, :S]
    return y.to(x.dtype), state
