"""Plain PyTorch versions of the kernels (the CPU path and the oracles).

Each function computes what its JAX counterpart computes
(:mod:`repro.kernels.ref`; ``ssd_chunked`` is ``repro.models.ssm``'s,
``mlstm_chunked`` ``repro.models.xlstm``'s), in fp32 (in fp64 when given
fp64 inputs, so that a check can measure fp32's own rounding against
it), on any device; the CUDA kernels are held against them on the card.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _wide(t):
    """The working precision: fp32, or fp64 for fp64 inputs."""
    return t if t.dtype == torch.float64 else t.float()


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


def attention_lse_ref(q, k, v, *, causal: bool = True, window: int = 0,
                      softcap: float = 0.0):
    """:func:`attention_ref` and each row's log-sum-exp, from one product
    Q K^T: (out (B,H,Sq,D) in q's dtype, lse (B,H,Sq) fp32), lse the
    logsumexp of the row's scaled, soft-capped scores over the keys its
    mask admits, -inf where it admits none (that row's output is 0)."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    group = H // KV
    kf = _wide(k).repeat_interleave(group, dim=1)
    vf = _wide(v).repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", _wide(q), kf) / math.sqrt(D)
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
    lse = torch.logsumexp(s, dim=-1)
    p = torch.nan_to_num(torch.exp(s - lse[..., None]), nan=0.0)   # fully-masked rows
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype), lse


def ssd_ref(x, dt, A, Bmat, Cmat):
    """Sequential SSD recurrence (the definitional oracle).

    x (B,S,H,P); dt (B,S,H); A (H,); Bmat/Cmat (B,S,N).
    Returns y (B,S,H,P) in x's dtype, final state (B,H,N,P) in fp32.
    """
    B, S, H, P = x.shape
    N = Bmat.shape[-1]
    xf, dtf, Bf, Cf, Af = (_wide(t) for t in (x, dt, Bmat, Cmat, A))
    state = torch.zeros((B, H, N, P), dtype=xf.dtype, device=x.device)
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
    xf, dtf, Bf, Cf = (_wide(t) for t in (x, dt, Bmat, Cmat))
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

    dA = dtq * _wide(A)                                   # (B,nc,Q,H), negative
    cum = torch.cumsum(dA, dim=2)                         # within-chunk log decay

    # intra-chunk: decay(i,j) = exp(cum_i - cum_j) for j <= i.  Masked before
    # the exp: above the diagonal cum_i - cum_j > 0 and exp can overflow to
    # inf, which where() after the exp (JAX's ssd_chunked) hides from the
    # forward but not from the gradient (0 x inf = NaN); exp(-inf) = 0.
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,Q,Q,H)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    decay = torch.exp(diff.masked_fill(~mask[None, None, :, :, None], float("-inf")))
    cb = torch.einsum("bcin,bcjn->bcij", Cq, Bq)
    w = cb[..., None] * decay * dtq[:, :, None, :, :]     # (B,nc,Q,Q,H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w, xq)

    # chunk summaries: the state each chunk contributes, decayed to its end
    total = cum[:, :, -1:, :]                             # (B,nc,1,H)
    rem = torch.exp(total - cum)
    contrib = torch.einsum("bcjh,bcjn,bcjhp->bchnp", rem * dtq, Bq, xq)

    # inter-chunk scan: the state before each chunk
    chunk_decay = torch.exp(total[:, :, 0, :])            # (B,nc,H)
    state = torch.zeros((B, H, N, P), dtype=xf.dtype, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + contrib[:, c]
    prev_states = torch.stack(prev, dim=1)                # (B,nc,H,N,P)

    y_inter = torch.einsum("bcin,bchnp->bcihp", Cq, prev_states) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(B, nc * Q, H, P)[:, :S]
    return y.to(x.dtype), state


def mlstm_ref(q, k, v, i_gate, f_gate):
    """Sequential stabilised mLSTM (the definitional oracle).

    q/k/v (B,S,H,D); gates (B,S,H).  Returns h (B,S,H,D) in q's dtype and
    the final state (S (B,H,D,D), n (B,H,D), m (B,H)) in fp32 (the JAX
    oracle returns h only).
    """
    B, S, H, D = q.shape
    qf = _wide(q) / math.sqrt(D)
    kf, vf, ig = _wide(k), _wide(v), _wide(i_gate)
    logf = F.logsigmoid(_wide(f_gate))
    S_p = torch.zeros((B, H, D, D), dtype=qf.dtype, device=q.device)
    n_p = torch.zeros((B, H, D), dtype=qf.dtype, device=q.device)
    m_p = torch.full((B, H), float("-inf"), dtype=qf.dtype, device=q.device)
    hs = []
    for t in range(S):
        m_new = torch.maximum(logf[:, t] + m_p, ig[:, t])
        scale_old = torch.exp(logf[:, t] + m_p - m_new)
        wt = torch.exp(ig[:, t] - m_new)
        S_p = S_p * scale_old[:, :, None, None] + wt[:, :, None, None] * torch.einsum(
            "bhk,bhv->bhkv", kf[:, t], vf[:, t])
        n_p = n_p * scale_old[:, :, None] + wt[:, :, None] * kf[:, t]
        m_p = m_new
        num = torch.einsum("bhk,bhkv->bhv", qf[:, t], S_p)
        den = torch.einsum("bhk,bhk->bh", qf[:, t], n_p)
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None])
    return torch.stack(hs, dim=1).to(q.dtype), (S_p, n_p, m_p)


def mlstm_chunked(q, k, v, i_gate, f_gate, chunk: int):
    """Chunk-parallel stabilised mLSTM (exp input gate, sigmoid forget gate).

    The plain version of the mLSTM kernel (``repro.models.xlstm.mlstm_chunked``):
    q/k/v (B,S,H,D); i_gate (B,S,H) raw input-gate preactivation; f_gate
    (B,S,H) raw forget-gate preactivation.  Returns h (B,S,H,D) in q's
    dtype and the final state (S (B,H,D,D), n (B,H,D), m (B,H)) in fp32.

    Where S is not a multiple of ``chunk`` (the JAX function asserts), the
    tail is padded with q = k = v = 0, log-forget exactly 0 and input gate
    -inf, and h cut back: a padded step neither decays the state nor adds
    to it, so this is exact.
    """
    B, S, H, D = q.shape
    Q = chunk
    pad = (-S) % Q
    qf = _wide(q) / math.sqrt(D)
    kf, vf, ig = _wide(k), _wide(v), _wide(i_gate)
    logf = F.logsigmoid(_wide(f_gate))
    if pad:
        qf, kf, vf = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (qf, kf, vf))
        ig = F.pad(ig, (0, 0, 0, pad), value=float("-inf"))
        logf = F.pad(logf, (0, 0, 0, pad))   # log-forget 0: no decay
    nc = (S + pad) // Q
    qq = qf.reshape(B, nc, Q, H, D)
    kk = kf.reshape(B, nc, Q, H, D)
    vv = vf.reshape(B, nc, Q, H, D)
    ig = ig.reshape(B, nc, Q, H)
    logf = logf.reshape(B, nc, Q, H)

    b = torch.cumsum(logf, dim=2)                           # (B,nc,Q,H) incl. own f
    total = b[:, :, -1, :]                                  # (B,nc,H)

    # intra-chunk log weights: l_ij = b_i - b_j + i_j  (j <= i)
    diff = b[:, :, :, None, :] - b[:, :, None, :, :] + ig[:, :, None, :, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=q.device))
    diff = diff.masked_fill(~mask[None, None, :, :, None], float("-inf"))
    m_intra = diff.amax(dim=3)                              # (B,nc,Q,H)

    # state contribution log weights to the chunk's end: w_j = total - b_j + i_j
    w = total[:, :, None, :] - b + ig                       # (B,nc,Q,H)
    m_chunk = w.amax(dim=2)                                 # (B,nc,H)

    # inter-chunk scan: the state before each chunk
    S_p = torch.zeros((B, H, D, D), dtype=qf.dtype, device=q.device)
    n_p = torch.zeros((B, H, D), dtype=qf.dtype, device=q.device)
    m_p = torch.full((B, H), float("-inf"), dtype=qf.dtype, device=q.device)
    S_prev, n_prev, m_prev = [], [], []
    for c in range(nc):
        S_prev.append(S_p)
        n_prev.append(n_p)
        m_prev.append(m_p)
        m_new = torch.maximum(m_p + total[:, c], m_chunk[:, c])
        scale_old = torch.exp(m_p + total[:, c] - m_new)
        wts = torch.exp(w[:, c] - m_new[:, None, :])        # (B,Q,H)
        S_p = S_p * scale_old[:, :, None, None] + torch.einsum(
            "bqh,bqhk,bqhv->bhkv", wts, kk[:, c], vv[:, c])
        n_p = n_p * scale_old[:, :, None] + torch.einsum("bqh,bqhk->bhk", wts, kk[:, c])
        m_p = m_new
    S_prev = torch.stack(S_prev, dim=1)                     # (B,nc,H,D,D)
    n_prev = torch.stack(n_prev, dim=1)                     # (B,nc,H,D)
    m_prev = torch.stack(m_prev, dim=1)                     # (B,nc,H)

    # per-position stabiliser: the inter weight is m_prev + b_i
    m_i = torch.maximum(m_prev[:, :, None, :] + b, m_intra)     # (B,nc,Q,H)
    inter_scale = torch.exp(m_prev[:, :, None, :] + b - m_i)    # (B,nc,Q,H)
    num_inter = torch.einsum("bcqhk,bchkv->bcqhv", qq, S_prev) * inter_scale[..., None]
    den_inter = torch.einsum("bcqhk,bchk->bcqh", qq, n_prev) * inter_scale

    intra_w = torch.exp(diff - m_i[:, :, :, None, :])           # (B,nc,Q,Q,H)
    qkw = torch.einsum("bcihk,bcjhk->bcijh", qq, kk) * intra_w
    num_intra = torch.einsum("bcijh,bcjhv->bcihv", qkw, vv)
    den_intra = qkw.sum(dim=3)

    num = num_inter + num_intra
    den = den_inter + den_intra
    h = num / torch.maximum(den.abs(), torch.exp(-m_i))[..., None]
    h = h.reshape(B, nc * Q, H, D)[:, :S]
    return h.to(q.dtype), (S_p, n_p, m_p)
