"""Plain PyTorch versions of the kernels (the CPU path and the oracles).

Each function computes what :mod:`repro.kernels.ref` computes, in fp32,
on any device; the CUDA kernels are held against them on the card.
"""
from __future__ import annotations

import math

import torch


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
