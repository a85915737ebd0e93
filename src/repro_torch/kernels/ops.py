"""Public kernel functions: the kernel on CUDA tensors, the plain version
on CPU tensors.

Where a tensor lies decides the path, and nothing else: a CPU tensor
goes to :mod:`.ref`; a CUDA tensor goes to the hand-written kernel, which
raises on what it does not take; an abstract tensor (meta, or a
FakeTensor: :mod:`.abstract`) takes the kernel's path, whose wrappers give
outputs of the kernel's shapes and record the call for the dry run.
There is no fallback from one to the other.  On the card, a call whose inputs need a gradient (grad mode on
and an input that requires it) goes through the kernel's autograd
Function (:class:`~.flash_attention.FlashAttentionFunction`,
:class:`~.ssd.SsdScanFunction`, :class:`~.mlstm.MlstmScanFunction`: the
forward kernel, then the backward kernel); without one it launches the
forward directly, with no autograd bookkeeping.
"""
from __future__ import annotations

import torch

from .abstract import is_abstract
from .flash_attention import (FlashAttentionFunction, flash_attention_cuda,
                              flash_attention_lse_cuda)
from .mlstm import MlstmScanFunction, mlstm_scan_cuda
from .ref import attention_lse_ref, attention_ref, mlstm_chunked, ssd_chunked
from .ssd import SsdScanFunction, ssd_scan_cuda


def _plain(t: torch.Tensor) -> bool:
    """The plain version's case: a CPU tensor that holds data."""
    return t.device.type == "cpu" and not is_abstract(t)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """Flash attention.  q (B,H,Sq,D); k/v (B,KV,Sk,D) -> (B,H,Sq,D)."""
    if _plain(q):
        return attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, causal, window, softcap)
    return flash_attention_cuda(q, k, v, causal=causal, window=window, softcap=softcap)


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Flash attention and each row's log-sum-exp: q (B,H,Sq,D); k/v
    (B,KV,Sk,D) -> (out (B,H,Sq,D), lse (B,H,Sq) fp32, -inf where a row
    admits no key).  No gradient: it serves decode steps."""
    if _plain(q):
        return attention_lse_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    return flash_attention_lse_cuda(q, k, v, causal=causal, window=window, softcap=softcap)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bmat: torch.Tensor,
             Cmat: torch.Tensor, *, chunk: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD.  x (B,S,H,P), dt (B,S,H), A (H,), B/C (B,S,N) ->
    (y (B,S,H,P), final state (B,H,N,P) fp32)."""
    if _plain(x):
        return ssd_chunked(x, dt, A, Bmat, Cmat, chunk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, Bmat, Cmat)):
        return SsdScanFunction.apply(x, dt, A, Bmat, Cmat, chunk)
    return ssd_scan_cuda(x, dt, A, Bmat, Cmat, chunk=chunk)


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, i_gate: torch.Tensor,
               f_gate: torch.Tensor, *, chunk: int = 128):
    """Chunked stabilised mLSTM.  q/k/v (B,S,H,D), gates (B,S,H) ->
    (h (B,S,H,D), final (S (B,H,D,D), n (B,H,D), m (B,H)) fp32)."""
    if _plain(q):
        return mlstm_chunked(q, k, v, i_gate, f_gate, chunk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, i_gate, f_gate)):
        h, S_f, n_f, m_f = MlstmScanFunction.apply(q, k, v, i_gate, f_gate, chunk)
        return h, (S_f, n_f, m_f)
    return mlstm_scan_cuda(q, k, v, i_gate, f_gate, chunk=chunk)
