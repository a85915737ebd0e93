"""Public kernel functions: the kernel on CUDA tensors, the plain version
on CPU tensors.

Where a tensor lies decides the path, and nothing else: a CPU tensor
goes to :mod:`.ref`; a CUDA tensor goes to the hand-written kernel, which
raises on what it does not take.  There is no fallback from one to the
other.
"""
from __future__ import annotations

import torch

from .flash_attention import flash_attention_cuda
from .ref import attention_ref, ssd_chunked
from .ssd import ssd_scan_cuda


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """Flash attention.  q (B,H,Sq,D); k/v (B,KV,Sk,D) -> (B,H,Sq,D)."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    return flash_attention_cuda(q, k, v, causal=causal, window=window, softcap=softcap)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bmat: torch.Tensor,
             Cmat: torch.Tensor, *, chunk: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD.  x (B,S,H,P), dt (B,S,H), A (H,), B/C (B,S,N) ->
    (y (B,S,H,P), final state (B,H,N,P) fp32)."""
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, A, Bmat, Cmat, chunk)
    return ssd_scan_cuda(x, dt, A, Bmat, Cmat, chunk=chunk)
