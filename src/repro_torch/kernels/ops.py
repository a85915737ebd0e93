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
from .ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """Flash attention.  q (B,H,Sq,D); k/v (B,KV,Sk,D) -> (B,H,Sq,D)."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    return flash_attention_cuda(q, k, v, causal=causal, window=window, softcap=softcap)
