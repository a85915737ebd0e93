"""Gradient compression for cross-pod reduction (ports :mod:`repro.optim.compression`).

int8 block quantization with error feedback: gradients are quantized
before the (slow, cross-pod) all-reduce and the quantization residual is
carried into the next step, preserving convergence (1-bit Adam lineage):
4x fewer gradient bytes on the 'pod' axis.  Pure numerics on dicts of
tensors, as the JAX module is on pytrees; nothing on the train path calls
it (the JAX package's does not either).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F


class CompressionState(NamedTuple):
    error: dict   # residual feedback, keyed like the grads


def compression_init(grads_like: dict) -> CompressionState:
    return CompressionState(error={k: torch.zeros_like(g) for k, g in grads_like.items()})


def quantize_int8(x: torch.Tensor, block: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8 quantization; returns (q (n_blocks, block)
    int8, scales (n_blocks, 1) fp32).  The last block is zero-padded;
    rounding is half to even (``jnp.round``)."""
    flat = x.reshape(-1)
    blocks = F.pad(flat, (0, (-flat.numel()) % block)).reshape(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape, dtype) -> torch.Tensor:
    out = (q.float() * scale).reshape(-1)
    return out[:math.prod(shape)].reshape(shape).to(dtype)


def compress_grads(grads: dict, state: CompressionState, block: int = 256
                   ) -> tuple[dict, CompressionState]:
    """Quantize grads (+error feedback); returns (the dequantized grads that
    would come out of the compressed all-reduce, the new state)."""
    deq, err = {}, {}
    for k, g in grads.items():
        e = state.error[k]
        g_fb = g.float() + e.float()
        q, s = quantize_int8(g_fb, block)
        d = dequantize_int8(q, s, g.shape, torch.float32)
        err[k] = (g_fb - d).to(e.dtype)
        deq[k] = d.to(g.dtype)
    return deq, CompressionState(error=err)


def compressed_bytes(grads: dict, block: int = 256) -> tuple[int, int]:
    """(raw_bytes, compressed_bytes) for reporting: the int8 payload and
    one fp32 scale per block."""
    raw = comp = 0
    for g in grads.values():
        n = g.numel()
        raw += n * g.element_size()
        comp += n * 1 + -(-n // block) * 4
    return raw, comp
