"""Wrapper of the Hopper flash-attention kernel (``csrc/flash_attention.cu``).

The kernel replaces ``repro/kernels/flash_attention.py::_attn_kernel``
(the Pallas TPU kernel) and computes the same function as
:func:`repro_torch.kernels.ref.attention_ref`.  Layouts are the JAX
package's: q (B,H,Sq,D); k/v (B,KV,Sk,D); out (B,H,Sq,D).  Inputs may be
strided views (the model passes its (B,S,H,D) activations and
(B,S_max,KV,D) cache slices transposed, without a copy); the output is
allocated as a (B,Sq,H,D) tensor and returned as its (B,H,Sq,D) view, the
layout the model's output projection reads.

``launches`` counts the kernel's launches; nothing else changes it.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

SUPPORTED_D = (16, 32, 64, 80, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("flash_attention").flash_attention_fwd
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [P, P, P, P, I, I, I, I, I, I, I] + [L] * 12 + [
            I, I, ctypes.c_float, ctypes.c_float, P]
        fn.restype = I
        _fn = fn
    return _fn


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, device: torch.device):
    if t.device != device:
        raise ValueError(f"flash_attention: {name} is on {t.device}, q on {device}")
    if t.dtype != dtype:
        raise TypeError(f"flash_attention: {name} is {t.dtype}, q is {dtype}")
    if t.stride(-1) != 1:
        raise ValueError(f"flash_attention: {name}'s last axis must be contiguous")
    vec = 16 // t.element_size()
    if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:-1]):
        raise ValueError(f"flash_attention: {name} must be 16-byte aligned "
                         f"(pointer and strides), got strides {t.stride()}")


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; raises on what it does not take."""
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda takes CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention: dtype {q.dtype} not supported "
                        f"(float32, bfloat16)")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be 4-D")
    B, H, Sq, D = q.shape
    _, KV, Sk, _ = k.shape
    if k.shape != (B, KV, Sk, D) or v.shape != k.shape or H % KV:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if D not in SUPPORTED_D:
        raise ValueError(f"flash_attention: head dim {D} not in {SUPPORTED_D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q.dtype, q.device)
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[q.dtype], B, H, KV, Sq, Sk, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            int(bool(causal)), int(window), float(softcap), 1.0 / math.sqrt(D), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
