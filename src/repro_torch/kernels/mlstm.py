"""Wrapper of the Hopper chunked-mLSTM kernel (``csrc/mlstm.cu``).

The kernel replaces ``repro/kernels/mlstm.py::_mlstm_kernel`` (the Pallas
TPU kernel) and computes the same function as
:func:`repro_torch.kernels.ref.mlstm_chunked`: h and the final state.
Layouts are the JAX package's: q/k/v (B,S,H,D); i_gate/f_gate (B,S,H),
raw preactivations, in q's dtype.  q, k, v and the gates may be strided
views (the model passes the gates as the two halves of one (B,S,2H)
tensor, without a copy); h is allocated as a contiguous (B,S,H,D) tensor,
the state as S (B,H,D,D), n (B,H,D), m (B,H) in fp32.

``launches`` counts the kernel's launches; nothing else changes it.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

COLS = 32         # D: a multiple of 4 up to 32, or a multiple of 32 ...
MAX_D = 512       # ... up to 512
MAX_CHUNK = 128   # chunk: a multiple of 4 in [4, 128]
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("mlstm").mlstm_scan_fwd
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [P] * 9 + [I] * 6 + [L] * 18 + [P]
        fn.restype = I
        _fn = fn
    return _fn


def smem_bytes(chunk: int, D: int) -> int:
    """Dynamic shared memory a block of the kernel takes at these sizes
    (the kernel's own plan; needs the built library)."""
    fn = _build.load("mlstm").mlstm_scan_smem_bytes
    fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    return fn(chunk, D)


def _head_dim_ok(D: int) -> bool:
    return D >= 4 and D % 4 == 0 and (D <= COLS or (D % COLS == 0 and D <= MAX_D))


def _chunk_ok(chunk: int) -> bool:
    return 4 <= chunk <= MAX_CHUNK and chunk % 4 == 0


def mlstm_scan_cuda(q, k, v, i_gate, f_gate, *, chunk: int):
    """Launch the kernel on CUDA tensors; raises on what it does not take.
    Returns (h (B,S,H,D) in q's dtype, (S (B,H,D,D), n (B,H,D), m (B,H)) fp32)."""
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"mlstm_scan_cuda takes CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"mlstm_scan: dtype {q.dtype} not supported (float32, bfloat16)")
    if q.dim() != 4:
        raise ValueError("mlstm_scan: q must be (B,S,H,D)")
    B, S, H, D = q.shape
    if (tuple(k.shape) != (B, S, H, D) or tuple(v.shape) != (B, S, H, D)
            or tuple(i_gate.shape) != (B, S, H) or tuple(f_gate.shape) != (B, S, H)):
        raise ValueError(f"mlstm_scan: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, i_gate {tuple(i_gate.shape)}, "
                         f"f_gate {tuple(f_gate.shape)} do not match")
    if not (_head_dim_ok(D) and _chunk_ok(chunk)):
        raise ValueError(f"mlstm_scan: head dim {D}, chunk {chunk} not supported (head dim a "
                         f"multiple of 4 up to {COLS} or of {COLS} up to {MAX_D}; chunk a "
                         f"multiple of 4 up to {MAX_CHUNK})")
    if not (1 <= B <= 65535 and 1 <= H <= 65535 and S >= 1):
        raise ValueError(f"mlstm_scan: batch {B} and heads {H} must be in [1, 65535] and "
                         f"length {S} at least 1")
    for name, t in (("k", k), ("v", v), ("i_gate", i_gate), ("f_gate", f_gate)):
        if t.device != q.device:
            raise ValueError(f"mlstm_scan: {name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"mlstm_scan: {name} is {t.dtype}, expected q's {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"mlstm_scan: {name}'s last axis must be contiguous")
    h = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    S_f = torch.empty((B, H, D, D), dtype=torch.float32, device=q.device)
    n_f = torch.empty((B, H, D), dtype=torch.float32, device=q.device)
    m_f = torch.empty((B, H), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), i_gate.data_ptr(), f_gate.data_ptr(),
            h.data_ptr(), S_f.data_ptr(), n_f.data_ptr(), m_f.data_ptr(),
            _DTYPE_CODE[q.dtype], B, S, H, D, chunk,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *i_gate.stride(), *f_gate.stride(), *h.stride()[:3], stream,
        )
    if rc != 0:
        raise RuntimeError(f"mlstm_scan kernel launch failed: CUDA error {rc}")
    launches += 1
    return h, (S_f, n_f, m_f)
