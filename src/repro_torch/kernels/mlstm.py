"""Wrapper of the Hopper chunked-mLSTM kernel (``csrc/mlstm.cu``).

The kernel replaces ``repro/kernels/mlstm.py::_mlstm_kernel`` (the Pallas
TPU kernel) and computes the same function as
:func:`repro_torch.kernels.ref.mlstm_chunked`: h and the final state.
Layouts are the JAX package's: q/k/v (B,S,H,D); i_gate/f_gate (B,S,H),
raw preactivations, in q's dtype.  q, k, v and the gates may be strided
views (the model passes the gates as the two halves of one (B,S,2H)
tensor, without a copy); h is allocated as a contiguous (B,S,H,D) tensor,
the state as S (B,H,D,D), n (B,H,D), m (B,H) in fp32.

Two kernels, chosen by dtype alone inside ``csrc/mlstm.cu``: fp32 runs the
scalar FMA kernel; bf16 runs the tensor-core pair (one launch forms W =
q k^T (.) weights once per (b, h, chunk) into a scratch tensor that this
wrapper allocates with ``torch.empty``, one launch does the rest).

Under grad mode, inputs that require a gradient are refused (no backward
yet, ROADMAP.md A18).  ``launches`` counts calls that launched the kernels
(a bf16 call is two kernel launches, an fp32 call one); nothing else
changes it.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

COLS = 32         # D: a multiple of 4 up to 32, or a multiple of 32 ...
MAX_D = 512       # ... up to 512
MAX_CHUNK = 128   # chunk: a multiple of 4 in [4, 128]
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

NO_BACKWARD = ("mlstm_scan: the mLSTM kernel has no backward yet (ROADMAP.md A18, B3c), so "
               "its output would carry no gradient; on the card it runs under "
               "torch.no_grad() or torch.inference_mode() only")

launches = 0
_fn = None
_queries: dict = {}


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("mlstm").mlstm_scan_fwd
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [P] * 10 + [I] * 6 + [L] * 18 + [P]
        fn.restype = I
        _fn = fn
    return _fn


def _query(name: str, *args: int, restype=ctypes.c_int) -> int:
    """Call one of the library's size queries (all int arguments)."""
    fn = _queries.get(name)
    if fn is None:
        fn = _queries[name] = getattr(_build.load("mlstm"), name)
        fn.argtypes = [ctypes.c_int] * len(args)
        fn.restype = restype
    return fn(*args)


def smem_bytes(chunk: int, D: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Dynamic shared memory a block of the kernel for ``dtype`` takes at
    these sizes (for bf16 the larger, second kernel; the kernel's own plan;
    needs the built library)."""
    return _query("mlstm_scan_smem_bytes", chunk, D, _DTYPE_CODE[dtype])


def w_smem_bytes(chunk: int, D: int) -> int:
    """Dynamic shared memory a block of the bf16 path's first kernel (W) takes."""
    return _query("mlstm_scan_w_smem_bytes", chunk, D)


def value_cols(chunk: int, D: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Value columns of S that one block of the kernel for ``dtype`` owns."""
    return _query("mlstm_scan_value_cols", chunk, D, _DTYPE_CODE[dtype])


def scratch_bytes(B: int, S: int, H: int, chunk: int, dtype: torch.dtype) -> int:
    """Bytes of device scratch a call takes (0 for fp32)."""
    return _query("mlstm_scan_scratch_bytes", B, S, H, chunk, _DTYPE_CODE[dtype],
                  restype=ctypes.c_int64)


def _head_dim_ok(D: int) -> bool:
    return D >= 4 and D % 4 == 0 and (D <= COLS or (D % COLS == 0 and D <= MAX_D))


def _chunk_ok(chunk: int) -> bool:
    return 4 <= chunk <= MAX_CHUNK and chunk % 4 == 0


def mlstm_scan_cuda(q, k, v, i_gate, f_gate, *, chunk: int):
    """Launch the kernel on CUDA tensors; raises on what it does not take.
    Returns (h (B,S,H,D) in q's dtype, (S (B,H,D,D), n (B,H,D), m (B,H)) fp32)."""
    global launches
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, i_gate, f_gate)):
        raise RuntimeError(NO_BACKWARD)
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
    scratch = torch.empty((scratch_bytes(B, S, H, chunk, q.dtype) // 4,), dtype=torch.float32,
                          device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), i_gate.data_ptr(), f_gate.data_ptr(),
            h.data_ptr(), S_f.data_ptr(), n_f.data_ptr(), m_f.data_ptr(), scratch.data_ptr(),
            _DTYPE_CODE[q.dtype], B, S, H, D, chunk,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *i_gate.stride(), *f_gate.stride(), *h.stride()[:3], stream,
        )
    if rc != 0:
        raise RuntimeError(f"mlstm_scan kernel launch failed: CUDA error {rc}")
    launches += 1
    return h, (S_f, n_f, m_f)
