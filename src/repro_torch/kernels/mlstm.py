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

The backward (``csrc/mlstm_bwd.cu``, its own library) is
:func:`mlstm_scan_bwd_cuda`, which :class:`MlstmScanFunction` calls; the
differentiable entry on the card is :func:`repro_torch.kernels.ops.mlstm_scan`.
It too chooses by dtype alone inside the library: fp32 runs four scalar FMA
launches, bf16 five tensor-core launches (``mlstm_bwd_*_bf16``).
:func:`mlstm_scan_cuda` alone refuses inputs that require a gradient under
grad mode, since its output would carry none.  ``launches`` counts calls
that launched the forward kernels (a bf16 call is two kernel launches, an
fp32 call one) and ``bwd_launches`` calls of the backward (four kernel
launches each in fp32, five in bf16); nothing else changes them.

On abstract tensors (:mod:`.abstract`) both wrappers return outputs of
the kernels' shapes (not their scratch, whose size the built library
computes) and record the call's FLOPs
(the backward's: each einsum differentiated in both operands, less the
last chunk's state update, which only the final state reads).
"""
from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from . import _build, abstract

COLS = 32         # D: a multiple of 4 up to 32, or a multiple of 32 ...
MAX_D = 512       # ... up to 512
MAX_CHUNK = 128   # chunk: a multiple of 4 in [4, 128]
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

NO_BACKWARD = ("mlstm_scan_cuda records no gradient; call repro_torch.kernels.ops.mlstm_scan, "
               "whose autograd Function runs the backward kernel")

launches = 0
bwd_launches = 0
_fn = None
_bwd_fn = None
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


def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        fn = _build.load("mlstm_bwd").mlstm_scan_bwd
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 12 + [I] * 6 + [ctypes.POINTER(ctypes.c_int64), P]
        fn.restype = I
        _bwd_fn = fn
    return _bwd_fn


def _query(name: str, *args: int, restype=ctypes.c_int, lib: str = "mlstm") -> int:
    """Call one of a library's size queries (all int arguments)."""
    fn = _queries.get((lib, name))
    if fn is None:
        fn = _queries[(lib, name)] = getattr(_build.load(lib), name)
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


def bwd_smem_bytes(chunk: int, D: int) -> int:
    """Dynamic shared memory a block of the backward's main kernel takes."""
    return _query("mlstm_scan_bwd_smem_bytes", chunk, D, lib="mlstm_bwd")


BWD_TC_KERNELS = ("mlstm_bwd_states_bf16", "mlstm_bwd_chunk_bf16", "mlstm_bwd_out_bf16")


def bwd_tc_smem_bytes(chunk: int, D: int, kernel: str) -> int:
    """Dynamic shared memory a block of one of the bf16 backward's kernels
    takes (``BWD_TC_KERNELS``; ``mlstm_bwd_dstates_bf16`` takes what
    ``mlstm_bwd_states_bf16`` does, ``mlstm_bwd_gates_bf16`` none)."""
    return _query("mlstm_scan_bwd_tc_smem_bytes", chunk, D, BWD_TC_KERNELS.index(kernel),
                  lib="mlstm_bwd")


def bwd_scratch_bytes(B: int, S: int, H: int, D: int, chunk: int) -> int:
    """Bytes of fp32 device scratch a backward call takes (what the larger
    of its two paths, fp32 and bf16, needs)."""
    return _query("mlstm_scan_bwd_scratch_bytes", B, S, H, D, chunk, restype=ctypes.c_int64,
                  lib="mlstm_bwd")


def _head_dim_ok(D: int) -> bool:
    return D >= 4 and D % 4 == 0 and (D <= COLS or (D % COLS == 0 and D <= MAX_D))


def _chunk_ok(chunk: int) -> bool:
    return 4 <= chunk <= MAX_CHUNK and chunk % 4 == 0


def _check_inputs(q, k, v, i_gate, f_gate, chunk: int) -> tuple[int, int, int, int]:
    """(B, S, H, D) of valid kernel inputs; raises on what the kernels do
    not take."""
    if q.device.type != "cuda" and not abstract.is_abstract(q):
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
    return B, S, H, D


def mlstm_scan_cuda(q, k, v, i_gate, f_gate, *, chunk: int):
    """Launch the forward kernels on CUDA tensors; raises on what they do
    not take, and on inputs that require a gradient while grad mode is on
    (the output would carry none: :func:`ops.mlstm_scan` is the
    differentiable entry).
    Returns (h (B,S,H,D) in q's dtype, (S (B,H,D,D), n (B,H,D), m (B,H)) fp32)."""
    global launches
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, i_gate, f_gate)):
        raise RuntimeError(NO_BACKWARD)
    B, S, H, D = _check_inputs(q, k, v, i_gate, f_gate, chunk)
    h = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    S_f = torch.empty((B, H, D, D), dtype=torch.float32, device=q.device)
    n_f = torch.empty((B, H, D), dtype=torch.float32, device=q.device)
    m_f = torch.empty((B, H), dtype=torch.float32, device=q.device)
    if abstract.is_abstract(q):   # the scratch's size is the built library's: not allocated
        abstract.record("mlstm", abstract.mlstm_flops(B, S, H, D, chunk))
        return h, (S_f, n_f, m_f)
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


def mlstm_scan_bwd_cuda(q, k, v, i_gate, f_gate, dh, *, chunk: int):
    """dq, dk, dv, d i_gate, d f_gate of h = :func:`mlstm_scan_cuda`'s first
    output at (q, k, v, i_gate, f_gate), given h's gradient ``dh``, by the
    backward kernels; raises on what they do not take.  ``dh`` may have any
    strides: it is made contiguous where the kernel could not read it in
    place.  Returns (dq, dk, dv (B,S,H,D), d i_gate, d f_gate (B,S,H)), all
    contiguous in q's dtype."""
    global bwd_launches
    B, S, H, D = _check_inputs(q, k, v, i_gate, f_gate, chunk)
    if tuple(dh.shape) != (B, S, H, D) or dh.device != q.device or dh.dtype != q.dtype:
        raise ValueError(f"mlstm_scan_bwd: dh is {tuple(dh.shape)} {dh.dtype} on {dh.device}, "
                         f"expected {(B, S, H, D)} {q.dtype} on {q.device}")
    dh = dh if dh.stride(-1) == 1 else dh.contiguous()
    dq, dk, dv = (torch.empty((B, S, H, D), dtype=q.dtype, device=q.device) for _ in range(3))
    di, df = (torch.empty((B, S, H), dtype=q.dtype, device=q.device) for _ in range(2))
    if abstract.is_abstract(q):
        abstract.record("mlstm_bwd", abstract.mlstm_bwd_flops(B, S, H, D, chunk))
        return dq, dk, dv, di, df
    scratch = torch.empty((bwd_scratch_bytes(B, S, H, D, chunk) // 4,), dtype=torch.float32,
                          device=q.device)
    strides = (ctypes.c_int64 * 18)(*(s for t in (q, k, v, i_gate, f_gate, dh)
                                      for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _bwd_kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), i_gate.data_ptr(), f_gate.data_ptr(),
            dh.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            di.data_ptr(), df.data_ptr(), scratch.data_ptr(),
            _DTYPE_CODE[q.dtype], B, S, H, D, chunk, strides, stream,
        )
    if rc != 0:
        raise RuntimeError(f"mlstm_scan_bwd kernel launch failed: CUDA error {rc}")
    bwd_launches += 1
    return dq, dk, dv, di, df


class MlstmScanFunction(torch.autograd.Function):
    """The mLSTM scan with the hand-written forward and backward kernels:
    the forward saves its inputs; the backward recomputes the forward with
    fp32 accumulation (the states before each chunk, and h where its
    gradient needs it, ``csrc/mlstm_bwd.cu``).  Returns h and the final
    (S, n, m) flat; the final state is marked non-differentiable (unlike
    h, the stabilised state depends on m, and nothing trains through it)."""

    @staticmethod
    def forward(ctx, q, k, v, i_gate, f_gate, chunk: int):
        h, (S_f, n_f, m_f) = mlstm_scan_cuda(q, k, v, i_gate, f_gate, chunk=chunk)
        ctx.save_for_backward(q, k, v, i_gate, f_gate)
        ctx.chunk = chunk
        ctx.mark_non_differentiable(S_f, n_f, m_f)
        return h, S_f, n_f, m_f

    @staticmethod
    @once_differentiable
    def backward(ctx, dh, dS, dn, dm):
        return (*mlstm_scan_bwd_cuda(*ctx.saved_tensors, dh, chunk=ctx.chunk), None)
