"""Wrapper of the Hopper SSD chunked-scan kernel (``csrc/ssd.cu``).

The kernel replaces ``repro/kernels/ssd.py::_ssd_kernel`` (the Pallas
TPU kernel) and computes the same function as
:func:`repro_torch.kernels.ref.ssd_chunked`: y and the final state.
Layouts are the JAX package's: x (B,S,H,P); dt (B,S,H) fp32; A (H,) fp32;
Bmat/Cmat (B,S,N).  x, Bmat and Cmat may be strided views (the model
passes slices of one (B,S,d_in+2N) tensor, without a copy); y is
allocated as a contiguous (B,S,H,P) tensor, the state as (B,H,N,P) fp32.

The backward (``csrc/ssd_bwd.cu``, its own library) is
:func:`ssd_scan_bwd_cuda`, which :class:`SsdScanFunction` calls; the
differentiable entry on the card is :func:`repro_torch.kernels.ops.ssd_scan`.
Like the forward it chooses its kernel by dtype alone: bf16 runs on the
tensor cores (``ssd_bwd_bf16``), fp32 on scalar FMAs (``ssd_bwd``); either
is followed by ``ssd_bwd_reduce``, which sums the per-head partials.
:func:`ssd_scan_cuda` alone refuses inputs that require a gradient under
grad mode, since its output would carry none.  ``launches`` counts the
forward kernel's launches and ``bwd_launches`` the backward's calls (two
kernel launches each); nothing else changes them.
"""
from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from . import _build

MAX_NP = 64      # N and P: multiples of 4 in [4, 64]
MAX_CHUNK = 128  # chunk: a multiple of 4 in [4, 128]
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

NO_BACKWARD = ("ssd_scan_cuda records no gradient; call repro_torch.kernels.ops.ssd_scan, "
               "whose autograd Function runs the backward kernel")

launches = 0
bwd_launches = 0
_fn = None
_bwd_fn = None
_queries: dict = {}


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("ssd").ssd_scan_fwd
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [P] * 7 + [I] * 7 + [L] * 13 + [P]
        fn.restype = I
        _fn = fn
    return _fn


def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        fn = _build.load("ssd_bwd").ssd_scan_bwd
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [P] * 13 + [I] * 7 + [L] * 13 + [P]
        fn.restype = I
        _bwd_fn = fn
    return _bwd_fn


def _bwd_query(name: str, *args: int, restype=ctypes.c_int) -> int:
    """Call one of the backward library's size queries (all int arguments)."""
    fn = _queries.get(name)
    if fn is None:
        fn = _queries[name] = getattr(_build.load("ssd_bwd"), name)
        fn.argtypes = [ctypes.c_int] * len(args)
        fn.restype = restype
    return fn(*args)


def bwd_smem_bytes(chunk: int, N: int, P: int) -> int:
    """Dynamic shared memory a block of the backward's fp32 (scalar) kernel
    takes."""
    return _bwd_query("ssd_scan_bwd_smem_bytes", chunk, N, P)


def bwd_tc_smem_bytes(chunk: int, N: int, P: int) -> int:
    """Dynamic shared memory a block of the backward's bf16 (tensor-core)
    kernel takes."""
    return _bwd_query("ssd_scan_bwd_tc_smem_bytes", chunk, N, P)


def bwd_scratch_bytes(B: int, S: int, H: int, P: int, N: int, chunk: int) -> int:
    """Bytes of fp32 device scratch a backward call takes."""
    return _bwd_query("ssd_scan_bwd_scratch_bytes", B, S, H, P, N, chunk,
                      restype=ctypes.c_int64)


def smem_bytes(chunk: int, N: int, P: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Dynamic shared memory a block of the kernel for ``dtype`` takes at
    these sizes (the kernel's own plan; needs the built library)."""
    fn = _build.load("ssd").ssd_scan_smem_bytes
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    return fn(chunk, N, P, _DTYPE_CODE[dtype])


def _size_ok(v: int, hi: int) -> bool:
    return 4 <= v <= hi and v % 4 == 0


def _check_inputs(x, dt, A, Bmat, Cmat, chunk: int) -> tuple[int, int, int, int, int]:
    """(B, S, H, P, N) of valid kernel inputs; raises on what the kernels
    do not take."""
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_cuda takes CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"ssd_scan: dtype {x.dtype} not supported (float32, bfloat16)")
    if x.dim() != 4:
        raise ValueError("ssd_scan: x must be (B,S,H,P)")
    B, S, H, P = x.shape
    N = Bmat.shape[-1]
    if (tuple(dt.shape) != (B, S, H) or tuple(A.shape) != (H,)
            or tuple(Bmat.shape) != (B, S, N) or tuple(Cmat.shape) != (B, S, N)):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B {tuple(Bmat.shape)}, "
                         f"C {tuple(Cmat.shape)} do not match")
    if not (_size_ok(N, MAX_NP) and _size_ok(P, MAX_NP) and _size_ok(chunk, MAX_CHUNK)):
        raise ValueError(f"ssd_scan: N {N}, P {P}, chunk {chunk} not supported (N and P "
                         f"multiples of 4 up to {MAX_NP}, chunk a multiple of 4 up to "
                         f"{MAX_CHUNK})")
    if B < 1 or S < 1 or B > 65535:
        raise ValueError(f"ssd_scan: batch {B} must be in [1, 65535] and length {S} at least 1")
    for name, t, dtype in (("dt", dt, torch.float32), ("A", A, torch.float32),
                           ("B", Bmat, x.dtype), ("C", Cmat, x.dtype)):
        if t.device != x.device:
            raise ValueError(f"ssd_scan: {name} is on {t.device}, x on {x.device}")
        if t.dtype != dtype:
            raise TypeError(f"ssd_scan: {name} is {t.dtype}, expected {dtype}")
    for name, t in (("x", x), ("B", Bmat), ("C", Cmat), ("A", A)):
        if t.stride(-1) != 1:
            raise ValueError(f"ssd_scan: {name}'s last axis must be contiguous")
    return B, S, H, P, N


def ssd_scan_cuda(x, dt, A, Bmat, Cmat, *, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on CUDA tensors; raises on what it does not
    take, and on inputs that require a gradient while grad mode is on (its
    outputs would carry none: :func:`ops.ssd_scan` is the differentiable
    entry).  Returns (y (B,S,H,P) in x's dtype, final state (B,H,N,P) fp32)."""
    global launches
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, Bmat, Cmat)):
        raise RuntimeError(NO_BACKWARD)
    B, S, H, P, N = _check_inputs(x, dt, A, Bmat, Cmat, chunk)
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    state = torch.empty((B, H, N, P), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _kernel()(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bmat.data_ptr(), Cmat.data_ptr(),
            y.data_ptr(), state.data_ptr(),
            _DTYPE_CODE[x.dtype], B, S, H, P, N, chunk,
            *x.stride()[:3], *dt.stride(), Bmat.stride(0), Bmat.stride(1),
            Cmat.stride(0), Cmat.stride(1), *y.stride()[:3], stream,
        )
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {rc}")
    launches += 1
    return y, state


def ssd_scan_bwd_cuda(x, dt, A, Bmat, Cmat, dy, dfinal=None, *, chunk: int):
    """dx, ddt, dA, dB, dC of :func:`ssd_scan_cuda`'s function at (x, dt, A,
    B, C), given y's gradient ``dy`` and, optionally, the final state's
    ``dfinal`` (None: zero), by the backward kernels; raises on what they do
    not take.  ``dy`` and ``dfinal`` may have any strides: they are made
    contiguous where the kernel could not read them in place.  Returns
    (dx (B,S,H,P), ddt (B,S,H) fp32, dA (H,) fp32, dB (B,S,N), dC (B,S,N)),
    dx, dB and dC in x's dtype, all contiguous."""
    global bwd_launches
    B, S, H, P, N = _check_inputs(x, dt, A, Bmat, Cmat, chunk)
    if tuple(dy.shape) != (B, S, H, P) or dy.device != x.device or dy.dtype != x.dtype:
        raise ValueError(f"ssd_scan_bwd: dy is {tuple(dy.shape)} {dy.dtype} on {dy.device}, "
                         f"expected {(B, S, H, P)} {x.dtype} on {x.device}")
    if dy.stride(-1) != 1:
        dy = dy.contiguous()
    if dfinal is not None:
        if tuple(dfinal.shape) != (B, H, N, P) or dfinal.device != x.device:
            raise ValueError(f"ssd_scan_bwd: dfinal is {tuple(dfinal.shape)} on "
                             f"{dfinal.device}, expected {(B, H, N, P)} on {x.device}")
        dfinal = dfinal.float().contiguous()
    dx = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    ddt = torch.empty((B, S, H), dtype=torch.float32, device=x.device)
    dA = torch.empty((H,), dtype=torch.float32, device=x.device)
    dB = torch.empty((B, S, N), dtype=x.dtype, device=x.device)
    dC = torch.empty((B, S, N), dtype=x.dtype, device=x.device)
    scratch = torch.empty((bwd_scratch_bytes(B, S, H, P, N, chunk) // 4,), dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _bwd_kernel()(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bmat.data_ptr(), Cmat.data_ptr(),
            dy.data_ptr(), None if dfinal is None else dfinal.data_ptr(),
            dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
            scratch.data_ptr(), _DTYPE_CODE[x.dtype], B, S, H, P, N, chunk,
            *x.stride()[:3], *dt.stride(), Bmat.stride(0), Bmat.stride(1),
            Cmat.stride(0), Cmat.stride(1), *dy.stride()[:3], stream,
        )
    if rc != 0:
        raise RuntimeError(f"ssd_scan_bwd kernel launch failed: CUDA error {rc}")
    bwd_launches += 1
    return dx, ddt, dA, dB, dC


class SsdScanFunction(torch.autograd.Function):
    """The SSD scan with the hand-written forward and backward kernels: the
    forward saves its inputs; the backward rebuilds the states before each
    chunk from them (``csrc/ssd_bwd.cu``).  Both outputs (y and the final
    state) take a gradient; an unused one arrives as None (zero)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bmat, Cmat, chunk: int):
        y, final = ssd_scan_cuda(x, dt, A, Bmat, Cmat, chunk=chunk)
        ctx.save_for_backward(x, dt, A, Bmat, Cmat)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)   # an unused output's gradient stays None
        return y, final

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, dfinal):
        x, dt, A, Bmat, Cmat = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        dx, ddt, dA, dB, dC = ssd_scan_bwd_cuda(x, dt, A, Bmat, Cmat, dy, dfinal,
                                                chunk=ctx.chunk)
        return dx, ddt, dA, dB, dC, None
