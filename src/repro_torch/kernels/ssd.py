"""Wrapper of the Hopper SSD chunked-scan kernel (``csrc/ssd.cu``).

The kernel replaces ``repro/kernels/ssd.py::_ssd_kernel`` (the Pallas
TPU kernel) and computes the same function as
:func:`repro_torch.kernels.ref.ssd_chunked`: y and the final state.
Layouts are the JAX package's: x (B,S,H,P); dt (B,S,H) fp32; A (H,) fp32;
Bmat/Cmat (B,S,N).  x, Bmat and Cmat may be strided views (the model
passes slices of one (B,S,d_in+2N) tensor, without a copy); y is
allocated as a contiguous (B,S,H,P) tensor, the state as (B,H,N,P) fp32.

Under grad mode, inputs that require a gradient are refused (no backward
yet, ROADMAP.md A18).  ``launches`` counts the kernel's launches; nothing
else changes it.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_NP = 64      # N and P: multiples of 4 in [4, 64]
MAX_CHUNK = 128  # chunk: a multiple of 4 in [4, 128]
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

NO_BACKWARD = ("ssd_scan: the SSD kernel has no backward yet (ROADMAP.md A18, B2c), so "
               "its output would carry no gradient; on the card it runs under "
               "torch.no_grad() or torch.inference_mode() only")

launches = 0
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("ssd").ssd_scan_fwd
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [P] * 7 + [I] * 7 + [L] * 13 + [P]
        fn.restype = I
        _fn = fn
    return _fn


def smem_bytes(chunk: int, N: int, P: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Dynamic shared memory a block of the kernel for ``dtype`` takes at
    these sizes (the kernel's own plan; needs the built library)."""
    fn = _build.load("ssd").ssd_scan_smem_bytes
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    return fn(chunk, N, P, _DTYPE_CODE[dtype])


def _size_ok(v: int, hi: int) -> bool:
    return 4 <= v <= hi and v % 4 == 0


def ssd_scan_cuda(x, dt, A, Bmat, Cmat, *, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA tensors; raises on what it does not take.
    Returns (y (B,S,H,P) in x's dtype, final state (B,H,N,P) fp32)."""
    global launches
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, Bmat, Cmat)):
        raise RuntimeError(NO_BACKWARD)
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
