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
Like the forward it chooses its kernel by dtype alone: bf16 runs the
warpgroup kernel ``ssd_bwd_wgmma`` and then ``ssd_bwd_gsum``, which sums
its per-group partials; fp32 runs the scalar ``ssd_bwd`` and then
``ssd_bwd_reduce``, which sums its per-head partials.  The bf16 forward is
``ssd_fwd_wgmma``, the fp32 forward ``ssd_fwd``.  Both bf16 kernels split
a call's chunks over the blocks of thread-block clusters and give a block
a group of heads: :func:`group_size` is the rule, which the library
applies (:func:`plan` asks it).
:func:`ssd_scan_cuda` alone refuses inputs that require a gradient under
grad mode, since its output would carry none.  ``launches`` counts the
forward kernel's launches and ``bwd_launches`` the backward's calls (two
kernel launches each); nothing else changes them.

On abstract tensors (:mod:`.abstract`) both wrappers return outputs of
the kernels' shapes (not the backward's scratch, whose size the built
library computes) and record the call's FLOPs
(the backward's twice the forward's: each einsum differentiated in both
operands).
"""
from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from . import _build, abstract

MAX_NP = 64      # N and P: multiples of 4 in [4, 64]
MAX_CHUNK = 128  # chunk: a multiple of 4 in [4, 128]
MAX_CLUSTER = 8  # blocks of a thread-block cluster (the portable limit)
MAX_GROUP = {False: 4, True: 2}  # heads a block holds: forward, backward
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

NO_BACKWARD = ("ssd_scan_cuda records no gradient; call repro_torch.kernels.ops.ssd_scan, "
               "whose autograd Function runs the backward kernel")

launches = 0
bwd_launches = 0
_fn = None
_bwd_fn = None
_queries: dict = {}


def bind_fwd(lib: ctypes.CDLL):
    """The forward C entry ``ssd_scan_fwd`` of a built library, typed."""
    fn = lib.ssd_scan_fwd
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.argtypes = [P] * 7 + [I] * 7 + [L] * 13 + [P]
    fn.restype = I
    return fn


def bind_bwd(lib: ctypes.CDLL):
    """The backward C entry ``ssd_scan_bwd`` of a built library, typed."""
    fn = lib.ssd_scan_bwd
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.argtypes = [P] * 13 + [I] * 7 + [L] * 13 + [P]
    fn.restype = I
    return fn


def _kernel():
    global _fn
    if _fn is None:
        _fn = bind_fwd(_build.load("ssd"))
    return _fn


def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        _bwd_fn = bind_bwd(_build.load("ssd_bwd"))
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
    """Dynamic shared memory a block of the backward's bf16 kernel
    (``ssd_bwd_wgmma``) takes."""
    return _bwd_query("ssd_scan_bwd_tc_smem_bytes", chunk, N, P)


def bwd_scratch_bytes(B: int, S: int, H: int, P: int, N: int, chunk: int,
                      dtype: torch.dtype = torch.float32) -> int:
    """Bytes of fp32 device scratch a backward call in ``dtype`` takes."""
    n = _bwd_query("ssd_scan_bwd_scratch_bytes_of", B, S, H, P, N, chunk, _DTYPE_CODE[dtype],
                   restype=ctypes.c_int64)
    if n < 0:
        raise RuntimeError("ssd_scan_bwd: no plan for the bf16 kernel on this device")
    return n


def chunk_plan(nc: int) -> tuple[int, int]:
    """(chunks a block takes, blocks a cluster) for ``nc`` chunks: at most
    MAX_CLUSTER blocks, each ceil(nc / MAX_CLUSTER) consecutive chunks, the
    last fewer."""
    k = -(-nc // MAX_CLUSTER)
    return k, -(-nc // k)


def group_size(B: int, S: int, H: int, chunk: int, slots: int, *,
               backward: bool = False) -> int:
    """Heads a block of the bf16 kernels holds (``csrc/ssd_wgmma.cuh``'s
    rule, which the library applies with the ``slots`` it measures): of G
    in [1, MAX_GROUP], the one that minimises ceil(B cs ceil(H / G) / slots)
    (F + ceil(G / 2)), the waves of the grid over the blocks that run at
    once times a block's time (a fixed part F = 11/25 of a pair of heads,
    and a unit a pair: the two warpgroups walk a pair at once), the largest
    G on a tie."""
    _, cs = chunk_plan(-(-S // chunk))
    best, best_cost = 1, None
    for g in range(1, MAX_GROUP[backward] + 1):
        cost = -(-(B * cs * -(-H // g)) // slots) * (11 + 25 * -(-g // 2))
        if best_cost is None or cost <= best_cost:
            best, best_cost = g, cost
    return best


def plan(B: int, S: int, H: int, chunk: int, *,
         backward: bool = False) -> tuple[int, int, int, int]:
    """(heads a block holds, chunks a block takes, blocks a cluster, blocks
    that run at once) of a bf16 call on the current device, as the built
    library plans it."""
    lib = _build.load("ssd_bwd" if backward else "ssd")
    fn = lib.ssd_scan_bwd_plan if backward else lib.ssd_scan_plan
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 4
    fn.restype = ctypes.c_int
    out = [ctypes.c_int() for _ in range(4)]
    rc = fn(B, S, H, chunk, *(ctypes.byref(v) for v in out))
    if rc != 0:
        raise RuntimeError(f"ssd plan failed: CUDA error {rc}")
    return tuple(v.value for v in out)


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
    if x.device.type != "cuda" and not abstract.is_abstract(x):
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
    if abstract.is_abstract(x):
        abstract.record("ssd", abstract.ssd_flops(B, S, H, P, N, chunk))
        return (torch.empty((B, S, H, P), dtype=x.dtype, device=x.device),
                torch.empty((B, H, N, P), dtype=torch.float32, device=x.device))
    y, state = run_fwd(_kernel(), x, dt, A, Bmat, Cmat, chunk)
    launches += 1
    return y, state


def run_fwd(fn, x, dt, A, Bmat, Cmat, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One call of a forward C entry ``fn`` (:func:`bind_fwd`) on checked
    CUDA inputs: y and the final state, allocated here."""
    B, S, H, P = x.shape
    N = Bmat.shape[-1]
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    state = torch.empty((B, H, N, P), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bmat.data_ptr(), Cmat.data_ptr(),
            y.data_ptr(), state.data_ptr(),
            _DTYPE_CODE[x.dtype], B, S, H, P, N, chunk,
            *x.stride()[:3], *dt.stride(), Bmat.stride(0), Bmat.stride(1),
            Cmat.stride(0), Cmat.stride(1), *y.stride()[:3], stream,
        )
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {rc}")
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
    if abstract.is_abstract(x):   # the scratch's size is the built library's: not allocated
        abstract.record("ssd_bwd", 2 * abstract.ssd_flops(B, S, H, P, N, chunk))
        return (torch.empty((B, S, H, P), dtype=x.dtype, device=x.device),
                torch.empty((B, S, H), dtype=torch.float32, device=x.device),
                torch.empty((H,), dtype=torch.float32, device=x.device),
                torch.empty((B, S, N), dtype=x.dtype, device=x.device),
                torch.empty((B, S, N), dtype=x.dtype, device=x.device))
    out = run_bwd(_bwd_kernel(), bwd_scratch_bytes(B, S, H, P, N, chunk, x.dtype),
                  x, dt, A, Bmat, Cmat, dy, dfinal, chunk)
    bwd_launches += 1
    return out


def run_bwd(fn, scratch_bytes: int, x, dt, A, Bmat, Cmat, dy, dfinal, chunk: int):
    """One call of a backward C entry ``fn`` (:func:`bind_bwd`) on checked
    CUDA inputs with ``scratch_bytes`` of scratch: (dx, ddt, dA, dB, dC),
    allocated here."""
    B, S, H, P = x.shape
    N = Bmat.shape[-1]
    dx = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    ddt = torch.empty((B, S, H), dtype=torch.float32, device=x.device)
    dA = torch.empty((H,), dtype=torch.float32, device=x.device)
    dB = torch.empty((B, S, N), dtype=x.dtype, device=x.device)
    dC = torch.empty((B, S, N), dtype=x.dtype, device=x.device)
    scratch = torch.empty((scratch_bytes // 4,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bmat.data_ptr(), Cmat.data_ptr(),
            dy.data_ptr(), None if dfinal is None else dfinal.data_ptr(),
            dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
            scratch.data_ptr(), _DTYPE_CODE[x.dtype], B, S, H, P, N, chunk,
            *x.stride()[:3], *dt.stride(), Bmat.stride(0), Bmat.stride(1),
            Cmat.stride(0), Cmat.stride(1), *dy.stride()[:3], stream,
        )
    if rc != 0:
        raise RuntimeError(f"ssd_scan_bwd kernel launch failed: CUDA error {rc}")
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
