"""Wrappers of the Hopper flash-attention kernels: the forward
(``csrc/flash_attention.cu``) and the backward
(``csrc/flash_attention_bwd.cu``), joined by :class:`FlashAttentionFunction`.

The forward replaces ``repro/kernels/flash_attention.py::_attn_kernel``
(the Pallas TPU kernel) and computes the same function as
:func:`repro_torch.kernels.ref.attention_ref`; the backward computes its
dq, dk and dv (the Pallas kernel has none: the JAX package differentiates
its jnp attention).  Layouts are the JAX package's: q (B,H,Sq,D); k/v
(B,KV,Sk,D); out (B,H,Sq,D).  Inputs may be strided views (the model
passes its (B,S,H,D) activations and (B,S_max,KV,D) cache slices
transposed, without a copy); the output is allocated as a (B,Sq,H,D)
tensor and returned as its (B,H,Sq,D) view, the layout the model's output
projection reads.  dq, dk and dv take q's, k's and v's layouts and dtypes.

``flash_attention_cuda`` records no gradient, so it refuses inputs that
require one while grad mode is on; :func:`repro_torch.kernels.ops.flash_attention`
sends those through :class:`FlashAttentionFunction` instead.

``flash_attention_lse_cuda`` calls the forward's second C entry,
``flash_attention_lse``: the same kernels, also writing each row's fp32
log-sum-exp (B,H,Sq), so that attention over keys split across ranks can
merge the ranks' partial outputs (decode with the cache's sequence split,
:mod:`repro_torch.models.layers`); it records no gradient either.

A bf16 decode call (Sq < 16) whose (b, KV head, 16-row) blocks leave
SMs idle (:func:`decode_split` below D 256: qwen2_vl's 32 blocks become
96; :func:`d256_decode_split` at D 256: gemma2's 16 blocks on 132 SMs), goes,
from either wrapper, to a third C entry, ``flash_attention_decode_split``:
the keys are cut into ranges over more blocks.  Below D 256 that is one
launch, whose ranges of one (b, KV head, rows) form a thread-block
cluster and merge through its distributed shared memory; at D 256 each
range writes a partial (o, m, l) to fp32 scratch this wrapper allocates
and a second launch merges them, as ``models.layers`` merges ranks'
partials.  The call counts as one launch of the wrapper's counter.

``launches`` counts the forward wrapper's calls that launch a kernel,
``lse_launches`` the second entry's and ``bwd_launches`` the backward's
calls (two kernel launches each in bf16, by ``wgmma``; three in fp32,
scalar); nothing else changes them.  Both directions take the head dims
``SUPPORTED_D``.

On abstract tensors (:mod:`.abstract`) each wrapper returns outputs of
the kernel's shapes and records the call's FLOPs (the backward's: twice
the forward's, Q K^T and P V each differentiated in both operands).
"""
from __future__ import annotations

import contextlib
import ctypes
import math

import torch
from torch.autograd.function import once_differentiable

from . import _build, abstract

SUPPORTED_D = (16, 32, 64, 80, 128, 256)   # head dims of the forward and of the backward
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
lse_launches = 0
bwd_launches = 0
_fn = None
_lse_fn = None
_split_fn = None
_bwd_fn = None
_sms: dict[int, int] = {}

# The split decode (csrc/flash_attention.cu, flash_attention_decode_split).
# Below D 256 (attn_decode_tma): a block holds 16 query rows of one (b, KV
# head) and one range of keys, a whole number of SPLIT_KEYS (its TMA
# boxes), which it streams through its ring in tiles of TILE_KEYS; the
# ranges of one (b, KV head, rows), at most MAX_SPLITS, are the CTAs of a
# cluster and merge on chip.
DECODE_ROWS = 16
SPLIT_KEYS = 16
TILE_KEYS = 64
MAX_SPLITS = 8
# D 256 (attn_decode_bf16, then attn_decode_merge): ranges of a whole
# number of D256_SPLIT_STEP keys (a round of the block's 4 warps), at
# least D256_SPLIT_MIN_KEYS, for about D256_SPLIT_WAVES blocks an SM.
D256_SPLIT_STEP = 64
D256_SPLIT_MIN_KEYS = 128
D256_SPLIT_WAVES = 2


def decode_split(B: int, KV: int, rows: int, Sk: int, sms: int) -> tuple[int, int]:
    """(splits, keys a split) of a decode call below D 256 with ``rows``
    query rows a KV head (GQA group x Sq) over ``Sk`` keys on a card of
    ``sms`` SMs.  A block's time grows with the tiles it streams: the
    ranges (each a whole number of SPLIT_KEYS, none empty, at most
    MAX_SPLITS) are cut so that a block streams the fewest tiles of
    TILE_KEYS, with no more (b, KV head, 16-row, range) blocks than SMs (a
    cluster's blocks are placed together, and more of them than that
    waited for a second wave on an H100), and the fewest ranges among
    equals.  One split is (1, Sk)."""
    units = -(-rows // DECODE_ROWS) * KV * B
    groups = -(-Sk // SPLIT_KEYS)
    best, best_tiles = (1, Sk), -(-Sk // TILE_KEYS)
    for want in range(2, min(MAX_SPLITS, groups, sms // units) + 1):
        chunk = -(-groups // want) * SPLIT_KEYS
        tiles = -(-chunk // TILE_KEYS)
        if tiles < best_tiles:
            best, best_tiles = (-(-Sk // chunk), chunk), tiles
    return best


def d256_decode_split(B: int, KV: int, rows: int, Sk: int, sms: int) -> tuple[int, int]:
    """(splits, keys a split) of a D 256 decode call, as
    :func:`decode_split`: one split (all the keys) where the (b, KV head,
    16-row) blocks alone reach ``sms``, or where the keys are too few to
    cut; else enough ranges of keys, each a multiple of D256_SPLIT_STEP,
    for about D256_SPLIT_WAVES blocks an SM, none shorter than
    D256_SPLIT_MIN_KEYS.  (Every head dim's rule before attn_decode_tma.)"""
    blocks = -(-rows // DECODE_ROWS) * KV * B
    if blocks >= sms or Sk <= D256_SPLIT_MIN_KEYS:
        return 1, Sk
    want = min(-(-D256_SPLIT_WAVES * sms // blocks), Sk // D256_SPLIT_MIN_KEYS)
    chunk = -(-Sk // (want * D256_SPLIT_STEP)) * D256_SPLIT_STEP
    return -(-Sk // chunk), chunk


def bind_fwd(lib: ctypes.CDLL):
    """``lib``'s C entry ``flash_attention_fwd`` with its signature set:
    this tree's library, or one built from another source of
    ``csrc/flash_attention.cu`` (``scripts/attention_fwd_ab.py``)."""
    fn = lib.flash_attention_fwd
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.argtypes = [P, P, P, P, I, I, I, I, I, I, I] + [L] * 12 + [
        I, I, ctypes.c_float, ctypes.c_float, P]
    fn.restype = I
    return fn


def _kernel():
    global _fn
    if _fn is None:
        _fn = bind_fwd(_build.load("flash_attention"))
    return _fn


def bind_lse(lib: ctypes.CDLL):
    """``lib``'s C entry ``flash_attention_lse`` with its signature set (as
    :func:`bind_fwd`)."""
    fn = lib.flash_attention_lse
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.argtypes = [P] * 5 + [I] * 7 + [L] * 12 + [I, I, ctypes.c_float, ctypes.c_float, P]
    fn.restype = I
    return fn


def _lse_kernel():
    global _lse_fn
    if _lse_fn is None:
        _lse_fn = bind_lse(_build.load("flash_attention"))
    return _lse_fn


def bind_split(lib: ctypes.CDLL):
    """``lib``'s C entry ``flash_attention_decode_split`` with its signature
    set (as :func:`bind_fwd`)."""
    fn = lib.flash_attention_decode_split
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.argtypes = [P] * 6 + [I] * 9 + [L] * 12 + [I, I, ctypes.c_float, ctypes.c_float, P]
    fn.restype = I
    return fn


def _split_kernel():
    global _split_fn
    if _split_fn is None:
        _split_fn = bind_split(_build.load("flash_attention"))
    return _split_fn


def sm_count(device: torch.device) -> int:
    """The card's SM count, from the forward library's
    ``flash_attention_sm_count`` (cudaDevAttrMultiProcessorCount)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sms:
        fn = _build.load("flash_attention").flash_attention_sm_count
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
        n = fn(index)
        if n <= 0:
            raise RuntimeError(f"flash_attention: no SM count for cuda:{index}")
        _sms[index] = n
    return _sms[index]


@contextlib.contextmanager
def _launch_stream(device: torch.device):
    """The launch's device made current; yields its current stream's handle."""
    with torch.cuda.device(device):
        yield torch.cuda.current_stream(device).cuda_stream


def run_fwd(fn, q, k, v, *, causal: bool, window: int, softcap: float) -> torch.Tensor:
    """Call the forward entry ``fn`` (from :func:`bind_fwd`) on checked
    inputs; counts nothing.  Returns the (B,H,Sq,D) view of a (B,Sq,H,D)
    output."""
    B, H, Sq, D = q.shape
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    with _launch_stream(q.device) as stream:
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[q.dtype], B, H, k.shape[1], Sq, k.shape[2], D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            int(bool(causal)), int(window), float(softcap), 1.0 / math.sqrt(D), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc}")
    return out


def run_lse(fn, q, k, v, *, causal: bool, window: int, softcap: float):
    """Call the lse entry ``fn`` (from :func:`bind_lse`) on checked inputs;
    counts nothing.  Returns (out, lse) as :func:`flash_attention_lse_cuda`."""
    B, H, Sq, D = q.shape
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    with _launch_stream(q.device) as stream:
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            _DTYPE_CODE[q.dtype], B, H, k.shape[1], Sq, k.shape[2], D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            int(bool(causal)), int(window), float(softcap), 1.0 / math.sqrt(D), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention_lse kernel launch failed: CUDA error {rc}")
    return out, lse


def _split_plan(q, k) -> tuple[int, int]:
    """(splits, keys a split) of a call: for a bf16 decode call (Sq < 16)
    :func:`decode_split` below D 256 and :func:`d256_decode_split` at D
    256, else (1, Sk)."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if q.dtype != torch.bfloat16 or Sq >= DECODE_ROWS:
        return 1, Sk
    rule = d256_decode_split if D == 256 else decode_split
    return rule(B, KV, H // KV * Sq, Sk, sm_count(q.device))


def run_split(q, k, v, splits: int, chunk: int, *, causal: bool, window: int, softcap: float,
              lse: torch.Tensor | None = None, fn=None) -> torch.Tensor:
    """The split decode entry (this tree's, or ``fn`` from :func:`bind_split`)
    on checked bf16 decode inputs, with its
    scratch allocated here on the current stream (a kernel allocates
    nothing, and a CUDA graph may capture the call); writes ``lse`` when
    given.  Counts nothing.  Returns the (B,H,Sq,D) view of a (B,Sq,H,D)
    output.  This tree's kernel below D 256 merges its ranges on chip and
    leaves the scratch unused (the entry keeps it for D 256, and for an
    older library's split entry, which needs it at every head dim)."""
    B, H, Sq, D = q.shape
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    part = torch.empty(B * H * Sq * splits * (D + 2), dtype=torch.float32, device=q.device)
    with _launch_stream(q.device) as stream:
        rc = (fn or _split_kernel())(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), part.data_ptr(), splits, chunk,
            _DTYPE_CODE[q.dtype], B, H, k.shape[1], Sq, k.shape[2], D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            int(bool(causal)), int(window), float(softcap), 1.0 / math.sqrt(D), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention_decode_split kernel launch failed: CUDA error {rc}")
    return out


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, device: torch.device):
    if t.device != device:
        raise ValueError(f"flash_attention: {name} is on {t.device}, q on {device}")
    if t.dtype != dtype:
        raise TypeError(f"flash_attention: {name} is {t.dtype}, q is {dtype}")
    if t.stride(-1) != 1:
        raise ValueError(f"flash_attention: {name}'s last axis must be contiguous")
    if not _aligned(t):
        raise ValueError(f"flash_attention: {name} must be 16-byte aligned "
                         f"(pointer and strides), got strides {t.stride()}")


def _aligned(t: torch.Tensor) -> bool:
    """The last axis contiguous, the pointer and the other strides 16-byte
    aligned: what the kernels' 16-byte loads need."""
    vec = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % vec == 0 for s in t.stride()[:-1]))


def bind_bwd(lib: ctypes.CDLL):
    """``lib``'s C entry ``flash_attention_bwd`` with its signature set:
    this tree's library, or one built from another source of
    ``csrc/flash_attention_bwd.cu`` (``scripts/attention_fwd_ab.py --bwd``)."""
    fn = lib.flash_attention_bwd
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 10 + [I] * 7 + [ctypes.POINTER(ctypes.c_int64), I, I,
                                         ctypes.c_float, ctypes.c_float, P]
    fn.restype = I
    return fn


def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        _bwd_fn = bind_bwd(_build.load("flash_attention_bwd"))
    return _bwd_fn


def _require_cuda(q):
    if q.device.type != "cuda" and not abstract.is_abstract(q):
        raise ValueError(f"flash_attention_cuda takes CUDA tensors, got {q.device}")


def _check_inputs(q, k, v) -> tuple[int, int, int, int, int, int]:
    """Raises on q/k/v the kernels do not take; returns (B, H, KV, Sq, Sk, D).
    Abstract tensors are checked for shape only."""
    _require_cuda(q)
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
    if not abstract.is_abstract(q):
        for name, t in (("q", q), ("k", k), ("v", v)):
            _check(name, t, q.dtype, q.device)
    return B, H, KV, Sq, Sk, D


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0) -> torch.Tensor:
    """Launch the forward kernel on CUDA tensors; raises on what it does not
    take, and on inputs that require a gradient while grad mode is on (its
    output would carry none: :func:`ops.flash_attention` is the
    differentiable entry)."""
    global launches
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError("flash_attention_cuda records no gradient; call "
                           "repro_torch.kernels.ops.flash_attention, whose autograd Function "
                           "runs the backward kernel")
    B, H, KV, Sq, Sk, D = _check_inputs(q, k, v)
    if abstract.is_abstract(q):
        out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)
        if out.numel():
            abstract.record("flash_attention", abstract.attention_flops(B, H, Sq, Sk, D))
        return out
    splits, chunk = _split_plan(q, k) if q.numel() and Sk else (1, Sk)
    if splits > 1:
        out = run_split(q, k, v, splits, chunk, causal=causal, window=window, softcap=softcap)
    else:
        out = run_fwd(_kernel(), q, k, v, causal=causal, window=window, softcap=softcap)
    if out.numel():
        launches += 1
    return out


def flash_attention_lse_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                             softcap: float = 0.0) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel through the ``flash_attention_lse`` entry: (out
    (B,H,Sq,D) in q's dtype, the view of a (B,Sq,H,D) tensor; lse (B,H,Sq)
    fp32, the log-sum-exp of each row's scaled, soft-capped, masked
    scores, -inf where a row admits no key).  Raises as
    :func:`flash_attention_cuda` does, also on inputs that require a
    gradient while grad mode is on (it has no backward)."""
    global lse_launches
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError("flash_attention_lse records no gradient: it serves decode steps")
    B, H, KV, Sq, Sk, D = _check_inputs(q, k, v)
    if abstract.is_abstract(q) or q.numel() == 0:
        out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        if out.numel():
            abstract.record("flash_attention_lse", abstract.attention_flops(B, H, Sq, Sk, D))
        return out, lse
    splits, chunk = _split_plan(q, k) if Sk else (1, Sk)
    if splits > 1:
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        out = run_split(q, k, v, splits, chunk, causal=causal, window=window, softcap=softcap,
                        lse=lse)
    else:
        out, lse = run_lse(_lse_kernel(), q, k, v, causal=causal, window=window, softcap=softcap)
    lse_launches += 1
    return out, lse


def run_bwd(fn, q, k, v, out, dout, *, causal: bool, window: int, softcap: float):
    """Call the backward entry ``fn`` (from :func:`bind_bwd`) on checked
    inputs (``dout`` 16-byte aligned); counts nothing.  Returns (dq, dk,
    dv)."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dq.numel() == 0 or Sk == 0:   # no query, or no key: every gradient is 0
        return dq.zero_(), dk.zero_(), dv.zero_()
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    strides = (ctypes.c_int64 * 24)(*(s for t in (q, k, v, out, dout, dq, dk, dv)
                                      for s in t.stride()[:3]))
    with _launch_stream(q.device) as stream:
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            _DTYPE_CODE[q.dtype], B, H, KV, Sq, Sk, D, strides,
            int(bool(causal)), int(window), float(softcap), 1.0 / math.sqrt(D), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA error {rc}")
    return dq, dk, dv


def flash_attention_bwd_cuda(q, k, v, out, dout, *, causal: bool = True, window: int = 0,
                             softcap: float = 0.0):
    """dq, dk, dv of :func:`flash_attention_cuda`'s function at (q, k, v),
    given its output ``out`` and the output's gradient ``dout``, by the
    backward kernels (bf16: two warpgroup launches, ``wgmma``, at every head
    dim; fp32: three scalar ones); raises on what it does not take.
    ``dout`` may have any strides: it is made contiguous where the kernel
    could not read it in place.  Returns (dq, dk, dv) in q's, k's and v's
    dtypes and layouts."""
    global bwd_launches
    B, H, KV, Sq, Sk, D = _check_inputs(q, k, v)
    for name, t in (("out", out), ("dout", dout)):
        if tuple(t.shape) != (B, H, Sq, D):
            raise ValueError(f"flash_attention_bwd: {name} is {tuple(t.shape)}, "
                             f"expected {(B, H, Sq, D)}")
    if abstract.is_abstract(q):
        grads = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        if q.numel():   # the scratch run_bwd allocates: lse and delta
            torch.empty((2, B, H, Sq), dtype=torch.float32, device=q.device)
            abstract.record("flash_attention_bwd", 2 * abstract.attention_flops(B, H, Sq, Sk, D))
        return grads
    _check("out", out, q.dtype, q.device)
    if dout.device != q.device or dout.dtype != q.dtype:
        raise TypeError(f"flash_attention_bwd: dout is {dout.dtype} on {dout.device}, "
                        f"q is {q.dtype} on {q.device}")
    if not _aligned(dout):
        dout = dout.contiguous()
    grads = run_bwd(_bwd_kernel(), q, k, v, out, dout, causal=causal, window=window,
                    softcap=softcap)
    if q.numel():
        bwd_launches += 1
    return grads


class FlashAttentionFunction(torch.autograd.Function):
    """Attention with the hand-written forward and backward kernels: the
    forward saves q, k, v and its output; the backward recomputes the rows'
    log-sum-exp from them (``csrc/flash_attention_bwd.cu``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, softcap: float):
        out = flash_attention_cuda(q, k, v, causal=causal, window=window, softcap=softcap)
        ctx.save_for_backward(q, k, v, out)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, dout, **ctx.opts)
        return dq, dk, dv, None, None, None
