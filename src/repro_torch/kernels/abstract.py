"""The kernels' third case: abstract tensors.

A kernel wrapper chooses its path by where its tensors lie: the plain
version on the CPU, the hand-written kernel on the card, and here, on an
abstract tensor (the ``meta`` device, or a ``FakeTensor`` of
``torch._subclasses.fake_tensor``), outputs of the kernel's shapes and
nothing computed.  The port's dry run (:mod:`repro_torch.launch.dryrun`)
runs the model on abstract tensors; each such call records, on every
recorder that :func:`recording` made current, the kernel's name, the
launches the card would make (the counters' units: a call of the
attention forward, a call of a backward) and the FLOPs of the einsums of
the JAX function the kernel replaces, by the convention of
``repro.launch.hlo_analysis._dot_flops``: 2 x result elements x
contracted size, a causal mask counting the whole product, as the
masked einsum does.  ``tests/test_torch_dryrun.py`` holds each count
equal to ``torch.utils.flop_counter.FlopCounterMode`` over the kernel's
plain version, forward and autograd.
"""
from __future__ import annotations

import contextlib
import math

import torch
from torch._subclasses.fake_tensor import FakeTensor

_recorders: list = []


def is_abstract(t: torch.Tensor) -> bool:
    """True for a tensor that holds no data: on ``meta``, or a FakeTensor."""
    return isinstance(t, FakeTensor) or t.device.type == "meta"


@contextlib.contextmanager
def recording(recorder):
    """Make ``recorder`` (anything with ``kernel(name, flops, launches)``)
    receive the abstract calls made inside the block."""
    _recorders.append(recorder)
    try:
        yield recorder
    finally:
        _recorders.remove(recorder)


def record(name: str, flops: float, launches: int = 1):
    for r in _recorders:
        r.kernel(name, float(flops), launches)


def attention_flops(B: int, H: int, Sq: int, Sk: int, D: int) -> int:
    """Q K^T and P V: two products of 2 B H Sq Sk D each."""
    return 4 * B * H * Sq * Sk * D


def ssd_flops(B: int, S: int, H: int, P: int, N: int, chunk: int) -> int:
    """``ssd_chunked``'s einsums over the padded length: C B^T per chunk
    (2 B S Q N), the intra-chunk output (2 B S Q H P), the chunk states
    and the inter-chunk output (2 B S H N P each)."""
    Sp = math.ceil(S / chunk) * chunk
    return 2 * B * Sp * chunk * N + 2 * B * Sp * chunk * H * P + 4 * B * Sp * H * N * P


def mlstm_flops(B: int, S: int, H: int, D: int, chunk: int) -> int:
    """``mlstm_chunked``'s einsums over the padded length: the chunk
    states' S and n (2 B S H D^2, 2 B S H D), the inter-chunk numerator
    and denominator (the same), the intra-chunk q k^T and its product with
    v (2 B S Q H D each)."""
    Sp = math.ceil(S / chunk) * chunk
    return 4 * B * Sp * H * D * D + 4 * B * Sp * H * D + 4 * B * Sp * chunk * H * D


def mlstm_bwd_flops(B: int, S: int, H: int, D: int, chunk: int) -> int:
    """The backward of h alone (the final state takes no gradient): twice
    the forward's einsums, less the last chunk's state update, which
    only the final state reads (2 x (2 B H D^2 Q + 2 B H D Q))."""
    return 2 * mlstm_flops(B, S, H, D, chunk) - 4 * B * H * D * chunk * (D + 1)
