"""What one rank's step does, read off the ops it dispatches: FLOPs,
matmul bytes, kernel launches, live memory, and the collectives' bytes.

The counterpart of :mod:`repro.launch.hlo_analysis`, which parses the
post-SPMD HLO that XLA compiled.  The port has no compiler: it runs the
step eagerly, so :class:`Recorder`, a ``TorchDispatchMode``, sees every
op the rank runs, forward and backward, as it runs (on abstract tensors
in the dry run, where nothing is computed):

* ``flops``: every ``mm``, ``bmm``, ``addmm`` and ``baddbmm`` at 2 x
  result elements x contracted size (``hlo_analysis._dot_flops``'s
  convention, and ``FlopCounterMode``'s), plus what each hand-written
  kernel's abstract case records (the einsums of the JAX function it
  replaces, :mod:`repro_torch.kernels.abstract`); elementwise FLOPs are
  ignored there too;
* ``dot_bytes``: the matmuls' operands and results;
* ``kernel_launches``: the launches the card would make, by kernel
  counter (``flash_attention``, ``flash_attention_bwd``, ...);
* the peak of the bytes of the storages the step creates and holds at
  once (weak references to them; rounded up to the CUDA caching
  allocator's 512-byte blocks, as ``torch.cuda.max_memory_allocated``
  counts them);
* the collectives from the mesh's own counters
  (``ProcessMesh.comm_bytes`` and ``comm_calls``), reported in
  :func:`analyze`'s schema: the result bytes of each op, an all-reduce
  counted twice (its ring moves about twice its buffer), as JAX counts
  them.

A Python loop is unrolled as it runs, so there are no trip counts to
infer.  ``hlo_analysis`` also reports ``*_tpu_corrected`` keys, which
halve the fp32 payloads that XLA's CPU backend upcasts from bf16 before
placing a collective; the port's collectives move the dtype the model
hands them, so those keys carry the raw values unchanged.
"""
from __future__ import annotations

import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import abstract

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
_KIND = {"all_gather": "all-gather", "reduce_scatter": "reduce-scatter",
         "all_reduce": "all-reduce"}
BLOCK = 512   # the CUDA caching allocator's rounding of a request

_aten = torch.ops.aten
_MATMULS = {_aten.mm.default: "mm", _aten.bmm.default: "bmm", _aten.addmm.default: "addmm",
            _aten.baddbmm.default: "baddbmm"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Recorder(TorchDispatchMode):
    """Counts a step's matmul FLOPs and bytes, the kernels' abstract
    records, and the peak of the bytes of the storages it creates
    (``peak_bytes``; ``live_bytes`` now).  Enter it inside the step's
    ``FakeTensorMode`` (or over real tensors); kernels report to it while
    it is entered."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.dot_bytes = 0.0
        self.kernel_flops: dict[str, float] = {}
        self.kernel_launches: dict[str, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._seen: dict[int, weakref.ref] = {}
        self._known: set[int] = set()
        self._recording = None

    def __enter__(self):
        self._recording = abstract.recording(self)
        self._recording.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._recording.__exit__(*exc)

    def known(self, tensors):
        """Storages that exist before the step (its arguments): ops that
        write into them create nothing."""
        for t in tensors:
            self._known.add(id(t.untyped_storage()))

    def kernel(self, name: str, flops: float, launches: int):
        """An abstract case's record (a loop recorded whole, like the
        sLSTM recurrence's, launches nothing)."""
        self.flops += flops
        self.kernel_flops[name] = self.kernel_flops.get(name, 0.0) + flops
        if launches:
            self.kernel_launches[name] = self.kernel_launches.get(name, 0) + launches

    def _freed(self, key: int, nbytes: int):
        self._seen.pop(key, None)
        self.live_bytes -= nbytes

    def _track(self, t: torch.Tensor):
        st = t.untyped_storage()
        key = id(st)
        if key in self._known or key in self._seen:
            return
        nbytes = math.ceil(st.nbytes() / BLOCK) * BLOCK
        self._seen[key] = weakref.ref(st, lambda _, k=key, n=nbytes: self._freed(k, n))
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        kind = _MATMULS.get(func)
        if kind is not None:
            a, b = (args[0], args[1]) if kind in ("mm", "bmm") else (args[1], args[2])
            self.flops += 2.0 * out.numel() * a.shape[-1]
            self.dot_bytes += _nbytes(a) + _nbytes(b) + _nbytes(out)
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self._track(t)
        return out


def collectives(mesh) -> dict:
    """The mesh's collectives so far in ``hlo_analysis.analyze``'s
    schema: per kind, the bytes of each op's result (an all-gather's
    output, a reduce-scatter's output, an all-reduce's tensor counted
    twice) and the number of ops; ``per_op_axis`` keeps the mesh's own
    counts, by (operation, axis), as ``ProcessMesh.comm_bytes`` holds them
    (a reduce-scatter's input)."""
    per_kind = {k: 0 for k in COLLECTIVES}
    counts = {k: 0 for k in COLLECTIVES}
    sizes = mesh.axis_sizes()
    for (op, axis), nbytes in mesh.comm_bytes.items():
        kind = _KIND[op]
        if kind == "reduce-scatter":
            nbytes //= sizes[axis]
        elif kind == "all-reduce":
            nbytes *= 2
        per_kind[kind] += nbytes
        counts[kind] += mesh.comm_calls.get((op, axis), 0)
    total = sum(per_kind.values())
    return {"per_kind": per_kind, "counts": counts, "total_bytes": total,
            "per_kind_tpu_corrected": dict(per_kind), "total_bytes_tpu_corrected": total,
            "per_op_axis": {f"{op} {axis}": n for (op, axis), n in
                            sorted(mesh.comm_bytes.items())}}


def analyze(recorder: Recorder, mesh) -> dict:
    """``hlo_analysis.analyze``'s record for a step that ran under
    ``recorder`` on ``mesh``."""
    return {"flops": recorder.flops, "dot_bytes": recorder.dot_bytes,
            "collectives": collectives(mesh)}
