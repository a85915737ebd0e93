#!/usr/bin/env python
"""The mLSTM backward at xlstm_125m's train shape, launch by launch, on the card.

    PYTHONPATH=src python scripts/mlstm_bwd_split.py [--old PATH] [--dtype bfloat16 float32]

Times ``repro_torch.kernels.mlstm.mlstm_scan_bwd_cuda`` at (B 8, S 512, H 4,
D 384), chunk 128, the gates strided as ``mlstm_block`` passes them (CUDA
events over a few calls), and splits one call's device time by kernel with
``torch.profiler``.  ``--old`` names another source of
``csrc/mlstm_bwd.cu`` with the same C interface (an older commit's, taken
with ``git show <commit>:src/repro_torch/kernels/csrc/mlstm_bwd.cu``); it
is built beside this tree's library and measured in the same way, in turns
(this tree, old, old, this tree), with the relative rms of both against
autograd of the fp32 plain version.  Prints the card's name and power
limit first.  Needs a CUDA card and nvcc; imports no JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))
from repro_torch.kernels import _build, mlstm, ref  # noqa: E402

SHAPE, CHUNK = (8, 512, 4, 384), 128


def inputs(dtype, dev):
    B, S, H, D = SHAPE
    g = torch.Generator(device=dev).manual_seed(1710)
    q, k, v, dh = (torch.randn(SHAPE, generator=g, device=dev).to(dtype) for _ in range(4))
    gates = torch.randn((B, S, 2 * H), generator=g, device=dev)
    gates[..., H:] += 1.0
    ig, fg = torch.split(gates.to(dtype), H, dim=-1)
    return (q, k, v, ig, fg), dh


def load_old(src: Path):
    """The C entry of ``src`` built into the port's (git-ignored) build directory."""
    lib = _build.load_source(src, "mlstm_bwd_old")
    lib.mlstm_scan_bwd.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 6
                                   + [ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p])
    lib.mlstm_scan_bwd.restype = ctypes.c_int
    lib.mlstm_scan_bwd_scratch_bytes.argtypes = [ctypes.c_int] * 5
    lib.mlstm_scan_bwd_scratch_bytes.restype = ctypes.c_int64

    def call(q, k, v, ig, fg, dh, *, chunk):
        B, S, H, D = q.shape
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        di, df = (torch.empty((B, S, H), dtype=q.dtype, device=q.device) for _ in range(2))
        scratch = torch.empty(lib.mlstm_scan_bwd_scratch_bytes(B, S, H, D, chunk) // 4,
                              device=q.device)
        strides = (ctypes.c_int64 * 18)(*(s for t in (q, k, v, ig, fg, dh)
                                          for s in t.stride()[:3]))
        rc = lib.mlstm_scan_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), ig.data_ptr(),
                                fg.data_ptr(), dh.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                                dv.data_ptr(), di.data_ptr(), df.data_ptr(), scratch.data_ptr(),
                                1 if q.dtype == torch.bfloat16 else 0, B, S, H, D, chunk, strides,
                                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"old mlstm_scan_bwd failed: CUDA error {rc}")
        return dq, dk, dv, di, df

    return call


def time_ms(fn, iters=5, reps=3) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return sorted(times)[len(times) // 2]


def split(fn) -> list[tuple[str, float]]:
    """Device ms of each kernel of one call, in launch order."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda e: e.time_range.start)
    return [(m.group(1), e.self_device_time_total / 1e3) for e in rows
            for m in [re.search(r"(mlstm_bwd_\w+)", e.name)] if m]


def rel_rms(got, want) -> float:
    return float((got.double() - want.double()).square().mean().sqrt()
                 / want.double().square().mean().sqrt())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, help="another csrc/mlstm_bwd.cu to measure beside")
    ap.add_argument("--dtype", nargs="+", default=["bfloat16", "float32"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    impls = {"this tree": mlstm.mlstm_scan_bwd_cuda}
    if args.old:
        impls["old"] = load_old(args.old)
    for dtype in args.dtype:
        ins, dh = inputs(getattr(torch, dtype), dev)
        t = [a.detach().float().requires_grad_() for a in ins]
        want = torch.autograd.grad(ref.mlstm_chunked(*t, CHUNK)[0], t, dh.float())
        for name, fn in impls.items():
            got = fn(*ins, dh, chunk=CHUNK)
            print(f"[{dtype}] {name}: rel rms against autograd of the fp32 plain version "
                  + " ".join(f"{rel_rms(g.float(), w):.2e}" for g, w in zip(got, want)))
        order = list(impls) + list(reversed(impls))
        for name in order:
            fn = impls[name]
            print(f"[{dtype}] {name}: {time_ms(lambda: fn(*ins, dh, chunk=CHUNK)):.4f} ms a call")
        for name, fn in impls.items():
            parts = split(lambda: fn(*ins, dh, chunk=CHUNK))
            print(f"[{dtype}] {name}: by kernel, one call: " + ", ".join(
                f"{k} {ms:.4f} ms" for k, ms in parts) + f"; sum {sum(ms for _, ms in parts):.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
