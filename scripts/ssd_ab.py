#!/usr/bin/env python
"""The SSD scan's forward or backward beside another source of its kernel.

    PYTHONPATH=src python scripts/ssd_ab.py --old PATH
    PYTHONPATH=src python scripts/ssd_ab.py --bwd --old PATH

``--old`` is another ``csrc/ssd.cu`` (with ``--bwd``, ``csrc/ssd_bwd.cu``),
taken with ``git show <commit>:src/repro_torch/kernels/csrc/ssd.cu``; it
is built into its own library with this tree's headers and called through
the same C entry (``ssd_scan_fwd`` / ``ssd_scan_bwd``, whose arguments are
pinned), by ``ssd.run_fwd`` / ``ssd.run_bwd``.

First both run chip_smoke.py's SSD cases (and the backward's edge cases)
in fp32 and bf16: every fp32 output must be bitwise the old kernel's (the
fp32 kernels are unchanged); every bf16 output must lie within ``SSD_TOL``
of the old kernel's and of the plain version's (forward), or, for
gradients, within ``BF16_GRAD_REL_RMS`` (relative rms) of autograd of the
plain version in fp32 and of the old kernel's (backward).  Then at three
shapes in bf16, in the model's strided layout: zamba2_1p2b's serve and
train call (8,512,64,64) N 64, chunk 128; a (2, 2) mesh rank's (4,512,32,
64) (half the batch, half the heads); and the long serve mode's
(1,4096,64,64), where nc is 32: this tree and the old kernel in turns
(this tree, old, old, this tree), each a CUDA graph of calls that read
the next of input sets that together pass the 50 MB L2 (cold-L2 calls,
device time), beside the bound (``chip_smoke.ssd_bound_ms`` /
``ssd_bwd_bound_ms``) and the share of it.  Each shape's outputs are held
as above too.  Prints the card's name and power limit first; exits 1 on
any miss.  Needs a CUDA card and nvcc; imports no JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build, ref, ssd  # noqa: E402

# label, B, S, H, P, N, chunk
SHAPES = [
    ("zamba2 serve/train", 8, 512, 64, 64, 64, 128),
    ("(2, 2) mesh rank", 4, 512, 32, 64, 64, 128),
    ("long serve mode", 1, 4096, 64, 64, 64, 128),
]
# chip_smoke.py's SSD cases: B, S, H, P, N, chunk, final-state cotangent, model layout
CASES = [
    (1, 64, 2, 16, 8, 16, False, False), (2, 128, 3, 16, 8, 32, True, False),
    (1, 128, 1, 32, 16, 64, False, False), (2, 96, 2, 8, 4, 32, False, False),
    (1, 40, 2, 4, 4, 4, False, False), (2, 64, 3, 8, 8, 16, True, False),
    (1, 100, 2, 16, 8, 32, True, False), (2, 5, 2, 16, 8, 8, False, False),
    (1, 37, 3, 12, 20, 12, False, False), (2, 96, 2, 64, 64, 32, False, True),
    (2, 200, 4, 64, 64, 128, True, True), (1, 1100, 3, 16, 8, 32, True, False),
    (1, 256, 5, 32, 16, 64, False, False), (2, 384, 7, 64, 64, 128, True, True),
]


def plain_grads(args, dy, dfinal, chunk):
    t = [a.detach().float().requires_grad_() for a in args]
    S = args[0].shape[1]
    y, st = ref.ssd_ref(*t) if S % chunk else ref.ssd_chunked(*t, chunk)
    outs, cots = [y], [dy.float()]
    if dfinal is not None:
        outs.append(st)
        cots.append(dfinal)
    return torch.autograd.grad(outs, t, cots)


def held(label, new, old, want, dtype, grads) -> bool:
    """fp32: bitwise the old kernel's; bf16: within the tolerance of the
    plain version and of the old kernel."""
    if dtype == "float32":
        ok = all(torch.equal(a, b) for a, b in zip(new, old))
        print(f"  {label} fp32: bitwise the old kernel's {ok}")
        return ok
    if grads:
        rms = [cs.rel_rms(torch, a.float(), w) for a, w in zip(new, want)]
        rms_old = [cs.rel_rms(torch, a.float(), b.float()) for a, b in zip(new, old)]
        ok = max(rms) <= cs.BF16_GRAD_REL_RMS and max(rms_old) <= cs.BF16_GRAD_REL_RMS
        print(f"  {label} bf16: rel rms against the plain version "
              + " ".join(f"{v:.1e}" for v in rms) + ", against the old kernel "
              + " ".join(f"{v:.1e}" for v in rms_old) + f" (<= {cs.BF16_GRAD_REL_RMS}) "
              + ("ok" if ok else "MISS"))
        return ok
    tol = cs.SSD_TOL["bfloat16"]
    ok = all(torch.allclose(a.float(), w.float(), **tol) and torch.allclose(a.float(), b.float(), **tol)
             for a, b, w in zip(new, old, want))
    err = max(float((a.float() - w.float()).abs().max()) for a, w in zip(new, want))
    err_old = max(float((a.float() - b.float()).abs().max()) for a, b in zip(new, old))
    print(f"  {label} bf16: max abs difference from the plain version {err:.3e}, from the old "
          f"kernel {err_old:.3e} (rtol {tol['rtol']}, atol {tol['atol']}) {'ok' if ok else 'MISS'}")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="another csrc/ssd.cu (with --bwd, csrc/ssd_bwd.cu) to measure beside")
    ap.add_argument("--bwd", action="store_true", help="the backward instead of the forward")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    dev = torch.device("cuda")
    bwd = args.bwd
    lib = _build.load_source(args.old, "ssd_bwd_old" if bwd else "ssd_old")
    if bwd:
        old_fn = ssd.bind_bwd(lib)
        old_scratch = lib.ssd_scan_bwd_scratch_bytes
        old_scratch.argtypes = [ctypes.c_int] * 6
        old_scratch.restype = ctypes.c_int64

        def old(a, dy, dfinal, chunk):
            B, S, H, P = a[0].shape
            return ssd.run_bwd(old_fn, old_scratch(B, S, H, P, a[3].shape[-1], chunk), *a, dy,
                               dfinal, chunk)

        def new(a, dy, dfinal, chunk):
            return ssd.ssd_scan_bwd_cuda(*a, dy, dfinal, chunk=chunk)
    else:
        old_fn = ssd.bind_fwd(lib)

        def old(a, dy, dfinal, chunk):
            return ssd.run_fwd(old_fn, *a, chunk)

        def new(a, dy, dfinal, chunk):
            return ssd.ssd_scan_cuda(*a, chunk=chunk)

    def want_of(a, dy, dfinal, chunk):
        if bwd:
            return plain_grads(a, dy, dfinal, chunk)
        f = [t.float() for t in a]
        return ref.ssd_ref(*f) if a[0].shape[1] % chunk else ref.ssd_chunked(*f, chunk)

    misses = 0
    print("chip_smoke's SSD cases" + (" (the backward's, with its edges)" if bwd else "") + ":")
    for n, (B, S, H, P, N, chunk, fin, ml) in enumerate(CASES):
        for dtype in ("float32", "bfloat16"):
            a = cs.ssd_inputs(torch, B, S, H, P, N, dtype, 2000 + 10 * n, dev, model_layout=ml)
            dy = cs.randn(torch, (B, S, H, P), dtype, 2005 + 10 * n, dev)
            dfinal = (cs.randn(torch, (B, H, N, P), "float32", 2006 + 10 * n, dev)
                      if fin and bwd else None)
            got, was = new(a, dy, dfinal, chunk), old(a, dy, dfinal, chunk)
            torch.cuda.synchronize()
            want = want_of(a, dy, dfinal, chunk) if dtype == "bfloat16" else None
            misses += not held(f"({B},{S},{H},{P}) N {N} chunk {chunk}", got, was, want, dtype, bwd)

    print("shapes (bf16, model layout; ms a call as CUDA graphs of cold-L2 calls):")
    for n, (label, B, S, H, P, N, chunk) in enumerate(SHAPES):
        per_set = (2 * B * S * H * P * 2 if bwd else B * S * H * P * 2) + 2 * B * S * N * 2
        nsets = max(2, -(-100_000_000 // per_set))
        sets = []
        for i in range(nsets):
            a = cs.ssd_inputs(torch, B, S, H, P, N, "bfloat16", 2500 + 10 * n + i, dev,
                              model_layout=True)
            dy = cs.randn(torch, (B, S, H, P), "bfloat16", 2600 + 10 * n + i, dev) if bwd else None
            sets.append((a, dy))
        a, dy = sets[0]
        got, was = new(a, dy, None, chunk), old(a, dy, None, chunk)
        misses += not held(label, got, was, want_of(a, dy, None, chunk), "bfloat16", bwd)
        del got, was
        fns = {"this tree": new, "old": old}
        times: dict[str, list[float]] = {}
        for name in ("this tree", "old", "old", "this tree"):
            calls = [lambda s=s, fn=fns[name]: fn(s[0], s[1], None, chunk) for s in sets] * 2
            times.setdefault(name, []).append(cs.graph_ms(torch, calls))
        bound, by = (cs.ssd_bwd_bound_ms(a[0], N, chunk) if bwd
                     else cs.ssd_bound_ms(*a, chunk))
        ms = {k: min(v) for k, v in times.items()}
        plan = ssd.plan(B, S, H, chunk, backward=bwd)
        print(f"{label} ({B},{S},{H},{P}) N {N} chunk {chunk} {'backward' if bwd else 'forward'}"
              f" (heads a block {plan[0]}, chunks a block {plan[1]}, blocks a cluster {plan[2]},"
              f" blocks at once {plan[3]}): "
              f"ms this tree " + "/".join(f"{x:.4f}" for x in times["this tree"])
              + ", old " + "/".join(f"{x:.4f}" for x in times["old"])
              + f"; bound {bound * 1e3:.2f} us ({by}); share of the bound: this tree "
              f"{bound / ms['this tree']:.1%}, old {bound / ms['old']:.1%}; "
              f"{ms['old'] / ms['this tree']:.2f}x the old kernel's speed ({nsets} input sets)")
        del sets, a, dy
        torch.cuda.empty_cache()
    print(f"misses: {misses}")
    return 1 if misses else 0


if __name__ == "__main__":
    sys.exit(main())
