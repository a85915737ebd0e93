#!/usr/bin/env python
"""The attention forward or backward beside another source of its kernel.

    PYTHONPATH=src python scripts/attention_fwd_ab.py --old PATH
    PYTHONPATH=src python scripts/attention_fwd_ab.py --bwd --old PATH

Forward: times ``repro_torch.kernels.flash_attention.flash_attention_cuda``
(or ``flash_attention_lse_cuda``) and the same C entry built from
``--old`` (another ``csrc/flash_attention.cu``, taken with ``git show
<commit>:src/repro_torch/kernels/csrc/flash_attention.cu``; it includes
this tree's ``csrc/mma_bf16.cuh``) in turns (this tree, old, old, this
tree) at each shape: the decode calls of stablelm, zamba2, phi3.5 and
gemma2 (ring, global, and the lse entry over a rank's half of the global
cache) over cold caches as a CUDA graph of calls (``chip_smoke.graph_ms``,
each call reading the next of K/V sets that together pass the L2),
stablelm's prefill by CUDA events.  Prints the split this tree's wrapper
takes (``flash_attention.decode_split``) and whether the two outputs are
bitwise equal, or their largest difference.

Backward (``--bwd``, ``--old`` another ``csrc/flash_attention_bwd.cu``):
calls ``flash_attention_bwd_cuda`` and the old entry on the same inputs
at each head dim below 256, in fp32 and bf16, over chip_smoke.py's
``ATTN_BWD_CASES`` and ``ATTN_BWD_EDGES``, and says whether dq, dk and dv
are bitwise equal; then times both in turns by CUDA events at stablelm_3b's
train shape and at gemma2_9b's two (1,16,8192,256) kv 8 softcap 50,
global and local (window 4096), where it prints the largest difference of
dq, dk and dv from the old kernel's.  Exits 1 if any output below head
dim 256 differs.

Prints the card's name and power limit first.  Needs a CUDA card and
nvcc; imports no JAX.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

# label, B, H, KV, Sq, Sk, D, causal, softcap, entry ("fwd" or "lse"):
# stablelm, zamba2 and phi3.5-MoE decode at Sk 575 (prompt 512 + 63
# tokens); gemma2's decode over a full ring and its global cache (prompt
# 5120 + 63), and the lse entry over a rank's half of that cache;
# stablelm's prefill
SHAPES = [
    ("stablelm decode", 8, 32, 32, 1, 575, 80, False, 0.0, "fwd"),
    ("zamba2 decode", 8, 32, 32, 1, 575, 64, False, 0.0, "fwd"),
    ("phi35 decode", 8, 32, 8, 1, 575, 128, False, 0.0, "fwd"),
    ("gemma2 decode ring", 2, 16, 8, 1, 4096, 256, False, 50.0, "fwd"),
    ("gemma2 decode global", 2, 16, 8, 1, 5183, 256, False, 50.0, "fwd"),
    ("gemma2 lse, half the global cache", 2, 16, 8, 1, 2592, 256, False, 50.0, "lse"),
    ("stablelm prefill", 8, 32, 32, 512, 512, 80, True, 0.0, "fwd"),
]


def forward_ab(old_src: Path, dev) -> int:
    """The forward at SHAPES, in turns; always 0 (bitwise equality is
    printed, not gated: a forward change may move the bits)."""
    lib = _build.load_source(old_src, "flash_attention_old")
    old_fwd, old_lse = fa.bind_fwd(lib), fa.bind_lse(lib)
    for seed, (label, B, H, KV, Sq, Sk, D, causal, cap, entry) in enumerate(SHAPES):
        opts = dict(causal=causal, window=0, softcap=cap)
        if entry == "lse":
            impls = {"this tree": lambda q, k, v: fa.flash_attention_lse_cuda(q, k, v, **opts)[0],
                     "old": lambda q, k, v: fa.run_lse(old_lse, q, k, v, **opts)[0]}
        else:
            impls = {"this tree": lambda q, k, v: fa.flash_attention_cuda(q, k, v, **opts),
                     "old": lambda q, k, v: fa.run_fwd(old_fwd, q, k, v, **opts)}
        q = cs.model_layout(torch, B, H, Sq, D, "bfloat16", 900 + 10 * seed, dev)
        if Sq > 1:
            sets = [tuple(cs.model_layout(torch, B, KV, Sk, D, "bfloat16", 901 + 10 * seed + i, dev)
                          for i in (0, 1))]
        else:
            sets = cs.decode_sets(torch, B, KV, Sk, D, 901 + 10 * seed, dev, s_alloc=Sk)
        outs = {name: fn(q, *sets[0]) for name, fn in impls.items()}
        same = torch.equal(outs["this tree"], outs["old"])
        diff = float((outs["this tree"].float() - outs["old"].float()).abs().max())
        times = []
        for name in ("this tree", "old", "old", "this tree"):
            fn = impls[name]
            if Sq > 1:
                ms = cs.time_ms(torch, lambda: fn(q, *sets[0]))
            else:
                n = len(sets)
                ms = cs.graph_ms(torch, [lambda i=i: fn(q, *sets[i % n]) for i in range(8 * n)])
            times.append(f"{name} {ms:.4f}")
        splits, chunk = fa._split_plan(q, sets[0][0])
        plan = f"keys split {splits} ways of {chunk}" if splits > 1 else "unsplit"
        print(f"{label} ({B},{H},{Sq},{D}) kv {KV} Sk {Sk} ({entry}, {plan}): outputs bitwise "
              f"equal {same} (max abs difference {diff:.3e}); ms " + ", ".join(times))
        del q, sets, outs
    return 0


def backward_ab(old_src: Path, dev) -> int:
    """The backward over chip_smoke's cases and edges at every head dim
    below 256, then at stablelm_3b's train shape in turns; 1 if any dq,
    dk or dv differs."""
    old_fn = fa.bind_bwd(_build.load_source(old_src, "flash_attention_bwd_old"))
    impls = {"this tree": lambda *t, **o: fa.flash_attention_bwd_cuda(*t, **o),
             "old": lambda *t, **o: fa.run_bwd(old_fn, *t, **o)}
    cases = ([(label, B, H, KV, Sq, Sk, causal, window, softcap, 1.0)
              for label, B, H, KV, Sq, Sk, causal, window, softcap in cs.ATTN_BWD_CASES]
             + [(label, B, H, KV, Sq, Sk, causal, 0, 0.0, scale)
                for label, B, H, KV, Sq, Sk, causal, scale in cs.ATTN_BWD_EDGES])
    differ = 0
    for D in (d for d in fa.SUPPORTED_D if d < 256):
        for dtype in ("float32", "bfloat16"):
            same = 0
            for j, (label, B, H, KV, Sq, Sk, causal, window, softcap, scale) in enumerate(cases):
                seed = 700 + 10 * j + D
                q = cs.randn(torch, (B, H, Sq, D), "float32", seed, dev, scale).to(
                    getattr(torch, dtype))
                k = cs.randn(torch, (B, KV, Sk, D), "float32", seed + 1, dev, scale).to(q.dtype)
                v = cs.randn(torch, (B, KV, Sk, D), dtype, seed + 2, dev)
                dout = cs.randn(torch, (B, H, Sq, D), dtype, seed + 3, dev)
                opts = dict(causal=causal, window=window, softcap=softcap)
                out = fa.flash_attention_cuda(q, k, v, **opts)
                got = {name: fn(q, k, v, out, dout, **opts) for name, fn in impls.items()}
                if all(torch.equal(a, b) for a, b in zip(got["this tree"], got["old"])):
                    same += 1
                else:
                    differ += 1
                    print(f"D {D} {dtype} {label}: dq, dk, dv NOT bitwise equal")
            print(f"D {D} {dtype}: dq, dk, dv bitwise equal in {same} of {len(cases)} cases")

    H, D = 32, 80
    for dtype in ("bfloat16", "float32"):
        q, k, v, dout = (cs.model_layout(torch, cs.BATCH, H, cs.TRAIN_SEQ, D, dtype, 900 + n, dev)
                         for n in range(4))
        out = fa.flash_attention_cuda(q, k, v, causal=True)
        times = []
        for name in ("this tree", "old", "old", "this tree"):
            fn = impls[name]
            ms = cs.time_ms(torch, lambda: fn(q, k, v, out, dout, causal=True, window=0,
                                              softcap=0.0), iters=10)
            times.append(f"{name} {ms:.4f}")
        print(f"train ({cs.BATCH},{H},{cs.TRAIN_SEQ},{D}) causal {dtype}: ms " + ", ".join(times))

    # gemma2's train shapes, bf16: the D 256 path, beside the old source's
    H, KV, D, S = 16, 8, 256, cs.GEMMA2_TRAIN_SEQ
    for label, window, seed in (("global", 0, 1300), ("local", 4096, 1310)):
        q, dout = (cs.model_layout(torch, 1, H, S, D, "bfloat16", seed + n, dev) for n in (0, 3))
        k, v = (cs.model_layout(torch, 1, KV, S, D, "bfloat16", seed + n, dev) for n in (1, 2))
        opts = dict(causal=True, window=window, softcap=50.0)
        out = fa.flash_attention_cuda(q, k, v, **opts)
        got = {name: fn(q, k, v, out, dout, **opts) for name, fn in impls.items()}
        diffs = [float((a.float() - b.float()).abs().max())
                 for a, b in zip(got["this tree"], got["old"])]
        del got
        times = []
        for name in ("this tree", "old", "old", "this tree"):
            fn = impls[name]
            ms = cs.time_ms(torch, lambda: fn(q, k, v, out, dout, **opts), iters=5, reps=3)
            times.append(f"{name} {ms:.4f}")
        bound = cs.attention_bwd_bound_ms(torch, q, k, causal=True, window=window, dev=dev)
        print(f"gemma2 train {label} (1,{H},{S},{D}) kv {KV} causal"
              f"{f' window {window}' if window else ''} softcap 50 bf16: max abs difference from "
              f"the old kernel dq {diffs[0]:.3e} dk {diffs[1]:.3e} dv {diffs[2]:.3e}; bound "
              f"{bound[0]:.4f} ms ({bound[1]}); ms " + ", ".join(times))
        del q, k, v, dout, out
        torch.cuda.empty_cache()
    return 1 if differ else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="another csrc/flash_attention.cu (or, with --bwd, "
                         "csrc/flash_attention_bwd.cu) to measure beside")
    ap.add_argument("--bwd", action="store_true", help="the backward instead of the forward")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    return (backward_ab if args.bwd else forward_ab)(args.old, torch.device("cuda"))


if __name__ == "__main__":
    sys.exit(main())
