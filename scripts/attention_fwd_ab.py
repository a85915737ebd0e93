#!/usr/bin/env python
"""The attention forward at the serve paths' bf16 shapes, beside another source.

    PYTHONPATH=src python scripts/attention_fwd_ab.py --old PATH

Times ``repro_torch.kernels.flash_attention.flash_attention_cuda`` and the
same C entry built from ``--old`` (another ``csrc/flash_attention.cu``,
taken with ``git show <commit>:src/repro_torch/kernels/csrc/flash_attention.cu``;
it includes this tree's ``csrc/mma_bf16.cuh``) in turns (this tree, old,
old, this tree) at each shape: decode over cold caches as a CUDA graph of
calls (``chip_smoke.graph_ms``, each call reading the next of K/V sets
that together pass the L2), prefill by CUDA events.  Prints whether the
two outputs are bitwise equal, and the card's name and power limit first.
Needs a CUDA card and nvcc; imports no JAX.
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

# label, B, H, KV, Sq, Sk, D, causal: stablelm, zamba2 and phi3.5-MoE decode
# at Sk 575 (prompt 512 + 63 tokens), stablelm's prefill
SHAPES = [
    ("stablelm decode", 8, 32, 32, 1, 575, 80, False),
    ("zamba2 decode", 8, 32, 32, 1, 575, 64, False),
    ("phi35 decode", 8, 32, 8, 1, 575, 128, False),
    ("stablelm prefill", 8, 32, 32, 512, 512, 80, True),
]


def load_old(src: Path):
    """The forward entry of ``src`` built into the port's (git-ignored)
    build directory, bound and called as this tree's."""
    fn = fa.bind_fwd(_build.load_source(src, "flash_attention_old"))
    return lambda q, k, v, *, causal: fa.run_fwd(fn, q, k, v, causal=causal, window=0,
                                                 softcap=0.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="another csrc/flash_attention.cu to measure beside")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    impls = {"this tree": lambda q, k, v, causal: fa.flash_attention_cuda(q, k, v, causal=causal),
             "old": lambda q, k, v, causal, old=load_old(args.old): old(q, k, v, causal=causal)}
    for seed, (label, B, H, KV, Sq, Sk, D, causal) in enumerate(SHAPES):
        q = cs.model_layout(torch, B, H, Sq, D, "bfloat16", 900 + 10 * seed, dev)
        if Sq > 1:
            sets = [tuple(cs.model_layout(torch, B, KV, Sk, D, "bfloat16", 901 + 10 * seed + i, dev)
                          for i in (0, 1))]
        else:
            sets = cs.decode_sets(torch, B, KV, Sk, D, 901 + 10 * seed, dev)
        outs = {name: fn(q, *sets[0], causal) for name, fn in impls.items()}
        same = torch.equal(outs["this tree"], outs["old"])
        times = []
        for name in ("this tree", "old", "old", "this tree"):
            fn = impls[name]
            if Sq > 1:
                ms = cs.time_ms(torch, lambda: fn(q, *sets[0], causal))
            else:
                n = len(sets)
                ms = cs.graph_ms(torch, [lambda i=i: fn(q, *sets[i % n], causal)
                                         for i in range(8 * n)])
            times.append(f"{name} {ms:.4f}")
        print(f"{label} ({B},{H},{Sq},{D}) kv {KV} Sk {Sk}: outputs bitwise equal {same}; ms "
              + ", ".join(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
