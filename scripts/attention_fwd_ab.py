#!/usr/bin/env python
"""The attention forward or backward beside another source of its kernel.

    PYTHONPATH=src python scripts/attention_fwd_ab.py --old PATH [--only TEXT]
    PYTHONPATH=src python scripts/attention_fwd_ab.py --bwd --old PATH

Forward: times ``repro_torch.kernels.flash_attention.flash_attention_cuda``
(or ``flash_attention_lse_cuda``) and the same C entry built from
``--old`` (another ``csrc/flash_attention.cu``, taken with ``git show
<commit>:src/repro_torch/kernels/csrc/flash_attention.cu``; it includes
this tree's ``csrc/mma_bf16.cuh``) in turns (this tree, old, old, this
tree) at each shape: the decode calls (Sk 575) of stablelm, zamba2,
phi3.5, qwen2_vl, yi, command_r, llama4 and musicgen, the lse entry over
a rank's half of stablelm's cache, and gemma2's (ring, global, and the
lse entry over a rank's half of the global cache) over cold caches as a
CUDA graph of calls (``chip_smoke.graph_ms``, each call reading the next
of K/V sets that together pass the L2), each beside SDPA's graph (the
lse entry's beside efficient attention with its log-sum-exp) and the
bound, the
prefills (8 x 512) of stablelm, zamba2, phi3.5, qwen2_vl, yi, command_r,
llama4 and musicgen, and gemma2's at its serve shape (2,16,5120,256) and
its train shape (1,16,8192,256), global and local (window 4096), each as
a CUDA graph of calls (device time; a prefill's calls launched one by one,
the wrapper's host time in them, are printed beside).  Prints the split
this tree's wrapper takes (``flash_attention.decode_split`` below D 256,
``d256_decode_split`` at D 256; the old source's calls are routed by the
latter, the rule of every head dim before the TMA decode kernel), whether
the two outputs are bitwise equal, or their largest difference, the bound
and SDPA's time.  Then calls both on ``chip_smoke.py``'s forward cases at
every head dim below 256 in both dtypes and on D 256 cases in both.
Every fp32 output and every D 256 output must be bitwise the old
kernel's; a bf16 output below D 256 (the prefill and the decode, where
the old source may run another design) must lie within 2e-2 of the old
kernel's output and of the plain version's.  Exits 1 if any misses.

Backward (``--bwd``, ``--old`` another ``csrc/flash_attention_bwd.cu``):
calls ``flash_attention_bwd_cuda`` and the old entry on the same inputs
at every head dim, in fp32 and bf16, over chip_smoke.py's
``ATTN_BWD_CASES`` and ``ATTN_BWD_EDGES``: fp32 and D 256 outputs must
be bitwise the old kernel's; bf16 below D 256 (redesigned) must lie
within ``GRAD_TOL`` of autograd of ``attention_ref`` in fp32.  Then, in
turns, as CUDA graphs of calls, the six train shapes below D 256
(stablelm, zamba2, phi3.5, qwen2_vl, yi, musicgen; each held within
``GRAD_TOL`` too) beside SDPA's backward (a graph of it, or eager calls
where capture fails, as printed), the plain version's backward (eager),
the bound, the share of the bf16 peak
and the largest difference from the old kernel; stablelm's shape in
fp32 and gemma2_9b's two (1,16,8192,256) kv 8 softcap 50, global and
local (window 4096), bitwise, by CUDA events.  Exits 1 on any miss.

Prints the card's name and power limit first.  Needs a CUDA card and
nvcc; imports no JAX.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

# label, B, H, KV, Sq, Sk, D, causal, window, softcap, entry ("fwd" or
# "lse"): the decode of stablelm, zamba2, phi3.5-MoE and the five families
# at Sk 575 (prompt 512 + 63 tokens), the lse entry over a rank's half of
# stablelm's cache; gemma2's decode over a full ring and its global cache
# (prompt 5120 + 63), and the lse entry over a rank's half of that cache;
# the prefills (8 x 512) of stablelm, zamba2, phi3.5 and the five
# families, and gemma2's at its serve and train shapes, global and local
SHAPES = [
    ("stablelm decode", 8, 32, 32, 1, 575, 80, False, 0, 0.0, "fwd"),
    ("zamba2 decode", 8, 32, 32, 1, 575, 64, False, 0, 0.0, "fwd"),
    ("phi35 decode", 8, 32, 8, 1, 575, 128, False, 0, 0.0, "fwd"),
    ("qwen2_vl decode", 8, 28, 4, 1, 575, 128, False, 0, 0.0, "fwd"),
    ("yi decode", 8, 56, 8, 1, 575, 128, False, 0, 0.0, "fwd"),
    ("command_r decode", 8, 96, 8, 1, 575, 128, False, 0, 0.0, "fwd"),
    ("llama4 decode", 8, 40, 8, 1, 575, 128, False, 0, 0.0, "fwd"),
    ("musicgen decode", 8, 24, 24, 1, 575, 64, False, 0, 0.0, "fwd"),
    ("stablelm lse, half the cache", 8, 32, 32, 1, 288, 80, False, 0, 0.0, "lse"),
    ("gemma2 decode ring", 2, 16, 8, 1, 4096, 256, False, 0, 50.0, "fwd"),
    ("gemma2 decode global", 2, 16, 8, 1, 5183, 256, False, 0, 50.0, "fwd"),
    ("gemma2 lse, half the global cache", 2, 16, 8, 1, 2592, 256, False, 0, 50.0, "lse"),
    ("stablelm prefill", 8, 32, 32, 512, 512, 80, True, 0, 0.0, "fwd"),
    ("zamba2 prefill", 8, 32, 32, 512, 512, 64, True, 0, 0.0, "fwd"),
    ("phi35 prefill", 8, 32, 8, 512, 512, 128, True, 0, 0.0, "fwd"),
    ("qwen2_vl prefill", 8, 28, 4, 512, 512, 128, True, 0, 0.0, "fwd"),
    ("yi prefill", 8, 56, 8, 512, 512, 128, True, 0, 0.0, "fwd"),
    ("command_r prefill", 8, 96, 8, 512, 512, 128, True, 0, 0.0, "fwd"),
    ("llama4 prefill", 8, 40, 8, 512, 512, 128, True, 0, 0.0, "fwd"),
    ("musicgen prefill", 8, 24, 24, 512, 512, 64, True, 0, 0.0, "fwd"),
    ("gemma2 prefill global", 2, 16, 8, 5120, 5120, 256, True, 0, 50.0, "fwd"),
    ("gemma2 prefill local", 2, 16, 8, 5120, 5120, 256, True, 4096, 50.0, "fwd"),
    ("gemma2 train global", 1, 16, 8, 8192, 8192, 256, True, 0, 50.0, "fwd"),
    ("gemma2 train local", 1, 16, 8, 8192, 8192, 256, True, 4096, 50.0, "fwd"),
]


def must_match(D: int, dtype) -> bool:
    """Whether this tree's forward must give the old kernel's bits: every
    fp32 call and every D 256 call (the bf16 prefill and decode below D 256
    were redesigned: they are held within 2e-2 instead, ``agrees``)."""
    return D == 256 or dtype == torch.float32


def agrees(name, new, old, q, k, v, opts) -> bool:
    """A bf16 output below D 256 within 2e-2 of the old kernel's and of the
    plain version's; prints a miss."""
    want = ref.attention_ref(q, k, v, **opts)
    tol = cs.TOL["bfloat16"]
    ok = all(torch.allclose(new.float(), w.float(), **tol) for w in (old, want))
    if not ok:
        print(f"{name}: NOT within 2e-2 of the old kernel's output and the plain version's "
              f"(max abs difference {float((new.float() - old.float()).abs().max()):.3e}, "
              f"{float((new.float() - want.float()).abs().max()):.3e})")
    return ok


def bitwise_cases(impls, dev) -> int:
    """Both builds on chip_smoke's forward cases (``kernel_phase``'s, every
    head dim below 256, both dtypes) and D 256 cases in both dtypes; each
    output bitwise the old kernel's where ``must_match``, else within 2e-2
    of it and of the plain version (``agrees``); returns how many miss."""
    cases = [  # B, H, KV, Sq, Sk, D, causal, window, softcap
        (1, 2, 2, 128, 128, 64, True, 0, 0.0), (2, 8, 2, 128, 128, 64, True, 0, 0.0),
        (1, 4, 1, 64, 256, 32, False, 0, 0.0), (2, 3, 3, 96, 96, 16, True, 0, 0.0),
        (2, 4, 2, 5, 37, 80, True, 0, 0.0), (1, 4, 4, 100, 77, 80, False, 20, 0.0),
        (1, 8, 2, 70, 70, 128, True, 0, 0.0), (1, 2, 2, 128, 128, 32, True, 64, 0.0),
        (1, 2, 2, 64, 64, 32, True, 0, 20.0), (1, 8, 2, 128, 128, 32, True, 0, 0.0),
    ]
    cases += [(2, 8, 2, Sq, 40 * Sq + 17, (16, 32, 64, 80, 128)[Sq % 5], Sq % 2 == 0, 0, 0.0)
              for Sq in range(1, 16)]
    cases += [(2, 4, 2, Sq, Sk, D, causal, 0, 0.0) for i, D in enumerate((16, 32, 64, 80, 128))
              for Sq, Sk, causal in ((37 + 31 * i, 100 + 23 * i, True),
                                     (150 - 9 * i, 61 + 7 * i, False))]
    d256 = [(1, 16, 8, 300, 300, 256, True, 0, 50.0), (1, 4, 2, 600, 600, 256, True, 64, 50.0),
            (2, 16, 8, 1, 700, 256, False, 0, 50.0), (2, 4, 2, 77, 300, 256, True, 0, 0.0)]
    differ = total = same = 0
    for j, (B, H, KV, Sq, Sk, D, causal, window, cap) in enumerate(cases + d256):
        for dtype in (torch.float32, torch.bfloat16):
            seed = 2000 + 10 * j
            q = cs.randn(torch, (B, H, Sq, D), "float32", seed, dev, 2.0).to(dtype)
            k = cs.randn(torch, (B, KV, Sk, D), "float32", seed + 1, dev, 2.0).to(dtype)
            v = cs.randn(torch, (B, KV, Sk, D), "float32", seed + 2, dev).to(dtype)
            opts = dict(causal=causal, window=window, softcap=cap)
            got = [fn(q, k, v, **opts) for fn in impls.values()]
            name = (f"({B},{H},{Sq},{D}) kv {KV} Sk {Sk} causal {causal} window {window} "
                    f"softcap {cap} {dtype}")
            total += 1
            same += torch.equal(*got)
            if must_match(D, dtype):
                if not torch.equal(*got):
                    differ += 1
                    print(f"{name}: NOT bitwise equal to the old kernel")
            elif not agrees(name, *got, q, k, v, opts):
                differ += 1
    print(f"forward cases (every head dim, both dtypes): bitwise equal in {same} of {total}; "
          f"{differ} miss (bitwise where required, else 2e-2)")
    return differ


def forward_ab(old_src: Path, dev, only: str | None = None) -> int:
    """The forward at SHAPES (those whose label holds ``only``, and then not
    the cases of ``bitwise_cases``, where given), in turns; 1 if any output
    that must keep the old kernel's bits (``must_match``) differs, or a bf16
    output below D 256 misses 2e-2 (``agrees``)."""
    lib = _build.load_source(old_src, "flash_attention_old")
    old_fwd, old_lse, old_split = fa.bind_fwd(lib), fa.bind_lse(lib), fa.bind_split(lib)

    def old_entry(q, k, v, *, lse=False, **opts):
        """The old source's entries, routed as the old wrapper routed a call
        (a bf16 decode call ``d256_decode_split`` splits goes to the split
        entry, at every head dim)."""
        B, H, Sq, D = q.shape
        splits, chunk = (1, k.shape[2])
        if q.dtype == torch.bfloat16 and Sq < fa.DECODE_ROWS and k.shape[2]:
            splits, chunk = fa.d256_decode_split(B, k.shape[1], H // k.shape[1] * Sq, k.shape[2],
                                                 fa.sm_count(q.device))
        if splits > 1:
            out = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device) if lse else None
            return fa.run_split(q, k, v, splits, chunk, lse=out, fn=old_split, **opts)
        if lse:
            return fa.run_lse(old_lse, q, k, v, **opts)[0]
        return fa.run_fwd(old_fwd, q, k, v, **opts)

    differ = 0
    for seed, (label, B, H, KV, Sq, Sk, D, causal, window, cap, entry) in enumerate(SHAPES):
        if only and only not in label:
            continue
        opts = dict(causal=causal, window=window, softcap=cap)
        if entry == "lse":
            impls = {"this tree": lambda q, k, v: fa.flash_attention_lse_cuda(q, k, v, **opts)[0],
                     "old": lambda q, k, v: old_entry(q, k, v, lse=True, **opts)}
        else:
            impls = {"this tree": lambda q, k, v: fa.flash_attention_cuda(q, k, v, **opts),
                     "old": lambda q, k, v: old_entry(q, k, v, **opts)}
        q = cs.model_layout(torch, B, H, Sq, D, "bfloat16", 900 + 10 * seed, dev)
        if Sq > 1:
            sets = [tuple(cs.model_layout(torch, B, KV, Sk, D, "bfloat16", 901 + 10 * seed + i, dev)
                          for i in (1, 2))]
        else:
            sets = cs.decode_sets(torch, B, KV, Sk, D, 901 + 10 * seed, dev, s_alloc=Sk)
        outs = {name: fn(q, *sets[0]) for name, fn in impls.items()}
        same = torch.equal(outs["this tree"], outs["old"])
        diff = float((outs["this tree"].float() - outs["old"].float()).abs().max())
        if must_match(D, q.dtype):
            differ += not same
        else:
            differ += not agrees(label, outs["this tree"], outs["old"], q, *sets[0], opts)
        n, calls = len(sets), 5 if D == 256 else 20
        t, by = cs.bound_ms(torch, q, *sets[0], causal=causal, window=window, dev=dev)
        lib_name = "sdpa"
        if Sq > 1:
            lib = lambda i: F.scaled_dot_product_attention(  # noqa: E731
                q, *sets[0], is_causal=causal, enable_gqa=H != KV)
        elif entry == "lse":   # the same (o, lse), K/V given repeated to the query heads
            lib_name = "efficient attention with its lse"
            lib_kv = [(a.repeat_interleave(H // KV, 1), b.repeat_interleave(H // KV, 1))
                      for a, b in sets] if H != KV else sets
            lib = lambda i: torch.ops.aten._scaled_dot_product_efficient_attention(  # noqa: E731
                q, *lib_kv[i % n], None, True)
        else:
            lib = lambda i: F.scaled_dot_product_attention(  # noqa: E731
                q, *sets[i % n], enable_gqa=H != KV)
        fns = {name: (lambda i, fn=fn: fn(q, *sets[i % n])) for name, fn in impls.items()}
        fns[lib_name] = lib
        # in turns: a decode call beside the library call too, a prefill's
        # library call after them
        order = ("this tree", "old", lib_name, lib_name, "old", "this tree") if Sq == 1 else \
            ("this tree", "old", "old", "this tree", lib_name)
        times = {}
        for name in order:
            ms = cs.graph_ms(torch, [lambda i=i, fn=fns[name]: fn(i)
                                     for i in range(calls if Sq > 1 else 8 * n)])
            times.setdefault(name, []).append(ms)
        eager = ", ".join(f"{name} {cs.time_ms(torch, lambda: impls[name](q, *sets[0]), iters=calls):.4f}"
                          for name in ("this tree", "old")) if Sq > 1 else ""
        splits, chunk = fa._split_plan(q, sets[0][0])
        plan = f"keys split {splits} ways of {chunk}" if splits > 1 else "unsplit"
        bound = (f"; bound {t:.4f} ms ({by})"
                 + (" (sdpa without window and softcap: not the same function)"
                    if window or cap else ""))
        times = ", ".join(f"{name} " + "-".join(f"{x:.4f}" for x in sorted(set(v)))
                          for name, v in times.items())
        print(f"{label} ({B},{H},{Sq},{D}) kv {KV} Sk {Sk}{' causal' if causal else ''}"
              f"{f' window {window}' if window else ''} ({entry}, {plan}): outputs bitwise "
              f"equal {same} (max abs difference {diff:.3e}){bound}; ms " + times
              + (f" (launched one by one: {eager})" if eager else ""))
        del q, sets, outs
        torch.cuda.empty_cache()
    if not only:
        differ += bitwise_cases({"this tree": fa.flash_attention_cuda, "old": old_entry}, dev)
    return 1 if differ else 0


# The backward's train shapes below D 256 (all causal, bf16, in the model's
# layout): label, B, H, KV, S, D.
BWD_TRAIN_SHAPES = [
    ("stablelm", 8, 32, 32, 512, 80),
    ("zamba2", 8, 32, 32, 512, 64),
    ("phi35", 8, 32, 8, 512, 128),
    ("qwen2_vl", 8, 28, 4, 512, 128),
    ("yi", 8, 56, 8, 512, 128),
    ("musicgen", 8, 24, 24, 512, 64),
]


def sdpa_bwd_graph_ms(q, k, v, dout, calls: int) -> tuple[float, str]:
    """SDPA's backward (causal, GQA where H != KV) at one shape: device ms a
    call of ``calls`` captured in one CUDA graph (its forward run on the
    capture stream, so the backward's kernels land in the capture), or,
    where capture fails, back-to-back eager calls by CUDA events; with
    which of the two it was."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        x = [t.detach().requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*x, is_causal=True, enable_gqa=q.shape[1] != k.shape[1])
        grad = lambda: torch.autograd.grad(out, x, dout, retain_graph=True)  # noqa: E731
        for _ in range(3):
            grad()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(calls):
                grad()
        graph.replay()
        torch.cuda.synchronize()
        samples = []
        for _ in range(5):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) / calls)
        return sorted(samples)[2], "graph"
    except RuntimeError as err:   # a backend that cannot be captured: time it eagerly
        torch.cuda.synchronize()
        return cs.time_ms(torch, grad, iters=calls), f"eager ({str(err).splitlines()[0][:60]})"


def must_match_bwd(D: int, dtype: str) -> bool:
    """Whether this tree's backward must give the old kernel's bits: every
    fp32 call and every D 256 call (the bf16 backward below D 256 was
    redesigned: it is held against the plain version instead)."""
    return D == 256 or dtype == "float32"


def backward_ab(old_src: Path, dev) -> int:
    """The backward over chip_smoke's cases and edges at every head dim,
    then the six train shapes below D 256, the fp32 train shape and
    gemma2's two D 256 train shapes, in turns; 1 if an fp32 or D 256
    output differs from the old kernel's, or a bf16 output below D 256
    misses GRAD_TOL against autograd of attention_ref in fp32."""
    old_fn = fa.bind_bwd(_build.load_source(old_src, "flash_attention_bwd_old"))
    impls = {"this tree": lambda *t, **o: fa.flash_attention_bwd_cuda(*t, **o),
             "old": lambda *t, **o: fa.run_bwd(old_fn, *t, **o)}
    cases = ([(label, B, H, KV, Sq, Sk, causal, window, softcap, 1.0)
              for label, B, H, KV, Sq, Sk, causal, window, softcap in cs.ATTN_BWD_CASES]
             + [(label, B, H, KV, Sq, Sk, causal, 0, 0.0, scale)
                for label, B, H, KV, Sq, Sk, causal, scale in cs.ATTN_BWD_EDGES])
    differ = 0
    tol = cs.GRAD_TOL["bfloat16"]
    for D in fa.SUPPORTED_D:
        for dtype in ("float32", "bfloat16"):
            same = worst = 0
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
                equal = all(torch.equal(a, b) for a, b in zip(got["this tree"], got["old"]))
                same += equal
                if must_match_bwd(D, dtype):
                    if not equal:
                        differ += 1
                        print(f"D {D} {dtype} {label}: dq, dk, dv NOT bitwise equal")
                    continue
                x = [t.detach().float().requires_grad_() for t in (q, k, v)]
                want = torch.autograd.grad(ref.attention_ref(*x, **opts), x, dout.float())
                errs = [float((g.float() - w).abs().max()) for g, w in zip(got["this tree"], want)]
                worst = max(worst, *errs)
                if not all(torch.allclose(g.float(), w, **tol) for g, w in zip(got["this tree"], want)):
                    differ += 1
                    print(f"D {D} {dtype} {label}: NOT within {tol} of autograd of attention_ref "
                          f"(max abs err dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e})")
            rule = ("bitwise required" if must_match_bwd(D, dtype)
                    else f"within 2e-2 of autograd of attention_ref, worst max abs err {worst:.3e}")
            print(f"D {D} {dtype}: dq, dk, dv bitwise equal to the old kernel's in {same} of "
                  f"{len(cases)} cases ({rule})")

    card = torch.cuda.get_device_name(0)
    for label, B, H, KV, S, D in BWD_TRAIN_SHAPES:
        q, dout = (cs.model_layout(torch, B, H, S, D, "bfloat16", 900 + n, dev) for n in (0, 3))
        k, v = (cs.model_layout(torch, B, KV, S, D, "bfloat16", 900 + n, dev) for n in (1, 2))
        opts = dict(causal=True, window=0, softcap=0.0)
        out = fa.flash_attention_cuda(q, k, v, **opts)
        got = {name: fn(q, k, v, out, dout, **opts) for name, fn in impls.items()}
        diffs = [float((a.float() - b.float()).abs().max())
                 for a, b in zip(got["this tree"], got["old"])]
        x = [t.detach().float().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(ref.attention_ref(*x, **opts), x, dout.float())
        ok = all(torch.allclose(g.float(), w, **tol) for g, w in zip(got["this tree"], want))
        differ += not ok
        del got, x, want
        times = []
        for name in ("this tree", "old", "old", "this tree"):
            fn = impls[name]
            ms = cs.graph_ms(torch, [lambda: fn(q, k, v, out, dout, **opts)] * 10)
            times.append(f"{name} {ms:.4f}")
        sdpa, how = sdpa_bwd_graph_ms(q, k, v, dout, 10)
        x = [t.detach().requires_grad_() for t in (q, k, v)]
        ref_out = ref.attention_ref(*x, **opts)
        plain = cs.time_ms(torch, lambda: torch.autograd.grad(ref_out, x, dout, retain_graph=True),
                           iters=5, reps=3)
        del x, ref_out
        bound, by = cs.attention_bwd_bound_ms(torch, q, k, causal=True, window=0, dev=dev)
        new = min(float(t.split()[-1]) for t in (times[0], times[3]))
        pairs = B * H * cs.admitted_pairs(torch, S, S, causal=True, window=0, dev=dev)
        peak = cs.PEAK_FLOPS["bfloat16"]
        share = 10 * D * pairs / (new * 1e-3) / peak   # the five products the function needs
        issued = 24 * D * pairs / (new * 1e-3) / peak  # the twelve the kernel issues
        print(f"train {label} ({B},{H},{S},{D}) kv {KV} causal bf16 on {card}: ms "
              + ", ".join(times) + f"; sdpa backward {sdpa:.4f} ({how}); plain {plain:.4f} (autograd "
              f"of attention_ref, eager); bound {bound * 1e3:.2f} us "
              f"({by}); the best new call at {share:.1%} of the bf16 peak (five products), "
              f"{issued:.1%} issued (twelve), {new / sdpa:.2f}x sdpa; within 2e-2 of autograd of "
              f"attention_ref: {ok}; max abs difference from the old kernel dq {diffs[0]:.3e} "
              f"dk {diffs[1]:.3e} dv {diffs[2]:.3e}")
        del q, k, v, dout, out
        torch.cuda.empty_cache()

    H, D = 32, 80
    q, k, v, dout = (cs.model_layout(torch, cs.BATCH, H, cs.TRAIN_SEQ, D, "float32", 900 + n, dev)
                     for n in range(4))
    opts = dict(causal=True, window=0, softcap=0.0)
    out = fa.flash_attention_cuda(q, k, v, **opts)
    got = {name: fn(q, k, v, out, dout, **opts) for name, fn in impls.items()}
    same = all(torch.equal(a, b) for a, b in zip(got["this tree"], got["old"]))
    differ += not same
    times = []
    for name in ("this tree", "old", "old", "this tree"):
        fn = impls[name]
        ms = cs.time_ms(torch, lambda: fn(q, k, v, out, dout, **opts), iters=10)
        times.append(f"{name} {ms:.4f}")
    print(f"train ({cs.BATCH},{H},{cs.TRAIN_SEQ},{D}) causal float32: outputs bitwise equal "
          f"{same}; ms " + ", ".join(times))
    del q, k, v, dout, out, got

    # gemma2's train shapes, bf16: the D 256 path, beside the old source's
    H, KV, D, S = 16, 8, 256, cs.GEMMA2_TRAIN_SEQ
    for label, window, seed in (("global", 0, 1300), ("local", 4096, 1310)):
        q, dout = (cs.model_layout(torch, 1, H, S, D, "bfloat16", seed + n, dev) for n in (0, 3))
        k, v = (cs.model_layout(torch, 1, KV, S, D, "bfloat16", seed + n, dev) for n in (1, 2))
        opts = dict(causal=True, window=window, softcap=50.0)
        out = fa.flash_attention_cuda(q, k, v, **opts)
        got = {name: fn(q, k, v, out, dout, **opts) for name, fn in impls.items()}
        same = all(torch.equal(a, b) for a, b in zip(got["this tree"], got["old"]))
        differ += not same
        del got
        times = []
        for name in ("this tree", "old", "old", "this tree"):
            fn = impls[name]
            ms = cs.time_ms(torch, lambda: fn(q, k, v, out, dout, **opts), iters=5, reps=3)
            times.append(f"{name} {ms:.4f}")
        bound = cs.attention_bwd_bound_ms(torch, q, k, causal=True, window=window, dev=dev)
        print(f"gemma2 train {label} (1,{H},{S},{D}) kv {KV} causal"
              f"{f' window {window}' if window else ''} softcap 50 bf16: outputs bitwise equal "
              f"{same}; bound {bound[0]:.4f} ms ({bound[1]}); ms " + ", ".join(times))
        del q, k, v, dout, out
        torch.cuda.empty_cache()
    return 1 if differ else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="another csrc/flash_attention.cu (or, with --bwd, "
                         "csrc/flash_attention_bwd.cu) to measure beside")
    ap.add_argument("--bwd", action="store_true", help="the backward instead of the forward")
    ap.add_argument("--only", help="forward: only the shapes whose label holds this text "
                                   "(e.g. 'gemma2 prefill'), without the bitwise cases")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    if args.bwd:
        return backward_ab(args.old, torch.device("cuda"))
    return forward_ab(args.old, torch.device("cuda"), args.only)


if __name__ == "__main__":
    sys.exit(main())
