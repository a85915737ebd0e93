#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); builds the kernels
from the checkout's sources itself.  Phases, each of which fails the run:

1. build   — compile ``src/repro_torch/kernels/csrc/{flash_attention,
             flash_attention_bwd,ssd,mlstm}.cu`` for sm_90a, one ``nvcc`` per
             source, all four started together;
2. kernels — every kernel against its plain PyTorch version on the card
             (the cases of ``tests/test_kernels.py``, in fp32 (the scalar
             kernels) and bf16 (the tensor-core kernels), and the serve
             paths' shapes), then timed at the serve paths' shapes beside
             the plain version, one library call where there is one, and
             the card's bound; attention decode is timed with a cold L2;
             the attention backward's dq, dk, dv against autograd of the
             plain attention in fp32 (every head dim, both dtypes, causal,
             window, softcap, GQA, ragged and Sq != Sk; then, at D 80 and
             128, the edges of its tiles, GQA 8 and q, k scaled by 4), then
             timed at stablelm_3b's train shape beside SDPA's backward, two
             bf16 calls there bitwise equal;
3. serve stablelm_3b — at full size, seed-initialised on the card:
             batch 8, prompt 512, 64 greedy tokens in bf16 through
             ``repro_torch.launch.serve``; the attention kernel must have
             run on every layer of the prefill and of every decode step,
             every logit must be finite, and in fp32 the prefill's last
             logits must match the same prefill with the plain attention
             (the bf16 gap is printed beside it);
4. serve zamba2_1p2b — the hybrid Mamba2 model at full size, the same
             batch, prompt and tokens: the SSD kernel must have run once
             per Mamba2 layer (the prefill; decode steps are plain
             PyTorch) and the attention kernel once per shared-block
             application in the prefill and every decode step; in fp32
             the prefill's last logits, and 4 decode steps after it (which
             read the prefill's final SSM states), must match the same
             with both kernels swapped for their plain versions;
5. serve xlstm_125m — the xLSTM model (6 mLSTM + 6 sLSTM blocks) at full
             size, the same batch, prompt and tokens: the mLSTM kernel must
             have run once per mLSTM layer (the prefill; decode steps are
             plain PyTorch) and no other kernel at all; in fp32 the
             prefill's last logits and 4 decode steps after it (which read
             the prefill's final mLSTM and sLSTM states) must match the
             same with the kernels swapped for their plain versions; the
             bf16 gap to the plain versions is printed after the first
             mLSTM block and at the last logits;
6. train stablelm_3b — full size, seed-initialised on the card, through
             ``repro_torch.launch.train``: fp32 master params, bf16
             compute, remat, batch 8 x seq 512, 4 AdamW steps of
             ``SyntheticTokens``; every loss and grad finite, 64 forward
             and 32 backward attention calls a step, no SSD or mLSTM
             launch; a profiled step must run the bf16 backward kernels
             and no scalar one; then, at full width and 4 layers in fp32,
             one step through the kernels against the same step with the
             plain attention: the loss, every grad leaf and the updated
             params (the bf16 gap is printed);
7. elastic stablelm_3b — the live elastic loop
             (``repro_torch.elastic.ElasticTrainer``) at full size on the
             ``steady-cycle`` trace, 25 steps over a pool of 4 slots, the
             engine carrying a ``PytreeBytesModel`` of the full model:
             expand 1->4 (hypercube), TS-shrink 4->1, twice; node counts
             per step, finite losses, 4 records equal to the port's
             simulator with the same engine, each stage 3's logged bytes
             equal to the charged ones and its total to the pytree's, 64
             forward and 32 backward attention calls a step, and a peak
             memory no higher than the train phase's.  The slots are
             logical and all lie on this one card: stage 3 records the
             params' new placement and moves no byte, and each record's
             ``est``/``downtime`` is the cost model's modelled cluster
             time, not a card time.  Then ``restart-vs-shrink``'s first 6
             steps at full width and 4 layers with a checkpoint
             directory: right after the RESTART (step 5) the params equal
             the step-4 snapshot on disk and the params held when it was
             saved, bitwise.

Prints the card's name and power limit, one JSON line of kernel numbers,
and last ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
result, on any failure, without a card, or without the port's sources.
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

# NVIDIA H100 SXM data sheet, for the least time the card could take.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SSD_TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=3e-2, atol=3e-2)}
MLSTM_TOL = {"float32": dict(rtol=2e-4, atol=2e-4), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
MLSTM_EXTREME_TOL = dict(rtol=5e-4, atol=5e-4)   # tests/test_kernels.py, gates of +-20
MODEL_TOL = dict(rtol=2e-3, atol=5e-4)   # tests/test_models.py, fp32
# A backward sums over S terms where the forward's 2e-5 sums over keys.
GRAD_TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
GRAD_REL_RMS = 1e-4     # a gradient leaf of the fp32 train gate, against the plain twin
KERNELS = ("flash_attention", "flash_attention_bwd", "ssd", "mlstm")
# The attention backward's two paths, chosen by dtype alone.
BWD_PATHS = {
    "bfloat16": {"route": "tensor cores (mma.sync bf16)",
                 "kernels": ["attn_bwd_dq_bf16", "attn_bwd_dkdv_bf16"]},
    "float32": {"route": "scalar fp32 FMA",
                "kernels": ["attn_bwd_prep", "attn_bwd_dkdv", "attn_bwd_dq"]},
}
L2_BYTES = 50 * 2**20   # H100 L2; decode timings rotate over more K/V than this
# The bf16 prefill gaps to the plain twins that the scalar kernels gave
# (chip_smoke.py on an H100 80GB HBM3 at 700 W), printed beside today's.
EARLIER_BF16_GAP = {"stablelm_3b": "3.906e-02", "zamba2_1p2b": "8.6e-02"}

ARCH, BATCH, PROMPT, GEN = "stablelm_3b", 8, 512, 64
TRAIN_STEPS, TRAIN_SEQ, GATE_LAYERS = 4, 512, 4
ELASTIC_SCENARIO, ELASTIC_STEPS = "steady-cycle", 25
RESTART_STEP = 5        # restart-vs-shrink's RESTART, read back from step 4's snapshot
HYBRID = "zamba2_1p2b"
XLSTM = "xlstm_125m"


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device")
    if not (SRC / "repro_torch").is_dir():
        return fail(f"the port's sources are not at {SRC / 'repro_torch'}")
    sys.path.insert(0, str(SRC))
    from repro_torch.device import card_label

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = card_label(dev)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    t_start = time.perf_counter()
    failures: list[str] = []
    build_phase(torch)
    entry = kernel_phase(torch, dev, failures)
    ssd_entry = ssd_kernel_phase(torch, dev, failures)
    mlstm_entry = mlstm_kernel_phase(torch, dev, failures)
    bwd_entry = attention_bwd_phase(torch, dev, failures)
    if failures:
        return fail("; ".join(failures))
    counts: dict[str, dict[str, int]] = {}   # serve path -> kernel -> launches
    serve_phase(torch, dev, entry, failures, counts)
    if failures:
        return fail("; ".join(failures))
    torch.cuda.empty_cache()
    hybrid_phase(torch, dev, entry, ssd_entry, failures, counts)
    if failures:
        return fail("; ".join(failures))
    torch.cuda.empty_cache()
    xlstm_phase(torch, dev, mlstm_entry, failures, counts)
    if failures:
        return fail("; ".join(failures))
    torch.cuda.empty_cache()
    train_peak = train_phase(torch, dev, entry, bwd_entry, failures, counts)
    if failures:
        return fail("; ".join(failures))
    torch.cuda.empty_cache()
    elastic_phase(torch, dev, train_peak, failures, counts)
    if failures:
        return fail("; ".join(failures))
    kernels = [entry, bwd_entry, ssd_entry, mlstm_entry]
    for e in kernels:
        e["launches_by_path"] = {path: c[e["name"]] for path, c in counts.items()}
        e["launches"] = sum(e["launches_by_path"].values())

    print(f"[smoke] all phases passed in {time.perf_counter() - t_start:.1f}s")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


# ----------------------------------------------------------------- kernels --


def randn(torch, shape, dtype, seed, dev, scale=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * scale).to(getattr(torch, dtype))


def model_layout(torch, B, H, S, D, dtype, seed, dev, s_alloc=None):
    """(B,H,S,D) view of a (B,S_alloc,H,D) tensor, as the model passes its
    activations and cache slices to the kernel."""
    t = randn(torch, (B, s_alloc or S, H, D), dtype, seed, dev)
    return t[:, :S].transpose(1, 2)


def time_ms(torch, fn, iters=20, reps=5) -> float:
    """Median over ``reps`` of the mean time of ``iters`` back-to-back calls,
    by CUDA events, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def admitted_pairs(torch, Sq, Sk, *, causal, window, dev) -> int:
    """(query, key) pairs of one head that the causal / window masks admit."""
    qp = torch.arange(Sq, device=dev)[:, None]
    kp = torch.arange(Sk, device=dev)[None, :]
    mask = torch.ones(Sq, Sk, dtype=torch.bool, device=dev)
    if causal:
        mask &= kp <= qp
    if window > 0:
        mask &= kp > qp - window
    return int(mask.sum())


def bound_ms(torch, q, k, v, *, causal, window, dev) -> tuple[float, str]:
    """Larger of bytes / bandwidth (q, k, v read once, o written once) and
    operations / peak: 4 D flops per (query, key) pair the mask admits."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    flops = 4 * D * B * H * admitted_pairs(torch, Sq, Sk, causal=causal, window=window, dev=dev)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(q.dtype).removeprefix("torch.")] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_summary(log: str) -> dict[tuple[str, tuple[int, ...]], str]:
    """Registers and spills of each kernel in an ``nvcc -Xptxas=-v`` log, by
    the kernel's own name (the mangled name's first component after its
    anonymous namespace) and its integer template arguments, in the log's
    order."""
    out, kernel = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, args = m.group(1), ""
            ns = re.match(r"_ZN(\d+)", name)
            if ns:
                rest = name[ns.end() + int(ns.group(1)):]
                n = re.match(r"\d+", rest)
                if n:
                    name = rest[n.end():n.end() + int(n.group())]
                    args = rest[n.end() + int(n.group()):]
            kernel = (name, tuple(int(a) for a in re.findall(r"Li(\d+)E", args)))
            out[kernel] = ""
        elif kernel and ("spill" in line or "registers" in line):
            text = re.sub(r"^ptxas info\s*:\s*", "", line.strip())
            out[kernel] = f"{out[kernel]}{'; ' if out[kernel] else ''}{text}"
    return out


def build_phase(torch):
    """One nvcc per kernel source, all started together; prints each
    kernel's registers, spills and shared memory as ptxas reports them."""
    from repro_torch.kernels import _build

    def timed(name):
        t0 = time.perf_counter()
        log = _build.build(name)
        return log, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(KERNELS)) as pool:
        logs = dict(zip(KERNELS, pool.map(timed, KERNELS)))
    print(f"[build] {', '.join(KERNELS)} in parallel: {time.perf_counter() - t0:.1f}s")
    for name, (log, secs) in logs.items():
        print(f"[build] {name}: {secs:.1f}s{'' if log else ' (library already built)'}")
        summary = ptxas_summary(log)
        last = {kernel: props for (kernel, _), props in summary.items()}
        for kernel, props in last.items():
            print(f"[build] {name}: {kernel}: {props}")
        if name == "flash_attention_bwd":   # the train shape's head dim
            for (kernel, args), props in summary.items():
                if args[-1:] == (80,):
                    print(f"[build] {name}: {kernel} at D 80: {props}")
    from repro_torch.kernels import mlstm, ssd

    print(f"[build] ssd: dynamic shared memory a block at the serve shape (chunk 128, "
          f"N 64, P 64): {ssd.smem_bytes(128, 64, 64)} bytes (bf16, tensor cores), "
          f"{ssd.smem_bytes(128, 64, 64, torch.float32)} bytes (fp32, scalar)")
    print(f"[build] mlstm: dynamic shared memory a block at the serve shape (chunk 128, "
          f"D 384): bf16 {mlstm.w_smem_bytes(128, 384)} bytes (W, one block a (b, h, chunk)), "
          f"{mlstm.smem_bytes(128, 384)} bytes (the rest, {mlstm.value_cols(128, 384)} value "
          f"columns a block); fp32 {mlstm.smem_bytes(128, 384, torch.float32)} bytes (scalar, "
          f"{mlstm.value_cols(128, 384, torch.float32)} value columns a block)")


def kernel_phase(torch, dev, failures) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels import flash_attention as fa

    # kernel vs plain version on the card
    def compare(label, q, k, v, dtype, tol=None, *, causal, window=0, softcap=0.0,
                convex=False) -> float:
        out = fa.flash_attention_cuda(q, k, v, causal=causal, window=window, softcap=softcap)
        want = ref.attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
        torch.cuda.synchronize()
        err = float((out.float() - want.float()).abs().max())
        tol = tol or TOL[dtype]
        ok = bool(torch.isfinite(out).all()) and torch.allclose(
            out.float(), want.float(), **tol)
        if convex:
            ok = ok and float(out.abs().max()) <= float(v.abs().max()) + 1e-4
        print(f"[kernel] {label:<34} {dtype:<8} max_abs_err={err:.3e} "
              f"(rtol={tol['rtol']}, atol={tol['atol']}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"flash_attention {label} {dtype}: max_abs_err {err:.3e}")
        return err

    cases = [  # label, B, H, KV, Sq, Sk, D, causal, window
        ("mha", 1, 2, 2, 128, 128, 64, True, 0),
        ("gqa group 4", 2, 8, 2, 128, 128, 64, True, 0),
        ("mqa Sq!=Sk", 1, 4, 1, 64, 256, 32, False, 0),
        ("D 16 odd tiles", 2, 3, 3, 96, 96, 16, True, 0),
        ("D 80 causal Sq<Sk ragged", 2, 4, 2, 5, 37, 80, True, 0),
        ("D 80 window 20 masked rows", 1, 4, 4, 100, 77, 80, False, 20),
        ("D 128 gqa ragged", 1, 8, 2, 70, 70, 128, True, 0),
    ]
    for seed, (label, B, H, KV, Sq, Sk, D, causal, window) in enumerate(cases):
        for dtype in ("float32", "bfloat16"):
            q = randn(torch, (B, H, Sq, D), dtype, 3 * seed, dev)
            k = randn(torch, (B, KV, Sk, D), dtype, 3 * seed + 1, dev)
            v = randn(torch, (B, KV, Sk, D), dtype, 3 * seed + 2, dev)
            compare(label, q, k, v, dtype, causal=causal, window=window)
    for dtype in ("float32", "bfloat16"):
        for window in (16, 64, 128):
            q, k, v = (randn(torch, (1, 2, 128, 32), dtype, 100 + i, dev) for i in range(3))
            compare(f"window {window}", q, k, v, dtype, causal=True, window=window)
        q, k, v = (randn(torch, (1, 2, 64, 32), dtype, 110 + i, dev, 4.0 if i < 2 else 1.0)
                   for i in range(3))
        compare("softcap 20", q, k, v, dtype, dict(rtol=3e-5, atol=3e-5) if dtype == "float32"
                else None, causal=True, softcap=20.0)
        for seed, (log2s, group) in enumerate([(5, 1), (6, 2), (7, 4), (8, 2)]):
            S = 2 ** log2s
            q = randn(torch, (1, 2 * group, S, 32), dtype, 120 + 3 * seed, dev)
            k = randn(torch, (1, 2, S, 32), dtype, 121 + 3 * seed, dev)
            v = randn(torch, (1, 2, S, 32), dtype, 122 + 3 * seed, dev)
            compare(f"convex S {S} group {group}", q, k, v, dtype, causal=True, convex=True)
    # bf16 only: the tensor-core kernels' decode mode (Sq < 16) with GQA
    # group 4, every Sq from 1 to 15; and every head dim with ragged Sq != Sk
    # in prefill mode.
    dims = (16, 32, 64, 80, 128)
    for Sq in range(1, 16):
        D, Sk, causal = dims[Sq % 5], 40 * Sq + 17, Sq % 2 == 0
        q, k, v = (randn(torch, shape, "bfloat16", 130 + 3 * Sq + i, dev) for i, shape in
                   enumerate([(2, 8, Sq, D), (2, 2, Sk, D), (2, 2, Sk, D)]))
        compare(f"decode gqa 4 Sq {Sq} Sk {Sk} D {D}{' causal' if causal else ''}", q, k, v,
                "bfloat16", causal=causal)
    for i, D in enumerate(dims):
        for Sq, Sk, causal in ((37 + 31 * i, 100 + 23 * i, True), (150 - 9 * i, 61 + 7 * i, False)):
            q, k, v = (randn(torch, shape, "bfloat16", 180 + 10 * i + j, dev) for j, shape in
                       enumerate([(2, 4, Sq, D), (2, 2, Sk, D), (2, 2, Sk, D)]))
            compare(f"D {D} ragged Sq {Sq} Sk {Sk}{' causal' if causal else ''}", q, k, v,
                    "bfloat16", causal=causal)

    # The serve path's two shapes, in the model's strided layout.
    H, D, Sk_dec = 32, 80, PROMPT + GEN - 1
    pq = model_layout(torch, BATCH, H, PROMPT, D, "bfloat16", 200, dev)
    pk = model_layout(torch, BATCH, H, PROMPT, D, "bfloat16", 201, dev)
    pv = model_layout(torch, BATCH, H, PROMPT, D, "bfloat16", 202, dev)
    dq = model_layout(torch, BATCH, H, 1, D, "bfloat16", 203, dev)
    dkv = decode_sets(torch, BATCH, H, Sk_dec, D, 204, dev)
    err = max(compare("serve prefill (8,32,512,80) causal", pq, pk, pv, "bfloat16",
                      causal=True),
              compare(f"serve decode (8,32,1,80) Sk {Sk_dec}", dq, *dkv[0], "bfloat16",
                      causal=False))

    pre, dec = attention_timings(torch, pq, [(pk, pv)], True, dev), \
        attention_timings(torch, dq, dkv, False, dev)
    for label, t in (("prefill (8,32,512,80) causal bf16", pre),
                     (f"decode (8,32,1,80) Sk {Sk_dec} bf16", dec)):
        print_attention_time(label, t)
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:28",
        "launches": None,
        "max_abs_err": err,
        "shape": "prefill (8,32,512,80) causal bf16",
        **pre,
        "decode": {"shape": f"decode (8,32,1,80) Sk {Sk_dec} bf16", **dec},
    }


def decode_sets(torch, B, H, Sk, D, seed, dev) -> list:
    """Distinct (k, v) caches in the model's layout, enough of them that
    together they exceed the L2: a decode step reads each layer's cache
    cold, and a timing on one set would read it from the L2."""
    one = 2 * B * H * Sk * D * 2
    n = L2_BYTES // one + 2
    return [(model_layout(torch, B, H, Sk, D, "bfloat16", seed + 2 * i, dev, PROMPT + GEN),
             model_layout(torch, B, H, Sk, D, "bfloat16", seed + 2 * i + 1, dev, PROMPT + GEN))
            for i in range(n)]


def graph_ms(torch, fns, reps=5) -> float:
    """Device time per call: ``fns`` captured in order in one CUDA graph and
    replayed, so no host time sits between the launches.  Median of
    ``reps`` replays, by CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / len(fns))
    return statistics.median(samples)


def attention_timings(torch, q, kv_sets, causal, dev) -> dict:
    """Kernel, plain version and one library call at one shape, and the
    bound.  With more than one (k, v) set (decode), each timed call reads
    the next set, so every call finds its K/V outside the L2; the kernel
    and SDPA are then timed as a CUDA graph of such calls (``ms``,
    ``library_ms``), which leaves out the host's launch time: at ~20 us a
    call that is as long as the kernel's.  The calls launched one by one
    are kept as ``eager_ms`` and ``library_eager_ms``."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    n = len(kv_sets)
    kern = lambda i: fa.flash_attention_cuda(q, *kv_sets[i % n], causal=causal)   # noqa: E731
    sdpa = lambda i: F.scaled_dot_product_attention(q, *kv_sets[i % n], is_causal=causal)  # noqa: E731

    def rotating(fn):
        it = iter(range(10**9))
        return lambda: fn(next(it))

    iters = 20 if n == 1 else 8 * n
    t = {
        "ms": time_ms(torch, rotating(kern), iters=iters),
        "plain_ms": time_ms(torch, rotating(lambda i: ref.attention_ref(
            q, *kv_sets[i % n], causal=causal)), iters=iters),
        "library_ms": time_ms(torch, rotating(sdpa), iters=iters),
    }
    if n > 1:
        t["eager_ms"], t["library_eager_ms"] = t["ms"], t["library_ms"]
        t["ms"] = graph_ms(torch, [lambda i=i: kern(i) for i in range(iters)])
        t["library_ms"] = graph_ms(torch, [lambda i=i: sdpa(i) for i in range(iters)])
    t["bound_ms"], t["bound_by"] = bound_ms(torch, q, *kv_sets[0], causal=causal, window=0,
                                            dev=dev)
    return t


def print_attention_time(label, t):
    if "eager_ms" in t:
        print(f"[time] flash_attention {label}, cold L2 (each call reads the next of "
              f"several K/V sets that together exceed the 50 MB L2): kernel "
              f"{t['ms']:.4f} ms, sdpa {t['library_ms']:.4f} ms as a CUDA graph of such calls "
              f"(device time); launched one by one kernel {t['eager_ms']:.4f} ms, sdpa "
              f"{t['library_eager_ms']:.4f} ms; plain {t['plain_ms']:.4f} ms; bound "
              f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']})")
        return
    print(f"[time] flash_attention {label}: kernel {t['ms']:.4f} ms, plain "
          f"{t['plain_ms']:.4f} ms, sdpa {t['library_ms']:.4f} ms, bound "
          f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']})")


# ------------------------------------------------------- attention backward --


def attention_bwd_bound_ms(torch, q, k, *, causal, window, dev) -> tuple[float, str]:
    """Larger of bytes / bandwidth (q, k, v, o, dO read once; dq, dk, dv
    written once) and operations / peak: five products of 2 D flops each
    (q k^T, dO v^T, P^T dO, dS^T q, dS k) per (query, key) pair the mask
    admits."""
    B, H, Sq, D = q.shape
    nbytes = 4 * (q.numel() + k.numel()) * q.element_size()
    flops = 10 * D * B * H * admitted_pairs(torch, Sq, k.shape[2], causal=causal, window=window,
                                            dev=dev)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(q.dtype).removeprefix("torch.")] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_bwd_phase(torch, dev, failures) -> dict:
    """The backward kernel's dq, dk, dv against autograd of attention_ref in
    fp32 on the same inputs, then timed at stablelm_3b's train shape."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    def compare(label, q, k, v, dout, dtype, *, causal, window=0, softcap=0.0,
                deterministic=False) -> float:
        opts = dict(causal=causal, window=window, softcap=softcap)
        out = fa.flash_attention_cuda(q, k, v, **opts)
        got = fa.flash_attention_bwd_cuda(q, k, v, out, dout, **opts)
        if deterministic:   # no atomics: a second call gives the same bits
            again = fa.flash_attention_bwd_cuda(q, k, v, out, dout, **opts)
            same = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
            print(f"[kernel] flash_attention_bwd {label} {dtype}: two calls bitwise equal "
                  f"(dq, dk, dv): {same}")
            if not same:
                failures.append(f"flash_attention_bwd {label} {dtype}: two calls differ")
        ref_in = [t.detach().float().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(ref.attention_ref(*ref_in, **opts), ref_in, dout.float())
        torch.cuda.synchronize()
        tol = GRAD_TOL[dtype]
        errs = [float((g.float() - w).abs().max()) for g, w in zip(got, want)]
        ok = all(bool(torch.isfinite(g).all()) and g.dtype == t.dtype and g.shape == t.shape
                 and torch.allclose(g.float(), w, **tol) for g, w, t in zip(got, want, (q, k, v)))
        print(f"[kernel] flash_attention_bwd {label:<42} {dtype:<8} max_abs_err dq {errs[0]:.3e} "
              f"dk {errs[1]:.3e} dv {errs[2]:.3e} (rtol={tol['rtol']}, atol={tol['atol']}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"flash_attention_bwd {label} {dtype}: max_abs_err {max(errs):.3e}")
        return max(errs)

    cases = [  # label, B, H, KV, Sq, Sk, causal, window, softcap
        ("causal", 2, 4, 4, 64, 64, True, 0, 0.0),
        ("gqa 4 ragged S 100 window 16", 1, 8, 2, 100, 100, True, 16, 0.0),
        ("mqa Sq 37 != Sk 70 softcap 50", 1, 4, 1, 37, 70, False, 0, 50.0),
        ("non-causal gqa 2 S 100 window 32", 1, 4, 2, 100, 100, False, 32, 0.0),
        ("causal window 32 softcap 50", 1, 4, 2, 100, 100, True, 32, 50.0),
        ("window 20 masked rows Sq 100 Sk 77", 1, 4, 4, 100, 77, False, 20, 0.0),
    ]
    for i, D in enumerate((16, 32, 64, 80, 128)):
        for j, (label, B, H, KV, Sq, Sk, causal, window, softcap) in enumerate(cases):
            for dtype in ("float32", "bfloat16"):
                seed = 800 + 40 * i + 4 * j
                q = randn(torch, (B, H, Sq, D), dtype, seed, dev)
                k, v = (randn(torch, (B, KV, Sk, D), dtype, seed + n, dev) for n in (1, 2))
                dout = randn(torch, (B, H, Sq, D), dtype, seed + 3, dev)
                compare(f"D {D} {label}", q, k, v, dout, dtype, causal=causal, window=window,
                        softcap=softcap)
    # The edges of the bf16 kernels' 64-row / 64-key tiles (32 query rows at
    # D 128 in the dK / dV launch) and of the scalar kernels' 32; GQA 8; and
    # q, k scaled by 4 (a peaked softmax, where dS cancels most).
    edges = [  # label, B, H, KV, Sq, Sk, causal, q / k scale
        ("edge S 63", 1, 4, 4, 63, 63, True, 1.0),
        ("edge S 65", 1, 4, 4, 65, 65, True, 1.0),
        ("edge gqa 2 S 127", 1, 4, 2, 127, 127, True, 1.0),
        ("edge gqa 2 S 129", 1, 4, 2, 129, 129, True, 1.0),
        ("edge non-causal Sq 1 Sk 300", 1, 4, 4, 1, 300, False, 1.0),
        ("edge non-causal Sq 17 Sk 300", 1, 4, 4, 17, 300, False, 1.0),
        ("gqa 8 S 129", 1, 8, 1, 129, 129, True, 1.0),
        ("large logits (q, k x 4) gqa 4 S 129", 1, 8, 2, 129, 129, True, 4.0),
    ]
    for i, D in enumerate((80, 128)):
        for j, (label, B, H, KV, Sq, Sk, causal, scale) in enumerate(edges):
            for dtype in ("float32", "bfloat16"):
                seed = 1100 + 40 * i + 4 * j
                q = randn(torch, (B, H, Sq, D), "float32", seed, dev, scale).to(
                    getattr(torch, dtype))
                k = randn(torch, (B, KV, Sk, D), "float32", seed + 1, dev, scale).to(q.dtype)
                v = randn(torch, (B, KV, Sk, D), dtype, seed + 2, dev)
                dout = randn(torch, (B, H, Sq, D), dtype, seed + 3, dev)
                compare(f"D {D} {label}", q, k, v, dout, dtype, causal=causal)
                if scale != 1.0:
                    exact_error_ratios(torch, f"D {D} {label}", q, k, v, dout, dtype,
                                       causal=causal)

    # The train path's shape, in the model's strided layout, in both dtypes.
    H, D = 32, 80
    shape = f"train ({BATCH},{H},{TRAIN_SEQ},{D}) causal"
    entry = {"name": "flash_attention_bwd", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
             "replaces": "src/repro/models/layers.py:204 (no Pallas backward: the JAX package "
                         "differentiates this jnp attention, src/repro/train/steps.py:75)",
             "launches": None, "paths": []}
    for dtype in ("bfloat16", "float32"):
        q, k, v, dout = (model_layout(torch, BATCH, H, TRAIN_SEQ, D, dtype, 900 + n, dev)
                         for n in range(4))
        err = compare(shape, q, k, v, dout, dtype, causal=True,
                      deterministic=dtype == "bfloat16")
        t = attention_bwd_timings(torch, q, k, v, dout, dev)
        path = BWD_PATHS[dtype]
        print(f"[time] flash_attention_bwd {shape} {dtype}: kernel {t['ms']:.4f} ms "
              f"({path['route']}: {' + '.join(path['kernels'])}), plain {t['plain_ms']:.4f} ms "
              f"(autograd of attention_ref, backward only), sdpa backward {t['library_ms']:.4f} "
              f"ms, bound {t['bound_ms'] * 1e3:.2f} us ({t['bound_by']})")
        entry["paths"].append({"dtype": dtype, **path, "shape": f"{shape} {dtype}",
                               "max_abs_err": err, **t})
        if dtype == "bfloat16":
            entry.update(max_abs_err=err, shape=f"{shape} bf16", **t)
    return entry


def exact_error_ratios(torch, label, q, k, v, dout, dtype, *, causal):
    """Information: the kernel's dq, dk, dv and autograd of attention_ref in
    fp32, each against the gradient in fp64 (the same function written in
    float64), as err / (atol + rtol |exact|) at GRAD_TOL: where the fp32
    reference's own error is a visible share of the tolerance."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    def attention_fp64(q, k, v):
        group = q.shape[1] // k.shape[1]
        kf, vf = (t.repeat_interleave(group, dim=1) for t in (k, v))
        s = torch.einsum("bhqd,bhkd->bhqk", q, kf) / math.sqrt(q.shape[-1])
        if causal:
            qp = torch.arange(q.shape[2], device=q.device)[:, None]
            s = s.masked_fill(torch.arange(k.shape[2], device=q.device)[None, :] > qp,
                              float("-inf"))
        return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), vf)

    tol = GRAD_TOL[dtype]
    out = fa.flash_attention_cuda(q, k, v, causal=causal)
    got = fa.flash_attention_bwd_cuda(q, k, v, out, dout, causal=causal)
    x64 = [t.detach().double().requires_grad_() for t in (q, k, v)]
    exact = torch.autograd.grad(attention_fp64(*x64), x64, dout.double())
    x32 = [t.detach().float().requires_grad_() for t in (q, k, v)]
    fp32 = torch.autograd.grad(ref.attention_ref(*x32, causal=causal), x32, dout.float())

    def ratios(grads):
        return " ".join(
            f"{float(((g.double() - e).abs() / (tol['atol'] + tol['rtol'] * e.abs())).max()):.3f}"
            for g, e in zip(grads, exact))

    print(f"[kernel] flash_attention_bwd {label:<42} {dtype:<8} against the fp64 gradient, err / "
          f"tol (dq dk dv): kernel {ratios(got)}, fp32 autograd of attention_ref "
          f"{ratios(fp32)} (information)")


def attention_bwd_timings(torch, q, k, v, dout, dev) -> dict:
    """The backward kernel, the plain version's backward (autograd of
    attention_ref, its graph built once) and SDPA's backward, at one shape,
    and the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    out = fa.flash_attention_cuda(q, k, v, causal=True)
    ref_in = [t.detach().requires_grad_() for t in (q, k, v)]
    ref_out = ref.attention_ref(*ref_in, causal=True)
    sdpa_in = [t.detach().requires_grad_() for t in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*sdpa_in, is_causal=True)
    t = {
        "ms": time_ms(torch, lambda: fa.flash_attention_bwd_cuda(q, k, v, out, dout, causal=True),
                      iters=10),
        "plain_ms": time_ms(torch, lambda: torch.autograd.grad(ref_out, ref_in, dout,
                                                               retain_graph=True),
                            iters=5, reps=3),
        "library_ms": time_ms(torch, lambda: torch.autograd.grad(sdpa_out, sdpa_in, dout,
                                                                 retain_graph=True), iters=10),
    }
    t["bound_ms"], t["bound_by"] = attention_bwd_bound_ms(torch, q, k, causal=True, window=0,
                                                          dev=dev)
    return t


# --------------------------------------------------------------------- ssd --


def ssd_inputs(torch, B, S, H, P, N, dtype, seed, dev, *, model_layout=False):
    """x, dt, A, B, C on the card: x/B/C in ``dtype``, dt post-softplus and
    A negative in fp32, as the model makes them.  ``model_layout``: x, B
    and C are slices of one (B,S,H*P+2N) tensor, as ``mamba2_block``
    passes them."""
    import torch.nn.functional as F

    if model_layout:
        xbc = randn(torch, (B, S, H * P + 2 * N), dtype, seed, dev)
        xs, Bm, Cm = torch.split(xbc, [H * P, N, N], dim=-1)
        x = xs.reshape(B, S, H, P)
    else:
        x = randn(torch, (B, S, H, P), dtype, seed, dev)
        Bm = randn(torch, (B, S, N), dtype, seed + 3, dev)
        Cm = randn(torch, (B, S, N), dtype, seed + 4, dev)
    dt = F.softplus(randn(torch, (B, S, H), "float32", seed + 1, dev))
    A = -torch.exp(randn(torch, (H,), "float32", seed + 2, dev, 0.5))
    return x, dt, A, Bm, Cm


def ssd_bound_ms(x, dt, A, Bm, Cm, chunk) -> tuple[float, str]:
    """Larger of bytes / bandwidth (x, dt, A, B, C read once; y and the fp32
    final state written once) and operations / peak: 2 Q (Q N + Q P + 2 N P)
    per (b, h, chunk)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    e = x.element_size()
    nbytes = (2 * x.numel() + Bm.numel() + Cm.numel()) * e + 4 * (dt.numel() + A.numel()
                                                                  + B * H * N * P)
    flops = 2 * chunk * (chunk * N + chunk * P + 2 * N * P) * B * H * -(-S // chunk)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(x.dtype).removeprefix("torch.")] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ssd_kernel_phase(torch, dev, failures) -> dict:
    from repro_torch.kernels import ref, ssd

    def check(label, got, want, tol) -> float:
        err = float((got.float() - want.float()).abs().max())
        ok = bool(torch.isfinite(got).all()) and torch.allclose(got.float(), want.float(), **tol)
        print(f"[kernel] ssd {label:<50} max_abs_err={err:.3e} (rtol={tol['rtol']}, "
              f"atol={tol['atol']:.3g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"ssd {label}: max_abs_err {err:.3e}")
        return err

    def compare(label, args, chunk, dtype, oracle=None) -> float:
        """y and the final state against ssd_chunked (or ``oracle``)."""
        y, st = ssd.ssd_scan_cuda(*args, chunk=chunk)
        want_y, want_st = oracle(*args) if oracle else ref.ssd_chunked(*args, chunk)
        torch.cuda.synchronize()
        return max(check(f"{label} y", y, want_y, SSD_TOL[dtype]),
                   check(f"{label} state", st, want_st, SSD_TOL[dtype]))

    cases = [(1, 64, 2, 16, 8, 16), (2, 128, 3, 16, 8, 32), (1, 128, 1, 32, 16, 64),
             (2, 96, 2, 8, 4, 32)]   # tests/test_kernels.py
    for seed, (B, S, H, P, N, chunk) in enumerate(cases):
        for dtype in ("float32", "bfloat16"):
            compare(f"({B},{S},{H},{P}) N {N} chunk {chunk} {dtype}",
                    ssd_inputs(torch, B, S, H, P, N, dtype, 300 + 10 * seed, dev), chunk, dtype)
    for dtype in ("float32", "bfloat16"):
        compare(f"ragged S 100 chunk 32 vs ssd_ref {dtype}",
                ssd_inputs(torch, 1, 100, 2, 16, 8, dtype, 350, dev), 32, dtype,
                oracle=ref.ssd_ref)
    # bf16: widths that the tensor-core kernel pads to its 16-wide tiles.
    for seed, (B, S, H, P, N, chunk) in enumerate([(1, 40, 2, 4, 4, 4), (2, 64, 3, 4, 4, 16),
                                                     (1, 48, 2, 8, 8, 4), (2, 64, 3, 8, 8, 16)]):
        compare(f"({B},{S},{H},{P}) N {N} chunk {chunk} bfloat16",
                ssd_inputs(torch, B, S, H, P, N, "bfloat16", 390 + 10 * seed, dev), chunk,
                "bfloat16")
    for dtype, tol in (("float32", dict(rtol=1e-3, atol=1e-3)), ("bfloat16", SSD_TOL["bfloat16"])):
        x, _, _, Bm, Cm = ssd_inputs(torch, 1, 32, 1, 8, 4, dtype, 360, dev)
        dt = torch.full((1, 32, 1), 0.5, device=dev)
        A = torch.full((1,), -50.0, device=dev)
        y, _ = ssd.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=8)
        local = (torch.einsum("bsn,bsn->bs", Cm.float(), Bm.float())[:, :, None, None] * 0.5
                 * x.float())
        check(f"decay A=-50: y ~ dt (C.B) x {dtype}", y, local, tol)

    # The serve path's shape, in the model's strided layout.
    shape = f"serve ({BATCH},{PROMPT},64,64) N 64 chunk 128 bf16"
    sargs = ssd_inputs(torch, BATCH, PROMPT, 64, 64, 64, "bfloat16", 370, dev, model_layout=True)
    err = compare(shape, sargs, 128, "bfloat16")

    t = {"ms": time_ms(torch, lambda: ssd.ssd_scan_cuda(*sargs, chunk=128)),
         "plain_ms": time_ms(torch, lambda: ref.ssd_chunked(*sargs, 128), iters=5, reps=3),
         "library_ms": None}
    t["bound_ms"], t["bound_by"] = ssd_bound_ms(*sargs, 128)
    print(f"[time] ssd {shape}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
          f"no single PyTorch call, bound {t['bound_ms'] * 1e3:.2f} us ({t['bound_by']})")
    return {
        "name": "ssd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd.py:24",
        "launches": None,
        "max_abs_err": err,
        "shape": shape,
        **t,
    }


# ------------------------------------------------------------------- mlstm --


def mlstm_inputs(torch, B, S, H, D, dtype, seed, dev, *, gate_scale=None, model_layout=False):
    """q, k, v, i_gate, f_gate on the card, all in ``dtype``: q/k/v unit
    normal, i ~ N(0,1), f ~ N(1,1) (tests/test_kernels.py), or both gates
    N(0, gate_scale^2).  ``model_layout``: the gates are the two halves of
    one (B,S,2H) tensor, as ``mlstm_block`` passes them."""
    q, k, v = (randn(torch, (B, S, H, D), dtype, seed + i, dev) for i in range(3))
    if model_layout:
        gates = randn(torch, (B, S, 2 * H), "float32", seed + 3, dev)
        gates[..., H:] += 1.0
        ig, fg = torch.split(gates.to(getattr(torch, dtype)), H, dim=-1)
        return q, k, v, ig, fg
    ig = randn(torch, (B, S, H), "float32", seed + 3, dev)
    fg = randn(torch, (B, S, H), "float32", seed + 4, dev)
    if gate_scale is None:
        fg = fg + 1.0
    else:
        ig, fg = ig * gate_scale, fg * gate_scale
    return q, k, v, ig.to(getattr(torch, dtype)), fg.to(getattr(torch, dtype))


def mlstm_bound_ms(q, chunk) -> tuple[float, str]:
    """Larger of bytes / bandwidth (q, k, v and both gates read once; h and
    the fp32 final S, n, m written once) and operations / peak:
    4 Q D (Q + D) per (b, h, chunk)."""
    B, S, H, D = q.shape
    e = q.element_size()
    nbytes = (4 * q.numel() + 2 * B * S * H) * e + 4 * B * H * (D * D + D + 1)
    flops = 4 * chunk * D * (chunk + D) * B * H * -(-S // chunk)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(q.dtype).removeprefix("torch.")] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mlstm_tc_flops(B, S, H, D, chunk) -> dict:
    """FLOP the bf16 kernels issue as mma at these sizes: q k^T on the
    16 x 16 tiles on or below the diagonal, once per (b, h, chunk); q S,
    the state update and W v, each twice (bf16 hi + lo of S, of cw k, of
    W).  Padded rows and columns (chunk and D rounded up to 16) count."""
    QP, DP = -(-chunk // 16) * 16, -(-D // 16) * 16
    tiles = (QP // 16) * (QP // 16 + 1) // 2
    n = B * H * -(-S // chunk)
    return {"q k^T": n * tiles * 2 * 256 * DP, "q S": n * 2 * 2 * QP * DP * DP,
            "update": n * 2 * 2 * QP * DP * DP, "W v": n * 2 * 2 * tiles * 256 * DP}


def mlstm_kernel_phase(torch, dev, failures) -> dict:
    from repro_torch.kernels import mlstm, ref

    def check(label, got, want, tol) -> float:
        err = float((got.float() - want.float()).abs().max())
        ok = bool(torch.isfinite(got).all()) and torch.allclose(got.float(), want.float(), **tol)
        print(f"[kernel] mlstm {label:<52} max_abs_err={err:.3e} (rtol={tol['rtol']}, "
              f"atol={tol['atol']:.3g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"mlstm {label}: max_abs_err {err:.3e}")
        return err

    def compare(label, args, chunk, tol, oracle=None) -> float:
        """h and the final (S, n, m) against mlstm_chunked (or ``oracle``)."""
        h, st = mlstm.mlstm_scan_cuda(*args, chunk=chunk)
        want_h, want_st = oracle(*args) if oracle else ref.mlstm_chunked(*args, chunk)
        torch.cuda.synchronize()
        return max([check(f"{label} h", h, want_h, tol)]
                   + [check(f"{label} {n}", got, want, tol)
                      for n, got, want in zip("Snm", st, want_st)])

    cases = [(1, 64, 2, 16, 16), (2, 128, 2, 16, 32), (1, 96, 1, 32, 32),
             (2, 64, 2, 8, 16)]   # tests/test_kernels.py
    for seed, (B, S, H, D, chunk) in enumerate(cases):
        for dtype in ("float32", "bfloat16"):
            compare(f"({B},{S},{H},{D}) chunk {chunk} {dtype}",
                    mlstm_inputs(torch, B, S, H, D, dtype, 500 + 10 * seed, dev), chunk,
                    MLSTM_TOL[dtype])
    for seed in range(3):
        compare(f"gates +-20 (1,32,1,8) chunk 8 #{seed} vs mlstm_ref",
                mlstm_inputs(torch, 1, 32, 1, 8, "float32", 550 + 10 * seed, dev,
                             gate_scale=20.0), 8, MLSTM_EXTREME_TOL, oracle=ref.mlstm_ref)
    compare("ragged S 100 chunk 32 vs mlstm_ref float32",
            mlstm_inputs(torch, 2, 100, 2, 16, "float32", 580, dev), 32,
            MLSTM_TOL["float32"], oracle=ref.mlstm_ref)
    compare("ragged S 200 D 384 chunk 128 vs mlstm_ref float32",
            mlstm_inputs(torch, 1, 200, 2, 384, "float32", 585, dev), 128,
            MLSTM_TOL["float32"], oracle=ref.mlstm_ref)
    compare("strided gates (2,64,4,32) chunk 16 bfloat16",
            mlstm_inputs(torch, 2, 64, 4, 32, "bfloat16", 590, dev, model_layout=True), 16,
            MLSTM_TOL["bfloat16"])
    # bf16 only, the tensor-core kernels (tests/test_torch_cuda.py): chunks
    # and head dims that do not fill 16-wide tiles, every value-column
    # width, ragged lengths (S 16 against chunk 128 is the serve warm-up's
    # shape) and gates of +-20, all against mlstm_chunked.
    for seed, (B, S, H, D, chunk) in enumerate([
            (2, 40, 2, 16, 4), (1, 48, 2, 16, 12), (2, 80, 2, 32, 20), (2, 64, 2, 24, 8),
            (2, 64, 2, 8, 8), (2, 48, 2, 12, 16), (1, 40, 2, 20, 8), (1, 96, 3, 64, 32),
            (1, 128, 2, 96, 64), (1, 256, 1, 512, 128)]):
        compare(f"({B},{S},{H},{D}) chunk {chunk} bfloat16",
                mlstm_inputs(torch, B, S, H, D, "bfloat16", 620 + 10 * seed, dev), chunk,
                MLSTM_TOL["bfloat16"])
    for seed, (S, chunk, D) in enumerate([(37, 16, 8), (37, 16, 32), (200, 128, 384),
                                          (16, 128, 384), (5, 8, 96)]):
        compare(f"ragged S {S} D {D} chunk {chunk} bfloat16",
                mlstm_inputs(torch, 2, S, 2, D, "bfloat16", 700 + 10 * seed, dev), chunk,
                MLSTM_TOL["bfloat16"])
    for seed in range(3):
        for D, S, chunk in ((8, 32, 8), (384, 256, 128)):
            compare(f"gates +-20 (1,{S},1,{D}) chunk {chunk} #{seed} bfloat16",
                    mlstm_inputs(torch, 1, S, 1, D, "bfloat16", 750 + 10 * seed, dev,
                                 gate_scale=20.0), chunk, MLSTM_TOL["bfloat16"])

    # The serve path's shape, in the model's layout.
    shape = f"serve ({BATCH},{PROMPT},4,384) chunk 128 bf16"
    sargs = mlstm_inputs(torch, BATCH, PROMPT, 4, 384, "bfloat16", 600, dev, model_layout=True)
    err = compare(shape, sargs, 128, MLSTM_TOL["bfloat16"])

    t = {"ms": time_ms(torch, lambda: mlstm.mlstm_scan_cuda(*sargs, chunk=128)),
         "plain_ms": time_ms(torch, lambda: ref.mlstm_chunked(*sargs, 128), iters=5, reps=3),
         "library_ms": None}
    t["bound_ms"], t["bound_by"] = mlstm_bound_ms(sargs[0], 128)
    t["graph_ms"] = graph_ms(torch, [lambda: mlstm.mlstm_scan_cuda(*sargs, chunk=128)] * 10)
    print(f"[time] mlstm {shape}: kernel {t['ms']:.4f} ms ({t['graph_ms']:.4f} ms a call in a "
          f"CUDA graph of 10), plain {t['plain_ms']:.4f} ms, no single PyTorch call, bound "
          f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']})")
    work = mlstm_tc_flops(BATCH, PROMPT, 4, 384, 128)
    total = sum(work.values())
    useful = 4 * 128 * 384 * (128 + 384) * BATCH * 4 * (PROMPT // 128)
    print(f"[time] mlstm: the bf16 kernels issue {total / 1e9:.2f} GFLOP of mma ("
          + ", ".join(f"{k} {v / 1e9:.2f}" for k, v in work.items())
          + f"; q k^T once per (b, h, chunk), the other three with hi + lo): "
          f"{total / t['ms'] / 1e9:.1f} TFLOP/s issued; the function's own {useful / 1e9:.2f} "
          f"GFLOP at {useful / t['ms'] / 1e9:.1f} TFLOP/s")
    return {
        "name": "mlstm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mlstm.cu",
        "replaces": "src/repro/kernels/mlstm.py:23",
        "launches": None,
        "max_abs_err": err,
        "shape": shape,
        **t,
    }


# ------------------------------------------------------------------- serve --


def reset_counts():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mlstm, ssd

    fa.launches = 0
    fa.bwd_launches = 0
    ssd.launches = 0
    mlstm.launches = 0


def read_counts() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mlstm, ssd

    return {"flash_attention": fa.launches, "flash_attention_bwd": fa.bwd_launches,
            "ssd": ssd.launches, "mlstm": mlstm.launches}


def serve_phase(torch, dev, entry, failures, counts):
    from repro_torch.launch import serve
    from repro_torch.models import Model

    t0 = time.perf_counter()
    model, params = serve.build_model(ARCH, full=True, device=dev, seed=0)
    torch.cuda.synchronize()
    cfg = model.cfg
    n_params = sum(p.numel() for p in params.values())
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads x {cfg.hd}, {n_params / 1e9:.3f} B params in "
          f"{cfg.dtype}, initialised in {time.perf_counter() - t0:.1f}s")
    prompts = serve.make_prompts(model, BATCH, PROMPT, seed=1)
    # Warm-up at a short prompt: CUDA loads each kernel module at its first
    # use, and cuBLAS sets itself up, so a cold first run times those too.
    cold = serve.generate(model, params, prompts[:, :16], 4)
    print(f"[serve] warm-up (prompt 16, 4 tokens): prefill {cold.prefill_s * 1e3:.1f} ms, "
          f"decode {cold.decode_s * 1e3:.1f} ms")

    reset_counts()
    res = serve.generate(model, params, prompts, GEN)
    counts[ARCH] = read_counts()
    launches = counts[ARCH]["flash_attention"]
    step_ms = res.decode_s / (GEN - 1) * 1e3
    print(f"[serve] prefill {BATCH}x{PROMPT} tokens: {res.prefill_s * 1e3:.1f} ms; decode "
          f"{res.decode_tok_s:.1f} tok/s ({GEN - 1} steps in {res.decode_s:.3f}s, "
          f"{step_ms:.2f} ms a step); peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB")
    print(f"[serve] attention kernel share: prefill {cfg.n_layers} x {entry['ms']:.4f} ms = "
          f"{cfg.n_layers * entry['ms'] / (res.prefill_s * 1e3):.1%}; decode at most "
          f"{cfg.n_layers} x {entry['decode']['ms']:.4f} ms = "
          f"{cfg.n_layers * entry['decode']['ms'] / step_ms:.1%} of a step")
    print(f"[serve] sample output ids: {res.generated[0, :12].tolist()}")
    want = cfg.n_layers * (1 + GEN - 1)
    print(f"[serve] flash_attention launches: {launches} (expected {want})")
    if launches != want:
        failures.append(f"flash_attention launched {launches} times, expected {want}")
    others = {k: v for k, v in counts[ARCH].items() if k != "flash_attention" and v}
    if others:
        failures.append(f"{ARCH} serve launched other kernels: {others}")
    if not res.finite:
        failures.append("non-finite logits in the serve run")

    # The gate: the same weights (bf16 values are exact in fp32) and prompts
    # in fp32, prefilled through the kernel and through the plain attention,
    # must agree to the model-level fp32 tolerance of tests/test_models.py.
    cfg32 = cfg.replace(dtype="float32", logit_dtype="float32")
    params32 = {k: v.float() for k, v in params.items()}
    model32 = Model(cfg32, dev)
    lk = last_logits(torch, model32, params32, prompts, failures)
    lp = last_logits(torch, model32, params32, prompts, failures, plain=True)
    gate(torch, "[serve] fp32 prefill last logits, kernel vs plain attention", lk, lp, failures)
    del params32, lk, lp

    # Information only: the served bf16 prefill against the same prefill
    # with the plain attention.  The two round attention outputs
    # differently by up to one bf16 ulp, and 32 layers of a bf16 residual
    # stream carry that into every logit, so this gap is rounding, not a
    # tolerance: the fp32 gate above holds the kernel.
    last = last_logits(torch, model, params, prompts, failures, plain=True)
    bf16_gap(torch, "[serve] bf16 prefill last logits, kernel vs plain attention",
             res.prefill_logits.float(), last, failures, EARLIER_BF16_GAP[ARCH])


def gate(torch, label, got, want, failures):
    """The fp32 model-level check of tests/test_models.py."""
    err = float((got - want).abs().max())
    ok = bool(torch.isfinite(got).all()) and torch.allclose(got, want, **MODEL_TOL)
    print(f"{label}: max_abs_err={err:.3e} (rtol={MODEL_TOL['rtol']}, "
          f"atol={MODEL_TOL['atol']}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{label}: max_abs_err {err:.3e}")


def bf16_gap(torch, label, got, want, failures, earlier=None, ids=True):
    """Printed as information; only non-finite values fail.  ``earlier``:
    the same gap with the scalar kernels, for comparison; ``ids``: the
    values are logits, so also the share of rows with the same greedy id."""
    err = float((got - want).abs().max())
    rel_rms = float((got - want).square().mean().sqrt() / want.square().mean().sqrt())
    same = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    print(f"{label} (information): max_abs_err={err:.3e}"
          f"{f' (scalar kernels: {earlier})' if earlier else ''} at max |value| "
          f"{float(want.abs().max()):.3f}, relative rms {rel_rms:.3e}"
          + (f", same greedy id in {same:.0%} of rows" if ids else ""))
    if not bool(torch.isfinite(want).all()):
        failures.append(f"{label}: non-finite logits in the plain run")


@contextlib.contextmanager
def plain_versions(failures):
    """Every kernel swapped for its plain version, in this run only: the
    port has no switch for it.  Fails the run if a kernel launches inside."""
    from unittest import mock

    from repro_torch.kernels import ops, ref

    def ssd_plain(x, dt, A, Bmat, Cmat, *, chunk):
        return ref.ssd_chunked(x, dt, A, Bmat, Cmat, chunk)

    def mlstm_plain(q, k, v, i_gate, f_gate, *, chunk):
        return ref.mlstm_chunked(q, k, v, i_gate, f_gate, chunk)

    before = read_counts()
    with mock.patch.object(ops, "flash_attention", ref.attention_ref), \
            mock.patch.object(ops, "ssd_scan", ssd_plain), \
            mock.patch.object(ops, "mlstm_scan", mlstm_plain):
        yield
    if read_counts() != before:
        failures.append("a run with the plain versions launched a kernel")


def last_logits(torch, model, params, prompts, failures, *, plain=False):
    """The prefill's last-position logits (B, V) in fp32, through the
    kernels or (``plain``) their plain versions."""
    with torch.inference_mode(), (plain_versions(failures) if plain
                                  else contextlib.nullcontext()):
        return model.forward(params, {"tokens": prompts})[0][:, -1].float()


def prefill_then_decode(torch, model, params, prompts, tokens, failures, *, plain=False):
    """One-pass prefill of ``prompts``, then one decode step per column of
    ``tokens``: (the prefill's last logits (B, V), the steps' logits
    (B, n, V)), in fp32, through the kernels or their plain versions."""
    B, P = prompts.shape
    n = tokens.shape[1]
    dev = prompts.device
    with torch.inference_mode(), (plain_versions(failures) if plain
                                  else contextlib.nullcontext()):
        cache = model.init_cache(B, P + n)
        pos = torch.arange(P, dtype=torch.int32, device=dev).expand(B, P)
        last = model.prefill(params, cache, {"tokens": prompts, "positions": pos})[:, -1].float()
        steps = []
        for i in range(n):
            lg, cache = model.decode_step(params, cache, {
                "tokens": tokens[:, i:i + 1], "cache_pos": P + i,
                "positions": torch.full((B, 1), P + i, dtype=torch.int32, device=dev)})
            steps.append(lg[:, -1].float())
    return last, torch.stack(steps, dim=1)


def hybrid_phase(torch, dev, fa_entry, ssd_entry, failures, counts):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.launch import serve
    from repro_torch.models import Model

    t0 = time.perf_counter()
    model, params = serve.build_model(HYBRID, full=True, device=dev, seed=0)
    torch.cuda.synchronize()
    cfg = model.cfg
    n_attn = cfg.n_layers // cfg.attn_every
    d_in = cfg.ssm_expand * cfg.d_model
    n_params = sum(p.numel() for p in params.values())
    print(f"[hybrid] {cfg.name}: {cfg.n_layers} Mamba2 layers, d_model {cfg.d_model}, "
          f"{d_in // cfg.ssm_head_dim} SSM heads x {cfg.ssm_head_dim}, state "
          f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}; one shared attention block "
          f"({cfg.n_heads} heads x {cfg.hd}, d_ff {cfg.d_ff}) applied {n_attn} times; "
          f"{n_params / 1e9:.3f} B params in {cfg.dtype}, initialised in "
          f"{time.perf_counter() - t0:.1f}s")
    prompts = serve.make_prompts(model, BATCH, PROMPT, seed=1)
    cold = serve.generate(model, params, prompts[:, :16], 4)   # 16: ragged against chunk 128
    print(f"[hybrid] warm-up (prompt 16, 4 tokens): prefill {cold.prefill_s * 1e3:.1f} ms, "
          f"decode {cold.decode_s * 1e3:.1f} ms, finite {cold.finite}")
    if not cold.finite:
        failures.append("non-finite logits in the hybrid warm-up run (prompt 16)")

    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    res = serve.generate(model, params, prompts, GEN)
    counts[HYBRID] = read_counts()
    step_ms = res.decode_s / (GEN - 1) * 1e3
    print(f"[hybrid] prefill {BATCH}x{PROMPT} tokens: {res.prefill_s * 1e3:.1f} ms; decode "
          f"{res.decode_tok_s:.1f} tok/s ({GEN - 1} steps in {res.decode_s:.3f}s, "
          f"{step_ms:.2f} ms a step); peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    print(f"[hybrid] sample output ids: {res.generated[0, :12].tolist()}")
    for name, want in (("ssd", cfg.n_layers), ("flash_attention", n_attn * GEN),
                       ("flash_attention_bwd", 0), ("mlstm", 0)):
        got = counts[HYBRID][name]
        print(f"[hybrid] {name} launches: {got} (expected {want})")
        if got != want:
            failures.append(f"{HYBRID}: {name} launched {got} times, expected {want}")
    if not res.finite:
        failures.append("non-finite logits in the hybrid serve run")

    # The attention kernel at this model's shapes (head dim 64), checked and
    # timed; with the SSD kernel's time, the kernels' shares of the run.
    H, D, Sk_dec = cfg.n_heads, cfg.hd, PROMPT + GEN - 1
    att = {}
    for label, S, Sk, causal, seed in (("prefill", PROMPT, PROMPT, True, 400),
                                       ("decode", 1, Sk_dec, False, 410)):
        q = model_layout(torch, BATCH, H, S, D, "bfloat16", seed, dev)
        if label == "prefill":
            kv_sets = [(model_layout(torch, BATCH, H, Sk, D, "bfloat16", seed + 1, dev,
                                     PROMPT + GEN),
                        model_layout(torch, BATCH, H, Sk, D, "bfloat16", seed + 2, dev,
                                     PROMPT + GEN))]
        else:
            kv_sets = decode_sets(torch, BATCH, H, Sk, D, seed + 1, dev)
        k, v = kv_sets[0]
        out = fa.flash_attention_cuda(q, k, v, causal=causal)
        want = ref.attention_ref(q, k, v, causal=causal)
        err = float((out.float() - want.float()).abs().max())
        ok = torch.allclose(out.float(), want.float(), **TOL["bfloat16"])
        shape = f"{label} ({BATCH},{H},{S},{D}) Sk {Sk}{' causal' if causal else ''} bf16"
        print(f"[kernel] flash_attention {shape}: max_abs_err={err:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"flash_attention {shape}: max_abs_err {err:.3e}")
        att[label] = {"shape": shape, **attention_timings(torch, q, kv_sets, causal, dev)}
        print_attention_time(shape, att[label])
    fa_entry[HYBRID] = att
    pre_ms = res.prefill_s * 1e3
    print(f"[hybrid] kernel shares of the prefill: ssd {cfg.n_layers} x "
          f"{ssd_entry['ms']:.4f} ms = {cfg.n_layers * ssd_entry['ms'] / pre_ms:.1%}, "
          f"attention {n_attn} x {att['prefill']['ms']:.4f} ms = "
          f"{n_attn * att['prefill']['ms'] / pre_ms:.1%}; attention in decode at most "
          f"{n_attn} x {att['decode']['ms']:.4f} ms = "
          f"{n_attn * att['decode']['ms'] / step_ms:.1%} of a step")

    # The gates, in fp32 on the same weights and prompts: the prefill's last
    # logits, and 4 decode steps after it (they read the prefill's final SSM
    # and conv states and its attention cache), through the kernels against
    # the same through both plain versions.
    cfg32 = cfg.replace(dtype="float32", logit_dtype="float32")
    params32 = {k: v.float() for k, v in params.items()}
    model32 = Model(cfg32, dev)
    g = torch.Generator(device=dev).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab, (BATCH, 4), generator=g, device=dev)
    lk, sk = prefill_then_decode(torch, model32, params32, prompts, tokens, failures)
    lp, sp = prefill_then_decode(torch, model32, params32, prompts, tokens, failures, plain=True)
    gate(torch, "[hybrid] fp32 prefill last logits, kernels vs plain versions", lk, lp, failures)
    gate(torch, "[hybrid] fp32 4 decode steps after the prefill, kernels vs plain versions",
         sk, sp, failures)
    del params32, lk, lp, sk, sp

    last = last_logits(torch, model, params, prompts, failures, plain=True)
    bf16_gap(torch, "[hybrid] bf16 prefill last logits, kernels vs plain versions",
             res.prefill_logits.float(), last, failures, EARLIER_BF16_GAP[HYBRID])


def slstm_pass(torch, model, params, dev) -> tuple[float, int]:
    """One sLSTM block's pass over a (BATCH, PROMPT) input, as the prefill
    runs it (a Python loop of PROMPT steps): warm host-clock ms, and its
    kernel launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.xlstm import slstm_block

    lp = {k.removeprefix("blocks/"): v[0] for k, v in params.items() if k.startswith("blocks/")}
    x = randn(torch, (BATCH, PROMPT, model.cfg.d_model), model.cfg.dtype, 700, dev)
    with torch.inference_mode():
        slstm_block(lp, "slstm", model.cfg, x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slstm_block(lp, "slstm", model.cfg, x)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            slstm_block(lp, "slstm", model.cfg, x)
            torch.cuda.synchronize()
    launches = sum(e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    return ms, launches


def xlstm_phase(torch, dev, mlstm_entry, failures, counts):
    from repro_torch.launch import serve
    from repro_torch.models import Model

    t0 = time.perf_counter()
    model, params = serve.build_model(XLSTM, full=True, device=dev, seed=0)
    torch.cuda.synchronize()
    cfg = model.cfg
    every = cfg.xlstm_slstm_every
    n_mlstm = cfg.n_layers // every * (every - 1)
    dp = int(cfg.xlstm_proj_factor * cfg.d_model)
    n_params = sum(p.numel() for p in params.values())
    print(f"[xlstm] {cfg.name}: {cfg.n_layers} blocks ({n_mlstm} mLSTM, "
          f"{cfg.n_layers - n_mlstm} sLSTM), d_model {cfg.d_model}, {cfg.n_heads} heads; "
          f"mLSTM inner {dp}, head dim {dp // cfg.n_heads}, chunk {cfg.xlstm_chunk}; sLSTM "
          f"head dim {cfg.d_model // cfg.n_heads}; vocab {cfg.vocab}; {n_params / 1e6:.1f} M "
          f"params in {cfg.dtype}, initialised in {time.perf_counter() - t0:.1f}s")
    prompts = serve.make_prompts(model, BATCH, PROMPT, seed=1)
    cold = serve.generate(model, params, prompts[:, :16], 4)   # 16: ragged against chunk 128
    print(f"[xlstm] warm-up (prompt 16, 4 tokens): prefill {cold.prefill_s * 1e3:.1f} ms, "
          f"decode {cold.decode_s * 1e3:.1f} ms, finite {cold.finite}")
    if not cold.finite:
        failures.append("non-finite logits in the xlstm warm-up run (prompt 16)")

    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    res = serve.generate(model, params, prompts, GEN)
    counts[XLSTM] = read_counts()
    step_ms = res.decode_s / (GEN - 1) * 1e3
    print(f"[xlstm] prefill {BATCH}x{PROMPT} tokens: {res.prefill_s * 1e3:.1f} ms; decode "
          f"{res.decode_tok_s:.1f} tok/s ({GEN - 1} steps in {res.decode_s:.3f}s, "
          f"{step_ms:.2f} ms a step); peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    print(f"[xlstm] sample output ids: {res.generated[0, :12].tolist()}")
    for name, want in (("mlstm", n_mlstm), ("ssd", 0), ("flash_attention", 0),
                       ("flash_attention_bwd", 0)):
        got = counts[XLSTM][name]
        print(f"[xlstm] {name} launches: {got} (expected {want})")
        if got != want:
            failures.append(f"{XLSTM}: {name} launched {got} times, expected {want}")
    if not res.finite:
        failures.append("non-finite logits in the xlstm serve run")
    pre_ms = res.prefill_s * 1e3
    slstm_ms, slstm_launches = slstm_pass(torch, model, params, dev)
    n_slstm = cfg.n_layers - n_mlstm
    print(f"[xlstm] shares of the prefill: mLSTM kernel {n_mlstm} x {mlstm_entry['ms']:.4f} ms "
          f"= {n_mlstm * mlstm_entry['ms'] / pre_ms:.1%}; sLSTM blocks {n_slstm} x "
          f"{slstm_ms:.1f} ms = {n_slstm * slstm_ms / pre_ms:.1%} ({slstm_launches} kernel "
          f"launches a block over the prompt, {slstm_launches / PROMPT:.1f} a step)")

    # The gates, in fp32 on the same weights and prompts: the prefill's last
    # logits, and 4 decode steps after it (they read the prefill's final
    # mLSTM and sLSTM states), through the kernel against the same through
    # the plain versions.
    cfg32 = cfg.replace(dtype="float32", logit_dtype="float32")
    params32 = {k: v.float() for k, v in params.items()}
    model32 = Model(cfg32, dev)
    g = torch.Generator(device=dev).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab, (BATCH, 4), generator=g, device=dev)
    lk, sk = prefill_then_decode(torch, model32, params32, prompts, tokens, failures)
    lp, sp = prefill_then_decode(torch, model32, params32, prompts, tokens, failures, plain=True)
    gate(torch, "[xlstm] fp32 prefill last logits, kernel vs plain versions", lk, lp, failures)
    gate(torch, "[xlstm] fp32 4 decode steps after the prefill, kernel vs plain versions",
         sk, sp, failures)
    del params32, lk, lp, sk, sp

    # The bf16 gap to the plain versions at two points of the same prefill:
    # the first mLSTM block's output (the kernel's own error: both runs feed
    # it the same input) and the last logits (after 11 more blocks).
    first_k, last_k = first_mlstm_and_logits(torch, model, params, prompts, failures)
    first_p, last_p = first_mlstm_and_logits(torch, model, params, prompts, failures, plain=True)
    bf16_gap(torch, "[xlstm] bf16 first mLSTM block's output, kernel vs plain versions",
             first_k, first_p, failures, ids=False)
    bf16_gap(torch, "[xlstm] bf16 prefill last logits, kernel vs plain versions",
             last_k, last_p, failures)


def first_mlstm_and_logits(torch, model, params, prompts, failures, *, plain=False):
    """A prefill's first mLSTM block output (B, S, d) and last logits (B, V),
    in fp32, through the kernels or (``plain``) their plain versions."""
    from unittest import mock

    from repro_torch.models import transformer

    seen = []
    block = transformer.mlstm_block

    def recording(*args, **kwargs):
        out = block(*args, **kwargs)
        if not seen:
            seen.append(out[0].float())
        return out

    with mock.patch.object(transformer, "mlstm_block", recording):
        last = last_logits(torch, model, params, prompts, failures, plain=plain)
    return seen[0], last


# ------------------------------------------------------------------- train --


def train_phase(torch, dev, fa_entry, bwd_entry, failures, counts) -> int:
    """Full stablelm_3b trained 4 steps through ``repro_torch.launch.train``,
    then the fp32 gate at full width and 4 layers against the plain twin.
    Returns the peak memory of the 4 steps (bytes)."""
    from repro_torch.configs import arch_config
    from repro_torch.data import SyntheticTokens, to_device
    from repro_torch.device import card_label
    from repro_torch.launch import train as train_cli

    cfg = arch_config(ARCH)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model, state, step_fn = train_cli.build(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state.params.values())
    print(f"[train] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads "
          f"x {cfg.hd}, {n_params / 1e9:.3f} B params as fp32 masters (params, grads and AdamW "
          f"mu / nu: {16 * n_params / 1e9:.1f} GB), compute {cfg.dtype}, remat {cfg.remat}; "
          f"initialised in {time.perf_counter() - t0:.1f}s")
    data = SyntheticTokens(cfg, BATCH, TRAIN_SEQ, seed=0)

    reset_counts()
    state, records = train_cli.train(model, state, step_fn, data.iter(), TRAIN_STEPS,
                                     log=lambda line: print(f"[train] {line}"))
    path = f"train {ARCH}"
    counts[path] = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    for r in records:
        print(f"[train] step {r.step}: loss {r.loss:.4f}, grad norm {r.grad_norm:.4f}, "
              f"{r.seconds * 1e3:.1f} ms")
    step_s = statistics.median(r.seconds for r in records[1:])
    print(f"[train] step time {step_s * 1e3:.1f} ms (median of steps 1-{TRAIN_STEPS - 1}; step 0, "
          f"cold, {records[0].seconds * 1e3:.1f} ms), {BATCH * TRAIN_SEQ / step_s:.0f} tokens/s, "
          f"peak memory {peak / 2**30:.1f} GiB ({peak / 1e9:.1f} GB), on {card_label(dev)}")
    if not all(math.isfinite(r.loss) and math.isfinite(r.grad_norm) for r in records):
        failures.append("non-finite loss or grads in the stablelm_3b train run")
    print("[train] every loss and grad norm finite (the fp32 global norm is finite only if "
          f"every grad element is): {all(math.isfinite(r.grad_norm) for r in records)}")
    per_step = {"flash_attention": cfg.n_layers * (1 + int(cfg.remat)),
                "flash_attention_bwd": cfg.n_layers, "ssd": 0, "mlstm": 0}
    for name, want in per_step.items():
        got = counts[path][name]
        print(f"[train] {name} launches: {got} in {TRAIN_STEPS} steps (expected "
              f"{TRAIN_STEPS} x {want} = {TRAIN_STEPS * want})")
        if got != TRAIN_STEPS * want:
            failures.append(f"{path}: {name} launched {got} times, expected {TRAIN_STEPS * want}")
    fwd_ms = per_step["flash_attention"] * fa_entry["ms"]
    bwd_ms = per_step["flash_attention_bwd"] * bwd_entry["ms"]
    print(f"[train] attention kernel shares of a step: forward {per_step['flash_attention']} x "
          f"{fa_entry['ms']:.4f} ms = {fwd_ms / (step_s * 1e3):.1%}, backward "
          f"{per_step['flash_attention_bwd']} x {bwd_entry['ms']:.4f} ms = "
          f"{bwd_ms / (step_s * 1e3):.1%}")
    profile_train_step(torch, model, state, step_fn, to_device(data.sample(TRAIN_STEPS), dev),
                       cfg.dtype, failures)
    del model, state, step_fn
    torch.cuda.empty_cache()

    # Information: the same 4 steps from the same seed with the plain
    # attention.  Both run bf16 compute, whose rounding differs between the
    # two paths and grows over the steps, so the losses are printed beside
    # each other, not gated (the fp32 gate below holds the kernels).
    model, state, step_fn = train_cli.build(cfg, device=dev, seed=0)
    with plain_versions(failures):
        _, plain = train_cli.train(model, state, step_fn, data.iter(), TRAIN_STEPS,
                                   log=lambda line: None)
    print("[train] the same steps with the plain attention (information): losses "
          + ", ".join(f"{r.loss:.4f}" for r in plain) + " against the kernels' "
          + ", ".join(f"{r.loss:.4f}" for r in records) + "; grad norms "
          + ", ".join(f"{r.grad_norm:.4f}" for r in plain) + " against "
          + ", ".join(f"{r.grad_norm:.4f}" for r in records))
    if not all(math.isfinite(r.loss) for r in plain):
        failures.append("non-finite loss in the plain-attention train run")
    del model, state, step_fn
    torch.cuda.empty_cache()

    # The gate: full width, 4 layers, fp32 (TF32 off, as main() sets), one
    # step through the kernels against the same step with the plain
    # attention; then the same in bf16, printed.
    batch = to_device(data.sample(0), dev)
    for dtype in ("float32", "bfloat16"):
        small = cfg.replace(n_layers=GATE_LAYERS, dtype=dtype, logit_dtype=dtype)
        model, state, _ = train_cli.build(small, device=dev, seed=0)
        got = one_step(torch, model, state.params, batch, failures)
        want = one_step(torch, model, state.params, batch, failures, plain=True)
        label = (f"[train] {dtype} step at full width, depth cut to {GATE_LAYERS} layers, "
                 f"kernels vs plain attention")
        loss_err = abs(got[0] - want[0])
        worst = max(((rel_rms(torch, got[1][k], want[1][k]), k) for k in want[1]))
        p_err = max(float((got[2][k] - want[2][k]).abs().max()) for k in want[2])
        if dtype == "float32":
            ok_loss = loss_err <= MODEL_TOL["atol"] + MODEL_TOL["rtol"] * abs(want[0])
            ok_grads = worst[0] <= GRAD_REL_RMS and all(
                torch.allclose(got[1][k], want[1][k], **MODEL_TOL) for k in want[1])
            ok_params = all(torch.allclose(got[2][k], want[2][k], **MODEL_TOL) for k in want[2])
            print(f"{label}: loss {got[0]:.6f} vs {want[0]:.6f} (|gap| {loss_err:.3e}, "
                  f"rtol={MODEL_TOL['rtol']}, atol={MODEL_TOL['atol']}) "
                  f"{'ok' if ok_loss else 'FAIL'}; grads: worst leaf relative rms {worst[0]:.3e} "
                  f"({worst[1]}; at most {GRAD_REL_RMS}, and each leaf within rtol/atol) "
                  f"{'ok' if ok_grads else 'FAIL'}; params after AdamW max_abs_err {p_err:.3e} "
                  f"{'ok' if ok_params else 'FAIL'}")
            for ok, what in ((ok_loss, "loss"), (ok_grads, "grads"), (ok_params, "params")):
                if not ok:
                    failures.append(f"fp32 train gate: {what}")
        else:
            print(f"{label} (information): loss {got[0]:.6f} vs {want[0]:.6f} (|gap| "
                  f"{loss_err:.3e}); grads: worst leaf relative rms {worst[0]:.3e} ({worst[1]}); "
                  f"params after AdamW max_abs_err {p_err:.3e}")
            if not math.isfinite(got[0]) or not math.isfinite(want[0]):
                failures.append("bf16 train gate: non-finite loss")
        del model, state, got, want
        torch.cuda.empty_cache()
    return peak


def elastic_phase(torch, dev, train_peak, failures, counts):
    """Full stablelm_3b through the elastic loop on ``steady-cycle``, then
    the RESTART gate of ``restart-vs-shrink`` at full width, 4 layers."""
    import dataclasses
    import tempfile

    from repro_torch.checkpoint import restore_tree
    from repro_torch.configs import arch_config
    from repro_torch.device import card_label
    from repro_torch.elastic import ElasticTrainer, PytreeBytesModel
    from repro_torch.malleability import get_scenario, record_parity_key, run_scenario_sim
    from repro_torch.malleability.scenarios import RuntimeAdapter, param_bytes_for_arch
    from repro_torch.models import Model

    label = card_label(dev)
    cfg = arch_config(ARCH)
    sc = get_scenario(ELASTIC_SCENARIO)
    model = Model(cfg, dev)
    engine = dataclasses.replace(sc.default_engine(), bytes_model=PytreeBytesModel(model))
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    trainer = ElasticTrainer.from_scenario(model, sc, engine=engine, lr=3e-4, batch=BATCH,
                                           seq=TRAIN_SEQ)
    trainer._init_state()
    torch.cuda.synchronize()
    print(f"[elastic] {cfg.name} on {sc.name!r}: {sc.pool_nodes()} logical slots, all on this "
          f"card ({label}); stage 3 records placements and moves no byte, and est/downtime are "
          f"the {sc.profile} cost model's modelled cluster times, not card times; initialised "
          f"in {time.perf_counter() - t0:.1f}s")

    reset_counts()
    t0 = time.perf_counter()
    hist = trainer.run(ELASTIC_STEPS)
    path = f"elastic {ARCH}"
    counts[path] = read_counts()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"[elastic] {ELASTIC_STEPS} steps in {wall:.1f}s; losses "
          + ", ".join(f"{r.loss:.4f}" for r in hist))
    print("[elastic] step times (ms, host clock ended by the loss's sync): "
          + ", ".join(f"{r.seconds * 1e3:.1f}" for r in hist))
    nodes = [r.n_nodes for r in hist]
    want_nodes = [1] * 5 + [4] * 5 + [1] * 5 + [4] * 5 + [1] * 5
    print(f"[elastic] nodes per step: {nodes}")
    if nodes != want_nodes:
        failures.append(f"{path}: nodes per step {nodes}, expected {want_nodes}")
    if not all(math.isfinite(r.loss) for r in hist):
        failures.append(f"{path}: non-finite loss")
    for n in sorted(set(nodes)):
        times = [r.seconds for r in hist[1:] if r.n_nodes == n]
        print(f"[elastic] step time at {n} node(s): {statistics.median(times) * 1e3:.1f} ms "
              f"(median of {len(times)}; min {min(times) * 1e3:.1f}, max "
              f"{max(times) * 1e3:.1f}) on {label}")

    # records against the simulator with the same engine
    sim = run_scenario_sim(sc, engine=engine)
    sim = [r for r in sim if r.step < ELASTIC_STEPS]
    got = [record_parity_key(RuntimeAdapter._convert(r))[1:] for r in trainer.runtime.history]
    want = [record_parity_key(r)[1:] for r in sim]
    if len(got) != 4 or got != want:
        failures.append(f"{path}: records {got} differ from the simulator's {want}")
    total = param_bytes_for_arch(ARCH)
    for rec, w, t in zip(trainer.runtime.history, trainer.wall_log, trainer.transfer_log):
        print(f"[elastic] step {w['step']} {rec.kind} {rec.mechanism} {rec.nodes_before}->"
              f"{rec.nodes_after}: host wall on the card {w['host_s'] * 1e3:.2f} ms ({label}); "
              f"modelled cluster est {rec.est_wall_s * 1e3:.2f} ms, downtime "
              f"{rec.downtime_s * 1e3:.2f} ms; stage 3 bytes moved {t['bytes_moved']} "
              f"(charged {t['charged_bytes_moved']}), stayed {t['bytes_stayed']}, total "
              f"{t['bytes_total']} (the pytree: {total})")
        if t["bytes_moved"] != t["charged_bytes_moved"] or t["bytes_total"] != total:
            failures.append(f"{path}: stage 3 at step {t['step']} logged {t}")
    if len(trainer.transfer_log) != 4:
        failures.append(f"{path}: {len(trainer.transfer_log)} stage-3 entries, expected 4")
    per_step = {"flash_attention": cfg.n_layers * (1 + int(cfg.remat)),
                "flash_attention_bwd": cfg.n_layers, "ssd": 0, "mlstm": 0}
    for name, n in per_step.items():
        print(f"[elastic] {name} launches: {counts[path][name]} (expected "
              f"{ELASTIC_STEPS} x {n} = {ELASTIC_STEPS * n})")
        if counts[path][name] != ELASTIC_STEPS * n:
            failures.append(f"{path}: {name} launched {counts[path][name]} times")
    print(f"[elastic] peak memory {peak / 2**30:.2f} GiB against the train phase's "
          f"{train_peak / 2**30:.2f} GiB on {label}")
    if peak > train_peak:
        failures.append(f"{path}: peak memory {peak} above the train phase's {train_peak}")
    del trainer, model, engine
    torch.cuda.empty_cache()

    # RESTART at full width, 4 layers: the params right after it (step 5)
    # are the step-4 snapshot on disk, and the params the trainer held when
    # it saved that snapshot.  Six steps reach it.
    small = cfg.replace(n_layers=GATE_LAYERS)
    rsc = get_scenario("restart-vs-shrink")
    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer = ElasticTrainer.from_scenario(Model(small, dev), rsc, lr=3e-4, batch=BATCH,
                                               seq=TRAIN_SEQ, checkpoint_dir=ckpt_dir,
                                               checkpoint_every=2)
        t0 = time.perf_counter()
        trainer.run(RESTART_STEP - 1)   # saves step 4's snapshot after step 3
        at_save = {k: p.detach().to("cpu", copy=True) for k, p in trainer.state.params.items()}
        # The params the first step after the RESTART starts from, as the
        # step function is handed them (read only; the step runs as it would).
        after_restart = {}
        step_fn = trainer._step_fn

        def observed_step(state, batch):
            if len(trainer.history) == RESTART_STEP:
                after_restart.update({k: p.detach().to("cpu", copy=True)
                                      for k, p in state.params.items()})
            return step_fn(state, batch)

        trainer._step_fn = observed_step
        hist = trainer.run(2)
        print(f"[elastic] {rsc.name!r} at full width, {GATE_LAYERS} layers: {len(hist)} steps "
              f"in {time.perf_counter() - t0:.1f}s, nodes {[r.n_nodes for r in hist]}")
        for rec, w in zip(trainer.runtime.history, trainer.wall_log):
            extra = ""
            if w["bytes_read"]:
                extra = (f"; of it {w['wait_s'] * 1e3:.2f} ms waiting for the last "
                         f"snapshot's write to land, then {w['bytes_read']} bytes read back "
                         f"from the store in {w['read_s'] * 1e3:.2f} ms, "
                         f"{w['bytes_read'] / w['read_s'] / 1e9:.2f} GB/s (disk, then host "
                         "to card; host clock)")
            print(f"[elastic]   step {w['step']} {rec.kind} {rec.mechanism} "
                  f"{rec.nodes_before}->{rec.nodes_after}: host wall on the card "
                  f"{w['host_s'] * 1e3:.2f} ms{extra} ({label}); modelled cluster est "
                  f"{rec.est_wall_s * 1e3:.2f} ms, downtime {rec.downtime_s * 1e3:.2f} ms")
        restored = {t["step"]: t["restored_from_step"] for t in trainer.transfer_log
                    if "restored_from_step" in t}
        snap = restore_tree({"params": trainer.state.params}, ckpt_dir,
                            RESTART_STEP - 1)["params"]
        same_disk = bool(after_restart) and all(
            torch.equal(after_restart[k], v) for k, v in snap.items())
        same_held = bool(after_restart) and all(
            torch.equal(after_restart[k], v) for k, v in at_save.items())
        print(f"[elastic] restores (step: snapshot step) {restored}; params right after the "
              f"RESTART bitwise equal to the snapshot on disk: {same_disk}, to the params "
              f"held when it was saved: {same_held}")
        if restored != {RESTART_STEP: RESTART_STEP - 1} or not (same_disk and same_held):
            failures.append(f"restart-vs-shrink: restores {restored}, equal to the snapshot "
                            f"on disk {same_disk}, to the params saved {same_held}")
        if not all(math.isfinite(r.loss) for r in hist):
            failures.append("restart-vs-shrink: non-finite loss")
        del trainer, at_save, after_restart, snap
    torch.cuda.empty_cache()


def rel_rms(torch, got, want) -> float:
    return float((got.double() - want.double()).square().mean().sqrt()
                 / want.double().square().mean().sqrt().clamp_min(1e-30))


def one_step(torch, model, params, batch, failures, *, plain=False):
    """One train step from a copy of ``params``, through the kernels or
    (``plain``) the plain attention: (loss, grads, params after AdamW),
    grads and params in fp32."""
    from repro_torch.optim import adamw_init, adamw_update, global_norm
    from repro_torch.train import loss_and_grads

    params = {k: p.detach().clone().requires_grad_() for k, p in params.items()}
    with plain_versions(failures) if plain else contextlib.nullcontext():
        loss, grads = loss_and_grads(model, params, batch)
    with torch.no_grad():
        kept = {k: g.float().clone() for k, g in grads.items()}   # adamw_update consumes grads
        adamw_update(grads, adamw_init(params), params, 3e-4, grad_norm=global_norm(grads))
    return float(loss), kept, {k: p.detach().float() for k, p in params.items()}


def profile_train_step(torch, model, state, step_fn, batch, dtype, failures):
    """Where a warm train step's time goes: one more step split in its two
    phases by host clock (each ended by a device sync), then one under
    torch.profiler: the device's busy share, its kernels by group, and the
    attention backward's kernels by name, which must be those of the
    compute dtype's path (``BWD_PATHS``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.optim import adamw_update, global_norm
    from repro_torch.train import loss_and_grads

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, grads = loss_and_grads(model, state.params, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with torch.no_grad():
        adamw_update(grads, state.opt, state.params, 3e-4, grad_norm=global_norm(grads))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del grads
    print(f"[train] a step's phases (host clock, synced): loss and grads {(t1 - t0) * 1e3:.1f} ms, "
          f"global norm and AdamW over {sum(p.numel() for p in state.params.values()) / 1e9:.3f} B "
          f"fp32 params {(t2 - t1) * 1e3:.1f} ms")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    groups: dict[str, float] = {}
    for e in kernels:
        name = e.key.lower()
        group = ("attention backward kernel" if "attn_bwd" in name else
                 "attention forward kernel" if "attn_" in name else
                 "matmul (cuBLAS)" if any(w in name for w in ("gemm", "xmma", "nvjet", "cutlass"))
                 else "other (elementwise, reductions, copies, AdamW)")
        groups[group] = groups.get(group, 0.0) + e.self_device_time_total / 1e3
    print(f"[train] profiled step: {wall_ms:.1f} ms wall, device busy {busy:.1f} ms "
          f"({busy / wall_ms:.1%}), {sum(e.count for e in kernels)} kernel launches; by group: "
          + ", ".join(f"{g} {ms:.1f} ms ({ms / busy:.1%})"
                      for g, ms in sorted(groups.items(), key=lambda kv: -kv[1])))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[train]   {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d}x  {e.key[:90]}")
    bwd = {}
    for e in kernels:
        m = re.search(r"(attn_bwd_\w+)", e.key)
        if m:
            ms, n = bwd.get(m.group(1), (0.0, 0))
            bwd[m.group(1)] = (ms + e.self_device_time_total / 1e3, n + e.count)
    print("[train] attention backward kernels in the profiled step: " + ", ".join(
        f"{name} {ms:.2f} ms in {n} launches" for name, (ms, n) in sorted(bwd.items())))
    want = BWD_PATHS[dtype]["kernels"]
    if sorted(bwd) != sorted(want):
        failures.append(f"profiled {dtype} train step ran the attention backward kernels "
                        f"{sorted(bwd)}, expected {want}")


if __name__ == "__main__":
    sys.exit(main())
