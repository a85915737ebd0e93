#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); builds the kernels
from the checkout's sources itself.  Phases, each of which fails the run:

1. build   — compile ``src/repro_torch/kernels/csrc/{flash_attention,ssd,mlstm}.cu``
             for sm_90a, one ``nvcc`` per source, all started together;
2. kernels — every kernel against its plain PyTorch version on the card
             (the cases of ``tests/test_kernels.py``, in fp32 (the scalar
             kernels) and bf16 (the tensor-core kernels), and the serve
             paths' shapes), then timed at the serve paths' shapes beside
             the plain version, one library call where there is one, and
             the card's bound; attention decode is timed with a cold L2;
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
             same with the kernels swapped for their plain versions.

Prints the card's name and power limit, one JSON line of kernel numbers,
and last ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
result, on any failure, without a card, or without the port's sources.
"""
from __future__ import annotations

import contextlib
import json
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
KERNELS = ("flash_attention", "ssd", "mlstm")
L2_BYTES = 50 * 2**20   # H100 L2; decode timings rotate over more K/V than this
# The bf16 prefill gaps to the plain twins that the scalar kernels gave
# (chip_smoke.py on an H100 80GB HBM3 at 700 W), printed beside today's.
EARLIER_BF16_GAP = {"stablelm_3b": "3.906e-02", "zamba2_1p2b": "8.6e-02"}

ARCH, BATCH, PROMPT, GEN = "stablelm_3b", 8, 512, 64
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
    kernels = [entry, ssd_entry, mlstm_entry]
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


def bound_ms(torch, q, k, v, *, causal, window, dev) -> tuple[float, str]:
    """Larger of bytes / bandwidth (q, k, v read once, o written once) and
    operations / peak: 4 D flops per (query, key) pair the mask admits."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    qp = torch.arange(Sq, device=dev)[:, None]
    kp = torch.arange(Sk, device=dev)[None, :]
    mask = torch.ones(Sq, Sk, dtype=torch.bool, device=dev)
    if causal:
        mask &= kp <= qp
    if window > 0:
        mask &= kp > qp - window
    flops = 4 * D * B * H * int(mask.sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(q.dtype).removeprefix("torch.")] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "smem", "Compiling entry")):
                print(f"[build] {name}: {line.strip()}")
    from repro_torch.kernels import mlstm, ssd

    print(f"[build] ssd: dynamic shared memory a block at the serve shape (chunk 128, "
          f"N 64, P 64): {ssd.smem_bytes(128, 64, 64)} bytes (bf16, tensor cores), "
          f"{ssd.smem_bytes(128, 64, 64, torch.float32)} bytes (fp32, scalar)")
    print(f"[build] mlstm: dynamic shared memory a block at the serve shape (chunk 128, "
          f"D 384): {mlstm.smem_bytes(128, 384)} bytes")


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


def mlstm_work(chunk, D) -> str:
    """The FMAs a block of the kernel does per chunk, and the share of them
    that recomputes q k^T (every one of the D/32 blocks of a (b, h) does)."""
    vb = min(D, 32)
    t4 = chunk // 4
    qk = t4 * (t4 + 1) // 2 * 16 * D          # lower-triangle 4x4 tiles of q k^T
    wv = t4 * (t4 + 1) // 2 * 16 * vb         # W v on its own value columns
    total = qk + 2 * chunk * D * vb + wv      # + q S and the state update
    return (f"q k^T is {qk / 1e6:.2f} of the {total / 1e6:.2f} M FMAs a block does per "
            f"chunk ({qk / total:.0%}), recomputed by each of the {D // vb} blocks of a (b, h)")


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

    # The serve path's shape, in the model's layout.
    shape = f"serve ({BATCH},{PROMPT},4,384) chunk 128 bf16"
    sargs = mlstm_inputs(torch, BATCH, PROMPT, 4, 384, "bfloat16", 600, dev, model_layout=True)
    err = compare(shape, sargs, 128, MLSTM_TOL["bfloat16"])

    t = {"ms": time_ms(torch, lambda: mlstm.mlstm_scan_cuda(*sargs, chunk=128)),
         "plain_ms": time_ms(torch, lambda: ref.mlstm_chunked(*sargs, 128), iters=5, reps=3),
         "library_ms": None}
    t["bound_ms"], t["bound_by"] = mlstm_bound_ms(sargs[0], 128)
    print(f"[time] mlstm {shape}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
          f"no single PyTorch call, bound {t['bound_ms'] * 1e3:.2f} us ({t['bound_by']})")
    print(f"[time] mlstm: {mlstm_work(128, 384)}")
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
    ssd.launches = 0
    mlstm.launches = 0


def read_counts() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mlstm, ssd

    return {"flash_attention": fa.launches, "ssd": ssd.launches, "mlstm": mlstm.launches}


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


def bf16_gap(torch, label, got, want, failures, earlier=None):
    """Printed as information; only non-finite values fail.  ``earlier``:
    the same gap with the scalar kernels, for comparison."""
    err = float((got - want).abs().max())
    rel_rms = float((got - want).square().mean().sqrt() / want.square().mean().sqrt())
    same = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    print(f"{label} (information): max_abs_err={err:.3e}"
          f"{f' (scalar kernels: {earlier})' if earlier else ''} at max |logit| "
          f"{float(want.abs().max()):.3f}, relative rms {rel_rms:.3e}, same greedy id in "
          f"{same:.0%} of rows")
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
    for name, want in (("ssd", cfg.n_layers), ("flash_attention", n_attn * GEN)):
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
    for name, want in (("mlstm", n_mlstm), ("ssd", 0), ("flash_attention", 0)):
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

    last = last_logits(torch, model, params, prompts, failures, plain=True)
    bf16_gap(torch, "[xlstm] bf16 prefill last logits, kernel vs plain versions",
             res.prefill_logits.float(), last, failures)


if __name__ == "__main__":
    sys.exit(main())
