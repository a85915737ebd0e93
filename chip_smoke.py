#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); builds the kernels
from the checkout's sources itself.  Phases, each of which fails the run:

1. build   — compile ``src/repro_torch/kernels/csrc/flash_attention.cu``
             for sm_90a;
2. kernels — every kernel against its plain PyTorch version on the card
             (the cases of ``tests/test_kernels.py`` and the serve path's
             shapes), then timed at the serve path's shapes beside the
             plain version, one library call and the card's bound;
3. serve   — ``stablelm_3b`` at full size, seed-initialised on the card:
             batch 8, prompt 512, 64 greedy tokens in bf16 through
             ``repro_torch.launch.serve``; the attention kernel must have
             run on every layer of the prefill and of every decode step,
             every logit must be finite, and in fp32 the prefill's last
             logits must match the same prefill with the plain attention
             (the bf16 gap is printed beside it).

Prints the card's name and power limit, one JSON line of kernel numbers,
and last ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
result, on any failure, without a card, or without the port's sources.
"""
from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

# NVIDIA H100 SXM data sheet, for the least time the card could take.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}

ARCH, BATCH, PROMPT, GEN = "stablelm_3b", 8, 512, 64


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

    failures: list[str] = []
    entry = kernel_phase(torch, dev, failures)
    if failures:
        return fail("; ".join(failures))
    serve_phase(torch, dev, entry, failures)
    if failures:
        return fail("; ".join(failures))

    print(f"card: {card}")
    print(json.dumps({"kernels": [entry]}))
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


def kernel_phase(torch, dev, failures) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import flash_attention as fa

    # 1. build
    t0 = time.perf_counter()
    log = _build.build("flash_attention")
    print(f"[build] flash_attention: {time.perf_counter() - t0:.1f}s"
          f"{'' if log else ' (library already built)'}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[build] flash_attention: {line.strip()}")

    # 2. kernel vs plain version on the card
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
    for window in (16, 64, 128):
        q, k, v = (randn(torch, (1, 2, 128, 32), "float32", 100 + i, dev) for i in range(3))
        compare(f"window {window}", q, k, v, "float32", causal=True, window=window)
    q, k, v = (randn(torch, (1, 2, 64, 32), "float32", 110 + i, dev, 4.0 if i < 2 else 1.0)
               for i in range(3))
    compare("softcap 20", q, k, v, "float32", dict(rtol=3e-5, atol=3e-5),
            causal=True, softcap=20.0)
    for seed, (log2s, group) in enumerate([(5, 1), (6, 2), (7, 4), (8, 2)]):
        S = 2 ** log2s
        q = randn(torch, (1, 2 * group, S, 32), "float32", 120 + 3 * seed, dev)
        k = randn(torch, (1, 2, S, 32), "float32", 121 + 3 * seed, dev)
        v = randn(torch, (1, 2, S, 32), "float32", 122 + 3 * seed, dev)
        compare(f"convex S {S} group {group}", q, k, v, "float32", causal=True, convex=True)

    # The serve path's two shapes, in the model's strided layout.
    H, D, Sk_dec = 32, 80, PROMPT + GEN - 1
    pq = model_layout(torch, BATCH, H, PROMPT, D, "bfloat16", 200, dev)
    pk = model_layout(torch, BATCH, H, PROMPT, D, "bfloat16", 201, dev)
    pv = model_layout(torch, BATCH, H, PROMPT, D, "bfloat16", 202, dev)
    dq = model_layout(torch, BATCH, H, 1, D, "bfloat16", 203, dev)
    dk = model_layout(torch, BATCH, H, Sk_dec, D, "bfloat16", 204, dev, PROMPT + GEN)
    dv = model_layout(torch, BATCH, H, Sk_dec, D, "bfloat16", 205, dev, PROMPT + GEN)
    err = max(compare("serve prefill (8,32,512,80) causal", pq, pk, pv, "bfloat16",
                      causal=True),
              compare(f"serve decode (8,32,1,80) Sk {Sk_dec}", dq, dk, dv, "bfloat16",
                      causal=False))

    # Times at those shapes (kernel, plain version, one library call).
    def timings(q, k, v, causal):
        t = {
            "ms": time_ms(torch, lambda: fa.flash_attention_cuda(q, k, v, causal=causal)),
            "plain_ms": time_ms(torch, lambda: ref.attention_ref(q, k, v, causal=causal)),
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal)),
        }
        t["bound_ms"], t["bound_by"] = bound_ms(torch, q, k, v, causal=causal, window=0, dev=dev)
        return t

    pre, dec = timings(pq, pk, pv, True), timings(dq, dk, dv, False)
    for label, t in (("prefill (8,32,512,80) causal bf16", pre),
                     (f"decode (8,32,1,80) Sk {Sk_dec} bf16", dec)):
        print(f"[time] flash_attention {label}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, sdpa {t['library_ms']:.4f} ms, bound "
              f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']})")
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


# ------------------------------------------------------------------- serve --


def serve_phase(torch, dev, entry, failures):
    from repro_torch.kernels import flash_attention as fa
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

    fa.launches = 0
    res = serve.generate(model, params, prompts, GEN)
    launches = fa.launches
    entry["launches"] = launches
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
    err32 = float((lk - lp).abs().max())
    ok32 = bool(torch.isfinite(lk).all()) and torch.allclose(lk, lp, rtol=2e-3, atol=5e-4)
    print(f"[serve] fp32 prefill last logits, kernel vs plain attention: "
          f"max_abs_err={err32:.3e} (rtol=2e-3, atol=5e-4) {'ok' if ok32 else 'FAIL'}")
    if not ok32:
        failures.append(f"fp32 prefill logits differ from the plain attention's: {err32:.3e}")
    del params32, lk, lp

    # Information only: the served bf16 prefill against the same prefill
    # with the plain attention.  The two round attention outputs
    # differently by up to one bf16 ulp, and 32 layers of a bf16 residual
    # stream carry that into every logit, so this gap is rounding, not a
    # tolerance: the fp32 gate above holds the kernel.
    last = last_logits(torch, model, params, prompts, failures, plain=True)
    got = res.prefill_logits.float()
    err = float((got - last).abs().max())
    rel_rms = float((got - last).square().mean().sqrt() / last.square().mean().sqrt())
    same = float((got.argmax(-1) == last.argmax(-1)).float().mean())
    print(f"[serve] bf16 prefill last logits, kernel vs plain attention (information): "
          f"max_abs_err={err:.3e} at max |logit| {float(last.abs().max()):.3f}, "
          f"relative rms {rel_rms:.3e}, same greedy id in {same:.0%} of rows")
    if not bool(torch.isfinite(last).all()):
        failures.append("non-finite logits in the plain bf16 prefill")


def last_logits(torch, model, params, prompts, failures, *, plain=False):
    """The prefill's last-position logits (B, V) in fp32.  ``plain`` swaps
    the plain attention in for the kernel, in this run only: the port has
    no switch for it."""
    import contextlib
    from unittest import mock

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    swap = (mock.patch.object(ops, "flash_attention", ref.attention_ref) if plain
            else contextlib.nullcontext())
    before = fa.launches
    with torch.inference_mode(), swap:
        out = model.forward(params, {"tokens": prompts})[0][:, -1].float()
    if plain and fa.launches != before:
        failures.append("the plain prefill launched the kernel")
    return out


if __name__ == "__main__":
    sys.exit(main())
