"""Serving driver: ``python -m repro_torch.launch.serve``.

Ports ``repro.launch.serve``.  The default mode drives the **elastic
decode service** (:mod:`repro_torch.serving`): it replays one (or all)
registered serve traffic traces (the decode pool grown and shrunk by the
traffic policy, in-flight KV caches migrated and priced on every resize)
on the simulator and the live runtime, prints per-phase latency and
throughput, and exits with the number of traces on which the two
executors disagree on any number.  As in the JAX package the service runs
no model: a decode step is priced at ``ServeConfig.step_time_s``, so its
latencies and tokens/s are modelled, not measured.  The live runtime's
pool is logical slots on one device (``--device``).

    python -m repro_torch.launch.serve --scenario all
    python -m repro_torch.launch.serve --device cpu --scenario serve-slo --executor sim

``--static`` ports ``repro.launch.serve._run_static``: batched greedy
decoding over synthetic prompts with a KV cache, reporting prefill time
and decode throughput.  Weights (seed 0) and prompts (seed 1) are
random, drawn on the device.

The prefill is ONE ``Model.forward(collect_kv=True)`` pass whose cache
contents (attention k/v; for the hybrid family also every Mamba2
layer's final SSM state and conv tail; for xLSTM every mLSTM layer's
final (S, n, m) and every sLSTM layer's (c, n, h, m)) are written into
the cache, as the JAX package's own prefill does for attention
(``repro.launch.dryrun``; for xLSTM it has none and feeds the prompt
token by token); its tests hold that equal to feeding the prompt token
by token.  Greedy decode then calls ``decode_step`` ``gen_len - 1``
times.  Attention, the Mamba2 chunked scan and the mLSTM chunked scan
run in the hand-written CUDA kernels on the card
(``repro_torch.kernels``); the sLSTM recurrence is a Python loop over
the prompt, as the JAX package's is a ``lax.scan``.  gemma2's local
layers keep window-sized ring caches where the cache outgrows the window.
The MoE layer's capacity is per call, so a one-pass prefill routes (and
drops) as the JAX package's one-pass forward does, not as its
token-by-token loop.  ``--layers`` cuts the config's depth, for a model
that does not fit one card whole (phi3.5-MoE's 41.9 B params).

    python -m repro_torch.launch.serve --static --arch stablelm_3b --full
    python -m repro_torch.launch.serve --static --arch zamba2_1p2b --full
    python -m repro_torch.launch.serve --static --arch xlstm_125m --full
    python -m repro_torch.launch.serve --static --arch gemma2_9b --full \\
        --batch 2 --prompt-len 5120 --gen-len 64
    python -m repro_torch.launch.serve --static --arch phi35_moe_42b --full \\
        --layers 8 --prompt-len 512 --gen-len 64

Both modes run on ``cuda`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import sys
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from repro_torch.configs import arch_config, smoke_config
from repro_torch.device import DeviceLike, card_label, resolve_device
from repro_torch.models import Model

@dataclass
class ServeResult:
    generated: torch.Tensor        # (B, G) greedy ids, on the host
    prefill_logits: torch.Tensor   # (B, V) logits at the last prompt position
    prefill_s: float
    decode_s: float
    finite: bool                   # every logit of every step was finite

    @property
    def decode_tok_s(self) -> float:
        B, G = self.generated.shape
        return B * (G - 1) / max(self.decode_s, 1e-9)


def build_model(arch: str, *, full: bool = False, device: DeviceLike = None,
                seed: int = 0, layers: Optional[int] = None) -> tuple[Model, dict]:
    """The arch's config (``full``: published widths and depth; else the
    smoke config; ``layers``: that depth instead) with params drawn from
    ``seed`` on the device, each cast to the compute dtype as it is drawn
    (no copy of the model in fp32: yi_34b's 34.4 B params are 68.8 GB in
    bf16)."""
    cfg = (arch_config if full else smoke_config)(arch).replace(embed_inputs=False)
    if layers:
        cfg = cfg.replace(n_layers=layers)
    model = Model(cfg, device)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    params, _ = model.init(gen, cast=cfg.compute_dtype)
    return model, model.serving_params(params)


def make_prompts(model: Model, batch: int, prompt_len: int, seed: int = 1) -> torch.Tensor:
    """(batch, prompt_len) token ids drawn from ``seed`` on the model's device."""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    return torch.randint(0, model.cfg.vocab, (batch, prompt_len), generator=gen,
                         device=model.device)


def _positions(model: Model, pos: torch.Tensor) -> torch.Tensor:
    return torch.stack([pos, pos, pos]) if model.cfg.mrope_sections else pos


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def generate(model: Model, params: dict, prompts: torch.Tensor, gen_len: int) -> ServeResult:
    """Prefill ``prompts`` in one pass, then greedy-decode ``gen_len`` ids
    (the first from the prefill's last logits)."""
    B, P = prompts.shape
    dev = model.device
    cache = model.init_cache(B, P + gen_len)

    _sync(dev)
    t0 = time.perf_counter()
    pos = torch.arange(P, dtype=torch.int32, device=dev).expand(B, P)
    logits = model.prefill(params, cache, {"tokens": prompts,
                                            "positions": _positions(model, pos)})
    last = logits[:, -1]
    finite = torch.isfinite(logits).all()
    nxt = last.argmax(dim=-1, keepdim=True)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    generated = [nxt]
    t0 = time.perf_counter()
    for t in range(P, P + gen_len - 1):
        pos = torch.full((B, 1), t, dtype=torch.int32, device=dev)
        lg, cache = model.decode_step(params, cache, {
            "tokens": nxt, "positions": _positions(model, pos), "cache_pos": t})
        finite &= torch.isfinite(lg).all()
        nxt = lg[:, -1].argmax(dim=-1, keepdim=True)
        generated.append(nxt)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    return ServeResult(
        generated=torch.cat(generated, dim=1).cpu(),
        prefill_logits=last,
        prefill_s=t_prefill,
        decode_s=t_decode,
        finite=bool(finite),
    )


def run_static(args: argparse.Namespace) -> int:
    dev = resolve_device(args.device)
    model, params = build_model(args.arch, full=args.full, device=dev, layers=args.layers)
    prompts = make_prompts(model, args.batch, args.prompt_len)
    res = generate(model, params, prompts, args.gen_len)
    B, P, G = args.batch, args.prompt_len, args.gen_len
    print(f"arch={model.cfg.name} batch={B} on {card_label(dev)}")
    print(f"prefill: {P} tokens x {B} in one pass, {res.prefill_s:.3f}s")
    print(f"decode:  {res.decode_tok_s:.1f} tok/s ({G - 1} steps in {res.decode_s:.2f}s)")
    print(f"sample output ids: {res.generated[0, :12].tolist()}")
    if not res.finite:
        print("non-finite logits", file=sys.stderr)
        return 1
    if args.profile:
        print_profile(model, params, prompts, args.gen_len)
    return 0


def _profiled(model: Model, params: dict, prompts: torch.Tensor, gen_len: int):
    """A serve run under ``torch.profiler``: (its kernels' key averages,
    device busy ms, kernel launches, wall ms)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _sync(model.device)
        t0 = time.perf_counter()
        generate(model, params, prompts, gen_len)
        _sync(model.device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return kernels, busy_ms, sum(e.count for e in kernels), wall_ms


def print_profile(model: Model, params: dict, prompts: torch.Tensor, gen_len: int):
    """Where a warm serve run's time goes: the device's busy share and the
    kernels that take it (``torch.profiler``), and the kernel launches of
    the prefill and of a decode step (a profiled prefill alone, then the
    whole run).  A busy share is a profiled run's device time over that
    same run's wall clock; an unprofiled run's wall clock is printed beside
    it."""
    warm = generate(model, params, prompts, gen_len)       # unprofiled wall clock
    _, pre_busy, pre_launches, pre_wall = _profiled(model, params, prompts, 1)
    kernels, busy_ms, launches, wall_ms = _profiled(model, params, prompts, gen_len)
    print(f"profile: unprofiled run {(warm.prefill_s + warm.decode_s) * 1e3:.1f} ms "
          f"(prefill {warm.prefill_s * 1e3:.1f} ms, decode {warm.decode_s * 1e3:.1f} ms); "
          f"profiled run {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({busy_ms / wall_ms:.1%}), idle {1 - busy_ms / wall_ms:.1%}; "
          f"{launches} kernel launches")
    print(f"profile: prefill alone {pre_wall:.1f} ms, device busy {pre_busy:.1f} ms "
          f"({pre_busy / pre_wall:.1%}), {pre_launches} kernel launches; a decode step "
          f"{(launches - pre_launches) / max(gen_len - 1, 1):.0f} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:10.2f} ms {e.count:7d}x  {e.key[:100]}")


def print_serve_report(rep) -> None:
    """Per-phase table + totals for one serve replay."""
    print(f"[{rep.executor}] {rep.scenario}: {rep.submitted} requests, "
          f"{rep.completed} completed, {rep.dropped} dropped "
          f"({rep.migrated} migrated / {rep.requeued} requeued on resizes)")
    print(f"  {'steps':>12} {'workers':>7} {'done':>5} "
          f"{'p50 lat':>9} {'tok/s':>8}")
    for ph in rep.phases:
        print(f"  [{ph.start_step:4d},{ph.end_step:4d}) {ph.workers:7d} "
              f"{ph.completed:5d} {ph.p50_latency_s:8.3f}s "
              f"{ph.throughput_tok_s:8.1f}")
    print(f"  total: wall {rep.wall_s:.2f}s, downtime {rep.downtime_s:.4f}s, "
          f"queued {rep.queued_s:.2f}s, p50 {rep.p50_latency_s:.3f}s, "
          f"p99 {rep.p99_latency_s:.3f}s, {rep.throughput_tok_s:.1f} tok/s, "
          f"{rep.bytes_moved / 1e6:.1f} MB KV moved "
          f"({rep.bytes_cross_rack / 1e6:.1f} MB cross-rack)")


def run_elastic(names: Sequence[str], executor: str, strategy: Optional[str],
                device: DeviceLike = None) -> int:
    """Replay serve traces; returns the number of sim/live disagreements.
    The live executor's slots lie on ``device``."""
    from repro_torch.serving import run_serve, serve_parity_key

    bad = 0
    for name in names:
        if executor in ("sim", "live"):
            print_serve_report(run_serve(name, executor=executor,
                                         strategy=strategy, device=device))
            continue
        sim = run_serve(name, executor="sim", strategy=strategy)
        live = run_serve(name, executor="live", strategy=strategy, device=device)
        print_serve_report(live)
        if serve_parity_key(sim) == serve_parity_key(live):
            print(f"  sim == live: OK ({len(live.records)} resizes, "
                  f"{live.completed} requests, every number identical)")
        else:
            bad += 1
            print(f"  sim == live: DISAGREE on {name!r}", file=sys.stderr)
    return bad


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--static", action="store_true",
                    help="single-shot batched greedy decode (needs --arch)")
    ap.add_argument("--arch", default="", help="model config (static mode only)")
    ap.add_argument("--full", action="store_true",
                    help="the arch's full config (default: its smoke config)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config's depth to this many layers")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--scenario", default="all",
                    help="serve trace name, or 'all' (elastic mode)")
    ap.add_argument("--executor", choices=("sim", "live", "both"),
                    default="both", help="elastic-mode executor(s)")
    ap.add_argument("--strategy", default=None,
                    help="spawn strategy override (elastic mode)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--profile", action="store_true",
                    help="then profile a warm run: device busy share, top kernels")
    args = ap.parse_args(argv)
    if not args.static:
        from repro_torch.malleability.policies import SERVE_SCENARIO_NAMES

        names = (SERVE_SCENARIO_NAMES if args.scenario == "all"
                 else (args.scenario,))
        return run_elastic(names, args.executor, args.strategy, args.device)
    if not args.arch:
        ap.error("--static requires --arch")
    if args.profile and args.device not in (None, "cuda"):
        ap.error("--profile measures the card: it runs on cuda only")
    return run_static(args)


if __name__ == "__main__":
    sys.exit(main())
