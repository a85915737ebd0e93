"""Training entry point: ``python -m repro_torch.launch.train --arch <id> [...]``.

Ports ``repro.launch.train``: ``SyntheticTokens`` (seed 0) through
``build_train_step`` (loss and grads by autograd, then AdamW), params
from seed 0, with ``CheckpointManager`` when ``--checkpoint-dir`` is
given.  ``--scenario <name>`` runs the elastic loop
(:class:`repro_torch.elastic.ElasticTrainer`) against a registered
scenario and prints the JAX driver's ``reconfig`` and ``scenario`` lines;
their ``est`` and ``downtime`` are the cost model's modelled cluster
times, not card times (the slots of the pool are logical, all on one
card).  Attention runs forward and backward in the hand-written CUDA
kernels on the card (``repro_torch.kernels``).

    python -m repro_torch.launch.train --arch stablelm_3b --full-config \\
        --steps 4 --batch 8 --seq 512
    python -m repro_torch.launch.train --arch stablelm_3b --full-config \\
        --scenario steady-cycle --batch 8 --seq 512
    python -m repro_torch.launch.train --device cpu --arch stablelm_3b \\
        --scenario steady-cycle --batch 8 --seq 32

Runs on ``cuda`` unless ``--device cpu`` is given.  What is not ported
yet exits 2 and names its ROADMAP.md item: ``--model-parallel`` above 1
(A16), the ``moe`` family (A12), and the ``hybrid`` and ``ssm`` families,
whose kernels have no backward yet (A18).
"""
from __future__ import annotations

import argparse
import math
import statistics
import sys
import time
from dataclasses import dataclass
from typing import Callable, Iterable, Optional, Sequence

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import arch_config, smoke_config
from repro_torch.data import SyntheticTokens, to_device
from repro_torch.device import DeviceLike, card_label, resolve_device
from repro_torch.models import Model
from repro_torch.models.common import ModelConfig
from repro_torch.train import TrainState, build_init_fn, build_train_step

NOT_PORTED = {
    "model_parallel": "--model-parallel > 1 is not ported yet: ROADMAP.md A16",
    "moe": "the moe family is not ported yet: ROADMAP.md A12",
    "hybrid": "training the hybrid family needs an SSD backward kernel, not written "
              "yet: ROADMAP.md A18",
    "ssm": "training the xLSTM family needs an mLSTM backward kernel, not written "
           "yet: ROADMAP.md A18",
}


@dataclass
class StepRecord:
    step: int
    loss: float
    grad_norm: float
    seconds: float   # host clock of the step, ended by a device sync


def refusal(cfg: ModelConfig, args: argparse.Namespace) -> Optional[str]:
    """Why this run is not ported yet, or None."""
    if args.model_parallel > 1:
        return NOT_PORTED["model_parallel"]
    return NOT_PORTED.get(cfg.family)


def build(cfg: ModelConfig, *, device: DeviceLike = None, lr: float = 3e-4,
          seed: int = 0) -> tuple[Model, TrainState, Callable]:
    """(model, initial state with params drawn from ``seed`` on the
    device, step function)."""
    model = Model(cfg, device)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    state = build_init_fn(model)(gen)
    return model, state, build_train_step(model, lr=lr)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(model: Model, state: TrainState, step_fn: Callable, batches: Iterable[dict],
          steps: int, *, ckpt: Optional[CheckpointManager] = None, checkpoint_every: int = 50,
          log: Callable[[str], None] = print) -> tuple[TrainState, list[StepRecord]]:
    """``steps`` steps over ``batches`` (host batches); logs JAX's
    ``step {i} loss ...`` lines at every 10th and the last step."""
    records = []
    t0 = time.perf_counter()
    for i, host_batch in enumerate(batches):
        if i >= steps:
            break
        ts = time.perf_counter()
        state, metrics = step_fn(state, to_device(host_batch, model.device))
        _sync(model.device)
        records.append(StepRecord(i, float(metrics["loss"]), float(metrics["grad_norm"]),
                                  time.perf_counter() - ts))
        if i % 10 == 0 or i == steps - 1:
            log(f"step {i:>5} loss {records[-1].loss:.4f} ({(time.perf_counter() - t0):.1f}s)")
        if ckpt and (i + 1) % checkpoint_every == 0:
            ckpt.save({"params": state.params}, i + 1)
    if ckpt:
        ckpt.wait()
    return state, records


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--full-config", action="store_true",
                    help="use the full arch config (production scale)")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--scenario", default=None,
                    help="run the elastic loop against a registered scenario "
                         "(see repro_torch.malleability.registered_scenarios)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = arch_config(args.arch) if args.full_config else smoke_config(args.arch)
    why = refusal(cfg, args)
    if why:
        print(why, file=sys.stderr)
        return 2
    dev = resolve_device(args.device)
    if args.scenario:
        return run_scenario(Model(cfg, dev), args)
    model, state, step_fn = build(cfg, device=dev, lr=args.lr)
    n_params = sum(p.numel() for p in state.params.values())
    print(f"arch={cfg.name} params={n_params / 1e9:.3f}B batch={args.batch} seq={args.seq} "
          f"on {card_label(dev)}", flush=True)
    ckpt = CheckpointManager(args.checkpoint_dir) if args.checkpoint_dir else None
    data = SyntheticTokens(cfg, args.batch, args.seq)
    state, records = train(model, state, step_fn, data.iter(), args.steps, ckpt=ckpt,
                           checkpoint_every=args.checkpoint_every,
                           log=lambda line: print(line, flush=True))
    if dev.type == "cuda" and len(records) > 1:
        step_s = statistics.median(r.seconds for r in records[1:])
        print(f"step time {step_s * 1e3:.1f} ms (median of steps 1..{len(records) - 1}), "
              f"{args.batch * args.seq / step_s:.0f} tokens/s, peak memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB on {card_label(dev)}")
    if not all(math.isfinite(r.loss) and math.isfinite(r.grad_norm) for r in records):
        print("non-finite loss or grads", file=sys.stderr)
        return 1
    return 0


def run_scenario(model: Model, args: argparse.Namespace) -> int:
    """Malleable training: the declarative trace drives the live runtime
    (``repro.launch.train.run_scenario``'s lines, the modelled costs
    labelled as such; on the card also its step and reconfiguration
    times)."""
    from repro_torch.elastic import ElasticTrainer
    from repro_torch.malleability import get_scenario

    dev = model.device
    scenario = get_scenario(args.scenario)
    trainer = ElasticTrainer.from_scenario(
        model, scenario, lr=args.lr, batch=args.batch, seq=args.seq,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
    )
    steps = max(args.steps, scenario.steps)
    t0 = time.perf_counter()
    hist = trainer.run(steps)
    for rec in trainer.runtime.history:
        print(f"reconfig {rec.kind:<10} {rec.mechanism:<22} "
              f"{rec.nodes_before}->{rec.nodes_after} nodes  "
              f"est {rec.est_wall_s*1e3:.2f} ms  downtime {rec.downtime_s*1e3:.2f} ms "
              f"(modelled, {scenario.profile} cluster)", flush=True)
    print(f"scenario {scenario.name!r}: {len(hist)} steps, "
          f"loss {hist[0].loss:.4f} -> {hist[-1].loss:.4f} "
          f"({time.perf_counter()-t0:.1f}s, {len(trainer.runtime.history)} reconfigs)",
          flush=True)
    if dev.type == "cuda":
        label = card_label(dev)
        for nodes in sorted({r.n_nodes for r in hist}):
            times = [r.seconds for r in hist[1:] if r.n_nodes == nodes]
            if times:
                print(f"step time at {nodes} nodes {statistics.median(times) * 1e3:.1f} ms "
                      f"(median of {len(times)}) on {label}")
        for w in trainer.wall_log:
            print(f"reconfig at step {w['step']} ({'+'.join(w['kinds'])}): host wall "
                  f"{w['host_s'] * 1e3:.2f} ms, {w['bytes_read']} bytes read back on {label}")
        print(f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB on {label}")
    if not all(math.isfinite(r.loss) for r in hist):
        print("non-finite loss", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
