"""Training entry point: ``python -m repro_torch.launch.train --arch <id> [...]``.

Ports ``repro.launch.train``: ``SyntheticTokens`` (seed 0) through
``build_train_step`` (loss and grads by autograd, then AdamW), params
from seed 0, with ``CheckpointManager`` when ``--checkpoint-dir`` is
given.  ``--scenario <name>`` runs the elastic loop
(:class:`repro_torch.elastic.ElasticTrainer`) against a registered
scenario and prints the JAX driver's ``reconfig`` and ``scenario`` lines;
their ``est`` and ``downtime`` are the cost model's modelled cluster
times, not card times (the slots of the pool are logical, all on one
card).  On the card, attention, the SSD scan and the mLSTM scan run
forward and backward in the hand-written CUDA kernels
(``repro_torch.kernels``), so every family trains there: dense (gemma2
at its head dim of 256 too), moe, hybrid (zamba2) and xLSTM.

    python -m repro_torch.launch.train --arch stablelm_3b --full-config \\
        --steps 4 --batch 8 --seq 512
    python -m repro_torch.launch.train --arch stablelm_3b --full-config \\
        --scenario steady-cycle --batch 8 --seq 512
    python -m repro_torch.launch.train --arch zamba2_1p2b --full-config \\
        --steps 4 --batch 8 --seq 512
    python -m repro_torch.launch.train --arch phi35_moe_42b --full-config \\
        --layers 2 --steps 4 --batch 8 --seq 512
    python -m repro_torch.launch.train --arch gemma2_9b --full-config \\
        --layers 4 --steps 4 --batch 1 --seq 8192
    python -m repro_torch.launch.train --device cpu --arch xlstm_125m \\
        --scenario steady-cycle --batch 8 --seq 32
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch stablelm_3b \\
        --full-config --layers 8 --model-parallel 2
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch zamba2_1p2b \\
        --full-config --layers 6 --model-parallel 2

Under ``torchrun`` (a world of more than one rank) or with
``--model-parallel`` above 1 the step runs on a (world / N, N) mesh of
the ranks (``repro_torch.launch.mesh.make_host_mesh``), one process per
rank: the state sharded over it, the batch over 'data', the layers
tensor, sequence and expert parallel over 'model'
(``repro_torch.train.steps``).  Rank 0 prints the lines; the backend
(NCCL with a card per rank, gloo where ranks share one or run on the
CPU) is printed once.  ``--checkpoint-dir`` gathers the full params to
rank 0, which writes the store's layout.  Every family trains on any
``--model-parallel`` that divides the world (the hybrid and xLSTM blocks
tensor parallel over their heads); where it does not divide the
sequence, the residual stays whole over 'model', as in JAX.

``--layers`` cuts the config's depth (phi3.5-MoE's fp32 masters and
AdamW state take ~16 GB a layer; gemma2's embedding and head alone 29
GB).  Runs on ``cuda`` unless ``--device cpu`` is given.
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
from repro_torch.data import SyntheticTokens, make_batch_on_mesh, to_device
from repro_torch.device import DeviceLike, card_label, resolve_device
from repro_torch.launch.mesh import env_world, init_distributed, make_host_mesh
from repro_torch.models import Model
from repro_torch.models.common import ModelConfig
from repro_torch.parallel.sharding import ShardingContext
from repro_torch.train import (ParamLayout, TrainState, build_init_fn, build_train_step,
                               gather_params, param_layout)


@dataclass
class StepRecord:
    step: int
    loss: float
    grad_norm: float
    seconds: float   # host clock of the step, ended by a device sync


def refusal(args: argparse.Namespace) -> Optional[str]:
    """Why this run cannot go ahead, or None; decided before any weight is
    drawn or any process group joined."""
    _, world, _ = env_world()
    if getattr(args, "scenario", None):
        if world > 1:
            return ("--scenario runs the elastic loop in one process (its slots are "
                    "logical); run it without torchrun")
        return None
    if world % args.model_parallel:
        return (f"--model-parallel {args.model_parallel} needs a world of ranks it divides "
                f"(this one has {world}): run under torchrun --nproc-per-node <n>")
    return None


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
          log: Callable[[str], None] = print,
          place: Optional[Callable[[dict], dict]] = None) -> tuple[TrainState, list[StepRecord]]:
    """``steps`` steps over ``batches`` (host batches, each put on the
    model's device, or through ``place``: a rank's shard); logs JAX's
    ``step {i} loss ...`` lines at every 10th and the last step."""
    records = []
    t0 = time.perf_counter()
    for i, host_batch in enumerate(batches):
        if i >= steps:
            break
        ts = time.perf_counter()
        batch = place(host_batch) if place else to_device(host_batch, model.device)
        state, metrics = step_fn(state, batch)
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
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config's depth to this many layers")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="size of the mesh's model axis; the ranks come from torchrun "
                         "(torchrun --nproc-per-node <world> -m repro_torch.launch.train "
                         "...), the data axis is world / N")
    ap.add_argument("--scenario", default=None,
                    help="run the elastic loop against a registered scenario "
                         "(see repro_torch.malleability.registered_scenarios)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = arch_config(args.arch) if args.full_config else smoke_config(args.arch)
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    why = refusal(args)
    if why:
        print(why, file=sys.stderr)
        return 2
    if not args.scenario and (env_world()[1] > 1 or args.model_parallel > 1):
        return run_on_mesh(cfg, args)
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


class MeshCheckpoint:
    """``CheckpointManager``'s ``save``/``wait`` for the ranks of a mesh:
    every rank gathers the full params (a collective), rank 0 writes them
    in the store's layout."""

    def __init__(self, manager: Optional[CheckpointManager], layout: ParamLayout):
        self.manager, self.layout = manager, layout

    def save(self, tree: dict, step: int) -> None:
        full = {"params": gather_params(tree["params"], self.layout)}
        if self.manager is not None:
            self.manager.save(full, step)

    def wait(self) -> None:
        if self.manager is not None:
            self.manager.wait()


def run_on_mesh(cfg: ModelConfig, args: argparse.Namespace) -> int:
    """This rank's part of a mesh run (``repro.launch.train.main`` on
    ``make_host_mesh``): params from seed 0, each rank its storage shards
    and its data shard of ``SyntheticTokens``; rank 0 prints."""
    import torch.distributed as dist

    dev, backend, why = init_distributed(args.device)
    try:
        mesh = make_host_mesh(args.model_parallel, device=dev)
        ctx = ShardingContext(mesh=mesh, mode="train")
        model = Model(cfg, dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        state = build_init_fn(model, ctx)(gen)
        step_fn = build_train_step(model, ctx, lr=args.lr)
        first = mesh.rank == 0
        log = (lambda line: print(line, flush=True)) if first else (lambda line: None)
        n_params = sum(math.prod(s.shape) for s in model.abstract_params()[0].values())
        log(f"arch={cfg.name} params={n_params / 1e9:.3f}B batch={args.batch} seq={args.seq} "
            f"mesh data {mesh.shape[0]} x model {mesh.shape[1]}, backend {backend} ({why}); "
            f"rank 0 on {card_label(dev)}")
        ckpt = None
        if args.checkpoint_dir:
            ckpt = MeshCheckpoint(CheckpointManager(args.checkpoint_dir) if first else None,
                                  param_layout(model, ctx))
        data = SyntheticTokens(cfg, args.batch, args.seq)
        state, records = train(model, state, step_fn, data.iter(), args.steps, ckpt=ckpt,
                               checkpoint_every=args.checkpoint_every, log=log,
                               place=lambda b: make_batch_on_mesh(b, cfg, ctx))
        if dev.type == "cuda" and len(records) > 1:
            step_s = statistics.median(r.seconds for r in records[1:])
            log(f"step time {step_s * 1e3:.1f} ms (median of steps 1..{len(records) - 1}), "
                f"{args.batch * args.seq / step_s:.0f} tokens/s on {mesh.size} ranks")
            print(f"rank {mesh.rank}: peak memory "
                  f"{torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB on {card_label(dev)}",
                  flush=True)
        if not all(math.isfinite(r.loss) and math.isfinite(r.grad_norm) for r in records):
            print(f"rank {mesh.rank}: non-finite loss or grads", file=sys.stderr)
            return 1
        return 0
    finally:
        dist.destroy_process_group()


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
