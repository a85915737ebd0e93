"""Dry run: one rank's step of every (arch x shape x mesh) cell, on fake
ranks and abstract tensors.

The counterpart of :mod:`repro.launch.dryrun`, which lowers and compiles
each cell for 512 forced host devices and reads XLA's analyses.  The
port has no compiler; it runs its own step, the same model code as a
real mesh step, as rank ``rank`` of the production mesh
(:func:`repro_torch.launch.mesh.make_production_mesh`: (16, 16) or
(2, 16, 16) ranks of ``torch.distributed``'s ``fake`` backend, whose
collectives move nothing), on FakeTensors (``FakeTensorMode``: shapes
and dtypes, nothing allocated on any device; the hand-written kernels
take their abstract case, :mod:`repro_torch.kernels.abstract`), under a
:class:`~repro_torch.launch.graph_analysis.Recorder`.  For each cell:

1. the rank's arguments, abstract: its storage shards of the params
   (``param_layout``), with AdamW's state for a train cell, or of the
   serving params (``serving_param_shapes``: the compute dtype) with its
   shard of the cache (``cache_layouts``) for a decode cell, and its
   shard of the cell's inputs (``launch.specs.input_specs``);
2. the step: train ``loss_and_grads`` + ``adamw_update``
   (``build_train_step``); prefill ``Model.forward(collect_kv=True)``
   in train mode and the JAX cell's ``logits[:, -1:]`` and caches (the
   logits of the whole prompt are computed, as XLA computes them there;
   ``repro_torch.train.build_prefill_step`` forms the last position's
   alone); decode and long ``build_serve_step`` at the last position of
   the cache (``cache_pos`` = seq_len - 1: every row admitted, the whole
   product that JAX's masked einsum counts);
3. a record with the JAX record's keys.

Keys that differ in meaning from the JAX record:

* ``per_device.argument_bytes``: the bytes of the rank's argument
  shards that the step reads (``cache_pos``, a host int in the port,
  counted as JAX's int32 scalar; a prefill's labels left out, as ``jit``
  drops an unused argument); ``output_bytes``: the step's outputs (the port's train step
  also returns the grad norm, and its decode logits are whole over the
  vocabulary on every rank, where JAX's stay split over 'model'); ``alias_bytes``: the outputs written in place into the
  arguments (the train state, the cache), where JAX counts donated
  buffers; ``temp_bytes``: the peak of the storages the step creates
  and holds at once, less the outputs it creates (weak references,
  rounded to the CUDA allocator's 512-byte blocks), so that
  ``peak_hbm_est`` = argument + output + temp - alias is the arguments
  plus that peak, a prediction of ``torch.cuda.max_memory_allocated``
  over the step;
* ``flops`` and ``flops_deep`` are both the recorder's count (matmuls
  plus the kernels' abstract records), where JAX keeps the larger of its
  while-aware dot count and XLA's raw count; ``dot_bytes`` the matmuls'
  operands and results;
* ``collectives`` are the mesh's own counts in JAX's schema
  (:func:`repro_torch.launch.graph_analysis.collectives`), with
  ``per_op_axis`` beside them;
* ``trace_s`` (the wall time of the step on abstract tensors) takes the
  place of ``lower_s`` and ``compile_s``; ``kernel_launches`` counts
  the launches the card would make, by kernel counter;
* ``hw`` is the NVIDIA H100 SXM data-sheet profile the port carries
  (``repro_torch.malleability.throughput``), data-sheet values, not
  measurements, where JAX's is a TPU v5e's.

Every number of a record is a prediction for one rank.  No device is
needed: nothing is allocated.

Usage:
  python -m repro_torch.launch.dryrun --arch stablelm_3b --shape train_4k --mesh single
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

HW = {
    "source": "NVIDIA H100 SXM data sheet (one card); data-sheet values, not measurements",
    "peak_flops_bf16": 989e12,
    "hbm_bw": 3.35e12,
    "ici_bw": 450e9,
    "hbm_bytes": 80e9,
}


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def _leaves(tree) -> list:
    """The tensors of a nested dict / tuple / list (a host int is none)."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _leaves(v)]
    return [tree] if hasattr(tree, "untyped_storage") else []


def run_config(cfg, shape, mesh_shape: tuple, axis_names: tuple, rank: int = 0) -> dict:
    """The record of one cell: ``cfg`` (a ModelConfig) at ``shape`` (a
    ``ShapeCell``: its kind, global batch and sequence length) on rank
    ``rank`` of a fake mesh of ``mesh_shape`` on ``axis_names``.  The keys
    ``arch``, ``shape`` and ``mesh`` are the caller's to add."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_fake_mesh

    mesh = make_fake_mesh(tuple(mesh_shape), tuple(axis_names), rank)
    try:
        return _run(cfg, shape, mesh)
    finally:   # the fake group is this process's default group: leave none behind
        dist.destroy_process_group()


def _run(cfg, shape, mesh) -> dict:
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.graph_analysis import Recorder, analyze
    from repro_torch.launch.specs import input_specs, sharding_mode
    from repro_torch.models import Model
    from repro_torch.optim import adamw_init
    from repro_torch.parallel.sharding import ShardingContext, resolve_spec, use_sharding
    from repro_torch.train import (TrainState, batch_shardings, build_serve_step,
                                   build_train_step, param_layout, serving_param_shapes)

    ctx = ShardingContext(mesh=mesh, mode=sharding_mode(shape))
    model = Model(cfg, "cpu")
    layout = param_layout(model, ctx)
    specs = input_specs(cfg, shape)
    B, S = shape.global_batch, shape.seq_len
    with FakeTensorMode():
        if shape.kind == "train":
            shapes = model.abstract_params()[0]
            in_specs = batch_shardings(cfg, ctx, B, S)
        else:
            shapes = serving_param_shapes(model)[0]
            in_specs = {}
            for name, t in specs.items():
                if name == "cache_pos":
                    continue
                axes = {"positions": (None, "batch", "seq") if t.dim() == 3 else ("batch", "seq"),
                        "embeds": ("batch", "seq", "embed")}.get(name, ("batch", "seq"))
                in_specs[name] = resolve_spec(axes, tuple(t.shape), ctx, "act")
        params = {k: torch.empty(mesh.shard_shape(layout.storage[k], s.shape), dtype=s.dtype)
                  for k, s in shapes.items()}
        # a prefill reads no labels (jit drops an unused argument as well)
        unused = ("cache_pos", "labels") if shape.kind == "prefill" else ("cache_pos",)
        inputs = {k: torch.empty(mesh.shard_shape(in_specs[k], tuple(t.shape)), dtype=t.dtype)
                  for k, t in specs.items() if k not in unused}
        arg_bytes = _nbytes(params) + _nbytes(inputs)
        if shape.kind == "train":
            params = {k: p.requires_grad_(p.is_floating_point()) for k, p in params.items()}
            state = TrainState(params=params, opt=adamw_init(params),
                               step=torch.zeros((), dtype=torch.int32))
            args = (state, inputs)
            arg_bytes += _nbytes(state.opt) + _nbytes(state.step)
            run = build_train_step(model, ctx)
        elif shape.kind == "prefill":
            args = (params, inputs)
            pre_ctx = dataclasses.replace(ctx, layout=layout)

            def run(params, batch):
                with torch.no_grad(), use_sharding(pre_ctx):
                    logits, caches = model.forward(params, batch, collect_kv=True)
                    return logits[:, -1:], caches
        else:
            with use_sharding(ctx):
                cache = model.init_cache(B, S)
            arg_bytes += _nbytes(cache) + 4          # cache_pos: an int32 scalar in JAX
            args = (params, cache, dict(inputs, cache_pos=S - 1))
            serve = build_serve_step(model, ctx)

            def run(params, cache, tok):
                with torch.no_grad():
                    return serve(params, cache, tok)

        rec = Recorder()
        rec.known(_leaves(args))
        mesh.comm_bytes.clear()
        mesh.comm_calls.clear()
        t0 = time.perf_counter()
        with rec:
            out = run(*args)
        trace_s = time.perf_counter() - t0
        out_bytes = _nbytes(_leaves(out))
        if shape.kind == "train":
            alias = _nbytes(out[0])                    # the state, updated in place
        elif shape.kind == "prefill":
            alias = 0
        else:
            alias = _nbytes(out[1])                    # the cache, written in place
        created = out_bytes - alias
        temp = max(rec.peak_bytes - created, 0)
    deep = analyze(rec, mesh)
    return {
        "status": "ok",
        "n_chips": mesh.size,
        "rank": mesh.rank,
        "mesh_shape": list(mesh.shape),
        "mode": ctx.mode,
        "trace_s": round(trace_s, 2),
        "per_device": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": temp,
            "alias_bytes": alias,
            "peak_hbm_est": arg_bytes + out_bytes + temp - alias,
            "flops": deep["flops"],
            "flops_deep": deep["flops"],
            "dot_bytes": deep["dot_bytes"],
        },
        "kernel_launches": dict(sorted(rec.kernel_launches.items())),
        "kernel_flops": dict(sorted(rec.kernel_flops.items())),
        "collectives": deep["collectives"],
        "hw": HW,
    }


def run_cell(arch: str, shape_name: str, mesh_kind: str, rank: int = 0) -> dict:
    """The record of one production cell, as the JAX package's
    ``run_cell``: skipped cells carry ``shape_skip_reason``."""
    from repro_torch.configs import SHAPES, arch_config, shape_skip_reason

    shape = next(s for s in SHAPES if s.name == shape_name)
    head = {"arch": arch, "shape": shape_name, "mesh": mesh_kind}
    skip = shape_skip_reason(arch, shape)
    if skip:
        return dict(head, status="skipped", reason=skip)
    if mesh_kind == "multi":
        mesh_shape, axes = (2, 16, 16), ("pod", "data", "model")
    else:
        mesh_shape, axes = (16, 16), ("data", "model")
    return dict(head, **run_config(arch_config(arch), shape, mesh_shape, axes, rank))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str)
    ap.add_argument("--shape", type=str)
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args()
    import torch

    torch.set_num_threads(1)   # abstract tensors compute nothing: threads only contend

    try:
        rec = run_cell(args.arch, args.shape, args.mesh, args.rank)
    except Exception as e:  # a failed cell is a fault in the port: report it
        rec = {
            "arch": args.arch, "shape": args.shape, "mesh": args.mesh,
            "status": "error", "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-4000:],
        }
    js = json.dumps(rec, indent=2)
    print(js)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(js)
    sys.exit(0 if rec.get("status") in ("ok", "skipped") else 1)


if __name__ == "__main__":
    main()
