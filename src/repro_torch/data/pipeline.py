"""Synthetic token/embedding pipeline (a copy of :mod:`repro.data.pipeline`).

Deterministic per (seed, step), in numpy, bit-identical to the JAX
package's stream: the same tokens and labels, the ``embeds`` of
``embed_inputs`` configs and the ``(3, B, S)`` M-RoPE positions.  The JAX
module imports jax, so the port keeps its own copy.  ``to_device`` puts a
whole host batch on one device; ``make_batch_on_mesh`` keeps a rank's
shard of it, as JAX's ``device_put`` with the batch's shardings does.
"""
from __future__ import annotations

import math
import queue
import threading
from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch.models.common import ModelConfig
from repro_torch.parallel.sharding import ShardingContext, resolve_spec


@dataclass
class SyntheticTokens:
    """Zipf-ish synthetic LM stream with next-token labels."""

    cfg: ModelConfig
    batch: int
    seq: int
    seed: int = 0

    def sample(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        # Zipf-like marginal over the vocab (heavier head, realistic gather
        # locality for the embedding table).
        v = self.cfg.vocab
        ranks = rng.zipf(1.3, size=(self.batch, self.seq + 1)).astype(np.int64)
        tokens = np.minimum(ranks - 1, v - 1).astype(np.int32)
        out = {
            "labels": tokens[:, 1:],
        }
        if self.cfg.embed_inputs:
            erng = np.random.default_rng((self.seed << 21) ^ step)
            out["embeds"] = erng.standard_normal(
                (self.batch, self.seq, self.cfg.d_model), dtype=np.float32
            )
        else:
            out["tokens"] = tokens[:, :-1]
        if self.cfg.mrope_sections:
            pos = np.broadcast_to(
                np.arange(self.seq, dtype=np.int32), (self.batch, self.seq)
            )
            out["positions"] = np.stack([pos, pos, pos])
        return out

    def iter(self, start_step: int = 0, prefetch: int = 2) -> Iterator[dict]:
        """Background-thread prefetching iterator."""
        q: queue.Queue = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def worker():
            s = start_step
            while not stop.is_set():
                q.put(self.sample(s))
                s += 1

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()


def to_device(host_batch: dict, device) -> dict:
    """A host batch as tensors on ``device``, dtypes kept (int32 ids and
    positions, fp32 embeddings)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in host_batch.items()}


def batch_spec(cfg: ModelConfig, ctx: ShardingContext) -> tuple[dict, Callable]:
    """(field -> ndim, field -> logical axes) for the batch fields under
    the context's rules: ``positions`` (None, batch, seq) for M-RoPE,
    ``embeds`` (batch, seq, embed), the others (batch, seq)."""
    def spec_for(name: str, ndim: int):
        if name == "positions" and cfg.mrope_sections:
            axes = (None, "batch", "seq")
        elif name == "embeds":
            axes = ("batch", "seq", "embed")
        else:
            axes = ("batch", "seq")
        return axes[:ndim] if ndim else axes

    names = {"labels": 2}
    if cfg.embed_inputs:
        names["embeds"] = 3
    else:
        names["tokens"] = 2
    if cfg.mrope_sections:
        names["positions"] = 3
    return names, spec_for


def make_batch_on_mesh(host_batch: dict, cfg: ModelConfig, ctx: ShardingContext) -> dict:
    """This rank's shard of a host batch, on ``ctx.mesh.device``: each
    field resolved as an activation (``batch`` over the data axis in
    train mode) and cut at the rank's coordinates.  Every rank draws the
    same host batch from the seed, so the shards tile it as the JAX
    package's ``device_put`` does.  The port splits evenly only: a batch
    that the data shards do not divide raises (JAX pads an uneven split
    and replicates a batch smaller than the shards)."""
    _, spec_for = batch_spec(cfg, ctx)
    mesh = ctx.mesh
    B = host_batch["labels"].shape[0]
    shards = math.prod(mesh.axis_size(a) for a in ("pod", "data"))
    if B % shards:
        raise ValueError(f"a global batch of {B} does not split evenly over {shards} data shards")
    out = {}
    for k, v in host_batch.items():
        spec = resolve_spec(tuple(spec_for(k, v.ndim)), v.shape, ctx, "act")
        shard = np.ascontiguousarray(v[mesh.shard_slices(spec, v.shape)])
        out[k] = torch.from_numpy(shard).to(mesh.device)
    return out
