"""Synthetic token/embedding pipeline (a copy of :mod:`repro.data.pipeline`).

Deterministic per (seed, step), in numpy, bit-identical to the JAX
package's stream: the same tokens and labels, the ``embeds`` of
``embed_inputs`` configs and the ``(3, B, S)`` M-RoPE positions.  The JAX
module imports jax, so the port keeps its own copy; ``to_device`` takes
the place of ``make_batch_on_mesh`` (nothing is sharded here).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from repro_torch.models.common import ModelConfig


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
