"""Model facade: init / loss / prefill / decode (ports :mod:`repro.models.model`).

Params are a flat dict of tensors under the JAX package's keys, so
:mod:`repro_torch.bridge` passes them 1:1 between the two packages.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import DeviceLike, resolve_device

from .common import ModelConfig, ParamBuilder, torch_dtype
from .layers import init_rmsnorm, rmsnorm
from .transformer import (KV_ENTRIES, decode_blocks, forward_blocks, init_blocks,
                          init_cache_shapes, local_layers)


def _build_params(cfg: ModelConfig, generator: Optional[torch.Generator]) -> tuple[dict, dict]:
    b = ParamBuilder(generator, torch_dtype(cfg.param_dtype))
    if not cfg.embed_inputs:
        b.add("embed/table", (cfg.vocab, cfg.d_model), ("vocab", "embed"),
              init="embed", scale=0.02)
    init_rmsnorm(b, "final_norm", cfg.d_model)
    if not cfg.tie_embeddings:
        b.add("head/w", (cfg.d_model, cfg.vocab), ("embed", "vocab"),
              init="normal")
    params, specs = b.build()
    bp, bs = init_blocks(generator, cfg)
    params.update(bp)
    specs.update(bs)
    return params, specs


def abstract_params(cfg: ModelConfig) -> tuple[dict, dict]:
    """Shape-only params (:class:`~repro_torch.models.common.ParamShape`,
    nothing allocated, no device needed) + logical specs, for every
    family: the JAX package's ``Model.abstract_params``."""
    return _build_params(cfg, None)


class Model:
    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)

    # ---------------------------------------------------------------- init --
    def init(self, generator: torch.Generator) -> tuple[dict, dict]:
        """Params drawn from ``generator`` (which must live on the model's
        device), in ``cfg.param_dtype``, and their logical axes."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on {self.device}")
        return _build_params(self.cfg, generator)

    def abstract_params(self) -> tuple[dict, dict]:
        """Shape-only params + logical specs (:func:`abstract_params`)."""
        return abstract_params(self.cfg)

    def serving_params(self, params: dict) -> dict:
        """Floating params cast once to the compute dtype: serving keeps no
        fp32 master copy (``repro.train.steps.serving_param_shapes``)."""
        dt = self.cfg.compute_dtype
        return {k: (v.to(dt) if v.is_floating_point() else v) for k, v in params.items()}

    # -------------------------------------------------------------- forward --
    def embed(self, params: dict, batch: dict) -> torch.Tensor:
        cfg = self.cfg
        if cfg.embed_inputs:
            return batch["embeds"].to(cfg.compute_dtype)
        return params["embed/table"][batch["tokens"]].to(cfg.compute_dtype)

    def logits(self, params: dict, y: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        y = rmsnorm(params, "final_norm", y, cfg.norm_eps)
        w = params["embed/table"].T if cfg.tie_embeddings else params["head/w"]
        logits = (y @ w.to(cfg.compute_dtype)).to(torch_dtype(cfg.logit_dtype))
        if cfg.final_softcap > 0:
            logits = (cfg.final_softcap * torch.tanh(
                logits.float() / cfg.final_softcap)).to(logits.dtype)
        return logits

    def forward(self, params: dict, batch: dict, collect_kv: bool = False):
        """Logits (B,S,V) and, with ``collect_kv``, the prefill's cache
        contents: a dict keyed like ``init_cache`` (``forward_blocks``)."""
        x = self.embed(params, batch)
        positions = batch.get("positions")
        if positions is None:
            B, S = x.shape[:2]
            positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
        y, caches = forward_blocks(params, self.cfg, x, positions, collect_kv)
        return self.logits(params, y), caches

    # ------------------------------------------------------------------ loss --
    def loss(self, params: dict, batch: dict) -> torch.Tensor:
        """Mean next-token cross entropy; labels < 0 are masked.  The logits
        are cast to fp32 for it; with ``cfg.loss_chunk`` dividing S, the sum
        runs over sequence chunks of that length, in order, as the JAX
        package's scan does (else over the whole sequence)."""
        cfg = self.cfg
        logits, _ = self.forward(params, batch)
        labels = batch["labels"].long()
        mask = (labels >= 0).float()
        labels = labels.clamp_min(0)

        def xent(lg, lb, mk):
            lg = lg.float()
            lse = torch.logsumexp(lg, dim=-1)
            picked = torch.gather(lg, -1, lb[..., None])[..., 0]
            return torch.sum((lse - picked) * mk), torch.sum(mk)

        S = logits.shape[1]
        if cfg.loss_chunk and S % cfg.loss_chunk == 0:
            tot = cnt = torch.zeros((), dtype=torch.float32, device=logits.device)
            for lo in range(0, S, cfg.loss_chunk):
                sl = slice(lo, lo + cfg.loss_chunk)
                ls, c = xent(logits[:, sl], labels[:, sl], mask[:, sl])
                tot, cnt = tot + ls, cnt + c
        else:
            tot, cnt = xent(logits, labels, mask)
        return tot / torch.clamp(cnt, min=1.0)

    # ---------------------------------------------------------------- decode --
    def init_cache(self, batch: int, max_len: int) -> dict:
        shapes = init_cache_shapes(self.cfg, batch, max_len)
        return {
            name: torch.full(shape, fill, dtype=torch_dtype(dt), device=self.device)
            for name, (shape, dt, _axes, fill) in shapes.items()
        }

    def decode_step(self, params: dict, cache: dict, batch: dict):
        """One token for every sequence.  batch: tokens/embeds (B,1),
        positions (B,1) or (3,B,1), cache_pos: a host int.  The cache is
        written in place and returned."""
        x = self.embed(params, batch)
        y, cache = decode_blocks(
            params, self.cfg, x, batch["positions"], cache, int(batch["cache_pos"])
        )
        return self.logits(params, y), cache

    def prefill(self, params: dict, cache: dict, batch: dict) -> torch.Tensor:
        """One forward pass over the prompt that fills ``cache`` as S decode
        steps would: attention (k, v) at positions 0..S-1 (in gemma2's
        window-sized rings, position p of the last ``window`` at slot
        p % window), recurrent states (hybrid ``ssm``, ``conv``; xLSTM
        ``mlstm_*``, ``slstm_*``) whole.  Returns the logits (B,S,V)."""
        logits, caches = self.forward(params, batch, collect_kv=True)
        if "k_loc" in cache:
            # forward_blocks collects every layer's (k, v): the local ones
            # go to the rings, the others to the global cache
            loc = local_layers(self.cfg)
            glob = [i for i in range(self.cfg.n_layers) if i not in loc]
            caches = {"k_loc": caches["k"][loc], "v_loc": caches["v"][loc],
                      "k": caches["k"][glob], "v": caches["v"][glob]}
        for name, val in caches.items():
            dst = cache[name]
            if name not in KV_ENTRIES:
                dst.copy_(val)   # a recurrent state, of the cache's own shape
                continue
            # (n, B, S, KV, hd) into the cache's (n, B, max_len or window, KV, hd)
            S, n = val.shape[2], dst.shape[2]
            if name.endswith("_loc") and S > n:
                slots = torch.arange(S - n, S, device=dst.device) % n
                dst[:, :, slots] = val[:, :, S - n:].to(dst.dtype)
            else:
                dst[:, :, :S] = val.to(dst.dtype)
        return logits
