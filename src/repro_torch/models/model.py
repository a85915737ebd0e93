"""Model facade: init / loss / prefill / decode (ports :mod:`repro.models.model`).

Params are a flat dict of tensors under the JAX package's keys, so
:mod:`repro_torch.bridge` passes them 1:1 between the two packages.

Under a train-mode sharding context on a
:class:`~repro_torch.parallel.sharding.ProcessMesh`, a rank's batch is its
data shard, its params are in :func:`~repro_torch.models.layers.compute_spec`'s
layout, and with a model axis m > 1: the embedding table and the head are
split on the vocabulary, the lookup's partial rows are reduce-scattered
into the sequence-sharded residual, the logits are the rank's
vocabulary slice for the whole sequence, and ``loss`` is a
vocabulary-parallel cross entropy (the max, the sum of exponentials and
the picked logit all-reduced over 'model').  The loss is then summed
over 'data' and divided by the global count of labels, so every rank
returns the JAX package's global mean.  While a mesh train step runs,
the params are the rank's storage shards: ``embed`` and ``logits`` gather
the embedding table, the head and the final norm where they use them,
and each block's params are gathered in the layer loop
(:mod:`repro_torch.models.transformer`).  Where the model axis does not
divide the sequence, the residual stays whole over 'model' (the lookup's
partial rows all-reduced), as JAX's forward falls back there; the logits
and the loss keep the vocabulary-parallel layout.

Under a serving context (``decode`` or ``long`` mode, one token a step)
the token is whole over 'model': the lookup's partial rows are
all-reduced, and the vocabulary-parallel logits are all-gathered over
'model' so that every rank holds the whole row.  The cache is the rank's
shard of every leaf (:meth:`Model.cache_layouts`, ``init_cache``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import (ProcessMesh, current_context, resolve_spec,
                                           spec_axes, use_sharding)

from .common import ModelConfig, ParamBuilder, torch_dtype
from .layers import (_row_parallel_ctx, _seq_parallel, compute_params, init_rmsnorm,
                     kv_seq_axes, rmsnorm, whole_residual)
from .transformer import (KV_ENTRIES, decode_blocks, forward_blocks, init_blocks,
                          init_cache_shapes, local_layers)


def _build_params(cfg: ModelConfig, generator: Optional[torch.Generator],
                  cast: Optional[torch.dtype] = None) -> tuple[dict, dict]:
    b = ParamBuilder(generator, torch_dtype(cfg.param_dtype), cast)
    if not cfg.embed_inputs:
        b.add("embed/table", (cfg.vocab, cfg.d_model), ("vocab", "embed"),
              init="embed", scale=0.02)
    init_rmsnorm(b, "final_norm", cfg.d_model)
    if not cfg.tie_embeddings:
        b.add("head/w", (cfg.d_model, cfg.vocab), ("embed", "vocab"),
              init="normal")
    params, specs = b.build()
    bp, bs = init_blocks(generator, cfg, cast)
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
    def init(self, generator: torch.Generator,
             cast: Optional[torch.dtype] = None) -> tuple[dict, dict]:
        """Params drawn from ``generator`` (which must live on the model's
        device), in ``cfg.param_dtype``, and their logical axes.  With
        ``cast``, each param is cast to it as soon as it is drawn: the
        values of casting the drawn params, without holding the model in
        ``param_dtype`` (serving's bf16 copy of yi_34b, 68.8 GB, is drawn so
        on one card)."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on {self.device}")
        return _build_params(self.cfg, generator, cast)

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
        """(B, S, d) in the compute dtype; in train mode on a model axis
        m > 1 that splits the sequence, the rank's slice (B, S/m, d)."""
        cfg = self.cfg
        mesh, sp = _model_mesh(serving=True), _seq_parallel(_row_parallel_ctx())
        if cfg.embed_inputs:
            x = batch["embeds"].to(cfg.compute_dtype)
            return coll.take(x, mesh, "model", 1) if sp else x
        table, tokens = _read(params, "embed/table", cfg.compute_dtype), batch["tokens"]
        if mesh is None:
            return table[tokens].to(cfg.compute_dtype)
        if table.shape[0] == cfg.vocab:            # the table whole on every rank
            rows = table[tokens].to(cfg.compute_dtype)
            return coll.take(rows, mesh, "model", 1) if sp else rows
        # the rank's rows of the table: a token elsewhere gives a zero row,
        # so the sum over 'model' is the lookup, exactly
        lo = mesh.axis_index("model") * table.shape[0]
        local = tokens.long() - lo
        hit = (local >= 0) & (local < table.shape[0])
        rows = table[local.clamp(0, table.shape[0] - 1)].to(cfg.compute_dtype)
        rows = torch.where(hit[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                             device=rows.device))
        if sp:
            return coll.reduce_scatter(rows, mesh, "model", 1)
        return coll.all_reduce(rows, mesh, "model")

    def logits(self, params: dict, y: torch.Tensor) -> torch.Tensor:
        """(B, S, V) from the residual; in train mode on a model axis m > 1
        the rank's vocabulary slice (B, S, V/m) of the whole sequence (y,
        where it is the rank's sequence slice, is gathered first), in a
        serving mode the whole row (the rank's slice gathered over
        'model')."""
        mesh = _model_mesh()
        if mesh is not None:
            if _seq_parallel(_row_parallel_ctx()):
                y = coll.all_gather(y, mesh, "model", 1)
            return self._head(params, y)
        return self._whole_vocab(self._head(params, y), _model_mesh(serving=True))

    def _head(self, params: dict, y: torch.Tensor) -> torch.Tensor:
        """The final norm, the head (the rank's vocabulary slice on a
        model axis that splits it) and the final softcap."""
        cfg = self.cfg
        norm = compute_params({k: v for k, v in params.items() if k.startswith("final_norm/")},
                              "", cfg.compute_dtype)
        y = rmsnorm(norm, "final_norm", y, cfg.norm_eps)
        w = _read(params, "embed/table", cfg.compute_dtype).T if cfg.tie_embeddings else \
            _read(params, "head/w", cfg.compute_dtype)
        logits = (y @ w.to(cfg.compute_dtype)).to(torch_dtype(cfg.logit_dtype))
        if cfg.final_softcap > 0:
            logits = (cfg.final_softcap * torch.tanh(
                logits.float() / cfg.final_softcap)).to(logits.dtype)
        return logits

    def _whole_vocab(self, logits: torch.Tensor, mesh) -> torch.Tensor:
        """``logits`` whole over the vocabulary: gathered over 'model' where
        they are the rank's slice."""
        if mesh is None or logits.shape[-1] == self.cfg.vocab:
            return logits
        return coll.all_gather(logits, mesh, "model", 2)

    def forward(self, params: dict, batch: dict, collect_kv: bool = False, *,
                last: bool = False):
        """Logits (B,S,V) and, with ``collect_kv``, the prefill's cache
        contents: a dict keyed like ``init_cache`` (``forward_blocks``).
        With ``last``, the logits of the last position only (B,1,V), as a
        prefill returns them (the JAX package's prefill cell keeps
        ``logits[:, -1:]``): on a model axis the last position's row is
        gathered from each rank's slice, not the whole sequence, and its
        logits are whole over the vocabulary on every rank.

        In train mode on a model axis that does not divide S, the forward
        runs with the residual whole over 'model' (``whole_residual``), as
        JAX's falls back from its sequence-parallel projections there."""
        S = batch["embeds" if self.cfg.embed_inputs else "tokens"].shape[1]
        mesh = _model_mesh()
        if mesh is not None and S % mesh.axis_size("model"):
            with use_sharding(whole_residual(current_context())):
                return self._forward(params, batch, collect_kv, last)
        return self._forward(params, batch, collect_kv, last)

    def _forward(self, params: dict, batch: dict, collect_kv: bool, last: bool):
        mesh = _model_mesh()
        x = self.embed(params, batch)
        B, S = batch["embeds" if self.cfg.embed_inputs else "tokens"].shape[:2]
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
        y, caches = forward_blocks(params, self.cfg, x, positions, collect_kv)
        if not last:
            return self.logits(params, y), caches
        if mesh is None:
            return self.logits(params, y[:, -1:]), caches
        # each rank's last row (the last rank's is the prompt's) where the
        # sequence is split, its logits gathered whole over the vocabulary
        y = coll.all_gather(y[:, -1:], mesh, "model", 1) if _seq_parallel(
            _row_parallel_ctx()) else y
        return self._whole_vocab(self._head(params, y[:, -1:]), mesh), caches

    # ------------------------------------------------------------------ loss --
    def loss(self, params: dict, batch: dict) -> torch.Tensor:
        """Mean next-token cross entropy; labels < 0 are masked.  The logits
        are cast to fp32 for it; with ``cfg.loss_chunk`` dividing S, the sum
        runs over sequence chunks of that length, in order, as the JAX
        package's scan does (else over the whole sequence).

        Under a sharding context the logits are the rank's vocabulary
        slice on a model axis above 1 (the max, the sum of exponentials
        and the picked logit all-reduced over 'model'), and the sum and
        the count of the rank's data shard are summed over 'data': every
        rank returns the global mean."""
        cfg = self.cfg
        logits, _ = self.forward(params, batch)
        labels = batch["labels"].long()
        mask = (labels >= 0).float()
        labels = labels.clamp_min(0)
        ctx = current_context()
        mesh = None if ctx is None else ctx.mesh
        split = _model_mesh() is not None and logits.shape[-1] < cfg.vocab

        def xent(lg, lb, mk):
            lg = lg.float()
            if split:
                lse, picked = _vocab_parallel_terms(lg, lb, mesh)
            else:
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
        if mesh is not None:
            tot = coll.all_reduce(tot, mesh, "data")
            cnt = coll.sum_over(cnt, mesh, ["data"])
        return tot / torch.clamp(cnt, min=1.0)

    # ---------------------------------------------------------------- decode --
    def init_cache(self, batch: int, max_len: int) -> dict:
        """The decode cache for ``batch`` sequences of up to ``max_len``
        tokens; under a serving context on a
        :class:`~repro_torch.parallel.sharding.ProcessMesh`, this rank's
        shard of every leaf (:meth:`cache_layouts`)."""
        shapes = init_cache_shapes(self.cfg, batch, max_len)
        ctx = current_context()
        specs = None
        if ctx is not None and isinstance(ctx.mesh, ProcessMesh) and ctx.mode != "train":
            specs = self.cache_layouts(batch, max_len, ctx)
        out = {}
        for name, (shape, dt, _axes, fill) in shapes.items():
            if specs is not None:
                shape = ctx.mesh.shard_shape(specs[name], shape)
            out[name] = torch.full(shape, fill, dtype=torch_dtype(dt), device=self.device)
        return out

    def cache_layouts(self, batch: int, max_len: int, ctx) -> dict:
        """Each cache leaf's spec under a serving context (``decode`` or
        ``long`` mode): ``resolve_spec`` of its logical axes at its global
        shape, as the JAX package's ``cache_shardings``.  A batch smaller
        than its rule's axes is whole (JAX's ``_fit_axes``): the ranks of
        the axes it leaves hold and compute the same rows.  Raises where an
        attention cache's sequence does not split over every axis of
        ``kv_seq`` the batch's rule leaves (a cache shorter than those
        axes), which the serving path reads."""
        out = {}
        for name, (shape, _dt, axes, _f) in init_cache_shapes(self.cfg, batch,
                                                               max_len).items():
            spec = resolve_spec(tuple(axes), tuple(shape), ctx, "act")
            got = dict(zip(axes, (spec_axes(e) for e in spec)))
            if "kv_seq" in got and got["kv_seq"] != kv_seq_axes(ctx):
                raise ValueError(
                    f"cache leaf {name} {tuple(shape)} on {ctx.mesh.axis_sizes()} in "
                    f"{ctx.mode!r} mode: its kv_seq dimension resolves to {got['kv_seq']}, "
                    f"the serving path needs {kv_seq_axes(ctx)} (a dimension smaller than "
                    "its axes is kept whole by the rules)")
            out[name] = spec
        return out

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


def _read(params: dict, name: str, dtype) -> torch.Tensor:
    """One param as the layers read it (:func:`~repro_torch.models.layers.compute_params`)."""
    return compute_params({name: params[name]}, "", dtype)[name]


def _model_mesh(serving: bool = False):
    """The current context's mesh when it has a model axis above 1 and the
    mode is train (the vocabulary-parallel logits and loss) or, with
    ``serving``, any mode; else None."""
    rp = _row_parallel_ctx()
    if rp is None or not (serving or rp[0].mode == "train"):
        return None
    return rp[0].mesh


def _vocab_parallel_terms(lg: torch.Tensor, lb: torch.Tensor, mesh):
    """(logsumexp, picked logit) per token over the whole vocabulary, from
    this rank's fp32 logits slice lg (..., V/m) and the labels lb: the
    max (no gradient), the sum of exponentials and the picked logit (0
    from every rank whose slice lacks the label) are all-reduced over
    'model'."""
    n = lg.shape[-1]
    mx = coll.all_reduce(lg.detach().amax(dim=-1), mesh, "model", op="max")
    se = coll.all_reduce(torch.exp(lg - mx[..., None]).sum(dim=-1), mesh, "model")
    local = lb - mesh.axis_index("model") * n
    hit = (local >= 0) & (local < n)
    mine = torch.gather(lg, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    picked = coll.all_reduce(torch.where(hit, mine, torch.zeros_like(mine)), mesh, "model")
    return torch.log(se) + mx, picked
