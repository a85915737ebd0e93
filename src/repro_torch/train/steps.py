"""Train step and init, and the serving steps (ports :mod:`repro.train.steps`).

``build_train_step`` returns ``step(state, batch) -> (state, metrics)``:
the loss and its grads by ``torch.autograd`` over the fp32 master params
(leaves that require grad), then ``adamw_update`` under
``torch.no_grad()``, as the JAX step runs ``jax.value_and_grad(model.loss)``
then ``adamw_update``.  The params, ``mu``, ``nu`` and the grads are
updated in place (see :mod:`repro_torch.optim.adamw`), so the returned
state holds the same tensors as the one passed in.

Without a sharding context one process holds and computes everything.
With one (a :class:`~repro_torch.parallel.sharding.ProcessMesh`, one
process per rank) the state is sharded as the JAX package's
``train_state_shardings`` gives it: each param and both AdamW moments
stored as ``resolve_spec(kind="weight")`` places them, the fallback pass
included (ZeRO-3 over 'data', tensor parallel over 'model').  The loss
runs on those storage shards, under a context that carries the step's
:class:`ParamLayout`, and the model gathers each param into the layout
the layers compute in (:func:`~repro_torch.models.layers.compute_spec`:
the rank's tensor-parallel slice, whole over 'data') where it uses it:
the embedding table in the embedding, the final norm and the head in the
logits, zamba2's shared block once before the layer loop, and each
block's (or xLSTM unit's) slice of the stacked params inside the
function the loop runs, so that under remat the recompute gathers it
again, as JAX's ``nothing_saveable`` scan body does
(:mod:`repro_torch.models.transformer`).  A rank then holds at most one
checkpointed unit's gathered weights at a time, besides the embedding,
the head, the final norm and the shared block; without remat autograd
saves every layer's gathered weights for the backward, as JAX's scan
saves its residuals.  A param is cast to the compute dtype just before
its gather where the forward reads it only in that dtype; autograd takes
each gather's transpose, so the grads come back reduce-scattered to the
storage shards, summed over the data shards into the gradient of JAX's
global mean (a stacked param's layer by layer into its gradient,
:meth:`ParamLayout.layer_slice`).  The reduce-scatters sum in fp32
whatever the compute dtype (the cotangent is cast back up before them,
``collectives.redistribute(..., dtype)``).  In bf16 each data shard's
gradient is still rounded to bf16 once by its own backward, where one
process rounds the whole batch's once, so a bf16 step on a data axis
above 1 differs from the single-process step by that rounding.  AdamW
then runs on the storage shards, clipped by the norm over all shards.

The serving steps (``serving_param_shapes``, ``cache_layouts``,
``abstract_cache``, ``build_serve_step``; the port's own
``build_prefill_step``, ``shard_params``, ``place_batch``) run the same
model on the same storage layout, in the ``decode`` or ``long`` mode of
the JAX package's rules, the params in the compute dtype and the cache
the rank's shard of every leaf.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.data.pipeline import batch_spec
from repro_torch.models import Model
from repro_torch.models.common import ModelConfig, ParamShape, torch_dtype
from repro_torch.models.layers import compute_spec
from repro_torch.models.transformer import KV_ENTRIES, init_cache_shapes, local_layers
from repro_torch.optim import AdamWState, adamw_init, adamw_update, global_norm
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import (ShardingContext, param_specs, resolve_spec,
                                           spec_axes, use_sharding)


class TrainState(NamedTuple):
    params: dict
    opt: AdamWState
    step: torch.Tensor   # () int32


class _LayerSlice(torch.autograd.Function):
    """Layer ``i``'s slice of a stacked param ``p``.  Its backward adds the
    slice's gradient into row ``i`` of ``grad`` at once and passes nothing
    on to ``p``: ``grad`` is ``p``'s gradient, filled layer by layer as the
    backward reaches each layer (JAX's scan writes its stacked cotangent
    the same way), where ``unbind``'s backward would hold every layer's
    gradient and then stack them into a second copy."""

    @staticmethod
    def forward(ctx, p, i, grad):
        ctx.i, ctx.grad = i, grad
        return p[i]

    @staticmethod
    def backward(ctx, g):
        ctx.grad[ctx.i].add_(g)
        return None, None, None


@dataclass(frozen=True)
class ParamLayout:
    """How each param lives on a rank (``storage``: its weight spec) and
    is computed (``compute``: per dimension "model" or None), and which
    params are cast to the compute dtype before they are gathered.  In a
    step, ``grads`` holds the gradients of the stacked params that
    :meth:`layer_slice` cut (``loss_and_grads`` gives each step its own
    dict)."""

    ctx: ShardingContext
    storage: dict
    compute: dict
    cast: frozenset
    grads: Optional[dict] = None

    def layer_slice(self, name: str, p: torch.Tensor, i: int) -> torch.Tensor:
        """Layer ``i``'s slice of ``p``, the storage shard of a stacked
        param, whose gradient is added into ``grads[name]`` (zeros, like
        ``p``) as the backward reaches the layer.  Take it where the
        layer runs: autograd runs the ready node created last first, so a
        slice taken before the loop would hold every layer's gradient
        until the backward had passed all of them.  Outside a train step
        (``grads`` None: a serving step) the plain slice ``p[i]``."""
        if self.grads is None:
            return p[i]
        if name not in self.grads:
            self.grads[name] = torch.zeros_like(p)
        return _LayerSlice.apply(p, i, self.grads[name])

    def to_compute(self, name: str, p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """The storage shard ``p`` in its compute layout, in ``dtype`` if
        it is cast (autograd keeps the transpose: zero pads and
        reduce-scatters, in ``p``'s dtype).  ``p`` may also be one
        layer's slice of a stacked param's shard: its leading layer axis,
        never sharded, is dropped from both layouts."""
        src = tuple(spec_axes(e) for e in self.storage[name])
        dst = tuple(spec_axes(e) for e in self.compute[name])
        lead = len(src) - p.dim()
        if any(src[:lead] + dst[:lead]):
            raise ValueError(f"{name}: a slice along a sharded axis ({src}, {dst})")
        return coll.redistribute(p, self.ctx.mesh, src[lead:], dst[lead:],
                                 dtype if name in self.cast else None)


def param_layout(model: Model, ctx: ShardingContext) -> ParamLayout:
    """The :class:`ParamLayout` of ``model``'s params on ``ctx.mesh``.
    Every param but the final norm's scale is read by the forward only in
    the compute dtype (the blocks in their layer loop, the embedding after
    its lookup, the head at its product), so those are cast before the
    gather: the forward reads the same numbers, and its
    gathers move half the bytes in bf16; their gradients are summed over
    the ranks in fp32 (:meth:`ParamLayout.to_compute`)."""
    shapes, specs = model.abstract_params()
    m = ctx.mesh.axis_sizes().get("model", 1)
    return ParamLayout(
        ctx=ctx,
        storage=param_specs(shapes, specs, ctx),
        compute={k: compute_spec(k, tuple(specs[k]), tuple(shapes[k].shape), model.cfg, m,
                                 ctx.mode) for k in shapes},
        cast=frozenset(k for k in shapes if not k.startswith("final_norm/")),
    )


def train_state_shardings(model: Model, ctx: ShardingContext) -> tuple[TrainState, TrainState]:
    """(abstract state, spec tree): the params' shapes, and each leaf's
    storage spec (params, ``mu`` and ``nu`` alike; the step counters
    replicated, ``()``)."""
    shapes, specs = model.abstract_params()
    p_spec = param_specs(shapes, specs, ctx)
    abstract = TrainState(params=shapes, opt=AdamWState(step=(), mu=shapes, nu=shapes), step=())
    shardings = TrainState(params=p_spec, opt=AdamWState(step=(), mu=dict(p_spec),
                                                         nu=dict(p_spec)), step=())
    return abstract, shardings


def batch_shardings(cfg: ModelConfig, ctx: ShardingContext, batch: int, seq: int) -> dict:
    """Each batch field's activation spec for a global batch x seq."""
    names, spec_for = batch_spec(cfg, ctx)
    out = {}
    for name, ndim in names.items():
        if name == "positions":
            shape = (3, batch, seq)
        elif name == "embeds":
            shape = (batch, seq, cfg.d_model)
        else:
            shape = (batch, seq)
        out[name] = resolve_spec(tuple(spec_for(name, ndim)), shape, ctx, "act")
    return out


def loss_and_grads(model: Model, params: dict, batch: dict,
                   layout: Optional[ParamLayout] = None) -> tuple[torch.Tensor, dict]:
    """``jax.value_and_grad(model.loss)``: the loss and one grad per param,
    keyed like the params (zeros for a param the loss does not reach).

    With a ``layout``, ``params`` and the grads are this rank's storage
    shards and ``batch`` its data shard: the loss (the global mean, on
    every rank) runs on them under the layout's context, which carries
    the layout, and the model gathers each param where it uses it (the
    module docstring).  The loss is replicated over the mesh's W
    ranks, so each seeds 1/W of its cotangent (the convention of
    :mod:`repro_torch.parallel.collectives`), and a grad whose storage is
    replicated over an axis is summed over it."""
    names = sorted(params)
    leaves = [params[k] for k in names]
    if layout is None:
        loss = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    else:
        mesh = layout.ctx.mesh
        step = dataclasses.replace(layout, grads={})
        with use_sharding(dataclasses.replace(layout.ctx, layout=step)):
            loss = model.loss(params, batch)
            seed = torch.full_like(loss, 1.0 / mesh.size)
            grads = torch.autograd.grad(loss, leaves, grad_outputs=seed, allow_unused=True)
        grads = [step.grads.get(k, g) for k, g in zip(names, grads)]
        grads = [g if g is None else coll.sum_over(g, mesh, mesh.replicated_axes(layout.storage[k]))
                 for k, g in zip(names, grads)]
    return loss.detach(), {k: (torch.zeros_like(p) if g is None else g)
                           for k, p, g in zip(names, leaves, grads)}


def build_train_step(model: Model, ctx: Optional[ShardingContext] = None,
                     lr: float = 3e-4) -> Callable:
    """``step(state, batch) -> (state, metrics)``; metrics: ``loss``,
    ``step`` and the grads' fp32 global norm ``grad_norm`` (finite only if
    every grad is).  With ``ctx``, ``state`` holds this rank's storage
    shards (``build_init_fn(model, ctx)``) and ``batch`` its data shard
    (``make_batch_on_mesh``)."""
    layout = None if ctx is None else param_layout(model, ctx)

    def train_step(state: TrainState, batch: dict):
        loss, grads = loss_and_grads(model, state.params, batch, layout)
        with torch.no_grad():
            gnorm = global_norm(grads) if layout is None else \
                global_norm(grads, layout.ctx.mesh, layout.storage)
            params, opt = adamw_update(grads, state.opt, state.params, lr, grad_norm=gnorm)
        step = state.step + 1
        metrics = {"loss": loss, "step": step, "grad_norm": gnorm}
        return TrainState(params=params, opt=opt, step=step), metrics

    return train_step


def build_init_fn(model: Model, ctx: Optional[ShardingContext] = None) -> Callable:
    """``init_fn(generator) -> TrainState``: params drawn on the model's
    device in ``cfg.param_dtype`` (fp32 masters) that require grad, zero
    AdamW state, step 0.

    With ``ctx`` every rank draws the full params from the generator and
    keeps its storage shard, so every mesh starts from the single-process
    weights; the ranks draw in turn (rank order), so ranks that share a
    card hold one full copy at a time."""

    def init_fn(generator: torch.Generator) -> TrainState:
        if ctx is None:
            params, _ = model.init(generator)
        else:
            params = _draw_shards(model, generator, ctx)
        params = {k: v.requires_grad_(v.is_floating_point()) for k, v in params.items()}
        return TrainState(params=params, opt=adamw_init(params),
                          step=torch.zeros((), dtype=torch.int32, device=model.device))

    return init_fn


def _draw_shards(model: Model, generator: torch.Generator, ctx: ShardingContext) -> dict:
    import torch.distributed as dist

    mesh = ctx.mesh
    specs = param_layout(model, ctx).storage
    shards = {}
    for turn in range(mesh.size):
        if turn == mesh.rank:
            full, _ = model.init(generator)
            for k in sorted(full):
                p = full.pop(k)
                # a copy: a view would keep the whole tensor alive
                shards[k] = p[mesh.shard_slices(specs[k], tuple(p.shape))].clone()
            del p
            if generator.device.type == "cuda":
                # the caching allocator keeps the full copy's blocks: hand
                # them back, or the ranks that share a card would each keep
                # one after their turn
                torch.cuda.empty_cache()
        dist.barrier()
    return shards


def gather_params(params: dict, layout: ParamLayout, *, to_host: bool = True) -> dict:
    """Every param whole, from the ranks' storage shards (each rank takes
    part; every rank gets the whole tree, on the host with ``to_host``)."""
    mesh = layout.ctx.mesh
    out = {}
    with torch.no_grad():
        for k in sorted(params):
            src = tuple(spec_axes(e) for e in layout.storage[k])
            full = coll.redistribute(params[k].detach(), mesh, src, ((),) * len(src))
            out[k] = full.to("cpu", copy=True) if to_host else full.contiguous()
    return out


# ----------------------------------------------------------------- serving --


def serving_param_shapes(model: Model) -> tuple[dict, dict]:
    """Abstract params with every float in the compute dtype (serving
    keeps no fp32 master copy), and their logical axes: the JAX
    package's ``serving_param_shapes``."""
    shapes, specs = model.abstract_params()
    dt = model.cfg.compute_dtype
    return {k: ParamShape(s.shape, dt if s.dtype.is_floating_point else s.dtype, s.axes)
            for k, s in shapes.items()}, specs


def cache_layouts(model: Model, ctx: ShardingContext, batch: int, max_len: int) -> dict:
    """Each cache leaf's spec on ``ctx.mesh`` in its serving mode (the
    JAX package's ``cache_shardings``; ``Model.cache_layouts``): a rank
    holds ``mesh.shard_slices(spec, shape)`` of the leaf."""
    return model.cache_layouts(batch, max_len, ctx)


def abstract_cache(model: Model, batch: int, max_len: int) -> dict:
    """The cache's leaves as shapes and dtypes, nothing allocated
    (:class:`~repro_torch.models.common.ParamShape`, with its logical
    axes): the JAX package's ``abstract_cache``."""
    return {name: ParamShape(tuple(shape), torch_dtype(dt), tuple(axes))
            for name, (shape, dt, axes, _f) in init_cache_shapes(model.cfg, batch,
                                                                 max_len).items()}


def shard_params(params: dict, layout: ParamLayout) -> dict:
    """This rank's storage shard of every param of a whole tree (a copy
    each)."""
    mesh = layout.ctx.mesh
    return {k: v[mesh.shard_slices(layout.storage[k], tuple(v.shape))].clone()
            for k, v in params.items()}


def build_serve_step(model: Model, ctx: Optional[ShardingContext] = None) -> Callable:
    """``serve_step(params, cache, tok) -> (logits (B,1,V), cache)``: one
    decode token for every sequence (``tok``: tokens or embeds (B,1),
    positions, ``cache_pos`` a host int), the cache written in place.

    With ``ctx`` (``decode`` or ``long`` mode on a
    :class:`~repro_torch.parallel.sharding.ProcessMesh`), ``params`` are
    this rank's storage shards of the serving params
    (:func:`shard_params` of :func:`serving_param_shapes`' dtypes), each
    gathered where the model reads it, ``cache`` its shard of every leaf
    (``model.init_cache`` under ``ctx``, or :func:`build_prefill_step`)
    and ``tok`` its shard of the token batch (:func:`place_batch`); every
    rank returns the whole logits of its batch rows."""
    if ctx is None:
        return model.decode_step
    if ctx.mode == "train":
        raise ValueError("a serve step runs in a serving mode ('decode' or 'long'); a "
                         "prefill runs in train mode (build_prefill_step)")
    step_ctx = dataclasses.replace(ctx, layout=param_layout(model, ctx))

    def serve_step(params: dict, cache: dict, tok: dict):
        with use_sharding(step_ctx):
            return model.decode_step(params, cache, tok)

    return serve_step


def place_batch(host_batch: dict, cfg: ModelConfig, ctx: ShardingContext) -> dict:
    """This rank's shard of a host prompt or token batch under ``ctx``'s
    rules (each field's activation spec; a batch smaller than its axes
    stays whole, as JAX keeps it), on ``ctx.mesh.device``; ``cache_pos``
    is kept as it is."""
    _, spec_for = batch_spec(cfg, ctx)
    mesh = ctx.mesh
    out = {}
    for k, v in host_batch.items():
        if k == "cache_pos":
            out[k] = v
            continue
        v = torch.as_tensor(v)
        spec = resolve_spec(tuple(spec_for(k, v.dim())), tuple(v.shape), ctx, "act")
        out[k] = v[mesh.shard_slices(spec, tuple(v.shape))].contiguous().to(mesh.device)
    return out


def build_prefill_step(model: Model, ctx: Optional[ShardingContext], batch: int,
                       max_len: int) -> Callable:
    """``prefill(params, cache, prompt) -> logits (B,1,V)`` of the last
    position, ``cache`` filled as the prompt's decode steps would fill it.

    Without ``ctx``, ``Model.prefill``.  With ``ctx`` (a serving mode on a
    mesh, ``params`` and ``cache`` as :func:`build_serve_step` takes
    them, ``prompt`` the rank's shard of a ``batch`` x S prompt under the
    train rules, :func:`place_batch`): the prompt runs in train mode, as
    the JAX package's prefill cell does (the residual sequence-parallel
    where the model axis divides S, else whole), and each cache leaf it
    fills is moved from the train layout it comes out in into the cache's
    (:func:`cache_layouts` for ``batch`` x ``max_len``) by
    ``collectives.redistribute``: the K/V padded to the cache's length
    first (gemma2's rings laid out as their slots), the Mamba2 conv tail
    made whole over its channels first (the train layout holds this
    rank's heads' x channels beside B and C)."""
    if ctx is None:
        def prefill(params, cache, prompt):
            return model.prefill(params, cache, prompt)[:, -1:]
        return prefill
    cfg = model.cfg
    train_ctx = dataclasses.replace(ctx, mode="train")
    train_ctx = dataclasses.replace(train_ctx, layout=param_layout(model, train_ctx))
    shapes = init_cache_shapes(cfg, batch, max_len)
    dst = cache_layouts(model, ctx, batch, max_len)
    mesh = ctx.mesh
    train_batch = tuple(spec_axes(resolve_spec(("batch",), (batch,), train_ctx, "act")[0]))

    def prefill(params: dict, cache: dict, prompt: dict):
        S = prompt["embeds" if cfg.embed_inputs else "tokens"].shape[1]
        with use_sharding(train_ctx):
            logits, caches = model.forward(params, prompt, collect_kv=True, last=True)
            if "k_loc" in cache:
                loc = local_layers(cfg)
                glob = [i for i in range(cfg.n_layers) if i not in loc]
                caches = {"k_loc": caches["k"][loc], "v_loc": caches["v"][loc],
                          "k": caches["k"][glob], "v": caches["v"][glob]}
            if "conv" in caches:
                caches["conv"] = _whole_conv(cfg, caches["conv"], mesh)
        for name, val in caches.items():
            shape, _dt, axes, _f = shapes[name]
            if name in KV_ENTRIES:
                val = _kv_slots(val, shape[2], ring=name.endswith("_loc"), prompt_len=S)
            src = tuple(() if n == g else (train_batch if a == "batch" else ("model",))
                        for n, g, a in zip(val.shape, shape, axes))
            moved = coll.redistribute(val, mesh, src, tuple(spec_axes(e) for e in dst[name]))
            cache[name].copy_(moved.to(cache[name].dtype))
        return logits

    return prefill


def _kv_slots(val: torch.Tensor, n: int, *, ring: bool, prompt_len: int) -> torch.Tensor:
    """A prompt's (L, B, S, KV, hd) keys or values laid out as a cache of
    ``n`` slots: positions 0..S-1 at slots 0..S-1 and zeros after them,
    or, in a ring of ``n`` slots that the prompt outgrows, the last ``n``
    positions at slots p % n."""
    S = prompt_len
    if ring and S > n:
        out = torch.empty(val.shape[:2] + (n,) + val.shape[3:], dtype=val.dtype,
                          device=val.device)
        out[:, :, torch.arange(S - n, S, device=val.device) % n] = val[:, :, S - n:]
        return out
    return torch.nn.functional.pad(val, (0, 0, 0, 0, 0, n - S))


def _whole_conv(cfg: ModelConfig, conv: torch.Tensor, mesh) -> torch.Tensor:
    """The prefill's conv tails (L, B, K-1, cl + 2N), this rank's heads'
    x channels then B and C, as (L, B, K-1, d_in + 2N): the x channels
    gathered over 'model' where the heads are split."""
    d_in = cfg.ssm_expand * cfg.d_model
    cl = conv.shape[-1] - 2 * cfg.ssm_state
    if cl == d_in:
        return conv
    x = coll.all_gather(conv[..., :cl].contiguous(), mesh, "model", 3)
    return torch.cat([x, conv[..., cl:]], dim=-1)
