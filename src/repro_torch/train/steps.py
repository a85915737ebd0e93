"""Train step and init (ports :mod:`repro.train.steps`, without sharding).

``build_train_step`` returns ``step(state, batch) -> (state, metrics)``:
the loss and its grads by ``torch.autograd`` over the fp32 master params
(leaves that require grad), then ``adamw_update`` under
``torch.no_grad()``, as the JAX step runs ``jax.value_and_grad(model.loss)``
then ``adamw_update``.  Nothing is sharded (ROADMAP.md A16); the params,
``mu``, ``nu`` and the grads are updated in place (see
:mod:`repro_torch.optim.adamw`), so the returned state holds the same
tensors as the one passed in.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.models import Model
from repro_torch.optim import AdamWState, adamw_init, adamw_update, global_norm


class TrainState(NamedTuple):
    params: dict
    opt: AdamWState
    step: torch.Tensor   # () int32


def loss_and_grads(model: Model, params: dict, batch: dict) -> tuple[torch.Tensor, dict]:
    """``jax.value_and_grad(model.loss)``: the loss and one grad per param,
    keyed like the params (zeros for a param the loss does not reach)."""
    names = sorted(params)
    leaves = [params[k] for k in names]
    loss = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), {k: (torch.zeros_like(p) if g is None else g)
                           for k, p, g in zip(names, leaves, grads)}


def build_train_step(model: Model, lr: float = 3e-4) -> Callable:
    """``step(state, batch) -> (state, metrics)``; metrics: ``loss``,
    ``step`` and the grads' fp32 global norm ``grad_norm`` (finite only if
    every grad is)."""

    def train_step(state: TrainState, batch: dict):
        loss, grads = loss_and_grads(model, state.params, batch)
        with torch.no_grad():
            gnorm = global_norm(grads)
            params, opt = adamw_update(grads, state.opt, state.params, lr, grad_norm=gnorm)
        step = state.step + 1
        metrics = {"loss": loss, "step": step, "grad_norm": gnorm}
        return TrainState(params=params, opt=opt, step=step), metrics

    return train_step


def build_init_fn(model: Model) -> Callable:
    """``init_fn(generator) -> TrainState``: params drawn on the model's
    device in ``cfg.param_dtype`` (fp32 masters) that require grad, zero
    AdamW state, step 0."""

    def init_fn(generator: torch.Generator) -> TrainState:
        params, _ = model.init(generator)
        params = {k: v.requires_grad_(v.is_floating_point()) for k, v in params.items()}
        return TrainState(params=params, opt=adamw_init(params),
                          step=torch.zeros((), dtype=torch.int32, device=model.device))

    return init_fn
