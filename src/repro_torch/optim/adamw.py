"""AdamW with global-norm clipping (ports :mod:`repro.optim.adamw`).

The state mirrors the params: ``mu``/``nu`` are dicts keyed like them,
so it reshards and checkpoints under the params' own keys, which
``torch.optim.AdamW``'s per-param state would not.  The arithmetic is the
JAX package's: b2 0.95, clipping by the fp32 global norm with ``+ 1e-9``,
``update = (m / c1) / (sqrt(v / c2) + eps) + wd * p`` on every leaf.

Unlike the JAX functions, which return new arrays, ``adamw_update``
updates the params, ``mu``, ``nu`` and the grads in place, one leaf at a
time, so a step holds no second copy of the state (2.8 B fp32 params
take 11.2 GB each for params, grads, ``mu`` and ``nu``).  Call it under
``torch.no_grad()``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32
    mu: dict
    nu: dict


def adamw_init(params: dict) -> AdamWState:
    device = next(iter(params.values())).device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        mu={k: torch.zeros_like(p) for k, p in params.items()},
        nu={k: torch.zeros_like(p) for k, p in params.items()},
    )


def global_norm(tree: dict, mesh=None, specs: Optional[dict] = None) -> torch.Tensor:
    """sqrt of the sum of every leaf's fp32 sum of squares, leaves in sorted
    key order (the JAX package's pytree order).

    With a :class:`~repro_torch.parallel.sharding.ProcessMesh` and each
    leaf's storage spec, the leaves are this rank's shards: every element
    is counted once (a leaf replicated over an axis contributes from the
    rank at coordinate 0 of that axis only) and the sum runs over every
    rank, so each gets the norm of the whole tree."""
    if mesh is None:
        leaves = [torch.sum(torch.square(tree[k].float())) for k in sorted(tree)]
        return torch.sqrt(torch.sum(torch.stack(leaves)))
    from repro_torch.parallel import collectives

    leaves = []
    for k in sorted(tree):
        first = all(mesh.axis_index(a) == 0 for a in mesh.replicated_axes(specs[k]))
        sq = torch.sum(torch.square(tree[k].float()))
        leaves.append(sq if first else torch.zeros_like(sq))
    total = collectives.sum_over(torch.sum(torch.stack(leaves)), mesh, mesh.axis_names)
    return torch.sqrt(total)


def adamw_update(
    grads: dict,
    state: AdamWState,
    params: dict,
    lr: Union[torch.Tensor, float],
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: Optional[float] = 1.0,
    grad_norm: Optional[torch.Tensor] = None,
) -> tuple[dict, AdamWState]:
    """One AdamW step, in place; returns (params, new_state), the same
    tensors.  ``grad_norm``: ``global_norm(grads)`` if the caller has it
    already (it is computed here otherwise).  Every op is elementwise, so
    on a mesh it runs on the storage shards as they are, given the norm
    over all of them (``global_norm(grads, mesh, specs)``)."""
    step = state.step + 1
    if clip_norm is not None:
        gnorm = global_norm(grads) if grad_norm is None else grad_norm
        scale = torch.clamp(clip_norm / (gnorm + 1e-9), max=1.0)
    # bias correction, in fp32 on the device
    stepf = step.float()
    c1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=stepf.device), stepf)
    c2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=stepf.device), stepf)
    for name, p in params.items():
        g, m, v = grads[name], state.mu[name], state.nu[name]
        if clip_norm is not None:
            g.mul_(scale)
        m.mul_(b1).add_(g * (1 - b1))                    # b1 m + (1 - b1) g
        v.mul_(b2).add_(torch.square(g).mul_(1 - b2))    # b2 v + (1 - b2) g^2
        update = (m / c1).div_((v / c2).sqrt_().add_(eps)).add_(weight_decay * p)
        p.sub_((lr * update).to(p.dtype))
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu)
