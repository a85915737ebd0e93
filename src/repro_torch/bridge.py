"""Params between the JAX package and the port, as dicts of numpy arrays.

Both packages key their params by the same flat ``"scope/name"`` strings
with the same shapes (stacked block params carry a leading ``layers``
axis), so a checkpoint of one computes the same function in the other.
The port's own init cannot reproduce ``jax.random`` bits: the tests hand
the JAX package's params to the port through here.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def to_torch(arrays: Mapping[str, np.ndarray], device: DeviceLike = None
             ) -> dict[str, torch.Tensor]:
    """numpy arrays -> tensors on ``device``, dtypes kept.

    bfloat16 arrays (``ml_dtypes``, as JAX hands them out) go through fp32,
    which holds every bfloat16 value exactly.
    """
    dev = resolve_device(device)
    out = {}
    for name, a in arrays.items():
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))  # a copy: JAX's buffers are read-only
        out[name] = t.to(dev)
    return out


def to_numpy(tensors: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """tensors -> numpy arrays on the host (bfloat16 comes back as fp32,
    which numpy can hold)."""
    out = {}
    for name, t in tensors.items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[name] = t.numpy()
    return out
