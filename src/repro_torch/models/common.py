"""Model substrate: config + functional param system with logical axes.

A copy of :mod:`repro.models.common` for PyTorch: the same
``ModelConfig`` fields, defaults and counts, and a ``ParamBuilder`` that
draws the same init scales from an explicit ``torch.Generator``.  Params
are a flat dict of ``"scope/name"`` tensors, so the JAX package's params
pass 1:1 through :mod:`repro_torch.bridge`.  The logical axis names are
kept beside them for :mod:`repro_torch.parallel.sharding`.  Without a
generator the builder records only each param's :class:`ParamShape`
(the JAX package's ``abstract_params``), which sizes any config without
allocating it.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import torch

# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    """One decoder-only architecture (all ten assigned archs fit here)."""

    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25

    # --- gemma2-style alternating local/global attention ---------------------
    sliding_window: int = 0        # 0 -> full attention everywhere
    alt_local_global: bool = False  # even layers local, odd layers global
    attn_softcap: float = 0.0      # tanh soft-capping on attention logits
    final_softcap: float = 0.0     # tanh soft-capping on final logits

    # --- SSM / hybrid (zamba2) ------------------------------------------------
    ssm_state: int = 0             # Mamba2 state dim (N)
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 128
    attn_every: int = 0            # hybrid: shared attn block every k SSM layers

    # --- xLSTM ------------------------------------------------------------------
    xlstm_slstm_every: int = 2     # every k-th block is sLSTM (rest mLSTM)
    xlstm_proj_factor: float = 2.0
    xlstm_chunk: int = 128

    # --- VLM (qwen2-vl) ------------------------------------------------------------
    mrope_sections: tuple[int, ...] = ()   # (t, h, w) split of head_dim/2

    # --- modality frontend stub --------------------------------------------------
    embed_inputs: bool = False     # True: inputs are precomputed embeddings

    # --- numerics / impl ------------------------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    remat: bool = True
    # Kept equal to the JAX package's config; the port never reads it: the
    # tensors' device alone picks kernel or plain attention (kernels.ops).
    attn_impl: str = "chunked"
    attn_chunk: int = 512          # query-chunk for the chunked path
    seq_parallel: bool = True      # shard the residual stream's seq dim over TP
    tie_embeddings: bool = False
    logit_dtype: str = "bfloat16"  # dtype of loss logits (vocab-sharded)
    loss_chunk: int = 0            # 0 -> unchunked; else seq-chunked loss

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # Rough parameter count (docs/roofline MODEL_FLOPS term).
    def param_count(self) -> int:
        d, hd = self.d_model, self.hd
        embed = self.vocab * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family in ("dense", "moe", "audio", "vlm"):
            attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
            if self.family == "moe":
                ffn = 3 * d * self.d_ff * (self.n_experts + self.n_shared_experts) + d * self.n_experts
            else:
                ffn = 3 * d * self.d_ff
            per_layer = attn + ffn
        elif self.family == "hybrid":
            d_in = self.ssm_expand * d
            ssm = d * (2 * d_in + 2 * self.ssm_state + d_in // self.ssm_head_dim) + d_in * d
            attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
            mlp = 3 * d * self.d_ff
            per_layer = ssm  # per SSM layer
            return embed + self.n_layers * per_layer + (attn + mlp)  # shared attn counted once
        elif self.family == "ssm":
            dp = int(self.xlstm_proj_factor * d)
            per_layer = 2 * d * dp + 3 * dp * dp // max(self.n_heads, 1) + dp * d
        return embed + self.n_layers * per_layer

    def active_param_count(self) -> int:
        """Active params per token (MoE uses top_k of n_experts)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        total = self.param_count()
        # shared experts are already in `total` and always active; only the
        # routed experts collapse from n_experts to top_k.
        ffn_routed_all = 3 * d * self.d_ff * self.n_experts * self.n_layers
        ffn_routed_active = 3 * d * self.d_ff * self.top_k * self.n_layers
        return total - ffn_routed_all + ffn_routed_active


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (the config's dtype strings)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


# ---------------------------------------------------------------------------
# Param construction with logical axes
# ---------------------------------------------------------------------------


class ParamShape(NamedTuple):
    """One param without its values: what ``jax.eval_shape`` gives."""

    shape: tuple
    dtype: torch.dtype
    axes: tuple

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize


class ParamBuilder:
    """Collects (param, logical_axes) pairs under ``"scope/name"`` keys.

    Draws from ``generator`` on the generator's device; the scales are
    those of the JAX builder (``normal``: 1/sqrt(shape[0]); ``embed``:
    ``scale``), but the bits are PyTorch's, not ``jax.random``'s.  With
    ``generator=None`` it records a :class:`ParamShape` per param instead.
    """

    def __init__(self, generator: Optional[torch.Generator], param_dtype=torch.float32):
        self.generator = generator
        self.device = None if generator is None else generator.device
        self.params: dict[str, Any] = {}
        self.specs: dict[str, Any] = {}
        self.param_dtype = param_dtype

    def _normal(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator, device=self.device,
                           dtype=self.param_dtype)

    def add(self, name: str, shape, axes: tuple, init: str = "normal", scale: float | None = None):
        assert len(shape) == len(axes), (name, shape, axes)
        dtype, dev = self.param_dtype, self.device
        if init not in ("zeros", "ones", "normal", "embed"):
            raise ValueError(init)
        if self.generator is None:
            arr = ParamShape(tuple(shape), dtype, tuple(axes))
        elif init == "zeros":
            arr = torch.zeros(shape, dtype=dtype, device=dev)
        elif init == "ones":
            arr = torch.ones(shape, dtype=dtype, device=dev)
        elif init == "normal":
            fan_in = shape[0] if len(shape) >= 1 else 1
            s = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
            arr = self._normal(shape) * s
        elif init == "embed":
            arr = self._normal(shape) * (scale or 1.0)
        self.params[name] = arr
        self.specs[name] = axes
        return arr

    def build(self):
        return self.params, self.specs


def stack_params(per_layer: list[tuple[dict, dict]]) -> tuple[dict, dict]:
    """Stack L per-layer param dicts (or :class:`ParamShape` dicts) along
    a leading 'layers' axis."""
    if not per_layer:
        return {}, {}
    keys = per_layer[0][0].keys()

    def stack(leaves):
        if isinstance(leaves[0], ParamShape):
            s = leaves[0]
            return ParamShape((len(leaves),) + s.shape, s.dtype, ("layers",) + s.axes)
        return torch.stack(leaves, dim=0)

    params = {k: stack([pl[0][k] for pl in per_layer]) for k in keys}
    specs = {k: ("layers",) + tuple(per_layer[0][1][k]) for k in keys}
    return params, specs
