"""musicgen-medium [audio]: 48L d_model=1536 24H (GQA kv=24) d_ff=6144
vocab=2048 — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

Backbone only: the EnCodec frontend is a STUB — ``input_specs()``
supplies precomputed frame embeddings (B, S, d_model)."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab=2048,
    embed_inputs=True,
)

SMOKE = CONFIG.replace(
    name="musicgen-smoke",
    n_layers=2,
    d_model=48,
    n_heads=4,
    n_kv_heads=4,
    d_ff=96,
    vocab=128,
    remat=False,
)
