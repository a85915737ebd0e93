"""qwen2-vl-7b [vlm]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064 — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

Backbone only: the vision tower is a STUB — ``input_specs()`` supplies
precomputed patch embeddings; M-RoPE (t/h/w sections 16/24/24 over the
64 rotary channels) is implemented in full."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab=152064,
    mrope_sections=(16, 24, 24),
    embed_inputs=True,
    loss_chunk=512,
)

SMOKE = CONFIG.replace(
    name="qwen2-vl-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=256,
    mrope_sections=(2, 3, 3),
    loss_chunk=0,
    remat=False,
)
