"""gemma2-9b [dense]: 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000 — local+global alternating attention (4096 window) and
logit soft-capping [arXiv:2408.00118; hf]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab=256000,
    sliding_window=4096,
    alt_local_global=True,
    attn_softcap=50.0,
    final_softcap=30.0,
    loss_chunk=512,
)

SMOKE = CONFIG.replace(
    name="gemma2-smoke",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=256,
    sliding_window=8,
    loss_chunk=0,
    remat=False,
)
