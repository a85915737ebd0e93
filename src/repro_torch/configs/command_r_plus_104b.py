"""command-r-plus-104b [dense]: 64L d_model=12288 96H (GQA kv=8)
d_ff=33792 vocab=256000 — GQA, no-bias
[hf:CohereForAI/c4ai-command-r-v01; unverified]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab=256000,
    loss_chunk=512,   # 256k vocab: chunk the fp32 loss materialization
)

SMOKE = CONFIG.replace(
    name="command-r-smoke",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    head_dim=8,
    d_ff=192,
    vocab=512,
    loss_chunk=0,
    remat=False,
)
