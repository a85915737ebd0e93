"""yi-34b [dense]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 — llama-arch GQA [arXiv:2403.04652; hf].

56 heads are not divisible by the 16-way model axis: baseline relies on
GSPMD's uneven sharding (internal padding); the perf pass pads heads
explicitly (see EXPERIMENTS.md §Perf).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab=64000,
)

SMOKE = CONFIG.replace(
    name="yi-smoke",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    head_dim=8,
    d_ff=128,
    vocab=256,
    remat=False,
)
