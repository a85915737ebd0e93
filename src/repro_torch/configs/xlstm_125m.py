"""xlstm-125m [ssm]: 12L d_model=768 4H d_ff=0 vocab=50304 — sLSTM +
mLSTM blocks [arXiv:2405.04517; unverified].

d_ff=0: mixing blocks carry their own projections (mLSTM proj factor 2,
sLSTM with a 4/3 GLU FFN).  Every 2nd block is sLSTM."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    xlstm_slstm_every=2,
    xlstm_proj_factor=2.0,
    xlstm_chunk=128,
)

SMOKE = CONFIG.replace(
    name="xlstm-smoke",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    vocab=256,
    xlstm_chunk=8,
    remat=False,
)
