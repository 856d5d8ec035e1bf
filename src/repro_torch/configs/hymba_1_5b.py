"""hymba-1.5b [hybrid] — parallel attn+mamba heads (arXiv:2411.13676; hf).

32L d_model=1600 25H (GQA kv=5, head_dim 64) d_ff=5504 vocab=32001,
ssm_state=16.  Sliding-window attention everywhere except {first, middle,
last} layers (full attention), per the Hymba recipe; the mamba branch runs
in parallel with attention in every layer (per-branch RMSNorm, mean fuse).
Sub-quadratic: SWA ring caches + constant SSM state => long_500k runnable.
"""
from .base import ArchConfig, SSMCfg

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab=32001,
    sliding_window=1024,
    full_attn_layers=(0, 16, 31),
    ssm=SSMCfg(state_dim=16, n_heads=25, head_dim=64, conv_width=4),
)
