"""mixtral-8x22b [moe] — 8 experts top-2, SWA (arXiv:2401.04088; hf).

56L d_model=6144 48H (GQA kv=8, head_dim 128) d_ff=16384 vocab=32768,
MoE 8e top-2.  Sliding window 4096 per the assignment => bounded decode
cache, long_500k runnable.
"""
from .base import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=32768,
    sliding_window=4096,
    moe=MoECfg(n_experts=8, top_k=2, capacity_factor=1.25, group_size=2048),
)
