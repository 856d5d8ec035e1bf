"""rwkv6-7b "Finch" [ssm] — attn-free, data-dependent decay
(arXiv:2404.05892; hf).

32L d_model=4096 (64 wkv heads x head_dim 64) d_ff=14336 vocab=65536.
Constant-size decode state (token-shift vectors + (H, 64, 64) wkv state)
=> long_500k runnable.
"""
from .base import ArchConfig, RWKVCfg

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,
    n_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab=65536,
    norm="layernorm",
    rwkv=RWKVCfg(n_heads=64, head_dim=64, decay_lora=64),
)
