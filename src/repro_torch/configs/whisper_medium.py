"""whisper-medium [audio] — enc-dec, conv frontend stubbed
(arXiv:2212.04356; unverified).

24 encoder + 24 decoder layers, d_model=1024 16H (kv=16, head_dim 64)
d_ff=4096 vocab=51865, LayerNorm + gelu MLPs.  The conv1d/mel frontend is a
STUB: ``input_specs()`` supplies frame embeddings (B, 1500, d).  Decoder
positions use RoPE in this backbone (original uses learned embeddings —
backbone-equivalent for shape/roofline purposes, noted divergence).
Full attention decoder => long_500k skipped.
"""
from .base import ArchConfig, EncDecCfg

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=51865,
    norm="layernorm",
    mlp_style="gelu2",
    enc_dec=EncDecCfg(enc_layers=24, enc_seq=1500),
)
