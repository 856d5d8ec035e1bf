"""grok-1-314b [moe] — 8 experts top-2 (hf:xai-org/grok-1; unverified).

64L d_model=6144 48H (GQA kv=8, head_dim 128) d_ff=32768 vocab=131072,
MoE 8e top-2, attention logit soft-capping at 30.  Full attention =>
long_500k skipped (DESIGN §Arch-applicability).  Adam moments in bf16 so
params+opt+grads fit the single-pod HBM budget (DESIGN §5 / EXPERIMENTS
§Dry-run note).
"""
from .base import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab=131072,
    attn_softcap=30.0,
    moe=MoECfg(n_experts=8, top_k=2, capacity_factor=1.25, group_size=2048),
    opt_moment_dtype="bfloat16",
)
