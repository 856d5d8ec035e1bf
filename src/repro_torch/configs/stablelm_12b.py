"""stablelm-12b [dense] (hf:stabilityai/stablelm-2-12b; hf).

40L d_model=5120 32H (GQA kv=8, head_dim 160) d_ff=13824 vocab=100352.
LayerNorm (stablelm-2 family).  Full attention => long_500k skipped.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=160,
    d_ff=13824,
    vocab=100352,
    norm="layernorm",
)
