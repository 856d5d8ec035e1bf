"""llava-next-mistral-7b [vlm] — anyres tiling backbone
(hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified).

Mistral-7B backbone: 32L d_model=4096 32H (GQA kv=8, head_dim 128)
d_ff=14336 vocab=32000.  The vision frontend is a STUB per the assignment:
``input_specs()`` supplies precomputed patch embeddings (B, 576, d) which
are prepended to the token embeddings; loss is masked to text positions.
Full attention (llava fine-tunes drop mistral's SWA) => long_500k skipped.
"""
from .base import ArchConfig, VLMCfg

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=32000,
    vlm=VLMCfg(n_patches=576),
)
