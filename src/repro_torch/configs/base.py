"""Architecture & run-shape configuration dataclasses."""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Sequence, Tuple


@dataclass(frozen=True)
class MoECfg:
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    group_size: int = 2048       # token group size for dispatch


@dataclass(frozen=True)
class SSMCfg:
    state_dim: int = 16
    n_heads: int = 25            # mamba heads (hymba: parallel with attn)
    head_dim: int = 64
    dt_rank: int = 0             # 0 => d_model // 16
    conv_width: int = 4


@dataclass(frozen=True)
class RWKVCfg:
    n_heads: int = 64
    head_dim: int = 64
    decay_lora: int = 64         # rank of the data-dependent decay LoRA


@dataclass(frozen=True)
class EncDecCfg:
    enc_layers: int = 24
    enc_seq: int = 1500          # whisper: 30s of audio at 50 fps
    # frontend is a stub: input_specs() supplies frame embeddings directly


@dataclass(frozen=True)
class VLMCfg:
    n_patches: int = 576         # llava-next base tile (24x24)
    # frontend is a stub: input_specs() supplies patch embeddings directly


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 => d_model // n_heads
    qkv_bias: bool = False
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    # sliding-window attention: None = full; int = window size
    sliding_window: Optional[int] = None
    # layer indices using FULL attention even when sliding_window is set
    full_attn_layers: Tuple[int, ...] = ()
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None          # hybrid (hymba): parallel attn+mamba
    rwkv: Optional[RWKVCfg] = None        # attn-free rwkv6
    enc_dec: Optional[EncDecCfg] = None
    vlm: Optional[VLMCfg] = None
    # numeric policy
    param_dtype: str = "bfloat16"
    opt_moment_dtype: str = "float32"     # grok uses bfloat16 (HBM fit, see DESIGN)
    # attention impl: 'masked_scan' (baseline) | 'triangular' (optimized)
    attn_impl: str = "masked_scan"
    attn_chunk_q: int = 512
    attn_chunk_k: int = 512
    attn_softcap: Optional[float] = None   # grok: 30.0 logit soft-capping
    mlp_style: str = "swiglu"              # 'swiglu' | 'gelu2' (whisper)
    # ssm/rwkv mixer impl: 'scan' (baseline per-step) | 'chunked' (block form)
    mixer_impl: str = "scan"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run the long_500k decode cell? (bounded state)"""
        if self.rwkv is not None:
            return True
        if self.sliding_window is not None:
            return True  # bounded KV window (+ SSM state for hybrids)
        return False

    def n_params(self) -> int:
        """Analytic parameter count (embeddings included)."""
        d, f, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab
        hd = self.hd
        if self.rwkv is not None:
            H = self.rwkv.n_heads
            per_layer = (
                4 * d * H * self.rwkv.head_dim   # r,k,v,g (time-mix)
                + d * H * self.rwkv.head_dim     # output proj
                + 2 * self.rwkv.decay_lora * d   # decay lora
                + 2 * d * f // 2 + d * f // 2    # channel mix (approx 3 mats)
            )
            body = L * per_layer
        else:
            attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
            if self.moe is not None:
                ffn = self.moe.n_experts * 3 * d * f + d * self.moe.n_experts  # router
            else:
                ffn = 3 * d * f
            per_layer = attn + ffn
            if self.ssm is not None:
                s = self.ssm
                di = s.n_heads * s.head_dim
                per_layer += 2 * d * di + di * d + di * (2 * s.state_dim)  # in/gate/out + B,C proj
            body = L * per_layer
            if self.enc_dec is not None:
                # encoder layers + decoder cross-attention
                enc = self.enc_dec.enc_layers * (attn + 3 * d * f)
                cross = L * (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d)
                body += enc + cross
        emb = V * d * (1 if self.tie_embeddings else 2)
        return body + emb

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.moe is None:
            return self.n_params()
        d, f, L = self.d_model, self.d_ff, self.n_layers
        inactive = L * (self.moe.n_experts - self.moe.top_k) * 3 * d * f
        return self.n_params() - inactive


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    phase: str                   # 'train' | 'prefill' | 'decode'

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """A tiny same-family config for CPU smoke tests."""
    base = dict(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        head_dim=16,
    )
    if cfg.moe is not None:
        base["moe"] = MoECfg(n_experts=2, top_k=2, capacity_factor=1.5, group_size=16)
    if cfg.ssm is not None:
        base["ssm"] = SSMCfg(state_dim=4, n_heads=4, head_dim=16, conv_width=4)
    if cfg.rwkv is not None:
        base["rwkv"] = RWKVCfg(n_heads=4, head_dim=16, decay_lora=8)
        base["n_kv_heads"] = base["n_heads"]
    if cfg.enc_dec is not None:
        base["enc_dec"] = EncDecCfg(enc_layers=2, enc_seq=24)
    if cfg.vlm is not None:
        base["vlm"] = VLMCfg(n_patches=8)
    if cfg.sliding_window is not None:
        base["sliding_window"] = 32
        # keep full-attn layer indices in range
        base["full_attn_layers"] = tuple(i for i in cfg.full_attn_layers if i < 2)
    base.update(overrides)
    return replace(cfg, **base)
