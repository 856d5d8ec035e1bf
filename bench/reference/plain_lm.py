"""A plain decoder-only LM in float32 PyTorch: the benchmark's reference.

It imports nothing of the program.  It reads a configuration file of
``bench/configs/`` (a dict) and a dict of weights named as the program's
``state_dict`` names them (``embed``, ``blocks.{i}.attn.wq``, ...), which
the benchmark makes from the seed and hands to both sides.  Every weight is
widened to float32 here, every product runs in float32 with TF32 off, and
nothing is cached: attention is a masked softmax over the whole sequence,
the selective scan a sum over each chunk of 64 steps and a state carried
between chunks, the mixture of experts a loop over experts of the tokens
routed to each.

Equations (the families a config names: ``dense``, ``moe``, ``hybrid``):

* RMSNorm ``x / sqrt(mean(x^2) + 1e-6) * scale``; split-half RoPE.
* GQA attention, causal, windowed where the layer has a window
  (``i - j < window``), scale ``1/sqrt(D)``.
* SwiGLU MLP ``(silu(x Wg) * (x Wu)) Wd``.
* hybrid (Hymba): attention and a Mamba branch read the same normed input;
  the block adds ``0.5 (norm_a(attn) + norm_m(mamba))``.  Mamba branch:
  ``u = silu(causal depthwise conv(x W_in))``, ``dt = softplus(x W_dt +
  b_dt)``, ``h_t = exp(-exp(A_log) dt_t) h_{t-1} + dt_t u_t B_t^T``,
  ``y_t = h_t C_t + D u_t``, times ``silu(x W_gate)``, then ``W_out``.
* moe (Mixtral): a float32 router, softmax, the top k by a stable
  descending sort, renormalised; within each group of tokens an expert
  takes at most ``C = max(ceil(g k cf / E), k)`` slots, slot 0 of every
  token before slot 1 of any; dropped slots add nothing.  Which tokens form
  a group is the serving call's: the caller passes the groups.

``precision="fp8"`` is the benchmark's control: each product's two operands
are rounded to float8 e4m3 (one scale a tensor, amax / 448) first, with the
gradient passed straight through.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

SCAN_CHUNK = 64
ATTN_BLOCK_BYTES = 2 << 30          # float32 scores held at once by one attention call
FP8_MAX = 448.0


def fp32_matmuls() -> None:
    """Products in true float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# --- parameters -----------------------------------------------------------------

def head_dim(cfg) -> int:
    return cfg["head_dim"] or cfg["d_model"] // cfg["n_heads"]


def layer_windows(cfg) -> List[Optional[int]]:
    full = set(cfg.get("full_attn_layers") or ())
    w = cfg.get("sliding_window")
    return [None if (w is None or i in full) else w for i in range(cfg["n_layers"])]


def param_list(cfg) -> List[Tuple[str, Tuple[int, ...], str, str, float]]:
    """``(name, shape, dtype, init, scale)`` of every weight, in a fixed
    order.  ``init`` is ``normal`` (N(0, 1) scale / sqrt(fan in), fan in the
    second-last dim, or the last of a vector), ``ones``, ``zeros`` or
    ``decay`` (-0.5 - U[0, 1)); ``dtype`` ``bf16`` or ``fp32``."""
    fam = cfg["family"]
    if fam not in ("dense", "moe", "hybrid") or cfg.get("qkv_bias") or cfg.get("norm", "rmsnorm") != "rmsnorm":
        raise ValueError(f"plain_lm: no reference for {cfg['name']}")
    d, v, f = cfg["d_model"], cfg["vocab"], cfg["d_ff"]
    hd, h, kv = head_dim(cfg), cfg["n_heads"], cfg["n_kv_heads"]
    out = [("embed", (v, d), "bf16", "normal", 1.0)]
    for i in range(cfg["n_layers"]):
        p = f"blocks.{i}."
        out += [(p + "ln1.scale", (d,), "fp32", "ones", 1.0),
                (p + "attn.wq", (d, h * hd), "bf16", "normal", 1.0),
                (p + "attn.wk", (d, kv * hd), "bf16", "normal", 1.0),
                (p + "attn.wv", (d, kv * hd), "bf16", "normal", 1.0),
                (p + "attn.wo", (h * hd, d), "bf16", "normal", 1.0),
                (p + "ln2.scale", (d,), "fp32", "ones", 1.0)]
        if fam == "moe":
            e = cfg["moe"]["n_experts"]
            out += [(p + "moe.router", (d, e), "fp32", "normal", 1.0),
                    (p + "moe.w_gate", (e, d, f), "bf16", "normal", 1.0),
                    (p + "moe.w_up", (e, d, f), "bf16", "normal", 1.0),
                    (p + "moe.w_down", (e, f, d), "bf16", "normal", 1.0)]
        else:
            out += [(p + "mlp.w_gate", (d, f), "bf16", "normal", 1.0),
                    (p + "mlp.w_up", (d, f), "bf16", "normal", 1.0),
                    (p + "mlp.w_down", (f, d), "bf16", "normal", 1.0)]
        if fam == "hybrid":
            s = cfg["ssm"]
            di = s["n_heads"] * s["head_dim"]
            out += [(p + "ssm.in_proj", (d, di), "bf16", "normal", 1.0),
                    (p + "ssm.gate_proj", (d, di), "bf16", "normal", 1.0),
                    (p + "ssm.conv_w", (s["conv_width"], di), "bf16", "normal", 0.5),
                    (p + "ssm.dt_proj", (d, s["n_heads"]), "bf16", "normal", 1.0),
                    (p + "ssm.dt_bias", (s["n_heads"],), "fp32", "zeros", 1.0),
                    (p + "ssm.b_proj", (d, s["state_dim"]), "bf16", "normal", 1.0),
                    (p + "ssm.c_proj", (d, s["state_dim"]), "bf16", "normal", 1.0),
                    (p + "ssm.a_log", (s["n_heads"],), "fp32", "decay", 1.0),
                    (p + "ssm.d_skip", (s["n_heads"],), "fp32", "ones", 1.0),
                    (p + "ssm.out_proj", (di, d), "bf16", "normal", 1.0),
                    (p + "attn_branch_norm.scale", (d,), "fp32", "ones", 1.0),
                    (p + "ssm_branch_norm.scale", (d,), "fp32", "ones", 1.0)]
    out.append(("final_norm.scale", (d,), "fp32", "ones", 1.0))
    if not cfg.get("tie_embeddings"):
        out.append(("unembed", (d, v), "bf16", "normal", 1.0))
    return out


# --- products ---------------------------------------------------------------------

def _fp8(x: torch.Tensor) -> torch.Tensor:
    s = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (x.detach() / s).to(torch.float8_e4m3fn).float() * s
    return x + (q - x).detach()


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    a, b = a.float(), b.float()
    if precision == "fp8":
        a, b = _fp8(a), _fp8(b)
    elif precision != "fp32":
        raise ValueError(precision)
    return torch.matmul(a, b)


def rms(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D) at positions 0..S-1, split-half rotation."""
    s, d = x.shape[1], x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    sin, cos = torch.sin(ang)[None, :, None, :], torch.cos(ang)[None, :, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, window: Optional[int], precision: str) -> torch.Tensor:
    """q (B, S, H, D), k and v (B, S, Hkv, D) -> (B, S, H, D); a masked
    softmax over blocks of batch rows."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    i = torch.arange(s, device=q.device)
    mask = i[:, None] >= i[None, :]
    if window is not None:
        mask &= (i[:, None] - i[None, :]) < window
    rows = max(1, ATTN_BLOCK_BYTES // (h * s * s * 4))
    outs = []
    for r0 in range(0, b, rows):
        qb = q[r0:r0 + rows].transpose(1, 2)                                  # (r, H, S, D)
        kb = k[r0:r0 + rows].transpose(1, 2).repeat_interleave(g, dim=1)
        vb = v[r0:r0 + rows].transpose(1, 2).repeat_interleave(g, dim=1)
        sc = mm(qb, kb.transpose(-1, -2), precision) / math.sqrt(d)
        p = torch.softmax(sc.masked_fill(~mask, float("-inf")), dim=-1)
        outs.append(mm(p, vb, precision).transpose(1, 2))
    return torch.cat(outs, dim=0)


def swiglu(x, wg, wu, wd, precision):
    return mm(F.silu(mm(x, wg, precision)) * mm(x, wu, precision), wd, precision)


def mamba(w, p: str, cfg, x, precision: str) -> torch.Tensor:
    s = cfg["ssm"]
    nh, hp, n, cw = s["n_heads"], s["head_dim"], s["state_dim"], s["conv_width"]
    b, t, _ = x.shape
    xs = mm(x, w[p + "in_proj"], precision)
    z = mm(x, w[p + "gate_proj"], precision)
    conv = w[p + "conv_w"].float()
    xp = F.pad(xs, (0, 0, cw - 1, 0))
    u = sum(xp[:, cw - 1 - j: cw - 1 - j + t] * conv[j] for j in range(cw))
    u = F.silu(u)
    dt = F.softplus(mm(x, w[p + "dt_proj"], precision) + w[p + "dt_bias"].float())     # (B, T, H)
    logdec = -torch.exp(w[p + "a_log"].float()) * dt
    bm, cm = mm(x, w[p + "b_proj"], precision), mm(x, w[p + "c_proj"], precision)
    uh = u.reshape(b, t, nh, hp)
    xin = dt[..., None] * uh
    state = x.new_zeros(b, nh, hp, n)
    ys = []
    for c0 in range(0, t, SCAN_CHUNK):
        c1 = min(t, c0 + SCAN_CHUNK)
        la = torch.cumsum(logdec[:, c0:c1], dim=1)                                     # (B, L, H)
        tri = torch.tril(torch.ones(c1 - c0, c1 - c0, dtype=torch.bool, device=x.device))
        rel = torch.where(tri[None, :, :, None], la[:, :, None, :] - la[:, None, :, :],
                          torch.full((), float("-inf"), device=x.device))
        cb = torch.einsum("btn,bsn->bts", cm[:, c0:c1], bm[:, c0:c1])
        y = torch.einsum("btsh,bshp->bthp", torch.exp(rel) * cb[..., None], xin[:, c0:c1])
        y = y + torch.exp(la)[..., None] * torch.einsum("btn,bhpn->bthp", cm[:, c0:c1], state)
        ys.append(y)
        carry = torch.exp(la[:, -1:, :] - la)[..., None] * xin[:, c0:c1]               # (B, L, H, P)
        state = (torch.exp(la[:, -1, :])[:, :, None, None] * state
                 + torch.einsum("blhp,bln->bhpn", carry, bm[:, c0:c1]))
    y = torch.cat(ys, dim=1) + w[p + "d_skip"].float()[None, None, :, None] * uh
    y = y.reshape(b, t, nh * hp) * F.silu(z)
    return mm(y, w[p + "out_proj"], precision)


def moe(w, p: str, cfg, x, groups: Sequence[torch.Tensor], precision: str) -> torch.Tensor:
    """x (B, T, d); ``groups``: index tensors into the B·T flattened tokens,
    each one group of the routing."""
    m = cfg["moe"]
    e_n, k, cf = m["n_experts"], m["top_k"], m["capacity_factor"]
    b, t, d = x.shape
    flat = x.reshape(b * t, d)
    tok, exp_, gate = [], [], []
    for idx in groups:
        g = idx.numel()
        probs = torch.softmax(mm(flat[idx], w[p + "router"], precision), dim=-1)
        top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
        top_p, top_i = top_p[:, :k], top_i[:, :k]
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
        cap = max(int(math.ceil(g * k * cf / e_n)), k)
        oh = F.one_hot(top_i, e_n)                                    # (g, k, E)
        slot_major = oh.transpose(0, 1).reshape(k * g, e_n)
        pos = (torch.cumsum(slot_major, 0) - slot_major).reshape(k, g, e_n).transpose(0, 1)
        keep = (pos * oh).sum(-1) < cap                                # (g, k)
        tt, kk = keep.nonzero(as_tuple=True)
        tok.append(idx[tt])
        exp_.append(top_i[tt, kk])
        gate.append(top_p[tt, kk])
    tok, exp_, gate = torch.cat(tok), torch.cat(exp_), torch.cat(gate)
    out = torch.zeros_like(flat)
    for e in range(e_n):
        sel = exp_ == e
        if not bool(sel.any()):
            continue
        xe = flat[tok[sel]]
        ye = swiglu(xe, w[p + "w_gate"][e], w[p + "w_up"][e], w[p + "w_down"][e], precision)
        out = out.index_add(0, tok[sel], ye * gate[sel][:, None])
    return out.reshape(b, t, d)


def block(w, i: int, cfg, x, window, groups, precision: str) -> torch.Tensor:
    p = f"blocks.{i}."
    hd = head_dim(cfg)
    b, t, _ = x.shape
    xn = rms(x, w[p + "ln1.scale"])
    theta = cfg.get("rope_theta", 10000.0)
    q = rope(mm(xn, w[p + "attn.wq"], precision).reshape(b, t, cfg["n_heads"], hd), theta)
    k = rope(mm(xn, w[p + "attn.wk"], precision).reshape(b, t, cfg["n_kv_heads"], hd), theta)
    v = mm(xn, w[p + "attn.wv"], precision).reshape(b, t, cfg["n_kv_heads"], hd)
    a = mm(attention(q, k, v, window, precision).reshape(b, t, -1), w[p + "attn.wo"], precision)
    if cfg["family"] == "hybrid":
        m = mamba(w, p + "ssm.", cfg, xn, precision)
        a = 0.5 * (rms(a, w[p + "attn_branch_norm.scale"]) + rms(m, w[p + "ssm_branch_norm.scale"]))
    x = x + a
    xn = rms(x, w[p + "ln2.scale"])
    if cfg["family"] == "moe":
        return x + moe(w, p + "moe.", cfg, xn, groups, precision)
    return x + swiglu(xn, w[p + "mlp.w_gate"], w[p + "mlp.w_up"], w[p + "mlp.w_down"], precision)


def hidden(w: Dict[str, torch.Tensor], cfg, tokens: torch.Tensor, precision: str = "fp32",
           groups: Optional[Sequence[torch.Tensor]] = None, layer_checkpoint: bool = False
           ) -> torch.Tensor:
    """The final normed hidden states (B, T, d) in float32 of ``tokens``
    (B, T).  ``groups``: the MoE's routing groups (see :func:`moe`);
    ``layer_checkpoint``: recompute each layer in the backward."""
    x = w["embed"].float()[tokens.long()]
    for i, window in enumerate(layer_windows(cfg)):
        if layer_checkpoint:
            x = ckpt.checkpoint(block, w, i, cfg, x, window, groups, precision, use_reentrant=False)
        else:
            x = block(w, i, cfg, x, window, groups, precision)
    return rms(x, w["final_norm.scale"])


def unembed(w) -> torch.Tensor:
    return w["embed"].t() if "unembed" not in w else w["unembed"]


def logits(w, h: torch.Tensor, precision: str = "fp32") -> torch.Tensor:
    """The head over final hidden states ``h``, in float32."""
    return mm(h, unembed(w), precision)


def serve_groups(cfg, batch: int, prompt: int, steps: int, device) -> List[torch.Tensor]:
    """The MoE's routing groups of one serving call over its B x (prompt +
    steps) tokens: the prefill's tokens flattened row by row and cut into
    groups of ``group_size`` (or all of them, if fewer), then each decode
    step's B tokens as one group."""
    t = prompt + steps
    gs = cfg["moe"]["group_size"]
    pre = (torch.arange(batch, device=device)[:, None] * t
           + torch.arange(prompt, device=device)[None, :]).reshape(-1)
    g = min(gs, pre.numel())
    if pre.numel() % g:
        raise ValueError(f"{pre.numel()} prefill tokens do not fill groups of {g}")
    groups = list(pre.split(g))
    rows = torch.arange(batch, device=device) * t
    if batch > gs:
        raise ValueError(f"a decode step of {batch} tokens is more than one group of {gs}")
    groups += [rows + prompt + j for j in range(steps)]
    return groups
