"""Closed-loop serving: one ``ServeEngine.generate`` call after another,
each a batch of prompts of the cell's length, greedy, ``max_new`` tokens.

The prompts are uniform token ids drawn from the seed on the host, a pool
of distinct batches; each call takes the next, moves it to the card inside
the timed span and ends when its tokens are on the host.  A request's time
to first token runs from the call into ``generate`` to its first token on
the host; with ``max_new`` 1 that is the call.  After the window a sample
of the finished calls, drawn from the seed, is run through the reference
over each prompt and its served tokens.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bench.weights import allocate, fill


class State:
    pass


def prompts(ctx):
    t = ctx.traffic
    rng = np.random.default_rng(ctx.data_seed)
    return rng.integers(0, ctx.cfg["vocab"], (t["pool"], t["batch"], t["prompt"]), dtype=np.int32)


def setup(ctx, device="cuda"):
    from repro_torch.models.api import build_model
    from repro_torch.models.serve_llm import ServeEngine

    t = ctx.traffic
    st = State()
    st.device = device
    st.model = build_model(ctx.arch, device=device, dtype=torch.bfloat16)
    fill(dict(st.model.lm.named_parameters()), ctx.plist, ctx.seed)
    st.engine = ServeEngine(st.model, cache_len=t["cache_len"])
    # keep each call's prefill logits (the first token's), to judge them
    prefill = st.model.prefill

    def kept_prefill(batch, cache_len):
        logits, caches = prefill(batch, cache_len)
        st.first_logits = logits[:, -1]
        return logits, caches

    st.model.prefill = kept_prefill
    st.generate = st.engine.generate
    st.pool = prompts(ctx)
    st.i = 0
    st.calls = []
    # warm the cell's shapes with one call of ``warm_new`` tokens (a whole
    # call where the first full-length call runs slower than the rest)
    st.generate({"tokens": torch.from_numpy(st.pool[0]).to(device)},
                max_new=min(t["max_new"], t["warm_new"]))
    if device == "cuda":
        torch.cuda.synchronize()
    return st


def call(ctx, st):
    t = ctx.traffic
    k = st.i % st.pool.shape[0]
    t0 = time.perf_counter()
    res = st.generate({"tokens": torch.from_numpy(st.pool[k]).to(st.device)}, max_new=t["max_new"])
    seconds = time.perf_counter() - t0
    st.i += 1
    unit = {"seconds": seconds, "prefill_s": res.prefill_s, "decode_s": res.decode_s,
            "decode_steps": t["max_new"] - 1, "pool": k, "tokens": res.tokens,
            "logits": st.first_logits}
    st.calls.append(unit)
    return unit


def window(ctx, st, seconds: float):
    t = ctx.traffic
    first = len(st.calls)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        call(ctx, st)
    span = time.perf_counter() - t0
    calls = st.calls[first:]
    reqs = len(calls) * t["batch"]
    metrics = {}
    e2e = {m["name"] for m in ctx.end_to_end}
    if "ttft_p95_ms" in e2e and t["max_new"] == 1:
        ttft = np.repeat([1e3 * c["seconds"] for c in calls], t["batch"])
        metrics["ttft_p95_ms"] = (float(np.percentile(ttft, 95)), "ms")
    if "output_tok_s" in e2e:
        metrics["output_tok_s"] = (reqs * t["max_new"] / span, "tokens/s")
    st.window_calls = (first, len(st.calls))
    return {"attempted": reqs, "failed": 0, "metrics": metrics}


def traced_units(ctx, st):
    first = len(st.calls)
    st.traced_from = getattr(st, "traced_from", first)
    for _ in range(ctx.traffic["trace_calls"]):
        call(ctx, st)
    st.window_calls = (st.traced_from, len(st.calls))
    return [{k: v for k, v in c.items() if k not in ("tokens", "logits")} for c in st.calls[first:]]


def release(ctx, st):
    t = ctx.traffic
    lo, hi = st.window_calls
    rng = np.random.default_rng([ctx.seed, 2])
    n = min(t["sample_calls"], hi - lo)
    picked = sorted(rng.choice(np.arange(lo, hi), size=n, replace=False).tolist())
    return {"sample": [(st.pool[st.calls[i]["pool"]], st.calls[i]["tokens"],
                        st.calls[i]["logits"].float().cpu()) for i in picked]}


@torch.no_grad()
def reference_logits(ctx, w, prompt, served, device, precision="fp32"):
    """The reference over one call's prompts and served tokens: at each
    served position, the logits (B, n, V) that chose it."""
    ref, cfg = ctx.ref, ctx.cfg
    b, p = prompt.shape
    n = served.shape[1]
    tokens = torch.from_numpy(np.concatenate([prompt, served[:, :-1]], axis=1)).to(device)
    groups = ref.serve_groups(cfg, b, p, n - 1, device) if cfg.get("moe") else None
    h = ref.hidden(w, cfg, tokens, precision=precision, groups=groups)
    return ref.logits(w, h[:, p - 1:], precision)


def served_gaps(logits, served):
    """Each served token's gap below the reference's best logit, and its
    rank (how many tokens the reference puts above it)."""
    srv = torch.as_tensor(served, device=logits.device).long()
    best = logits.max(dim=-1).values
    got = torch.gather(logits, -1, srv[..., None])[..., 0]
    return best - got, (logits > got[..., None]).sum(-1)


def summary(gaps, ranks, errs, mismatch=0):
    """The numbers of a sample: the served tokens' gaps and ranks, each
    request's first-token logits' largest error (its worst, 90th percentile
    and median request), and how many first tokens are not the first choice
    of the logits they were served from."""
    g, r, e = torch.cat(gaps).double(), torch.cat(ranks), torch.cat(errs).double()
    return {"gap_max": float(g.max()), "gap_mean": float(g.mean()),
            "off_first": float((r > 0).double().mean()), "rank_max": float(r.max()),
            "logit_err_max": float(e.max()), "logit_err_p90": float(torch.quantile(e, 0.9)),
            "logit_err_med": float(e.median()),
            "first_not_argmax": float(mismatch)}


def logit_errors(got, want):
    """Each request's largest first-token logit error: (B, V) each; a
    request the program gave no logits for errs by infinity."""
    if got.shape != want.shape:
        return torch.full((want.shape[0],), float("inf"))
    return (got.to(want.device).float() - want).abs().amax(dim=-1).cpu()


def compare_call(ctx, w, prompt, served, first, device):
    """The reference over one sampled call: its logits at the served
    positions, and the call's served-token gaps and ranks, first-token
    logit errors, first tokens off their logits' first choice and whether
    everything was finite."""
    mismatch = (int((first.argmax(dim=-1).numpy() != served[:, 0]).sum())
                if first.shape[0] == served.shape[0] else served.shape[0])
    logits = reference_logits(ctx, w, prompt, served, device)
    finite = bool(torch.isfinite(logits).all()) and bool(torch.isfinite(first).all())
    g, r = served_gaps(logits, served)
    return logits, (g.flatten().cpu(), r.flatten().cpu(), logit_errors(first, logits[:, 0]),
                    mismatch, finite)


def check(ctx, kept, device="cuda"):
    from bench.reference.plain_lm import fp32_matmuls

    fp32_matmuls()
    w = allocate(ctx.plist, device)
    fill(w, ctx.plist, ctx.seed)
    rows = []
    for prompt, served, first in kept["sample"]:
        logits, row = compare_call(ctx, w, prompt, served, first, device)
        rows.append(row)
        del logits
    del w
    return numbers_of(rows)


def numbers_of(rows):
    """``(numbers, detail)`` of the sampled calls' rows of
    :func:`compare_call`; every number NaN where anything was not finite."""
    gaps, ranks, errs, mismatch, finite = zip(*rows)
    numbers = summary(gaps, ranks, errs, sum(mismatch))
    if not all(finite):
        numbers = {k: float("nan") for k in numbers}
    return numbers, {"served_tokens": int(sum(g.numel() for g in gaps))}
