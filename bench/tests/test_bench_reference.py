"""The plain reference against the program's CPU path (the kernels' plain
versions) in float32 at a tiny size: the same loss, gradients and logits."""

import numpy as np
import torch

from bench.reference import plain_lm
from bench.tests.tiny import tiny_ctx
from bench.weights import allocate, fill

SEED = 2**31 + 3


def _program(ctx):
    from repro_torch.models.api import build_model

    model = build_model(ctx.arch, device="cpu", dtype=torch.float32)
    w = allocate(ctx.plist, "cpu")
    fill(w, ctx.plist, SEED)
    with torch.no_grad():
        for name, p in model.lm.named_parameters():
            p.copy_(w[name])
    return model, {n: t.float() for n, t in w.items()}


def test_hymba_loss_and_gradients_match_the_program():
    ctx = tiny_ctx("hymba-1.5b.train", SEED)
    model, w = _program(ctx)
    model.trainable()
    g = torch.Generator().manual_seed(1)
    rows = torch.randint(0, ctx.cfg["vocab"], (2, 65), generator=g)
    batch = {"tokens": rows[:, :-1], "labels": rows[:, 1:]}
    loss = model.train_loss(None, batch)
    names = [n for n, _ in model.lm.named_parameters()]
    got = torch.autograd.grad(loss, list(model.lm.parameters()))
    params = {n: t.clone().requires_grad_(True) for n, t in w.items()}
    h = plain_lm.hidden(params, ctx.cfg, batch["tokens"], layer_checkpoint=True)
    logits = plain_lm.logits(params, h)
    ref_loss = torch.nn.functional.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                                 batch["labels"].reshape(-1))
    want = torch.autograd.grad(ref_loss, [params[n] for n in names])
    assert abs(float(loss) - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    for n, a, b in zip(names, got, want):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()) + 1e-9, n


def test_mixtral_prefill_and_decode_logits_match_the_program():
    ctx = tiny_ctx("mixtral-8x22b.decode", SEED)
    t = ctx.traffic
    model, w = _program(ctx)
    rng = np.random.default_rng(5)
    prompt = torch.from_numpy(rng.integers(0, ctx.cfg["vocab"], (t["batch"], t["prompt"])))
    logits, caches = model.prefill({"tokens": prompt}, t["cache_len"])
    outs, toks = [logits[:, -1]], [logits[:, -1].argmax(-1)]
    for i in range(t["max_new"] - 1):
        lg, caches = model.decode_step(caches, toks[-1][:, None].to(torch.int32), t["prompt"] + i)
        outs.append(lg[:, -1])
        toks.append(lg[:, -1].argmax(-1))
    got = torch.stack(outs, dim=1)
    served = torch.stack(toks, dim=1)
    seq = torch.cat([prompt, served[:, :-1]], dim=1)
    groups = plain_lm.serve_groups(ctx.cfg, t["batch"], t["prompt"], t["max_new"] - 1, "cpu")
    with torch.no_grad():
        h = plain_lm.hidden(w, ctx.cfg, seq, groups=groups)
        want = plain_lm.logits(w, h[:, t["prompt"] - 1:])
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_hymba_prefill_logits_match_the_program():
    ctx = tiny_ctx("hymba-1.5b.train", SEED)
    model, w = _program(ctx)
    # a prompt longer than the window, so windowed and full layers differ
    prompt = torch.from_numpy(np.random.default_rng(6).integers(0, ctx.cfg["vocab"], (2, 80)))
    logits, _ = model.prefill({"tokens": prompt}, 81)
    with torch.no_grad():
        want = plain_lm.logits(w, plain_lm.hidden(w, ctx.cfg, prompt)[:, -1:])
    assert float((logits - want).abs().max()) <= 1e-4 * float(want.abs().max())
