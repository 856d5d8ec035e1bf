"""Closed-loop training: one ``make_train_step`` step after another.

Set-up builds the step with its model and optimizer state, fills the
weights from the seed and drives the same object through the first
``checked_steps`` steps, which warm every shape and which the reference
follows: each step's loss, the first gradient as the optimizer got it
(its first moment after one step over ``1 - b1``) and the parameters'
change after the checked steps, each by leaf of the optimizer's tree.
The window then runs whole steps until ``--seconds`` have passed; every
step ends in a synchronise.  Every step's rows differ from every other's.
"""

from __future__ import annotations

import time

import torch

from bench import judge
from bench.weights import allocate, fill


def _leaves(tree, prefix=""):
    """``(dotted name, tensor)`` of a nested dict/list tree, in key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def layer_map(params):
    """Each optimizer leaf -> the reference's weights it stacks:
    ``groups.{g}.{path}`` holds layers off..off+n-1 of ``blocks.{i}.{path}``
    (the groups are consecutive runs of layers), a top-level leaf itself."""
    out, group_size = {}, {}
    for name, t in _leaves(params):
        parts = name.split(".")
        if parts[0] == "groups":
            group_size.setdefault(int(parts[1]), t.shape[0])
    starts, acc = {}, 0
    for g in sorted(group_size):
        starts[g] = acc
        acc += group_size[g]
    for name, t in _leaves(params):
        parts = name.split(".")
        if parts[0] == "groups":
            g, path = int(parts[1]), ".".join(parts[2:])
            out[name] = [f"blocks.{starts[g] + i}.{path}" for i in range(t.shape[0])]
        else:
            out[name] = [name]
    return out


def batches(ctx, device):
    """``(pool, B, S + 1)`` token ids, uniform over the vocabulary, from
    the seed; step i reads row block i."""
    t = ctx.traffic
    gen = torch.Generator(device=device)
    gen.manual_seed(ctx.data_seed)
    return torch.randint(0, ctx.cfg["vocab"], (t["pool"], t["batch"], t["seq"] + 1),
                         generator=gen, device=device, dtype=torch.int64)


def _batch(pool, i):
    rows = pool[i % pool.shape[0]]
    return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


class State:
    pass


def setup(ctx, device="cuda"):
    from repro_torch.models.api import build_model
    from repro_torch.models.weights import to_reference
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step

    t = ctx.traffic
    st = State()
    model = build_model(ctx.arch, device=device, dtype=torch.bfloat16,
                        remat_policy=t["remat_policy"])
    fill(dict(model.lm.named_parameters()), ctx.plist, ctx.seed)
    st.params = to_reference(model, release=True)
    st.opt_cfg = adamw.AdamWConfig(**t["optimizer"])
    st.opt = adamw.init(st.params, st.opt_cfg)
    st.model = model
    st.step = make_train_step(model, st.opt_cfg)
    st.pool = batches(ctx, device)
    st.i = 0
    st.layers = layer_map(st.params)
    losses = []
    b1 = st.opt_cfg.b1
    for k in range(t["checked_steps"]):
        _run_step(st)
        losses.append(float(st.metrics["loss"]))
        if k == 0:
            grad = {n: float(torch.linalg.vector_norm(m.float())) / (1.0 - b1)
                    for n, m in _leaves(st.opt["mu"])}
            grad_norm = float(st.metrics["grad_norm"])
            # the first gradient's direction, as the optimizer holds it (a
            # copy on the host, for the reference to compare with)
            first = {n: m.detach().float().cpu() for n, m in _leaves(st.opt["mu"])}
    # the change of every leaf after the checked steps, from the weights
    # made again from the seed (no copy is held through the steps)
    w0 = allocate(ctx.plist, device)
    fill(w0, ctx.plist, ctx.seed)
    delta = {}
    for name, p in _leaves(st.params):
        sq = 0.0
        for i, ref_name in enumerate(st.layers[name]):
            cur = p[i] if len(st.layers[name]) > 1 or name.startswith("groups") else p
            sq += float(torch.sum(torch.square(cur.float() - w0[ref_name].float())))
        delta[name] = sq ** 0.5
    del w0
    st.readings = {"loss": losses, "grad": grad, "delta": delta, "grad_norm": grad_norm}
    st.first_moment = first
    _sync(st)
    return st


def _sync(st):
    if st.pool.is_cuda:
        torch.cuda.synchronize()


def _run_step(st):
    st.params, st.opt, st.metrics = st.step(st.params, st.opt, _batch(st.pool, st.i))
    st.i += 1


def window(ctx, st, seconds: float):
    t = ctx.traffic
    steps = 0
    t0 = time.perf_counter()
    while True:
        _run_step(st)
        _sync(st)
        steps += 1
        if time.perf_counter() - t0 >= seconds:
            break
    span = time.perf_counter() - t0
    tokens = steps * t["batch"] * t["seq"]
    return {"attempted": steps, "failed": 0,
            "metrics": {"train_tok_s": (tokens / span, "tokens/s")}}


def traced_units(ctx, st):
    units = []
    for _ in range(ctx.traffic["trace_steps"]):
        t0 = time.perf_counter()
        _run_step(st)
        _sync(st)
        units.append({"seconds": time.perf_counter() - t0})
    return units


def release(ctx, st):
    kept = {"readings": st.readings, "layers": st.layers, "first_moment": st.first_moment,
            "batches": st.pool[:ctx.traffic["checked_steps"]].cpu()}
    return kept


def by_name(first, layers):
    """The program's per-leaf first moments as views by the reference's
    weight names."""
    out = {}
    for leaf, names in layers.items():
        t = first[leaf]
        for i, n in enumerate(names):
            out[n] = t[i] if leaf.startswith("groups") else t
    return out


def cosines(a, b, layers, device):
    """Per optimizer leaf, the cosine between two first gradients given by
    the reference's weight names (stacked as the program stacks them)."""
    out = {}
    for leaf, names in layers.items():
        dot = na = nb = 0.0
        for n in names:
            x, y = a[n].to(device), b[n].to(device)
            dot += float(torch.sum(x * y))
            na += float(torch.sum(x * x))
            nb += float(torch.sum(y * y))
        out[leaf] = dot / max((na * nb) ** 0.5, 1e-30)
    return out


def reference_readings(ctx, batches_host, device, precision="fp32", keep_first=False):
    """The plain reference through the checked steps, in float32 with
    AdamW written out: each step's loss, the first clipped gradient's and
    the change's norms, by the reference's weight names.  Each update is
    computed in float32; the weights the configuration keeps in bfloat16
    are stored so after it."""
    from bench.reference.plain_lm import fp32_matmuls

    fp32_matmuls()
    ref, cfg, o = ctx.ref, ctx.cfg, ctx.traffic["optimizer"]
    w = allocate(ctx.plist, device)
    fill(w, ctx.plist, ctx.seed)
    params = {n: t.float().requires_grad_(True) for n, t in w.items()}
    del w
    start = {n: p.detach().clone() for n, p in params.items()}
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    names = list(params)
    stored_bf16 = {name for name, _, dt, _, _ in ctx.plist if dt == "bf16"}
    losses, grad = [], None
    for step in range(1, batches_host.shape[0] + 1):
        rows = batches_host[step - 1].to(device)
        tokens, labels = rows[:, :-1], rows[:, 1:]
        h = ref.hidden(params, cfg, tokens, precision=precision, layer_checkpoint=True)
        logits = ref.logits(params, h, precision)
        loss = torch.nn.functional.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                                 labels.reshape(-1))
        gs = torch.autograd.grad(loss, [params[n] for n in names])
        del h, logits
        losses.append(float(loss.detach()))
        gnorm = torch.sqrt(sum(torch.sum(g * g) for g in gs))
        scale = torch.clamp(o["grad_clip"] / torch.clamp(gnorm, min=1e-9), max=1.0)
        lr = judge.lr_at(o, step)
        with torch.no_grad():
            if step == 1:
                grad = {n: float(torch.linalg.vector_norm(g * scale)) for n, g in zip(names, gs)}
                grad_norm = float(gnorm)
                first = {n: g.cpu() for n, g in zip(names, gs)} if keep_first else None
            for n, g in zip(names, gs):
                g = g * scale
                m[n].mul_(o["b1"]).add_((1 - o["b1"]) * g)
                v[n].mul_(o["b2"]).add_((1 - o["b2"]) * g * g)
                mhat = m[n] / (1 - o["b1"] ** step)
                vhat = v[n] / (1 - o["b2"] ** step)
                p = params[n]
                p.sub_(lr * (mhat / (torch.sqrt(vhat) + o["eps"]) + o["weight_decay"] * p))
                if n in stored_bf16:        # the weights the configuration keeps in bfloat16
                    p.copy_(p.to(torch.bfloat16).float())
        del gs
    delta = {n: float(torch.linalg.vector_norm(params[n].detach() - start[n])) for n in names}
    return {"loss": losses, "grad": grad, "delta": delta, "grad_norm": grad_norm, "first": first}


def check(ctx, kept, device="cuda"):
    ref = reference_readings(ctx, kept["batches"], device, keep_first=True)
    cos = cosines(by_name(kept["first_moment"], kept["layers"]), ref.pop("first"), kept["layers"],
                  device)
    return judge.train_numbers(kept["readings"], ref, kept["layers"],
                               ctx.traffic["optimizer"]["grad_clip"], cos)
