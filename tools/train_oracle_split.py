#!/usr/bin/env python3
"""Split the full-width float32 training gradient oracle of ``chip_smoke.py``
by component, to show which kernel's Function its error comes from.

Run from the repository root on a machine with a CUDA card:

    python3 tools/train_oracle_split.py [--arch hymba-1.5b] [--layers 0]

The oracle's model and batch (full width, float32, TF32 off, weights from
the smoke's seed, one batch of 1 x 2048 tokens) take one ``train_loss`` and
backward per side:

* ``plain``: every kernel's training Function swapped for autograd through
  its plain version (the oracle's reference side);
* ``kernels``: ``_Flash``, ``_SsmScan`` and ``_Wkv6`` (each kernel forward,
  its torch-op backward), twice, to show the card's run-to-run spread;
* ``attention_plain`` and ``mixer_plain``: only attention, or only the scan
  and wkv6, swapped for the plain version.

For each side against ``plain`` it prints the loss difference and the
largest leaf error relative to that leaf's largest |g| (the oracle's
measure), the leaves with the largest such errors, and for the worst leaf
its error and largest |g| per stacked layer.  The last line is one JSON
object.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import torch

import chip_smoke as cs


@contextlib.contextmanager
def _swapped(attention: bool, mixer: bool):
    saved = cs.lm_mod.attend, cs.ssm_mod._SsmScan, cs.rwkv_mod._Wkv6
    if attention:
        cs.lm_mod.attend = cs._plain_attend
    if mixer:
        cs.ssm_mod._SsmScan, cs.rwkv_mod._Wkv6 = cs._PlainScan, cs._PlainWkv6
    try:
        yield
    finally:
        cs.lm_mod.attend, cs.ssm_mod._SsmScan, cs.rwkv_mod._Wkv6 = saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--layers", type=int, default=0, help="a depth cut (0: full depth)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_oracle_split: no CUDA device is available", file=sys.stderr)
        return 1
    smi = cs._smi()
    print(smi)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cs.get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = cs.build_model(cfg, device=dev, dtype=torch.float32)
    model.init(torch.Generator(device=dev).manual_seed(args.seed + 1))
    params = cs.to_reference(model, device=dev)
    batch = cs._train_batch(cs.TokenPipeline(cs.DataConfig(
        vocab=cfg.vocab, batch=1, seq_len=cs.TRAIN_SEQ, seed=args.seed)), dev, cfg,
        np.random.default_rng(args.seed))
    keys = [k for k, _ in cs.keystr_items(params)]
    sides = {}
    for name, attention, mixer in (("plain", True, True), ("kernels", False, False),
                                   ("kernels_again", False, False),
                                   ("attention_plain", True, False), ("mixer_plain", False, True)):
        with _swapped(attention, mixer):
            live = cs.tree_map(lambda p: p.detach().requires_grad_(True), params)
            loss = model.train_loss(live, batch)
            grads = torch.autograd.grad(loss, cs.tree_leaves(live))
        sides[name] = (float(loss), grads)
    loss_p, g_p = sides.pop("plain")
    report = {"arch": cfg.name, "layers": cfg.n_layers, "card": smi, "sides": {}}
    for name, (loss, grads) in sides.items():
        rows = []
        for key, a, b in zip(keys, grads, g_p):
            rows.append((float((a - b).abs().max() / b.abs().max().clamp_min(1e-30)), key, a, b))
        rows.sort(key=lambda r: -r[0])
        rel, key, a, b = rows[0]
        per_layer = []
        if a.dim() >= 2 and key.startswith("['groups']"):
            for i in range(a.shape[0]):
                per_layer.append((i, float((a[i] - b[i]).abs().max()), float(b[i].abs().max())))
        report["sides"][name] = dict(
            loss_rel_err=abs(loss - loss_p) / abs(loss_p),
            top=[(k, r) for r, k, _, _ in rows[:8]], worst_per_layer=per_layer)
        print(f"{name} vs plain: loss rel {abs(loss - loss_p) / abs(loss_p):.3g}; largest leaf "
              f"errors {[(k, f'{r:.3g}') for r, k, _, _ in rows[:6]]} | {smi}")
        if per_layer:
            print(f"  {key} per layer (index, max |err|, max |g|): "
                  f"{[(i, f'{e:.3g}', f'{g:.3g}') for i, e, g in per_layer]}")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
