"""End-to-end training driver with Poplar-journaled fault tolerance.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --steps 100 --batch 8 --seq 2048 --journal-dir build/journal \
        --journal-lanes 4 --journal-slices 22 --journal-buffer-mb 64

* runs on the card by default (``--device cuda``); ``--device cpu --reduced``
  runs a tiny same-family config on the CPU with the plain versions;
* restores from the journal automatically if one exists
  (checkpoint/restart): parameters, optimizer state and the data cursor;
* journals ``{params, opt, data}`` every ``--save-every`` steps (and at the
  last step), asynchronously, and waits for the last step's commit;
* a record larger than a lane's buffer raises: at full width, size
  ``--journal-buffer-mb`` and ``--journal-slices`` so the largest slice of
  the largest leaf fits (tinyllama-1.1b: 64 MiB and 22 slices).

The port of ``repro/launch/train.py``; the reference's ``--attn-impl`` and
``--mixer-impl`` choose among variants the port does not have (it has one
attention path), and its ``--lanes`` is ``--journal-lanes``.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional


def main(argv=None) -> int:
    import torch

    from ..configs.base import reduced as make_reduced
    from ..configs.registry import get_config
    from ..data.pipeline import DataConfig, TokenPipeline
    from ..journal import PoplarCheckpointManager, restore_latest, to_pytree
    from ..models.api import build_model
    from ..models.weights import to_reference
    from ..optim import adamw
    from ..train.step import make_train_step
    from ..tree import tree_leaves, tree_map

    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true", help="tiny same-family config (CPU)")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(dtypes))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--journal-dir", default=None)
    ap.add_argument("--journal-lanes", type=int, default=2)
    ap.add_argument("--journal-slices", type=int, default=0, help="0: one slice per lane")
    ap.add_argument("--journal-buffer-mb", type=int, default=8)
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=0, help="override reduced width")
    ap.add_argument("--n-layers", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        overrides = {}
        if args.d_model:
            overrides.update(d_model=args.d_model, head_dim=max(16, args.d_model // 4),
                             d_ff=args.d_model * 3)
        if args.n_layers:
            overrides["n_layers"] = args.n_layers
        cfg = make_reduced(cfg, **overrides)

    model = build_model(cfg, device=args.device, dtype=dtypes[args.dtype])
    dev = model.device
    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=10, total_steps=max(args.steps, 100))
    step_fn = make_train_step(model, opt_cfg)
    data_cfg = DataConfig(vocab=cfg.vocab, batch=args.batch, seq_len=args.seq)

    model.init(torch.Generator(device=dev).manual_seed(args.seed))
    params = to_reference(model, device=dev)
    opt_state = adamw.init(params, opt_cfg)
    start_step = 0
    pipe = TokenPipeline(data_cfg)

    mgr: Optional[PoplarCheckpointManager] = None
    if args.journal_dir:
        restored = restore_latest(args.journal_dir)
        if restored is not None:
            rstep, flat, meta = restored
            state_like = {"params": params, "opt": opt_state, "data": pipe.state()}
            tree = to_pytree(flat, state_like)
            params = tree_map(lambda t: t.to(dev), tree["params"])
            opt_state = tree_map(lambda t: t.to(dev), tree["opt"])
            pipe = TokenPipeline.restore(data_cfg, {k: v.numpy() for k, v in tree["data"].items()})
            start_step = rstep + 1
            print(f"[restore] resumed from journaled step {rstep} "
                  f"(cursor={pipe.cursor}, meta={meta})", flush=True)
        mgr = PoplarCheckpointManager(
            args.journal_dir, n_lanes=args.journal_lanes, n_slices=args.journal_slices,
            buffer_capacity=args.journal_buffer_mb << 20)

    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"[train] arch={cfg.name} params={n_params/1e6:.2f}M device={dev} "
          f"steps {start_step}..{args.steps} batch={args.batch}x{args.seq}", flush=True)

    t0 = time.perf_counter()
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in pipe.next_batch().items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])          # synchronises with the card
            tps = args.batch * args.seq * (step - start_step + 1) / (time.perf_counter() - t0)
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} tok/s {tps:,.0f}", flush=True)
        if mgr is not None and (step % args.save_every == 0 or step == args.steps - 1):
            mgr.save(step, {"params": params, "opt": opt_state, "data": pipe.state()},
                     {"loss": float(metrics["loss"])})
    if mgr is not None:
        if args.steps > start_step:
            mgr.wait_for_commit(args.steps - 1, timeout=600)
        print(f"[journal] last committed step: {mgr.last_committed_step()}", flush=True)
        mgr.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
