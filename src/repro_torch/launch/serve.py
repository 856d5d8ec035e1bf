"""Serving entry point: batched prefill + greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \\
        --device cpu --reduced

The first two run the full-width model in bfloat16 on the card with
weights drawn from ``--seed``; the third a reduced same-family config on
the CPU (the kernels' plain versions).  ``--arch`` takes every registered
arch; a vlm's patch embeddings and an encoder-decoder's frame embeddings
are drawn from ``--seed`` after the tokens, N(0, 0.02) in bfloat16, as the
reference's serve CLI draws them.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def main(argv=None) -> int:
    from ..configs.base import reduced as make_reduced
    from ..configs.registry import get_config
    from ..models.api import build_model, draw_extras
    from ..models.serve_llm import ServeEngine

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    model = build_model(cfg, device=args.device)
    model.init(torch.Generator(device=model.device).manual_seed(args.seed))
    engine = ServeEngine(model, cache_len=args.cache_len)

    rng = np.random.default_rng(args.seed)
    tokens = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens).to(model.device)}
    batch.update({k: torch.from_numpy(e).to(model.device, torch.bfloat16)
                  for k, e in draw_extras(cfg, rng, args.batch).items()})

    res = engine.generate(batch, max_new=args.max_new)
    where = torch.cuda.get_device_name(model.device) if model.device.type == "cuda" else "cpu"
    print(f"[serve] arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"new={args.max_new} device={where}")
    print(f"  prefill {res.prefill_s*1e3:.1f} ms | decode {res.decode_s*1e3:.1f} ms "
          f"| {res.tokens_per_s:,.1f} tok/s")
    for i in range(min(args.batch, 2)):
        print(f"  sample {i}: {res.tokens[i].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
