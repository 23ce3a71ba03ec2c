"""Serving driver: continuous batching under a simulated request load.

Requests arrive Poisson-style into main/priority queues; the engine's
FeedRouter-style admission keeps the decode batch full.  Reports
throughput, time-to-first-token, and priority latency separation.
The port's twin of ``repro/launch/serve.py``: it serves the arch's smoke
config with random weights from ``--seed`` on ``--device`` (default
``cuda``, which raises without a card; ``cpu`` runs the plain path).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
      --requests 32 --max-batch 8 [--device cpu]
"""
from __future__ import annotations

import argparse
import random
import time

import numpy as np
import torch

from repro_torch.config import ServeConfig
from repro_torch.configs import get_arch
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.kernels import resolve_device
from repro_torch.models.model import build_model
from repro_torch.serve.engine import Request, ServeEngine

_PROMPTS = [
    "breaking news alert market update",
    "global economy report earnings",
    "storm warning local county",
    "science study health data",
]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--priority-frac", type=float, default=0.2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    spec = get_arch(args.arch)
    cfg = spec.smoke
    model = build_model(cfg)
    params = model.init_params(
        torch.Generator(device=dev).manual_seed(args.seed), dev)
    tok = HashTokenizer(cfg.vocab)
    eng = ServeEngine(model, params, ServeConfig(
        max_batch=args.max_batch, max_seq_len=256,
        replenish_after=max(1, args.max_batch // 4),
        replenish_timeout_s=0.02), eos_id=-1, device=dev)

    rng = random.Random(args.seed)
    t0 = time.time()
    for i in range(args.requests):
        prio = 0 if rng.random() < args.priority_frac else 1
        prompt = rng.choice(_PROMPTS) + f" request {i}"
        eng.submit(Request(
            rid=i, prompt_tokens=tok.encode(prompt, add_eos=False),
            max_new_tokens=args.max_new, priority=prio,
            arrived_at=time.monotonic()))
    done = eng.run_until_drained()
    wall = time.time() - t0

    ttfts = [(r.first_token_at - r.arrived_at) for r in done]
    p_ttfts = [t for r, t in zip(done, ttfts) if r.priority == 0]
    n_ttfts = [t for r, t in zip(done, ttfts) if r.priority == 1]
    print(f"completed {len(done)}/{args.requests} requests in {wall:.2f}s "
          f"on {dev}")
    print(f"decode steps {eng.steps}; tokens {eng.tokens_generated} "
          f"({eng.tokens_generated/wall:,.1f} tok/s)")
    print(f"batch efficiency: {eng.tokens_generated/max(1,eng.steps):.2f} "
          f"tokens/step (max {args.max_batch})")
    if p_ttfts and n_ttfts:
        print(f"TTFT priority={np.mean(p_ttfts)*1e3:.0f}ms "
              f"normal={np.mean(n_ttfts)*1e3:.0f}ms")
    return done


if __name__ == "__main__":
    main()
