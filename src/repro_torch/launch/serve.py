"""Serving launcher: batched greedy generation with the serving engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b --smoke \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch deepseek-v2-236b --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \\
      --smoke --device cpu

The JAX package's ``launch/serve.py`` with the same flags, plus
``--device`` (``cuda`` unless ``cpu`` is asked for; ``cuda`` without a
card raises).  Parameters are random, drawn from ``--seed`` on the
device.  The prompts are tokens, so a frontend arch (qwen2-vl-7b,
hubert-xlarge) is refused with a ``ValueError`` before any weight is
drawn.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--n-requests", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def serve_requests(eng, vocab: int, n_requests: int, max_new: int,
                   seed: int, log=print) -> List[List[int]]:
    """Run ``n_requests`` random prompts of 2 to 8 tokens (drawn from
    ``seed``) through ``eng`` a batch at a time; every request's tokens."""
    rng = np.random.default_rng(seed)
    batch = eng.sc.batch
    outs: List[List[int]] = []
    while len(outs) < n_requests:
        nbatch = min(batch, n_requests - len(outs))
        prompts = [rng.integers(1, vocab, size=rng.integers(2, 9))
                   for _ in range(nbatch)]
        for i, o in enumerate(eng.run(prompts, max_new=max_new)):
            log(f"req {len(outs)}: prompt {len(prompts[i])} toks -> "
                f"{o[:8]}{'...' if len(o) > 8 else ''}")
            outs.append(o)
    return outs


def main(argv: Optional[Sequence[str]] = None) -> List[List[int]]:
    args = parse_args(argv)

    import torch

    from repro_torch import configs, resolve_device
    from repro_torch.dist.sharding import Runtime
    from repro_torch.models import model as model_mod
    from repro_torch.serve.engine import (ServeConfig, ServingEngine,
                                          check_token_model)

    cfg = configs.get_smoke(args.arch) if args.smoke \
        else configs.get_config(args.arch)
    check_token_model(cfg)
    dev = resolve_device(args.device)
    rt = Runtime(mesh=None)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = model_mod.init_params(cfg, rt, gen, dev)
    eng = ServingEngine(cfg, rt, params,
                        ServeConfig(batch=args.batch, max_len=args.max_len),
                        device=dev)
    del params
    t0 = time.monotonic()
    outs = serve_requests(eng, cfg.vocab, args.n_requests, args.max_new,
                          args.seed)
    dt = time.monotonic() - t0
    toks = args.n_requests * (args.max_new + 1)
    print(f"{args.n_requests} requests, {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s) on {dev}")
    return outs


if __name__ == "__main__":
    main()
