"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --smoke \\
      --steps 100 --global-batch 8 --seq 128 --ckpt-dir /tmp/ck
  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --smoke \\
      --device cpu --steps 4 --global-batch 4 --seq 64

The JAX package's ``launch/train.py`` with the same flags, plus
``--device`` (``cuda`` unless ``cpu`` is asked for; ``cuda`` without a
card raises).  ``--smoke`` selects the reduced config.  Fault-tolerance
drills: ``--inject-failure-at N`` crashes mid-run; re-running the same
command resumes from the last committed checkpoint and reproduces the
trajectory.  Prints one JSON line per history entry.  ``--mesh`` (data
and model axes over several devices) raises until ROADMAP A13.5.
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Dict, Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--inject-failure-at", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default="", help="e.g. 2x4 => (data, model)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)
    if args.mesh:
        raise NotImplementedError(
            f"--mesh {args.mesh}: meshes come with ROADMAP A13.5; the port "
            "trains on one device")

    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.dist.sharding import Runtime
    from repro_torch.train.loop import LoopConfig, TrainLoop
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import TrainConfig

    cfg = configs.get_smoke(args.arch) if args.smoke \
        else configs.get_config(args.arch)
    loop = TrainLoop(
        cfg, Runtime(),
        DataConfig(global_batch=args.global_batch, seq_len=args.seq,
                   seed=args.seed),
        TrainConfig(opt=AdamWConfig(lr=args.lr, warmup_steps=args.warmup,
                                    total_steps=args.steps),
                    grad_accum=args.grad_accum),
        LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                   log_every=args.log_every,
                   ckpt_dir=args.ckpt_dir or None,
                   inject_failure_at=args.inject_failure_at),
        device=args.device)
    out = loop.run(seed=args.seed)
    for h in out["history"]:
        print(json.dumps(h))
    if out["stragglers"]:
        print("straggler steps:", out["stragglers"])
    return out


if __name__ == "__main__":
    main()
