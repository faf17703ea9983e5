"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --smoke \\
      --steps 100 --global-batch 8 --seq 128 --ckpt-dir /tmp/ck
  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --smoke \\
      --device cpu --steps 4 --global-batch 4 --seq 64
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \\
      --smoke --device cpu --steps 4 --global-batch 4 --seq 64
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \\
      --smoke --device cpu --steps 4 --global-batch 4 --seq 64
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-7b \\
      --smoke --device cpu --steps 4 --global-batch 4 --seq 64
  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
      -m repro_torch.launch.train --arch yi-9b --smoke --device cpu \\
      --mesh 4 --steps 4 --global-batch 8 --seq 64
  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
      -m repro_torch.launch.train --arch olmoe-1b-7b --smoke --device cpu \\
      --mesh 4 --steps 4 --global-batch 8 --seq 64
  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
      -m repro_torch.launch.train --arch yi-9b --smoke --device cpu \\
      --mesh 2x2 --steps 4 --global-batch 8 --seq 64

The JAX package's ``launch/train.py`` with the same flags, plus
``--device`` (``cuda`` unless ``cpu`` is asked for; ``cuda`` without a
card raises).  ``--smoke`` selects the reduced config.  Fault-tolerance
drills: ``--inject-failure-at N`` crashes mid-run; re-running the same
command resumes from the last committed checkpoint and reproduces the
trajectory.  Prints one JSON line per history entry (with the experts'
load-balance loss ``aux`` beside the loss for a mixture-of-experts
model).

``--mesh N`` or ``DxM`` trains on a mesh of ``(data, model)`` axes over
the ranks that ``torchrun --standalone --nproc-per-node N`` starts (its
environment rendezvous; the mesh's size must be the world's): any family
data parallel, and with a model axis ``M`` above 1 tensor parallel (the
dense, frontend and mixture-of-experts families; the families with MLA,
Mamba2 or RWKV6 blocks raise before a weight is drawn, ROADMAP
A13.5.3e).  Rank ``r`` runs on
``cuda:{local_rank % device_count}`` (or the CPU under ``--device
cpu``); the backend is nccl where every rank has a card of its own,
gloo otherwise (the CPU, or ranks sharing a card).  Rank 0 prints the
layout and the history.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
from typing import Any, Dict, Optional, Sequence

# A group's collectives fail after this long instead of hanging.
GROUP_TIMEOUT = datetime.timedelta(seconds=120)


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


def mesh_shape(text: str):
    """``"4"`` -> (4,), ``"2x4"`` -> (2, 4): the (data, model) sizes."""
    shape = tuple(int(x) for x in text.split("x"))
    if not 1 <= len(shape) <= 2 or min(shape) < 1:
        raise ValueError(f"--mesh {text!r}: give N or DxM")
    return shape


def init_ranks(n: int, device: str):
    """Join the world that ``torchrun`` set up (rank, world size and
    rendezvous from the environment): ``(torch.device, backend)`` of this
    rank."""
    import torch
    import torch.distributed as dist

    from repro_torch import resolve_device

    if "RANK" not in os.environ:
        raise RuntimeError(
            f"a mesh of {n} ranks needs {n} processes: run `torchrun "
            f"--standalone --nproc-per-node {n} -m repro_torch.launch.train "
            "... --mesh ...`")
    world = int(os.environ["WORLD_SIZE"])
    if world != n:
        raise ValueError(f"the mesh holds {n} ranks but torchrun started "
                         f"{world}")
    local = int(os.environ.get("LOCAL_RANK", 0))
    dev = resolve_device(device)
    backend = "gloo"
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        dev = torch.device("cuda", local % count)
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if count >= local_world:
            backend = "nccl"
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://",
                            timeout=GROUP_TIMEOUT)
    return dev, backend


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)

    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.dist.sharding import Runtime
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.loop import LoopConfig, TrainLoop
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import TrainConfig

    cfg = configs.get_smoke(args.arch) if args.smoke \
        else configs.get_config(args.arch)
    rt, device, rank = Runtime(), args.device, 0
    if args.mesh:
        shape = mesh_shape(args.mesh)
        from repro_torch.models.model import check_model_axis
        check_model_axis(cfg, shape[1] if len(shape) == 2 else 1)
        import math

        import torch.distributed as dist

        device, backend = init_ranks(math.prod(shape), args.device)
        rank = dist.get_rank()
        rt = Runtime(mesh=make_mesh(shape, ("data", "model")[:len(shape)]))
        if rank == 0:
            print(f"mesh {rt.mesh.shape}: {dist.get_world_size()} ranks, "
                  f"backend {backend}, rank 0 on {device}", flush=True)
    try:
        loop = TrainLoop(
            cfg, rt,
            DataConfig(global_batch=args.global_batch, seq_len=args.seq,
                       seed=args.seed),
            TrainConfig(opt=AdamWConfig(lr=args.lr, warmup_steps=args.warmup,
                                        total_steps=args.steps),
                        grad_accum=args.grad_accum),
            LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                       log_every=args.log_every,
                       ckpt_dir=args.ckpt_dir or None,
                       inject_failure_at=args.inject_failure_at),
            device=device)
        out = loop.run(seed=args.seed)
    finally:
        if args.mesh:
            dist.destroy_process_group()
    if rank == 0:
        for h in out["history"]:
            print(json.dumps(h))
        if out["stragglers"]:
            print("straggler steps:", out["stragglers"])
    return out


if __name__ == "__main__":
    main()
