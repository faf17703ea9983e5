"""Time K2 bool, the dense bool semiring product, on the card at the
path's shapes, split by kernel, for one or more source trees.

    python3 probes/k2_bool.py [--tree SRC ...] [--iters N]

Each tree (a checkout's ``src`` directory; by default this checkout's)
runs in a process of its own, in the order given: give parent, change,
change, parent to compare two commits on one card.  At each shape the
call is first held bitwise against the plain version on the same inputs,
then replayed ``--iters`` times under ``torch.profiler``: device ms a call
by kernel name, device kernels a call, CUDA-event ms a call, and the byte
bound (operands read once, output written once, at 3.35 TB/s).  Prints
the card's name and power limit, then one JSON line a tree.  Needs one
card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

# (batch, m, k, n): the main sweep and repair builds at sf(q=19) (9
# layers), pi_min and ecmp at one layer, and the same at sf(q=29).
SHAPES = ((9, 722, 722, 722), (1, 722, 722, 722), (9, 1682, 1682, 1682),
          (1, 1682, 1682, 1682))
HBM_BYTES_PER_S = 3.35e12


def _one(iters: int) -> dict:
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ref, semiring_matmul

    out = {}
    for batch, m, k, n in SHAPES:
        rng = np.random.default_rng(batch * m)
        p = k ** -0.5
        a = torch.from_numpy(rng.random((batch, m, k)) < p).cuda()
        b = torch.from_numpy(rng.random((batch, k, n)) < p).cuda()
        got = semiring_matmul(a, b, "bool")
        if not torch.equal(got, ref.semiring_matmul_ref(a, b, "bool")):
            raise AssertionError(f"bool {(batch, m, k, n)} differs from "
                                 "the plain version")
        for _ in range(3):
            semiring_matmul(a, b, "bool")
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        start.record()
        for _ in range(iters):
            semiring_matmul(a, b, "bool")
        stop.record()
        torch.cuda.synchronize()
        event_ms = start.elapsed_time(stop) / iters
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(8):  # the profiler can lose a trace's first events
                torch.cuda._sleep(1_000_000)
            torch.cuda.synchronize()
            for _ in range(iters):
                semiring_matmul(a, b, "bool")
            torch.cuda.synchronize()
        kernels = {}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA or "spin" in e.key:
                continue
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            kernels[e.key[:60]] = [us / 1e3 / iters, e.count / iters]
        nbytes = a.numel() + b.numel() + got.numel()
        out["x".join(map(str, (batch, m, k, n)))] = dict(
            device_ms=sum(v[0] for v in kernels.values()),
            kernels_a_call=sum(v[1] for v in kernels.values()),
            by_kernel=kernels, event_ms=event_ms,
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=None,
                    help="a checkout's src directory (repeatable)")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(_one(args.iters)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    trees = args.tree or [str(Path(__file__).resolve().parents[1] / "src")]
    for tree in trees:
        env = dict(os.environ, PYTHONPATH=str(Path(tree).resolve()))
        res = subprocess.run([sys.executable, __file__, "--one", "--iters",
                              str(args.iters)], env=env, capture_output=True,
                             text=True, timeout=900)
        if res.returncode != 0:
            print(res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        print(json.dumps({"tree": tree, **json.loads(
            res.stdout.strip().splitlines()[-1])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
