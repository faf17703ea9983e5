"""Time gloo's wire between two ranks that share one card, as phase 17 of
``chip_smoke.py`` runs them: a 1 GiB f32 payload on the card, staged
through page-locked host memory.

    python3 probes/gloo_wire.py

Two spawned processes join a gloo group (a file rendezvous), each with
the payload on ``cuda:0``, and time on the host clock, twice each: a
page-locked allocation, the copy to it from the card and the pageable
copy, one all-reduce, the same in 4 and 16 chunks in flight, one
point-to-point exchange and the same in 8 chunks, and the copy back to
the card.  Once with gloo's default threads, once with 8.  Prints the
card's name and power limit, then one line of seconds (rank 0's) per
thread count.  Needs one card; exits non-zero without one.
"""

from __future__ import annotations

import datetime
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

GIB_F32 = 256 * 2**20


def _timed(out, key, fn):
    t0 = time.perf_counter()
    res = fn()
    out[key] = round(time.perf_counter() - t0, 3)
    return res


def _rank(rank, path, threads, q):
    torch.cuda.set_device(0)
    kw = {}
    if threads:
        opts = dist.ProcessGroupGloo._Options()
        opts._threads = threads
        kw["pg_options"] = opts
    dist.init_process_group(
        "gloo", init_method=f"file://{path}", world_size=2, rank=rank,
        timeout=datetime.timedelta(seconds=120), **kw)
    x = torch.randn(GIB_F32, device="cuda")
    peer = 1 - rank
    out = {}
    for rep in range(2):
        h = _timed(out, f"pin_alloc{rep}",
                   lambda: torch.empty(GIB_F32, pin_memory=True))
        _timed(out, f"d2h_pinned{rep}", lambda: h.copy_(x))
        _timed(out, f"d2h_pageable{rep}", lambda: x.cpu())
        dist.barrier()
        _timed(out, f"all_reduce{rep}", lambda: dist.all_reduce(h))
        for k in (4, 16):
            dist.barrier()
            _timed(out, f"all_reduce_{k}_chunks{rep}", lambda: [
                w.wait() for w in [dist.all_reduce(c, async_op=True)
                                   for c in h.chunk(k)]])
        for k in (1, 8):
            dist.barrier()
            recv = [torch.empty_like(c) for c in h.chunk(k)]
            ops = [op for c, r in zip(h.chunk(k), recv)
                   for op in (dist.P2POp(dist.isend, c, peer),
                              dist.P2POp(dist.irecv, r, peer))]
            _timed(out, f"exchange_{k}_chunks{rep}", lambda: [
                w.wait() for w in dist.batch_isend_irecv(ops)])
        _timed(out, f"h2d_pinned{rep}", lambda: (
            h.to("cuda", non_blocking=True), torch.cuda.synchronize()))
    q.put((rank, out))
    dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("gloo_wire: no CUDA device is available", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    ctx = mp.get_context("spawn")
    for threads in (0, 8):
        q = ctx.Queue()
        with tempfile.TemporaryDirectory() as d:
            procs = [ctx.Process(target=_rank, args=(r, f"{d}/pg", threads, q))
                     for r in range(2)]
            for p in procs:
                p.start()
            res = dict(q.get(timeout=300) for _ in procs)
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.terminate()
        print(f"gloo threads {threads or 'default'}: {res[0]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
