"""Run the PyTorch/CUDA port on one GPU: build its kernels, hold each against
its plain PyTorch version, drive the main path at full width, and report.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and continued):

1. card: name, count, and ``nvidia-smi`` name and power limit;
   then the main cells are driven once with a recorder in front of each
   kernel wrapper, to keep the inputs the main path hands the kernels;
2. the semiring kernel vs its plain version: three semirings at ragged
   shapes, and every boolean product the main path made, bitwise; the
   main path's products timed (replayed in order) with CUDA events beside
   the plain version and ``torch.matmul`` of f32 copies (TF32 off);
3. the water-filling kernel vs its plain version: ragged shapes, rows
   with no live slot, all-inactive rows, ``want_util`` on and off, and
   every call the main path made (its strided (F, S) views of the packed
   path record: S=9 for fatpaths, S=4 for ecmp); ``share`` bitwise,
   ``sent``/``util`` within rtol 1e-5 (the plain version sums with float
   atomics in another order), and two launches bitwise equal; the main
   path's calls timed, replayed in order;
4. a small cell (sf(q=5)) on the card and on the CPU through the same
   port: tables and path-edge tensors bitwise, departures within 2 steps
   for at least 99% of flows;
5. the main path: ``Session(device="cuda").sweep`` over sf(q=19) (722
   routers, 10 830 endpoints) x {fatpaths(n_layers=9,rho=0.6), ecmp} x
   permutation x transport(steps=2000,transport=ndp), with every launch
   count set to 0 just before and read just after; then each cell's scan
   alone (host wall, µs per step, ``torch.profiler`` device time), and
   the same cells with 256 MiB flows, where all 2000 steps run;
6. one ``{"kernels": [...]}`` line: launches on the main path, error
   against the plain version, kernel / plain / bound / library times
   (``ms``, ``plain_ms`` and ``library_ms`` are device time per call of
   the main path's calls, from ``torch.profiler``);
7. the last line: ``{"ok": true, "device": {...}}``.

Bounds use the H100 SXM's published dense peaks: 3.35 TB/s of device
memory, 1979 TOP/s of int8 on the tensor cores (the boolean product's
byte operands) and 67 TFLOP/s of float32 outside the tensor cores.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
INT8_OP_PER_S = 1979e12
MAIN_TOPO = "sf(q=19)"
MAIN_ROUTINGS = ("fatpaths(n_layers=9,rho=0.6)", "ecmp")
MAIN_PATTERN = "permutation"
MAIN_EVAL = "transport(steps=2000,transport=ndp)"
# 256 MiB per flow: more than 2000 steps at line rate (125 kB a step).
LONG_PATTERN = "permutation(flow_size=268435456)"


def _time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms over ``iters`` launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def phase_card():
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(f"# phase 1: {name}, {count} device(s), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return name, count


def capture_main_inputs(Session, paths, transport):
    """Drive the main cells once with a recorder in front of each kernel
    wrapper, keeping every semiring call's operands and every water-filling
    call's inputs, tagged with the cell's routing, so that phases 2 and 3
    check and time the kernels on exactly what the main path hands them
    (the water-filling edges are the path's strided view of its packed
    (F, S + 2) record)."""
    mm, wf = [], []
    real_mm, real_wf = paths.semiring_matmul, transport.waterfill_step
    tag = {}

    def rec_mm(a, b, semiring="count", **kw):
        mm.append((tag["routing"], a, b, semiring))
        return real_mm(a, b, semiring, **kw)

    def rec_wf(edges, w, desired, cap, **kw):
        wf.append((tag["routing"], (edges, w, desired, cap), kw))
        return real_wf(edges, w, desired, cap, **kw)

    paths.semiring_matmul, transport.waterfill_step = rec_mm, rec_wf
    try:
        ses = Session(device="cuda")
        for routing in MAIN_ROUTINGS:
            tag["routing"] = routing
            ses.run(MAIN_TOPO, routing, MAIN_PATTERN, MAIN_EVAL)
    finally:
        paths.semiring_matmul, transport.waterfill_step = real_mm, real_wf
    torch.cuda.synchronize()
    print(f"# captured the main path's kernel inputs: {len(mm)} semiring "
          f"and {len(wf)} water-filling calls", flush=True)
    return mm, wf


def _replay_ms(fn, calls, iters: int):
    """``fn(*call)`` replayed over ``calls`` in order, ``iters`` times:
    ``(device ms, wall ms)`` per call.  Device time is the sum of the
    device events ``torch.profiler`` records (kernels, memsets, copies);
    the wall is CUDA events around the host-issued loop, which the host's
    issue rate bounds when a call's device work is short."""
    def replay():
        for _ in range(iters):
            for c in calls:
                fn(*c)
    wall = _time_ms(replay, 1, warmup=1) / iters / len(calls)
    device_ms, _, _ = _profile(replay)
    if device_ms is None:
        print("# the profiler recorded no device time: wall stands in for "
              "device time", flush=True)
        return wall, wall
    return device_ms / iters / len(calls), wall


def _mm_bound(a, b, semiring):
    """(bytes s, operations s) of one product: each operand read once, the
    output written once; bool (byte operands) at the int8 tensor rate,
    count and minplus at the f32 rate."""
    batch = max(a.shape[0] if a.ndim == 3 else 1,
                b.shape[0] if b.ndim == 3 else 1)
    m, k = a.shape[-2:]
    n = b.shape[-1]
    item = 1 if semiring == "bool" else 4
    nbytes = (a.numel() + b.numel() + batch * m * n) * item
    rate = INT8_OP_PER_S if semiring == "bool" else F32_FLOP_PER_S
    return nbytes / HBM_BYTES_PER_S, 2.0 * batch * m * k * n / rate


def _sum_bound(parts):
    """Least time of a sequence of calls, in ms, and what bounds it."""
    t_bytes = sum(p[0] for p in parts) * 1e3
    t_ops = sum(p[1] for p in parts) * 1e3
    t_least = sum(max(p) for p in parts) * 1e3
    return t_least, ("bytes" if t_bytes >= t_ops else "operations")


def phase_semiring(ref, semiring_matmul, main_calls):
    dev = "cuda"
    g = torch.Generator().manual_seed(0)
    max_err = 0.0

    def operands(shape_a, shape_b, semiring):
        a = torch.rand(shape_a, generator=g)
        b = torch.rand(shape_b, generator=g)
        if semiring == "bool":
            a, b = a < 0.05, b < 0.05
        elif semiring == "count":               # integer-valued: exact sums
            a, b = (a * 4).floor(), (b * 4).floor()
        else:
            a[a > 0.8] = math.inf
            b[b > 0.8] = math.inf
        return a.to(dev), b.to(dev)

    def check(a, b, semiring, what):
        out = semiring_matmul(a, b, semiring)
        exp = ref.semiring_matmul_ref(a, b, semiring)
        torch.cuda.synchronize()
        if out.shape != exp.shape or out.dtype != exp.dtype:
            raise AssertionError(f"semiring {semiring} {what}: "
                                 f"{out.shape}/{out.dtype} vs "
                                 f"{exp.shape}/{exp.dtype}")
        if not torch.equal(out, exp):
            raise AssertionError(f"semiring {semiring} {what} is not "
                                 "bitwise equal to its plain version")
        diff = (out.float() - exp.float())
        finite = torch.isfinite(exp.float())
        return float(diff[finite].abs().max()) if finite.any() else 0.0

    cases = [((1, 1), (1, 1)), ((33, 70), (70, 129)),
             ((3, 33, 70), (3, 70, 129)), ((3, 33, 70), (70, 129)),
             ((33, 70), (3, 70, 129)), ((130, 1), (1, 200)),
             ((2, 65, 1100), (2, 1100, 67)), ((9, 722, 722), (722, 722)),
             ((9, 722, 722), (9, 722, 722))]
    for sa, sb in cases:
        for semiring in ("bool", "count", "minplus"):
            a, b = operands(sa, sb, semiring)
            max_err = max(max_err, check(a, b, semiring, f"{sa}x{sb}"))
    for i, (routing, a, b, semiring) in enumerate(main_calls):
        max_err = max(max_err, check(a, b, semiring,
                                     f"main-path call {i} ({routing})"))
    print(f"# phase 2: semiring bitwise equal to its plain version on "
          f"{len(cases) * 3} ragged cases and the main path's "
          f"{len(main_calls)} calls", flush=True)

    # Time the main path's own calls, replayed in order.
    calls = [(a, b, s) for _, a, b, s in main_calls]
    ms, wall = _replay_ms(semiring_matmul, calls, 20)
    plain_ms, plain_wall = _replay_ms(ref.semiring_matmul_ref, calls, 20)
    f32 = [(a.float(), b.float()) for a, b, _ in calls]
    library_ms, _ = _replay_ms(torch.matmul, f32, 20)
    bound, by = _sum_bound([_mm_bound(*c) for c in calls])
    bound /= len(calls)
    for routing in MAIN_ROUTINGS:
        mine = [(a, b, s) for r, a, b, s in main_calls if r == routing]
        shapes = sorted({(tuple(a.shape), tuple(b.shape)) for a, b, _ in mine})
        k_dev, k_wall = _replay_ms(semiring_matmul, mine, 20)
        p_dev, p_wall = _replay_ms(ref.semiring_matmul_ref, mine, 20)
        print(f"# semiring on {routing}: {len(mine)} calls {shapes}: "
              f"device ms/call kernel {k_dev:.5f}, plain {p_dev:.5f}; wall "
              f"ms/call kernel {k_wall:.5f}, plain {p_wall:.5f}", flush=True)
    print(f"# semiring, main path's calls: device ms/call kernel {ms:.5f}, "
          f"plain {plain_ms:.5f}, torch.matmul f32 {library_ms:.5f}, bound "
          f"{bound:.6f} ({by}); wall ms/call kernel {wall:.5f}, plain "
          f"{plain_wall:.5f}", flush=True)
    return dict(name="semiring", route="cuda",
                source="src/repro_torch/kernels/csrc/semiring.cu",
                replaces="src/repro/kernels/semiring.py:92",
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=library_ms)


def _wf_instance(f, s, e, seed, dev="cuda"):
    g = torch.Generator().manual_seed(seed)
    edges = torch.randint(0, max(1, e - 1), (f, s), generator=g,
                          dtype=torch.int32)
    edges[torch.rand((f, s), generator=g) < 0.25] = e - 1
    edges[torch.rand((f, s), generator=g) < 0.1] = -1
    edges[torch.rand(f, generator=g) < 0.05] = -1        # no live slot
    w = (torch.rand(f, generator=g) >= 0.2).float()
    desired = torch.rand(f, generator=g) * w
    active = torch.rand(f, generator=g) < 0.8
    cap = torch.ones(e)
    return [x.to(dev) for x in (edges, w, desired, cap, active)]


def _close(a, b, what):
    bad = (a - b).abs() > 1e-5 * b.abs() + 1e-7
    both_inf = torch.isinf(a) & torch.isinf(b) & (a == b)
    bad &= ~both_inf
    if bool(bad.any()):
        raise AssertionError(f"waterfill {what}: not within rtol 1e-5 of "
                             f"its plain version")
    fin = torch.isfinite(b)
    return float((a - b)[fin].abs().max()) if fin.any() else 0.0


def _wf_check(ref, waterfill_step, edges, w, desired, cap, act, fi, wu,
              what):
    """Two launches bitwise equal; share bitwise and sent/util within
    rtol 1e-5 of the plain version.  Returns the max abs error."""
    k1 = waterfill_step(edges, w, desired, cap, active=act, fair_iters=fi,
                        want_util=wu)
    k2 = waterfill_step(edges, w, desired, cap, active=act, fair_iters=fi,
                        want_util=wu)
    # The plain version with the kernel's masking of -1 slots.
    act_r = torch.ones_like(w, dtype=torch.bool) if act is None else act
    r = ref.waterfill_ref(edges, w, desired, cap, fair_iters=fi,
                          active=act_r, want_util=wu)
    torch.cuda.synchronize()
    for x, y in zip(k1, k2):
        if not torch.equal(x, y):
            raise AssertionError(f"waterfill {what} fi={fi}: two launches "
                                 "differ")
    if not torch.equal(k1[1], r[1]):
        raise AssertionError(f"waterfill {what} fi={fi}: share not bitwise")
    err = _close(k1[0], r[0], f"{what} sent")
    if wu:
        err = max(err, _close(k1[2], r[2], f"{what} util"))
    return err


def phase_waterfill(ref, waterfill_step, main_calls):
    shapes = [(1, 5, 33), (7, 3, 19), (130, 9, 513), (1000, 8, 3001),
              (10830, 8, 42599)]
    max_err = 0.0
    n_cases = 0
    for f, s, e in shapes:
        edges, w, desired, cap, active = _wf_instance(f, s, e, f + e)
        for act in (active, torch.zeros_like(active), None):
            for fi in (0, 1, 2):
                for wu in (False, True):
                    max_err = max(max_err, _wf_check(
                        ref, waterfill_step, edges, w, desired, cap, act,
                        fi, wu, f"({f},{s},{e})"))
                    n_cases += 1
    # The main path's own inputs: every call as the path made it, and the
    # first call of each cell again with every fair_iters and want_util.
    first = {}
    for i, (routing, args, kw) in enumerate(main_calls):
        first.setdefault(routing, (args, kw))
        max_err = max(max_err, _wf_check(
            ref, waterfill_step, *args, kw.get("active"),
            kw.get("fair_iters", 2), False, f"main-path call {i} ({routing})"))
        n_cases += 1
    for routing, (args, kw) in first.items():
        for fi in (0, 1, 2):
            for wu in (False, True):
                max_err = max(max_err, _wf_check(
                    ref, waterfill_step, *args, kw.get("active"), fi, wu,
                    f"main-path first call ({routing})"))
                n_cases += 1
    print(f"# phase 3: waterfill on {n_cases} cases ({len(main_calls)} of "
          "them the main path's own calls, strided edges): share bitwise, "
          f"sent/util within rtol 1e-5 (max abs err {max_err:.3g}), "
          "launch-to-launch bitwise", flush=True)

    def wf_bound(edges, w, desired, cap):
        f, s = edges.shape
        nbytes = f * s * 4 + f * (4 + 4 + 1) + cap.shape[0] * 4 + f * 4 * 2
        return nbytes / HBM_BYTES_PER_S, 0.0

    def kernel(args, kw):
        return waterfill_step(*args, **kw)

    def plain(args, kw):
        return ref.waterfill_ref(*args, **kw)

    calls = [(args, kw) for _, args, kw in main_calls]
    ms, wall = _replay_ms(kernel, calls, 10)
    plain_ms, plain_wall = _replay_ms(plain, calls, 3)
    bound, by = _sum_bound([wf_bound(*args) for args, _ in calls])
    bound /= len(calls)
    for routing, (args, kw) in first.items():
        edges = args[0]
        mine = [(a, k) for r, a, k in main_calls if r == routing]
        k_dev, k_wall = _replay_ms(kernel, mine, 10)
        p_dev, p_wall = _replay_ms(plain, mine, 3)
        print(f"# waterfill on {routing}: {len(mine)} calls, edges "
              f"{tuple(edges.shape)} row stride {edges.stride(0)}, "
              f"E={args[3].shape[0]}, fair_iters={kw.get('fair_iters')}: "
              f"device ms/call kernel {k_dev:.5f}, plain {p_dev:.5f}; wall "
              f"ms/call kernel {k_wall:.5f}, plain {p_wall:.5f}", flush=True)
    print(f"# waterfill, main path's calls: device ms/call kernel {ms:.5f}, "
          f"plain {plain_ms:.5f}, bound {bound:.6f} ({by}); wall ms/call "
          f"kernel {wall:.5f}, plain {plain_wall:.5f}", flush=True)
    return dict(name="waterfill", route="cuda",
                source="src/repro_torch/kernels/csrc/waterfill.cu",
                replaces="src/repro/kernels/waterfill.py:167",
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=None)


def phase_small_cell(Session, transport):
    sessions = {d: Session(device=d) for d in ("cuda", "cpu")}
    exact = True
    for routing in ("ecmp", "fatpaths(n_layers=9,rho=0.6)"):
        res, bundles, prepared = {}, {}, {}
        for d, ses in sessions.items():
            rr = ses.run("sf(q=5)", routing, "permutation",
                         "transport(steps=400)")
            bundle = ses.routing("sf(q=5)", routing)
            cell = ses.resolve(ses.grid(["sf(q=5)"], [routing],
                                        ["permutation"])[0])
            cfg = transport.SimConfig(balancing=bundle.balancing,
                                      n_steps=400)
            sims = transport.simulate_seeds(cell.topo, bundle.routing,
                                            cell.workload, cfg, [0],
                                            device=d)
            arrs, _ = transport.prepare(cell.topo, bundle.routing,
                                        cell.workload, cfg, device=d)
            res[d], bundles[d], prepared[d] = (rr, sims[0]), bundle, arrs
        for name in ("nh", "reach"):
            if not torch.equal(getattr(bundles["cuda"].routing, name).cpu(),
                               getattr(bundles["cpu"].routing, name)):
                raise AssertionError(f"{routing}: {name} differs card vs CPU")
        for name in ("path_edges", "routed", "usable"):
            if not torch.equal(prepared["cuda"][name].cpu(),
                               prepared["cpu"][name]):
                raise AssertionError(f"{routing}: {name} differs card vs CPU")
        dep_g = res["cuda"][1].depart_step
        dep_c = res["cpu"][1].depart_step
        same = float((dep_g == dep_c).mean())
        gap = int(np.abs(dep_g.astype(np.int64) - dep_c).max())
        if same < 0.99 or gap > 2:
            raise AssertionError(f"{routing}: departures agree for {same:.4f}"
                                 f" of flows, max gap {gap} steps")
        fin_g = res["cuda"][0].metrics["finished"]
        fin_c = res["cpu"][0].metrics["finished"]
        if fin_g != fin_c:
            raise AssertionError(f"{routing}: finished {fin_g} vs {fin_c}")
        cell_exact = res["cuda"][0].metrics == res["cpu"][0].metrics
        exact &= cell_exact
        print(f"# phase 4: sf(q=5) {routing}: tables and path edges bitwise; "
              f"departures equal for {same:.4f} of flows (max gap {gap}); "
              f"metrics {'exactly equal' if cell_exact else 'differ'} "
              "card vs CPU", flush=True)
    return exact


def _profile(fn, top_n: int = 6):
    """One ``fn()`` under ``torch.profiler``: the summed self time of its
    device-side events (kernels, copies, memsets) in ms, their count, and
    the ``top_n`` of them by device time; ``(None, 0, [])`` when the trace
    holds no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    total = sum(dev_us(e) for e in dev)
    if total <= 0:
        return None, 0, []
    ranked = sorted(dev, key=dev_us, reverse=True)[:top_n]
    return (total / 1e3, sum(e.count for e in dev),
            [[e.key[:60], dev_us(e) / 1e3, e.count] for e in ranked])


def _scan_reading(ses, transport, prng, routing, pattern, n_steps,
                  profile_steps):
    """The scan of one cell alone, again: host wall around a synchronize,
    steps run and µs per step; then ``torch.profiler`` over the first
    ``profile_steps`` steps with the adaptive horizon off (device time,
    idle share and device events per step)."""
    cell = ses.resolve(ses.grid([MAIN_TOPO], [routing], [pattern])[0])
    cfg = transport.SimConfig(balancing=cell.bundle.balancing,
                              n_steps=n_steps, transport="ndp")
    arrs, static = transport.prepare(cell.topo, cell.bundle.routing,
                                     cell.workload, cfg, device="cuda")
    key = prng.PRNGKey(0, "cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    final = transport._run_scan(arrs, key, cfg, static)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t1
    steps = int(final["horizon_chunks"]) * cfg.horizon_chunk \
        + cfg.n_steps % cfg.horizon_chunk
    pcfg = dataclasses.replace(cfg, n_steps=profile_steps,
                               adaptive_horizon=False)
    pstatic = (static[0], static[1], profile_steps)
    device_ms, n_dev, top = _profile(
        lambda: transport._run_scan(arrs, key, pcfg, pstatic))
    # Idle share against the unprofiled wall of as many steps: the
    # profiler's own host cost would inflate a profiled wall.
    window_s = scan_s / steps * profile_steps
    return dict(scan_s=scan_s, steps=steps, us_per_step=scan_s / steps * 1e6,
                profile_steps=profile_steps, scan_device_ms=device_ms,
                scan_idle_share=(None if device_ms is None else
                                 1.0 - device_ms / 1e3 / window_s),
                scan_device_events_per_step=n_dev / profile_steps,
                scan_top_kernels_ms=top, e_tot=static[0],
                hop_slots=arrs["path_edges"].shape[2])


def phase_main(Session, transport, prng, LAUNCHES, reset_launches):
    ses = Session(device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    per_cell = []
    last = dict(LAUNCHES)

    def count_cell(rr):
        per_cell.append({k: LAUNCHES[k] - last[k] for k in LAUNCHES})
        last.update(LAUNCHES)

    reset_launches()
    last.update(LAUNCHES)
    t0 = time.perf_counter()
    results = ses.sweep([MAIN_TOPO], list(MAIN_ROUTINGS), [MAIN_PATTERN],
                        [MAIN_EVAL], callback=count_cell)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for name in ("semiring", "waterfill"):
        if launches[name] <= 0:
            raise AssertionError(f"main path never launched the {name} "
                                 "kernel")
    cells = []
    for rr, cell_launches in zip(results, per_cell):
        m = rr.metrics
        if not m["finished"] > 0:
            raise AssertionError(f"{rr.cell_id}: no flow finished")
        for k in ("fct_p50_us", "fct_p99_us", "fct_mean_us"):
            if not math.isfinite(m[k]):
                raise AssertionError(f"{rr.cell_id}: {k} = {m[k]}")
        # The main cells end in their first chunks, so the profile covers
        # the same steps the scan ran (64 + the 16-step tail).
        info = dict(cell=rr.cell_id, metrics=m, build_s=rr.meta["build_s"],
                    cell_wall_s=rr.wall_s, launches=cell_launches,
                    n_flows=rr.meta["n_flows"],
                    **_scan_reading(ses, transport, prng, rr.routing,
                                    MAIN_PATTERN, 2000, 80))
        cells.append(info)
        print("# phase 5: " + json.dumps(info), flush=True)
    print(f"# phase 5: sweep wall {wall:.3f} s, launches {launches}, peak "
          f"device memory {peak / 2 ** 20:.1f} MiB", flush=True)
    # Steady state: the same cells with flows too long for the adaptive
    # horizon to stop early, so every one of the 2000 steps runs with
    # flows in flight.
    for routing in MAIN_ROUTINGS:
        rr = ses.run(MAIN_TOPO, routing, LONG_PATTERN, MAIN_EVAL)
        info = dict(cell=rr.cell_id, metrics=rr.metrics,
                    cell_wall_s=rr.wall_s,
                    **_scan_reading(ses, transport, prng, routing,
                                    LONG_PATTERN, 2000, 320))
        if info["steps"] != 2000:
            raise AssertionError(f"{rr.cell_id}: the long cell stopped at "
                                 f"{info['steps']} steps")
        print("# phase 5 (long flows): " + json.dumps(info), flush=True)
    return launches, cells


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import prng
    from repro_torch.core import paths, transport
    from repro_torch.experiments import Session
    from repro_torch.kernels import (LAUNCHES, build, ref, reset_launches,
                                     semiring_matmul, waterfill_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, count = phase_card()
    t0 = time.perf_counter()
    build.build_all()
    print(f"# kernels built in {time.perf_counter() - t0:.2f} s", flush=True)
    main_mm, main_wf = capture_main_inputs(Session, paths, transport)
    k2 = phase_semiring(ref, semiring_matmul, main_mm)
    k1 = phase_waterfill(ref, waterfill_step, main_wf)
    del main_mm, main_wf
    exact = phase_small_cell(Session, transport)
    launches, _ = phase_main(Session, transport, prng, LAUNCHES,
                             reset_launches)
    k2["launches"] = launches["semiring"]
    k1["launches"] = launches["waterfill"]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(f"# small cell card vs CPU exactly equal: {exact}")
    print(json.dumps({"kernels": [{k: d[k] for k in keys} for d in (k2, k1)]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
