"""Experiment CLI of the port: run cells or whole grids, emit RunResult JSON.

  python -m repro_torch.experiments sweep --topos sf,df,ft \\
      --schemes ecmp,letflow,fatpaths --patterns adversarial,shuffle \\
      [--evaluators transport] [--seeds 0] [--quick] [--json out.json] \\
      [--filter SUBSTR] [--device cuda|cpu] [--devices N] \\
      [--checkpoint DIR] [--cell-timeout-s N]

  python -m repro_torch.experiments run --topo "sf(q=5)" --scheme fatpaths \\
      --pattern adversarial [--evaluator "transport(steps=1200)"]

  python -m repro_torch.experiments diff a.json b.json [--rtol 0]
  python -m repro_torch.experiments list    # registered axes + defaults

``--quick`` shortens transport simulations (steps=400) unless a spec
pins ``steps`` explicitly.  ``--device`` defaults to ``cuda``; without a
card that raises rather than falling back to the CPU.  ``--devices N``
runs the grid through the batched engine
(:mod:`repro_torch.experiments.dist_sweep`) over N devices: ``cuda:0..N-1``
(more than are visible raises) or, with ``--device cpu``, N shards of the
CPU; results equal the sequential sweep's for every N.  ``--checkpoint
DIR`` makes a sweep resumable: completed cells are committed one file
each and a re-run skips them.  ``--cell-timeout-s`` is a watchdog of the
sequential sweep and cannot be combined with ``--devices``.  Artifacts
use the JAX package's RunResult format, so ``diff`` compares an artifact
of either package with one of the other.
"""

from __future__ import annotations

import argparse
import sys

_QUICK_STEPS = 400


def _quicken(evaluators, quick: bool):
    """Apply --quick: cap transport steps unless the spec pins them."""
    from .specs import Spec
    if not quick:
        return evaluators
    out = []
    for e in evaluators:
        spec = Spec.coerce(e)
        if spec.name == "transport" and "steps" not in spec.kw:
            spec = Spec(spec.name, spec.kwargs + (("steps", _QUICK_STEPS),))
        out.append(spec)
    return out


def _write_json(results, path: str) -> None:
    from .results import results_to_json
    with open(path, "w") as f:
        f.write(results_to_json(results) + "\n")
    print(f"# wrote {len(results)} RunResults to {path}")


def _watchdog_sweep(session, cells, args, stream) -> int:
    """Sequential sweep with a per-cell wall-clock watchdog
    (``--cell-timeout-s``).  Each cell runs in a worker thread; a cell
    over the budget is recorded as failed with a timeout (empty metrics,
    an ``error`` meta field) and the sweep goes on.  The overrunning cell
    cannot be stopped: its thread runs on, holding the Session and the
    device (the next cells share both), until it returns or the process
    exits; the thread is a daemon, so it does not hold the exit up.
    Timed-out cells are never checkpointed, so a resume tries them again.
    Exit code 0 when at least one cell succeeded, else 1."""
    import threading

    from ..ckpt.sweep import SweepCheckpoint
    from .dist_sweep import resumed_result
    from .results import RunResult

    timeout = float(args.cell_timeout_s)
    ckpt = SweepCheckpoint(args.checkpoint) if args.checkpoint else None
    results = []
    n_ok = n_timeout = 0
    for spec in cells:
        rr = resumed_result(ckpt, spec.cell_id)
        if rr is None:
            out = {}

            def work(spec=spec, out=out):
                try:
                    out["rr"] = session.run(spec)
                except BaseException as e:  # re-raised on this thread
                    out["exc"] = e
            worker = threading.Thread(target=work, daemon=True)
            worker.start()
            worker.join(timeout)
            if worker.is_alive():
                print(f"# cell {spec.cell_id} exceeded --cell-timeout-s "
                      f"{timeout:g}; marked failed-with-timeout", flush=True)
                results.append(RunResult(
                    topo=spec.topo.format(), routing=spec.routing.format(),
                    pattern=spec.pattern.format(),
                    evaluator=spec.evaluator.format(), seed=spec.seed,
                    metrics={},
                    meta={"error": {"type": "timeout",
                                    "timeout_s": timeout}},
                    wall_s=timeout))
                n_timeout += 1
                continue
            if "exc" in out:
                raise out["exc"]
            rr = out["rr"]
            if ckpt is not None:
                ckpt.put(rr.cell_id, rr.to_dict())
        stream(rr)
        results.append(rr)
        n_ok += 1
    print(f"# {len(results)} cells; {n_ok} succeeded, {n_timeout} timed "
          "out", flush=True)
    if args.json:
        _write_json(results, args.json)
    return 0 if (n_ok > 0 or not cells) else 1


def cmd_sweep(args) -> int:
    from .results import summary_table
    from .session import Session
    from .specs import split_spec_list

    session = Session(device=args.device)
    evaluators = _quicken(split_spec_list(args.evaluators), args.quick)
    seeds = [int(s) for s in args.seeds.split(",") if s != ""]
    cells = session.grid(topos=split_spec_list(args.topos),
                         routings=split_spec_list(args.schemes),
                         patterns=split_spec_list(args.patterns),
                         evaluators=evaluators, seeds=seeds)
    if args.filter:
        kept = [c for c in cells if args.filter in c.cell_id]
        if not kept:
            print(f"error: --filter {args.filter!r} matches none of the "
                  f"{len(cells)} grid cell(s):", file=sys.stderr)
            for c in cells:
                print(f"  {c.cell_id}", file=sys.stderr)
            return 2
        print(f"# --filter {args.filter!r}: {len(kept)} of {len(cells)} "
              "cell(s)", flush=True)
        cells = kept
    stream = lambda rr: print(summary_table([rr]), flush=True)  # noqa: E731
    if args.cell_timeout_s is not None:
        if args.devices is not None:
            print("error: --cell-timeout-s is a watchdog of the sequential "
                  "sweep; drop --devices", file=sys.stderr)
            return 2
        return _watchdog_sweep(session, cells, args, stream)
    if args.devices is not None or args.checkpoint:
        from .dist_sweep import dist_sweep
        results = dist_sweep(
            session, cells, devices=args.devices,
            checkpoint_dir=args.checkpoint or None, callback=stream,
            log=lambda m: print(m, flush=True))
    else:
        results = []
        for spec in cells:
            rr = session.run(spec)
            stream(rr)
            results.append(rr)
    builds = session.stats["stack_build"]
    hits = session.stats["stack_hit"]
    print(f"# {len(results)} cells; layer/table stacks built {builds}x, "
          f"reused {hits}x", flush=True)
    if args.json:
        _write_json(results, args.json)
    return 0


def cmd_run(args) -> int:
    from .results import results_to_json
    from .session import Session

    session = Session(device=args.device)
    (evaluator,) = _quicken([args.evaluator], args.quick)
    rr = session.run(args.topo, args.scheme, args.pattern, evaluator,
                     seed=args.seed)
    print(rr.to_json())
    if args.json:
        with open(args.json, "w") as f:
            f.write(results_to_json([rr]) + "\n")
    return 0


def cmd_list(_args) -> int:
    from .catalog import EVALUATORS, ROUTINGS, TOPOLOGIES, TRAFFIC

    for title, reg in (("topologies", TOPOLOGIES),
                       ("routing schemes", ROUTINGS),
                       ("traffic patterns", TRAFFIC),
                       ("evaluators", EVALUATORS)):
        print(f"{title}:")
        for name in reg.names():
            defaults = ", ".join(f"{k}={v!r}"
                                 for k, v in sorted(reg.defaults(name).items()))
            print(f"  {name}({defaults})")
            doc = reg.doc(name)
            if doc:
                print(f"      {doc}")
    return 0


def cmd_diff(args) -> int:
    """Cell-for-cell comparison of two sweep artifacts."""
    from .results import compare_results, results_from_json

    sides = []
    for path in (args.a, args.b):
        with open(path) as f:
            sides.append(results_from_json(f.read()))
    diffs = compare_results(sides[0], sides[1], rtol=args.rtol)
    for d in diffs:
        print(d)
    if diffs:
        print(f"# {len(diffs)} difference(s) between {args.a} and {args.b}",
              file=sys.stderr)
        return 1
    print(f"# identical: {len(sides[0])} cells ({args.a} vs {args.b}, "
          f"rtol={args.rtol:g})")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.experiments",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    sw = sub.add_parser("sweep", help="run a topology x scheme x pattern grid")
    sw.add_argument("--topos", default="sf,df,ft")
    sw.add_argument("--schemes", default="ecmp,letflow,fatpaths")
    sw.add_argument("--patterns", default="adversarial,shuffle")
    sw.add_argument("--evaluators", default="transport")
    sw.add_argument("--seeds", default="0")
    sw.add_argument("--filter", default="",
                    help="run only cells whose cell id contains this "
                         "substring (rc=2 with the cell list when nothing "
                         "matches)")
    sw.add_argument("--quick", action="store_true")
    sw.add_argument("--json", default="", help="write RunResult list here")
    sw.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    sw.add_argument("--devices", type=int, default=None,
                    help="run the batched engine over N devices (cuda:0.."
                         "N-1, or N shards of the CPU with --device cpu)")
    sw.add_argument("--checkpoint", default="",
                    help="resumable sweep: per-cell checkpoint directory")
    sw.add_argument("--cell-timeout-s", type=float, default=None,
                    dest="cell_timeout_s",
                    help="sequential-sweep watchdog: a cell over this "
                         "wall-clock budget is marked failed-with-timeout "
                         "(error meta) and the sweep goes on; rc 0 if any "
                         "cell succeeded.  Timed-out cells are not "
                         "checkpointed, so a --checkpoint resume retries "
                         "them")
    sw.set_defaults(fn=cmd_sweep)

    rn = sub.add_parser("run", help="run a single cell")
    rn.add_argument("--topo", required=True)
    rn.add_argument("--scheme", required=True)
    rn.add_argument("--pattern", required=True)
    rn.add_argument("--evaluator", default="transport")
    rn.add_argument("--seed", type=int, default=0)
    rn.add_argument("--quick", action="store_true")
    rn.add_argument("--json", default="")
    rn.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    rn.set_defaults(fn=cmd_run)

    df = sub.add_parser("diff", help="cell-for-cell compare two artifacts")
    df.add_argument("a")
    df.add_argument("b")
    df.add_argument("--rtol", type=float, default=0.0,
                    help="relative tolerance for float metrics (default: "
                         "exact)")
    df.set_defaults(fn=cmd_diff)

    ls = sub.add_parser("list", help="show registered axes and defaults")
    ls.set_defaults(fn=cmd_list)

    args = ap.parse_args(argv)
    from .specs import SpecError
    try:
        return args.fn(args)
    except SpecError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
