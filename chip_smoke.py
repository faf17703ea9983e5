"""Run the PyTorch/CUDA port on one GPU: build its kernels, hold each against
its plain PyTorch version, drive the main path at full width, and report.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and continued):

1. card: name, count, and ``nvidia-smi`` name and power limit; the
   kernels are built (``ptxas``'s registers, shared memory and spills of
   each kernel printed); then the main cells are driven once with a
   recorder in front of each
   kernel wrapper, to keep the inputs the main path hands the kernels;
2. the semiring kernel vs its plain version: three semirings at ragged
   shapes, and every boolean product the main path made, bitwise; the
   main path's products timed (replayed in order) with CUDA events beside
   the plain version and ``torch.matmul`` of f32 copies (TF32 off); each
   semiring is timed again on its own path's calls once phase (a) has
   recorded them (bool: the main sweep; count: ``min_path_stats`` and
   ``path_counts_power``; minplus: the ksp cell), count and bool beside
   ``torch.matmul`` f32, into the entry's ``per_semiring``;
3. the water-filling kernel vs its plain version on CPU copies of the
   same inputs (the plain version on the card sums with float atomics in
   no fixed order; the kernel sums each link in the CPU's flat (flow,
   slot) order): ragged shapes, rows with no live slot, all-inactive
   rows, values outside [0, 1], ``want_util`` and ``acc`` on and off,
   and every call the main path made (its strided (F, S) views of the
   packed path record with the cell's link plan: S=9 for fatpaths, S=4
   for ecmp); ``sent``, ``share``, ``util`` and ``acc`` bitwise, and two
   launches bitwise equal; the main path's calls timed, replayed in order,
   with the kernel's per-phase split (``%globaltimer``: each phase's work,
   its blocks' skew and its grid barrier) and the plan a direct call
   builds timed apart;
(a) the ``ksp`` scheme and ``min_path_stats`` on the card:
   ``Session(device="cuda").run`` of sf(q=19) x
   fatpaths(n_layers=9,rho=0.6,scheme=ksp) x permutation x
   transport(steps=2000,transport=ndp) (four (min, +) squarings of
   (8, 722, 722)), then ``min_path_stats(adj, max_l=8)`` and
   ``ops.path_counts_power(adj, 3)``, each with the launch counts set to
   0 before and read after, every semiring call recorded and held
   against the plain version, the statistics bitwise against the CPU port;
(b) the block-sparse semiring kernel: driven over every semiring call
   recorded in phases 1 and (a), then held bitwise against the dense
   kernel and the plain version on those calls, on ragged shapes and on a
   block-diagonal operand, and timed beside them, with its occupancy
   pass's device time apart;
(c) the GF(p) kernel: ``ops.gf_power_sum(K, 4)`` of the Cheung
   propagation matrix of sf(q=11) (4114 directed links, p = 1009), exact
   against the plain version, both modes on ragged shapes (and p = 40009
   over a K that crosses the kernel's reduction chunk), timed beside
   float64 ``torch.matmul`` + ``remainder`` (``f64_matmul_ms``);
(d) the flash-attention kernels: ``ops.attention`` at the gemma2-27b
   (H 32, Hkv 16, D 128, causal, window 4096, softcap 50, S 8192) and
   yi-9b (H 32, Hkv 4, D 128, causal, S 4096) layouts in bf16 (the
   tensor-core kernel), held against the plain version two query heads
   at a time at bf16's rounding (|err| <= 1e-2 |exp| + 1e-3), the same
   layouts in f32 (the CUDA-core kernel) at rtol = atol = 1e-4, and
   ragged cases (D 32 to 256, dead rows) in both; both kernels timed
   beside the plain version and, for yi-9b,
   ``scaled_dot_product_attention`` on the bf16 inputs (the entry's
   ``library_ms``) and on f32 copies (``library_f32_ms``);
4. a small cell (sf(q=5)) on the card and on the CPU through the same
   port, for ecmp, fatpaths and fatpaths with the ksp scheme: tables,
   path-edge tensors, ``depart_step`` and the metrics equal;
5. the main path: ``Session(device="cuda").sweep`` over sf(q=19) (722
   routers, 10 830 endpoints) x {fatpaths(n_layers=9,rho=0.6), ecmp} x
   permutation x transport(steps=2000,transport=ndp), with every launch
   count set to 0 just before and read just after; the same sweep on the
   CPU port, its metrics (``==``) and ``depart_step`` equal to the
   card's; then each cell's scan alone (host wall, µs per step,
   ``torch.profiler`` device time, the link plan's entries and longest
   segment), and the same cells with 256 MiB flows, where all 2000 steps
   run;
   (The CPU port's runs of the cells phases 6-9 hold card vs CPU port
   are queued once the kernels are built on one worker process, which
   runs them beside phases 1-9 on the card; each phase takes its
   results when it reaches them.)
6. the pi_min layer scheme: sf(q=19) x
   fatpaths(n_layers=9,rho=0.6,scheme=pi_min) x permutation x
   transport(steps=2000,transport=ndp) in a new session on the card
   (launch counts 0 before, read after) and on the CPU port: the stacks'
   ``layer_adj``, ``nh``, ``reach`` and ``pathlen`` bitwise, ``depart_step``
   and metrics equal, the card's stack loop-free on every entry; the
   build's boolean products recorded, held bitwise against the plain
   version and timed (``per_semiring.bool.pi_min_build``) beside the
   main sweep's;
7. dynamic traffic at sf(q=19) x fatpaths(n_layers=9,rho=0.6): load over
   a 96-step window, incast under the outcast evaluator and anycast to
   the closest replica, each on the card (counts 0 before, read after)
   and on the CPU port, ``depart_step`` and metrics equal; then the full
   ``load(level=0.5)`` (256-step window, 630 493 flows) on the card only:
   no flow departs before its activation step, metrics finite, and its
   scan profiled over the whole run (µs per step, device time, idle
   share, the water-filling kernel's device time per call, the link
   plan's entries and longest segment, peak device memory);
8. faults at sf(q=19) x fatpaths(n_layers=9,rho=0.6), each cell on the
   card (counts 0 before, read after) and on the CPU port, metrics and
   meta equal and every simulation's ``depart_step``, ``delivered``,
   ``retrans_bytes`` and per-step goodput and stalled curves bitwise:
   static damage (``failures(rate=0.05)`` with bernoulli/repair,
   switch/drop and blast/repair) x permutation x
   transport(steps=2000,transport=ndp), the degraded tables bitwise, the
   reports equal, the card's stack loop-free on every entry, K2 bool held
   against its plain version on each repair build's products and timed;
   a mid-run death at step 40 x permutation(256 MiB) x
   recovery(steps=400,transport=dctcp) for fatpaths and for ecmp, the
   fatpaths scan profiled over its first 80 steps and K1 held against
   its plain version on its own calls (dead links, ``util``) and timed
   with and without ``util``;
   ``churn(rate=0.1)`` x permutation(256 MiB) x availability(steps=400);
   and the ``degradation`` ladder over permutation (7 scenarios);
9. the blocked path engine (phases 1-8 build with ``REPRO_PATH_ENGINE=
   dense``, as their launch counts assume; phase 9 sets each engine for
   its own builds, in a new session per engine): (9.1) the sf(q=19) main
   sweep under ``auto`` (blocked tables and compressed tables from 512
   routers up), its RunResults and ``depart_step`` equal to phase 5's
   dense run, the stacks bitwise across engines, the compressed tables
   exactly ``nh``, each engine's build split over three builds; (9.2) the
   sf(q=29) stacks (rand, ksp, pi_min, ecmp) under each engine, bitwise
   equal, with peak device memory per build, and the blocked ksp build's
   four (min, +) products of (8, 1682, 1682) held against the plain
   version and timed; (9.3) ``min_path_stats(adj, max_l=8)`` of sf(q=29)
   under each engine (distances bitwise, counts bitwise below 2^24), the
   blocked engine's 49 count products of (256, 1682) x (1682, 1682) held
   against the plain version and timed beside the dense engine's 7;
   (9.4) the sf(q=29) fatpaths(n_layers=9,rho=0.6) and ecmp cells x
   permutation x transport(steps=2000,transport=ndp) under ``auto`` on
   the card and on the CPU port, held equal as phase 5 holds its cells,
   with their scan readings and peak memory; (9.5) ``ft2eq(of=sf(q=29))``
   x ecmp x the same pattern and evaluator under each engine on the card:
   tables, RunResult and ``depart_step`` bitwise, the compressed tables'
   block, build seconds and peak memory;
10. the batched sweep engine, with the engine phases 1-8 force: (10.1)
   ``Session(device="cuda").sweep(..., devices=1)`` over sf(q=19) x
   {fatpaths(n_layers=9,rho=0.6), ecmp} x {permutation, uniform} x
   transport(steps=2000,transport=ndp,seeds=4) x cell seeds {0, 1} (8
   cells, 32 elements, one union scan a bucket; counts 0 before, read
   after) against the sequential sweep on the card: RunResults equal
   (``compare_results`` at rtol 0), every element's ``depart_step``,
   ``delivered`` and ``retrans_bytes`` bitwise, the water-filling kernel
   launched once a step a bucket (the tail included) and held bitwise
   against its plain version on a step of each union; each bucket's
   union read again over 80 profiled steps (elements, union flows and
   links, plan entries and longest segment, the kernel's ms a call, µs a
   step, device events a step, idle share, peak memory) beside the µs an
   element-step of the same elements' sequential scans; (10.2) sf(q=19)
   x failures(of=fatpaths(n_layers=9,rho=0.6),rate=0.05,down_step=40) x
   permutation x transport(steps=400,recovery=on,transport=dctcp) and x
   load(level=0.5,window=96) x transport(steps=200), cell seeds {0, 1,
   2}, batched against sequential; (10.3) 10.1's ecmp permutation cell
   (seed 0), batched on the card, against the CPU port's sequential run;
   (10.4) half of 10.1 into a checkpoint directory, then the whole grid
   resumed from it (``sweep_resumed``), equal to 10.1;
11. the evaluators off the scan, each on ``Session(device="cuda")`` and
   ``Session(device="cpu")`` in this process (one numpy, one scipy; their
   versions printed first, and without scipy the phase fails): (11.1)
   sf(q=19) x {fatpaths(n_layers=9,rho=0.6), ecmp} x permutation x
   ``mat`` (the stacks built through the boolean semiring kernel, counts
   0 before and read after), card against CPU port at rtol 0, with the
   wall split into the stack build, the batched table walk (sequences,
   wall to the copy back, and its device time profiled once), the path
   assembly, ``linprog`` and the greedy; (11.2) the same two schemes x
   permutation x ``fabric`` on the same sessions' stacks, at rtol 0, with
   the walk's and the flowlet greedy's seconds; (11.3)
   ``diversity_report(sf(q=11))`` card against CPU port field by field,
   the semiring kernel's launches in it counted and each of its
   recorded products held against the plain version; (11.4)
   ``GFConnectivity.build(sf(q=7).adj, max_len=3)``: ``M`` on the card
   bitwise the CPU port's, ``query_pairs`` on 64 pairs equal;
12. the LM serving path, last, after the card's cache is emptied: (12.1)
   yi-9b at full width (8.83e9 parameters drawn on the card in f32 from
   the seed, held by the engine in bf16) through
   ``repro_torch.launch.serve``'s engine and request loop at the
   launcher's defaults (batch 4, max_len 128, 8 requests of 2-8 tokens,
   16 new tokens each, seed 0), counts 0 before and read after: flash
   attention launched exactly 48 x (1 + 16) x 2 = 1632 times (every
   prefill and decode attention of the path), tokens in the vocabulary
   and logits finite; prefill ms, decode ms per step (host wall ending
   in a synchronize), tokens/s, peak memory, one decode step profiled
   (device time split into flash attention, the matmuls and the rest)
   beside its bound (every bf16 weight read once, the embedding at its
   rows) and the all-weights figure (17.7 GB at 3.35 TB/s, 5.27 ms), and
   the transposed copy of the live prefix a decode attention makes;
   (12.2) the path's own first prefill attention call and a decode call
   (the first batch's last step), held against the plain version at
   bf16's rounding (rtol 1e-2, atol 1e-3) and timed beside it, their
   bounds and ``scaled_dot_product_attention(enable_gqa=True)``; (12.3)
   yi-9b at full width and 2 layers, weights drawn on the host from the
   seed and copied to the card: the CPU port's prefill and 16 decode
   steps teacher-forced on the card, every step's logits within bf16
   compute's tolerance, |err| <= 0.1 (1 + |exp|), of the CPU port's and
   of the same model run in f32 on the card, and how many free-running
   greedy tokens agree; (12.4) on the card, an 11-token prefill and one
   decode step give a 12-token forward's last logits, in f32 with an f32
   cache (rtol = atol = 2e-2, the JAX package's test) and in bf16 with
   a bf16 cache (0.1);
13. training, last (see ``phase_train``): (13.1) K5's backward at
   yi-9b's training layout (B 2, H 32, Hkv 4, S 4096, D 128, causal) in
   bf16 (route ``wgmma-tma``: the wgmma kernels fed by TMA) and f32 (the
   CUDA-core kernels) and at gemma2-27b's (B 1, S 8192, window 4096,
   softcap 50) and olmoe-1b-7b's (B 2, H = Hkv = 16, S 4096, D 128,
   causal) in bf16, each launched twice on its asserted route and the
   two launches held bitwise equal, held against the plain version one
   KV head at a time (|err| <= 2e-2 max|exp| bf16, 1e-4 f32), the
   forward's output (rtol 1e-2 / atol 1e-3 bf16, 1e-4 f32) and LSE
   against the plain version's, timed beside the bound (10 D flops a
   pair) and, without softcap or window,
   ``scaled_dot_product_attention(enable_gqa=True)``'s backward;
   (13.2) yi-9b at full width and 1 layer in f32, two train steps on the
   card and on the CPU port from the same host-drawn weights (loss,
   grad norm and every gradient leaf held), ``remat="full"`` bitwise
   ``"none"`` on the card; (13.3) yi-9b at full width with n_layers cut
   to 8 (the one cut: AdamW's f32 state of 48 layers exceeds the card)
   through ``TrainLoop``, batch 2 x 4096 ``lm`` tokens, 6 steps, counts 0
   before and read after: exactly 96 K5 forward and 48 backward
   launches, no plain-version call, finite losses; losses, step wall,
   tokens/s, peak memory, one more step profiled (K5 forward, K5
   backward, cuBLAS, the optimizer, the rest) beside its bound;
14. the mixture-of-experts family, after phase 13 with the card's cache
   emptied (see ``phase_moe`` and the constants above): (14.1) K5 with a
   V head dimension below Q's at deepseek-v2's layout (H 128, S 2048, D
   192, Dv 128, causal), forward with its LSE and backward in bf16 and
   f32 (the backward twice on its asserted route, ``wgmma-tma`` in bf16,
   bitwise equal), held against the plain versions one KV head at a time
   and timed
   beside their bounds and ``scaled_dot_product_attention``'s where a
   fused backend takes Dv != D; (14.2) olmoe-1b-7b served uncut and
   (14.3) deepseek-v2-236b served at 2 of its 60 layers, both drawn on
   the card in f32 from the seed and served in bf16 through
   ``launch.serve``'s engine at the launcher's defaults, counts 0 before
   and read after (K5 exactly 544 and 4 times: deepseek's absorbed
   decode launches none), tokens in the vocabulary, finite logits; K5
   on the path's own prefill call and (olmoe) decode call held against
   the plain version as in 12.2 and timed beside it;
   prefill and decode ms, tokens/s, peak memory, one decode step
   profiled and split into K5, the expert products, the router and the
   rest beside its bound (the weights it touches, the chosen experts
   only); (14.4) at full width and 1 layer, decode against prefill in
   f32 and bf16, and the share of expert choices bf16 and f32 agree on;
   (14.5) the MLA and MoE blocks' gradients at full width in f32, card
   against the CPU port, and ``remat="full"`` bitwise ``"none"``;
   (14.6) olmoe-1b-7b at 4 layers through ``TrainLoop``, phase 13.3's
   batch and steps: exactly 48 K5 forward and 24 backward launches, no
   plain-version call, finite losses, aux and grad norms, one more step
   profiled beside its bound;
15. the recurrent families, after phase 14 with the card's cache emptied
   (see ``phase_recurrent`` and the constants above): (15.1) K5 at
   zamba2's shared attention block's training layout (B 2, H = Hkv =
   32, S 4096, D 64, window 4096, causal), forward with its LSE and
   backward in bf16 and f32 (the backward twice on its asserted route,
   ``wgmma-tma`` in bf16, bitwise equal), held against the plain
   versions one KV head at a time and timed beside their bounds and
   ``scaled_dot_product_attention(is_causal=True)``'s forward and
   backward (at S <= window the same function); (15.2) zamba2-1.2b and
   (15.3) rwkv6-7b served uncut, drawn on the card in f32 from the seed
   and served in bf16 through ``launch.serve``'s engine at the
   launcher's defaults, counts 0 before and read after (K5 exactly 68
   and 0 times), tokens in the vocabulary, finite logits, prefill and
   decode ms, tokens/s, peak memory, one decode step profiled and split
   into K5, cuBLAS, the SSM's conv and scan or the WKV recurrence and
   the rest beside its bound; zamba2's own K5 prefill and decode calls
   held and timed as in 12.2; (15.4) zamba2 at 19 layers and rwkv6 at 2
   in f32: the CPU port's prefill and 16 decode steps teacher-forced on
   the card (rtol 1e-4, atol 1e-4 max|exp|), and decode against prefill
   on the card in f32 and bf16 (zamba2 after a 600-token prefill:
   ``ssd_chunked`` and an ``ssd_scan`` for the state); (15.5) the m (S
   600, a padded last chunk), shared a (twice) and r blocks' gradients
   at full width in f32, card against the CPU port, and zamba2's
   ``remat="full"`` bitwise ``"none"`` at 19 layers; (15.6) zamba2-1.2b
   uncut and (15.7) rwkv6-7b at 2 of 32 layers through ``TrainLoop``,
   batch 2 x 4096 and 2 x 512, 4 and 3 steps: exactly 16 K5 forward and
   8 backward launches (zamba2) and none (rwkv6), no plain-version call,
   finite losses and grad norms, peak memory, one more step profiled
   beside its bound;
16. one ``{"kernels": [...]}`` line: launches on the main path (for the
   block-sparse and GF(p) kernels, on their own phase's path, for flash
   attention the serving path's, for its backward the training path's;
   each path's own counts in ``path_launches``),
   error against the plain version (0 for the water-filling kernel, which
   phase 3 holds bitwise), kernel / plain / bound / library
   times (``ms``, ``plain_ms`` and ``library_ms`` are device time per call
   from ``torch.profiler``, each reading taken again until the trace
   holds a device event for every launch, memset and copy call);
17. the last line: ``{"ok": true, "device": {...}}``.

Bounds use the H100 SXM's published dense peaks: 3.35 TB/s of device
memory, 1979 TOP/s of int8 and 989 TFLOP/s of bf16 on the tensor cores,
and 67 TFLOP/s of float32 outside the tensor cores (the count semiring's
rate: its exact fp64 tensor-core sums peak at the same 67 TFLOP/s).  The
GF(p) product is bound at the int8 rate over its 8-bit limb products
(four for p > 256, one below): limbs^2 x 2 E^3 operations.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import importlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
INT8_OP_PER_S = 1979e12
BF16_FLOP_PER_S = 989e12
# Markers of cuBLAS's (and cuBLASLt's) product kernels in profiler names.
_CUBLAS = ("gemm", "gemv", "xmma", "cutlass", "nvjet", "splitk", "cublas")
# Markers of K5's backward kernels in profiler names: the CUDA-core
# kernels and every kernel of the wgmma routes' namespace ``wg`` (the
# statistics pass, dK/dV, dQ).  ``_bwd_split`` fails on a backward kernel
# that none of them matches, so the training splits count every one.
_K5_BWD = ("::delta_kernel", "::dkdv_kernel", "::dq_kernel", "::wg::")
# Host calls that put one event on the device: kernel launches (runtime
# and driver API), memsets and copies.
DEVICE_WORK_CALLS = ("Launch", "Memset", "Memcpy")
SPIN_CYCLES = 4_000_000     # about 2 ms at the H100's 1980 MHz
# (lead, events lost) of the profiler readings taken again.
PROFILE_RETRIES: list = []
# Lead spin kernels missing from each trace taken.
PROFILE_LEAD_LOST: list = []
# The lead of the last reading that held every event: the next trace
# starts there, since the losses grow as the process ages.
PROFILE_LEAD = [8]
MAIN_TOPO = "sf(q=19)"
MAIN_ROUTINGS = ("fatpaths(n_layers=9,rho=0.6)", "ecmp")
MAIN_PATTERN = "permutation"
MAIN_EVAL = "transport(steps=2000,transport=ndp)"
# 256 MiB per flow: more than 2000 steps at line rate (125 kB a step).
LONG_PATTERN = "permutation(flow_size=268435456)"
KSP_ROUTING = "fatpaths(n_layers=9,rho=0.6,scheme=ksp)"
PIMIN_ROUTING = "fatpaths(n_layers=9,rho=0.6,scheme=pi_min)"
DYN_ROUTING = "fatpaths(n_layers=9,rho=0.6)"
# Dynamic cells held card vs CPU port: load over a 96-step window
# (236 435 flows, so that its CPU-port run takes about a minute on the
# card's host: 64 steps took 28 s there, 128 steps 91 s), incast waves
# under the outcast evaluator, anycast to the closest replica.
# Each with the steps its scan is profiled over: the whole run (None), or
# anycast's first 320, since its four replicas' links keep it busy for
# all 2000 steps.
DYN_CELLS = (("load(level=0.5,window=96)", MAIN_EVAL, None),
             ("incast", "outcast(steps=2000,transport=ndp)", None),
             ("anycast(policy=closest)", MAIN_EVAL, 320))
# The paper-scale load cell, card only: the default 256-step window,
# 630 493 flows.
FULL_LOAD = "load(level=0.5)"
# Phase 8, faults on the fatpaths stack: static damage for three (pattern,
# mode) pairs; a mid-run death at step 40 under dctcp recovery for
# fatpaths and for ecmp (layer-pinned: the never-recovers control); churn
# under the availability evaluator; the degradation ladder at its default
# rates and patterns.
FAULT_RATE = 0.05
STATIC_DAMAGE = (("bernoulli", "repair"), ("switch", "drop"),
                 ("blast", "repair"))
RECOVERY_ROUTINGS = tuple(f"failures(of={r},rate={FAULT_RATE},down_step=40)"
                          for r in (DYN_ROUTING, "ecmp"))
RECOVERY_PATTERN = LONG_PATTERN
RECOVERY_EVAL = "recovery(steps=400,transport=dctcp)"
# The fatpaths recovery scan is profiled over its first 80 steps, the
# death at step 40 and 40 steps of recovery (285 device events a step,
# 114 000 over the whole run).
RECOVERY_PROFILE_STEPS = 80
CHURN_ROUTING = f"churn(of={DYN_ROUTING},rate=0.1)"
AVAIL_EVAL = "availability(steps=400)"
DEGRADE_EVAL = "degradation"
# The CPU port's side of the cells phases 6-9 hold card vs CPU port runs
# in one worker process beside the card's phases (``_start_cpu_port``),
# on CPU_PORT_THREADS of the host's cores; serially those runs took 235
# of the script's 893 s on an H100 machine's 8 cores.  CPU_PORT maps each
# cell to its path engine and pending result.
CPU_PORT_THREADS = 6
CPU_PORT: dict = {}
# Seconds phases 6-9 waited on each result, and each run's own wall.
CPU_PORT_WAIT: list = []
CPU_PORT_WALL: list = []
# Phase 9, the blocked engine: the paper's scale, sf(q=29) (1 682 routers,
# radix 43, 37 004 endpoints, its table 5), and its cost-equal two-layer
# fat tree (903 routers, spine radix 861, 37 023 endpoints): the paper's
# headline pair.
PAPER_TOPO = "sf(q=29)"
FT2_TOPO = f"ft2eq(of={PAPER_TOPO})"
PAPER_STACKS = (DYN_ROUTING, KSP_ROUTING, PIMIN_ROUTING, "ecmp")
BUILD_REPEATS = 3
# Phase 10, the batched sweep engine: the main cells' grid widened to two
# patterns, two cell seeds and four sim seeds a cell (8 cells, 32
# elements); a mixed grid of a mid-run death under dctcp recovery and a
# dynamic load cell over the same failures routing, three cell seeds each.
SWEEP_PATTERNS = (MAIN_PATTERN, "uniform")
SWEEP_EVAL = "transport(steps=2000,transport=ndp,seeds=4)"
SWEEP_SEEDS = (0, 1)
MIXED_ROUTING = f"failures(of={DYN_ROUTING},rate={FAULT_RATE},down_step=40)"
MIXED_CELLS = ((MAIN_PATTERN, "transport(steps=400,recovery=on,"
                "transport=dctcp)"),
               ("load(level=0.5,window=96)", "transport(steps=200)"))
MIXED_SEEDS = (0, 1, 2)
# Phase 11, the evaluators off the scan: the main cells' topology, schemes
# and pattern under ``mat`` and ``fabric``; the diversity report of
# sf(q=11) (242 routers) and the Cheung GF(p) oracle of sf(q=7) (98
# routers, 1 078 directed links; sf(q=11)'s 4 114 is above its limit).
OFFSCAN_EVALS = ("mat", "fabric")
DIVERSITY_TOPO = "sf(q=11)"
GF_BUILD_TOPO = "sf(q=7)"
GF_BUILD_LEN = 3
GF_TOPO_Q = 11          # sf(q=11): 242 routers, 4114 directed links
GF_P = 1009
GF_LEN = 4
# Phase 12, the LM serving path: yi-9b (48 layers, d_model 4096, 32
# query heads : 4 KV heads, d_head 128), the launcher's defaults; the
# same width at 2 layers, card against the CPU port.  bf16 compute's
# tolerance there: |err| <= 0.1 (1 + |exp|).  bf16 rounding through two
# layers leaves either side up to 0.092 from the same model in f32, on
# logits up to 6.1, and the two round differently (0.054 apart at most);
# measured on an H100 with this script's 12.3.
SERVE_ARCH = "yi-9b"
SERVE_SHORT_LAYERS = 2
SERVE_BF16_TOL = 0.1
# Attention layouts at full width, from src/repro/configs/*.py; S is the
# model's context (gemma2) or a long prompt (yi-9b).
ATTN_LAYOUTS = {
    "gemma2-27b": dict(h=32, hkv=16, d=128, s=8192, causal=True,
                       window=4096, softcap=50.0),
    "yi-9b": dict(h=32, hkv=4, d=128, s=4096, causal=True, window=0,
                  softcap=0.0),
}
# Phase 13, training: yi-9b at full width with n_layers cut from 48 to 8
# (AdamW's f32 masters and moments of all 48 layers, 106 GB before any
# gradient, exceed the card's 80 GB; 8 layers hold 1.908e9 parameters,
# 22.9 GB with their moments), its own bf16 compute, f32 parameters and
# full remat, batch 2 x 4096 tokens (Yi's pretraining context), 6 steps.
# K5's backward is held against its plain version at yi-9b's training
# layout (batch 2) in bf16 and f32 and at gemma2-27b's (softcap, window,
# S 8192) in bf16: |err| <= 1e-4 max|exp| in f32 (both sum f32 products
# in other orders, as the forward's 1e-4), 2e-2 max|exp| in bf16 (one
# bf16 rounding of each gradient, 2^-8, with room for the sums' order).
# The card against the CPU port at full width and 1 layer in f32, batch
# 1 x 128 (the CPU side about 30 s on the card's host): loss rtol 1e-5,
# grad norm rtol 1e-4, every gradient leaf within 1e-4 of its largest
# (K5 and its backward hold 1e-4 to the plain version; cuBLAS and the
# CPU sum in other orders); the losses of step 2 within 1e-4.
TRAIN_ARCH = "yi-9b"
TRAIN_LAYERS = 8
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 4096, 6
TRAIN_SHORT_SEQ = 128
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
BWD_LAYOUTS = {
    "yi-9b": dict(b=2, **ATTN_LAYOUTS["yi-9b"]),
    "gemma2-27b": dict(b=1, **ATTN_LAYOUTS["gemma2-27b"]),
    # olmoe-1b-7b's training layout (phase 14.6): MHA, 16 heads of 128.
    "olmoe-1b-7b": dict(b=2, h=16, hkv=16, d=128, s=4096, causal=True,
                        window=0, softcap=0.0),
}
# Phase 14, the mixture-of-experts family (src/repro/configs/olmoe_1b_7b.py
# and deepseek_v2_236b.py, arXiv:2409.02060 and 2405.04434).  K5 at
# deepseek-v2's prefill and training attention: 128 heads, q and k nope +
# rope = 192 wide, v 128, causal, S 2048 (its bounds as phase 13's).
# olmoe-1b-7b served uncut (16 layers, 6.92e9 parameters); deepseek-v2-236b
# served with n_layers cut from 60 to 2, the one cut (a layer holds 3.97e9
# parameters: 60 are 476 GB in bf16; 2 and the 1.05e9 of embedding and
# head are 9.0e9, 36 GB to draw in f32 and 18 GB held in bf16).  Decode
# against prefill at full width and 1 layer: f32 with an f32 cache at
# rtol = atol = 2e-2 (the JAX package's test), bf16 with a bf16 cache at
# 0.1 (phase 12's bf16 bound).  The two new blocks' gradients at full width
# in f32, card against the CPU port: every leaf within 1e-4 of its largest
# (K5 and its backward hold 1e-4 to the plain version; cuBLAS and the CPU
# sum in other orders).  olmoe-1b-7b trained with n_layers cut from 16 to
# 4, the one cut (AdamW's f32 masters and two moments of 16 layers are
# 6.92e9 x 16 B = 111 GB; 4 layers 1.89e9 x 16 B = 30 GB): phase 13's
# batch, steps, compute and remat.  deepseek-v2 does not train on the card
# at full width (one layer's f32 parameters, gradients and moments are
# about 5.0e9 x 16 B = 80 GB): its training is held on the CPU at smoke
# size, here through 14.1 and 14.5.
MOE_ARCHS = ("olmoe-1b-7b", "deepseek-v2-236b")
MOE_SERVE_LAYERS = {"olmoe-1b-7b": 16, "deepseek-v2-236b": 2}
MLA_LAYOUT = dict(b=1, h=128, hkv=128, s=2048, d=192, dv=128, causal=True,
                  window=0, softcap=0.0)
MOE_GRAD_TOKENS, MLA_GRAD_SEQ = 512, 64
MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS = "olmoe-1b-7b", 4


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


def _ptxas_report(logs):
    """Each built kernel's registers, spill bytes and static shared memory
    from ``ptxas -v``: {library: {kernel: [registers, spill stores, spill
    loads, smem bytes]}}, names demangled by ``c++filt`` where it runs."""
    import re

    out = {}
    for lib, log in logs.items():
        kernels, name = {}, None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = m.group(1)
                kernels[name] = [None, 0, 0, 0]
            elif name and "spill stores" in line:
                st, ld = re.findall(r"(\d+) bytes spill", line)
                kernels[name][1:3] = [int(st), int(ld)]
            elif name and "Used" in line and "registers" in line:
                kernels[name][0] = int(re.search(r"Used (\d+) registers",
                                                 line).group(1))
                smem = re.search(r"(\d+) bytes smem", line)
                kernels[name][3] = int(smem.group(1)) if smem else 0
        try:
            plain = subprocess.run(["c++filt"], input="\n".join(kernels),
                                   capture_output=True, text=True,
                                   check=True).stdout.split("\n")
        except (OSError, subprocess.CalledProcessError):
            plain = list(kernels)
        out[lib] = {p.replace("(anonymous namespace)::", "")[:90]: v
                    for p, v in zip(plain, kernels.values())}
    return out


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


@contextlib.contextmanager
def _patched(module, attr, wrap):
    """Replace ``module.attr`` by ``wrap(module.attr)`` for the block."""
    real = getattr(module, attr)
    setattr(module, attr, wrap(real))
    try:
        yield
    finally:
        setattr(module, attr, real)


@contextlib.contextmanager
def _recording(modules, calls, tag):
    """Put a recorder in front of ``semiring_matmul`` in each of
    ``modules``: every call appends ``(tag, a, b, semiring)`` to
    ``calls`` and goes on to the real wrapper."""
    def recorder(fn):
        def rec(a, b, semiring="count", **kw):
            calls.append((tag, a, b, semiring))
            return fn(a, b, semiring, **kw)
        return rec

    with contextlib.ExitStack() as stack:
        for m in modules:
            stack.enter_context(_patched(m, "semiring_matmul", recorder))
        yield


def capture_main_inputs(Session, paths, transport):
    """Drive the main cells once with a recorder in front of each kernel
    wrapper, keeping every semiring call's operands and every water-filling
    call's inputs, tagged with the cell's routing, so that phases 2 and 3
    check and time the kernels on exactly what the main path hands them
    (the water-filling edges are the path's strided view of its packed
    (F, S + 2) record)."""
    mm, wf = [], []
    ses = Session(device="cuda")
    for routing in MAIN_ROUTINGS:
        def rec_wf(fn, routing=routing):
            def rec(edges, w, desired, cap, **kw):
                wf.append((routing, (edges, w, desired, cap), kw))
                return fn(edges, w, desired, cap, **kw)
            return rec

        with _recording([paths], mm, routing), \
                _patched(transport, "waterfill_step", rec_wf):
            ses.run(MAIN_TOPO, routing, MAIN_PATTERN, MAIN_EVAL)
    torch.cuda.synchronize()
    print(f"# captured the main path's kernel inputs: {len(mm)} semiring "
          f"and {len(wf)} water-filling calls", flush=True)
    for routing in MAIN_ROUTINGS:
        offsets, entries, _ = next(kw["plan"] for r, _, kw in wf
                                   if r == routing)
        seg = (offsets[1:] - offsets[:-1]).max()
        print(f"# link plan of {routing}: {entries.numel()} entries, "
              f"longest segment {int(seg)}", flush=True)
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
    return device_ms / iters / len(calls), wall


def _replay_split_ms(fn, calls, iters: int, marker: str):
    """``fn(*call)`` replayed as in :func:`_replay_ms`: ``(device ms,
    device ms of the kernels whose name holds marker)`` per call, both
    from one profiled replay."""
    def replay():
        for _ in range(iters):
            for c in calls:
                fn(*c)
    fn(*calls[0])
    device_ms, _, top = _profile(replay, top_n=10 ** 6)
    part = sum(ms for name, ms, _ in top if marker in name)
    per = iters * len(calls)
    return device_ms / per, part / per


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


def _check_equal(out, exp, what):
    """Raise unless ``out`` equals ``exp`` bitwise (shape, type, bits);
    returns the max abs difference over finite entries (0.0)."""
    torch.cuda.synchronize()
    if out.shape != exp.shape or out.dtype != exp.dtype:
        raise AssertionError(f"{what}: {tuple(out.shape)}/{out.dtype} vs "
                             f"{tuple(exp.shape)}/{exp.dtype}")
    if not torch.equal(out, exp):
        raise AssertionError(f"{what} is not bitwise equal to its plain "
                             "version")
    diff = out.double() - exp.double()
    finite = torch.isfinite(exp.double())
    return float(diff[finite].abs().max()) if finite.any() else 0.0


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
        return _check_equal(semiring_matmul(a, b, semiring),
                            ref.semiring_matmul_ref(a, b, semiring),
                            f"semiring {semiring} {what}")

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
    if {s for _, _, _, s in main_calls} != {"bool"}:
        raise AssertionError("the main sweep made other than bool products")
    per = {"bool": dict(path="main sweep", calls=len(calls), ms=ms,
                        plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                        library_ms=library_ms)}
    return dict(name="semiring", route="cuda",
                source="src/repro_torch/kernels/csrc/semiring.cu",
                replaces="src/repro/kernels/semiring.py:92",
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=library_ms,
                per_semiring=per)


def phase_semiring_paths(ref, semiring_matmul, recorded, path_launches, k2):
    """K2 timed on the count and minplus calls of their own paths
    (recorded in phase (a)), beside the plain version and, for count,
    ``torch.matmul`` of f32 copies (TF32 off); into ``per_semiring``.
    Each recorded call is one launch on its path (phase (a) holds the
    launch counts to the recorded calls)."""
    paths = {"count": ("min_path_stats", "path_counts_power"),
             "minplus": ("ksp",)}
    for s, tags in paths.items():
        mine = [(a, b, s) for tag, a, b, ss in recorded
                if ss == s and tag in tags]
        ms, wall = _replay_ms(semiring_matmul, mine, 20)
        plain_ms, _ = _replay_ms(ref.semiring_matmul_ref, mine,
                                 20 if s == "count" else 2)
        lib = None
        extra = {}
        if s == "count":
            lib, _ = _replay_ms(torch.matmul, [(a.float(), b.float())
                                               for a, b, _ in mine], 20)
            # The split-K sum pass apart from the product, one reading.
            _, extra["reduce_ms"] = _replay_split_ms(semiring_matmul, mine,
                                                     20, "count_reduce")
            # The same products on copies whose rows are padded with zeros
            # to a multiple of 4 floats, so that the kernel stages 16-byte
            # copies (722-float rows allow 8); equal results, checked.
            def pad4(x, rows):
                return torch.nn.functional.pad(
                    x, (0, -x.shape[1] % 4, 0, -x.shape[0] % 4 if rows
                        else 0))
            padded = [(pad4(a, False), pad4(b, True), "count")
                      for a, b, _ in mine]
            for (a, b, _), (ap, bp, _) in zip(mine, padded):
                got = semiring_matmul(ap, bp, "count")
                if not torch.equal(got[:, :b.shape[1]],
                                   semiring_matmul(a, b, "count")):
                    raise AssertionError("count on padded operands differs")
            extra["padded16_ms"] = _replay_ms(semiring_matmul, padded, 20)[0]
            # The same products as one batched call (B is the adjacency in
            # every one): a full grid without split K, per product.
            if all(torch.equal(b, mine[0][1]) for _, b, _ in mine):
                stack = torch.stack([a for a, _, _ in mine])
                one = [(stack, mine[0][1], "count")]
                extra["batched_ms_per_product"] = _replay_ms(
                    semiring_matmul, one, 10)[0] / len(mine)
                extra["batched_library_ms_per_product"] = _replay_ms(
                    torch.matmul, [(stack, mine[0][1].float())],
                    10)[0] / len(mine)
        bound, by = _sum_bound([_mm_bound(*c) for c in mine])
        k2["per_semiring"][s] = dict(
            path=" + ".join(tags), calls=len(mine),
            launches=len(mine), ms=ms, wall_ms=wall, plain_ms=plain_ms,
            bound_ms=bound / len(mine), bound_by=by, library_ms=lib,
            shapes=sorted({(tuple(a.shape), tuple(b.shape))
                           for a, b, _ in mine}), **extra)
        print(f"# semiring {s} on its path's calls: "
              + json.dumps(k2["per_semiring"][s]), flush=True)
    k2["path_launches"] = path_launches


def _wf_instance(f, s, e, seed, dev="cuda", scale=1.0):
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
    if scale != 1.0:                     # outside [0, 1]
        w = w * (0.5 + torch.rand(f, generator=g) * scale)
        desired = desired * scale
        cap = 0.25 + torch.rand(e, generator=g) * scale
    return [x.to(dev) for x in (edges, w, desired, cap, active)]


_REF_KW = ("active", "fair_iters", "want_util", "acc")


def _wf_check(ref, waterfill_step, args, kw, what):
    """Two launches bitwise equal, and every output bitwise the plain
    version's on CPU copies of the inputs (with the kernel's masking of
    -1 slots when ``active`` is None).  Returns the max abs error (0.0)."""
    k1 = waterfill_step(*args, **kw)
    k2 = waterfill_step(*args, **kw)
    cpu = {k: (v.cpu() if torch.is_tensor(v) else v)
           for k, v in kw.items() if k in _REF_KW}
    if cpu.get("active") is None:
        cpu["active"] = torch.ones(args[1].shape, dtype=torch.bool)
    r = ref.waterfill_ref(*[a.cpu() for a in args], **cpu)
    torch.cuda.synchronize()
    if len(k1) != len(r):
        raise AssertionError(f"waterfill {what}: {len(k1)} outputs, plain "
                             f"version {len(r)}")
    err = 0.0
    for name, x, y, z in zip(("sent", "share", "util" if kw.get("want_util")
                              else "acc", "acc"), k1, k2, r):
        if not torch.equal(x, y):
            raise AssertionError(f"waterfill {what} {kw.get('fair_iters')}:"
                                 f" two launches differ in {name}")
        err = max(err, _check_equal(x.cpu(), z, f"waterfill {what} {name}"))
    return err


def _wf_bound_s(f, s, e, util=False):
    """Least time of one water-filling step in s: edges (F, S), w,
    desired, active, acc and cap read; sent, share and acc (and util)
    written."""
    nbytes = f * s * 4 + f * (4 + 4 + 1 + 4) + e * 4 + f * 4 * (3 + util)
    return nbytes / HBM_BYTES_PER_S


def phase_waterfill(ref, waterfill, main_calls):
    waterfill_step = waterfill.waterfill_step
    shapes = [(1, 5, 33, 1.0), (7, 3, 19, 1.0), (130, 9, 513, 1.0),
              (1000, 8, 3001, 1.0), (10830, 8, 42599, 1.0),
              (1000, 8, 3001, 50.0), (10830, 9, 42599, 300.0)]
    max_err = 0.0
    n_cases = 0
    for f, s, e, scale in shapes:
        edges, w, desired, cap, active = _wf_instance(f, s, e, f + e,
                                                      scale=scale)
        acc = torch.rand(f, generator=torch.Generator().manual_seed(f)) \
            .mul(100.0).cuda()
        for act in (active, torch.zeros_like(active), None):
            for fi in (0, 1, 2):
                for wu in (False, True):
                    for a in (None, acc):
                        kw = dict(active=act, fair_iters=fi, want_util=wu,
                                  acc=a)
                        max_err = max(max_err, _wf_check(
                            ref, waterfill_step, (edges, w, desired, cap),
                            kw, f"({f},{s},{e}) x{scale}"))
                        n_cases += 1
    # The main path's own inputs: every call as the path made it (with
    # its plan, layers and accumulator), and the first call of each cell
    # again with every fair_iters and want_util.
    first = {}
    for i, (routing, args, kw) in enumerate(main_calls):
        first.setdefault(routing, (args, kw))
        max_err = max(max_err, _wf_check(ref, waterfill_step, args, kw,
                                         f"main-path call {i} ({routing})"))
        n_cases += 1
    for routing, (args, kw) in first.items():
        for fi in (0, 1, 2):
            for wu in (False, True):
                max_err = max(max_err, _wf_check(
                    ref, waterfill_step, args,
                    dict(kw, fair_iters=fi, want_util=wu),
                    f"main-path first call ({routing})"))
                n_cases += 1
    print(f"# phase 3: waterfill bitwise equal to its plain version on CPU "
          f"copies (sent, share, util, acc) on {n_cases} cases "
          f"({len(main_calls)} of them the main path's own calls, strided "
          "edges, with the cell's link plan), and launch to launch",
          flush=True)

    def wf_bound(edges, w, desired, cap):
        return _wf_bound_s(*edges.shape, cap.shape[0]), 0.0

    def kernel(args, kw):
        return waterfill_step(*args, **kw)

    def plain(args, kw):
        return ref.waterfill_ref(*args, **{k: v for k, v in kw.items()
                                           if k in _REF_KW})

    calls = [(args, kw) for _, args, kw in main_calls]
    ms, wall = _replay_ms(kernel, calls, 10)
    plain_ms, plain_wall = _replay_ms(plain, calls, 3)
    bound, by = _sum_bound([wf_bound(*args) for args, _ in calls])
    bound /= len(calls)
    # The plan a direct call (no plan given) builds from its (F, S) edges.
    plan_ms, _ = _replay_ms(waterfill.link_plan,
                            [(args[0], args[3].shape[0])
                             for args, _ in calls], 3)
    # Per-phase split over the main path's calls, from %globaltimer: block
    # 0's stamps at the start, after each grid barrier and at its end, and
    # every block's arrival at each barrier.  A phase's work runs from the
    # last release to its last arrival; the barrier from the last arrival
    # to block 0's release; skew is last minus first arrival.
    fi = calls[0][1]["fair_iters"]
    nb = 2 * fi + 1
    blocks = waterfill._lib().waterfill_grid_blocks()
    stamps = torch.zeros((len(calls), nb + 2 + blocks * nb),
                         dtype=torch.int64, device="cuda")
    for _ in range(2):
        for j, (args, kw) in enumerate(calls):
            waterfill._launch(*args, kw["active"], kw["fair_iters"], False,
                              kw["acc"], kw["plan"], kw["layer"],
                              phase_ns=stamps[j])
    torch.cuda.synchronize()
    st = stamps.double()
    rel = st[:, :nb + 2]                       # start, releases, end
    arr = st[:, nb + 2:].reshape(len(calls), blocks, nb)
    last, first_in = arr.max(1).values, arr.min(1).values
    us = lambda x: float(x.mean()) / 1e3         # noqa: E731
    names = [f"{p}{r}" for r in range(fi + 1) for p in ("links", "flows")]
    phase_split = {"blocks": blocks}
    for b in range(nb):
        phase_split[names[b]] = {
            "work_us": us(last[:, b] - rel[:, b]),
            "skew_us": us(last[:, b] - first_in[:, b]),
            "barrier_us": us(rel[:, b + 1] - last[:, b])}
    phase_split[names[nb]] = {"work_us": us(rel[:, nb + 1] - rel[:, nb])}
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
          f"kernel {wall:.5f}, plain {plain_wall:.5f}; direct-call plan "
          f"build {plan_ms:.5f}; per phase (µs, %globaltimer; the last "
          "flow phase is block 0's own) "
          + json.dumps(phase_split), flush=True)
    return dict(name="waterfill", route="cuda",
                source="src/repro_torch/kernels/csrc/waterfill.cu",
                replaces="src/repro/kernels/waterfill.py:167",
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=None,
                plan_build_ms=plan_ms, phase_split_ms=phase_split)


def _need_launches(launches, names, what, exactly=None):
    """Raise unless each kernel of ``names`` was launched (``exactly``
    that many times, when given; 0 for a path that must not launch
    it)."""
    for name in names:
        if (launches[name] <= 0 if exactly is None
                else launches[name] != exactly):
            raise AssertionError(f"{what} launched the {name} kernel "
                                 f"{launches[name]} times")


def _check_count_call(out, exp, a, b, what):
    """A recorded ``count`` product against its plain version: bitwise
    where every exact entry is below 2^24, the range where the count
    semiring is exact.  Above it (the 7th and 8th walk-count powers of
    sf(q=19) reach 7e8) f32 sums depend on their order, so both must lie
    within rtol 4e-6 of the float64 product (at most ~30 nonzero terms
    per entry, each rounding by 2^-24).  Returns (max abs err vs plain,
    whether bitwise was required)."""
    exact = torch.matmul(a.double(), b.double())
    if float(exact.max()) < 2 ** 24:
        return _check_equal(out, exp, what), True
    for x, name in ((out, "kernel"), (exp, "plain version")):
        if not torch.allclose(x.double(), exact, rtol=4e-6, atol=0.0):
            raise AssertionError(f"{what}: {name} not within rtol 4e-6 of "
                                 "the float64 product")
    return float((out.double() - exp.double()).abs().max()), False


def phase_ksp(Session, paths, pathcount, ops, transport, prng, ref,
              semiring_matmul, LAUNCHES, reset_launches):
    """(a) The ksp cell and the path statistics at sf(q=19) on the card,
    each driven with the launch counts set to 0 before and read after;
    every semiring call recorded and held against the plain version."""
    ses = Session(device="cuda")
    calls = []
    reset_launches()
    with _recording([paths], calls, "ksp"):
        rr = ses.run(MAIN_TOPO, KSP_ROUTING, MAIN_PATTERN, MAIN_EVAL)
    torch.cuda.synchronize()
    ksp_launches = dict(LAUNCHES)
    _need_launches(ksp_launches, ("semiring", "waterfill"), "the ksp cell")
    if ksp_launches["semiring"] != len(calls):
        raise AssertionError(f"the ksp cell launched the semiring kernel "
                             f"{ksp_launches['semiring']} times for "
                             f"{len(calls)} recorded calls")
    m = rr.metrics
    if not m["finished"] > 0 or not all(
            math.isfinite(m[k]) for k in ("fct_p50_us", "fct_p99_us")):
        raise AssertionError(f"{rr.cell_id}: metrics {m}")
    kinds = {}
    for _, a, b, s in calls:
        kinds.setdefault(s, []).append((tuple(a.shape), tuple(b.shape)))
    if len(kinds.get("minplus", ())) != 4:
        raise AssertionError(f"the ksp cell made {kinds.get('minplus')} "
                             "(min, +) products, not 4")
    info = dict(cell=rr.cell_id, metrics=m, build_s=rr.meta["build_s"],
                cell_wall_s=rr.wall_s, launches=ksp_launches,
                semiring_calls={s: len(v) for s, v in kinds.items()},
                **_scan_reading(ses, transport, prng, KSP_ROUTING,
                                MAIN_PATTERN, 2000, 80))
    print("# phase (a): " + json.dumps(info), flush=True)

    adj = np.asarray(ses.topology(MAIN_TOPO).adj)
    n_ksp = len(calls)
    ksp_calls = list(calls)
    reset_launches()
    with _recording([paths, pathcount], calls, "min_path_stats"):
        dist_g, cnt_g = paths.min_path_stats(adj, max_l=8, device="cuda")
    with _recording([paths, pathcount], calls, "path_counts_power"):
        pc_g = ops.path_counts_power(torch.as_tensor(adj, device="cuda"), 3)
    torch.cuda.synchronize()
    stats_launches = dict(LAUNCHES)
    _need_launches(stats_launches, ("semiring",),
                   "min_path_stats and path_counts_power")
    if stats_launches["semiring"] != len(calls) - len(ksp_calls):
        raise AssertionError("min_path_stats and path_counts_power launched "
                             f"the semiring kernel {stats_launches['semiring']}"
                             f" times for {len(calls) - len(ksp_calls)} "
                             "recorded calls")
    dist_c, cnt_c = paths.min_path_stats(adj, max_l=8, device="cpu")
    pc_c = ops.path_counts_power(torch.as_tensor(adj), 3)
    if not (np.array_equal(dist_g, dist_c) and np.array_equal(cnt_g, cnt_c)):
        raise AssertionError("min_path_stats differs card vs CPU")
    if not torch.equal(pc_g.cpu(), pc_c):
        raise AssertionError("path_counts_power differs card vs CPU")

    max_err, n_exact = 0.0, 0
    for i, (tag, a, b, s) in enumerate(calls):
        what = f"semiring {s} call {i} ({tag})"
        out = semiring_matmul(a, b, s)
        exp = ref.semiring_matmul_ref(a, b, s)
        if s == "count":
            err, exact = _check_count_call(out, exp, a, b, what)
        else:
            err, exact = _check_equal(out, exp, what), True
        max_err, n_exact = max(max_err, err), n_exact + exact
    print(f"# phase (a): min_path_stats (c_min max {cnt_g.max():.0f}) and "
          "path_counts_power(adj, 3) bitwise card vs CPU port; launches "
          f"{stats_launches}; {len(calls)} recorded semiring calls "
          f"({n_ksp} from the ksp cell) held against the plain version: "
          f"{n_exact} bitwise, {len(calls) - n_exact} count products above "
          f"2^24 within rtol 4e-6 of float64 (max abs err {max_err:.6g})",
          flush=True)
    path_launches = {"ksp cell": ksp_launches["semiring"],
                     "min_path_stats + path_counts_power":
                         stats_launches["semiring"]}
    return calls, info, path_launches


def _sparse_bound(a, b, semiring, occupancy, tile=128):
    """((bytes s, operations s), occupied share) of one block-sparse
    product: K2's bound counted over the occupied tiles and tile pairs
    only (the output is written whole)."""
    ao = occupancy(a, tile, tile, semiring).float()
    bo = occupancy(b, tile, tile, semiring).float()
    ao = ao if ao.ndim == 3 else ao[None]
    bo = bo if bo.ndim == 3 else bo[None]
    batch = max(ao.shape[0], bo.shape[0])
    pairs = float(torch.matmul(ao.expand(batch, -1, -1),
                               bo.expand(batch, -1, -1)).sum())
    share = pairs / (batch * ao.shape[1] * ao.shape[2] * bo.shape[2])
    m, k = a.shape[-2:]
    n = b.shape[-1]
    item = 1 if semiring == "bool" else 4
    nbytes = (a.numel() * float(ao.mean()) + b.numel() * float(bo.mean())
              + batch * m * n) * item
    rate = INT8_OP_PER_S if semiring == "bool" else F32_FLOP_PER_S
    return (nbytes / HBM_BYTES_PER_S,
            2.0 * batch * m * k * n * share / rate), share


def phase_sparse(ref, sparse_semiring_matmul, occupancy, semiring_matmul,
                 recorded, LAUNCHES, reset_launches):
    """(b) The block-sparse kernel on every recorded semiring call, then
    held bitwise against the dense kernel and the plain version."""
    calls = [(a, b, s) for _, a, b, s in recorded]
    reset_launches()
    for a, b, s in calls:
        sparse_semiring_matmul(a, b, s)
    torch.cuda.synchronize()
    launches = LAUNCHES["sparse"]
    _need_launches(LAUNCHES, ("sparse",), "phase (b)", len(calls))

    max_err, n_cases = 0.0, 0

    def check(a, b, s, what, **tiles):
        out = sparse_semiring_matmul(a, b, s, **tiles)
        if not torch.equal(out, semiring_matmul(a, b, s)):
            raise AssertionError(f"{what}: not bitwise equal to the dense "
                                 "kernel")
        exp = ref.sparse_semiring_matmul_ref(a, b, s)
        if s == "count":
            return _check_count_call(out, exp, a, b, what)[0]
        return _check_equal(out, exp, what)

    for i, (tag, a, b, s) in enumerate(recorded):
        max_err = max(max_err, check(a, b, s, f"sparse {s} on recorded "
                                     f"call {i} ({tag})"))
        n_cases += 1
    g = torch.Generator().manual_seed(1)

    def operands(shape_a, shape_b, semiring, density):
        x = [torch.rand(sh, generator=g) < density
             for sh in (shape_a, shape_b)]
        if semiring == "count":
            x = [v.float() * torch.randint(1, 4, v.shape, generator=g)
                 for v in x]
        elif semiring == "minplus":
            x = [torch.where(v, torch.randint(1, 9, v.shape, generator=g)
                             .float(), math.inf) for v in x]
        return [v.cuda() for v in x]

    cases = [((96, 96), (96, 96), 0.25, 32),       # tests/test_sparse.py
             ((33, 70), (70, 129), 0.3, 128),
             ((3, 33, 70), (70, 129), 0.3, 32),
             ((2, 65, 1100), (2, 1100, 67), 0.05, 64),
             ((130, 257), (257, 200), 0.02, 48), ((1, 1), (1, 1), 1.0, 128)]
    for sa, sb, dens, t in cases:
        for s in ("bool", "count", "minplus"):
            a, b = operands(sa, sb, s, dens)
            max_err = max(max_err, check(a, b, s, f"sparse {s} {sa}x{sb} "
                                         f"tile {t}", bm=t, bn=t, bk=t))
            n_cases += 1
    # Block-diagonal A: 7 of every 8 tile pairs are empty and skipped.
    for s in ("bool", "count", "minplus"):
        a, b = operands((1024, 1024), (1024, 1024), s, 0.5)
        zero = math.inf if s == "minplus" else 0
        blocks = torch.arange(1024, device="cuda") // 128
        a = torch.where(blocks[:, None] == blocks[None, :], a,
                        torch.tensor(zero, device="cuda").to(a.dtype))
        _, share = _sparse_bound(a, b, s, occupancy)
        if share > 0.5:
            raise AssertionError(f"block-diagonal operand: {share} of the "
                                 "tile pairs occupied")
        max_err = max(max_err, check(a, b, s, f"sparse {s} block-diagonal "
                                     f"(occupied share {share})"))
        n_cases += 1
    print(f"# phase (b): block-sparse kernel bitwise equal to the dense "
          f"kernel and the plain version on {n_cases} cases ("
          f"{len(recorded)} recorded calls; count products above 2^24 vs "
          "plain within rtol 4e-6 of float64), launches on its own path "
          f"{launches}", flush=True)

    groups = {"all": calls}
    for s in ("bool", "count", "minplus"):
        groups[s] = [c for c in calls if c[2] == s]
    per = {}
    for name, mine in groups.items():
        if not mine:
            continue
        # One reading: the whole call, and of it the occupancy pass (the
        # rest is the product, with the packing passes for bool).
        ms, occ_ms = _replay_split_ms(sparse_semiring_matmul, mine, 5,
                                      "occupancy")
        k2_ms, _ = _replay_ms(semiring_matmul, mine, 5)
        plain_ms, _ = _replay_ms(ref.sparse_semiring_matmul_ref, mine, 2)
        parts = [_sparse_bound(a, b, s, occupancy) for a, b, s in mine]
        bound, by = _sum_bound([p for p, _ in parts])
        lib = None
        if name == "count":
            lib, _ = _replay_ms(torch.matmul, [(a.float(), b.float())
                                               for a, b, _ in mine], 5)
        per[name] = dict(calls=len(mine), ms=ms, occupancy_ms=occ_ms,
                         product_ms=ms - occ_ms, dense_kernel_ms=k2_ms,
                         plain_ms=plain_ms, bound_ms=bound / len(mine),
                         bound_by=by, library_ms=lib,
                         occupied_share=sum(sh for _, sh in parts)
                         / len(parts))
        print(f"# sparse on {name} calls: " + json.dumps(per[name]),
              flush=True)
    top = per["all"]
    return dict(name="sparse", route="cuda",
                source="src/repro_torch/kernels/csrc/sparse.cu",
                replaces="src/repro/kernels/sparse.py:94", launches=launches,
                max_abs_err=max_err, ms=top["ms"], plain_ms=top["plain_ms"],
                bound_ms=top["bound_ms"], bound_by=top["bound_by"],
                library_ms=None,
                per_semiring={k: v for k, v in per.items() if k != "all"})


def cheung_matrix(adj, p, seed=0):
    """The E_dir x E_dir Cheung propagation matrix of a topology, formed
    as ``repro.core.diversity.GFConnectivity.build`` forms it: a random
    coefficient in [1, p) where head(a) == tail(b) and the step from link
    a to link b does not go straight back; int32."""
    u, v = np.nonzero(np.asarray(adj, dtype=bool))
    match = v[:, None] == u[None, :]
    match &= ~((u[:, None] == v[None, :]) & match)
    rng = np.random.default_rng(seed)
    k = np.zeros((len(u), len(u)), dtype=np.int32)
    k[match] = rng.integers(1, p, size=int(match.sum()))
    return k


def phase_gfmm(topology, ops, ref, gf_matmul, gf_plan, LAUNCHES,
               reset_launches):
    """(c) ``ops.gf_power_sum`` of the sf(q=11) Cheung matrix on the card,
    exact against the plain version; both modes on ragged shapes."""
    kmat = torch.from_numpy(cheung_matrix(
        topology.slim_fly(GF_TOPO_Q).adj, GF_P)).cuda()
    e = kmat.shape[0]
    reset_launches()
    m_k = ops.gf_power_sum(kmat, GF_LEN, p=GF_P)
    torch.cuda.synchronize()
    launches = LAUNCHES["gfmm"]
    _need_launches(LAUNCHES, ("gfmm",), "gf_power_sum", GF_LEN - 1)
    eye = torch.eye(e, dtype=torch.int32, device="cuda")
    m, calls = eye, []
    for _ in range(GF_LEN - 1):
        calls.append((m, kmat))
        m = (ref.gf_matmul_ref(m, kmat, GF_P) + eye) % GF_P
    _check_equal(m_k, m, f"gf_power_sum of the {e}x{e} Cheung matrix")
    for i, (x, y) in enumerate(calls):
        _check_equal(gf_matmul(x, y, p=GF_P), ref.gf_matmul_ref(x, y, GF_P),
                     f"GF({GF_P}) product {i} of gf_power_sum")
    g = torch.Generator().manual_seed(2)
    n_cases = 0
    ragged = ((1, 1, 1), (70, 1100, 33), (257, 64, 129), (1000, 333, 777))
    # p = 40009 (two limbs, bk = 1) over K = 20 000: past one reduction
    # chunk of the kernel (gf_plan's 16 512 entries).
    for mode, p, bk, shapes in (("int32", GF_P, 128, ragged),
                                ("f32", 251, 128, ragged),
                                ("int32", 40009, 1, ((33, 20000, 17),))):
        for mm, kk, nn in shapes:
            a = torch.randint(0, p, (mm, kk), generator=g,
                              dtype=torch.int32).cuda()
            b = torch.randint(0, p, (kk, nn), generator=g,
                              dtype=torch.int32).cuda()
            _check_equal(gf_matmul(a, b, p=p, mode=mode, bk=bk),
                         ref.gf_matmul_ref(a, b, p),
                         f"GF({p}) {mode} ({mm},{kk})x({kk},{nn})")
            n_cases += 1
    print(f"# phase (c): gf_power_sum(K, {GF_LEN}) of the sf(q={GF_TOPO_Q}) "
          f"Cheung matrix ({e}x{e}, {int((kmat != 0).sum())} nonzeros, "
          f"p={GF_P}) exact against the plain version, its "
          f"{len(calls)} products too; {n_cases} ragged cases in both modes "
          f"exact; launches on its own path {launches}", flush=True)

    ms, wall = _replay_ms(lambda x, y: gf_matmul(x, y, p=GF_P), calls, 3)
    plain_ms, _ = _replay_ms(lambda x, y: ref.gf_matmul_ref(x, y, GF_P),
                             calls, 2)
    f64 = [(x.double(), y.double()) for x, y in calls]
    f64_ms, _ = _replay_ms(lambda x, y: torch.remainder(x @ y, GF_P), f64, 3)
    # The kernel's route: limbs^2 products of 8-bit limbs on the int8
    # tensor cores, 2 E^3 operations each.
    limbs, chunk = gf_plan(GF_P, e)
    t_ops = limbs ** 2 * 2.0 * e ** 3 / INT8_OP_PER_S
    t_bytes = 3 * e * e * 4 / HBM_BYTES_PER_S
    bound = max(t_ops, t_bytes) * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"# GF(p) product {e}^2: device ms/call kernel {ms:.5f} (wall "
          f"{wall:.5f}), plain {plain_ms:.5f}, bound {bound:.5f} ({by}; "
          f"{limbs ** 2} int8 limb products, chunk {chunk}); for scale, "
          f"float64 torch.matmul + remainder {f64_ms:.5f} (exact while "
          f"k (p-1)^2 < 2^53)", flush=True)
    return dict(name="gfmm", route="cuda",
                source="src/repro_torch/kernels/csrc/gfmm.cu",
                replaces="src/repro/kernels/gfmm.py:53", launches=launches,
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=None, f64_matmul_ms=f64_ms,
                limbs=limbs, chunk=chunk)


def _attn_pairs(sq, sk, causal, window):
    """Unmasked (q, k) pairs of one head."""
    q = np.arange(sq)
    hi = np.minimum(sk - 1, q) if causal else np.full(sq, sk - 1)
    lo = np.maximum(0, q - window + 1) if window > 0 else np.zeros(sq, int)
    return int(np.maximum(0, hi - lo + 1).sum())


def _attn_close(out, exp, rtol, atol, what):
    """Raise unless |out - exp| <= rtol |exp| + atol everywhere; returns
    (max abs error, relative Frobenius error ||out - exp|| / ||exp||)."""
    out, exp = out.double(), exp.double()
    diff = (out - exp).abs()
    err = float(diff.max())
    rel = float(torch.linalg.vector_norm(out - exp)
                / torch.linalg.vector_norm(exp))
    if not bool((diff <= rtol * exp.abs() + atol).all()):
        raise AssertionError(f"{what}: not within rtol {rtol} / atol {atol} "
                             f"of the plain version (max abs err {err}, "
                             f"relative Frobenius err {rel})")
    return err, rel


def phase_flash(ops, ref, flash_attention, LAUNCHES, reset_launches):
    """(d) Attention at two full-width layouts in bf16 (the tensor-core
    kernel), held against the plain version two query heads at a time at
    bf16's rounding (rtol 1e-2, atol 1e-3: both round an f32 result, so
    they differ by about one bf16 ulp, 2^-7 of the value); the same
    layouts in f32 (the CUDA-core kernel) and ragged cases in both types,
    f32 at rtol = atol = 1e-4 and bf16 at bf16's rounding (the JAX
    package's own kernel tolerances, 5e-2 bf16 and 2e-3 f32, are looser
    than both).  Both kernels timed at both layouts."""
    g = torch.Generator(device="cuda").manual_seed(3)
    inputs = {}
    for name, lay in ATTN_LAYOUTS.items():
        shapes = ((1, lay["h"], lay["s"], lay["d"]),
                  (1, lay["hkv"], lay["s"], lay["d"]),
                  (1, lay["hkv"], lay["s"], lay["d"]))
        inputs[name] = [torch.randn(sh, generator=g, device="cuda")
                        .to(torch.bfloat16) for sh in shapes]
    kws = {name: dict(causal=lay["causal"], window=lay["window"],
                      softcap=lay["softcap"])
           for name, lay in ATTN_LAYOUTS.items()}
    reset_launches()
    outs = {name: ops.attention(*inputs[name], **kws[name])
            for name in ATTN_LAYOUTS}
    torch.cuda.synchronize()
    launches = LAUNCHES["flash_attention"]
    _need_launches(LAUNCHES, ("flash_attention",), "phase (d)",
                   len(ATTN_LAYOUTS))

    def plain_sliced(q, k, v, kw):
        """The plain version two query heads (and their KV head) at a
        time: heads are independent, and (1, 2, S, S) f32 logits fit."""
        group = q.shape[1] // k.shape[1]
        return torch.cat([ref.attention_ref(
            q[:, h0:h0 + 2], k[:, h0 // group:h0 // group + 1],
            v[:, h0 // group:h0 // group + 1], **kw)
            for h0 in range(0, q.shape[1], 2)], dim=1)

    err = {}
    for name in ATTN_LAYOUTS:
        x, kw = inputs[name], kws[name]
        err[f"{name} bf16"] = _attn_close(
            outs[name], plain_sliced(*x, kw), 1e-2, 1e-3,
            f"attention {name} bf16")
        x32 = [t.float() for t in x]
        err[f"{name} f32"] = _attn_close(
            flash_attention(*x32, **kw), plain_sliced(*x32, kw), 1e-4, 1e-4,
            f"attention {name} f32")
    # (b, h, hkv, sq, sk, d, causal, window, softcap)
    cases = [(1, 4, 2, 200, 200, 64, True, 0, 0.0),
             (2, 4, 1, 130, 130, 128, False, 0, 0.0),
             (1, 2, 2, 300, 300, 96, True, 50, 0.0),
             (1, 4, 2, 190, 190, 128, True, 64, 50.0),
             (1, 2, 1, 100, 77, 200, False, 0, 0.0),
             (1, 4, 2, 1000, 700, 128, True, 0, 0.0),
             (1, 2, 1, 150, 60, 32, True, 16, 0.0),     # rows 75.. dead
             (1, 8, 1, 300, 300, 256, True, 0, 30.0)]
    gc = torch.Generator(device="cuda").manual_seed(4)
    tol = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-3)}
    ragged = {dt: (0.0, 0.0) for dt in tol}
    for b, h, hkv, sq, sk, d, causal, window, softcap in cases:
        q = torch.randn((b, h, sq, d), generator=gc, device="cuda")
        k, v = (torch.randn((b, hkv, sk, d), generator=gc, device="cuda")
                for _ in range(2))
        kw = dict(causal=causal, window=window, softcap=softcap)
        for dt, (rtol, atol) in tol.items():
            x = [t.to(dt) for t in (q, k, v)]
            out = flash_attention(*x, **kw)
            e = _attn_close(out, ref.attention_ref(*x, **kw), rtol, atol,
                            f"attention {dt} {(b, h, hkv, sq, sk, d)} {kw}")
            ragged[dt] = tuple(map(max, ragged[dt], e))
            if causal and window and sq > sk + window - 1:
                if not bool((out[:, :, sk + window - 1:] == 0).all()):
                    raise AssertionError(f"{dt}: fully masked rows are "
                                         "not 0")
    err["f32 ragged"] = ragged[torch.float32]
    err["bf16 ragged"] = ragged[torch.bfloat16]
    print(f"# phase (d): attention at {list(ATTN_LAYOUTS)} against the "
          "plain version, two heads at a time, in bf16 (rtol 1e-2, atol "
          "1e-3; the JAX package's limit is 5e-2) and in f32 (rtol = atol "
          f"= 1e-4), and {len(cases)} ragged cases in both (f32 1e-4, the "
          "JAX package's limit being 2e-3; bf16 as above); (max abs err, "
          "relative Frobenius err) " + json.dumps(err) + "; fully masked "
          f"rows 0; launches on its own path {launches}", flush=True)

    per = {}
    for name, lay in ATTN_LAYOUTS.items():
        q, k, v = inputs[name]
        kw = kws[name]
        ms, wall = _replay_ms(lambda *x: ops.attention(*x, **kw),
                              [(q, k, v)], 2)
        x32 = [t.float() for t in (q, k, v)]
        f32_ms, _ = _replay_ms(lambda *x: flash_attention(*x, **kw),
                               [tuple(x32)], 2)
        del x32
        plain_ms, _ = _replay_ms(plain_sliced, [(q, k, v, kw)], 1)
        lib = lib32 = None
        if lay["softcap"] == 0 and lay["window"] == 0:
            def sdpa(*x):
                return torch.nn.functional.scaled_dot_product_attention(
                    *x, is_causal=lay["causal"], enable_gqa=True)
            lib, _ = _replay_ms(sdpa, [(q, k, v)], 2)
            x32 = [t.float() for t in (q, k, v)]
            lib32, _ = _replay_ms(sdpa, [tuple(x32)], 2)
            del x32
        pairs = _attn_pairs(lay["s"], lay["s"], lay["causal"], lay["window"])
        t_ops = 4.0 * lay["h"] * lay["d"] * pairs / BF16_FLOP_PER_S
        t_bytes = sum(x.numel() * 2 for x in (q, k, v, q)) / HBM_BYTES_PER_S
        t_ops32 = 4.0 * lay["h"] * lay["d"] * pairs / F32_FLOP_PER_S
        per[name] = dict(ms=ms, wall_ms=wall, f32_ms=f32_ms,
                         f32_bound_ms=max(t_ops32, 2 * t_bytes) * 1e3,
                         plain_ms=plain_ms,
                         bound_ms=max(t_ops, t_bytes) * 1e3,
                         bound_by="operations" if t_ops >= t_bytes
                         else "bytes", library_ms=lib,
                         library_f32_ms=lib32,
                         unmasked_pairs_per_head=pairs)
        print(f"# attention {name}: " + json.dumps(per[name]), flush=True)
    # The entry's times are yi-9b's in bf16, the layout that one PyTorch
    # call (scaled_dot_product_attention) also computes; both layouts and
    # both kernels are in per_layout.
    top = per["yi-9b"]
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:96",
                launches=launches,
                max_abs_err=max(e for e, _ in err.values()),
                ms=top["ms"], plain_ms=top["plain_ms"],
                bound_ms=top["bound_ms"], bound_by=top["bound_by"],
                library_ms=top["library_ms"], entry_layout="yi-9b bf16",
                per_layout=per)


def phase_small_cell(Session, transport):
    sessions = {d: Session(device=d) for d in ("cuda", "cpu")}
    for routing in ("ecmp", "fatpaths(n_layers=9,rho=0.6)", KSP_ROUTING):
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
        for name in ("path_edges", "routed", "usable", "plan_offsets",
                     "plan_entries"):
            if not torch.equal(prepared["cuda"][name].cpu(),
                               prepared["cpu"][name]):
                raise AssertionError(f"{routing}: {name} differs card vs CPU")
        dep_g = res["cuda"][1].depart_step
        dep_c = res["cpu"][1].depart_step
        if not np.array_equal(dep_g, dep_c):
            raise AssertionError(f"{routing}: depart_step differs card vs "
                                 f"CPU for {int((dep_g != dep_c).sum())} "
                                 "flows")
        if res["cuda"][0].metrics != res["cpu"][0].metrics:
            raise AssertionError(f"{routing}: metrics differ card vs CPU: "
                                 f"{res['cuda'][0].metrics} vs "
                                 f"{res['cpu'][0].metrics}")
        print(f"# phase 4: sf(q=5) {routing}: tables, path edges, "
              "depart_step and metrics equal card vs CPU", flush=True)


def _profile(fn, top_n: int = 6):
    """One ``fn()`` under ``torch.profiler``: the summed self time of its
    device-side events (kernels, copies, memsets) in ms, their count, and
    the ``top_n`` of them by device time.

    On the H100 machines the profiler can lose the first device events of
    a trace: one to a few of them, and once a process has run a while,
    whole multi-ms kernels (every event of a short trace).  So each trace
    opens with ``lead`` spin kernels of about 2 ms and a synchronize, and
    a reading counts only when the trace holds a device event for every
    launch, memset and copy call of ``fn`` (the trace's calls, less the
    spin kernels); otherwise ``lead`` doubles and the reading is taken
    again.  Each trace starts at the lead the last good reading needed
    (8 at first).  The spin kernels are left out of the sums."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    lead = PROFILE_LEAD[0]
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(lead):
                torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        events = prof.events()
        calls = sum(1 for e in events if e.device_type == DeviceType.CPU
                    and any(w in e.name for w in DEVICE_WORK_CALLS))
        n_dev = sum(1 for e in events if e.device_type == DeviceType.CUDA
                    and "spin_kernel" not in e.name)
        PROFILE_LEAD_LOST.append(lead - sum(
            1 for e in events if e.device_type == DeviceType.CUDA
            and "spin_kernel" in e.name))
        if n_dev == calls - lead:
            PROFILE_LEAD[0] = lead
            break
        PROFILE_RETRIES.append((lead, calls - lead - n_dev))
        lead *= 2
    else:
        raise AssertionError("the profiler kept losing device events: "
                             f"{PROFILE_RETRIES[-5:]} (lead, lost)")
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.key]
    total = sum(dev_us(e) for e in dev)
    ranked = sorted(dev, key=dev_us, reverse=True)[:top_n]
    return (total / 1e3, n_dev,
            [[e.key[:60], dev_us(e) / 1e3, e.count] for e in ranked])


def _scan_reading(ses, transport, prng, routing, pattern, n_steps,
                  profile_steps, cfg_kw=None, topo=MAIN_TOPO):
    """The scan of one cell alone, again: host wall around a synchronize,
    steps run and µs per step; then ``torch.profiler`` over the first
    ``profile_steps`` steps with the adaptive horizon off, or with
    ``profile_steps=None`` over the same run again (device time, idle
    share, device events per step, and the water-filling kernel's device
    time per call).  ``cfg_kw`` holds further ``SimConfig`` fields (ndp
    by default); ``topo`` is the cell's topology (sf(q=19) by default)."""
    cell = ses.resolve(ses.grid([topo], [routing], [pattern])[0])
    cfg = transport.SimConfig(balancing=cell.bundle.balancing,
                              n_steps=n_steps,
                              **{"transport": "ndp", **(cfg_kw or {})})
    arrs, static = transport.prepare(cell.topo, cell.bundle.routing,
                                     cell.workload, cfg, device="cuda")
    return _arrs_reading(transport, arrs, prng.PRNGKey(0, "cuda"), cfg,
                         static, profile_steps)


def _arrs_reading(transport, arrs, key, cfg, static, profile_steps,
                  n_real=None):
    """:func:`_scan_reading` of prepared scan operands: one cell's with
    one key, or a union's with a key stack and its ``n_real`` (steps run:
    its longest element horizon and the tail)."""
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    final = transport._run_scan(arrs, key, cfg, static, n_real=n_real)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t1
    steps = _steps_run(final, cfg)
    if profile_steps is None:
        profile_steps, pcfg, pstatic = steps, cfg, static
    else:
        pcfg = dataclasses.replace(cfg, n_steps=profile_steps,
                                   adaptive_horizon=False)
        pstatic = (static[0], static[1], profile_steps)
    device_ms, n_dev, top = _profile(
        lambda: transport._run_scan(arrs, key, pcfg, pstatic, n_real=n_real),
        top_n=10 ** 6)
    wf = [(ms, n) for name, ms, n in top if "waterfill" in name]
    # Idle share against the unprofiled wall of as many steps: the
    # profiler's own host cost would inflate a profiled wall.
    window_s = scan_s / steps * profile_steps
    return dict(scan_s=scan_s, steps=steps, us_per_step=scan_s / steps * 1e6,
                profile_steps=profile_steps, scan_device_ms=device_ms,
                scan_idle_share=1.0 - device_ms / 1e3 / window_s,
                scan_device_events_per_step=n_dev / profile_steps,
                scan_top_kernels_ms=top[:6],
                waterfill_calls=sum(n for _, n in wf),
                waterfill_ms_per_call=(sum(ms for ms, _ in wf)
                                       / max(1, sum(n for _, n in wf))),
                e_tot=static[0],
                hop_slots=arrs["path_edges"].shape[2],
                plan_entries=arrs["plan_entries"].numel(),
                plan_max_segment=int((arrs["plan_offsets"][1:]
                                      - arrs["plan_offsets"][:-1]).max()))


def _steps_run(final, cfg):
    """Steps a scan ran: its (longest) horizon's chunks and the tail."""
    return int(np.max(final["horizon_chunks"])) * cfg.horizon_chunk \
        + cfg.n_steps % cfg.horizon_chunk


def _timed_scans(scans):
    """Wrap ``_run_scan``: each call's balancing, synchronized wall and
    steps run go to ``scans``."""
    def wrap(fn):
        def rec(arrs, key0, cfg, static, n_real=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            final = fn(arrs, key0, cfg, static, n_real=n_real)
            torch.cuda.synchronize()
            scans.append((cfg.balancing, time.perf_counter() - t0,
                          _steps_run(final, cfg)))
            return final
        return rec
    return wrap


def _sims_recorder(sims):
    """Wrap ``simulate_seeds`` so that each call's SimResults are kept."""
    def wrap(fn):
        def rec(*args, **kw):
            sims.append(fn(*args, **kw))
            return sims[-1]
        return rec
    return wrap


def phase_main(Session, transport, catalog, prng, LAUNCHES, reset_launches):
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
    card_sims, cpu_sims = [], []
    t0 = time.perf_counter()
    with _patched(catalog, "simulate_seeds", _sims_recorder(card_sims)):
        results = ses.sweep([MAIN_TOPO], list(MAIN_ROUTINGS),
                            [MAIN_PATTERN], [MAIN_EVAL], callback=count_cell)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for name in ("semiring", "waterfill"):
        if launches[name] <= 0:
            raise AssertionError(f"main path never launched the {name} "
                                 "kernel")
    # The same sweep on the CPU port: the card must give the same bits.
    t1 = time.perf_counter()
    with _patched(catalog, "simulate_seeds", _sims_recorder(cpu_sims)):
        cpu_results = Session(device="cpu").sweep(
            [MAIN_TOPO], list(MAIN_ROUTINGS), [MAIN_PATTERN], [MAIN_EVAL])
    cpu_wall = time.perf_counter() - t1
    for rr, rc, sg, sc in zip(results, cpu_results, card_sims, cpu_sims):
        if rr.metrics != rc.metrics:
            raise AssertionError(f"{rr.cell_id}: metrics differ card vs "
                                 f"CPU: {rr.metrics} vs {rc.metrics}")
        for g, c in zip(sg, sc):
            if not np.array_equal(g.depart_step, c.depart_step):
                raise AssertionError(f"{rr.cell_id}: depart_step differs "
                                     "card vs CPU")
    digests = [hashlib.sha256(sims[0].depart_step.tobytes()).hexdigest()[:16]
               for sims in card_sims]
    print(f"# phase 5: both main cells' metrics and depart_step equal card "
          f"vs CPU (CPU sweep {cpu_wall:.2f} s; depart_step sha256 "
          f"{digests}; host metrics by numpy {np.__version__})", flush=True)
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
    return launches, ses, results, card_sims


_SIM_LANES = ("depart_step", "delivered", "retrans_bytes", "goodput_steps",
              "stalled_steps")


def _cpu_port_cells():
    """The cells that phases 6-9 hold card vs CPU port, in the order the
    phases reach them: (topo, routing, pattern, evaluator, path engine,
    whether the CPU port's stack tables and failure report come back)."""
    return [(MAIN_TOPO, PIMIN_ROUTING, MAIN_PATTERN, MAIN_EVAL, "dense",
             True),
            *[(MAIN_TOPO, DYN_ROUTING, p, e, "dense", False)
              for p, e, _ in DYN_CELLS],
            *[(MAIN_TOPO, _static_routing(p, m), MAIN_PATTERN, MAIN_EVAL,
               "dense", True) for p, m in STATIC_DAMAGE],
            *[(MAIN_TOPO, r, RECOVERY_PATTERN, RECOVERY_EVAL, "dense", False)
              for r in RECOVERY_ROUTINGS],
            (MAIN_TOPO, CHURN_ROUTING, RECOVERY_PATTERN, AVAIL_EVAL, "dense",
             False),
            (MAIN_TOPO, DYN_ROUTING, MAIN_PATTERN, DEGRADE_EVAL, "dense",
             False),
            *[(PAPER_TOPO, r, MAIN_PATTERN, MAIN_EVAL, "auto", False)
              for r in (DYN_ROUTING, "ecmp")]]


def _cpu_port_init():
    """The worker process: no card, CPU_PORT_THREADS threads, and a
    lower priority than the card's process, whose host-bound phases it
    shares the cores with."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    torch.set_num_threads(CPU_PORT_THREADS)
    os.nice(10)


def _cpu_port_run(topo, routing, pattern, evaluator, engine, stack):
    """In the worker: one cell in a new ``Session(device="cpu")`` under
    path engine ``engine``.  Returns its RunResult, the SimResults of
    each simulation call, the stack's ``_TABLES`` and failure report
    (when ``stack``, else None) and the run's wall seconds."""
    from repro_torch.experiments import Session, catalog
    os.environ["REPRO_PATH_ENGINE"] = engine
    sims = []
    t0 = time.perf_counter()
    ses = Session(device="cpu")
    with _patched(catalog, "simulate_seeds", _sims_recorder(sims)):
        rc = ses.run(topo, routing, pattern, evaluator)
    cpu_s = time.perf_counter() - t0
    tables = None
    if stack:
        b = ses.routing(topo, routing)
        tables = dict(failure_meta=b.failure_meta,
                      **{n: getattr(b.routing, n) for n in _TABLES})
    return rc, sims, tables, cpu_s


def _start_cpu_port():
    """Start one worker process (spawned: the card stays this process's)
    and queue on it the CPU port's runs of ``_cpu_port_cells``, so that
    they run beside phases 1-9 on the card; ``_card_and_cpu`` takes each
    result as its phase reaches it.  The caller terminates the pool."""
    import multiprocessing
    pool = multiprocessing.get_context("spawn").Pool(
        1, initializer=_cpu_port_init)
    for cell in _cpu_port_cells():
        CPU_PORT[cell[:4]] = (cell[4], pool.apply_async(_cpu_port_run, cell))
    return pool


def _card_and_cpu(Session, catalog, routing, pattern, evaluator, LAUNCHES,
                  reset_launches, card_ctx=contextlib.nullcontext,
                  topo=MAIN_TOPO, need=("semiring", "waterfill")):
    """One ``topo`` cell (sf(q=19) by default) in a new session on the
    card, with the launch counts set to 0 just before and read just
    after, then held against the CPU port's run of the same cell under
    the same path engine (from the worker, see :func:`_start_cpu_port`):
    its metrics and meta equal (``compare_results`` at rtol 0, NaN
    equal to NaN), and every simulation's ``depart_step``, ``delivered``
    and, where the cell has them, ``retrans_bytes`` and the per-step
    ``goodput_steps`` and ``stalled_steps``, bitwise.  ``card_ctx()`` is
    entered around the card's run only; each kernel of ``need`` must have
    been launched.  Returns (card session, the CPU port's stack tables
    and failure report or None, card RunResult, card SimResults of the
    first simulation call, launches, CPU-port wall s)."""
    card = []
    ses = Session(device="cuda")
    torch.cuda.synchronize()
    reset_launches()
    with _patched(catalog, "simulate_seeds", _sims_recorder(card)), \
            card_ctx():
        rr = ses.run(topo, routing, pattern, evaluator)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    _need_launches(launches, need, rr.cell_id)
    engine, pending = CPU_PORT.pop((topo, routing, pattern, evaluator))
    if engine != os.environ["REPRO_PATH_ENGINE"]:
        raise AssertionError(f"{rr.cell_id}: the CPU port ran under "
                             f"{engine}, the card under "
                             f"{os.environ['REPRO_PATH_ENGINE']}")
    t0 = time.perf_counter()
    rc, cpu, tables, cpu_s = pending.get()
    CPU_PORT_WAIT.append(time.perf_counter() - t0)
    CPU_PORT_WALL.append(cpu_s)
    _same_runs([rr], [rc], card, cpu, f"{rr.cell_id} card vs CPU")
    return ses, tables, rr, card[0], launches, cpu_s


def _same_runs(results_a, results_b, sims_a, sims_b, what):
    """Raise unless two runs of the same cells agree: RunResults by
    ``compare_results`` at rtol 0 (meta apart from timings), and every
    simulation's ``_SIM_LANES`` bitwise."""
    from repro_torch.experiments.results import compare_results
    diffs = compare_results(results_a, results_b, rtol=0.0)
    if diffs:
        raise AssertionError(f"{what}: {diffs[:4]}")
    if len(sims_a) != len(sims_b):
        raise AssertionError(f"{what}: {len(sims_a)} simulations against "
                             f"{len(sims_b)}")
    for run_a, run_b in zip(sims_a, sims_b):
        for a_sim, b_sim in zip(run_a, run_b):
            for name in _SIM_LANES:
                a, b = getattr(a_sim, name), getattr(b_sim, name)
                if (a is None) != (b is None) or (
                        a is not None and a.tobytes() != b.tobytes()):
                    raise AssertionError(f"{what}: {name} differs in "
                                         f"{results_a[0].cell_id}")


def _bool_calls_entry(ref, semiring_matmul, calls, launches, what):
    """K2 bool on one path's recorded products: each bitwise its plain
    version, then timed beside it and ``torch.matmul`` of f32 copies."""
    max_err = max(_check_equal(semiring_matmul(*c),
                               ref.semiring_matmul_ref(*c),
                               f"semiring bool {what} call {i}")
                  for i, c in enumerate(calls))
    ms, wall = _replay_ms(semiring_matmul, calls, 20)
    plain_ms, _ = _replay_ms(ref.semiring_matmul_ref, calls, 5)
    lib, _ = _replay_ms(torch.matmul, [(a.float(), b.float())
                                       for a, b, _ in calls], 20)
    bound, by = _sum_bound([_mm_bound(*c) for c in calls])
    return dict(calls=len(calls), launches=launches, ms=ms, wall_ms=wall,
                plain_ms=plain_ms, bound_ms=bound / len(calls), bound_by=by,
                library_ms=lib, max_abs_err=max_err,
                shapes=sorted({(tuple(a.shape), tuple(b.shape))
                               for a, b, _ in calls}))


def phase_pimin(Session, catalog, paths, transport, prng, ref,
                semiring_matmul, LAUNCHES, reset_launches, k2):
    """6. The pi_min cell at sf(q=19) on the card and on the CPU port:
    tables bitwise, ``depart_step`` and metrics equal; the card's stack
    loop-free on every entry; K2 bool held against its plain version on
    the build's own calls and timed there beside the main sweep's."""
    calls = []
    ses, cpu_stack, rr, _, launches, cpu_s = _card_and_cpu(
        Session, catalog, PIMIN_ROUTING, MAIN_PATTERN, MAIN_EVAL, LAUNCHES,
        reset_launches, lambda: _recording([paths], calls, "pi_min"))
    if launches["semiring"] != len(calls) or \
            {c[3] for c in calls} != {"bool"}:
        raise AssertionError(f"the pi_min cell launched the semiring kernel "
                             f"{launches['semiring']} times for "
                             f"{len(calls)} recorded calls")
    lr_g = ses.routing(MAIN_TOPO, PIMIN_ROUTING).routing
    for name in _TABLES:
        if not torch.equal(getattr(lr_g, name).cpu(), cpu_stack[name]):
            raise AssertionError(f"pi_min {name} differs card vs CPU")
    report = lr_g.validate_loop_free(n_samples=10 ** 9)
    k2["per_semiring"]["bool"]["pi_min_build"] = _bool_calls_entry(
        ref, semiring_matmul, [(a, b, s) for _, a, b, s in calls],
        launches["semiring"], "pi_min build")
    info = dict(cell=rr.cell_id, metrics=rr.metrics,
                build_s=rr.meta["build_s"], cell_wall_s=rr.wall_s,
                cpu_port_wall_s=cpu_s, launches=launches,
                loop_check=report.describe(),
                **_scan_reading(ses, transport, prng, PIMIN_ROUTING,
                                MAIN_PATTERN, 2000, 80))
    print("# phase 6: pi_min tables (layer_adj, nh, reach, pathlen) bitwise, "
          "depart_step and metrics equal card vs CPU port; "
          + json.dumps(info), flush=True)
    print("# phase 6: semiring bool on the pi_min build's calls: "
          + json.dumps(k2["per_semiring"]["bool"]["pi_min_build"])
          + "; on the main sweep's 7 calls "
          f"{k2['per_semiring']['bool']['ms']:.5f} ms a call", flush=True)
    return launches


def phase_dynamic(Session, catalog, transport, prng, LAUNCHES,
                  reset_launches, k1):
    """7. Dynamic traffic at sf(q=19): the DYN_CELLS on the card and on
    the CPU port (metrics and ``depart_step`` equal); then the full
    ``load(level=0.5)`` cell on the card alone: no flow departs before it
    arrives, finite metrics, and its scan's readings."""
    path_launches = {}
    for pattern, evaluator, profile_steps in DYN_CELLS:
        ses, _, rr, _, launches, cpu_s = _card_and_cpu(
            Session, catalog, DYN_ROUTING, pattern, evaluator, LAUNCHES,
            reset_launches)
        path_launches[rr.cell_id] = launches
        info = dict(cell=rr.cell_id, metrics=rr.metrics,
                    n_flows=rr.meta["n_flows"],
                    offered_gbs=rr.meta["offered_gbs"],
                    build_s=rr.meta["build_s"], cell_wall_s=rr.wall_s,
                    cpu_port_wall_s=cpu_s, launches=launches,
                    **_scan_reading(ses, transport, prng, DYN_ROUTING,
                                    pattern, 2000, profile_steps))
        print("# phase 7: depart_step and metrics equal card vs CPU port; "
              + json.dumps(info), flush=True)

    sims = []
    ses = Session(device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with _patched(catalog, "simulate_seeds", _sims_recorder(sims)):
        rr = ses.run(MAIN_TOPO, DYN_ROUTING, FULL_LOAD, MAIN_EVAL)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    _need_launches(launches, ("semiring", "waterfill"), rr.cell_id)
    path_launches[rr.cell_id] = launches
    sim = sims[0][0]
    active_at = ses.workload(MAIN_TOPO, FULL_LOAD).active_step
    dep = sim.depart_step
    done = dep >= 0
    if not (done.any() and (dep[done] >= active_at[done]).all()):
        raise AssertionError(f"{rr.cell_id}: a flow departed before it "
                             "arrived, or none departed")
    if not all(math.isfinite(v) for v in rr.metrics.values()):
        raise AssertionError(f"{rr.cell_id}: metrics {rr.metrics}")
    reading = _scan_reading(ses, transport, prng, DYN_ROUTING, FULL_LOAD,
                            2000, None)
    info = dict(cell=rr.cell_id, metrics=rr.metrics,
                n_flows=rr.meta["n_flows"], offered_gbs=rr.meta["offered_gbs"],
                build_s=rr.meta["build_s"], cell_wall_s=rr.wall_s,
                launches=launches, peak_device_mib=peak / 2 ** 20, **reading)
    print("# phase 7 (card only): every finished flow departs at or after "
          "its activation step, metrics finite; " + json.dumps(info),
          flush=True)
    k1["per_path"] = {"full load cell": dict(
        calls=reading["waterfill_calls"], ms=reading["waterfill_ms_per_call"],
        bound_ms=_wf_bound_s(rr.meta["n_flows"], reading["hop_slots"],
                             reading["e_tot"]) * 1e3, bound_by="bytes",
        n_flows=rr.meta["n_flows"], plan_entries=reading["plan_entries"],
        plan_max_segment=reading["plan_max_segment"])}
    return path_launches


def _static_routing(pattern, mode):
    return (f"failures(of={DYN_ROUTING},rate={FAULT_RATE},pattern={pattern},"
            f"mode={mode})")


def _recovery_k1(ses, transport, prng, ref, waterfill_step, routing):
    """K1 on the recovery cell's own calls (400 steps of the dctcp scan
    with ``util``, dead links from step 40 on): a sample held bitwise
    against the plain version with ``util`` on and off, and all of them
    timed both ways."""
    cell = ses.resolve(ses.grid([MAIN_TOPO], [routing],
                                [RECOVERY_PATTERN])[0])
    cfg = transport.SimConfig(balancing=cell.bundle.balancing,
                              transport="dctcp", recovery="on", record=1,
                              n_steps=400, adaptive_horizon=False)
    arrs, static = transport.prepare(cell.topo, cell.bundle.routing,
                                     cell.workload, cfg, device="cuda")
    calls = []

    def rec(fn):
        def wrap(edges, w, desired, cap, **kw):
            calls.append(((edges, w, desired, cap), kw))
            return fn(edges, w, desired, cap, **kw)
        return wrap

    with _patched(transport, "waterfill_step", rec):
        transport._run_scan(arrs, prng.PRNGKey(0, "cuda"), cfg, static)
    torch.cuda.synchronize()
    if not all(kw["want_util"] for _, kw in calls):
        raise AssertionError("the dctcp recovery scan called K1 without util")
    dead = [int((args[3] == 0).sum()) for args, _ in calls]
    if dead[39] != 0 or dead[40] == 0:
        raise AssertionError(f"dead links before/at step 40: {dead[39:41]}")
    max_err = 0.0
    for i in (0, 39, 40, 41, 200, len(calls) - 1):
        args, kw = calls[i]
        for wu in (True, False):
            max_err = max(max_err, _wf_check(
                ref, waterfill_step, args, dict(kw, want_util=wu),
                f"recovery-cell call {i}"))

    def kernel(args, kw):
        return waterfill_step(*args, **kw)

    on_ms, on_wall = _replay_ms(kernel, calls, 3)
    off_ms, off_wall = _replay_ms(
        kernel, [(a, dict(kw, want_util=False)) for a, kw in calls], 3)
    edges, _, _, cap = calls[0][0]
    return dict(calls=len(calls), ms=on_ms, wall_ms=on_wall,
                ms_without_util=off_ms, wall_ms_without_util=off_wall,
                bound_ms=_wf_bound_s(*edges.shape, cap.shape[0], util=True)
                * 1e3, bound_by="bytes", n_flows=edges.shape[0],
                dead_links=dead[-1], max_abs_err=max_err)


def phase_faults(Session, catalog, failures, paths, transport, prng, ref,
                 semiring_matmul, waterfill_step, LAUNCHES, reset_launches,
                 k1, k2):
    """8. Faults at sf(q=19), each cell on the card (launch counts 0
    before, read after) and on the CPU port, held equal by
    :func:`_card_and_cpu`: the static-damage cells (degraded
    tables bitwise, the same report, the card's stack loop-free, K2 bool
    on the repair build's products), the mid-run death cells under dctcp
    recovery (the fatpaths one profiled over RECOVERY_PROFILE_STEPS, K1
    timed on its calls with and
    without ``util``), the churn cell under the availability evaluator,
    and the degradation ladder."""
    path_launches = {}
    for pattern, mode in STATIC_DAMAGE:
        routing = _static_routing(pattern, mode)
        calls, marks = [], []

        def mark(fn):
            def rec(*a, **kw):
                marks.append(len(calls))
                out = fn(*a, **kw)
                marks.append(len(calls))
                return out
            return rec

        @contextlib.contextmanager
        def card_ctx():
            with _recording([paths], calls, routing), \
                    _patched(failures, "apply_failures", mark):
                yield

        ses, cpu_stack, rr, _, launches, cpu_s = _card_and_cpu(
            Session, catalog, routing, MAIN_PATTERN, MAIN_EVAL, LAUNCHES,
            reset_launches, card_ctx)
        path_launches[rr.cell_id] = launches
        if launches["semiring"] != len(calls) or len(marks) != 2 or \
                {c[3] for c in calls} != {"bool"}:
            raise AssertionError(f"{rr.cell_id}: {launches['semiring']} "
                                 f"semiring launches for {len(calls)} "
                                 "recorded calls")
        b_g = ses.routing(MAIN_TOPO, routing)
        for name in _TABLES:
            if not torch.equal(getattr(b_g.routing, name).cpu(),
                               cpu_stack[name]):
                raise AssertionError(f"{rr.cell_id}: {name} differs card vs "
                                     "CPU")
        if b_g.failure_meta != cpu_stack["failure_meta"] or \
                not b_g.failure_meta["failed_links"] > 0:
            raise AssertionError(f"{rr.cell_id}: reports {b_g.failure_meta} "
                                 f"vs {cpu_stack['failure_meta']}")
        report = b_g.routing.validate_loop_free(n_samples=10 ** 9)
        info = dict(cell=rr.cell_id, metrics=rr.metrics,
                    failure=b_g.failure_meta, build_s=rr.meta["build_s"],
                    cell_wall_s=rr.wall_s, cpu_port_wall_s=cpu_s,
                    launches=launches, loop_check=report.describe(),
                    rebuild_launches=marks[1] - marks[0])
        repair = [(a, b, s) for _, a, b, s in calls[marks[0]:marks[1]]]
        if mode == "repair":
            entry = _bool_calls_entry(ref, semiring_matmul, repair,
                                      len(repair), f"{pattern} repair build")
            k2["per_semiring"]["bool"][f"repair_build_{pattern}"] = entry
            info["semiring_bool_repair_build"] = entry
        elif repair:
            raise AssertionError(f"{rr.cell_id}: the drop mode made "
                                 f"{len(repair)} semiring products")
        print("# phase 8: degraded tables (layer_adj, nh, reach, pathlen) "
              "bitwise, reports, depart_step and metrics equal card vs CPU "
              "port; main stack's K2 bool "
              f"{k2['per_semiring']['bool']['ms']:.5f} ms a call; "
              + json.dumps(info), flush=True)

    for routing in RECOVERY_ROUTINGS:
        ses, _, rr, _, launches, cpu_s = _card_and_cpu(
            Session, catalog, routing, RECOVERY_PATTERN, RECOVERY_EVAL,
            LAUNCHES, reset_launches)
        path_launches[rr.cell_id] = launches
        info = dict(cell=rr.cell_id, metrics=rr.metrics,
                    build_s=rr.meta["build_s"], cell_wall_s=rr.wall_s,
                    cpu_port_wall_s=cpu_s, launches=launches)
        if routing == RECOVERY_ROUTINGS[0]:
            info.update(_scan_reading(
                ses, transport, prng, routing, RECOVERY_PATTERN, 400,
                RECOVERY_PROFILE_STEPS,
                dict(transport="dctcp", recovery="on", record=1,
                     adaptive_horizon=False)))
            k1.setdefault("per_path", {})["recovery cell"] = _recovery_k1(
                ses, transport, prng, ref, waterfill_step, routing)
            info["waterfill_recovery_cell"] = k1["per_path"]["recovery cell"]
        print("# phase 8: goodput and stalled curves, retrans_bytes, "
              "depart_step and metrics equal card vs CPU port; "
              + json.dumps(info), flush=True)

    for routing, pattern, evaluator in ((CHURN_ROUTING, RECOVERY_PATTERN,
                                         AVAIL_EVAL),
                                        (DYN_ROUTING, MAIN_PATTERN,
                                         DEGRADE_EVAL)):
        _, _, rr, _, launches, cpu_s = _card_and_cpu(
            Session, catalog, routing, pattern, evaluator, LAUNCHES,
            reset_launches)
        path_launches[rr.cell_id] = launches
        info = dict(cell=rr.cell_id, metrics=rr.metrics,
                    build_s=rr.meta["build_s"], cell_wall_s=rr.wall_s,
                    cpu_port_wall_s=cpu_s, launches=launches,
                    **{k: rr.meta[k] for k in ("churn_links", "churn_events",
                                               "churn_first_down")
                       if k in rr.meta})
        print("# phase 8: curves, depart_step and metrics equal card vs CPU "
              "port; " + json.dumps(info), flush=True)
    return path_launches


@contextlib.contextmanager
def _engine(name):
    """``REPRO_PATH_ENGINE`` set to ``name`` for the block."""
    old = os.environ.get("REPRO_PATH_ENGINE")
    os.environ["REPRO_PATH_ENGINE"] = name
    try:
        yield
    finally:
        if old is None:
            del os.environ["REPRO_PATH_ENGINE"]
        else:
            os.environ["REPRO_PATH_ENGINE"] = old


_TABLES = ("layer_adj", "nh", "reach", "pathlen")


def _same_stack(a, b, what):
    """Raise unless two stacks' tables are bitwise equal."""
    for name in _TABLES:
        if not torch.equal(getattr(a, name).cpu(), getattr(b, name).cpu()):
            raise AssertionError(f"{what}: {name} differs")


def _compressed_info(lr, what):
    """The blocked stack's compressed tables: present, exactly its dense
    ``nh``, and their size beside it."""
    ct = lr.compressed
    if ct is None or not torch.equal(ct.dense(), lr.nh):
        raise AssertionError(f"{what}: compressed tables missing or not "
                             "its dense nh")
    return dict(block=ct.block, k=int(ct.nh_sets.shape[-1]),
                nbytes=ct.nbytes,
                dense_nh_bytes=lr.nh.numel() * lr.nh.element_size())


def _build_peak(build):
    """``build()`` with the device's peak memory reset before: (result,
    MiB allocated above what was allocated before)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = build()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def phase_blocked_main(Session, catalog, layers, transport, LAUNCHES,
                       reset_launches, dense_ses, dense_results, dense_sims):
    """9.1 The sf(q=19) main sweep under ``auto`` (blocked tables and
    compressed tables from 512 routers up) in a new session: RunResults
    and every ``depart_step`` equal to phase 5's dense run, the stacks
    bitwise the dense ones, the compressed tables their ``nh``; then each
    engine's build split over BUILD_REPEATS builds."""
    sims = []
    with _engine("auto"):
        ses = Session(device="cuda")
        torch.cuda.synchronize()
        reset_launches()
        with _patched(catalog, "simulate_seeds", _sims_recorder(sims)):
            results = ses.sweep([MAIN_TOPO], list(MAIN_ROUTINGS),
                                [MAIN_PATTERN], [MAIN_EVAL])
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        blocked = {r: ses.routing(MAIN_TOPO, r).routing
                   for r in MAIN_ROUTINGS}
    _need_launches(launches, ("waterfill",), "the blocked sf(q=19) sweep")
    if launches["semiring"]:
        raise AssertionError("the blocked engine made semiring products")
    _same_runs(dense_results, results, dense_sims, sims,
               "sf(q=19) blocked vs dense")
    info = {}
    with _engine("dense"):
        for r in MAIN_ROUTINGS:
            dense = dense_ses.routing(MAIN_TOPO, r).routing
            _same_stack(blocked[r], dense, f"sf(q=19) {r} blocked vs dense")
            if dense.compressed is not None:
                raise AssertionError("the dense engine attached compressed "
                                     "tables")
            info[r] = _compressed_info(blocked[r], r)
    topo = ses.topology(MAIN_TOPO)
    builds = {}
    for eng in ("dense", "blocked"):
        with _engine(eng):
            for r in MAIN_ROUTINGS:
                stats = [(layers.build_layers(topo, 9, 0.6, seed=0,
                                              device="cuda")
                          if r == DYN_ROUTING else
                          transport.ecmp_routing(topo, n_tables=8, seed=0,
                                                 device="cuda")).build_stats
                         for _ in range(BUILD_REPEATS)]
                builds[f"{r} {eng}"] = {k: [st.get(k) for st in stats]
                                        for k in stats[0]}
    print("# phase 9.1: sf(q=19) main sweep under auto (blocked + "
          "compressed): RunResults and depart_step equal phase 5's dense "
          "run, tables bitwise across engines, compressed tables exactly "
          f"nh; launches {launches}; compressed {json.dumps(info)}; build "
          f"s over {BUILD_REPEATS} builds (ecmp's compression is in its "
          f"host_s) {json.dumps(builds)}", flush=True)
    return launches


def phase_paper_stacks(Session, paths, ref, semiring_matmul, LAUNCHES,
                       reset_launches, k2):
    """9.2 The four sf(q=29) stacks under each engine, each built in a new
    session with the launch counts and the peak memory reset before it:
    bitwise equal across engines; the blocked ksp stack's four (min, +)
    products held against the plain version (whole products) and
    timed."""
    stacks, out, minplus = {}, {}, []
    n = Session(device="cpu").topology(PAPER_TOPO).n_routers
    for eng in ("auto", "dense"):
        with _engine(eng):
            ses = Session(device="cuda")
            if paths.path_engine(n) != ("blocked" if eng == "auto"
                                        else "dense"):
                raise AssertionError(f"{eng} resolved otherwise at {n} "
                                     "routers")
            for r in PAPER_STACKS:
                calls = []
                reset_launches()
                with _recording([paths], calls, r):
                    lr, peak = _build_peak(
                        lambda: ses.routing(PAPER_TOPO, r).routing)
                if LAUNCHES["semiring"] != len(calls):
                    raise AssertionError(f"{r} {eng}: {LAUNCHES['semiring']}"
                                         f" launches, {len(calls)} calls")
                kinds = {}
                for _, a, b, sr in calls:
                    kinds[sr] = kinds.get(sr, 0) + 1
                stacks[(eng, r)] = lr
                out[f"{r} {eng}"] = dict(
                    semiring_launches=kinds, peak_mib=peak,
                    **{k: v for k, v in lr.build_stats.items()})
                if eng == "auto" and r == KSP_ROUTING:
                    minplus = [(a, b, sr) for _, a, b, sr in calls]
    for r in PAPER_STACKS:
        _same_stack(stacks[("auto", r)], stacks[("dense", r)],
                    f"sf(q=29) {r} blocked vs dense")
        out[f"{r} auto"]["compressed"] = _compressed_info(stacks[("auto", r)],
                                                          r)
    if len(minplus) != 4 or {c[2] for c in minplus} != {"minplus"} or \
            {tuple(c[0].shape) for c in minplus} != {(8, n, n)}:
        raise AssertionError("the blocked sf(q=29) ksp build made "
                             f"{[(tuple(a.shape), sr) for a, _, sr in minplus]}")
    del stacks
    max_err = max(_check_equal(semiring_matmul(*c),
                               ref.semiring_matmul_ref(*c),
                               f"sf(q=29) ksp minplus call {i}")
                  for i, c in enumerate(minplus))
    ms, wall = _replay_ms(semiring_matmul, minplus, 3)
    plain_ms, _ = _replay_ms(ref.semiring_matmul_ref, minplus, 1)
    bound, by = _sum_bound([_mm_bound(*c) for c in minplus])
    entry = dict(calls=len(minplus), launches=len(minplus), ms=ms,
                 wall_ms=wall, plain_ms=plain_ms,
                 bound_ms=bound / len(minplus), bound_by=by,
                 library_ms=None, max_abs_err=max_err,
                 plain_compared="whole products",
                 shapes=[[8, n, n], [8, n, n]])
    k2["per_semiring"]["minplus"]["paper_ksp_blocked"] = entry
    print("# phase 9.2: sf(q=29) stacks (rand, ksp, pi_min, ecmp) bitwise "
          "across engines on the card, compressed tables exactly nh; "
          + json.dumps(out), flush=True)
    print("# phase 9.2: semiring minplus on the blocked sf(q=29) ksp "
          "build's 4 products, bitwise its plain version: "
          + json.dumps(entry), flush=True)
    return {"sf(q=29) ksp build (blocked)": len(minplus)}


def phase_paper_stats(Session, paths, ref, semiring_matmul, LAUNCHES,
                      reset_launches, k2):
    """9.3 ``min_path_stats(adj, max_l=8)`` of sf(q=29) under each engine:
    distances bitwise, counts bitwise below 2^24; the blocked engine's
    count products (row blocks) held against the plain version and timed
    beside the dense engine's."""
    adj = np.asarray(Session(device="cpu").topology(PAPER_TOPO).adj)
    res, recorded, launches = {}, {}, {}
    for eng in ("dense", "blocked"):
        calls = []
        reset_launches()
        with _recording([paths], calls, eng):
            res[eng] = paths.min_path_stats(adj, max_l=8, engine=eng,
                                            device="cuda")
        torch.cuda.synchronize()
        launches[eng] = LAUNCHES["semiring"]
        if launches[eng] != len(calls):
            raise AssertionError(f"min_path_stats {eng}: {launches[eng]} "
                                 f"launches, {len(calls)} calls")
        recorded[eng] = [(a, b, sr) for _, a, b, sr in calls
                         if sr == "count"]
    (d_d, c_d), (d_b, c_b) = res["dense"], res["blocked"]
    exact = c_d < 2 ** 24
    if not (np.array_equal(d_d, d_b) and np.array_equal(exact, c_b < 2 ** 24)
            and np.array_equal(c_d[exact], c_b[exact])):
        raise AssertionError("sf(q=29) min_path_stats differs across "
                             "engines")
    n_blocks = -(-adj.shape[0] // paths._CHUNK)
    if len(recorded["blocked"]) != 7 * n_blocks or \
            len(recorded["dense"]) != 7 or launches["blocked"] != 7 * n_blocks:
        raise AssertionError(f"count products: dense "
                             f"{len(recorded['dense'])}, blocked "
                             f"{len(recorded['blocked'])}")
    max_err, n_exact = 0.0, 0
    for i, (a, b, sr) in enumerate(recorded["blocked"]):
        err, ex = _check_count_call(semiring_matmul(a, b, sr),
                                    ref.semiring_matmul_ref(a, b, sr), a, b,
                                    f"sf(q=29) row-block count call {i}")
        max_err, n_exact = max(max_err, err), n_exact + ex
    entries = {}
    for eng, mine in recorded.items():
        ms, wall = _replay_ms(semiring_matmul, mine, 5)
        plain_ms, _ = _replay_ms(ref.semiring_matmul_ref, mine, 5)
        lib, _ = _replay_ms(torch.matmul, [(a.float(), b.float())
                                           for a, b, _ in mine], 5)
        bound, by = _sum_bound([_mm_bound(*c) for c in mine])
        entries[eng] = dict(calls=len(mine), launches=launches[eng],
                            ms=ms, wall_ms=wall, plain_ms=plain_ms,
                            bound_ms=bound / len(mine), bound_by=by,
                            library_ms=lib, path_ms=ms * len(mine),
                            shapes=sorted({(tuple(a.shape), tuple(b.shape))
                                           for a, b, _ in mine}))
    entries["blocked"].update(max_abs_err=max_err, bitwise_calls=n_exact)
    k2["per_semiring"]["count"]["paper_min_path_stats"] = entries
    print(f"# phase 9.3: sf(q=29) min_path_stats(max_l=8): distances "
          f"bitwise and counts (max {c_b.max():.0f}) bitwise across "
          f"engines; blocked count products held against the plain version "
          f"({n_exact} bitwise, the rest above 2^24 within rtol 4e-6 of "
          "float64); " + json.dumps(entries), flush=True)
    return {"sf(q=29) min_path_stats (blocked)": launches["blocked"],
            "sf(q=29) min_path_stats (dense)": launches["dense"]}


def phase_paper_cells(Session, catalog, transport, prng, LAUNCHES,
                      reset_launches, k1):
    """9.4 The sf(q=29) main cells under ``auto`` on the card and on the
    CPU port (blocked too), held equal as phase 5 holds its cells, with
    their scan readings and peak memory."""
    path_launches = {}
    with _engine("auto"):
        for r in (DYN_ROUTING, "ecmp"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ses, _, rr, _, launches, cpu_s = _card_and_cpu(
                Session, catalog, r, MAIN_PATTERN, MAIN_EVAL, LAUNCHES,
                reset_launches, topo=PAPER_TOPO, need=("waterfill",))
            peak = torch.cuda.max_memory_allocated()
            if ses.routing(PAPER_TOPO, r).routing.compressed is None:
                raise AssertionError(f"{rr.cell_id}: no compressed tables")
            reading = _scan_reading(ses, transport, prng, r, MAIN_PATTERN,
                                    2000, 80, topo=PAPER_TOPO)
            path_launches[rr.cell_id] = launches
            info = dict(cell=rr.cell_id, metrics=rr.metrics,
                        n_flows=rr.meta["n_flows"],
                        build_s=rr.meta["build_s"], cell_wall_s=rr.wall_s,
                        cpu_port_wall_s=cpu_s, launches=launches,
                        peak_device_mib=peak / 2 ** 20, **reading)
            k1.setdefault("per_path", {})[rr.cell_id] = _k1_reading(
                rr, reading)
            print("# phase 9.4: depart_step and metrics equal card vs CPU "
                  "port (both blocked); " + json.dumps(info), flush=True)
    return path_launches


def _k1_reading(rr, reading):
    return dict(calls=reading["waterfill_calls"],
                ms=reading["waterfill_ms_per_call"],
                bound_ms=_wf_bound_s(rr.meta["n_flows"], reading["hop_slots"],
                                     reading["e_tot"]) * 1e3,
                bound_by="bytes", n_flows=rr.meta["n_flows"],
                plan_entries=reading["plan_entries"],
                plan_max_segment=reading["plan_max_segment"])


def phase_ft2(Session, catalog, transport, prng, LAUNCHES, reset_launches,
              k1):
    """9.5 The cost-equal FT2 of sf(q=29) x ecmp x permutation x the main
    evaluator under each engine on the card (no CPU run): tables,
    RunResult and ``depart_step`` bitwise; the block the compressed
    tables settle on, each engine's build seconds and peak memory."""
    runs = {}
    for eng in ("auto", "dense"):
        with _engine(eng):
            sims = []
            ses = Session(device="cuda")
            reset_launches()
            lr, peak = _build_peak(lambda: ses.routing(FT2_TOPO,
                                                       "ecmp").routing)
            with _patched(catalog, "simulate_seeds", _sims_recorder(sims)):
                rr = ses.run(FT2_TOPO, "ecmp", MAIN_PATTERN, MAIN_EVAL)
            torch.cuda.synchronize()
            runs[eng] = (ses, lr, rr, sims, dict(LAUNCHES), peak)
    (ses, lr_b, rr, sims_b, launches, peak_b) = runs["auto"]
    (_, lr_d, rr_d, sims_d, launches_d, peak_d) = runs["dense"]
    _need_launches(launches, ("waterfill",), f"{rr.cell_id} blocked")
    _need_launches(launches_d, ("semiring", "waterfill"),
                   f"{rr.cell_id} dense")
    _same_stack(lr_b, lr_d, "FT2 blocked vs dense")
    _same_runs([rr_d], [rr], sims_d, sims_b, "FT2 blocked vs dense")
    spine = int(np.asarray(ses.topology(FT2_TOPO).adj).sum(1).max())
    with _engine("auto"):
        reading = _scan_reading(ses, transport, prng, "ecmp", MAIN_PATTERN,
                                2000, 80, topo=FT2_TOPO)
    k1.setdefault("per_path", {})[rr.cell_id] = _k1_reading(rr, reading)
    info = dict(cell=rr.cell_id, metrics=rr.metrics,
                n_routers=rr.meta["n_routers"], n_flows=rr.meta["n_flows"],
                spine_radix=spine,
                compressed=_compressed_info(lr_b, "FT2"),
                build_stats={"blocked": lr_b.build_stats,
                             "dense": lr_d.build_stats},
                build_peak_mib={"blocked": peak_b, "dense": peak_d},
                cell_wall_s={"blocked": rr.wall_s, "dense": rr_d.wall_s},
                launches={"blocked": launches, "dense": launches_d},
                **reading)
    print("# phase 9.5: FT2 tables, RunResult and depart_step bitwise "
          "blocked vs dense on the card; " + json.dumps(info), flush=True)
    return {f"{rr.cell_id} (blocked)": launches,
            f"{rr.cell_id} (dense)": launches_d}


@contextlib.contextmanager
def _batched_recorder(transport, dist_sweep, sims, buckets, unions=None):
    """Record what the batched engine does: each SimResult it assembles
    (``sims``, in its order), each bucket's wall, peak device memory
    above the memory allocated before it, elements and union scans
    (``buckets``), and, with ``unions`` given, each union scan's operands
    for a reading afterwards."""
    def scan_wrap(fn):
        def rec(arrs, key0, cfg, static, n_real=None):
            final = fn(arrs, key0, cfg, static, n_real=n_real)
            if key0.dim() == 2:
                buckets[-1]["scans"].append(dict(
                    elements=int(key0.shape[0]),
                    union_flows=int(arrs["size"].shape[0]),
                    union_links=int(static[0]),
                    plan_entries=int(arrs["plan_entries"].numel()),
                    plan_max_segment=int((arrs["plan_offsets"][1:]
                                          - arrs["plan_offsets"][:-1]).max()),
                    horizon_chunks=final["horizon_chunks"],
                    steps=_steps_run(final, cfg)))
                if unions is not None:
                    unions.append((arrs, key0, cfg, static, n_real))
            return final
        return rec

    def bucket_wrap(fn):
        def rec(works, *args, **kw):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            buckets.append(dict(cells=len(works), scans=[], element_cells=[
                w.spec.cell_id for w in works for _ in w.sim_seeds]))
            t0 = time.perf_counter()
            out = fn(works, *args, **kw)
            torch.cuda.synchronize()
            buckets[-1].update(
                wall_s=time.perf_counter() - t0, mode=out[2],
                peak_mib=(torch.cuda.max_memory_allocated() - base)
                / 2 ** 20)
            return out
        return rec

    def result_wrap(fn):
        def rec(*args, **kw):
            sims.append(fn(*args, **kw))
            return sims[-1]
        return rec

    with _patched(transport, "_run_scan", scan_wrap), \
            _patched(transport, "batch_result", result_wrap), \
            _patched(dist_sweep, "_run_bucket", bucket_wrap):
        yield


def _by_cell(cells, sims, buckets):
    """The batched engine's SimResults (in bucket order) in the order of
    ``cells``, each cell's sim seeds in turn."""
    by_id = {}
    for cid, sim in zip([c for b in buckets for c in b["element_cells"]],
                        sims):
        by_id.setdefault(cid, []).append(sim)
    return [sim for c in cells for sim in by_id[c.cell_id]]


def _same_departures(sims_a, sims_b, what):
    """Raise unless two flat lists of SimResults have equal departures,
    delivered bytes and retransmitted bytes; the departures' digests."""
    if len(sims_a) != len(sims_b):
        raise AssertionError(f"{what}: {len(sims_a)} simulations against "
                             f"{len(sims_b)}")
    for i, (a, b) in enumerate(zip(sims_a, sims_b)):
        for name in ("depart_step", "delivered", "retrans_bytes"):
            x, y = getattr(a, name), getattr(b, name)
            if (x is None) != (y is None) or (
                    x is not None and x.tobytes() != y.tobytes()):
                raise AssertionError(f"{what}: {name} differs in "
                                     f"simulation {i}")
    return [hashlib.sha256(a.depart_step.tobytes()).hexdigest()[:12]
            for a in sims_a]


def _union_k1_check(ref, waterfill_step, arrs, static, seed):
    """The water-filling kernel on one step of a union, over its link
    plan (random layers, weights and accumulators): bitwise its plain
    version on CPU copies."""
    from repro_torch.kernels.waterfill import LinkPlan
    g = torch.Generator().manual_seed(seed)
    n = arrs["size"].shape[0]
    layer = torch.randint(0, static[1], (n,), generator=g,
                          dtype=torch.int32).cuda()
    w = (torch.rand(n, generator=g) >= 0.2).float().cuda()
    desired = torch.rand(n, generator=g).cuda() * w
    edges = arrs["path_edges"][layer.long(), torch.arange(n, device="cuda")]
    return _wf_check(
        ref, waterfill_step,
        [edges, w, desired, torch.ones(static[0], device="cuda")],
        dict(active=w > 0, acc=torch.rand(n, generator=g).cuda(),
             plan=LinkPlan(arrs["plan_offsets"], arrs["plan_entries"], n),
             layer=layer), "union plan")


def phase_sweep(Session, catalog, transport, dist_sweep, prng, ref,
                waterfill_step, LAUNCHES, reset_launches, k1):
    """10. The batched sweep engine on the card (the engine phases 1-8
    force): (10.1) the sf(q=19) grid of fatpaths(9, 0.6) and ecmp x
    permutation and uniform x transport(steps=2000,seeds=4) x cell seeds
    0 and 1 (8 cells, 32 elements) through ``sweep(devices=1)`` and the
    sequential sweep, each in a new session: RunResults equal
    (``compare_results`` at rtol 0) and every element's departures,
    delivered and retransmitted bytes bitwise; the water-filling kernel
    launched once a step a bucket; each bucket's union read over 80
    profiled steps; (10.2) a death under dctcp recovery and a dynamic load
    cell over the same failures routing, three cell seeds each, batched
    against sequential; (10.3) 10.1's ecmp permutation cell (seed 0),
    batched on the card, against the CPU port's sequential run; (10.4)
    half of 10.1 into a checkpoint directory, then the whole grid resumed
    from it, equal to 10.1."""
    import tempfile

    from repro_torch.experiments.results import compare_results
    t_phase = time.perf_counter()
    grid = ([MAIN_TOPO], list(MAIN_ROUTINGS), list(SWEEP_PATTERNS),
            [SWEEP_EVAL], list(SWEEP_SEEDS))

    def seq_run(cells, card_sims, scans=None):
        ses = Session(device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            stack.enter_context(_patched(catalog, "simulate_seeds",
                                         _sims_recorder(card_sims)))
            if scans is not None:
                stack.enter_context(_patched(transport, "_run_scan",
                                             _timed_scans(scans)))
            out = [ses.run(c) for c in cells]
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # 10.1 batched, then sequential.
    b_sims, buckets, unions = [], [], []
    ses = Session(device="cuda")
    cells = ses.grid(*grid)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with _batched_recorder(transport, dist_sweep, b_sims, buckets, unions):
        batched = ses.sweep(*grid, devices=1)
    torch.cuda.synchronize()
    b_wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    b_sims = _by_cell(cells, b_sims, buckets)
    steps = sum(sc["steps"] for b in buckets for sc in b["scans"])
    _need_launches(launches, ("semiring", "waterfill"), "10.1 batched")
    if launches["waterfill"] != steps \
            or any(len(b["scans"]) != 1 for b in buckets):
        raise AssertionError(f"10.1: {launches['waterfill']} water-filling "
                             f"launches for {steps} union steps over "
                             f"{len(buckets)} buckets")
    s_sims, s_scans = [], []
    sequential, s_wall = seq_run(cells, s_sims, s_scans)
    s_sims = [r for run in s_sims for r in run]
    diffs = compare_results(sequential, batched, rtol=0.0)
    if diffs:
        raise AssertionError(f"10.1 batched vs sequential: {diffs[:4]}")
    digests = _same_departures(s_sims, b_sims, "10.1 batched vs sequential")
    for rr in batched:
        m = rr.metrics
        if not (m["finished"] > 0 and math.isfinite(m["fct_p99_us"])):
            raise AssertionError(f"{rr.cell_id}: {m}")
    print(f"# phase 10.1: {len(cells)} cells, {len(b_sims)} elements; "
          f"RunResults and every element's depart_step, delivered and "
          f"retrans_bytes equal batched vs sequential on the card; "
          f"water-filling launches {launches['waterfill']} = union steps "
          f"{steps}; batched grid wall {b_wall:.3f} s, sequential "
          f"{s_wall:.3f} s; depart_step sha256 {digests[::4]}", flush=True)
    for bi, (b, (arrs, keys, cfg, static, n_real)) in enumerate(
            zip(buckets, unions)):
        reading = _arrs_reading(transport, arrs, keys, cfg, static, 80,
                                n_real=n_real)
        scan = b["scans"][0]
        f_u = scan["union_flows"]
        if reading["steps"] != scan["steps"]:
            raise AssertionError(f"10.1 {b['mode']}: the union ran "
                                 f"{reading['steps']} steps again, not "
                                 f"{scan['steps']}")
        # The same elements' sequential scans in this run, per step.
        seq = [(t, n) for bal, t, n in s_scans if bal == cfg.balancing]
        seq_us = sum(t for t, _ in seq) / sum(n for _, n in seq) * 1e6
        per_elem = reading["us_per_step"] / scan["elements"]
        info = dict(bucket=b["mode"], cells=b["cells"],
                    elements=scan["elements"], union_flows=f_u,
                    union_links=scan["union_links"],
                    horizon_chunks=scan["horizon_chunks"],
                    bucket_wall_s=b["wall_s"],
                    peak_device_mib=b["peak_mib"],
                    us_per_element_step=per_elem,
                    sequential_scans=len(seq),
                    sequential_us_per_element_step=seq_us,
                    batched_speedup_per_element_step=seq_us / per_elem,
                    **reading)
        k1.setdefault("per_path", {})[f"batched bucket {b['mode']} "
                                      f"{cfg.balancing}"] = dict(
            calls=reading["waterfill_calls"],
            ms=reading["waterfill_ms_per_call"],
            bound_ms=_wf_bound_s(f_u, reading["hop_slots"],
                                 reading["e_tot"]) * 1e3,
            bound_by="bytes", n_flows=f_u,
            plan_entries=scan["plan_entries"],
            plan_max_segment=scan["plan_max_segment"],
            max_abs_err=_union_k1_check(ref, waterfill_step, arrs, static,
                                        bi))
        print(f"# phase 10.1 bucket ({cfg.balancing}): " + json.dumps(info),
              flush=True)
    del unions

    # 10.2 the mixed bucket: a death under recovery and dynamic load.
    mixed = [c for pattern, ev in MIXED_CELLS
             for c in ses.grid([MAIN_TOPO], [MIXED_ROUTING], [pattern],
                               [ev], list(MIXED_SEEDS))]
    m_sims, m_buckets = [], []
    ses2 = Session(device="cuda")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with _batched_recorder(transport, dist_sweep, m_sims, m_buckets):
        m_batched = dist_sweep.dist_sweep(ses2, mixed, devices=1)
    torch.cuda.synchronize()
    m_wall = time.perf_counter() - t0
    m_launches = dict(LAUNCHES)
    m_steps = sum(sc["steps"] for b in m_buckets for sc in b["scans"])
    if m_launches["waterfill"] != m_steps:
        raise AssertionError(f"10.2: {m_launches['waterfill']} water-"
                             f"filling launches for {m_steps} union steps")
    ms_sims = []
    m_seq, m_seq_wall = seq_run(mixed, ms_sims)
    diffs = compare_results(m_seq, m_batched, rtol=0.0)
    if diffs:
        raise AssertionError(f"10.2 batched vs sequential: {diffs[:4]}")
    _same_departures([r for run in ms_sims for r in run],
                     _by_cell(mixed, m_sims, m_buckets),
                     "10.2 batched vs sequential")
    print("# phase 10.2: " + json.dumps(dict(
        cells=[c.cell_id for c in mixed], batched_wall_s=m_wall,
        sequential_wall_s=m_seq_wall, launches=m_launches,
        buckets=[{k: v for k, v in b.items() if k != "element_cells"}
                 for b in m_buckets],
        metrics=[r.metrics for r in m_batched])), flush=True)

    # 10.3 one ecmp cell of 10.1, batched on the card, vs the CPU port.
    i = next(j for j, c in enumerate(cells)
             if c.routing.name == "ecmp" and c.seed == 0
             and c.pattern.name == MAIN_PATTERN)
    n_seeds = batched[i].meta["n_seeds"]
    cpu_sims = []
    t0 = time.perf_counter()
    with _patched(catalog, "simulate_seeds", _sims_recorder(cpu_sims)):
        rc = Session(device="cpu").run(cells[i])
    cpu_s = time.perf_counter() - t0
    if compare_results([batched[i]], [rc], rtol=0.0):
        raise AssertionError(f"10.3 {rc.cell_id}: batched card vs CPU: "
                             f"{compare_results([batched[i]], [rc])[:4]}")
    _same_departures(b_sims[i * n_seeds:(i + 1) * n_seeds], cpu_sims[0],
                     "10.3 batched card vs CPU port")
    print(f"# phase 10.3: {rc.cell_id} batched on the card equals the CPU "
          f"port's sequential run ({n_seeds} sim seeds; CPU port "
          f"{cpu_s:.2f} s)", flush=True)

    # 10.4 resume from a checkpoint of half the grid.
    with tempfile.TemporaryDirectory() as ckdir:
        t0 = time.perf_counter()
        dist_sweep.dist_sweep(Session(device="cuda"), cells[:len(cells) // 2],
                              devices=1, checkpoint_dir=ckdir)
        logs = []
        resumed = dist_sweep.dist_sweep(Session(device="cuda"), cells,
                                        devices=1, checkpoint_dir=ckdir,
                                        log=logs.append)
        r_wall = time.perf_counter() - t0
    n_res = sum(1 for r in resumed if r.meta.get("sweep_resumed"))
    diffs = compare_results(batched, resumed, rtol=0.0)
    if diffs or n_res != len(cells) // 2:
        raise AssertionError(f"10.4 resume: {n_res} resumed, {diffs[:4]}")
    print(f"# phase 10.4: {n_res} of {len(cells)} cells resumed from the "
          f"checkpoint, the rest run, artifact equal to 10.1 ({r_wall:.2f} "
          f"s; {logs[0] if logs else ''})", flush=True)
    print(f"# phase 10: wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {"batched sweep": launches, "batched mixed bucket": m_launches}


@contextlib.contextmanager
def _timed(targets, acc):
    """Wrap each ``(owner, attr, key)`` of ``targets`` so that every call
    appends its wall seconds to the list ``acc[key]``."""
    def wrap(key):
        def outer(fn):
            def timed(*args, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    acc.setdefault(key, []).append(time.perf_counter() - t0)
            return timed
        return outer

    with contextlib.ExitStack() as stack:
        for owner, attr, key in targets:
            stack.enter_context(_patched(owner, attr, wrap(key)))
        yield


def _walk_recorder(walks):
    """A recorder for ``usable_walks``: appends (wall s, walks) per call.
    The walk ends in its sequences' copy to the host, so the wall closes
    on the device's work."""
    def outer(fn):
        def rec(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            walks.append((time.perf_counter() - t0, int(len(out[2]))))
            return out
        return rec
    return outer


def phase_offscan(Session, catalog, layers, paths, throughput, fabric,
                  diversity, ref, semiring_matmul, LAUNCHES, reset_launches):
    """11. The evaluators off the scan, on the card and on the CPU port in
    this process: the sf(q=19) ``mat`` and ``fabric`` cells (RunResults at
    rtol 0), ``diversity_report(sf(q=11))`` field by field, and the sf(q=7)
    GF(p) oracle's ``M`` bitwise.  Each card run has the launch counts set
    to 0 just before and read just after."""
    import scipy
    import scipy.optimize
    from repro_torch.experiments.results import compare_results

    t_phase = time.perf_counter()
    print(f"# phase 11: scipy {scipy.__version__}, numpy {np.__version__}",
          flush=True)
    ses = {"cuda": Session(device="cuda"), "cpu": Session(device="cpu")}
    targets = [(throughput, "_candidate_paths", "candidates"),
               (scipy.optimize, "linprog", "linprog"),
               (catalog, "mat_lp", "mat_lp"),
               (catalog, "mat_single_layer", "single"),
               (fabric.ClusterFabric, "_walk_pairs", "pair_paths"),
               (fabric.ClusterFabric, "_fabric_loads", "loads")]
    path_launches = {}
    for ev in OFFSCAN_EVALS:
        for routing in MAIN_ROUTINGS:
            runs = {}
            for dev in ("cuda", "cpu"):
                walks, acc = [], {}
                torch.cuda.synchronize()
                reset_launches()
                with _timed(targets, acc), \
                        _patched(throughput, "usable_walks",
                                 _walk_recorder(walks)), \
                        _patched(fabric, "usable_walks",
                                 _walk_recorder(walks)):
                    rr = ses[dev].run(MAIN_TOPO, routing, MAIN_PATTERN, ev)
                torch.cuda.synchronize()
                runs[dev] = (rr, dict(LAUNCHES), walks, acc)
            rr, launches, walks, acc = runs["cuda"]
            rc = runs["cpu"][0]
            diffs = compare_results([rr], [rc], rtol=0.0)
            if diffs:
                raise AssertionError(f"{rr.cell_id} card vs CPU: {diffs[:4]}")
            if not all(math.isfinite(v) for v in rr.metrics.values()):
                raise AssertionError(f"{rr.cell_id}: metrics {rr.metrics}")
            info = dict(cell=rr.cell_id, metrics=rr.metrics,
                        cell_wall_s=rr.wall_s, cpu_port_wall_s=rc.wall_s,
                        build_s=rr.meta["build_s"],
                        build_device_s=rr.meta["build_device_s"],
                        launches=launches)
            if ev == "mat":
                # The cell builds its stack: APSP through K2 bool.
                _need_launches(launches, ("semiring",), rr.cell_id)
                path_launches[f"mat {routing} stack build"] = \
                    launches["semiring"]
                if rr.meta["lp_status"] != "optimal" or \
                        not rr.metrics["n_paths"] >= rr.metrics["n_demands"]:
                    raise AssertionError(f"{rr.cell_id}: {rr.meta['lp_status']}"
                                         f", {rr.metrics}")
                if len(walks) != 2 or len(acc["candidates"]) != 2:
                    raise AssertionError(f"{rr.cell_id}: {len(walks)} walks "
                                         "for two candidate-path lists")
                lr = ses["cuda"].routing(MAIN_TOPO, routing).routing
                demands = throughput.router_demands(
                    ses["cuda"].workload(MAIN_TOPO, MAIN_PATTERN),
                    lr.topo.n_routers)
                s = np.array([k[0] for k in demands])
                t = np.array([k[1] for k in demands])
                walk_ms, walk_events, walk_top = _profile(
                    lambda: layers.usable_walks(lr, s, t, 16), top_n=4)
                info.update(
                    lp_status=rr.meta["lp_status"],
                    walk_sequences=walks[0][1],
                    walk_wall_s=[w[0] for w in walks],
                    walk_device_ms=walk_ms, walk_device_events=walk_events,
                    walk_top=walk_top,
                    assembly_host_s=[c - w[0] for c, w in
                                     zip(acc["candidates"], walks)],
                    lp_matrices_host_s=(acc["mat_lp"][0]
                                        - acc["candidates"][0]
                                        - acc["linprog"][0]),
                    linprog_host_s=acc["linprog"][0],
                    greedy_host_s=acc["single"][0] - acc["candidates"][1])
            else:
                if len(walks) != 1:
                    raise AssertionError(f"{rr.cell_id}: {len(walks)} walks, "
                                         "not one")
                info.update(
                    fabric_scheme=rr.meta["fabric_scheme"],
                    walk_sequences=walks[0][1], walk_wall_s=walks[0][0],
                    assembly_host_s=acc["pair_paths"][0] - walks[0][0],
                    greedy_host_s=acc["loads"][0] - acc["pair_paths"][0])
            print(f"# phase 11 ({ev}): " + json.dumps(info), flush=True)
    print("# phase 11: sf(q=19) mat and fabric cells equal card vs CPU port "
          "(RunResults at rtol 0, lp_status and fabric_scheme included)",
          flush=True)

    # diversity_report: min_path_stats through K2 bool (APSP) and count.
    calls = []
    topo_g = ses["cuda"].topology(DIVERSITY_TOPO)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with _recording([paths], calls, "diversity_report"):
        rep_g = diversity.diversity_report(topo_g, device="cuda")
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    div_launches = dict(LAUNCHES)
    _need_launches(div_launches, ("semiring",), "diversity_report",
                   exactly=len(calls))
    kinds = {}
    for _, a, b, sr in calls:
        kinds[sr] = kinds.get(sr, 0) + 1
    if not kinds.get("count"):
        raise AssertionError(f"diversity_report made no count product: "
                             f"{kinds}")
    t0 = time.perf_counter()
    rep_c = diversity.diversity_report(ses["cpu"].topology(DIVERSITY_TOPO),
                                       device="cpu")
    cpu_s = time.perf_counter() - t0
    dg, dc = dataclasses.asdict(rep_g), dataclasses.asdict(rep_c)
    for k in dc:
        if dg[k] != dc[k] or type(dg[k]) is not type(dc[k]):
            raise AssertionError(f"diversity_report {k}: card {dg[k]!r}, "
                                 f"CPU port {dc[k]!r}")
    max_err, n_exact = 0.0, 0
    for i, (_, a, b, sr) in enumerate(calls):
        what = f"semiring {sr} call {i} (diversity_report)"
        out = semiring_matmul(a, b, sr)
        exp = ref.semiring_matmul_ref(a, b, sr)
        if sr == "count":
            err, exact = _check_count_call(out, exp, a, b, what)
        else:
            err, exact = _check_equal(out, exp, what), True
        max_err, n_exact = max(max_err, err), n_exact + exact
    path_launches[f"diversity_report {DIVERSITY_TOPO}"] = \
        div_launches["semiring"]
    print(f"# phase 11: diversity_report({DIVERSITY_TOPO}) equal card vs CPU "
          f"port field by field: {json.dumps(dg)}; card {card_s:.2f} s, CPU "
          f"port {cpu_s:.2f} s; launches {div_launches}; semiring products "
          f"{kinds}, held against the plain version: {n_exact} bitwise, "
          f"{len(calls) - n_exact} count products above 2^24 within rtol "
          f"4e-6 of float64 (max abs err {max_err:.6g})", flush=True)

    # The Cheung GF(p) oracle: float64 Horner products, exact integers.
    adj = ses["cpu"].topology(GF_BUILD_TOPO).adj
    t0 = time.perf_counter()
    gf_g = diversity.GFConnectivity.build(adj, GF_BUILD_LEN, device="cuda")
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gf_c = diversity.GFConnectivity.build(adj, GF_BUILD_LEN, device="cpu")
    cpu_s = time.perf_counter() - t0
    if gf_g.M.dtype != np.float64 or gf_g.M.tobytes() != gf_c.M.tobytes():
        raise AssertionError("GFConnectivity.M differs card vs CPU port")
    rng = np.random.default_rng(0)
    pairs = [tuple(int(v) for v in rng.choice(len(adj), 2, replace=False))
             for _ in range(64)]
    q_g, q_c = gf_g.query_pairs(pairs), gf_c.query_pairs(pairs)
    if not np.array_equal(q_g, q_c):
        raise AssertionError("GFConnectivity.query_pairs differs card vs CPU")
    print(f"# phase 11: GFConnectivity.build({GF_BUILD_TOPO}, max_len="
          f"{GF_BUILD_LEN}): M ({gf_g.M.shape[0]}^2, p {gf_g.p}) bitwise card "
          f"vs CPU port ({card_s:.3f} against {cpu_s:.3f} s); query_pairs on "
          f"64 pairs equal (ranks {int(q_g.min())}-{int(q_g.max())}, mean "
          f"{float(q_g.mean()):.3f})", flush=True)
    print(f"# phase 11: wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return path_launches


def _serve_timed(eng, times, lgs):
    """Wrap ``eng``'s prefill and decode steps: each call's host wall,
    ending in a synchronize, appended to ``times[step]``; each decode
    step's logits kept in ``lgs``."""
    prefill, decode = eng.prefill, eng.decode

    def timed_prefill(params, batch):
        t0 = time.perf_counter()
        out = prefill(params, batch)
        torch.cuda.synchronize()
        times["prefill"].append(time.perf_counter() - t0)
        lgs.append(out[0])
        return out

    def timed_decode(params, cache, toks):
        t0 = time.perf_counter()
        out = decode(params, cache, toks)
        torch.cuda.synchronize()
        times["decode"].append(time.perf_counter() - t0)
        lgs.append(out[1])
        return out

    eng.prefill, eng.decode = timed_prefill, timed_decode


def _step_bound(cfg, params, b, sq, n_keys, chosen=None):
    """Least time in ms of one forward of ``b`` rows of ``sq`` new tokens
    over ``n_keys`` cached keys a layer (the new ones included), what
    bounds it, and the weight bytes it reads: every weight read once (the
    embedding table only at its ``b * sq`` rows; given ``chosen``, each
    layer's (T, k) expert choices, of the experts only the chosen ones),
    the cache's live entries read and the new ones written (K and V, or
    MLA's latent and rope key), the logits written in bf16; operations 2
    per weight and token for the products (each token through its own
    top-k experts), 2 (Dq + Dv) per (query, key) pair and head for
    attention (MLA's absorbed decode against the latent: Dq = kv_lora +
    rope, Dv = kv_lora), at the bf16 tensor-core rate."""
    weight_bytes = mm_params = 0
    for path, t in _leaves(params).items():
        if path == "/embed/tok":
            weight_bytes += b * sq * t.shape[1] * t.element_size()
        elif chosen is not None and "/moe/w" in path:
            weight_bytes += t[0, 0].numel() * t.element_size() * sum(
                int(torch.unique(c).numel()) for c in chosen)
            mm_params += t[0, 0].numel() * cfg.moe.top_k * t.shape[0]
        else:
            weight_bytes += t.numel() * t.element_size()
            if t.ndim >= 3 or path == "/lm_head/w":
                mm_params += t.numel()
    m = cfg.mla
    if m is None:
        per_key, dq, dv = 2 * cfg.n_kv_heads * cfg.d_head, cfg.d_head, \
            cfg.d_head
    elif sq == 1:
        per_key, dq, dv = m.kv_lora + m.rope_dim, m.kv_lora + m.rope_dim, \
            m.kv_lora
    else:
        per_key, dq, dv = m.kv_lora + m.rope_dim, m.nope_dim + m.rope_dim, \
            m.v_dim
    kv = cfg.n_layers * b * per_key * 2
    t_bytes = (weight_bytes + kv * n_keys + b * sq * cfg.vocab * 2) \
        / HBM_BYTES_PER_S
    pairs = sq * n_keys if sq == 1 else _attn_pairs(sq, sq, cfg.causal, 0)
    t_ops = (2.0 * b * sq * mm_params + 2.0 * cfg.n_layers * b * cfg.n_heads
             * (dq + dv) * pairs) / BF16_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations"), weight_bytes


def _to_card(tree):
    return {k: _to_card(v) if isinstance(v, dict) else v.cuda()
            for k, v in tree.items()}


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v
    return out


def _k5_recorder(calls, decode_at):
    """A wrapper for the models' ``flash_attention`` that keeps copies of
    the first causal (prefill) call and of the ``decode_at``-th
    non-causal (decode) call in ``calls``: the path's own K5 inputs."""
    n_decode = [0]

    def wrap(fn):
        def call(q, k, v, **kw):
            if kw["causal"] and "prefill" not in calls:
                calls["prefill"] = (q.contiguous().clone(),
                                    k.contiguous().clone(),
                                    v.contiguous().clone(), kw)
            elif not kw["causal"]:
                if n_decode[0] == decode_at:
                    calls["decode"] = (q.contiguous().clone(),
                                       k.contiguous().clone(),
                                       v.contiguous().clone(), kw)
                n_decode[0] += 1
            return fn(q, k, v, **kw)
        return call
    return wrap


def _k5_call_reading(ref, flash_attention, call, what):
    """One recorded attention call of a served path: held against the
    plain version at bf16's rounding, timed beside it, its bound and
    ``scaled_dot_product_attention(enable_gqa=True)`` on the same
    inputs."""
    q, k, v, kw = call
    out = flash_attention(q, k, v, **kw)
    err, rel = _attn_close(out, ref.attention_ref(q, k, v, **kw), 1e-2, 1e-3,
                           f"attention on the served path's {what} call")
    ms, wall = _replay_ms(lambda *x: flash_attention(*x, **kw), [(q, k, v)],
                          20)
    plain_ms, _ = _replay_ms(lambda *x: ref.attention_ref(*x, **kw),
                             [(q, k, v)], 5)

    def sdpa(*x):
        return torch.nn.functional.scaled_dot_product_attention(
            *x, is_causal=kw["causal"], scale=kw["scale"], enable_gqa=True)
    # SDPA has no window and no softcap: no library time for such a call
    # (a window that covers every key of the call changes nothing).
    windowed = kw["window"] and kw["window"] < k.shape[2]
    lib = None if windowed or kw["softcap"] else \
        _replay_ms(sdpa, [(q, k, v)], 20)[0]
    b, h, sq, d = q.shape
    lay = dict(b=b, h=h, hkv=k.shape[1], sq=sq, sk=k.shape[2], d=d,
               dv=v.shape[3], causal=kw["causal"], window=kw["window"])
    bound, by = _fwd_bound(lay, q.dtype)
    return dict(shape={n: lay[n] for n in ("b", "h", "hkv", "sq", "sk", "d",
                                           "dv")},
                dtype=str(q.dtype).replace("torch.", ""), ms=ms, wall_ms=wall,
                plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib, max_abs_err=err, rel_frobenius_err=rel)


def phase_serve(ref, flash_attention, LAUNCHES, reset_launches):
    """12. The LM serving path on the card (see the module docstring)."""
    from repro_torch import configs
    from repro_torch.dist.sharding import Runtime
    from repro_torch.launch import serve as launch
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import model as model_mod
    from repro_torch.serve.engine import ServeConfig, ServingEngine

    t_phase = time.perf_counter()
    args = launch.parse_args(["--arch", SERVE_ARCH])   # the CLI's defaults
    cfg, rt = configs.get_config(SERVE_ARCH), Runtime()
    sc = ServeConfig(batch=args.batch, max_len=args.max_len)
    n_batches = -(-args.n_requests // args.batch)
    want = cfg.n_layers * (1 + args.max_new) * n_batches

    # 12.1: yi-9b at full width, the launcher's path with its defaults.
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = model_mod.init_params(cfg, rt, gen, "cuda")
    eng = ServingEngine(cfg, rt, params, sc, device="cuda")
    del params
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    held = sum(t.numel() * t.element_size()
               for t in _leaves(eng.params).values())
    calls = {}
    # Layer 0's call at the first batch's last decode step.
    rec = _k5_recorder(calls, cfg.n_layers * (args.max_new - 1))
    times = {"prefill": [], "decode": []}
    lgs = []
    _serve_timed(eng, times, lgs)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with _patched(attn_mod, "flash_attention", rec):
        outs = launch.serve_requests(eng, cfg.vocab, args.n_requests,
                                     args.max_new, args.seed,
                                     log=lambda line: None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    serve_peak = torch.cuda.max_memory_allocated()
    _need_launches(launches, ("flash_attention",), "yi-9b serve",
                   exactly=want)
    if len(outs) != args.n_requests or any(
            len(o) != args.max_new + 1 or not all(0 <= t < cfg.vocab
                                                   for t in o)
            for o in outs):
        raise AssertionError(f"yi-9b serve: unexpected outputs {outs}")
    if not all(bool(torch.isfinite(lg).all()) for lg in lgs):
        raise AssertionError("yi-9b serve: logits not finite")
    tokens = args.n_requests * (args.max_new + 1)
    prefill_s, decode_s = list(times["prefill"]), list(times["decode"])
    last = torch.from_numpy(eng.last.astype(np.int64)).cuda()[:, None]
    n_keys = int(eng.cache["0"]["pos"][0]) + 1
    device_ms, n_events, top = _profile(
        lambda: eng.decode(eng.params, eng.cache, last), top_n=10 ** 6)
    split = {"flash_attention": 0.0, "matmul": 0.0, "rest": 0.0}
    for kname, ms, _ in top:
        low = kname.lower()
        if "flash" in low:
            split["flash_attention"] += ms
        elif any(m in low for m in _CUBLAS):
            split["matmul"] += ms
        else:
            split["rest"] += ms
    bound, by, _ = _step_bound(cfg, eng.params, args.batch, 1, n_keys)
    width = calls["prefill"][0].shape[2]
    p_bound, p_by, _ = _step_bound(cfg, eng.params, args.batch, width,
                                   width)
    # The transposed copy of the live prefix a decode attention makes (K
    # and V of one layer), as the engine's cache holds them now.
    kc, vc = eng.cache["0"]["k"][0], eng.cache["0"]["v"][0]
    copy_ms, _ = _replay_ms(
        lambda n: (kc[:, :n].transpose(1, 2).contiguous(),
                   vc[:, :n].transpose(1, 2).contiguous()), [(n_keys,)], 20)
    info = dict(
        arch=SERVE_ARCH, batch=args.batch, max_len=args.max_len,
        n_requests=args.n_requests, max_new=args.max_new, seed=args.seed,
        params=cfg.param_count(), init_s=init_s,
        init_peak_gb=init_peak / 1e9, held_weights_gb=held / 1e9,
        serve_peak_gb=serve_peak / 1e9, wall_s=wall,
        tokens_per_s=tokens / wall,
        prefill_ms=[t * 1e3 for t in prefill_s],
        decode_ms_per_step=1e3 * sum(decode_s) / len(decode_s),
        decode_ms_min=1e3 * min(decode_s), decode_ms_max=1e3 * max(decode_s),
        decode_steps=len(decode_s), launches=launches,
        profiled_decode_step=dict(keys=n_keys, device_ms=device_ms,
                                  device_events=n_events, split_ms=split,
                                  top=top[:12]),
        decode_bound_ms=bound, decode_bound_by=by,
        all_weights_bound_ms=held / HBM_BYTES_PER_S * 1e3,
        prefill_width=width, prefill_bound_ms=p_bound, prefill_bound_by=p_by,
        prefix_copy_ms_per_layer=copy_ms,
        prefix_copy_ms_per_step=copy_ms * cfg.n_layers)
    print("# phase 12.1: " + json.dumps(info), flush=True)
    del eng, lgs, kc, vc, last
    torch.cuda.empty_cache()

    # 12.2: K5 on the path's own inputs.
    per = {f"yi-9b serve {what}": _k5_call_reading(ref, flash_attention,
                                                   calls[what], what)
           for what in ("prefill", "decode")}
    del calls
    print("# phase 12.2: " + json.dumps(per), flush=True)

    # 12.3: yi-9b at full width and 2 layers, card against the CPU port on
    # the same weights (drawn on the host from the seed), the CPU port's
    # tokens teacher-forced on the card; both beside the same model in f32
    # on the card.
    cfg2 = dataclasses.replace(cfg, n_layers=SERVE_SHORT_LAYERS)
    cfg2_f32 = dataclasses.replace(cfg2, dtype="float32")
    host = model_mod.init_params(cfg2, rt,
                                 torch.Generator().manual_seed(args.seed),
                                 "cpu")
    card = _to_card(host)
    eng_c = ServingEngine(cfg2, rt, host, sc, device="cpu")
    eng_g = ServingEngine(cfg2, rt, card, sc, device="cuda")
    eng_t = ServingEngine(cfg2_f32, rt, card, sc, device="cuda")
    del host, card
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(1, cfg.vocab, size=rng.integers(2, 9))
               for _ in range(args.batch)]
    cpu_logits, cpu_fed = [], []
    pre_c, dec_c = eng_c.prefill, eng_c.decode

    def rec_prefill(params, batch):
        lg, cache = pre_c(params, batch)
        cpu_logits.append(lg.float())
        return lg, cache

    def rec_decode(params, cache, toks):
        cpu_fed.append(toks)
        nxt, lg, cache = dec_c(params, cache, toks)
        cpu_logits.append(lg)
        return nxt, lg, cache

    eng_c.prefill, eng_c.decode = rec_prefill, rec_decode
    t0 = time.perf_counter()
    out_c = eng_c.run(prompts, max_new=args.max_new)
    cpu_s = time.perf_counter() - t0
    toks = np.zeros((args.batch, max(len(p) for p in prompts)), np.int64)
    for i, p in enumerate(prompts):
        toks[i, -len(p):] = p

    def forced(eng):
        """The prefill's and each teacher-forced decode step's logits."""
        lg, cache = eng.prefill(eng.params,
                                {"tokens": torch.from_numpy(toks).cuda()})
        out = [lg.float().cpu()]
        for fed in cpu_fed:
            _, lg, cache = eng.decode(eng.params, cache, fed.cuda())
            out.append(lg.cpu())
        return out

    card_logits, f32_logits = forced(eng_g), forced(eng_t)
    del eng_t

    def gap(got, exp):
        """Per step: max |got - exp| and max |got - exp| / (1 + |exp|)."""
        return ([float((g - e).abs().max()) for g, e in zip(got, exp)],
                max(float(((g - e).abs() / (1 + e.abs())).max())
                    for g, e in zip(got, exp)))

    gaps = {"card vs CPU port": gap(card_logits, cpu_logits),
            "card vs f32": gap(card_logits, f32_logits),
            "CPU port vs f32": gap(cpu_logits, f32_logits)}
    for what in ("card vs CPU port", "card vs f32"):
        if gaps[what][1] > SERVE_BF16_TOL:
            raise AssertionError(
                f"2-layer yi-9b, {what}: logits not within rtol = atol = "
                f"{SERVE_BF16_TOL} ({gaps[what]})")
    out_g = eng_g.run(prompts, max_new=args.max_new)
    agree = sum(a == b for o_g, o_c in zip(out_g, out_c)
                for a, b in zip(o_g, o_c))
    prefix = [next((j for j, (a, b) in enumerate(zip(o_g, o_c)) if a != b),
                   len(o_c)) for o_g, o_c in zip(out_g, out_c)]
    print(f"# phase 12.3: yi-9b at full width and {SERVE_SHORT_LAYERS} "
          f"layers on the same weights: the CPU port's prefill and "
          f"{len(cpu_fed)} decode steps teacher-forced on the card, every "
          f"step's logits within rtol = atol = {SERVE_BF16_TOL} of the CPU "
          "port's and of the same model in f32 on the card (bf16 compute; "
          "per pair: max abs err per step, max |err| / (1 + |exp|)) "
          f"{json.dumps(gaps)}; logits up to "
          f"{float(max(c.abs().max() for c in f32_logits)):.3f}; "
          f"free-running greedy tokens agree at {agree} of "
          f"{sum(len(o) for o in out_c)} positions (first disagreement per "
          f"request at {prefix}); CPU port run {cpu_s:.1f} s", flush=True)

    # 12.4: decode matches prefill on the card, in f32 (the JAX package's
    # test: f32 smoke configs and cache, rtol = atol = 2e-2) and in bf16
    # with a bf16 cache (at bf16 compute's tolerance).
    b, s = 2, 12
    tk = torch.from_numpy(np.random.default_rng(args.seed + 1).integers(
        0, cfg.vocab, (b, s))).cuda()
    errs = {}
    for c2, dt, tol in ((cfg2_f32, torch.float32, 2e-2),
                        (cfg2, torch.bfloat16, SERVE_BF16_TOL)):
        params = eng_g.params if dt == torch.bfloat16 else \
            model_mod.cast_params(eng_g.params, c2)
        full, _ = model_mod.forward(params, c2, rt, {"tokens": tk})
        cache = model_mod.init_cache(c2, rt, b, 32, dt, device="cuda")
        _, cache, _ = model_mod.forward(params, c2, rt,
                                        {"tokens": tk[:, :-1]}, cache=cache)
        step, _, _ = model_mod.forward(params, c2, rt, {"tokens": tk[:, -1:]},
                                       cache=cache)
        full, step = full[:, -1].float(), step[:, 0].float()
        errs[str(dt)] = float((step - full).abs().max())
        if not bool(((step - full).abs() <= tol * full.abs() + tol).all()):
            raise AssertionError(f"{dt}: decode does not match prefill on "
                                 f"the card (max abs err {errs[str(dt)]})")
        del params, full, step, cache
    print(f"# phase 12.4: an {s - 1}-token prefill and one decode step give "
          f"the {s}-token forward's last logits on the card: f32 within "
          f"rtol = atol = 2e-2, bf16 within {SERVE_BF16_TOL} (max abs err "
          f"{json.dumps(errs)})", flush=True)
    del eng_c, eng_g, tk
    torch.cuda.empty_cache()
    wall12 = time.perf_counter() - t_phase
    print(f"# phase 12: wall {wall12:.1f} s", flush=True)
    return dict(launches=launches["flash_attention"], per_layout=per,
                wall_s=wall12)


def _fwd_bound(lay, dtype, lse=False):
    """(least ms, what bounds it) of K5's forward at layout ``lay`` (``sq``
    and ``sk`` are ``s`` by default, V ``dv`` wide, D by default): 2
    products per unmasked (q, k) pair and head, S = q k^T and P v, 2 (D +
    Dv) flops, at the dtype's rate; q, k, v read once, the output (and
    with ``lse`` its f32 LSE) written once."""
    b, h, hkv, d = lay["b"], lay["h"], lay["hkv"], lay["d"]
    sq, sk = lay.get("sq", lay.get("s")), lay.get("sk", lay.get("s"))
    dv = lay.get("dv", d)
    pairs = b * h * _attn_pairs(sq, sk, lay["causal"], lay["window"])
    rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S
    item = torch.finfo(dtype).bits // 8
    nbytes = item * (b * h * sq * (d + dv) + b * hkv * sk * (d + dv)) \
        + (4 * b * h * sq if lse else 0)
    t_ops = 2.0 * (d + dv) * pairs / rate
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _bwd_bound(lay, dtype):
    """(least ms, what bounds it) of K5's backward at layout ``lay`` (V
    ``dv`` wide, D by default): 5 products per unmasked (q, k) pair and
    head, S = q k^T, dP = dO v^T, dV, dQ and dK, 2 (3 D + 2 Dv) flops (10
    D at Dv = D), at the dtype's rate; q, k, v, o, dO and the LSE read
    once, dQ, dK, dV written once."""
    b, h, hkv, s, d = lay["b"], lay["h"], lay["hkv"], lay["s"], lay["d"]
    dv = lay.get("dv", d)
    pairs = b * h * _attn_pairs(s, s, lay["causal"], lay["window"])
    rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S
    item = torch.finfo(dtype).bits // 8
    nbytes = item * 2 * (b * h * s * (d + dv) + b * hkv * s * (d + dv)) \
        + 4 * b * h * s
    t_ops = 2.0 * (3 * d + 2 * dv) * pairs / rate
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _bwd_plain_sliced(ref, q, k, v, out, lse, do, kw):
    """The plain backward one KV head (and its query heads) at a time:
    the groups are independent, and their (B, G, S, S) f32 products
    fit."""
    group = q.shape[1] // k.shape[1]
    parts = [ref.flash_attention_bwd_ref(
        q[:, g * group:(g + 1) * group], k[:, g:g + 1], v[:, g:g + 1],
        out[:, g * group:(g + 1) * group], lse[:, g * group:(g + 1) * group],
        do[:, g * group:(g + 1) * group], **kw)
        for g in range(k.shape[1])]
    return tuple(torch.cat([p[i] for p in parts], dim=1) for i in range(3))


def _fwd_plain_sliced(ref, q, k, v, kw):
    """The plain forward and its LSE one KV head (and its query heads) at
    a time."""
    group = q.shape[1] // k.shape[1]
    parts = [ref.attention_ref(q[:, g * group:(g + 1) * group],
                               k[:, g:g + 1], v[:, g:g + 1],
                               return_lse=True, **kw)
             for g in range(k.shape[1])]
    return (torch.cat([p[0] for p in parts], dim=1),
            torch.cat([p[1] for p in parts], dim=1))


def _bwd_twice(fa_mod, args, kw, dt, what):
    """K5's backward on ``args``, launched twice: the route both launches
    took (``ROUTE_LAUNCHES`` read around them) must be ``wgmma-tma`` in
    bf16 and ``cuda-cores`` in f32, and the two launches' gradients must
    be the same bits (no atomics, sums in a fixed order).  Returns the
    gradients and the route."""
    want = "wgmma-tma" if dt == torch.bfloat16 else "cuda-cores"
    before = dict(fa_mod.ROUTE_LAUNCHES)
    got = fa_mod.flash_attention_bwd(*args, **kw)
    again = fa_mod.flash_attention_bwd(*args, **kw)
    ran = {r: n - before.get(r, 0) for r, n in fa_mod.ROUTE_LAUNCHES.items()
           if n != before.get(r, 0)}
    if ran != {want: 2}:
        raise AssertionError(f"K5 backward {what}: routes {ran}, expected "
                             f"{want}")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"K5 backward {what}: two launches differ")
    return got, want


def _bwd_split(fa_mod, args, kw):
    """One backward call profiled: its device ms and the ms of each of its
    kernels (the statistics pass, dK/dV, dQ), for what to redesign
    next."""
    ms, _, top = _profile(lambda: fa_mod.flash_attention_bwd(*args, **kw))
    unnamed = [name for name, _, _ in top
               if not any(m in name for m in _K5_BWD)]
    if unnamed:
        raise AssertionError(f"K5 backward kernels {unnamed} match none of "
                             f"{_K5_BWD}: the training splits would miss "
                             "them")
    return dict(device_ms=ms, kernels={name: t for name, t, _ in top})


def phase_bwd(ref, fa_mod):
    """13.1 K5's backward at full-width layouts against its plain version
    (see the constants above), its forward and LSE against the plain
    version's (the output at rtol 1e-2 / atol 1e-3 in bf16 and 1e-4 in
    f32, the LSE within 1e-4), each backward timed beside its bound and,
    where there is no softcap and no window,
    ``scaled_dot_product_attention(enable_gqa=True)``'s backward under
    autograd; every backward launched twice (bitwise equal) on its route
    (``wgmma-tma`` in bf16, the CUDA cores in f32)."""
    t_phase = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(13)
    per, errs = {}, []
    for name, lay in BWD_LAYOUTS.items():
        dtypes = (torch.bfloat16, torch.float32) if name == "yi-9b" \
            else (torch.bfloat16,)
        b, h, hkv, s, d = lay["b"], lay["h"], lay["hkv"], lay["s"], lay["d"]
        base = [torch.randn(sh, generator=g, device="cuda") for sh in
                ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d), (b, h, s, d))]
        kw = dict(causal=lay["causal"], window=lay["window"],
                  softcap=lay["softcap"], scale=d ** -0.5)
        for dt in dtypes:
            q, k, v, do = (t.to(dt) for t in base)
            out, lse = fa_mod._launch(q, k, v, kw["causal"], kw["window"],
                                      kw["softcap"], kw["scale"],
                                      with_lse=True)
            exp, lse_exp = _fwd_plain_sliced(ref, q, k, v, kw)
            rtol, atol = (1e-2, 1e-3) if dt == torch.bfloat16 \
                else (1e-4, 1e-4)
            f_err, _ = _attn_close(out, exp, rtol, atol,
                                   f"K5 forward {name} {dt}")
            lse_err = float((lse - lse_exp).abs().max())
            if not bool(((lse - lse_exp).abs()
                         <= 1e-4 + 1e-5 * lse_exp.abs()).all()):
                raise AssertionError(f"K5 LSE {name} {dt}: max abs err "
                                     f"{lse_err}")
            del exp, lse_exp
            got, route = _bwd_twice(fa_mod, (q, k, v, out, lse, do), kw, dt,
                                    f"{name} {dt}")
            exp = _bwd_plain_sliced(ref, q, k, v, out, lse, do, kw)
            err = {}
            for gname, a, e in zip(("dq", "dk", "dv"), got, exp):
                e_max = float(e.float().abs().max())
                err[gname] = float((a.float() - e.float()).abs().max())
                if err[gname] > BWD_TOL[dt] * e_max:
                    raise AssertionError(
                        f"K5 backward {name} {dt} {gname}: max abs err "
                        f"{err[gname]} above {BWD_TOL[dt]} x {e_max}")
            errs += list(err.values())
            del got, exp
            ms, wall = _replay_ms(lambda *x: fa_mod.flash_attention_bwd(
                *x, **kw), [(q, k, v, out, lse, do)], 2)
            plain_ms, _ = _replay_ms(
                lambda *x: _bwd_plain_sliced(ref, *x, kw),
                [(q, k, v, out, lse, do)], 1)
            lib = None
            if not lay["softcap"] and not lay["window"]:
                xs = [t.detach().clone().requires_grad_() for t in (q, k, v)]
                o = torch.nn.functional.scaled_dot_product_attention(
                    *xs, is_causal=lay["causal"], scale=kw["scale"],
                    enable_gqa=True)
                lib, _ = _replay_ms(lambda: torch.autograd.grad(
                    o, xs, do, retain_graph=True), [()], 2)
                del xs, o
            bound, by = _bwd_bound(lay, dt)
            key = f"{name} {str(dt).replace('torch.', '')}"
            per[key] = dict(shape=dict(b=b, h=h, hkv=hkv, s=s, d=d),
                            route=route, ms=ms, wall_ms=wall,
                            split=_bwd_split(fa_mod, (q, k, v, out, lse, do),
                                             kw),
                            plain_ms=plain_ms,
                            bound_ms=bound, bound_by=by, library_ms=lib,
                            max_abs_err=err, fwd_max_abs_err=f_err,
                            lse_max_abs_err=lse_err)
            print(f"# phase 13.1 K5 backward {key}: " + json.dumps(per[key]),
                  flush=True)
            del q, k, v, do, out, lse
            torch.cuda.empty_cache()
    print(f"# phase 13.1: wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return per, max(errs)


def _grad_gap(got, exp):
    """Per leaf max |got - exp| / max |exp|, and the largest, of two
    gradient trees or lists."""
    from repro_torch.train.optimizer import tree_leaves

    def flat(t):
        return list(t) if isinstance(t, (list, tuple)) else tree_leaves(t)
    gaps = [float((a.cpu() - b).abs().max() / b.abs().max().clamp_min(
        1e-30)) for a, b in zip(flat(got), flat(exp))]
    return gaps, max(gaps)


def phase_train_short(configs, Runtime, model_mod, tts, topt, DataConfig,
                      SyntheticDataset, LAUNCHES, reset_launches):
    """13.2 yi-9b at full width and 1 layer in f32, card against the CPU
    port on the same weights (drawn on the host from the seed) and the
    same batch of 1 x 128 ``lm`` tokens: two train steps a side, the
    first step's loss, grad norm and every gradient leaf held (see the
    constants above); on the card ``remat="full"`` gives the same
    gradients as ``remat="none"``, bitwise."""
    rt = Runtime()
    cfg = dataclasses.replace(configs.get_config(TRAIN_ARCH), n_layers=1,
                              dtype="float32", remat="none")
    tc = tts.TrainConfig(opt=topt.AdamWConfig(warmup_steps=1,
                                              total_steps=TRAIN_STEPS))
    t0 = time.perf_counter()
    host = model_mod.init_params(cfg, rt, torch.Generator().manual_seed(0),
                                 "cpu")
    card = _to_card(host)
    init_s = time.perf_counter() - t0
    data = {dev: SyntheticDataset(cfg, DataConfig(1, TRAIN_SHORT_SEQ),
                                  rt, dev) for dev in ("cuda", "cpu")}
    # remat full against none on the card, from the same weights.
    full = dataclasses.replace(cfg, remat="full")
    reset_launches()
    runs = {r: tts.loss_and_grads(card, c, rt, data["cuda"].batch(0))
            for r, c in (("none", cfg), ("full", full))}
    remat_launches = dict(LAUNCHES)
    if remat_launches["flash_attention"] != 3 or \
            remat_launches["flash_attention_bwd"] != 2:
        raise AssertionError(f"13.2: remat none + full launched K5 "
                             f"{remat_launches} (3 forward, 2 backward)")
    if not torch.equal(runs["none"][0], runs["full"][0]) or not all(
            torch.equal(a, b) for a, b in zip(
                topt.tree_leaves(runs["none"][2]),
                topt.tree_leaves(runs["full"][2]))):
        raise AssertionError("13.2: remat='full' gradients differ from "
                             "remat='none' on the card")
    del runs
    out = {}
    for dev, params in (("cuda", card), ("cpu", host)):
        first = []

        def rec(fn):
            def call(*a, **kw):
                res = fn(*a, **kw)
                if not first:
                    first.append(res)
                return res
            return call
        step = tts.make_train_step(cfg, rt, tc)
        opt = topt.adamw_init(params)
        t0 = time.perf_counter()
        metrics = []
        with _patched(tts, "loss_and_grads", rec):
            for i in range(2):
                params, opt, m = step(params, opt, data[dev].batch(i), i)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
        out[dev] = dict(metrics=metrics, first=first[0],
                        wall_s=time.perf_counter() - t0)
    g_card, g_cpu = out["cuda"]["first"][2], out["cpu"]["first"][2]
    gaps, worst = _grad_gap(g_card, g_cpu)
    (l1g, n1g), (l2g, n2g) = out["cuda"]["metrics"]
    (l1c, n1c), (l2c, n2c) = out["cpu"]["metrics"]
    if abs(l1g - l1c) > 1e-5 * abs(l1c) or abs(n1g - n1c) > 1e-4 * n1c \
            or worst > 1e-4 or abs(l2g - l2c) > 1e-4 * abs(l2c):
        raise AssertionError(
            f"13.2: card {out['cuda']['metrics']} vs CPU port "
            f"{out['cpu']['metrics']}; worst gradient leaf gap {worst}")
    info = dict(arch=TRAIN_ARCH, n_layers=1, dtype="float32",
                tokens=TRAIN_SHORT_SEQ, params=cfg.param_count(),
                card=out["cuda"]["metrics"], cpu_port=out["cpu"]["metrics"],
                worst_gradient_leaf_gap=worst, leaves=len(gaps),
                remat_full_equals_none=True, init_s=init_s,
                card_two_steps_s=out["cuda"]["wall_s"],
                cpu_two_steps_s=out["cpu"]["wall_s"])
    print("# phase 13.2: " + json.dumps(info), flush=True)
    del host, card, out, g_card, g_cpu


def _step_split(top):
    split = {"k5_forward": 0.0, "k5_backward": 0.0, "cublas": 0.0,
             "rest": 0.0}
    for kname, ms, _ in top:
        low = kname.lower()
        if "flash_tc_kernel" in low or "flash_kernel" in low:
            split["k5_forward"] += ms
        elif any(m in kname for m in _K5_BWD):
            split["k5_backward"] += ms
        elif any(m in low for m in _CUBLAS):
            split["cublas"] += ms
        else:
            split["rest"] += ms
    return split


def _loop_run(cfg, ref, LAUNCHES, reset_launches, steps=TRAIN_STEPS,
              k5=None, seq=TRAIN_SEQ):
    """``cfg`` through ``TrainLoop`` at phase 13.3's batch and optimizer
    for ``steps`` steps on ``lm`` data of ``seq`` tokens a row, counts 0
    before and read after:
    exactly ``k5`` = (forward, backward) K5 launches a step, by default 2
    forward a layer (each layer's forward and its recompute under full
    remat) and 1 backward, no call of either plain version, a finite
    history (the aux too, with experts).  Returns the loop, its result,
    the run's seconds, the launches, the peak bytes and the plain
    versions' calls."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.dist.sharding import Runtime
    from repro_torch.train import loop as tloop
    from repro_torch.train import optimizer as topt
    from repro_torch.train import train_step as tts

    tc = tts.TrainConfig(opt=topt.AdamWConfig(warmup_steps=1,
                                              total_steps=steps))
    loop = tloop.TrainLoop(
        cfg, Runtime(), DataConfig(TRAIN_BATCH, seq, seed=0), tc,
        tloop.LoopConfig(total_steps=steps, log_every=1),
        device="cuda")
    plain_calls = {"attention_ref": 0, "flash_attention_bwd_ref": 0}

    def counted(name):
        def wrap(fn):
            def call(*a, **kw):
                plain_calls[name] += 1
                return fn(*a, **kw)
            return call
        return wrap
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with _patched(ref, "attention_ref", counted("attention_ref")), \
            _patched(ref, "flash_attention_bwd_ref",
                     counted("flash_attention_bwd_ref")):
        res = loop.run(seed=0)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    what = f"{cfg.name} train"
    fwd, bwd = k5 or (2 * cfg.n_layers, cfg.n_layers)
    _need_launches(launches, ("flash_attention",), what,
                   exactly=fwd * steps)
    _need_launches(launches, ("flash_attention_bwd",), what,
                   exactly=bwd * steps)
    if any(plain_calls.values()):
        raise AssertionError(f"{what} called a plain version: "
                             f"{plain_calls}")
    hist = res["history"]
    keys = ("loss", "grad_norm") + (("aux",) if cfg.moe else ())
    if len(hist) != steps or not all(
            math.isfinite(h[k]) for h in hist for k in keys):
        raise AssertionError(f"{what}: history {hist}")
    return loop, res, run_s, launches, peak, plain_calls


def _profiled_step(loop, state, cfg, steps=TRAIN_STEPS, seq=None):
    """One more step of ``loop`` on its next batch (its first ``seq``
    tokens a row, when given), profiled: the gradient pass (with the wire
    cast), then the optimizer.  Returns the gradient pass (to trace
    again), its (device ms, events, top) and the optimizer's."""
    from repro_torch.train import optimizer as topt
    from repro_torch.train import train_step as tts

    rt = loop.rt
    batch = {k: v[:, :seq] for k, v in loop.data.batch(steps).items()}
    grads = {}

    def grad_pass():
        grads.clear()   # a retaken reading replaces the last one's
        grads["g"] = topt.tree_map(rt.astype, tts.loss_and_grads(
            state["params"], cfg, rt, batch)[2])
    g = _profile(grad_pass, top_n=10 ** 6)
    o = _profile(lambda: topt.adamw_update(
        loop.tc.opt, state["params"], grads["g"], state["opt"]),
        top_n=10 ** 6)
    return grad_pass, g, o


def phase_train(ref, fa_mod, LAUNCHES, reset_launches):
    """13. Training on the card.  (13.1) K5's backward against its plain
    version; (13.2) the card against the CPU port at 1 layer; (13.3)
    yi-9b at full width and 8 layers through ``TrainLoop`` (the
    launcher's path) on ``lm`` data, counts 0 before and read after:
    exactly 8 x 2 x 6 = 96 K5 forward launches (each layer's forward and
    its recompute under full remat, a step) and 48 backward launches, no
    call of either plain version, finite losses and grad norms; then one
    more step profiled (the gradient pass and the optimizer apart).

    Should the loss fall in 6 steps?  Not steadily.  The ``lm`` stream's
    Zipf unigram is learnable through the LM head, but with one warmup
    step AdamW's first updates are about lr = 3e-4 in each weight's
    gradient sign, and summed coherently over d_model = 4096 inputs of
    unit scale they move every pre-activation by about lr d = 1.2, as
    much as its size at init (0.02 sqrt(d) = 1.3): the first steps
    overshoot, and the loss can rise above its ln(64 000) = 11.07 start
    before it falls.  The step is the JAX package's, held to it step by
    step on the CPU (``tests/test_torch_train_steps.py``).  The
    trajectory is reported, not tuned."""
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, SyntheticDataset
    from repro_torch.dist.sharding import Runtime
    from repro_torch.models import model as model_mod
    from repro_torch.train import optimizer as topt
    from repro_torch.train import train_step as tts

    t_phase = time.perf_counter()
    per, bwd_err = phase_bwd(ref, fa_mod)
    t13_2 = time.perf_counter()
    phase_train_short(configs, Runtime, model_mod, tts, topt, DataConfig,
                      SyntheticDataset, LAUNCHES, reset_launches)
    gc.collect()
    torch.cuda.empty_cache()

    # 13.3 the full-width run.
    t13_3 = time.perf_counter()
    cfg = dataclasses.replace(configs.get_config(TRAIN_ARCH),
                              n_layers=TRAIN_LAYERS)
    loop, res, run_s, launches, peak, plain_calls = _loop_run(
        cfg, ref, LAUNCHES, reset_launches)
    hist = res["history"]
    walls = [h["wall_s"] for h in hist]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    state = res["state"]
    _, (g_ms, g_events, g_top), (o_ms, o_events, o_top) = _profiled_step(
        loop, state, cfg)
    split = _step_split(g_top)
    split["optimizer"] = o_ms
    # The step's bound: the matmuls' 8 N T (forward, recompute, backward
    # twice) and the attention's pair products (4 D forward twice, 10 D
    # backward) at the bf16 rate, plus the optimizer's bytes (f32
    # parameter, m and v read and written, the bf16 gradient read: 26
    # bytes a parameter) at 3.35 TB/s.
    n_mm = sum(t.numel() for path, t in _leaves(state["params"]).items()
               if t.ndim >= 3 or path == "/lm_head/w")
    n_all = sum(t.numel() for t in _leaves(state["params"]).values())
    pairs = TRAIN_BATCH * _attn_pairs(TRAIN_SEQ, TRAIN_SEQ, True, 0)
    t_mm = 8.0 * n_mm * tokens / BF16_FLOP_PER_S
    t_attn = 18.0 * cfg.d_head * cfg.n_heads * TRAIN_LAYERS * pairs \
        / BF16_FLOP_PER_S
    t_opt = 26.0 * n_all / HBM_BYTES_PER_S
    steady = float(np.median(walls[1:]))
    info = dict(
        arch=TRAIN_ARCH, n_layers=TRAIN_LAYERS, cut="n_layers 48 -> 8",
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS,
        params=cfg.param_count(), matmul_params=n_mm,
        dtype=cfg.dtype, param_dtype=cfg.param_dtype, remat=cfg.remat,
        losses=[h["loss"] for h in hist],
        grad_norms=[h["grad_norm"] for h in hist],
        step_wall_s=walls, steady_step_s=steady,
        tokens_per_s=tokens / steady, run_s=run_s, peak_gb=peak / 1e9,
        launches={k: launches[k] for k in ("flash_attention",
                                            "flash_attention_bwd")},
        plain_calls=plain_calls,
        profiled_step=dict(device_ms=g_ms + o_ms, events=g_events + o_events,
                           split_ms=split, optimizer_events=o_events,
                           top=g_top[:12] + o_top[:4]),
        device_idle_share=1.0 - (g_ms + o_ms) / 1e3 / steady,
        bound_ms=(t_mm + t_attn + t_opt) * 1e3,
        bound_parts_ms=dict(matmuls=t_mm * 1e3, attention=t_attn * 1e3,
                            optimizer_bytes=t_opt * 1e3))
    print("# phase 13.3: " + json.dumps(info), flush=True)
    del loop, res, state
    gc.collect()
    torch.cuda.empty_cache()
    wall13 = time.perf_counter() - t_phase
    print(f"# phase 13: wall {wall13:.1f} s (13.1 {t13_2 - t_phase:.1f}, "
          f"13.2 {t13_3 - t13_2:.1f}, 13.3 {time.perf_counter() - t13_3:.1f})",
          flush=True)
    top = per[f"{TRAIN_ARCH} bfloat16"]
    return dict(name="flash_attention_bwd", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                replaces="src/repro/models/attention.py:251",
                launches=launches["flash_attention_bwd"],
                max_abs_err=bwd_err,
                **{k: top[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")},
                entry_layout=f"{TRAIN_ARCH} training bf16 (B 2, S 4096)",
                per_layout=per,
                path_launches={f"{TRAIN_ARCH} train": launches[
                    "flash_attention_bwd"]}), launches["flash_attention"]


def _sdpa_dv(q, k, v, do, scale):
    """``scaled_dot_product_attention``'s forward and backward ms on K5's
    inputs, through the first fused backend that takes a V head dimension
    below Q's (the math backend is the plain composition, no library
    kernel): ``(backend, forward ms, backward ms)``, or ``(None, reason,
    None)``."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def fwd(*x):
        return torch.nn.functional.scaled_dot_product_attention(
            *x, is_causal=True, scale=scale)
    reasons = {}
    for backend in [getattr(SDPBackend, n) for n in (
            "FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION")
            if hasattr(SDPBackend, n)]:
        try:
            with sdpa_kernel([backend]):
                fwd(q, k, v)
                xs = [t.detach().clone().requires_grad_() for t in (q, k, v)]
                o = fwd(*xs)
                torch.autograd.grad(o, xs, do, retain_graph=True)
                f_ms, _ = _replay_ms(fwd, [(q, k, v)], 3)
                b_ms, _ = _replay_ms(lambda: torch.autograd.grad(
                    o, xs, do, retain_graph=True), [()], 2)
            return backend.name, f_ms, b_ms
        except RuntimeError as err:
            reasons[backend.name] = str(err).splitlines()[0][:120]
    return None, reasons, None


def phase_mla_k5(ref, fa_mod):
    """14.1 K5 at deepseek-v2's prefill and training layout (MLA_LAYOUT:
    q and k 192 wide, v 128) in bf16 and f32: the forward with its LSE and
    the backward held against the plain versions one KV head at a time
    (the forward at rtol 1e-2 / atol 1e-3 in bf16 and 1e-4 in f32, the
    LSE within 1e-4, each gradient within 2e-2 or 1e-4 of its largest),
    each timed beside its bound (forward 2 (D + Dv) flops a pair,
    backward 2 (3 D + 2 Dv)) and ``scaled_dot_product_attention``'s; the
    backward launched twice (bitwise equal) on its route (``wgmma-tma``
    in bf16)."""
    t_phase = time.perf_counter()
    lay = MLA_LAYOUT
    b, h, hkv, s, d, dv = (lay[k] for k in ("b", "h", "hkv", "s", "d", "dv"))
    g = torch.Generator(device="cuda").manual_seed(14)
    base = [torch.randn(sh, generator=g, device="cuda") for sh in
            ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, dv), (b, h, s, dv))]
    kw = dict(causal=lay["causal"], window=0, softcap=0.0, scale=d ** -0.5)
    fwd, bwd, errs = {}, {}, {"fwd": [], "bwd": []}
    for dt in (torch.bfloat16, torch.float32):
        name = f"deepseek-v2-236b MLA {str(dt).replace('torch.', '')}"
        q, k, v, do = (t.to(dt) for t in base)
        out, lse = fa_mod._launch(q, k, v, True, 0, 0.0, kw["scale"],
                                  with_lse=True)
        if out.shape != (b, h, s, dv):
            raise AssertionError(f"K5 at Dv {dv}: output {out.shape}")
        exp, lse_exp = _fwd_plain_sliced(ref, q, k, v, kw)
        rtol, atol = (1e-2, 1e-3) if dt == torch.bfloat16 else (1e-4, 1e-4)
        f_err, f_rel = _attn_close(out, exp, rtol, atol, f"K5 {name}")
        lse_err = float((lse - lse_exp).abs().max())
        if not bool(((lse - lse_exp).abs()
                     <= 1e-4 + 1e-5 * lse_exp.abs()).all()):
            raise AssertionError(f"K5 LSE {name}: max abs err {lse_err}")
        del exp, lse_exp
        got, route = _bwd_twice(fa_mod, (q, k, v, out, lse, do), kw, dt,
                                name)
        exp = _bwd_plain_sliced(ref, q, k, v, out, lse, do, kw)
        b_err = {}
        for gname, a, e in zip(("dq", "dk", "dv"), got, exp):
            e_max = float(e.float().abs().max())
            b_err[gname] = float((a.float() - e.float()).abs().max())
            if a.shape != e.shape or b_err[gname] > BWD_TOL[dt] * e_max:
                raise AssertionError(
                    f"K5 backward {name} {gname}: max abs err "
                    f"{b_err[gname]} above {BWD_TOL[dt]} x {e_max}")
        errs["fwd"].append(f_err)
        errs["bwd"] += list(b_err.values())
        del got, exp
        f_ms, f_wall = _replay_ms(lambda *x: fa_mod._launch(
            *x, True, 0, 0.0, kw["scale"], with_lse=True), [(q, k, v)], 3)
        f_plain, _ = _replay_ms(lambda *x: _fwd_plain_sliced(ref, *x, kw),
                                [(q, k, v)], 1)
        b_ms, b_wall = _replay_ms(lambda *x: fa_mod.flash_attention_bwd(
            *x, **kw), [(q, k, v, out, lse, do)], 2)
        b_plain, _ = _replay_ms(lambda *x: _bwd_plain_sliced(ref, *x, kw),
                                [(q, k, v, out, lse, do)], 1)
        backend, lib_f, lib_b = _sdpa_dv(q, k, v, do, kw["scale"])
        f_bound, f_by = _fwd_bound(lay, dt, lse=True)
        b_bound, b_by = _bwd_bound(lay, dt)
        shape = dict(b=b, h=h, hkv=hkv, s=s, d=d, dv=dv, causal=True)
        fwd[name] = dict(
            shape=shape, ms=f_ms, wall_ms=f_wall, plain_ms=f_plain,
            bound_ms=f_bound, bound_by=f_by, library_ms=lib_f if backend else None,
            library=backend or f"none: {lib_f}", with_lse=True,
            max_abs_err=f_err, rel_frobenius_err=f_rel,
            lse_max_abs_err=lse_err)
        bwd[name] = dict(
            shape=shape, ms=b_ms, wall_ms=b_wall, plain_ms=b_plain,
            bound_ms=b_bound, bound_by=b_by,
            library_ms=lib_b if backend else None,
            library=backend or f"none: {lib_f}", max_abs_err=b_err,
            route=route,
            split=_bwd_split(fa_mod, (q, k, v, out, lse, do), kw))
        print(f"# phase 14.1 K5 forward {name}: " + json.dumps(fwd[name]),
              flush=True)
        print(f"# phase 14.1 K5 backward {name}: " + json.dumps(bwd[name]),
              flush=True)
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()
    print(f"# phase 14.1: wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return fwd, bwd, max(errs["fwd"]), max(errs["bwd"])


def _route_recorder(moe_mod, chosen):
    """Wrap ``moe.route``: every call's chosen experts (T, k) appended to
    ``chosen``."""
    def wrap(fn):
        def call(*a, **kw):
            out = fn(*a, **kw)
            chosen.append(out[1].detach())
            return out
        return call
    return _patched(moe_mod, "route", wrap)


def _range_split(fn, ranges):
    """One ``fn()`` under ``torch.profiler`` with each ``(module, attr,
    name)`` of ``ranges`` in a ``record_function`` range: device ms of
    K5 (its kernels' names), of each range (its kernels and its
    children's, products included), of cuBLAS outside the ranges (the
    products' kernels' names) and of the rest of the device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def ranged(name):
        def wrap(f):
            def call(*a, **kw):
                with record_function(name):
                    return f(*a, **kw)
            return call
        return wrap
    names = {name for _, _, name in ranges}
    with contextlib.ExitStack() as stack:
        for module, attr, name in ranges:
            stack.enter_context(_patched(module, attr, ranged(name)))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    events = prof.events()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    def is_mm(name):
        return any(m in name.lower() for m in _CUBLAS)

    def mm_inside(e):
        return sum(k.duration for k in e.kernels if is_mm(k.name)) + sum(
            mm_inside(c) for c in e.cpu_children)
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.name not in names]
    total = sum(dev_us(e) for e in kernels) / 1e3
    split = {"k5": sum(dev_us(e) for e in kernels
                       if "flash" in e.name) / 1e3}
    inside = 0.0
    for name in names:
        tops = [e for e in events if e.device_type == DeviceType.CPU
                and e.name == name]
        split[name] = sum(e.device_time_total for e in tops) / 1e3
        inside += sum(mm_inside(e) for e in tops) / 1e3
    split["cublas"] = sum(dev_us(e) for e in kernels
                          if is_mm(e.name)) / 1e3 - inside
    split["rest"] = total - sum(split.values())
    return total, split, inside


def _moe_split(fn, moe_mod):
    """:func:`_range_split` of ``fn()`` with the router and the expert
    products in ranges."""
    return _range_split(fn, [(moe_mod, "route", "router"),
                             (moe_mod, "_expert_ffn_sorted", "experts")])


def _served(arch, cfg, n_prefill, per_step, LAUNCHES, reset_launches):
    """``cfg`` (``arch``'s widths) drawn on the card in f32 from the
    launcher's seed and served in bf16 through ``launch.serve``'s engine
    at the launcher's defaults, counts 0 before and read after: exactly
    ``n_prefill`` K5 launches a prefill and ``per_step`` a decode step;
    the requests' tokens in the vocabulary, the logits finite.  K5's
    first prefill call and layer 0's call at the first batch's last
    decode step are recorded (every K5 caller of the models patched).
    Returns the engine, the launcher's arguments, those calls and the
    run's readings."""
    from repro_torch.dist.sharding import Runtime
    from repro_torch.launch import serve as launch
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import mla as mla_mod
    from repro_torch.models import model as model_mod
    from repro_torch.serve.engine import ServeConfig, ServingEngine

    args = launch.parse_args(["--arch", arch])   # the CLI's defaults
    rt = Runtime()
    sc = ServeConfig(batch=args.batch, max_len=args.max_len)
    n_batches = -(-args.n_requests // args.batch)
    want = n_batches * (n_prefill + args.max_new * per_step)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = model_mod.init_params(cfg, rt, gen, "cuda")
    n_params = sum(t.numel() for t in _leaves(params).values())
    eng = ServingEngine(cfg, rt, params, sc, device="cuda")
    del params
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    held = sum(t.numel() * t.element_size()
               for t in _leaves(eng.params).values())
    times = {"prefill": [], "decode": []}
    lgs = []
    _serve_timed(eng, times, lgs)
    calls = {}
    rec = _k5_recorder(calls, per_step * (args.max_new - 1))
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with _patched(attn_mod, "flash_attention", rec), \
            _patched(mla_mod, "flash_attention", rec):
        outs = launch.serve_requests(eng, cfg.vocab, args.n_requests,
                                     args.max_new, args.seed,
                                     log=lambda line: None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    serve_peak = torch.cuda.max_memory_allocated()
    _need_launches(launches, ("flash_attention",), f"{arch} serve",
                   exactly=want)
    if len(outs) != args.n_requests or any(
            len(o) != args.max_new + 1 or not all(0 <= t < cfg.vocab
                                                   for t in o)
            for o in outs):
        raise AssertionError(f"{arch} serve: unexpected outputs {outs}")
    if not all(bool(torch.isfinite(lg).all()) for lg in lgs):
        raise AssertionError(f"{arch} serve: logits not finite")
    recorded = {"prefill"} if n_prefill else set()
    if set(calls) != recorded | ({"decode"} if per_step else set()):
        raise AssertionError(f"{arch} serve: K5 calls recorded "
                             f"{sorted(calls)}")
    decode_s = times["decode"]
    tokens = args.n_requests * (args.max_new + 1)
    info = dict(
        batch=args.batch, max_len=args.max_len,
        n_requests=args.n_requests, max_new=args.max_new, seed=args.seed,
        params_reckoned=cfg.param_count(), params_drawn=n_params,
        init_s=init_s, init_peak_gb=init_peak / 1e9,
        held_weights_gb=held / 1e9, serve_peak_gb=serve_peak / 1e9,
        wall_s=wall, tokens_per_s=tokens / wall,
        prefill_ms=[t * 1e3 for t in times["prefill"]],
        decode_ms_per_step=1e3 * sum(decode_s) / len(decode_s),
        decode_ms_min=1e3 * min(decode_s), decode_ms_max=1e3 * max(decode_s),
        decode_steps=len(decode_s), launches=launches,
        k5_launches_per_decode_step=per_step,
        all_weights_bound_ms=held / HBM_BYTES_PER_S * 1e3)
    return eng, args, calls, info


def _served_calls(ref, flash_attention, arch, calls, sub):
    """K5 on the served path's own recorded calls, as phase 12.2 reads
    yi-9b's."""
    per = {f"{arch} serve {what}": _k5_call_reading(ref, flash_attention,
                                                    calls[what], what)
           for what in sorted(calls)}
    if per:
        print(f"# phase {sub} K5 on the path's own calls: "
              + json.dumps(per), flush=True)
    return per


def _moe_serve(arch, ref, flash_attention, LAUNCHES, reset_launches):
    """14.2 / 14.3: ``arch`` at full width (n_layers MOE_SERVE_LAYERS)
    through :func:`_served` (K5 once a layer a prefill, and a decode step
    for olmoe; deepseek's absorbed decode launches none), one decode step
    profiled and split beside its bound; then K5 on the path's own
    calls."""
    from repro_torch import configs
    from repro_torch.models import moe as moe_mod

    cfg = dataclasses.replace(configs.get_config(arch),
                              n_layers=MOE_SERVE_LAYERS[arch])
    per_step = 0 if cfg.mla is not None else cfg.n_layers
    eng, args, calls, base = _served(arch, cfg, cfg.n_layers, per_step,
                                     LAUNCHES, reset_launches)
    last = torch.from_numpy(eng.last.astype(np.int64)).cuda()[:, None]
    n_keys = int(eng.cache["0"]["pos"][0]) + 1
    chosen = []

    def step():
        chosen.clear()   # a retaken reading replaces the last one's
        eng.decode(eng.params, eng.cache, last)
    with _route_recorder(moe_mod, chosen):
        device_ms, n_events, top = _profile(step, top_n=10 ** 6)
        bound, by, touched = _step_bound(cfg, eng.params, args.batch, 1,
                                         n_keys, chosen=chosen)
    experts_used = [int(torch.unique(c).numel()) for c in chosen]
    split_ms, split, _ = _moe_split(step, moe_mod)
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in _leaves(eng.cache).values() if t.is_cuda)
    full = configs.get_config(arch).n_layers
    info = dict(
        arch=arch, n_layers=cfg.n_layers,
        cut=None if cfg.n_layers == full
        else f"n_layers {full} -> {cfg.n_layers}", **base,
        active_params=cfg.active_param_count(),
        init_peak_reckoned_gb=6 * cfg.param_count() / 1e9,
        profiled_decode_step=dict(
            keys=n_keys, device_ms=device_ms, device_events=n_events,
            split_ms=split, split_total_ms=split_ms,
            experts_used_per_layer=experts_used, top=top[:10]),
        decode_bound_ms=bound, decode_bound_by=by,
        touched_weight_gb=touched / 1e9, cache_gb=cache_bytes / 1e9)
    if cfg.mla is not None:
        m = cfg.mla
        info["dense_kv_cache_gb"] = (cfg.n_layers * args.batch * args.max_len
                                     * cfg.n_heads
                                     * (m.nope_dim + m.rope_dim + m.v_dim)
                                     * 2 / 1e9)
    sub = f"14.{2 if cfg.mla is None else 3}"
    print(f"# phase {sub}: " + json.dumps(info), flush=True)
    del eng, last
    gc.collect()
    torch.cuda.empty_cache()
    per = _served_calls(ref, flash_attention, arch, calls, sub)
    return base["launches"]["flash_attention"], per


def _decode_vs_prefill(arch, moe_mod):
    """14.4 ``arch`` at full width and 1 layer on the card: an 11-token
    prefill and one decode step give a 12-token forward's last logits, in
    f32 with an f32 cache and in bf16 with a bf16 cache; the share of
    (token, k) expert choices of the 12-token forward that agree between
    the two, printed, not gated."""
    from repro_torch import configs
    from repro_torch.dist.sharding import Runtime
    from repro_torch.models import model as model_mod

    rt = Runtime()
    cfg = dataclasses.replace(configs.get_config(arch), n_layers=1)
    c32 = dataclasses.replace(cfg, dtype="float32")
    params = model_mod.init_params(cfg, rt, torch.Generator(
        device="cuda").manual_seed(0), "cuda")
    b, s = 2, 12
    tk = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (b, s))).cuda()
    errs, choices = {}, {}
    for c, dt, tol in ((c32, torch.float32, 2e-2),
                       (cfg, torch.bfloat16, SERVE_BF16_TOL)):
        p = params if dt == torch.float32 else model_mod.cast_params(params,
                                                                     c)
        chosen = []
        with torch.no_grad():
            with _route_recorder(moe_mod, chosen):
                full, _ = model_mod.forward(p, c, rt, {"tokens": tk})
            choices[str(dt)] = chosen[0]
            cache = model_mod.init_cache(c, rt, b, 32, dt, device="cuda")
            _, cache, _ = model_mod.forward(p, c, rt, {"tokens": tk[:, :-1]},
                                            cache=cache)
            step, _, _ = model_mod.forward(p, c, rt, {"tokens": tk[:, -1:]},
                                           cache=cache)
        full, step = full[:, -1].float(), step[:, 0].float()
        errs[str(dt)] = float((step - full).abs().max())
        if not bool(((step - full).abs() <= tol * full.abs() + tol).all()):
            raise AssertionError(f"{arch} {dt}: decode does not match "
                                 f"prefill (max abs err {errs[str(dt)]})")
        del p, full, step, cache
    a, f = choices["torch.bfloat16"], choices["torch.float32"]
    agree = sum(len(set(x.tolist()) & set(y.tolist()))
                for x, y in zip(a, f)) / a.numel()
    del params
    torch.cuda.empty_cache()
    return dict(max_abs_err=errs, expert_choices_agree_bf16_f32=agree,
                tokens=int(a.shape[0]), top_k=int(a.shape[1]))


def _block_grads(LAUNCHES, reset_launches):
    """14.5 The two new blocks at full width in f32, card against the CPU
    port from host-drawn weights: deepseek-v2's MLA attention block (B 1,
    S MLA_GRAD_SEQ) and olmoe-1b-7b's MoE block with its aux
    (MOE_GRAD_TOKENS tokens); the gradients of ``sum(out w)`` (+ 3 aux)
    with respect to every weight and the input, each leaf within 1e-4 of
    its largest; the chosen experts equal first.  Then ``remat="full"``
    against ``"none"`` bitwise on the card, olmoe at 1 layer."""
    from repro_torch import configs
    from repro_torch.dist.sharding import Runtime
    from repro_torch.models import common, mla, moe
    from repro_torch.models import model as model_mod
    from repro_torch.train import optimizer as topt
    from repro_torch.train import train_step as tts

    rt = Runtime()
    rng = np.random.default_rng(5)
    out = {}

    def grads(fn, params, x, w, dev):
        p = topt.tree_map(lambda t: t.to(dev).requires_grad_(), params)
        xd = torch.from_numpy(x).to(dev).requires_grad_()
        y, extra = fn(p, xd)
        scalar = torch.sum(y * torch.from_numpy(w).to(dev)) + 3.0 * extra
        return torch.autograd.grad(scalar, topt.tree_leaves(p) + [xd])

    # MLA.
    cfg = dataclasses.replace(configs.get_config("deepseek-v2-236b"),
                              dtype="float32")
    host = mla.mla_init(cfg, torch.Generator().manual_seed(0),
                        device="cpu")
    x = rng.standard_normal((1, MLA_GRAD_SEQ, cfg.d_model)).astype(
        np.float32)
    w = rng.standard_normal((1, MLA_GRAD_SEQ, cfg.d_model)).astype(
        np.float32)

    def mla_fn(p, xd):
        pos = torch.arange(MLA_GRAD_SEQ, device=xd.device)[None]
        rope = common.rope_tables(pos, cfg.mla.rope_dim, cfg.rope_theta)
        return mla.mla_apply(p, cfg, rt, xd, rope)[0], 0.0
    reset_launches()
    g_card = grads(mla_fn, host, x, w, "cuda")
    launched = dict(LAUNCHES)
    g_cpu = grads(mla_fn, host, x, w, "cpu")
    if launched["flash_attention"] != 1 or \
            launched["flash_attention_bwd"] != 1:
        raise AssertionError(f"14.5 MLA block launched K5 {launched}")
    gaps, worst = _grad_gap(g_card, g_cpu)
    if worst > 1e-4:
        raise AssertionError(f"14.5 MLA block: gradient leaf gaps {gaps}")
    out["mla"] = dict(seq=MLA_GRAD_SEQ, leaves=len(gaps),
                      worst_gradient_leaf_gap=worst)
    del host, g_card, g_cpu

    # MoE.
    cfg = dataclasses.replace(configs.get_config("olmoe-1b-7b"),
                              dtype="float32")
    host = moe.moe_init(cfg, torch.Generator().manual_seed(1), device="cpu")
    x = rng.standard_normal((1, MOE_GRAD_TOKENS, cfg.d_model)).astype(
        np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    xh = torch.from_numpy(x).reshape(-1, cfg.d_model)
    ti_card = moe.route(xh.cuda(), host["router"].cuda(), cfg)[1].cpu()
    ti_cpu = moe.route(xh, host["router"], cfg)[1]
    if not torch.equal(ti_card, ti_cpu):
        raise AssertionError("14.5 MoE block: the chosen experts differ "
                             "between the card and the CPU port")

    def moe_fn(p, xd):
        return moe.moe_apply(p, cfg, rt, xd)
    g_card = grads(moe_fn, host, x, w, "cuda")
    t0 = time.perf_counter()
    g_cpu = grads(moe_fn, host, x, w, "cpu")
    cpu_s = time.perf_counter() - t0
    gaps, worst = _grad_gap(g_card, g_cpu)
    if worst > 1e-4:
        raise AssertionError(f"14.5 MoE block: gradient leaf gaps {gaps}")
    out["moe"] = dict(tokens=MOE_GRAD_TOKENS, leaves=len(gaps),
                      worst_gradient_leaf_gap=worst,
                      experts_used=int(torch.unique(ti_cpu).numel()),
                      cpu_port_s=cpu_s)
    del host, g_card, g_cpu

    # remat full against none, olmoe at full width and 1 layer.
    c1 = dataclasses.replace(cfg, n_layers=1, remat="none")
    params = model_mod.init_params(c1, rt, torch.Generator(
        device="cuda").manual_seed(2), "cuda")
    tok = torch.from_numpy(rng.integers(0, c1.vocab, (1, 128))).cuda()
    runs = {r: tts.loss_and_grads(params, dataclasses.replace(c1, remat=r),
                                  rt, {"tokens": tok, "labels": tok})
            for r in ("none", "full")}
    if not torch.equal(runs["none"][0], runs["full"][0]) or not torch.equal(
            runs["none"][1]["aux"], runs["full"][1]["aux"]) or not all(
            torch.equal(a, b) for a, b in zip(
                topt.tree_leaves(runs["none"][2]),
                topt.tree_leaves(runs["full"][2]))):
        raise AssertionError("14.5: remat='full' differs from remat='none' "
                             "on the card (olmoe, 1 layer)")
    out["remat_full_equals_none"] = True
    out["remat_aux"] = float(runs["full"][1]["aux"])
    del params, runs
    torch.cuda.empty_cache()
    return out


def _moe_train(ref, LAUNCHES, reset_launches):
    """14.6 olmoe-1b-7b at full width and MOE_TRAIN_LAYERS layers through
    ``TrainLoop`` (phase 13.3's batch, steps, compute and remat), counts 0
    before and read after: K5 forward twice a layer a step (forward and
    recompute), backward once, no plain-version call, finite losses, aux
    and grad norms; one more step profiled beside its bound."""
    from repro_torch import configs
    from repro_torch.models import moe as moe_mod

    cfg = dataclasses.replace(configs.get_config(MOE_TRAIN_ARCH),
                              n_layers=MOE_TRAIN_LAYERS)
    loop, res, run_s, launches, peak, plain_calls = _loop_run(
        cfg, ref, LAUNCHES, reset_launches)
    hist = res["history"]
    walls = [h["wall_s"] for h in hist]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    state = res["state"]
    grad_pass, (g_ms, g_events, g_top), (o_ms, o_events, o_top) = \
        _profiled_step(loop, state, cfg)
    _, moe_split, _ = _moe_split(grad_pass, moe_mod)
    split = _step_split(g_top)
    split["optimizer"] = o_ms
    n_all = sum(t.numel() for t in _leaves(state["params"]).values())
    active = cfg.active_param_count()
    t_mm = 6.0 * active * tokens / BF16_FLOP_PER_S
    t_opt = 26.0 * n_all / HBM_BYTES_PER_S
    steady = float(np.median(walls[1:]))
    info = dict(
        arch=MOE_TRAIN_ARCH, n_layers=MOE_TRAIN_LAYERS,
        cut=f"n_layers 16 -> {MOE_TRAIN_LAYERS}", batch=TRAIN_BATCH,
        seq=TRAIN_SEQ, steps=TRAIN_STEPS, params=n_all,
        params_reckoned=cfg.param_count(), active_params=active,
        dtype=cfg.dtype, param_dtype=cfg.param_dtype, remat=cfg.remat,
        losses=[h["loss"] for h in hist], aux=[h["aux"] for h in hist],
        grad_norms=[h["grad_norm"] for h in hist], step_wall_s=walls,
        steady_step_s=steady, tokens_per_s=tokens / steady, run_s=run_s,
        peak_gb=peak / 1e9, peak_reckoned_gb=16 * n_all / 1e9,
        launches={k: launches[k] for k in ("flash_attention",
                                            "flash_attention_bwd")},
        plain_calls=plain_calls,
        profiled_step=dict(device_ms=g_ms + o_ms, events=g_events + o_events,
                           split_ms=split, moe_split_ms=moe_split,
                           optimizer_events=o_events,
                           top=g_top[:12] + o_top[:4]),
        device_idle_share=1.0 - (g_ms + o_ms) / 1e3 / steady,
        bound_ms=(t_mm + t_opt) * 1e3,
        bound_parts_ms=dict(six_n_t=t_mm * 1e3, optimizer_bytes=t_opt * 1e3,
                            remat_recompute=t_mm / 3 * 1e3))
    print("# phase 14.6: " + json.dumps(info), flush=True)
    del loop, res, state
    gc.collect()
    torch.cuda.empty_cache()
    return launches, info


def phase_moe(ref, fa_mod, LAUNCHES, reset_launches):
    """14. The mixture-of-experts family on the card (see the constants
    above and the module docstring)."""
    from repro_torch.models import moe as moe_mod

    t = [time.perf_counter()]
    fwd, bwd, f_err, b_err = phase_mla_k5(ref, fa_mod)
    t.append(time.perf_counter())
    serve, serve_k5 = {}, {}
    for arch in MOE_ARCHS:
        serve[arch], per = _moe_serve(arch, ref, fa_mod.flash_attention,
                                      LAUNCHES, reset_launches)
        serve_k5.update(per)
        t.append(time.perf_counter())
    dvp = {arch: _decode_vs_prefill(arch, moe_mod) for arch in MOE_ARCHS}
    print(f"# phase 14.4: at full width and 1 layer, an 11-token prefill "
          f"and one decode step give the 12-token forward's last logits "
          f"on the card, f32 (f32 cache) within rtol = atol = 2e-2 and "
          f"bf16 (bf16 cache) within {SERVE_BF16_TOL}: " + json.dumps(dvp),
          flush=True)
    t.append(time.perf_counter())
    grads = _block_grads(LAUNCHES, reset_launches)
    print("# phase 14.5: the MLA and MoE blocks' gradients at full width "
          "in f32, card against the CPU port, each leaf within 1e-4 of its "
          "largest; remat full bitwise none on the card: "
          + json.dumps(grads), flush=True)
    t.append(time.perf_counter())
    train_launches, _ = _moe_train(ref, LAUNCHES, reset_launches)
    t.append(time.perf_counter())
    parts = np.diff(t).tolist()
    print(f"# phase 14: wall {t[-1] - t[0]:.1f} s (14.1 {parts[0]:.1f}, "
          f"14.2 {parts[1]:.1f}, 14.3 {parts[2]:.1f}, 14.4 {parts[3]:.1f}, "
          f"14.5 {parts[4]:.1f}, 14.6 {parts[5]:.1f})", flush=True)
    return dict(fwd=fwd, bwd=bwd, fwd_err=f_err, bwd_err=b_err,
                serve=serve, serve_k5=serve_k5, train=train_launches)


# Phase 15, the recurrent families (src/repro/configs/zamba2_1p2b.py and
# rwkv6_7b.py, arXiv:2411.15242 and 2404.05892).  K5 at zamba2's shared
# attention block's training layout: 32 heads of 64 (MHA), causal, window
# 4096 at S 4096 (the window covers every causal pair there, so SDPA's
# ``is_causal`` computes the same function).  zamba2-1.2b served uncut
# (38 layers: 2 repeats of 18 Mamba2 blocks and the shared block; 1.118e9
# parameters) and rwkv6-7b uncut (32 layers, 7.53e9), drawn on the card
# in f32 and served in bf16 at the launcher's defaults.  At full width and
# short depth (zamba2 one repeat, 19 layers, the least its pattern
# allows; rwkv6 2 layers) in f32 with an f32 cache: the card against the
# CPU port at rtol 1e-4, atol 1e-4 max|exp| (the f32 K5 holds 1e-4 to
# the plain version; cuBLAS and the CPU sum in other orders), and decode
# against prefill on the card (f32 2e-2, bf16 0.1; zamba2 primes its
# state from a 600-token prefill, above 2 x 256: ``ssd_chunked`` and an
# ``ssd_scan`` for the state).  The m, shared a and r blocks' gradients
# at full width in f32, card against the CPU port, each leaf within 1e-4
# of its largest (m at S 600: ``ssd_chunked`` with a padded last chunk).
# zamba2 trained uncut (1.118e9 x 16 B = 18 GB of f32 weights, gradients
# and AdamW moments), rwkv6-7b with n_layers cut from 32 to 2, the one
# cut (7.53e9 x 16 B = 121 GB at full depth; 2 layers 0.97e9): phase
# 13.3's batch and compute, 4 and 3 steps; zamba2 at 2 x 4096 tokens,
# rwkv6 at 2 x 512 (its step is about 10^5 eager launches of the
# sequential WKV scan at S 4096, 7.4 s a step; at S 1024, 32 000
# device events, 15.7 took 58.6 s on the card's host, 5.4 of them its
# three steps), its steps and its profiled step alike.
REC_ARCHS = ("zamba2-1.2b", "rwkv6-7b")
ZAMBA_K5_LAYOUT = dict(b=2, h=32, hkv=32, s=4096, d=64, causal=True,
                       window=4096, softcap=0.0)
REC_SHORT_LAYERS = {"zamba2-1.2b": 19, "rwkv6-7b": 2}
REC_PREFILL = {"zamba2-1.2b": 600, "rwkv6-7b": 64}
SSM_GRAD_SEQ, SHARED_GRAD_SEQ, RWKV_GRAD_SEQ = 600, 64, 64
# layers, steps, tokens a row
REC_TRAIN = {"zamba2-1.2b": (38, 4, 4096), "rwkv6-7b": (2, 3, 512)}
# Leaves read as matrices in a product (the rest are vectors, token-shift
# mixes, the conv's taps, RWKV6's bonus: elementwise).
MM_LEAVES = frozenset({"in_proj", "out_proj", "wq", "wk", "wv", "wo", "wi",
                       "wr", "wg", "wa", "wb", "w"})


def _attn_blocks(cfg):
    """K5's launches a forward: the g, l and a positions times the
    repeats."""
    return sum(ch in "gla" for ch in cfg.layer_pattern) * cfg.pattern_repeats


def phase_zamba_k5(ref, fa_mod):
    """15.1 K5 at ZAMBA_K5_LAYOUT in bf16 (the tensor-core kernels) and
    f32: the forward with its LSE and the backward held against the plain
    versions one KV head at a time (13.1's tolerances), each timed beside
    its bound (4 D flops a pair forward, 10 D backward) and
    ``scaled_dot_product_attention(is_causal=True)``'s forward and
    backward; the backward launched twice (bitwise equal) on its route
    (``wgmma-tma`` in bf16, the CUDA cores in f32)."""
    t_phase = time.perf_counter()
    lay = ZAMBA_K5_LAYOUT
    b, h, hkv, s, d = (lay[k] for k in ("b", "h", "hkv", "s", "d"))
    g = torch.Generator(device="cuda").manual_seed(15)
    base = [torch.randn(sh, generator=g, device="cuda") for sh in
            ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d), (b, h, s, d))]
    kw = dict(causal=True, window=lay["window"], softcap=0.0,
              scale=d ** -0.5)
    fwd, bwd, errs = {}, {}, {"fwd": [], "bwd": []}

    def sdpa(*x):
        return torch.nn.functional.scaled_dot_product_attention(
            *x, is_causal=True, scale=kw["scale"])
    for dt in (torch.bfloat16, torch.float32):
        name = f"zamba2-1.2b shared block {str(dt).replace('torch.', '')}"
        q, k, v, do = (t.to(dt) for t in base)
        out, lse = fa_mod._launch(q, k, v, True, lay["window"], 0.0,
                                  kw["scale"], with_lse=True)
        exp, lse_exp = _fwd_plain_sliced(ref, q, k, v, kw)
        rtol, atol = (1e-2, 1e-3) if dt == torch.bfloat16 else (1e-4, 1e-4)
        f_err, f_rel = _attn_close(out, exp, rtol, atol, f"K5 {name}")
        lse_err = float((lse - lse_exp).abs().max())
        if not bool(((lse - lse_exp).abs()
                     <= 1e-4 + 1e-5 * lse_exp.abs()).all()):
            raise AssertionError(f"K5 LSE {name}: max abs err {lse_err}")
        del exp, lse_exp
        got, route = _bwd_twice(fa_mod, (q, k, v, out, lse, do), kw, dt,
                                name)
        exp = _bwd_plain_sliced(ref, q, k, v, out, lse, do, kw)
        b_err = {}
        for gname, a, e in zip(("dq", "dk", "dv"), got, exp):
            e_max = float(e.float().abs().max())
            b_err[gname] = float((a.float() - e.float()).abs().max())
            if b_err[gname] > BWD_TOL[dt] * e_max:
                raise AssertionError(
                    f"K5 backward {name} {gname}: max abs err "
                    f"{b_err[gname]} above {BWD_TOL[dt]} x {e_max}")
        errs["fwd"].append(f_err)
        errs["bwd"] += list(b_err.values())
        del got, exp
        f_ms, f_wall = _replay_ms(lambda *x: fa_mod._launch(
            *x, True, lay["window"], 0.0, kw["scale"], with_lse=True),
            [(q, k, v)], 3)
        f_plain, _ = _replay_ms(lambda *x: _fwd_plain_sliced(ref, *x, kw),
                                [(q, k, v)], 1)
        b_ms, b_wall = _replay_ms(lambda *x: fa_mod.flash_attention_bwd(
            *x, **kw), [(q, k, v, out, lse, do)], 2)
        b_plain, _ = _replay_ms(lambda *x: _bwd_plain_sliced(ref, *x, kw),
                                [(q, k, v, out, lse, do)], 1)
        lib_f, _ = _replay_ms(sdpa, [(q, k, v)], 3)
        xs = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        o = sdpa(*xs)
        lib_b, _ = _replay_ms(lambda: torch.autograd.grad(
            o, xs, do, retain_graph=True), [()], 2)
        del xs, o
        f_bound, f_by = _fwd_bound(lay, dt, lse=True)
        b_bound, b_by = _bwd_bound(lay, dt)
        shape = dict(b=b, h=h, hkv=hkv, s=s, d=d, causal=True,
                     window=lay["window"])
        fwd[name] = dict(
            shape=shape, ms=f_ms, wall_ms=f_wall, plain_ms=f_plain,
            bound_ms=f_bound, bound_by=f_by, library_ms=lib_f,
            with_lse=True, max_abs_err=f_err, rel_frobenius_err=f_rel,
            lse_max_abs_err=lse_err)
        bwd[name] = dict(
            shape=shape, ms=b_ms, wall_ms=b_wall, plain_ms=b_plain,
            bound_ms=b_bound, bound_by=b_by, library_ms=lib_b,
            max_abs_err=b_err, route=route,
            split=_bwd_split(fa_mod, (q, k, v, out, lse, do), kw))
        print(f"# phase 15.1 K5 forward {name}: " + json.dumps(fwd[name]),
              flush=True)
        print(f"# phase 15.1 K5 backward {name}: " + json.dumps(bwd[name]),
              flush=True)
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()
    print(f"# phase 15.1: wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return fwd, bwd, max(errs["fwd"]), max(errs["bwd"])


def _rec_step_bound(cfg, params, cache, b, n_keys):
    """Least ms of one decode step of ``b`` rows, what bounds it, and its
    bytes: every weight read once (the embedding at its ``b`` rows; the
    shared block once an application), the caches' f32 states, conv
    windows and boundary tokens read and written once, the shared
    block's live K and V (``n_keys`` a row) read at each application,
    the logits written in bf16; 2 operations a product weight and row at
    the bf16 rate."""
    apps = cfg.layer_pattern.count("a") * cfg.pattern_repeats
    nbytes = mm = 0
    for path, t in _leaves(params).items():
        reads = apps if path.startswith("/shared_attn") else 1
        if path == "/embed/tok":
            nbytes += b * t.shape[1] * t.element_size()
            continue
        nbytes += reads * t.numel() * t.element_size()
        if path.rsplit("/", 1)[-1] in MM_LEAVES:
            mm += reads * t.numel()
    for path, t in _leaves(cache).items():
        leaf = path.rsplit("/", 1)[-1]
        if leaf in ("k", "v"):
            nbytes += t.shape[0] * b * n_keys * t.shape[-2] * t.shape[-1] \
                * t.element_size()
        elif t.is_cuda:
            nbytes += 2 * t.numel() * t.element_size()
    nbytes += b * cfg.vocab * 2
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2.0 * b * mm / BF16_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes


def _rec_ranges(arch):
    from repro_torch.models import rwkv as rwkv_mod
    from repro_torch.models import ssm as ssm_mod
    if arch == "rwkv6-7b":
        return [(rwkv_mod, "wkv_recurrence", "wkv recurrence")]
    return [(ssm_mod, "_causal_conv", "ssm conv"),
            (ssm_mod, "ssd_scan", "ssm scan"),
            (ssm_mod, "ssd_chunked", "ssm chunked")]


def _rec_serve(arch, ref, flash_attention, LAUNCHES, reset_launches):
    """15.2 / 15.3: ``arch`` uncut through :func:`_served` (K5 once an
    attention block a forward: zamba2 68 times, rwkv6 never), one decode
    step profiled and split (K5, cuBLAS, the recurrent blocks' scan and
    conv or the WKV recurrence, the rest) beside its bound; then K5 on
    the path's own calls."""
    from repro_torch import configs

    cfg = configs.get_config(arch)
    per_step = _attn_blocks(cfg)
    eng, args, calls, base = _served(arch, cfg, per_step, per_step,
                                     LAUNCHES, reset_launches)
    last = torch.from_numpy(eng.last.astype(np.int64)).cuda()[:, None]
    pos = [c["pos"] for c in eng.cache.values() if "pos" in c]
    n_keys = int(pos[0][0]) + 1 if pos else 0

    def step():
        eng.decode(eng.params, eng.cache, last)
    device_ms, n_events, top = _profile(step, top_n=10 ** 6)
    split_ms, split, mm_in_ranges = _range_split(step, _rec_ranges(arch))
    bound, by, nbytes = _rec_step_bound(cfg, eng.params, eng.cache,
                                        args.batch, n_keys)
    state_bytes = sum(t.numel() * t.element_size()
                      for p, t in _leaves(eng.cache).items()
                      if t.is_cuda
                      and p.rsplit("/", 1)[-1] not in ("k", "v"))
    info = dict(
        arch=arch, n_layers=cfg.n_layers, cut=None, **base,
        profiled_decode_step=dict(
            keys=n_keys, device_ms=device_ms, device_events=n_events,
            split_ms=split, split_total_ms=split_ms,
            cublas_inside_ranges_ms=mm_in_ranges, top=top[:10]),
        decode_bound_ms=bound, decode_bound_by=by,
        decode_bound_gb=nbytes / 1e9, recurrent_state_gb=state_bytes / 1e9)
    sub = "15.2" if arch == "zamba2-1.2b" else "15.3"
    print(f"# phase {sub}: " + json.dumps(info), flush=True)
    del eng, last
    gc.collect()
    torch.cuda.empty_cache()
    per = _served_calls(ref, flash_attention, arch, calls, sub)
    return base["launches"]["flash_attention"], per


def _rec_short(arch):
    """15.4 ``arch`` at full width and REC_SHORT_LAYERS layers from
    weights drawn on the card: in f32 with an f32 cache, the CPU port's
    prefill and 16 decode steps teacher-forced on the card, every step's
    logits within rtol 1e-4, atol 1e-4 max|exp| of the CPU port's; then
    on the card a REC_PREFILL-token prefill and one decode step against
    the forward's last logits, f32 (f32 cache) within 2e-2 and bf16 (bf16
    cache) within 0.1."""
    from repro_torch import configs
    from repro_torch.dist.sharding import Runtime
    from repro_torch.launch import serve as launch
    from repro_torch.models import model as model_mod
    from repro_torch.serve.engine import ServeConfig, ServingEngine
    from repro_torch.train import optimizer as topt

    args = launch.parse_args(["--arch", arch])
    rt = Runtime()
    cfg = dataclasses.replace(configs.get_config(arch),
                              n_layers=REC_SHORT_LAYERS[arch])
    c32 = dataclasses.replace(cfg, dtype="float32")
    card = model_mod.init_params(c32, rt, torch.Generator(
        device="cuda").manual_seed(args.seed), "cuda")
    host = topt.tree_map(lambda t: t.cpu(), card)
    sc = ServeConfig(batch=args.batch, max_len=args.max_len,
                     cache_dtype="float32")
    eng_c = ServingEngine(c32, rt, host, sc, device="cpu")
    eng_g = ServingEngine(c32, rt, card, sc, device="cuda")
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(1, cfg.vocab, size=rng.integers(2, 9))
               for _ in range(args.batch)]
    cpu_logits, cpu_fed = [], []
    pre_c, dec_c = eng_c.prefill, eng_c.decode

    def rec_prefill(params, batch):
        lg, cache = pre_c(params, batch)
        cpu_logits.append(lg.float())
        return lg, cache

    def rec_decode(params, cache, toks):
        cpu_fed.append(toks)
        nxt, lg, cache = dec_c(params, cache, toks)
        cpu_logits.append(lg)
        return nxt, lg, cache
    eng_c.prefill, eng_c.decode = rec_prefill, rec_decode
    t0 = time.perf_counter()
    eng_c.run(prompts, max_new=args.max_new)
    cpu_s = time.perf_counter() - t0
    toks = np.zeros((args.batch, max(len(p) for p in prompts)), np.int64)
    for i, p in enumerate(prompts):
        toks[i, -len(p):] = p
    lg, cache = eng_g.prefill(eng_g.params,
                              {"tokens": torch.from_numpy(toks).cuda()})
    card_logits = [lg.float().cpu()]
    for fed in cpu_fed:
        _, lg, cache = eng_g.decode(eng_g.params, cache, fed.cuda())
        card_logits.append(lg.cpu())
    gaps = []
    for i, (g, c) in enumerate(zip(card_logits, cpu_logits)):
        gaps.append(float((g - c).abs().max() / c.abs().max()))
        if not bool(((g - c).abs() <= 1e-4 * c.abs()
                     + 1e-4 * c.abs().max()).all()):
            raise AssertionError(f"15.4 {arch} at {cfg.n_layers} layers, "
                                 f"step {i}: card vs CPU port gap {gaps}")
    del eng_c, eng_g, host, cache
    # Decode against prefill on the card.
    b, s = 2, REC_PREFILL[arch]
    tk = torch.from_numpy(np.random.default_rng(args.seed + 1).integers(
        0, cfg.vocab, (b, s + 1))).cuda()
    errs = {}
    with torch.no_grad():
        for c, dt, tol in ((c32, torch.float32, 2e-2),
                           (cfg, torch.bfloat16, SERVE_BF16_TOL)):
            p = card if dt == torch.float32 else model_mod.cast_params(card,
                                                                       c)
            full, _ = model_mod.forward(p, c, rt, {"tokens": tk})
            cache = model_mod.init_cache(c, rt, b, s + 8, dt, device="cuda")
            _, cache, _ = model_mod.forward(p, c, rt, {"tokens": tk[:, :-1]},
                                            cache=cache)
            step, _, _ = model_mod.forward(p, c, rt, {"tokens": tk[:, -1:]},
                                           cache=cache)
            full, step = full[:, -1].float(), step[:, 0].float()
            errs[str(dt)] = float((step - full).abs().max())
            if not bool(((step - full).abs()
                         <= tol * full.abs() + tol).all()):
                raise AssertionError(f"15.4 {arch} {dt}: decode does not "
                                     f"match a {s}-token prefill (max abs "
                                     f"err {errs[str(dt)]})")
            del p, full, step, cache
    del card
    torch.cuda.empty_cache()
    return dict(n_layers=cfg.n_layers, steps=len(card_logits),
                worst_step_gap=max(gaps), logits_max=float(max(
                    c.abs().max() for c in cpu_logits)),
                cpu_port_s=cpu_s, prefill=s, decode_vs_prefill=errs)


def _grads_of(fn, params, x, w, dev):
    """Gradients of ``sum(fn(params, x) w)`` with respect to every leaf
    of ``params`` (sorted) and ``x``, on ``dev``."""
    from repro_torch.train import optimizer as topt

    p = topt.tree_map(lambda t: t.to(dev).requires_grad_(), params)
    xd = torch.from_numpy(x).to(dev).requires_grad_()
    y = fn(p, xd)
    return torch.autograd.grad(torch.sum(y * torch.from_numpy(w).to(dev)),
                               topt.tree_leaves(p) + [xd])


def _rec_block_grads(LAUNCHES, reset_launches):
    """15.5 The m (S SSM_GRAD_SEQ, ``ssd_chunked``), shared a (applied
    twice, S SHARED_GRAD_SEQ) and r (S RWKV_GRAD_SEQ) blocks at full width
    in f32, card against the CPU port from weights drawn on the card:
    each gradient leaf (and the input's) within 1e-4 of its largest; then
    zamba2 at 19 layers on the card, ``remat="full"`` bitwise
    ``"none"``: K5 forward once an application under none, twice under
    full (the shared block's own checkpoint recomputes it; the unit's
    recompute stops at that block's input), backward once."""
    from repro_torch import configs
    from repro_torch.dist.sharding import Runtime
    from repro_torch.models import common, rwkv, ssm
    from repro_torch.models import model as model_mod
    from repro_torch.train import optimizer as topt
    from repro_torch.train import train_step as tts

    rt = Runtime()
    rng = np.random.default_rng(15)
    gen = torch.Generator(device="cuda").manual_seed(15)
    out = {}

    def held(what, fn, params, s, d, want_k5=0):
        x = rng.standard_normal((1, s, d)).astype(np.float32)
        w = rng.standard_normal((1, s, d)).astype(np.float32)
        reset_launches()
        g_card = _grads_of(fn, params, x, w, "cuda")
        launched = dict(LAUNCHES)
        t0 = time.perf_counter()
        g_cpu = _grads_of(fn, topt.tree_map(lambda t: t.cpu(), params), x,
                          w, "cpu")
        cpu_s = time.perf_counter() - t0
        if launched["flash_attention"] != want_k5 or \
                launched["flash_attention_bwd"] != want_k5:
            raise AssertionError(f"15.5 {what} launched K5 {launched}")
        gaps, worst = _grad_gap(g_card, g_cpu)
        if worst > 1e-4:
            raise AssertionError(f"15.5 {what}: gradient leaf gaps {gaps}")
        out[what] = dict(seq=s, leaves=len(gaps),
                         worst_gradient_leaf_gap=worst, leaf_gaps=gaps,
                         cpu_port_s=cpu_s)

    zcfg = dataclasses.replace(configs.get_config("zamba2-1.2b"),
                               dtype="float32", remat="none")
    d = zcfg.d_model
    bp = {"ln1": common.rmsnorm_init(d, device="cuda"),
          "ssm": ssm.ssm_init(zcfg, gen, device="cuda")}
    held("m", lambda p, xd: model_mod._apply_block(p, zcfg, rt, "m", xd,
                                                   None, None)[0],
         bp, SSM_GRAD_SEQ, d)
    shared = model_mod._shared_block_init(zcfg, gen, torch.float32, "cuda")

    def twice(p, xd):
        pos = torch.arange(xd.shape[1], device=xd.device)[None]
        rope = common.rope_tables(pos, zcfg.d_head, zcfg.rope_theta)
        for _ in range(2):
            xd = model_mod._apply_block({}, zcfg, rt, "a", xd, rope, None,
                                        p)[0]
        return xd
    held("a twice", twice, shared, SHARED_GRAD_SEQ, d, want_k5=2)
    del bp, shared
    rcfg = dataclasses.replace(configs.get_config("rwkv6-7b"),
                               dtype="float32")
    bp = {"ln1": common.rmsnorm_init(rcfg.d_model, device="cuda"),
          "ln2": common.rmsnorm_init(rcfg.d_model, device="cuda"),
          "rwkv": rwkv.rwkv_init(rcfg, gen, device="cuda")}
    held("r", lambda p, xd: model_mod._apply_block(p, rcfg, rt, "r", xd,
                                                   None, None)[0],
         bp, RWKV_GRAD_SEQ, rcfg.d_model)
    del bp

    c19 = dataclasses.replace(zcfg, n_layers=REC_SHORT_LAYERS["zamba2-1.2b"])
    params = model_mod.init_params(c19, rt, gen, "cuda")
    tok = torch.from_numpy(rng.integers(0, c19.vocab,
                                        (1, SSM_GRAD_SEQ))).cuda()
    runs, k5 = {}, {}
    for r in ("none", "full"):
        reset_launches()
        runs[r] = tts.loss_and_grads(params, dataclasses.replace(c19, remat=r),
                                     rt, {"tokens": tok, "labels": tok})
        k5[r] = (LAUNCHES["flash_attention"], LAUNCHES["flash_attention_bwd"])
    if k5 != {"none": (1, 1), "full": (2, 1)}:
        raise AssertionError(f"15.5 zamba2 remat: K5 launches {k5}")
    if not torch.equal(runs["none"][0], runs["full"][0]) or not all(
            torch.equal(a, b) for a, b in zip(
                topt.tree_leaves(runs["none"][2]),
                topt.tree_leaves(runs["full"][2]))):
        raise AssertionError("15.5: remat='full' differs from remat='none' "
                             "on the card (zamba2, 19 layers)")
    out["remat_full_equals_none"] = dict(n_layers=c19.n_layers,
                                         tokens=SSM_GRAD_SEQ, k5=k5)
    del params, runs
    torch.cuda.empty_cache()
    return out


def _train_split(top):
    """A gradient pass's device ms by kernel names: K5 forward and
    backward, cuBLAS's bf16 products and its f32 ones (the SSD's einsums,
    the only f32 products of these models), the rest."""
    split = _step_split(top)
    f32 = sum(ms for kname, ms, _ in top
              if any(m in kname.lower() for m in _CUBLAS)
              and any(m in kname.lower() for m in ("sgemm", "f32f32",
                                                   "fp32", "_sss")))
    split["cublas"] -= f32
    split["cublas_f32"] = f32
    return split


def _rec_train(arch, ref, LAUNCHES, reset_launches):
    """15.6 / 15.7 ``arch`` at REC_TRAIN's depth through ``TrainLoop``
    (phase 13.3's batch, compute and remat), counts 0 before and read
    after: K5 forward twice a shared-block application a step (its
    forward and its own checkpoint's recompute) and backward once (none
    for rwkv6), no plain-version call, finite losses and grad norms; one
    more step profiled at the same tokens a row beside
    its bound: the products at the bf16 rate (6 N T, plus a forward's 2 N
    T for each recompute: zamba2's Mamba2 blocks run three forwards
    under the nested checkpoints, its shared block two, rwkv6's blocks
    two, the embedding and LM head one), the SSD's f32 products at the
    f32 rate (cb, the intra-chunk product, the chunk states and the
    inter-chunk output; three forwards and a backward of twice a
    forward), K5's pairs (4 D forward twice, 10 D backward), the
    optimizer's 26 bytes a parameter."""
    from repro_torch import configs

    n_layers, steps, seq = REC_TRAIN[arch]
    cfg = dataclasses.replace(configs.get_config(arch), n_layers=n_layers)
    apps = cfg.layer_pattern.count("a") * cfg.pattern_repeats
    loop, res, run_s, launches, peak, plain_calls = _loop_run(
        cfg, ref, LAUNCHES, reset_launches, steps=steps,
        k5=(2 * apps, apps), seq=seq)
    hist = res["history"]
    walls = [h["wall_s"] for h in hist]
    state = res["state"]
    _, (g_ms, g_events, g_top), (o_ms, o_events, o_top) = _profiled_step(
        loop, state, cfg, steps=steps, seq=seq)
    split = _train_split(g_top)
    split["optimizer"] = o_ms
    t = TRAIN_BATCH * seq
    n_all = n_head = n_m = n_a = n_r = 0
    for path, x in _leaves(state["params"]).items():
        n_all += x.numel()
        if path.rsplit("/", 1)[-1] not in MM_LEAVES:
            continue
        if path == "/lm_head/w":
            n_head += x.numel()
        elif path.startswith("/shared_attn"):
            n_a += x.numel() * apps
        elif "/ssm/" in path:
            n_m += x.numel()
        else:
            n_r += x.numel()
    t_mm = (10.0 * n_m + 8.0 * n_a + 8.0 * n_r + 6.0 * n_head) * t \
        / BF16_FLOP_PER_S
    t_ssd = 0.0
    if cfg.ssm is not None:
        s = cfg.ssm
        q, nc = s.chunk, -(-seq // s.chunk)
        h, p, n = cfg.n_ssm_heads, s.head_dim, s.d_state
        per = 2.0 * TRAIN_BATCH * nc * (q * q * n + h * q * q * p
                                        + 2 * q * h * p * n)
        n_blocks = cfg.layer_pattern.count("m") * cfg.pattern_repeats
        t_ssd = 5.0 * per * n_blocks / F32_FLOP_PER_S
    pairs = TRAIN_BATCH * _attn_pairs(seq, seq, True, cfg.window)
    t_attn = 18.0 * cfg.d_head * cfg.n_heads * apps * pairs \
        / BF16_FLOP_PER_S
    t_opt = 26.0 * n_all / HBM_BYTES_PER_S
    steady = float(np.median(walls[1:]))
    full = configs.get_config(arch).n_layers
    cut = ([f"n_layers {full} -> {n_layers}"] if n_layers != full else []) \
        + ([f"seq {TRAIN_SEQ} -> {seq}"] if seq != TRAIN_SEQ else [])
    info = dict(
        arch=arch, n_layers=n_layers, cut=", ".join(cut) or None,
        batch=TRAIN_BATCH, seq=seq, steps=steps, params=n_all,
        params_reckoned=cfg.param_count(), dtype=cfg.dtype,
        param_dtype=cfg.param_dtype, remat=cfg.remat,
        losses=[h["loss"] for h in hist],
        grad_norms=[h["grad_norm"] for h in hist], step_wall_s=walls,
        steady_step_s=steady, tokens_per_s=TRAIN_BATCH * seq / steady,
        run_s=run_s, peak_gb=peak / 1e9, peak_reckoned_gb=16 * n_all / 1e9,
        launches={k: launches[k] for k in ("flash_attention",
                                            "flash_attention_bwd")},
        plain_calls=plain_calls,
        profiled_step=dict(seq=seq, device_ms=g_ms + o_ms,
                           events=g_events + o_events, split_ms=split,
                           optimizer_events=o_events,
                           top=g_top[:12] + o_top[:4]),
        bound_ms=(t_mm + t_ssd + t_attn + t_opt) * 1e3,
        bound_parts_ms=dict(products=t_mm * 1e3, ssd_f32=t_ssd * 1e3,
                            attention=t_attn * 1e3,
                            optimizer_bytes=t_opt * 1e3),
        device_idle_share=1.0 - (g_ms + o_ms) / 1e3 / steady)
    sub = "15.6" if arch == "zamba2-1.2b" else "15.7"
    print(f"# phase {sub}: " + json.dumps(info), flush=True)
    del loop, res, state
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_recurrent(ref, fa_mod, LAUNCHES, reset_launches):
    """15. The recurrent families on the card (see the constants above
    and the module docstring)."""
    t = [time.perf_counter()]
    fwd, bwd, f_err, b_err = phase_zamba_k5(ref, fa_mod)
    t.append(time.perf_counter())
    serve, serve_k5 = {}, {}
    for arch in REC_ARCHS:
        serve[arch], per = _rec_serve(arch, ref, fa_mod.flash_attention,
                                      LAUNCHES, reset_launches)
        serve_k5.update(per)
        t.append(time.perf_counter())
    short = {arch: _rec_short(arch) for arch in REC_ARCHS}
    print("# phase 15.4: at full width and short depth in f32 (f32 cache) "
          "the CPU port's prefill and decode steps teacher-forced on the "
          "card within rtol 1e-4, atol 1e-4 max|exp|; decode against "
          "prefill on the card, f32 within 2e-2 and bf16 within "
          f"{SERVE_BF16_TOL}: " + json.dumps(short), flush=True)
    t.append(time.perf_counter())
    grads = _rec_block_grads(LAUNCHES, reset_launches)
    print("# phase 15.5: the m, shared a and r blocks' gradients at full "
          "width in f32, card against the CPU port, each leaf within 1e-4 "
          "of its largest; remat full bitwise none on the card: "
          + json.dumps(grads), flush=True)
    t.append(time.perf_counter())
    train = {}
    for arch in REC_ARCHS:
        train[arch] = _rec_train(arch, ref, LAUNCHES, reset_launches)
        t.append(time.perf_counter())
    parts = np.diff(t).tolist()
    print(f"# phase 15: wall {t[-1] - t[0]:.1f} s (15.1 {parts[0]:.1f}, "
          f"15.2 {parts[1]:.1f}, 15.3 {parts[2]:.1f}, 15.4 {parts[3]:.1f}, "
          f"15.5 {parts[4]:.1f}, 15.6 {parts[5]:.1f}, 15.7 {parts[6]:.1f})",
          flush=True)
    return dict(fwd=fwd, bwd=bwd, fwd_err=f_err, bwd_err=b_err,
                serve=serve, serve_k5=serve_k5, train=train)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    with contextlib.ExitStack() as stop:
        return _main(stop)


def _main(stop) -> int:
    """The phases; ``stop`` ends the CPU port's worker on any exit."""
    from repro_torch import prng
    from repro_torch.core import (diversity, failures, layers, paths,
                                  throughput, topology, transport)
    from repro_torch.dist import fabric
    from repro_torch.experiments import Session, catalog, dist_sweep
    from repro_torch.kernels import (LAUNCHES, build, flash_attention,
                                     gf_matmul, ops, pathcount, ref,
                                     reset_launches, semiring_matmul,
                                     sparse_semiring_matmul, waterfill)
    # The module itself: the package's ``flash_attention`` is the function.
    fa_mod = importlib.import_module("repro_torch.kernels.flash_attention")
    from repro_torch.kernels.gfmm import gf_plan
    from repro_torch.kernels.sparse import _occupancy

    t_start = time.perf_counter()
    # Phases 1-8 build with the dense engine, as before phase 9 existed:
    # their launch counts (K2 bool in every APSP) depend on it.
    os.environ["REPRO_PATH_ENGINE"] = "dense"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, count = phase_card()
    t0 = time.perf_counter()
    build.build_all()
    print(f"# kernels built in {time.perf_counter() - t0:.2f} s", flush=True)
    pool = _start_cpu_port()
    stop.callback(pool.join)
    stop.callback(pool.terminate)
    ptxas = _ptxas_report(build.PTXAS_LOG)
    for lib, kernels in ptxas.items():
        print(f"# ptxas {lib}: " + json.dumps(kernels), flush=True)
    main_mm, main_wf = capture_main_inputs(Session, paths, transport)
    k2 = phase_semiring(ref, semiring_matmul, main_mm)
    k1 = phase_waterfill(ref, waterfill, main_wf)
    del main_wf
    new_mm, _, path_launches = phase_ksp(
        Session, paths, pathcount, ops, transport, prng, ref,
        semiring_matmul, LAUNCHES, reset_launches)
    phase_semiring_paths(ref, semiring_matmul, new_mm, path_launches, k2)
    k3 = phase_sparse(ref, sparse_semiring_matmul, _occupancy,
                      semiring_matmul, main_mm + new_mm, LAUNCHES,
                      reset_launches)
    del main_mm, new_mm
    k4 = phase_gfmm(topology, ops, ref, gf_matmul, gf_plan, LAUNCHES,
                    reset_launches)
    k5 = phase_flash(ops, ref, flash_attention, LAUNCHES, reset_launches)
    torch.cuda.empty_cache()
    t4 = time.perf_counter()
    phase_small_cell(Session, transport)
    t5 = time.perf_counter()
    launches, main_ses, main_results, main_sims = phase_main(
        Session, transport, catalog, prng, LAUNCHES, reset_launches)
    k2["launches"] = launches["semiring"]
    k2["per_semiring"]["bool"]["launches"] = launches["semiring"]
    k1["launches"] = launches["waterfill"]
    t6 = time.perf_counter()
    pimin = phase_pimin(Session, catalog, paths, transport, prng, ref,
                        semiring_matmul, LAUNCHES, reset_launches, k2)
    t7 = time.perf_counter()
    dyn = phase_dynamic(Session, catalog, transport, prng, LAUNCHES,
                        reset_launches, k1)
    t8 = time.perf_counter()
    faults = phase_faults(Session, catalog, failures, paths, transport, prng,
                          ref, semiring_matmul, waterfill.waterfill_step,
                          LAUNCHES, reset_launches, k1, k2)
    t9 = time.perf_counter()
    blocked_main = phase_blocked_main(Session, catalog, layers, transport,
                                      LAUNCHES, reset_launches, main_ses,
                                      main_results, main_sims)
    del main_ses, main_results, main_sims
    torch.cuda.empty_cache()
    k2_paper = phase_paper_stacks(Session, paths, ref, semiring_matmul,
                                  LAUNCHES, reset_launches, k2)
    k2_paper.update(phase_paper_stats(Session, paths, ref, semiring_matmul,
                                      LAUNCHES, reset_launches, k2))
    torch.cuda.empty_cache()
    paper = phase_paper_cells(Session, catalog, transport, prng, LAUNCHES,
                              reset_launches, k1)
    paper.update(phase_ft2(Session, catalog, transport, prng, LAUNCHES,
                           reset_launches, k1))
    t10 = time.perf_counter()
    torch.cuda.empty_cache()
    sweep = phase_sweep(Session, catalog, transport, dist_sweep, prng, ref,
                        waterfill.waterfill_step, LAUNCHES, reset_launches,
                        k1)
    t11 = time.perf_counter()
    torch.cuda.empty_cache()
    offscan = phase_offscan(Session, catalog, layers, paths, throughput,
                            fabric, diversity, ref, semiring_matmul,
                            LAUNCHES, reset_launches)
    t12 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    serve = phase_serve(ref, flash_attention, LAUNCHES, reset_launches)
    t13 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    k5b, train_k5 = phase_train(ref, fa_mod, LAUNCHES, reset_launches)
    t14 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    moe = phase_moe(ref, fa_mod, LAUNCHES, reset_launches)
    t15 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    rec = phase_recurrent(ref, fa_mod, LAUNCHES, reset_launches)
    t16 = time.perf_counter()
    print(f"# wall s: phases 1-3 and (a)-(d) {t4 - t_start:.1f}, phase 4 "
          f"{t5 - t4:.1f}, phase 5 {t6 - t5:.1f}, phase 6 {t7 - t6:.1f}, "
          f"phase 7 {t8 - t7:.1f}, phase 8 "
          f"{t9 - t8:.1f}, phase 9 {t10 - t9:.1f}, phase 10 "
          f"{t11 - t10:.1f}, phase 11 {t12 - t11:.1f}, phase 12 "
          f"{t13 - t12:.1f}, phase 13 {t14 - t13:.1f}, phase 14 "
          f"{t15 - t14:.1f}, phase 15 {t16 - t15:.1f}, script up to here "
          f"{t16 - t_start:.1f}; phases 6-9 waited {sum(CPU_PORT_WAIT):.1f} "
          f"s for the CPU port's {len(CPU_PORT_WAIT)} runs (their own "
          f"walls {sum(CPU_PORT_WALL):.1f} s)", flush=True)
    cells = {**dyn, **faults, "sf(q=19) main sweep (blocked)": blocked_main,
             **paper, **sweep}
    k2["path_launches"].update(
        {"pi_min cell": pimin["semiring"], **k2_paper,
         **{cell: n["semiring"] for cell, n in cells.items()}, **offscan})
    k1["path_launches"] = {"main sweep": launches["waterfill"],
                           "pi_min cell": pimin["waterfill"],
                           **{cell: n["waterfill"]
                              for cell, n in cells.items()}}
    # Flash attention's main path is the serving path: its launches and
    # its decode call (1536 of the 1632 launches) lead the entry, phase
    # (d)'s layouts and the prefill call stay in per_layout.
    k5["path_launches"] = {"phase (d)": k5["launches"],
                           f"{SERVE_ARCH} serve": serve["launches"],
                           f"{TRAIN_ARCH} train": train_k5,
                           **{f"{arch} serve": n
                              for arch, n in moe["serve"].items()},
                           f"{MOE_TRAIN_ARCH} train":
                               moe["train"]["flash_attention"],
                           **{f"{arch} serve": n
                              for arch, n in rec["serve"].items()},
                           **{f"{arch} train": n["flash_attention"]
                              for arch, n in rec["train"].items()}}
    k5["per_layout"].update(serve["per_layout"])
    k5["per_layout"].update(moe["fwd"])
    k5["per_layout"].update(moe["serve_k5"])
    k5["per_layout"].update(rec["fwd"])
    k5["per_layout"].update(rec["serve_k5"])
    top = serve["per_layout"][f"{SERVE_ARCH} serve decode"]
    k5.update(launches=serve["launches"],
              max_abs_err=max([k5["max_abs_err"], moe["fwd_err"],
                               rec["fwd_err"]] + [
                  r["max_abs_err"] for r in (*serve["per_layout"].values(),
                                             *moe["serve_k5"].values(),
                                             *rec["serve_k5"].values())]),
              **{k: top[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")},
              entry_layout=f"{SERVE_ARCH} serve decode bf16")
    k5b["path_launches"][f"{MOE_TRAIN_ARCH} train"] = \
        moe["train"]["flash_attention_bwd"]
    k5b["path_launches"].update(
        {f"{arch} train": n["flash_attention_bwd"]
         for arch, n in rec["train"].items()})
    k5b["per_layout"].update(moe["bwd"])
    k5b["per_layout"].update(rec["bwd"])
    k5b["max_abs_err"] = max(k5b["max_abs_err"], moe["bwd_err"],
                             rec["bwd_err"])
    # The loaded library's wgmma kernels: registers, spill bytes (stores,
    # loads) and static shared memory from its build's ptxas report, and
    # whether this run built it or found it built.
    wg = {name: regs for name, regs in ptxas.get(
        "flash_attention_bwd", {}).items() if "wg::" in name}
    if not wg:
        raise AssertionError("no ptxas report of flash_attention_bwd's "
                             "wgmma kernels")
    k5b["ptxas"] = dict(library=build.PTXAS_FROM["flash_attention_bwd"],
                        kernels=wg)
    if CPU_PORT:
        raise AssertionError("CPU-port runs that no phase held against the "
                             f"card: {list(CPU_PORT)}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    lost = PROFILE_LEAD_LOST
    print(f"# profiler: {len(lost)} traces; lead spin kernels missing from "
          f"{sum(1 for x in lost if x)} of them ({sum(lost)} in all, at most "
          f"{max(lost)} in one; last lead {PROFILE_LEAD[0]}); readings taken "
          "again after losing device "
          f"events of the call: {len(PROFILE_RETRIES)} ((lead, lost): "
          f"{PROFILE_RETRIES})", flush=True)
    # Every kernel's keys, then the breakdowns some of them carry.
    print(json.dumps({"kernels": [
        {**{k: d[k] for k in keys}, **{k: v for k, v in d.items()
                                        if k not in keys}}
        for d in (k2, k1, k3, k4, k5, k5b)]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
