#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card, end to end.

    python3 chip_smoke.py             # the check (one card)
    python3 chip_smoke.py --profile   # also: torch.profiler over the engine,
                                      # training and ensemble epochs, and
                                      # the panel gradient
    python3 chip_smoke.py --only_bwd  # the FFN backward's and panel
                                      # cotangent's libraries and the
                                      # backward's checks only (no result
                                      # line)
    python3 chip_smoke.py --only_dx   # the FFN panel cotangent's libraries,
                                      # plans and checks only (no result
                                      # line)
    python3 chip_smoke.py --only_dx --compare_dx DIR
                                      # also: the f32 sdf_ffn_dx bit for bit
                                      # against DIR/sdf_ffn_bwd.cu's (an
                                      # older source beside its header)
    python3 chip_smoke.py --only_fwd  # the FFN forward's libraries and
                                      # checks only (no result line)
    python3 chip_smoke.py --only_fwd --compare_fwd DIR
                                      # also: the f32 forward bit for bit
                                      # against DIR/sdf_ffn.cu (an older
                                      # source beside its header)
    python3 chip_smoke.py --only_cem  # the conditional-EM library and its
                                      # plans, checks and timings only (no
                                      # result line)
    python3 chip_smoke.py --only_cem --compare_cem DIR
                                      # also: the f32 cond_em_fwd/bwd/dx
                                      # bit for bit against DIR/cond_em.cu
                                      # (one with the first kernels'
                                      # argument lists, as at bdd71ce)
    python3 chip_smoke.py --only_serve
                                      # the FFN forward's libraries, then
                                      # phases 4 and 4b alone (4b on nine
                                      # stand-in members); no result line
    python3 chip_smoke.py --only_ceiling
                                      # the matmul ceiling's library, plans,
                                      # checks and measurement only (no
                                      # result line)
    python3 chip_smoke.py --only_ceiling --compare_ceiling DIR
                                      # also: the ceiling bit for bit on
                                      # integer operands against
                                      # DIR/microbench.cu, both timed in
                                      # turns
    python3 chip_smoke.py --only_data # the training kernels' libraries
                                      # and phase 11 alone (no result
                                      # line)
    python3 chip_smoke.py --only_ops  # the training kernels' libraries
                                      # and phase 12 alone (no result
                                      # line)
    python3 chip_smoke.py --only_elastic
                                      # the training kernels' libraries,
                                      # phase 9's grid in process, then
                                      # phase 13 alone (no result line)

Phases, each printing its results; any failure exits non-zero:

1. Card: ``nvidia-smi`` name and power limit.
2. Build: every kernel of the port from this checkout's sources (``nvcc``,
   sm_90a, one process per library, all started together): the SDF-FFN
   forward, backward and panel cotangent for each width bound, the
   conditional-EM (forward, backward, panel cotangent), and the matmul
   ceiling; then each library's tensor-core instructions in its
   ``cuobjdump -sass`` (HMMA in the FFN forward's and panel cotangent's
   libraries and in the conditional-EM's, whose bf16 routes need them;
   HGMMA, ``wgmma``, in the matmul ceiling's).
3. Kernels against their plain PyTorch versions on the card, at the serving,
   training, ensemble-training and panel-gradient paths' shapes (S = 9 with
   one dropout seed per member), with CUDA-event timings, bounds, the
   dropout keep share (at 0.05 and the sweep grid's 0.01 and 0.1), and
   bitwise-repeatable gradients and panel
   cotangents; the three FFN kernels also at the JAX sweep grid's other
   widths, hidden (128, 128), (64, 64, 64) and (32, 32), at S = 1 and 9
   (each backward line with its launch plan, and the paper-width backward
   timed at every stock tile; each forward route's launch plan per width
   bound, as the card holds it, with no spills; the panel cotangent's plan
   per width bound and dtype, as the card holds it, with no spills, and
   the panel cotangent with dropout 0.05 and without, the latter also
   timed by CUDA-graph replays and at every stock tile, and off the main
   paths (F = 80, F = 10 under (8, 7, 6), one hidden layer); the
   conditional-EM kernels
   at K = 4 and 8, each plan as the card holds it (the panel cotangent's
   too, and its S = 9 call timed at every stock tile), each timed as one
   event-timed call like every kernel, its device time from CUDA-graph
   replays beside it, each faster than its plain version by both); then the
   matmul ceiling:
   its values at small shapes, its plan per model shape as the card holds
   it, and (the roofline path) ``measure_matmul_ceiling`` at the model's
   shapes with the JAX defaults (checked bit for bit there on integer
   operands), each shape's TFLOP/s (at most 105% of the data-sheet peak)
   beside cuBLAS's on the same bf16 products.
4. Serving at the paper's full width: a synthetic panel (F = 46, M = 178,
   N = 10,000 stocks, 48/12/24 months, seed 42) and the three paper-width
   reference checkpoints (``ref_runs/{w500,mid2000,w4000}``) served by the
   port's ``serving.server`` through the async front end on a free port,
   in f32 and then in bf16. The forward kernel's launch counter is reset
   just before the service is built: its warmup runs every (stock bucket ×
   batch bucket) forward once uncaptured and captures it as a CUDA graph,
   so the launches must equal twice the captures, and every served forward
   after that is a graph replay with no capture. Every test month goes over
   the JSON, base64 and raw-f32 wires (the raw wire carries the month's
   valid rows alone), the batch-4 groups as four concurrent requests that
   the continuous batcher folds into one flush (batch bucket 4, the
   occupancy in ``/metrics``), identical concurrent requests coalesce onto
   one dispatch, a repeated request comes from the cache, two macro months
   are appended; every answer is held against the port's offline
   ``ensemble_metrics`` (plain route, same card) and the wires bit for bit
   one another. Then every warmed bucket's graph replay against the same
   forward run eagerly (bit for bit), ``engine.infer`` timed with graphs and
   eagerly in turns, the request medians per wire and the server's segments
   of each, and ``/metrics``' p50 and p99.
5. Offline ensemble: the port's ``evaluate_ensemble`` on the same panel.
6. Training at full width on the same panel (the paper's model, dropout
   0.05, schedule 8/4/16, ignore 2): ``train_3phase`` on the kernel route
   against ``kernel="off"`` in f32, with every kernel's launches counted
   per phase, and the roofline of its phase-1 and phase-3 epochs
   (``ops/roofline.py``: the measured epoch ms and the f32 panel's bytes
   against the f32 CUDA-core peak, which bounds these f32 kernels, and
   against the measured bf16 shape ceiling); a short ``train_3phase`` at
   the sweep's hidden (128, 128) on the kernel route (launches counted);
   then the ``train`` CLI in its
   default bf16 configuration, and the port's ``evaluate_ensemble`` on the
   run dir it wrote.
7. Ensemble training at full width on the same panel: the paper's nine
   seeds trained together, members stacked (``train_ensemble``, f32,
   dropout 0.05, schedule 8/4/16, ignore 2). Every epoch launches each
   kernel exactly as one model does, every launch carries all 9 members;
   the kernel route is held against ``kernel="off"`` and each member
   against its own serial ``train_3phase``; the roofline of its epochs at
   S = 9; then ``evaluate_ensemble --train_seeds`` (bf16) and
   ``--checkpoint_dirs`` on what it wrote must report the same test Sharpe.
8. Panel gradients at full width: the characteristic sensitivity
   ∂loss/∂individual of the nine members phase 7 trained (parameters
   frozen), on the train split: ``torch.autograd.grad`` of the conditional
   loss, the unconditional loss and the weights against a seeded random
   cotangent, kernel route against ``kernel="off"`` in f32 and bf16. One
   conditional call must launch the FFN forward and panel cotangent, the
   conditional-EM forward, backward and panel cotangent once each, and the
   FFN's parameter backward not at all.
9. The sweep on the same panel: ``run_sweep`` over a covering grid of four
   architecture buckets (every hidden width, LSTM width, K and dropout
   rate of the JAX default grid at least once) × the grid's four learning
   rates × search seed 42, f32, schedule 8/4/16, with a bucket ledger.
   Every pass of a bucket launches each training kernel once for all four
   grid points; each bucket's wall time and launch plans are printed; the
   (128, 128) bucket is held against ``kernel="off"``, the (64, 64)
   bucket's lr 2e-3 point against a one-point bucket, and a resume from the
   ledger must launch nothing and return the same ranking bit for bit.
   Then ``python -m ...sweep --quick`` (bf16) and ``evaluate_ensemble
   --checkpoint_dirs`` on its rank-0 run dirs: the same test Sharpe, and
   the report's and ranking's sidecars verify.
10. Model health and promotion on the same panel: the diagnostics pass
   (``ops/diagnostics.py``) of phase 6's model (S = 1) and phase 7's nine
   members (S = 9) on the valid split, kernel route against
   ``kernel="off"`` in f32 and bf16, each pass launching ``sdf_ffn_fwd`` and
   ``cond_em_fwd`` once and nothing else, mean_k v_k² equal to the eval
   loss_cond to rtol 1e-6, each pass timed; ``train_3phase`` again with
   phase 6's seed and schedule, without and with ``diag_stride`` 2: params,
   best checkpoints and history bit for bit phase 6's, the forward kernels'
   launches up by the stride epochs + 1, a verified finite ``health.json``,
   the epoch ms with and without; phase 6's train CLI call runs with
   ``--diag_stride 4`` and must leave ``reference_profile.json``,
   ``health.json`` and the ``diag_*`` fields; then the promotion CLI on
   phase 7's nine members saved as run dirs: generation 1 with the offline
   valid Sharpe, a NaN member, a torn member and a 3σ-shifted panel each
   rejected by its slug, a second generation, ``rollback`` and ``show``.
4b. Hot reload of the serving path (f32), on phase 7's members as phase 10
   saved them and phase 10's pointer: three members served, ``/v1/reload``
   to three others bit for bit a fresh engine on them (the generation
   bumped, a cached request served anew, no capture); a NaN candidate
   written through the verified writer reverted by the canary (a 5xx, the
   pre-swap answers bit for bit); the ``ref_runs`` trio refused (another
   architecture; four dirs when it is not) with the engine serving on;
   ``/v1/drain`` on the admin port closes the listener and the serve loop
   returns; a nine-member service booted from the pointer reloads as a
   no-op and refuses, whole, a pointer whose member was tampered.
11. The data plane at the paper's real panel shape (240/60/300 months ×
   10,000 stocks × 46 characteristics, macro 178, seed 42, written
   uncompressed into ``_smoke_real/``, the panel cache in
   ``_smoke_cache/``; both removed after): the native codec built on this
   host and its decode of the train split bit for bit the NumPy decode;
   per split, ``device_put_batch`` dense, packed and auto, ``stream_batch``
   at the default slab and at 4 MiB slabs (dozens of reuses of each pinned
   slab), and the bf16 wire, each bit for bit ``load_splits`` +
   ``to_batch("cuda")`` (the bf16 wire: its panel rounded to bf16), with
   bytes shipped, host ms and ms to resident; ``StartupPipeline`` cold
   (cache cleared) and warm, bit for bit, cache hits 0/3 then 3/3, its
   spans and its wall against the sequential load; ``load_splits_chunked``
   cold, warm, a column span and a truncated shard that alone re-decodes;
   then the train CLI (epochs 2/1/2) through the pipeline against
   ``--no_pipeline``, in f32 and in the default bf16 (the pipeline on the
   bf16 wire): ``history.npz`` and ``final_model.pt`` bit for bit, the
   epochs' walls at T = 240, and the training kernels' launches of the
   bf16 pipeline run (the ``data_plane_train_real_shape`` path).
12. The trainer's operational plane on phase 6's model and panel (dropout
   0.05, schedule 8/4/16, ignore 2, seed 42, the default kernel route; run
   dirs in ``_smoke_ops/``, removed after; it runs after 4b, while the
   panel is on disk): (a) f32 ``train_3phase`` with ``checkpoint_every`` 4
   and a ``nan_loss`` plan at the second segment: trips ``[(1, 4, 8)]``,
   params, history and every ``.pt`` bit for bit an unguarded clean run,
   and each training kernel's launches the clean run's plus exactly the
   retried segment's (this run is the ``trainer_ops_plane`` path); (b)
   three consecutive trips raise ``DivergenceError`` naming
   ``phase1_unconditional`` with no ``.pt`` written; (c)
   ``stop_after_epochs`` 6 and 14, each resumed, bit for bit an
   uninterrupted whole-phase run in f32 and bf16, no resume file left;
   the epoch walls with the guard on and off (in turns) and the ms of one
   resume save; (d) the train CLI in subprocesses, default bf16:
   ``--checkpoint_every 4 --metrics_port 0 --profile DIR`` with a
   ``/metrics`` scrape showing ``epochs_dispatched`` while it trains,
   ``heartbeat.json`` with ``device_memory``, ``manifest.json`` with
   ``kernel_programs``, 28 ``metrics.jsonl`` rows, a Chrome trace naming
   the FFN and conditional-EM kernels; then a ``kill`` plan at the third
   segment (the child dies by SIGKILL) and ``--resume``: ``history.npz``
   and ``final_model.pt`` bit for bit the first run's.
13. The supervisor and the elastic sweep, after phase 12 on phase 6's
   panel (run dirs in ``_smoke_elastic/``, removed after): (a) the train
   CLI under ``supervise`` with a ``kill`` plan at the third segment,
   (b) with a ``hang`` plan at phase 1's boundary in f32 and bf16 (a
   heartbeat timeout of ``SUP_TIMEOUT``), side by side with two clean
   runs: one restart each with ``--resume``, the hang SIGKILLed and
   attributed to ``phase1_unconditional``, ``history.npz`` and
   ``final_model.pt`` bit for bit the clean run of the same dtype;
   (c) a supervised ``--workers 2`` fleet (the sweep CLI's coordinator
   over ``--worker`` processes) on phase 9's four buckets × four lrs,
   f32, with kills at ``sweep/claim`` #1, ``sweep/bucket`` #2 and
   ``sweep/ledger_write`` #2: the ranking byte-identical to phase 9's,
   one record per bucket naming its worker, three restarts, each
   worker's manifest on the CUDA route and every bucket's kernel plans
   in the workers' events; (d) a persistent ``raise`` on B2 with
   ``--max_bucket_attempts`` 2: coverage 0.75 and the other entries bit
   for bit phase 9's. Launches of these paths (``supervised_train``,
   ``elastic_sweep``) are counted in the child processes that exit
   normally (``DLAP_LAUNCH_COUNTS``).

Then one ``kernels`` JSON line, the card line again, and the result line
``{"ok": true, "device": {...}}`` last.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PKG = "deeplearninginassetpricing_paperreplication_torch"
REF_RUNS = ["ref_runs/w500", "ref_runs/mid2000", "ref_runs/w4000"]
DATA_DIR = ROOT / "_smoke_data"
DEVICE = "cuda"
PANEL = dict(n_periods_train=48, n_periods_valid=12, n_periods_test=24,
             n_stocks=10_000, n_features=46, n_macro=178, seed=42)
RUN_DIR = ROOT / "_smoke_run"
ENS_DIR = ROOT / "_smoke_ensemble"
# the paper's nine seeds (the JAX package's train_ensemble default)
ENSEMBLE_SEEDS = (42, 123, 456, 789, 1000, 2000, 3000, 4000, 5000)
ENSEMBLE_CLI_SEEDS = (42, 123, 456)
SCHEDULE = dict(num_epochs_unc=8, num_epochs_moment=4, num_epochs=16,
                ignore_epoch=2)
# expected launches per epoch: (sdf_ffn_fwd, sdf_ffn_bwd, cond_em_fwd,
# cond_em_bwd) — the train step, then (phases 1 and 3) eval on valid, test
PER_EPOCH = {"unconditional": (3, 1, 2, 0), "moment": (1, 0, 1, 1),
             "conditional": (3, 1, 3, 1)}
# one frozen-parameter panel gradient of the conditional loss: (sdf_ffn_fwd,
# sdf_ffn_bwd, sdf_ffn_dx, cond_em_fwd, cond_em_bwd, cond_em_dx)
PANEL_GRAD_LAUNCHES = (1, 0, 1, 1, 1, 1)
DROPOUT = 0.05
# kernel-check shapes: (S, T, N) of the FFN backward, (S, N) of the
# conditional-EM at T = 48, and the keep-share panel (T, N)
BWD_SHAPES = [(S, T, N) for S in (1, 3)
              for T, N in ((4, 16384), (48, 10000), (48, 10007))] + [
                  (9, 48, 10000)]
CEM_SHAPES = [(S, N) for S in (1, 3) for N in (10000, 10007)] + [(9, 10000)]
CEM_T = 48
CEM_KS = (4, 8)  # the sweep's num_condition_moment values
# (S, T, N, F, K) of the conditional-EM instances off the main paths
CEM_ODD_SHAPES = [(3, 12, 1001, 80, 8), (2, 5, 77, 10, 5),
                  (4, 24, 999, 46, 16)]
KEEP_SHAPE = (48, 10_000)
KEEP_RATES = (DROPOUT, 0.01, 0.1)  # the JAX sweep grid's dropout rates
BWD_ROW, CEM_ROW = (1, 48, 10000), (1, 10000)  # the training path's shapes
# the ensemble training path's shapes: all nine members in one launch
ENS_BWD_ROW, ENS_CEM_ROW = (9, 48, 10000), (9, 10000)
# the panel cotangents' (S, T, N): one member, a ragged three, and the
# panel-gradient path's nine members
DX_SHAPES = [(1, 48, 10000), (3, 48, 10007), (9, 48, 10000)]
DX_ROW = (9, 48, 10000)
# (S, T, N, F, hidden) of the FFN panel cotangent off the main paths: the
# bf16 route on the CUDA cores (F > 64), a ten-feature panel under a
# three-layer odd stack (route 1 with a CUDA-core middle layer), and one
# hidden layer (both routes' one-layer paths)
DX_ODD_SHAPES = [(2, 6, 1001, 80, (64, 64)), (3, 5, 1001, 10, (8, 7, 6)),
                 (2, 4, 999, 46, (12,))]
# the sweep grid's other FFN widths that the FFN kernels must hold at
# (the JAX package's parallel/sweep.py:82 hidden_dims: the w128 library,
# a third layer, and the w32 library with the backward's 4-tile register
# instance), at one member and at the ensemble's nine; and one short
# train_3phase at (128, 128)
WIDE_HIDDEN = [(128, 128), (64, 64, 64), (32, 32)]
WIDE_SHAPES = [(1, 48, 10000), (9, 48, 10000)]
WIDE_TRAIN = dict(hidden=(128, 128), num_epochs_unc=2, num_epochs_moment=1,
                  num_epochs=2, ignore_epoch=0)
# the sweep phase's covering grid: four architecture buckets, each trained
# at the JAX default grid's four lrs for search seed 42 (S = 4 grid points
# a bucket), together holding every value of every axis of that grid
# (hidden, rnn units, K, dropout)
SWEEP_BUCKETS = [((64, 64), (4,), 8, 0.05), ((128, 128), (8,), 4, 0.1),
                 ((64, 64, 64), (16,), 8, 0.01), ((32, 32), (32,), 4, 0.05)]
SWEEP_LRS = (1e-3, 5e-4, 2e-3, 1e-4)
SWEEP_SEED = 42
SWEEP_DIR = ROOT / "_smoke_sweep"
# model health and promotion (phase 10): the diag run's stride, the train
# CLI's, the diagnostics passes timed per route, and the gate's scratch
HEALTH_DIR = ROOT / "_smoke_health"
DIAG_STRIDE = 2
CLI_DIAG_STRIDE = 4
DIAG_TIMED_PASSES = 5
# (T, N) of the sweep's kernel checks: the train split
SWEEP_TN = (CEM_T, 10_000)
# expected launches per epoch of a sweep bucket (as PER_EPOCH): the train
# step, then (phases 1 and 3) eval on valid only — the search runs no test
# evals
SWEEP_PER_EPOCH = {"unconditional": (2, 1, 1, 0), "moment": (1, 0, 1, 1),
                   "conditional": (2, 1, 2, 1)}
# the matmul ceiling's value checks, (M, K, BN, S, repeats, steps): at 2 x 3
# steps (one step per step group) on normal operands, within 1e-4 of max;
# and at the timed configuration (8 x 64: several steps per step group, as
# measure_matmul_ceiling launches it) on integer operands in [-2, 2], whose
# every partial sum is exact in f32 (|sum| <= 9 * 224 * 4 * 512 < 2^24), so
# the kernel must equal its plain version bit for bit: one repeat too many or
# too few shows, where on normal operands the f32 accumulation of 512 like
# terms alone can drift past the 1e-4 bar
CEILING_CHECKS = [(64, 46, 2048, 9, 2, 3), (64, 64, 2048, 9, 2, 3),
                  (8, 224, 2048, 9, 2, 3), (128, 128, 2048, 9, 2, 3),
                  (8, 16, 100, 2, 2, 3)]
CEILING_EXACT_CHECKS = [(64, 46, 2048, 9, 8, 64), (64, 64, 2048, 9, 8, 64),
                        (8, 224, 2048, 9, 8, 64), (128, 128, 2048, 9, 8, 64)]

F32_TOL = dict(rtol=1e-4, atol=1e-5)  # kernel vs plain, f32 (sum order)
GRAD_F32_REL = 1e-4  # gradients, f32: atol = 1e-4 · max|reference|
SERVE_F32_TOL = dict(rtol=1e-4, atol=1e-6)  # served vs offline, f32
BF16_REL = 2e-2  # bf16: atol = 2e-2 · max|reference|


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def bound(flops: int, nbytes: int, dtype: str):
    """(bound ms, what bounds it): the larger of operations over the card's
    published peak rate for `dtype` and bytes over its memory rate (the
    H100 SXM data sheet's, from ops/roofline.py)."""
    from deeplearninginassetpricing_paperreplication_torch.ops import (
        roofline,
    )

    peak = {"float32": roofline.PEAK_F32_FLOPS,
            "bfloat16": roofline.PEAK_BF16_FLOPS}[dtype]
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / (roofline.HBM_PEAK_GBPS * 1e9) * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def rel_err(out, ref) -> float:
    """max|out - ref| / max|ref| (0 for an all-zero reference)."""
    scale = float(ref.abs().max())
    return float((out - ref).abs().max()) / scale if scale else float(
        (out - ref).abs().max())


def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(torch, fn, reps: int = 20) -> float:
    """Device time of one call from CUDA events around `reps` replays of fn
    captured in a CUDA graph: the host's Python and launch overhead, which
    one event-timed call includes, is left out."""
    graph = graph_of(torch, fn)
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def graph_of(torch, fn):
    """fn captured in a CUDA graph, after two warm-up calls on a side stream
    (as capture needs): a replay launches the same kernels with no host
    dispatch between them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def device_events(prof):
    """The profile's device-side events (kernels, copies), by device time,
    and the device's busy ms. Host-side events (autograd Functions, aten
    ops) carry the device time of what they launched, so summing them too
    would count every kernel twice."""
    from torch.autograd import DeviceType

    evs = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0),
                 key=lambda e: e.self_device_time_total, reverse=True)
    return evs, sum(e.self_device_time_total for e in evs) / 1e3


def within(diff: np.ndarray, ref: np.ndarray, dtype: str, rtol: float,
           atol: float) -> bool:
    if dtype == "bfloat16":
        return bool(np.all(diff <= BF16_REL * np.abs(ref).max()))
    return bool(np.all(diff <= atol + rtol * np.abs(ref)))


# -- phase 3 ------------------------------------------------------------------


def kernel_checks(torch, K, card):
    """The fused FFN against its plain version at the listed shapes; returns
    the row of the shape the main path serves most (S=3, T=4, N=16384)."""
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(0)
    F, hidden = 46, [64, 64]

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    row = None
    print(f"[kernels] sdf_ffn_fwd vs sdf_ffn_reference, F={F} hidden={hidden}"
          f" ({card})", flush=True)
    for S in (1, 3):
        for T in (1, 4, 24):
            for N in (16384, 10007):
                x = rand(T, F, N)
                zp = rand(S, T, hidden[0], scale=0.3)
                k1T = rand(S, hidden[0], F, scale=F ** -0.5)
                mids = [(rand(S, hidden[1], hidden[0],
                              scale=hidden[0] ** -0.5),
                         rand(S, hidden[1], scale=0.1))]
                kout = rand(S, hidden[1], scale=hidden[1] ** -0.5)
                bout = rand(S, scale=0.1)
                for cd in ("float32", "bfloat16"):
                    packed = K.pack_ffn(k1T, mids, kout, bout, cd)
                    out = K.sdf_ffn_packed(x, zp, packed)
                    torch.cuda.synchronize()
                    ref = K.sdf_ffn_reference(x, zp, k1T, mids, kout, bout,
                                              cd)
                    diff = (out - ref).abs().cpu().numpy()
                    refn = ref.cpu().numpy()
                    err = float(diff.max())
                    check(bool(torch.isfinite(out).all()),
                          f"non-finite kernel output at S={S} T={T} N={N}")
                    check(within(diff, refn, cd, **F32_TOL),
                          f"kernel disagrees with its plain version at S={S}"
                          f" T={T} N={N} {cd}: max|d| {err:.3e}")
                    ms = cuda_ms(torch, lambda: K.sdf_ffn_packed(x, zp,
                                                                 packed))
                    plain_ms = cuda_ms(torch, lambda: K.sdf_ffn_reference(
                        x, zp, k1T, mids, kout, bout, cd))
                    flops = K.flops(S, T, N, F, hidden)
                    bound_ms, bound_by = bound(
                        flops, K.bytes_moved(S, T, N, F, hidden), cd)
                    print(f"[kernels] S={S} T={T:2d} N={N:5d} {cd:8s} "
                          f"max|d| {err:.3e} max|ref| "
                          f"{float(np.abs(refn).max()):.3f}  kernel "
                          f"{ms:.4f} ms  plain {plain_ms:.4f} ms  bound "
                          f"{bound_ms:.4f} ms ({bound_by})"
                          f"  {flops / ms / 1e9:.1f} TFLOP/s", flush=True)
                    if (S, T, N, cd) == (3, 4, 16384, "bfloat16"):
                        row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                   bound_ms=bound_ms, bound_by=bound_by,
                                   shape=f"S=3 T=4 N=16384 F={F} "
                                         f"hidden={hidden} bfloat16")
    wide_checks(torch, K, card, "fwd")
    return row


def wide_checks(torch, K, card, kernel, hiddens=WIDE_HIDDEN,
                shapes=WIDE_SHAPES, dtypes=("float32", "bfloat16"),
                rate=DROPOUT):
    """sdf_ffn_fwd or sdf_ffn_dx against its plain version at `hiddens`
    (default the sweep widths) and `shapes`, each of `dtypes`, dropout
    `rate` with one seed per member, and two calls bitwise-equal. Returns
    {(hidden, S, T, N, cd): row}."""
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(6)
    F = 46
    rows = {}
    for hidden in hiddens:
        hidden = list(hidden)
        for S, T, N in shapes:
            x = torch.randn(T, F, N, generator=g, device=dev)
            zp1, k1T, mids, kout, bout = _ffn_params(torch, g, S, F, hidden,
                                                    dev)
            zp = (zp1 + torch.randn(S, T, hidden[0], generator=g,
                                    device=dev) * 0.3).contiguous()
            gout = torch.randn(S, T, N, generator=g, device=dev) / N
            seed = 11 if S == 1 else list(range(11, 11 + S))
            for cd in dtypes:
                packed = K.pack_ffn(k1T, mids, kout, bout, cd)
                if kernel == "fwd":
                    def kern():
                        return K.sdf_ffn_packed(x, zp, packed,
                                                dropout_rate=rate, seed=seed)

                    def plain():
                        return K.sdf_ffn_reference(x, zp, k1T, mids, kout,
                                                   bout, cd, seed, rate)
                    flops = K.flops(S, T, N, F, hidden)
                    nbytes = K.bytes_moved(S, T, N, F, hidden)
                    bar = 1e-5 if cd == "float32" else BF16_REL
                else:
                    def kern():
                        return K._launch_dx(x, zp, packed, gout, seed, rate)

                    def plain():
                        return K.sdf_ffn_dx_reference(x, zp, k1T, mids, kout,
                                                      gout, cd, seed, rate)
                    flops = K.dx_flops(S, T, N, F, hidden)
                    nbytes = K.dx_bytes_moved(S, T, N, F, hidden)
                    bar = GRAD_F32_REL if cd == "float32" else BF16_REL
                out, again = kern(), kern()
                torch.cuda.synchronize()
                check(torch.equal(out, again),
                      f"sdf_ffn_{kernel} not bitwise repeatable at S={S} "
                      f"hidden={hidden} {cd}")
                ref = plain()
                err = rel_err(out, ref)
                check(bool(torch.isfinite(out).all()) and err <= bar,
                      f"sdf_ffn_{kernel} disagrees with its plain version at"
                      f" S={S} T={T} N={N} hidden={hidden} {cd} dropout "
                      f"{rate}: max|d|/max|ref| {err:.3e}")
                abs_err = float((out - ref).abs().max())
                del out, again, ref
                ms = cuda_ms(torch, kern, reps=5, warmup=1)
                plain_ms = cuda_ms(torch, plain, reps=2, warmup=1)
                b_ms, b_by = bound(flops, nbytes, cd)
                print(f"[kernels] {kernel} hidden={hidden} S={S} T={T} "
                      f"N={N} {cd:8s} dropout {rate}: max|d|/max|ref| "
                      f"{err:.2e}  kernel {ms:.4f} ms  plain {plain_ms:.4f} "
                      f"ms  bound {b_ms:.4f} ms ({b_by}) ({card})",
                      flush=True)
                rows[(tuple(hidden), S, T, N, cd)] = dict(
                    max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by,
                    shape=f"S={S} T={T} N={N} F={F} hidden={hidden} {cd} "
                          f"dropout {rate}")
    return rows


def dropout_keep_share(torch, K, card):
    """The forward kernel's measured keep share at dropout 0.05 and at the
    sweep grid's other rates, 0.01 and 0.1, from its own output: with
    k1T = 0 and zp = 1 every first-layer unit is 1 before dropout, so
    w = scale·mean(keep); a second layer W = 0, b = 1 reads the second
    layer's units the same way."""
    dev = torch.device(DEVICE)
    (T, N), F, H = KEEP_SHAPE, 46, 64
    x = torch.randn(T, F, N, device=dev)
    shares = {}
    for rate in KEEP_RATES:
        _, scale = K.dropout_params(rate)
        for layer in (0, 1):
            zp = torch.ones(1, T, H, device=dev)
            k1T = torch.zeros(1, H, F, device=dev)
            mids = ([(torch.zeros(1, H, H, device=dev),
                      torch.ones(1, H, device=dev))] if layer else [])
            kout = torch.full((1, H), 1.0 / H, device=dev)
            bout = torch.zeros(1, device=dev)
            packed = K.pack_ffn(k1T, mids, kout, bout, "float32")
            w = K.sdf_ffn_packed(x, zp, packed, dropout_rate=rate, seed=123)
            ref = K.sdf_ffn_reference(x, zp, k1T, mids, kout, bout,
                                      "float32", 123, rate)
            check(float((w - ref).abs().max()) <= 1e-6,
                  f"dropout {rate}: kernel and plain masks differ (layer "
                  f"{layer})")
            shares[(rate, layer)] = float(w.double().mean()) / scale
    for (rate, layer), share in shares.items():
        check(abs(share - (1 - rate)) <= 0.002,
              f"dropout {rate} keep share {share:.5f} of layer {layer} is "
              f"not {1 - rate:g} ± 0.002")
    for rate in KEEP_RATES:
        print(f"[kernels] sdf_ffn_fwd dropout {rate}: kernel == plain masks;"
              f" keep share over {T * N * H:,} units per layer: "
              f"{shares[(rate, 0)]:.5f} (layer 0), {shares[(rate, 1)]:.5f} "
              f"(layer 1), expected {1 - rate:g} ({card})", flush=True)
    # the training step's forward: the paper's widths, one member, then
    # the ensemble's nine members with one dropout seed each
    ens_row = None
    for S in (1, 9):
        g = torch.Generator(device=dev).manual_seed(3)
        zp1, k1T, mids, kout, bout = _ffn_params(torch, g, S, F, [H, H], dev)
        zp = zp1.expand(S, T, H).contiguous()
        seed = 5 if S == 1 else list(range(5, 5 + S))
        for cd in ("float32", "bfloat16"):
            packed = K.pack_ffn(k1T, mids, kout, bout, cd)
            for rate in (0.0, DROPOUT):
                w = K.sdf_ffn_packed(x, zp, packed, dropout_rate=rate,
                                     seed=seed)
                ref = K.sdf_ffn_reference(x, zp, k1T, mids, kout, bout, cd,
                                          seed, rate)
                err = rel_err(w, ref)
                check(err <= (1e-5 if cd == "float32" else BF16_REL),
                      f"sdf_ffn_fwd at the training shape S={S}, {cd} "
                      f"dropout {rate}: max|d|/max|ref| {err:.3e}")
                ms = cuda_ms(torch, lambda: K.sdf_ffn_packed(
                    x, zp, packed, dropout_rate=rate, seed=seed))
                plain_ms = cuda_ms(torch, lambda: K.sdf_ffn_reference(
                    x, zp, k1T, mids, kout, bout, cd, seed, rate), reps=10)
                b_ms, b_by = bound(K.flops(S, T, N, F, [H, H]),
                                   K.bytes_moved(S, T, N, F, [H, H]), cd)
                print(f"[kernels] fwd S={S} T={T} N={N} {cd:8s} drop "
                      f"{rate:.2f} max|d|/max|ref| {err:.2e}  kernel "
                      f"{ms:.4f} ms  plain {plain_ms:.4f} ms  bound "
                      f"{b_ms:.4f} ms ({b_by})", flush=True)
                if (S, cd, rate) == (9, "float32", DROPOUT):
                    ens_row = dict(
                        max_abs_err=float((w - ref).abs().max()), ms=ms,
                        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                        shape=f"S=9 T={T} N={N} F={F} hidden={[H, H]} "
                              f"float32 dropout {DROPOUT}")
    return shares, ens_row


def _ffn_params(torch, g, S, F, hidden, dev):
    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale
    zp = rand(S, 1, hidden[0], scale=0.3)
    k1T = rand(S, hidden[0], F, scale=F ** -0.5)
    mids = [(rand(S, b, a, scale=a ** -0.5), rand(S, b, scale=0.1))
            for a, b in zip(hidden, hidden[1:])]
    kout = rand(S, hidden[-1], scale=hidden[-1] ** -0.5)
    bout = rand(S, scale=0.1)
    return zp, k1T, mids, kout, bout


def bwd_plan_of(torch, K, lay, S, T, N, tile=None):
    """The backward's plan for this card and what the card makes of it;
    fails if the card holds fewer blocks resident per SM than planned."""
    plan = K.card_bwd_plan(lay, torch.device(DEVICE), S, T, N, tile)
    info = K.bwd_plan_info(lay, plan)
    check(info["blocks_per_sm"] >= plan.blocks_per_sm,
          f"sdf_ffn_bwd plan {plan}: the card holds {info['blocks_per_sm']} "
          f"blocks per SM, not {plan.blocks_per_sm}")
    return plan, dict(tile=plan.tile, threads=plan.threads,
                      smem_bytes=plan.smem_bytes,
                      blocks_per_sm_planned=plan.blocks_per_sm,
                      blocks_per_sm=info["blocks_per_sm"], G=plan.G,
                      accumulators=plan.accumulators, reg_tiles=plan.nt,
                      registers=info["registers"],
                      local_bytes=info["local_bytes"])


def plan_text(p) -> str:
    return (f"plan tile {p['tile']} threads {p['threads']} smem "
            f"{p['smem_bytes']} B resident {p['blocks_per_sm']}/SM (planned "
            f"{p['blocks_per_sm_planned']}) G {p['G']} acc "
            f"{p['accumulators']}"
            + (f" ({p['reg_tiles']} tiles)" if p["reg_tiles"] else "")
            + f" regs {p['registers']} local {p['local_bytes']} B")


def fwd_plan_lines(torch, K, card):
    """Each forward route's plan at every width bound (the paper's (64, 64)
    and the sweep widths) and the main paths' (S, T, N), as the card holds
    it; fails if the card keeps fewer blocks resident than planned or a
    kernel spills to local memory."""
    dev = torch.device(DEVICE)
    for hidden in [(64, 64)] + WIDE_HIDDEN:
        lay = K.ffn_layout(46, hidden)
        for S, T, N in ((3, 4, 16384), (1, 48, 10000), (9, 48, 10000)):
            for cd in ("float32", "bfloat16"):
                plan = K.card_fwd_plan(lay, dev, S, T, N, cd)
                info = K.fwd_plan_info(lay, S, plan)
                check(info["blocks_per_sm"] >= plan.blocks_per_sm,
                      f"sdf_ffn_fwd plan {plan}: the card holds "
                      f"{info['blocks_per_sm']} blocks per SM")
                check(info["local_bytes"] == 0,
                      f"sdf_ffn_fwd w{K.width_bound(hidden)} {cd} spills "
                      f"{info['local_bytes']} B per thread")
                print(f"[kernels] fwd plan hidden={list(hidden)} w"
                      f"{K.width_bound(hidden)} S={S} T={T} N={N} {cd:8s} "
                      f"route {plan.route} tile {plan.tile} threads "
                      f"{plan.threads} members {plan.members} smem "
                      f"{plan.smem_bytes} B resident "
                      f"{info['blocks_per_sm']}/SM (planned "
                      f"{plan.blocks_per_sm}) G {plan.G} of {plan.cells} "
                      f"cells regs {info['registers']} local "
                      f"{info['local_bytes']} B ({card})", flush=True)


def dx_plan_lines(torch, K, card):
    """The panel cotangent's plan at every width bound (the paper's (64, 64),
    the sweep widths and the odd (8, 7, 6)), S = 1 and 9, both dtypes, as
    the card holds it; fails if the card keeps fewer blocks resident than
    planned or a kernel spills to local memory."""
    dev = torch.device(DEVICE)
    for hidden in [(64, 64)] + WIDE_HIDDEN + [(8, 7, 6)]:
        lay = K.ffn_layout(46, hidden)
        for S, T, N in ((1, 48, 10000), DX_ROW):
            for cd in ("float32", "bfloat16"):
                plan = K.card_dx_plan(lay, dev, S, T, N, cd)
                info = K.dx_plan_info(lay, S, cd, plan)
                check(info["blocks_per_sm"] >= plan.blocks_per_sm,
                      f"sdf_ffn_dx plan {plan}: the card holds "
                      f"{info['blocks_per_sm']} blocks per SM")
                check(info["local_bytes"] == 0,
                      f"sdf_ffn_dx w{K.width_bound(hidden)} {cd} spills "
                      f"{info['local_bytes']} B per thread")
                print(f"[kernels] dx plan hidden={list(hidden)} w"
                      f"{K.width_bound(hidden)} S={S} T={T} N={N} {cd:8s} "
                      f"route {plan.route} tile {plan.tile} threads "
                      f"{plan.threads} weights "
                      f"{'resident' if plan.resident else 'streamed'} "
                      f"({plan.wbufs} buffers) panel tiles {plan.xbufs} smem "
                      f"{plan.smem_bytes} B "
                      f"resident {info['blocks_per_sm']}/SM (planned "
                      f"{plan.blocks_per_sm}) G {plan.G} of {plan.cells} "
                      f"cells regs {info['registers']} local "
                      f"{info['local_bytes']} B ({card})", flush=True)


def sass_hmma(K, _nvcc, kernels=("fwd",), more=()):
    """Tensor-core instructions in the SASS (cuobjdump) of each library:
    HMMA (mma.sync) in each library of `kernels` (the FFN forward, its panel
    cotangent) and, for each (job, opcode) in `more`, that opcode (HMMA in
    the conditional-EM library, whose bf16 panel cotangent needs it; HGMMA,
    wgmma, in the matmul ceiling's). Every count must be positive."""
    tool = Path(_nvcc.nvcc()).with_name("cuobjdump")
    if not tool.exists():
        print("[build] cuobjdump not in the toolkit: HMMA count not taken",
              flush=True)
        return
    counts = {}
    for job, op in ([(j, "HMMA") for j in K.build_jobs(kernels=kernels)]
                    + list(more)):
        sass = subprocess.run([str(tool), "-sass", str(job.path)],
                              capture_output=True, text=True,
                              check=True).stdout
        counts[f"{job.name} {op}"] = sass.count(op)
    print(f"[build] tensor-core instructions in the SASS: {counts}",
          flush=True)
    check(all(counts.values()), "a library lacks its tensor-core "
          "instructions")


def compare_fwd(torch, K, _nvcc, src_dir, card):
    """The f32 forward against an older source's (src_dir/sdf_ffn.cu, its
    one-thread-per-stock kernel and argument list) at the training shapes:
    bit for bit equal, and the two timed in turns (old, new, new, old)."""
    import ctypes

    src = Path(src_dir).resolve()
    out = _nvcc.BUILD_DIR / "libsdf_ffn_fwd_compare.so"
    _nvcc.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_nvcc.nvcc(), *_nvcc.NVCC_FLAGS, "-DSDF_FFN_MAXW=64",
                    "-o", str(out), str(src / "sdf_ffn.cu")], check=True)
    old = ctypes.CDLL(str(out)).sdf_ffn_fwd
    old.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                    + [ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_uint,
                       ctypes.c_float, ctypes.c_void_p])
    old.restype = ctypes.c_int
    dev = torch.device(DEVICE)
    (T, N), F, H = KEEP_SHAPE, 46, 64
    x = torch.randn(T, F, N, device=dev)
    for S in (1, 9):
        g = torch.Generator(device=dev).manual_seed(3)
        zp1, k1T, mids, kout, bout = _ffn_params(torch, g, S, F, [H, H], dev)
        zp = zp1.expand(S, T, H).contiguous()
        seed = 5 if S == 1 else list(range(5, 5 + S))
        packed = K.pack_ffn(k1T, mids, kout, bout, "float32")
        for rate in (0.0, DROPOUT):
            drop, bases = K._dropout_args(seed, rate, S, dev)

            def run_old():
                o = torch.empty(S, T, N, device=dev)
                rc = old(x.data_ptr(), zp.data_ptr(), packed.params.data_ptr(),
                         o.data_ptr(), S, T, N,
                         K._layout_ints(packed.layout), 0, *drop,
                         torch.cuda.current_stream().cuda_stream)
                check(rc == 0, f"the older forward failed (code {rc})")
                return o

            def run_new():
                return K.sdf_ffn_packed(x, zp, packed, dropout_rate=rate,
                                        seed=seed)
            a, b = run_old(), run_new()
            torch.cuda.synchronize()
            check(torch.equal(a.view(torch.int32), b.view(torch.int32)), f"sdf_ffn_fwd f32 differs from the older kernel at "
                        f"S={S} dropout {rate}: max|d| "
                        f"{float((a - b).abs().max()):.3e}")
            t = [cuda_ms(torch, f) for f in (run_old, run_new, run_new,
                                              run_old)]
            print(f"[kernels] fwd f32 S={S} T={T} N={N} drop {rate:.2f}: bit "
                  f"for bit equal to {src.name}/sdf_ffn.cu; older "
                  f"{t[0]:.4f} / {t[3]:.4f} ms, new {t[1]:.4f} / {t[2]:.4f} "
                  f"ms ({card})", flush=True)
            del bases


def ffn_bwd_checks(torch, K, card, hidden=(64, 64), shapes=None,
                   dtypes=("float32", "bfloat16"), rates=(0.0, DROPOUT)):
    """sdf_ffn_bwd against sdf_ffn_bwd_reference, each output tensor, and
    two calls bitwise-equal, at `shapes` (BWD_SHAPES) of `hidden`, each of
    `dtypes` and dropout `rates`; each line carries the launch plan.
    Returns {(S, T, N, cd, rate): row}; at (64, 64) and the ensemble's
    S = 9 it also times the plan at every stock tile that fits."""
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(1)
    F, hidden = 46, list(hidden)
    wide = hidden != [64, 64]
    rows = {}
    names = ["dzp", "dk1T", "dkout", "dbout"] + [
        f"{n}{li + 1}" for li in range(1, len(hidden)) for n in ("dW", "db")]
    print(f"[kernels] sdf_ffn_bwd vs sdf_ffn_bwd_reference, F={F} "
          f"hidden={hidden} ({card})", flush=True)
    for S, T, N in shapes or BWD_SHAPES:
        x = torch.randn(T, F, N, generator=g, device=dev)
        zp1, k1T, mids, kout, bout = _ffn_params(torch, g, S, F, hidden,
                                                dev)
        zp = (zp1 + torch.randn(S, T, hidden[0], generator=g,
                                device=dev) * 0.3).contiguous()
        gout = torch.randn(S, T, N, generator=g, device=dev) / N
        # one dropout seed per member, as the ensemble trains
        seed = 7 if S == 1 else list(range(7, 7 + S))
        lay = K.ffn_layout(F, hidden)
        plan, pinfo = bwd_plan_of(torch, K, lay, S, T, N)
        for cd in dtypes:
            packed = K.pack_ffn(k1T, mids, kout, bout, cd)
            for rate in rates:
                def kern(p=None):
                    return K._launch_bwd(x, zp, packed, gout, seed, rate, p)
                grads, dzp = kern()
                grads2, dzp2 = kern()
                torch.cuda.synchronize()
                check(torch.equal(grads, grads2)
                      and torch.equal(dzp, dzp2),
                      f"sdf_ffn_bwd not bitwise repeatable at S={S} "
                      f"T={T} N={N} hidden={hidden} {cd} rate {rate}")
                dk1T, dmids, dkout, dbout = K.unpack_grads(
                    grads, packed.layout)
                outs = [dzp, dk1T, dkout, dbout] + [
                    t for wb in dmids for t in wb]

                def plain():
                    return K.sdf_ffn_bwd_reference(
                        x, zp, k1T, mids, kout, gout, cd, seed, rate)
                r = plain()
                refs = [r[0], r[1], r[3], r[4]] + [
                    t for wb in r[2] for t in wb]
                errs = [rel_err(o, q) for o, q in zip(outs, refs)]
                abs_err = max(float((o - q).abs().max())
                              for o, q in zip(outs, refs))
                del r, refs
                bar = GRAD_F32_REL if cd == "float32" else BF16_REL
                worst = max(range(len(errs)), key=errs.__getitem__)
                check(all(bool(torch.isfinite(o).all()) for o in outs),
                      f"non-finite sdf_ffn_bwd output S={S} T={T} N={N} "
                      f"hidden={hidden}")
                check(errs[worst] <= bar,
                      f"sdf_ffn_bwd disagrees with its plain version at "
                      f"S={S} T={T} N={N} hidden={hidden} {cd} rate {rate}: "
                      f"{names[worst]} max|d|/max|ref| {errs[worst]:.3e}")
                ms = cuda_ms(torch, kern, reps=5 if wide else 10, warmup=2)
                plain_ms = cuda_ms(torch, plain, reps=2 if wide else 5,
                                   warmup=1)
                b_ms, b_by = bound(K.bwd_flops(S, T, N, F, hidden),
                                   K.bwd_bytes_moved(S, T, N, F, hidden),
                                   cd)
                print(f"[kernels] bwd hidden={hidden} S={S} T={T:2d} "
                      f"N={N:5d} {cd:8s} drop {rate:.2f}  max|d|/max|ref| "
                      f"{errs[worst]:.2e} ({names[worst]})  kernel {ms:.4f} "
                      f"ms  plain {plain_ms:.4f} ms  bound {b_ms:.4f} ms "
                      f"({b_by})  bitwise-repeatable; {plan_text(pinfo)}",
                      flush=True)
                rows[(S, T, N, cd, rate)] = dict(
                    max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, plan=pinfo,
                    shape=f"S={S} T={T} N={N} F={F} hidden={hidden} {cd} "
                          f"dropout {rate}")
                if (not wide and (S, T, N) == ENS_BWD_ROW
                        and (cd, rate) == ("float32", DROPOUT)):
                    tile_times(torch, K, lay, S, T, N, kern, card)
    return rows


def tile_times(torch, K, lay, S, T, N, kern, card):
    """The backward at every stock tile whose plan fits, same inputs."""
    parts = []
    for tile in K.BWD_TILES:
        try:
            plan, pinfo = bwd_plan_of(torch, K, lay, S, T, N, tile)
        except ValueError:
            continue
        ms = cuda_ms(torch, lambda: kern(plan), reps=5, warmup=1)
        parts.append(f"tile {tile} ({pinfo['blocks_per_sm']}/SM, "
                     f"{pinfo['accumulators']}, regs {pinfo['registers']}) "
                     f"{ms:.4f} ms")
    print(f"[kernels] bwd S={S} T={T} N={N} f32 dropout {DROPOUT} by stock "
          f"tile: " + "; ".join(parts) + f" ({card})", flush=True)


def cem_plan_lines(torch, C, card, Ks=CEM_KS):
    """cem_plan's forward and backward plans at CEM_SHAPES (T = CEM_T), K
    in Ks, both dtypes, as the card holds them; fails if the card keeps
    fewer blocks resident than planned or a kernel spills."""
    dev = torch.device(DEVICE)
    F, T = 46, CEM_T
    for S, N in CEM_SHAPES:
        for Kn in Ks:
            for cd in ("float32", "bfloat16"):
                for p in C.card_cem_plan(dev, S, T, N, F, Kn, cd):
                    info = C.plan_info(p, S, T, N, F, Kn, cd)
                    check(info["blocks_per_sm"] >= p.blocks_per_sm,
                          f"cond_em_{p.kernel} plan {p}: the card holds "
                          f"{info['blocks_per_sm']} blocks per SM")
                    check(info["local_bytes"] == 0,
                          f"cond_em_{p.kernel} {cd} K={Kn} spills "
                          f"{info['local_bytes']} B per thread")
                    print(f"[kernels] cem plan {p.kernel} S={S} T={T} "
                          f"N={N:5d} K={Kn} {cd:8s} route {p.route} tile "
                          f"{p.tile} members {p.members} threads {p.threads}"
                          f" var {p.var} stages {p.stages} smem "
                          f"{p.smem_bytes} B resident "
                          f"{info['blocks_per_sm']}/SM (planned "
                          f"{p.blocks_per_sm}) groups {p.groups} grid "
                          f"{list(p.grid)} ({p.blocks} blocks) regs "
                          f"{info['registers']} local {info['local_bytes']} "
                          f"B ({card})", flush=True)
    for S, T, N, F, Kn in ([(S, T, N, F, Kn) for S, N in CEM_SHAPES
                            for Kn in Ks] + CEM_ODD_SHAPES):
        for cd in ("float32", "bfloat16"):
            dx_plan_line(torch, C, S, T, N, F, Kn, cd, card)


def dx_plan_line(torch, C, S, T, N, F, Kn, cd, card, tile=None):
    """cond_em_dx's plan at one shape as the card holds it; fails if the
    card keeps fewer blocks resident than planned or the kernel spills.
    Returns the plan."""
    p = C.card_cem_dx_plan(torch.device(DEVICE), S, T, N, F, Kn, cd, tile)
    info = C.dx_plan_info(p, S, T, N, F, Kn, cd)
    check(info["blocks_per_sm"] >= p.blocks_per_sm,
          f"cond_em_dx plan {p}: the card holds {info['blocks_per_sm']} "
          "blocks per SM")
    check(info["local_bytes"] == 0,
          f"cond_em_dx {cd} F={F} K={Kn} spills {info['local_bytes']} B "
          "per thread")
    print(f"[kernels] cem plan dx S={S} T={T} N={N:5d} F={F} K={Kn} "
          f"{cd:8s} route {p.route} tile {p.tile} threads {p.threads} "
          f"stages {p.stages} smem {p.smem_bytes} B resident "
          f"{info['blocks_per_sm']}/SM (planned {p.blocks_per_sm}) G {p.G} "
          f"of {p.cells} cells regs {info['registers']} local "
          f"{info['local_bytes']} B ({card})", flush=True)
    return p


def _cem_inputs(torch, g, S, T, N, F, Kn, dev):
    x = torch.randn(T, F, N, generator=g, device=dev)
    zpm = torch.randn(S, T, Kn, generator=g, device=dev) * 0.3
    xr = torch.randn(S, T, N, generator=g, device=dev) * 0.1
    tinv = 1.0 / torch.randint(1, T + 1, (N,), generator=g,
                               device=dev).float()
    kT = torch.randn(S, Kn, F, generator=g, device=dev) * F ** -0.5
    gem = torch.randn(S, Kn, N, generator=g, device=dev) / N
    return x, zpm, xr, tinv, kT, gem


def cond_em_checks(torch, C, card, Ks=CEM_KS, shapes=CEM_SHAPES,
                   dtypes=("float32", "bfloat16"), odd=True):
    """cond_em_fwd / cond_em_bwd against their plain versions at `shapes`
    (S, N), T = CEM_T, K in Ks and each of `dtypes`, each backward twice
    bitwise-equal, then (with `odd`) at CEM_ODD_SHAPES. Returns the rows
    {(kernel, S, N, K, cd): row}, and under "fwd"/"bwd" and
    "ensemble_fwd"/"ensemble_bwd" the training paths' (S = 1 and S = 9,
    N = 10000, K = 8, f32)."""
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(2)
    F, T = 46, CEM_T
    rows = {}
    print(f"[kernels] cond_em vs cond_em_reference, F={F} K={list(Ks)} "
          f"({card})", flush=True)
    for Kn in Ks:
        for S, N in shapes:
            x, zpm, xr, tinv, kT, gem = _cem_inputs(torch, g, S, T, N, F, Kn,
                                                    dev)
            for cd in dtypes:
                bar = GRAD_F32_REL if cd == "float32" else BF16_REL
                em = C._launch_fwd(x, zpm, xr, tinv, kT, cd)
                em_ref = C.cond_em_reference(x, zpm, xr, tinv, kT, cd)
                e_f = rel_err(em, em_ref)
                check(bool(torch.isfinite(em).all()) and e_f <= bar,
                      f"cond_em_fwd disagrees at S={S} N={N} K={Kn} {cd}: "
                      f"{e_f:.3e}")
                outs = C._launch_bwd(x, zpm, xr, tinv, kT, gem, cd)
                outs2 = C._launch_bwd(x, zpm, xr, tinv, kT, gem, cd)
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip(outs, outs2)),
                      f"cond_em_bwd not bitwise repeatable S={S} N={N} "
                      f"K={Kn} {cd}")
                refs = C.cond_em_bwd_reference(x, zpm, xr, tinv, kT, gem,
                                               cd)
                errs = [rel_err(o, r) for o, r in zip(outs, refs)]
                check(all(bool(torch.isfinite(o).all()) for o in outs)
                      and max(errs) <= bar,
                      f"cond_em_bwd disagrees at S={S} N={N} K={Kn} {cd}: "
                      f"dkT/dzp_m/dxr {errs}")
                fns = {"fwd": (lambda: C._launch_fwd(x, zpm, xr, tinv, kT,
                                                      cd),
                               lambda: C.cond_em_reference(x, zpm, xr, tinv,
                                                           kT, cd),
                               C.fwd_flops, C.fwd_bytes_moved,
                               float((em - em_ref).abs().max())),
                       "bwd": (lambda: C._launch_bwd(x, zpm, xr, tinv, kT,
                                                      gem, cd),
                               lambda: C.cond_em_bwd_reference(
                                   x, zpm, xr, tinv, kT, gem, cd),
                               C.bwd_flops, C.bwd_bytes_moved,
                               max(float((o - r).abs().max())
                                   for o, r in zip(outs, refs)))}
                t = {}
                for k, (kern, plain, flops, nbytes, err) in fns.items():
                    # one event-timed call, as every kernel row is timed
                    # (its host launch included), and beside it the device
                    # time from CUDA-graph replays; kernel and plain alike
                    t[k] = dict(ms=cuda_ms(torch, kern),
                                plain_ms=cuda_ms(torch, plain, reps=10),
                                device_ms=graph_ms(torch, kern),
                                plain_device_ms=graph_ms(torch, plain,
                                                         reps=10),
                                bound=bound(flops(S, T, N, F, Kn),
                                            nbytes(S, T, N, F, Kn), cd),
                                err=err)
                    for a, b in (("ms", "plain_ms"),
                                 ("device_ms", "plain_device_ms")):
                        check(t[k][a] < t[k][b],
                              f"cond_em_{k} at S={S} N={N} K={Kn} {cd} is "
                              f"not faster than its plain version ({a}): "
                              f"{t[k][a]:.4f} against {t[k][b]:.4f} ms")
                print(f"[kernels] cond_em S={S} T={T} N={N:5d} K={Kn} "
                      f"{cd:8s} fwd max|d|/max|ref| {e_f:.2e} | bwd "
                      f"{max(errs):.2e} bitwise-repeatable ({card})",
                      flush=True)
                for k, r in t.items():
                    print(f"[kernels]   cond_em_{k} S={S} N={N:5d} K={Kn} "
                          f"{cd:8s} kernel {r['ms']:.4f} ms (device "
                          f"{r['device_ms']:.4f}) plain {r['plain_ms']:.4f} "
                          f"ms (device {r['plain_device_ms']:.4f}) bound "
                          f"{r['bound'][0]:.4f} ms ({r['bound'][1]}) "
                          f"({card})", flush=True)
                for k, r in t.items():
                    rows[(k, S, N, Kn, cd)] = dict(
                        max_abs_err=r["err"], ms=r["ms"],
                        device_ms=r["device_ms"], plain_ms=r["plain_ms"],
                        bound_ms=r["bound"][0], bound_by=r["bound"][1],
                        shape=f"S={S} T={T} N={N} F={F} K={Kn} {cd}")
                    if (cd == "float32" and Kn == 8
                            and (S, N) in (CEM_ROW, ENS_CEM_ROW)):
                        key = k if (S, N) == CEM_ROW else "ensemble_" + k
                        rows[key] = rows[(k, S, N, Kn, cd)]
    # the kernel instances the main paths do not take: F past the tensor
    # cores' k steps (bf16 on the CUDA cores), an odd K, K = 16, empty
    # period groups (T = 5 in 4 groups), a small ragged N
    for S, T, N, F, Kn in CEM_ODD_SHAPES if odd else ():
        x, zpm, xr, tinv, kT, gem = _cem_inputs(torch, g, S, T, N, F, Kn,
                                                dev)
        for cd in ("float32", "bfloat16"):
            bar = GRAD_F32_REL if cd == "float32" else BF16_REL
            em = C._launch_fwd(x, zpm, xr, tinv, kT, cd)
            outs = C._launch_bwd(x, zpm, xr, tinv, kT, gem, cd)
            again = C._launch_bwd(x, zpm, xr, tinv, kT, gem, cd)
            torch.cuda.synchronize()
            errs = [rel_err(em, C.cond_em_reference(x, zpm, xr, tinv, kT,
                                                    cd))] + [
                rel_err(o, r) for o, r in zip(outs, C.cond_em_bwd_reference(
                    x, zpm, xr, tinv, kT, gem, cd))]
            plans = C.card_cem_plan(dev, S, T, N, F, Kn, cd)
            check(all(torch.equal(a, b) for a, b in zip(outs, again))
                  and max(errs) <= bar,
                  f"cond_em at S={S} T={T} N={N} F={F} K={Kn} {cd}: "
                  f"em/dkT/dzp_m/dxr {errs}")
            print(f"[kernels] cond_em S={S} T={T} N={N} F={F} K={Kn} "
                  f"{cd:8s} routes {plans.fwd.route}/{plans.bwd.route}: "
                  f"max|d|/max|ref| {max(errs):.2e}, bitwise-repeatable "
                  f"({card})", flush=True)
    return rows


def compare_cem(torch, C, _nvcc, src_dir, card):
    """The f32 cond_em_fwd, cond_em_bwd and cond_em_dx against an older
    source's (src_dir/cond_em.cu, its one-thread-per-stock kernels and
    argument lists, as at bdd71ce) at S in {1, 3, 9}, N in {10000, 10007},
    K in {4, 8}, and cond_em_dx also at CEM_ODD_SHAPES (K = 5 and 16, F = 10
    and 80): every output bit for bit equal (int32 views), and the two timed
    in turns (old, new, new, old)."""
    import ctypes

    src = Path(src_dir).resolve()
    out = _nvcc.BUILD_DIR / "libcond_em_compare.so"
    _nvcc.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_nvcc.nvcc(), *_nvcc.NVCC_FLAGS, "-o", str(out),
                    str(src / "cond_em.cu")], check=True)
    lib = ctypes.CDLL(str(out))
    lib.cond_em_fwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                                + [ctypes.c_void_p])
    lib.cond_em_bwd.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                                + [ctypes.c_void_p])
    lib.cond_em_dx.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                               + [ctypes.c_void_p])
    lib.cond_em_fwd.restype = lib.cond_em_bwd.restype = ctypes.c_int
    lib.cond_em_dx.restype = ctypes.c_int

    def olds_dx(x, zpm, xr, tinv, kT, gem, bf16=0):
        """The older cond_em_dx on the same inputs (kT rounded by the
        caller, as the wrapper does: a no-op in f32)."""
        T, F, N = x.shape
        S, Kn, _ = kT.shape

        def run():
            o = torch.empty(T, F, N, device=x.device)
            rc = lib.cond_em_dx(
                x.data_ptr(), zpm.data_ptr(), xr.data_ptr(), tinv.data_ptr(),
                kT.data_ptr(), gem.data_ptr(), o.data_ptr(), S, T, F, N, Kn,
                bf16, torch.cuda.current_stream().cuda_stream)
            check(rc == 0, f"the older cond_em_dx failed ({rc})")
            return (o,)
        return run
    dev = torch.device(DEVICE)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(8)
    F, T = 46, CEM_T
    for Kn in (4, 8):
        for S in (1, 3, 9):
            for N in (10000, 10007):
                x, zpm, xr, tinv, kT, gem = _cem_inputs(torch, g, S, T, N, F,
                                                        Kn, dev)
                gf = C._groups(S, T, N, 64, sms, 4)
                gb = C._groups(S, T, N, C.BWD_STOCKS, sms, 4)
                tiles = -(-N // C.BWD_STOCKS)

                def old_fwd():
                    part = torch.empty(S, gf, Kn, N, device=dev)
                    rc = lib.cond_em_fwd(
                        x.data_ptr(), zpm.data_ptr(), xr.data_ptr(),
                        tinv.data_ptr(), kT.data_ptr(), part.data_ptr(), S,
                        T, F, N, Kn, gf, 0,
                        torch.cuda.current_stream().cuda_stream)
                    check(rc == 0, f"the older cond_em_fwd failed ({rc})")
                    return (part.sum(dim=1),)

                def old_bwd():
                    dkt = torch.empty(S, gb * tiles, Kn, F, device=dev)
                    dzp = torch.empty(S, tiles, T, Kn, device=dev)
                    dxr = torch.empty(S, T, N, device=dev)
                    rc = lib.cond_em_bwd(
                        x.data_ptr(), zpm.data_ptr(), xr.data_ptr(),
                        tinv.data_ptr(), kT.data_ptr(), gem.data_ptr(),
                        dkt.data_ptr(), dzp.data_ptr(), dxr.data_ptr(), S, T,
                        F, N, Kn, gb, 0,
                        torch.cuda.current_stream().cuda_stream)
                    check(rc == 0, f"the older cond_em_bwd failed ({rc})")
                    return dkt.sum(dim=1), dzp.sum(dim=1), dxr

                def new_fwd():
                    return (C._launch_fwd(x, zpm, xr, tinv, kT, "float32"),)

                def new_bwd():
                    return C._launch_bwd(x, zpm, xr, tinv, kT, gem,
                                         "float32")

                def new_dx():
                    return (C._launch_dx(x, zpm, xr, tinv, kT, gem,
                                         "float32"),)
                times = []
                for name, old, new in (("fwd", old_fwd, new_fwd),
                                       ("bwd", old_bwd, new_bwd),
                                       ("dx", olds_dx(x, zpm, xr, tinv, kT,
                                                      gem), new_dx)):
                    a, b = old(), new()
                    torch.cuda.synchronize()
                    for u, v in zip(a, b):
                        check(torch.equal(u.view(torch.int32),
                                          v.view(torch.int32)),
                              f"cond_em_{name} f32 differs from the older "
                              f"kernel at S={S} N={N} K={Kn}: max|d| "
                              f"{float((u - v).abs().max()):.3e}")
                    t = [cuda_ms(torch, f) for f in (old, new, new, old)]
                    d = [graph_ms(torch, f) for f in (old, new, new, old)]
                    times.append(f"{name} older {t[0]:.4f} / {t[3]:.4f} ms, "
                                 f"new {t[1]:.4f} / {t[2]:.4f} ms (device: "
                                 f"older {d[0]:.4f} / {d[3]:.4f}, new "
                                 f"{d[1]:.4f} / {d[2]:.4f})")
                print(f"[kernels] cem f32 S={S} T={T} N={N:5d} K={Kn}: bit "
                      f"for bit equal to {src.name}/cond_em.cu; "
                      + "; ".join(times) + f" ({card})", flush=True)
                if (S, N, Kn) == (*ENS_CEM_ROW, 8):
                    # the panel gradient's bf16 call: the two kernels in
                    # turns (held by tolerance, not bit for bit)
                    kb = kT.bfloat16().float()
                    old_bf16 = olds_dx(x, zpm, xr, tinv, kb, gem, 1)

                    def new_bf16():
                        return (C._launch_dx(x, zpm, xr, tinv, kT, gem,
                                             "bfloat16"),)
                    turns = (old_bf16, new_bf16, new_bf16, old_bf16)
                    t = [cuda_ms(torch, f) for f in turns]
                    d = [graph_ms(torch, f) for f in turns]
                    print(f"[kernels] cem dx bf16 S={S} T={T} N={N} K={Kn}: "
                          f"older {t[0]:.4f} / {t[3]:.4f} ms, new {t[1]:.4f}"
                          f" / {t[2]:.4f} ms (device: older {d[0]:.4f} / "
                          f"{d[3]:.4f}, new {d[1]:.4f} / {d[2]:.4f}) "
                          f"({card})", flush=True)
    for S, T, N, F, Kn in CEM_ODD_SHAPES:
        args = _cem_inputs(torch, g, S, T, N, F, Kn, dev)
        old, new = olds_dx(*args), lambda: (C._launch_dx(*args, "float32"),)
        a, b = old()[0], new()[0]
        torch.cuda.synchronize()
        check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
              f"cond_em_dx f32 differs from the older kernel at S={S} T={T} "
              f"N={N} F={F} K={Kn}: max|d| {float((a - b).abs().max()):.3e}")
        t = [cuda_ms(torch, f) for f in (old, new, new, old)]
        print(f"[kernels] cem dx f32 S={S} T={T} N={N} F={F} K={Kn}: bit for "
              f"bit equal to {src.name}/cond_em.cu; older {t[0]:.4f} / "
              f"{t[3]:.4f} ms, new {t[1]:.4f} / {t[2]:.4f} ms ({card})",
              flush=True)


def dx_checks(torch, K, C, card, names=("sdf_ffn_dx", "cond_em_dx")):
    """The panel cotangents sdf_ffn_dx and cond_em_dx (those in `names`)
    against their plain versions at DX_SHAPES, f32 and bf16 (the FFN with
    dropout 0.05, one seed per member, and without, as the panel-gradient
    path runs it: that one also timed by CUDA-graph replays), each two calls
    bitwise-equal; returns the panel-gradient path's rows (S=9, T=48,
    N=10000; the FFN's at dropout 0, and with dropout under key
    (name, dtype, "dropout"))."""
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(4)
    F, hidden, Kn = 46, [64, 64], 8
    lay = K.ffn_layout(F, hidden)
    rows = {}
    print(f"[kernels] sdf_ffn_dx / cond_em_dx vs sdf_ffn_dx_reference / "
          f"cond_em_dx_reference, F={F} hidden={hidden} K={Kn} ({card})",
          flush=True)
    for S, T, N in DX_SHAPES:
        x = torch.randn(T, F, N, generator=g, device=dev)
        zp1, k1T, mids, kout, bout = _ffn_params(torch, g, S, F, hidden,
                                                dev)
        zp = (zp1 + torch.randn(S, T, hidden[0], generator=g,
                                device=dev) * 0.3).contiguous()
        gout = torch.randn(S, T, N, generator=g, device=dev) / N
        seed = 9 if S == 1 else list(range(9, 9 + S))
        zpm = torch.randn(S, T, Kn, generator=g, device=dev) * 0.3
        xr = torch.randn(S, T, N, generator=g, device=dev) * 0.1
        tinv = 1.0 / torch.randint(1, T + 1, (N,), generator=g,
                                   device=dev).float()
        kT = torch.randn(S, Kn, F, generator=g, device=dev) * F ** -0.5
        gem = torch.randn(S, Kn, N, generator=g, device=dev) / N
        for cd in ("float32", "bfloat16"):
            packed = K.pack_ffn(k1T, mids, kout, bout, cd)
            cases = []
            if "sdf_ffn_dx" in names:
                for rate in (0.0, DROPOUT):
                    cases.append((
                        "sdf_ffn_dx", rate,
                        lambda r=rate: K._launch_dx(x, zp, packed, gout,
                                                    seed, r),
                        lambda r=rate: K.sdf_ffn_dx_reference(
                            x, zp, k1T, mids, kout, gout, cd, seed, r),
                        K.dx_flops(S, T, N, F, hidden),
                        K.dx_bytes_moved(S, T, N, F, hidden),
                        f"dropout {rate}"))
            if "cond_em_dx" in names:
                cases.append((
                    "cond_em_dx", None,
                    lambda: C._launch_dx(x, zpm, xr, tinv, kT, gem, cd),
                    lambda: C.cond_em_dx_reference(x, zpm, xr, tinv, kT,
                                                   gem, cd),
                    C.dx_flops(S, T, N, F, Kn),
                    C.dx_bytes_moved(S, T, N, F, Kn), f"K={Kn}"))
            for name, rate, kern, plain, flops, nbytes, what in cases:
                out, again = kern(), kern()
                torch.cuda.synchronize()
                check(torch.equal(out, again), f"{name} not bitwise "
                      f"repeatable at S={S} T={T} N={N} {cd} {what}")
                ref = plain()
                err = rel_err(out, ref)
                check(bool(torch.isfinite(out).all())
                      and err <= (GRAD_F32_REL if cd == "float32"
                                  else BF16_REL),
                      f"{name} disagrees with its plain version at S={S} "
                      f"T={T} N={N} {cd} {what}: max|d|/max|ref| {err:.3e}")
                ms = cuda_ms(torch, kern, reps=10, warmup=2)
                plain_ms = cuda_ms(torch, plain, reps=5, warmup=1)
                b_ms, b_by = bound(flops, nbytes, cd)
                row = dict(max_abs_err=float((out - ref).abs().max()), ms=ms,
                           plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                           shape=f"S={S} T={T} N={N} F={F} {cd} {what}")
                extra = ""
                if rate in (None, 0.0):  # the panel-gradient path's own call
                    row["graph_ms"] = graph_ms(torch, kern)
                    extra = f" (device {row['graph_ms']:.4f} ms)"
                if name == "cond_em_dx":
                    plan = C.card_cem_dx_plan(dev, S, T, N, F, Kn, cd)
                    row["plan"] = dataclasses.asdict(plan)
                    extra += (f"  plan route {plan.route} tile {plan.tile} "
                              f"threads {plan.threads} "
                              f"{plan.blocks_per_sm}/SM G {plan.G}")
                if name == "sdf_ffn_dx":
                    plan = K.card_dx_plan(lay, dev, S, T, N, cd)
                    row["plan"] = dict(
                        route=plan.route, tile=plan.tile,
                        threads=plan.threads, wbufs=plan.wbufs,
                        xbufs=plan.xbufs, blocks_per_sm=plan.blocks_per_sm,
                        G=plan.G)
                    extra += (f"  plan route {plan.route} tile {plan.tile} "
                              f"threads {plan.threads} buffers {plan.wbufs} "
                              f"{'(resident)' if plan.resident else ''} / "
                              f"{plan.xbufs} {plan.blocks_per_sm}/SM G "
                              f"{plan.G}")
                print(f"[kernels] {name} S={S} T={T} N={N:5d} {cd:8s} "
                      f"{what}: max|d|/max|ref| {err:.2e}  kernel "
                      f"{ms:.4f} ms{extra}  plain {plain_ms:.4f} ms  bound "
                      f"{b_ms:.4f} ms ({b_by})  bitwise-repeatable",
                      flush=True)
                if (S, T, N) == DX_ROW:
                    key = ((name, cd) if rate in (None, 0.0)
                           else (name, cd, "dropout"))
                    rows[key] = row
                    if name == "sdf_ffn_dx" and rate == 0.0:
                        dx_tile_times(torch, K, lay, S, T, N, cd, x, zp,
                                      packed, gout, card)
                    if name == "cond_em_dx":
                        cem_dx_tile_times(torch, C, S, T, N, F, Kn, cd,
                                          (x, zpm, xr, tinv, kT, gem), card)
    if "sdf_ffn_dx" in names:
        for S, T, N, F, hidden in DX_ODD_SHAPES:
            x = torch.randn(T, F, N, generator=g, device=dev)
            zp1, k1T, mids, kout, bout = _ffn_params(torch, g, S, F,
                                                    list(hidden), dev)
            zp = (zp1 + torch.randn(S, T, hidden[0], generator=g,
                                    device=dev) * 0.3).contiguous()
            gout = torch.randn(S, T, N, generator=g, device=dev) / N
            seed = list(range(13, 13 + S))
            for cd in ("float32", "bfloat16"):
                packed = K.pack_ffn(k1T, mids, kout, bout, cd)
                for rate in (0.0, DROPOUT):
                    out = K._launch_dx(x, zp, packed, gout, seed, rate)
                    again = K._launch_dx(x, zp, packed, gout, seed, rate)
                    torch.cuda.synchronize()
                    err = rel_err(out, K.sdf_ffn_dx_reference(
                        x, zp, k1T, mids, kout, gout, cd, seed, rate))
                    check(torch.equal(out, again)
                          and bool(torch.isfinite(out).all())
                          and err <= (GRAD_F32_REL if cd == "float32"
                                      else BF16_REL),
                          f"sdf_ffn_dx at S={S} T={T} N={N} F={F} hidden="
                          f"{list(hidden)} {cd} dropout {rate}: max|d|/"
                          f"max|ref| {err:.3e}, or not bitwise repeatable")
                    plan = K.card_dx_plan(packed.layout, dev, S, T, N, cd)
                    print(f"[kernels] sdf_ffn_dx S={S} T={T} N={N} F={F} "
                          f"hidden={list(hidden)} {cd:8s} dropout {rate}: "
                          f"max|d|/max|ref| {err:.2e}  route {plan.route} "
                          f"tile {plan.tile}  bitwise-repeatable ({card})",
                          flush=True)
        wide_checks(torch, K, card, "dx")
    if "cond_em_dx" in names:
        # the conditional-EM's instances off the main path: bf16 on the CUDA
        # cores (F > 64), an odd K on a ten-feature panel, K = 16
        for S, T, N, F, Kn in CEM_ODD_SHAPES:
            args = _cem_inputs(torch, g, S, T, N, F, Kn, dev)
            for cd in ("float32", "bfloat16"):
                out = C._launch_dx(*args, cd)
                again = C._launch_dx(*args, cd)
                torch.cuda.synchronize()
                err = rel_err(out, C.cond_em_dx_reference(*args, cd))
                plan = C.card_cem_dx_plan(dev, S, T, N, F, Kn, cd)
                check(torch.equal(out, again)
                      and bool(torch.isfinite(out).all())
                      and err <= (GRAD_F32_REL if cd == "float32"
                                  else BF16_REL),
                      f"cond_em_dx at S={S} T={T} N={N} F={F} K={Kn} {cd}: "
                      f"max|d|/max|ref| {err:.3e}, or not bitwise "
                      "repeatable")
                print(f"[kernels] cond_em_dx S={S} T={T} N={N} F={F} K={Kn} "
                      f"{cd:8s}: max|d|/max|ref| {err:.2e}  route "
                      f"{plan.route} tile {plan.tile}  bitwise-repeatable "
                      f"({card})", flush=True)
    return rows


def cem_dx_tile_times(torch, C, S, T, N, F, Kn, cd, args, card):
    """cond_em_dx at every stock tile whose plan fits, same inputs, device
    time from CUDA-graph replays."""
    parts = []
    route_tiles = C.DX_MMA_TILES if C.dx_route(F, cd) else C.DX_TILES
    for tile in route_tiles:
        try:
            plan = dx_plan_line(torch, C, S, T, N, F, Kn, cd, card, tile)
        except ValueError:
            continue
        ms = graph_ms(torch, lambda: C._launch_dx(*args, cd, plan), reps=10)
        parts.append(f"tile {tile} ({plan.threads} threads, "
                     f"{plan.blocks_per_sm}/SM, G {plan.G}) {ms:.4f} ms")
    print(f"[kernels] cond_em_dx S={S} T={T} N={N} K={Kn} {cd} by stock tile "
          f"(device): " + "; ".join(parts) + f" ({card})", flush=True)


def dx_tile_times(torch, K, lay, S, T, N, cd, x, zp, packed, gout, card):
    """The panel cotangent without dropout at every stock tile whose plan
    fits, same inputs, device time from CUDA-graph replays."""
    dev = torch.device(DEVICE)
    parts = []
    for tile in K.DX_TILES:
        try:
            plan = K.card_dx_plan(lay, dev, S, T, N, cd, tile)
        except ValueError:
            continue
        ms = graph_ms(torch, lambda: K._launch_dx(x, zp, packed, gout, 0, 0.0,
                                                  plan), reps=10)
        parts.append(f"tile {tile} ({plan.threads} threads, "
                     f"{plan.blocks_per_sm}/SM, buffers {plan.wbufs} / "
                     f"{plan.xbufs}) {ms:.4f} ms")
    print(f"[kernels] dx S={S} T={T} N={N} {cd} no dropout by stock tile "
          f"(device): " + "; ".join(parts) + f" ({card})", flush=True)


def compare_dx(torch, K, _nvcc, src_dir, card):
    """The f32 sdf_ffn_dx against an older source's (src_dir/sdf_ffn_bwd.cu,
    its one-thread-per-stock kernel and argument list, built once per width
    bound) at DX_SHAPES (hidden (64, 64)) and at WIDE_HIDDEN × WIDE_SHAPES,
    dropout 0 and 0.05: bit for bit equal (int32 views), and the two timed
    in turns (old, new, new, old), without dropout also by CUDA-graph
    replays."""
    import ctypes

    src = Path(src_dir).resolve()
    _nvcc.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, olds = {}, {}
    for w in K.WIDTH_BOUNDS:
        out = _nvcc.BUILD_DIR / f"libsdf_ffn_dx_compare_w{w}.so"
        procs[w] = (out, subprocess.Popen(
            [_nvcc.nvcc(), *_nvcc.NVCC_FLAGS, f"-DSDF_FFN_MAXW={w}", "-o",
             str(out), str(src / "sdf_ffn_bwd.cu")]))
    for w, (out, proc) in procs.items():
        check(proc.wait() == 0, f"the older {src.name}/sdf_ffn_bwd.cu (w{w}) "
              "did not build")
        fn = ctypes.CDLL(str(out)).sdf_ffn_dx
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p, ctypes.c_uint,
                          ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        olds[w] = fn
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(12)
    F = 46
    cases = ([((64, 64), sh) for sh in DX_SHAPES]
             + [(h, sh) for h in WIDE_HIDDEN for sh in WIDE_SHAPES])
    for hidden, (S, T, N) in cases:
        x = torch.randn(T, F, N, generator=g, device=dev)
        zp1, k1T, mids, kout, bout = _ffn_params(torch, g, S, F,
                                                list(hidden), dev)
        zp = (zp1 + torch.randn(S, T, hidden[0], generator=g,
                                device=dev) * 0.3).contiguous()
        gout = torch.randn(S, T, N, generator=g, device=dev) / N
        seed = 9 if S == 1 else list(range(9, 9 + S))
        packed = K.pack_ffn(k1T, mids, kout, bout, "float32")
        old = olds[K.width_bound(hidden)]
        for rate in (0.0, DROPOUT):
            drop, bases = K._dropout_args(seed, rate, S, dev)

            def run_old():
                o = torch.empty(T, F, N, device=dev)
                rc = old(x.data_ptr(), zp.data_ptr(), packed.params.data_ptr(),
                         gout.data_ptr(), o.data_ptr(), S, T, N,
                         K._layout_ints(packed.layout), 0, *drop,
                         torch.cuda.current_stream().cuda_stream)
                check(rc == 0, f"the older sdf_ffn_dx failed (code {rc})")
                return o

            def run_new():
                return K._launch_dx(x, zp, packed, gout, seed, rate)
            a, b = run_old(), run_new()
            torch.cuda.synchronize()
            check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
                  f"sdf_ffn_dx f32 differs from the older kernel at hidden="
                  f"{list(hidden)} S={S} T={T} N={N} dropout {rate}: max|d| "
                  f"{float((a - b).abs().max()):.3e}")
            t = [cuda_ms(torch, f, reps=10) for f in (run_old, run_new,
                                                      run_new, run_old)]
            line = (f"older {t[0]:.4f} / {t[3]:.4f} ms, new {t[1]:.4f} / "
                    f"{t[2]:.4f} ms")
            if rate == 0.0:
                d = [graph_ms(torch, f, reps=10) for f in (run_old, run_new,
                                                           run_new, run_old)]
                line += (f" (device: older {d[0]:.4f} / {d[3]:.4f}, new "
                         f"{d[1]:.4f} / {d[2]:.4f})")
            print(f"[kernels] dx f32 hidden={list(hidden)} S={S} T={T} "
                  f"N={N:5d} drop {rate:.2f}: bit for bit equal to "
                  f"{src.name}/sdf_ffn_bwd.cu; {line} ({card})", flush=True)
            del bases


def ceiling_checks(torch, MB, card):
    """matmul_ceiling against its plain version at CEILING_CHECKS (padded
    K and M, two row slices, ragged BN) and, bit for bit, at
    CEILING_EXACT_CHECKS (the timed configuration); then the roofline path:
    measure_matmul_ceiling at MODEL_MATMUL_SHAPES with the JAX defaults
    (S = 9, BN 2048, 8 repeats x 64 steps), launches counted, beside
    cuBLAS (torch.matmul of the same bf16 [S, M, K] x [K, BN] stack, as
    many calls as the kernel's repeats x steps, replayed from one CUDA
    graph so that host dispatch is not timed). Returns the kernels-line
    row, which carries the per-shape ceilings."""
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(6)
    errs, abs_errs = [], []
    for m, k, bn, S, reps, steps in CEILING_CHECKS:
        w = torch.randn(S, m, k, generator=g, device=dev).bfloat16()
        x = torch.randn(k, bn, generator=g, device=dev).bfloat16()
        out = MB.matmul_ceiling(w, x, reps, steps)
        ref = MB.matmul_ceiling_reference(w, x, reps, steps)
        torch.cuda.synchronize()
        err = rel_err(out, ref)
        errs.append(err)
        abs_errs.append(float((out - ref).abs().max()))
        check(bool(torch.isfinite(out).all()) and err <= GRAD_F32_REL,
              f"matmul_ceiling disagrees with its plain version at "
              f"M={m} K={k} BN={bn} S={S}: max|d|/max|ref| {err:.3e}")
    print(f"[kernels] matmul_ceiling vs matmul_ceiling_reference at "
          f"{CEILING_CHECKS} (M, K, BN, S, repeats, steps): "
          f"max|d|/max|ref| {max(errs):.2e} ({card})", flush=True)
    for m, k, bn, S, reps, steps in CEILING_EXACT_CHECKS:
        w = torch.randint(-2, 3, (S, m, k), generator=g, device=dev)
        x = torch.randint(-2, 3, (k, bn), generator=g, device=dev)
        out = MB.matmul_ceiling(w.bfloat16(), x.bfloat16(), reps, steps)
        ref = MB.matmul_ceiling_reference(w.bfloat16(), x.bfloat16(), reps,
                                          steps)
        torch.cuda.synchronize()
        check(torch.equal(out, ref),
              f"matmul_ceiling differs from its plain version on integer "
              f"operands at M={m} K={k} BN={bn} S={S} {reps} x {steps}: "
              f"max|d| {float((out - ref).abs().max())}")
    print(f"[kernels] matmul_ceiling == matmul_ceiling_reference bit for bit "
          f"on integer operands at {CEILING_EXACT_CHECKS} (the timed "
          f"configuration) ({card})", flush=True)

    S, bn, reps, steps = 9, 2048, 8, 64
    plans = {}
    for m, k in MB.MODEL_MATMUL_SHAPES:
        plan = MB.card_ceiling_plan(dev, S, m, k, bn, steps)
        info = MB.ceiling_plan_info(plan, S, m, k, bn)
        check(info["local_bytes"] == 0, f"matmul_ceiling {m}x{k} spills "
              f"{info['local_bytes']} B per thread")
        plans[f"{m}x{k}"] = dict(dataclasses.asdict(plan),
                                 registers=info["registers"])
        print(f"[ceiling] plan {m}x{k}: {plan.warpgroups} warpgroups, width "
              f"{plan.width} ({plan.slices} slice) × {plan.stack} members a "
              f"product (m64n{plan.n}k16), {plan.kchunks} k chunk(s) "
              f"of {plan.ksteps} k steps, {plan.layout}, smem "
              f"{plan.smem_bytes} B, resident {info['blocks_per_sm']}/SM "
              f"(planned {plan.blocks_per_sm}), {plan.groups} step groups, "
              f"grid {list(plan.grid)} ({plan.blocks} blocks), regs "
              f"{info['registers']} local {info['local_bytes']} B ({card})",
              flush=True)
    MB.reset_launch_count()
    # 20 timed calls, not the JAX default 3: one call takes a fraction of a
    # millisecond, too short a span to time in three
    ceiling = MB.measure_matmul_ceiling(timed_calls=20, device=DEVICE)
    torch.cuda.synchronize()
    launches = MB.launches
    check(launches > 0, "the roofline path launched matmul_ceiling no time")
    blended = MB.model_shape_ceiling_tflops(ceiling)
    ms = plain_ms = library_ms = device_ms = 0.0
    flops = nbytes = 0
    for m, k in MB.MODEL_MATMUL_SHAPES:
        rec = ceiling[f"{m}x{k}"]
        check(rec["tflops"] <= 1.05 * 989.0,
              f"matmul_ceiling {m}x{k} reads {rec['tflops']:.1f} TFLOP/s, "
              "above 105% of the card's 989 TFLOP/s bf16 peak")
        w = torch.randn(S, m, k, generator=g, device=dev).bfloat16()
        x = torch.randn(k, bn, generator=g, device=dev).bfloat16()
        rec["graph_ms"] = graph_ms(torch, lambda: MB.matmul_ceiling(
            w, x, reps, steps), reps=5)
        device_ms += rec["graph_ms"]

        def cublas():
            for _ in range(reps * steps):
                torch.matmul(w, x)
        lib_ms = cuda_ms(torch, graph_of(torch, cublas).replay, reps=5,
                         warmup=1)
        p_ms = cuda_ms(torch, lambda: MB.matmul_ceiling_reference(
            w, x, reps, steps), reps=5, warmup=1)
        f = 2 * m * k * bn * S * reps * steps
        rec["cublas_tflops"] = f / (lib_ms / 1e3) / 1e12
        ms += rec["seconds"] * 1e3
        plain_ms += p_ms
        library_ms += lib_ms
        flops += f
        nbytes += 2 * (S * m * k + k * bn) + 4 * m * bn
        print(f"[ceiling] {m}x{k}: {rec['tflops']:.2f} TFLOP/s "
              f"({rec['seconds'] * 1e3:.4f} ms per call, device "
              f"{rec['graph_ms']:.4f} ms from CUDA-graph replays, of "
              f"{rec['gflops_per_call']:.2f} GFLOP), "
              f"{rec['fraction_of_dense_128']:.3f} of 128x128; cuBLAS "
              f"{rec['cublas_tflops']:.2f} TFLOP/s ({lib_ms:.4f} ms for "
              f"{reps * steps} torch.matmul calls in one CUDA graph) "
              f"({card})", flush=True)
    print(f"[ceiling] model_shape_ceiling_tflops {blended} (S={S}, BN {bn},"
          f" {reps} x {steps}; {launches} launches) ({card})", flush=True)
    b_ms, b_by = bound(flops, nbytes, "bfloat16")
    row = dict(max_abs_err=max(abs_errs), ms=ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
               graph_ms=device_ms, plan=plans,
               launches_by_path={"roofline": launches},
               model_shape_ceiling_tflops=blended,
               per_shape={key: rec for key, rec in ceiling.items()
                          if key != "note"},
               shape=f"MODEL_MATMUL_SHAPES S={S} BN={bn} {reps}x{steps} "
                     "bf16, one call per shape")
    return row


def compare_ceiling(torch, MB, _nvcc, src_dir, card):
    """The ceiling against an older source's (src_dir/microbench.cu, its
    mma.sync kernel and argument lists, as at a09a4f7): bit for bit on
    integer operands at CEILING_EXACT_CHECKS, then each of the model's
    shapes at the JAX defaults timed in turns (old, new, new, old), 20
    calls after one warm-up each, as measure_matmul_ceiling times them."""
    import ctypes

    src = Path(src_dir).resolve()
    out = _nvcc.BUILD_DIR / "libmicrobench_compare.so"
    _nvcc.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_nvcc.nvcc(), *_nvcc.NVCC_FLAGS, "-o", str(out),
                    str(src / "microbench.cu")], check=True)
    lib = ctypes.CDLL(str(out))
    lib.matmul_ceiling.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                                   + [ctypes.c_void_p])
    lib.matmul_ceiling_occupancy.argtypes = (
        [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 2)
    lib.matmul_ceiling.restype = ctypes.c_int
    lib.matmul_ceiling_occupancy.restype = ctypes.c_int
    dev = torch.device(DEVICE)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(14)

    def old_of(w, x, reps, steps):
        S, M, K = w.shape
        BN = x.shape[1]
        blocks, per_sm = ctypes.c_int(), ctypes.c_int()
        check(lib.matmul_ceiling_occupancy(S, M, K, BN, ctypes.byref(blocks),
                                           ctypes.byref(per_sm)) == 0,
              "the older matmul_ceiling has no occupancy")
        groups = MB.step_groups(steps, blocks.value, sms * per_sm.value)

        def run():
            part = torch.empty(groups, M, BN, device=dev)
            rc = lib.matmul_ceiling(w.data_ptr(), x.data_ptr(),
                                    part.data_ptr(), S, M, K, BN, reps,
                                    steps, groups,
                                    torch.cuda.current_stream().cuda_stream)
            check(rc == 0, f"the older matmul_ceiling failed ({rc})")
            return part.sum(dim=0)
        return run

    for m, k, bn, S, reps, steps in CEILING_EXACT_CHECKS:
        w = torch.randint(-2, 3, (S, m, k), generator=g,
                          device=dev).bfloat16()
        x = torch.randint(-2, 3, (k, bn), generator=g, device=dev).bfloat16()
        a = old_of(w, x, reps, steps)()
        b = MB.matmul_ceiling(w, x, reps, steps)
        torch.cuda.synchronize()
        check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
              f"matmul_ceiling differs from the older kernel at M={m} K={k} "
              f"on integer operands: max|d| {float((a - b).abs().max())}")
    print(f"[ceiling] bit for bit equal to {src.name}/microbench.cu on "
          f"integer operands at {CEILING_EXACT_CHECKS} ({card})", flush=True)

    def per_call_ms(fn, calls=20):
        fn()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / calls

    S, bn, reps, steps = 9, 2048, 8, 64
    total = [0.0] * 4
    for m, k in MB.MODEL_MATMUL_SHAPES:
        w = torch.randn(S, m, k, generator=g, device=dev).bfloat16()
        x = torch.randn(k, bn, generator=g, device=dev).bfloat16()
        old = old_of(w, x, reps, steps)

        def new():
            return MB.matmul_ceiling(w, x, reps, steps)
        t = [per_call_ms(f) for f in (old, new, new, old)]
        total = [a + b for a, b in zip(total, t)]
        tf = [2 * m * k * bn * S * reps * steps / (v / 1e3) / 1e12 for v in t]
        print(f"[ceiling] {m}x{k} older {t[0]:.4f} / {t[3]:.4f} ms "
              f"({tf[0]:.1f} / {tf[3]:.1f} TFLOP/s), new {t[1]:.4f} / "
              f"{t[2]:.4f} ms ({tf[1]:.1f} / {tf[2]:.1f} TFLOP/s) ({card})",
              flush=True)
    print(f"[ceiling] sum of the four shapes: older {total[0]:.4f} / "
          f"{total[3]:.4f} ms, new {total[1]:.4f} / {total[2]:.4f} ms "
          f"({card})", flush=True)


# -- phase 4 ------------------------------------------------------------------

# the months of the hot-reload checks (4b)
RELOAD_MONTHS = (0, 5, 11, 23)


def post(url: str, body, raw: bool = False):
    """POST a JSON body (bytes or a dict) or, with ``raw``, a raw-f32 body:
    (status, decoded answer — a float32 array off the raw wire, the error
    text for a non-200)."""
    from deeplearninginassetpricing_paperreplication_torch.serving.server \
        import BINARY_CONTENT_TYPE

    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method="POST", headers={
        "Content-Type": BINARY_CONTENT_TYPE if raw else "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            out = r.read()
            return r.status, (np.frombuffer(out, np.float32) if raw
                              else json.loads(out))
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(errors="replace")


def get(url: str):
    with urllib.request.urlopen(url, timeout=60) as r:
        out = r.read()
        try:
            return r.status, json.loads(out)
        except json.JSONDecodeError:
            return r.status, out.decode()


def _b64(a) -> str:
    import base64

    return base64.b64encode(np.ascontiguousarray(a, np.float32)
                            .tobytes()).decode()


def _unb64(s: str) -> np.ndarray:
    import base64

    return np.frombuffer(base64.b64decode(s), np.float32)


def _raw_body(month: int, individual: np.ndarray) -> bytes:
    import struct

    x = np.ascontiguousarray(individual, np.float32)
    return struct.pack("<iI", month, x.shape[0]) + x.tobytes()


def serving_bodies(test):
    """Per test month, encoded once (a request's time is the server's and
    the transport's, not the client's encoding): the JSON body (the full
    cross-section with its mask and returns), its base64 twin, and the
    valid rows alone (the raw-f32 wire carries no mask) as raw-f32 and
    base64 bodies."""
    mask = test.mask.astype(np.float32)
    out = []
    for t in range(test.T):
        valid = test.mask[t] > 0
        out.append(dict(
            json=json.dumps({"individual": test.individual[t].tolist(),
                             "mask": mask[t].tolist(),
                             "returns": test.returns[t].tolist(),
                             "month": t}).encode(),
            b64=json.dumps({"individual_b64": _b64(test.individual[t]),
                            "mask_b64": _b64(mask[t]),
                            "returns_b64": _b64(test.returns[t]),
                            "month": t, "encoding": "b64"}).encode(),
            raw=_raw_body(t, test.individual[t][valid]),
            b64_valid=json.dumps({
                "individual_b64": _b64(test.individual[t][valid]),
                "returns_b64": _b64(test.returns[t][valid]), "month": t,
                "encoding": "b64"}).encode(),
            valid=valid))
    return out


def _behind_plug(service, send_plug, sends, ready):
    """Run `sends` concurrently while a plug request holds the dispatcher:
    the engine's dispatch lock is held, the continuous batcher takes the
    plug and blocks on the lock, the `sends` queue (or coalesce) behind it
    until `ready()`, then the lock is released — so the batcher sees them
    all at once. Returns the sends' answers in order."""
    from concurrent.futures import ThreadPoolExecutor

    cb = service.cbatcher
    with ThreadPoolExecutor(len(sends) + 1) as pool:
        with service.engine._infer_lock:
            flushes = cb.flushes
            plug = pool.submit(send_plug)
            _wait_until(lambda: cb.flushes > flushes, "the plug's flush")
            futs = [pool.submit(f) for f in sends]
            _wait_until(ready, "the concurrent requests to queue")
        check(plug.result(timeout=600)[0] == 200, "the plug request failed")
        return [f.result(timeout=600) for f in futs]


def _wait_until(cond, what: str, timeout: float = 60.0) -> None:
    t0 = time.monotonic()
    while not cond():
        check(time.monotonic() - t0 < timeout, f"timed out waiting for {what}")
        time.sleep(0.002)


def serve_and_check(torch, dtype, test, offline, bodies, card, K,
                    server_mod):
    """Serve the three-member ensemble at `dtype` through the async front
    end on a free port, from a launch count of 0: the service's warmup
    (one uncaptured forward and one CUDA-graph capture per bucket), every
    test month over the JSON, base64 and raw-f32 wires, the batch-4 groups
    as four concurrent requests the continuous batcher folds into one
    flush, identical concurrent requests coalesced, a repeated request
    from the cache, two macro appends; every answer held against
    `offline`, the wires bit for bit one another."""
    from deeplearninginassetpricing_paperreplication_torch.observability \
        .metrics import parse_prom_text
    from deeplearninginassetpricing_paperreplication_torch.serving import (
        AsyncServerThread,
        pick_free_port,
    )

    K.reset_launch_count()  # the main path starts at the service's build
    args = server_mod.build_arg_parser().parse_args(
        ["--checkpoint_dirs", *[str(ROOT / d) for d in REF_RUNS],
         "--data_dir", str(DATA_DIR), "--device", DEVICE,
         "--compute_dtype", dtype])
    t0 = time.perf_counter()
    service = server_mod.build_service(args)
    warm_s = time.perf_counter() - t0
    eng = service.engine
    n_buckets = len(eng.stock_buckets) * len(eng.batch_buckets)
    check(eng.stats()["captures"] == n_buckets,
          f"warmup captured {eng.stats()['captures']} graphs for "
          f"{n_buckets} buckets")
    server = AsyncServerThread(service, port=pick_free_port())
    base = f"http://127.0.0.1:{server.start()}"
    # the full cross-section lands in the smallest stock bucket holding it
    bucket = min(b for b in eng.stock_buckets if b >= test.N)
    avg_ref = offline["avg_weights"]
    port_ref = offline["ensemble_port_returns"]
    lat = {"json": [], "b64": [], "raw": [], "b64_valid": []}
    errs_w, errs_sdf = [], []

    def timed(wire, url, body, raw=False):
        t1 = time.perf_counter()
        out = post(url, body, raw=raw)
        lat[wire].append(time.perf_counter() - t1)
        return out

    def check_weights(t, w, ref, n):
        check(w.shape == (n,) and bool(np.isfinite(w).all()),
              f"bad weights at month {t}: shape {w.shape}")
        check(abs(np.abs(w).sum() - 1.0) < 1e-4,
              f"sum|w| = {np.abs(w).sum()} at month {t}")
        dw = np.abs(w - ref)
        errs_w.append(float(dw.max()))
        check(within(dw, ref, dtype, **SERVE_F32_TOL),
              f"served weights != offline at month {t} ({dtype}): "
              f"max|d| {dw.max():.3e}")

    def check_sdf(t, sdf):
        check(sdf is not None and np.isfinite(sdf), f"non-finite sdf {t}")
        ds = abs(sdf - port_ref[t])
        errs_sdf.append(ds)
        check(within(np.array([ds]), port_ref, dtype, **SERVE_F32_TOL)
              if dtype == "bfloat16" else
              ds <= SERVE_F32_TOL["atol"]
              + SERVE_F32_TOL["rtol"] * abs(port_ref[t]),
              f"served sdf != offline at month {t} ({dtype}): |d| {ds:.3e}")

    def check_answer(t, ans_w, ans_s, b=1):
        check(ans_w["month"] == t and ans_w["n"] == test.N
              and ans_w["bucket"] == bucket and ans_w["batch_bucket"] == b,
              f"bad answer header {ans_w} (batch bucket {b})")
        w = (np.asarray(ans_w["weights"]) if "weights" in ans_w
             else _unb64(ans_w["weights_b64"]))
        check_weights(t, w, avg_ref[t], test.N)
        member = (np.asarray(ans_s["member_sdf"]) if "member_sdf" in ans_s
                  else _unb64(ans_s["member_sdf_b64"]))
        check(member.shape == (eng.n_members,)
              and bool(np.isfinite(member).all()),
              f"non-finite member sdf month {t}")
        check_sdf(t, ans_s["sdf"])
        return w, member

    try:
        b64_answers = {}
        for t in range(test.T):  # batch bucket 1, every wire
            body = bodies[t]
            sw, jw = timed("json", base + "/v1/weights", body["json"])
            ss, js = post(base + "/v1/sdf", body["json"])
            check(sw == 200 and ss == 200, f"JSON HTTP {sw}/{ss} month {t}")
            jw_w, js_m = check_answer(t, jw, js)
            sw, bw = timed("b64", base + "/v1/weights", body["b64"])
            ss, bs = post(base + "/v1/sdf", body["b64"])
            check(sw == 200 and ss == 200, f"b64 HTTP {sw}/{ss} month {t}")
            bw_w, bs_m = check_answer(t, bw, bs)
            b64_answers[t] = bs
            # the wires bit for bit one another: same month, same batch
            check(np.array_equal(jw_w.astype(np.float32), bw_w)
                  and js["sdf"] == bs["sdf"]
                  and np.array_equal(js_m.astype(np.float32), bs_m),
                  f"JSON and base64 answers differ at month {t}")
            valid = body["valid"]
            sr, rw = timed("raw", base + "/v1/weights", body["raw"],
                           raw=True)
            sv, vw = timed("b64_valid", base + "/v1/sdf", body["b64_valid"])
            check(sr == 200 and sv == 200, f"raw HTTP {sr}/{sv} month {t}")
            check_weights(t, rw, avg_ref[t][valid], int(valid.sum()))
            check_sdf(t, vw["sdf"])
            sv, vw = post(base + "/v1/weights", body["b64_valid"])
            check(sv == 200 and np.array_equal(rw, _unb64(vw["weights_b64"])),
                  f"raw-f32 and base64 answers differ at month {t}")
        # a repeated request: from the cache, the same answer
        s, again = post(base + "/v1/sdf", bodies[3]["b64"])
        check(s == 200 and again["cached"] is True
              and again["sdf"] == b64_answers[3]["sdf"],
              "a repeated request was not answered from the cache")
        # batch bucket 4: each group's four /v1/weights and four /v1/sdf
        # requests sent concurrently behind a plug (a raw request of another
        # month) fold into two flushes of four; "fold" makes each body new
        # to the cache, so it reaches the batcher
        hist0 = dict(service.cbatcher.occupancy_hist)
        groups = 0
        for t0_ in range(0, test.T, 4):
            group = list(range(t0_, min(t0_ + 4, test.T)))
            sends = [lambda t=t, ep=ep: post(base + ep, dict(
                json.loads(bodies[t]["b64"]), fold=True))
                for ep in ("/v1/weights", "/v1/sdf") for t in group]
            answers = _behind_plug(
                service,
                lambda t=t0_: post(base + "/v1/weights",
                                   bodies[(t + 4) % test.T]["raw"], raw=True),
                sends, lambda n=len(sends): service.cbatcher.pending() == n)
            n = len(group)
            for t, (sw, aw), (ss, as_) in zip(group, answers[:n],
                                               answers[n:]):
                check(sw == 200 and ss == 200,
                      f"HTTP {sw}/{ss} in the group at month {t}")
                check_answer(t, aw, as_, b=4)
            groups += 1
        folded = service.cbatcher.occupancy_hist.get(4, 0) - hist0.get(4, 0)
        check(folded == 2 * groups,
              f"{folded} flushes of 4 for {groups} groups of 4 + 4 requests")
        # identical concurrent requests: one dispatch, the rest coalesced
        hits0 = service.coalesce_hits
        same = _behind_plug(
            service,
            lambda: post(base + "/v1/weights", bodies[1]["raw"], raw=True),
            [lambda: post(base + "/v1/weights", bodies[2]["raw"],
                          raw=True)] * 4,
            lambda: service.coalesce_hits == hits0 + 3)
        for s, w in same:
            check(s == 200 and np.array_equal(w, same[0][1]),
                  "coalesced answers differ")
        # two new macro months, then the latest month
        for k in range(2):
            s, ans = post(base + "/v1/macro",
                          {"macro": test.macro[k].tolist()})
            check(s == 200 and ans["month"] == test.T + k,
                  f"/v1/macro answered {s} {ans}")
        s, ans = post(base + "/v1/weights", {
            "individual_b64": _b64(test.individual[0]), "month": -1})
        w = np.asarray(ans.get("weights", [np.nan]) if s == 200 else [np.nan])
        check(s == 200 and ans["month"] == test.T + 1
              and np.isfinite(w).all() and abs(np.abs(w).sum() - 1) < 1e-4,
              f"month -1 after two appends answered {s}")
        s, health = get(base + "/healthz")
        check(s == 200 and health["ok"] is True, f"/healthz: {s} {health}")
        stats = eng.stats()
        launches = K.launches
        records = service.flight.snapshot("")["requests"]
        s, metrics = get(base + "/metrics")
        s2, prom = get(base + "/metrics?format=prom")
    finally:
        server.stop()
        service.close()
    flushes = metrics["batcher"]["flushes"]
    check(launches > 0, "the main path launched sdf_ffn_fwd no time")
    # one uncaptured warm-up forward and one capture per bucket; every
    # served forward after that is a replay, with no capture
    check(launches == 2 * stats["captures"],
          f"{launches} kernel launches for {stats['captures']} captures "
          "(one warm-up forward + one capture each)")
    check(stats["steady_state_captures"] == 0,
          f"{stats['steady_state_captures']} captures after warmup")
    check(stats["replays"] == flushes and flushes > 0,
          f"{stats['replays']} graph replays for {flushes} served forwards")
    check(metrics["batcher"]["occupancy_hist"].get("4") == 2 * (test.T // 4),
          f"/metrics occupancy {metrics['batcher']['occupancy_hist']}")
    check(metrics["coalesce"]["hits"] >= 3 and metrics["cache"]["hits"] >= 1,
          f"/metrics coalesce {metrics['coalesce']} cache "
          f"{metrics['cache']}")
    series = parse_prom_text(prom) if s2 == 200 else {}
    check(series.get("dlap_serve_coalesce_hits_total", {}).get(()) ==
          metrics["coalesce"]["hits"]
          and "dlap_model_generation" in series,
          "the Prometheus scrape lacks the coalescing or model series")
    med = {k: statistics.median(v) * 1e3 for k, v in lat.items()}
    p = metrics["latency"]
    # where a request's time goes, per wire: the server's own segments of
    # its /v1/weights requests at batch bucket 1 (the flight recorder's
    # ring), medians in ms
    seg = {}
    for wire in ("json", "b64", "binary"):
        rows = [r for r in records if r.get("wire") == wire
                and r.get("endpoint") == "/v1/weights"
                and r.get("status") == 200 and r.get("occupancy") == 1]
        seg[wire] = {k: statistics.median(r.get(k) or 0.0 for r in rows)
                     * 1e3 for k in ("duration_s", "parse_s", "queue_s",
                                     "dispatch_s", "serialize_s", "write_s")
                     } if rows else None
    print(f"[serve {dtype}] async front end: {test.T} months x (JSON, b64, "
          f"raw-f32) + {2 * (test.T // 4)} batch-4 flushes of 4 concurrent "
          f"requests + a cache hit + {metrics['coalesce']['hits']} coalesced"
          f"; warmup {warm_s:.2f} s ({stats['captures']} CUDA graphs); "
          f"kernel launches {launches} (= 2 x captures), graph replays "
          f"{stats['replays']} = flushes {flushes}, captures after warmup "
          f"{stats['steady_state_captures']}; served vs offline max|d| "
          f"weights {max(errs_w):.3e} sdf {max(errs_sdf):.3e}; JSON and "
          f"b64, raw-f32 and b64 bit for bit ({card})", flush=True)
    print(f"[serve {dtype}] /v1/weights request median ms: JSON "
          f"{med['json']:.2f}, b64 {med['b64']:.2f} (N = {test.N}, masked); "
          f"raw-f32 {med['raw']:.2f}, b64 /v1/sdf {med['b64_valid']:.2f} "
          f"(valid rows only); /metrics over the run: p50 "
          f"{p['p50_ms']} ms, p99 {p['p99_ms']} ms of {p['count']} "
          f"requests ({card})", flush=True)
    for wire, m in seg.items():
        if m is not None:
            print(f"[serve {dtype}] {wire} /v1/weights on the server, median "
                  f"ms: parse {m['parse_s']:.3f} (the body's decode and "
                  f"checks), queue {m['queue_s']:.3f}, dispatch "
                  f"{m['dispatch_s']:.3f} (engine.infer), serialize "
                  f"{m['serialize_s']:.3f}, write {m['write_s']:.3f}; the "
                  f"row's duration {m['duration_s']:.3f} (from the handler's"
                  f" start, after the transport's JSON decode) ({card})",
                  flush=True)
    return service, launches, med


def graph_checks(torch, service, test, card):
    """Every bucket the deployment warmed, replayed from its CUDA graph and
    run eagerly (the same kernel route uncaptured): bit for bit."""
    from deeplearninginassetpricing_paperreplication_torch.serving.engine \
        import InferenceRequest

    eng = service.engine
    mask = test.mask.astype(np.float32)
    before = eng.stats()["captures"]
    n = 0
    for nb in eng.stock_buckets:
        rows = min(nb, test.N)
        for b in eng.batch_buckets:
            reqs = [InferenceRequest(individual=test.individual[t, :rows],
                                     mask=mask[t, :rows],
                                     returns=test.returns[t, :rows], month=t)
                    for t in range(b)]
            for g, e in zip(eng.infer(reqs), eng.infer(reqs, graphs=False)):
                check(g.bucket == nb and g.batch_bucket == b,
                      f"{rows} stocks x {b} landed in ({g.bucket}, "
                      f"{g.batch_bucket})")
                check(np.array_equal(g.weights, e.weights)
                      and g.sdf == e.sdf
                      and np.array_equal(g.member_sdf, e.member_sdf),
                      f"graph replay != eager at bucket ({nb}, {b}) "
                      f"({eng.exec_cfg.compute_dtype})")
            n += 1
    check(eng.stats()["captures"] == before, "a graph check captured")
    print(f"[graphs {eng.exec_cfg.compute_dtype}] {n} buckets "
          f"(stock {list(eng.stock_buckets)} x batch "
          f"{list(eng.batch_buckets)}): CUDA-graph replay bit for bit the "
          f"eager kernel route ({card})", flush=True)


def engine_timing(torch, service, test, card):
    """Time engine.infer alone (no HTTP, no JSON), CUDA-graph replay and
    eager in turns: host clock around a call that ends in a device sync,
    batch buckets 1 and 4."""
    from deeplearninginassetpricing_paperreplication_torch.serving.engine \
        import InferenceRequest

    eng = service.engine
    reqs = [InferenceRequest(individual=test.individual[t],
                             mask=test.mask[t].astype(np.float32),
                             returns=test.returns[t], month=t)
            for t in range(test.T)]
    out = {}
    for b in (1, 4):
        times = {True: [], False: []}
        for graphs in (True, False):
            for _ in range(3):
                eng.infer(reqs[:b], graphs=graphs)
        for i in range(0, test.T, b):
            for graphs in (True, False, False, True):
                t0 = time.perf_counter()
                eng.infer(reqs[i:i + b], graphs=graphs)  # host arrays: synced
                times[graphs].append(time.perf_counter() - t0)
        out[b] = {k: statistics.median(v) * 1e3 for k, v in times.items()}
    print(f"[engine {eng.exec_cfg.compute_dtype}] infer() median ms, CUDA "
          f"graphs / eager: batch 1 {out[1][True]:.3f} / {out[1][False]:.3f}"
          f", batch 4 {out[4][True]:.3f} / {out[4][False]:.3f} (N = "
          f"{test.N}, {eng.n_members} members; {card})", flush=True)
    return reqs


def profile_engine(torch, service, reqs, card):
    """torch.profiler over 24 batch-1 engine calls (graph replays): device
    time by kernel and the device's busy share of the window."""
    from torch.profiler import ProfilerActivity, profile

    eng = service.engine
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for r in reqs:
            eng.infer([r])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    evs, busy = device_events(prof)
    print(f"[profile] {len(reqs)} engine calls in {wall * 1e3:.1f} ms wall;"
          f" device busy {busy:.2f} ms ({0.1 * busy / wall:.1f}% of "
          f"the window; {card})", flush=True)
    for e in evs[:12]:
        print(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms  "
              f"{e.count:5d} x  {e.key[:90]}", flush=True)


def make_panel():
    """The synthetic panel every phase from 4 on reads (``PANEL``), written
    to ``DATA_DIR`` anew: its (train, valid, test) splits."""
    from deeplearninginassetpricing_paperreplication_torch.data.panel import (
        load_splits,
    )
    from deeplearninginassetpricing_paperreplication_torch.data.synthetic \
        import generate_all_splits

    t0 = time.perf_counter()
    if DATA_DIR.exists():
        shutil.rmtree(DATA_DIR)
    generate_all_splits(DATA_DIR, verbose=False, compress=False, **PANEL)
    splits = load_splits(DATA_DIR)
    print(f"[panel] synthetic F={PANEL['n_features']} M={PANEL['n_macro']} "
          f"N={PANEL['n_stocks']} months {PANEL['n_periods_train']}/"
          f"{PANEL['n_periods_valid']}/{PANEL['n_periods_test']} seed "
          f"{PANEL['seed']}: {time.perf_counter() - t0:.1f} s", flush=True)
    return splits


def serving_phase(torch, K, card, test, profile: bool) -> int:
    """Phase 4 at f32 and bf16: the service through the async front end
    (`serve_and_check`), every warmed bucket's graph against the eager
    route, `engine.infer` timed; returns the forward's launches."""
    from deeplearninginassetpricing_paperreplication_torch.evaluate_ensemble \
        import stack_checkpoints
    from deeplearninginassetpricing_paperreplication_torch.parallel.ensemble \
        import ensemble_metrics
    from deeplearninginassetpricing_paperreplication_torch.serving import (
        server as server_mod,
    )
    from deeplearninginassetpricing_paperreplication_torch.utils.config \
        import ExecutionConfig

    bodies = serving_bodies(test)
    cfg, stacked = stack_checkpoints([str(ROOT / d) for d in REF_RUNS],
                                     device=DEVICE)
    batch = test.to_batch(DEVICE)
    launches = 0
    for dtype in ("float32", "bfloat16"):
        offline = ensemble_metrics(cfg, stacked, batch, ExecutionConfig(
            kernel="off", compute_dtype=dtype, device=DEVICE))
        service, n, _ = serve_and_check(torch, dtype, test, offline, bodies,
                                        card, K, server_mod)
        launches += n
        graph_checks(torch, service, test, card)
        reqs = engine_timing(torch, service, test, card)
        if profile:
            profile_engine(torch, service, reqs, card)
    return launches


def stand_in_members(torch):
    """Nine members of the paper architecture (``ref_runs``' config) from
    seeded random weights, saved as verified run dirs, and a promotion
    pointer naming them: what phases 7 and 10 hand phase 4b, for
    ``--only_serve``."""
    from deeplearninginassetpricing_paperreplication_torch.evaluate_ensemble \
        import stack_checkpoints
    from deeplearninginassetpricing_paperreplication_torch.parallel.ensemble \
        import init_ensemble_params
    from deeplearninginassetpricing_paperreplication_torch.reliability \
        .promotion import verify_member_dirs, write_pointer
    from deeplearninginassetpricing_paperreplication_torch.serving.engine \
        import params_digest
    from deeplearninginassetpricing_paperreplication_torch.training \
        .checkpoint import member_state_dicts, save_state_dict
    from deeplearninginassetpricing_paperreplication_torch.utils.config \
        import GANConfig

    cfg = GANConfig.load(ROOT / REF_RUNS[0] / "config.json")
    shutil.rmtree(HEALTH_DIR, ignore_errors=True)
    dirs = []
    for seed, sd in zip(ENSEMBLE_SEEDS, member_state_dicts(
            init_ensemble_params(cfg, ENSEMBLE_SEEDS))):
        d = HEALTH_DIR / "members" / f"seed_{seed}"
        d.mkdir(parents=True)
        cfg.save(d / "config.json")
        save_state_dict(d / "best_model_sharpe.pt", sd)
        dirs.append(str(d))
    members, rejection = verify_member_dirs(dirs)
    check(rejection is None, f"stand-in members: {rejection}")
    _, stacked = stack_checkpoints(dirs, device="cpu")
    ctl = HEALTH_DIR / "ctl"
    write_pointer(ctl, {"checkpoint_dirs": dirs, "members": members,
                        "params_fingerprint": params_digest(stacked)})
    return dirs, ctl


def reload_checks(torch, card, splits, member_dirs, ctl):
    """(4b) Hot reload on phase 7's nine members (saved as verified run
    dirs by phase 10, whose promotion pointer under `ctl` names all nine),
    f32, through the async front end: a swap from three members to three
    others equals a fresh engine on those dirs bit for bit, bumps the
    generation and serves a cached request anew; a NaN candidate trips the
    canary (a 5xx, the pre-swap answers restored bit for bit); the
    ref_runs trio (another architecture, or four dirs) is refused with the
    engine serving on; a service booted from the pointer reloads as a
    no-op and refuses a pointer whose member was tampered, generation
    unchanged; /v1/drain closes the listener and the serve loop returns."""
    from deeplearninginassetpricing_paperreplication_torch.evaluate_ensemble \
        import stack_checkpoints
    from deeplearninginassetpricing_paperreplication_torch.observability \
        .manifest import config_hash
    from deeplearninginassetpricing_paperreplication_torch.reliability \
        .promotion import read_pointer, write_pointer
    from deeplearninginassetpricing_paperreplication_torch.serving import (
        AsyncServerThread,
        InferenceEngine,
        InferenceRequest,
        pick_free_port,
    )
    from deeplearninginassetpricing_paperreplication_torch.serving import (
        server as server_mod,
    )
    from deeplearninginassetpricing_paperreplication_torch.training \
        .checkpoint import member_state_dicts, save_state_dict
    from deeplearninginassetpricing_paperreplication_torch.utils.config \
        import ExecutionConfig, GANConfig

    t_start = time.perf_counter()
    train, _, test = splits
    common = ["--data_dir", str(DATA_DIR), "--device", DEVICE,
              "--compute_dtype", "float32", "--stock_buckets", "16384"]
    mask = test.mask.astype(np.float32)
    sdf_body = {t: {"individual_b64": _b64(test.individual[t]),
                    "mask_b64": _b64(mask[t]),
                    "returns_b64": _b64(test.returns[t]), "month": t,
                    "encoding": "b64"} for t in RELOAD_MONTHS}
    raw_body = {t: _raw_body(t, test.individual[t]) for t in RELOAD_MONTHS}

    def request(t, masked=True):
        return InferenceRequest(individual=test.individual[t],
                                mask=mask[t] if masked else None,
                                returns=test.returns[t] if masked else None,
                                month=t)

    def fresh(dirs):
        eng = InferenceEngine(dirs, macro_history=test.macro,
                              macro_stats=(train.mean_macro,
                                           train.std_macro),
                              stock_buckets=(16384,),
                              exec_cfg=ExecutionConfig(
                                  device=DEVICE, compute_dtype="float32"))
        eng.warmup()
        return eng

    def served(base):
        out = {}
        for t in RELOAD_MONTHS:
            s, ans = post(base + "/v1/sdf", sdf_body[t])
            s2, w = post(base + "/v1/weights", raw_body[t], raw=True)
            check(s == 200 and s2 == 200, f"HTTP {s}/{s2} at month {t}")
            out[t] = (ans, w)
        return out

    def same_as(answers, eng, what):
        for t, (ans, w) in answers.items():
            ref = eng.infer_one(request(t), observe=False)
            ref_raw = eng.infer_one(request(t, masked=False), observe=False)
            check(ans["sdf"] == ref.sdf and np.array_equal(
                _unb64(ans["member_sdf_b64"]), ref.member_sdf)
                and np.array_equal(w, ref_raw.weights),
                f"{what}: served answers != the reference at month {t} "
                f"(sdf {ans['sdf']} vs {ref.sdf}, max|dw| "
                f"{np.abs(w - ref_raw.weights).max():.3e})")

    service = server_mod.build_service(server_mod.build_arg_parser()
                                       .parse_args(["--checkpoint_dirs",
                                                    *member_dirs[:3],
                                                    *common]))
    server = AsyncServerThread(service, port=pick_free_port(), admin_port=0)
    base = f"http://127.0.0.1:{server.start()}"
    admin = f"http://127.0.0.1:{server.admin_port}"
    eng = service.engine
    try:
        before = served(base)  # also fills the cache and the canary ring
        gen0 = eng.stats()["params_generation"]
        t0 = time.perf_counter()
        s, out = post(base + "/v1/reload",
                      {"checkpoint_dirs": member_dirs[3:6]})
        swap_s = time.perf_counter() - t0
        check(s == 200 and out["swapped"] is True
              and out["params_generation"] == gen0 + 1
              and out["canary"]["finite"] is True
              and out["canary"]["replayed"] > 0, f"reload: {s} {out}")
        after = served(base)
        check(not any(ans["cached"] for ans, _ in after.values()),
              "a request cached before the swap was served from the cache")
        ref_b = fresh(member_dirs[3:6])
        same_as(after, ref_b, "after the swap")
        check(eng.stats()["steady_state_captures"] == 0,
              "the reload captured a graph")
        # a NaN candidate: written through the verified writer, so only
        # the canary can stop it
        nan_dir = HEALTH_DIR / "nan_candidate"
        shutil.rmtree(nan_dir, ignore_errors=True)
        nan_dir.mkdir(parents=True)
        shutil.copy(Path(member_dirs[6]) / "config.json", nan_dir)
        _, stacked = stack_checkpoints([member_dirs[6]], device="cpu")
        save_state_dict(nan_dir / "best_model_sharpe.pt", {
            k: v * float("nan")
            for k, v in member_state_dicts(stacked)[0].items()})
        gen1 = eng.stats()["params_generation"]
        s, err = post(base + "/v1/reload", {
            "checkpoint_dirs": member_dirs[3:5] + [str(nan_dir)]})
        check(s == 500 and "canary" in err,
              f"the NaN candidate was not reverted: {s} {err}")
        check(eng.stats()["params_generation"] == gen1 + 2
              and eng.checkpoint_dirs == member_dirs[3:6],
              "the revert did not restore the pre-swap generation")
        same_as(served(base), ref_b, "after the canary's revert")
        # the ref_runs trio: another architecture, else the member count
        ref_dirs = [str(ROOT / d) for d in REF_RUNS]
        other_arch = (config_hash(GANConfig.load(Path(ref_dirs[0])
                                                 / "config.json"))
                      != eng.config_hash)
        bad = ref_dirs if other_arch else member_dirs[:4]
        s, err = post(base + "/v1/reload", {"checkpoint_dirs": bad})
        check(s == 500 and ("architecture" in err or "member" in err),
              f"a reload to {'the ref_runs trio' if other_arch else 'four'}"
              f" dirs answered {s} {err}")
        check(eng.stats()["params_generation"] == gen1 + 2,
              "a refused reload moved the generation")
        same_as(served(base), ref_b, "after the refused reload")
        # /v1/drain: the public listener closes, the serve loop returns
        s, drained = post(admin + "/v1/drain", {"timeout_s": 10})
        check(s == 200 and drained["drained"] is True, f"drain: {drained}")
        check(server.returned.wait(15) and server.error is None,
              f"the serve loop did not return cleanly: {server.error}")
        try:
            urllib.request.urlopen(base + "/healthz", timeout=5)
            check(False, "the public listener still answers after a drain")
        except urllib.error.URLError:
            pass
    finally:
        server.stop()
        service.close()
    del ref_b

    # a service booted from phase 10's pointer (the nine members)
    ptr_service = server_mod.build_service(
        server_mod.build_arg_parser().parse_args(
            ["--pointer", str(ctl), "--batch_buckets", "1", *common]))
    server = AsyncServerThread(ptr_service, port=pick_free_port())
    base = f"http://127.0.0.1:{server.start()}"
    eng = ptr_service.engine
    try:
        check(eng.n_members == 9, f"the pointer booted {eng.n_members}")
        s, out = post(base + "/v1/reload", {})
        check(s == 200 and out["swapped"] is False
              and out["converged"] is True,
              f"a no-body reload from the pointer: {s} {out}")
        # a pointer written for the test names a copy of one member's dir
        pointer = read_pointer(ctl)
        src = Path(pointer["checkpoint_dirs"][0])
        copy = HEALTH_DIR / "pointer_copy" / src.name
        shutil.rmtree(copy.parent, ignore_errors=True)
        shutil.copytree(src, copy)
        head = {k: v for k, v in pointer.items()
                if k not in ("kind", "generation", "history")}
        head["checkpoint_dirs"] = [str(copy)] + pointer["checkpoint_dirs"][1:]
        head["members"] = [dict(m, dir=str(copy)) if i == 0 else m
                           for i, m in enumerate(pointer["members"])]
        ptr_service.pointer_root = HEALTH_DIR / "ctl_test"
        write_pointer(ptr_service.pointer_root, head)
        s, out = post(base + "/v1/reload", {})
        check(s == 200 and out["swapped"] is False,
              f"a reload to the copied member: {s} {out}")
        gen = eng.stats()["params_generation"]
        pt = copy / pointer["members"][0]["file"]
        data = bytearray(pt.read_bytes())
        data[len(data) // 2] ^= 0xFF
        pt.write_bytes(bytes(data))
        s, err = post(base + "/v1/reload", {})
        check(s == 500 and "digest mismatch" in err
              and eng.stats()["params_generation"] == gen,
              f"the tampered member was not refused whole: {s} {err}")
    finally:
        server.stop()
        ptr_service.close()
    print(f"[serve reload] {len(member_dirs)} members, f32, async front "
          f"end: a swap from members 1-3 to 4-6 in {swap_s:.2f} s bit for "
          f"bit a fresh "
          f"engine (generation {gen0} -> {gen0 + 1}, cached request served "
          f"anew, no capture); a NaN candidate reverted by the canary (5xx,"
          f" pre-swap answers bit for bit); "
          f"{'the ref_runs trio' if other_arch else 'four dirs'} refused, "
          f"serving on; /v1/drain: listener closed, loop returned; a "
          f"9-member service from the pointer: no-op reload, a tampered "
          f"member refused whole (generation {gen} kept); "
          f"{time.perf_counter() - t_start:.1f} s ({card})", flush=True)


# -- phase 6 ------------------------------------------------------------------


def counts(K, C):
    return (K.launches, K.bwd_launches, C.fwd_launches, C.bwd_launches)


def train_checks(torch, K, C, card, splits, opts):
    """train_3phase at full width, kernel route against kernel="off" (f32,
    dropout 0.05, the same seed), with the launches counted per phase."""
    from deeplearninginassetpricing_paperreplication_torch.training import (
        trainer as trainer_mod,
    )
    from deeplearninginassetpricing_paperreplication_torch.utils.config \
        import ExecutionConfig, GANConfig, TrainConfig

    train, valid, test = splits
    cfg = GANConfig(macro_feature_dim=train.macro_feature_dim,
                    individual_feature_dim=train.individual_feature_dim,
                    dropout=DROPOUT)
    tcfg = TrainConfig(**SCHEDULE, seed=42, print_freq=10 ** 6)
    batches = [ds.to_batch(DEVICE) for ds in (train, valid, test)]
    per_phase = {}
    run_phase = trainer_mod.Trainer.run_phase

    def counted(self, phase, seeds, b, best, **kw):
        before = counts(K, C)
        out = run_phase(self, phase, seeds, b, best, **kw)
        torch.cuda.synchronize()
        per_phase[phase] = tuple(a - c for a, c in zip(counts(K, C), before))
        return out

    # one untimed epoch per phase on each route first: library loads,
    # cuBLAS handles and the allocator's first growth are set-up
    for kernel in ("on", "off"):
        trainer_mod.train_3phase(
            cfg, *batches, tcfg=TrainConfig(1, 1, 1, ignore_epoch=0),
            verbose=False, exec_cfg=ExecutionConfig(
                kernel=kernel, compute_dtype="float32", device=DEVICE))
    trainer_mod.Trainer.run_phase = counted
    try:
        results = {}
        for kernel in ("on", "off"):
            exec_cfg = ExecutionConfig(kernel=kernel,
                                       compute_dtype="float32",
                                       device=DEVICE)
            per_phase.clear()
            K.reset_launch_count()
            C.reset_launch_count()
            t0 = time.perf_counter()
            gan, params, hist, trainer = trainer_mod.train_3phase(
                cfg, *batches, tcfg=tcfg, seed=42, verbose=False,
                exec_cfg=exec_cfg)
            before = counts(K, C)
            final = trainer.final_eval(batches[2])
            final_launches = tuple(a - c for a, c in
                                   zip(counts(K, C), before))
            results[kernel] = dict(hist=hist, phases=dict(per_phase),
                                   final=final, final_launches=final_launches,
                                   epoch_ms=trainer.epoch_ms(),
                                   wall=time.perf_counter() - t0,
                                   trainer=trainer, params=params)
    finally:
        trainer_mod.Trainer.run_phase = run_phase

    on, off = results["on"], results["off"]
    n_epochs = {"unconditional": SCHEDULE["num_epochs_unc"],
                "moment": SCHEDULE["num_epochs_moment"],
                "conditional": SCHEDULE["num_epochs"]}
    for phase, per in PER_EPOCH.items():
        want = tuple(n_epochs[phase] * v for v in per)
        check(on["phases"][phase] == want,
              f"{phase}: launches (fwd, bwd, cem_fwd, cem_bwd) "
              f"{on['phases'][phase]} != {want}")
        check(off["phases"][phase] == (0, 0, 0, 0),
              f"kernel='off' launched kernels in {phase}")
    check(on["final_launches"] == (1, 0, 1, 0),
          f"final_eval launched {on['final_launches']}, not (1, 0, 1, 0)")
    dev_loss = max(float(np.max(np.abs(on["hist"][k] - off["hist"][k])
                             / np.maximum(np.abs(off["hist"][k]), 1e-12)))
                   for k in ("train_loss", "valid_loss", "test_loss"))
    dev_sharpe = max(float(np.max(np.abs(on["hist"][k] - off["hist"][k])))
                     for k in ("train_sharpe", "valid_sharpe",
                               "test_sharpe"))
    check(all(np.isfinite(on["hist"][k]).all() for k in on["hist"]
              if k != "phase"), "non-finite training history")
    check(dev_loss <= 1e-3, f"kernel vs plain training: loss rel dev "
                            f"{dev_loss:.3e} > 1e-3")
    check(dev_sharpe <= 5e-3, f"kernel vs plain training: Sharpe dev "
                              f"{dev_sharpe:.3e} > 5e-3")
    fmt = lambda d: ", ".join(f"{k} {v:.2f}" for k, v in d.items())  # noqa: E731
    print(f"[train] full width F={cfg.individual_feature_dim} "
          f"M={cfg.macro_feature_dim} N={train.N} T={train.T}/{valid.T}/"
          f"{test.T}, hidden {list(cfg.hidden_dim)}, LSTM "
          f"{list(cfg.num_units_rnn)}, K={cfg.num_condition_moment}, dropout "
          f"{DROPOUT}, schedule 8/4/16 ignore 2, f32 ({card})", flush=True)
    print(f"[train] kernel vs plain, every epoch: max loss rel dev "
          f"{dev_loss:.3e} (bar 1e-3), max Sharpe dev {dev_sharpe:.3e} "
          f"(bar 5e-3); final test Sharpe kernel "
          f"{on['final']['sharpe']:.6f} plain {off['final']['sharpe']:.6f}",
          flush=True)
    for phase, n in n_epochs.items():
        print(f"[train] launches {phase}: (fwd, bwd, cem_fwd, cem_bwd) "
              f"{on['phases'][phase]} = {n} epochs x {PER_EPOCH[phase]}",
              flush=True)
    print(f"[train] final_eval launches {on['final_launches']}; wall ms per "
          f"epoch kernel: {fmt(on['epoch_ms'])}; plain: "
          f"{fmt(off['epoch_ms'])} ({card})", flush=True)
    if opts.profile:
        profile_training(torch, on["trainer"], batches, card)
    launches = {name: sum(v[i] for v in on["phases"].values())
                + on["final_launches"][i]
                for i, name in enumerate(("sdf_ffn_fwd", "sdf_ffn_bwd",
                                          "cond_em_fwd", "cond_em_bwd"))}
    return launches, on["epoch_ms"], dict(cfg=cfg, params=on["params"],
                                          hist=on["hist"],
                                          epoch_ms=on["epoch_ms"])


def wide_train_check(torch, K, C, card, splits):
    """train_3phase at the sweep's hidden (128, 128), kernel route, f32,
    dropout 0.05, a short schedule: a finite history, and every kernel's
    launches per phase as PER_EPOCH counts them."""
    from deeplearninginassetpricing_paperreplication_torch.training import (
        trainer as trainer_mod,
    )
    from deeplearninginassetpricing_paperreplication_torch.utils.config \
        import ExecutionConfig, GANConfig, TrainConfig

    train, valid, test = splits
    sched = dict(WIDE_TRAIN)
    hidden = sched.pop("hidden")
    cfg = GANConfig(macro_feature_dim=train.macro_feature_dim,
                    individual_feature_dim=train.individual_feature_dim,
                    hidden_dim=hidden, dropout=DROPOUT)
    batches = [ds.to_batch(DEVICE) for ds in (train, valid, test)]
    per_phase = {}
    run_phase = trainer_mod.Trainer.run_phase

    def counted(self, phase, seeds, b, best, **kw):
        before = counts(K, C)
        out = run_phase(self, phase, seeds, b, best, **kw)
        torch.cuda.synchronize()
        per_phase[phase] = tuple(a - c for a, c in zip(counts(K, C), before))
        return out

    trainer_mod.Trainer.run_phase = counted
    try:
        t0 = time.perf_counter()
        _, _, hist, trainer = trainer_mod.train_3phase(
            cfg, *batches, tcfg=TrainConfig(**sched, seed=42,
                                            print_freq=10 ** 6),
            seed=42, verbose=False, exec_cfg=ExecutionConfig(
                kernel="on", compute_dtype="float32", device=DEVICE))
        wall = time.perf_counter() - t0
    finally:
        trainer_mod.Trainer.run_phase = run_phase
    n_epochs = {"unconditional": sched["num_epochs_unc"],
                "moment": sched["num_epochs_moment"],
                "conditional": sched["num_epochs"]}
    for phase, per in PER_EPOCH.items():
        want = tuple(n_epochs[phase] * v for v in per)
        check(per_phase[phase] == want,
              f"hidden {list(hidden)}: {phase} launches (fwd, bwd, cem_fwd, "
              f"cem_bwd) {per_phase[phase]} != {want}")
    check(all(np.isfinite(hist[k]).all() for k in hist if k != "phase"),
          f"non-finite training history at hidden {list(hidden)}")
    fmt = lambda d: ", ".join(f"{k} {v:.2f}" for k, v in d.items())  # noqa: E731
    print(f"[train wide] hidden {list(hidden)}, F="
          f"{cfg.individual_feature_dim} N={train.N} T={train.T}, dropout "
          f"{DROPOUT}, schedule {n_epochs['unconditional']}/"
          f"{n_epochs['moment']}/{n_epochs['conditional']}, f32, kernel "
          f"route: {wall:.1f} s; final train/valid/test Sharpe "
          f"{hist['train_sharpe'][-1]:.4f} / {hist['valid_sharpe'][-1]:.4f} "
          f"/ {hist['test_sharpe'][-1]:.4f}; wall ms per epoch "
          f"{fmt(trainer.epoch_ms())} ({card})", flush=True)
    for phase in n_epochs:
        print(f"[train wide] launches {phase}: (fwd, bwd, cem_fwd, cem_bwd) "
              f"{per_phase[phase]}", flush=True)
    return {name: sum(v[i] for v in per_phase.values())
            for i, name in enumerate(("sdf_ffn_fwd", "sdf_ffn_bwd",
                                      "cond_em_fwd", "cond_em_bwd"))}


def profile_training(torch, trainer, batches, card):
    """torch.profiler over 4 phase-3 epochs (train step + two evals) on the
    kernel route: device time by kernel and the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    from deeplearninginassetpricing_paperreplication_torch.training.steps \
        import eval_step, train_step

    gan = trainer.gan
    b = [gan.prepare_batch(x) for x in batches]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for e in range(4):
            train_step(gan, "conditional", trainer.opt_sdf, b[0], 1000 + e)
            eval_step(gan, b[1])
            eval_step(gan, b[2])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    evs, busy = device_events(prof)
    print(f"[profile train] 4 phase-3 epochs in {wall * 1e3:.1f} ms wall; "
          f"device busy {busy:.2f} ms ({0.1 * busy / wall:.1f}% of the "
          f"window; {card})", flush=True)
    for e in evs[:14]:
        print(f"[profile train]   {e.self_device_time_total / 1e3:9.3f} ms  "
              f"{e.count:5d} x  {e.key[:90]}", flush=True)


def cli_check(torch, card):
    """The train CLI in its default bf16 configuration, then the port's
    evaluate_ensemble on the run dir it wrote."""
    from deeplearninginassetpricing_paperreplication_torch import train
    from deeplearninginassetpricing_paperreplication_torch.evaluate_ensemble \
        import evaluate_ensemble
    from deeplearninginassetpricing_paperreplication_torch.utils.config \
        import ExecutionConfig

    shutil.rmtree(RUN_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    train.main(["--data_dir", str(DATA_DIR), "--save_dir", str(RUN_DIR),
                "--epochs_unc", str(SCHEDULE["num_epochs_unc"]),
                "--epochs_moment", str(SCHEDULE["num_epochs_moment"]),
                "--epochs", str(SCHEDULE["num_epochs"]), "--ignore_epoch",
                str(SCHEDULE["ignore_epoch"]), "--print_freq", "8",
                "--device", DEVICE, "--diag_stride", str(CLI_DIAG_STRIDE)])
    wall = time.perf_counter() - t0
    metrics = json.loads((RUN_DIR / "final_metrics.json").read_text())
    health_cli_files(card)
    res = evaluate_ensemble([str(RUN_DIR)], str(DATA_DIR),
                            exec_cfg=ExecutionConfig(device=DEVICE),
                            verbose=False)
    check(np.isfinite(res["test_sharpe"]), "non-finite test Sharpe of the "
                                           "CLI-trained run dir")
    print(f"[cli] train CLI (bf16, kernel auto) wrote {RUN_DIR.name}/ in "
          f"{wall:.1f} s; evaluate_ensemble test Sharpe (negated, ddof 0) "
          f"{res['test_sharpe']:.6f}; wall ms per epoch: "
          + ", ".join(f"{k} {v:.2f}" for k, v in metrics["epoch_ms"].items())
          + f" ({card})", flush=True)
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    return metrics["epoch_ms"]


def roofline_lines(tag, splits, epoch_ms, n_members, ceiling_tflops, card):
    """roofline_summary of the measured phase-1 and phase-3 epochs, with the
    f32 panel's bytes per epoch (the JAX bench's pass structure: phase 3
    streams the panel 4x in its train step, phase 1 2x, and every epoch's
    valid and test evals 2x each), against two compute walls: the f32
    CUDA-core peak, which bounds these epochs (their kernels run f32 on the
    CUDA cores), and the measured bf16 tensor-core shape ceiling, the wall
    a redesign onto the tensor cores is judged by."""
    from deeplearninginassetpricing_paperreplication_torch.ops import (
        roofline,
    )

    train, valid, test = splits
    shapes = dict(T_train=train.T, T_valid=valid.T, T_test=test.T,
                  N=train.N, F=train.individual_feature_dim)
    F, N, bpe = shapes["F"], shapes["N"], 4  # the port's panel is f32
    eval_bytes = 2 * (valid.T + test.T) * F * N * bpe
    for phase, passes, key in (("phase1", 2, "phase1_unconditional"),
                               ("phase3", 4, "phase3_conditional")):
        nbytes = passes * train.T * F * N * bpe + eval_bytes
        for wall, tflops in (("f32 CUDA-core peak",
                              roofline.PEAK_F32_FLOPS / 1e12),
                             ("bf16 shape ceiling", ceiling_tflops)):
            summary = roofline.roofline_summary(
                epoch_ms[key] / 1e3, shapes, phase=phase,
                n_members=n_members, panel_bytes_per_epoch=nbytes,
                shape_ceiling_tflops=tflops)
            print(f"[roofline {tag}] {phase} S={n_members} epoch "
                  f"{epoch_ms[key]:.2f} ms against the {wall} "
                  f"({tflops:.2f} TFLOP/s): {json.dumps(summary)} ({card})",
                  flush=True)


# -- phase 7 ------------------------------------------------------------------


def _history_devs(a, b):
    """(max loss rel dev, max Sharpe abs dev, where the loss one is: key
    and (member,) epoch) between two histories."""
    rel = {k: np.abs(a[k] - b[k]) / np.maximum(np.abs(b[k]), 1e-12)
           for k in ("train_loss", "valid_loss", "test_loss")}
    worst = max(rel, key=lambda k: rel[k].max())
    where = (worst, *np.unravel_index(int(np.argmax(rel[worst])),
                                      rel[worst].shape))
    dev_sharpe = max(float(np.max(np.abs(a[k] - b[k])))
                     for k in ("train_sharpe", "valid_sharpe", "test_sharpe"))
    return float(rel[worst].max()), dev_sharpe, where


def ensemble_checks(torch, K, C, card, splits, single_epoch_ms, opts):
    """train_ensemble at full width with the paper's nine seeds: the
    launches per phase and the member count of every launch, the kernel
    route against kernel="off", and each member against its serial run."""
    from deeplearninginassetpricing_paperreplication_torch.parallel import (
        ensemble as ens_mod,
    )
    from deeplearninginassetpricing_paperreplication_torch.training.trainer \
        import train_3phase
    from deeplearninginassetpricing_paperreplication_torch.utils.config \
        import ExecutionConfig, GANConfig, TrainConfig

    train, valid, test = splits
    cfg = GANConfig(macro_feature_dim=train.macro_feature_dim,
                    individual_feature_dim=train.individual_feature_dim,
                    dropout=DROPOUT)
    tcfg = TrainConfig(**SCHEDULE, print_freq=10 ** 6)
    batches = [ds.to_batch(DEVICE) for ds in (train, valid, test)]
    S = len(ENSEMBLE_SEEDS)
    per_phase, phase_s, members = {}, {}, {}
    run_phase = ens_mod.run_phase
    launchers = {"sdf_ffn_fwd": (K, "_launch"),
                 "sdf_ffn_bwd": (K, "_launch_bwd"),
                 "cond_em_fwd": (C, "_launch_fwd"),
                 "cond_em_bwd": (C, "_launch_bwd")}
    originals = {n: getattr(m, a) for n, (m, a) in launchers.items()}

    def counted(gan, phase, *args, **kw):
        torch.cuda.synchronize()
        before, t0 = counts(K, C), time.perf_counter()
        out = run_phase(gan, phase, *args, **kw)
        torch.cuda.synchronize()
        phase_s[phase] = time.perf_counter() - t0
        per_phase[phase] = tuple(a - c for a, c in zip(counts(K, C), before))
        return out

    def recorder(name):
        # records the member count of each launch; the count of launches
        # stays the wrapper's own
        def rec(*args, **kw):
            n = (args[2].n_members if name.startswith("sdf")
                 else args[4].shape[0])
            members.setdefault(name, set()).add(n)
            return originals[name](*args, **kw)
        return rec

    def run(kernel, tc=tcfg):
        return ens_mod.train_ensemble(
            cfg, *batches, seeds=ENSEMBLE_SEEDS, tcfg=tc, verbose=False,
            exec_cfg=ExecutionConfig(kernel=kernel, compute_dtype="float32",
                                     device=DEVICE))

    # one untimed epoch per phase on each route first (set-up)
    for kernel in ("on", "off"):
        run(kernel, TrainConfig(1, 1, 1, ignore_epoch=0))
    ens_mod.run_phase = counted
    for name, (m, a) in launchers.items():
        setattr(m, a, recorder(name))
    try:
        results = {}
        for kernel in ("on", "off"):
            per_phase.clear()
            phase_s.clear()
            members.clear()
            K.reset_launch_count()
            C.reset_launch_count()
            final, hist = run(kernel)
            results[kernel] = dict(hist=hist, phases=dict(per_phase),
                                   seconds=dict(phase_s),
                                   members=dict(members), final=final)
    finally:
        ens_mod.run_phase = run_phase
        for name, (m, a) in launchers.items():
            setattr(m, a, originals[name])

    on, off = results["on"], results["off"]
    n_epochs = {"unconditional": SCHEDULE["num_epochs_unc"],
                "moment": SCHEDULE["num_epochs_moment"],
                "conditional": SCHEDULE["num_epochs"]}
    for phase, per in PER_EPOCH.items():
        want = tuple(n_epochs[phase] * v for v in per)
        check(on["phases"][phase] == want,
              f"ensemble {phase}: launches (fwd, bwd, cem_fwd, cem_bwd) "
              f"{on['phases'][phase]} != {want} (one launch per pass for "
              f"all {S} members)")
        check(off["phases"][phase] == (0, 0, 0, 0),
              f"ensemble kernel='off' launched kernels in {phase}")
    check(set(on["members"]) == set(launchers)
          and all(v == {S} for v in on["members"].values()),
          f"ensemble launches not all at S = {S}: {on['members']}")
    check(all(np.isfinite(v).all() for v in on["hist"].values())
          and all(bool(torch.isfinite(v).all())
                  for v in on["final"].values()),
          "non-finite ensemble history or params")
    dev_loss, dev_sharpe, where = _history_devs(on["hist"], off["hist"])
    check(dev_loss <= 1e-3, f"ensemble kernel vs plain: loss rel dev "
                            f"{dev_loss:.3e} > 1e-3")
    check(dev_sharpe <= 5e-3, f"ensemble kernel vs plain: Sharpe dev "
                              f"{dev_sharpe:.3e} > 5e-3")
    # each member against its own serial run on the kernel route
    serial = []
    t0 = time.perf_counter()
    for i, seed in enumerate(ENSEMBLE_SEEDS):
        _, _, h, _ = train_3phase(
            cfg, *batches, tcfg=tcfg, seed=seed, verbose=False,
            exec_cfg=ExecutionConfig(kernel="on", compute_dtype="float32",
                                     device=DEVICE))
        serial.append(_history_devs({k: v[i] for k, v in on["hist"].items()},
                                    h))
    serial_s = time.perf_counter() - t0
    s_loss, _, s_where = max(serial, key=lambda d: d[0])
    s_sharpe = max(d[1] for d in serial)
    check(s_loss <= 1e-3, f"ensemble member vs serial run: loss rel dev "
                          f"{s_loss:.3e} > 1e-3")
    check(s_sharpe <= 5e-3, f"ensemble member vs serial run: Sharpe dev "
                            f"{s_sharpe:.3e} > 5e-3")
    epoch_ms = {ens_mod.PHASE_SECTIONS[p]: 1e3 * on["seconds"][p] / n
                for p, n in n_epochs.items()}
    plain_ms = {ens_mod.PHASE_SECTIONS[p]: 1e3 * off["seconds"][p] / n
                for p, n in n_epochs.items()}
    fmt = lambda d: ", ".join(f"{k} {v:.2f}" for k, v in d.items())  # noqa: E731
    print(f"[ensemble train] {S} members (seeds {list(ENSEMBLE_SEEDS)}) "
          f"stacked, full width N={train.N} T={train.T}/{valid.T}/{test.T}, "
          f"dropout {DROPOUT}, schedule 8/4/16 ignore 2, f32 ({card})",
          flush=True)
    for phase, n in n_epochs.items():
        print(f"[ensemble train] launches {phase}: (fwd, bwd, cem_fwd, "
              f"cem_bwd) {on['phases'][phase]} = {n} epochs x "
              f"{PER_EPOCH[phase]}, every launch S={S}", flush=True)
    print(f"[ensemble train] kernel vs plain, every epoch of every member: "
          f"max loss rel dev {dev_loss:.3e} (bar 1e-3; {where[0]} member "
          f"{where[1]} epoch {where[2]}), max Sharpe dev {dev_sharpe:.3e} "
          f"(bar 5e-3)", flush=True)
    print(f"[ensemble train] members vs {S} serial train_3phase runs "
          f"(kernel route, {serial_s:.1f} s): max loss rel dev "
          f"{s_loss:.3e} ({s_where[0]} epoch {s_where[1]}), max Sharpe dev "
          f"{s_sharpe:.3e}", flush=True)
    print(f"[ensemble train] wall ms per epoch, S={S} kernel: "
          f"{fmt(epoch_ms)}; plain: {fmt(plain_ms)} ({card})", flush=True)
    print(f"[ensemble train] wall ms per member-epoch, S={S} kernel: "
          f"{fmt({k: v / S for k, v in epoch_ms.items()})}; S=1 (phase 6) "
          f"kernel: {fmt(single_epoch_ms)} ({card})", flush=True)
    if opts.profile:
        profile_ensemble(torch, cfg, on["final"], batches, card)
    launches = {name: sum(v[i] for v in on["phases"].values())
                for i, name in enumerate(("sdf_ffn_fwd", "sdf_ffn_bwd",
                                          "cond_em_fwd", "cond_em_bwd"))}
    return launches, S, epoch_ms, on["final"]


def profile_ensemble(torch, cfg, params, batches, card):
    """torch.profiler over 4 phase-3 ensemble epochs (train step + two
    evals each, nine members): device time by kernel, busy share."""
    from torch.profiler import ProfilerActivity, profile

    from deeplearninginassetpricing_paperreplication_torch.models.gan import \
        GAN
    from deeplearninginassetpricing_paperreplication_torch.training.steps \
        import (
            MemberOptimizer,
            eval_step_members,
            member_subtree,
            train_step_members,
        )
    from deeplearninginassetpricing_paperreplication_torch.utils.config \
        import ExecutionConfig

    gan = GAN(cfg, ExecutionConfig(compute_dtype="float32", device=DEVICE))
    b = [gan.prepare_batch(x) for x in batches]
    params = {k: v.clone() for k, v in params.items()}
    opt = MemberOptimizer(member_subtree(params, "sdf_net"), 1e-3)
    seeds = list(ENSEMBLE_SEEDS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for e in range(4):
            train_step_members(gan, "conditional", opt, params, b[0],
                               [s + e for s in seeds])
            eval_step_members(gan, params, b[1])
            eval_step_members(gan, params, b[2])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    evs, busy = device_events(prof)
    print(f"[profile ensemble] 4 phase-3 epochs x {len(seeds)} members in "
          f"{wall * 1e3:.1f} ms wall; device busy {busy:.2f} ms "
          f"({0.1 * busy / wall:.1f}% of the window; {card})", flush=True)
    for e in evs[:14]:
        print(f"[profile ensemble]   {e.self_device_time_total / 1e3:9.3f} ms"
              f"  {e.count:5d} x  {e.key[:90]}", flush=True)


def ensemble_cli_check(torch, card):
    """evaluate_ensemble --train_seeds (default bf16) with --save_dir, then
    --checkpoint_dirs on the run dirs it wrote: the same test Sharpe."""
    from deeplearninginassetpricing_paperreplication_torch import (
        evaluate_ensemble as ee,
    )
    from deeplearninginassetpricing_paperreplication_torch.utils.config \
        import ExecutionConfig

    shutil.rmtree(ENS_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    ee.main(["--data_dir", str(DATA_DIR), "--train_seeds",
             *map(str, ENSEMBLE_CLI_SEEDS),
             "--epochs_unc", str(SCHEDULE["num_epochs_unc"]),
             "--epochs_moment", str(SCHEDULE["num_epochs_moment"]),
             "--epochs", str(SCHEDULE["num_epochs"]), "--ignore_epoch",
             str(SCHEDULE["ignore_epoch"]), "--save_dir", str(ENS_DIR),
             "--device", DEVICE])
    wall = time.perf_counter() - t0
    report = json.loads((ENS_DIR / "ensemble_report.json").read_text())
    dirs = [str(ENS_DIR / f"seed_{s}") for s in ENSEMBLE_CLI_SEEDS]
    res = ee.evaluate_ensemble(dirs, str(DATA_DIR),
                               exec_cfg=ExecutionConfig(device=DEVICE),
                               verbose=False)
    reported = report["ensemble_sharpe"]["test"]
    check(np.isfinite(reported), "non-finite --train_seeds test Sharpe")
    d = abs(res["test_sharpe"] - reported)
    check(d <= 1e-6, f"--checkpoint_dirs test Sharpe {res['test_sharpe']} "
                     f"!= --train_seeds report {reported} (|d| {d:.3e})")
    print(f"[ensemble cli] --train_seeds {list(ENSEMBLE_CLI_SEEDS)} (bf16, "
          f"kernel auto) trained, evaluated and saved in {wall:.1f} s; test "
          f"Sharpe {reported:.6f}; --checkpoint_dirs on the saved run dirs "
          f"{res['test_sharpe']:.6f} (|d| {d:.1e}, bar 1e-6) ({card})",
          flush=True)
    shutil.rmtree(ENS_DIR, ignore_errors=True)


# -- phase 8 ------------------------------------------------------------------


def panel_counts(K, C):
    return (K.launches, K.bwd_launches, K.dx_launches, C.fwd_launches,
            C.bwd_launches, C.dx_launches)


def panel_gradient_checks(torch, K, C, card, splits, params, opts):
    """∂/∂individual of the nine trained members' conditional loss,
    unconditional loss and weights (against a seeded random cotangent),
    parameters frozen, on the train split: the kernel route against
    kernel="off" in f32 and bf16, the launches of one conditional call,
    and the launches of the whole phase per kernel."""
    from deeplearninginassetpricing_paperreplication_torch.models.gan import \
        GAN
    from deeplearninginassetpricing_paperreplication_torch.utils.config \
        import ExecutionConfig, GANConfig

    train = splits[0]
    cfg = GANConfig(macro_feature_dim=train.macro_feature_dim,
                    individual_feature_dim=train.individual_feature_dim,
                    dropout=DROPOUT)
    params = {k: v.detach() for k, v in params.items()}  # frozen
    batch = train.to_batch(DEVICE)
    S = params["sdf_net.output_proj.bias"].shape[0]
    dev = torch.device(DEVICE)
    cot = torch.randn(S, *batch["mask"].shape, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(8))
    wrt = (("conditional", "conditional"), ("unconditional", "unconditional"),
           ("weights", "unconditional"))

    def grad(gan, what, phase):
        ind = batch["individual"].clone().requires_grad_()
        res = gan.forward_members(params, dict(batch, individual=ind), phase)
        y = ((res["weights"] * cot).sum() if what == "weights"
             else res["loss"].sum())
        (dx,) = torch.autograd.grad(y, ind)
        return dx

    gans = {(kernel, cd): GAN(cfg, ExecutionConfig(
        kernel=kernel, compute_dtype=cd, device=DEVICE))
        for kernel in ("on", "off") for cd in ("float32", "bfloat16")}
    grad(gans[("on", "float32")], "conditional", "conditional")  # warm-up
    torch.cuda.synchronize()
    K.reset_launch_count()
    C.reset_launch_count()
    one = grad(gans[("on", "float32")], "conditional", "conditional")
    torch.cuda.synchronize()
    got = panel_counts(K, C)
    check(got == PANEL_GRAD_LAUNCHES,
          f"one conditional panel gradient launched (sdf_ffn_fwd, "
          f"sdf_ffn_bwd, sdf_ffn_dx, cond_em_fwd, cond_em_bwd, cond_em_dx) "
          f"{got}, not {PANEL_GRAD_LAUNCHES}")
    walls = {}
    for kernel in ("on", "off"):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            grad(gans[(kernel, "float32")], "conditional", "conditional")
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        walls[kernel] = statistics.median(times) * 1e3
    K.reset_launch_count()
    C.reset_launch_count()
    results = {}
    for cd in ("float32", "bfloat16"):
        for what, phase in wrt:
            on = grad(gans[("on", cd)], what, phase)
            off = grad(gans[("off", cd)], what, phase)
            err = rel_err(on, off)
            check(bool(torch.isfinite(on).all())
                  and err <= (GRAD_F32_REL if cd == "float32" else BF16_REL),
                  f"panel gradient of the {what} ({cd}): kernel vs plain "
                  f"max|d|/max|ref| {err:.3e}")
            results[(what, cd)] = (err, float(on.abs().max()))
    torch.cuda.synchronize()
    names = ("sdf_ffn_fwd", "sdf_ffn_bwd", "sdf_ffn_dx", "cond_em_fwd",
             "cond_em_bwd", "cond_em_dx")
    launches = dict(zip(names, panel_counts(K, C)))
    check(launches["sdf_ffn_bwd"] == 0,
          "a frozen-parameter panel gradient launched sdf_ffn_bwd")
    mean_abs = one.abs().mean(dim=(0, 1))  # [F]: mean |∂loss/∂x_f|
    top = torch.argsort(mean_abs, descending=True)[:5].tolist()
    print(f"[panel grad] S={S} members of phase 7, train split T={train.T} "
          f"N={train.N} F={train.individual_feature_dim}, parameters frozen "
          f"({card})", flush=True)
    print(f"[panel grad] one conditional call launched (fwd, bwd, dx, "
          f"cem_fwd, cem_bwd, cem_dx) {got}; wall ms (forward + grad, f32) "
          f"kernel {walls['on']:.2f}, plain {walls['off']:.2f}", flush=True)
    for (what, cd), (err, amax) in results.items():
        print(f"[panel grad] d {what} / d individual, {cd}: kernel vs plain "
              f"max|d|/max|ref| {err:.2e} (bar "
              f"{GRAD_F32_REL if cd == 'float32' else BF16_REL:g}); "
              f"max|dx| {amax:.3e}", flush=True)
    print(f"[panel grad] conditional loss, f32: max|dx| "
          f"{float(one.abs().max()):.3e}; characteristics with the largest "
          f"mean |dloss/dx_f|: "
          + ", ".join(f"f{f} {float(mean_abs[f]):.3e}" for f in top),
          flush=True)
    print(f"[panel grad] launches on the kernel route ({len(results)} "
          f"gradients): {launches}", flush=True)
    if opts.profile:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(4):
                grad(gans[("on", "float32")], "conditional", "conditional")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        evs, busy = device_events(prof)
        print(f"[profile panel grad] 4 conditional panel gradients, S={S}, "
              f"f32, in {wall * 1e3:.1f} ms wall; device busy {busy:.2f} ms "
              f"({0.1 * busy / wall:.1f}% of the window; {card})",
              flush=True)
        for e in evs[:10]:
            print(f"[profile panel grad]   {e.self_device_time_total / 1e3:9.3f}"
                  f" ms  {e.count:5d} x  {e.key[:90]}", flush=True)
    return launches


# -- phase 9 ------------------------------------------------------------------


def sweep_plan_lines(torch, K, C, tag, cfg, S, splits, card):
    """The launch plans of a sweep bucket's four training kernels (f32) as
    the card holds them: the FFN forward and conditional-EM forward at the
    train and valid splits' T, the backwards at the train split's; fails
    if the card keeps fewer blocks resident than planned or a kernel
    spills."""
    dev = torch.device(DEVICE)
    lay = K.ffn_layout(cfg.individual_feature_dim, cfg.hidden_dim)
    F, Kn, N, cd = cfg.individual_feature_dim, cfg.num_condition_moment, \
        splits[0].N, "float32"
    for T in (splits[0].T, splits[1].T):
        plan = K.card_fwd_plan(lay, dev, S, T, N, cd)
        info = K.fwd_plan_info(lay, S, plan)
        check(info["blocks_per_sm"] >= plan.blocks_per_sm
              and info["local_bytes"] == 0,
              f"sweep {tag} sdf_ffn_fwd plan {plan}: the card holds "
              f"{info['blocks_per_sm']} blocks per SM, "
              f"{info['local_bytes']} B local")
        print(f"[sweep] {tag} plan sdf_ffn_fwd S={S} T={T} N={N} route "
              f"{plan.route} tile {plan.tile} threads {plan.threads} members "
              f"{plan.members} smem {plan.smem_bytes} B resident "
              f"{info['blocks_per_sm']}/SM (planned {plan.blocks_per_sm}) G "
              f"{plan.G} of {plan.cells} cells regs {info['registers']} "
              f"local {info['local_bytes']} B", flush=True)
        if T == splits[0].T:
            _, bp = bwd_plan_of(torch, K, lay, S, T, N)
            print(f"[sweep] {tag} plan sdf_ffn_bwd S={S} T={T} N={N} "
                  f"{plan_text(bp)}", flush=True)
        for p in C.card_cem_plan(dev, S, T, N, F, Kn, cd):
            if p.kernel == "bwd" and T != splits[0].T:
                continue
            info = C.plan_info(p, S, T, N, F, Kn, cd)
            check(info["blocks_per_sm"] >= p.blocks_per_sm
                  and info["local_bytes"] == 0,
                  f"sweep {tag} cond_em_{p.kernel} plan {p}: the card holds "
                  f"{info['blocks_per_sm']} blocks per SM, "
                  f"{info['local_bytes']} B local")
            print(f"[sweep] {tag} plan cond_em_{p.kernel} S={S} T={T} N={N} "
                  f"K={Kn} route {p.route} tile {p.tile} members "
                  f"{p.members} threads {p.threads} var {p.var} stages "
                  f"{p.stages} smem {p.smem_bytes} B resident "
                  f"{info['blocks_per_sm']}/SM (planned {p.blocks_per_sm}) "
                  f"groups {p.groups} grid {list(p.grid)} regs "
                  f"{info['registers']} local {info['local_bytes']} B",
                  flush=True)


def sweep_kernel_checks(torch, K, C, card):
    """The four training kernels against their plain versions at the
    sweep's shapes (T, N = SWEEP_TN), through the phase-3 checks: each
    covering-grid bucket at S = 4 (f32, its widths, K and dropout rate) and
    the --quick search's S = 2 (bf16, (64, 64) and (32, 32), K = 8, dropout
    0.05), one dropout seed per grid point. Returns {kernel: {case: row}}
    for the kernels line."""
    T, N = SWEEP_TN
    cases = [(f"B{i + 1}", len(SWEEP_LRS), (h,), k, d, "float32")
             for i, (h, _, k, d) in enumerate(SWEEP_BUCKETS)]
    cases.append(("quick", 2, ((64, 64), (32, 32)), 8, DROPOUT, "bfloat16"))
    rows = {n: {} for n in ("sdf_ffn_fwd", "sdf_ffn_bwd", "cond_em_fwd",
                            "cond_em_bwd")}
    for tag, S, hiddens, Kn, rate, cd in cases:
        names = {h: tag if len(hiddens) == 1 else f"{tag} {list(h)}"
                 for h in hiddens}
        fwd = wide_checks(torch, K, card, "fwd", hiddens, [(S, T, N)],
                          (cd,), rate)
        for h in hiddens:
            rows["sdf_ffn_fwd"][names[h]] = fwd[(h, S, T, N, cd)]
            rows["sdf_ffn_bwd"][names[h]] = ffn_bwd_checks(
                torch, K, card, h, [(S, T, N)], (cd,), (rate,))[
                    (S, T, N, cd, rate)]
        cem = cond_em_checks(torch, C, card, (Kn,), [(S, N)], (cd,),
                             odd=False)
        for k in ("fwd", "bwd"):
            rows[f"cond_em_{k}"][tag] = cem[(k, S, N, Kn, cd)]
    return rows


def _point_devs(a, b, i, j):
    """(loss rel dev, Sharpe dev) between grid point i of bucket output a
    and point j of b: their histories and reported valid Sharpes."""
    dev_loss, dev_sharpe, _ = _history_devs(
        {k: v[i] for k, v in a["history"].items()},
        {k: v[j] for k, v in b["history"].items()})
    ra, rb = a["best_valid_sharpe"][i], b["best_valid_sharpe"][j]
    dev_rep = 0.0 if ra == rb else abs(float(ra) - float(rb))
    return dev_loss, max(dev_sharpe, dev_rep)


def sweep_checks(torch, K, C, card, splits):
    """run_sweep over the covering grid (four buckets × four lrs × seed 42,
    f32, a ledger): every pass of a bucket one launch per kernel for all
    four grid points; B2 on the kernel route against kernel="off"; B1's
    lr 2e-3 point against a one-point bucket; a resume from the ledger that
    launches nothing and returns the same ranking bit for bit. Returns the
    search's launches by kernel and its ranking (phase 13's reference)."""
    from deeplearninginassetpricing_paperreplication_torch.parallel import (
        ensemble as ens_mod,
    )
    from deeplearninginassetpricing_paperreplication_torch.parallel import (
        sweep as sw,
    )
    from deeplearninginassetpricing_paperreplication_torch.reliability \
        .ledger import SweepLedger
    from deeplearninginassetpricing_paperreplication_torch.utils.config \
        import ExecutionConfig, GANConfig, TrainConfig

    train, valid, _ = splits
    base = GANConfig(macro_feature_dim=train.macro_feature_dim,
                     individual_feature_dim=train.individual_feature_dim)
    cfgs = [dataclasses.replace(base, hidden_dim=h, num_units_rnn=r,
                                num_condition_moment=k, dropout=d)
            for h, r, k, d in SWEEP_BUCKETS]
    configs = [(c, lr) for c in cfgs for lr in SWEEP_LRS]
    tcfg = TrainConfig(**SCHEDULE, seed=SWEEP_SEED, print_freq=10 ** 6)
    batches = [ds.to_batch(DEVICE) for ds in (train, valid)]
    G = len(SWEEP_LRS)
    n_epochs = {"unconditional": SCHEDULE["num_epochs_unc"],
                "moment": SCHEDULE["num_epochs_moment"],
                "conditional": SCHEDULE["num_epochs"]}
    epochs = sum(n_epochs.values())

    def execution(kernel):
        return ExecutionConfig(kernel=kernel, compute_dtype="float32",
                               device=DEVICE)

    def bucket(cfg, lrs, kernel="on", tc=tcfg):
        return sw.train_bucket(cfg, lrs, [SWEEP_SEED], *batches, tc,
                               exec_cfg=execution(kernel))

    # one untimed epoch per phase of every bucket (and of B2's plain route)
    # first: library loads and the allocator's first growth are set-up
    warm = TrainConfig(1, 1, 1, ignore_epoch=0)
    for c in cfgs:
        bucket(c, SWEEP_LRS, tc=warm)
    bucket(cfgs[1], SWEEP_LRS, "off", warm)
    torch.cuda.synchronize()

    real_bucket, real_phase = sw.train_bucket, ens_mod.run_phase
    launchers = {"sdf_ffn_fwd": (K, "_launch"),
                 "sdf_ffn_bwd": (K, "_launch_bwd"),
                 "cond_em_fwd": (C, "_launch_fwd"),
                 "cond_em_bwd": (C, "_launch_bwd")}
    originals = {n: getattr(m, a) for n, (m, a) in launchers.items()}
    runs, phases, members = [], {}, {}

    def counted_phase(gan, phase, *args, **kw):
        before = counts(K, C)
        out = real_phase(gan, phase, *args, **kw)
        phases[phase] = tuple(a - c for a, c in zip(counts(K, C), before))
        return out

    def counted_bucket(*args, **kw):
        phases.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_bucket(*args, **kw)
        torch.cuda.synchronize()
        runs.append(dict(out=out, seconds=time.perf_counter() - t0,
                         phases=dict(phases)))
        return out

    def recorder(name):
        # records the member count of each launch; the count of launches
        # stays the wrapper's own
        def rec(*args, **kw):
            n = (args[2].n_members if name.startswith("sdf")
                 else args[4].shape[0])
            members.setdefault(name, set()).add(n)
            return originals[name](*args, **kw)
        return rec

    shutil.rmtree(SWEEP_DIR, ignore_errors=True)
    ledger = SweepLedger(SWEEP_DIR / "sweep_ledger")
    stats = {}
    sw.train_bucket, ens_mod.run_phase = counted_bucket, counted_phase
    for name, (m, a) in launchers.items():
        setattr(m, a, recorder(name))
    try:
        K.reset_launch_count()
        C.reset_launch_count()
        ranked = sw.run_sweep(configs, [SWEEP_SEED], *batches, tcfg=tcfg,
                              top_k=None, verbose=False,
                              exec_cfg=execution("on"), stats_out=stats,
                              ledger=ledger)
        torch.cuda.synchronize()
        totals = counts(K, C)
    finally:
        sw.train_bucket, ens_mod.run_phase = real_bucket, real_phase
        for name, (m, a) in launchers.items():
            setattr(m, a, originals[name])
    names = ("sdf_ffn_fwd", "sdf_ffn_bwd", "cond_em_fwd", "cond_em_bwd")
    launches = dict(zip(names, totals))

    # (a) every pass one launch for the bucket's four grid points
    check(stats["n_buckets"] == len(cfgs) and len(runs) == len(cfgs)
          and stats["ledger_writes"] == len(cfgs),
          f"run_sweep: {stats} over {len(runs)} trained buckets, not "
          f"{len(cfgs)}")
    check(set(members) == set(launchers)
          and all(v == {G} for v in members.values()),
          f"sweep launches not all at S = {G}: {members}")
    print(f"[sweep] covering grid: {len(cfgs)} buckets x lrs "
          f"{list(SWEEP_LRS)} x seed {SWEEP_SEED} (S={G} a bucket), f32, "
          f"schedule 8/4/16 ignore 2, N={train.N} T={train.T}/{valid.T}, "
          f"no test evals ({card})", flush=True)
    for i, (c, run) in enumerate(zip(cfgs, runs)):
        tag = f"B{i + 1}"
        for phase, per in SWEEP_PER_EPOCH.items():
            want = tuple(n_epochs[phase] * v for v in per)
            check(run["phases"][phase] == want,
                  f"sweep {tag} {phase}: launches (fwd, bwd, cem_fwd, "
                  f"cem_bwd) {run['phases'][phase]} != {want} (one launch "
                  f"per pass for all {G} grid points)")
        out = run["out"]
        check(all(np.isfinite(v).all() for v in out["history"].values())
              and np.isfinite(out["best_valid_sharpe"]).all()
              and all(bool(torch.isfinite(v).all())
                      for v in out["params"].values()),
              f"sweep {tag}: non-finite history, Sharpe or params")
        print(f"[sweep] {tag} hidden={list(c.hidden_dim)} "
              f"rnn={list(c.num_units_rnn)} K={c.num_condition_moment} "
              f"dropout {c.dropout}: {run['seconds']:.3f} s wall, "
              f"{run['seconds'] * 1e3 / (G * epochs):.2f} ms per "
              f"grid-point-epoch ({run['seconds'] * 1e3 / epochs:.2f} ms per "
              f"epoch at S={G}); launches "
              + ", ".join(f"{p} {run['phases'][p]}" for p in n_epochs)
              + f"; reported valid Sharpes "
              f"{[round(float(v), 6) for v in out['best_valid_sharpe']]}",
              flush=True)
        sweep_plan_lines(torch, K, C, tag, c, G, splits, card)
    print(f"[sweep] launches of the whole search: {launches}; every launch "
          f"S={G}; ranking top: lr {ranked[0]['lr']} hidden "
          f"{list(ranked[0]['config'].hidden_dim)} valid Sharpe "
          f"{ranked[0]['valid_sharpe']:.6f}", flush=True)

    # (b) B2 on the kernel route against kernel="off"
    before = counts(K, C)
    t0 = time.perf_counter()
    off = bucket(cfgs[1], SWEEP_LRS, "off")
    torch.cuda.synchronize()
    off_s = time.perf_counter() - t0
    check(counts(K, C) == before, "kernel='off' launched kernels in B2")
    devs = [_point_devs(runs[1]["out"], off, i, i) for i in range(G)]
    dev_loss, dev_sharpe = max(d[0] for d in devs), max(d[1] for d in devs)
    check(dev_loss <= 1e-3, f"sweep B2 kernel vs plain: loss rel dev "
                            f"{dev_loss:.3e} > 1e-3")
    check(dev_sharpe <= 5e-3, f"sweep B2 kernel vs plain: Sharpe dev "
                              f"{dev_sharpe:.3e} > 5e-3")
    print(f"[sweep] B2 kernel vs plain, every epoch of the {G} grid points "
          f"and their reported valid Sharpes: max loss rel dev "
          f"{dev_loss:.3e} (bar 1e-3), max Sharpe dev {dev_sharpe:.3e} (bar "
          f"5e-3); wall s kernel {runs[1]['seconds']:.3f}, plain "
          f"{off_s:.3f} ({card})", flush=True)

    # (c) the per-member lr: B1's lr 2e-3 point alone in a one-point bucket
    i = SWEEP_LRS.index(2e-3)
    one = bucket(cfgs[0], [2e-3])
    dev_loss, dev_sharpe = _point_devs(runs[0]["out"], one, i, 0)
    check(dev_loss <= 1e-3 and dev_sharpe <= 5e-3,
          f"sweep B1 lr 2e-3 point vs a one-point bucket: loss rel dev "
          f"{dev_loss:.3e}, Sharpe dev {dev_sharpe:.3e}")
    print(f"[sweep] B1 lr 2e-3 (grid point {i} of S={G}) vs a one-point "
          f"bucket (S=1, same init and dropout seeds): max loss rel dev "
          f"{dev_loss:.3e} (bar 1e-3), max Sharpe dev {dev_sharpe:.3e} (bar "
          f"5e-3)", flush=True)

    # (d) resume: every bucket from the ledger, nothing launched
    torch.cuda.synchronize()
    K.reset_launch_count()
    C.reset_launch_count()
    again_stats = {}
    t0 = time.perf_counter()
    again = sw.run_sweep(configs, [SWEEP_SEED], *batches, tcfg=tcfg,
                         top_k=None, verbose=False, exec_cfg=execution("on"),
                         stats_out=again_stats,
                         ledger=SweepLedger(SWEEP_DIR / "sweep_ledger"),
                         consult_ledger=True)
    resume_s = time.perf_counter() - t0
    check(panel_counts(K, C) == (0,) * 6,
          f"the ledger resume launched kernels: {panel_counts(K, C)}")
    check(again_stats["ledger_hits"] == len(cfgs)
          and again_stats["ledger_writes"] == 0,
          f"the ledger resume: {again_stats}")
    row = lambda r: (r["config"], r["lr"], r["seed"], r["valid_sharpe"])  # noqa: E731
    check([row(r) for r in again] == [row(r) for r in ranked],
          "the ranking resumed from the ledger differs from the search's")
    print(f"[sweep] resume from the ledger: {again_stats['ledger_hits']} "
          f"hits, 0 launches, the ranking of {len(again)} points equal bit "
          f"for bit, in {resume_s:.3f} s", flush=True)
    return launches, ranked


def sweep_cli_check(torch, card):
    """``python -m ...sweep --quick`` (bf16, kernel auto) on the panel, then
    evaluate_ensemble --checkpoint_dirs on the rank0 run dirs it wrote:
    the report's test Sharpe within 1e-6; the report's and the ranking's
    sidecars verify."""
    from deeplearninginassetpricing_paperreplication_torch.evaluate_ensemble \
        import evaluate_ensemble
    from deeplearninginassetpricing_paperreplication_torch.reliability \
        import verified
    from deeplearninginassetpricing_paperreplication_torch.utils.config \
        import ExecutionConfig

    save = SWEEP_DIR / "cli"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"{PKG}.sweep", "--data_dir", str(DATA_DIR),
         "--save_dir", str(save), "--quick", "--device", DEVICE],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"the sweep CLI exited {proc.returncode}:\n"
                                f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    loaded = {}
    for name in ("report.json", "sweep_ranking.json"):
        # the file itself, through its own sidecar: load_verified would
        # also pass a file with no sidecar, or fall back a generation
        path = save / name
        check(verified.digest_path(path).exists(),
              f"the sweep CLI wrote {name} with no sha256 sidecar")
        loaded[name], used = verified.load_verified(path, json.loads)
        check(used == path, f"{name} did not verify: loaded {used}")
    report, ranking = loaded["report.json"], loaded["sweep_ranking.json"]
    dirs = sorted(str(p) for p in save.glob("rank0_seed*"))
    check(len(dirs) == 3 and len(ranking) == 4,
          f"the sweep CLI wrote {len(dirs)} rank0 dirs and "
          f"{len(ranking)} ranking rows")
    res = evaluate_ensemble(dirs, str(DATA_DIR),
                            exec_cfg=ExecutionConfig(device=DEVICE),
                            verbose=False)
    reported = report["winners"][0]["ensemble_sharpe"]["test"]
    check(reported is not None and np.isfinite(reported),
          "non-finite sweep CLI test Sharpe")
    d = abs(res["test_sharpe"] - reported)
    check(d <= 1e-6, f"--checkpoint_dirs test Sharpe {res['test_sharpe']} "
                     f"!= the sweep report's {reported} (|d| {d:.3e})")
    print(f"[sweep cli] --quick (bf16, kernel auto): 2 buckets x 2 lrs "
          f"searched, {len(report['winners'])} winners x 3 seeds trained, in "
          f"{wall:.1f} s (search {report['search_seconds']} s); winner 0 "
          f"test Sharpe {reported:.6f}; --checkpoint_dirs on rank0_seed* "
          f"{res['test_sharpe']:.6f} (|d| {d:.1e}, bar 1e-6); grand "
          f"ensemble ({report['n_grand_members']} members) test Sharpe "
          f"{report['grand_ensemble_test_sharpe']:.6f}; report.json and "
          f"sweep_ranking.json sidecars verify ({card})", flush=True)
    shutil.rmtree(SWEEP_DIR, ignore_errors=True)


# -- main ----------------------------------------------------------------------


# -- phase 10 -----------------------------------------------------------------


def health_cli_files(card):
    """The train CLI's run dir under --diag_stride: the drift profile,
    health.json and the diag_* fields of history.npz, each verified."""
    from deeplearninginassetpricing_paperreplication_torch.observability \
        import drift, modelhealth
    from deeplearninginassetpricing_paperreplication_torch.ops.diagnostics \
        import SCALAR_KEYS
    from deeplearninginassetpricing_paperreplication_torch.reliability \
        .verified import digest_path

    for name in ("reference_profile.json", "health.json"):
        check((RUN_DIR / name).exists() and digest_path(RUN_DIR / name)
              .exists(), f"the train CLI under --diag_stride left no "
                         f"verified {name}")
    hist = np.load(RUN_DIR / "history.npz")
    want = [float(e % CLI_DIAG_STRIDE == 0) for n in (
        SCHEDULE["num_epochs_unc"], SCHEDULE["num_epochs"]) for e in range(n)]
    check(all(f"diag_{k}" in hist.files for k in SCALAR_KEYS)
          and "diag_moment_violations" in hist.files,
          "history.npz lacks diag_* fields")
    check(hist["diag_computed"].tolist() == want,
          f"diag_computed {hist['diag_computed'].tolist()} != {want}")
    health = modelhealth.read_health(RUN_DIR)
    profile = drift.read_profile(RUN_DIR)
    check(health is not None and health["finite"], "CLI health.json is "
                                                   "missing or non-finite")
    check(profile is not None and len(profile["individual"])
          == PANEL["n_features"], "CLI reference_profile.json is unusable")
    print(f"[health cli] train --diag_stride {CLI_DIAG_STRIDE}: "
          f"reference_profile.json ({profile['n_periods']} x "
          f"{profile['n_stocks']}), health.json (moment_violation_max "
          f"{health['diagnostics']['moment_violation_max']:.6f}, history "
          f"row {health['history_last']['history_row']}), "
          f"{int(hist['diag_computed'].sum())} diag rows of "
          f"{hist['diag_computed'].size} ({card})", flush=True)


def diag_pass_checks(torch, K, C, card, splits, models):
    """(a) The diagnostics pass (``diagnostics_members``) of phase 6's model
    (S = 1) and phase 7's nine members (S = 9) on the valid split, kernel
    route against kernel="off" in f32 and bf16; the identity mean_k v_k² ==
    loss_cond of the eval forward on the kernel route (f32, rtol 1e-6); one
    pass launching sdf_ffn_fwd and cond_em_fwd once each and nothing else;
    each pass event-timed and its device ms from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from deeplearninginassetpricing_paperreplication_torch.models.gan import \
        GAN
    from deeplearninginassetpricing_paperreplication_torch.ops.diagnostics \
        import diagnostics_members
    from deeplearninginassetpricing_paperreplication_torch.utils.config \
        import ExecutionConfig

    valid = splits[1]
    rows = {}
    for tag, cfg, params in models:
        S = next(iter(params.values())).shape[0]
        gans = {(kernel, cd): GAN(cfg, ExecutionConfig(
            kernel=kernel, compute_dtype=cd, device=DEVICE))
            for kernel in ("on", "off") for cd in ("float32", "bfloat16")}
        batch = gans["on", "float32"].prepare_batch(valid.to_batch(DEVICE))
        row = {}
        for cd in ("float32", "bfloat16"):
            on_gan, off_gan = gans["on", cd], gans["off", cd]
            K.reset_launch_count()
            C.reset_launch_count()
            d_on = diagnostics_members(on_gan, params, batch)
            torch.cuda.synchronize()
            n = panel_counts(K, C)
            check(n == (1, 0, 0, 1, 0, 0),
                  f"{tag} {cd}: one diagnostics pass launched (fwd, bwd, dx, "
                  f"cem_fwd, cem_bwd, cem_dx) {n}, not (1, 0, 0, 1, 0, 0)")
            d_off = {k: v.cpu().numpy() for k, v in diagnostics_members(
                off_gan, params, batch).items()}
            worst = 0.0
            for k, b in d_off.items():
                a = d_on[k].cpu().numpy()
                # adv_gap = loss_cond - loss_unc errs as its terms do
                ref = (np.maximum(np.abs(d_off["loss_cond"]),
                                  np.abs(d_off["loss_unc"]))
                       if k == "adv_gap" else b)
                check(np.isfinite(a).all(), f"{tag} {cd}: non-finite {k}")
                check(within(np.abs(a - b), ref, cd, **F32_TOL),
                      f"{tag} {cd}: diagnostics {k} kernel {a} vs plain {b}")
                if np.abs(ref).max():
                    worst = max(worst, float(np.max(np.abs(a - b))
                                             / np.abs(ref).max()))
            ms = cuda_ms(torch, lambda: diagnostics_members(
                on_gan, params, batch), reps=DIAG_TIMED_PASSES, warmup=1)
            plain_ms = cuda_ms(torch, lambda: diagnostics_members(
                off_gan, params, batch), reps=DIAG_TIMED_PASSES, warmup=1)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(DIAG_TIMED_PASSES):
                    diagnostics_members(on_gan, params, batch)
                torch.cuda.synchronize()
            _, busy = device_events(prof)
            row[cd] = dict(ms=ms, device_ms=busy / DIAG_TIMED_PASSES,
                           plain_ms=plain_ms, max_rel_dev=worst)
            if cd == "float32":
                with torch.no_grad():
                    loss_cond = on_gan.forward_members(
                        params, batch, "conditional")["loss_conditional"]
                v2 = (d_on["moment_violations"].double() ** 2).mean(dim=1)
                rel = float(((v2 - loss_cond.double()).abs()
                             / loss_cond.double().abs()).max())
                check(rel <= 1e-6, f"{tag}: mean_k v_k^2 vs the eval "
                                   f"loss_cond, rel {rel:.3e} > 1e-6")
                row["identity_rel"] = rel
                row["moment_violation_max"] = [
                    round(float(x), 6) for x in d_on["moment_violation_max"]]
            print(f"[health diag] {tag} S={S} T={valid.T} N={valid.N} {cd}: "
                  f"kernel {ms:.4f} ms (device {busy / DIAG_TIMED_PASSES:.4f}"
                  f" ms), plain {plain_ms:.4f} ms a pass; kernel vs plain max "
                  f"rel dev {worst:.3e}; launches (fwd, bwd, dx, cem_fwd, "
                  f"cem_bwd, cem_dx) {n} ({card})", flush=True)
        print(f"[health diag] {tag} S={S}: mean_k v_k^2 vs eval loss_cond "
              f"max rel {row['identity_rel']:.3e} (bar 1e-6); "
              f"moment_violation_max {row['moment_violation_max']}",
              flush=True)
        rows[f"S={S}"] = row
    return rows


def diag_train_check(torch, K, C, card, splits, single):
    """(b) train_3phase with phase 6's seed, config and schedule on the
    kernel route, without and with diag_stride, in turns (without, with,
    with, without), each with a save_dir: every run's final params and
    non-diag history bit for bit phase 6's, the best checkpoints with the
    diagnostics bit for bit those without, the forward kernels' launches
    risen by exactly the stride epochs + 1 over phase 6's, and a finite
    health.json loaded as the file itself."""
    from deeplearninginassetpricing_paperreplication_torch.observability \
        .modelhealth import HEALTH_FILENAME
    from deeplearninginassetpricing_paperreplication_torch.reliability \
        .verified import digest_path, load_verified
    from deeplearninginassetpricing_paperreplication_torch.training \
        .checkpoint import load_checkpoint_dir
    from deeplearninginassetpricing_paperreplication_torch.training.trainer \
        import Trainer, train_3phase
    from deeplearninginassetpricing_paperreplication_torch.utils.config \
        import ExecutionConfig, TrainConfig

    # the stride's cost inside the trainer: each in-training diagnostics
    # pass between two CUDA events (its stream time) and two host clocks
    # (its Python and launch time); neither syncs, so the run is unchanged
    untimed, spans = Trainer.diagnostics, []

    def timed(self, batch):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        a.record()
        out = untimed(self, batch)
        b.record()
        spans.append((a, b, time.perf_counter() - t0))
        return out

    batches = [ds.to_batch(DEVICE) for ds in splits]
    n_epochs = {"unconditional": SCHEDULE["num_epochs_unc"],
                "moment": SCHEDULE["num_epochs_moment"],
                "conditional": SCHEDULE["num_epochs"]}
    train_launches = tuple(sum(n_epochs[p] * per[i]
                               for p, per in PER_EPOCH.items())
                           for i in range(4))
    n_diag = sum(-(-n_epochs[p] // DIAG_STRIDE)
                 for p in ("unconditional", "conditional"))
    runs = []
    for i, stride in enumerate((None, DIAG_STRIDE, DIAG_STRIDE, None)):
        save = HEALTH_DIR / f"train_{i}_stride_{stride}"
        shutil.rmtree(save, ignore_errors=True)
        K.reset_launch_count()
        C.reset_launch_count()
        t0 = time.perf_counter()
        Trainer.diagnostics = timed
        try:
            _, params, hist, trainer = train_3phase(
                single["cfg"], *batches, tcfg=TrainConfig(
                    **SCHEDULE, seed=42, print_freq=10 ** 6),
                save_dir=str(save), seed=42, verbose=False,
                diag_stride=stride, exec_cfg=ExecutionConfig(
                    kernel="on", compute_dtype="float32", device=DEVICE))
        finally:
            Trainer.diagnostics = untimed
        torch.cuda.synchronize()
        runs.append(dict(params=params, hist=hist, save=save, stride=stride,
                         launches=panel_counts(K, C),
                         wall=time.perf_counter() - t0,
                         epoch_ms=trainer.epoch_ms()))
    off, on = runs[0], runs[1]
    for r in runs:
        tag = "with" if r["stride"] else "without"
        # each run with a save_dir adds the health.json pass: one launch of
        # each forward kernel
        extra = n_diag + 1 if r["stride"] else 1
        want = (train_launches[0] + extra, train_launches[1], 0,
                train_launches[2] + extra, train_launches[3], 0)
        check(r["launches"] == want, f"{tag} diagnostics: launches (fwd, "
              f"bwd, dx, cem_fwd, cem_bwd, cem_dx) {r['launches']} != {want}")
        check(all(torch.equal(r["params"][k], single["params"][k])
                  for k in single["params"]),
              f"final params {tag} diagnostics differ from phase 6's")
        for k, v in single["hist"].items():
            check(np.array_equal(r["hist"][k], v),
                  f"history {k} {tag} diagnostics differs from phase 6's")
    for which in ("best_model_loss", "best_model_sharpe", "final_model"):
        a, b = (load_checkpoint_dir(r["save"], which)[1] for r in (off, on))
        check(all(torch.equal(a[k], b[k]) for k in a),
              f"{which}.pt differs with the diagnostics on")
    path = on["save"] / HEALTH_FILENAME
    doc, got = load_verified(path, lambda b: json.loads(b.decode()))
    check(digest_path(path).exists() and got == path,
          f"health.json loaded from {got}, not the verified {path}")
    diag = doc["diagnostics"]
    check(doc["finite"] and all(np.isfinite(v) for v in diag.values()
                                if isinstance(v, float))
          and np.isfinite(diag["moment_violations"]).all(),
          "health.json of the diag run is not finite")
    check(np.array_equal(on["hist"]["diag_computed"], [
        float(e % DIAG_STRIDE == 0) for p in ("unconditional", "conditional")
        for e in range(n_epochs[p])]), "diag_computed pattern is wrong")
    fmt = lambda d: ", ".join(f"{k} {v:.2f}" for k, v in d.items())  # noqa: E731

    def mean_ms(stride):
        rs = [r["epoch_ms"] for r in runs if r["stride"] == stride]
        return {k: sum(r[k] for r in rs) / len(rs) for k in rs[0]}

    epoch_on, epoch_off = mean_ms(DIAG_STRIDE), mean_ms(None)
    n_runs = sum(1 for r in runs if r["stride"])
    check(len(spans) == n_runs * n_diag, f"{len(spans)} timed in-training "
          f"passes != {n_runs} runs x {n_diag} stride epochs")
    n_diag_epochs = n_runs * (n_epochs["unconditional"]
                              + n_epochs["conditional"])
    pass_ms = statistics.median(a.elapsed_time(b) for a, b, _ in spans)
    host_pass_ms = statistics.median(1e3 * h for _, _, h in spans)
    overhead = dict(
        stream_ms_per_epoch=sum(a.elapsed_time(b) for a, b, _ in spans)
        / n_diag_epochs,
        host_ms_per_epoch=1e3 * sum(h for _, _, h in spans) / n_diag_epochs,
        pass_stream_ms=pass_ms, pass_host_ms=host_pass_ms)
    print(f"[health train] diag_stride {DIAG_STRIDE} vs phase 6 (f32 kernel "
          f"route, dropout {DROPOUT}, 8/4/16): final params, best "
          f"checkpoints and non-diag history bit for bit; launches (fwd, bwd, "
          f"dx, cem_fwd, cem_bwd, cem_dx) {on['launches']} = training "
          f"{train_launches} + {n_diag} stride epochs + 1 health pass of "
          f"each forward; health.json verified, moment_violation_max "
          f"{diag['moment_violation_max']:.6f}", flush=True)
    for r in runs:
        print(f"[health train] run diag_stride {r['stride']}: wall ms per "
              f"epoch {fmt(r['epoch_ms'])}; {r['wall']:.2f} s", flush=True)
    print(f"[health train] wall ms per epoch, mean of two runs each, with "
          f"diagnostics: {fmt(epoch_on)}; without: {fmt(epoch_off)}; phase "
          f"6: {fmt(single['epoch_ms'])} ({card})", flush=True)
    print(f"[health train] the stride's overhead, timed in the trainer over "
          f"{len(spans)} passes: {overhead['stream_ms_per_epoch']:.4f} ms of "
          f"stream time and {overhead['host_ms_per_epoch']:.4f} ms of host "
          f"time per phase-1/3 epoch at diag_stride {DIAG_STRIDE}; one pass "
          f"median {pass_ms:.4f} ms stream, {host_pass_ms:.4f} ms host "
          f"({card})", flush=True)
    return dict(launches=on["launches"], epoch_ms_diag=epoch_on,
                epoch_ms_off=epoch_off, n_diag=n_diag, overhead=overhead)


def _promote_cli(argv):
    """The port's promotion CLI in this process: (exit code, its JSON
    line)."""
    import contextlib
    import io

    from deeplearninginassetpricing_paperreplication_torch.reliability \
        import promotion

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = promotion.main(argv)
    lines = out.getvalue().strip()
    return rc, json.loads(lines) if lines else None


def promotion_checks(torch, K, C, card, splits, ens_cfg, ens_params):
    """(c) The promotion CLI on phase 7's nine members, saved as run dirs,
    with the valid split as a .npz: generation 1 with the offline valid
    Sharpe; a NaN member, a truncated member and a 3-sigma-shifted panel
    each rejected by its slug; then a second generation, rollback and
    show."""
    from deeplearninginassetpricing_paperreplication_torch.observability \
        .drift import reference_profile, write_profile
    from deeplearninginassetpricing_paperreplication_torch.parallel.ensemble \
        import ensemble_metrics
    from deeplearninginassetpricing_paperreplication_torch.training \
        .checkpoint import member_state_dicts, save_state_dict
    from deeplearninginassetpricing_paperreplication_torch.utils.config \
        import ExecutionConfig

    train, valid, _ = splits
    members = HEALTH_DIR / "members"
    shutil.rmtree(members, ignore_errors=True)
    dirs = []
    for seed, sd in zip(ENSEMBLE_SEEDS, member_state_dicts(ens_params)):
        d = members / f"seed_{seed}"
        d.mkdir(parents=True)
        ens_cfg.save(d / "config.json")
        save_state_dict(d / "best_model_sharpe.pt", sd)
        dirs.append(str(d))
    prof = write_profile(HEALTH_DIR, reference_profile(
        train.full_batch(), source=str(DATA_DIR)))
    npz, shifted = HEALTH_DIR / "valid.npz", HEALTH_DIR / "valid_3sd.npz"
    np.savez(npz, **valid.full_batch())
    sd = train.individual[train.mask].std(axis=0)
    np.savez(shifted, **dict(valid.full_batch(), individual=(
        valid.individual + 3 * sd).astype(np.float32)))
    ctl = HEALTH_DIR / "ctl"
    shutil.rmtree(ctl, ignore_errors=True)
    gate = ["--moment_tolerance", "1.0", "--drift_threshold", "0.25",
            "--reference_profile", str(prof), "--device", DEVICE]

    K.reset_launch_count()
    C.reset_launch_count()
    t0 = time.perf_counter()
    rc, res = _promote_cli(["promote", "--root", str(ctl), "--candidates",
                            *dirs, "--valid_npz", str(npz), *gate])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = panel_counts(K, C)
    check(rc == 0 and res["generation"] == 1,
          f"the nine members were not promoted: rc {rc}, {res}")
    # one diagnostics pass (sdf_ffn_fwd + cond_em_fwd) and the ensemble
    # metrics' weights (sdf_ffn_fwd), every launch at S = 9
    check(launches == (2, 0, 0, 1, 0, 0), f"the gate launched (fwd, bwd, "
          f"dx, cem_fwd, cem_bwd, cem_dx) {launches}, not (2, 0, 0, 1, 0, 0)")
    offline = float(ensemble_metrics(
        ens_cfg, ens_params, valid.to_batch(DEVICE),
        ExecutionConfig(device=DEVICE))["ensemble_sharpe"])
    d = abs(res["valid_sharpe"] - offline)
    check(d <= 1e-6, f"pointer valid Sharpe {res['valid_sharpe']} vs offline "
                     f"ensemble_metrics {offline} (|d| {d:.3e})")
    print(f"[promotion] 9 members (phase 7) promoted to generation 1 in "
          f"{wall:.2f} s (stack, digests, drift, one S=9 diagnostics pass, "
          f"ensemble metrics; bf16 kernel); launches (fwd, bwd, dx, cem_fwd, "
          f"cem_bwd, cem_dx) {launches}; valid Sharpe "
          f"{res['valid_sharpe']:.6f}, offline ensemble_metrics "
          f"{offline:.6f} (|d| {d:.1e}, bar 1e-6) "
          f"({card})", flush=True)

    rejected = {}
    nan_dir = members / "nan_member"
    nan_dir.mkdir()
    ens_cfg.save(nan_dir / "config.json")
    save_state_dict(nan_dir / "best_model_sharpe.pt", {
        k: v * float("nan") for k, v in member_state_dicts(ens_params)[0]
        .items()})
    torn_dir = members / "torn_member"
    shutil.copytree(dirs[0], torn_dir)
    torn = torn_dir / "best_model_sharpe.pt"
    with open(torn, "r+b") as f:
        f.truncate(torn.stat().st_size // 2)
    for slug, cands, panel in (
            ("moment_violation", dirs[:8] + [str(nan_dir)], npz),
            ("digest_mismatch", dirs[:8] + [str(torn_dir)], npz),
            ("data_drift", dirs, shifted)):
        t0 = time.perf_counter()
        rc, res = _promote_cli(["promote", "--root", str(ctl),
                                "--candidates", *cands, "--valid_npz",
                                str(panel), *gate])
        rejected[slug] = time.perf_counter() - t0
        check(rc == 1 and res["rejected"] == slug,
              f"expected a {slug} rejection, got rc {rc}: {res}")
    rc, res = _promote_cli(["promote", "--root", str(ctl), "--candidates",
                            *dirs[:3], "--valid_npz", str(npz),
                            "--sharpe_tolerance", "-1", *gate])
    check(rc == 0 and res["generation"] == 2, f"second promotion: {res}")
    rc, res = _promote_cli(["rollback", "--root", str(ctl), "--reason",
                            "chip smoke"])
    check(rc == 0 and res == {"generation": 3, "rolled_back_from": 2},
          f"rollback: {res}")
    rc, shown = _promote_cli(["show", "--root", str(ctl)])
    check(rc == 0 and shown["generation"] == 3
          and shown["checkpoint_dirs"] == dirs,
          "show after the rollback does not name the nine members")
    print("[promotion] rejected: " + ", ".join(
        f"{k} ({v:.2f} s)" for k, v in rejected.items())
        + "; generation 2 (3 members), rollback to generation 3 = the nine, "
          f"show: generation {shown['generation']} ({card})", flush=True)
    # the members and the pointer stay for the serving reload checks (4b)
    return dict(launches=launches, wall_s=wall, reject_s=rejected,
                dirs=dirs, ctl=ctl)


# -- phase 11 -----------------------------------------------------------------

# the paper's real panel shape (bench.py's): 240/60/300 months x 10,000
# stocks x 46 characteristics, 178 macro series; only the epochs are cut
REAL_PANEL = dict(n_periods_train=240, n_periods_valid=60, n_periods_test=300,
                  n_stocks=10_000, n_features=46, n_macro=178, seed=42)
REAL_DIR = ROOT / "_smoke_real"
CACHE_DIR = ROOT / "_smoke_cache"
REAL_EPOCHS = (2, 1, 2)
SMALL_SLAB = 4 << 20  # ~40 reuses of each slab on the train split's rows
SPLIT_NAMES = ("train", "valid", "test")


def _timed_put(torch, fn):
    """(batch, stats, ms to resident from CUDA events, host wall ms): the
    start event is recorded on the idle default stream, the end event after
    the call, which orders the default stream behind the copies."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    stats = {}
    t0 = time.perf_counter()
    a.record()
    out = fn(stats)
    b.record()
    b.synchronize()
    return out, stats, a.elapsed_time(b), (time.perf_counter() - t0) * 1e3


def _same_batch(torch, ref, got, what):
    check(set(ref) == set(got), f"{what}: keys {sorted(got)} != "
                                f"{sorted(ref)}")
    for k in ref:
        check(got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape
              and torch.equal(got[k], ref[k]),
              f"{what}: {k} differs from load_splits + to_batch")


def _same_dataset(ref, got, what):
    for f in ("returns", "individual", "mask", "macro", "dates",
              "mean_macro", "std_macro"):
        a, b = getattr(ref, f), getattr(got, f)
        check(np.array_equal(np.asarray(a), np.asarray(b)),
              f"{what}: dataset field {f} differs from load_splits")


def _spans(path, t0_mono):
    """{span: (start s, end s)} from an events.jsonl, relative to t0."""
    out = {}
    for line in Path(path).read_text().splitlines():
        r = json.loads(line)
        if r["kind"] == "span_end":
            end = r["mono"] - t0_mono
            out[r["name"]] = (end - r["duration_s"], end)
    return out


def codec_check(card):
    """The native codec built on this host, and its decode of the train
    split bit for bit the NumPy decode."""
    from deeplearninginassetpricing_paperreplication_torch.data import native
    from deeplearninginassetpricing_paperreplication_torch.data.panel import (
        _MISSING_THRESHOLD,
        numpy_decode,
    )

    t0 = time.perf_counter()
    check(native.native_available(), "the native panel codec did not build "
                                     "(g++ -fopenmp) on this host")
    build_s = time.perf_counter() - t0
    with np.load(REAL_DIR / "char" / "Char_train.npz") as f:
        data = f["data"]
    t0 = time.perf_counter()
    got = native.decode_panel(data, _MISSING_THRESHOLD)
    codec_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ref = numpy_decode(data)
    numpy_ms = (time.perf_counter() - t0) * 1e3
    check(got is not None, "the codec is built but decode_panel returned None")
    for name, a, b in zip(("returns", "individual", "mask"), got, ref):
        check(a.dtype == b.dtype and a.shape == b.shape
              and np.array_equal(a.view(np.uint8), b.view(np.uint8)),
              f"codec decode of the train split: {name} is not bit for bit "
              "the NumPy decode")
    lib = native._LIB
    print(f"[data codec] built/loaded in {build_s:.2f} s "
          f"({native.so_path().name}, {lib.panel_codec_num_threads()} OpenMP "
          f"threads); train split {data.shape}: codec {codec_ms:.1f} ms, "
          f"NumPy {numpy_ms:.1f} ms, bit for bit; coverage "
          f"{float(ref[2].mean()):.4f} ({card})", flush=True)
    return dict(codec_ms=codec_ms, numpy_ms=numpy_ms, build_s=build_s)


def transfer_routes(torch, card, ref_splits, ref_batches):
    """Every transfer route against load_splits + to_batch on the card, per
    split, with its bytes, host ms and ms to resident (CUDA events), each
    route called twice (first: pinning and the copy stream's first use)."""
    from deeplearninginassetpricing_paperreplication_torch.data import (
        pipeline as P,
    )
    from deeplearninginassetpricing_paperreplication_torch.data import (
        transfer as TR,
    )

    rows = {}
    routes = [
        ("put dense f32", False, lambda b, st: TR.device_put_batch(
            b, packed=False, device=DEVICE, stats=st)),
        ("put packed f32", False, lambda b, st: TR.device_put_batch(
            b, packed=True, device=DEVICE, stats=st)),
        ("put auto f32", False, lambda b, st: TR.device_put_batch(
            b, packed="auto", device=DEVICE, stats=st)),
        ("stream auto f32", False, lambda b, st: P.stream_batch(
            b, device=DEVICE, stats=st)),
        ("stream auto f32 4MiB", False, lambda b, st: P.stream_batch(
            b, device=DEVICE, chunk_bytes=SMALL_SLAB, stats=st)),
        ("stream dense f32 4MiB", False, lambda b, st: P.stream_batch(
            b, packed=False, device=DEVICE, chunk_bytes=SMALL_SLAB,
            stats=st)),
        ("put packed bf16", True, lambda b, st: TR.device_put_batch(
            b, packed=True, device=DEVICE, bf16_wire=True, stats=st)),
        ("stream auto bf16", True, lambda b, st: P.stream_batch(
            b, device=DEVICE, bf16_wire=True, stats=st)),
    ]
    for name, ds, ref in zip(SPLIT_NAMES, ref_splits, ref_batches):
        batch = ds.full_batch()
        ref_bf16 = dict(ref, individual=ref["individual"].to(
            torch.bfloat16).float())
        for label, bf16, fn in routes:
            times = []
            for call in range(2):
                out, st, ms, wall = _timed_put(torch,
                                               lambda s: fn(batch, s))
                _same_batch(torch, ref_bf16 if bf16 else ref, out,
                            f"{name} {label} (call {call + 1})")
                times.append((ms, st["host_ms"], wall))
                del out
            gbps = st["wire_bytes"] / (times[1][0] * 1e6)
            rows[(name, label)] = dict(
                wire_bytes=st["wire_bytes"], chunks=st["chunks"],
                packed=st["packed"], resident_ms=[t[0] for t in times],
                host_ms=[t[1] for t in times])
            print(f"[data route] {name} {label}: {st['wire_bytes']} B "
                  f"({st['chunks']} slabs, packed {st['packed']}); host "
                  f"{times[0][1]:.2f} / {times[1][1]:.2f} ms; resident "
                  f"{times[0][0]:.2f} / {times[1][0]:.2f} ms (calls 1 / 2); "
                  f"{gbps:.2f} GB/s; bit for bit ({card})", flush=True)
    return rows


def pipeline_checks(torch, card, ref_splits, ref_batches, seq_ms):
    """StartupPipeline cold (cache cleared), then warm: datasets and batches
    bit for bit load_splits + to_batch, the cache hits 0/3 then 3/3, every
    startup span, and the wall against the sequential load."""
    from deeplearninginassetpricing_paperreplication_torch.data import (
        diskcache,
    )
    from deeplearninginassetpricing_paperreplication_torch.data import (
        pipeline as P,
    )
    from deeplearninginassetpricing_paperreplication_torch.data.transfer \
        import sync_batch
    from deeplearninginassetpricing_paperreplication_torch.observability \
        .events import EventLog
    from deeplearninginassetpricing_paperreplication_torch.utils.config \
        import ExecutionConfig, GANConfig

    diskcache.clear()
    cfg = GANConfig(macro_feature_dim=REAL_PANEL["n_macro"],
                    individual_feature_dim=REAL_PANEL["n_features"])
    out = {}
    for label, hits in (("cold", 0), ("warm", 3)):
        run = REAL_DIR / f"events_{label}"
        ev = EventLog(run, process_index=0)
        torch.cuda.synchronize()
        t0, m0 = time.perf_counter(), time.monotonic()
        res = P.StartupPipeline(
            REAL_DIR, device=DEVICE, events=ev,
            compile_fn=P.trainer_precompile_fn(
                cfg, ExecutionConfig(device=DEVICE)),
        ).start().result()
        for b in res.batches:
            sync_batch(b)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        ev.close()
        check(sum(res.cache_hits.values()) == hits,
              f"pipeline {label}: cache hits {res.cache_hits}, want {hits}/3")
        for name, r_ds, g_ds, r_b, g_b in zip(SPLIT_NAMES, ref_splits,
                                              res.datasets, ref_batches,
                                              res.batches):
            _same_dataset(r_ds, g_ds, f"pipeline {label} {name}")
            _same_batch(torch, r_b, g_b, f"pipeline {label} {name}")
        spans = _spans(run / "events.jsonl", m0)
        out[label] = dict(wall_ms=wall, spans=spans, compiled=res.compiled)
        print(f"[data pipeline] {label}: wall {wall:.1f} ms against the "
              f"sequential load_splits + to_batch {seq_ms:.1f} ms; cache hits "
              f"{hits}/3; compiled {res.compiled}; bit for bit ({card})",
              flush=True)
        print(f"[data pipeline] {label} spans (start-end ms): " + ", ".join(
            f"{k} {a * 1e3:.1f}-{b * 1e3:.1f}" for k, (a, b)
            in sorted(spans.items(), key=lambda kv: kv[1][0])), flush=True)
        del res
    return out


def chunked_checks(card, ref_splits):
    """load_splits_chunked at the default shard width, cold then warm, a
    column span, then one truncated shard: it alone re-decodes, and every
    split stays bit for bit load_splits."""
    from deeplearninginassetpricing_paperreplication_torch.data import (
        diskcache,
    )
    from deeplearninginassetpricing_paperreplication_torch.data import (
        pipeline as P,
    )
    from deeplearninginassetpricing_paperreplication_torch.observability \
        .events import EventLog

    width = diskcache.DEFAULT_SHARD_WIDTH
    out = {}

    def run(label, **kw):
        path = REAL_DIR / f"events_chunked_{label}"
        ev = EventLog(path, process_index=0)
        t0 = time.perf_counter()
        got = P.load_splits_chunked(REAL_DIR, shard_width=width, events=ev,
                                    **kw)
        ms = (time.perf_counter() - t0) * 1e3
        ev.close()
        rows = [json.loads(x) for x in
                (path / "events.jsonl").read_text().splitlines()]
        cols = kw.get("columns")
        for name, r, g in zip(SPLIT_NAMES, ref_splits, got):
            if cols is not None:
                a, b = cols
                r = dataclasses.replace(
                    r, returns=r.returns[:, a:b],
                    individual=r.individual[:, a:b], mask=r.mask[:, a:b])
            _same_dataset(r, g, f"chunked {label} {name}")
        counters = {}
        for r in rows:
            if r["kind"] == "counter":
                counters[r["name"]] = counters.get(r["name"], 0) + r["value"]
        out[label] = dict(ms=ms, counters=counters)
        print(f"[data chunked] {label}: {ms:.1f} ms; counters {counters}; "
              f"bit for bit ({card})", flush=True)
        return counters

    c = run("cold")
    check(c.get("startup/shard_loaded", 0) == 0, "chunked cold run loaded "
                                                  "shards from a cache")
    c = run("warm")
    n_shards = len(diskcache.shard_bounds(REAL_PANEL["n_stocks"], width))
    check(c.get("startup/shard_loaded") == 3 * n_shards,
          f"chunked warm run loaded {c.get('startup/shard_loaded')} shards, "
          f"want {3 * n_shards}")
    c = run("span", columns=(width, 3 * width))
    check(c.get("startup/shard_loaded") == 3 * 2, "a two-shard column span "
                                                  "loaded other shards")
    char, macro = P.split_paths(REAL_DIR, "train")
    entry = diskcache.load_chunked(char, macro, width)
    torn = entry.shard_path(2, "individual")
    torn.write_bytes(torn.read_bytes()[: torn.stat().st_size // 2])
    c = run("torn")
    check(c.get("startup/shard_redecode") == 1,
          f"a torn shard: {c.get('startup/shard_redecode')} re-decodes, "
          "want 1")
    check(c.get("startup/shard_loaded") == 3 * n_shards - 1,
          "a torn shard: the other shards were not served from the cache")
    check(all(entry.verify_shard(i)[0] for i in range(entry.n_shards)),
          "the torn shard was not repaired in place")
    return out


def real_shape_cli(torch, K, C, card):
    """The train CLI at the real shape, epochs 2/1/2: the pipeline against
    --no_pipeline in f32 and in the default bf16 (whose pipeline ships the
    bf16 wire): history.npz and final_model.pt bit for bit. The default
    bf16 pipeline run is this path's main run: the training kernels'
    launches are counted there."""
    from deeplearninginassetpricing_paperreplication_torch import train
    from deeplearninginassetpricing_paperreplication_torch.utils.config \
        import ExecutionConfig, GANConfig

    runs, launches = {}, None
    for dtype in ("float32", "bfloat16"):
        for mode in ("pipeline", "no_pipeline"):
            save = REAL_DIR / f"run_{dtype}_{mode}"
            argv = ["--data_dir", str(REAL_DIR), "--save_dir", str(save),
                    "--epochs_unc", str(REAL_EPOCHS[0]), "--epochs_moment",
                    str(REAL_EPOCHS[1]), "--epochs", str(REAL_EPOCHS[2]),
                    "--ignore_epoch", "0", "--print_freq", "1",
                    "--device", DEVICE]
            if dtype == "float32":
                argv += ["--compute_dtype", "float32"]
            if mode == "no_pipeline":
                argv.append("--no_pipeline")
            main_run = dtype == "bfloat16" and mode == "pipeline"
            if main_run:
                K.reset_launch_count()
                C.reset_launch_count()
            t0 = time.perf_counter()
            train.main(argv)
            wall = time.perf_counter() - t0
            if main_run:
                launches = dict(zip(("sdf_ffn_fwd", "sdf_ffn_bwd",
                                     "cond_em_fwd", "cond_em_bwd"),
                                    counts(K, C)))
            metrics = json.loads((save / "final_metrics.json").read_text())
            runs[(dtype, mode)] = dict(save=save, wall_s=wall,
                                       metrics=metrics)
            startup = metrics["startup"]
            print(f"[data train] {dtype} {mode}: {wall:.1f} s; startup "
                  f"{startup}; wall ms per epoch at T = "
                  f"{REAL_PANEL['n_periods_train']}: "
                  + ", ".join(f"{k} {v:.2f}" for k, v in
                              metrics["epoch_ms"].items())
                  + f"; test Sharpe {metrics['test']['sharpe']:.6f} ({card})",
                  flush=True)
        pipe, seq = runs[(dtype, "pipeline")], runs[(dtype, "no_pipeline")]
        check(pipe["metrics"]["startup"]["pipeline"]
              and not seq["metrics"]["startup"]["pipeline"],
              "the train CLI's default load is not the pipeline")
        want = ExecutionConfig(device=DEVICE, compute_dtype=dtype
                               ).bf16_wire_ok(GANConfig(
                                   macro_feature_dim=REAL_PANEL["n_macro"],
                                   individual_feature_dim=REAL_PANEL[
                                       "n_features"]))
        check(want == (dtype == "bfloat16") or DEVICE != "cuda",
              f"{dtype}: bf16_wire_ok is {want} for the paper's model")
        check(pipe["metrics"]["startup"]["bf16_wire"] == want,
              f"{dtype}: the pipeline's wire is not what bf16_wire_ok says")
        a = np.load(pipe["save"] / "history.npz")
        b = np.load(seq["save"] / "history.npz")
        check(set(a.files) == set(b.files), "history.npz keys differ")
        for k in a.files:
            check(np.array_equal(a[k], b[k]), f"{dtype}: history.npz {k} "
                                              "differs between the pipeline "
                                              "and --no_pipeline")
        check((pipe["save"] / "final_model.pt").read_bytes()
              == (seq["save"] / "final_model.pt").read_bytes(),
              f"{dtype}: final_model.pt differs between the pipeline and "
              "--no_pipeline")
        print(f"[data train] {dtype}: history.npz and final_model.pt bit for "
              f"bit, pipeline against --no_pipeline", flush=True)
    for name, n in launches.items():
        check(n > 0, f"the real-shape train CLI launched {name} no time")
    print(f"[data train] launches, bf16 pipeline run: {launches}", flush=True)
    return launches, {f"{d} {m}": dict(wall_s=r["wall_s"],
                                      epoch_ms=r["metrics"]["epoch_ms"])
                      for (d, m), r in runs.items()}


def data_plane_phase(torch, K, C, card):
    """(11) The data plane at the paper's real panel shape."""
    from deeplearninginassetpricing_paperreplication_torch.data.panel import (
        load_splits,
    )
    from deeplearninginassetpricing_paperreplication_torch.data.synthetic \
        import generate_all_splits

    t_phase = time.perf_counter()
    shutil.rmtree(REAL_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    generate_all_splits(REAL_DIR, verbose=False, compress=False, **REAL_PANEL)
    nbytes = sum(p.stat().st_size for p in REAL_DIR.rglob("*.npz"))
    print(f"[data] real-shape panel F={REAL_PANEL['n_features']} "
          f"M={REAL_PANEL['n_macro']} N={REAL_PANEL['n_stocks']} months "
          f"{REAL_PANEL['n_periods_train']}/{REAL_PANEL['n_periods_valid']}/"
          f"{REAL_PANEL['n_periods_test']} seed {REAL_PANEL['seed']}, "
          f"uncompressed, {nbytes} B: {time.perf_counter() - t0:.1f} s",
          flush=True)
    codec = codec_check(card)
    # the reference: the sequential load, then a dense copy from pageable
    # memory
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref_splits = load_splits(REAL_DIR)
    load_ms = (time.perf_counter() - t0) * 1e3
    ref_batches, dense = [], []
    for ds in ref_splits:
        b, _, ms, wall = _timed_put(torch,
                                    lambda s, ds=ds: ds.to_batch(DEVICE))
        ref_batches.append(b)
        dense.append((ms, wall))
    seq_ms = load_ms + sum(w for _, w in dense)
    for name, ds, (ms, _) in zip(SPLIT_NAMES, ref_splits, dense):
        nbytes = sum(np.asarray(v).size * 4 for v in ds.full_batch().values())
        print(f"[data route] {name} to_batch dense f32 (pageable): {nbytes} B;"
              f" resident {ms:.2f} ms; {nbytes / (ms * 1e6):.2f} GB/s "
              f"({card})", flush=True)
    print(f"[data] sequential load_splits {load_ms:.1f} ms + to_batch "
          f"{sum(w for _, w in dense):.1f} ms", flush=True)
    routes = transfer_routes(torch, card, ref_splits, ref_batches)
    pipe = pipeline_checks(torch, card, ref_splits, ref_batches, seq_ms)
    del ref_batches
    torch.cuda.empty_cache()
    chunked = chunked_checks(card, ref_splits)
    del ref_splits
    launches, cli = real_shape_cli(torch, K, C, card)
    shutil.rmtree(REAL_DIR, ignore_errors=True)
    print(f"[data] phase 11 done in {time.perf_counter() - t_phase:.1f} s "
          f"({card})", flush=True)
    return dict(launches=launches, codec=codec, routes=routes,
                pipeline=pipe, chunked=chunked, cli=cli, load_ms=load_ms,
                dense=dense)


# ---------------------------------------------------------------------------
# 12. the trainer's operational plane
# ---------------------------------------------------------------------------

OPS_DIR = ROOT / "_smoke_ops"
OPS_CHECKPOINT_EVERY = 4
OPS_STOPS = (6, 14)  # inside phase 1 (8 epochs), inside phase 3 (after 12)
TRAIN_KERNELS = ("sdf_ffn_fwd", "sdf_ffn_bwd", "cond_em_fwd", "cond_em_bwd")


def _fault_plan(plan):
    """Point the port's fault injector at `plan` (None clears it)."""
    from deeplearninginassetpricing_paperreplication_torch.reliability import (
        faults,
    )

    if plan is None:
        os.environ.pop(faults.ENV_PLAN, None)
    else:
        os.environ[faults.ENV_PLAN] = json.dumps(plan)
    faults.reset_injector()


def _same_run(torch, a, b, what):
    """Two train_3phase results (final params, history, run dir) bit for
    bit: params, every history series, every .pt file's bytes."""
    pa, ha, da = a
    pb, hb, db = b
    check(list(pa) == list(pb) and all(torch.equal(pa[k], pb[k]) for k in pa),
          f"{what}: final params differ")
    check(set(ha) == set(hb) and all(np.array_equal(np.asarray(ha[k]),
                                                    np.asarray(hb[k]))
                                     for k in ha),
          f"{what}: history differs")
    pts = sorted(p.name for p in da.glob("*.pt"))
    check(pts and pts == sorted(p.name for p in db.glob("*.pt")),
          f"{what}: the .pt files differ")
    for name in pts:
        check((da / name).read_bytes() == (db / name).read_bytes(),
              f"{what}: {name} differs")


def ops_plane_runs(torch, K, C, card, splits):
    """(a) a transient NaN rolled back bit for bit, (b) a persistent one
    aborting, (c) stop and resume in f32 and bf16, then the walls of the
    guard (on and off in turns) and of one resume save. Returns the
    guarded run's launches (the path's count) and the walls."""
    from deeplearninginassetpricing_paperreplication_torch.reliability.guard \
        import DivergenceError
    from deeplearninginassetpricing_paperreplication_torch.training import (
        trainer as trainer_mod,
    )
    from deeplearninginassetpricing_paperreplication_torch.utils.config \
        import ExecutionConfig, GANConfig, TrainConfig

    train, valid, test = splits
    cfg = GANConfig(macro_feature_dim=train.macro_feature_dim,
                    individual_feature_dim=train.individual_feature_dim,
                    dropout=DROPOUT)
    tcfg = TrainConfig(**SCHEDULE, seed=42, print_freq=10 ** 6)
    batches = [ds.to_batch(DEVICE) for ds in (train, valid, test)]
    ce = OPS_CHECKPOINT_EVERY

    def run(name, dtype="float32", fresh=True, **kw):
        save = OPS_DIR / name
        if fresh:
            shutil.rmtree(save, ignore_errors=True)
        _, params, hist, trainer = trainer_mod.train_3phase(
            cfg, *batches, tcfg=tcfg, seed=42, verbose=False,
            save_dir=str(save), exec_cfg=ExecutionConfig(
                compute_dtype=dtype, device=DEVICE), **kw)
        torch.cuda.synchronize()
        return (params, hist, save), trainer

    def counted(name, **kw):
        K.reset_launch_count()
        C.reset_launch_count()
        out, trainer = run(name, **kw)
        return out, trainer, counts(K, C)

    # (a) a transient NaN: the guard rolls phase 1's second segment back
    clean, _, clean_n = counted("clean", checkpoint_every=ce,
                                divergence_guard=False)
    _fault_plan([{"site": "trainer/epoch_loop", "action": "nan_loss",
                  "trigger_count": 2}])
    try:
        guarded, tr, guarded_n = counted("guarded", checkpoint_every=ce)
    finally:
        _fault_plan(None)
    check(tr.divergence_trips == [(1, ce, 2 * ce)],
          f"divergence_trips {tr.divergence_trips} != [(1, {ce}, {2 * ce})]")
    _same_run(torch, clean, guarded, "a guarded run with a transient NaN vs "
                                     "an unguarded clean run")
    trips = np.load(guarded[2] / "history.npz")["divergence_trips"]
    check(trips.tolist() == [[1.0, ce, 2.0 * ce]],
          f"history.npz divergence_trips {trips.tolist()}")
    retried = tuple(ce * v for v in PER_EPOCH["unconditional"])
    want = tuple(a + r for a, r in zip(clean_n, retried))
    check(guarded_n == want, f"guarded launches {guarded_n} != the clean "
                             f"run's {clean_n} + the retried segment's "
                             f"{retried}")
    print(f"[ops] (a) transient NaN after phase 1 epochs [{ce}, {2 * ce}), "
          f"f32, checkpoint_every {ce}: trips {tr.divergence_trips}; "
          f"params, history and "
          f"{', '.join(sorted(p.name for p in guarded[2].glob('*.pt')))} bit "
          f"for bit the unguarded clean run; launches (fwd, bwd, cem_fwd, "
          f"cem_bwd) clean {clean_n}, guarded {guarded_n} = clean + the "
          f"retried segment's {retried} ({card})", flush=True)

    # (b) a persistent NaN: three consecutive trips abort before any .pt
    _fault_plan([{"site": "trainer/epoch_loop", "action": "nan_loss",
                  "trigger_count": n} for n in (1, 2, 3)])
    try:
        run("aborted", checkpoint_every=ce)
        fail("three consecutive trips did not raise DivergenceError")
    except DivergenceError as e:
        check("phase1_unconditional" in str(e),
              f"the DivergenceError names no phase1_unconditional: {e}")
        left = sorted(p.name for p in (OPS_DIR / "aborted").glob("*.pt*"))
        check(not left, f"the aborted run wrote {left}")
        print(f"[ops] (b) persistent NaN: DivergenceError ({e}); no .pt "
              "written", flush=True)
    finally:
        _fault_plan(None)

    # (c) stop and resume, f32 and bf16, each bit for bit an uninterrupted
    # whole-phase run; every resume save timed
    save_ms = []
    real_save = trainer_mod.Trainer._save_resume

    def timed_save(self, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_save(self, *a, **kw)
        save_ms.append((time.perf_counter() - t0) * 1e3)

    for dtype in ("float32", "bfloat16"):
        ref, _ = run(f"whole_{dtype}", dtype)
        if dtype == "float32":
            _same_run(torch, clean, ref, "a segmented run vs a whole one")
        trainer_mod.Trainer._save_resume = timed_save
        try:
            for stop in OPS_STOPS:
                name = f"stop{stop}_{dtype}"
                (_, _, save), tr = run(name, dtype, checkpoint_every=ce,
                                       stop_after_epochs=stop)
                meta = json.loads((save / "resume_meta.json").read_text())
                check(tr.stopped_midphase and meta["in_phase"] > 0,
                      f"{name}: no mid-phase stop")
                resumed, _ = run(name, dtype, fresh=False,
                                 checkpoint_every=ce, resume=True)
                _same_run(torch, ref, resumed, f"{name} resumed vs the "
                                               "uninterrupted run")
                left = sorted(p.name for p in save.glob("resume_*"))
                check(not left, f"{name}: resume files left: {left}")
                print(f"[ops] (c) {dtype} stop_after_epochs {stop} (mid-phase"
                      f" {meta['in_phase']} at epoch "
                      f"{meta['epochs_in_phase']}) + resume: bit for bit the "
                      "uninterrupted run; no resume file left", flush=True)
        finally:
            trainer_mod.Trainer._save_resume = real_save

    # walls: the guard on and off in turns (checkpoint_every 4, f32)
    walls = {False: [], True: []}
    for guard in (False, True, True, False):
        _, tr = run(f"wall_{int(guard)}", checkpoint_every=ce,
                    divergence_guard=guard)
        walls[guard].append(tr.epoch_ms())
    mean = {g: {k: statistics.mean(w[k] for w in ws) for k in ws[0]}
            for g, ws in walls.items()}
    # the guard's own work a segment: its rollback point, timed alone
    snap_ms = []
    for _ in range(21):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (tr.snapshot(), tr.opt_state(tr.opt_sdf), tr.opt_state(tr.opt_moment))
        torch.cuda.synchronize()
        snap_ms.append((time.perf_counter() - t0) * 1e3)
    fmt = lambda d: ", ".join(f"{k} {v:.2f}" for k, v in d.items())  # noqa: E731
    save_med = statistics.median(save_ms)
    print(f"[ops walls] wall ms per epoch, f32, checkpoint_every {ce}, two "
          f"runs each in turns: guard on {fmt(mean[True])}; guard off "
          f"{fmt(mean[False])} ({card})", flush=True)
    print(f"[ops walls] one guard snapshot (the live params and both "
          f"optimizers' moments copied on the card, synchronized): median "
          f"{statistics.median(snap_ms[1:]):.3f} ms of 20 ({card})",
          flush=True)
    print(f"[ops walls] one resume save (sync, state to the host, torch.save,"
          f" verified write of the state and its meta): median "
          f"{save_med:.2f} ms of {len(save_ms)}, range {min(save_ms):.2f}-"
          f"{max(save_ms):.2f} ({card})", flush=True)
    return guarded_n, dict(guard_on_epoch_ms=mean[True],
                           guard_off_epoch_ms=mean[False],
                           guard_snapshot_ms=statistics.median(snap_ms[1:]),
                           resume_save_ms=save_med)


def _read_port(proc, lines, found):
    """Collect a child's stdout lines; set `found` once the metrics
    sidecar's port is logged."""
    for line in proc.stdout:
        lines.append(line)
        if "metrics sidecar: http://127.0.0.1:" in line and not found:
            found.append(int(line.split("127.0.0.1:")[1].split("/")[0]))


def ops_cli_checks(torch, card):
    """(d) The train CLI in subprocesses, default bf16: --checkpoint_every
    --metrics_port 0 --profile (a scrape while it trains); a kill plan at
    the epoch loop, then --resume, bit for bit the first run."""
    import threading

    from deeplearninginassetpricing_paperreplication_torch.observability \
        .metrics import parse_prom_text

    base = [sys.executable, "-m", f"{PKG}.train", "--data_dir", str(DATA_DIR),
            "--epochs_unc", str(SCHEDULE["num_epochs_unc"]),
            "--epochs_moment", str(SCHEDULE["num_epochs_moment"]),
            "--epochs", str(SCHEDULE["num_epochs"]), "--ignore_epoch",
            str(SCHEDULE["ignore_epoch"]), "--print_freq", "8", "--device",
            DEVICE, "--checkpoint_every", str(OPS_CHECKPOINT_EVERY)]
    first, second, prof = (OPS_DIR / "cli", OPS_DIR / "cli_killed",
                           OPS_DIR / "trace")
    for d in (first, second, prof):
        shutil.rmtree(d, ignore_errors=True)
    env = {k: v for k, v in os.environ.items() if k != "DLAP_FAULT_PLAN"}

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        base + ["--save_dir", str(first), "--metrics_port", "0",
                "--profile", str(prof)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines, port = [], []
    reader = threading.Thread(target=_read_port, args=(proc, lines, port),
                              daemon=True)
    reader.start()
    scraped = None
    while proc.poll() is None and scraped is None:
        if port:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port[0]}/metrics",
                        timeout=2) as r:
                    prom = parse_prom_text(r.read().decode())
                n = sum(prom.get("dlap_epochs_dispatched_total", {})
                        .values())
                if n > 0:
                    scraped = n
            except (OSError, ValueError):
                pass
        time.sleep(0.005)
    rc = proc.wait(timeout=600)
    reader.join(timeout=10)
    wall = time.perf_counter() - t0
    check(rc == 0, f"train CLI exited {rc}:\n" + "".join(lines[-30:]))
    check(port, "the train CLI logged no metrics sidecar port")
    check(scraped is not None, "no /metrics scrape during training showed "
                               "epochs_dispatched")
    hb = json.loads((first / "heartbeat.json").read_text())
    check(hb["heartbeat"]["section"] == "finalize"
          and hb.get("device_memory", {}).get("n_devices", 0) >= 1
          and hb["device_memory"]["totals"].get("peak_bytes_in_use", 0) > 0,
          f"heartbeat.json lacks device_memory: {hb}")
    manifest = json.loads((first / "manifest.json").read_text())
    progs = manifest.get("kernel_programs") or {}
    check(all(any(k.startswith(n) for k in progs) for n in TRAIN_KERNELS),
          f"manifest.json kernel_programs {sorted(progs)} lack a training "
          "kernel")
    check(all(p["held"]["local_bytes"] == 0 for p in progs.values()),
          "a kernel program spills")
    rows = (first / "metrics.jsonl").read_text().splitlines()
    n_epochs = sum(SCHEDULE[k] for k in ("num_epochs_unc",
                                         "num_epochs_moment", "num_epochs"))
    check(len(rows) == n_epochs, f"metrics.jsonl has {len(rows)} rows, not "
                                 f"{n_epochs}")
    events = [json.loads(x) for x in
              (first / "events.jsonl").read_text().splitlines()]
    dispatched = sum(e["value"] for e in events
                     if e["name"] == "epochs_dispatched")
    check(dispatched == n_epochs, f"events.jsonl epochs_dispatched "
                                  f"{dispatched} != {n_epochs}")
    traces = [p for p in prof.rglob("*") if p.is_file()]
    text = "".join(p.read_text(errors="replace") for p in traces)
    check(traces and "sdf_ffn" in text and "cond_em" in text,
          "the --profile trace names no FFN or conditional-EM kernel")
    trace_mb = sum(p.stat().st_size for p in traces) / 1e6
    print(f"[ops cli] train CLI (bf16, --checkpoint_every "
          f"{OPS_CHECKPOINT_EVERY} --metrics_port 0 --profile): {wall:.1f} s;"
          f" /metrics scraped mid-run at port {port[0]}: epochs_dispatched "
          f"{scraped}; heartbeat.json finalize, peak_bytes_in_use "
          f"{hb['device_memory']['totals'].get('peak_bytes_in_use')}; "
          f"kernel_programs {sorted(progs)}; metrics.jsonl {len(rows)} rows;"
          f" trace {trace_mb:.1f} MB naming sdf_ffn and cond_em ({card})",
          flush=True)

    # a SIGKILL at the third segment (phase 2), then --resume
    plan = [{"site": "trainer/epoch_loop", "trigger_count": 3,
             "action": "kill"}]
    killed = subprocess.run(
        base + ["--save_dir", str(second)], cwd=ROOT,
        env=dict(env, DLAP_FAULT_PLAN=json.dumps(plan)),
        capture_output=True, text=True, timeout=600)
    check(killed.returncode == -9, f"the kill plan's run exited "
                                   f"{killed.returncode}, not by SIGKILL")
    meta = json.loads((second / "resume_meta.json").read_text())
    resumed = subprocess.run(base + ["--save_dir", str(second), "--resume"],
                             cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=600)
    check(resumed.returncode == 0, f"--resume exited {resumed.returncode}:\n"
          + resumed.stdout[-3000:] + resumed.stderr[-3000:])
    a, b = np.load(first / "history.npz"), np.load(second / "history.npz")
    check(set(a.files) == set(b.files)
          and all(np.array_equal(a[k], b[k]) for k in a.files),
          "history.npz of the killed-and-resumed CLI run differs")
    check((first / "final_model.pt").read_bytes()
          == (second / "final_model.pt").read_bytes(),
          "final_model.pt of the killed-and-resumed CLI run differs")
    rows = (second / "metrics.jsonl").read_text().splitlines()
    check(len(rows) == n_epochs and not list(second.glob("resume_*")),
          f"the resumed run dir: {len(rows)} metrics rows, resume files "
          f"{sorted(p.name for p in second.glob('resume_*'))}")
    print(f"[ops cli] kill plan at trainer/epoch_loop #3: rc -9 (after "
          f"phase {meta['completed_phase']}, in_phase {meta['in_phase']}); "
          f"--resume: history.npz and final_model.pt bit for bit the "
          f"uninterrupted CLI run; metrics.jsonl {len(rows)} rows ({card})",
          flush=True)


def ops_plane_phase(torch, K, C, card, splits):
    """(12) The trainer's operational plane at phase 6's full width and
    panel; returns the guarded run's launches by kernel."""
    t0 = time.perf_counter()
    shutil.rmtree(OPS_DIR, ignore_errors=True)
    try:
        launches, walls = ops_plane_runs(torch, K, C, card, splits)
        ops_cli_checks(torch, card)
    finally:
        _fault_plan(None)
        shutil.rmtree(OPS_DIR, ignore_errors=True)
    for name, n in zip(TRAIN_KERNELS, launches):
        check(n > 0, f"the operational plane's run launched {name} no time")
    print(f"[ops] phase 12 done in {time.perf_counter() - t0:.1f} s ({card})",
          flush=True)
    return dict(launches=dict(zip(TRAIN_KERNELS, launches)), walls=walls)


# ---------------------------------------------------------------------------
# 13. the supervisor and the elastic sweep
# ---------------------------------------------------------------------------

ELASTIC_DIR = ROOT / "_smoke_elastic"
# the supervised train CLI: phase 12's arguments; a hung child is killed
# after this many seconds without a heartbeat (a healthy one beats at its
# start and at every segment of 4 epochs)
SUP_TIMEOUT = 30.0
SUP_FLAGS = ["--poll", "0.25", "--backoff", "0.5", "--jitter", "0",
             "--min_uptime", "1"]
# the fleet: two workers, leases of a few seconds, a bucket attempt budget
# that outlasts three kills landing on one bucket
FLEET_FLAGS = ["--workers", "2", "--lease_timeout", "5",
               "--worker_heartbeat_timeout", "120", "--worker_min_uptime",
               "1", "--worker_backoff", "0.5", "--worker_max_restarts", "8",
               "--retry_backoff", "0.5"]
FLEET_KILLS = [
    {"site": "sweep/claim", "action": "kill", "trigger_count": 1},
    {"site": "sweep/bucket", "action": "kill", "trigger_count": 2},
    {"site": "sweep/ledger_write", "action": "kill", "trigger_count": 2},
]


def _launch_rows(path):
    """The launch counts the processes that exited normally appended to
    `path` (``ops.ENV_LAUNCH_COUNTS``): one row each."""
    if not path.exists():
        return []
    return [json.loads(x) for x in path.read_text().splitlines()]


def _sum_launches(rows):
    return {k: sum(r[k] for r in rows) for k in TRAIN_KERNELS}


def _events(run_dir, pattern="events*.jsonl"):
    rows = []
    for p in sorted(Path(run_dir).glob(pattern)):
        for line in p.read_text().splitlines():
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                pass  # a SIGKILLed writer's torn last row
    return rows


def _count(rows, name):
    return sum(int(r.get("value", 1)) for r in rows
               if r.get("kind") == "counter" and r.get("name") == name)


def _same_cli_run(a, b, what):
    ha, hb = np.load(a / "history.npz"), np.load(b / "history.npz")
    check(set(ha.files) == set(hb.files)
          and all(np.array_equal(ha[k], hb[k]) for k in ha.files),
          f"{what}: history.npz differs from the clean run's")
    check((a / "final_model.pt").read_bytes()
          == (b / "final_model.pt").read_bytes(),
          f"{what}: final_model.pt differs from the clean run's")


def supervised_train_checks(torch, card):
    """(a) a kill at the third segment and (b) a hang at phase 1's boundary
    (f32 and bf16), each under ``supervise``; the five train CLI processes
    (two clean, three supervised) run side by side. Returns the supervised
    children's launches (the ``supervised_train`` path) and the walls."""
    from deeplearninginassetpricing_paperreplication_torch.ops import (
        ENV_LAUNCH_COUNTS,
    )

    train = [sys.executable, "-m", f"{PKG}.train", "--data_dir",
             str(DATA_DIR), "--epochs_unc", str(SCHEDULE["num_epochs_unc"]),
             "--epochs_moment", str(SCHEDULE["num_epochs_moment"]),
             "--epochs", str(SCHEDULE["num_epochs"]), "--ignore_epoch",
             str(SCHEDULE["ignore_epoch"]), "--print_freq", "8", "--device",
             DEVICE, "--checkpoint_every", str(OPS_CHECKPOINT_EVERY)]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DLAP_FAULT_")}
    hang = [{"site": "trainer/phase_boundary", "trigger_count": 1,
             "action": "hang"}]
    runs = {
        "clean_bfloat16": (None, "bfloat16"),
        "clean_float32": (None, "float32"),
        "kill_bfloat16": ([{"site": "trainer/epoch_loop", "trigger_count": 3,
                            "action": "kill"}], "bfloat16"),
        "hang_float32": (hang, "float32"),
        "hang_bfloat16": (hang, "bfloat16"),
    }
    procs, t0 = {}, time.perf_counter()
    for name, (plan, dtype) in runs.items():
        save = ELASTIC_DIR / name
        cmd = train + ["--compute_dtype", dtype, "--save_dir", str(save)]
        e = dict(env, **{ENV_LAUNCH_COUNTS: str(ELASTIC_DIR
                                                / f"launches.{name}.jsonl")})
        if plan is not None:
            e["DLAP_FAULT_PLAN"] = json.dumps(plan)
            cmd = [sys.executable, "-m", f"{PKG}.supervise", "--run_dir",
                   str(save), "--timeout", str(SUP_TIMEOUT)] + SUP_FLAGS + [
                "--"] + cmd
        with open(ELASTIC_DIR / f"{name}.log", "w") as log:
            procs[name] = subprocess.Popen(cmd, cwd=ROOT, env=e, stdout=log,
                                           stderr=subprocess.STDOUT)
    walls = {}
    while len(walls) < len(procs) and time.perf_counter() - t0 < 600:
        for name, proc in procs.items():
            if name not in walls and proc.poll() is not None:
                walls[name] = time.perf_counter() - t0
        time.sleep(0.05)
    outs = {}
    for name, proc in procs.items():
        if proc.poll() is None:
            # SIGTERM first: a supervisor then kills its child's group
            proc.terminate()
            try:
                proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        outs[name] = (ELASTIC_DIR / f"{name}.log").read_text()
        check(proc.returncode == 0, f"{name} exited {proc.returncode}:\n"
                                    + outs[name][-3000:])
    summaries = {}
    for name, (plan, dtype) in runs.items():
        save = ELASTIC_DIR / name
        if plan is None:
            continue
        summary = json.loads(outs[name].strip().splitlines()[-1])
        summaries[name] = summary
        _same_cli_run(ELASTIC_DIR / f"clean_{dtype}", save,
                      f"supervised {name}")
        rows = _events(save, "events.supervisor.jsonl")
        children = [r for r in rows if r.get("kind") == "span_begin"
                    and r.get("name") == "supervise/child"]
        check(summary["outcome"] == "success" and summary["restarts"] == 1
              and _count(rows, "supervise/restart") == 1
              and [(c["attempt"], c["resumed"]) for c in children]
              == [(1, False), (2, True)],
              f"{name}: {summary}; children {children}")
        argv = json.loads((save / "manifest.json").read_text())["argv"]
        check("--resume" in argv, f"{name}: the restart ran {argv}")
        death = summary["deaths"][0]
        if plan[0]["action"] == "kill":
            check(death["rc"] == -9 and not death["hang"],
                  f"{name}: death {death}")
        else:
            check(death["hang"] and death["rc"] == -9
                  and summary["hang_kills"] == 1
                  and death["section"] == "phase1_unconditional",
                  f"{name}: the hang was not SIGKILLed and attributed to "
                  f"phase1_unconditional: {death}")
        faults = _events(save, "events.faults.jsonl")
        check(len(faults) == 1, f"{name}: fault rows {faults}")
        check(not list(save.glob("resume_*")), f"{name}: resume files left")
        print(f"[elastic train] {name}: {plan[0]['action']} at "
              f"{plan[0]['site']} #{plan[0]['trigger_count']}; death in "
              f"{death['section']} (rc {death['rc']}, hang {death['hang']}, "
              f"after {death['uptime_s']} s), restarts {summary['restarts']},"
              f" the restart with --resume; history.npz and final_model.pt "
              f"bit for bit clean_{dtype}; {walls[name]:.1f} s ({card})",
              flush=True)
    rows = [r for name in summaries
            for r in _launch_rows(ELASTIC_DIR / f"launches.{name}.jsonl")]
    check(len(rows) == len(summaries), f"launch rows {rows}: not one per "
                                       "supervised run's restarted child")
    launches = _sum_launches(rows)
    for name, n in launches.items():
        check(n > 0, f"the supervised train CLI launched {name} no time")
    print(f"[elastic train] launches of the restarted children (the "
          f"processes that exited normally; the killed first children's "
          f"are lost with them): {launches}; walls "
          + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items())
          + f" ({card})", flush=True)
    return launches, dict(walls=walls, restarts={
        k: v["restarts"] for k, v in summaries.items()})


def _ranking_rows(ranked):
    return [(r["config"].to_dict(), r["lr"], r["seed"], r["valid_sharpe"])
            for r in ranked]


def elastic_sweep_checks(torch, card, splits, ref_ranked):
    """(c) the fleet over phase 9's covering grid with the three kills,
    (d) the poison bucket, each through the sweep CLI's coordinator
    (``_prepare_queue``, ``_elastic_search``) and ``--worker``
    subprocesses. Returns the surviving workers' launches (the
    ``elastic_sweep`` path) and the walls."""
    from deeplearninginassetpricing_paperreplication_torch import (
        sweep as cli,
    )
    from deeplearninginassetpricing_paperreplication_torch.observability \
        .events import EventLog
    from deeplearninginassetpricing_paperreplication_torch.observability \
        .heartbeat import Heartbeat
    from deeplearninginassetpricing_paperreplication_torch.observability \
        .logging import RunLogger
    from deeplearninginassetpricing_paperreplication_torch.ops import (
        ENV_LAUNCH_COUNTS,
    )
    from deeplearninginassetpricing_paperreplication_torch.utils.config \
        import ExecutionConfig, GANConfig, TrainConfig

    train = splits[0]
    base = GANConfig(macro_feature_dim=train.macro_feature_dim,
                     individual_feature_dim=train.individual_feature_dim)
    cfgs = [dataclasses.replace(base, hidden_dim=h, num_units_rnn=r,
                                num_condition_moment=k, dropout=d)
            for h, r, k, d in SWEEP_BUCKETS]
    configs = [(c, lr) for c in cfgs for lr in SWEEP_LRS]
    tcfg = TrainConfig(**SCHEDULE, seed=SWEEP_SEED, print_freq=10 ** 6)
    exec_cfg = ExecutionConfig(compute_dtype="float32", device=DEVICE)
    ref_dir = ELASTIC_DIR / "phase9"
    ref_bytes = cli.write_ranking(ref_dir, ref_ranked).read_bytes()

    def fleet(name, plan, attempts):
        save = ELASTIC_DIR / name
        args = cli.build_arg_parser().parse_args(
            ["--data_dir", str(DATA_DIR), "--save_dir", str(save),
             "--search_seeds", str(SWEEP_SEED), "--device", DEVICE,
             "--compute_dtype", "float32", "--max_bucket_attempts",
             str(attempts)] + FLEET_FLAGS)
        events = EventLog(save)
        hb = Heartbeat(save / "heartbeat.json", events=events)
        logger = RunLogger(events=events)
        os.environ[ENV_LAUNCH_COUNTS] = str(save / "launches.jsonl")
        _fault_plan(plan)
        t0 = time.perf_counter()
        try:
            _, queue = cli._prepare_queue(args, configs, tcfg, save, events,
                                          logger, False, exec_cfg)
            ranked, coverage, summaries = cli._elastic_search(
                args, queue, save, events, hb, logger)
            cli.write_ranking(save, ranked, coverage)
        finally:
            os.environ.pop(ENV_LAUNCH_COUNTS, None)
            _fault_plan(None)
            events.close()
        wall = time.perf_counter() - t0
        recs = {r["key"]: r for r in
                (json.loads(p.read_text()) for p in
                 (save / "sweep_ledger" / "records").glob("*.json"))}
        items = queue.items()
        bucket_walls = [recs[it["key"]]["seconds"] if it["key"] in recs
                        else None for it in items]
        restarts = {w: s["restarts"] for w, s in summaries.items()}
        return save, ranked, coverage, recs, items, dict(
            wall=wall, bucket_walls=bucket_walls, restarts=restarts)

    # (c) three kills, counted fleet-wide
    save, ranked, coverage, recs, items, c_walls = fleet("fleet",
                                                         FLEET_KILLS, 6)
    check((save / "sweep_ranking.json").read_bytes() == ref_bytes,
          "the supervised 2-worker sweep's ranking differs from phase 9's "
          "in-process ranking")
    faults = _events(save, "events.faults.jsonl")
    check(sorted((r["site"], r["action"]) for r in faults)
          == sorted((p["site"], p["action"]) for p in FLEET_KILLS),
          f"fired faults {faults}")
    rows = _events(save)
    check(coverage["complete"] and len(recs) == len(cfgs)
          and _count(rows, "sweep/ledger_write") == len(cfgs),
          f"coverage {coverage}; {len(recs)} records; ledger writes "
          f"{_count(rows, 'sweep/ledger_write')} (a completed bucket "
          "retrained?)")
    check(all(r["worker"] in ("w0", "w1") and r["execution"] == {
        "compute_dtype": "float32", "kernel": "auto"} for r in recs.values()),
        f"records' workers {[r['worker'] for r in recs.values()]}")
    restarts = _count(rows, "supervise/restart")
    check(restarts == len(FLEET_KILLS), f"{restarts} restarts for "
                                        f"{len(FLEET_KILLS)} kills")
    programs = {}
    for wid in ("w0", "w1"):
        m = json.loads((save / f"manifest.{wid}.json").read_text())
        progs = m.get("kernel_programs") or {}
        check(m["device"].startswith("cuda")
              and m["execution"]["kernel"] == "auto"
              and m.get("kernel_route") == "cuda"
              and all(p["held"]["local_bytes"] == 0 for p in progs.values()),
              f"{wid}'s manifest: device {m['device']}, execution "
              f"{m['execution']}, route {m.get('kernel_route')}, programs "
              f"{sorted(progs)}")
        programs[wid] = sorted(progs)
    planned = {r["name"].split("/")[0] for r in rows
               if r.get("kind") == "program"}
    check(planned == {f"bucket{i + 1}" for i in range(len(cfgs))}
          and any(programs.values()),
          f"buckets with kernel plans in the workers' events: {planned}; "
          f"manifests {programs}")
    launch_rows = _launch_rows(save / "launches.jsonl")
    c_launches = _sum_launches(launch_rows)
    print(f"[elastic sweep] (c) supervised --workers 2 over phase 9's "
          f"{len(cfgs)} buckets x {len(SWEEP_LRS)} lrs (f32, 8/4/16), kills "
          f"at sweep/claim #1, sweep/bucket #2, sweep/ledger_write #2: "
          f"ranking byte-identical to phase 9's in-process ranking; "
          f"{len(recs)} records, {_count(rows, 'sweep/ledger_write')} ledger"
          f" writes (none retrained), workers "
          f"{sorted(r['worker'] for r in recs.values())}; restarts "
          f"{c_walls['restarts']}, takeovers "
          f"{_count(rows, 'sweep/lease_takeover')}; wall "
          f"{c_walls['wall']:.1f} s; bucket walls s "
          f"{c_walls['bucket_walls']}; worker kernel plans "
          f"{ {w: len(p) for w, p in programs.items()} }; launches of the "
          f"{len(launch_rows)} workers that exited normally {c_launches} "
          f"({card})", flush=True)

    # (d) the poison bucket: B2 raises at every claim
    poison = items[1]["key"]
    save, ranked, coverage, recs, _, d_walls = fleet(
        "poison", [{"site": "sweep/bucket", "action": "raise",
                    "match": poison, "persistent": True}], 2)
    check(not coverage["complete"] and coverage["coverage"] == 0.75
          and [q["key"] for q in coverage["quarantined"]] == [poison]
          and coverage["quarantined"][0]["attempts"] == 2
          and coverage["missing"] == [],
          f"poison coverage {coverage}")
    saved = json.loads((save / "sweep_coverage.json").read_text())
    check(saved == coverage, "sweep_coverage.json differs")
    ref_rows = [r for r in _ranking_rows(ref_ranked)
                if r[0] != cfgs[1].to_dict()]
    check(_ranking_rows(ranked) == ref_rows,
          "the degraded ranking's entries differ from phase 9's")
    check(json.loads((save / "sweep_ranking.json").read_text())
          == [dict(r, rank=i) for i, r in enumerate(
              r for r in json.loads(ref_bytes)
              if r["config"] != cfgs[1].to_dict())],
          "the degraded sweep_ranking.json differs from phase 9's rows")
    d_launches = _sum_launches(_launch_rows(save / "launches.jsonl"))
    print(f"[elastic sweep] (d) poison B2 (persistent raise at "
          f"sweep/bucket), --max_bucket_attempts 2: quarantined after "
          f"{coverage['quarantined'][0]['attempts']} attempts, coverage "
          f"{coverage['coverage']}, the other {len(recs)} buckets' entries "
          f"bit for bit phase 9's; restarts {d_walls['restarts']}; wall "
          f"{d_walls['wall']:.1f} s; bucket walls s "
          f"{d_walls['bucket_walls']}; launches {d_launches} ({card})",
          flush=True)
    launches = {k: c_launches[k] + d_launches[k] for k in TRAIN_KERNELS}
    for name, n in launches.items():
        check(n > 0, f"the elastic sweep launched {name} no time")
    return launches, dict(fleet=c_walls, poison=d_walls)


def elastic_phase(torch, card, splits, ref_ranked):
    """(13) The supervisor and the elastic sweep on phase 6's panel;
    returns the two paths' launches by kernel."""
    t0 = time.perf_counter()
    shutil.rmtree(ELASTIC_DIR, ignore_errors=True)
    ELASTIC_DIR.mkdir(parents=True)
    # the children import the package from this checkout, wherever the
    # fleet's supervisors start them
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    try:
        train_launches, train_walls = supervised_train_checks(torch, card)
        sweep_launches, sweep_walls = elastic_sweep_checks(
            torch, card, splits, ref_ranked)
    finally:
        _fault_plan(None)
        shutil.rmtree(ELASTIC_DIR, ignore_errors=True)
    print(f"[elastic] phase 13 done in {time.perf_counter() - t0:.1f} s; "
          f"restarts: train {train_walls['restarts']}, fleet "
          f"{sweep_walls['fleet']['restarts']}, poison "
          f"{sweep_walls['poison']['restarts']} ({card})", flush=True)
    return dict(supervised_train=train_launches,
                elastic_sweep=sweep_launches)


def elastic_reference(torch, splits):
    """Phase 9's in-process ranking of the covering grid (f32, kernel on,
    a scratch ledger), for ``--only_elastic``."""
    from deeplearninginassetpricing_paperreplication_torch.parallel import (
        sweep as sw,
    )
    from deeplearninginassetpricing_paperreplication_torch.reliability \
        .ledger import SweepLedger
    from deeplearninginassetpricing_paperreplication_torch.utils.config \
        import ExecutionConfig, GANConfig, TrainConfig

    train, valid, _ = splits
    base = GANConfig(macro_feature_dim=train.macro_feature_dim,
                     individual_feature_dim=train.individual_feature_dim)
    configs = [(dataclasses.replace(base, hidden_dim=h, num_units_rnn=r,
                                    num_condition_moment=k, dropout=d), lr)
               for h, r, k, d in SWEEP_BUCKETS for lr in SWEEP_LRS]
    t0 = time.perf_counter()
    ranked = sw.run_sweep(
        configs, [SWEEP_SEED], *(ds.to_batch(DEVICE) for ds in (train, valid)),
        tcfg=TrainConfig(**SCHEDULE, seed=SWEEP_SEED, print_freq=10 ** 6),
        top_k=None, verbose=False, exec_cfg=ExecutionConfig(
            kernel="on", compute_dtype="float32", device=DEVICE),
        ledger=SweepLedger(SWEEP_DIR / "sweep_ledger"))
    shutil.rmtree(SWEEP_DIR, ignore_errors=True)
    print(f"[elastic] phase 9's in-process ranking of the covering grid: "
          f"{len(ranked)} points in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return ranked


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile the serving engine, training and "
                         "ensemble-training epochs and the panel gradient "
                         "with torch.profiler")
    ap.add_argument("--only_bwd", action="store_true",
                    help="build the FFN backward's and panel cotangent's "
                         "libraries only and run the backward's checks and "
                         "the panel cotangent at the sweep widths (a short "
                         "call while the backward changes); no result line")
    ap.add_argument("--only_dx", action="store_true",
                    help="build the FFN panel cotangent's libraries only and "
                         "run its plans and checks (a short call while "
                         "sdf_ffn_dx.cu changes); no result line")
    ap.add_argument("--compare_dx", metavar="DIR", default=None,
                    help="with --only_dx: hold the f32 sdf_ffn_dx bit for "
                         "bit against DIR/sdf_ffn_bwd.cu's, an older source "
                         "beside its sdf_ffn_common.cuh, and time both in "
                         "turns")
    ap.add_argument("--only_fwd", action="store_true",
                    help="build the FFN forward's libraries only and run "
                         "their checks (a short call while the forward "
                         "changes); no result line")
    ap.add_argument("--compare_fwd", metavar="DIR", default=None,
                    help="with --only_fwd: hold the f32 forward bit for bit "
                         "against DIR/sdf_ffn.cu, an older source beside "
                         "its sdf_ffn_common.cuh")
    ap.add_argument("--only_cem", action="store_true",
                    help="build the conditional-EM library only and run its "
                         "plans, checks and timings (a short call while "
                         "cond_em.cu changes); no result line")
    ap.add_argument("--compare_cem", metavar="DIR", default=None,
                    help="with --only_cem: hold the f32 cond_em_fwd and "
                         "cond_em_bwd bit for bit against DIR/cond_em.cu, "
                         "an older source, and time both in turns")
    ap.add_argument("--only_ceiling", action="store_true",
                    help="build the matmul ceiling's library only and run "
                         "its checks and the roofline path's measurement (a "
                         "short call while microbench.cu changes); no result "
                         "line")
    ap.add_argument("--only_serve", action="store_true",
                    help="build the FFN forward's libraries only and run "
                         "phase 4 and phase 4b, the latter on nine "
                         "stand-in members (seeded random weights of the "
                         "paper architecture) and a pointer naming them (a "
                         "short call while the serving path changes); no "
                         "result line")
    ap.add_argument("--compare_ceiling", metavar="DIR", default=None,
                    help="with --only_ceiling: hold the ceiling bit for bit "
                         "against DIR/microbench.cu's on integer operands "
                         "and time both in turns at the JAX defaults")
    ap.add_argument("--only_data", action="store_true",
                    help="build the training kernels' libraries only and run "
                         "phase 11, the data plane at the real panel shape "
                         "(a short call while the data plane changes); no "
                         "result line")
    ap.add_argument("--only_ops", action="store_true",
                    help="build the training kernels' libraries only and run "
                         "phase 12, the trainer's operational plane on "
                         "phase 6's panel (a short call while the guard, "
                         "resume or the train CLI's telemetry change); no "
                         "result line")
    ap.add_argument("--only_elastic", action="store_true",
                    help="build the training kernels' libraries only and run "
                         "phase 13, the supervisor and the elastic sweep on "
                         "phase 6's panel, against a fresh in-process run of "
                         "phase 9's grid (a short call while the supervisor, "
                         "the work queue or the sweep CLI change); no result "
                         "line")
    opts = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a CUDA "
             "card")
    # the panel cache of every phase lives in the checkout, and goes with it
    os.environ["DLAP_PANEL_CACHE_DIR"] = str(CACHE_DIR)
    try:
        return run_phases(opts, torch)
    finally:
        shutil.rmtree(CACHE_DIR, ignore_errors=True)
        shutil.rmtree(REAL_DIR, ignore_errors=True)


def run_phases(opts, torch) -> int:

    if not (ROOT / PKG).is_dir() or not (ROOT / "ref_runs").is_dir():
        fail(f"{PKG}/ and ref_runs/ must sit beside this script (run it "
             "from a checkout of the repository)")
    sys.path.insert(0, str(ROOT))
    # the plain references are full f32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from deeplearninginassetpricing_paperreplication_torch.evaluate_ensemble \
        import evaluate_ensemble
    from deeplearninginassetpricing_paperreplication_torch.ops import _nvcc
    from deeplearninginassetpricing_paperreplication_torch.ops import (
        cond_em as C,
    )
    from deeplearninginassetpricing_paperreplication_torch.ops import (
        microbench as MB,
    )
    from deeplearninginassetpricing_paperreplication_torch.ops import (
        sdf_ffn as K,
    )
    from deeplearninginassetpricing_paperreplication_torch.utils.config \
        import ExecutionConfig
    from deeplearninginassetpricing_paperreplication_torch.data import native

    # the panel codec builds on this host in this run (phase 11 checks it)
    shutil.rmtree(native.BUILD_DIR, ignore_errors=True)
    t_start = time.perf_counter()
    # 1. card
    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.device_count()} device(s); {kind}", flush=True)

    # 2. build: every library, all nvcc processes started together
    t0 = time.perf_counter()
    jobs = (K.build_jobs([64], kernels=("fwd", "bwd")) + C.build_jobs()
            if opts.only_data or opts.only_ops or opts.only_elastic
            else K.build_jobs(kernels=("bwd", "dx")) if opts.only_bwd
            else K.build_jobs(kernels=("dx",)) if opts.only_dx
            else K.build_jobs(kernels=("fwd",))
            if opts.only_fwd or opts.only_serve
            else C.build_jobs() if opts.only_cem
            else MB.build_jobs() if opts.only_ceiling
            else K.build_jobs() + C.build_jobs() + MB.build_jobs())
    logs = _nvcc.run(jobs, verbose=True)
    print(f"[build] {len(logs)} libraries ({', '.join(sorted(logs))}) built "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in sorted(logs):
        for line in logs[name].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {name}: {line.strip()}", flush=True)

    (cem_job,), (mb_job,) = C.build_jobs(), MB.build_jobs()
    sass_hmma(K, _nvcc, ("dx",) if opts.only_bwd or opts.only_dx
              else ("fwd",) if opts.only_fwd or opts.only_serve
              else () if (opts.only_cem or opts.only_ceiling
                          or opts.only_data or opts.only_ops
                          or opts.only_elastic)
              else ("fwd", "dx"),
              [(cem_job, "HMMA")] if opts.only_cem
              else [(mb_job, "HGMMA")] if opts.only_ceiling
              else [] if (opts.only_bwd or opts.only_dx or opts.only_fwd
                          or opts.only_serve or opts.only_data
                          or opts.only_ops or opts.only_elastic)
              else [(cem_job, "HMMA"), (mb_job, "HGMMA")])

    if opts.only_data:
        # the data plane alone: phase 11 on the training kernels' libraries
        data_plane_phase(torch, K, C, card)
        return 0

    if opts.only_ops:
        # the trainer's operational plane alone: phase 12 on phase 6's panel
        try:
            ops_plane_phase(torch, K, C, card, make_panel())
        finally:
            shutil.rmtree(DATA_DIR, ignore_errors=True)
        return 0

    if opts.only_elastic:
        # the supervisor and the elastic sweep alone: phase 13 on phase 6's
        # panel, held against a fresh in-process run of phase 9's grid
        try:
            splits = make_panel()
            elastic_phase(torch, card, splits,
                          elastic_reference(torch, splits))
        finally:
            shutil.rmtree(DATA_DIR, ignore_errors=True)
        return 0

    if opts.only_dx:
        # the panel cotangent's libraries alone: its plans, every check and
        # timing, and (with --compare_dx) the f32 route against an older
        # source
        t0 = time.perf_counter()
        dx_plan_lines(torch, K, card)
        dx_checks(torch, K, C, card, names=("sdf_ffn_dx",))
        if opts.compare_dx:
            compare_dx(torch, K, _nvcc, opts.compare_dx, card)
        print(f"[kernels] panel-cotangent checks passed in "
              f"{time.perf_counter() - t0:.1f} s ({card})", flush=True)
        return 0

    if opts.only_cem:
        # the conditional-EM library alone: its plans, every check and
        # timing, the panel cotangent, and (with --compare_cem) the f32
        # kernels against an older source
        t0 = time.perf_counter()
        cem_plan_lines(torch, C, card)
        cond_em_checks(torch, C, card)
        dx_checks(torch, K, C, card, names=("cond_em_dx",))
        if opts.compare_cem:
            compare_cem(torch, C, _nvcc, opts.compare_cem, card)
        print(f"[kernels] conditional-EM checks passed in "
              f"{time.perf_counter() - t0:.1f} s ({card})", flush=True)
        return 0

    if opts.only_ceiling:
        # the matmul ceiling's library alone: its plans, checks and the
        # roofline path's measurement, and (with --compare_ceiling) the
        # kernel against an older source
        t0 = time.perf_counter()
        ceiling_checks(torch, MB, card)
        if opts.compare_ceiling:
            compare_ceiling(torch, MB, _nvcc, opts.compare_ceiling, card)
        print(f"[kernels] matmul-ceiling checks passed in "
              f"{time.perf_counter() - t0:.1f} s ({card})", flush=True)
        return 0

    if opts.only_fwd:
        # the forward's libraries alone: its plans, every forward check,
        # and (with --compare_fwd) the f32 route against an older source
        t0 = time.perf_counter()
        fwd_plan_lines(torch, K, card)
        kernel_checks(torch, K, card)
        dropout_keep_share(torch, K, card)
        if opts.compare_fwd:
            compare_fwd(torch, K, _nvcc, opts.compare_fwd, card)
        print(f"[kernels] forward checks passed in "
              f"{time.perf_counter() - t0:.1f} s ({card})", flush=True)
        return 0

    if opts.only_bwd:
        # the backward's libraries alone: sdf_ffn_bwd at every check shape
        # and sweep width, sdf_ffn_dx at the sweep widths
        t0 = time.perf_counter()
        ffn_bwd_checks(torch, K, card)
        for h in WIDE_HIDDEN:
            ffn_bwd_checks(torch, K, card, h, WIDE_SHAPES)
        wide_checks(torch, K, card, "dx")
        print(f"[kernels] backward checks passed in "
              f"{time.perf_counter() - t0:.1f} s ({card})", flush=True)
        return 0

    if opts.only_serve:
        # the serving phases alone: 4, then 4b on stand-in members
        t0 = time.perf_counter()
        splits = make_panel()
        serving_phase(torch, K, card, splits[2], opts.profile)
        print(f"[serve] phase 4 done in {time.perf_counter() - t0:.1f} s "
              f"({card})", flush=True)
        reload_checks(torch, card, splits, *stand_in_members(torch))
        shutil.rmtree(HEALTH_DIR, ignore_errors=True)
        shutil.rmtree(DATA_DIR, ignore_errors=True)
        print(f"[serve] serving checks passed in "
              f"{time.perf_counter() - t0:.1f} s ({card})", flush=True)
        return 0

    # 3. kernels against their plain versions
    t0 = time.perf_counter()
    fwd_plan_lines(torch, K, card)
    dx_plan_lines(torch, K, card)
    row = kernel_checks(torch, K, card)
    _, ens_fwd_row = dropout_keep_share(torch, K, card)
    bwd_rows = ffn_bwd_checks(torch, K, card)
    bwd_row, ens_bwd_row = (bwd_rows[r + ("float32", DROPOUT)]
                            for r in (BWD_ROW, ENS_BWD_ROW))
    wide_bwd = {str(list(h)): {f"S={k[0]}": r for k, r in ffn_bwd_checks(
        torch, K, card, h, WIDE_SHAPES).items()
        if k[3:] == ("float32", DROPOUT)} for h in WIDE_HIDDEN}
    cem_plan_lines(torch, C, card)
    cem_rows = cond_em_checks(torch, C, card)
    dx_rows = dx_checks(torch, K, C, card)
    ceiling_row = ceiling_checks(torch, MB, card)
    shape_ceiling = ceiling_row["model_shape_ceiling_tflops"]
    print(f"[kernels] all checks passed in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # 4. serving
    t0 = time.perf_counter()
    splits = make_panel()
    test = splits[2]
    serve_launches = serving_phase(torch, K, card, test, opts.profile)
    print(f"[serve] phase 4 done in {time.perf_counter() - t0:.1f} s "
          f"({card})", flush=True)

    # 5. offline ensemble
    res = evaluate_ensemble([str(ROOT / d) for d in REF_RUNS], str(DATA_DIR),
                            exec_cfg=ExecutionConfig(device=DEVICE),
                            verbose=False)
    check(np.isfinite(res["test_sharpe"]), "non-finite ensemble Sharpe")
    print(f"[ensemble] 3-member test Sharpe (negated, ddof 0, bf16 kernel): "
          f"{res['test_sharpe']:.6f}; train {res['train_sharpe']:.6f} valid "
          f"{res['valid_sharpe']:.6f}; members "
          f"{[round(s, 6) for s in res['individual_sharpes']]}", flush=True)

    # 6. training
    t0 = time.perf_counter()
    train_launches, single_epoch_ms, single = train_checks(
        torch, K, C, card, splits, opts)
    roofline_lines("train", splits, single_epoch_ms, 1, shape_ceiling, card)
    wide_launches = wide_train_check(torch, K, C, card, splits)
    cli_check(torch, card)
    print(f"[train] phase done in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # 7. ensemble training
    t0 = time.perf_counter()
    ens_launches, ens_members, ens_epoch_ms, ens_params = ensemble_checks(
        torch, K, C, card, splits, single_epoch_ms, opts)
    roofline_lines("ensemble train", splits, ens_epoch_ms, ens_members,
                   shape_ceiling, card)
    ensemble_cli_check(torch, card)
    print(f"[ensemble train] phase done in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # 8. panel gradients
    t0 = time.perf_counter()
    grad_launches = panel_gradient_checks(torch, K, C, card, splits,
                                          ens_params, opts)
    print(f"[panel grad] phase done in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # 9. sweep
    t0 = time.perf_counter()
    sweep_rows = sweep_kernel_checks(torch, K, C, card)
    sweep_launches, sweep_ranked = sweep_checks(torch, K, C, card, splits)
    sweep_cli_check(torch, card)
    print(f"[sweep] phase done in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # 10. model health and promotion
    t0 = time.perf_counter()
    ens_cfg = single["cfg"]  # phase 7 trains phase 6's configuration
    diag_rows = diag_pass_checks(torch, K, C, card, splits, [
        ("phase 6 model", single["cfg"],
         {k: v[None] for k, v in single["params"].items()}),
        ("phase 7 members", ens_cfg, ens_params)])
    diag_train = diag_train_check(torch, K, C, card, splits, single)
    gate = promotion_checks(torch, K, C, card, splits, ens_cfg, ens_params)
    print(f"[health] phase done in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # 4b. hot reload of the serving path on phase 7's members and phase
    # 10's pointer
    reload_checks(torch, card, splits, gate["dirs"], gate["ctl"])
    shutil.rmtree(HEALTH_DIR, ignore_errors=True)

    # 12. the trainer's operational plane on phase 6's panel
    ops = ops_plane_phase(torch, K, C, card, splits)

    # 13. the supervisor and the elastic sweep on phase 6's panel, held
    # against phase 9's in-process ranking
    elastic = elastic_phase(torch, card, splits, sweep_ranked)
    shutil.rmtree(DATA_DIR, ignore_errors=True)

    # 11. the data plane at the real panel shape
    data = data_plane_phase(torch, K, C, card)

    src = f"{PKG}/ops/csrc/"
    tpu = "deeplearninginassetpricing_paperreplication_tpu/ops/"
    health_idx = {"sdf_ffn_fwd": 0, "sdf_ffn_bwd": 1, "cond_em_fwd": 3,
                  "cond_em_bwd": 4}

    def by_path(name, serving=0):
        paths = {"training": train_launches[name],
                 "training_hidden_128x128": wide_launches[name],
                 "ensemble_training": ens_launches[name],
                 "sweep": sweep_launches[name],
                 f"training_diag_stride_{DIAG_STRIDE}": diag_train[
                     "launches"][health_idx[name]]}
        if serving:
            paths = {"serving": serving, **paths}
        if grad_launches[name]:
            paths["panel_gradient"] = grad_launches[name]
        if gate["launches"][health_idx[name]]:
            paths["promotion_gate"] = gate["launches"][health_idx[name]]
        paths["data_plane_train_real_shape"] = data["launches"][name]
        paths["trainer_ops_plane"] = ops["launches"][name]
        # counted in the supervised train CLI's restarted children and the
        # elastic workers that exited normally (ops.ENV_LAUNCH_COUNTS)
        paths["supervised_train"] = elastic["supervised_train"][name]
        paths["elastic_sweep"] = elastic["elastic_sweep"][name]
        return dict(launches=sum(paths.values()), launches_by_path=paths,
                    ensemble_members=ens_members,
                    at_sweep_shapes=sweep_rows[name])

    def grad_path(name):
        n = grad_launches[name]
        extra = {f"at_{cd}_dropout": dx_rows[(name, cd, "dropout")]
                 for cd in ("float32", "bfloat16")
                 if (name, cd, "dropout") in dx_rows}
        return dict(launches=n, launches_by_path={"panel_gradient": n},
                    **dx_rows[(name, "float32")],
                    at_bfloat16=dx_rows[(name, "bfloat16")], **extra,
                    library_ms=None)  # no single PyTorch call computes it

    kernels = [
        dict(name="sdf_ffn_fwd", route="cuda", source=src + "sdf_ffn.cu",
             replaces=tpu + "pallas_ffn.py:561",
             also_replaces=tpu + "pallas_ffn.py:188",
             **by_path("sdf_ffn_fwd", serve_launches), **row,
             at_ensemble_shape=ens_fwd_row, diagnostics_pass=diag_rows),
        dict(name="sdf_ffn_bwd", route="cuda", source=src + "sdf_ffn_bwd.cu",
             replaces=tpu + "pallas_ffn.py:205",
             also_replaces=tpu + "pallas_ffn.py:591",
             **by_path("sdf_ffn_bwd"), **bwd_row,
             at_ensemble_shape=ens_bwd_row, at_sweep_widths=wide_bwd),
        dict(name="cond_em_fwd", route="cuda", source=src + "cond_em.cu",
             replaces=tpu + "pallas_moment.py:64",
             also_replaces=tpu + "pallas_moment.py:274",
             **by_path("cond_em_fwd"), **cem_rows["fwd"],
             at_ensemble_shape=cem_rows["ensemble_fwd"],
             diagnostics_pass=diag_rows),
        dict(name="cond_em_bwd", route="cuda", source=src + "cond_em.cu",
             replaces=tpu + "pallas_moment.py:86",
             also_replaces=tpu + "pallas_moment.py:302",
             **by_path("cond_em_bwd"), **cem_rows["bwd"],
             at_ensemble_shape=cem_rows["ensemble_bwd"]),
    ]
    for k in kernels:
        k["library_ms"] = None  # no single PyTorch call computes these
    kernels += [
        dict(name="sdf_ffn_dx", route="cuda", source=src + "sdf_ffn_dx.cu",
             replaces=tpu + "pallas_ffn.py:300", **grad_path("sdf_ffn_dx")),
        dict(name="cond_em_dx", route="cuda", source=src + "cond_em.cu",
             replaces=tpu + "pallas_moment.py:134",
             **grad_path("cond_em_dx")),
        dict(name="matmul_ceiling", route="cuda",
             source=src + "microbench.cu",
             replaces=tpu + "microbench.py:35",
             launches=ceiling_row["launches_by_path"]["roofline"],
             **ceiling_row),
    ]
    for k in kernels:
        for path, n in k["launches_by_path"].items():
            check(n > 0, f"the {path} path launched {k['name']} no time")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
