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
                                      # also: the f32 sdf_ffn_dx and
                                      # sdf_ffn_bwd at offset 0 bit for bit
                                      # against DIR/sdf_ffn_dx.cu's and
                                      # sdf_ffn_bwd.cu's (this tree's
                                      # argument lists, the dropout offset
                                      # included)
    python3 chip_smoke.py --only_fwd  # the FFN forward's libraries and
                                      # checks only (no result line)
    python3 chip_smoke.py --only_fwd --compare_fwd DIR
                                      # also: the f32 forward at offset 0
                                      # bit for bit against DIR/sdf_ffn.cu
                                      # (this tree's argument list, the
                                      # dropout offset included)
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
    python3 chip_smoke.py --only_refit
                                      # the training kernels' libraries
                                      # and phase 14 alone (no result
                                      # line; no report of phases 11 and
                                      # 12's run dirs)
    python3 chip_smoke.py --only_fleet
                                      # the FFN forward's libraries, phase
                                      # 4 at f32 (the answers), then phase
                                      # 15 on stand-in members (no result
                                      # line)
    python3 chip_smoke.py --only_joint
                                      # the training kernels' libraries,
                                      # their checks at phase 16's shapes,
                                      # then phase 16 with the figures on
                                      # stand-in members (no result line)
    python3 chip_smoke.py --only_shard
                                      # the FFN and conditional-EM
                                      # libraries, then phase 17 alone (no
                                      # result line)
    python3 chip_smoke.py --only_mesh
                                      # the training kernels' libraries,
                                      # then phase 18 alone (no result
                                      # line)
    python3 chip_smoke.py --only_multihost
                                      # the training kernels' libraries,
                                      # then phase 19 alone (no result
                                      # line)
    python3 chip_smoke.py --only_bf16panel
                                      # the w64 FFN and conditional-EM
                                      # libraries, then phase 20 alone (no
                                      # result line)
    python3 chip_smoke.py --only_shapes
                                      # the streamed, w64 FFN and
                                      # conditional-EM libraries, then
                                      # phase 21 alone (no result line)
    python3 chip_smoke.py --only_shapes --compare_stream DIR
                                      # also: the streamed route's CUDA-core
                                      # instances bit for bit against
                                      # DIR/sdf_ffn_stream.cu (this tree's
                                      # argument lists), both timed in turns

Phases, each printing its results; any failure exits non-zero:

1. Card: ``nvidia-smi`` name and power limit.
2. Build: every kernel of the port from this checkout's sources (``nvcc``,
   sm_90a, one process per library, all started together): the SDF-FFN
   forward, backward and panel cotangent for each width bound, the
   conditional-EM (forward, backward, panel cotangent; one library per
   panel dtype), and the matmul
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
   timed by CUDA-graph replays and at every stock tile; its bf16 route at
   every such shape also through the C2 audit build (the same source under
   ``-DSDF_FFN_DX_AUDIT``): the top-layer decisions it certified, the
   sign flips of the mma sums against the exact chains (none may lie
   outside the certified window), the largest |mma - chain| / bound (below
   the window's 2^-16, printed against the assumed 2^-19), and the audit
   build's dx bit for bit the main library's; and off the main
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
14. Rolling refit and the run report, after phase 11, on phase 6's panel
   (run dirs in ``_smoke_refit/``, removed after): the four training
   kernels against their plain versions at the refit's shapes (S = 1 at
   T = 24 and 36, the gate's S = 2 at T = 12) and their launch plans as
   the card holds them; (a) the refit CLI in this process over months 24,
   36 and 48 × seeds 1 and 2 (the paper's model, f32, 8/4/16, ignore 2,
   the gate with a moment tolerance): every month recorded with its
   members' sha256s, the gate in month order, the launches exactly six
   members' and three gated months'; then ``--resume-from-ledger``: no
   training launch (only the gate again on a rejected month), no member
   file rewritten, the pointer's generation kept; (b) month 24 with
   ``--kernel off``: each seed's history within the training bars; (c) a
   supervised ``--workers 2`` fleet with kills at ``sweep/claim`` #2 and
   ``sweep/bucket`` #3: three records, two restarts, every month's
   ``.pt`` files and ``history.npz`` byte-identical to (a)'s and the same
   gate outcome; (d) the report CLI: ``--json`` on (c)'s run dir, the text
   report's startup, training, model-health and kernel-plans sections on
   the run dirs phases 11 and 12 kept (``_smoke_report_runs/``), one
   Chrome trace of the fleet with a lane for each worker and supervisor,
   and ``--budget`` passing with a run-scoped spec and failing when it
   asks for a fourth month. Launches: ``rolling_refit`` (a) and
   ``rolling_refit_fleet`` (the workers that exit normally and the
   coordinator's gate).
15. The serving fleet under load (``_smoke_fleet/``, removed after): the
   paper-width ``ref_runs`` trio (f32, stock buckets of the test panel's
   requests, batch buckets 1 and 4, cache off) served by the serving
   CLI's supervised replicas on one ``SO_REUSEPORT`` port, booted from a
   promotion pointer. A 2-replica fleet: the parent holds no CUDA
   context, each replica one; (a) every test month at c = 1 over raw-f32
   and base64 bit for bit phase 4's batch-1 answers, and 32 concurrent
   clients within the f32 bar of the offline weights; (b) closed loops
   at c = 32 (raw-f32, base64) and c = 4 (JSON), an open-loop raw-f32
   ladder and the c = 32 raw-f32 loop on one replica, errors all zero,
   per replica no capture after warmup, replays and launches counted;
   (c) a replica SIGKILLed under open-loop load with retries: every
   request answered, one restart, the new incarnation capturing in its
   warmup only; (d) a ``RollingUpdater`` onto phase 4b's reload target
   (generation 2 of the pointer, stand-in members of the same
   architecture) under load: nothing dropped, both replicas on the
   pointer's fingerprint; (f) the prober and the burn-rate engine on the
   drill spec: a SIGKILLed and a SIGSTOPped replica each fire the
   availability alert and it resolves; ``ops status`` and ``report
   --json`` (its SLO section) on the fleet's run dir; a
   ``/v1/debug/profile`` capture on an admin port naming sdf_ffn_fwd on
   the device lane. A 1-replica fleet with ``--autoscale --max_replicas
   2``: (e) ``bench_loadadapt``'s swing, a scale-up and a scale-down, no
   interactive request dropped, bulk shed with 429s. Launches
   (``serving_fleet``): the live replicas' at each fleet's end.

16. The joint trainers, the JAX run dirs and the figures, on phase 6's
   panel (``_smoke_joint/``, removed after): first ``sdf_ffn_fwd`` and
   ``sdf_ffn_bwd`` against their plain versions at SimpleSDF's hidden (32,
   16), S = 1 (the w32 library); (a) ``joint_train`` of the paper's model
   (24 epochs, plateau patience 3, seed 42): f32 dropout 0 on the kernel
   route against ``kernel="off"``, every epoch losses rel 1e-3 and Sharpes
   abs 5e-3; the ``lr`` traces equal, unless the epoch where the routes'
   plateau decisions first part has a margin |metric - best·(1 + 1e-4)|
   below 5e-3 of |metric|: that epoch and its margin are printed and the
   histories compared through it; launches 24 × (2, 1, 2, 1); then dropout
   0.05 on the kernel route, f32 twice bit for bit and bf16, all finite,
   with the epoch ms of each route; (b) ``train_simple_sdf`` (input [macro
   178, individual 46], hidden (32, 16), 24 epochs): dropout 0 kernel
   against plain, the first epoch at the same bars and every epoch within
   max(the bars, 4 × the largest deviation of four plain runs whose first
   or output layer's initial weights move by ±2^-23: the baseline's
   trajectory is chaotic), launches 24 × (3, 1), dropout 0.1 twice bit for bit; (c) ``tests/fixtures/jax_run_{msgpack,pt}`` (the JAX
   package's run dir of the paper-width model and its ``.pt`` twin): the
   same ``state_dict`` bit for bit and bit-for-bit ``evaluate_ensemble``
   metrics; (d) ``summary_statistics`` on phase 7's nine members saved as
   run dirs (one ``sdf_ffn_fwd`` launch at S = 9) against
   ``evaluate_ensemble``'s test Sharpe, |d| <= 1e-6; the plots CLI exits
   non-zero naming matplotlib where it is missing, and writes the seven
   figures where it is there. Launches: ``joint_training``,
   ``simple_sdf_training``, ``plots_summary``.

17. Stock-sharded training on phase 6's panel (``_smoke_shard/``, removed
   after), the paper's model, f32, dropout 0.05, 8/4/16, ignore 2, seed
   42: (d) first the FFN kernels' dropout at stock offsets 5,000 and 2^31
   (a rank's span start): the forward's and the panel cotangent's masks
   of both layers read out whole (unit j's mask as member j's output, as
   dx's feature j) and the backward's at 64 stocks of the span (member s's
   dzp with g on stock n_s only), each bit for bit ``dropout_keep`` at
   that offset, at BWD_SHAPES' (T, N) and seeds; then the three kernels
   against their plain versions at that offset (hidden (64, 64), F = 46),
   each unlike its output at offset 0; (a) the train CLI with
   ``--shard_stocks`` and no process group (the kernel route):
   ``history.npz`` and the three checkpoints' tensors bit for bit the same
   CLI without the flag; (b) ``torch.distributed.run --nproc_per_node 2``
   of the train CLI with ``--shard_stocks`` on the one card (gloo, the
   kernel route): each rank launches the training kernels exactly phase
   6's ``PER_EPOCH`` counts (plus its final evals and health pass), plans
   them at N = 5,000, the two ranks end with bit-for-bit equal parameters,
   and every epoch is within the training bars (loss rel 1e-3, Sharpe abs
   5e-3) of (a)'s unsharded run; (c) the same two ranks with ``--kernel
   off``, held to (a) by the same bars and launching nothing. The wall ms
   per epoch at world sizes 1 and 2. Launches (``sharded_training``): the
   two ranks' of (b).

18. The mesh path on phase 6's panel (``_smoke_mesh/``, removed after):
   first the four training kernels at a grid position's span (S = 2, B1
   and B2's widths) and the forward at the serving spans against their
   plain versions (``at_mesh_shapes``); then, counts from 0, (a) B1 and B2
   of phase 9's grid (f32, 8/4/16, seed 42): ``run_sweep`` with a
   one-device grid mesh ranks bit for bit as no mesh; each bucket through
   ``train_bucket(grid_mesh=…)`` over two positions (two spans of card 0,
   or cards 0 and 1) is bit for bit ``member_chunk=2`` and within the
   sweep bars of the mesh-off bucket, every launch at S = 2, each
   position's launches a bucket's; the sweep CLI ``--device_slices N
   --slice_width 1`` in process and with ``--workers`` (1, or 2 on four
   cards) rank byte for byte alike, the slice leases released; (b) the
   ``ref_runs`` trio, f32, stock buckets 64…16,384, every test month:
   ``mesh="stocks=1"`` bit for bit the default engine, a stock-span engine
   (stocks=2 on card 0, or stocks=4 over four cards) and a
   members=3,stocks=2 engine within 1e-6 of it and within the f32 bar of
   offline ``ensemble_metrics``, no capture after warmup, graph replays bit
   for bit the eager route, a hot reload onto stand-in members and back,
   ``infer()`` ms of each; (c) ``serve --replicas 2 --mesh stocks=-1
   --mesh_slices N`` (N cards): ``fleet.json``'s mesh keys, every month
   through the shared port against (b), a SIGKILL under load with no
   request lost; (d) ``bench_meshserve`` at a small load. Launches
   (``mesh``): this process's over (a)–(d) and the fleet survivor's
   forwards.

19. Multi-process training and sequence parallelism (``_smoke_multihost/``,
   removed after): first the four training kernels at the path's shapes
   against their plain versions (``at_multihost_shapes``: S = 1, f32,
   dropout 0, K = 8; the worker CLI's T = 6, N = 8, F = 5, hidden (4,), and
   a rank's T = 48, N = 10,000 and 5,000, F = 46, hidden (64, 64)); then
   worlds of rank processes on a TCP store (``spawn_world``: gloo ranks
   sharing card 0, or NCCL with a card each where the host has as many),
   each rank one conditional ``train_step`` of its mesh row's member with
   the row's stock sums all-reduced over the row: (a) the worker CLI at
   the JAX shapes, two ranks, mesh [2, 1]: the ranks' gathered losses
   equal and each member's bit for bit its one-process step on the card;
   (b) the worker at the paper width (F = 46, M = 178, hidden (64, 64),
   LSTM (4,), K = 8, T = 48, N = 10,000, f32, dropout 0): [2, 1] bit for
   bit the one-process step; four ranks on two granules (``GROUP_RANK``
   0, 0, 1, 1), mesh [2, 2], every rank planning its kernels at N = 5,000
   and holding the same losses, within rtol 2e-4 of [2, 1]; [2, 1] with
   ``--kernel off`` within the loss bar 1e-3, launching nothing; each
   rank's launches of rows 1, 3, 6, 7 (one each on the kernel route) and
   each world's wall; (c) ``sequence_sharded_lstm`` (I = 178, H = 4) over
   four time positions (spans of card 0, or one card each on four) at T =
   600 (atol 1e-6) and 16,384 (atol 1e-5) against the one-device
   ``lstm_scan``, both timed; a ragged T raises. Launches (``multihost``):
   the kernel-route ranks' of (a) and (b).

20. The bf16 feature-major panel (``ExecutionConfig.bf16_panel``, the
   default on the kernel route) on phase 6's panel: (a) each of the six
   panel kernels (hidden (64, 64), F = 46, K = 8, T = 48) on a bf16 panel
   bit for bit the same kernel on ``x.bfloat16().float()`` (a bf16 dx bit
   for bit that call's f32 dx rounded once) and against its plain version
   on the bf16 panel at phase 3's bars (a bf16 dx also within one bf16
   ulp), at S = 1 and 9, N = 10,000, 10,003 and a 2,500-stock span at
   offset 5,000, f32 and bf16 compute, dropout 0 and 0.05 (the FFN's); at
   N = 10,000 one call timed on the bf16 and on the f32 panel, each beside
   its bound; (b) phase 6's model (seed 42, dropout 0.05, 8/4/16) under the
   default ``ExecutionConfig`` (bf16 compute, bf16 panel; its launches are
   the ``bf16panel_training`` path, every one on the bf16 panel) bit for
   bit ``bf16_panel=False`` (histories, selected epochs, final params),
   with each run's epoch walls and peak allocated memory; f32 compute on
   the bf16 panel, the kernel route against the plain route fed the same
   panel, at the training bars; (c) the nine seeds (S = 9), bf16 compute,
   the bf16 panel bit for bit the f32 panel, and ``ensemble_metrics`` on a
   training-prepared (bf16-panel) batch bit for bit the f32 batch's; (d)
   the conditional panel gradient of (c)'s members through the bf16 panel
   (the ``bf16panel_gradient`` path: one call launches rows 1, 4, 6, 7, 8
   once each on the bf16 panel), kernel against the plain route on the
   same panel at 2e-2·max|ref|.

21. The kernel route's shape range, on phase 6's panel written anew: (a)
   the three FFN kernels at stacks the resident kernels cannot hold (the
   streamed route: CUDA cores, routes 2 f32 / 3 bf16, and under bf16
   compute each kernel's tensor-core form, route 4, up to 4 layers) and
   the conditional EM past 16 moments, against their plain versions;
   the streamed forward and backward bit for bit each other (kout = e_j,
   g one-hot); the plans with their tiles in global scratch at (1536,);
   under f32 compute each kernel's register-tiled form, route 5, bit for
   bit route 2 and in turns with it; the panel cotangent's route 4 through
   its audit build (0
   top-layer decisions flipped outside the certified window) and beside
   route 3 on a forced plan; timed rows at (256, 256), T = 48, N = 10,000,
   and route 3 against route 4 in turns; (b) the train
   CLI at ``--hidden_dim 256 256 --num_moments 32``, f32 and bf16 compute,
   kernel route against ``--kernel off``; (c) its S = 9 panel gradient;
   (d) a served (256, 256) trio.

Then one ``kernels`` JSON line, the card line again, and the result line
``{"ok": true, "device": {...}}`` last.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
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
    the row of the shape the main path serves most (S=3, T=4, N=16384,
    bf16), with its f32 twin (the fleet's) under ``at_float32``."""
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(0)
    F, hidden = 46, [64, 64]

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    rows = {}
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
                    if (S, T, N) == (3, 4, 16384):
                        rows[cd] = dict(
                            max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by,
                            shape=f"S=3 T=4 N=16384 F={F} hidden={hidden} "
                                  f"{cd}")
    wide_checks(torch, K, card, "fwd")
    # the bf16 serving shape is the row; the fleet's f32 one rides beside
    return dict(rows["bfloat16"], at_float32=rows["float32"])


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


def _older_ffn_libs(K, _nvcc, src_dir, jobs):
    """{(kernel, width): (library, ctypes function)} of the FFN kernels
    built from another checkout's sources (src_dir holds
    sdf_ffn{,_bwd,_dx}.cu beside sdf_ffn_common.cuh, with this tree's entry
    argument lists: the dropout stock offset included), bound as this tree
    binds its own, one nvcc each, all started together."""
    import ctypes

    src = Path(src_dir).resolve()
    names = {"fwd": "sdf_ffn.cu", "bwd": "sdf_ffn_bwd.cu",
             "dx": "sdf_ffn_dx.cu"}
    _nvcc.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for kernel, width in jobs:
        out = _nvcc.BUILD_DIR / f"libsdf_ffn_{kernel}_older_w{width}.so"
        procs[(kernel, width)] = (out, subprocess.Popen(
            [_nvcc.nvcc(), *_nvcc.NVCC_FLAGS, f"-DSDF_FFN_MAXW={width}",
             "-o", str(out), str(src / names[kernel])]))
    libs = {}
    for (kernel, width), (out, proc) in procs.items():
        check(proc.wait() == 0, f"the older {src.name}/{names[kernel]} "
              f"(w{width}) did not build")
        lib = ctypes.CDLL(str(out))
        fn = getattr(lib, f"sdf_ffn_{kernel}")
        fn.argtypes = K._ARGTYPES[kernel]
        fn.restype = ctypes.c_int
        libs[(kernel, width)] = (lib, fn)
    return libs


def compare_fwd(torch, K, _nvcc, src_dir, card):
    """The f32 forward at offset 0 against an older source's
    (src_dir/sdf_ffn.cu, this tree's argument list) at the training
    shapes, dropout 0 and 0.05, on the same launch plan: bit for bit
    equal, and the two timed in turns (old, new, new, old)."""
    _, old = _older_ffn_libs(K, _nvcc, src_dir, [("fwd", 64)])[("fwd", 64)]
    new = K._load("fwd", 64).sdf_ffn_fwd
    dev = torch.device(DEVICE)
    (T, N), F, H = KEEP_SHAPE, 46, 64
    x = torch.randn(T, F, N, device=dev)
    for S in (1, 9):
        g = torch.Generator(device=dev).manual_seed(3)
        zp1, k1T, mids, kout, bout = _ffn_params(torch, g, S, F, [H, H], dev)
        zp = zp1.expand(S, T, H).contiguous()
        seed = 5 if S == 1 else list(range(5, 5 + S))
        packed = K.pack_ffn(k1T, mids, kout, bout, "float32")
        plan = K.card_fwd_plan(packed.layout, dev, S, T, N, "float32")
        for rate in (0.0, DROPOUT):
            drop, bases = K._dropout_args(seed, rate, S, dev)

            def run_old():
                o = torch.empty(S, T, N, device=dev)
                rc = old(x.data_ptr(), 0, zp.data_ptr(),
                         packed.params.data_ptr(), o.data_ptr(), S, T, N,
                         K._layout_ints(packed.layout), 0, *drop,
                         plan.route, plan.tile, plan.threads, plan.members,
                         plan.smem_bytes, plan.blocks_per_sm, plan.G,
                         torch.cuda.current_stream().cuda_stream)
                check(rc == 0, f"the older forward failed (code {rc})")
                return o

            def run_new():
                o = torch.empty(S, T, N, device=dev)
                rc = new(x.data_ptr(), 0, zp.data_ptr(),
                         packed.params.data_ptr(), o.data_ptr(), S, T, N,
                         K._layout_ints(packed.layout), 0, *drop,
                         plan.route, plan.tile, plan.threads, plan.members,
                         plan.smem_bytes, plan.blocks_per_sm, plan.G,
                         torch.cuda.current_stream().cuda_stream)
                check(rc == 0, f"the forward failed (code {rc})")
                return o
            a, b = run_old(), run_new()
            c = K.sdf_ffn_packed(x, zp, packed, dropout_rate=rate, seed=seed)
            torch.cuda.synchronize()
            check(torch.equal(a.view(torch.int32), b.view(torch.int32))
                  and torch.equal(b, c),
                  f"sdf_ffn_fwd f32 differs from the older kernel at "
                  f"S={S} dropout {rate}: max|d| "
                  f"{float((a - b).abs().max()):.3e}")
            # both entries called alike (the same plan and dropout
            # arguments, made once), so the times are the kernels'
            t = [cuda_ms(torch, f) for f in (run_old, run_new, run_new,
                                              run_old)]
            print(f"[kernels] fwd f32 S={S} T={T} N={N} drop {rate:.2f} "
                  f"offset 0: bit for bit equal to "
                  f"{Path(src_dir).name}/sdf_ffn.cu; older {t[0]:.4f} / "
                  f"{t[3]:.4f} ms, new {t[1]:.4f} / {t[2]:.4f} ms ({card})",
                  flush=True)
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
    source's (src_dir/cond_em.cu: its one-thread-per-stock kernels and
    argument lists, as at bdd71ce, or a source with this tree's argument
    lists, run by this tree's launchers at the same plans) at S in {1, 3,
    9}, N in {10000, 10007}, K in {4, 8}, and cond_em_dx also at
    CEM_ODD_SHAPES (K = 5 and 16, F = 10 and 80): every output bit for bit
    equal (int32 views), and the two timed in turns (old, new, new,
    old)."""
    import ctypes

    src = Path(src_dir).resolve()
    out = _nvcc.BUILD_DIR / "libcond_em_compare.so"
    _nvcc.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_nvcc.nvcc(), *_nvcc.NVCC_FLAGS, "-o", str(out),
                    str(src / "cond_em.cu")], check=True)
    lib = ctypes.CDLL(str(out))
    current = hasattr(lib, "cond_em_plan_info")  # this tree's interface
    opened = set()  # shapes whose plans the older kernels are open to

    def on_older(fn, *args):
        """`fn`, a launcher of this tree, on the older library, its kernels
        first opened to the plans' shared memory (the plan queries)."""
        saved = C._libs.get(False)
        C._libs[False] = C.bind(lib)
        x, kT, cd = args[0], args[4], args[-1]
        (T, F, N), (S, Kn, _) = x.shape, kT.shape
        try:
            if (S, T, N, F, Kn, cd) not in opened:
                opened.add((S, T, N, F, Kn, cd))
                for p in C.card_cem_plan(x.device, S, T, N, F, Kn, cd):
                    C.plan_info(p, S, T, N, F, Kn, cd)
                C.dx_plan_info(C.card_cem_dx_plan(x.device, S, T, N, F, Kn,
                                                  cd), S, T, N, F, Kn, cd)
            return fn(*args)
        finally:
            if saved is None:
                C._libs.pop(False)
            else:
                C._libs[False] = saved
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
            if current:
                return (on_older(C._launch_dx, x, zpm, xr, tinv, kT, gem,
                                 "bfloat16" if bf16 else "float32"),)
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
                    if current:
                        return (on_older(C._launch_fwd, x, zpm, xr, tinv, kT,
                                         "float32"),)
                    part = torch.empty(S, gf, Kn, N, device=dev)
                    rc = lib.cond_em_fwd(
                        x.data_ptr(), zpm.data_ptr(), xr.data_ptr(),
                        tinv.data_ptr(), kT.data_ptr(), part.data_ptr(), S,
                        T, F, N, Kn, gf, 0,
                        torch.cuda.current_stream().cuda_stream)
                    check(rc == 0, f"the older cond_em_fwd failed ({rc})")
                    return (part.sum(dim=1),)

                def old_bwd():
                    if current:
                        return on_older(C._launch_bwd, x, zpm, xr, tinv, kT,
                                        gem, "float32")
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
    rows, audits = {}, {}
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
                if name == "sdf_ffn_dx" and cd == "bfloat16":
                    audits[(S, T, N, rate)] = dx_audit_check(
                        torch, K, card, (x, zp, packed, gout, seed, rate),
                        out, f"S={S} T={T} N={N:5d} dropout {rate}")
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
    if audits:
        rows[("sdf_ffn_dx", "bfloat16", "c2_audit")] = {
            f"S={k[0]} T={k[1]} N={k[2]} dropout {k[3]}": v
            for k, v in audits.items()}
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


def dx_audit_check(torch, K, card, args, out, what):
    """ROADMAP C2: the bf16 sdf_ffn_dx's top-layer ReLU decisions through
    the audit build (the same source under -DSDF_FFN_DX_AUDIT), which also
    computes the exact chain of every top-layer element. Fails if a sign
    disagreement between the mma sum and the exact chain lies outside the
    certified window, if the largest |mma - chain| / (max|a|·Σ|W| + |b|)
    reaches the window's 2^-16, or if the audit build's dx is not the main
    library's bit for bit. Prints that ratio against 2^-19, the bound the
    window assumes (8x below it). Returns the counters."""
    adx, c = K.dx_audit(*args)
    torch.cuda.synchronize()
    assumed, window = 2.0 ** -19, 2.0 ** -16
    c = dict(c, ratio_vs_assumed=c["max_ratio"] / assumed,
             dx_bitwise_main=bool(torch.equal(adx, out)))
    print(f"[kernels] sdf_ffn_dx C2 audit {what}: (a) certified "
          f"{c['certified']} of {c['elements']} top-layer elements; (b) sign "
          f"flips mma vs chain {c['flips']}, outside the window "
          f"{c['flips_outside']}; (c) max |mma - chain|/bound "
          f"{c['max_ratio']:.3e} = {c['ratio_vs_assumed']:.3f} x 2^-19 "
          f"(window 2^-16); dx bit for bit the main library's: "
          f"{c['dx_bitwise_main']}; audit kernel {c['registers']} registers,"
          f" {c['local_bytes']} local bytes ({card})", flush=True)
    check(c["elements"] > 0, f"the C2 audit saw no element at {what}")
    check(c["flips_outside"] == 0,
          f"C2: {c['flips_outside']} top-layer decisions of sdf_ffn_dx flip "
          f"outside the certified window at {what}")
    check(c["max_ratio"] < window,
          f"C2: |mma - chain|/bound {c['max_ratio']:.3e} reaches the "
          f"certified window 2^-16 at {what}")
    check(c["dx_bitwise_main"], f"C2: the audit build's dx is not the main "
          f"library's bit for bit at {what}")
    return c


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
    """The f32 sdf_ffn_dx and sdf_ffn_bwd at offset 0 against an older
    source's (src_dir/sdf_ffn_dx.cu and sdf_ffn_bwd.cu, this tree's
    argument lists, built once per width bound) at DX_SHAPES (hidden
    (64, 64)) and at WIDE_HIDDEN × WIDE_SHAPES, dropout 0 and 0.05, on the
    same launch plans: bit for bit equal (int32 views), and the two timed
    in turns (old, new, new, old), the panel cotangent without dropout also
    by CUDA-graph replays."""
    libs = _older_ffn_libs(K, _nvcc, src_dir, [
        (k, w) for k in ("dx", "bwd") for w in K.WIDTH_BOUNDS])
    olds = {w: (libs[("dx", w)], libs[("bwd", w)][1])
            for w in K.WIDTH_BOUNDS}
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
        lay = packed.layout
        (lib, old), old_bwd = olds[K.width_bound(hidden)]
        new = K._load("dx", K.width_bound(hidden)).sdf_ffn_dx
        new_bwd = K._load("bwd", K.width_bound(hidden)).sdf_ffn_bwd
        plan = K.card_dx_plan(lay, dev, S, T, N, "float32")
        bplan = K.card_bwd_plan(lay, dev, S, T, N)
        import ctypes
        held = (ctypes.c_int * 3)()
        # opens the older kernel to the plan's shared memory
        check(lib.sdf_ffn_dx_plan_info(
            K._layout_ints(lay), S, 0, plan.route, plan.tile, plan.threads,
            plan.wbufs, plan.xbufs, ctypes.c_longlong(plan.smem_bytes), 0,
            held) == 0, "the older sdf_ffn_dx refused the plan")
        for rate in (0.0, DROPOUT):
            drop, bases = K._dropout_args(seed, rate, S, dev)

            def stream():
                # read at each call: a CUDA-graph capture runs on its own
                return torch.cuda.current_stream().cuda_stream

            def run_old():
                o = torch.empty(T, F, N, device=dev)
                rc = old(x.data_ptr(), 0, zp.data_ptr(),
                         packed.params.data_ptr(), gout.data_ptr(),
                         o.data_ptr(), None, S, T, N,
                         K._layout_ints(lay), 0, *drop, plan.route,
                         plan.tile, plan.threads, plan.wbufs, plan.xbufs,
                         plan.smem_bytes, plan.G, stream())
                check(rc == 0, f"the older sdf_ffn_dx failed (code {rc})")
                return o

            def run_new():
                o = torch.empty(T, F, N, device=dev)
                rc = new(x.data_ptr(), 0, zp.data_ptr(),
                         packed.params.data_ptr(), gout.data_ptr(),
                         o.data_ptr(), None, S, T, N,
                         K._layout_ints(lay), 0, *drop, plan.route,
                         plan.tile, plan.threads, plan.wbufs, plan.xbufs,
                         plan.smem_bytes, plan.G, stream())
                check(rc == 0, f"sdf_ffn_dx failed (code {rc})")
                return o

            def bwd(fn, args):
                gp = torch.zeros((S, bplan.G, lay.P), device=dev)
                dp = torch.zeros((S, bplan.G, T, hidden[0]), device=dev)
                rc = fn(x.data_ptr(), 0, zp.data_ptr(),
                        packed.params.data_ptr(), gout.data_ptr(),
                        gp.data_ptr(), dp.data_ptr(), S, T, N,
                        K._layout_ints(lay), 0, *args, bplan.G,
                        bplan.tile, bplan.threads, bplan.nt,
                        bplan.smem_bytes, bplan.blocks_per_sm, stream())
                check(rc == 0, f"sdf_ffn_bwd failed (code {rc})")
                return gp, dp
            run_old_bwd = lambda: bwd(old_bwd, drop)  # noqa: E731
            run_new_bwd = lambda: bwd(new_bwd, drop)  # noqa: E731
            a, b = run_old(), run_new()
            c = K._launch_dx(x, zp, packed, gout, seed, rate, plan)
            (gp, dp), (gq, dq) = run_old_bwd(), run_new_bwd()
            grads, dzp = K._launch_bwd(x, zp, packed, gout, seed, rate, bplan)
            torch.cuda.synchronize()
            check(torch.equal(a.view(torch.int32), b.view(torch.int32))
                  and torch.equal(b, c),
                  f"sdf_ffn_dx f32 differs from the older kernel at hidden="
                  f"{list(hidden)} S={S} T={T} N={N} dropout {rate}: max|d| "
                  f"{float((a - b).abs().max()):.3e}")
            check(torch.equal(gp, gq) and torch.equal(dp, dq)
                  and torch.equal(gq.sum(dim=1), grads)
                  and torch.equal(dq.sum(dim=1), dzp),
                  f"sdf_ffn_bwd f32 differs from the older kernel at hidden="
                  f"{list(hidden)} S={S} T={T} N={N} dropout {rate}")
            # both entries called alike (the same plans and dropout
            # arguments, made once), so the times are the kernels'
            t = [cuda_ms(torch, f, reps=10) for f in (run_old, run_new,
                                                      run_new, run_old)]
            tb = [cuda_ms(torch, f, reps=5) for f in (
                run_old_bwd, run_new_bwd, run_new_bwd, run_old_bwd)]
            line = ""
            if rate == 0.0:
                d = [graph_ms(torch, f, reps=10) for f in (run_old, run_new,
                                                           run_new, run_old)]
                line = (f" (device: older {d[0]:.4f} / {d[3]:.4f}, new "
                        f"{d[1]:.4f} / {d[2]:.4f})")
            print(f"[kernels] dx and bwd f32 hidden={list(hidden)} S={S} "
                  f"T={T} N={N:5d} drop {rate:.2f} offset 0: bit for bit "
                  f"equal to {Path(src_dir).name}/sdf_ffn_dx.cu and "
                  f"sdf_ffn_bwd.cu; dx older {t[0]:.4f} / {t[3]:.4f} ms, "
                  f"new {t[1]:.4f} / {t[2]:.4f} ms{line}; bwd older "
                  f"{tb[0]:.4f} / {tb[3]:.4f} ms, new {tb[1]:.4f} / "
                  f"{tb[2]:.4f} ms ({card})", flush=True)
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
    `offline`, the wires bit for bit one another. Returns the service, the
    forward's launches, the request medians per wire and each month's
    batch-1 answers on the raw-f32 and base64 wires (phase 15 holds a
    fleet to them)."""
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

    batch1 = {"raw": {}, "b64": {}}
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
            batch1["b64"][t] = bw_w.copy()
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
            batch1["raw"][t] = rw.copy()
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
    return service, launches, med, batch1


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


def serving_phase(torch, K, card, test, profile: bool,
                  dtypes=("float32", "bfloat16")):
    """Phase 4 at each of `dtypes`: the service through the async front
    end (`serve_and_check`), every warmed bucket's graph against the eager
    route, `engine.infer` timed; returns the forward's launches and what
    phase 15 holds a fleet to: the f32 offline weights and the f32
    batch-1 answers per wire."""
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
    ref = {}
    for dtype in dtypes:
        offline = ensemble_metrics(cfg, stacked, batch, ExecutionConfig(
            kernel="off", compute_dtype=dtype, device=DEVICE))
        service, n, _, answers = serve_and_check(
            torch, dtype, test, offline, bodies, card, K, server_mod)
        if dtype == "float32":
            ref = dict(answers, offline=np.asarray(offline["avg_weights"]))
        launches += n
        graph_checks(torch, service, test, card)
        reqs = engine_timing(torch, service, test, card)
        if profile:
            profile_engine(torch, service, reqs, card)
    return launches, ref


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
                                  device=DEVICE, compute_dtype="float32",
                                  bf16_panel=False))
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
                kernel=kernel, compute_dtype="float32", bf16_panel=False,
                device=DEVICE))
    trainer_mod.Trainer.run_phase = counted
    try:
        results = {}
        for kernel in ("on", "off"):
            exec_cfg = ExecutionConfig(kernel=kernel,
                                       compute_dtype="float32",
                                       bf16_panel=False, device=DEVICE)
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
                kernel="on", compute_dtype="float32", bf16_panel=False,
                device=DEVICE))
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
                                     bf16_panel=False, device=DEVICE))

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
                                     bf16_panel=False, device=DEVICE))
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

    gan = GAN(cfg, ExecutionConfig(compute_dtype="float32", bf16_panel=False,
                                   device=DEVICE))
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
        kernel=kernel, compute_dtype=cd, bf16_panel=False, device=DEVICE))
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


def sweep_plan_lines(torch, K, C, tag, cfg, S, splits, card, prefix="sweep",
                     Ts=None, train_T=None):
    """The launch plans of a sweep bucket's four training kernels (f32) as
    the card holds them: the FFN forward and conditional-EM forward at
    each T of `Ts` (default the train and valid splits'), the backwards at
    `train_T` (default the train split's; 0: none); fails if the card
    keeps fewer blocks resident than planned or a kernel spills. Lines
    start with ``[prefix]``."""
    dev = torch.device(DEVICE)
    lay = K.ffn_layout(cfg.individual_feature_dim, cfg.hidden_dim)
    F, Kn, N, cd = cfg.individual_feature_dim, cfg.num_condition_moment, \
        splits[0].N, "float32"
    Ts = Ts or (splits[0].T, splits[1].T)
    train_T = splits[0].T if train_T is None else train_T
    for T in Ts:
        plan = K.card_fwd_plan(lay, dev, S, T, N, cd)
        info = K.fwd_plan_info(lay, S, plan)
        check(info["blocks_per_sm"] >= plan.blocks_per_sm
              and info["local_bytes"] == 0,
              f"{prefix} {tag} sdf_ffn_fwd plan {plan}: the card holds "
              f"{info['blocks_per_sm']} blocks per SM, "
              f"{info['local_bytes']} B local")
        print(f"[{prefix}] {tag} plan sdf_ffn_fwd S={S} T={T} N={N} route "
              f"{plan.route} tile {plan.tile} threads {plan.threads} members "
              f"{plan.members} smem {plan.smem_bytes} B resident "
              f"{info['blocks_per_sm']}/SM (planned {plan.blocks_per_sm}) G "
              f"{plan.G} of {plan.cells} cells regs {info['registers']} "
              f"local {info['local_bytes']} B", flush=True)
        if T == train_T:
            _, bp = bwd_plan_of(torch, K, lay, S, T, N)
            print(f"[{prefix}] {tag} plan sdf_ffn_bwd S={S} T={T} N={N} "
                  f"{plan_text(bp)}", flush=True)
        for p in C.card_cem_plan(dev, S, T, N, F, Kn, cd):
            if p.kernel == "bwd" and T != train_T:
                continue
            info = C.plan_info(p, S, T, N, F, Kn, cd)
            check(info["blocks_per_sm"] >= p.blocks_per_sm
                  and info["local_bytes"] == 0,
                  f"{prefix} {tag} cond_em_{p.kernel} plan {p}: the card "
                  f"holds {info['blocks_per_sm']} blocks per SM, "
                  f"{info['local_bytes']} B local")
            print(f"[{prefix}] {tag} plan cond_em_{p.kernel} S={S} T={T} N={N} "
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
                               bf16_panel=False, device=DEVICE)

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
            kernel=kernel, compute_dtype=cd, bf16_panel=False, device=DEVICE))
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
                    kernel="on", compute_dtype="float32", bf16_panel=False,
                    device=DEVICE))
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
# processes a phase starts for a later one or beside its own work; main()
# stops any still running (stop_fleet: SIGTERM, then SIGKILL)
BACKGROUND = []
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
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            train.main(argv)
            wall = time.perf_counter() - t0
            # the bf16 run trains on the bf16 panel (the CLI's bf16_panel)
            peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
            if main_run:
                launches = dict(zip(("sdf_ffn_fwd", "sdf_ffn_bwd",
                                     "cond_em_fwd", "cond_em_bwd"),
                                    counts(K, C)))
            metrics = json.loads((save / "final_metrics.json").read_text())
            runs[(dtype, mode)] = dict(save=save, wall_s=wall,
                                       metrics=metrics, peak_mib=peak_mib)
            startup = metrics["startup"]
            panel = "bf16" if dtype == "bfloat16" else "f32"
            print(f"[data train] {dtype} {mode}: {wall:.1f} s; peak "
                  f"allocated {peak_mib:.1f} MiB ({panel} panel); startup "
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
                                      epoch_ms=r["metrics"]["epoch_ms"],
                                      peak_mib=r["peak_mib"])
                      for (d, m), r in runs.items()}


def start_real_panel():
    """Write the real-shape panel (REAL_PANEL, uncompressed) into REAL_DIR
    anew in a process of its own, so phase 11's set-up runs while an
    earlier phase waits on its children; returns (the process, its start
    on the host clock). :func:`data_plane_phase` waits for it."""
    shutil.rmtree(REAL_DIR, ignore_errors=True)
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from "
            f"{PKG}.data.synthetic import generate_all_splits; "
            "generate_all_splits(sys.argv[2], verbose=False, compress=False, "
            f"**{REAL_PANEL!r})")
    proc = subprocess.Popen([sys.executable, "-c", code, str(ROOT),
                             str(REAL_DIR)], cwd=ROOT)
    BACKGROUND.append(proc)
    return proc, time.perf_counter()


def data_plane_phase(torch, K, C, card, real=None):
    """(11) The data plane at the paper's real panel shape; `real` the
    panel's writer from :func:`start_real_panel`, started earlier (else
    started here)."""
    from deeplearninginassetpricing_paperreplication_torch.data.panel import (
        load_splits,
    )

    t_phase = time.perf_counter()
    proc, t0 = real or start_real_panel()
    check(proc.wait() == 0, f"writing the real-shape panel exited "
                            f"{proc.returncode}")
    nbytes = sum(p.stat().st_size for p in REAL_DIR.rglob("*.npz"))
    print(f"[data] real-shape panel F={REAL_PANEL['n_features']} "
          f"M={REAL_PANEL['n_macro']} N={REAL_PANEL['n_stocks']} months "
          f"{REAL_PANEL['n_periods_train']}/{REAL_PANEL['n_periods_valid']}/"
          f"{REAL_PANEL['n_periods_test']} seed {REAL_PANEL['seed']}, "
          f"uncompressed, {nbytes} B: written {time.perf_counter() - t0:.1f}"
          f" s after its start ({time.perf_counter() - t_phase:.1f} s of "
          f"this phase)", flush=True)
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
    keep_for_report(REAL_DIR / "run_bfloat16_pipeline", "phase11")
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
                compute_dtype=dtype, bf16_panel=dtype == "bfloat16",
                device=DEVICE), **kw)
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

    # the kill plan's run (a SIGKILL at the third segment, phase 2) starts
    # beside the profiled one; its --resume follows both
    plan = [{"site": "trainer/epoch_loop", "trigger_count": 3,
             "action": "kill"}]
    killed = subprocess.Popen(
        base + ["--save_dir", str(second)], cwd=ROOT,
        env=dict(env, DLAP_FAULT_PLAN=json.dumps(plan)),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    BACKGROUND.append(killed)
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

    # the kill plan's run, then --resume
    check(killed.wait(timeout=600) == -9, f"the kill plan's run exited "
                                          f"{killed.returncode}, not by "
                                          "SIGKILL")
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
        keep_for_report(OPS_DIR / "cli", "phase12")
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


def spawn_supervised_train():
    """Start (a) a kill at the third segment and (b) a hang at phase 1's
    boundary (f32 and bf16), each under ``supervise``, and their two clean
    runs: five train CLI processes side by side. Returns (the runs, their
    processes, the start); :func:`supervised_train_checks` waits for them
    and checks them."""
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
    return runs, procs, t0


def supervised_train_checks(torch, card, spawned):
    """The runs of :func:`spawn_supervised_train`, waited for and checked.
    Returns the supervised children's launches (the ``supervised_train``
    path) and the walls."""
    runs, procs, t0 = spawned
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
    exec_cfg = ExecutionConfig(compute_dtype="float32", bf16_panel=False,
                               device=DEVICE)
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
        # the supervised train CLIs run while the elastic sweeps do (each
        # its own run dir; the train children's environment is fixed at
        # their spawn, before the sweeps set their fault plans)
        spawned = spawn_supervised_train()
        with ThreadPoolExecutor(max_workers=1) as pool:
            train = pool.submit(supervised_train_checks, torch, card,
                                spawned)
            sweep_launches, sweep_walls = elastic_sweep_checks(
                torch, card, splits, ref_ranked)
            train_launches, train_walls = train.result()
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
            kernel="on", compute_dtype="float32", bf16_panel=False,
            device=DEVICE),
        ledger=SweepLedger(SWEEP_DIR / "sweep_ledger"))
    shutil.rmtree(SWEEP_DIR, ignore_errors=True)
    print(f"[elastic] phase 9's in-process ranking of the covering grid: "
          f"{len(ranked)} points in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return ranked


# ---------------------------------------------------------------------------
# 14. rolling refit and the run report
# ---------------------------------------------------------------------------

REFIT_DIR = ROOT / "_smoke_refit"
# run dirs of phases 11 and 12, kept for phase 14's report
REPORT_RUNS = ROOT / "_smoke_report_runs"
# the refit: the paper's model on phase 6's panel and schedule, two seeds a
# month, three walk-forward months of the 48-month train split, f32
REFIT_MONTHS = (24, 36, 48)
REFIT_SEEDS = (1, 2)
# the fleet: two workers, leases of a few seconds, an attempt budget that
# outlasts both kills landing on one month
REFIT_FLEET_FLAGS = ["--workers", "2", "--lease_timeout", "5",
                     "--worker_heartbeat_timeout", "120",
                     "--worker_min_uptime", "1", "--worker_backoff", "0.5",
                     "--worker_max_restarts", "8", "--retry_backoff", "0.5",
                     "--max_bucket_attempts", "4"]
REFIT_KILLS = [
    {"site": "sweep/claim", "action": "kill", "trigger_count": 2},
    {"site": "sweep/bucket", "action": "kill", "trigger_count": 3},
]
# the gate's model-health check (phase 10's tolerance): its diagnostics
# pass runs the conditional-EM forward at the gate's S = 2
REFIT_MOMENT_TOLERANCE = 1.0
# launches (sdf_ffn_fwd, sdf_ffn_bwd, cond_em_fwd, cond_em_bwd) of one
# refit member past its epochs (SWEEP_PER_EPOCH: the refit, like the
# search, evaluates no test split): the health.json pass on the valid
# split; and of one gated month: the gate's diagnostics pass and
# ensemble_metrics over its two members (S = 2)
REFIT_HEALTH_PASS = (1, 0, 1, 0)
REFIT_GATE_PASS = (2, 0, 1, 0)
# a member's files that must be byte-identical across runs
REFIT_FILES = ("best_model_sharpe.pt", "best_model_loss.pt",
               "final_model.pt", "history.npz")


def keep_for_report(src, name):
    """Keep a copy of run dir `src` for phase 14's report checks."""
    REPORT_RUNS.mkdir(parents=True, exist_ok=True)
    dst = REPORT_RUNS / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)


def refit_argv(run_dir, months=REFIT_MONTHS, extra=()):
    return ["--data_dir", str(DATA_DIR), "--run_dir", str(run_dir),
            "--months", *map(str, months),
            "--seeds", *map(str, REFIT_SEEDS),
            "--epochs_unc", str(SCHEDULE["num_epochs_unc"]),
            "--epochs_moment", str(SCHEDULE["num_epochs_moment"]),
            "--epochs", str(SCHEDULE["num_epochs"]),
            "--ignore_epoch", str(SCHEDULE["ignore_epoch"]),
            "--hidden_dim", "64", "64", "--rnn_dim", "4",
            "--num_moments", "8", "--dropout", str(DROPOUT),
            "--moment_tolerance", str(REFIT_MOMENT_TOLERANCE),
            "--device", DEVICE, "--compute_dtype", "float32", *extra]


def refit_member_launches():
    """The predicted launches of one refit member."""
    epochs = {"unconditional": SCHEDULE["num_epochs_unc"],
              "moment": SCHEDULE["num_epochs_moment"],
              "conditional": SCHEDULE["num_epochs"]}
    return tuple(sum(SWEEP_PER_EPOCH[p][i] * n for p, n in epochs.items())
                 + REFIT_HEALTH_PASS[i] for i in range(4))


def _refit_records(run_dir):
    """{month: ledger record} of a refit run dir."""
    return {r["month"]: r for r in (
        json.loads(p.read_text()) for p in
        (Path(run_dir) / "sweep_ledger" / "records").glob("*.json"))}


def _gate_outcome(run_dir):
    """(promoted sources, [(rejected source, reason)]) from the first run
    of a refit coordinator's events."""
    rows = _events(run_dir, "events.jsonl")
    rows = [r for r in rows if r.get("run_id") == rows[0].get("run_id")]
    return ([r["source"] for r in rows if r.get("kind") == "counter"
             and r.get("name") == "promote/advance"],
            [(r["source"], r["reason"]) for r in rows
             if r.get("kind") == "counter"
             and r.get("name") == "promote/reject"])


def _member_files(run_dir):
    return {p.relative_to(run_dir): p.stat().st_mtime_ns
            for p in Path(run_dir).glob("refits/*/*/*") if p.is_file()}


def refit_kernel_checks(torch, K, C, card):
    """The four training kernels against their plain versions at the
    refit's shapes: S = 1 at each window's T (dropout 0.05) and the gate's
    S = 2 at the valid split's T (no dropout: an eval forward), f32,
    N = 10,000; then each shape's launch plans as the card holds them.
    Returns {kernel: {case: row}} for the kernels line."""
    global CEM_T
    N = PANEL["n_stocks"]
    Tv = PANEL["n_periods_valid"]
    train = [(1, T, N) for T in REFIT_MONTHS if T != CEM_T]
    rows = {n: {} for n in TRAIN_KERNELS}
    fwd = wide_checks(torch, K, card, "fwd", [(64, 64)], train,
                      ("float32",), DROPOUT)
    fwd.update(wide_checks(torch, K, card, "fwd", [(64, 64)],
                           [(2, Tv, N)], ("float32",), 0.0))
    for (_, S, T, _, _), r in fwd.items():
        rows["sdf_ffn_fwd"][f"S={S} T={T}"] = r
    for (S, T, _, _, _), r in ffn_bwd_checks(
            torch, K, card, (64, 64), train, ("float32",),
            (DROPOUT,)).items():
        rows["sdf_ffn_bwd"][f"S={S} T={T}"] = r
    saved = CEM_T
    try:
        for S, T in [(1, T) for _, T, _ in train] + [(2, Tv)]:
            CEM_T = T
            cem = cond_em_checks(torch, C, card, (8,), [(S, N)],
                                 ("float32",), odd=False)
            for k in ("fwd", "bwd") if S == 1 else ("fwd",):
                rows[f"cond_em_{k}"][f"S={S} T={T}"] = cem[
                    (k, S, N, 8, "float32")]
    finally:
        CEM_T = saved
    return rows


def refit_plan_lines(torch, K, C, card, splits):
    """The launch plans of the refit's kernels as the card holds them: each
    window's training (S = 1 at T = the month, the valid split's evals),
    then the gate's validation pass (S = 2 at the valid split's T)."""
    from deeplearninginassetpricing_paperreplication_torch.utils.config \
        import GANConfig

    train = splits[0]
    cfg = GANConfig(macro_feature_dim=train.macro_feature_dim,
                    individual_feature_dim=train.individual_feature_dim)
    Tv = splits[1].T
    for month in REFIT_MONTHS:
        sweep_plan_lines(torch, K, C, f"month {month}", cfg, 1, splits, card,
                         prefix="refit", Ts=(month, Tv), train_T=month)
    sweep_plan_lines(torch, K, C, "gate", cfg, len(REFIT_SEEDS), splits,
                     card, prefix="refit", Ts=(Tv,), train_T=0)


def refit_in_process(torch, K, C, card):
    """(a) the refit CLI in this process, --workers 0, then again with
    --resume-from-ledger; (b) month 24 again with --kernel off. Returns
    (a)'s run dir, its launches and its walls."""
    from deeplearninginassetpricing_paperreplication_torch import refit
    from deeplearninginassetpricing_paperreplication_torch.reliability \
        .promotion import read_pointer

    run = REFIT_DIR / "in_process"
    K.reset_launch_count()
    C.reset_launch_count()
    t0 = time.perf_counter()
    check(refit.main(refit_argv(run)) == 0, "the refit exited non-zero")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(zip(TRAIN_KERNELS, counts(K, C)))
    records = _refit_records(run)
    check(sorted(records) == list(REFIT_MONTHS)
          and all(r["worker"] == "inline" and r["execution"] == {
              "compute_dtype": "float32", "kernel": "auto"}
              for r in records.values()),
          f"refit records {sorted(records)}")
    for r in records.values():
        for m in r["members"]:
            data = (Path(m["dir"]) / m["file"]).read_bytes()
            check(hashlib.sha256(data).hexdigest() == m["sha256"],
                  f"{m['dir']}: {m['file']} differs from its record")
    promoted, rejected = _gate_outcome(run)
    gated = len(promoted) + len(rejected)
    check(gated == len(REFIT_MONTHS) and promoted,
          f"gate: promoted {promoted}, rejected {rejected}")
    member = refit_member_launches()
    want = tuple(len(REFIT_MONTHS) * len(REFIT_SEEDS) * member[i]
                 + gated * REFIT_GATE_PASS[i] for i in range(4))
    check(tuple(launches.values()) == want,
          f"refit launches {launches}, predicted {want} ({member} a "
          f"member, {REFIT_GATE_PASS} a gated month)")
    pointer = read_pointer(run)
    walls = {m: r["seconds"] for m, r in sorted(records.items())}
    print(f"[refit] (a) refit CLI in process, months {list(REFIT_MONTHS)} x "
          f"seeds {list(REFIT_SEEDS)} (f32, 8/4/16): {wall:.1f} s; month "
          f"walls s {walls}; promoted {promoted}, rejected {rejected}; "
          f"pointer generation {pointer['generation']} ({pointer['source']})"
          f"; launches {launches} = {len(REFIT_MONTHS) * len(REFIT_SEEDS)} "
          f"members x {member} + {gated} gated months x {REFIT_GATE_PASS} "
          f"({card})", flush=True)

    # the resume trains nothing; as in the JAX package, only the months
    # the gate rejected go through it again (a promoted month is skipped)
    before = _member_files(run)
    K.reset_launch_count()
    C.reset_launch_count()
    t0 = time.perf_counter()
    check(refit.main(refit_argv(run, extra=["--resume-from-ledger"])) == 0,
          "the resumed refit exited non-zero")
    resume_wall = time.perf_counter() - t0
    hits = _count(_events(run, "events.jsonl"), "sweep/ledger_hit")
    regated = tuple(len(rejected) * n for n in REFIT_GATE_PASS)
    check(counts(K, C) == regated,
          f"the resumed refit launched {counts(K, C)}, not the gate passes "
          f"of its {len(rejected)} rejected months {regated}")
    check(_member_files(run) == before, "the resumed refit rewrote a member "
                                        "file")
    check(read_pointer(run)["generation"] == pointer["generation"],
          "the resumed refit moved the pointer")
    print(f"[refit] (a) --resume-from-ledger: {resume_wall:.1f} s; no "
          f"training launch (launches {counts(K, C)}: the gate again on the "
          f"{len(rejected)} rejected months), {len(before)} member files "
          f"untouched (mtimes), pointer generation {pointer['generation']}; "
          f"ledger hits {hits} ({card})", flush=True)

    plain = REFIT_DIR / "kernel_off"
    month = REFIT_MONTHS[0]
    t0 = time.perf_counter()
    check(refit.main(refit_argv(plain, (month,), ["--kernel", "off",
                                                  "--no_promote"])) == 0,
          "the --kernel off refit exited non-zero")
    off_wall = time.perf_counter() - t0
    devs = []
    for s in REFIT_SEEDS:
        sub = Path("refits") / f"m{month:04d}" / f"seed{s}"
        d_loss, d_sharpe, where = _history_devs(
            np.load(run / sub / "history.npz"),
            np.load(plain / sub / "history.npz"))
        check(d_loss <= 1e-3 and d_sharpe <= 5e-3,
              f"refit month {month} seed {s}: the kernel route deviates from "
              f"--kernel off: loss rel {d_loss:.3e} at {where}, Sharpe "
              f"{d_sharpe:.3e}")
        devs.append((d_loss, d_sharpe))
    print(f"[refit] (b) month {month} with --kernel off: {off_wall:.1f} s; "
          f"each seed's history within the training bars of the kernel "
          f"route's: (loss rel, Sharpe) {devs} ({card})", flush=True)
    return run, launches, dict(wall=wall, month_walls=walls,
                               resume_wall=resume_wall, off_wall=off_wall)


def refit_fleet(torch, K, C, card, ref):
    """(c) a supervised --workers 2 refit with kills at sweep/claim #2 and
    sweep/bucket #3: every month's member files byte-identical to (a)'s,
    the same months promoted and rejected, three records, two restarts.
    Returns its run dir, the launches (the workers that exited normally,
    and the coordinator's gate) and its walls."""
    from deeplearninginassetpricing_paperreplication_torch import refit
    from deeplearninginassetpricing_paperreplication_torch.ops import (
        ENV_LAUNCH_COUNTS,
    )

    run = REFIT_DIR / "fleet"
    run.mkdir(parents=True)
    os.environ[ENV_LAUNCH_COUNTS] = str(run / "launches.jsonl")
    _fault_plan(REFIT_KILLS)
    K.reset_launch_count()
    C.reset_launch_count()
    t0 = time.perf_counter()
    try:
        rc = refit.main(refit_argv(run, extra=REFIT_FLEET_FLAGS))
    finally:
        os.environ.pop(ENV_LAUNCH_COUNTS, None)
        _fault_plan(None)
    wall = time.perf_counter() - t0
    gate = counts(K, C)
    check(rc == 0, "the refit fleet's coordinator exited non-zero")
    records = _refit_records(run)
    check(sorted(records) == list(REFIT_MONTHS)
          and all(r["worker"] in ("w0", "w1") for r in records.values()),
          f"fleet records {sorted(records)}, workers "
          f"{[r['worker'] for r in records.values()]}")
    for month in REFIT_MONTHS:
        for s in REFIT_SEEDS:
            sub = Path("refits") / f"m{month:04d}" / f"seed{s}"
            for f in REFIT_FILES:
                check((run / sub / f).read_bytes()
                      == (ref / sub / f).read_bytes(),
                      f"fleet {sub}/{f} differs from the in-process run's")
    outcome, ref_outcome = _gate_outcome(run), _gate_outcome(ref)
    check(outcome == ref_outcome, f"fleet gate {outcome}, in process "
                                  f"{ref_outcome}")
    faults = _events(run, "events.faults.jsonl")
    check(sorted((r["site"], r["action"]) for r in faults)
          == sorted((p["site"], p["action"]) for p in REFIT_KILLS),
          f"fired faults {faults}")
    rows = _events(run)
    restarts = _count(rows, "supervise/restart")
    check(restarts == len(REFIT_KILLS)
          and _count(rows, "sweep/ledger_write") == len(REFIT_MONTHS),
          f"{restarts} restarts for {len(REFIT_KILLS)} kills; ledger writes "
          f"{_count(rows, 'sweep/ledger_write')} (a month retrained?)")
    for wid in ("w0", "w1"):
        m = json.loads((run / f"manifest.{wid}.json").read_text())
        check(m["kernel_route"] == "cuda" and m["execution"] == {
            "compute_dtype": "float32", "kernel": "auto"}
            and "--resume" not in m["argv"],
            f"{wid}'s manifest: route {m['kernel_route']}, execution "
            f"{m['execution']}, argv {m['argv']}")
    worker_rows = _launch_rows(run / "launches.jsonl")
    workers = _sum_launches(worker_rows)
    launches = {k: workers[k] + n for k, n in zip(TRAIN_KERNELS, gate)}
    gated = len(ref_outcome[0]) + len(ref_outcome[1])
    check(gate == tuple(gated * n for n in REFIT_GATE_PASS),
          f"the fleet coordinator's gate launched {gate}")
    walls = {m: r["seconds"] for m, r in sorted(records.items())}
    print(f"[refit] (c) supervised --workers 2, kills at sweep/claim #2 and "
          f"sweep/bucket #3: {wall:.1f} s; {len(records)} records by "
          f"{ {m: r['worker'] for m, r in sorted(records.items())} }, "
          f"month walls s {walls}; restarts {restarts}, takeovers "
          f"{_count(rows, 'sweep/lease_takeover')}; every month's "
          f"{', '.join(REFIT_FILES)} byte-identical to (a)'s; gate "
          f"{outcome} as (a); launches of the {len(worker_rows)} workers "
          f"that exited normally {workers} + the gate {gate} ({card})",
          flush=True)
    return run, launches, dict(wall=wall, month_walls=walls,
                               restarts=restarts)


def _report(*argv):
    return subprocess.run([sys.executable, "-m", f"{PKG}.report", *argv],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)


def refit_report_checks(card, fleet):
    """(d) the report CLI: --json on (c)'s run dir, the text report on
    phases 11 and 12's run dirs, --trace of (c)'s fleet, --budget with a
    run-scoped spec that holds and one that asks for a fourth month."""
    t0 = time.perf_counter()
    out = _report(str(fleet), "--json")
    check(out.returncode == 0, f"report --json exited {out.returncode}: "
                               + out.stderr[-2000:])
    s = json.loads(out.stdout)
    check(s["elastic"]["buckets_completed"] == len(REFIT_MONTHS)
          and s["reliability"]["restarts"] == len(REFIT_KILLS),
          f"report --json: elastic {s['elastic']}, reliability "
          f"{s['reliability']}")
    kept = []
    for name in ("phase11", "phase12"):
        run = REPORT_RUNS / name
        if not run.is_dir():
            print(f"[refit] (d) report on {name}'s run dir: not run "
                  f"({name} did not run)", flush=True)
            continue
        out = _report(str(run))
        check(out.returncode == 0 and "startup breakdown" in out.stdout
              and "per-phase throughput" in out.stdout
              and "phase3_conditional" in out.stdout
              and "kernel launch plans" in out.stdout
              and "model health:" in out.stdout,
              f"report on {name}'s run dir:\n{out.stdout[-3000:]}")
        kept.append(name)
    trace_path = REFIT_DIR / "fleet_trace.json"
    out = _report(str(fleet), "--trace", str(trace_path))
    check(out.returncode == 0, f"report --trace exited {out.returncode}: "
                               + out.stderr[-2000:])
    trace = json.loads(trace_path.read_text())
    lanes = {e["args"]["name"] for e in trace["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"}
    for lane in ("events.jsonl", "events.w0.jsonl", "events.w1.jsonl",
                 "events.supervisor.w0.jsonl", "events.supervisor.w1.jsonl"):
        check(lane in lanes, f"the fleet's trace has no {lane} lane: "
                             f"{sorted(lanes)}")
    spans = {e["name"] for e in trace["traceEvents"] if e["ph"] == "X"}
    check({"refit/bucket", "refit/fleet"} <= spans,
          f"the fleet's trace lacks the refit spans: {sorted(spans)[:20]}")
    rcs = {}
    for months in (len(REFIT_MONTHS), len(REFIT_MONTHS) + 1):
        spec = REFIT_DIR / f"budget_{months}.json"
        spec.write_text(json.dumps({"schema": 1, "budgets": [
            {"name": "refit_months", "metric": "elastic.buckets_completed",
             "equals": months},
            {"name": "refit_restarts", "metric": "reliability.restarts",
             "max": len(REFIT_KILLS)}]}))
        rcs[months] = _report(str(fleet), "--budget", str(spec)).returncode
    check(rcs[len(REFIT_MONTHS)] == 0 and rcs[len(REFIT_MONTHS) + 1] != 0,
          f"report --budget exit codes {rcs}")
    print(f"[refit] (d) report: --json buckets_completed "
          f"{s['elastic']['buckets_completed']}, restarts "
          f"{s['reliability']['restarts']}; the startup and training "
          f"sections on {kept}; --trace {trace['otherData']['n_files']} lanes "
          f"({', '.join(sorted(lanes))}), "
          f"{trace['otherData']['n_span_events']} spans, "
          f"{trace['otherData']['n_synthesized_ends']} synthesized ends; "
          f"--budget rc {rcs}; {time.perf_counter() - t0:.1f} s ({card})",
          flush=True)


def refit_phase(torch, K, C, card, splits):
    """(14) Rolling refit and the run report on phase 6's panel; returns
    the two refit paths' launches by kernel and the kernel rows at the
    refit's shapes."""
    t0 = time.perf_counter()
    shutil.rmtree(REFIT_DIR, ignore_errors=True)
    REFIT_DIR.mkdir(parents=True)
    # the fleet's workers import the package from this checkout
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p and p != str(ROOT)])
    try:
        rows = refit_kernel_checks(torch, K, C, card)
        refit_plan_lines(torch, K, C, card, splits)
        ref, in_process, a_walls = refit_in_process(torch, K, C, card)
        fleet, fleet_launches, c_walls = refit_fleet(torch, K, C, card, ref)
        refit_report_checks(card, fleet)
    finally:
        _fault_plan(None)
        shutil.rmtree(REFIT_DIR, ignore_errors=True)
        shutil.rmtree(REPORT_RUNS, ignore_errors=True)
    for path, launches in (("rolling_refit", in_process),
                           ("rolling_refit_fleet", fleet_launches)):
        for name, n in launches.items():
            check(n > 0, f"the {path} path launched {name} no time")
    print(f"[refit] phase 14 done in {time.perf_counter() - t0:.1f} s; "
          f"(a) {a_walls['wall']:.1f} s, resume {a_walls['resume_wall']:.1f}"
          f" s, (b) {a_walls['off_wall']:.1f} s, (c) {c_walls['wall']:.1f} s"
          f" ({card})", flush=True)
    return dict(rolling_refit=in_process, rolling_refit_fleet=fleet_launches,
                rows=rows)


# -- phase 15 -----------------------------------------------------------------


FLEET_DIR = ROOT / "_smoke_fleet"
FLEET_C = 32  # closed-loop clients on the raw-f32 and base64 wires
FLEET_JSON_C = 4  # the JSON wire's parse is ~155 ms a request at N = 10,000
FLEET_RAW_N = 480  # requests of a closed raw-f32 loop
FLEET_B64_N = 160
FLEET_JSON_N = 8
FLEET_LADDER = (0.25, 0.5, 0.75)  # open-loop rates, shares of the c = 32 rps
FLEET_SWING_S = (4.0, 12.0, 6.0)  # base, surge, base (bench_loadadapt's swing)
FLEET_AUTOSCALE = ["--autoscale", "--min_replicas", "1", "--max_replicas", "2",
                   "--autoscale_poll_s", "0.25", "--autoscale_up_depth", "10",
                   "--autoscale_down_depth", "1",
                   "--autoscale_up_hysteresis", "2",
                   "--autoscale_down_hysteresis", "12",
                   "--autoscale_cooldown_s", "3", "--max_queue", "32",
                   "--bulk_threshold", "0.5"]


def replica_pids(run_dir: Path) -> dict:
    """{replica id: live pid} of a CLI fleet's replicas (each one's command
    line names its own run dir under `run_dir`)."""
    out = {}
    for d in Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            argv = (d / "cmdline").read_bytes().decode(errors="replace") \
                .split("\0")
        except OSError:
            continue
        if "--replica_id" in argv and "--run_dir" in argv:
            rdir = argv[argv.index("--run_dir") + 1]
            if Path(rdir).parent == run_dir:
                out[int(argv[argv.index("--replica_id") + 1])] = int(d.name)
    return out


def nvidia_fds(pid: int) -> int:
    """Open file descriptors of `pid` on /dev/nvidia* — a process holding a
    CUDA context has several, one that never touched the card none."""
    n = 0
    for fd in Path(f"/proc/{pid}/fd").iterdir():
        try:
            n += os.readlink(fd).startswith("/dev/nvidia")
        except OSError:
            pass
    return n


def compute_app_pids():
    """The pids `nvidia-smi --query-compute-apps=pid` lists, or None when it
    cannot say."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    if out.returncode != 0:
        return None
    return {int(x) for x in out.stdout.split() if x.strip().isdigit()}


def boot_fleet(run_dir: Path, replicas: int, extra, timeout: float = 300.0):
    """The serving CLI's fleet (`--replicas`) as a subprocess on a free
    port, with `extra` arguments; returns (process, base url, admin urls,
    boot s) once every replica's heartbeat says `serve/accepting`."""
    from deeplearninginassetpricing_paperreplication_torch.observability \
        .heartbeat import read_state
    from deeplearninginassetpricing_paperreplication_torch.serving import (
        pick_free_port,
        read_fleet_json,
    )

    shutil.rmtree(run_dir, ignore_errors=True)
    port = pick_free_port()
    env = {k: v for k, v in os.environ.items() if k != "DLAP_FAULT_PLAN"}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p and p != str(ROOT)])
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{PKG}.serving.server", "--server", "async",
         "--replicas", str(replicas), "--run_dir", str(run_dir), "--port",
         str(port), "--device", DEVICE, "--compute_dtype", "float32",
         "--cache_size", "0", *extra],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)

    def ready():
        layout = read_fleet_json(run_dir) or {}
        ids = layout.get("replica_ids") or []
        return len(ids) == replicas and all(
            (read_state(run_dir / f"replica{i}" / "heartbeat.json")
             .get("heartbeat") or {}).get("section") == "serve/accepting"
            for i in ids)

    while not ready():
        if proc.poll() is not None or time.perf_counter() - t0 > timeout:
            stop_fleet(proc)
            tails = "".join(
                f"\n{p}:\n" + "\n".join(p.read_text(errors="replace")
                                        .splitlines()[-15:])
                for p in sorted(run_dir.glob("replica*/supervised.log")))
            fail(f"the {replicas}-replica fleet did not boot: "
                 f"{proc.stdout.read()[-3000:]}{tails}")
        time.sleep(0.1)
    layout = read_fleet_json(run_dir)
    return (proc, f"http://127.0.0.1:{port}", layout["admin_urls"],
            time.perf_counter() - t0)


def stop_fleet(proc) -> None:
    """SIGTERM the fleet parent (it stops its replicas), SIGKILL after 60 s."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()


def _back(admin_url: str, old_run_id: str, t_kill: float,
          timeout: float = 300.0) -> float:
    """Seconds from `t_kill` until the replica behind `admin_url` answers
    as a new incarnation (another run id)."""
    while True:
        try:
            s, h = get(admin_url + "/healthz")
            if s == 200 and h.get("run_id") != old_run_id:
                return time.perf_counter() - t_kill
        except OSError:
            pass
        check(time.perf_counter() - t_kill < timeout,
              f"{admin_url} was not restarted within {timeout:.0f} s")
        time.sleep(0.1)


def _lat(run) -> str:
    p = run.get("latency") or {}
    return (f"p50 {p.get('p50_ms')} p95 {p.get('p95_ms')} p99 "
            f"{p.get('p99_ms')} ms")


def _metrics(url: str) -> dict:
    return get(url + "/metrics")[1]


def fleet_members(torch, member_dirs):
    """The fleet's promotion pointer: generation 1 the `ref_runs` trio
    (saved again through the verified IO, tensors unchanged, so the
    pointer can name each member's digest), and the reload target of
    phase 4b (`member_dirs[3:6]`, the same architecture) ready for
    generation 2. Returns (pointer root, generation 2's head)."""
    from deeplearninginassetpricing_paperreplication_torch.evaluate_ensemble \
        import stack_checkpoints
    from deeplearninginassetpricing_paperreplication_torch.reliability \
        .promotion import verify_member_dirs, write_pointer
    from deeplearninginassetpricing_paperreplication_torch.serving.engine \
        import params_digest
    from deeplearninginassetpricing_paperreplication_torch.training \
        .checkpoint import member_state_dicts, save_state_dict

    shutil.rmtree(FLEET_DIR, ignore_errors=True)
    dirs = []
    src = [str(ROOT / d) for d in REF_RUNS]
    _, stacked = stack_checkpoints(src, device="cpu")
    for d, sd in zip(REF_RUNS, member_state_dicts(stacked)):
        out = FLEET_DIR / "members" / Path(d).name
        out.mkdir(parents=True)
        shutil.copy(ROOT / d / "config.json", out)
        save_state_dict(out / "best_model_sharpe.pt", sd)
        dirs.append(str(out))

    def head(ds):
        members, rejection = verify_member_dirs(ds)
        check(rejection is None, f"fleet members: {rejection}")
        _, st = stack_checkpoints(ds, device="cpu")
        return {"checkpoint_dirs": list(ds), "members": members,
                "params_fingerprint": params_digest(st)}

    ctl = FLEET_DIR / "ctl"
    gen1 = head(dirs)
    check(gen1["params_fingerprint"] == params_digest(stacked),
          "the saved ref_runs trio differs from ref_runs")
    write_pointer(ctl, gen1)
    return ctl, head(member_dirs[3:6])


def fleet_bodies(test):
    """Per test month: the raw-f32 body of the valid rows and the base64
    and JSON bodies of the full cross-section (phase 4's), plus a second
    distinct raw body (the valid rows but the last) for the swing."""
    from deeplearninginassetpricing_paperreplication_torch.serving.engine \
        import DEFAULT_STOCK_BUCKETS, bucket_for

    bodies = serving_bodies(test)
    raw = [b["raw"] for b in bodies]
    valid = [b["valid"] for b in bodies]
    alt = [_raw_body(t, test.individual[t][valid[t]][:-1])
           for t in range(test.T)]
    sizes = [int(v.sum()) for v in valid] + [int(v.sum()) - 1 for v in valid]
    buckets = sorted({bucket_for(n, DEFAULT_STOCK_BUCKETS)
                      for n in sizes + [test.N]})
    return dict(raw=raw, alt=alt, valid=valid,
                b64=[b["b64"] for b in bodies],
                json=[b["json"] for b in bodies], buckets=buckets)


def fleet_answers(base, admin, test, ref, b):
    """(a) every month once (c = 1) over raw-f32 and base64 through the
    shared port: bit for bit phase 4's batch-1 answers; then every month
    four times from 32 concurrent clients: within the f32 bar of the
    offline weights."""
    from concurrent.futures import ThreadPoolExecutor

    for t in range(test.T):
        s, w = post(base + "/v1/weights", b["raw"][t], raw=True)
        check(s == 200 and np.array_equal(w, ref["raw"][t]),
              f"fleet raw-f32 answer != phase 4's at month {t}")
        s, ans = post(base + "/v1/weights", b["b64"][t])
        check(s == 200 and np.array_equal(_unb64(ans["weights_b64"]),
                                          ref["b64"][t]),
              f"fleet base64 answer != phase 4's at month {t}")
    jobs = [t % test.T for t in range(4 * test.T)]
    worst = [0.0]

    def one(t):
        s, w = post(base + "/v1/weights", b["raw"][t], raw=True)
        check(s == 200, f"HTTP {s} under load at month {t}")
        want = ref["offline"][t][b["valid"][t]]
        d = np.abs(w - want)
        check(within(d, want, "float32", **SERVE_F32_TOL),
              f"under load, month {t} max|d| {d.max():.3e} over the f32 bar")
        worst[0] = max(worst[0], float(d.max()))

    with ThreadPoolExecutor(FLEET_C) as pool:
        list(pool.map(one, jobs))
    return worst[0]


def fleet_context_check(proc, pids, card):
    """The fleet parent holds no CUDA context, each replica one: no
    /dev/nvidia* descriptor in the parent, some in every replica; and
    `nvidia-smi --query-compute-apps` lists the replicas, not the parent
    (this process's own context aside)."""
    parent_fds = nvidia_fds(proc.pid)
    fds = {i: nvidia_fds(p) for i, p in pids.items()}
    check(parent_fds == 0, f"the fleet parent holds {parent_fds} "
                           "/dev/nvidia* descriptors")
    check(all(n > 0 for n in fds.values()),
          f"a replica holds no /dev/nvidia* descriptor: {fds}")
    apps = compute_app_pids()
    if apps is not None and os.getpid() in apps:
        listed = apps - {os.getpid()}
        check(listed == set(pids.values()) and proc.pid not in apps,
              f"nvidia-smi lists compute apps {sorted(apps)}; replicas "
              f"{pids}, parent {proc.pid}, this script {os.getpid()}")
        how = "nvidia-smi lists exactly the replicas (and this script)"
    else:
        how = (f"nvidia-smi's pids {sorted(apps or [])} are of another pid "
               f"namespace: held by /proc descriptors alone")
    print(f"[fleet] CUDA contexts: parent pid {proc.pid} 0 /dev/nvidia* "
          f"descriptors, replicas {pids} {fds}; {how} ({card})", flush=True)


def fleet_load(base, admin, b, card):
    """(b) closed loops at c = 32 on raw-f32 and base64 and c = 4 on JSON,
    an open-loop raw-f32 ladder, then the c = 32 raw-f32 loop against one
    replica (its admin port); errors all zero; per replica: no capture
    after warmup, graph replays and kernel launches counted."""
    from deeplearninginassetpricing_paperreplication_torch.serving.loadgen \
        import run_ladder, run_loadgen
    from deeplearninginassetpricing_paperreplication_torch.serving.server \
        import BINARY_CONTENT_TYPE

    raw = b["raw"] + b["alt"]

    def loop(url, pool, c, n, ctype="application/json"):
        cpu0, t0 = time.process_time(), time.perf_counter()
        out = run_loadgen(url + "/v1/weights", lambda i: pool[i % len(pool)],
                          mode="closed", concurrency=c, n_requests=n,
                          warmup_requests=0, retries=2, content_type=ctype)
        out["client_cpu"] = (time.process_time() - cpu0) / (
            time.perf_counter() - t0)
        check(out["n_ok"] == n and out["errors"] == {},
              f"closed loop c={c}: {out['n_ok']}/{n}, errors "
              f"{out['errors']}")
        return out

    # the bucket-4 shapes' first flushes, untimed
    loop(base, raw, FLEET_C, 4 * len(raw), BINARY_CONTENT_TYPE)
    runs = {"raw": loop(base, raw, FLEET_C, FLEET_RAW_N, BINARY_CONTENT_TYPE),
            "b64": loop(base, b["b64"], FLEET_C, FLEET_B64_N),
            "json": loop(base, b["json"], FLEET_JSON_C, FLEET_JSON_N)}
    cap = runs["raw"]["throughput_rps"]
    rates = [round(f * cap, 1) for f in FLEET_LADDER]
    ladder = run_ladder(base + "/v1/weights", lambda i: raw[i % len(raw)],
                        rates=rates, warmup_s=0.5, measure_s=1.5, retries=2,
                        content_type=BINARY_CONTENT_TYPE)
    for step in ladder["steps"]:
        check(step["n_ok"] == step["n_requests"] and step["errors"] == {},
              f"ladder step {step['offered_rate_rps']} rps: errors "
              f"{step['errors']}")
    one = loop(admin[0], raw, FLEET_C, FLEET_RAW_N // 2, BINARY_CONTENT_TYPE)
    per, depth = {}, {}
    for url in admin:
        m = _metrics(url)
        e = m["engine"]
        depth[url] = m["batcher"].get("mean_queue_depth")
        check(e["steady_state_captures"] == 0 and e["replays"] > 0
              and e["kernel_launches"] > 0 and e["ffn_route"] == "cuda",
              f"{url}: captures after warmup {e['steady_state_captures']}, "
              f"replays {e['replays']}, launches {e['kernel_launches']}, "
              f"route {e['ffn_route']}")
        per[url] = e
    for wire, r in runs.items():
        c = FLEET_JSON_C if wire == "json" else FLEET_C
        print(f"[fleet] (b) 2 replicas, {wire} c={c}: {r['n_ok']} requests "
              f"{r['throughput_rps']} rps, {_lat(r)}, errors {r['errors']}, "
              f"retried {r['n_retried']}; client CPU "
              f"{r['client_cpu']:.2f} cores ({card})", flush=True)
    for step in ladder["steps"]:
        print(f"[fleet] (b) open loop raw-f32 {step['offered_rate_rps']} rps "
              f"offered: {step['n_ok']}/{step['n_requests']} served, "
              f"{_lat(step)}, late sends {step.get('late_sends')}, errors "
              f"{step['errors']} ({card})", flush=True)
    print(f"[fleet] (b) 1 replica, raw-f32 c={FLEET_C}: "
          f"{one['throughput_rps']} rps, {_lat(one)}; 2-vs-1 "
          f"{cap / one['throughput_rps']:.3f}; client CPU "
          f"{one['client_cpu']:.2f} cores ({card})", flush=True)
    print(f"[fleet] (b) per replica: " + "; ".join(
        f"replica{i} captures {e['captures']} (after warmup "
        f"{e['steady_state_captures']}), replays {e['replays']}, "
        f"sdf_ffn_fwd launches {e['kernel_launches']}, mean queue depth "
        f"at a flush {depth[url]}"
        for i, (url, e) in enumerate(per.items())) + f" ({card})",
        flush=True)
    return dict(runs=runs, ladder=ladder, one=one, cap=cap)


def _open_load(base, pool, rate, seconds, retries=3):
    """An open-loop raw-f32 run on a thread; returns (thread, result)."""
    import threading

    from deeplearninginassetpricing_paperreplication_torch.serving.loadgen \
        import run_loadgen
    from deeplearninginassetpricing_paperreplication_torch.serving.server \
        import BINARY_CONTENT_TYPE

    out = {}

    def drive():
        out.update(run_loadgen(
            base + "/v1/weights", lambda i: pool[i % len(pool)], mode="open",
            rate_rps=rate, n_requests=max(1, int(rate * seconds)),
            warmup_requests=0, retries=retries, open_workers=32,
            content_type=BINARY_CONTENT_TYPE))

    t = threading.Thread(target=drive, name="fleet-load")
    t.start()
    return t, out


def _restarts(run_dir: Path, rid: int) -> int:
    path = run_dir / f"events.supervisor.replica{rid}.jsonl"
    return sum(json.loads(x).get("name") == "supervise/restart"
               for x in path.read_text().splitlines() if x.strip())


def fleet_kill(base, admin, run_dir, b, cap, n_buckets, card):
    """(c) SIGKILL replica0 in the middle of an open-loop raw-f32 run with
    retries: every request answered, one supervised restart, and the new
    incarnation captures in its warmup only."""
    raw = b["raw"] + b["alt"]
    pid0 = replica_pids(run_dir)[0]
    old_run = get(admin[0] + "/healthz")[1]["run_id"]
    rate = round(0.35 * cap, 1)
    t, load = _open_load(base, raw, rate, 4.0)
    time.sleep(1.5)
    os.kill(pid0, signal.SIGKILL)
    t_kill = time.perf_counter()
    t.join()
    check(load["n_ok"] == load["n_requests"] and load["errors"] == {},
          f"(c) {load['n_requests'] - load['n_ok']} requests lost to the "
          f"kill: {load['errors']}")
    back = _back(admin[0], old_run, t_kill)
    check(_restarts(run_dir, 0) == 1, f"replica0 restarted "
                                      f"{_restarts(run_dir, 0)} times")
    for body in raw[:8]:
        check(post(admin[0] + "/v1/weights", body, raw=True)[0] == 200,
              "the restarted replica does not serve")
    e = _metrics(admin[0])["engine"]
    check(e["captures"] == n_buckets and e["steady_state_captures"] == 0,
          f"(c) the new incarnation: {e['captures']} captures for "
          f"{n_buckets} buckets, {e['steady_state_captures']} after warmup")
    print(f"[fleet] (c) SIGKILL replica0 (pid {pid0}) under {rate} rps "
          f"open loop: {load['n_ok']}/{load['n_requests']} answered, "
          f"{load['n_retried']} retried, {_lat(load)}; restarted once, "
          f"serving again {back:.1f} s after the kill (the supervisor's "
          f"backoff and one replica's boot); new incarnation "
          f"{e['captures']} captures, {e['steady_state_captures']} after "
          f"warmup ({card})",
          flush=True)
    return back


def fleet_reload(base, admin, ctl, gen2, b, cap, card):
    """(d) `RollingUpdater` rolls both replicas onto generation 2 of the
    pointer under an open-loop raw-f32 load: nothing dropped, both report
    the pointer's fingerprint, no capture after warmup."""
    from deeplearninginassetpricing_paperreplication_torch.reliability \
        .promotion import write_pointer
    from deeplearninginassetpricing_paperreplication_torch.serving.fleet \
        import RollingUpdater

    raw = b["raw"] + b["alt"]
    rate = round(0.3 * cap, 1)
    t, load = _open_load(base, raw, rate, 6.0)
    time.sleep(1.0)
    pointer = write_pointer(ctl, gen2)
    t0 = time.perf_counter()
    roll = RollingUpdater(admin, ctl, health_interval_s=0.25).roll()
    roll_s = time.perf_counter() - t0
    t.join()
    check(roll["status"] == "promoted", f"(d) roll: {roll}")
    check(load["n_ok"] == load["n_requests"] and load["errors"] == {},
          f"(d) {load['n_requests'] - load['n_ok']} requests dropped by the "
          f"rolling reload: {load['errors']}")
    fp = str(pointer["params_fingerprint"])[:16]
    for url in admin:
        e = _metrics(url)["engine"]
        check(e["params_fingerprint"] == fp
              and e["steady_state_captures"] == 0
              and e["params_generation"] >= 1,
              f"(d) {url}: fingerprint {e['params_fingerprint']} (want "
              f"{fp}), captures after warmup {e['steady_state_captures']}")
    print(f"[fleet] (d) rolling reload onto pointer generation "
          f"{pointer['generation']} ({fp}) under {rate} rps: "
          f"{load['n_ok']}/{load['n_requests']} answered, 0 dropped, "
          f"{_lat(load)}; roll {roll_s:.2f} s, both replicas on the "
          f"pointer's fingerprint, 0 captures after warmup ({card})",
          flush=True)


def fleet_slo(base, admin, run_dir, b, card):
    """(f) the prober and the burn-rate engine on the drill spec: a
    SIGKILLed replica and, later, a SIGSTOPped one (still accepting) each
    fire the availability alert, each alert resolves (restart, SIGCONT);
    then `ops status` and `report --json` on the fleet's run dir, and a
    `/v1/debug/profile` capture on replica1's admin port whose trace names
    sdf_ffn_fwd on a device lane."""
    from deeplearninginassetpricing_paperreplication_torch.observability \
        .events import EventLog
    from deeplearninginassetpricing_paperreplication_torch.observability \
        .slo import FileAlertSink, SLOEngine, drill_spec
    from deeplearninginassetpricing_paperreplication_torch.serving.flight \
        import FlightRecorder
    from deeplearninginassetpricing_paperreplication_torch.serving.probe \
        import Prober, build_sources, fixture_payload

    events = EventLog(run_dir, filename="events.probe.jsonl",
                      process_index=0)
    flight = FlightRecorder(run_dir=run_dir, events=events)
    prober = Prober(events, public_url=base,
                    fixture=fixture_payload(PANEL["n_features"], month=0),
                    fleet_dir=run_dir, interval_s=0.25, timeout_s=1.0)
    engine = SLOEngine(drill_spec(), build_sources(prober=prober),
                       events=events, flight=flight,
                       sinks=(FileAlertSink(run_dir / "alerts.jsonl"),),
                       poll_s=0.1)

    def wait_for(cond, timeout, what):
        t0 = time.perf_counter()
        while not cond():
            check(time.perf_counter() - t0 < timeout,
                  f"(f) timed out waiting for {what}: {engine.state()}")
            time.sleep(0.05)
        return time.perf_counter() - t0

    det = {}
    try:
        prober.start()
        engine.start()
        wait_for(lambda: prober.counts()[1] >= 12, 60, "probes flowing")
        wait_for(lambda: engine.firing() == [], 60, "a clean baseline")
        pids = replica_pids(run_dir)
        os.kill(pids[0], signal.SIGKILL)
        det["kill"] = wait_for(lambda: engine.firing(), 60,
                               "the kill drill's alert")
        det["kill_resolve"] = wait_for(lambda: not engine.firing(), 180,
                                       "the kill's resolve")
        pid1 = replica_pids(run_dir)[1]
        os.kill(pid1, signal.SIGSTOP)
        try:
            det["wedge"] = wait_for(lambda: engine.firing(), 60,
                                    "the wedge drill's alert")
        finally:
            os.kill(pid1, signal.SIGCONT)
        det["wedge_resolve"] = wait_for(lambda: not engine.firing(), 180,
                                        "the wedge's resolve")
        stats = prober.stats()
    finally:
        engine.stop()
        prober.stop()
        events.close()
    names = [json.loads(x)["name"] for x in
             (run_dir / "events.probe.jsonl").read_text().splitlines()
             if json.loads(x).get("kind") == "alert"]
    check(names[-4:] == ["alert/firing", "alert/resolved", "alert/firing",
                         "alert/resolved"], f"(f) alert rows {names}")
    print(f"[fleet] (f) SLO drills (drill spec: 8 s / 2 s windows, burn 6): "
          f"SIGKILL replica0 fired in {det['kill']:.2f} s, resolved "
          f"{det['kill_resolve']:.1f} s later; SIGSTOP replica1 fired in "
          f"{det['wedge']:.2f} s, resolved {det['wedge_resolve']:.1f} s "
          f"after SIGCONT; probes {stats['checks']} checks, "
          f"{stats['failures']} failures ({card})", flush=True)
    status = subprocess.run([sys.executable, "-m", f"{PKG}.ops", "status",
                             str(run_dir)], cwd=ROOT, capture_output=True,
                            text=True, timeout=120)
    check(status.returncode == 0 and "slo:" in status.stdout
          and "replica0" in status.stdout,
          f"ops status: rc {status.returncode}\n{status.stdout[-2000:]}"
          f"{status.stderr[-2000:]}")
    rep = _report(str(run_dir), "--json")
    check(rep.returncode == 0, f"report --json: {rep.stderr[-2000:]}")
    slo = json.loads(rep.stdout).get("slo") or {}
    check(slo.get("alerts", {}).get("firings", 0) >= 2
          and slo["alerts"]["firing_now"] == [],
          f"report --json's slo section: {slo}")
    for line in status.stdout.splitlines()[:12]:
        print(f"[fleet] (f) ops status | {line}", flush=True)
    # the profile capture on replica1 (back from SIGSTOP)
    s, out = post(admin[1] + "/v1/debug/profile", {"action": "start"})
    check(s == 200, f"profile start: {s} {out}")
    for body in b["raw"][:8]:
        check(post(admin[1] + "/v1/weights", body, raw=True)[0] == 200,
              "replica1 does not serve under the profiler")
    s, out = post(admin[1] + "/v1/debug/profile", {"action": "stop"})
    check(s == 200, f"profile stop: {s} {out}")
    trace = json.loads(Path(out["trace"]).read_text())
    kernels = [e for e in trace.get("traceEvents", [])
               if e.get("cat") == "kernel"
               and "sdf_ffn_fwd" in str(e.get("name"))]
    check(kernels, "the profile's trace shows no sdf_ffn_fwd kernel on a "
                   "device lane")
    first = kernels[0] if kernels else {}
    s, _ = post(base + "/v1/debug/profile", {"action": "start"})
    check(s == 404, f"the shared port answered /v1/debug/profile {s}")
    print(f"[fleet] (f) ops status rc 0; report --json slo: firings "
          f"{slo['alerts']['firings']}, resolves {slo['alerts']['resolves']}"
          f", probe failures {slo['probe']['failures']}; /v1/debug/profile "
          f"on replica1's admin port: {len(kernels)} sdf_ffn_fwd kernels on "
          f"the device lane (first {str(first.get('name'))[:60]}, "
          f"{first.get('dur')} us), 404 on the shared port ({card})",
          flush=True)
    return det


def boot_autoscale_fleet(b):
    """(e)'s fleet: one replica under `--autoscale --max_replicas 2` on the
    pointer of (d), booted (a stop on exit registered in BACKGROUND);
    boot_fleet's (process, base url, admin urls, boot s)."""
    booted = boot_fleet(
        FLEET_DIR / "autoscale", 1, ["--pointer", str(FLEET_DIR / "ctl"),
                                     "--data_dir", str(DATA_DIR),
                                     "--stock_buckets",
                                     ",".join(map(str, b["buckets"])),
                                     "--batch_buckets", "1,4",
                                     *FLEET_AUTOSCALE])
    BACKGROUND.append(booted[0])
    return booted


def fleet_autoscale(b, capacity_rps, card, booted):
    """(e) a fleet booted at one replica with `--autoscale --max_replicas
    2` (`booted`: :func:`boot_autoscale_fleet`'s), driven by
    bench_loadadapt's swing (every 4th request bulk; the
    surge at 1.3× one replica's closed-loop capacity over distinct
    payloads: the larger of `capacity_rps`, (b)'s c = 32 measurement, and
    a c = 8 calibration on this fleet, below the scale-up depth — either
    alone can read low, host timing varies within a run): at least one
    scale-up and one scale-down, no interactive request dropped, bulk shed
    with 429s."""
    from deeplearninginassetpricing_paperreplication_torch.observability \
        .trace import read_jsonl
    from deeplearninginassetpricing_paperreplication_torch.serving import (
        read_fleet_json,
    )
    from deeplearninginassetpricing_paperreplication_torch.serving.loadgen \
        import loadadapt_swing, run_loadgen
    from deeplearninginassetpricing_paperreplication_torch.serving.server \
        import BINARY_CONTENT_TYPE

    run_dir = FLEET_DIR / "autoscale"
    proc, base, admin, boot_s = booted
    launches = 0
    try:
        raw = b["raw"] + b["alt"]

        def scales():
            rows = read_jsonl(run_dir / "events.autoscaler.jsonl")
            acts = [r.get("action") for r in rows
                    if r.get("name") == "fleet/scale"]
            return acts.count("up"), acts.count("down")

        # the bucket-4 shapes' first flushes, then the calibration, both
        # below the scale-up depth
        run_loadgen(base + "/v1/weights", lambda i: raw[i % len(raw)],
                    mode="closed", concurrency=4, n_requests=48,
                    warmup_requests=0, content_type=BINARY_CONTENT_TYPE)
        cal = run_loadgen(base + "/v1/weights", lambda i: raw[i % len(raw)],
                          mode="closed", concurrency=8, n_requests=320,
                          warmup_requests=0,
                          content_type=BINARY_CONTENT_TYPE)
        sw = loadadapt_swing(
            base + "/v1/weights", lambda i: raw[i % len(raw)], None,
            lambda i: "bulk" if i % 4 == 0 else "interactive",
            phase_s=FLEET_SWING_S, surge_factor=1.3,
            content_type=BINARY_CONTENT_TYPE,
            capacity_rps=max(capacity_rps, cal["throughput_rps"]))
        # a replica the autoscaler is draining may no longer answer
        peak = {}
        for url in (read_fleet_json(run_dir) or {}).get("admin_urls", []):
            try:
                peak[url] = _metrics(url)["batcher"]
            except OSError:
                peak[url] = {"mean_queue_depth": "(drained)"}
        print("[fleet] (e) after the swing, per replica: " + "; ".join(
            f"mean queue depth {m.get('mean_queue_depth')}, shed "
            f"{m.get('shed')}, rejected {m.get('rejected')}, flushes "
            f"{m.get('flushes')}" for m in peak.values()) + f" ({card})",
            flush=True)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 90:
            ups, downs = scales()
            layout = read_fleet_json(run_dir) or {}
            if downs >= 1 and layout.get("replicas") == 1:
                break
            time.sleep(0.25)
        settle_s = time.perf_counter() - t0
        ups, downs = scales()
        for url in (read_fleet_json(run_dir) or {}).get("admin_urls", []):
            launches += _metrics(url)["engine"]["kernel_launches"]
        run = sw["swing"]["run"]
        inter = run["by_class"].get("interactive") or {}
        bulk = run["by_class"].get("bulk") or {}
        check(ups >= 1 and downs >= 1,
              f"(e) scale-ups {ups}, scale-downs {downs}")
        check(inter.get("dropped") == 0,
              f"(e) {inter.get('dropped')} interactive requests dropped: "
              f"{inter.get('errors')}")
        check((bulk.get("n_shed_429") or 0) >= 1,
              f"(e) no bulk request shed: {bulk.get('errors')}")
        decisions = [r for r in read_jsonl(run_dir / "events.autoscaler"
                                           ".jsonl")
                     if r.get("name") == "fleet/scale"]
    finally:
        stop_fleet(proc)
    for step in sw["swing"]["steps"]:
        print(f"[fleet] (e) swing step {step['offered_rate_rps']} rps x "
              f"{step['duration_s']} s: {step['n_ok']}/{step['n_requests']} "
              f"ok, {_lat(step)}, errors {step['errors']} ({card})",
              flush=True)
    print(f"[fleet] (e) autoscale 1..2 replicas: boot {boot_s:.1f} s, "
          f"one replica's capacity {sw['capacity_rps']} rps (the larger of "
          f"(b)'s c=32 {capacity_rps} and c=8 here {cal['throughput_rps']}), "
          f"surge {sw['surge_rate']} / base {sw['base_rate']} rps; "
          f"scale-ups {ups}, scale-downs {downs} ("
          + ", ".join(f"{r['action']} {r.get('reason') or ''}".strip()
                      for r in decisions)
          + f"); interactive {inter.get('n_ok')}/{inter.get('n_requests')} "
          f"ok (dropped {inter.get('dropped')}), bulk shed 429 "
          f"{bulk.get('n_shed_429')} of {bulk.get('n_requests')}; retried "
          f"{run['n_retried']}; back to 1 replica {settle_s:.1f} s after "
          f"the swing ({card})", flush=True)
    return launches


def fleet_phase(torch, card, splits, ref, member_dirs):
    """(15) The serving fleet under load: the paper-width 3-member ensemble
    (`ref_runs`, f32, stock buckets of the test panel's requests, batch
    buckets 1 and 4) served by the serving CLI's supervised replicas on
    one SO_REUSEPORT port, boot from a promotion pointer. A 2-replica
    fleet runs (a) answers, (b) load, (c) a kill, (d) a rolling reload and
    (f) the SLO drills, console and profile; a 1-replica fleet with the
    autoscaler runs (e). Returns the replicas' sdf_ffn_fwd launches (the
    live incarnations' at each fleet's end; a killed one's are lost)."""
    t_phase = time.perf_counter()
    test = splits[2]
    b = fleet_bodies(test)
    ctl, gen2 = fleet_members(torch, member_dirs)
    run_dir = FLEET_DIR / "fleet"
    common = ["--pointer", str(ctl), "--data_dir", str(DATA_DIR),
              "--stock_buckets", ",".join(map(str, b["buckets"])),
              "--batch_buckets", "1,4"]
    n_buckets = 2 * len(b["buckets"])
    proc, base, admin, boot_s = boot_fleet(run_dir, 2, common)
    launches = 0
    try:
        print(f"[fleet] 2 replicas on {base} (SO_REUSEPORT), admin "
              f"{admin}: booted in {boot_s:.1f} s (both together: the "
              f"supervised CLI parent, torch, the panel, {n_buckets} CUDA "
              f"graphs each, f32, stock buckets {b['buckets']}) ({card})",
              flush=True)
        pids = replica_pids(run_dir)
        check(sorted(pids) == [0, 1], f"replica processes {pids}")
        fleet_context_check(proc, pids, card)
        t0 = time.perf_counter()
        worst = fleet_answers(base, admin, test, ref, b)
        print(f"[fleet] (a) {test.T} months x (raw-f32, base64), c = 1: bit "
              f"for bit phase 4's batch-1 answers; {4 * test.T} raw-f32 "
              f"requests from {FLEET_C} clients within the f32 bar of the "
              f"offline weights (max|d| {worst:.3e}); "
              f"{time.perf_counter() - t0:.1f} s ({card})", flush=True)
        load = fleet_load(base, admin, b, card)
        fleet_kill(base, admin, run_dir, b, load["cap"], n_buckets, card)
        fleet_reload(base, admin, ctl, gen2, b, load["cap"], card)
        # (e)'s fleet boots on (d)'s pointer while the drills of (f) run
        with ThreadPoolExecutor(max_workers=1) as pool:
            auto = pool.submit(boot_autoscale_fleet, b)
            fleet_slo(base, admin, run_dir, b, card)
            booted = auto.result()
        for url in admin:
            launches += _metrics(url)["engine"]["kernel_launches"]
    finally:
        stop_fleet(proc)
    check(proc.returncode == 0, f"the fleet parent exited {proc.returncode}")
    launches += fleet_autoscale(b, load["one"]["throughput_rps"], card,
                                booted)
    shutil.rmtree(FLEET_DIR, ignore_errors=True)
    print(f"[fleet] phase 15 done in {time.perf_counter() - t_phase:.1f} s; "
          f"sdf_ffn_fwd launches in the replicas {launches} ({card})",
          flush=True)
    return launches


JOINT_DIR = ROOT / "_smoke_joint"
JOINT_EPOCHS = 24
JOINT_PATIENCE = 3
JOINT_SEED = 42
JOINT_DROPOUT = 0.05
SIMPLE_HIDDEN = (32, 16)  # train_simple_sdf's default widths
SIMPLE_DROPOUT = 0.1  # and its default dropout
SIMPLE_EPOCHS = 24
# the plain SimpleSDF runs that measure its trajectory's rounding noise:
# (layer, sign) of a 2^-23 relative change of that layer's initial weights
SIMPLE_PERTURBATIONS = (("fc_layers", 1), ("fc_layers", -1),
                        ("output_proj", 1), ("output_proj", -1))
LOSS_BAR, SHARPE_BAR = 1e-3, 5e-3  # PERF.md §2: loss rel, Sharpe abs
SUMMARY_SHARPE_TOL = 1e-6
# launches per epoch, (sdf_ffn_fwd, sdf_ffn_bwd, cond_em_fwd, cond_em_bwd):
# joint: the training forward and its one backward (cond_em_bwd gives
# dzp_m, dxr and dk_stock in that launch; no panel cotangent), then the
# eval forward; SimpleSDF: the training forward and backward, then the
# eval forwards on train and valid
JOINT_PER_EPOCH = (2, 1, 2, 1)
SIMPLE_PER_EPOCH = (3, 1, 0, 0)
JAX_RUN_DIRS = ("tests/fixtures/jax_run_msgpack", "tests/fixtures/jax_run_pt")


def plateau_decisions(torch, J, valid_sharpe):
    """Replay the plateau rule over a history's valid Sharpes with the
    trainer's own f32 step: per epoch (improved?, margin), the margin
    |metric - best·(1 + 1e-4)| relative to |metric|."""
    best = torch.tensor(-np.inf, dtype=torch.float32)
    bad = torch.tensor(0, dtype=torch.int32)
    scale = torch.tensor(1.0, dtype=torch.float32)
    out = []
    for m in valid_sharpe:
        m = torch.tensor(m, dtype=torch.float32)
        thr = best * (1.0 + J.PLATEAU_THRESHOLD)
        out.append((bool(m > thr),
                    float((m - thr).abs() / m.abs().clamp_min(1e-12))))
        scale, best, bad = J._plateau_update(scale, best, bad, m, 0.5,
                                             JOINT_PATIENCE,
                                             J.PLATEAU_THRESHOLD)
    return out


def compare_joint_histories(torch, J, on, off, what):
    """The kernel route's joint history against the plain route's. The lr
    traces must be equal, unless the epoch where the two routes' plateau
    decisions first part has a margin |metric - best·(1 + 1e-4)| below the
    Sharpe bar (5e-3 of |metric|): then that epoch and its margin are
    printed and the histories compared up to it (its lr excluded). Losses
    rel 1e-3, Sharpes abs 5e-3, every compared epoch. Returns (epochs
    compared, max loss rel dev, max Sharpe dev)."""
    n = len(off["lr"])
    upto, lr_upto = n, n
    if not np.array_equal(on["lr"], off["lr"]):
        d_on = plateau_decisions(torch, J, on["valid_sharpe"])
        d_off = plateau_decisions(torch, J, off["valid_sharpe"])
        parted = [e for e in range(n) if d_on[e][0] != d_off[e][0]]
        check(bool(parted), f"{what}: the lr traces differ with the same "
              f"plateau decisions ({on['lr']} vs {off['lr']})")
        e = parted[0]
        margin = min(d_on[e][1], d_off[e][1])
        check(margin < SHARPE_BAR,
              f"{what}: the plateau decisions part at epoch {e} with margin "
              f"{margin:.3e} >= {SHARPE_BAR}")
        print(f"[joint] {what}: plateau decisions part at epoch {e}, margin "
              f"{margin:.3e} of |metric| (< {SHARPE_BAR}): histories "
              f"compared through epoch {e}", flush=True)
        upto, lr_upto = e + 1, e
    check(np.array_equal(on["lr"][:lr_upto], off["lr"][:lr_upto]),
          f"{what}: lr traces differ before the plateau decisions part")
    dev_loss, dev_sharpe = _devs(on, off, ("train_loss", "valid_loss"),
                                 ("train_sharpe", "valid_sharpe"), upto)
    check(dev_loss <= LOSS_BAR, f"{what}: kernel vs plain loss rel dev "
          f"{dev_loss:.3e} > {LOSS_BAR}")
    check(dev_sharpe <= SHARPE_BAR, f"{what}: kernel vs plain Sharpe dev "
          f"{dev_sharpe:.3e} > {SHARPE_BAR}")
    return upto, dev_loss, dev_sharpe


def _finite(hist) -> bool:
    return all(bool(np.isfinite(v).all()) for v in hist.values())


def joint_training_checks(torch, K, C, card, splits):
    """(a) joint_train at full width (the paper's model) on phase 6's
    panel: f32 dropout 0 on the kernel route against kernel="off" (launches
    counted on the kernel run), then dropout 0.05 on the kernel route, two
    f32 runs bit for bit and one bf16, every value finite. Returns the
    launches {name: n}."""
    from deeplearninginassetpricing_paperreplication_torch.models.gan import (
        GAN,
    )
    from deeplearninginassetpricing_paperreplication_torch.models.networks \
        import init_member_params
    from deeplearninginassetpricing_paperreplication_torch.training import (
        joint as J,
    )
    from deeplearninginassetpricing_paperreplication_torch.utils.config \
        import ExecutionConfig, GANConfig

    train, valid, _ = splits
    batches = [ds.to_batch(DEVICE) for ds in (train, valid)]

    def cfg_of(dropout):
        return GANConfig(macro_feature_dim=train.macro_feature_dim,
                         individual_feature_dim=train.individual_feature_dim,
                         dropout=dropout)

    init = {k: v[0] for k, v in init_member_params(
        cfg_of(0.0), [JOINT_SEED]).items()}

    def run(kernel, cd, dropout, epochs=JOINT_EPOCHS):
        gan = GAN.from_state_dict(cfg_of(dropout), init, ExecutionConfig(
            kernel=kernel, compute_dtype=cd, bf16_panel=False, device=DEVICE))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = J.joint_train(gan, *batches, num_epochs=epochs, lr=1e-3,
                             plateau_patience=JOINT_PATIENCE,
                             seed=JOINT_SEED)
        ms = (time.perf_counter() - t0) * 1e3 / epochs
        return hist, ms, {k: v.detach().clone()
                          for k, v in gan.module.state_dict().items()}

    for kernel in ("on", "off"):  # set-up: library loads, first allocations
        run(kernel, "float32", 0.0, epochs=1)
    K.reset_launch_count()
    C.reset_launch_count()
    on, on_ms, _ = run("on", "float32", 0.0)
    launches = counts(K, C)
    K.reset_launch_count()
    C.reset_launch_count()
    off, off_ms, _ = run("off", "float32", 0.0)
    check(counts(K, C) == (0, 0, 0, 0), "kernel='off' joint_train launched "
          "a kernel")
    want = tuple(JOINT_EPOCHS * v for v in JOINT_PER_EPOCH)
    check(launches == want, f"joint_train launches (fwd, bwd, cem_fwd, "
          f"cem_bwd) {launches} != {want}")
    check(_finite(on) and _finite(off), "non-finite joint_train history")
    upto, dev_loss, dev_sharpe = compare_joint_histories(
        torch, J, on, off, "joint f32 dropout 0")
    print(f"[joint] joint_train full width F={train.individual_feature_dim} "
          f"M={train.macro_feature_dim} N={train.N} T={train.T}/{valid.T}, "
          f"hidden [64, 64], LSTM [4], K=8, {JOINT_EPOCHS} epochs, patience "
          f"{JOINT_PATIENCE}, seed {JOINT_SEED}, f32 dropout 0: kernel vs "
          f"plain over {upto} epochs: max loss rel dev {dev_loss:.3e} (bar "
          f"{LOSS_BAR}), max Sharpe dev {dev_sharpe:.3e} (bar {SHARPE_BAR});"
          f" lr {on['lr'][0]:.3e} -> {on['lr'][-1]:.3e} (plain "
          f"{off['lr'][-1]:.3e}); final valid Sharpe kernel "
          f"{on['valid_sharpe'][-1]:.6f} plain {off['valid_sharpe'][-1]:.6f}"
          f" ({card})", flush=True)
    print(f"[joint] launches (fwd, bwd, cem_fwd, cem_bwd) {launches} = "
          f"{JOINT_EPOCHS} epochs x {JOINT_PER_EPOCH}; wall ms per epoch "
          f"kernel {on_ms:.2f}, plain {off_ms:.2f} ({card})", flush=True)
    d1, d1_ms, p1 = run("on", "float32", JOINT_DROPOUT)
    d2, _, p2 = run("on", "float32", JOINT_DROPOUT)
    bf, bf_ms, pb = run("on", "bfloat16", JOINT_DROPOUT)
    check(_finite(d1) and _finite(bf)
          and all(bool(torch.isfinite(v).all()) for v in pb.values()),
          "non-finite joint_train with dropout")
    check(all(np.array_equal(d1[k], d2[k]) for k in d1)
          and all(torch.equal(p1[k], p2[k]) for k in p1),
          "joint_train with dropout 0.05 (f32) not bit for bit from one "
          "seed")
    print(f"[joint] dropout {JOINT_DROPOUT}, kernel route: f32 twice bit "
          f"for bit, bf16 finite; final valid Sharpe f32 "
          f"{d1['valid_sharpe'][-1]:.6f} bf16 {bf['valid_sharpe'][-1]:.6f};"
          f" wall ms per epoch f32 {d1_ms:.2f}, bf16 {bf_ms:.2f} ({card})",
          flush=True)
    return dict(zip(TRAIN_KERNELS, launches)), dict(
        kernel_ms=on_ms, plain_ms=off_ms, dropout_f32_ms=d1_ms,
        dropout_bf16_ms=bf_ms)


def _devs(a, b, keys_loss, keys_sharpe, upto=None):
    """(max loss rel dev, max Sharpe abs dev) of two histories over the
    epochs [:upto]."""
    sl = slice(None, upto)
    loss = max(float(np.max(np.abs(a[k][sl] - b[k][sl])
                            / np.maximum(np.abs(b[k][sl]), 1e-12)))
               for k in keys_loss)
    sh = max(float(np.max(np.abs(a[k][sl] - b[k][sl]))) for k in keys_sharpe)
    return loss, sh


def simple_sdf_checks(torch, K, C, card, splits):
    """(b) train_simple_sdf at full width: input [macro 178, individual 46],
    hidden (32, 16) (the w32 library). Dropout 0, f32: the kernel route
    against kernel="off" (launches counted on the kernel run). The first
    epoch at the training bars (loss rel 1e-3, Sharpe abs 5e-3). Over all
    24 epochs this baseline's trajectory is chaotic (its loss falls ~60×
    toward 0): a 2^-23 relative change of the plain run's initial weights
    moves it about as far as the kernel route does
    (tools/simple_sdf_sensitivity.py). So the whole history is held to
    max(the bars, 4 × the largest deviation of four such perturbed plain
    runs, SIMPLE_PERTURBATIONS): the kernel route departs from the plain
    route by no more than the plain route's rounding noise does. Then dropout 0.1 on
    the kernel route twice: finite and bit for bit. Returns the launches."""
    from deeplearninginassetpricing_paperreplication_torch.models.networks \
        import SimpleSDF, init_params
    from deeplearninginassetpricing_paperreplication_torch.training import (
        joint as J,
    )
    from deeplearninginassetpricing_paperreplication_torch.utils.config \
        import ExecutionConfig

    train, valid, _ = splits
    batches = [ds.to_batch(DEVICE) for ds in (train, valid)]
    M, F = train.macro_feature_dim, train.individual_feature_dim
    losses, sharpes = ("train_loss", "valid_loss"), ("train_sharpe",
                                                     "valid_sharpe")

    def exec_of(kernel):
        return ExecutionConfig(kernel=kernel, compute_dtype="float32",
                               bf16_panel=False, device=DEVICE)

    def run(kernel, dropout, epochs=SIMPLE_EPOCHS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, hist = J.train_simple_sdf(
            M, F, *batches, hidden_dims=SIMPLE_HIDDEN, dropout=dropout,
            num_epochs=epochs, lr=1e-3, seed=JOINT_SEED,
            exec_cfg=exec_of(kernel))
        ms = (time.perf_counter() - t0) * 1e3 / epochs
        return hist, ms, {k: v.detach().clone()
                          for k, v in model.state_dict().items()}

    for kernel in ("on", "off"):
        run(kernel, 0.0, epochs=1)
    K.reset_launch_count()
    C.reset_launch_count()
    on, on_ms, _ = run("on", 0.0)
    launches = counts(K, C)
    K.reset_launch_count()
    off, off_ms, _ = run("off", 0.0)
    # the plain route's own rounding noise: its first or its output
    # layer's initial weights scaled by 1 ± 2^-23, the same seeds otherwise
    perturbed = []
    for layer, sign in SIMPLE_PERTURBATIONS:
        noisy = SimpleSDF(M, F, SIMPLE_HIDDEN, 0.0, exec_of("off"))
        init_params(noisy, torch.Generator().manual_seed(JOINT_SEED))
        with torch.no_grad():
            getattr(noisy, layer).get_parameter(
                "0.weight" if layer == "fc_layers" else "weight").mul_(
                1.0 + sign * 2.0 ** -23)
        noisy.to(DEVICE)
        perturbed.append(J.fit_simple_sdf(
            noisy, *batches, num_epochs=SIMPLE_EPOCHS, lr=1e-3,
            seed=JOINT_SEED))
    check(counts(K, C) == (0, 0, 0, 0), "kernel='off' SimpleSDF launched "
          "a kernel")
    want = tuple(SIMPLE_EPOCHS * v for v in SIMPLE_PER_EPOCH)
    check(launches == want, f"train_simple_sdf launches (fwd, bwd, cem_fwd,"
          f" cem_bwd) {launches} != {want}")
    check(_finite(on) and _finite(off), "non-finite SimpleSDF history")
    first = _devs(on, off, losses, sharpes, upto=1)
    check(first[0] <= LOSS_BAR and first[1] <= SHARPE_BAR,
          f"SimpleSDF kernel vs plain after one epoch: loss rel dev "
          f"{first[0]:.3e}, Sharpe dev {first[1]:.3e}")
    dev = _devs(on, off, losses, sharpes)
    spreads = [_devs(h, off, losses, sharpes) for h in perturbed]
    noise = (max(d[0] for d in spreads), max(d[1] for d in spreads))
    bars = (max(LOSS_BAR, 4 * noise[0]), max(SHARPE_BAR, 4 * noise[1]))
    check(dev[0] <= bars[0] and dev[1] <= bars[1],
          f"SimpleSDF kernel vs plain over {SIMPLE_EPOCHS} epochs: loss rel "
          f"dev {dev[0]:.3e}, Sharpe dev {dev[1]:.3e} against bars "
          f"{bars[0]:.3e} / {bars[1]:.3e} (the plain route's 2^-23 "
          f"perturbations move it up to {noise[0]:.3e} / {noise[1]:.3e})")
    d1, d_ms, p1 = run("on", SIMPLE_DROPOUT)
    d2, _, p2 = run("on", SIMPLE_DROPOUT)
    check(_finite(d1) and all(np.array_equal(d1[k], d2[k]) for k in d1)
          and all(torch.equal(p1[k], p2[k]) for k in p1),
          f"SimpleSDF with dropout {SIMPLE_DROPOUT}: non-finite, or not bit "
          "for bit from one seed")
    print(f"[simple_sdf] train_simple_sdf input [macro {M}, individual {F}] "
          f"hidden {list(SIMPLE_HIDDEN)}, {SIMPLE_EPOCHS} epochs, f32 "
          f"dropout 0, kernel vs plain: epoch 1 loss rel dev {first[0]:.3e},"
          f" Sharpe dev {first[1]:.3e} (bars {LOSS_BAR} / {SHARPE_BAR}); "
          f"all epochs {dev[0]:.3e} / {dev[1]:.3e} against the plain "
          f"route's own 2^-23 perturbations "
          f"{[(float(f'{a:.3e}'), float(f'{b:.3e}')) for a, b in spreads]} "
          f"(bars {bars[0]:.3e} / {bars[1]:.3e}); train loss "
          f"{off['train_loss'][0]:.4e} -> {off['train_loss'][-1]:.4e}; "
          f"final valid Sharpe kernel {on['valid_sharpe'][-1]:.6f} plain "
          f"{off['valid_sharpe'][-1]:.6f} ({card})", flush=True)
    print(f"[simple_sdf] launches {launches} = {SIMPLE_EPOCHS} x "
          f"{SIMPLE_PER_EPOCH}; dropout {SIMPLE_DROPOUT} twice bit for bit; "
          f"wall ms per epoch kernel {on_ms:.2f}, plain {off_ms:.2f}, "
          f"dropout {d_ms:.2f} ({card})", flush=True)
    return dict(zip(TRAIN_KERNELS, launches)), dict(
        kernel_ms=on_ms, plain_ms=off_ms, dropout_ms=d_ms,
        dev=dev, noise=noise, spreads=spreads)


def jax_run_dir_checks(torch, card):
    """(c) The JAX package's run dirs checked in under tests/fixtures/ (the
    paper-width model as flax .msgpack, and its .pt twin): read without
    msgpack or JAX (the port imports neither; the line says which of them
    this machine has), the .msgpack state_dict is the .pt one bit for bit,
    and evaluate_ensemble gives bit-for-bit metrics on both."""
    from deeplearninginassetpricing_paperreplication_torch.evaluate_ensemble \
        import evaluate_ensemble
    from deeplearninginassetpricing_paperreplication_torch.training \
        .checkpoint import load_checkpoint_dir
    from deeplearninginassetpricing_paperreplication_torch.utils.config \
        import ExecutionConfig

    import importlib.util
    importable = [m for m in ("msgpack", "jax", "flax")
                  if importlib.util.find_spec(m) is not None]
    dirs = [str(ROOT / d) for d in JAX_RUN_DIRS]
    (cm, sdm), (cp, sdp) = (load_checkpoint_dir(d) for d in dirs)
    check(cm == cp and list(sdm) == list(sdp)
          and all(torch.equal(sdm[k], sdp[k]) for k in sdp),
          "the JAX run dir's .msgpack does not load to its .pt twin bit for "
          "bit")
    res = [evaluate_ensemble([d], str(DATA_DIR), exec_cfg=ExecutionConfig(
        device=DEVICE), verbose=False) for d in dirs]
    check(res[0] == res[1], f"evaluate_ensemble on the JAX .msgpack run dir "
          f"{res[0]} != on its .pt twin {res[1]}")
    print(f"[jax_run] {JAX_RUN_DIRS[0]}: {len(sdm)} tensors bit for bit the "
          f".pt twin's; evaluate_ensemble (bf16 kernel) test Sharpe "
          f"{res[0]['test_sharpe']:.6f} on both, bit for bit; importable of "
          f"msgpack/jax/flax here: {importable or 'none'} ({card})",
          flush=True)


def figure_checks(torch, K, card, splits, cfg, stacked):
    """(d) summary_statistics on nine member run dirs (one sdf_ffn_fwd
    launch at S = 9, counted) against evaluate_ensemble on the same dirs:
    sharpe_monthly and test_sharpe are both mean/std (ddof 0) of the
    NEGATED ensemble portfolio return (the paper's sign), so they agree to
    |d| <= 1e-6. Then the plots CLI: without matplotlib it must exit
    non-zero naming it; with matplotlib it must write the seven figures
    (a short diag_stride run dir first). Returns the launches."""
    from deeplearninginassetpricing_paperreplication_torch import plots
    from deeplearninginassetpricing_paperreplication_torch.evaluate_ensemble \
        import evaluate_ensemble
    from deeplearninginassetpricing_paperreplication_torch.training \
        .checkpoint import member_state_dicts, save_state_dict
    from deeplearninginassetpricing_paperreplication_torch.utils.config \
        import ExecutionConfig

    import importlib.util
    dirs = []
    for seed, sd in zip(ENSEMBLE_SEEDS, member_state_dicts(stacked)):
        d = JOINT_DIR / "members" / f"seed_{seed}"
        d.mkdir(parents=True)
        cfg.save(d / "config.json")
        save_state_dict(d / "best_model_sharpe.pt", sd)
        dirs.append(str(d))
    exec_cfg = ExecutionConfig(device=DEVICE)
    plots.summary_statistics(dirs, str(DATA_DIR), exec_cfg=exec_cfg)  # warm
    torch.cuda.synchronize()
    K.reset_launch_count()
    t0 = time.perf_counter()
    stats = plots.summary_statistics(dirs, str(DATA_DIR), exec_cfg=exec_cfg)
    summary_ms = (time.perf_counter() - t0) * 1e3
    n = K.launches
    check(n == 1, f"summary_statistics launched sdf_ffn_fwd {n} times, not "
          "once for the nine members")
    res = evaluate_ensemble(dirs, str(DATA_DIR), exec_cfg=exec_cfg,
                            verbose=False)
    d = abs(stats["sharpe_monthly"] - res["test_sharpe"])
    check(all(np.isfinite(v) for v in stats.values()),
          f"non-finite summary statistics {stats}")
    check(d <= SUMMARY_SHARPE_TOL, f"summary_statistics sharpe_monthly "
          f"{stats['sharpe_monthly']} vs evaluate_ensemble test_sharpe "
          f"{res['test_sharpe']}: |d| {d:.3e} > {SUMMARY_SHARPE_TOL}")
    print(f"[figures] summary_statistics of {len(dirs)} members (bf16 "
          f"kernel, S = {len(dirs)}): Sharpe monthly "
          f"{stats['sharpe_monthly']:.6f} (negated ensemble return, ddof 0) "
          f"vs evaluate_ensemble test {res['test_sharpe']:.6f}: |d| "
          f"{d:.2e}; annual {stats['sharpe_annual']:.4f}, max drawdown "
          f"{stats['max_drawdown']:.4f}, EV {stats['explained_variation']:.4f}"
          f"; one launch, {summary_ms:.1f} ms ({card})", flush=True)
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    figs = JOINT_DIR / "figs"
    if has_mpl:
        from deeplearninginassetpricing_paperreplication_torch.training \
            .trainer import train_3phase
        from deeplearninginassetpricing_paperreplication_torch.utils.config \
            import TrainConfig
        run_dir = JOINT_DIR / "run"
        train_3phase(cfg, *[ds.to_batch(DEVICE) for ds in splits],
                     tcfg=TrainConfig(2, 1, 2, ignore_epoch=0, seed=1),
                     save_dir=str(run_dir), verbose=False,
                     exec_cfg=exec_cfg, diag_stride=1)
        dirs = [str(run_dir)] + dirs
    proc = subprocess.run(
        [sys.executable, "-m", f"{PKG}.plots", "--data_dir", str(DATA_DIR),
         "--checkpoint_dirs", *dirs, "--output_dir", str(figs),
         "--device", DEVICE],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    if has_mpl:
        written = sorted(p.name for p in figs.glob("*.png"))
        check(proc.returncode == 0 and len(written) == 7,
              f"plots CLI with matplotlib: rc {proc.returncode}, wrote "
              f"{written}: {proc.stderr[-2000:]}")
        print(f"[figures] plots CLI wrote {len(written)} figures ({card})",
              flush=True)
    else:
        check(proc.returncode != 0 and "matplotlib" in proc.stderr
              and not figs.exists(),
              f"plots CLI without matplotlib: rc {proc.returncode}, stderr "
              f"{proc.stderr[-2000:]!r}")
        print(f"[figures] no matplotlib here: the plots CLI exits "
              f"{proc.returncode} with {proc.stderr.strip().splitlines()[-1]!r}"
              f" ({card})", flush=True)
    return {"sdf_ffn_fwd": n}, summary_ms


def joint_phase(torch, K, C, card, splits, members=None):
    """Phase 16 on phase 6's panel: (a) joint_train, (b) train_simple_sdf,
    (c) the JAX run dirs, (d) the figures on `members` ((cfg, stacked):
    phase 7's nine; seeded stand-ins without). Returns its launches by path
    and numbers for the kernels line."""
    t0 = time.perf_counter()
    shutil.rmtree(JOINT_DIR, ignore_errors=True)
    try:
        joint_launches, joint_ms = joint_training_checks(torch, K, C, card,
                                                         splits)
        simple_launches, simple_ms = simple_sdf_checks(torch, K, C, card,
                                                       splits)
        jax_run_dir_checks(torch, card)
        if members is None:
            from deeplearninginassetpricing_paperreplication_torch.parallel \
                .ensemble import init_ensemble_params
            from deeplearninginassetpricing_paperreplication_torch.utils \
                .config import GANConfig
            cfg = GANConfig.load(ROOT / REF_RUNS[0] / "config.json")
            members = (cfg, init_ensemble_params(cfg, ENSEMBLE_SEEDS))
        plots_launches, summary_ms = figure_checks(torch, K, card, splits,
                                                   *members)
    finally:
        shutil.rmtree(JOINT_DIR, ignore_errors=True)
    wall = time.perf_counter() - t0
    print(f"[joint] phase 16 done in {wall:.1f} s ({card})", flush=True)
    return dict(joint_training=joint_launches,
                simple_sdf_training=simple_launches,
                plots_summary=plots_launches, wall_s=wall,
                joint_ms=joint_ms, simple_ms=simple_ms,
                summary_ms=summary_ms)


def joint_kernel_checks(torch, K, C, card):
    """The training kernels against their plain versions at phase 16's own
    shapes that phase 3 does not hold: sdf_ffn_fwd and sdf_ffn_bwd at
    SimpleSDF's hidden (32, 16), S = 1, T = 48, N = 10,000, f32, dropout 0
    and 0.1 (the w32 library). Returns {kernel: row} at dropout 0."""
    fwd = wide_checks(torch, K, card, "fwd", hiddens=[SIMPLE_HIDDEN],
                      shapes=[(1, 48, 10000)], dtypes=("float32",), rate=0.0)
    wide_checks(torch, K, card, "fwd", hiddens=[SIMPLE_HIDDEN],
                shapes=[(1, 48, 10000)], dtypes=("float32",),
                rate=SIMPLE_DROPOUT)
    bwd = ffn_bwd_checks(torch, K, card, SIMPLE_HIDDEN, [(1, 48, 10000)],
                         dtypes=("float32",), rates=(0.0, SIMPLE_DROPOUT))
    return {"sdf_ffn_fwd": next(iter(fwd.values())),
            "sdf_ffn_bwd": bwd[(1, 48, 10000, "float32", 0.0)]}


# -- phase 17 -----------------------------------------------------------------

SHARD_DIR = ROOT / "_smoke_shard"
# stock offsets beside the ranks' own span starts: rank 1's at N = 10,000
# over two ranks, and one past 2^31 (the hash adds it in uint32)
SHARD_OFFSETS = (5000, 1 << 31)
SHARD_READ_STOCKS = 64  # the backward's mask readout: stocks per launch
# per rank and CLI run, beside the epochs' PER_EPOCH: the final evals of
# train, valid and test and the health pass, (fwd, bwd, cem_fwd, cem_bwd)
SHARD_CLI_EXTRA = (4, 0, 4, 0)


def _mask_readouts(torch, K, T, N, seed, offset, rate=DROPOUT, H=64, F=46):
    """The FFN kernels' dropout masks at `offset`, read from their own
    outputs, against ``dropout_keep`` at that offset: the forward's unit j
    as member j's output (k1T = 0 and zp = 1 make every first-layer unit 1
    before dropout; a second layer W = 0, b = 1 the same), the panel
    cotangent's as feature j of dx (F = H, K1 = I, x = 0, g = 1; a second
    layer W = I, b = 1 gives both layers' masks), the backward's at
    SHARD_READ_STOCKS stocks as member s's dzp with g = 1 on stock n_s
    only. Every product in them is a single term, so a kept unit is exactly
    nonzero. Returns the units compared."""
    dev = torch.device(DEVICE)
    ones = lambda *sh: torch.ones(*sh, device=dev)  # noqa: E731
    zeros = lambda *sh: torch.zeros(*sh, device=dev)  # noqa: E731
    keep = [K.dropout_keep(seed, rate, layer, 1, T, H, N, dev,
                           offset)[0] for layer in (0, 1)]  # [T, H, N]
    both = keep[0] & keep[1]
    n = 0
    # forward: H members, one seed, member j reads unit j
    x = torch.randn(T, F, N, device=dev)
    for layer in (0, 1):
        mids = [(zeros(H, H, H), ones(H, H))] if layer else []
        packed = K.pack_ffn(zeros(H, H, F), mids, torch.eye(H, device=dev),
                            zeros(H), "float32")
        w = K._launch(x, ones(H, T, H), packed, [seed] * H, rate, offset)
        check(torch.equal(w != 0, keep[layer].permute(1, 0, 2)),
              f"sdf_ffn_fwd masks of layer {layer} at offset {offset} (T={T}"
              f" N={N} seed {seed}) differ from dropout_keep")
        n += w.numel()
    # panel cotangent: F = H features, dx feature j reads unit j
    for layer in (0, 1):
        mids = [(torch.eye(H, device=dev)[None], ones(1, H))] if layer else []
        packed = K.pack_ffn(torch.eye(H, device=dev)[None], mids, ones(1, H),
                            zeros(1), "float32")
        dx = K._launch_dx(zeros(T, H, N), ones(1, T, H), packed,
                          ones(1, T, N), seed, rate, offset=offset)
        check(torch.equal(dx != 0, keep[0] if layer == 0 else both),
              f"sdf_ffn_dx masks (layers 0..{layer}) at offset {offset} "
              f"(T={T} N={N} seed {seed}) differ from dropout_keep")
        n += dx.numel()
    # backward: member s's dzp reads stock n_s
    S = SHARD_READ_STOCKS
    cols = torch.linspace(0, N - 1, S, device=dev).round().long()
    g = zeros(S, T, N)
    g[torch.arange(S, device=dev), :, cols] = 1.0
    for layer in (0, 1):
        mids = ([(torch.eye(H, device=dev).expand(S, H, H).contiguous(),
                  ones(S, H))] if layer else [])
        packed = K.pack_ffn(zeros(S, H, F), mids, ones(S, H), zeros(S),
                            "float32")
        _, dzp = K._launch_bwd(x, ones(S, T, H), packed, g, [seed] * S,
                               rate, offset=offset)  # [S, T, H]
        want = (keep[0] if layer == 0 else both)[:, :, cols].permute(2, 0, 1)
        check(torch.equal(dzp != 0, want),
              f"sdf_ffn_bwd masks (layers 0..{layer}) at offset {offset} "
              f"(T={T} N={N} seed {seed}, stocks {S}) differ from "
              "dropout_keep")
        n += dzp.numel()
    return n


def shard_world(torch) -> int:
    """The ranks of phase 17's (b) and (c): four, NCCL with a card each,
    on a host of four cards or more; else two gloo ranks sharing card 0."""
    return 4 if torch.cuda.device_count() >= 4 else 2


def _fwd_plan(torch, K, lay, S, T, N):
    """The f32 forward's plan at (S, T, N) and what the card makes of it;
    fails if the card holds fewer blocks resident than planned or the
    kernel spills."""
    plan = K.card_fwd_plan(lay, torch.device(DEVICE), S, T, N, "float32")
    info = K.fwd_plan_info(lay, S, plan)
    check(info["blocks_per_sm"] >= plan.blocks_per_sm
          and info["local_bytes"] == 0,
          f"sdf_ffn_fwd plan {plan}: the card holds "
          f"{info['blocks_per_sm']} blocks per SM, local "
          f"{info['local_bytes']} B")
    return dict(route=plan.route, tile=plan.tile, threads=plan.threads,
                members=plan.members, smem_bytes=plan.smem_bytes,
                blocks_per_sm_planned=plan.blocks_per_sm,
                blocks_per_sm=info["blocks_per_sm"], G=plan.G,
                cells=plan.cells, registers=info["registers"],
                local_bytes=info["local_bytes"])


def _cem_plan(torch, C, S, T, N, F, Kn):
    """The f32 conditional-EM forward's and backward's plans at (S, T, N)
    and what the card makes of them; fails as cem_plan_lines does."""
    out = {}
    for p in C.card_cem_plan(torch.device(DEVICE), S, T, N, F, Kn,
                             "float32"):
        info = C.plan_info(p, S, T, N, F, Kn, "float32")
        check(info["blocks_per_sm"] >= p.blocks_per_sm
              and info["local_bytes"] == 0,
              f"cond_em_{p.kernel} plan {p}: the card holds "
              f"{info['blocks_per_sm']} blocks per SM, local "
              f"{info['local_bytes']} B")
        out[p.kernel] = dict(route=p.route, tile=p.tile, members=p.members,
                             threads=p.threads, var=p.var, stages=p.stages,
                             smem_bytes=p.smem_bytes,
                             blocks_per_sm_planned=p.blocks_per_sm,
                             blocks_per_sm=info["blocks_per_sm"],
                             groups=p.groups, grid=list(p.grid),
                             registers=info["registers"],
                             local_bytes=info["local_bytes"])
    return out


def shard_kernel_checks(torch, K, C, card, world):
    """(d) The training kernels at the ranks' shape and the FFN kernels'
    dropout at a stock offset. The masks read out bit for bit
    ``dropout_keep`` at SHARD_OFFSETS (BWD_SHAPES' (T, N), the first and
    last of each shape's seeds) and at each rank's span start (the train
    split's T, N / world). Then the forward, backward and panel cotangent
    against their plain versions at those offsets and shapes (hidden
    (64, 64), F = 46, f32, dropout 0.05), each unlike its output at
    offset 0, and the conditional-EM forward and backward against theirs at
    the ranks' shape (K = 8, f32). Returns the rows of the four kernels the
    ranks launch, at their shape, with the plans the card holds."""
    t0 = time.perf_counter()
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(17)
    F, hidden, Kn = 46, [64, 64], 8
    T, n_r = PANEL["n_periods_train"], PANEL["n_stocks"] // world
    starts = [r * n_r for r in range(world)]
    units = 0
    for offset in SHARD_OFFSETS:
        for S, T_, N in BWD_SHAPES:
            for seed in sorted({7, 7 + S - 1}):
                units += _mask_readouts(torch, K, T_, N, seed, offset)
    for offset in starts[1:]:
        units += _mask_readouts(torch, K, T, n_r, 7, offset)
    print(f"[shard] dropout masks at stock offsets {SHARD_OFFSETS} "
          f"(BWD_SHAPES' (T, N)) and {starts[1:]} (T={T} N={n_r}, the ranks' "
          f"span starts): sdf_ffn_fwd (both layers, every unit), sdf_ffn_dx "
          f"(both layers) and sdf_ffn_bwd ({SHARD_READ_STOCKS} stocks a "
          f"launch) bit for bit dropout_keep; {units:,} units read ({card})",
          flush=True)
    rank_shape = (1, T, n_r)
    cases = ([(o, sh) for o in SHARD_OFFSETS for sh in BWD_SHAPES]
             + [(a, rank_shape) for a in starts])
    worst = [0.0, 0.0]  # the ranks' shape: fwd, bwd max|d| over the ranks
    rows = {}
    for offset, (S, T_, N) in cases:
        x = torch.randn(T_, F, N, generator=g, device=dev)
        zp1, k1T, mids, kout, bout = _ffn_params(torch, g, S, F, hidden, dev)
        zp = (zp1 + torch.randn(S, T_, hidden[0], generator=g,
                                device=dev) * 0.3).contiguous()
        gout = torch.randn(S, T_, N, generator=g, device=dev) / N
        seed = 7 if S == 1 else list(range(7, 7 + S))
        packed = K.pack_ffn(k1T, mids, kout, bout, "float32")
        args = (x, zp, k1T, mids, kout)
        w = K.sdf_ffn_packed(x, zp, packed, dropout_rate=DROPOUT, seed=seed,
                             offset=offset)
        w0 = K.sdf_ffn_packed(x, zp, packed, dropout_rate=DROPOUT, seed=seed)
        wr = K.sdf_ffn_reference(*args, bout, "float32", seed, DROPOUT,
                                 offset)
        grads, dzp = K._launch_bwd(x, zp, packed, gout, seed, DROPOUT,
                                   offset=offset)
        dk1T, dmids, dkout, dbout = K.unpack_grads(grads, packed.layout)
        r = K.sdf_ffn_bwd_reference(*args, gout, "float32", seed, DROPOUT,
                                    offset)
        dx = K._launch_dx(x, zp, packed, gout, seed, DROPOUT, offset=offset)
        dx0 = K._launch_dx(x, zp, packed, gout, seed, DROPOUT)
        dxr = K.sdf_ffn_dx_reference(*args, gout, "float32", seed, DROPOUT,
                                     offset)
        outs = [dzp, dk1T, dkout, dbout, *(t for wb in dmids for t in wb)]
        refs = [r[0], r[1], r[3], r[4], *(t for wb in r[2] for t in wb)]
        bwd_err = max(rel_err(o, q) for o, q in zip(outs, refs))
        errs = (rel_err(w, wr), bwd_err, rel_err(dx, dxr))
        check(errs[0] <= 1e-5 and errs[1] <= GRAD_F32_REL
              and errs[2] <= GRAD_F32_REL,
              f"offset {offset} S={S} T={T_} N={N}: kernel vs plain "
              f"max|d|/max|ref| fwd {errs[0]:.2e}, bwd {errs[1]:.2e}, "
              f"dx {errs[2]:.2e}")
        check(offset == 0 or (not torch.equal(w, w0)
                              and not torch.equal(dx, dx0)),
              f"offset {offset} S={S} T={T_} N={N}: the offset changed no "
              "mask")
        print(f"[shard] offset {offset} S={S} T={T_:2d} N={N:5d} f32 drop "
              f"{DROPOUT}: kernel vs plain max|d|/max|ref| fwd "
              f"{errs[0]:.2e}, bwd {errs[1]:.2e}, dx {errs[2]:.2e}"
              + ("" if offset == 0 else "; unlike offset 0")
              + f" ({card})", flush=True)
        if (S, T_, N) != rank_shape:
            continue
        worst[0] = max(worst[0], float((w - wr).abs().max()))
        worst[1] = max(worst[1], max(float((o - q).abs().max())
                                     for o, q in zip(outs, refs)))
        if offset != starts[-1]:
            continue
        # the last rank's launches at its own offset, timed beside the
        # plain versions; its plans as the card holds them
        shape = (f"S=1 T={T} N={n_r} F={F} hidden={hidden} float32 dropout "
                 f"{DROPOUT} offsets {starts}")
        for name, kern, plain, flops, nbytes, plan, reps in (
                ("sdf_ffn_fwd",
                 lambda: K.sdf_ffn_packed(x, zp, packed,
                                          dropout_rate=DROPOUT, seed=seed,
                                          offset=offset),
                 lambda: K.sdf_ffn_reference(*args, bout, "float32", seed,
                                             DROPOUT, offset),
                 K.flops, K.bytes_moved,
                 _fwd_plan(torch, K, packed.layout, *rank_shape), (20, 10)),
                ("sdf_ffn_bwd",
                 lambda: K._launch_bwd(x, zp, packed, gout, seed, DROPOUT,
                                       offset=offset),
                 lambda: K.sdf_ffn_bwd_reference(*args, gout, "float32",
                                                 seed, DROPOUT, offset),
                 K.bwd_flops, K.bwd_bytes_moved,
                 bwd_plan_of(torch, K, packed.layout, *rank_shape)[1],
                 (10, 5))):
            b_ms, b_by = bound(flops(1, T, n_r, F, hidden),
                               nbytes(1, T, n_r, F, hidden), "float32")
            rows[name] = dict(
                max_abs_err=worst[0 if name == "sdf_ffn_fwd" else 1],
                ms=cuda_ms(torch, kern, reps=reps[0]),
                plain_ms=cuda_ms(torch, plain, reps=reps[1]),
                bound_ms=b_ms, bound_by=b_by, plan=plan, shape=shape)
    cem = cond_em_checks(torch, C, card, Ks=(Kn,), shapes=[(1, n_r)],
                         dtypes=("float32",), odd=False)
    plans = _cem_plan(torch, C, 1, CEM_T, n_r, F, Kn)
    for k in ("fwd", "bwd"):
        rows[f"cond_em_{k}"] = dict(cem[(k, 1, n_r, Kn, "float32")],
                                    plan=plans[k])
    for name, row in rows.items():
        print(f"[shard] {name} at the ranks' shape ({row['shape']}): "
              f"max|d| {row['max_abs_err']:.3e}  kernel {row['ms']:.4f} ms "
              f" plain {row['plain_ms']:.4f} ms  bound {row['bound_ms']:.4f} "
              f"ms ({row['bound_by']}); plan {row['plan']} ({card})",
              flush=True)
    print(f"[shard] (d) kernel checks {time.perf_counter() - t0:.1f} s",
          flush=True)
    return rows


def _shard_argv(save, kernel, extra=()):
    return ["--data_dir", str(DATA_DIR), "--save_dir", str(save),
            "--epochs_unc", str(SCHEDULE["num_epochs_unc"]),
            "--epochs_moment", str(SCHEDULE["num_epochs_moment"]),
            "--epochs", str(SCHEDULE["num_epochs"]), "--ignore_epoch",
            str(SCHEDULE["ignore_epoch"]), "--print_freq", "8",
            "--dropout", str(DROPOUT), "--device", DEVICE,
            "--compute_dtype", "float32", "--kernel", kernel, *extra]


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _torchrun(save, kernel, world):
    """The train CLI with --shard_stocks over `world` ranks, through
    torch.distributed.run; (wall s, launch rows, events)."""
    counts_file = SHARD_DIR / f"launches.{save.name}.jsonl"
    env = dict(os.environ, DLAP_LAUNCH_COUNTS=str(counts_file))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
           "--nproc_per_node", str(world), "--master_addr",
           "127.0.0.1", "--master_port", str(_free_port()), "-m",
           f"{PKG}.train", *_shard_argv(save, kernel, ["--shard_stocks"])]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    wall = time.perf_counter() - t0
    (SHARD_DIR / f"{save.name}.log").write_text(proc.stdout + proc.stderr)
    check(proc.returncode == 0,
          f"torchrun --shard_stocks ({kernel}) exited {proc.returncode}: "
          f"{(proc.stdout + proc.stderr)[-3000:]}")
    return wall, _launch_rows(counts_file), _events(save)


def _run_dir_devs(a, b):
    """(max loss rel dev, max Sharpe abs dev) of two run dirs' history.npz
    over every epoch."""
    ha, hb = np.load(a / "history.npz"), np.load(b / "history.npz")
    return _devs(ha, hb, ("train_loss", "valid_loss", "test_loss"),
                 ("train_sharpe", "valid_sharpe", "test_sharpe"))


def _rank_digests(rows):
    return [r.get("sha256") for r in rows if r.get("kind") == "counter"
            and r.get("name") == "shard/final_params"]


def shard_phase(torch, card, world):
    """Phase 17 (a)-(c) on phase 6's panel (DATA_DIR); (d) runs before it.
    Returns the launches of (b) (the ``sharded_training`` path) and the
    walls."""
    from deeplearninginassetpricing_paperreplication_torch import train

    t0 = time.perf_counter()
    shutil.rmtree(SHARD_DIR, ignore_errors=True)
    SHARD_DIR.mkdir(parents=True)
    try:
        # (a) no process group: --shard_stocks is world size 1
        plain, flag = SHARD_DIR / "world1", SHARD_DIR / "world1_flag"
        t1 = time.perf_counter()
        train.main(_shard_argv(plain, "on"))
        wall1 = time.perf_counter() - t1
        train.main(_shard_argv(flag, "on", ["--shard_stocks"]))
        ha, hb = np.load(plain / "history.npz"), np.load(flag / "history.npz")
        check(set(ha.files) == set(hb.files)
              and all(np.array_equal(ha[k], hb[k]) for k in ha.files),
              "(a) --shard_stocks without a group: history.npz differs")
        for name in ("best_model_loss.pt", "best_model_sharpe.pt",
                     "final_model.pt"):
            sa, sb = (torch.load(d / name, weights_only=True)
                      for d in (plain, flag))
            check(list(sa) == list(sb)
                  and all(torch.equal(sa[k], sb[k]) for k in sa),
                  f"(a) --shard_stocks without a group: {name} differs")
        log = (flag / "events.jsonl").read_text()
        check("without a process group: world size 1" in log,
              "(a) the log does not say world size 1")
        ms1 = json.loads((plain / "final_metrics.json").read_text())[
            "epoch_ms"]
        print(f"[shard] (a) train CLI --shard_stocks without a process group"
              f" (f32, kernel on): world size 1, history.npz and the three "
              f"checkpoints bit for bit the unsharded CLI's ({card})",
              flush=True)

        # (b) two ranks on the one card, kernel route; (c) the plain route
        epochs = {"unconditional": SCHEDULE["num_epochs_unc"],
                  "moment": SCHEDULE["num_epochs_moment"],
                  "conditional": SCHEDULE["num_epochs"]}
        want = tuple(sum(PER_EPOCH[p][i] * n for p, n in epochs.items())
                     + SHARD_CLI_EXTRA[i] for i in range(4))
        out = {}
        # the two worlds side by side (each wall includes the other's load)
        with ThreadPoolExecutor(max_workers=2) as pool:
            runs = {k: pool.submit(_torchrun, SHARD_DIR / f"world{world}_{k}",
                                   k, world) for k in ("on", "off")}
            runs = {k: f.result() for k, f in runs.items()}
        for kernel in ("on", "off"):
            save = SHARD_DIR / f"world{world}_{kernel}"
            wall, rows, evs = runs[kernel]
            check(len(rows) == world,
                  f"({kernel}) {len(rows)} launch rows, not one per rank")
            per_rank = [tuple(r[k] for k in TRAIN_KERNELS) for r in rows]
            expect = want if kernel == "on" else (0, 0, 0, 0)
            check(all(c == expect for c in per_rank),
                  f"({kernel}) per-rank launches (fwd, bwd, cem_fwd, "
                  f"cem_bwd) {per_rank} != {expect}")
            digests = _rank_digests(evs)
            check(len(digests) == world and len(set(digests)) == 1,
                  f"({kernel}) the ranks' final parameters differ: "
                  f"{digests}")
            mesh = json.loads((save / "manifest.json").read_text())[
                "devices"]["mesh"]
            spans = [(r["start"], r["stop"]) for r in mesh["ranks"]]
            n = PANEL["n_stocks"]
            backend = ("nccl" if torch.cuda.device_count() >= world
                       else "gloo")
            check(mesh["backend"] == backend and spans == [
                (r * n // world, (r + 1) * n // world)
                for r in range(world)],
                f"({kernel}) manifest mesh {mesh}")
            if kernel == "on":
                ns = {e["analysis"]["N"] for e in evs
                      if e.get("kind") == "program"
                      and e.get("name", "").endswith("/train")}
                check(ns == {n // world},
                      f"(b) the ranks planned the train kernels at N {ns}")
            dl, dsh = _run_dir_devs(save, plain)
            check(dl <= LOSS_BAR and dsh <= SHARPE_BAR,
                  f"({kernel}) two ranks vs the unsharded kernel run: loss "
                  f"rel {dl:.3e} (bar {LOSS_BAR}), Sharpe {dsh:.3e} (bar "
                  f"{SHARPE_BAR})")
            ms = json.loads((save / "final_metrics.json").read_text())[
                "epoch_ms"]
            out[kernel] = dict(wall=wall, rows=per_rank, dev=(dl, dsh),
                               epoch_ms=ms)
            print(f"[shard] ({'b' if kernel == 'on' else 'c'}) torchrun "
                  f"{world} ranks ({backend}, devices "
                  f"{[r['device'] for r in mesh['ranks']]}), kernel {kernel}:"
                  f" rank spans {spans}, per-rank launches {per_rank[0]} "
                  f"(want {expect}), ranks' final params bit for bit equal; "
                  f"every epoch vs the unsharded kernel run: loss rel "
                  f"{dl:.3e} (bar {LOSS_BAR}), Sharpe {dsh:.3e} (bar "
                  f"{SHARPE_BAR}); wall {wall:.1f} s ({card})", flush=True)
        fmt = lambda d: ", ".join(f"{k} {v:.2f}" for k, v in d.items())  # noqa: E731
        print(f"[shard] wall ms per epoch, f32: world size 1 kernel "
              f"{fmt(ms1)} (CLI wall {wall1:.1f} s); world size "
              f"{world} kernel {fmt(out['on']['epoch_ms'])}; world "
              f"size {world} plain {fmt(out['off']['epoch_ms'])} (the two "
              f"worlds side by side) ({card})", flush=True)
    finally:
        shutil.rmtree(SHARD_DIR, ignore_errors=True)
    wall = time.perf_counter() - t0
    print(f"[shard] phase 17 done in {wall:.1f} s ({card})", flush=True)
    return dict(launches={k: sum(r[i] for r in out["on"]["rows"])
                          for i, k in enumerate(TRAIN_KERNELS)},
                world1_epoch_ms=ms1, world2_epoch_ms=out["on"]["epoch_ms"],
                world2_plain_epoch_ms=out["off"]["epoch_ms"], wall_s=wall)


# -- phase 18: the mesh-packed sweep and the serving mesh ----------------------

MESH_DIR = ROOT / "_smoke_mesh"
MESH_BUCKETS = SWEEP_BUCKETS[:2]  # B1, B2 of phase 9's covering grid
MESH_SPAN = 2  # grid width 4 (four lrs x seed 42) over two positions
MESH_FLEET_RATE = 40.0  # the kill's open-loop rate (rps) and seconds
MESH_FLEET_S = 4.0
MESH_BENCH = dict(n_pairs=8, fleet_stocks=512, fleet_rate_rps=20.0,
                  fleet_seconds=4.0)


def _spread(devices, n):
    """`n` mesh positions laid over `devices` in turn."""
    return tuple(devices[i % len(devices)] for i in range(n))


def mesh_window(K, C):
    """(run, parts): ``with run(part):`` sets the launch counts to 0 just
    before one of the mesh path's own runs and adds them to
    ``parts[part]`` just after. The references, warm-ups and comparisons
    run outside every window, so they count nowhere."""
    parts = {}

    @contextlib.contextmanager
    def run(part):
        K.reset_launch_count()
        C.reset_launch_count()
        yield
        got = parts.setdefault(part, dict.fromkeys(TRAIN_KERNELS, 0))
        for k, n in zip(TRAIN_KERNELS, counts(K, C)):
            got[k] += n
    return run, parts


def mesh_kernel_checks(torch, K, C, card):
    """The kernels at the mesh path's own shapes against their plain
    versions: the four training kernels at a grid position's span (S = 2,
    B1 and B2's widths, K and dropout, f32, T, N = SWEEP_TN), and the
    forward at a serving span (S = 3 over 16,384 / stocks, and one member
    over 8,192: the members=3,stocks=2 engine's). Returns {kernel: {case:
    row}} for the kernels line."""
    T, N = SWEEP_TN
    rows = {n: {} for n in TRAIN_KERNELS}
    for i, (h, _, Kn, rate) in enumerate(MESH_BUCKETS):
        tag = f"B{i + 1} span"
        S = MESH_SPAN
        rows["sdf_ffn_fwd"][tag] = wide_checks(
            torch, K, card, "fwd", (h,), [(S, T, N)], ("float32",),
            rate)[(h, S, T, N, "float32")]
        rows["sdf_ffn_bwd"][tag] = ffn_bwd_checks(
            torch, K, card, h, [(S, T, N)], ("float32",), (rate,))[
                (S, T, N, "float32", rate)]
        cem = cond_em_checks(torch, C, card, (Kn,), [(S, N)], ("float32",),
                             odd=False)
        for k in ("fwd", "bwd"):
            rows[f"cond_em_{k}"][tag] = cem[(k, S, N, Kn, "float32")]
    n_span = 16384 // (4 if torch.cuda.device_count() >= 4 else 2)
    fwd = wide_checks(torch, K, card, "fwd", [(64, 64)],
                      [(3, 1, n_span), (1, 1, 8192)], ("float32",), 0.0)
    rows["sdf_ffn_fwd"]["serving span"] = fwd[((64, 64), 3, 1, n_span,
                                               "float32")]
    rows["sdf_ffn_fwd"]["serving member span"] = fwd[((64, 64), 1, 1, 8192,
                                                      "float32")]
    return rows


def _same_bucket(torch, a, b):
    return (np.array_equal(a["best_valid_sharpe"], b["best_valid_sharpe"])
            and all(np.array_equal(a["history"][k], b["history"][k])
                    for k in a["history"])
            and all(torch.equal(a["params"][k], b["params"][k].to(
                a["params"][k].device)) for k in a["params"]))


def mesh_sweep_checks(torch, K, C, card, splits, mesh_run):
    """(a) B1 and B2 of phase 9's grid, f32, 8/4/16, seed 42: run_sweep
    with a one-device grid mesh bit for bit the mesh-off run; each bucket
    through train_bucket(grid_mesh=…) over two positions (two spans of the
    one card, or one card each) bit for bit the same bucket at
    member_chunk=2 and within the sweep bars of the mesh-off bucket, each
    position launching a bucket's launches at S = 2. The two mesh runs
    count in ``mesh_run("sweep")``. Returns the walls and per-position
    launches."""
    from deeplearninginassetpricing_paperreplication_torch.parallel import (
        partition,
    )
    from deeplearninginassetpricing_paperreplication_torch.parallel import (
        sweep as sw,
    )
    from deeplearninginassetpricing_paperreplication_torch.utils.config \
        import ExecutionConfig, GANConfig, TrainConfig

    train, valid, _ = splits
    base = GANConfig(macro_feature_dim=train.macro_feature_dim,
                     individual_feature_dim=train.individual_feature_dim)
    cfgs = [dataclasses.replace(base, hidden_dim=h, num_units_rnn=r,
                                num_condition_moment=k, dropout=d)
            for h, r, k, d in MESH_BUCKETS]
    configs = [(c, lr) for c in cfgs for lr in SWEEP_LRS]
    tcfg = TrainConfig(**SCHEDULE, seed=SWEEP_SEED, print_freq=10 ** 6)
    ex = ExecutionConfig(kernel="on", compute_dtype="float32",
                         bf16_panel=False, device=DEVICE)
    batches = [ds.to_batch(DEVICE) for ds in (train, valid)]
    cards = partition.local_devices(DEVICE)
    epochs = {"unconditional": SCHEDULE["num_epochs_unc"],
              "moment": SCHEDULE["num_epochs_moment"],
              "conditional": SCHEDULE["num_epochs"]}
    per_bucket = tuple(sum(epochs[p] * SWEEP_PER_EPOCH[p][i]
                           for p in epochs) for i in range(4))

    def sync():
        for d in cards:
            torch.cuda.synchronize(d)

    for c in cfgs:  # library loads and first allocations are set-up
        sw.train_bucket(c, SWEEP_LRS, [SWEEP_SEED], *batches,
                        TrainConfig(1, 1, 1, ignore_epoch=0), exec_cfg=ex)
    sync()
    row = lambda r: (r["config"], r["lr"], r["seed"], r["valid_sharpe"])  # noqa: E731
    walls = {}
    for name, mesh in (("off", None), ("one", partition.grid_slice_mesh(
            0, 1, width=1, devices=cards))):
        stats = {}
        with (mesh_run("sweep") if mesh is not None
              else contextlib.nullcontext()):
            t0 = time.perf_counter()
            ranked = sw.run_sweep(configs, [SWEEP_SEED], *batches,
                                  tcfg=tcfg, top_k=None, verbose=False,
                                  exec_cfg=ex, stats_out=stats,
                                  grid_mesh=mesh)
            sync()
        walls[name] = (time.perf_counter() - t0, stats, ranked)
    one_stats = walls["one"][1]["grid_mesh"]
    check([row(r) for r in walls["one"][2]] == [row(r) for r in
                                                 walls["off"][2]],
          "run_sweep with a one-device grid mesh ranks otherwise than "
          "without a mesh")
    check(one_stats["axes"] == {"grid": 1}
          and one_stats["devices"] == [str(cards[0])]
          and not one_stats["fallback_buckets"],
          f"the one-device grid mesh's stats: {one_stats}")
    print(f"[mesh sweep] (a) run_sweep B1+B2 x lrs {list(SWEEP_LRS)} x seed "
          f"{SWEEP_SEED}, f32: a one-device grid mesh ({one_stats['axes']} "
          f"on {one_stats['devices']}) ranks bit for bit as no mesh; wall "
          f"{walls['one'][0]:.3f} s vs {walls['off'][0]:.3f} s; bucket "
          f"walls {[round(s, 3) for s in walls['one'][1]['bucket_seconds']]}"
          f" vs {[round(s, 3) for s in walls['off'][1]['bucket_seconds']]} "
          f"({card})", flush=True)

    pos = tuple(cards[:2]) if len(cards) >= 2 else (cards[0],) * 2
    mesh2 = partition.MeshConfig((("grid", 2),), pos).build()
    launchers = {"sdf_ffn_fwd": (K, "_launch"),
                 "sdf_ffn_bwd": (K, "_launch_bwd"),
                 "cond_em_fwd": (C, "_launch_fwd"),
                 "cond_em_bwd": (C, "_launch_bwd")}
    originals = {n: getattr(m, a) for n, (m, a) in launchers.items()}
    members = {}

    def recorder(name):
        def rec(*args, **kw):
            n = (args[2].n_members if name.startswith("sdf")
                 else args[4].shape[0])
            members.setdefault(name, set()).add(n)
            return originals[name](*args, **kw)
        return rec

    out = {"walls": {}, "positions": {}}
    for i, c in enumerate(cfgs):
        tag = f"B{i + 1}"
        for name, (m, a) in launchers.items():
            setattr(m, a, recorder(name))
        try:
            with mesh_run("sweep"):
                t0 = time.perf_counter()
                on = sw.train_bucket(c, SWEEP_LRS, [SWEEP_SEED], *batches,
                                     tcfg, exec_cfg=ex, grid_mesh=mesh2)
                sync()
                on_s = time.perf_counter() - t0
        finally:
            for name, (m, a) in launchers.items():
                setattr(m, a, originals[name])
        check(set(members) == set(launchers)
              and all(v == {MESH_SPAN} for v in members.values()),
              f"mesh {tag}: launches not all at S = {MESH_SPAN}: {members}")
        members.clear()
        place = on["placement"]
        check(place["span"] == MESH_SPAN and not place["fallback"]
              and place["devices"] == [str(d) for d in pos],
              f"mesh {tag} placement {place}")
        for p, got in enumerate(place["launches"]):
            have = tuple(got[k] for k in TRAIN_KERNELS)
            check(have == per_bucket,
                  f"mesh {tag} position {p}: launches (fwd, bwd, cem_fwd, "
                  f"cem_bwd) {have} != {per_bucket}")
        t0 = time.perf_counter()
        chunk = sw.train_bucket(c, SWEEP_LRS, [SWEEP_SEED], *batches, tcfg,
                                exec_cfg=ex, member_chunk=MESH_SPAN)
        sync()
        chunk_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        off = sw.train_bucket(c, SWEEP_LRS, [SWEEP_SEED], *batches, tcfg,
                              exec_cfg=ex)
        sync()
        off_s = time.perf_counter() - t0
        check(_same_bucket(torch, on, chunk),
              f"mesh {tag}: two positions differ from member_chunk=2")
        bitwise = _same_bucket(torch, on, off)
        devs = [_point_devs(on, off, g, g) for g in range(len(SWEEP_LRS))]
        dev_loss = max(d[0] for d in devs)
        dev_sharpe = max(d[1] for d in devs)
        check(dev_loss <= 1e-3 and dev_sharpe <= 5e-3,
              f"mesh {tag} vs mesh-off: loss rel dev {dev_loss:.3e}, "
              f"Sharpe dev {dev_sharpe:.3e}")
        out["walls"][tag] = dict(mesh=on_s, chunk=chunk_s, off=off_s)
        out["positions"][tag] = place["launches"]
        print(f"[mesh sweep] (a) {tag} hidden={list(c.hidden_dim)} over two "
              f"positions {place['devices']} (span {MESH_SPAN}): bit for bit "
              f"member_chunk=2; vs mesh-off (S=4) "
              + ("bit for bit" if bitwise else
                 f"loss rel dev {dev_loss:.3e}, Sharpe dev "
                 f"{dev_sharpe:.3e} (bars 1e-3, 5e-3)")
              + f"; wall s mesh {on_s:.3f}, member_chunk=2 {chunk_s:.3f}, "
              f"mesh-off {off_s:.3f}; per-position launches (rows 5, 9, 10: "
              f"sdf_ffn_bwd, cond_em_fwd, cond_em_bwd) "
              + ", ".join(f"p{p} ({g['sdf_ffn_bwd']}, {g['cond_em_fwd']}, "
                          f"{g['cond_em_bwd']})"
                          for p, g in enumerate(place["launches"]))
              + f", every launch S={MESH_SPAN} ({card})", flush=True)
    return out


def mesh_sweep_cli_check(torch, card):
    """(a) the sweep CLI (--quick --search_only, bf16): --device_slices N
    --slice_width 1 (N cards) in process and with --workers (1 on one card,
    2 on more), both at once: the two rankings byte for byte, the worker's
    slice lease claimed and released, its bucket plans per position.
    Returns the launches of the CLI processes that exited normally."""
    from deeplearninginassetpricing_paperreplication_torch.ops import (
        ENV_LAUNCH_COUNTS,
    )

    n = torch.cuda.device_count()
    workers = 1 if n == 1 else 2
    argv = [sys.executable, "-m", f"{PKG}.sweep", "--data_dir",
            str(DATA_DIR), "--quick", "--search_only", "--device", DEVICE,
            "--device_slices", str(n), "--slice_width", "1"]
    runs = {"in_process": [], "workers": [
        "--workers", str(workers), "--lease_timeout", "5",
        "--worker_min_uptime", "0.2", "--worker_backoff", "0.1"]}
    sink = MESH_DIR / "cli_launches.jsonl"
    MESH_DIR.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, **{ENV_LAUNCH_COUNTS: str(sink)})
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(argv + ["--save_dir", str(MESH_DIR / k),
                                         *extra],
                                 cwd=ROOT, stdout=subprocess.PIPE, env=env,
                                 stderr=subprocess.STDOUT, text=True)
             for k, extra in runs.items()}
    logs = {k: p.communicate(timeout=600)[0] for k, p in procs.items()}
    wall = time.perf_counter() - t0
    for k, p in procs.items():
        check(p.returncode == 0, f"the sweep CLI ({k}) exited "
                                 f"{p.returncode}:\n{logs[k][-3000:]}")
    check("mesh-packed grids over 1 device(s)" in logs["in_process"],
          "the in-process CLI did not pack its grids on a mesh")
    ranking = {k: (MESH_DIR / k / "sweep_ranking.json").read_bytes()
               for k in runs}
    check(ranking["in_process"] == ranking["workers"],
          "the --workers ranking differs from the in-process one")
    rows = _events(MESH_DIR / "workers", "events.w*.jsonl")
    claims = _count(rows, "sweep/slice_claim")
    check(claims == workers, f"{claims} slice claims by {workers} workers")
    check(not list((MESH_DIR / "workers" / "sweep_ledger" / "slices")
                   .glob("slice*.json")),
          "a slice lease outlived its worker")
    plans = json.loads((MESH_DIR / "workers" / "manifest.w0.json")
                       .read_text()).get("kernel_programs") or {}
    check(plans and all("/pos0/" in k for k in plans),
          f"the worker's bucket plans are not per position: {sorted(plans)}")
    print(f"[mesh sweep] (a) the sweep CLI --quick --search_only "
          f"--device_slices {n} --slice_width 1, in process and with "
          f"--workers {workers} (run at once): rankings byte for byte, "
          f"{claims} slice lease(s) claimed and released, "
          f"{len(plans)} bucket plans per position; {wall:.1f} s ({card})",
          flush=True)
    return _sum_launches(_launch_rows(sink))


def mesh_engine_checks(torch, K, card, test, mesh_run):
    """(b) the ref_runs trio (S = 3, F = 46, M = 178, hidden [64, 64]), f32,
    stock buckets 64…16,384, every test month at batch 1 (and batch 4):
    ``mesh="stocks=1"`` bit for bit the default engine; a stock-span engine
    (stocks=2 on one card, or stocks=4 over four) within 1e-6 of it and
    within the f32 bar of offline ``ensemble_metrics``; a members=3,stocks=2
    engine the same; no capture after warmup, launches = 2 × captures;
    every warmed bucket's replay bit for bit its eager route; a hot reload
    onto stand-in members and back; ``infer()`` ms of each engine. The
    mesh engines' builds, warmups and reloads count in
    ``mesh_run("engines")``. Returns the default engine (phase 18's fleet
    answers are held to it)."""
    from deeplearninginassetpricing_paperreplication_torch.evaluate_ensemble \
        import stack_checkpoints
    from deeplearninginassetpricing_paperreplication_torch.parallel import (
        partition,
    )
    from deeplearninginassetpricing_paperreplication_torch.parallel.ensemble \
        import ensemble_metrics
    from deeplearninginassetpricing_paperreplication_torch.serving.engine \
        import InferenceEngine, InferenceRequest
    from deeplearninginassetpricing_paperreplication_torch.utils.config \
        import ExecutionConfig

    ex = ExecutionConfig(device=DEVICE, compute_dtype="float32",
                         bf16_panel=False)
    dirs = [str(ROOT / d) for d in REF_RUNS]
    cfg, stacked = stack_checkpoints(dirs, device=DEVICE)
    offline = np.asarray(ensemble_metrics(
        cfg, stacked, test.to_batch(DEVICE),
        ExecutionConfig(kernel="off", compute_dtype="float32",
                        device=DEVICE))["avg_weights"])
    cards = partition.local_devices(DEVICE)
    stocks = 4 if len(cards) >= 4 else 2
    engines = {
        "default": (None, {}),
        "stocks=1": ("stocks=1", {}),
        f"stocks={stocks}": (partition.MeshConfig(
            (("stocks", stocks),), _spread(cards, stocks)), {}),
        "members=3,stocks=2": (partition.MeshConfig(
            (("members", 3), ("stocks", 2)), _spread(cards, 6)),
            dict(stock_buckets=(16384,), batch_buckets=(1,))),
    }
    built = {}
    for name, (mesh, kw) in engines.items():
        with (mesh_run("engines") if mesh is not None
              else contextlib.nullcontext()):
            before = K.launches
            eng = InferenceEngine(dirs, macro_history=test.macro,
                                  exec_cfg=ex, mesh=mesh, **kw)
            eng.warmup()
        st = eng.stats()
        check(K.launches - before == 2 * st["captures"],
              f"engine {name}: {K.launches - before} launches for "
              f"{st['captures']} captures")
        built[name] = eng
    reqs = [InferenceRequest(individual=test.individual[t],
                             mask=test.mask[t].astype(np.float32),
                             returns=test.returns[t], month=t)
            for t in range(test.T)]
    ref = [built["default"].infer_one(r) for r in reqs]
    devs = {}
    for name, eng in built.items():
        worst, bit = 0.0, True
        for t, (r, a) in enumerate(zip(reqs, ref)):
            got = eng.infer_one(r)
            d = max(float(np.abs(got.weights - a.weights).max()),
                    abs(got.sdf - a.sdf),
                    float(np.abs(got.member_sdf - a.member_sdf).max()))
            bit = bit and d == 0.0
            worst = max(worst, d)
            want = offline[t]
            check(within(np.abs(got.weights - want), want, "float32",
                         **SERVE_F32_TOL),
                  f"engine {name} month {t} over the f32 bar of offline")
        if name == "stocks=1":
            check(bit, f"mesh stocks=1 is not bit for bit the default "
                       f"engine (max|d| {worst:.3e})")
        check(worst <= 1e-6, f"engine {name} vs default: max|d| {worst:.3e}")
        devs[name] = (worst, bit)
    span = built[f"stocks={stocks}"]
    for i in range(0, test.T, 4):
        got = span.infer(reqs[i:i + 4])
        for g, a in zip(got, built["default"].infer(reqs[i:i + 4])):
            check(float(np.abs(g.weights - a.weights).max()) <= 1e-6
                  and g.batch_bucket == 4, "stock-span batch 4 vs default")
    for name in (f"stocks={stocks}", "members=3,stocks=2"):
        eng = built[name]
        for r in reqs[:2]:
            a = eng.infer([r])[0]
            b = eng.infer([r], graphs=False)[0]
            check(np.array_equal(a.weights, b.weights) and a.sdf == b.sdf,
                  f"engine {name}: graph replay != its eager route")
    # a hot reload onto stand-in members of the same architecture, and back
    stand, _ = stand_in_members(torch)
    before = [span.infer_one(r) for r in reqs[:3]]
    with mesh_run("engines"):
        t0 = time.perf_counter()
        out = span.reload(stand[:3])
        reload_s = time.perf_counter() - t0
    fresh = InferenceEngine(stand[:3], macro_history=test.macro, exec_cfg=ex)
    fresh.warmup()
    worst_swap = 0.0
    for r in reqs[:6]:
        worst_swap = max(worst_swap, float(np.abs(
            span.infer_one(r).weights - fresh.infer_one(r).weights).max()))
    check(out["swapped"] and worst_swap <= 1e-6,
          f"the span engine's reload: {out}, max|d| {worst_swap:.3e} vs a "
          "fresh engine")
    with mesh_run("engines"):
        span.reload(dirs)
    for a, r in zip(before, reqs[:3]):
        check(np.array_equal(span.infer_one(r).weights, a.weights),
              "the span engine reloaded back is not bit for bit its start")
    shutil.rmtree(HEALTH_DIR, ignore_errors=True)
    times = {name: [] for name in built}
    for r in reqs:
        for name, eng in built.items():
            t0 = time.perf_counter()
            eng.infer_one(r)
            times[name].append((time.perf_counter() - t0) * 1e3)
    for name, eng in built.items():
        st = eng.stats()
        check(st["steady_state_captures"] == 0,
              f"engine {name}: {st['steady_state_captures']} captures "
              "after warmup")
        print(f"[mesh engine] (b) {name} (mesh {st['mesh']}): "
              f"{st['mesh_devices']} position(s), first on {st['device']}, "
              f"{st['captured_graphs']} graphs, 0 captures after warmup; "
              f"every test month vs the default engine "
              + ("bit for bit" if devs[name][1] else
                 f"max|d| {devs[name][0]:.3e} (bar 1e-6)")
              + f", within the f32 bar of offline; infer() median "
              f"{statistics.median(times[name]):.3f} ms batch 1, graphs "
              f"({card})", flush=True)
    print(f"[mesh engine] (b) hot reload of stocks={stocks} onto stand-in "
          f"members in {reload_s * 1e3:.1f} ms: max|d| {worst_swap:.3e} vs "
          f"a fresh engine; reloaded back bit for bit ({card})", flush=True)
    return built["default"]


def mesh_fleet_check(torch, card, test, ref_engine):
    """(c) ``serve --replicas 2 --mesh stocks=-1 --mesh_slices N`` (N
    cards) on the trio: fleet.json's mesh keys, each replica's mesh and
    device; every month once (c = 1, raw-f32) through the shared port
    against (b)'s default engine (bit for bit on one card); a SIGKILL of
    replica0 under open-loop load with no request lost. Returns the
    survivor's forward launches."""
    from deeplearninginassetpricing_paperreplication_torch.serving import (
        read_fleet_json,
    )
    from deeplearninginassetpricing_paperreplication_torch.serving.engine \
        import InferenceRequest

    n = torch.cuda.device_count()
    b = fleet_bodies(test)
    run_dir = MESH_DIR / "fleet"
    extra = ["--checkpoint_dirs", *[str(ROOT / d) for d in REF_RUNS],
             "--data_dir", str(DATA_DIR),
             "--stock_buckets", ",".join(map(str, b["buckets"])),
             "--batch_buckets", "1,4", "--mesh", "stocks=-1",
             "--mesh_slices", str(n)]
    proc, base, admin, boot_s = boot_fleet(run_dir, 2, extra)
    try:
        layout = read_fleet_json(run_dir)
        want = {"0": f"0:{n}", "1": f"{1 % n}:{n}"}
        check(layout["mesh"] == "stocks=-1" and layout["mesh_slices"] == n
              and layout["mesh_slice_by_replica"] == want,
              f"fleet.json mesh keys: {layout}")
        engines = [_metrics(a)["engine"] for a in admin]
        devices = [e["device"] for e in engines]
        check(all(e["mesh"] == "stocks=1" for e in engines)
              and devices == [f"cuda:{i % n}" for i in range(2)],
              f"replica meshes {[e['mesh'] for e in engines]} on {devices}")
        worst = 0.0
        for t in range(test.T):
            s, w = post(base + "/v1/weights", b["raw"][t], raw=True)
            a = ref_engine.infer_one(InferenceRequest(
                individual=test.individual[t][b["valid"][t]], month=t))
            check(s == 200, f"HTTP {s} at month {t}")
            d = float(np.abs(w - a.weights).max())
            check(d == 0.0 if n == 1 else d <= 1e-6,
                  f"fleet answer at month {t} vs (b): max|d| {d:.3e}")
            worst = max(worst, d)
        pid0 = replica_pids(run_dir)[0]
        t, load = _open_load(base, b["raw"], MESH_FLEET_RATE, MESH_FLEET_S)
        time.sleep(1.0)
        os.kill(pid0, signal.SIGKILL)
        t.join()
        check(load["n_ok"] == load["n_requests"] and load["errors"] == {},
              f"(c) {load['n_requests'] - load['n_ok']} requests lost to "
              f"the kill: {load['errors']}")
        survivor = _metrics(admin[1])["engine"]
        check(survivor["steady_state_captures"] == 0,
              f"replica1 captured {survivor['steady_state_captures']} after "
              "warmup")
        print(f"[mesh fleet] (c) 2 replicas, --mesh stocks=-1 --mesh_slices "
              f"{n}: booted in {boot_s:.1f} s; fleet.json slices {want}; "
              f"replicas on {devices}, meshes stocks=1; {test.T} months c = 1 "
              f"through the shared port vs (b): "
              + ("bit for bit" if worst == 0.0 else f"max|d| {worst:.3e}")
              + f"; SIGKILL replica0 under {MESH_FLEET_RATE} rps: "
              f"{load['n_ok']}/{load['n_requests']} answered, "
              f"{load['n_retried']} retried, {_lat(load)}; replica1 0 "
              f"captures after warmup ({card})", flush=True)
        return survivor["kernel_launches"]
    finally:
        stop_fleet(proc)


def mesh_bench_check(torch, card):
    """(d) ``bench_meshserve`` at N = 10,240 × 46, K = 3, a small load:
    its bars (the degenerate mesh bit for bit, the sharded engine within
    its tolerance across the hot swap, no capture after warmup, no request
    lost to the kill). Its launches count nowhere: its one-device engines
    and its sharded engine run in one call."""
    from deeplearninginassetpricing_paperreplication_torch.serving.loadgen \
        import bench_meshserve

    t0 = time.perf_counter()
    out = bench_meshserve(device=DEVICE, **MESH_BENCH)
    wall = time.perf_counter() - t0
    fm = out["fault_matrix"]
    check(out["degenerate_bitwise"] == 1 and out["bit_identical"] == 1
          and out["steady_state_captures_max"] == 0
          and fm["dropped_requests"] == 0 and sum(fm["replica_restarts"]) >= 1,
          f"bench_meshserve bars: {json.dumps(out)[:3000]}")
    print(f"[mesh bench] (d) bench_meshserve {out['shape']}: sharded "
          f"{out['sharded_mesh']} over {out['sharded_positions']} positions"
          f" max|d| {out['sharded_max_abs_diff']:.3e} (bitwise "
          f"{out['bitwise_equal_sharded']}), degenerate bitwise; hot swap "
          f"max|d| {out['hot_swap']['max_abs_diff']:.3e}; infer median ms "
          f"single / sharded {out['median_infer_ms']['single']} / "
          f"{out['median_infer_ms']['sharded']}; fleet {fm['mesh']}: "
          f"{fm['n_ok']}/{fm['n_requests']} answered across the kill, "
          f"restarts {fm['replica_restarts']}, {_lat(fm)}; captures after "
          f"warmup {out['steady_state_captures']}; {wall:.1f} s ({card})",
          flush=True)
    return out


def mesh_phase(torch, K, C, card, splits):
    """(18) The mesh path on phase 6's panel: the kernels at its shapes,
    then (a) the mesh-packed sweep in process and through the CLI, (b) the
    serving mesh, (c) a mesh fleet and (d) bench_meshserve. Its launches
    are the mesh runs' own, each counted from 0 (``mesh_window``): the
    in-process sweep's mesh runs, the sweep CLI's processes, the mesh
    engines and the fleet's survivor. Returns them, by part too, and the
    kernel rows."""
    t_phase = time.perf_counter()
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    rows = mesh_kernel_checks(torch, K, C, card)
    mesh_run, parts = mesh_window(K, C)
    try:
        sweep = mesh_sweep_checks(torch, K, C, card, splits, mesh_run)
        parts["sweep_cli"] = mesh_sweep_cli_check(torch, card)
        ref_engine = mesh_engine_checks(torch, K, card, splits[2], mesh_run)
        parts["fleet_survivor"] = dict.fromkeys(TRAIN_KERNELS, 0)
        parts["fleet_survivor"]["sdf_ffn_fwd"] = mesh_fleet_check(
            torch, card, splits[2], ref_engine)
        bench = mesh_bench_check(torch, card)
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(MESH_DIR, ignore_errors=True)
        shutil.rmtree(HEALTH_DIR, ignore_errors=True)
    launches = {k: sum(p[k] for p in parts.values()) for k in TRAIN_KERNELS}
    wall = time.perf_counter() - t_phase
    print(f"[mesh] phase 18 done in {wall:.1f} s; the mesh runs' launches "
          f"{launches}, by part {parts} ({card})", flush=True)
    return dict(launches=launches, parts=parts, rows=rows, sweep=sweep,
                bench=bench, wall_s=wall)


# -- phase 19: multi-process training and sequence parallelism ----------------

MULTIHOST_DIR = ROOT / "_smoke_multihost"
# (b): phase 6's model at the paper width without dropout, f32, over the
# worker's panel (NumPy from seed 0) at T = 48, N = 10,000
MH_PAPER = dict(macro_feature_dim=178, individual_feature_dim=46,
                hidden_dim=[64, 64], num_units_rnn=[4], num_condition_moment=8,
                dropout=0.0)
MH_T, MH_N = 48, 10_000
MH_CLI_PER = 8  # (a): the worker CLI's default stocks a rank (mesh [2, 1])
MH_STEP = (1, 1, 1, 1)  # one conditional train_step: rows 1, 3, 6, 7
MH_RTOL = 2e-4  # [2, 2] against [2, 1]: only the stock sums' order differs
# a rank of (b): the worker at the paper width (the CLI takes no widths)
MH_PAPER_RANK = (
    "import json, sys\n"
    f"from {PKG}.parallel.multihost_worker import worker\n"
    f"from {PKG}.utils.config import GANConfig\n"
    "out = worker(cfg=GANConfig(**json.loads(sys.argv[2])),\n"
    "             **json.loads(sys.argv[1]))\n"
    "print(json.dumps(out), flush=True)\n")
# (c): the paper's macro LSTM (I = 178, H = 4) over four time positions
SEQ_I, SEQ_H, SEQ_D = 178, 4, 4
SEQ_CASES = ((600, 1e-6), (16_384, 1e-5))  # 240 + 60 + 300 months; daily


def multihost_kernel_checks(torch, K, C, card):
    """The four training kernels at the multihost path's shapes (S = 1,
    f32, dropout 0, K = 8) against their plain versions: the worker CLI's
    (T = 6, N = 8, F = 5, hidden (4,)) and a rank's at the paper width (T =
    48, N = 10,000 and 5,000, F = 46, hidden (64, 64)). Returns {kernel:
    {case: row}} for the kernels line."""
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(19)
    cases = [("cli", 6, MH_CLI_PER, 5, [4]),
             ("paper [2, 1]", MH_T, MH_N, 46, [64, 64]),
             ("paper [2, 2]", MH_T, MH_N // 2, 46, [64, 64])]
    rows = {n: {} for n in TRAIN_KERNELS}
    Kn, cd, seed = 8, "float32", 19
    for tag, T, N, F, hidden in cases:
        x = torch.randn(T, F, N, generator=g, device=dev)
        zp1, k1T, mids, kout, bout = _ffn_params(torch, g, 1, F, hidden, dev)
        zp = (zp1 + torch.randn(1, T, hidden[0], generator=g,
                                device=dev) * 0.3).contiguous()
        gout = torch.randn(1, T, N, generator=g, device=dev) / N
        packed = K.pack_ffn(k1T, mids, kout, bout, cd)
        args = (x, zp, k1T, mids, kout)
        _, zpm, xr, tinv, kT, gem = _cem_inputs(torch, g, 1, T, N, F, Kn, dev)
        cem = (x, zpm, xr, tinv, kT)

        def bwd_outs(pair):
            grads, dzp = pair
            dk1T, dmids, dkout, dbout = K.unpack_grads(grads, packed.layout)
            return [dzp, dk1T, dkout, dbout, *(t for wb in dmids for t in wb)]

        def bwd_refs(r):
            return [r[0], r[1], r[3], r[4], *(t for wb in r[2] for t in wb)]

        table = (
            ("sdf_ffn_fwd",
             lambda: K.sdf_ffn_packed(x, zp, packed, dropout_rate=0.0,
                                      seed=seed),
             lambda: K.sdf_ffn_reference(*args, bout, cd, seed, 0.0),
             lambda o: [o], lambda r: [r], 1e-5,
             K.flops(1, T, N, F, hidden), K.bytes_moved(1, T, N, F, hidden)),
            ("sdf_ffn_bwd",
             lambda: K._launch_bwd(x, zp, packed, gout, seed, 0.0),
             lambda: K.sdf_ffn_bwd_reference(*args, gout, cd, seed, 0.0),
             bwd_outs, bwd_refs, GRAD_F32_REL,
             K.bwd_flops(1, T, N, F, hidden),
             K.bwd_bytes_moved(1, T, N, F, hidden)),
            ("cond_em_fwd", lambda: C._launch_fwd(*cem, cd),
             lambda: C.cond_em_reference(*cem, cd), lambda o: [o],
             lambda r: [r], GRAD_F32_REL, C.fwd_flops(1, T, N, F, Kn),
             C.fwd_bytes_moved(1, T, N, F, Kn)),
            ("cond_em_bwd", lambda: C._launch_bwd(*cem, gem, cd),
             lambda: C.cond_em_bwd_reference(*cem, gem, cd), list, list,
             GRAD_F32_REL, C.bwd_flops(1, T, N, F, Kn),
             C.bwd_bytes_moved(1, T, N, F, Kn)),
        )
        for name, kern, plain, outs, refs, bar, flops, nbytes in table:
            got, ref = outs(kern()), refs(plain())
            err = max(rel_err(o, q) for o, q in zip(got, ref))
            check(all(bool(torch.isfinite(o).all()) for o in got)
                  and err <= bar,
                  f"{name} at the multihost {tag} shape (T={T} N={N} F={F} "
                  f"hidden={hidden}) disagrees with its plain version: "
                  f"max|d|/max|ref| {err:.3e}")
            b_ms, b_by = bound(flops, nbytes, cd)
            rows[name][tag] = dict(
                max_abs_err=max(float((o - q).abs().max())
                                for o, q in zip(got, ref)),
                ms=cuda_ms(torch, kern, reps=10, warmup=2),
                plain_ms=cuda_ms(torch, plain, reps=5, warmup=1),
                bound_ms=b_ms, bound_by=b_by,
                shape=f"S=1 T={T} N={N} F={F} hidden={hidden} K={Kn} {cd} "
                      "dropout 0")
            r = rows[name][tag]
            print(f"[multihost] {name} at the {tag} shape ({r['shape']}): "
                  f"max|d|/max|ref| {err:.2e}  kernel {r['ms']:.4f} ms  "
                  f"plain {r['plain_ms']:.4f} ms  bound {b_ms:.4f} ms "
                  f"({b_by}) ({card})", flush=True)
    return rows


def _mh_rank(row) -> int:
    """The process id of a launch-count row of a multihost rank (its argv:
    the worker CLI's, or MH_PAPER_RANK's JSON)."""
    argv = row["argv"]
    if "--process_id" in argv:
        return int(argv[argv.index("--process_id") + 1])
    return int(json.loads(argv[1])["process_id"])


def _mh_world(torch, tag, n, kernel, per, paper, granules=None):
    """One world of `n` ranks through ``spawn_world``: the worker CLI, or
    with `paper` the worker at MH_PAPER. Returns its results, wall s (spawn
    to the last rank's exit), per-rank launches (fwd, bwd, cem_fwd,
    cem_bwd) and the N each rank planned its kernels at."""
    from deeplearninginassetpricing_paperreplication_torch.parallel import (
        multihost_worker as W,
    )

    run_dir = MULTIHOST_DIR / tag
    counts_file = MULTIHOST_DIR / f"launches.{tag}.jsonl"
    env = dict(os.environ, DLAP_LAUNCH_COUNTS=str(counts_file))

    def command(r, coordinator):
        if not paper:
            return W.worker_command(
                r, coordinator, n, "--device", DEVICE, "--kernel", kernel,
                "--n_stocks_per_device", str(per), "--run_dir", str(run_dir),
                "--run_id", tag)
        kw = dict(coordinator=coordinator, num_processes=n, process_id=r,
                  T=MH_T, n_stocks_per_device=per, device=DEVICE,
                  kernel=kernel, run_dir=str(run_dir), run_id=tag)
        return [sys.executable, "-c", MH_PAPER_RANK, json.dumps(kw),
                json.dumps(MH_PAPER)]

    try:
        results, wall = W.spawn_world(command, n, granules=granules, env=env,
                                      timeout=600, cwd=ROOT)
    except RuntimeError as e:
        fail(f"multihost world {tag}: {e}")
    rows = sorted(_launch_rows(counts_file), key=_mh_rank)
    check([_mh_rank(r) for r in rows] == list(range(n)),
          f"{tag}: launch rows of ranks {[_mh_rank(r) for r in rows]}")
    launches = [tuple(r[k] for k in TRAIN_KERNELS) for r in rows]
    planned, steps = {}, {}
    for e in _events(run_dir):
        pidx = e.get("process_index", 0)
        if e.get("kind") == "program":
            planned.setdefault(pidx, set()).add(e["analysis"]["N"])
        elif (e.get("kind") == "span_end"
              and e.get("name") == "multihost/train_step"):
            steps[pidx] = (e["mono"] - e["duration_s"], e["mono"])
    check(len(steps) == n, f"{tag}: train_step spans of ranks {sorted(steps)}")
    backend = json.loads((run_dir / "manifest.json").read_text())[
        "devices"]["mesh"]["backend"]
    want = ("nccl" if torch.cuda.device_count() >= n else "gloo")
    check(backend == want, f"{tag}: backend {backend}, not {want}")
    losses = [o["losses"] for o in results]
    check(all(x == losses[0] for x in losses),
          f"{tag}: the ranks' gathered losses differ: {losses}")
    # the ranks' steps side by side: the sum of their spans (each up to
    # its device's end) over the time their union covers; n = all at once,
    # 1 = one after another (the host's monotonic clock, shared)
    union, end = 0.0, None
    for a, b in sorted(steps.values()):
        start = a if end is None else max(a, end)
        union += max(0.0, b - start)
        end = b if end is None else max(end, b)
    step_ms = [round((steps[r][1] - steps[r][0]) * 1e3, 3)
               for r in range(n)]
    return dict(results=results, wall=wall, launches=launches,
                planned=planned, backend=backend, losses=losses[0],
                step_ms=step_ms, concurrency=sum(step_ms) / 1e3 / union)


def _mh_reference(torch, cfg, T, N):
    """Each member's one-process step on card 0 (the kernel route) over
    the worker's panel at (T, N): the losses [2, 1] is held to."""
    from deeplearninginassetpricing_paperreplication_torch.parallel import (
        multihost_worker as W,
    )
    from deeplearninginassetpricing_paperreplication_torch.utils.config \
        import ExecutionConfig

    host = W.worker_panel(T, N, cfg.macro_feature_dim,
                          cfg.individual_feature_dim)
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in host.items()}
    ec = ExecutionConfig(kernel="on", compute_dtype="float32",
                         bf16_panel=False, device=DEVICE)
    return [float(W.member_step(cfg, W.member_state_dict(cfg, g), batch,
                                ec)[0]["loss"]) for g in range(2)]


def multihost_checks(torch, card):
    """(a) the worker CLI at its JAX shapes and (b) the worker at the paper
    width, as worlds of rank processes, the four worlds side by side.
    Returns the kernel-route ranks' launches (the ``multihost`` path) and
    the walls."""
    from deeplearninginassetpricing_paperreplication_torch.parallel import (
        multihost_worker as W,
    )
    from deeplearninginassetpricing_paperreplication_torch.utils.config \
        import GANConfig

    out, launches = {}, dict.fromkeys(TRAIN_KERNELS, 0)

    def held(tag, w, kernel, N, shape):
        check(all(o["mesh_shape"] == shape for o in w["results"]),
              f"{tag}: mesh {[o['mesh_shape'] for o in w['results']]}")
        want = MH_STEP if kernel == "on" else (0, 0, 0, 0)
        check(all(c == want for c in w["launches"]),
              f"{tag}: per-rank launches (fwd, bwd, cem_fwd, cem_bwd) "
              f"{w['launches']} != {want}")
        if kernel == "on":
            check(len(w["planned"]) == len(w["results"]) and all(
                v == {N} for v in w["planned"].values()),
                f"{tag}: the ranks planned their kernels at N "
                f"{w['planned']}, not {N}")
            for i, k in enumerate(TRAIN_KERNELS):
                launches[k] += sum(c[i] for c in w["launches"])
        out[tag] = w
        print(f"[multihost] {tag}: {len(w['results'])} ranks ({w['backend']})"
              f", mesh {shape}, kernel {kernel}: losses {w['losses']} equal "
              f"on every rank; per-rank launches {w['launches']}; planned N "
              f"{sorted(set().union(*w['planned'].values())) or '-'}; step "
              f"ms by rank {w['step_ms']} (side by side "
              f"{w['concurrency']:.2f} of {len(w['results'])}); wall "
              f"{w['wall']:.2f} s from spawn to the last rank's exit "
              f"({card})", flush=True)

    # the one-process references, then the four worlds side by side (each
    # with its own ranks, run dir and port: a world's wall and step times
    # include the others' load)
    ref_cli = _mh_reference(torch, W.jax_config(), W.JAX_T, MH_CLI_PER)
    cfg = GANConfig(**MH_PAPER)
    ref = _mh_reference(torch, cfg, MH_T, MH_N)
    worlds = {"cli_2x1": (2, "on", MH_CLI_PER, False, None),
              "paper_2x1": (2, "on", MH_N, True, None),
              "paper_2x2": (4, "on", MH_N // 2, True, [0, 0, 1, 1]),
              "paper_2x1_off": (2, "off", MH_N, True, None)}
    with ThreadPoolExecutor(max_workers=len(worlds)) as pool:
        runs = {tag: pool.submit(_mh_world, torch, tag, n, kernel, per,
                                 paper, granules)
                for tag, (n, kernel, per, paper, granules) in worlds.items()}
        runs = {tag: f.result() for tag, f in runs.items()}

    # (a) the worker CLI, two ranks, mesh [2, 1], the kernel route
    w = runs["cli_2x1"]
    held("cli_2x1", w, "on", MH_CLI_PER, [2, 1])
    check(w["losses"] == ref_cli, f"(a) the CLI's losses {w['losses']} are "
          f"not bit for bit the one-process step's {ref_cli}")
    print(f"[multihost] (a) the worker CLI (T={W.JAX_T} N={MH_CLI_PER} "
          f"F={W.JAX_F} M={W.JAX_M}): each member's loss bit for bit its "
          f"one-process train_step on the card ({card})", flush=True)

    # (b) the paper width: [2, 1], [2, 2] on two granules, the plain route
    w21 = runs["paper_2x1"]
    held("paper_2x1", w21, "on", MH_N, [2, 1])
    check(w21["losses"] == ref, f"(b) [2, 1] losses {w21['losses']} are "
          f"not bit for bit the one-process step's {ref}")
    w22 = runs["paper_2x2"]
    held("paper_2x2", w22, "on", MH_N // 2, [2, 2])
    d22 = max(abs(a - b) / abs(b) for a, b in zip(w22["losses"], ref))
    check(d22 <= MH_RTOL, f"(b) [2, 2] vs [2, 1]: loss rel {d22:.3e} (bar "
          f"{MH_RTOL})")
    off = runs["paper_2x1_off"]
    held("paper_2x1_off", off, "off", MH_N, [2, 1])
    d_off = max(abs(a - b) / abs(b) for a, b in zip(off["losses"], ref))
    check(d_off <= LOSS_BAR, f"(b) --kernel off vs the kernel route: loss "
          f"rel {d_off:.3e} (bar {LOSS_BAR})")
    print(f"[multihost] (b) paper width (T={MH_T} N={MH_N} F=46 M=178 "
          f"hidden (64, 64) LSTM (4,) K=8, f32, dropout 0): [2, 1] bit for "
          f"bit the one-process step; [2, 2] (N = {MH_N // 2} a rank) loss "
          f"rel {d22:.3e} (bar {MH_RTOL}); --kernel off loss rel "
          f"{d_off:.3e} (bar {LOSS_BAR}) ({card})", flush=True)
    return launches, {k: dict(wall_s=v["wall"], step_ms=v["step_ms"],
                              concurrency=v["concurrency"])
                      for k, v in out.items()}


def sequence_checks(torch, card):
    """(c) ``sequence_sharded_lstm`` over SEQ_D time positions (spans of
    card 0, or one card each on four) against the one-device
    ``lstm_scan`` on card 0, at each of SEQ_CASES; a ragged T raises.
    Returns {T: (max|d|, bit for bit, one-device ms, pipeline ms)}."""
    from deeplearninginassetpricing_paperreplication_torch.models.recurrent \
        import lstm_scan
    from deeplearninginassetpricing_paperreplication_torch.parallel import (
        partition,
        sequence,
    )

    devs = partition.local_devices(DEVICE)
    positions = _spread(devs, SEQ_D)
    mesh = partition.MeshConfig(((sequence.TIME_AXIS, SEQ_D),),
                                positions).build()
    dev0 = positions[0]
    g = torch.Generator().manual_seed(19)
    k = SEQ_H ** -0.5
    params = {name: ((torch.rand(shape, generator=g) * 2 - 1) * k).to(dev0)
              for name, shape in (("w_ih", (4 * SEQ_H, SEQ_I)),
                                  ("w_hh", (4 * SEQ_H, SEQ_H)),
                                  ("b_ih", (4 * SEQ_H,)),
                                  ("b_hh", (4 * SEQ_H,)))}

    def sync():
        for d in set(devs):
            torch.cuda.synchronize(d)

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        got = fn()
        sync()
        return got, (time.perf_counter() - t0) * 1e3

    out = {}
    lstm_scan(params, torch.zeros(8, SEQ_I, device=dev0))  # warm-up
    sequence.sequence_sharded_lstm(params, torch.zeros(8, SEQ_I,
                                                       device=dev0), mesh)
    for T, atol in SEQ_CASES:
        x = torch.randn(T, SEQ_I, generator=g).to(dev0)
        (ref, _), one_ms = timed(lambda: lstm_scan(params, x))
        chunks, pipe_ms = timed(
            lambda: sequence.sequence_sharded_lstm(params, x, mesh))
        check(len(chunks) == SEQ_D and all(
            c.device == p and c.shape == (T // SEQ_D, SEQ_H)
            for c, p in zip(chunks, positions)),
            f"(c) T={T}: chunks {[(c.device, tuple(c.shape)) for c in chunks]}"
            f" against positions {positions}")
        got = torch.cat([c.to(dev0) for c in chunks])
        err = float((got - ref).abs().max())
        exact = bool(torch.equal(got, ref))
        check(bool(torch.isfinite(got).all()) and err <= atol,
              f"(c) T={T} over {SEQ_D} positions vs one-device lstm_scan: "
              f"max|d| {err:.3e} (atol {atol})")
        out[T] = (err, exact, one_ms, pipe_ms)
        print(f"[multihost] (c) sequence T={T} I={SEQ_I} H={SEQ_H} over "
              f"{SEQ_D} positions {[str(p) for p in positions]}: max|d| "
              f"{err:.3e} (atol {atol}), {'' if exact else 'not '}bit for "
              f"bit the one-device lstm_scan; wall one device "
              f"{one_ms:.1f} ms, pipeline {pipe_ms:.1f} ms ({card})",
              flush=True)
    try:
        sequence.sequence_sharded_lstm(params, x[:SEQ_CASES[0][0] - 1], mesh)
    except ValueError as e:
        check("must divide" in str(e), f"(c) the ragged error: {e}")
    else:
        fail("(c) a ragged sequence did not raise")
    return out


def multihost_phase(torch, K, C, card):
    """(19) The kernels at the path's shapes, then (a) and (b)
    (``multihost_checks``) and (c) (``sequence_checks``). Returns the
    ranks' launches (the ``multihost`` path), the kernel rows and the
    walls."""
    t_phase = time.perf_counter()
    shutil.rmtree(MULTIHOST_DIR, ignore_errors=True)
    MULTIHOST_DIR.mkdir(parents=True)
    try:
        rows = multihost_kernel_checks(torch, K, C, card)
        launches, walls = multihost_checks(torch, card)
        seq = sequence_checks(torch, card)
    finally:
        shutil.rmtree(MULTIHOST_DIR, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    print(f"[multihost] phase 19 done in {wall:.1f} s; the ranks' launches "
          f"{launches}; world walls {walls} ({card})", flush=True)
    return dict(launches=launches, rows=rows, walls=walls, sequence=seq,
                wall_s=wall)


# -- phase 20 -----------------------------------------------------------------

BP_T = 48
# (S, N, stock offset): the training and ensemble shapes, an odd N (the
# bf16 panel's 2-byte loads) and a 2,500-stock span at its start 5,000 (a
# four-rank shard: bf16 rows 5,000 bytes apart, not 16-byte aligned)
BP_SHAPES = [(S, N, off) for S in (1, 9)
             for N, off in ((10_000, 0), (10_003, 0), (2_500, 5_000))]
BP_ROW_N = 10_000  # the timed shape: the training panel's N
BP_KERNELS = ("sdf_ffn_fwd", "sdf_ffn_bwd", "sdf_ffn_dx", "cond_em_fwd",
              "cond_em_bwd", "cond_em_dx")
BP_TRAIN_KERNELS = ("sdf_ffn_fwd", "sdf_ffn_bwd", "cond_em_fwd",
                    "cond_em_bwd")


def bf16_panel_counts(K, C):
    """The bf16-panel forms' launches, in BP_KERNELS order."""
    return (K.launches_bf16_panel, K.bwd_launches_bf16_panel,
            K.dx_launches_bf16_panel, C.fwd_launches_bf16_panel,
            C.bwd_launches_bf16_panel, C.dx_launches_bf16_panel)


def _bf16_ulp(torch, ref):
    """One bf16 ulp of each element of `ref` (0 where ref is 0)."""
    r = ref.float()
    ulp = torch.ldexp(torch.ones_like(r), torch.frexp(r).exponent - 8)
    return torch.where(r == 0, torch.zeros_like(r), ulp)


def _bp_calls(torch, K, C, S, T, N, F, Kn, hidden, off, cd, rate, ins):
    """{kernel: (its launch on a panel x, its plain version on x, flops,
    bytes moved at an element size)} for the six panel kernels: each
    returns a list of output tensors."""
    zp, k1T, mids, kout, bout, gout, seed, zpm, xr, tinv, kT, gem = ins
    packed = K.pack_ffn(k1T, mids, kout, bout, cd)

    def bwd(r):
        grads, dzp = r
        dk1T, dmids, dkout, dbout = K.unpack_grads(grads, packed.layout)
        return [dzp, dk1T, dkout, dbout] + [t for wb in dmids for t in wb]

    def bwd_ref(r):
        return [r[0], r[1], r[3], r[4]] + [t for wb in r[2] for t in wb]

    ffn = (S, T, N, F, hidden)
    cem = (S, T, N, F, Kn)
    return {
        "sdf_ffn_fwd": (
            lambda x: [K._launch(x, zp, packed, seed, rate, off)],
            lambda x: [K.sdf_ffn_reference(x, zp, k1T, mids, kout, bout, cd,
                                           seed, rate, off)],
            K.flops(*ffn), lambda b: K.bytes_moved(*ffn, b)),
        "sdf_ffn_bwd": (
            lambda x: bwd(K._launch_bwd(x, zp, packed, gout, seed, rate,
                                        offset=off)),
            lambda x: bwd_ref(K.sdf_ffn_bwd_reference(
                x, zp, k1T, mids, kout, gout, cd, seed, rate, off)),
            K.bwd_flops(*ffn), lambda b: K.bwd_bytes_moved(*ffn, b)),
        "sdf_ffn_dx": (
            lambda x: [K._launch_dx(x, zp, packed, gout, seed, rate,
                                    offset=off)],
            lambda x: [K.sdf_ffn_dx_reference(x, zp, k1T, mids, kout, gout,
                                              cd, seed, rate, off)],
            K.dx_flops(*ffn), lambda b: K.dx_bytes_moved(*ffn, b)),
        "cond_em_fwd": (
            lambda x: [C._launch_fwd(x, zpm, xr, tinv, kT, cd)],
            lambda x: [C.cond_em_reference(x, zpm, xr, tinv, kT, cd)],
            C.fwd_flops(*cem), lambda b: C.fwd_bytes_moved(*cem, b)),
        "cond_em_bwd": (
            lambda x: list(C._launch_bwd(x, zpm, xr, tinv, kT, gem, cd)),
            lambda x: list(C.cond_em_bwd_reference(x, zpm, xr, tinv, kT,
                                                   gem, cd)),
            C.bwd_flops(*cem), lambda b: C.bwd_bytes_moved(*cem, b)),
        "cond_em_dx": (
            lambda x: [C._launch_dx(x, zpm, xr, tinv, kT, gem, cd)],
            lambda x: [C.cond_em_dx_reference(x, zpm, xr, tinv, kT, gem,
                                              cd)],
            C.dx_flops(*cem), lambda b: C.dx_bytes_moved(*cem, b)),
    }


def bf16panel_plan_lines(torch, K, C, card):
    """Each panel kernel's plan at BP_T, N = 10,000 (and the 2,500-stock
    span), S = 1 and 9, both compute dtypes, for its bf16-panel instance
    beside its f32-panel one, as the card holds them; fails if the card
    keeps fewer blocks resident than planned or an instance spills."""
    dev = torch.device(DEVICE)
    F, hidden, Kn, T = 46, (64, 64), 8, BP_T
    lay = K.ffn_layout(F, hidden)
    for S in (1, 9):
        for N in (BP_ROW_N, 2_500):
            for cd in ("float32", "bfloat16"):
                for xb16 in (True, False):
                    plans = []
                    p = K.card_fwd_plan(lay, dev, S, T, N, cd, xb16)
                    plans.append(("sdf_ffn_fwd", p,
                                  K.fwd_plan_info(lay, S, p, xb16)))
                    p = K.card_bwd_plan(lay, dev, S, T, N, xb16=xb16)
                    plans.append(("sdf_ffn_bwd", p,
                                  K.bwd_plan_info(lay, p, xb16)))
                    p = K.card_dx_plan(lay, dev, S, T, N, cd, xb16=xb16)
                    plans.append(("sdf_ffn_dx", p,
                                  K.dx_plan_info(lay, S, cd, p, xb16=xb16)))
                    for p in C.card_cem_plan(dev, S, T, N, F, Kn, cd, xb16):
                        plans.append((f"cond_em_{p.kernel}", p, C.plan_info(
                            p, S, T, N, F, Kn, cd, xb16)))
                    p = C.card_cem_dx_plan(dev, S, T, N, F, Kn, cd,
                                           xb16=xb16)
                    plans.append(("cond_em_dx", p, C.dx_plan_info(
                        p, S, T, N, F, Kn, cd, xb16)))
                    for name, p, info in plans:
                        check(info["blocks_per_sm"] >= p.blocks_per_sm
                              and info["local_bytes"] == 0,
                              f"{name} {'bf16' if xb16 else 'f32'} panel "
                              f"plan {p}: the card holds "
                              f"{info['blocks_per_sm']} blocks per SM, "
                              f"{info['local_bytes']} B local")
                        print(f"[bf16 panel plan] {name:11s} S={S} T={T} "
                              f"N={N:5d} {cd:8s} "
                              f"{'bf16' if xb16 else 'f32 '} panel: route "
                              f"{getattr(p, 'route', 0)} tile {p.tile} "
                              f"threads {p.threads}"
                              f" smem {p.smem_bytes} B resident "
                              f"{info['blocks_per_sm']}/SM (planned "
                              f"{p.blocks_per_sm}) regs {info['registers']}"
                              f" local {info['local_bytes']} B ({card})",
                              flush=True)


def bf16panel_kernel_checks(torch, K, C, card):
    """(a) Each of the six panel kernels on a bf16 panel xb: bit for bit the
    same kernel on the f32 panel xb.float() (a bf16 dx: bit for bit that
    call's f32 dx rounded once), and against its plain version on xb at
    the bars of phase 3 (a bf16 dx also within one bf16 ulp: the sum's
    order can move one rounding), at BP_SHAPES, f32 and bf16 compute,
    dropout 0 and 0.05 (the FFN's); at N = 10,000 one call timed on the
    bf16 panel and on the f32 panel, each beside its bound. Returns
    {(kernel, S, cd): row}."""
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(20)
    F, hidden, Kn, T = 46, [64, 64], 8, BP_T
    rows = {}
    print(f"[bf16 panel] the six panel kernels on a bf16 panel, T={T} F={F} "
          f"hidden={hidden} K={Kn} ({card})", flush=True)
    for S, N, off in BP_SHAPES:
        xf = torch.randn(T, F, N, generator=g, device=dev)
        xb = xf.to(torch.bfloat16)
        xw = xb.float()  # the bf16 panel widened: what every kernel reads
        zp1, k1T, mids, kout, bout = _ffn_params(torch, g, S, F, hidden, dev)
        zp = (zp1 + torch.randn(S, T, hidden[0], generator=g,
                                device=dev) * 0.3).contiguous()
        gout = torch.randn(S, T, N, generator=g, device=dev) / N
        seed = 7 if S == 1 else list(range(7, 7 + S))
        _, zpm, xr, tinv, kT, gem = _cem_inputs(torch, g, S, T, N, F, Kn, dev)
        ins = (zp, k1T, mids, kout, bout, gout, seed, zpm, xr, tinv, kT, gem)
        for cd in ("float32", "bfloat16"):
            for rate in (0.0, DROPOUT):
                calls = _bp_calls(torch, K, C, S, T, N, F, Kn, hidden, off,
                                  cd, rate, ins)
                for name, (kern, plain, flops, nbytes) in calls.items():
                    if rate and name.startswith("cond_em"):
                        continue  # the moment net has no dropout
                    what = (f"{name} S={S} N={N} offset {off} {cd} dropout "
                            f"{rate}")
                    out = kern(xb)
                    wide = kern(xw)
                    torch.cuda.synchronize()
                    same = all(torch.equal(o, w.to(o.dtype))
                               for o, w in zip(out, wide))
                    check(same and all(o.dtype == (torch.bfloat16 if
                                                   name.endswith("_dx")
                                                   else torch.float32)
                                       for o in out),
                          f"{what}: the bf16 panel is not bit for bit the "
                          f"same kernel on x.bfloat16().float()")
                    ref = plain(xb)
                    err, ok = 0.0, True
                    for o, r in zip(out, ref):
                        d = (o.float() - r.float()).abs()
                        scale = float(r.float().abs().max())
                        err = max(err, float(d.max()) / (scale or 1.0))
                        if name == "sdf_ffn_fwd":
                            ok &= within(d.cpu().numpy(),
                                         r.float().cpu().numpy(), cd,
                                         **F32_TOL)
                            continue
                        bar = (GRAD_F32_REL if cd == "float32"
                               else BF16_REL) * scale
                        if name.endswith("_dx"):
                            ok &= bool((d <= bar + _bf16_ulp(torch, r)).all())
                        else:
                            ok &= float(d.max()) <= bar
                        ok &= bool(torch.isfinite(o).all())
                    check(ok, f"{what}: disagrees with its plain version on "
                              f"the bf16 panel, max|d|/max|ref| {err:.3e}")
                    if N != BP_ROW_N or (rate == 0.0) != name.startswith(
                            "cond_em"):
                        continue
                    ms = cuda_ms(torch, lambda: kern(xb), reps=10, warmup=2)
                    f32_ms = cuda_ms(torch, lambda: kern(xf), reps=10,
                                     warmup=2)
                    plain_ms = cuda_ms(torch, lambda: plain(xb), reps=3,
                                       warmup=1)
                    b_ms, b_by = bound(flops, nbytes(2), cd)
                    f_ms, f_by = bound(flops, nbytes(4), cd)
                    print(f"[bf16 panel] {name:11s} S={S} T={T} N={N} {cd:8s}"
                          f" dropout {rate:.2f}: max|d|/max|ref| {err:.2e}; "
                          f"bf16 panel {ms:.4f} ms (bound {b_ms:.4f}, "
                          f"{b_by}), f32 panel {f32_ms:.4f} ms (bound "
                          f"{f_ms:.4f}, {f_by}), plain {plain_ms:.4f} ms "
                          f"({card})", flush=True)
                    rows[(name, S, cd)] = dict(
                        max_abs_err=max(float((o.float() - r.float()).abs()
                                              .max())
                                        for o, r in zip(out, ref)),
                        ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by, library_ms=None, f32_panel_ms=f32_ms,
                        f32_panel_bound_ms=f_ms, f32_panel_bound_by=f_by,
                        shape=f"S={S} T={T} N={N} F={F} {cd} dropout {rate}"
                              f" bf16 panel")
                    del ref
            print(f"[bf16 panel] S={S} N={N} offset {off} {cd}: the six "
                  f"kernels bit for bit on x.bfloat16().float(), within "
                  f"their bars of the plain versions ({card})", flush=True)
    return rows


def _bp_selected(hist):
    """Per phase, the epoch (within the phase) of the best valid Sharpe."""
    out = {}
    for p in dict.fromkeys(hist["phase"].tolist()):
        at = np.flatnonzero(hist["phase"] == p)
        out[str(p)] = int(np.argmax(hist["valid_sharpe"][at]))
    return out


def bf16panel_train_checks(torch, K, C, card, splits):
    """(b) Phase 6's model, bf16 compute: the default ExecutionConfig (the
    bf16 panel; the main path run, its launches counted) bit for bit the
    run with bf16_panel=False (histories, selected epochs, final params);
    then f32 compute on the bf16 panel, the kernel route against the plain
    route fed the same bf16 panel, at the training bars. Returns (the
    bf16-panel forms' launches, the walls and peaks)."""
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
    check(ExecutionConfig(device=DEVICE).stores_bf16_panel(cfg),
          "the default ExecutionConfig does not store a bf16 panel on the "
          "card")

    def run(exec_cfg, b=batches, tc=tcfg):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, params, hist, trainer = trainer_mod.train_3phase(
            cfg, *b, tcfg=tc, seed=42, verbose=False, exec_cfg=exec_cfg)
        torch.cuda.synchronize()
        return dict(params=params, hist=hist, epoch_ms=trainer.epoch_ms(),
                    wall=time.perf_counter() - t0,
                    peak_mb=torch.cuda.max_memory_allocated() / 2 ** 20)

    default = ExecutionConfig(device=DEVICE)
    run(default, tc=TrainConfig(1, 1, 1, ignore_epoch=0))  # set-up
    K.reset_launch_count()
    C.reset_launch_count()
    bp = run(default)
    launches = dict(zip(BP_KERNELS, bf16_panel_counts(K, C)))
    totals = dict(zip(BP_TRAIN_KERNELS, counts(K, C)))
    n_epochs = {"unconditional": SCHEDULE["num_epochs_unc"],
                "moment": SCHEDULE["num_epochs_moment"],
                "conditional": SCHEDULE["num_epochs"]}
    for i, name in enumerate(BP_TRAIN_KERNELS):
        want = sum(n * PER_EPOCH[p][i] for p, n in n_epochs.items())
        check(launches[name] == totals[name] == want,
              f"the bf16-panel training launched {name} {totals[name]} "
              f"times, {launches[name]} on the bf16 panel, not {want}")
    fp = run(dataclasses.replace(default, bf16_panel=False))
    check(set(bp["hist"]) == set(fp["hist"])
          and all(np.array_equal(bp["hist"][k], fp["hist"][k])
                  for k in bp["hist"]),
          "bf16 compute: the bf16-panel history is not bit for bit the f32 "
          "panel's")
    check(all(torch.equal(bp["params"][k], fp["params"][k])
              for k in fp["params"]),
          "bf16 compute: the bf16-panel final params are not bit for bit "
          "the f32 panel's")
    sel = _bp_selected(bp["hist"])
    check(sel == _bp_selected(fp["hist"]), "selected epochs differ")
    fmt = lambda d: ", ".join(f"{k} {v:.2f}" for k, v in d.items())  # noqa: E731
    print(f"[bf16 panel train] phase 6's model, bf16 compute, 8/4/16: the "
          f"bf16 panel bit for bit the f32 panel (histories, selected epochs "
          f"{sel}, final params); launches on the bf16 panel {launches} "
          f"({card})", flush=True)
    for tag, r in (("bf16 panel", bp), ("f32 panel", fp)):
        print(f"[bf16 panel train] {tag}: wall ms per epoch {fmt(r['epoch_ms'])}"
              f"; run {r['wall']:.2f} s; peak allocated {r['peak_mb']:.1f} "
              f"MiB ({card})", flush=True)
    # f32 compute on the bf16 panel: the kernel route (the default panel)
    # against the plain route fed the same bf16 panel
    b16 = [dict(b, individual_t=b["individual"].permute(0, 2, 1).contiguous()
                .to(torch.bfloat16)) for b in batches]
    on = run(ExecutionConfig(kernel="on", compute_dtype="float32",
                             device=DEVICE))
    off = run(ExecutionConfig(kernel="off", compute_dtype="float32",
                              device=DEVICE), b=b16)
    dev_loss = max(float(np.max(np.abs(on["hist"][k] - off["hist"][k])
                             / np.maximum(np.abs(off["hist"][k]), 1e-12)))
                   for k in ("train_loss", "valid_loss", "test_loss"))
    dev_sharpe = max(float(np.max(np.abs(on["hist"][k] - off["hist"][k])))
                     for k in ("train_sharpe", "valid_sharpe",
                               "test_sharpe"))
    check(all(np.isfinite(on["hist"][k]).all() for k in on["hist"]
              if k != "phase"), "non-finite f32 bf16-panel history")
    check(dev_loss <= 1e-3 and dev_sharpe <= 5e-3,
          f"f32 compute on the bf16 panel, kernel vs plain: loss rel dev "
          f"{dev_loss:.3e} (bar 1e-3), Sharpe dev {dev_sharpe:.3e} (bar "
          f"5e-3)")
    print(f"[bf16 panel train] f32 compute on the bf16 panel, kernel vs the "
          f"plain route on the same panel, every epoch: max loss rel dev "
          f"{dev_loss:.3e} (bar 1e-3), max Sharpe dev {dev_sharpe:.3e} (bar "
          f"5e-3); selected epochs {_bp_selected(on['hist'])} / "
          f"{_bp_selected(off['hist'])}; wall ms per epoch kernel "
          f"{fmt(on['epoch_ms'])}; peak {on['peak_mb']:.1f} MiB ({card})",
          flush=True)
    return launches, {
        "bf16_panel": dict(epoch_ms=bp["epoch_ms"], peak_mib=bp["peak_mb"]),
        "f32_panel": dict(epoch_ms=fp["epoch_ms"], peak_mib=fp["peak_mb"])}


def bf16panel_ensemble_checks(torch, K, C, card, splits):
    """(c) The nine seeds (S = 9), bf16 compute: the bf16 panel bit for bit
    the f32 panel; ensemble_metrics on a batch prepared for training (its
    bf16 panel) bit for bit the f32 batch's. Returns (cfg, the members)."""
    from deeplearninginassetpricing_paperreplication_torch.models.gan import \
        GAN
    from deeplearninginassetpricing_paperreplication_torch.parallel import (
        ensemble as ens_mod,
    )
    from deeplearninginassetpricing_paperreplication_torch.utils.config \
        import ExecutionConfig, GANConfig, TrainConfig

    train, valid, test = splits
    cfg = GANConfig(macro_feature_dim=train.macro_feature_dim,
                    individual_feature_dim=train.individual_feature_dim,
                    dropout=DROPOUT)
    tcfg = TrainConfig(**SCHEDULE, print_freq=10 ** 6)
    batches = [ds.to_batch(DEVICE) for ds in (train, valid, test)]
    default = ExecutionConfig(device=DEVICE)
    res = {}
    for tag, ex in (("bf16", default),
                    ("f32", dataclasses.replace(default, bf16_panel=False))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[tag] = ens_mod.train_ensemble(cfg, *batches, seeds=ENSEMBLE_SEEDS,
                                          tcfg=tcfg, verbose=False,
                                          exec_cfg=ex)
        torch.cuda.synchronize()
        res[tag] += (time.perf_counter() - t0,)
    (pb, hb, wb), (pf, hf, wf) = res["bf16"], res["f32"]
    check(all(np.array_equal(np.asarray(hb[k]), np.asarray(hf[k]))
              for k in hf)
          and all(torch.equal(pb[k], pf[k]) for k in pf),
          "S = 9, bf16 compute: the bf16-panel ensemble is not bit for bit "
          "the f32 panel's")
    prepared = GAN(cfg, default).prepare_batch(test.to_batch(DEVICE))
    check(prepared["individual_t"].dtype == torch.bfloat16,
          "the training-prepared batch has no bf16 panel")
    m_b = ens_mod.ensemble_metrics(cfg, pb, prepared, default)
    m_f = ens_mod.ensemble_metrics(cfg, pb, test.to_batch(DEVICE), default)
    check(all(np.array_equal(m_b[k], m_f[k]) for k in m_f),
          "ensemble_metrics on a bf16-prepared batch is not bit for bit the "
          "f32 batch's")
    print(f"[bf16 panel ensemble] S={len(ENSEMBLE_SEEDS)}, bf16 compute, "
          f"8/4/16: the bf16 panel bit for bit the f32 panel (histories, "
          f"final params; {wb:.2f} s / {wf:.2f} s); ensemble_metrics on a "
          f"bf16-prepared test batch bit for bit the f32 batch's (test "
          f"Sharpe {float(m_f['ensemble_sharpe']):.6f}) ({card})",
          flush=True)
    return cfg, pb


def bf16panel_gradient_checks(torch, K, C, card, splits, cfg, params):
    """(d) The panel gradient of the conditional loss of S = 9 members,
    bf16 compute, through the bf16 panel: the kernel route against the
    plain route fed the same bf16 panel (bar 2e-2·max|ref|); one call's
    launches, every one on the bf16 panel. Returns those launches."""
    from deeplearninginassetpricing_paperreplication_torch.models.gan import \
        GAN
    from deeplearninginassetpricing_paperreplication_torch.utils.config \
        import ExecutionConfig

    batch = splits[0].to_batch(DEVICE)
    params = {k: v.detach() for k, v in params.items()}
    S = params["sdf_net.output_proj.bias"].shape[0]

    def grad(kernel, bf16_t):
        gan = GAN(cfg, ExecutionConfig(kernel=kernel, device=DEVICE))
        ind = batch["individual"].clone().requires_grad_()
        b = dict(batch, individual=ind)
        if bf16_t:  # the same bf16 panel for the plain route
            b["individual_t"] = ind.permute(0, 2, 1).contiguous().to(
                torch.bfloat16)
        res = gan.forward_members(params, b, "conditional")
        (dx,) = torch.autograd.grad(res["loss"].sum(), ind)
        return dx

    grad("on", False)  # warm-up
    torch.cuda.synchronize()
    K.reset_launch_count()
    C.reset_launch_count()
    on = grad("on", False)
    torch.cuda.synchronize()
    got = bf16_panel_counts(K, C)
    check(got == PANEL_GRAD_LAUNCHES
          and panel_counts(K, C) == PANEL_GRAD_LAUNCHES,
          f"one bf16-panel conditional panel gradient launched {got} on the "
          f"bf16 panel (of {panel_counts(K, C)}), not {PANEL_GRAD_LAUNCHES}")
    off = grad("off", True)
    err = rel_err(on, off)
    check(on.dtype == torch.float32 and bool(torch.isfinite(on).all())
          and err <= BF16_REL,
          f"the bf16-panel panel gradient, kernel vs plain: max|d|/max|ref| "
          f"{err:.3e} (bar {BF16_REL:g})")
    f32p = GAN(cfg, ExecutionConfig(bf16_panel=False, device=DEVICE))
    ind = batch["individual"].clone().requires_grad_()
    (ref32,) = torch.autograd.grad(f32p.forward_members(
        params, dict(batch, individual=ind), "conditional")["loss"].sum(),
        ind)
    print(f"[bf16 panel grad] S={S}, bf16 compute, conditional loss: one call "
          f"launched {got} on the bf16 panel; kernel vs plain on the same "
          f"panel max|d|/max|ref| {err:.2e} (bar {BF16_REL:g}); against the "
          f"f32 panel's kernel route {rel_err(on, ref32):.2e} (its dx summed "
          f"in f32, not rounded to bf16) ({card})", flush=True)
    return dict(zip(BP_KERNELS, got))


def bf16panel_phase(torch, K, C, card, splits):
    """Phase 20: (a) the six kernels on a bf16 panel, (b) phase 6's model,
    (c) the nine seeds, (d) the panel gradient. Returns the rows, the
    bf16-panel forms' launches by path, and (b)'s walls and peaks."""
    t0 = time.perf_counter()
    bf16panel_plan_lines(torch, K, C, card)
    rows = bf16panel_kernel_checks(torch, K, C, card)
    train_launches, memory = bf16panel_train_checks(torch, K, C, card, splits)
    cfg, members = bf16panel_ensemble_checks(torch, K, C, card, splits)
    grad_launches = bf16panel_gradient_checks(torch, K, C, card, splits, cfg,
                                              members)
    by_path = {name: {p: n for p, n in (("bf16panel_training",
                                         train_launches[name]),
                                        ("bf16panel_gradient",
                                         grad_launches[name])) if n}
               for name in BP_KERNELS}
    print(f"[bf16 panel] phase 20 done in {time.perf_counter() - t0:.1f} s "
          f"({card})", flush=True)
    return dict(rows=rows, launches=by_path, memory=memory)


# -- phase 21 -------------------------------------------------------------------

SH_DIR = ROOT / "_smoke_shapes"
# (a) the stacks the resident kernels cannot hold, F = 46, and the paper's
# widths at F = 256 (the panel cotangent and the bf16 forward stream there)
SH_STACKS = [((256, 256), 46), ((132,), 46), ((64,) * 12, 46),
             ((64,) * 16, 46), ((64, 64), 256)]
SH_T = 6  # the checks' periods (the plain versions at S = 9 hold
# [S, T, H, N] activations and int64 dropout bits per layer)
SH_N = 10_000
SH_RATES = (0.0, 0.1)
SH_KS = (17, 32)  # moment chunks: 9 + 8, 16 + 16
SH_ROW = (48, 10_000)  # the timed shape: the training panel's T, N
SH_C11 = [(1, 48, 10_000, 5, k) for k in (1, 4, 8)]  # F ≤ 6, S = 1, f32
# the forward/backward agreement: units j of kout = e_j, and the (period,
# stock) of the one-hot g (a stock inside a tile, not its first)
SH_AGREE_UNITS = tuple(range(0, 256, 17))  # 16 units, 0 … 255
SH_AGREE_AT = (3, 5003)
# the panel cotangent's route 4: its audit and route 3 beside it at these
# stacks (≤ 4 layers: the top layer 256, 132 and 64 deep)
SH_AUDIT = [((256, 256), 46), ((132,), 46), ((64, 64), 256)]
# (b)-(d): the train CLI's shape range run
SH_HIDDEN = (256, 256)
SH_MOMENTS = 32
# route 5 against route 2: a nonzero stock offset (a stock shard's span
# start), beside offset 0; and a stack beside SH_STACKS whose route-5 plans
# take tile 32 and a two-pass layer (320 units)
SH_OFFSET = 2_500
SH_TILED_EXTRA = [((320, 320), 46)]
# route 5 against route 2 in turns, (hidden, F, S): the training shape at S
# = 1 and 9, and at S = 1 every other stack whose route-5 tile fits: (132,)
# (a 144-unit pass of 256), the 64-wide stacks (a quarter of a pass; (64,
# 64) at F = 256 plans the resident kernels), the plans at tile 32 ((320,
# 320); the backward of (384,) and of 3 × 256), and the forward's boundary
# (K.STREAM_TILED_NARROW): 96 units, and 64 units where route 2 takes tile
# 32 (F = 1024) or 64 (F = 512)
SH_TILED_TURNS = ([(SH_HIDDEN, 46, 1), (SH_HIDDEN, 46, 9)]
                  + [(h, F, 1) for h, F in SH_STACKS[1:] + SH_TILED_EXTRA
                     + [((384,), 46), ((256,) * 3, 46), ((96, 96), 384),
                        ((64, 64), 1024), ((64,) * 3, 512)]])
# the plans whose tile buffers sit in global scratch (route 2 f32, route 3
# bf16: every kernel's at (1536,)), launched at a small depth (T, N)
SH_SCRATCH = ((1536,), 46)
SH_SCRATCH_DEPTH = (2, 2_048)
SH_EPOCHS = (4, 2, 4)
SH_KERNELS = ("sdf_ffn_fwd", "sdf_ffn_bwd", "sdf_ffn_dx", "cond_em_fwd",
              "cond_em_bwd", "cond_em_dx")


def stream_counts(K):
    """The streamed route's launches (forward, backward, panel cotangent)."""
    return (K.launches_stream, K.bwd_launches_stream, K.dx_launches_stream)


def _stack_text(hidden) -> str:
    return (f"{list(hidden)}" if len(hidden) <= 3
            else f"{len(hidden)}x{hidden[0]}")


def shapes_plan_lines(torch, K, card):
    """Each FFN kernel's plan at SH_STACKS, S = 1 and 9, T = 48, N =
    10,000, both computes, on the f32 and bf16 panels, as the card holds
    it: the route (2/3 streamed), tile, shared memory, scratch floats a
    block, resident blocks, G, registers, local bytes. Fails if a streamed
    plan is held with fewer blocks than planned or spills. Returns
    {(stack, F, kernel, cd, xb16): the held plan at S = 1}."""
    dev = torch.device(DEVICE)
    T, N = SH_ROW
    held = {}
    for hidden, F in SH_STACKS:
        lay = K.ffn_layout(F, hidden)
        for S in (1, 9):
            for cd in ("float32", "bfloat16"):
                for xb16 in (False, True):
                    for kernel in ("fwd", "bwd", "dx"):
                        if kernel == "fwd":
                            plan = K.card_fwd_plan(lay, dev, S, T, N, cd,
                                                   xb16)
                            info = K.fwd_plan_info(lay, S, plan, xb16)
                        elif kernel == "bwd":
                            plan = K.card_bwd_plan(lay, dev, S, T, N,
                                                   xb16=xb16,
                                                   compute_dtype=cd)
                            info = K.bwd_plan_info(lay, plan, xb16)
                        else:
                            plan = K.card_dx_plan(lay, dev, S, T, N, cd,
                                                  xb16=xb16)
                            info = K.dx_plan_info(lay, S, cd, plan,
                                                  xb16=xb16)
                        if K.is_stream(plan):
                            check(info["blocks_per_sm"] >= plan.blocks_per_sm
                                  and info["local_bytes"] == 0,
                                  f"sdf_ffn_{kernel}_stream plan {plan}: "
                                  f"the card holds {info}")
                        if S == 1:
                            held[(hidden, F, kernel, cd, xb16)] = dict(
                                route=plan.route, tile=plan.tile,
                                smem_bytes=plan.smem_bytes,
                                scratch_floats=plan.scratch,
                                blocks_per_sm=info["blocks_per_sm"],
                                G=plan.G, registers=info["registers"],
                                local_bytes=info["local_bytes"])
                        print(f"[shapes] {kernel} plan hidden="
                              f"{_stack_text(hidden)} F={F} S={S} {cd:8s} "
                              f"{'bf16' if xb16 else 'f32 '} panel: route "
                              f"{plan.route} tile {plan.tile} smem "
                              f"{plan.smem_bytes} B scratch {plan.scratch} "
                              f"floats/block resident {info['blocks_per_sm']}"
                              f"/SM (planned {plan.blocks_per_sm}) G "
                              f"{plan.G} regs {info['registers']} local "
                              f"{info['local_bytes']} B ({card})",
                              flush=True)
    return held


def _sh_check(torch, name, cd, out, wide, ref, what):
    """A kernel's outputs on the bf16 panel bit for bit its outputs on the
    widened panel (`wide`, None on the f32 panel), and within the bars of
    phase 3 of the plain version's. Returns max|d|/max|ref|."""
    if wide is not None:
        check(all(torch.equal(o, w.to(o.dtype)) for o, w in zip(out, wide)),
              f"{what}: the bf16 panel is not bit for bit the same kernel on"
              f" x.bfloat16().float()")
    err, ok = 0.0, True
    for o, r in zip(out, ref):
        d = (o.float() - r.float()).abs()
        scale = float(r.float().abs().max())
        err = max(err, float(d.max()) / (scale or 1.0))
        ok &= bool(torch.isfinite(o).all())
        if name == "sdf_ffn_fwd":
            ok &= within(d.cpu().numpy(), r.float().cpu().numpy(), cd,
                         **F32_TOL)
            continue
        bar = (GRAD_F32_REL if cd == "float32" else BF16_REL) * scale
        if name.endswith("_dx") and o.dtype == torch.bfloat16:
            ok &= bool((d <= bar + _bf16_ulp(torch, r)).all())
        else:
            ok &= float(d.max()) <= bar
    check(ok, f"{what}: disagrees with its plain version, max|d|/max|ref| "
              f"{err:.3e}")
    return err


def _sh_inputs(torch, g, S, T, N, F, hidden, Kn, dev):
    """The six kernels' inputs past the panel (_bp_calls' `ins`)."""
    zp1, k1T, mids, kout, bout = _ffn_params(torch, g, S, F, list(hidden),
                                            dev)
    zp = (zp1 + torch.randn(S, T, hidden[0], generator=g,
                            device=dev) * 0.3).contiguous()
    gout = torch.randn(S, T, N, generator=g, device=dev) / N
    seed = 7 if S == 1 else list(range(7, 7 + S))
    _, zpm, xr, tinv, kT, gem = _cem_inputs(torch, g, S, T, N, F, Kn, dev)
    return zp, k1T, mids, kout, bout, gout, seed, zpm, xr, tinv, kT, gem


def shapes_kernel_checks(torch, K, C, card):
    """(a) The three FFN kernels at SH_STACKS (the streamed route where the
    resident one cannot hold the stack), S = 1 and 9, both computes, both
    panels, dropout 0 and 0.1; the three conditional-EM kernels at K = 17
    and 32 (moment chunks), S = 1 and 9, both computes, both panels; and
    cond_em_dx at F ≤ 6, S = 1, f32 (C11). Each against its plain version
    at the bars of phase 3, twice bit for bit, and on the bf16 panel bit
    for bit on the widened panel. Then the timed rows
    (:func:`shapes_kernel_rows`)."""
    walls, t = {}, time.perf_counter()  # (a)'s parts, for the log
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(21)
    T, N = SH_T, SH_N
    streamed = {}
    print(f"[shapes] the FFN kernels at {len(SH_STACKS)} stacks, T={T} "
          f"N={N}, and the conditional EM at K={list(SH_KS)} ({card})",
          flush=True)

    def run(name, kern, plain, x, cd, what):
        xb = x.to(torch.bfloat16)
        for panel in (x, xb):
            w = f"{what} {'bf16' if panel is xb else 'f32'} panel"
            out = kern(panel)
            again = kern(panel)
            wide = kern(panel.float()) if panel is xb else None
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(out, again)),
                  f"{w}: not bit for bit repeatable")
            _sh_check(torch, name, cd, out, wide, plain(panel), w)
            del out, again, wide

    dx_mma = {}  # the panel cotangent's tensor-core launches of each case
    for hidden, F in SH_STACKS:
        for S in (1, 9):
            x = torch.randn(T, F, N, generator=g, device=dev)
            ins = _sh_inputs(torch, g, S, T, N, F, hidden, 8, dev)
            for cd in ("float32", "bfloat16"):
                for rate in SH_RATES:
                    calls = _bp_calls(torch, K, C, S, T, N, F, 8,
                                      list(hidden), 0, cd, rate, ins)
                    K.reset_launch_count()
                    for name in SH_KERNELS[:3]:
                        kern, plain, _, _ = calls[name]
                        run(name, kern, plain, x, cd,
                            f"{name} hidden={_stack_text(hidden)} F={F} "
                            f"S={S} {cd} dropout {rate}")
                    torch.cuda.synchronize()
                    for name, n in zip(SH_KERNELS[:3], stream_counts(K)):
                        streamed[(name, hidden, F, S, cd)] = n > 0
                    dx_mma[(hidden, F, S, cd, rate)] = (
                        K.dx_launches_stream_mma, K.dx_launches)
            print(f"[shapes] hidden={_stack_text(hidden)} F={F} S={S}: fwd,"
                  f" bwd, dx within their bars (both computes, panels, "
                  f"dropout {list(SH_RATES)}), bit for bit repeatable; "
                  f"streamed: "
                  + ", ".join(f"{n[8:]} {cd}" for (n, h, f, s, cd), on
                              in streamed.items()
                              if on and (h, f, s) == (hidden, F, S))
                  + f" ({card})", flush=True)
            del x, ins
    for hidden, F in SH_STACKS[:4]:
        for name in SH_KERNELS[:3]:
            check(all(streamed[(name, hidden, F, S, cd)] for S in (1, 9)
                      for cd in ("float32", "bfloat16")),
                  f"{name} did not take the streamed route at hidden="
                  f"{_stack_text(hidden)}")
    # the panel cotangent's route: 4 (tensor cores) under bf16 compute at
    # most STREAM_MMA_MAX_LAYERS deep, else 3; never under f32. Each case
    # made 5 launches (two a panel and the widened one)
    for (hidden, F, S, cd, rate), (mma, total) in dx_mma.items():
        want = (5 if cd == "bfloat16"
                and len(hidden) <= K.STREAM_MMA_MAX_LAYERS else 0)
        check(total == 5 and mma == want,
              f"sdf_ffn_dx hidden={_stack_text(hidden)} F={F} S={S} {cd} "
              f"dropout {rate}: {mma} of {total} launches on route 4, not "
              f"{want}")
    print(f"[shapes] sdf_ffn_dx under bf16 compute on route 4 (tensor "
          f"cores) at "
          + ", ".join(f"{_stack_text(h)} F={f}" for h, f in SH_STACKS
                      if len(h) <= K.STREAM_MMA_MAX_LAYERS)
          + ", route 3 at "
          + ", ".join(f"{_stack_text(h)} F={f}" for h, f in SH_STACKS
                      if len(h) > K.STREAM_MMA_MAX_LAYERS)
          + f"; f32 never on route 4 ({card})", flush=True)
    for Kn in SH_KS:
        n = len(C.moment_chunks(Kn))
        for S in (1, 9):
            x = torch.randn(T, 46, N, generator=g, device=dev)
            ins = _sh_inputs(torch, g, S, T, N, 46, (64, 64), Kn, dev)
            for cd in ("float32", "bfloat16"):
                calls = _bp_calls(torch, K, C, S, T, N, 46, Kn, [64, 64], 0,
                                  cd, 0.0, ins)
                C.reset_launch_count()
                for name in SH_KERNELS[3:]:
                    kern, plain, _, _ = calls[name]
                    run(name, kern, plain, x, cd, f"{name} K={Kn} S={S} {cd}")
                torch.cuda.synchronize()
                # per kernel: two calls and a widened one on the bf16
                # panel, two on the f32 panel; one launch a chunk
                got = (C.fwd_launches, C.bwd_launches, C.dx_launches)
                check(got == (5 * n,) * 3,
                      f"K={Kn}: the conditional EM launched {got}, not "
                      f"{5 * n} each ({n} chunks a call)")
            print(f"[shapes] cond_em fwd, bwd, dx K={Kn} ({n} chunks) S={S}:"
                  f" within their bars (both computes, panels), bit for bit "
                  f"repeatable ({card})", flush=True)
            del x, ins
    for S, Tc, Nc, F, Kn in SH_C11:
        x = torch.randn(Tc, F, Nc, generator=g, device=dev)
        _, zpm, xr, tinv, kT, gem = _cem_inputs(torch, g, S, Tc, Nc, F, Kn,
                                                dev)
        plan = C.card_cem_dx_plan(dev, S, Tc, Nc, F, Kn, "float32")
        out = [C._launch_dx(x, zpm, xr, tinv, kT, gem, "float32")]
        torch.cuda.synchronize()
        err = _sh_check(torch, "cond_em_dx", "float32", out, None,
                        [C.cond_em_dx_reference(x, zpm, xr, tinv, kT, gem,
                                                "float32")],
                        f"cond_em_dx F={F} K={Kn} S={S} (C11)")
        print(f"[shapes] cond_em_dx F={F} K={Kn} S={S} T={Tc} N={Nc} f32 "
              f"(C11): plan route {plan.route} tile {plan.tile} threads "
              f"{plan.threads} G {plan.G}; max|d|/max|ref| {err:.2e} "
              f"({card})", flush=True)
    def lap(name):
        nonlocal t
        walls[name] = time.perf_counter() - t
        t = time.perf_counter()
    lap("kernel checks")
    shapes_agreement_check(torch, K, card)
    lap("agreement")
    scratch = shapes_scratch_checks(torch, K, C, card)
    lap("scratch plans")
    tiled = shapes_tiled_checks(torch, K, C, card)
    lap("route 5 bit for bit")
    audit = shapes_dx_audit(torch, K, card)
    lap("dx audit")
    rows = shapes_kernel_rows(torch, K, C, card)
    lap("timed rows")
    rows["dx_route4"] = dict(audit=audit, in_turns=shapes_dx_turns(
        torch, K, card))
    lap("dx route 4 turns")
    rows["route5"] = dict(bit_for_bit_route2=tiled,
                          in_turns=shapes_tiled_turns(torch, K, card))
    lap("route 5 turns")
    rows["scratch_plans"] = scratch
    print("[shapes] (a) walls: " + ", ".join(f"{k} {v:.1f} s"
                                             for k, v in walls.items())
          + f" ({card})", flush=True)
    return rows


def shapes_tiled_checks(torch, K, C, card):
    """(a) Route 5, the register-tiled f32 kernels, against route 2: the
    forward and backward launched on the same (tile, G)
    (K.stream_reference_plan: route 2's tiles in scratch where they do not
    fit shared memory), the panel cotangent on route 2's own card plan (its
    dx is route 2's at any plan); bit for bit on int views for each kernel
    route 5 plans at the SH_STACKS stacks and SH_TILED_EXTRA (the deep
    64-wide stacks' backward and dx; their forward keeps route 2), both
    panels, S = 1 and 9, dropout 0 and 0.1, stock offset 0 and SH_OFFSET;
    (b) each against its plain version at phase 3's bars. Each call of the
    card's plan must launch route 5 once. Returns {"stacks": [...],
    "calls": n}."""
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(29)
    T, N = SH_T, SH_N
    kinds = ("fwd", "bwd", "dx")

    def ints(t):
        return t.view(torch.int16 if t.dtype == torch.bfloat16
                      else torch.int32)
    stacks, compared, worst = [], 0, 0.0
    for hidden, F in SH_STACKS + SH_TILED_EXTRA:
        lay = K.ffn_layout(F, hidden)
        for S in (1, 9):
            x = torch.randn(T, F, N, generator=g, device=dev)
            ins = _sh_inputs(torch, g, S, T, N, F, hidden, 8, dev)
            zp, k1T, mids, kout, bout, gout, seed = ins[:7]
            packed = K.pack_ffn(k1T, mids, kout, bout, "float32")
            ran = []
            for xb in (x, x.to(torch.bfloat16)):
                xb16 = xb is not x
                plans = dict(
                    fwd=K.card_fwd_plan(lay, dev, S, T, N, "float32", xb16),
                    bwd=K.card_bwd_plan(lay, dev, S, T, N, xb16=xb16,
                                        compute_dtype="float32"),
                    dx=K.card_dx_plan(lay, dev, S, T, N, "float32",
                                      xb16=xb16))
                tiled = {k: p.route == K.STREAM_TILED_ROUTE
                         for k, p in plans.items()}
                check(tiled["bwd"] or not tiled["fwd"],
                      f"hidden={_stack_text(hidden)} F={F}: the f32 forward "
                      f"plans {plans['fwd']}, the backward {plans['bwd']}")
                ran = [k for k in kinds if tiled[k]]
                if not ran:
                    continue
                refs = {k: K.stream_reference_plan(lay, k, plans[k], S)
                        for k in ("fwd", "bwd") if tiled[k]}
                if tiled["dx"]:
                    refs["dx"] = _dx_cuda_core_plan(torch, K, lay, S, T, N,
                                                    xb16, "float32")
                for rate in SH_RATES:
                    for off in (0, SH_OFFSET):
                        what = (f"route 5 hidden={_stack_text(hidden)} F={F}"
                                f" S={S} {'bf16' if xb16 else 'f32'} panel "
                                f"dropout {rate} offset {off}")
                        K.reset_launch_count()
                        new = {}
                        if tiled["fwd"]:
                            new["fwd"] = [K._launch(xb, zp, packed, seed,
                                                    rate, off)]
                        if tiled["bwd"]:
                            new["bwd"] = list(K._launch_bwd(
                                xb, zp, packed, gout, seed, rate, None, off))
                        if tiled["dx"]:
                            new["dx"] = [K._launch_dx(xb, zp, packed, gout,
                                                      seed, rate, None, off)]
                        torch.cuda.synchronize()
                        n5 = (K.launches_stream_tiled,
                              K.bwd_launches_stream_tiled,
                              K.dx_launches_stream_tiled)
                        want = tuple(int(tiled[k]) for k in kinds)
                        check(n5 == want,
                              f"{what}: the card's plans launched route 5 "
                              f"{n5} times (forward, backward, dx), not "
                              f"{want}")
                        old = {}
                        if tiled["fwd"]:
                            o2 = torch.empty_like(new["fwd"][0])
                            K._stream_launch("fwd", xb, zp, packed,
                                             refs["fwd"], seed, rate, off,
                                             (o2,))
                            old["fwd"] = [o2]
                        if tiled["bwd"]:
                            old["bwd"] = list(K._launch_bwd(
                                xb, zp, packed, gout, seed, rate,
                                refs["bwd"], off))
                        if tiled["dx"]:
                            old["dx"] = [K._launch_dx(xb, zp, packed, gout,
                                                      seed, rate, refs["dx"],
                                                      off)]
                        torch.cuda.synchronize()
                        for k in ran:
                            ref = refs[k]
                            check(all(torch.equal(ints(a), ints(b))
                                      for a, b in zip(new[k], old[k])),
                                  f"sdf_ffn_{k} {what}: not bit for bit "
                                  f"route 2 at tile {ref.tile}, G {ref.G} "
                                  f"(scratch {ref.scratch} floats a block)")
                        calls = _bp_calls(torch, K, C, S, T, N, F, 8,
                                          list(hidden), off, "float32", rate,
                                          ins)
                        if tiled["fwd"]:
                            worst = max(worst, _sh_check(
                                torch, "sdf_ffn_fwd", "float32", new["fwd"],
                                None, calls["sdf_ffn_fwd"][1](xb),
                                "sdf_ffn_fwd " + what))
                        if tiled["bwd"]:
                            g5, z5 = new["bwd"]
                            dk1T, dmids, dkout, dbout = K.unpack_grads(g5, lay)
                            worst = max(worst, _sh_check(
                                torch, "sdf_ffn_bwd", "float32",
                                [z5, dk1T, dkout, dbout]
                                + [t for wb in dmids for t in wb], None,
                                calls["sdf_ffn_bwd"][1](xb),
                                "sdf_ffn_bwd " + what))
                        if tiled["dx"]:
                            worst = max(worst, _sh_check(
                                torch, "sdf_ffn_dx", "float32", new["dx"],
                                None, calls["sdf_ffn_dx"][1](xb),
                                "sdf_ffn_dx " + what))
                        compared += len(ran)
                        del new, old
            del x, ins, packed
            if not ran:
                continue
            stacks.append(f"{_stack_text(hidden)} F={F} S={S} "
                          f"{'/'.join(ran)}")
            print(f"[shapes tiled] hidden={_stack_text(hidden)} F={F} S={S} "
                  f"T={T} N={N}: route 5's {', '.join(ran)} ("
                  + ", ".join(f"{k} tile {plans[k].tile} G {plans[k].G}"
                              for k in ran)
                  + ") bit for bit route 2 ("
                  + ", ".join(f"{k} tile {refs[k].tile} G {refs[k].G}"
                              f"{' tiles in scratch' if refs[k].scratch else ''}"
                              for k in ran)
                  + f"), both panels, dropout {list(SH_RATES)}, offset 0 and "
                  f"{SH_OFFSET}; within phase 3's bars of plain ({card})",
                  flush=True)
    check(len(stacks) >= 10, f"route 5 planned at {stacks} only")
    print(f"[shapes tiled] {compared} calls bit for bit route 2 at "
          f"{stacks}; max|d|/max|ref| against plain {worst:.2e} ({card})",
          flush=True)
    return dict(stacks=stacks, calls=compared, max_rel_err_plain=worst)


def shapes_scratch_checks(torch, K, C, card):
    """(a) The streamed plans whose tile buffers sit in a global scratch
    slice a block (route 2 under f32 compute, route 3 under bf16): at
    SH_SCRATCH every FFN kernel's plan of both computes on both panels puts
    its tiles there. Each launched once at SH_SCRATCH_DEPTH, S = 1 and 3,
    dropout 0.1, its plan's scratch > 0, one streamed launch, against its
    plain version at phase 3's bars. Returns {"kernel cd panel S=s": plan
    and max|d|/max|ref|}."""
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(31)
    (hidden, F), (T, N) = SH_SCRATCH, SH_SCRATCH_DEPTH
    lay = K.ffn_layout(F, hidden)
    rate = 0.1
    out = {}
    for S in (1, 3):
        x = torch.randn(T, F, N, generator=g, device=dev)
        ins = _sh_inputs(torch, g, S, T, N, F, hidden, 8, dev)
        for cd in ("float32", "bfloat16"):
            calls = _bp_calls(torch, K, C, S, T, N, F, 8, list(hidden), 0,
                              cd, rate, ins)
            for xb in (x, x.to(torch.bfloat16)):
                xb16 = xb is not x
                panel = "bf16" if xb16 else "f32"
                plans = {
                    "sdf_ffn_fwd": K.card_fwd_plan(lay, dev, S, T, N, cd,
                                                   xb16),
                    "sdf_ffn_bwd": K.card_bwd_plan(lay, dev, S, T, N,
                                                   xb16=xb16,
                                                   compute_dtype=cd),
                    "sdf_ffn_dx": K.card_dx_plan(lay, dev, S, T, N, cd,
                                                 xb16=xb16)}
                for name, plan in plans.items():
                    what = (f"{name} hidden={_stack_text(hidden)} F={F} S={S}"
                            f" T={T} N={N} {cd} {panel} panel dropout "
                            f"{rate}")
                    check(plan.route == K.STREAM_ROUTES[cd]
                          and plan.scratch > 0,
                          f"{what}: the plan {plan} does not put its tiles "
                          f"in scratch")
                    kern, plain = calls[name][:2]
                    K.reset_launch_count()
                    res = kern(xb)
                    torch.cuda.synchronize()
                    n = stream_counts(K)[SH_KERNELS.index(name)]
                    check(n == 1, f"{what}: {n} streamed launches, not 1")
                    err = _sh_check(torch, name, cd, res, None, plain(xb),
                                    what)
                    out[f"{name[8:]} {cd} {panel} panel S={S}"] = dict(
                        route=plan.route, tile=plan.tile, G=plan.G,
                        scratch_floats=plan.scratch, max_rel_err_plain=err)
                    print(f"[shapes scratch] {what}: route {plan.route} tile "
                          f"{plan.tile} G {plan.G}, {plan.scratch} scratch "
                          f"floats a block; max|d|/max|ref| {err:.2e} "
                          f"({card})", flush=True)
                    del res
        del x, ins
    return out


def shapes_tiled_turns(torch, K, card):
    """(c) Route 5 against route 2 (each on its own plan, route 2's as PR 28
    planned it) at SH_TILED_TURNS, SH_ROW, dropout DROPOUT, f32 on the f32
    panel, timed in turns (route 2, 5, 5, 2; each the median of 3 timings
    of k calls back to back over k, k the calls in ~20 ms), the forward, the
    backward and the panel cotangent (where route 5's tile fits), with each
    instance's registers and local bytes. Route 5 must build with 0 B of
    local memory, and where the planner streams the stack
    (K.stream_route_plan) the route it picks must be the faster one in
    turns: a boundary of the plans is a reading of this table. Returns
    {"kernel stack S=s": {planned, route2_ms, route5_ms, plans}}."""
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(30)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    T, N = SH_ROW
    route2, route5 = K.STREAM_ROUTES["float32"], K.STREAM_TILED_ROUTE
    out, wrong = {}, []
    for hidden, F, S in SH_TILED_TURNS:
        lay = K.ffn_layout(F, hidden)
        x = torch.randn(T, F, N, generator=g, device=dev)
        zp, k1T, mids, kout, bout, gout, seed = _sh_inputs(
            torch, g, S, T, N, F, hidden, 8, dev)[:7]
        packed = K.pack_ffn(k1T, mids, kout, bout, "float32")
        for kernel in ("fwd", "bwd", "dx"):
            plans = {}
            for route in (route2, route5):
                try:
                    tile, smem, blocks, G, cells, scr = K.stream_plan(
                        lay, kernel, sms, S, T, N,
                        K._stream_registers(kernel, route, False), route)
                except ValueError:
                    continue  # a tile route 5 cannot hold
                threads = K.stream_threads(route)
                plans[route] = (
                    K.FwdPlan(route, tile, threads, 1, smem, blocks, G, cells,
                              scr) if kernel == "fwd"
                    else K.BwdPlan(tile, threads, smem, blocks, G, 0, route,
                                   scr) if kernel == "bwd"
                    else K.DxPlan(route, tile, threads, 2, 1, False, smem,
                                  blocks, G, cells, scr))
            if route5 not in plans:
                continue
            if kernel == "fwd":
                planned = K.card_fwd_plan(lay, dev, S, T, N, "float32").route
                info = {r: K.fwd_plan_info(lay, S, p)
                        for r, p in plans.items()}

                def run(p):
                    o = torch.empty(S, T, N, device=dev)
                    K._stream_launch("fwd", x, zp, packed, p, seed, DROPOUT,
                                     0, (o,))
                    return o
            elif kernel == "bwd":
                planned = K.card_bwd_plan(lay, dev, S, T, N).route
                info = {r: K.bwd_plan_info(lay, p) for r, p in plans.items()}

                def run(p):
                    return K._launch_bwd(x, zp, packed, gout, seed, DROPOUT,
                                         p)
            else:
                planned = K.card_dx_plan(lay, dev, S, T, N, "float32").route
                info = {r: K.dx_plan_info(lay, S, "float32", p)
                        for r, p in plans.items()}

                def run(p):
                    return K._launch_dx(x, zp, packed, gout, seed, DROPOUT,
                                        p)
            p2, p5 = plans[route2], plans[route5]
            check(info[route5]["local_bytes"] == 0
                  and info[route5]["blocks_per_sm"] >= p5.blocks_per_sm,
                  f"sdf_ffn_{kernel} {_stack_text(hidden)} S={S}: route 5's "
                  f"plan {p5}, the card holds {info[route5]}")
            # k calls back to back a timing (at least ~20 ms of work), so
            # the host's launch path hides behind the card's
            est = cuda_ms(torch, lambda: run(p5), reps=1, warmup=1)
            k = max(1, int(20.0 / max(est, 0.01)))

            def calls(p):
                for _ in range(k):
                    run(p)
            t = [cuda_ms(torch, lambda p=p: calls(p), reps=3, warmup=1) / k
                 for p in (p2, p5, p5, p2)]
            where = f"{_stack_text(hidden)} F={F} S={S}"
            out[f"{kernel} {where}"] = dict(
                planned=planned, route2_ms=[t[0], t[3]],
                route5_ms=[t[1], t[2]],
                route2_plan=dict(tile=p2.tile, G=p2.G, **info[route2]),
                route5_plan=dict(tile=p5.tile, G=p5.G, **info[route5]))
            print(f"[shapes tiled turns] sdf_ffn_{kernel} f32 {where} T={T} "
                  f"N={N} dropout {DROPOUT}: route 2 (tile {p2.tile}, G "
                  f"{p2.G}, {info[route2]['registers']} registers, "
                  f"{info[route2]['local_bytes']} B local) {t[0]:.4f} / "
                  f"{t[3]:.4f} ms, route 5 (tile {p5.tile}, G {p5.G}, "
                  f"{info[route5]['registers']} registers, "
                  f"{info[route5]['local_bytes']} B local) {t[1]:.4f} / "
                  f"{t[2]:.4f} ms ({k} calls a timing); planned route "
                  f"{planned} ({card})", flush=True)
            fast, slow = ((t[1:3], t[::3]) if planned == route5
                          else (t[::3], t[1:3]))
            if planned in plans and max(fast) >= min(slow):
                wrong.append(f"sdf_ffn_{kernel} {where}: the planned route "
                             f"{planned} ({fast[0]:.4f}, {fast[1]:.4f} ms) "
                             f"is not faster than the other ({slow[0]:.4f}, "
                             f"{slow[1]:.4f} ms)")
        del x
    check(not wrong, "; ".join(wrong))
    return out


def _dx_cuda_core_plan(torch, K, lay, S, T, N, xb16, cd="bfloat16"):
    """The streamed panel cotangent's plan on the CUDA-core route of `cd`
    (route 3 for bf16 compute, route 2 for f32) for this card, as the
    planner made it before the tensor-core and register-tiled routes:
    forced where `cd` plans route 4 or 5."""
    sms = torch.cuda.get_device_properties(DEVICE).multi_processor_count
    route = K.STREAM_ROUTES[cd]
    tile, smem, blocks, G, cells, scratch = K.stream_plan(
        lay, "dx", sms, S, T, N, K._stream_registers("dx", route, xb16),
        route)
    return K.DxPlan(route, tile, K.STREAM_THREADS, 2, 1, False, smem, blocks,
                    G, cells, scratch)


def shapes_dx_audit(torch, K, card):
    """(a) The streamed panel cotangent's route 4 at SH_AUDIT, S = 1 and
    9, dropout 0 and 0.1, on the bf16 panel (T = SH_T): its audit build
    computes the exact chain of every top-layer element beside its mma sum
    and must find 0 decisions flipped outside the certified window, its dx
    bit for bit the main library's; route 3 through a forced plan beside
    it, both against the plain version at phase 3's bars. Returns the
    counters summed over the cases (max_ratio their largest), with the
    windows."""
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(25)
    T, N = SH_T, SH_N
    total = dict.fromkeys(K.AUDIT_COUNTERS[:-1], 0)
    total["max_ratio"] = 0.0
    windows = {}
    for hidden, F in SH_AUDIT:
        lay = K.ffn_layout(F, hidden)
        depth = hidden[-2] if len(hidden) > 1 else F
        window = K.stream_certify_window(depth)
        windows[_stack_text(hidden) + f" F={F}"] = window
        for S in (1, 9):
            x = torch.randn(T, F, N, generator=g, device=dev).to(
                torch.bfloat16)
            zp, k1T, mids, kout, bout, gout, seed = _sh_inputs(
                torch, g, S, T, N, F, hidden, 8, dev)[:7]
            packed = K.pack_ffn(k1T, mids, kout, bout, "bfloat16")
            plan4 = K.card_dx_plan(lay, dev, S, T, N, "bfloat16", xb16=True)
            plan3 = _dx_cuda_core_plan(torch, K, lay, S, T, N, True)
            check(plan4.route == K.STREAM_MMA_ROUTE,
                  f"sdf_ffn_dx bf16 hidden={_stack_text(hidden)} F={F}: plan "
                  f"{plan4}, not route {K.STREAM_MMA_ROUTE}")
            for rate in SH_RATES:
                what = (f"sdf_ffn_dx route 4 hidden={_stack_text(hidden)} "
                        f"F={F} S={S} bf16 dropout {rate}")
                d4 = K._launch_dx(x, zp, packed, gout, seed, rate, plan4)
                da, counts = K.dx_audit(x, zp, packed, gout, seed, rate,
                                        plan4)
                d3 = K._launch_dx(x, zp, packed, gout, seed, rate, plan3)
                ref = K.sdf_ffn_dx_reference(x, zp, k1T, mids, kout, gout,
                                             "bfloat16", seed, rate)
                torch.cuda.synchronize()
                check(torch.equal(da.view(torch.int16), d4.view(torch.int16)),
                      f"{what}: the audit build's dx is not the main "
                      f"library's bit for bit")
                check(counts["elements"] == S * T * N * hidden[-1]
                      and counts["flips_outside"] == 0,
                      f"{what}: the audit counted {counts}")
                e4 = _sh_check(torch, "sdf_ffn_dx", "bfloat16", [d4], None,
                               [ref], what)
                e3 = _sh_check(torch, "sdf_ffn_dx", "bfloat16", [d3], None,
                               [ref], what.replace("route 4", "route 3"))
                d43 = float((d4.float() - d3.float()).abs().max()) / float(
                    ref.float().abs().max())
                for k in K.AUDIT_COUNTERS[:-1]:
                    total[k] += counts[k]
                total["max_ratio"] = max(total["max_ratio"],
                                         counts["max_ratio"])
                print(f"[shapes dx audit] {what}: {counts['elements']} "
                      f"top-layer decisions, {counts['certified']} certified"
                      f" (recomputed), {counts['flips']} mma signs differ "
                      f"from the chain, {counts['flips_outside']} outside "
                      f"the window; max|mma - chain|/bound "
                      f"{counts['max_ratio']:.3e} (window {window:.3e}); "
                      f"audit kernel {counts['registers']} registers, "
                      f"{counts['local_bytes']} B local; "
                      f"max|d|/max|ref| route 4 {e4:.3e}, route 3 (forced "
                      f"plan, tile {plan3.tile}) {e3:.3e}, route 4 vs route "
                      f"3 {d43:.3e} ({card})", flush=True)
                del d4, da, d3, ref
            del x
    print(f"[shapes dx audit] route 4 at {len(SH_AUDIT)} stacks × S = 1, 9 × "
          f"dropout {list(SH_RATES)}: {total['elements']} decisions, "
          f"{total['certified']} certified, {total['flips']} mma flips, "
          f"{total['flips_outside']} outside the window; max|mma - chain|/"
          f"bound {total['max_ratio']:.3e}; windows {windows} ({card})",
          flush=True)
    return dict(total, windows=windows)


def shapes_dx_turns(torch, K, card):
    """The streamed panel cotangent at (256, 256), F = 46, SH_ROW, dropout
    DROPOUT, bf16 compute on the bf16 panel: route 3 (a forced plan) and
    route 4 (the card's plan) timed in turns (route 3, 4, 4, 3) at S = 1
    and 9, after holding route 4 at phase 3's bars against the plain
    version. Returns {S: {route3_ms: [a, b], route4_ms: [a, b]}}."""
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(26)
    T, N = SH_ROW
    F, hidden = 46, SH_HIDDEN
    lay = K.ffn_layout(F, hidden)
    out = {}
    for S in (1, 9):
        x = torch.randn(T, F, N, generator=g, device=dev).to(torch.bfloat16)
        zp, k1T, mids, kout, bout, gout, seed = _sh_inputs(
            torch, g, S, T, N, F, hidden, 8, dev)[:7]
        packed = K.pack_ffn(k1T, mids, kout, bout, "bfloat16")
        plan4 = K.card_dx_plan(lay, dev, S, T, N, "bfloat16", xb16=True)
        plan3 = _dx_cuda_core_plan(torch, K, lay, S, T, N, True)

        def r3():
            return K._launch_dx(x, zp, packed, gout, seed, DROPOUT, plan3)

        def r4():
            return K._launch_dx(x, zp, packed, gout, seed, DROPOUT, plan4)
        ref = K.sdf_ffn_dx_reference(x, zp, k1T, mids, kout, gout,
                                     "bfloat16", seed, DROPOUT)
        err = _sh_check(torch, "sdf_ffn_dx", "bfloat16", [r4()], None, [ref],
                        f"sdf_ffn_dx route 4 at its timed shape S={S}")
        del ref
        t = [cuda_ms(torch, f, reps=3, warmup=1) for f in (r3, r4, r4, r3)]
        out[S] = dict(route3_ms=[t[0], t[3]], route4_ms=[t[1], t[2]],
                      route3_tile=plan3.tile, route4_tile=plan4.tile)
        print(f"[shapes dx turns] sdf_ffn_dx bf16 (bf16 panel) S={S} T={T} "
              f"N={N} hidden={list(hidden)} dropout {DROPOUT}: route 3 "
              f"(tile {plan3.tile}) {t[0]:.4f} / {t[3]:.4f} ms, route 4 "
              f"(tile {plan4.tile}) {t[1]:.4f} / {t[2]:.4f} ms; route 4 "
              f"max|d|/max|ref| {err:.2e} ({card})", flush=True)
        check(S == 1 or max(t[1], t[2]) < min(t[0], t[3]),
              f"sdf_ffn_dx S={S}: route 4 ({t[1]:.4f}, {t[2]:.4f} ms) is not "
              f"faster than route 3 ({t[0]:.4f}, {t[3]:.4f} ms)")
        del x
    return out


def _older_stream_libs(K, _nvcc, src_dir):
    """({kernel: ctypes function} of the streamed route's three kernels,
    {kernel: its tensor-core entry} of the forward and backward, {kernel:
    its register-tiled entry} where the older source has it) built from
    another checkout's sdf_ffn_stream.cu (src_dir holds it beside its
    sdf_ffn_common.cuh and panel.cuh, with this tree's argument lists of
    sdf_ffn_{fwd,bwd,dx}_stream, sdf_ffn_{fwd,bwd}_stream_mma and
    sdf_ffn_{fwd,bwd,dx}_stream_tiled), bound as this tree binds its own,
    one nvcc each, all started together."""
    import ctypes

    src = Path(src_dir).resolve()
    _nvcc.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, kernel in enumerate(K.KERNELS):
        out = _nvcc.BUILD_DIR / f"libsdf_ffn_{kernel}_stream_older.so"
        procs[kernel] = (out, subprocess.Popen(
            [_nvcc.nvcc(), *_nvcc.NVCC_FLAGS, f"-DSDF_FFN_STREAM_KERNEL={i}",
             "-o", str(out), str(src / K.STREAM_SOURCE)]))
    fns, mma, tiled = {}, {}, {}
    for kernel, (out, proc) in procs.items():
        check(proc.wait() == 0, f"the older {src.name}/{K.STREAM_SOURCE} "
              f"(kernel {kernel}) did not build")
        lib = ctypes.CDLL(str(out))
        fn = getattr(lib, f"sdf_ffn_{kernel}_stream")
        fn.argtypes = K._STREAM_ARGTYPES[kernel]
        fn.restype = ctypes.c_int
        fns[kernel] = fn
        if kernel != "dx":
            fn = getattr(lib, f"sdf_ffn_{kernel}_stream_mma")
            fn.argtypes = K._STREAM_MMA_ARGTYPES[kernel]
            fn.restype = ctypes.c_int
            mma[kernel] = fn
        if hasattr(lib, f"sdf_ffn_{kernel}_stream_tiled"):
            fn = getattr(lib, f"sdf_ffn_{kernel}_stream_tiled")
            fn.argtypes = K._STREAM_TILED_ARGTYPES[kernel]
            fn.restype = ctypes.c_int
            tiled[kernel] = fn
    return fns, mma, tiled


def compare_stream(torch, K, _nvcc, src_dir, card):
    """The streamed route's CUDA-core instances against an older source's
    (src_dir/sdf_ffn_stream.cu, this tree's argument lists) on the same
    plans (route 2 at f32, route 3 at bf16, as the card holds them): the
    f32 instances of all three kernels and the bf16-compute ones (route 3
    on a forced plan where bf16 compute now plans the tensor-core form) at
    phase 21's stacks,
    T = SH_T, S = 1 and 9, both panels, dropout 0 and 0.1, offset 0, bit for
    bit (int views of every output); then timed in turns (old, new, new,
    old) at (256, 256), SH_ROW, dropout 0.05: the forward and backward at
    S = 1, the panel cotangent at S = 9, f32 on the f32 panel and bf16 on
    the bf16 panel. Likewise the forward's and backward's tensor-core forms
    (route 4) where bf16 compute plans them, bit for bit and, at (256,
    256), S = 1, timed in turns; and the register-tiled f32 kernels (route
    5) where f32 compute plans them, bit for bit, or, where the older source
    has no such kernel, a line saying that its pairs were skipped."""
    olds, old_mma, old_tiled = _older_stream_libs(K, _nvcc, src_dir)
    dev = torch.device(DEVICE)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(23)
    name = Path(src_dir).name

    def caller(kernel, fn, x, zp, packed, plan, gout, seed, rate):
        S, lay = packed.n_members, packed.layout
        T, F, N = x.shape
        tile, smem, _, G, _, scratch = plan
        blocks = G * (S if kernel == "bwd" else 1)

        def run():
            drop, _bases = K._dropout_args(seed, rate, S, dev)
            if kernel == "fwd":
                outs = (torch.empty(S, T, N, device=dev),)
            elif kernel == "bwd":
                outs = (gout, torch.zeros(S, G, lay.P, device=dev),
                        torch.zeros(S, G, T, lay.hidden[0], device=dev))
            else:
                outs = (gout, torch.empty(T, F, N, dtype=x.dtype,
                                          device=dev))
            scr = (torch.empty(blocks * scratch, device=dev) if scratch
                   else None)
            rc = fn(*K._panel_args(x), zp.data_ptr(),
                    packed.params.data_ptr(), *(t.data_ptr() for t in outs),
                    None if scr is None else scr.data_ptr(),
                    K._layout_ints(lay), K._layout_dev(lay, dev).data_ptr(),
                    S, T, N, int(packed.compute_dtype == "bfloat16"), *drop,
                    tile, smem, G, torch.cuda.current_stream().cuda_stream)
            check(rc == 0, f"sdf_ffn_{kernel}_stream failed (code {rc})")
            return [o for o in outs if o is not gout]
        return run

    def mma_caller(kernel, fn, x, zp, packed, plan, gout, seed, rate):
        S, lay = packed.n_members, packed.layout
        T, F, N = x.shape
        tile, smem, _, G, _, _ = plan
        wb = K.stream_mma_weights(packed)
        wtab = torch.tensor(K.stream_mma_table(lay)[1], dtype=torch.int32,
                            device=dev)

        def run():
            drop, _bases = K._dropout_args(seed, rate, S, dev)
            if kernel == "fwd":
                outs = (torch.empty(S, T, N, device=dev),)
            else:
                outs = (gout, torch.zeros(S, G, lay.P, device=dev),
                        torch.zeros(S, G, T, lay.hidden[0], device=dev))
            rc = fn(*K._panel_args(x), zp.data_ptr(),
                    packed.params.data_ptr(), wb.data_ptr(), wtab.data_ptr(),
                    wb.shape[1], *(t.data_ptr() for t in outs),
                    K._layout_ints(lay), K._layout_dev(lay, dev).data_ptr(),
                    S, T, N, *drop, tile, smem, G,
                    torch.cuda.current_stream().cuda_stream)
            check(rc == 0, f"sdf_ffn_{kernel}_stream_mma failed (code {rc})")
            return [o for o in outs if o is not gout]
        return run

    def tiled_caller(kernel, fn, x, zp, packed, plan, gout, seed, rate):
        S, lay = packed.n_members, packed.layout
        T, F, N = x.shape
        tile, smem, _, G, _, _ = plan

        def run():
            drop, _bases = K._dropout_args(seed, rate, S, dev)
            if kernel == "fwd":
                outs = (torch.empty(S, T, N, device=dev),)
            elif kernel == "bwd":
                outs = (gout, torch.zeros(S, G, lay.P, device=dev),
                        torch.zeros(S, G, T, lay.hidden[0], device=dev))
            else:
                outs = (gout, torch.empty(T, F, N, dtype=x.dtype,
                                          device=dev))
            rc = fn(*K._panel_args(x), zp.data_ptr(),
                    packed.params.data_ptr(), *(t.data_ptr() for t in outs),
                    K._layout_ints(lay), K._layout_dev(lay, dev).data_ptr(),
                    S, T, N, *drop, tile, smem, G,
                    torch.cuda.current_stream().cuda_stream)
            check(rc == 0, f"sdf_ffn_{kernel}_stream_tiled failed (code "
                           f"{rc})")
            return [o for o in outs if o is not gout]
        return run

    def ints(t):
        return t.view(torch.int16 if t.dtype == torch.bfloat16
                      else torch.int32)

    def mma_plan_of(kernel, lay, S, T, N, xb16):
        regs = K._stream_registers(kernel, K.STREAM_MMA_ROUTE, xb16)
        return K.stream_plan(lay, kernel, sms, S, T, N, regs,
                             K.STREAM_MMA_ROUTE)

    def mma_pair(kernel, x, zp, packed, gout, seed, rate):
        plan = mma_plan_of(kernel, packed.layout, packed.n_members,
                           x.shape[0], x.shape[2], x.dtype == torch.bfloat16)
        new = getattr(K._load_stream(kernel), f"sdf_ffn_{kernel}_stream_mma")
        return (mma_caller(kernel, old_mma[kernel], x, zp, packed, plan,
                           gout, seed, rate),
                mma_caller(kernel, new, x, zp, packed, plan, gout, seed,
                           rate))

    def streams(kernel, lay, S, T, N, cd):
        if kernel == "fwd":
            plan = K.fwd_plan(lay, sms, S, T, N, cd)
        elif kernel == "bwd":
            plan = K.bwd_plan(lay, sms, S, T, N, compute_dtype=cd)
        else:
            plan = K.dx_plan(lay, sms, S, T, N, cd)
        return K.is_stream(plan)

    def plan_of(kernel, lay, S, T, N, cd, xb16):
        route = K.STREAM_ROUTES[cd]
        regs = K._stream_registers(kernel, route, xb16)
        return K.stream_plan(lay, kernel, sms, S, T, N, regs, route)

    kinds = [(k, cd) for cd in ("float32", "bfloat16") for k in K.KERNELS]
    compared, skipped = 0, set()
    for hidden, F in SH_STACKS:
        lay = K.ffn_layout(F, hidden)
        for S in (1, 9):
            T, N = SH_T, SH_N
            x = torch.randn(T, F, N, generator=g, device=dev)
            zp1, k1T, mids, kout, bout = _ffn_params(torch, g, S, F,
                                                    list(hidden), dev)
            zp = (zp1 + torch.randn(S, T, hidden[0], generator=g,
                                    device=dev) * 0.3).contiguous()
            gout = torch.randn(S, T, N, generator=g, device=dev) / N
            seed = 9 if S == 1 else list(range(9, 9 + S))
            done = []
            for kernel in ("fwd", "bwd"):
                packed = K.pack_ffn(k1T, mids, kout, bout, "bfloat16")
                if K.stream_route_plan(lay, kernel, sms, S, T, N,
                                       "bfloat16")[0] != K.STREAM_MMA_ROUTE:
                    continue  # deeper than route 4's stacks
                for xb in (x, x.to(torch.bfloat16)):
                    for rate in SH_RATES:
                        old, new = mma_pair(kernel, xb, zp, packed, gout,
                                            seed, rate)
                        a, b = old(), new()
                        torch.cuda.synchronize()
                        check(all(torch.equal(ints(p), ints(q))
                                  for p, q in zip(a, b)),
                              f"sdf_ffn_{kernel}_stream_mma "
                              f"{'bf16' if xb is not x else 'f32'} panel "
                              f"hidden={_stack_text(hidden)} F={F} S={S} "
                              f"dropout {rate}: differs from {name}'s")
                        compared += 1
                done.append(f"{kernel} route 4")
            for kernel in K.KERNELS:
                packed = K.pack_ffn(k1T, mids, kout, bout, "float32")
                if K.stream_route_plan(lay, kernel, sms, S, T, N,
                                       "float32")[0] != K.STREAM_TILED_ROUTE:
                    continue  # a narrow stack's, or one route 5 cannot hold
                if kernel not in old_tiled:
                    skipped.add(kernel)
                    continue
                new_fn = getattr(K._load_stream(kernel),
                                 f"sdf_ffn_{kernel}_stream_tiled")
                for xb in (x, x.to(torch.bfloat16)):
                    xb16 = xb.dtype == torch.bfloat16
                    plan = K.stream_plan(
                        lay, kernel, sms, S, T, N,
                        K._stream_registers(kernel, K.STREAM_TILED_ROUTE,
                                            xb16), K.STREAM_TILED_ROUTE)
                    for rate in SH_RATES:
                        a, b = (tiled_caller(kernel, fn, xb, zp, packed, plan,
                                             gout, seed, rate)()
                                for fn in (old_tiled[kernel], new_fn))
                        torch.cuda.synchronize()
                        check(all(torch.equal(ints(p), ints(q))
                                  for p, q in zip(a, b)),
                              f"sdf_ffn_{kernel}_stream_tiled "
                              f"{'bf16' if xb16 else 'f32'} panel "
                              f"hidden={_stack_text(hidden)} F={F} S={S} "
                              f"dropout {rate}: differs from {name}'s")
                        compared += 1
                done.append(f"{kernel} route 5")
            for kernel, cd in kinds:
                packed = K.pack_ffn(k1T, mids, kout, bout, cd)
                if not streams(kernel, lay, S, T, N, cd):
                    continue  # the resident route's stack
                for xb in (x, x.to(torch.bfloat16)):
                    plan = plan_of(kernel, lay, S, T, N, cd,
                                   xb.dtype == torch.bfloat16)
                    for rate in SH_RATES:
                        old = caller(kernel, olds[kernel], xb, zp, packed,
                                     plan, gout, seed, rate)
                        new = caller(kernel, getattr(
                            K._load_stream(kernel),
                            f"sdf_ffn_{kernel}_stream"), xb, zp, packed,
                            plan, gout, seed, rate)
                        a, b = old(), new()
                        torch.cuda.synchronize()
                        check(all(torch.equal(ints(p), ints(q))
                                  for p, q in zip(a, b)),
                              f"sdf_ffn_{kernel}_stream {cd} "
                              f"{'bf16' if xb is not x else 'f32'} panel "
                              f"hidden={_stack_text(hidden)} F={F} S={S} "
                              f"dropout {rate}: differs from {name}'s")
                        compared += 1
                done.append(f"{kernel} {cd}")
            print(f"[shapes compare] hidden={_stack_text(hidden)} F={F} "
                  f"S={S} T={T} N={N}: {', '.join(done)} bit for bit "
                  f"{name}/{K.STREAM_SOURCE}'s (both panels, dropout "
                  f"{list(SH_RATES)}) ({card})", flush=True)
            del x
    T, N = SH_ROW
    F, hidden = 46, list(SH_HIDDEN)
    lay = K.ffn_layout(F, hidden)
    for kernel, cd in kinds:
        S = 9 if kernel == "dx" else 1
        if cd == "bfloat16" and kernel != "dx":
            continue  # the tensor-core form's, timed in phase 21's rows
        x = torch.randn(T, F, N, generator=g, device=dev)
        xb = x.to(torch.bfloat16) if cd == "bfloat16" else x
        zp1, k1T, mids, kout, bout = _ffn_params(torch, g, S, F, hidden, dev)
        zp = zp1.expand(S, T, hidden[0]).contiguous()
        gout = torch.randn(S, T, N, generator=g, device=dev) / N
        seed = 5 if S == 1 else list(range(5, 5 + S))
        packed = K.pack_ffn(k1T, mids, kout, bout, cd)
        plan = plan_of(kernel, lay, S, T, N, cd, xb is not x)
        old = caller(kernel, olds[kernel], xb, zp, packed, plan, gout, seed,
                     DROPOUT)
        new = caller(kernel, getattr(K._load_stream(kernel),
                                     f"sdf_ffn_{kernel}_stream"), xb, zp,
                     packed, plan, gout, seed, DROPOUT)
        check(all(torch.equal(ints(p), ints(q))
                  for p, q in zip(old(), new())),
              f"sdf_ffn_{kernel}_stream {cd} at its timed shape differs "
              f"from {name}'s")
        t = [cuda_ms(torch, f, reps=3, warmup=1) for f in (old, new, new,
                                                             old)]
        print(f"[shapes compare] {kernel} {cd} "
              f"{'bf16' if xb is not x else 'f32'} panel S={S} T={T} "
              f"N={N} hidden={hidden} dropout {DROPOUT}: bit for bit; "
              f"older {t[0]:.4f} / {t[3]:.4f} ms, new {t[1]:.4f} / "
              f"{t[2]:.4f} ms ({card})", flush=True)
        del x, xb
    for kernel in ("fwd", "bwd"):  # route 4 at S = 1 on the bf16 panel
        x = torch.randn(T, F, N, generator=g, device=dev).to(torch.bfloat16)
        zp1, k1T, mids, kout, bout = _ffn_params(torch, g, 1, F, hidden, dev)
        zp = zp1.expand(1, T, hidden[0]).contiguous()
        gout = torch.randn(1, T, N, generator=g, device=dev) / N
        packed = K.pack_ffn(k1T, mids, kout, bout, "bfloat16")
        old, new = mma_pair(kernel, x, zp, packed, gout, 5, DROPOUT)
        check(all(torch.equal(ints(p), ints(q))
                  for p, q in zip(old(), new())),
              f"sdf_ffn_{kernel}_stream_mma at its timed shape differs from "
              f"{name}'s")
        t = [cuda_ms(torch, f, reps=3, warmup=1) for f in (old, new, new,
                                                             old)]
        print(f"[shapes compare] {kernel} route 4 bfloat16 bf16 panel S=1 "
              f"T={T} N={N} hidden={hidden} dropout {DROPOUT}: bit for bit; "
              f"older {t[0]:.4f} / {t[3]:.4f} ms, new {t[1]:.4f} / "
              f"{t[2]:.4f} ms ({card})", flush=True)
        del x
    if skipped:
        print(f"[shapes compare] skipped the register-tiled route's (route "
              f"{K.STREAM_TILED_ROUTE}) pairs of "
              + ", ".join(f"sdf_ffn_{k}_stream_tiled" for k in sorted(skipped))
              + f": {name}/{K.STREAM_SOURCE} has no such entry ({card})",
              flush=True)
    print(f"[shapes compare] {compared} calls bit for bit {name}/"
          f"{K.STREAM_SOURCE}'s ({card})", flush=True)


def shapes_agreement_check(torch, K, card):
    """(a) The streamed forward and backward agree bit for bit: at (256,
    256), F = 46, S = 1 and 9, dropout 0.1, with kout = e_j and bout = 0 the
    forward's output at (t0, n0) is round(act_j) (f32 compute: act_j), and
    with g one-hot there the backward's dkout_j is act_j unrounded, so
    bf16(dkout_j) (f32: dkout_j) must be the output bit for bit, for every
    member and each unit of SH_AGREE_UNITS. bf16 compute on the bf16 panel
    (the tensor-core form), f32 on the f32 panel (the register-tiled
    form). Fails if no compared value is nonzero."""
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(24)
    T, N, F = SH_T, SH_N, 46
    t0, n0 = SH_AGREE_AT
    for S in (1, 9):
        x = torch.randn(T, F, N, generator=g, device=dev)
        zp1, k1T, mids, _, _ = _ffn_params(torch, g, S, F, list(SH_HIDDEN),
                                           dev)
        zp = (zp1 + torch.randn(S, T, SH_HIDDEN[0], generator=g,
                                device=dev) * 0.3).contiguous()
        seed = 11 if S == 1 else list(range(11, 11 + S))
        onehot = torch.zeros(S, T, N, device=dev)
        onehot[:, t0, n0] = 1.0
        for cd, panel in (("bfloat16", x.to(torch.bfloat16)),
                          ("float32", x)):
            K.reset_launch_count()
            nonzero, total = 0, 0
            for j in SH_AGREE_UNITS:
                kout = torch.zeros(S, SH_HIDDEN[-1], device=dev)
                kout[:, j] = 1.0
                packed = K.pack_ffn(k1T, mids, kout,
                                    torch.zeros(S, device=dev), cd)
                out = K._launch(panel, zp, packed, seed, 0.1)[:, t0, n0]
                grads, _ = K._launch_bwd(panel, zp, packed, onehot, seed, 0.1)
                dk = K.unpack_grads(grads, packed.layout)[2][:, j]
                want = (dk.to(torch.bfloat16).float() if cd == "bfloat16"
                        else dk)
                torch.cuda.synchronize()
                check(torch.equal(out, want),
                      f"(256, 256) S={S} {cd} unit {j}: the forward's output "
                      f"{out.tolist()} is not the backward's "
                      f"{'bf16(dkout)' if cd == 'bfloat16' else 'dkout'} "
                      f"{want.tolist()} bit for bit")
                nonzero += int((out != 0).sum())
                total += S
            mma = (K.launches_stream_mma, K.bwd_launches_stream_mma)
            tiled = (K.launches_stream_tiled, K.bwd_launches_stream_tiled)
            n = (len(SH_AGREE_UNITS),) * 2
            check(nonzero > 0 and mma == (n if cd == "bfloat16" else (0, 0))
                  and tiled == ((0, 0) if cd == "bfloat16" else n),
                  f"(256, 256) S={S} {cd}: {nonzero} nonzero of {total} "
                  f"compared; tensor-core launches {mma}, register-tiled "
                  f"{tiled}")
            print(f"[shapes] fwd/bwd agreement (256, 256) S={S} {cd} "
                  f"dropout 0.1, kout = e_j for j in {list(SH_AGREE_UNITS)}, "
                  f"g one-hot at (t, n) = {SH_AGREE_AT}: the forward's "
                  f"output bit for bit the backward's "
                  f"{'bf16(dkout_j)' if cd == 'bfloat16' else 'dkout_j'} "
                  f"({nonzero} of {total} nonzero; tensor-core launches "
                  f"{mma}, register-tiled {tiled}) ({card})", flush=True)
        del x


def shapes_kernel_rows(torch, K, C, card):
    """Each streamed FFN kernel at (256, 256), F = 46, and each chunked
    conditional-EM kernel at K = 32, at SH_ROW: the forwards and backwards
    at S = 1 (training) and S = 9 (the member axis), the two panel
    cotangents at S = 9 (the panel gradient of (c)), bf16 compute on the
    bf16 panel and f32 compute on the f32 panel, the FFN at dropout 0.05.
    One event-timed call each beside its plain version and bound. Returns
    {(name, S, cd): row}."""
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(22)
    T, N = SH_ROW
    F, hidden = 46, list(SH_HIDDEN)
    rows = {}
    for name, S in [(n, s) for n in SH_KERNELS
                    for s in ((9,) if n.endswith("_dx") else (1, 9))]:
        x = torch.randn(T, F, N, generator=g, device=dev)
        ins = _sh_inputs(torch, g, S, T, N, F, hidden, SH_MOMENTS, dev)
        for cd, xb16 in (("bfloat16", True), ("float32", False)):
            panel = x.to(torch.bfloat16) if xb16 else x
            rate = 0.0 if name.startswith("cond_em") else DROPOUT
            kern, plain, flops, nbytes = _bp_calls(
                torch, K, C, S, T, N, F, SH_MOMENTS, hidden, 0, cd, rate,
                ins)[name]
            out, ref = kern(panel), plain(panel)
            torch.cuda.synchronize()
            err = _sh_check(torch, name, cd, out, None, ref,
                            f"{name} at its timed shape {cd}")
            abs_err = max(float((o.float() - r.float()).abs().max())
                          for o, r in zip(out, ref))
            del out, ref
            ms = cuda_ms(torch, lambda: kern(panel), reps=5, warmup=2)
            plain_ms = cuda_ms(torch, lambda: plain(panel), reps=3, warmup=1)
            b_ms, b_by = bound(flops, nbytes(2 if xb16 else 4), cd)
            row = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=None,
                       shape=f"S={S} T={T} N={N} F={F} hidden={hidden} "
                             + (f"K={SH_MOMENTS} " if name.startswith(
                                 "cond_em") else f"dropout {rate} ")
                             + f"{cd} {'bf16' if xb16 else 'f32'} panel")
            print(f"[shapes] {name:11s} {row['shape']}: max|d|/max|ref| "
                  f"{err:.2e}  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                  f"bound {b_ms:.4f} ms ({b_by}) ({card})", flush=True)
            rows[(name, S, cd)] = row
        del x, ins
    return rows


def _sh_cfg(splits, **kw):
    from deeplearninginassetpricing_paperreplication_torch.utils.config \
        import GANConfig

    train = splits[0]
    return GANConfig(macro_feature_dim=train.macro_feature_dim,
                     individual_feature_dim=train.individual_feature_dim,
                     hidden_dim=SH_HIDDEN, num_condition_moment=SH_MOMENTS,
                     dropout=DROPOUT, **kw)


def shapes_train_check(torch, K, C, card, cd="float32"):
    """(b) The train CLI at --hidden_dim 256 256 --num_moments 32 on phase
    6's panel, SH_EPOCHS, on the kernel route (its launches counted: the
    streamed forward and backward, the chunked conditional EM) and on the
    plain route. f32 compute: every epoch's losses within C3's 1e-3
    relative bar, Sharpes within 5e-3, the same selected epochs. bf16
    compute (the CLI's default, on the bf16 panel; every FFN launch on the
    tensor-core form of the streamed route; f32 compute: every FFN launch
    on its register-tiled form): every epoch finite, epoch 1's
    losses within BF16_REL relative (PERF.md §2's bf16 class), the largest
    deviation over all epochs printed. Returns the kernel run's launches by
    kernel, and its streamed ones."""
    from deeplearninginassetpricing_paperreplication_torch import train

    unc, mom, cond = SH_EPOCHS
    runs = {}
    for kernel in ("on", "off"):
        save = SH_DIR / f"train_{kernel}_{cd}"
        shutil.rmtree(save, ignore_errors=True)
        torch.cuda.synchronize()
        K.reset_launch_count()
        C.reset_launch_count()
        t0 = time.perf_counter()
        train.main(["--data_dir", str(DATA_DIR), "--save_dir", str(save),
                    "--epochs_unc", str(unc), "--epochs_moment", str(mom),
                    "--epochs", str(cond), "--ignore_epoch", "0",
                    "--print_freq", "1000", "--device", DEVICE,
                    "--compute_dtype", cd, "--kernel", kernel,
                    "--hidden_dim", *map(str, SH_HIDDEN), "--num_moments",
                    str(SH_MOMENTS)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(zip(SH_KERNELS, panel_counts(K, C)))
        streamed = dict(zip(SH_KERNELS[:3], stream_counts(K)))
        streamed.update(zip(("sdf_ffn_fwd_mma", "sdf_ffn_bwd_mma",
                             "sdf_ffn_fwd_tiled", "sdf_ffn_bwd_tiled"),
                            (K.launches_stream_mma,
                             K.bwd_launches_stream_mma,
                             K.launches_stream_tiled,
                             K.bwd_launches_stream_tiled)))
        panel16 = dict(zip(SH_KERNELS, bf16_panel_counts(K, C)))
        with np.load(save / "history.npz") as h:
            hist = {k: h[k] for k in h.files}
        metrics = json.loads((save / "final_metrics.json").read_text())
        runs[kernel] = dict(hist=hist, wall=wall, launches=launches,
                            streamed=streamed, panel16=panel16,
                            epoch_ms=metrics["epoch_ms"])
        shutil.rmtree(save, ignore_errors=True)
    on, off = runs["on"], runs["off"]
    bf = cd == "bfloat16"
    ffn = ("sdf_ffn_fwd", "sdf_ffn_bwd")
    check(all(on["launches"][k] > 0 for k in SH_KERNELS
              if k not in ("sdf_ffn_dx", "cond_em_dx"))
          and all(on["streamed"][k] == on["launches"][k] for k in ffn),
          f"the (256, 256) kernel-route training launched {on['launches']}, "
          f"streamed {on['streamed']}: every FFN launch must stream")
    # bf16 compute: every FFN launch on the tensor-core form, the training
    # passes on the bf16 panel (evaluation rebuilds the f32 one); f32: every
    # one on the register-tiled form, none on a bf16 panel
    check(all(on["streamed"][k + "_mma"] == (on["launches"][k] if bf else 0)
              and on["streamed"][k + "_tiled"] == (0 if bf
                                                   else on["launches"][k])
              for k in ffn)
          and (on["panel16"]["sdf_ffn_bwd"] == on["launches"]["sdf_ffn_bwd"]
               and on["panel16"]["sdf_ffn_fwd"] > 0 if bf
               else not any(on["panel16"].values())),
          f"the (256, 256) {cd} training's FFN launches {on['launches']}: "
          f"tensor-core and register-tiled {on['streamed']}, bf16 panel "
          f"{on['panel16']}")
    check(not any(off["launches"].values()),
          f"the plain-route training launched {off['launches']}")
    check(all(np.isfinite(on["hist"][k]).all() for k in on["hist"]
              if k != "phase"), "non-finite (256, 256) kernel history")
    losses = ("train_loss", "valid_loss", "test_loss")
    rel = {k: np.abs(on["hist"][k] - off["hist"][k])
           / np.maximum(np.abs(off["hist"][k]), 1e-12) for k in losses}
    dev_loss = max(float(np.max(v)) for v in rel.values())
    dev_first = max(float(v[0]) for v in rel.values())
    dev_sharpe = max(float(np.max(np.abs(on["hist"][k] - off["hist"][k])))
                     for k in ("train_sharpe", "valid_sharpe",
                               "test_sharpe"))
    sel = _bp_selected(on["hist"])
    if bf:
        check(dev_first <= BF16_REL,
              f"train CLI hidden {list(SH_HIDDEN)} K={SH_MOMENTS} bf16, "
              f"kernel vs plain: epoch 1 loss rel dev {dev_first:.3e} (bar "
              f"{BF16_REL:g})")
        bars = (f"epoch 1 loss rel dev {dev_first:.3e} (bar {BF16_REL:g}); "
                f"largest over the epochs: loss {dev_loss:.3e}, Sharpe "
                f"{dev_sharpe:.3e}, selected epochs {sel} / "
                f"{_bp_selected(off['hist'])}")
    else:
        check(dev_loss <= 1e-3 and dev_sharpe <= 5e-3
              and sel == _bp_selected(off["hist"]),
              f"train CLI hidden {list(SH_HIDDEN)} K={SH_MOMENTS}, kernel vs "
              f"plain: loss rel dev {dev_loss:.3e} (bar 1e-3), Sharpe dev "
              f"{dev_sharpe:.3e} (bar 5e-3), selected epochs {sel} / "
              f"{_bp_selected(off['hist'])}")
        bars = (f"every epoch max loss rel dev {dev_loss:.3e} (bar 1e-3), "
                f"max Sharpe dev {dev_sharpe:.3e} (bar 5e-3), selected "
                f"epochs {sel}")
    fmt = lambda d: ", ".join(f"{k} {v:.2f}" for k, v in d.items())  # noqa: E731
    print(f"[shapes train] train CLI --hidden_dim {SH_HIDDEN[0]} "
          f"{SH_HIDDEN[1]} --num_moments {SH_MOMENTS}, {cd}"
          f"{' (bf16 panel)' if bf else ''}, {unc}/{mom}/{cond} epochs, N="
          f"{PANEL['n_stocks']}: kernel vs plain {bars}; launches "
          f"{on['launches']}, streamed {on['streamed']}; wall ms per epoch "
          f"kernel {fmt(on['epoch_ms'])}, plain {fmt(off['epoch_ms'])}; run "
          f"{on['wall']:.1f} s / {off['wall']:.1f} s ({card})", flush=True)
    return on["launches"], on["streamed"]


def shapes_train_turns(torch, K, C, card):
    """(b) The f32 train CLI at (256, 256), K = 32 (SH_EPOCHS, kernel
    route) with the streamed forward and backward on route 2
    (K.f32_streamed_on_route2) and on route 5, in turns (route 2, 5, 5, 2):
    each run's wall ms per epoch and phase, and its launches on route 5 (all
    the FFN's, or none). Returns {"route2": [epoch_ms, epoch_ms], "route5":
    [...]}."""
    from deeplearninginassetpricing_paperreplication_torch import train

    unc, mom, cond = SH_EPOCHS
    out = {"route2": [], "route5": []}
    for route in ("route2", "route5", "route5", "route2"):
        save = SH_DIR / f"turns_{route}"
        shutil.rmtree(save, ignore_errors=True)
        with (K.f32_streamed_on_route2() if route == "route2"
              else contextlib.nullcontext()):
            torch.cuda.synchronize()
            K.reset_launch_count()
            train.main(["--data_dir", str(DATA_DIR), "--save_dir", str(save),
                        "--epochs_unc", str(unc), "--epochs_moment", str(mom),
                        "--epochs", str(cond), "--ignore_epoch", "0",
                        "--print_freq", "1000", "--device", DEVICE,
                        "--compute_dtype", "float32", "--kernel", "on",
                        "--hidden_dim", *map(str, SH_HIDDEN),
                        "--num_moments", str(SH_MOMENTS)])
            torch.cuda.synchronize()
        tiled = (K.launches_stream_tiled, K.bwd_launches_stream_tiled)
        ffn = (K.launches_stream, K.bwd_launches_stream)
        check(ffn[0] > 0 and ffn[1] > 0
              and tiled == (ffn if route == "route5" else (0, 0)),
              f"the f32 train CLI on {route}: streamed launches {ffn}, "
              f"register-tiled {tiled}")
        metrics = json.loads((save / "final_metrics.json").read_text())
        out[route].append(metrics["epoch_ms"])
        shutil.rmtree(save, ignore_errors=True)
    fmt = lambda d: "/".join(f"{v:.2f}" for v in d.values())  # noqa: E731
    print(f"[shapes train turns] train CLI --hidden_dim {SH_HIDDEN[0]} "
          f"{SH_HIDDEN[1]} --num_moments {SH_MOMENTS} f32, {unc}/{mom}/{cond}"
          f" epochs, wall ms per epoch (phase 1/2/3) in turns: route 2 "
          f"{fmt(out['route2'][0])} ... {fmt(out['route2'][1])}, route 5 "
          f"{fmt(out['route5'][0])}, {fmt(out['route5'][1])} ({card})",
          flush=True)
    return out


def shapes_gradient_check(torch, K, C, card, splits):
    """(c) ∂(conditional loss)/∂individual of a (256, 256), K = 32
    ensemble of nine seeded members (S = 9), parameters frozen, on the
    train split: the kernel route against kernel="off" in f32 and bf16.
    Returns {compute dtype: the kernel route's launches}, {compute dtype:
    its streamed ones, and (``<kernel>_mma``) the tensor-core form's and
    (``<kernel>_tiled``) the register-tiled form's}: one call each."""
    from deeplearninginassetpricing_paperreplication_torch.models.gan import \
        GAN
    from deeplearninginassetpricing_paperreplication_torch.parallel.ensemble \
        import init_ensemble_params
    from deeplearninginassetpricing_paperreplication_torch.utils.config \
        import ExecutionConfig

    cfg = _sh_cfg(splits)
    params = {k: v.detach() for k, v in init_ensemble_params(
        cfg, ENSEMBLE_SEEDS, device=DEVICE).items()}
    batch = splits[0].to_batch(DEVICE)

    def grad(kernel, cd):
        gan = GAN(cfg, ExecutionConfig(kernel=kernel, compute_dtype=cd,
                                       bf16_panel=False, device=DEVICE))
        ind = batch["individual"].clone().requires_grad_()
        res = gan.forward_members(params, dict(batch, individual=ind),
                                  "conditional")
        (dx,) = torch.autograd.grad(res["loss"].sum(), ind)
        return dx

    grad("on", "float32")  # plans and set-up
    torch.cuda.synchronize()
    errs, launches, streamed = {}, {}, {}
    for cd in ("float32", "bfloat16"):
        K.reset_launch_count()
        C.reset_launch_count()
        on = grad("on", cd)
        torch.cuda.synchronize()
        launches[cd] = dict(zip(SH_KERNELS, panel_counts(K, C)))
        streamed[cd] = dict(zip(SH_KERNELS[:3], stream_counts(K)))
        streamed[cd].update(zip(
            ("sdf_ffn_fwd_mma", "sdf_ffn_bwd_mma", "sdf_ffn_dx_mma",
             "sdf_ffn_fwd_tiled", "sdf_ffn_dx_tiled"),
            (K.launches_stream_mma, K.bwd_launches_stream_mma,
             K.dx_launches_stream_mma, K.launches_stream_tiled,
             K.dx_launches_stream_tiled)))
        off = grad("off", cd)
        err = rel_err(on, off)
        check(bool(torch.isfinite(on).all())
              and err <= (GRAD_F32_REL if cd == "float32" else BF16_REL),
              f"(256, 256) K={SH_MOMENTS} S=9 panel gradient ({cd}): kernel "
              f"vs plain max|d|/max|ref| {err:.3e}")
        errs[cd] = err
    n = len(C.moment_chunks(SH_MOMENTS))
    want = (1, 0, 1, n, n, n)
    for cd in ("float32", "bfloat16"):
        # bf16: the forward and dx on route 4; f32: both on route 5
        mma = int(cd == "bfloat16")
        check(tuple(launches[cd].values()) == want
              and streamed[cd] == {"sdf_ffn_fwd": 1, "sdf_ffn_bwd": 0,
                                   "sdf_ffn_dx": 1, "sdf_ffn_fwd_mma": mma,
                                   "sdf_ffn_bwd_mma": 0,
                                   "sdf_ffn_dx_mma": mma,
                                   "sdf_ffn_fwd_tiled": 1 - mma,
                                   "sdf_ffn_dx_tiled": 1 - mma},
              f"one (256, 256) K={SH_MOMENTS} {cd} panel gradient launched "
              f"{launches[cd]} (streamed {streamed[cd]}), not {want}")
    print(f"[shapes grad] d conditional loss / d individual, hidden "
          f"{list(SH_HIDDEN)} K={SH_MOMENTS}, S=9 seeded members, train "
          f"split: kernel vs plain max|d|/max|ref| f32 "
          f"{errs['float32']:.2e} (bar {GRAD_F32_REL:g}), bf16 "
          f"{errs['bfloat16']:.2e} (bar {BF16_REL:g}); one call launched "
          f"{launches['float32']}, streamed f32 {streamed['float32']}, bf16 "
          f"{streamed['bfloat16']} ({card})", flush=True)
    return launches, streamed


def boot_server(run_dir: Path, extra, timeout: float = 300.0):
    """The serving CLI (one process, async front end, f32) as a subprocess
    on a free port with `extra` arguments; returns (process, base url,
    boot s) once /healthz answers."""
    from deeplearninginassetpricing_paperreplication_torch.serving import (
        pick_free_port,
    )

    shutil.rmtree(run_dir, ignore_errors=True)
    port = pick_free_port()
    env = {k: v for k, v in os.environ.items() if k != "DLAP_FAULT_PLAN"}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p and p != str(ROOT)])
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{PKG}.serving.server", "--server", "async",
         "--run_dir", str(run_dir), "--port", str(port), "--device", DEVICE,
         "--compute_dtype", "float32", "--cache_size", "0", *extra],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    base = f"http://127.0.0.1:{port}"
    while True:
        try:
            if get(base + "/healthz")[0] == 200:
                break
        except (urllib.error.URLError, ConnectionError, OSError):
            pass
        if proc.poll() is not None or time.perf_counter() - t0 > timeout:
            stop_fleet(proc)
            fail(f"the serving CLI did not boot: {proc.stdout.read()[-3000:]}")
        time.sleep(0.2)
    return proc, base, time.perf_counter() - t0


def shapes_serve_check(torch, K, card, splits):
    """(d) A (256, 256) ensemble of three seeded members saved as run dirs,
    served by the serving CLI (one replica, f32): a few test months over
    the raw-f32 wire answered and within the f32 bar of the offline
    ensemble_metrics weights. Returns the replica's sdf_ffn_fwd launches
    (every one streamed, on the register-tiled route: the stack has no
    resident plan)."""
    from deeplearninginassetpricing_paperreplication_torch.evaluate_ensemble \
        import stack_checkpoints
    from deeplearninginassetpricing_paperreplication_torch.parallel.ensemble \
        import ensemble_metrics, init_ensemble_params
    from deeplearninginassetpricing_paperreplication_torch.training \
        .checkpoint import member_state_dicts, save_state_dict
    from deeplearninginassetpricing_paperreplication_torch.utils.config \
        import ExecutionConfig

    test = splits[2]
    cfg = _sh_cfg(splits)
    check(not K.resident_fits(K.ffn_layout(cfg.individual_feature_dim,
                                           cfg.hidden_dim)),
          "the served stack has a resident plan")
    seeds = ENSEMBLE_SEEDS[:3]
    dirs = []
    for seed, sd in zip(seeds, member_state_dicts(
            init_ensemble_params(cfg, seeds))):
        d = SH_DIR / "members" / f"seed_{seed}"
        d.mkdir(parents=True, exist_ok=True)
        cfg.save(d / "config.json")
        save_state_dict(d / "best_model_sharpe.pt", sd)
        dirs.append(str(d))
    _, stacked = stack_checkpoints(dirs, device=DEVICE)
    offline = np.asarray(ensemble_metrics(cfg, stacked, test.to_batch(DEVICE),
                                          ExecutionConfig(
                                              kernel="off",
                                              compute_dtype="float32",
                                              device=DEVICE))["avg_weights"])
    bodies = serving_bodies(test)
    months = (0, test.T // 3, 2 * test.T // 3, test.T - 1)
    proc, base, boot_s = boot_server(SH_DIR / "serve", [
        "--checkpoint_dirs", *dirs, "--data_dir", str(DATA_DIR)])
    worst = 0.0
    try:
        for t in months:
            s, w = post(base + "/v1/weights", bodies[t]["raw"], raw=True)
            want = offline[t][bodies[t]["valid"]]
            check(s == 200 and w.shape == want.shape,
                  f"(256, 256) served month {t}: HTTP {s}")
            d = np.abs(w - want)
            check(within(d, want, "float32", **SERVE_F32_TOL),
                  f"(256, 256) served month {t}: max|d| {d.max():.3e} over "
                  f"the f32 bar of the offline weights")
            worst = max(worst, float(d.max()))
        engine = _metrics(base)["engine"]
        launches = engine["kernel_launches"]
    finally:
        stop_fleet(proc)
    check(proc.returncode == 0, f"the serving CLI exited {proc.returncode}")
    check(launches > 0 and engine["kernel_launches_stream"] == launches
          and engine["kernel_launches_stream_tiled"] == launches,
          f"the (256, 256) server launched sdf_ffn_fwd {launches} times, "
          f"{engine['kernel_launches_stream']} streamed, "
          f"{engine['kernel_launches_stream_tiled']} register-tiled")
    print(f"[shapes serve] {len(seeds)} seeded members hidden "
          f"{list(SH_HIDDEN)} through the serving CLI (booted in "
          f"{boot_s:.1f} s): months {list(months)} over raw-f32 answered, "
          f"within the f32 bar of the offline weights (max|d| {worst:.3e}); "
          f"the replica's sdf_ffn_fwd launches {launches}, all streamed on "
          f"the register-tiled route ({card})", flush=True)
    return launches


def shapes_phase(torch, K, C, card):
    """Phase 21 on phase 6's panel, written anew (and removed after): (a)
    the kernels at the shapes the resident kernels do not hold, (b) the
    train CLI at (256, 256), K = 32 (and in f32 on routes 2 and 5 in
    turns), (c) its panel gradient at S = 9, (d) a
    served (256, 256) ensemble. Returns the timed rows, the held plans and
    {kernel: {path: launches}} of the six kernels and of the streamed
    forms (``<kernel>_stream``)."""
    t0 = time.perf_counter()
    plans = shapes_plan_lines(torch, K, card)
    rows = shapes_kernel_checks(torch, K, C, card)
    t1 = time.perf_counter()
    try:
        splits = make_panel()
        train_l, train_s = shapes_train_check(torch, K, C, card)
        rows["route5"]["train_in_turns"] = shapes_train_turns(torch, K, C,
                                                              card)
        bf_l, bf_s = shapes_train_check(torch, K, C, card, "bfloat16")
        grad_l, grad_s = shapes_gradient_check(torch, K, C, card, splits)
        serve_l = shapes_serve_check(torch, K, card, splits)
    finally:
        shutil.rmtree(DATA_DIR, ignore_errors=True)
        shutil.rmtree(SH_DIR, ignore_errors=True)
    launches = {}
    for name in SH_KERNELS:
        paths = {"shapes_training": train_l[name],
                 "shapes_training_bf16": bf_l[name],
                 "shapes_panel_gradient": grad_l["float32"][name],
                 "shapes_panel_gradient_bf16": grad_l["bfloat16"][name]}
        if name == "sdf_ffn_fwd":
            paths["shapes_serving"] = serve_l
        launches[name] = {p: n for p, n in paths.items() if n}
    for name in SH_KERNELS[:3]:
        paths = {"shapes_training": train_s[name],
                 "shapes_training_bf16": bf_s[name],
                 "shapes_panel_gradient": grad_s["float32"][name],
                 "shapes_panel_gradient_bf16": grad_s["bfloat16"][name]}
        if name == "sdf_ffn_fwd":
            paths["shapes_serving"] = serve_l
        launches[name + "_stream"] = {p: n for p, n in paths.items() if n}
    # the tensor-core form's (bf16 compute): the bf16 training's FFN
    # launches and the bf16 panel gradient's
    for name in SH_KERNELS[:3]:
        paths = {"shapes_training_bf16": bf_s.get(name + "_mma", 0),
                 "shapes_panel_gradient_bf16": grad_s["bfloat16"][
                     name + "_mma"]}
        launches[name + "_stream_mma"] = {p: n for p, n in paths.items()
                                          if n}
    # the register-tiled form's (f32 compute): the f32 training's forward
    # and backward, the f32 panel gradient's forward and dx and the
    # server's forwards
    for name in SH_KERNELS[:3]:
        paths = {"shapes_training": train_s.get(name + "_tiled", 0),
                 "shapes_panel_gradient": grad_s["float32"].get(
                     name + "_tiled", 0)}
        if name == "sdf_ffn_fwd":
            paths["shapes_serving"] = serve_l
        launches[name + "_stream_tiled"] = {p: n for p, n in paths.items()
                                            if n}
    print(f"[shapes] phase 21 done in {time.perf_counter() - t0:.1f} s "
          f"((a) {t1 - t0:.1f} s); launches by path {launches} ({card})",
          flush=True)
    return dict(rows=rows, plans=plans, launches=launches)


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
                    help="with --only_dx: hold the f32 sdf_ffn_dx and "
                         "sdf_ffn_bwd at offset 0 bit for bit against "
                         "DIR/sdf_ffn_dx.cu's and sdf_ffn_bwd.cu's (this "
                         "tree's argument lists, beside their "
                         "sdf_ffn_common.cuh), and time both in turns")
    ap.add_argument("--only_fwd", action="store_true",
                    help="build the FFN forward's libraries only and run "
                         "their checks (a short call while the forward "
                         "changes); no result line")
    ap.add_argument("--compare_fwd", metavar="DIR", default=None,
                    help="with --only_fwd: hold the f32 forward at offset 0 "
                         "bit for bit against DIR/sdf_ffn.cu (this tree's "
                         "argument list, beside its sdf_ffn_common.cuh)")
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
    ap.add_argument("--only_refit", action="store_true",
                    help="build the training kernels' libraries only and run "
                         "phase 14, rolling refit and the run report on "
                         "phase 6's panel (a short call while the refit or "
                         "report CLI change); no result line")
    ap.add_argument("--only_fleet", action="store_true",
                    help="build the FFN forward's libraries only and run "
                         "phase 4 at f32 (the answers the fleet is held "
                         "to), then phase 15, the serving fleet under load, "
                         "on stand-in members (a short call while the "
                         "fleet, the autoscaler, the load generator or the "
                         "SLO plane change); no result line")
    ap.add_argument("--only_elastic", action="store_true",
                    help="build the training kernels' libraries only and run "
                         "phase 13, the supervisor and the elastic sweep on "
                         "phase 6's panel, against a fresh in-process run of "
                         "phase 9's grid (a short call while the supervisor, "
                         "the work queue or the sweep CLI change); no result "
                         "line")
    ap.add_argument("--only_joint", action="store_true",
                    help="build the training kernels' libraries only and run "
                         "their checks at phase 16's shapes, then phase 16: "
                         "joint_train, train_simple_sdf, the JAX run dirs "
                         "and the figures on phase 6's panel, on nine "
                         "stand-in members (a short call while the joint "
                         "trainers, the checkpoint reader or the plots "
                         "change); no result line")
    ap.add_argument("--only_shard", action="store_true",
                    help="build the FFN and conditional-EM libraries only, "
                         "then phase 17: the dropout offset checks and "
                         "stock-sharded training on phase 6's panel (a short "
                         "call while the partition layer, the collectives "
                         "or the sharded data plane change); no result line")
    ap.add_argument("--only_mesh", action="store_true",
                    help="build the training kernels' libraries only, then "
                         "phase 18: the kernels at the mesh path's shapes, "
                         "the mesh-packed sweep, the serving mesh, a mesh "
                         "fleet and bench_meshserve on phase 6's panel (a "
                         "short call while the mesh, the sweep or the "
                         "engine change); no result line")
    ap.add_argument("--only_bf16panel", action="store_true",
                    help="build the w64 FFN and conditional-EM libraries "
                         "only, then phase 20: the six panel kernels on a "
                         "bf16 panel and phase 6's model, the nine seeds and "
                         "the panel gradient through it (a short call while "
                         "the bf16 panel's staging or its routing change); "
                         "no result line")
    ap.add_argument("--only_multihost", action="store_true",
                    help="build the training kernels' libraries only, then "
                         "phase 19: the kernels at the multihost path's "
                         "shapes, the worker's worlds of rank processes and "
                         "the time-sharded LSTM (a short call while the "
                         "multihost worker, the hybrid mesh or the sequence "
                         "pipeline change); no result line")
    ap.add_argument("--compare_stream", metavar="DIR", default=None,
                    help="with --only_shapes: hold the streamed route's "
                         "CUDA-core instances (f32 forward, backward and "
                         "panel cotangent; bf16 route 3 too) bit for bit "
                         "against DIR/sdf_ffn_stream.cu's (this tree's "
                         "argument lists, beside its sdf_ffn_common.cuh and "
                         "panel.cuh) at phase 21's stacks, and time both in "
                         "turns")
    ap.add_argument("--only_shapes", action="store_true",
                    help="build the streamed FFN libraries, the w64 FFN and "
                         "the conditional-EM libraries only, then phase 21: "
                         "the kernels at the shapes the resident kernels do "
                         "not hold (widths above 128, more than 8 layers, "
                         "more than 16 moments, C11), a (256, 256), K = 32 "
                         "train CLI run, panel gradient and served ensemble "
                         "(a short call while the streamed route or the "
                         "moment chunks change); no result line")
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
        for proc in BACKGROUND:
            stop_fleet(proc)
        shutil.rmtree(CACHE_DIR, ignore_errors=True)
        shutil.rmtree(REAL_DIR, ignore_errors=True)
        shutil.rmtree(REPORT_RUNS, ignore_errors=True)
        shutil.rmtree(FLEET_DIR, ignore_errors=True)
        shutil.rmtree(JOINT_DIR, ignore_errors=True)
        shutil.rmtree(SHARD_DIR, ignore_errors=True)
        shutil.rmtree(MESH_DIR, ignore_errors=True)
        shutil.rmtree(MULTIHOST_DIR, ignore_errors=True)
        shutil.rmtree(SH_DIR, ignore_errors=True)


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
            if (opts.only_data or opts.only_ops or opts.only_elastic
                or opts.only_refit)
            else K.build_jobs([32, 64], kernels=("fwd", "bwd"))
            + C.build_jobs() if opts.only_joint or opts.only_multihost
            else K.build_jobs([64]) + C.build_jobs()
            if opts.only_shard or opts.only_bf16panel
            else K.stream_jobs() + [K.stream_audit_job()]
            + K.build_jobs([64]) + C.build_jobs()
            if opts.only_shapes
            else K.build_jobs(kernels=("fwd", "bwd")) + C.build_jobs()
            if opts.only_mesh
            else K.build_jobs(kernels=("bwd", "dx")) if opts.only_bwd
            else K.build_jobs(kernels=("dx",)) + [K.audit_job()]
            if opts.only_dx
            else K.build_jobs(kernels=("fwd",))
            if opts.only_fwd or opts.only_serve or opts.only_fleet
            else C.build_jobs() if opts.only_cem
            else MB.build_jobs() if opts.only_ceiling
            else K.build_jobs() + [K.audit_job()] + K.stream_jobs()
            + [K.stream_audit_job()] + C.build_jobs() + MB.build_jobs())
    logs = _nvcc.run(jobs, verbose=True)
    print(f"[build] {len(logs)} libraries ({', '.join(sorted(logs))}) built "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in sorted(logs):
        for line in logs[name].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {name}: {line.strip()}", flush=True)

    cem_job, (mb_job,) = C.build_jobs()[0], MB.build_jobs()
    sass_hmma(K, _nvcc, ("dx",) if opts.only_bwd or opts.only_dx
              else ("fwd",) if opts.only_fwd or opts.only_serve
              or opts.only_fleet
              else () if (opts.only_cem or opts.only_ceiling
                          or opts.only_data or opts.only_ops
                          or opts.only_elastic or opts.only_refit
                          or opts.only_joint or opts.only_shard
                          or opts.only_mesh or opts.only_multihost
                          or opts.only_bf16panel or opts.only_shapes)
              else ("fwd", "dx"),
              [(cem_job, "HMMA")] if opts.only_cem
              else [(mb_job, "HGMMA")] if opts.only_ceiling
              else [] if (opts.only_bwd or opts.only_dx or opts.only_fwd
                          or opts.only_serve or opts.only_fleet
                          or opts.only_data
                          or opts.only_ops or opts.only_elastic
                          or opts.only_refit or opts.only_joint
                          or opts.only_shard or opts.only_mesh
                          or opts.only_multihost or opts.only_bf16panel
                          or opts.only_shapes)
              else [(cem_job, "HMMA"), (mb_job, "HGMMA")])

    if opts.only_shapes:
        # phase 21 alone on phase 6's panel, and (with --compare_stream) the
        # streamed route's CUDA-core instances against an older source
        shapes_phase(torch, K, C, card)
        if opts.compare_stream:
            compare_stream(torch, K, _nvcc, opts.compare_stream, card)
        return 0

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

    if opts.only_joint:
        # phase 16 alone on phase 6's panel, its kernels first held against
        # their plain versions at its shapes (the paper width's S = 1 rows
        # are phase 3's in the whole run)
        try:
            splits = make_panel()
            joint_kernel_checks(torch, K, C, card)
            wide_checks(torch, K, card, "fwd", hiddens=[(64, 64)],
                        shapes=[(1, 48, 10000)], dtypes=("float32",),
                        rate=0.0)
            ffn_bwd_checks(torch, K, card, (64, 64), [(1, 48, 10000)],
                           dtypes=("float32",), rates=(0.0,))
            cond_em_checks(torch, C, card, Ks=(8,), shapes=[(1, 10000)],
                           dtypes=("float32",), odd=False)
            joint_phase(torch, K, C, card, splits)
        finally:
            shutil.rmtree(DATA_DIR, ignore_errors=True)
        return 0

    if opts.only_mesh:
        # phase 18 alone on phase 6's panel
        try:
            mesh_phase(torch, K, C, card, make_panel())
        finally:
            shutil.rmtree(DATA_DIR, ignore_errors=True)
        return 0

    if opts.only_multihost:
        # phase 19 alone (the worker makes its own panel)
        multihost_phase(torch, K, C, card)
        return 0

    if opts.only_bf16panel:
        # phase 20 alone on phase 6's panel
        try:
            bf16panel_phase(torch, K, C, card, make_panel())
        finally:
            shutil.rmtree(DATA_DIR, ignore_errors=True)
        return 0

    if opts.only_shard:
        # phase 17 alone on phase 6's panel
        try:
            world = shard_world(torch)
            shard_kernel_checks(torch, K, C, card, world)
            make_panel()
            shard_phase(torch, card, world)
        finally:
            shutil.rmtree(DATA_DIR, ignore_errors=True)
        return 0

    if opts.only_refit:
        # rolling refit and the run report alone: phase 14 on phase 6's
        # panel (the report's phase 11 and 12 run dirs are not there)
        try:
            refit_phase(torch, K, C, card, make_panel())
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

    if opts.only_fleet:
        # the serving fleet alone: phase 4 at f32 (the answers it is held
        # to), then phase 15 on stand-in members
        t0 = time.perf_counter()
        splits = make_panel()
        try:
            _, ref = serving_phase(torch, K, card, splits[2], opts.profile,
                                   dtypes=("float32",))
            member_dirs, _ = stand_in_members(torch)
            fleet_phase(torch, card, splits, ref, member_dirs)
        finally:
            shutil.rmtree(HEALTH_DIR, ignore_errors=True)
            shutil.rmtree(DATA_DIR, ignore_errors=True)
        print(f"[fleet] serving fleet checks passed in "
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
    serve_launches, fleet_ref = serving_phase(torch, K, card, test,
                                              opts.profile)
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
    # against phase 9's in-process ranking; phase 11's real-shape panel is
    # written meanwhile (phase 13 mostly waits on its children)
    real = start_real_panel()
    elastic = elastic_phase(torch, card, splits, sweep_ranked)

    # 11. the data plane at the real panel shape
    data = data_plane_phase(torch, K, C, card, real)

    # 14. rolling refit and the run report on phase 6's panel (the report
    # also reads the run dirs phases 11 and 12 kept)
    refits = refit_phase(torch, K, C, card, splits)

    # 15. the serving fleet under load, on phase 4's panel and answers;
    # its rolling reload targets phase 4b's stand-in members (phase 10's
    # members are another architecture than the ref_runs trio: dropout)
    try:
        fleet_launches = fleet_phase(torch, card, splits, fleet_ref,
                                     stand_in_members(torch)[0])
    finally:
        shutil.rmtree(HEALTH_DIR, ignore_errors=True)

    # 16. the joint trainers, the JAX run dirs and the figures on phase 6's
    # panel; the figures on phase 7's nine members
    joint_rows = joint_kernel_checks(torch, K, C, card)
    joint = joint_phase(torch, K, C, card, splits, (ens_cfg, ens_params))

    # 17. stock-sharded training on phase 6's panel, the FFN kernels'
    # dropout offset first
    world = shard_world(torch)
    shard_rows = shard_kernel_checks(torch, K, C, card, world)
    shard = shard_phase(torch, card, world)

    # 18. the mesh-packed sweep and the serving mesh on phase 6's panel
    mesh = mesh_phase(torch, K, C, card, splits)
    shutil.rmtree(DATA_DIR, ignore_errors=True)

    # 19. multi-process training and the time-sharded LSTM
    multihost = multihost_phase(torch, K, C, card)

    # 20. the bf16 panel on phase 6's panel (its splits are in memory)
    bp = bf16panel_phase(torch, K, C, card, splits)

    # 21. the kernel route's shape range: the streamed FFN route, the
    # moment chunks and C11, then a (256, 256), K = 32 model trained,
    # differentiated and served (phase 6's panel written anew)
    shp = shapes_phase(torch, K, C, card)

    src = f"{PKG}/ops/csrc/"
    tpu = "deeplearninginassetpricing_paperreplication_tpu/ops/"
    health_idx = {"sdf_ffn_fwd": 0, "sdf_ffn_bwd": 1, "cond_em_fwd": 3,
                  "cond_em_bwd": 4}

    def by_path(name, serving=0, fleet=0):
        paths = {"training": train_launches[name],
                 "training_hidden_128x128": wide_launches[name],
                 "ensemble_training": ens_launches[name],
                 "sweep": sweep_launches[name],
                 f"training_diag_stride_{DIAG_STRIDE}": diag_train[
                     "launches"][health_idx[name]]}
        if serving:
            paths = {"serving": serving, "serving_fleet": fleet, **paths}
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
        # the refit in process (its gate at S = 2 included), and the
        # fleet's workers that exited normally plus its coordinator's gate
        paths["rolling_refit"] = refits["rolling_refit"][name]
        paths["rolling_refit_fleet"] = refits["rolling_refit_fleet"][name]
        # phase 16: each path where it launches this kernel
        for path in ("joint_training", "simple_sdf_training",
                     "plots_summary"):
            if joint[path].get(name):
                paths[path] = joint[path][name]
        # phase 17: the ranks' launches of the torchrun CLI run
        paths["sharded_training"] = shard["launches"][name]
        # phase 18: the mesh runs' own, each counted from 0 (the in-process
        # sweep's, the sweep CLI's processes, the mesh engines, the fleet's
        # survivor)
        paths["mesh"] = mesh["launches"][name]
        # phase 19: the kernel-route ranks' launches (one step each),
        # counted in the rank processes
        paths["multihost"] = multihost["launches"][name]
        # phase 20: the bf16-panel training run and panel gradient (every
        # launch on the bf16 panel)
        paths.update(bp["launches"][name])
        # phase 21: the (256, 256), K = 32 training, panel gradient and
        # server (the streamed route and the moment chunks)
        paths.update(shp["launches"][name])
        return dict(launches=sum(paths.values()), launches_by_path=paths,
                    ensemble_members=ens_members,
                    at_sweep_shapes=sweep_rows[name],
                    at_refit_shapes=refits["rows"][name],
                    at_sharded_shape=shard_rows[name],
                    at_mesh_shapes=mesh["rows"][name],
                    at_multihost_shapes=multihost["rows"][name])

    def grad_path(name):
        paths = {"panel_gradient": grad_launches[name],
                 **bp["launches"][name], **shp["launches"][name]}
        extra = {f"at_{cd}_dropout": dx_rows[(name, cd, "dropout")]
                 for cd in ("float32", "bfloat16")
                 if (name, cd, "dropout") in dx_rows}
        return dict(launches=sum(paths.values()), launches_by_path=paths,
                    **dx_rows[(name, "float32")],
                    at_bfloat16=dx_rows[(name, "bfloat16")], **extra,
                    library_ms=None)  # no single PyTorch call computes it

    kernels = [
        dict(name="sdf_ffn_fwd", route="cuda", source=src + "sdf_ffn.cu",
             replaces=tpu + "pallas_ffn.py:561",
             also_replaces=tpu + "pallas_ffn.py:188",
             **by_path("sdf_ffn_fwd", serve_launches, fleet_launches),
             **row, at_simple_sdf_shape=joint_rows["sdf_ffn_fwd"],
             at_ensemble_shape=ens_fwd_row, diagnostics_pass=diag_rows),
        dict(name="sdf_ffn_bwd", route="cuda", source=src + "sdf_ffn_bwd.cu",
             replaces=tpu + "pallas_ffn.py:205",
             also_replaces=tpu + "pallas_ffn.py:591",
             **by_path("sdf_ffn_bwd"), **bwd_row,
             at_simple_sdf_shape=joint_rows["sdf_ffn_bwd"],
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
             replaces=tpu + "pallas_ffn.py:300", **grad_path("sdf_ffn_dx"),
             c2_audit=dx_rows[("sdf_ffn_dx", "bfloat16", "c2_audit")]),
        dict(name="cond_em_dx", route="cuda", source=src + "cond_em.cu",
             replaces=tpu + "pallas_moment.py:134",
             **grad_path("cond_em_dx")),
        dict(name="matmul_ceiling", route="cuda",
             source=src + "microbench.cu",
             replaces=tpu + "microbench.py:35",
             launches=ceiling_row["launches_by_path"]["roofline"],
             **ceiling_row),
    ]
    # the bf16-panel forms (phase 20): each kernel's row at its main path's
    # shape (S = 1, or the panel gradient's S = 9 for the two dx kernels),
    # bf16 compute, with the f32 compute row and the f32 panel's ms beside
    forms = []
    for k in kernels[:6]:
        name = k["name"]
        S = 9 if name.endswith("_dx") else 1
        forms.append(dict(
            name=name + "_bf16_panel", route="cuda", source=k["source"],
            replaces=k["replaces"],
            launches=sum(bp["launches"][name].values()),
            launches_by_path=bp["launches"][name],
            **bp["rows"][(name, S, "bfloat16")],
            at_float32=bp["rows"][(name, S, "float32")],
            at_other_members=bp["rows"][(name, 10 - S, "bfloat16")],
            peak_memory=bp["memory"] if name == "sdf_ffn_fwd" else None))
    kernels += forms
    # phase 21: the streamed route's three kernels (one source, a library
    # each) and the conditional EM over moment chunks, each at its timed
    # shape (bf16 compute on the bf16 panel, the f32 row beside) with its
    # launches on phase 21's paths; the FFN kernels' bf16 rows are their
    # tensor-core form (route 4), named with its launches beside; the
    # panel cotangent's also carries its audit and route 3 in turns
    tpu_rows = {"sdf_ffn_fwd": ("pallas_ffn.py:188", "pallas_ffn.py:561"),
                "sdf_ffn_bwd": ("pallas_ffn.py:205", "pallas_ffn.py:591"),
                "sdf_ffn_dx": ("pallas_ffn.py:300", None),
                "cond_em_fwd": ("pallas_moment.py:64", "pallas_moment.py:274"),
                "cond_em_bwd": ("pallas_moment.py:86", "pallas_moment.py:302"),
                "cond_em_dx": ("pallas_moment.py:134", None)}
    for name in SH_KERNELS:
        stream = not name.startswith("cond_em")
        S = 9 if name.endswith("_dx") else 1
        by = shp["launches"][name + "_stream" if stream else name]
        rep_, also = tpu_rows[name]
        row = dict(
            name=name + ("_stream" if stream else "_moment_chunks"),
            route="cuda",
            source=src + ("sdf_ffn_stream.cu" if stream else "cond_em.cu"),
            replaces=tpu + rep_, launches=sum(by.values()),
            launches_by_path=by, **shp["rows"][(name, S, "bfloat16")],
            at_float32=shp["rows"][(name, S, "float32")])
        if S == 1:  # the member axis beside the training shape
            row["at_nine_members"] = {cd: shp["rows"][(name, 9, cd)]
                                      for cd in ("bfloat16", "float32")}
        if also:
            row["also_replaces"] = tpu + also
        if name + "_stream_mma" in shp["launches"]:
            row["tensor_core_kernel"] = name[8:] + "_stream_mma_kernel"
            row["tensor_core_launches_by_path"] = shp["launches"][
                name + "_stream_mma"]
            check(sum(row["tensor_core_launches_by_path"].values()) > 0,
                  f"phase 21 launched {row['tensor_core_kernel']} no time")
        if name + "_stream_tiled" in shp["launches"]:
            row["f32_kernel"] = name[8:] + "_stream_tiled_kernel"
            row["f32_launches_by_path"] = shp["launches"][
                name + "_stream_tiled"]
            row["f32_route5_vs_route2_in_turns"] = {
                k: v for k, v in shp["rows"]["route5"]["in_turns"].items()
                if k.startswith(name[8:])}
            row["f32_route5_bit_for_bit_route2"] = shp["rows"]["route5"][
                "bit_for_bit_route2"]
            check(sum(row["f32_launches_by_path"].values()) > 0,
                  f"phase 21 launched {row['f32_kernel']} no time")
        if stream:
            row["scratch_tile_plans"] = {
                k: v for k, v in shp["rows"]["scratch_plans"].items()
                if k.startswith(name[8:])}
        if name == "sdf_ffn_dx":
            row["tensor_core_audit"] = shp["rows"]["dx_route4"]["audit"]
            row["route3_vs_route4_in_turns"] = shp["rows"]["dx_route4"][
                "in_turns"]
        if stream:
            row["plans"] = {f"{cd} {'bf16' if xb16 else 'f32'} panel":
                            shp["plans"][(SH_HIDDEN, 46, name[8:], cd,
                                          xb16)]
                            for cd in ("float32", "bfloat16")
                            for xb16 in (False, True)}
        check(row["launches"] > 0, f"phase 21 launched {row['name']} no "
                                   f"time")
        kernels.append(row)
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
