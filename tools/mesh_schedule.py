"""Two schedules of the mesh-packed sweep's positions on two cards: one
position after the other, and a thread per card.

B1 and B2 of ``chip_smoke.py`` phase 9's covering grid (f32, 8/4/16
epochs, seed 42, four learning rates: grid width 4) on its synthetic panel
(N = 10,000, F = 46, M = 178, months 48/12/24), each bucket laid over two
grid positions of span 2 as ``parallel.sweep.train_bucket(grid_mesh=…)``
lays it: each position trains its rows through ``train_members`` on its
own card. Per bucket the script times, in the order

    in turn on cuda:0 + cuda:1, threads on cuda:0 + cuda:1,
    threads on cuda:0 + cuda:1, in turn on cuda:0 + cuda:1,
    in turn on two spans of cuda:0,

the wall from the first position's start to the last one's end (every
card synchronized), holds every run's histories and reported Sharpes bit
for bit against the first, and prints one JSON line of the walls, with
the card's name and power limit.

    python tools/mesh_schedule.py        # on a host of two cards or more
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from deeplearninginassetpricing_paperreplication_torch.data.panel import (  # noqa: E402,E501
    load_splits,
)
from deeplearninginassetpricing_paperreplication_torch.data.synthetic import (  # noqa: E402,E501
    generate_all_splits,
)
from deeplearninginassetpricing_paperreplication_torch.models.networks import (  # noqa: E402,E501
    init_member_params,
)
from deeplearninginassetpricing_paperreplication_torch.ops import (  # noqa: E402,E501
    _nvcc,
    cond_em,
    sdf_ffn,
)
from deeplearninginassetpricing_paperreplication_torch.parallel.ensemble import (  # noqa: E402,E501
    train_members,
)
from deeplearninginassetpricing_paperreplication_torch.parallel.partition import (  # noqa: E402,E501
    on_device,
)
from deeplearninginassetpricing_paperreplication_torch.parallel.sweep import (  # noqa: E402,E501
    dropout_base_seed,
)
from deeplearninginassetpricing_paperreplication_torch.utils.config import (  # noqa: E402,E501
    ExecutionConfig,
    GANConfig,
    TrainConfig,
)

PANEL = dict(n_periods_train=48, n_periods_valid=12, n_periods_test=24,
             n_stocks=10_000, n_features=46, n_macro=178, seed=42)
SCHEDULE = dict(num_epochs_unc=8, num_epochs_moment=4, num_epochs=16,
                ignore_epoch=2)
BUCKETS = {"B1": ((64, 64), (4,), 8, 0.05), "B2": ((128, 128), (8,), 4, 0.1)}
LRS = (1e-3, 5e-4, 2e-3, 1e-4)
SEED = 42


def sync(devices):
    for d in set(devices):
        torch.cuda.synchronize(d)


def run_spans(cfg, placed, devices, tcfg, ex, threads):
    """The grid's two spans, position p on devices[p]: (wall s, outputs)."""
    seeds = [SEED] * len(LRS)
    start = init_member_params(cfg, seeds)
    G, D = len(seeds), len(devices)

    def run(p):
        a, b = p * G // D, (p + 1) * G // D
        dev = devices[p]
        with on_device(dev):
            return train_members(
                cfg, placed[dev]["train"], placed[dev]["valid"], None,
                seeds[a:b], tcfg, lrs=list(LRS[a:b]),
                dropout_seeds=[dropout_base_seed(s) for s in seeds[a:b]],
                exec_cfg=ex, state_dicts={k: v[a:b] for k, v in start.items()},
                verbose=False)

    sync(devices)
    t0 = time.perf_counter()
    if threads:
        with ThreadPoolExecutor(D) as pool:
            outs = list(pool.map(run, range(D)))
    else:
        outs = [run(p) for p in range(D)]
    sync(devices)
    return time.perf_counter() - t0, outs


def same(a, b):
    return all(np.array_equal(x["best_valid_sharpe"], y["best_valid_sharpe"])
               and all(np.array_equal(x["history"][k], y["history"][k])
                       for k in x["history"]) for x, y in zip(a, b))


def main() -> int:
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("this measurement needs two CUDA cards", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.splitlines()[0].strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    _nvcc.run(sdf_ffn.build_jobs([64, 128], kernels=("fwd", "bwd"))
              + cond_em.build_jobs())
    with tempfile.TemporaryDirectory() as tmp:
        generate_all_splits(tmp, verbose=False, compress=False, **PANEL)
        train, valid, _ = load_splits(tmp)
    two = [torch.device("cuda:0"), torch.device("cuda:1")]
    one = [two[0], two[0]]
    placed = {d: {"train": train.to_batch(str(d)),
                  "valid": valid.to_batch(str(d))} for d in two}
    ex = ExecutionConfig(kernel="on", compute_dtype="float32", device="cuda")
    tcfg = TrainConfig(**SCHEDULE, seed=SEED, print_freq=10 ** 6)
    base = GANConfig(macro_feature_dim=train.macro_feature_dim,
                     individual_feature_dim=train.individual_feature_dim)
    walls = {}
    for tag, (h, r, k, d) in BUCKETS.items():
        cfg = dataclasses.replace(base, hidden_dim=h, num_units_rnn=r,
                                  num_condition_moment=k, dropout=d)
        # library loads and first allocations on both cards
        run_spans(cfg, placed, two, TrainConfig(1, 1, 1, ignore_epoch=0),
                  ex, threads=False)
        legs = {"in_turn_two_cards": [], "threads_two_cards": [],
                "in_turn_one_card": []}
        ref = None
        for leg, devices, threads in (
                ("in_turn_two_cards", two, False),
                ("threads_two_cards", two, True),
                ("threads_two_cards", two, True),
                ("in_turn_two_cards", two, False),
                ("in_turn_one_card", one, False)):
            wall, outs = run_spans(cfg, placed, devices, tcfg, ex, threads)
            ref = ref or outs
            if not same(outs, ref):
                print(f"{tag} {leg}: the outputs differ from the first run's",
                      file=sys.stderr)
                return 1
            legs[leg].append(wall)
        walls[tag] = legs
        print(f"[mesh schedule] {tag} hidden={list(h)} span 2: "
              + "; ".join(f"{leg} {[round(w, 3) for w in ws]} s"
                          for leg, ws in legs.items())
              + f"; every run bit for bit the first ({card})", flush=True)
    print(card)
    print(json.dumps({"mesh_schedule_walls_s": walls, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
