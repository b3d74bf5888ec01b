"""How far the SimpleSDF baseline's training history moves when its
initial weights move by about an f32 ulp.

``train_simple_sdf`` at full width (phase 6's synthetic panel: N = 10,000,
F = 46, macro 178, 48/12 months, seed 42; hidden (32, 16), dropout 0, lr
1e-3) on the plain route, twice: as drawn, and with the first layer's
initial weights scaled by ``1 + eps``. It prints both runs' train loss
and valid Sharpe at a few epochs, then per history key the largest
absolute and relative deviation. A kernel route whose sums run in another
order perturbs the run by about as much at every step, so these numbers
are the noise floor ``chip_smoke.py`` phase 16 holds the kernel route to.

    python tools/simple_sdf_sensitivity.py [--eps 1e-7] [--epochs 24]
        [--threads N] [--data_dir DIR]    # writes the panel there once

The CPU's summation order, and so the trajectory, depends on torch's
thread count; ``--threads`` fixes it.

CPU only, about a minute; the panel takes ~180 MB.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from deeplearninginassetpricing_paperreplication_torch.data.panel import (  # noqa: E402
    load_splits,
)
from deeplearninginassetpricing_paperreplication_torch.data.synthetic import (  # noqa: E402
    generate_all_splits,
)
from deeplearninginassetpricing_paperreplication_torch.models.networks import (  # noqa: E402
    SimpleSDF,
    init_params,
)
from deeplearninginassetpricing_paperreplication_torch.training.joint import (  # noqa: E402
    fit_simple_sdf,
)
from deeplearninginassetpricing_paperreplication_torch.utils.config import (  # noqa: E402
    ExecutionConfig,
)

PANEL = dict(n_periods_train=48, n_periods_valid=12, n_periods_test=24,
             n_stocks=10_000, n_features=46, n_macro=178, seed=42)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--eps", type=float, default=1e-7)
    ap.add_argument("--epochs", type=int, default=24)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--threads", type=int, default=None)
    ap.add_argument("--data_dir", type=str, default=None)
    args = ap.parse_args(argv)
    if args.threads:
        torch.set_num_threads(args.threads)
    with tempfile.TemporaryDirectory() as tmp:
        data = Path(args.data_dir or tmp)
        if not (data / "char").exists():
            generate_all_splits(data, verbose=False, compress=False, **PANEL)
        train, valid, _ = load_splits(data)
    batches = [ds.to_batch("cpu") for ds in (train, valid)]
    cfg = ExecutionConfig(device="cpu", compute_dtype="float32")
    runs = {}
    for eps in (0.0, args.eps):
        model = SimpleSDF(train.macro_feature_dim,
                          train.individual_feature_dim, (32, 16), 0.0, cfg)
        init_params(model, torch.Generator().manual_seed(args.seed))
        with torch.no_grad():
            model.fc_layers[0].weight.mul_(1.0 + eps)
        t0 = time.perf_counter()
        runs[eps] = fit_simple_sdf(model, *batches, num_epochs=args.epochs,
                                   seed=args.seed)
        pick = [0, args.epochs // 2, args.epochs - 1]
        print(f"eps {eps:g}: {time.perf_counter() - t0:.1f} s; train_loss "
              f"at epochs {pick}: {runs[eps]['train_loss'][pick]}; "
              f"valid_sharpe {runs[eps]['valid_sharpe'][pick]}")
    a, b = runs[0.0], runs[args.eps]
    for k in a:
        d = np.abs(a[k] - b[k])
        print(f"{k:13s} max |d| {d.max():.4e}  max |d|/|ref| "
              f"{(d / np.maximum(np.abs(a[k]), 1e-12)).max():.4e}")


if __name__ == "__main__":
    main()
