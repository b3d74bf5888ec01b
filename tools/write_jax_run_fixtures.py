#!/usr/bin/env python3
"""Write the two JAX run directories the port's checkpoint tests and the
card's check read (``tests/fixtures/jax_run_msgpack`` and
``tests/fixtures/jax_run_pt``).

Both hold the paper-width GAN (F = 46, M = 178, hidden [64, 64], LSTM [4],
K = 8) with the same weights, the JAX package's init from
``jax.random.key(SEED)``: the first as the JAX package's own
``best_model_sharpe.msgpack`` (``save_params``: flax msgpack and its
``.sha256`` sidecar), the second as its ``save_torch_checkpoint`` twin
``best_model_sharpe.pt``; each with its ``config.json``. The bytes are a
function of the JAX and torch versions alone, so a test can hold the
checked-in files equal to what this script writes now.

    JAX_PLATFORMS=cpu python tools/write_jax_run_fixtures.py [OUT_DIR]
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "tests" / "fixtures"
SEED = 21
NAMES = ("jax_run_msgpack", "jax_run_pt")


def paper_config():
    from deeplearninginassetpricing_paperreplication_tpu.utils.config import (
        GANConfig,
    )

    return GANConfig(macro_feature_dim=178, individual_feature_dim=46,
                     hidden_dim=(64, 64), num_units_rnn=(4,),
                     num_condition_moment=8, dropout=0.05)


def write(out: Path = OUT) -> list:
    """Write both run dirs under `out`; returns their paths."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from deeplearninginassetpricing_paperreplication_tpu.models.gan import GAN
    from deeplearninginassetpricing_paperreplication_tpu.training.checkpoint import (
        save_params,
        save_torch_checkpoint,
    )

    cfg = paper_config()
    params = GAN(cfg).init(jax.random.key(SEED))
    msgpack_dir, pt_dir = (Path(out) / n for n in NAMES)
    for d in (msgpack_dir, pt_dir):
        d.mkdir(parents=True, exist_ok=True)
    cfg.save(msgpack_dir / "config.json")
    save_params(msgpack_dir / "best_model_sharpe.msgpack", params)
    save_torch_checkpoint(pt_dir / "best_model_sharpe.pt", params, cfg)
    return [msgpack_dir, pt_dir]


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    for d in write(Path(sys.argv[1]) if len(sys.argv) > 1 else OUT):
        print(d)
