"""One-call CUDA-event times of the six panel kernels of a checkout, on an
f32 panel and (where the checkout takes one) a bf16 panel.

The kernels of ``<root>/deeplearninginassetpricing_paperreplication_torch``
(built from that checkout's ``ops/csrc/`` into its ``ops/_build/``) at the
training paths' shapes: T = 48, N = 10,000, F = 46, hidden (64, 64), K = 8,
S = 1 and 9, f32 and bf16 compute; the FFN kernels with dropout 0.05, the
conditional-EM kernels without. The inputs are seeded (torch generator 20)
and the same in every checkout; every call goes through the wrappers'
launchers (``sdf_ffn._launch``, ``_launch_bwd``, ``_launch_dx``,
``cond_em._launch_fwd``, ``_launch_bwd``, ``_launch_dx``), whose Python
signatures an older checkout shares. Each time is the median of 20 calls
after 3 warm-up calls (``chip_smoke.cuda_ms``'s method). Prints one JSON
line: the card (``nvidia-smi`` name and power limit), the root, and
{"<kernel> S=<S> <compute> <panel>": ms}.

To compare two checkouts on one card, run them in turns in one call, e.g.
with the parent unpacked by ``git archive`` into the git-ignored
``_archive/parent``::

    python3 tools/panel_kernel_times.py --root _archive/parent
    python3 tools/panel_kernel_times.py --root .
    python3 tools/panel_kernel_times.py --root .
    python3 tools/panel_kernel_times.py --root _archive/parent
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

T, N, F, HIDDEN, KN = 48, 10_000, 46, (64, 64), 8
DROPOUT = 0.05


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=".",
                    help="the checkout whose kernels are timed")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("a CUDA card is needed", file=sys.stderr)
        return 2
    root = Path(opts.root).resolve()
    sys.path.insert(0, str(root))
    from deeplearninginassetpricing_paperreplication_torch.ops import (
        _nvcc,
    )
    from deeplearninginassetpricing_paperreplication_torch.ops import (
        cond_em as C,
    )
    from deeplearninginassetpricing_paperreplication_torch.ops import (
        sdf_ffn as K,
    )

    # the checkout's libraries, all nvcc processes started together
    _nvcc.run(K.build_jobs([64]) + C.build_jobs())
    dev = torch.device("cuda")
    bf16_panel = hasattr(K, "PANEL_DTYPES")
    times = {}
    for S in (1, 9):
        g = torch.Generator(device=dev).manual_seed(20)

        def rand(*shape, scale=1.0):
            return torch.randn(*shape, generator=g, device=dev) * scale

        xf = rand(T, F, N)
        zp = rand(S, T, HIDDEN[0], scale=0.3)
        k1T = rand(S, HIDDEN[0], F, scale=F ** -0.5)
        mids = [(rand(S, HIDDEN[1], HIDDEN[0], scale=HIDDEN[0] ** -0.5),
                 rand(S, HIDDEN[1], scale=0.1))]
        kout = rand(S, HIDDEN[1], scale=HIDDEN[1] ** -0.5)
        bout = rand(S, scale=0.1)
        gout = rand(S, T, N, scale=1.0 / N)
        zpm = rand(S, T, KN, scale=0.3)
        xr = rand(S, T, N, scale=0.1)
        tinv = 1.0 / torch.randint(1, T + 1, (N,), generator=g,
                                   device=dev).float()
        kT = rand(S, KN, F, scale=F ** -0.5)
        gem = rand(S, KN, N, scale=1.0 / N)
        seed = 7 if S == 1 else list(range(7, 7 + S))
        panels = {"f32": xf}
        if bf16_panel:
            panels["bf16"] = xf.to(torch.bfloat16)
        for cd in ("float32", "bfloat16"):
            packed = K.pack_ffn(k1T, mids, kout, bout, cd)
            calls = {
                "sdf_ffn_fwd": lambda x: K._launch(x, zp, packed, seed,
                                                   DROPOUT),
                "sdf_ffn_bwd": lambda x: K._launch_bwd(x, zp, packed, gout,
                                                       seed, DROPOUT),
                "sdf_ffn_dx": lambda x: K._launch_dx(x, zp, packed, gout,
                                                     seed, DROPOUT),
                "cond_em_fwd": lambda x: C._launch_fwd(x, zpm, xr, tinv, kT,
                                                       cd),
                "cond_em_bwd": lambda x: C._launch_bwd(x, zpm, xr, tinv, kT,
                                                       gem, cd),
                "cond_em_dx": lambda x: C._launch_dx(x, zpm, xr, tinv, kT,
                                                     gem, cd),
            }
            for name, call in calls.items():
                for tag, x in panels.items():
                    times[f"{name} S={S} {cd} {tag}"] = cuda_ms(
                        lambda: call(x))
    print(json.dumps({"card": card(), "root": str(opts.root),
                      "ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
