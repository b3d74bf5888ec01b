"""Where the time of the streamed f32 kernels (route 5,
``fwd_stream_tiled_kernel`` / ``bwd_stream_tiled_kernel`` /
``dx_stream_tiled_kernel`` in ``ops/csrc/sdf_ffn_stream.cu``) goes, by
ablation.

Each ablation is the checked-in source with one part of the work taken out
by a text edit (the edit's anchor must be in the source, else the script
fails naming it): the forward's output sums, the dropout hash of the
layer epilogues, the panel tile's staging, the backward's weight-gradient
products, the dh chain (backward and panel cotangent), the panel
cotangent's forward recompute and its K1 product, and that product on
the 256-unit pass of the layer products in place of its narrow map. An
ablated kernel computes something else, so its outputs are not checked;
the unmodified build is held bit for bit against the wrappers' own launch
(``sdf_ffn._launch`` / ``_launch_bwd`` / ``_launch_dx``). Every build is
one ``nvcc`` of the source with ``-DSDF_FFN_STREAM_KERNEL`` = 0 (forward),
1 (backward) or 2 (panel cotangent), all started together, into
``ops/_build/ablation/``, with ``-Xptxas -v`` (registers and spills of each
route-5 instance are printed).

Times: (256, 256), F = 46, T = 48, N = 10,000, dropout 0.05, the f32 panel
(seeded inputs, torch generator 3), the card's route-5 plan, S = 1 for the
forward and backward and S = 9 for the panel cotangent (the panel
gradient's); each the median of 3 CUDA-event calls after one warm-up
(``chip_smoke.cuda_ms``), the unmodified build and each ablation in turns
(base, ablation, ablation, base). Prints a line per build and kernel, then
one JSON line: the card (``nvidia-smi`` name and power limit) and
{"<kernel> <build>": [ms, ...]}. Run on the card from the repository's
root::

    python3 tools/stream_tiled_ablation.py
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402
from deeplearninginassetpricing_paperreplication_torch.ops import (  # noqa: E402
    _nvcc,
)
from deeplearninginassetpricing_paperreplication_torch.ops import (  # noqa: E402
    sdf_ffn as K,
)

T, N, F, HIDDEN = 48, 10_000, 46, [256, 256]
MEMBERS = {"fwd": 1, "bwd": 1, "dx": 9}

# {name: (kernels it applies to, [(anchor, replacement), ...])}
ABLATIONS = {
    "no_output_sums": (("fwd",), [(
        "#pragma unroll 8\n"
        "      for (int j = 0; j < HL; ++j)\n"
        "        a = fmaf(slab[j], top[(size_t)j * LD + n], a);",
        "      a = top[n] + (float)HL * slab[0];")]),
    "no_dropout_hash": (("fwd", "bwd"), [(
        "              if (drop.on)\n"
        "                e = sdf_ffn::keep_unit(hash[th.stock(c)], layer, u,",
        "              if (false)\n"
        "                e = sdf_ffn::keep_unit(hash[th.stock(c)], layer, u,")]),
    "no_panel_staging": (("fwd", "bwd"), [(
        "    if (!staged) stage_x<PX, kTileThreads>(X, x, T, F, N, t, n0, BN, "
        "LD);", ""), ("          if (staged) prefetch(c + gridDim.x);", ""), (
        "    stage_x<PX, kTileThreads>(X, x, T, F, N, t, n0, BN, LD);\n"
        "    stage_hash<kTileThreads>(hash, drop, s, t, n0, BN);\n"
        "    for (int n",
        "    stage_hash<kTileThreads>(hash, drop, s, t, n0, BN);\n"
        "    for (int n")]),
    "no_weight_gradients": (("bwd",), [(
        "      grad_product_tiled<BN>(dhp, L.h(l), act, L.h(l - 1), "
        "gp + L.off_w(l),\n                             L.hp(l - 1), slab);",
        ""), (
        "    grad_product_tiled<BN>(X, F, acts, H1, gp, L.hp(0), slab);", "")]),
    "no_dh_chain": (("bwd", "dx"), [(
        "      layer_product_tiled<kChain, BN, 4, 1>(",
        "      if (false) layer_product_tiled<kChain, BN, 4, 1>(")]),
    "no_recompute": (("dx",), [(
        "      forward_cell_tiled<BN, 4, 1>(L, W, zp + ((size_t)s * T + t) * "
        "H1, X,\n                                   acts, 0, true, hash, "
        "drop, slab);", "")]),
    "no_k1_product": (("dx",), [(
        "      k1_product<BN>(L, W, acts, acc, drop, slab);", "")]),
    "k1_on_256_pass": (("dx",), [(
        "  switch (pad16(F) / 16) {", "  switch (0) {")]),
}


def build(name, kernel, source):
    out = _nvcc.BUILD_DIR / "ablation" / name
    out.mkdir(parents=True, exist_ok=True)
    (out / K.STREAM_SOURCE).write_text(source)
    for header in ("sdf_ffn_common.cuh", "panel.cuh"):
        (out / header).write_text((_nvcc.CSRC / header).read_text())
    lib = out / f"lib_{kernel}.so"
    proc = subprocess.Popen(
        [_nvcc.nvcc(), *_nvcc.NVCC_FLAGS, "-Xptxas", "-v",
         f"-DSDF_FFN_STREAM_KERNEL={K.KERNELS.index(kernel)}", "-o", str(lib),
         str(out / K.STREAM_SOURCE)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    return lib, proc


def tiled_usage(log):
    """{instance: 'registers, spills'} of the route-5 kernels in a ptxas
    log."""
    usage, cur = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            cur = line.split("'")[1] if "'" in line else line.split()[-1]
        if not cur or "tiled" not in cur:
            continue
        tag = (("bf16" if "nv_bfloat16" in cur else "f32") + " panel tile "
               + ("64" if "Li64E" in cur else "32"))
        if "spill" in line or "Used" in line:
            usage[tag] = (usage.get(tag, "") + " " + line.strip()).strip()
    return usage


def main():
    dev = torch.device("cuda")
    source = (_nvcc.CSRC / K.STREAM_SOURCE).read_text()
    jobs = {}
    for kernel in K.KERNELS:
        jobs[("base", kernel)] = build("base", kernel, source)
    for name, (kernels, edits) in ABLATIONS.items():
        text = source
        for anchor, new in edits:
            if anchor not in text:
                raise SystemExit(f"{name}: anchor not in {K.STREAM_SOURCE}: "
                                 f"{anchor[:70]!r}")
            text = text.replace(anchor, new)
        for kernel in kernels:
            jobs[(name, kernel)] = build(name, kernel, text)
    fns = {}
    for (name, kernel), (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name} {kernel} did not build:\n{log[-3000:]}")
        for tag, use in sorted(tiled_usage(log).items()):
            print(f"[ablation build] {kernel} {name} {tag}: {use}", flush=True)
        fn = getattr(ctypes.CDLL(str(lib)), f"sdf_ffn_{kernel}_stream_tiled")
        fn.argtypes = K._STREAM_TILED_ARGTYPES[kernel]
        fn.restype = ctypes.c_int
        fns[(name, kernel)] = fn

    g = torch.Generator(device=dev).manual_seed(3)
    lay = K.ffn_layout(F, HIDDEN)
    x = torch.randn(T, F, N, generator=g, device=dev)
    ins, plans = {}, {}
    for kernel, S in MEMBERS.items():
        if S not in ins:
            zp1, k1T, mids, kout, bout = CS._ffn_params(torch, g, S, F,
                                                       HIDDEN, dev)
            ins[S] = dict(
                zp=zp1.expand(S, T, HIDDEN[0]).contiguous(),
                gout=torch.randn(S, T, N, generator=g, device=dev) / N,
                packed=K.pack_ffn(k1T, mids, kout, bout, "float32"),
                seed=7 if S == 1 else list(range(7, 7 + S)))
        plans[kernel] = (
            K.card_fwd_plan(lay, dev, S, T, N, "float32") if kernel == "fwd"
            else K.card_bwd_plan(lay, dev, S, T, N) if kernel == "bwd"
            else K.card_dx_plan(lay, dev, S, T, N, "float32"))

    def runner(name, kernel):
        fn, plan = fns[(name, kernel)], plans[kernel]
        S = MEMBERS[kernel]
        zp, gout, packed, seed = (ins[S][k] for k in ("zp", "gout", "packed",
                                                      "seed"))

        def run():
            drop, _bases = K._dropout_args(seed, CS.DROPOUT, S, dev)
            outs = ((torch.empty(S, T, N, device=dev),) if kernel == "fwd"
                    else (gout, torch.zeros(S, plan.G, lay.P, device=dev),
                          torch.zeros(S, plan.G, T, HIDDEN[0], device=dev))
                    if kernel == "bwd"
                    else (gout, torch.empty(T, F, N, device=dev)))
            rc = fn(*K._panel_args(x), zp.data_ptr(), packed.params.data_ptr(),
                    *(t.data_ptr() for t in outs), K._layout_ints(lay),
                    K._layout_dev(lay, dev).data_ptr(), S, T, N, *drop,
                    plan.tile, plan.smem_bytes, plan.G,
                    torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise SystemExit(f"{name} {kernel}: launch failed ({rc})")
            return [o for o in outs if o is not gout]
        return run

    ints = lambda t: t.view(torch.int32)  # noqa: E731
    base = {k: runner("base", k)() for k in MEMBERS}
    one, nine = ins[1], ins[9]
    want = {"fwd": [K._launch(x, one["zp"], one["packed"], 7, CS.DROPOUT)],
            "bwd": list(K._launch_bwd(x, one["zp"], one["packed"],
                                      one["gout"], 7, CS.DROPOUT)),
            "dx": [K._launch_dx(x, nine["zp"], nine["packed"], nine["gout"],
                                nine["seed"], CS.DROPOUT)]}
    torch.cuda.synchronize()
    base["bwd"] = [base["bwd"][0].sum(dim=1), base["bwd"][1].sum(dim=1)]
    if not all(torch.equal(ints(a), ints(b)) for k in MEMBERS
               for a, b in zip(base[k], want[k])):
        raise SystemExit("the unmodified build is not the wrappers' launch "
                         "bit for bit")
    times = {}
    for (name, kernel) in jobs:
        if name == "base":
            continue
        b, a = runner("base", kernel), runner(name, kernel)
        t = [CS.cuda_ms(torch, f, reps=3, warmup=1) for f in (b, a, a, b)]
        times.setdefault(f"{kernel} base", []).extend([t[0], t[3]])
        times[f"{kernel} {name}"] = [t[1], t[2]]
        print(f"[ablation] sdf_ffn_{kernel} (256, 256) S={MEMBERS[kernel]} "
              f"T={T} N={N} dropout {CS.DROPOUT}: unmodified {t[0]:.4f} / "
              f"{t[3]:.4f} ms, {name} {t[1]:.4f} / {t[2]:.4f} ms",
              flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(json.dumps({"card": card, "times_ms": times}), flush=True)


if __name__ == "__main__":
    main()
