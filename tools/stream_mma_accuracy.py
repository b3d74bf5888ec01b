"""How far the streamed SDF-FFN backward's and panel cotangent's two bf16
routes sit from the plain version, beside how far the plain version sits
from an exact evaluation, by depth: the evidence behind
``ops/sdf_ffn.py::STREAM_MMA_MAX_LAYERS``.

Under bf16 compute every product reads bf16 operands and accumulates in f32.
The plain version (``sdf_ffn_bwd_reference``), route 3 (the CUDA cores: one
FMA at a time per element, in k order) and route 4 (``mma.sync``) share the
rounding points and differ only in the order of their f32 sums. This runs
all three, and the same rounding points evaluated in float64, on the same
seeded inputs (the ``chip_smoke.py`` phase-21 generator's draws: torch
generator 21, T = 6, N = 10,000, F = 46) at stacks of 64 and 256 units and
growing depth, S = 1 and 9, dropout 0 and 0.1, and prints, per case, the
largest max|d|/max|ref| over the gradient tensors (dzp, dK1, dkout, each dW_l
and db_l) of route 4 and route 3 against the plain version and of the plain
version and route 4 against the float64 evaluation. Then the same for the
panel cotangent dx (``sdf_ffn_dx_reference``), route 4 on a forced plan at
every depth, and its audit build's count of top-layer decisions flipped
outside the certified window: route 4's dx runs the layers below the top as
route 3's exact chains and certifies the top layer's decisions, so its
distance from plain should not grow with depth the way the backward's does.
A stack too deep for route 4's shared memory is skipped. It needs a CUDA card
and builds the streamed backward's and panel cotangent's libraries (and the
dx's audit build) from this checkout::

    python3 tools/stream_mma_accuracy.py
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from deeplearninginassetpricing_paperreplication_torch.ops import (  # noqa: E402
    sdf_ffn as K,
)

T, N, F = 6, 10_000, 46
STACKS = ([(64,) * k for k in (2, 4, 6, 8, 10, 12, 16)]
          + [(256,) * k for k in (2, 4, 6)])


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def inputs(g, S, hidden, dev):
    """Seeded inputs as ``chip_smoke._sh_inputs`` draws them."""
    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale
    x = rand(T, F, N)
    zp = rand(S, 1, hidden[0], scale=0.3)
    k1T = rand(S, hidden[0], F, scale=F ** -0.5)
    mids = [(rand(S, b, a, scale=a ** -0.5), rand(S, b, scale=0.1))
            for a, b in zip(hidden, hidden[1:])]
    kout = rand(S, hidden[-1], scale=hidden[-1] ** -0.5)
    rand(S)  # bout: the backward does not read it
    zp = (zp + rand(S, T, hidden[0], scale=0.3)).contiguous()
    gout = rand(S, T, N) / N
    return x, zp, k1T, mids, kout, gout


def r16(a, dt):
    return a.to(torch.bfloat16).to(dt)


def exact_chain(x_t, zp, k1T, mids, kout, g, seed, rate, dt):
    """The plain versions' forward and dh chain at their rounding points,
    the sums in `dt`: (the rounded panel, each layer's activations, each
    layer's dh_pre)."""
    S = zp.shape[0]
    drop = rate > 0
    if drop:
        threshold, scale = K.dropout_params(rate)
        row = K._row_hash(seed, S, T, N, x_t.device)
    x = r16(x_t.float(), dt)
    h = torch.einsum("shf,tfn->sthn", r16(k1T, dt), x) + zp[..., None].to(dt)
    acts, facs = [], []
    for layer, wb in enumerate([None] + list(mids)):
        if wb is not None:
            w, b = wb
            h = torch.einsum("sko,ston->stkn", r16(w, dt), r16(acts[-1], dt))
            h = h + b[:, None, :, None].to(dt)
        keep = ((K._unit_bits(row, layer, h.shape[2]) >= threshold).to(dt)
                * scale if drop else 1.0)
        facs.append((h > 0).to(dt) * keep)
        acts.append(torch.relu(h) * keep)
    dh = r16(kout, dt)[:, None, :, None] * r16(g, dt)[:, :, None, :]
    pres = [None] * len(facs)
    for li in range(len(mids), 0, -1):
        pres[li] = dh * facs[li]
        dh = torch.einsum("sji,stjn->stin", r16(mids[li - 1][0], dt),
                          r16(pres[li], dt))
    pres[0] = dh * facs[0]
    return x, acts, pres


def exact_bwd(x_t, zp, k1T, mids, kout, g, seed, rate, dt=torch.float64):
    """``sdf_ffn_bwd_reference``'s rounding points, its sums in `dt`:
    [dzp, dK1, dkout, dW_1, db_1, ...]."""
    x, acts, pres = exact_chain(x_t, zp, k1T, mids, kout, g, seed, rate, dt)
    out = [pres[0].sum(dim=3),
           torch.einsum("stjn,tfn->sjf", r16(pres[0], dt), x),
           torch.einsum("sthn,stn->sh", acts[-1], g.to(dt))]
    for li in range(1, len(mids) + 1):
        out += [torch.einsum("stjn,stin->sji", r16(pres[li], dt),
                             r16(acts[li - 1], dt)),
                pres[li].sum(dim=(1, 3))]
    return out


def launched(x, zp, packed, gout, seed, rate, route):
    """The streamed backward on `route` (3 or 4) at this card's plan."""
    lay, S = packed.layout, packed.n_members
    regs = K._stream_registers("bwd", route, False)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    tile, smem, blocks, G, _, scratch = K.stream_plan(
        lay, "bwd", sms, S, T, N, regs, route)
    plan = K.BwdPlan(tile, K.STREAM_THREADS, smem, blocks, G, 0, route,
                     scratch)
    grads, dzp = K._launch_bwd(x, zp, packed, gout, seed, rate, plan)
    dk1T, dmids, dkout, _ = K.unpack_grads(grads, lay)
    return [dzp, dk1T, dkout] + [t for wb in dmids for t in wb]


def exact_dx(x_t, zp, k1T, mids, kout, g, seed, rate, dt=torch.float64):
    """``sdf_ffn_dx_reference``'s rounding points, its sums in `dt`."""
    _, _, pres = exact_chain(x_t, zp, k1T, mids, kout, g, seed, rate, dt)
    return torch.einsum("sjf,stjn->tfn", r16(k1T, dt), r16(pres[0], dt))


def dx_plan(packed, x, route):
    """The streamed dx's plan on `route` (3, or 4 forced at any depth) at
    this card's registers."""
    lay, S = packed.layout, packed.n_members
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    tile, smem, blocks, G, cells, scratch = K.stream_plan(
        lay, "dx", sms, S, T, N, K._stream_registers("dx", route, False),
        route)
    return K.DxPlan(route, tile, K.STREAM_THREADS, 2, 1, False, smem, blocks,
                    G, cells, scratch)


def worst(a, b) -> float:
    return max(float((p.double() - q.double()).abs().max()
                     / q.double().abs().max()) for p, q in zip(a, b))


def dx_case(name, x, zp, packed, k1T, mids, kout, gout, seed, rate):
    """The panel cotangent's routes 4 (and its audit) and 3 at one case."""
    try:
        plan4 = dx_plan(packed, x, K.STREAM_MMA_ROUTE)
    except ValueError as e:  # route 4's shared memory
        print(f"{name} dx: no route-4 plan ({e})", flush=True)
        return
    r4 = [K._launch_dx(x, zp, packed, gout, seed, rate, plan4)]
    audit, counts = K.dx_audit(x, zp, packed, gout, seed, rate, plan4)
    r3 = [K._launch_dx(x, zp, packed, gout, seed, rate,
                       dx_plan(packed, x, K.STREAM_ROUTES["bfloat16"]))]
    plain = [K.sdf_ffn_dx_reference(x, zp, k1T, mids, kout, gout, "bfloat16",
                                    seed, rate)]
    exact = [exact_dx(x, zp, k1T, mids, kout, gout, seed, rate)]
    torch.cuda.synchronize()
    same = torch.equal(audit, r4[0])
    print(f"{name} dx: route 4 vs plain {worst(r4, plain):.2e}, route 3 vs "
          f"plain {worst(r3, plain):.2e}, plain vs f64 "
          f"{worst(plain, exact):.2e}, route 4 vs f64 {worst(r4, exact):.2e}"
          f"; audit: {counts['certified']} of {counts['elements']} "
          f"certified, {counts['flips']} mma flips, "
          f"{counts['flips_outside']} outside the window, max|mma - chain|/"
          f"bound {counts['max_ratio']:.3e}, its dx "
          f"{'bit for bit' if same else 'NOT bit for bit'} route 4's",
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("this measurement needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(21)
    print(card(), flush=True)
    for hidden in STACKS:
        for S in (1, 9):
            x, zp, k1T, mids, kout, gout = inputs(g, S, hidden, dev)
            seed = 7 if S == 1 else list(range(7, 7 + S))
            packed = K.pack_ffn(k1T, mids, kout, torch.zeros(S, device=dev),
                                "bfloat16")
            for rate in (0.0, 0.1):
                name = f"{len(hidden)}x{hidden[0]} S={S} dropout {rate}"
                try:
                    r4 = launched(x, zp, packed, gout, seed, rate, 4)
                except ValueError as e:  # route 4's shared memory
                    print(f"{name}: no route-4 plan ({e})", flush=True)
                    continue
                r3 = launched(x, zp, packed, gout, seed, rate, 3)
                ref = K.sdf_ffn_bwd_reference(x, zp, k1T, mids, kout, gout,
                                              "bfloat16", seed, rate)
                plain = [ref[0], ref[1], ref[3]] + [
                    t for wb in ref[2] for t in wb]
                exact = exact_bwd(x, zp, k1T, mids, kout, gout, seed, rate)
                torch.cuda.synchronize()
                print(f"{name}: route 4 vs plain {worst(r4, plain):.2e}, "
                      f"route 3 vs plain {worst(r3, plain):.2e}, plain vs "
                      f"f64 {worst(plain, exact):.2e}, route 4 vs f64 "
                      f"{worst(r4, exact):.2e}", flush=True)
                del r4, r3, ref, plain, exact
                dx_case(name, x, zp, packed, k1T, mids, kout, gout, seed,
                        rate)
            del x, zp, k1T, mids, kout, gout
    return 0


if __name__ == "__main__":
    sys.exit(main())
