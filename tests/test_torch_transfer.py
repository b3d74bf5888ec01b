"""The port's mask-packed transfer (data/transfer.py) and its streamed form
(data/pipeline.stream_batch) against the JAX package's device_put_batch and
against PanelDataset.to_batch, bit for bit, on the CPU: dense, packed and
auto routes on the f32 wire, and the bf16 wire against JAX's
astype(bfloat16). The CUDA tests (pinned slabs, the copy stream) run on the
card."""

import numpy as np
import pytest
import torch

from deeplearninginassetpricing_paperreplication_torch.data import (
    pipeline as ppipe,
)
from deeplearninginassetpricing_paperreplication_torch.data import (
    transfer as ptr,
)
from deeplearninginassetpricing_paperreplication_torch.data.panel import (
    load_splits,
)
from deeplearninginassetpricing_paperreplication_tpu.data import (
    transfer as jtr,
)

ROUTES = [
    {"packed": True},
    {"packed": False},
    {"packed": "auto"},
    {"packed": True, "bf16_wire": True},
    {"packed": False, "bf16_wire": True},
]
IDS = ["packed", "dense", "auto", "packed-bf16", "dense-bf16"]


@pytest.fixture(scope="module")
def port_splits(synthetic_dir):
    return load_splits(synthetic_dir)


def _np(v):
    return np.asarray(v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                      else v)


def _assert_batch_equal(ref, got, what=""):
    assert set(ref) == set(got), what
    for k in ref:
        a, b = _np(ref[k]), _np(got[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (what, k)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {k}")


def _coverage_batch(coverage, t=8, n=50, f=4, seed=0):
    rng = np.random.default_rng(seed)
    mask = (rng.random((t, n)) < coverage).astype(np.float32)
    ind = rng.standard_normal((t, n, f)).astype(np.float32) * mask[:, :, None]
    ret = rng.standard_normal((t, n)).astype(np.float32) * mask
    return {"individual": ind, "returns": ret, "mask": mask}


@pytest.mark.parametrize("coverage", [0.0, 0.3, 0.9, 1.0])
def test_pack_rows_equals_jax(coverage):
    b = _coverage_batch(coverage, seed=3)
    got = ptr.pack_rows(b["mask"], b["individual"], b["returns"])
    ref = jtr.pack_rows(b["mask"], b["individual"], b["returns"])
    for a, c in zip(got, ref):
        assert a.dtype == c.dtype
        np.testing.assert_array_equal(a, c)
    assert got[0].dtype == np.int32


@pytest.mark.parametrize("route", ROUTES, ids=IDS)
@pytest.mark.parametrize("split", [0, 1, 2])
def test_device_put_batch_equals_jax(port_splits, splits, route, split):
    """Every route lands the JAX device_put_batch's arrays bit for bit; on
    the f32 wire both are to_batch's."""
    ref = jtr.device_put_batch(splits[split].full_batch(), **route)
    got = ptr.device_put_batch(port_splits[split].full_batch(),
                               device="cpu", **route)
    _assert_batch_equal(ref, got, str(route))
    if not route.get("bf16_wire"):
        _assert_batch_equal(port_splits[split].to_batch("cpu"), got)


@pytest.mark.parametrize("packed", [True, False])
def test_bf16_wire_is_the_rounded_panel(port_splits, packed):
    """The bf16 wire lands to_batch's panel rounded to bf16 (torch's and
    JAX's round to nearest even agree), everything else f32 exact."""
    import jax.numpy as jnp

    ds = port_splits[0]
    ref = ds.to_batch("cpu")
    got = ptr.device_put_batch(ds.full_batch(), packed=packed, device="cpu",
                               bf16_wire=True)
    np.testing.assert_array_equal(
        got["individual"].numpy(),
        ref["individual"].to(torch.bfloat16).float().numpy())
    np.testing.assert_array_equal(
        got["individual"].numpy(),
        ds.individual.astype(jnp.bfloat16).astype(np.float32))
    for k in ("returns", "mask", "macro"):
        assert torch.equal(got[k], ref[k]), k


def test_bf16_round_to_nearest_even_on_ties():
    """Values exactly between two bf16 neighbours round to the even one,
    as JAX's cast does."""
    import jax.numpy as jnp

    bits = np.array([0x3F808000, 0x3F818000, 0xBF808000, 0x3F80C000,
                     0x3F80FFFF, 0x00008000, 0x7F7F8000], np.uint32)
    x = bits.view(np.float32)
    batch = {"individual": x.reshape(1, 7, 1), "returns": np.ones((1, 7),
             np.float32), "mask": np.ones((1, 7), np.float32)}
    got = ptr.device_put_batch(batch, packed=False, device="cpu",
                               bf16_wire=True)["individual"].numpy()
    np.testing.assert_array_equal(
        got.reshape(-1).view(np.uint32),
        x.astype(jnp.bfloat16).astype(np.float32).view(np.uint32))


@pytest.mark.parametrize("route", ROUTES, ids=IDS)
@pytest.mark.parametrize("chunk_bytes", [160, 4096, None])
def test_stream_batch_equals_device_put_batch(port_splits, route,
                                              chunk_bytes):
    """Streamed through two slabs (160 bytes: dozens of reuses of each),
    bit for bit the one-copy transfer."""
    batch = port_splits[0].full_batch()
    ref = ptr.device_put_batch(batch, device="cpu", **route)
    kw = {} if chunk_bytes is None else {"chunk_bytes": chunk_bytes}
    stats = {}
    got = ppipe.stream_batch(batch, device="cpu", stats=stats, **route, **kw)
    _assert_batch_equal(ref, got, str(route))
    if chunk_bytes == 160:
        assert stats["chunks"] > 20


def test_stream_batch_packed_rep_is_used_verbatim(port_splits):
    batch = port_splits[0].full_batch()
    rep = ptr.pack_rows(batch["mask"], batch["individual"], batch["returns"])
    ref = ptr.device_put_batch(batch, packed=True, device="cpu")
    # a packed_rep whose rows are tagged: the transfer must ship them as is
    tagged = (rep[0], rep[1] + 1.0, rep[2])
    got = ppipe.stream_batch(batch, packed=True, device="cpu",
                             packed_rep=tagged, chunk_bytes=512)
    np.testing.assert_array_equal(
        got["individual"].numpy(),
        ref["individual"].numpy() + ref["mask"].numpy()[..., None])
    got = ppipe.stream_batch(batch, packed=True, device="cpu",
                             packed_rep=rep)
    _assert_batch_equal(ref, got)


@pytest.mark.parametrize("kwargs", [{"packed": True}, {"packed": False},
                                    {"packed": True, "bf16_wire": True}])
def test_extra_keys_pass_through(port_splits, kwargs):
    batch = port_splits[0].full_batch()
    batch["n_assets"] = np.float32(7)
    for out in (ptr.device_put_batch(batch, device="cpu", **kwargs),
                ppipe.stream_batch(batch, device="cpu", chunk_bytes=256,
                                   **kwargs)):
        assert out["n_assets"].shape == () and float(out["n_assets"]) == 7.0
        np.testing.assert_array_equal(out["macro"].numpy(), batch["macro"])


@pytest.mark.parametrize("coverage", [ptr.AUTO_PACK_THRESHOLD - 0.25,
                                      ptr.AUTO_PACK_THRESHOLD + 0.13])
def test_auto_pack_threshold_both_sides(coverage):
    assert ptr.AUTO_PACK_THRESHOLD == jtr.AUTO_PACK_THRESHOLD
    batch = _coverage_batch(coverage)
    should_pack = float(batch["mask"].mean()) < ptr.AUTO_PACK_THRESHOLD
    stats = {}
    auto = ptr.device_put_batch(batch, packed="auto", device="cpu",
                                stats=stats)
    assert stats["packed"] == should_pack
    s_auto = ppipe.stream_batch(batch, packed="auto", device="cpu",
                                chunk_bytes=64)
    for forced in (True, False):
        ref = ptr.device_put_batch(batch, packed=forced, device="cpu")
        _assert_batch_equal(ref, auto)
        _assert_batch_equal(ref, s_auto)


def test_wire_bytes_packed_against_dense(port_splits):
    """Bytes shipped: dense is every cell; packed is the valid rows, their
    int32 indices and returns; the bf16 wire halves the rows."""
    ds = port_splits[0]
    batch = ds.full_batch()
    t, n, f = ds.individual.shape
    v = int(ds.mask.sum())
    m = ds.macro.size
    st = {}
    ptr.device_put_batch(batch, packed=False, device="cpu", stats=st)
    assert st["wire_bytes"] == 4 * (t * n * f + 2 * t * n + m)
    ptr.device_put_batch(batch, packed=True, device="cpu", stats=st)
    assert st["wire_bytes"] == 4 * (v * f + 2 * v + m)
    ptr.device_put_batch(batch, packed=True, device="cpu", stats=st,
                         bf16_wire=True)
    assert st["wire_bytes"] == 2 * v * f + 4 * (2 * v + m)


def test_f32_contract_is_checked(port_splits):
    batch = port_splits[0].full_batch()
    batch["individual"] = batch["individual"].astype(np.float64)
    for fn in (ptr.device_put_batch, ppipe.stream_batch):
        with pytest.raises(TypeError, match="float32"):
            fn(batch, device="cpu")


def test_empty_panel_ships():
    batch = _coverage_batch(0.0)
    for packed in (True, False):
        out = ppipe.stream_batch(batch, packed=packed, device="cpu",
                                 chunk_bytes=64)
        assert float(out["mask"].sum()) == 0.0
        assert float(out["individual"].abs().sum()) == 0.0


def test_slabs_are_reused_in_turn(port_splits):
    batch = port_splits[0].full_batch()
    slabs = ptr.PinnedSlabs("cpu", 1024)
    st = {}
    ppipe.stream_batch(batch, packed=True, device="cpu", chunk_bytes=1024,
                       slabs=slabs, stats=st)
    assert st["chunks"] >= 4 and slabs.reuses == st["chunks"] - 2
    # a second call through the same slabs reuses both from its first chunk
    ppipe.stream_batch(batch, packed=True, device="cpu", chunk_bytes=1024,
                       slabs=slabs)
    assert slabs.reuses == 2 * st["chunks"] - 2
    with pytest.raises(ValueError, match="exceeds the slab"):
        ppipe.stream_batch(batch, packed=True, device="cpu",
                           chunk_bytes=4096, slabs=slabs)


def test_buffered_puts_keeps_order_and_reraises():
    out = ppipe.buffered_puts(7, lambda i: i * i, lambda x: x + 1)
    assert out == [i * i + 1 for i in range(7)]
    assert ppipe.buffered_puts(1, lambda i: 5, lambda x: x) == [5]

    def bad(i):
        if i == 3:
            raise KeyError("chunk 3")
        return i

    with pytest.raises(KeyError, match="chunk 3"):
        ppipe.buffered_puts(6, bad, lambda x: x)


def test_default_device_is_cuda(port_splits, monkeypatch):
    """The entry points run on the card unless asked for the CPU: with no
    card, asking for the default device is an error naming CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ptr.device_put_batch(port_splits[0].full_batch())


@pytest.mark.cuda
@pytest.mark.parametrize("route", ROUTES, ids=IDS)
def test_cuda_routes_equal_to_batch(port_splits, route):
    """On the card: pinned staging, the copy stream and the scatter, bit
    for bit to_batch("cuda") (bf16 wire: its rounded panel); a 160-byte
    slab forces dozens of slab reuses behind CUDA events."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ds = port_splits[0]
    ref = ds.to_batch("cuda")
    if route.get("bf16_wire"):
        ref["individual"] = ref["individual"].to(torch.bfloat16).float()
    for out in (ptr.device_put_batch(ds.full_batch(), device="cuda", **route),
                ppipe.stream_batch(ds.full_batch(), device="cuda",
                                   chunk_bytes=160, **route)):
        for k in ref:
            assert torch.equal(out[k], ref[k]), (route, k)
