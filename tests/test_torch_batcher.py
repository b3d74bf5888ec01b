"""The port's request batchers against the JAX package's: the same arrival
script through both packages' ``ContinuousBatcher`` and ``MicroBatcher``
gives the same flushes, sheds, ``QueueFull``s and FIFO order.

Every scenario returns a transcript (the handler's flushes, the results or
errors each submission saw, the batcher's counters); each test runs it on
one package and checks it against the expected transcript, and
``test_transcripts_agree`` holds the two packages' transcripts equal.
"""

import asyncio
import threading
import time

import pytest

from deeplearninginassetpricing_paperreplication_torch.serving import (
    batcher as port_batcher,
)
from deeplearninginassetpricing_paperreplication_tpu.serving import (
    batcher as jax_batcher,
)

PACKAGES = {"jax": jax_batcher, "torch": port_batcher}


def _outcome(fut_or_exc):
    """A submission's fate as plain data: ("ok", value) or (error class
    name, reason)."""
    if isinstance(fut_or_exc, BaseException):
        return (type(fut_or_exc).__name__,
                getattr(fut_or_exc, "reason", str(fut_or_exc)))
    return ("ok", fut_or_exc)


async def _settle(futs):
    out = []
    for f in futs:
        try:
            out.append(_outcome(await f))
        except Exception as e:  # noqa: BLE001 — recorded as the outcome
            out.append(_outcome(e))
    return out


# -- ContinuousBatcher scenarios ----------------------------------------------


def cb_folds_arrivals(B):
    """While flush #1 is held on the 'device', later submissions pile into
    the lane and ride flush #2 together."""
    calls, gate = [], threading.Event()

    def handler(bucket, items):
        calls.append(list(items))
        if len(calls) == 1:
            gate.wait(timeout=10)
        return [i * 10 for i in items]

    async def body():
        cb = B.ContinuousBatcher(handler, max_batch=8)
        first = asyncio.ensure_future(cb.submit("b", 1))
        await asyncio.sleep(0.15)
        rest = [asyncio.ensure_future(cb.submit("b", i)) for i in (2, 3, 4)]
        await asyncio.sleep(0.05)
        gate.set()
        out = await _settle([first, *rest])
        await cb.aclose()
        return dict(calls=calls, out=out, flushes=cb.flushes,
                    occupancy=cb.occupancy_hist)

    return asyncio.run(body())


def cb_idle_dispatches_immediately(B):
    async def body():
        cb = B.ContinuousBatcher(lambda b, items: list(items), max_batch=8)
        t0 = time.monotonic()
        out = await cb.submit("b", "only")
        fast = time.monotonic() - t0 < 1.0
        await cb.aclose()
        return dict(out=out, fast=fast, flushes=cb.flushes)

    return asyncio.run(body())


def cb_bounded_backpressure(B):
    gate = threading.Event()

    def handler(bucket, items):
        gate.wait(timeout=10)
        return list(items)

    async def body():
        cb = B.ContinuousBatcher(handler, max_batch=1, max_queue=2)
        first = asyncio.ensure_future(cb.submit("b", 0))
        await asyncio.sleep(0.1)
        held = [asyncio.ensure_future(cb.submit("b", i)) for i in (1, 2)]
        await asyncio.sleep(0.05)
        over = await _settle([asyncio.ensure_future(cb.submit("b", 3))])
        pending = cb.pending()
        gate.set()
        out = await _settle([first, *held])
        await cb.aclose()
        return dict(over=over, pending=pending, rejected=cb.rejected,
                    out=out)

    return asyncio.run(body())


def cb_handler_error_recovers(B):
    def handler(bucket, items):
        if "boom" in items:
            raise RuntimeError("kaput")
        return list(items)

    async def body():
        cb = B.ContinuousBatcher(handler, max_batch=4)
        out = await _settle([asyncio.ensure_future(cb.submit("b", "boom"))])
        out += await _settle([asyncio.ensure_future(cb.submit("b", "fine"))])
        await cb.aclose()
        return dict(out=out, flushes=cb.flushes)

    return asyncio.run(body())


def cb_fifo_across_lanes(B):
    gate, calls = threading.Event(), []

    def handler(bucket, items):
        calls.append((bucket, list(items)))
        if len(calls) == 1:
            gate.wait(timeout=10)
        return list(items)

    async def body():
        cb = B.ContinuousBatcher(handler, max_batch=8)
        futs = [asyncio.ensure_future(cb.submit("warm", "w0"))]
        await asyncio.sleep(0.15)
        # y's head is OLDER than x's → y flushes first
        futs.append(asyncio.ensure_future(cb.submit("y", "y0")))
        await asyncio.sleep(0.02)
        futs.append(asyncio.ensure_future(cb.submit("x", "x0")))
        gate.set()
        out = await _settle(futs)
        await cb.aclose()
        return dict(calls=calls, out=out)

    return asyncio.run(body())


def cb_rejects_after_close(B):
    async def body():
        cb = B.ContinuousBatcher(lambda b, items: list(items))
        first = await cb.submit("b", 1)
        await cb.aclose()
        late = await _settle([asyncio.ensure_future(cb.submit("b", 2))])
        return dict(first=first, late=late)

    return asyncio.run(body())


def cb_priority_admission(B):
    """Bulk past the soft threshold is shed; an interactive arrival at a
    full queue evicts the newest queued bulk item; interactive lanes flush
    before bulk lanes; an expired deadline is shed at admission."""
    gate, calls = threading.Event(), []

    def handler(bucket, items):
        calls.append((bucket, list(items)))
        if len(calls) == 1:
            gate.wait(timeout=10)
        return list(items)

    async def body():
        cb = B.ContinuousBatcher(handler, max_batch=8, max_queue=4,
                                 bulk_threshold=0.5)
        futs = [asyncio.ensure_future(cb.submit("p", "plug"))]
        await asyncio.sleep(0.1)
        futs += [asyncio.ensure_future(cb.submit("b", f"bulk{i}",
                                                 priority="bulk"))
                 for i in range(3)]  # the third is past bulk_max = 2
        await asyncio.sleep(0.02)
        futs += [asyncio.ensure_future(cb.submit("i", f"int{i}"))
                 for i in range(3)]  # the third fills the queue: evicts
        await asyncio.sleep(0.02)
        futs.append(asyncio.ensure_future(cb.submit(
            "i", "late", deadline=time.monotonic() - 1)))
        await asyncio.sleep(0.02)
        by_priority = cb.pending_by_priority()
        gate.set()
        out = await _settle(futs)
        await cb.aclose()
        return dict(calls=calls, out=out, shed=dict(sorted(cb.shed.items())),
                    by_priority=by_priority, bulk_max=cb.bulk_max)

    return asyncio.run(body())


def cb_deadline_expires_in_queue(B):
    gate, calls = threading.Event(), []

    def handler(bucket, items):
        calls.append(list(items))
        if len(calls) == 1:
            gate.wait(timeout=10)
        return list(items)

    async def body():
        cb = B.ContinuousBatcher(handler, max_batch=8)
        futs = [asyncio.ensure_future(cb.submit("b", "plug"))]
        await asyncio.sleep(0.1)
        futs.append(asyncio.ensure_future(cb.submit(
            "b", "soon", deadline=time.monotonic() + 0.05)))
        futs.append(asyncio.ensure_future(cb.submit("b", "patient")))
        await asyncio.sleep(0.2)
        gate.set()
        out = await _settle(futs)
        await cb.aclose()
        return dict(calls=calls, out=out, shed=dict(cb.shed))

    return asyncio.run(body())


# -- MicroBatcher scenarios ----------------------------------------------------


class _Recorder:
    def __init__(self, fn=lambda b, items: [(b, i) for i in items]):
        self.calls, self.fn, self.lock = [], fn, threading.Lock()

    def __call__(self, bucket, items):
        with self.lock:
            self.calls.append((bucket, list(items)))
        return self.fn(bucket, items)


def _results(futs):
    out = []
    for f in futs:
        try:
            out.append(_outcome(f.result(timeout=5)))
        except Exception as e:  # noqa: BLE001 — recorded as the outcome
            out.append(_outcome(e))
    return out


def mb_size_trigger(B):
    rec = _Recorder()
    mb = B.MicroBatcher(rec, max_batch=3, max_delay_s=60.0)
    out = _results([mb.submit("b64", i) for i in range(3)])
    mb.close()
    return dict(calls=rec.calls, out=out, flushes=mb.flushes)


def mb_deadline_trigger(B):
    rec = _Recorder()
    mb = B.MicroBatcher(rec, max_batch=8, max_delay_s=0.01)
    t0 = time.monotonic()
    out = _results([mb.submit("b64", "lonely")])
    fast = time.monotonic() - t0 < 2.0
    mb.close()
    return dict(calls=rec.calls, out=out, fast=fast)


def mb_lanes_do_not_mix(B):
    rec = _Recorder()
    mb = B.MicroBatcher(rec, max_batch=2, max_delay_s=0.005)
    out = _results([mb.submit(b, i)
                    for i, b in enumerate(("x", "y", "x", "y"))])
    mb.close()
    return dict(calls=sorted(rec.calls), out=out)


def mb_bounded_backpressure(B):
    release = threading.Event()

    def blocking(bucket, items):
        release.wait(timeout=10)
        return list(items)

    mb = B.MicroBatcher(blocking, max_batch=1, max_delay_s=0.0, max_queue=2)
    first = mb.submit("b", 0)
    time.sleep(0.05)
    held = [mb.submit("b", i) for i in (1, 2)]
    try:
        mb.submit("b", 3)
        over = ("ok", None)
    except Exception as e:  # noqa: BLE001 — recorded as the outcome
        over = _outcome(e)
    rejected = mb.rejected
    release.set()
    out = _results([first, *held])
    mb.close()
    return dict(over=over, rejected=rejected, out=out)


def mb_handler_error(B):
    def boom(bucket, items):
        raise RuntimeError("kaput")

    mb = B.MicroBatcher(boom, max_batch=2, max_delay_s=60.0)
    out = _results([mb.submit("b", i) for i in range(2)])
    mb.close()
    return dict(out=out)


def mb_rejects_after_close(B):
    mb = B.MicroBatcher(_Recorder(), max_batch=1, max_delay_s=0.0)
    mb.close()
    try:
        mb.submit("b", 1)
        late = ("ok", None)
    except Exception as e:  # noqa: BLE001 — recorded as the outcome
        late = _outcome(e)
    return dict(late=late)


EXPECTED = {
    cb_folds_arrivals: dict(
        calls=[[1], [2, 3, 4]],
        out=[("ok", 10), ("ok", 20), ("ok", 30), ("ok", 40)],
        flushes=2, occupancy={1: 1, 3: 1}),
    cb_idle_dispatches_immediately: dict(out="only", fast=True, flushes=1),
    cb_bounded_backpressure: dict(
        over=[("QueueFull", "2 requests pending (max_queue=2)")],
        pending=2, rejected=1, out=[("ok", 0), ("ok", 1), ("ok", 2)]),
    cb_handler_error_recovers: dict(
        out=[("RuntimeError", "kaput"), ("ok", "fine")], flushes=2),
    cb_fifo_across_lanes: dict(
        calls=[("warm", ["w0"]), ("y", ["y0"]), ("x", ["x0"])],
        out=[("ok", "w0"), ("ok", "y0"), ("ok", "x0")]),
    cb_rejects_after_close: dict(
        first=1, late=[("RuntimeError", "batcher is closed")]),
    cb_priority_admission: dict(
        calls=[("p", ["plug"]), ("i", ["int0", "int1", "int2"]),
               ("b", ["bulk0"])],
        out=[("ok", "plug"), ("ok", "bulk0"), ("Shed", "bulk_evicted"),
             ("Shed", "bulk_shed"), ("ok", "int0"), ("ok", "int1"),
             ("ok", "int2"), ("Shed", "deadline_expired")],
        shed={"bulk_evicted": 1, "bulk_shed": 1, "deadline_expired": 1},
        by_priority={"interactive": 3, "bulk": 1}, bulk_max=2),
    cb_deadline_expires_in_queue: dict(
        calls=[["plug"], ["patient"]],
        out=[("ok", "plug"), ("Shed", "deadline_expired"),
             ("ok", "patient")],
        shed={"deadline_expired": 1}),
    mb_size_trigger: dict(
        calls=[("b64", [0, 1, 2])],
        out=[("ok", ("b64", 0)), ("ok", ("b64", 1)), ("ok", ("b64", 2))],
        flushes=1),
    mb_deadline_trigger: dict(calls=[("b64", ["lonely"])],
                              out=[("ok", ("b64", "lonely"))], fast=True),
    mb_lanes_do_not_mix: dict(
        calls=[("x", [0, 2]), ("y", [1, 3])],
        out=[("ok", ("x", 0)), ("ok", ("y", 1)), ("ok", ("x", 2)),
             ("ok", ("y", 3))]),
    mb_bounded_backpressure: dict(
        over=("QueueFull", "2 requests pending (max_queue=2)"), rejected=1,
        out=[("ok", 0), ("ok", 1), ("ok", 2)]),
    mb_handler_error: dict(out=[("RuntimeError", "kaput")] * 2),
    mb_rejects_after_close: dict(late=("RuntimeError", "batcher is closed")),
}
SCENARIOS = list(EXPECTED)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__ for s in SCENARIOS])
def test_scenario(scenario, pkg):
    assert scenario(PACKAGES[pkg]) == EXPECTED[scenario]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__ for s in SCENARIOS])
def test_transcripts_agree(scenario):
    assert scenario(port_batcher) == scenario(jax_batcher)


def test_shed_and_queuefull_are_distinct_errors():
    for B in PACKAGES.values():
        e = B.Shed("x", "bulk_shed", retry_after_s=2.0)
        assert (e.reason, e.retry_after_s) == ("bulk_shed", 2.0)
        assert not issubclass(B.Shed, B.QueueFull)
    assert port_batcher.PRIORITIES == jax_batcher.PRIORITIES
