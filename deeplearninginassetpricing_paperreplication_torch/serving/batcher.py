"""Request batching: the async continuous batcher and the legacy
deadline-triggered micro-batcher (the port's copy of the JAX package's
``serving/batcher.py``; pure asyncio and threads).

:class:`ContinuousBatcher` (the production path) is asyncio-native: per-
bucket lanes, ONE dispatch in flight at a time, and the next flush takes
everything pending the moment the previous dispatch returns — the device
never sits idle waiting for a deadline, and batch occupancy grows with
offered load instead of being capped by a timer. A lone request on an idle
device dispatches immediately (no deadline latency floor); a burst under
load coalesces into one [B, Nb] forward (one CUDA-graph replay). Per-flush
occupancy and queue-depth gauges go to ``events.jsonl`` (``serve/flush``),
and the ``serve/flush`` fault site lets a fault plan kill a server
mid-flight.

:class:`MicroBatcher` is the deadline/size-triggered thread batcher, kept
for the deprecated ``--server threaded`` path: a dedicated dispatcher
thread flushes a lane when it reaches ``max_batch`` items OR its oldest
item has waited ``max_delay_s`` — which leaves the device idle between
flushes under load, the gap the continuous batcher closes.

Both are bounded and loud: when ``max_queue`` items are pending across all
lanes, submission raises :class:`QueueFull` immediately (the server maps it
to HTTP 503) instead of growing an unbounded queue in front of a saturated
accelerator.

Admission is NOT flat FIFO-reject, though (the continuous batcher only):
requests carry a **priority class** (``interactive`` | ``bulk``) and an
optional **deadline**, and under pressure the batcher sheds *expired and
bulk* work first — DAGOR-style (Zhou et al., SoCC 2018): the queue-depth
signal that would have 503'd everyone instead (1) stops admitting bulk past
a soft threshold (:class:`Shed` → HTTP 429 with ``Retry-After``), (2) lets
an interactive request at a FULL queue evict the newest queued bulk item
instead of being rejected, (3) drops queued items whose deadline already
expired at flush-take time (serving them would waste a device slot on an
answer the client stopped waiting for), and (4) flushes interactive lanes
before bulk lanes — interactive preempts, bulk rides the idle capacity.
"""

from __future__ import annotations

import asyncio
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..reliability.faults import inject

# priority classes, highest first: _next_lane flushes strictly in this
# order, and admission sheds from the back of the list first
PRIORITIES = ("interactive", "bulk")
DEFAULT_PRIORITY = "interactive"


class QueueFull(RuntimeError):
    """Raised by submit() when the batcher's bounded queue is at capacity."""


class Shed(RuntimeError):
    """Admission control dropped this request — bulk past the shed
    threshold, a queued bulk item evicted by an arriving interactive one,
    or a deadline that expired in the queue. The server maps it to HTTP
    429 with a ``Retry-After`` header (``retry_after_s``): unlike the 503
    of :class:`QueueFull` this is a *policy* rejection — the service is
    alive and deliberately choosing who waits."""

    def __init__(self, msg: str, reason: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.reason = reason
        self.retry_after_s = retry_after_s


class MicroBatcher:
    """Coalesce submit()ed items into handler(bucket, items) flushes.

    handler: called ON THE DISPATCHER THREAD with (bucket, [item, ...]) and
    must return one result per item, in order; results (or the raised
    exception) are delivered through each item's Future.
    """

    def __init__(
        self,
        handler: Callable[[Any, List[Any]], List[Any]],
        max_batch: int = 4,
        max_delay_s: float = 0.002,
        max_queue: int = 256,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._handler = handler
        self.max_batch = max_batch
        self.max_delay_s = max_delay_s
        self.max_queue = max_queue
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # bucket -> list of (enqueue_monotonic, item, future, meta)
        self._lanes: Dict[Any, List[Tuple[float, Any, Future, Any]]] = {}
        self._pending = 0
        self._closed = False
        self.flushes = 0
        self.rejected = 0
        self.current_flush: Optional[int] = None
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="serving-batcher")
        self._thread.start()

    # -- producer side -------------------------------------------------------

    def submit(self, bucket: Any, item: Any,
               meta: Optional[Dict[str, Any]] = None,
               priority: str = DEFAULT_PRIORITY,
               deadline: Optional[float] = None) -> Future:
        """Enqueue one item into `bucket`'s lane; returns its Future.
        ``meta`` (a caller-owned dict) is filled with the item's batching
        timeline — ``t_enq``/``t_take``/``flush``/``occupancy``/
        ``dispatch_s`` — the request-trace segment evidence.
        ``priority``/``deadline`` are accepted for signature parity with
        :class:`ContinuousBatcher` but IGNORED: the deprecated threaded
        path keeps its flat FIFO admission."""
        fut: Future = Future()
        with self._cond:
            if self._closed:
                raise RuntimeError("batcher is closed")
            if self._pending >= self.max_queue:
                self.rejected += 1
                raise QueueFull(
                    f"{self._pending} requests pending (max_queue="
                    f"{self.max_queue})")
            t_enq = time.monotonic()
            if meta is not None:
                meta["t_enq"] = t_enq
            self._lanes.setdefault(bucket, []).append(
                (t_enq, item, fut, meta))
            self._pending += 1
            self._cond.notify()
        return fut

    def submit_wait(self, bucket: Any, item: Any,
                    timeout: Optional[float] = None,
                    meta: Optional[Dict[str, Any]] = None,
                    priority: str = DEFAULT_PRIORITY,
                    deadline: Optional[float] = None) -> Any:
        """submit() and block for the result (the HTTP handler's shape)."""
        return self.submit(bucket, item, meta=meta, priority=priority,
                           deadline=deadline).result(timeout=timeout)

    # -- dispatcher ----------------------------------------------------------

    def _due_lanes(self, now: float):
        """(ready lanes, seconds until the next deadline or None)."""
        ready, next_deadline = [], None
        for bucket, lane in self._lanes.items():
            if not lane:
                continue
            oldest = lane[0][0]
            if len(lane) >= self.max_batch or now - oldest >= self.max_delay_s:
                ready.append(bucket)
            else:
                deadline = oldest + self.max_delay_s
                if next_deadline is None or deadline < next_deadline:
                    next_deadline = deadline
        return ready, (None if next_deadline is None
                       else max(0.0, next_deadline - now))

    def _run(self):
        while True:
            with self._cond:
                while True:
                    now = time.monotonic()
                    ready, wait = self._due_lanes(now)
                    if ready or (self._closed and self._pending == 0):
                        break
                    self._cond.wait(timeout=wait)
                if self._closed and self._pending == 0 and not ready:
                    return
                flushes = []
                for bucket in ready:
                    lane = self._lanes[bucket]
                    take, rest = lane[:self.max_batch], lane[self.max_batch:]
                    self._lanes[bucket] = rest
                    self._pending -= len(take)
                    flushes.append((bucket, take))
            for bucket, take in flushes:
                self._flush(bucket, take)

    def _flush(self, bucket, take):
        items = [item for _, item, _, _ in take]
        futures = [fut for _, _, fut, _ in take]
        t0 = time.monotonic()
        fid = self.flushes
        for _, _, _, meta in take:
            if meta is not None:
                meta.update(t_take=t0, t_dispatch=t0, flush=fid,
                            occupancy=len(take))
        try:
            self.current_flush = fid
            results = self._handler(bucket, items)
            if len(results) != len(items):
                raise RuntimeError(
                    f"handler returned {len(results)} results for "
                    f"{len(items)} items")
        except BaseException as e:
            for fut in futures:
                fut.set_exception(e)
            return
        finally:
            self.current_flush = None
            self.flushes += 1
            dispatch_s = time.monotonic() - t0
            for _, _, _, meta in take:
                if meta is not None:
                    meta["dispatch_s"] = dispatch_s
        for fut, res in zip(futures, results):
            fut.set_result(res)

    # -- lifecycle -----------------------------------------------------------

    def close(self, timeout: float = 5.0) -> None:
        """Stop accepting work, drain pending items, join the dispatcher."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify()
        self._thread.join(timeout=timeout)

    def pending(self) -> int:
        with self._lock:
            return self._pending


class ContinuousBatcher:
    """Asyncio continuous batcher: flushes fold in-flight arrivals.

    Single-threaded on the event loop (lane state needs no locks); the
    handler runs on a dedicated one-thread executor so the loop keeps
    accepting requests while a flush is on the device. Exactly one flush is
    in flight at a time — the device is the serialization point — and the
    next flush is taken the instant the previous one returns, up to
    ``max_batch`` items from the highest-priority lane whose head has
    waited longest (interactive lanes strictly preempt bulk lanes).

    Admission (module doc): bulk is shed with :class:`Shed` once pending
    reaches ``bulk_threshold × max_queue``; an interactive submit at a
    FULL queue evicts expired then newest-bulk queued items before giving
    up with :class:`QueueFull`; queued items whose ``deadline`` (a
    ``time.monotonic()`` instant) has passed are shed at flush-take time
    instead of dispatched.

    handler: called OFF-LOOP with (bucket, [item, ...]); must return one
    result per item, in order. Construct and use from a running event loop.
    """

    def __init__(
        self,
        handler: Callable[[Any, List[Any]], List[Any]],
        max_batch: int = 16,
        max_queue: int = 256,
        events: Any = None,
        label: Optional[str] = None,
        flight: Any = None,
        bulk_threshold: float = 0.5,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if not 0.0 < bulk_threshold <= 1.0:
            raise ValueError("bulk_threshold must be in (0, 1]")
        self._handler = handler
        self.max_batch = max_batch
        self.max_queue = max_queue
        # the DAGOR-style soft threshold: pending at/above this stops
        # admitting bulk while interactive still has max_queue - this much
        # headroom to absorb a burst
        self.bulk_max = max(1, int(round(max_queue * bulk_threshold)))
        self.events = events
        self.label = label
        self.flight = flight  # FlightRecorder: flush ring (may be None)
        # the id of the flush currently on the device (ONE in flight by
        # design): the engine stamps it onto its serve/dispatch span
        self.current_flush: Optional[int] = None
        # (priority, bucket) -> deque of
        # (enqueue_monotonic, item, asyncio.Future, meta, deadline)
        self._lanes: Dict[Tuple[str, Any], deque] = {}
        self._pending = 0
        self._pending_by: Dict[str, int] = {p: 0 for p in PRIORITIES}
        self._closed = False
        self._wake = asyncio.Event()
        self.flushes = 0
        self.rejected = 0
        # shed accounting by reason: bulk_shed (admission), bulk_evicted
        # (displaced by an arriving interactive), deadline_expired
        self.shed: Dict[str, int] = {}
        self.items_flushed = 0
        self.occupancy_hist: Dict[int, int] = {}
        self._queue_depth_sum = 0
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="serving-dispatch")
        self._task = asyncio.get_running_loop().create_task(self._run())

    # -- producer side (event-loop coroutines) --------------------------------

    async def submit(self, bucket: Any, item: Any,
                     meta: Optional[Dict[str, Any]] = None,
                     priority: str = DEFAULT_PRIORITY,
                     deadline: Optional[float] = None) -> Any:
        """Enqueue one item into the ``(priority, bucket)`` lane and await
        its result. ``meta`` (a caller-owned dict) receives the item's
        batching timeline: ``t_enq`` at enqueue, then ``t_take``/``flush``/
        ``occupancy`` when its flush is taken and ``dispatch_s`` when the
        dispatch returns — the queue_wait/batch_wait/dispatch_share
        segments of the request trace come straight from these.
        ``priority``: ``interactive`` (default) or ``bulk``; ``deadline``:
        an absolute ``time.monotonic()`` instant past which the caller no
        longer wants the answer (expired items are shed, not served)."""
        if priority not in PRIORITIES:
            raise ValueError(f"priority must be one of {PRIORITIES}: "
                             f"{priority!r}")
        # fault site: the admission decision point — a plan can raise/kill
        # exactly when a request is being admitted under pressure
        inject("serve/admit", priority=priority,
               queue_depth=self._pending, path=self.label or "")
        if self._closed:
            raise RuntimeError("batcher is closed")
        now = time.monotonic()
        if deadline is not None and now >= deadline:
            # dead on arrival: never enqueue work nobody is waiting for
            self._shed_count("deadline_expired", priority)
            raise Shed("deadline expired before admission",
                       "deadline_expired", retry_after_s=0.0)
        if priority == "bulk" and self._pending >= self.bulk_max:
            self._shed_count("bulk_shed", priority)
            raise Shed(
                f"{self._pending} requests pending >= bulk admission "
                f"threshold {self.bulk_max} (max_queue={self.max_queue})",
                "bulk_shed", retry_after_s=self._retry_after_s())
        if self._pending >= self.max_queue:
            # interactive at a full queue: make room from expired and
            # bulk work before giving up — DAGOR sheds low priority first
            if not self._evict_for_admission(now):
                self.rejected += 1
                raise QueueFull(
                    f"{self._pending} requests pending (max_queue="
                    f"{self.max_queue})")
        fut = asyncio.get_running_loop().create_future()
        t_enq = time.monotonic()
        if meta is not None:
            meta["t_enq"] = t_enq
            meta["priority"] = priority
        self._lanes.setdefault((priority, bucket), deque()).append(
            (t_enq, item, fut, meta, deadline))
        self._pending += 1
        self._pending_by[priority] += 1
        self._wake.set()
        return await fut

    def pending(self) -> int:
        return self._pending

    def pending_by_priority(self) -> Dict[str, int]:
        return dict(self._pending_by)

    def mean_queue_depth(self) -> Optional[float]:
        """Mean pending count observed at flush time (queueing pressure)."""
        if not self.flushes:
            return None
        return self._queue_depth_sum / self.flushes

    # -- shedding -------------------------------------------------------------

    def _retry_after_s(self) -> float:
        """Retry hint for shed work: roughly one queue-drain time, floored
        at 1 s (the HTTP header carries whole seconds anyway)."""
        return max(1.0, self._pending / max(1.0, 4.0 * self.max_batch))

    def _shed_count(self, reason: str, priority: str) -> None:
        self.shed[reason] = self.shed.get(reason, 0) + 1
        if self.events is not None:
            try:
                self.events.counter(
                    "serve/shed", reason=reason, priority=priority,
                    queue_depth=self._pending, replica=self.label)
            except Exception:
                pass  # telemetry must never fail the admission path

    def _shed_entry(self, entry, reason: str, priority: str) -> None:
        """Fail one queued entry's future with Shed (counts + events)."""
        _, _, fut, _meta, _ = entry
        self._shed_count(reason, priority)
        if not fut.done():
            fut.set_exception(Shed(
                f"shed from queue: {reason}", reason,
                retry_after_s=self._retry_after_s()))

    def _evict_for_admission(self, now: float) -> bool:
        """Make room at a full queue for an INTERACTIVE arrival: shed every
        expired queued item, then the newest queued bulk item. True when a
        slot opened."""
        for (priority, bucket), lane in list(self._lanes.items()):
            kept = deque()
            for entry in lane:
                deadline = entry[4]
                if deadline is not None and now >= deadline:
                    self._shed_entry(entry, "deadline_expired", priority)
                    self._pending -= 1
                    self._pending_by[priority] -= 1
                else:
                    kept.append(entry)
            if len(kept) != len(lane):
                self._lanes[(priority, bucket)] = kept
        if self._pending < self.max_queue:
            return True
        # newest bulk item across lanes: the work least likely to be
        # missed (its sender is told to back off via Retry-After)
        newest_key, newest_t = None, None
        for (priority, bucket), lane in self._lanes.items():
            if priority != "bulk" or not lane:
                continue
            if newest_t is None or lane[-1][0] > newest_t:
                newest_key, newest_t = (priority, bucket), lane[-1][0]
        if newest_key is None:
            return False
        entry = self._lanes[newest_key].pop()
        self._shed_entry(entry, "bulk_evicted", "bulk")
        self._pending -= 1
        self._pending_by["bulk"] -= 1
        return self._pending < self.max_queue

    # -- dispatcher task ------------------------------------------------------

    def _next_lane(self):
        """The non-empty lane whose head has waited longest within the
        highest non-empty priority class — interactive lanes strictly
        preempt bulk lanes; FIFO fairness across buckets within a class."""
        for priority in PRIORITIES:
            best, best_t = None, None
            for key, lane in self._lanes.items():
                if key[0] != priority or not lane:
                    continue
                if best_t is None or lane[0][0] < best_t:
                    best, best_t = key, lane[0][0]
            if best is not None:
                return best
        return None

    async def _run(self):
        loop = asyncio.get_running_loop()
        while True:
            key = self._next_lane()
            if key is None:
                if self._closed:
                    return
                self._wake.clear()
                # re-check after clear: a submit between _next_lane and
                # clear() would otherwise be stranded until the next one
                if self._next_lane() is None and not self._closed:
                    await self._wake.wait()
                continue
            priority, bucket = key
            lane = self._lanes[key]
            depth_at_flush = self._pending
            # take up to max_batch live items; expired-deadline items are
            # shed HERE, not dispatched — a device slot must not be spent
            # on an answer whose client already gave up
            now = time.monotonic()
            take = []
            while lane and len(take) < self.max_batch:
                entry = lane.popleft()
                self._pending -= 1
                self._pending_by[priority] -= 1
                deadline = entry[4]
                if deadline is not None and now >= deadline:
                    self._shed_entry(entry, "deadline_expired", priority)
                    continue
                take.append(entry)
            if not take:
                continue  # the whole head of the lane had expired
            occupancy = len(take)
            fid = self.flushes  # this flush's id: links request rows to it
            self.flushes += 1
            self.items_flushed += occupancy
            self.occupancy_hist[occupancy] = (
                self.occupancy_hist.get(occupancy, 0) + 1)
            self._queue_depth_sum += depth_at_flush
            t_take = time.monotonic()
            for _, _, _, meta, _ in take:
                if meta is not None:
                    meta.update(t_take=t_take, flush=fid,
                                occupancy=occupancy)
            if self.events is not None:
                try:
                    self.events.counter(
                        "serve/flush", occupancy=occupancy,
                        queue_depth=depth_at_flush, bucket=str(bucket),
                        flush=fid, priority=priority, replica=self.label)
                except Exception:
                    # telemetry (disk full, deleted run dir) must never
                    # kill the dispatcher: a dead dispatcher would hang
                    # every future submit() with no watchdog signal
                    pass
            items = [item for _, item, _, _, _ in take]
            try:
                # fault site: a plan can kill or raise mid-flight, with a
                # whole flush of requests in the air (a `raise` lands on
                # this flush's futures as a 5xx; the dispatcher itself
                # survives)
                inject("serve/flush", occupancy=occupancy,
                       path=self.label or "")
                self.current_flush = fid
                t0 = time.monotonic()
                try:
                    results = await loop.run_in_executor(
                        self._executor, self._handler, bucket, items)
                finally:
                    self.current_flush = None
                dispatch_s = time.monotonic() - t0
                for _, _, _, meta, _ in take:
                    if meta is not None:
                        meta.update(t_dispatch=t0, dispatch_s=dispatch_s)
                if self.flight is not None:
                    self.flight.record_flush({
                        "flush": fid, "bucket": str(bucket),
                        "occupancy": occupancy, "priority": priority,
                        "queue_depth": depth_at_flush,
                        "dispatch_s": round(dispatch_s, 6),
                        "ts": round(time.time(), 6)})
                if self.events is not None:
                    try:
                        # the flush's dispatch as a span row: the trace
                        # flow arrows land on this slice (request rows
                        # reference it by flush id)
                        self.events.emit(
                            "span_end", "serve/flush_dispatch",
                            duration_s=round(dispatch_s, 6), flush=fid,
                            occupancy=occupancy, bucket=str(bucket),
                            priority=priority, replica=self.label,
                            status="ok")
                    except Exception:
                        pass  # same contract as the counter above
                if len(results) != len(items):
                    raise RuntimeError(
                        f"handler returned {len(results)} results for "
                        f"{len(items)} items")
            except BaseException as e:
                for _, _, fut, _, _ in take:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            for (_, _, fut, _, _), res in zip(take, results):
                if not fut.done():
                    fut.set_result(res)

    # -- lifecycle ------------------------------------------------------------

    async def aclose(self) -> None:
        """Stop accepting work, drain pending flushes, join the task."""
        if self._closed:
            return
        self._closed = True
        self._wake.set()
        await self._task
        self._executor.shutdown(wait=False)
