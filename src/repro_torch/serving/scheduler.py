"""Async continuous-batching scheduler: the loop between the HTTP front
end and the batch-synchronous ``ServingEngine``.

One ``AsyncScheduler`` owns one engine (one model's weights) and runs a
single worker task that repeatedly: reaps expired requests, selects the
next batch (``engine.select_batch`` — oldest-bucket-first, per-request
DecodeConfig respected), and drives it ONE BLOCK AT A TIME through
``engine.decode_batch_blocks`` on the device's worker thread
(``serving/worker.py``).  Diffusion decode is batch-synchronous, so the
block boundary is the scheduling grain: between blocks the event loop is
live — it admits new submissions into the queue, answers ``/healthz``,
fans freshly committed blocks out to per-request event streams, and
serves earlier requests' SSE reads — while the device crunches the next
block.  Admission into a *running* batch is impossible by construction
(every row advances through the same denoising steps), which is why
admission control lives at the queue: depth-bounded (``QueueFullError`` →
HTTP 429) and deadline-bounded (queued longer than the deadline → dropped
un-decoded with a terminal ``expired`` event).

Supervision: every batch runs under the ``SupervisorConfig``
policy.  A per-block watchdog bounds each decode resumption; decode
failures are caught at the batch boundary and classified
(``supervisor.classify_failure``): transient ones are retried in place
with capped exponential backoff, persistent ones are bisected — the
batch's halves re-queued under fresh cohort ids until the poison request
is isolated and quarantined with a single terminal ``error`` event, its
co-batched neighbours re-queued and served normally.  Engine-fatal
failures (OOM-shaped, watchdog) feed a sliding-window ``CircuitBreaker``;
on trip the engine is rebuilt through the router's hot-swap path
(``rebuild_engine`` callable, installed by ``ServingServer``) and
``health`` reports ``degraded`` until the next clean batch.  If a failed
attempt had already streamed block events, its streams get a non-final
``reset`` event telling readers to discard them (the retry re-decodes
from scratch, so results stay bit-identical to a fault-free run).

Admission additionally runs the ``DegradationLadder``: under queue-depth
or deadline-headroom pressure a request's effective step budget is
progressively cheapened (fewer steps = more parallel commits per step)
BEFORE the 429 cliff — shed steps before shedding requests.

Event streams: every request gets an ordered in-memory event log —
``block`` events as blocks commit (already sliced per request, replica
rows dropped, offsets rebased to the request's own coordinates), possibly
``reset`` events after a failed attempt, and ONE terminal event
(``done`` / ``cancelled`` / ``expired`` / ``error`` / ``shutdown``,
marked ``"final": true``).  ``events(rid)`` replays the log then follows
it live, so an SSE reader may attach before, during, or after the decode
and still see every event exactly once, in commit order.  Finished logs
are retained for ``stream_retain`` requests, then dropped FIFO.

Graceful drain: ``drain(deadline_s)`` stops admission (submits raise
``SchedulerDrainingError`` → HTTP 503), lets the backlog finish within
the deadline, then stops the worker — the in-flight batch completes its
current block, whatever remains gets a terminal ``shutdown`` event.

Threading contract: all queue mutation (submit / cancel / select /
requeue) happens on the event-loop thread; the card's work — the
block-grain ``next()`` resumptions, a decode generator's close, engine
rebuilds and the profiler — runs on the device's single worker thread,
shared by every engine on the device and by its rebuilds (CUDA's current
stream is per thread, and captured graphs share static buffers, so a
watchdog-abandoned resumption and its retry must queue behind one
another, never overlap).  The engine itself is never touched from two
threads at once (a watchdog-abandoned resumption finishes its current
block in the background and its generator is closed, on the worker,
after it).  Only host data crosses to the event loop: block tokens are
numpy arrays, and a decode's exception arrives with its traceback's
frames (and the CUDA tensors they hold) dropped on the worker.

A sticky CUDA error (an illegal address, a device-side assert) loses the
process's CUDA context: no retry or engine rebuild can succeed, so the
batch's requests, and every later batch's, end in a terminal ``error``
and ``health`` reports ``poisoned``.

A copy of the reference's ``serving/scheduler.py`` but for the worker
thread, the poisoned state and ``torch.profiler``.
"""
from __future__ import annotations

import asyncio
import os
import time
from collections import deque
from typing import AsyncIterator, Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import DegradeConfig, SupervisorConfig
from repro_torch.core.decoder import SampleStats
from repro_torch.serving.engine import Batch, Request, ServingEngine
from repro_torch.serving.metrics import MetricsRegistry
from repro_torch.serving.supervisor import (Backoff, CircuitBreaker,
                                            DegradationLadder,
                                            WatchdogTimeout, bisect,
                                            classify_failure)
from repro_torch.serving.tracing import Span, TraceStore
from repro_torch.serving.worker import device_worker


class QueueFullError(RuntimeError):
    """Admission control: the engine queue is at max depth (HTTP 429)."""


class SchedulerDrainingError(RuntimeError):
    """Admission stopped: the scheduler is draining for shutdown
    (HTTP 503 + Retry-After — retryable against a replacement)."""


def stats_dict(stats: Optional[SampleStats]) -> Dict:
    """A SampleStats as a JSON-serializable dict (wire format) —
    ``SampleStats.as_dict()``, the one stable stats shape shared with
    ``ServingEngine.summary()`` and the benchmarks."""
    if stats is None:
        return {}
    return stats.as_dict()


class _Stream:
    """Ordered event log + wakeup for any number of async readers."""

    def __init__(self):
        self.events: List[Dict] = []
        self.new = asyncio.Event()

    def emit(self, event: Dict) -> None:
        self.events.append(event)
        self.new.set()

    @property
    def finished(self) -> bool:
        return bool(self.events) and self.events[-1].get("final", False)


class _AbandonBatch(Exception):
    """Drain deadline passed mid-batch: stop at this block boundary."""


class AsyncScheduler:
    """See the module docstring.  Construct, then ``await start()``."""

    def __init__(self, engine: ServingEngine, *,
                 max_queue_depth: int = 64,
                 default_deadline_s: float = 0.0,
                 stream_retain: int = 256,
                 svcfg: SupervisorConfig = SupervisorConfig(),
                 dgcfg: DegradeConfig = DegradeConfig(),
                 rebuild_engine: Optional[
                     Callable[[], ServingEngine]] = None,
                 registry: Optional[MetricsRegistry] = None,
                 model: str = "",
                 profile_dir: str = ""):
        self.engine = engine
        self.max_queue_depth = max_queue_depth
        self.default_deadline_s = default_deadline_s
        self.stream_retain = max(stream_retain, 1)
        self.svcfg = svcfg
        self.dgcfg = dgcfg
        self.rebuild_engine = rebuild_engine
        self.model = model
        self.profile_dir = profile_dir
        # request tracing: span records at every lifecycle stage, same
        # retention horizon as the event streams (retired together)
        self.trace_store = TraceStore(retain=self.stream_retain)
        self._install_refresh_hook(engine)
        # metrics registry (optional — standalone schedulers skip it):
        # the scheduler owns the per-request distributions the flat
        # counters cannot express
        self._m_latency = self._m_queue_wait = None
        self._m_tokens = self._m_depth = self._m_decodes = None
        if registry is not None:
            self._m_latency = registry.histogram(
                "repro_request_latency_seconds",
                "End-to-end latency, submit to terminal event",
                ("model",))
            self._m_queue_wait = registry.histogram(
                "repro_queue_wait_seconds",
                "Time a request spent queued before batch selection",
                ("model",))
            self._m_depth = registry.histogram(
                "repro_queue_depth_at_submit",
                "Queue depth observed by each arriving request",
                ("model",), buckets=(0, 1, 2, 4, 8, 16, 32, 64, 128))
            self._m_tokens = registry.histogram(
                "repro_tokens_per_request",
                "Generated tokens per finished request",
                ("model",), buckets=(8, 16, 32, 64, 128, 256, 512, 1024))
            self._m_decodes = registry.counter(
                "repro_decodes_total",
                "Finished decodes by strategy and cache policy",
                ("model", "strategy", "cache_policy"))
        self.breaker = CircuitBreaker(svcfg.breaker_threshold,
                                      svcfg.breaker_window_s)
        self.ladder = DegradationLadder(dgcfg, max_queue_depth)
        self._backoff = Backoff(svcfg.backoff_base_s, svcfg.backoff_cap_s)
        self._streams: Dict[int, _Stream] = {}
        self._retired: Deque[int] = deque()
        self._wake = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._closed = False
        self._draining = False
        self._abandon = False
        self._decoding = False
        self._inflight: set = set()
        self._poisoned: Optional[str] = None   # the sticky CUDA error
        self._batch_ema_s = 0.0
        self.counters = {"submitted": 0, "finished": 0, "rejected": 0,
                         "cancelled": 0, "expired": 0, "errors": 0,
                         "batches": 0, "blocks": 0,
                         # supervision
                         "retries": 0, "requeued": 0, "quarantined": 0,
                         "watchdog_timeouts": 0, "engine_faults": 0,
                         "engine_rebuilds": 0, "rebuild_failures": 0,
                         "resets": 0, "degraded": 0}

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> "AsyncScheduler":
        if self._task is None:
            self._loop = asyncio.get_running_loop()
            self._task = asyncio.create_task(self._run())
        return self

    async def close(self) -> None:
        """Finish the in-flight batch (if any), stop the worker, and end
        every still-open stream with a terminal event — the in-flight
        batch's requests get their REAL ``done`` events (its decode
        completes), only still-queued work gets ``shutdown``."""
        self.shutdown_nowait()
        # claim-then-act: take ownership of the worker handle BEFORE the
        # await so a concurrent close()/drain() sees None instead of
        # double-awaiting and then clobbering a restarted worker (ANA202)
        task, self._task = self._task, None
        if task is not None:
            await task

    async def drain(self, deadline_s: Optional[float] = None) -> None:
        """Graceful shutdown (the SIGTERM path): stop admission NOW,
        give the backlog up to ``deadline_s`` (default
        ``svcfg.drain_deadline_s``) to finish, then stop.  The in-flight
        batch finishes the block it is on; whatever is still unfinished
        at the deadline gets a terminal ``shutdown`` event."""
        if deadline_s is None:
            deadline_s = self.svcfg.drain_deadline_s
        self._draining = True
        loop = asyncio.get_running_loop()
        t_end = loop.time() + max(deadline_s, 0.0)
        while (self.engine.queue_depth or self._decoding) \
                and loop.time() < t_end:
            await asyncio.sleep(0.02)
        self.shutdown_nowait()
        # claim-then-act, same as close(): own the handle before awaiting
        task, self._task = self._task, None
        if task is not None:
            remaining = max(t_end - loop.time(), 0.05)
            try:
                await asyncio.wait_for(asyncio.shield(task), remaining)
            except asyncio.TimeoutError:
                # past the deadline: the worker stops at the next block
                # boundary instead of finishing the batch
                self._abandon = True
                await task

    def shutdown_nowait(self) -> None:
        """Synchronous shutdown request (the router's eviction hook runs
        in sync context — possibly on a worker thread when the server
        builds engines off-loop): the worker exits after the batch it is
        on, and open streams get their terminal event.  Streams of the
        IN-FLIGHT batch are skipped here — its decode completes and they
        get their real ``done`` events (see the shutdown-race regression
        test); anything the worker abandons is swept with ``shutdown``
        when the loop exits.  Thread-safe: the asyncio primitives are
        only touched from the scheduler's own loop."""
        if self._loop is not None:
            try:
                on_loop = asyncio.get_running_loop() is self._loop
            except RuntimeError:
                on_loop = False
            if not on_loop:
                self._loop.call_soon_threadsafe(self.shutdown_nowait)
                return
        if self._closed:
            return
        self._closed = True
        self._wake.set()
        # snapshot: _emit's retention trimming pops retired streams out
        # of _streams mid-iteration.  Routing through _emit (not raw
        # stream.emit) keeps the finished-guard — the single choke point
        # that proves "exactly one terminal event per stream" (ANA205)
        for rid in list(self._streams):
            if rid not in self._inflight:
                self._emit(rid, {"type": "shutdown", "rid": rid,
                                 "status": "shutdown", "final": True})

    @property
    def idle(self) -> bool:
        """No queued work and no batch in flight — safe to evict."""
        return not self._decoding and self.engine.queue_depth == 0

    @property
    def health(self) -> str:
        """``ok`` | ``degraded`` (breaker tripped, engine rebuilt, no
        clean batch yet) | ``poisoned`` (a sticky CUDA error: every batch
        fails) | ``draining`` | ``shutdown``."""
        if self._closed:
            return "shutdown"
        if self._draining:
            return "draining"
        if self._poisoned is not None:
            return "poisoned"
        if self.breaker.degraded:
            return "degraded"
        return "ok"

    # -- client API (event-loop thread only) -------------------------------
    def submit(self, prompt: np.ndarray, *,
               strategy: Optional[str] = None,
               steps: Optional[int] = None,
               gen_length: Optional[int] = None,
               block_size: Optional[int] = None,
               cache_policy: Optional[str] = None,
               trace: Optional[bool] = None,
               deadline_s: Optional[float] = None) -> int:
        """Admit a request; returns its rid.  Raises ``QueueFullError``
        at max queue depth, ``SchedulerDrainingError`` while draining,
        ``KeyError`` on an unknown strategy and ``ValueError`` on
        infeasible geometry or an unknown/unservable ``cache_policy``
        (all from ``engine.submit``'s boundary validation).  Under
        pressure the degradation ladder cheapens the request's effective
        step budget before the queue-full cliff."""
        if self._closed:
            raise RuntimeError("scheduler is shut down")
        if self._draining:
            raise SchedulerDrainingError(
                "scheduler is draining for shutdown; retry elsewhere")
        depth = self.engine.queue_depth
        if depth >= self.max_queue_depth:
            self.counters["rejected"] += 1
            raise QueueFullError(
                f"queue at max depth {self.max_queue_depth}; retry later")
        if not deadline_s:
            # explicit 0 follows the ServerConfig convention (0 = no
            # deadline), same as omitting it; the engine-level API keeps
            # raw semantics (deadline_s=0.0 there = already expired)
            deadline_s = self.default_deadline_s \
                if self.default_deadline_s > 0 else None
        rung = self.ladder.rung_for(depth, deadline_s, self._batch_ema_s)
        if rung:
            cheap = self.ladder.cheapen_steps(rung, self.engine.dcfg,
                                              steps, gen_length,
                                              block_size)
            if cheap != steps:
                steps = cheap
                self.counters["degraded"] += 1
        rid = self.engine.submit(prompt, strategy=strategy, steps=steps,
                                 gen_length=gen_length,
                                 block_size=block_size,
                                 cache_policy=cache_policy,
                                 trace=trace,
                                 deadline_s=deadline_s)
        self._streams[rid] = _Stream()
        self.counters["submitted"] += 1
        if self._m_depth is not None:
            self._m_depth.labels(model=self.model).observe(depth)
        self._wake.set()
        return rid

    def cancel(self, rid: int) -> bool:
        """Cancel a still-queued request (terminal ``cancelled`` event on
        its stream).  False once decoding started or after it finished."""
        ok = self.engine.cancel(rid)
        if ok:
            self.counters["cancelled"] += 1
            self._emit(rid, {"type": "cancelled", "rid": rid,
                             "status": "cancelled", "final": True})
        return ok

    async def events(self, rid: int) -> AsyncIterator[Dict]:
        """Replay-then-follow the request's event stream; the iterator
        ends after the terminal (``"final": true``) event.  Raises
        ``KeyError`` for an unknown (or already-retired) rid."""
        stream = self._streams[rid]
        i = 0
        while True:
            while i >= len(stream.events):
                stream.new.clear()
                await stream.new.wait()
            event = stream.events[i]
            i += 1
            yield event
            if event.get("final"):
                return

    async def result(self, rid: int) -> Dict:
        """Wait for and return the request's terminal event."""
        async for event in self.events(rid):
            if event.get("final"):
                return event
        raise RuntimeError(f"stream {rid} ended without a terminal event")

    def trace(self, rid: int) -> Dict:
        """Chrome trace-event JSON for one request: the scheduler's span
        records (queue wait, batch assembly, per-block decode, cache
        refresh, emit).  ``KeyError`` for a rid never selected into a
        batch or already retired."""
        return self.trace_store.chrome(rid)

    def metrics(self) -> Dict:
        return {"queue_depth": self.engine.queue_depth,
                "decoding": self._decoding,
                "open_streams": len(self._streams),
                "health": self.health,
                "ladder_rung": self.ladder.rung_for(
                    self.engine.queue_depth),
                "breaker_trips": self.breaker.trips,
                **self.counters,
                "faults_injected":
                    dict(self.engine.fault_injector.counters)
                    if self.engine.fault_injector is not None else {},
                "engine": self.engine.summary()}

    # -- internals ---------------------------------------------------------
    def _worker(self):
        """The engine's device's worker thread (rebuilds keep the
        device, so the thread too)."""
        return device_worker(self.engine.device)

    def _install_refresh_hook(self, engine: ServingEngine) -> None:
        """KV-cache refreshes happen inside the decoder between blocks;
        the engine surfaces them through this hook so the trace shows
        refresh time separately from decode time."""
        engine.on_cache_refresh = self._on_cache_refresh

    def _on_cache_refresh(self, requests, blk: int, t0: float,
                          t1: float) -> None:
        span = Span(f"cache_refresh[{blk}]", "decode", t0, t1,
                    {"block": blk})
        for req in requests:
            self.trace_store.add(req.rid, span)

    def _emit(self, rid: int, event: Dict) -> None:
        stream = self._streams.get(rid)
        if stream is None:
            return
        if stream.finished:
            # exactly ONE terminal event per stream: a shutdown that
            # raced an in-flight batch must not be followed by that
            # batch's late `done` (nor double-retire the stream)
            return
        stream.emit(event)
        if event.get("final"):
            self._retired.append(rid)
            # the request's trace retires on the same horizon as its
            # stream — /v1/trace stays answerable as long as /v1/stream
            self.trace_store.retire(rid)
            while len(self._retired) > self.stream_retain:
                old = self._retired.popleft()
                self._streams.pop(old, None)
                # the engine-side Request (result array included) retires
                # with its stream — without this, a long-running server
                # leaks one finished Request per request forever and
                # summary() scans an ever-growing history per scrape
                self.engine.done.pop(old, None)

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        try:
            while not self._closed:
                for req in self.engine.reap_expired():
                    self.counters["expired"] += 1
                    self._emit(req.rid,
                               {"type": "expired", "rid": req.rid,
                                "status": "expired", "final": True})
                # busy BEFORE popping the queue: the router's idle probe
                # may run (from an executor thread) in the instant
                # between select_batch emptying the queue and the decode
                # starting — it must not see that window as evictable
                # idleness
                self._decoding = True
                t_sel = time.perf_counter()
                batch = self.engine.select_batch()
                if batch is None:
                    self._decoding = False
                    self._wake.clear()
                    # re-check before sleeping: a submit may have landed
                    # between select_batch and clear (same thread, so
                    # only if select awaited — it doesn't — but cheap
                    # paranoia)
                    if self.engine.queue_depth == 0 and not self._closed:
                        await self._wake.wait()
                    continue
                if self._poisoned is not None:
                    # the context is lost: no decode can succeed
                    self._decoding = False
                    self._fail_batch(batch, self._poisoned)
                    continue
                self.counters["batches"] += 1
                t_asm = time.perf_counter()
                asm_args = {"batch_size": len(batch.requests),
                            "strategy": batch.dcfg.strategy,
                            "cache_policy": batch.dcfg.cache_policy}
                for req in batch.requests:
                    self.trace_store.add(req.rid, Span(
                        "queue_wait", "serving", req.submit_time, t_sel))
                    self.trace_store.add(req.rid, Span(
                        "batch_assembly", "serving", t_sel, t_asm,
                        asm_args))
                    if self._m_queue_wait is not None:
                        self._m_queue_wait.labels(model=self.model) \
                            .observe(t_sel - req.submit_time)
                t0 = loop.time()
                try:
                    await self._decode_supervised(loop, batch)
                except _AbandonBatch:
                    break           # drain deadline: swept below
                finally:
                    self._decoding = False
                    # in place, NOT `= set()`: shutdown_nowait reads this
                    # set from foreign threads; a rebind would let that
                    # reader hold the stale object across the swap
                    # (ANA201)
                    self._inflight.clear()
                dt = loop.time() - t0
                self._batch_ema_s = dt if not self._batch_ema_s \
                    else 0.8 * self._batch_ema_s + 0.2 * dt
        finally:
            self._decoding = False
            self._inflight.clear()
            # final sweep: whatever never reached a terminal event
            # (abandoned in-flight work, late re-queues) ends with
            # `shutdown` — no stream is left dangling
            for rid, stream in list(self._streams.items()):
                if not stream.finished:
                    self._emit(rid, {"type": "shutdown", "rid": rid,
                                     "status": "shutdown", "final": True})

    async def _decode_supervised(self, loop, batch: Batch) -> None:
        """One batch under the supervision policy (module docstring)."""
        svc = self.svcfg
        attempt = 0
        while True:
            self._inflight.clear()
            self._inflight.update(r.rid for r in batch.requests)
            progress = {"blocks": 0}
            try:
                profiling = await self._start_profiler(loop)
                try:
                    await self._drive_batch(loop, batch, progress)
                finally:
                    await self._stop_profiler(loop, profiling)
                self.breaker.record_success()
                for req in batch.requests:
                    self.counters["finished"] += 1
                    self._record_finished(req, batch)
                    self._emit(req.rid, self._done_event(req))
                return
            except _AbandonBatch:
                raise
            except Exception as e:
                if progress["blocks"]:
                    # blocks already fanned out this attempt are stale —
                    # the retry re-decodes from scratch
                    for req in batch.requests:
                        self.counters["resets"] += 1
                        self._emit(req.rid,
                                   {"type": "reset", "rid": req.rid})
                kind = classify_failure(e)
                if kind == "poisoned":
                    self._poisoned = f"{type(e).__name__}: {e}"
                    self._fail_batch(batch, self._poisoned)
                    return
                if kind == "fatal":
                    await self._engine_fault(loop, batch, e)
                    return
                attempt += 1
                if attempt <= svc.max_retries:
                    self.counters["retries"] += 1
                    await asyncio.sleep(self._backoff.delay(attempt))
                    continue
                if len(batch.requests) == 1:
                    # the poison request, isolated: exactly one terminal
                    # error event; nobody else was in this batch
                    req = batch.requests[0]
                    self.counters["errors"] += 1
                    self.counters["quarantined"] += 1
                    self.engine.record_failed(req)
                    self._emit(req.rid, {
                        "type": "error", "rid": req.rid,
                        "status": "error", "final": True,
                        "error": f"{type(e).__name__}: {e}"})
                    return
                # persistent multi-request failure: bisect.  Fresh
                # cohort ids per half keep the halves from re-merging
                # into the batch that just failed; the poison's cohort
                # keeps shrinking until it is alone
                for half in bisect(batch.requests):
                    self.engine.requeue(half, fresh_group=True)
                    self.counters["requeued"] += len(half)
                self._wake.set()
                return

    def _fail_batch(self, batch: Batch, error: str) -> None:
        """A terminal ``error`` for every request of the batch."""
        for req in batch.requests:
            self.counters["errors"] += 1
            self.engine.record_failed(req)
            self._emit(req.rid, {"type": "error", "rid": req.rid,
                                 "status": "error", "final": True,
                                 "error": error})

    def _record_finished(self, req: Request, batch: Batch) -> None:
        """Per-request observability on decode success: latency/token
        histograms, the per-strategy decode counter, and the request's
        wire metadata attached to its span record."""
        if self._m_decodes is not None:
            self._m_decodes.labels(
                model=self.model, strategy=batch.dcfg.strategy,
                cache_policy=batch.dcfg.cache_policy).inc()
            self._m_latency.labels(model=self.model).observe(req.latency)
            self._m_tokens.labels(model=self.model).observe(
                req.stats.tokens_generated if req.stats else 0)
        trace = req.stats.trace if req.stats is not None else None
        self.trace_store.attach(
            req.rid, trace, rid=req.rid,
            strategy=batch.dcfg.strategy,
            cache_policy=batch.dcfg.cache_policy,
            tokens_generated=int(req.stats.tokens_generated)
            if req.stats else 0)

    async def _start_profiler(self, loop):
        """``ServerConfig.profile_dir`` (non-empty) brackets each decoded
        batch with a ``torch.profiler`` trace of the host and the card,
        started and stopped on the device's worker and written there as a
        Chrome trace — the heavyweight opt-in complement to the
        always-cheap span records.  Returns the profiler, or None."""
        if not self.profile_dir:
            return None
        try:
            return await loop.run_in_executor(
                self._worker(), _profiler_start, self.engine.device)
        except Exception:
            # a profiler session may already be live (concurrent model,
            # external harness): tracing is telemetry, never a reason to
            # fail the decode
            return None

    async def _stop_profiler(self, loop, prof) -> None:
        if prof is None:
            return
        path = os.path.join(self.profile_dir, f"{self.model or 'model'}-"
                            f"batch{self.counters['batches']}.json")
        try:
            await loop.run_in_executor(self._worker(), _profiler_stop,
                                       prof, path)
        except Exception:
            pass

    async def _drive_batch(self, loop, batch: Batch, progress: Dict
                           ) -> None:
        """Drive one decode attempt block by block, under the watchdog;
        fans block events out to the per-request streams."""
        rids = [r.rid for r in batch.requests]
        worker = self._worker()
        blocks = self.engine.decode_batch_blocks(batch)
        try:
            await self._drive_blocks(loop, worker, blocks, batch, rids,
                                     progress)
        finally:
            # a failed, abandoned or timed-out attempt's generator closes
            # on the worker, after whatever resumption still runs there
            closing = loop.run_in_executor(worker, blocks.close)
            closing.add_done_callback(_retrieve)

    async def _drive_blocks(self, loop, worker, blocks, batch: Batch,
                            rids: List[int], progress: Dict) -> None:
        svc = self.svcfg
        while True:
            t_blk = time.perf_counter()
            started = loop.create_future()
            fut = loop.run_in_executor(worker, _drive, blocks, started)
            if svc.watchdog_s > 0:
                # the watchdog times the block, not its wait for the
                # worker (which may still run an abandoned resumption)
                await asyncio.wait((started, fut),
                                   return_when=asyncio.FIRST_COMPLETED)
                try:
                    kind, payload = await asyncio.wait_for(
                        asyncio.shield(fut), svc.watchdog_s)
                except asyncio.TimeoutError:
                    # the resumption keeps running on its executor
                    # thread but is never resumed again; the engine may
                    # be wedged, so this is engine-fatal
                    fut.add_done_callback(_retrieve)
                    self.counters["watchdog_timeouts"] += 1
                    raise WatchdogTimeout(
                        f"block exceeded the {svc.watchdog_s:g}s "
                        f"watchdog") from None
            else:
                kind, payload = await fut
            if kind == "done":
                final = Span("decode_finish", "decode", t_blk,
                             time.perf_counter())
                for rid in rids:
                    self.trace_store.add(rid, final)
                return
            blk, lo, hi, tokens = payload
            span = Span(f"decode_block[{blk}]", "decode", t_blk,
                        time.perf_counter(), {"block": blk})
            for rid in rids:
                self.trace_store.add(rid, span)
            self.counters["blocks"] += 1
            progress["blocks"] += 1
            for i, req in enumerate(batch.requests):
                # rebase to the request's own coordinates (mask pad
                # columns sit left of its prompt)
                self._emit(req.rid, {
                    "type": "block", "rid": req.rid, "block": blk,
                    "lo": lo - req.pad_cols,
                    "hi": hi - req.pad_cols,
                    "tokens": tokens[i].tolist()})
            if self._abandon:
                raise _AbandonBatch()

    async def _engine_fault(self, loop, batch: Batch,
                            exc: Exception) -> None:
        """Engine-fatal failure: count it, maybe trip the breaker and
        rebuild the engine, re-queue the batch's requests (per-request
        retry cap → terminal error)."""
        self.counters["engine_faults"] += 1
        if self.breaker.record_fault() and self.rebuild_engine is not None:
            try:
                rebuilt = await loop.run_in_executor(
                    self._worker(), self.rebuild_engine)
            except Exception:
                self.counters["rebuild_failures"] += 1
                rebuilt = None
            if rebuilt is not None:
                rebuilt.adopt(self.engine)
                self.engine = rebuilt
                # hooks are NOT adopted — re-point the refresh spans at
                # the engine that will actually decode from here on
                self._install_refresh_hook(rebuilt)
                self.counters["engine_rebuilds"] += 1
        survivors = []
        for req in batch.requests:
            req.retries += 1
            if req.retries > self.svcfg.max_retries:
                self.counters["errors"] += 1
                self.engine.record_failed(req)
                self._emit(req.rid, {
                    "type": "error", "rid": req.rid,
                    "status": "error", "final": True,
                    "error": f"{type(exc).__name__}: {exc}"})
            else:
                survivors.append(req)
        if survivors:
            self.engine.requeue(survivors)
            self.counters["requeued"] += len(survivors)
            self._wake.set()

    def _done_event(self, req: Request) -> Dict:
        # the "emit" span covers payload construction (tolist dominates
        # fan-out cost) and lands BEFORE _emit, whose terminal event
        # retires the trace — nothing may attach after retirement
        with self.trace_store.span(req.rid, "emit", "serving"):
            return {"type": "done", "rid": req.rid, "status": "ok",
                    "final": True,
                    "tokens": req.result.tolist(),
                    "latency_s": req.latency,
                    "stats": stats_dict(req.stats)}


def _drive(blocks, started: asyncio.Future):
    """One generator resumption, shaped for run_in_executor (on the
    device's worker); ``started`` is resolved on its loop as it begins.
    A failure leaves with its tracebacks dropped: their frames hold the
    decode's CUDA tensors, which must not cross to (and be freed on) the
    event loop's thread."""
    started.get_loop().call_soon_threadsafe(_resolve, started)
    try:
        return ("block", next(blocks))
    except StopIteration as fin:
        return ("done", fin.value)
    except Exception as exc:
        _drop_tracebacks(exc)
        raise exc.with_traceback(None)


def _resolve(fut: asyncio.Future) -> None:
    if not fut.done():
        fut.set_result(None)


def _drop_tracebacks(exc: BaseException) -> None:
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        exc.__traceback__ = None
        if exc.__cause__ is not None:
            _drop_tracebacks(exc.__cause__)
        exc = exc.__context__


def _profiler_start(device: torch.device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def _profiler_stop(prof, path: str) -> None:
    prof.stop()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    prof.export_chrome_trace(path)


def _retrieve(fut) -> None:
    """Mark an abandoned (watchdog-timed-out) future's eventual
    exception as retrieved so it can't warn at GC time."""
    if not fut.cancelled():
        fut.exception()
