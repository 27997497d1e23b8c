"""Request tracing: per-request span records through the serving stack,
exported as Chrome trace-event JSON (``chrome://tracing`` / Perfetto).

The scheduler records a ``Span`` per lifecycle stage of every request —
``queue_wait`` (submit → batch selection), ``batch_assembly``
(selection + padding), one ``decode_block[i]`` per block-grain executor
dispatch, ``cache_refresh`` when the decode's cache policy re-captured
KV state, and ``emit`` (fan-out of the terminal event) — into a
``TraceStore``.  When the decode ran with ``trace=true`` the request's
``DecodeTrace`` (``core/tracebuffer.py``: the on-device step telemetry,
read back once per decode) is attached too, and the export interleaves
per-step counter events — ``commits`` (the FINAL commit histogram, so
the counter sums exactly to ``tokens_generated`` even under wino_r
revocation), ``revocations``, ``skipped``, and the FDM-A phase — across
the decode spans' wall-clock extent.

Export format is the Chrome trace-event JSON object form::

    {"traceEvents": [{"name", "cat", "ph": "X"|"C"|"M",
                      "ts": µs, "dur": µs, "pid", "tid", "args"}, ...],
     "displayTimeUnit": "ms"}

with one process per request (pid = rid) so several requests can be
merged into one viewer timeline.  ``GET /v1/trace/{rid}`` serves it;
``tools/trace_view.py`` renders it in a terminal.

Retention mirrors the scheduler's stream retention: traces of finished
requests are kept for the most recent ``retain`` requests, then dropped
FIFO — the scheduler calls ``retire`` from the same choke point that
retires streams and engine bookkeeping.

A copy of the reference's ``serving/tracing.py``.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional

SCHED_TID = 0        # scheduler-lifecycle spans
DEVICE_TID = 1       # on-device step counters


@dataclasses.dataclass(frozen=True)
class Span:
    """One closed interval of a request's life, ``perf_counter`` based."""

    name: str
    cat: str
    start_s: float
    end_s: float
    args: Optional[Dict] = None

    @property
    def dur_s(self) -> float:
        return max(self.end_s - self.start_s, 0.0)


class SpanTimer:
    """``with store.span(rid, "name", "cat"):`` — record on exit, even
    when the body raises (a failed block dispatch is exactly the span
    you want to see in the trace)."""

    def __init__(self, store: "TraceStore", rids, name: str, cat: str,
                 args: Optional[Dict] = None):
        self.store = store
        self.rids = rids
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        self.start_s = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        span = Span(self.name, self.cat, self.start_s,
                    time.perf_counter(), self.args)
        for rid in self.rids:
            self.store.add(rid, span)
        return False


class TraceStore:
    """Per-rid span lists + attached DecodeTraces, bounded FIFO.

    Thread-safe: spans are recorded from the scheduler's event loop AND
    its decode executor thread, while ``/v1/trace`` reads happen on the
    server loop."""

    def __init__(self, retain: int = 256):
        self.retain = max(retain, 1)
        self._lock = threading.Lock()
        self._spans: Dict[int, List[Span]] = {}
        self._traces: Dict[int, object] = {}     # rid -> DecodeTrace
        self._meta: Dict[int, Dict] = {}
        self._retired: Deque[int] = deque()

    def add(self, rid: int, span: Span) -> None:
        with self._lock:
            self._spans.setdefault(rid, []).append(span)

    def span(self, rids, name: str, cat: str = "serving",
             args: Optional[Dict] = None) -> SpanTimer:
        if isinstance(rids, int):
            rids = (rids,)
        return SpanTimer(self, rids, name, cat, args)

    def attach(self, request_id: int, decode_trace, **meta) -> None:
        """Attach the on-device trace (and wire metadata) on finish.
        ``meta`` keys are free-form (``rid=...`` included — hence the
        positional parameter's longer name)."""
        with self._lock:
            if decode_trace is not None:
                self._traces[request_id] = decode_trace
            self._meta.setdefault(request_id, {}).update(meta)

    def retire(self, rid: int) -> None:
        """The request reached its terminal event; keep its trace for
        the most recent ``retain`` finishers, drop the oldest beyond."""
        with self._lock:
            if rid not in self._spans and rid not in self._traces:
                return
            self._retired.append(rid)
            while len(self._retired) > self.retain:
                old = self._retired.popleft()
                self._spans.pop(old, None)
                self._traces.pop(old, None)
                self._meta.pop(old, None)

    def known(self, rid: int) -> bool:
        with self._lock:
            return rid in self._spans or rid in self._traces

    def chrome(self, rid: int) -> Dict:
        """Chrome trace-event JSON for one request.  ``KeyError`` for an
        unknown (or already-retired) rid."""
        with self._lock:
            if rid not in self._spans and rid not in self._traces:
                raise KeyError(rid)
            spans = list(self._spans.get(rid, ()))
            trace = self._traces.get(rid)
            meta = dict(self._meta.get(rid, ()))
        return chrome_trace(rid, spans, trace, meta)


def _us(t_s: float, t0_s: float) -> float:
    return round((t_s - t0_s) * 1e6, 1)


def chrome_trace(rid: int, spans: List[Span], decode_trace=None,
                 meta: Optional[Dict] = None) -> Dict:
    """Assemble the trace-event JSON (module docstring has the shape).

    Device step counters have no host timestamps (the whole point of the
    on-device TraceBuffer is that steps never sync), so the per-step
    counter events are laid out evenly across the wall-clock extent of
    the ``decode_block`` spans — honest about what is known (step order,
    block membership, per-step counts) without inventing per-step times.
    """
    t0 = min((s.start_s for s in spans), default=0.0)
    events: List[Dict] = [
        {"name": "process_name", "ph": "M", "pid": rid, "tid": SCHED_TID,
         "args": {"name": f"request {rid}"}},
        {"name": "thread_name", "ph": "M", "pid": rid, "tid": SCHED_TID,
         "args": {"name": "scheduler"}},
    ]
    decode_lo, decode_hi = None, None
    for span in sorted(spans, key=lambda s: s.start_s):
        events.append({
            "name": span.name, "cat": span.cat, "ph": "X",
            "ts": _us(span.start_s, t0),
            "dur": round(span.dur_s * 1e6, 1),
            "pid": rid, "tid": SCHED_TID,
            **({"args": span.args} if span.args else {})})
        if span.cat == "decode":
            decode_lo = span.start_s if decode_lo is None \
                else min(decode_lo, span.start_s)
            decode_hi = span.end_s if decode_hi is None \
                else max(decode_hi, span.end_s)

    if decode_trace is not None and decode_trace.steps:
        events.append({"name": "thread_name", "ph": "M", "pid": rid,
                       "tid": DEVICE_TID, "args": {"name": "device steps"}})
        steps = decode_trace.steps
        if decode_lo is None:
            decode_lo, decode_hi = t0, t0 + steps * 1e-6
        pitch = max((decode_hi - decode_lo) / steps, 1e-9)
        histogram = decode_trace.commit_histogram()
        for i in range(steps):
            ts = _us(decode_lo + i * pitch, t0)
            counters = {"commits": int(histogram[i]),
                        "revocations": int(decode_trace.revocations[i]),
                        "skipped": int(decode_trace.skipped[i])}
            events.append({"name": "commits", "cat": "device", "ph": "C",
                           "ts": ts, "pid": rid, "tid": DEVICE_TID,
                           "args": counters})
            args = {"step": i, "block": int(decode_trace.block[i]),
                    "raw_commits": int(decode_trace.commits[i])}
            if int(decode_trace.phase[i]) >= 0:
                args["phase"] = int(decode_trace.phase[i])
            events.append({"name": f"step {i}", "cat": "device",
                           "ph": "X", "ts": ts,
                           "dur": round(pitch * 1e6, 1),
                           "pid": rid, "tid": DEVICE_TID, "args": args})

    out = {"traceEvents": events, "displayTimeUnit": "ms"}
    if meta:
        out["otherData"] = meta
    return out
