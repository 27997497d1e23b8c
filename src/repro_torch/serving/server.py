"""Stdlib-only async HTTP/1.1 + SSE serving front end.

Hand-rolled on ``asyncio.start_server`` — no http.server, no third-party
web framework, zero new runtime dependencies.  The endpoint surface:

* ``POST /v1/generate`` — submit a request.  JSON body::

      {"prompt": [ids...] | "text",        # text needs a server tokenizer
       "model": "name",                    # default: first registered
       "strategy": "fdm_a", "steps": 32,   # per-request DecodeConfig
       "gen_length": 64, "block_size": 16, # overrides (validated against
       "cache_policy": "prefix",           # the registry / geometry /
                                           # cache-policy axis)
       "deadline_s": 5.0,                  # max QUEUED time
       "wait": false}                      # true = block for the result

  ``wait=false`` (default) answers ``202 {"rid", "model", "stream"}``
  immediately; follow the ``stream`` URL for SSE.  Unknown strategy,
  bad geometry, an unknown/unservable ``cache_policy`` or a prompt token
  outside the vocabulary → 400 at the boundary; queue at max depth →
  429; an option the port does not run (``NotImplementedError``, e.g. an
  architecture not ported yet) → 501.  ``"trace": true`` records the
  decode's on-device step telemetry for ``/v1/trace/{rid}``.

* ``GET /v1/stream/{rid}?model=name`` — Server-Sent Events: one ``block``
  event per committed semi-AR block (the natural streaming grain of
  blockwise diffusion decoding — tokens inside a block finalize
  together), possibly ``reset`` events (supervision retried the batch:
  discard earlier blocks), then exactly one terminal event (``done`` /
  ``cancelled`` / ``expired`` / ``error`` / ``shutdown``).  Events
  replay from the start, so attaching after (or long after) the decode
  still yields the full ordered stream.

* ``POST /v1/cancel`` — ``{"rid", "model"}``; true iff still queued.
* ``GET /v1/models`` — registered models (+ residency) and strategies.
* ``GET /healthz`` — liveness + per-model health (``ok`` / ``degraded``
  after a circuit-breaker engine rebuild / ``draining``) + queue depths.
* ``GET /v1/trace/{rid}?model=name`` — Chrome trace-event JSON for one
  request: the scheduler's lifecycle spans (queue wait, batch assembly,
  per-block decode, cache refresh, emit), and for a ``"trace": true``
  request the device's per-step counters (commits, revocations, skips,
  FDM-A's phase).  Open in Perfetto or render
  with ``tools/trace_view.py``.
* ``GET /metrics`` — Prometheus text exposition (format 0.0.4, with
  HELP/TYPE) from a real ``MetricsRegistry``: the seed-era router/
  scheduler/decode-cache series plus latency, queue-wait, queue-depth
  and tokens-per-request histograms and per-strategy decode counters.

Backpressure answers carry ``Retry-After``: 429 at queue depth, 503
while draining for shutdown.  Bodies are bounded by Content-Length
against ``max_body_bytes`` before buffering; chunked uploads are
rejected (413).

Multi-model: requests route through a ``ModelRouter``; each resident
engine gets its own ``AsyncScheduler`` (created lazily, torn down by the
router's eviction hook so an evicted model's scheduler cannot pin its
engine — and with it the weights — past eviction).  Cold builds and
evictions run on the router's device's worker thread
(``serving/worker.py``), where every decode of the device runs too:
the event loop's thread makes no CUDA call.

A copy of the reference's ``serving/server.py`` but for the worker
thread, the 400 for an out-of-vocabulary prompt and the 501.
"""
from __future__ import annotations

import asyncio
import json
import threading
import urllib.parse
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ServerConfig
from repro_torch.core.decoder import decode_cache_info
from repro_torch.core.strategies import available_strategies
from repro_torch.serving.faults import CorruptOutputError
from repro_torch.serving.metrics import (CONTENT_TYPE, Family,
                                         MetricsRegistry)
from repro_torch.serving.router import ModelRouter
from repro_torch.serving.scheduler import (AsyncScheduler, QueueFullError,
                                           SchedulerDrainingError)
from repro_torch.serving.worker import device_worker

_MAX_HEADER_BYTES = 32 * 1024


class _HttpError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


_STATUS_TEXT = {200: "OK", 202: "Accepted", 400: "Bad Request",
                404: "Not Found", 405: "Method Not Allowed",
                413: "Payload Too Large", 429: "Too Many Requests",
                500: "Internal Server Error", 501: "Not Implemented",
                503: "Service Unavailable"}


class ServingServer:
    """One process-local server over a ``ModelRouter``.

    ``tokenizer`` (optional, e.g. ``repro_torch.data.CharTokenizer``) enables
    string prompts and adds decoded ``text`` fields to responses/events.
    """

    def __init__(self, router: ModelRouter,
                 scfg: ServerConfig = ServerConfig(), *, tokenizer=None):
        self.router = router
        self.scfg = scfg
        self.tokenizer = tokenizer
        self.registry = MetricsRegistry()
        self.registry.register_collector(self._collect_families)
        self._scheds: Dict[str, AsyncScheduler] = {}
        self._build_lock = asyncio.Lock()
        self._server: Optional[asyncio.AbstractServer] = None
        self.host: Optional[str] = None
        self.port: Optional[int] = None
        # tear the scheduler down WITH the engine: a live scheduler holds
        # the engine (hence the params) strongly, which would make router
        # eviction a memory no-op.  A caller-installed hook is chained,
        # not clobbered.
        self._chained_on_evict = router.on_evict
        router.on_evict = self._on_evict
        # models mid-supervised-rebuild: their eviction (inside
        # router.rebuild) must NOT tear down the scheduler driving the
        # rebuild — it adopts the fresh engine and keeps its streams
        self._rebuilding: set = set()

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> Tuple[str, int]:
        self._server = await asyncio.start_server(
            self._handle_conn, self.scfg.host, self.scfg.port)
        sock = self._server.sockets[0]
        self.host, self.port = sock.getsockname()[:2]
        return self.host, self.port

    async def serve_forever(self) -> None:
        assert self._server is not None, "call start() first"
        async with self._server:
            await self._server.serve_forever()

    async def close(self) -> None:
        for sched in list(self._scheds.values()):
            await sched.close()
        self._scheds.clear()
        # claim-then-act: a concurrent close()/drain() must see None
        # rather than wait_closed() on a listener another task already
        # tore down (ANA202)
        server, self._server = self._server, None
        if server is not None:
            server.close()
            await server.wait_closed()

    async def drain(self, deadline_s: Optional[float] = None) -> None:
        """Graceful shutdown (the SIGTERM path): every model stops
        admission immediately (new submits answer 503 + Retry-After),
        in-flight and queued work gets up to the drain deadline to
        finish — terminal ``shutdown`` events for whatever remains —
        then the listener closes.  Streams and /healthz stay servable
        for the duration, so clients see their terminal events instead
        of a reset connection."""
        scheds = list(self._scheds.values())
        if scheds:
            await asyncio.gather(
                *(s.drain(deadline_s) for s in scheds))
        await self.close()

    # -- model plumbing ----------------------------------------------------
    def _on_evict(self, name: str, engine) -> None:
        if name not in self._rebuilding:
            sched = self._scheds.pop(name, None)
            if sched is not None:
                sched.shutdown_nowait()
        if self._chained_on_evict is not None:
            self._chained_on_evict(name, engine)

    def _rebuild_engine(self, name: str):
        """The scheduler's circuit-breaker rebuild callable (runs on the
        device's worker thread).  Hot-swaps the engine through the router —
        real mechanics: force-evict + fresh factory build, compiled
        runners and params of the crashed engine actually free — while
        suppressing the eviction hook's scheduler teardown: the calling
        scheduler survives, adopts the fresh engine, and its streams
        ride through the swap."""
        self._rebuilding.add(name)
        try:
            engine = self.router.rebuild(name)
        finally:
            self._rebuilding.discard(name)
        sched = self._scheds.get(name)
        if sched is not None:
            # eviction dropped the old slot's busy probe with the slot
            self.router.set_busy_probe(name, lambda s=sched: not s.idle)
        return engine

    async def scheduler(self, name: str) -> AsyncScheduler:
        """Resident scheduler for a model (engine built/touched through
        the router, so this call is what drives LRU + eviction).

        Warm path: a resident engine with a live scheduler is returned
        with a cheap LRU touch, no lock, no thread hop.  Cold path: the
        build runs on the device's worker thread under a lock — a cold
        build (checkpoint load + model init) or an eviction
        (``gc.collect``) can take seconds, and freezing the event loop
        for it would stall every other model's streams and /healthz —
        the liveness this layer exists to provide.  Eviction hooks fired from that
        thread re-dispatch onto the loop
        (``AsyncScheduler.shutdown_nowait`` is thread-safe).  A request
        admitted in the narrow window while its scheduler is being
        evicted gets a terminal ``shutdown`` event — visible and
        retryable, never a silent drop."""
        sched = self._scheds.get(name)
        engine = self.router.touch(name)
        if sched is not None and engine is not None and \
                sched.engine is engine:
            return sched
        async with self._build_lock:
            loop = asyncio.get_running_loop()
            engine = await loop.run_in_executor(
                device_worker(self.router.device), self.router.engine,
                name)                             # KeyError on unknown
        sched = self._scheds.get(name)
        if sched is None or sched.engine is not engine:
            if sched is not None:
                await sched.close()
            sched = AsyncScheduler(
                engine,
                max_queue_depth=self.scfg.max_queue_depth,
                default_deadline_s=self.scfg.default_deadline_s,
                stream_retain=self.scfg.stream_retain,
                svcfg=self.scfg.supervisor,
                dgcfg=self.scfg.degrade,
                rebuild_engine=lambda n=name: self._rebuild_engine(n),
                registry=self.registry, model=name,
                profile_dir=self.scfg.profile_dir)
            await sched.start()
            self._scheds[name] = sched
            self.router.set_busy_probe(
                name, lambda s=sched: not s.idle)
        return sched

    # -- connection handling -----------------------------------------------
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                try:
                    request = await self._read_request(reader)
                except _HttpError as e:
                    # parse-stage failures (malformed request line,
                    # oversized headers/body): answer, then drop the
                    # connection — the stream position is unreliable
                    self._respond(writer, e.status, {"error": e.message})
                    await writer.drain()
                    break
                if request is None:
                    break
                method, path, query, body = request
                try:
                    close = await self._route(method, path, query, body,
                                              writer)
                except _HttpError as e:
                    self._respond(writer, e.status, {"error": e.message})
                    close = False
                except (KeyError, ValueError, CorruptOutputError) as e:
                    self._respond(writer, 400, {"error": str(e)})
                    close = False
                except NotImplementedError as e:
                    # an option the port does not run
                    self._respond(writer, 501, {"error": str(e)})
                    close = False
                except QueueFullError as e:
                    self._respond(writer, 429, {"error": str(e)},
                                  headers=self._retry_after())
                    close = False
                except SchedulerDrainingError as e:
                    self._respond(writer, 503, {"error": str(e)},
                                  headers=self._retry_after())
                    close = False
                except (ConnectionError, asyncio.IncompleteReadError):
                    raise
                except Exception as e:
                    # catch-all: a handler bug must answer 500, not drop
                    # the connection with no status line
                    self._respond(writer, 500,
                                  {"error": f"{type(e).__name__}: {e}"})
                    close = False
                await writer.drain()
                if close:
                    break
        except (ConnectionError, asyncio.IncompleteReadError,
                asyncio.LimitOverrunError):
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except ConnectionError:
                pass

    async def _read_request(self, reader: asyncio.StreamReader):
        """Parse one HTTP/1.1 request; None on clean EOF (keep-alive)."""
        try:
            line = await reader.readline()
        except (asyncio.LimitOverrunError, ValueError):
            raise _HttpError(400, "request line too long")
        if not line or line in (b"\r\n", b"\n"):
            return None
        parts = line.decode("latin-1").strip().split()
        if len(parts) != 3:
            raise _HttpError(400, "malformed request line")
        method, target, _version = parts
        headers = {}
        total = 0
        while True:
            try:
                hline = await reader.readline()
            except (asyncio.LimitOverrunError, ValueError):
                # one header line beyond the StreamReader limit would
                # otherwise kill the handler task with no response
                raise _HttpError(400, "header line too long")
            total += len(hline)
            if total > _MAX_HEADER_BYTES:
                raise _HttpError(400, "headers too large")
            if hline in (b"\r\n", b"\n", b""):
                break
            key, _, val = hline.decode("latin-1").partition(":")
            headers[key.strip().lower()] = val.strip()
        if "chunked" in headers.get("transfer-encoding", "").lower():
            # no framing by declared size means no pre-buffer cap;
            # reject before reading a single body byte (the connection
            # drops — the stream position past the headers is unknowable
            # without decoding the chunks we just refused to read)
            raise _HttpError(413, "chunked bodies are not accepted; "
                                  "send Content-Length")
        try:
            length = int(headers.get("content-length", "0") or "0")
        except ValueError:
            raise _HttpError(400, "bad Content-Length")
        if length < 0:
            raise _HttpError(400, "bad Content-Length")
        if length > self.scfg.max_body_bytes:
            # EVERY route shares this cap, and it fires before any body
            # byte is buffered — an oversized POST costs the server its
            # header read, nothing more
            raise _HttpError(413, "request body too large")
        body = await reader.readexactly(length) if length else b""
        url = urllib.parse.urlsplit(target)
        query = dict(urllib.parse.parse_qsl(url.query))
        return method.upper(), url.path, query, body

    # -- routing -----------------------------------------------------------
    async def _route(self, method: str, path: str, query: Dict[str, str],
                     body: bytes, writer: asyncio.StreamWriter) -> bool:
        """Dispatch one request; returns True when the connection must
        close afterwards (SSE streams are close-delimited)."""
        if method == "POST" and path == "/v1/generate":
            await self._generate(body, writer)
        elif method == "GET" and path.startswith("/v1/stream/"):
            return await self._stream(path, query, writer)
        elif method == "GET" and path.startswith("/v1/trace/"):
            self._trace(path, query, writer)
        elif method == "POST" and path == "/v1/cancel":
            await self._cancel(body, writer)
        elif method == "GET" and path == "/v1/models":
            self._respond(writer, 200, {
                "models": self.router.info()["models"],
                "strategies": list(available_strategies())})
        elif method == "GET" and path == "/healthz":
            # snapshot: evictions may pop entries from an executor thread
            scheds = list(self._scheds.items())
            health = {n: s.health for n, s in scheds}
            status = "ok"
            for state in health.values():
                if state != "ok":
                    status = state
                    break
            # "ok" stays a liveness bool (the process answers); per-model
            # readiness lives in "status"/"health" — degraded = breaker
            # tripped and no clean batch yet, draining = SIGTERM received
            self._respond(writer, 200, {
                "ok": True,
                "status": status,
                "models": self.router.names(),
                "health": health,
                "queue_depth": {n: s.engine.queue_depth
                                for n, s in scheds}})
        elif method == "GET" and path == "/metrics":
            self._respond_raw(writer, 200, self.registry.render(),
                              CONTENT_TYPE)
        else:
            raise _HttpError(404, f"no route for {method} {path}")
        return False

    # -- endpoints ---------------------------------------------------------
    def _resolve_model(self, model: Optional[str]) -> str:
        """rids are per-model counters, so /v1/stream and /v1/cancel may
        only default the model when there is no ambiguity — defaulting
        across several models would read (or cancel!) some OTHER user's
        same-numbered request."""
        if model:
            return model
        names = self.router.names()
        if len(names) == 1:
            return names[0]
        raise _HttpError(400, "several models are registered; pass "
                              "'model' (rids are per-model)")

    def _parse_json(self, body: bytes) -> Dict:
        if not body:
            raise _HttpError(400, "empty body; send JSON")
        try:
            obj = json.loads(body)
        except json.JSONDecodeError as e:
            raise _HttpError(400, f"invalid JSON: {e}")
        if not isinstance(obj, dict):
            raise _HttpError(400, "JSON body must be an object")
        return obj

    def _prompt_ids(self, req: Dict) -> np.ndarray:
        prompt = req.get("prompt")
        if isinstance(prompt, str):
            if self.tokenizer is None:
                raise _HttpError(
                    400, "string prompts need a server-side tokenizer; "
                         "send token ids")
            prompt = self.tokenizer.encode(prompt)
        if not isinstance(prompt, list) or not prompt or \
                not all(isinstance(t, int) and not isinstance(t, bool)
                        for t in prompt):
            raise _HttpError(400, "prompt must be a non-empty list of "
                                  "token ids (or a string)")
        return np.asarray(prompt, np.int32)

    async def _generate(self, body: bytes,
                        writer: asyncio.StreamWriter) -> None:
        req = self._parse_json(body)
        prompt = self._prompt_ids(req)
        for key, types in (("strategy", str), ("steps", int),
                           ("gen_length", int), ("block_size", int),
                           ("cache_policy", str),
                           ("deadline_s", (int, float)),
                           ("model", str)):
            val = req.get(key)
            if val is not None and (not isinstance(val, types)
                                    or isinstance(val, bool)):
                raise _HttpError(400, f"{key} has the wrong type")
        trace = req.get("trace")
        if trace is not None and not isinstance(trace, bool):
            raise _HttpError(400, "trace must be a boolean")
        model = req.get("model") or self.router.default
        gen_length = req.get("gen_length")
        if gen_length is not None and \
                gen_length > self.scfg.max_gen_length:
            raise _HttpError(400, f"gen_length {gen_length} exceeds the "
                                  f"server cap {self.scfg.max_gen_length}")
        steps = req.get("steps")
        if steps is not None and steps > self.scfg.max_steps:
            raise _HttpError(400, f"steps {steps} exceeds the server "
                                  f"cap {self.scfg.max_steps}")
        sched = await self.scheduler(model)
        rid = sched.submit(prompt,
                           strategy=req.get("strategy"),
                           steps=req.get("steps"),
                           gen_length=gen_length,
                           block_size=req.get("block_size"),
                           cache_policy=req.get("cache_policy"),
                           trace=trace,
                           deadline_s=req.get("deadline_s"))
        if req.get("wait"):
            event = await sched.result(rid)
            self._respond(writer, 200, {"rid": rid, "model": model,
                                        **self._with_text(event)})
            return
        self._respond(writer, 202, {
            "rid": rid, "model": model,
            "stream": f"/v1/stream/{rid}?model="
                      f"{urllib.parse.quote(model)}"})

    async def _stream(self, path: str, query: Dict[str, str],
                      writer: asyncio.StreamWriter) -> bool:
        tail = path[len("/v1/stream/"):]
        if not tail.isdigit():
            raise _HttpError(404, f"bad stream id {tail!r}")
        rid = int(tail)
        model = self._resolve_model(query.get("model"))
        sched = self._scheds.get(model)
        if sched is None:
            raise _HttpError(404, f"model {model!r} has no live "
                                  f"scheduler (evicted or never used)")
        try:
            events = sched.events(rid)
            first = await anext(events)
        except KeyError:
            raise _HttpError(404, f"unknown request id {rid}")
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: text/event-stream\r\n"
                     b"Cache-Control: no-store\r\n"
                     b"Connection: close\r\n\r\n")
        await writer.drain()
        await self._write_sse(writer, first)
        async for event in events:
            await self._write_sse(writer, event)
        return True          # close-delimited

    async def _write_sse(self, writer: asyncio.StreamWriter,
                         event: Dict) -> None:
        payload = json.dumps(self._with_text(event))
        writer.write(f"event: {event['type']}\n"
                     f"data: {payload}\n\n".encode())
        await writer.drain()

    def _with_text(self, event: Dict) -> Dict:
        if self.tokenizer is not None and "tokens" in event:
            return {**event, "text": self.tokenizer.decode(
                np.asarray(event["tokens"]))}
        return event

    def _trace(self, path: str, query: Dict[str, str],
               writer: asyncio.StreamWriter) -> None:
        """``GET /v1/trace/{rid}?model=name`` — Chrome trace-event JSON
        for one finished (or in-flight) request: the scheduler's
        lifecycle spans.  Load the body in Perfetto /
        ``chrome://tracing``, or render it with tools/trace_view.py."""
        tail = path[len("/v1/trace/"):]
        if not tail.isdigit():
            raise _HttpError(404, f"bad trace id {tail!r}")
        rid = int(tail)
        model = self._resolve_model(query.get("model"))
        sched = self._scheds.get(model)
        if sched is None:
            raise _HttpError(404, f"model {model!r} has no live "
                                  f"scheduler (evicted or never used)")
        try:
            trace = sched.trace(rid)
        except KeyError:
            raise _HttpError(404, f"no trace for request id {rid} "
                                  f"(never decoded, or retired)")
        self._respond(writer, 200, trace)

    async def _cancel(self, body: bytes,
                      writer: asyncio.StreamWriter) -> None:
        req = self._parse_json(body)
        model = self._resolve_model(req.get("model"))
        rid = req.get("rid")
        if not isinstance(rid, int):
            raise _HttpError(400, "rid must be an integer")
        sched = self._scheds.get(model)
        cancelled = bool(sched and sched.cancel(rid))
        self._respond(writer, 200, {"rid": rid, "cancelled": cancelled})

    # -- metrics -----------------------------------------------------------
    def _collect_families(self) -> List[Family]:
        """Scrape-time collector: snapshot router / scheduler / decode-
        cache state into exposition families.  The series names and the
        model-first label order are the seed's — dashboards and tests
        pin them — only the HELP/TYPE metadata and escaping moved into
        ``serving.metrics``."""
        fams: List[Family] = [
            Family("repro_up", "gauge", "Server process is serving.",
                   [({}, 1)]),
        ]

        def fam(series: str, mtype: str, help: str, samples) -> None:
            fams.append(Family(f"repro_{series}", mtype, help,
                               list(samples)))

        info = self.router.info()
        for series, key, mtype, help in (
                ("router_resident_bytes", "resident_bytes", "gauge",
                 "Bytes of resident params."),
                ("router_budget_bytes", "budget_bytes", "gauge",
                 "Router residency budget."),
                ("router_evictions_total", "evictions", "counter",
                 "Models evicted for space."),
                ("router_builds_total", "builds", "counter",
                 "Model builds (cold loads)."),
                ("router_swaps_total", "swaps", "counter",
                 "Resident-model swaps."),
                ("router_rebuilds_total", "rebuilds", "counter",
                 "Faulted-model rebuilds.")):
            fam(series, mtype, help, [({}, info[key])])

        # snapshot: evictions may pop entries from an executor thread
        scheds = list(self._scheds.items())
        per_model: Dict[str, List] = {}

        def add(series: str, mtype: str, help: str, labels, value):
            per_model.setdefault(series, [mtype, help, []])[2].append(
                (labels, value))

        for name, sched in scheds:
            m = sched.metrics()
            labels = {"model": name}
            add("queue_depth", "gauge",
                "Requests waiting for batch assembly.", labels,
                m["queue_depth"])
            add("decoding", "gauge", "A decode batch is in flight.",
                labels, int(m["decoding"]))
            add("health_degraded", "gauge",
                "Scheduler is on a degradation rung.", labels,
                int(m["health"] == "degraded"))
            add("ladder_rung", "gauge",
                "Current degradation-ladder rung.", labels,
                m["ladder_rung"])
            add("breaker_trips_total", "counter",
                "Circuit-breaker trips.", labels, m["breaker_trips"])
            for counter in ("submitted", "finished", "rejected",
                            "cancelled", "expired", "errors", "batches",
                            "blocks", "retries", "requeued",
                            "quarantined", "watchdog_timeouts",
                            "engine_faults", "engine_rebuilds",
                            "rebuild_failures", "resets", "degraded"):
                add(f"requests_{counter}_total", "counter",
                    f"Lifecycle counter: {counter}.", labels, m[counter])
            for kind, fired in m["faults_injected"].items():
                add("faults_injected_total", "counter",
                    "Injected faults that fired.",
                    {"model": name, "kind": kind}, fired)
            summary = m["engine"]
            if summary:
                add("latency_seconds", "gauge",
                    "Request latency summary stats.",
                    {"model": name, "stat": "mean"},
                    summary["mean_latency_s"])
                add("latency_seconds", "gauge",
                    "Request latency summary stats.",
                    {"model": name, "stat": "p95"},
                    summary["p95_latency_s"])
                add("decode_tps", "gauge",
                    "Committed tokens per decode-second.", labels,
                    summary["decode_tps"])
                add("throughput_tps", "gauge",
                    "Committed tokens per wall-second.", labels,
                    summary["throughput_tps"])
        for series, (mtype, help, samples) in per_model.items():
            fam(series, mtype, help, samples)

        cache = decode_cache_info()
        for fld in ("entries", "runners", "hits", "misses", "captures"):
            fam(f"decode_cache_{fld}", "gauge",
                f"Decode runner cache: {fld}.",
                [({}, getattr(cache, fld))])
        return fams

    # -- response helpers --------------------------------------------------
    def _retry_after(self) -> Dict[str, str]:
        """429/503 both carry Retry-After (integer seconds per RFC
        9110): backpressure is a *schedule*, not just a refusal — the
        blocking client honors it."""
        return {"Retry-After": str(max(1, round(self.scfg.retry_after_s)))}

    def _respond(self, writer: asyncio.StreamWriter, status: int,
                 obj: Dict, headers: Optional[Dict[str, str]] = None
                 ) -> None:
        self._respond_raw(writer, status, json.dumps(obj),
                          "application/json", headers)

    def _respond_raw(self, writer: asyncio.StreamWriter, status: int,
                     text: str, ctype: str,
                     headers: Optional[Dict[str, str]] = None) -> None:
        data = text.encode()
        extra = "".join(f"{k}: {v}\r\n"
                        for k, v in (headers or {}).items())
        head = (f"HTTP/1.1 {status} {_STATUS_TEXT.get(status, '?')}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(data)}\r\n{extra}"
                f"Connection: keep-alive\r\n\r\n")
        writer.write(head.encode() + data)


class ServerThread:
    """Run a ``ServingServer`` on a dedicated thread with its own event
    loop — the in-process harness used by tests, ``chip_smoke.py``, and
    notebook/demo callers.  Blocking clients
    (``repro_torch.serving.client``) talk to it over real sockets.

        handle = ServerThread(router, scfg).start()
        ... ServingClient(handle.host, handle.port) ...
        handle.stop()
    """

    def __init__(self, router: ModelRouter,
                 scfg: ServerConfig = ServerConfig(), *, tokenizer=None):
        self.server = ServingServer(router, scfg, tokenizer=tokenizer)
        self.host: Optional[str] = None
        self.port: Optional[int] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._stop: Optional[asyncio.Future] = None
        self._started = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._main, daemon=True,
                                        name="repro-serving")

    def _main(self) -> None:
        try:
            asyncio.run(self._amain())
        except BaseException as e:           # surface startup failures
            self._error = e
            self._started.set()

    async def _amain(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._stop = self._loop.create_future()
        try:
            self.host, self.port = await self.server.start()
        finally:
            self._started.set()
        await self._stop
        await self.server.close()

    def start(self, timeout: float = 30.0) -> "ServerThread":
        self._thread.start()
        if not self._started.wait(timeout):
            raise TimeoutError("server thread failed to start")
        if self._error is not None:
            raise self._error
        return self

    def stop(self, timeout: float = 30.0) -> None:
        if self._loop is not None and self._stop is not None and \
                not self._stop.done():
            self._loop.call_soon_threadsafe(self._stop.set_result, None)
        self._thread.join(timeout)

    def call(self, coro_fn, *args, timeout: float = 30.0):
        """Run ``await coro_fn(*args)`` on the server loop from the
        calling (non-loop) thread; returns its result.  How tests reach
        scheduler/router internals that must run on the loop thread."""
        assert self._loop is not None
        fut = asyncio.run_coroutine_threadsafe(coro_fn(*args), self._loop)
        return fut.result(timeout)
