"""Small blocking HTTP/SSE client for the serving front end.

Stdlib-only (``http.client``); used by the tests, the load benchmark,
and the examples — and it documents the wire protocol for real clients:

    client = ServingClient(host, port)
    out = client.generate([3, 5, 2], strategy="fdm_a", wait=True)
    for name, event in client.generate_stream([3, 5, 2]):
        ...                      # "block" events, then one terminal event

Retries: connection errors and 429 backpressure are retried up to
``max_retries`` times with capped exponential backoff + seeded jitter —
a 429's ``Retry-After`` header (the server's own schedule) takes
precedence over the computed delay.  ``max_retries=0`` turns the client
back into a single-shot prober (what backpressure tests and the load
benchmark want — they *count* 429s).  A stream that has already yielded
an event is never retried: the server replays events from the start, so
a blind reconnect would hand the caller duplicates.

A copy of the reference's ``serving/client.py``.
"""
from __future__ import annotations

import http.client
import json
import random
import time
import urllib.parse
from typing import Dict, Iterator, Optional, Tuple

from repro_torch.serving.faults import backoff_delay

_RETRYABLE_CONN = (ConnectionError, http.client.HTTPException, OSError)


class ServerError(RuntimeError):
    """Non-2xx response; carries the HTTP status and server message."""

    def __init__(self, status: int, message: str,
                 retry_after: Optional[float] = None):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.message = message
        self.retry_after = retry_after


class ServingClient:
    def __init__(self, host: str, port: int, timeout: float = 120.0, *,
                 max_retries: int = 2, backoff_base_s: float = 0.2,
                 backoff_cap_s: float = 5.0, seed: int = 0):
        self.host = host
        self.port = port
        self.timeout = timeout
        self.max_retries = max_retries
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self._rand = random.Random(seed)

    # -- plumbing ----------------------------------------------------------
    def _sleep_before_retry(self, attempt: int,
                            retry_after: Optional[float]) -> None:
        if retry_after is not None and retry_after >= 0:
            time.sleep(retry_after)
            return
        time.sleep(backoff_delay(attempt, self.backoff_base_s,
                                 self.backoff_cap_s, self._rand))

    def _request(self, method: str, path: str,
                 body: Optional[Dict] = None) -> Dict:
        attempt = 0
        while True:
            try:
                return self._request_once(method, path, body)
            except ServerError as e:
                if e.status != 429 or attempt >= self.max_retries:
                    raise
                attempt += 1
                self._sleep_before_retry(attempt, e.retry_after)
            except _RETRYABLE_CONN:
                if attempt >= self.max_retries:
                    raise
                attempt += 1
                self._sleep_before_retry(attempt, None)

    def _request_once(self, method: str, path: str,
                      body: Optional[Dict] = None) -> Dict:
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)
        try:
            payload = json.dumps(body) if body is not None else None
            conn.request(method, path, body=payload,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
            retry_after = _parse_retry_after(
                resp.getheader("Retry-After"))
        finally:
            conn.close()
        try:
            obj = json.loads(data) if data else {}
        except json.JSONDecodeError:
            obj = {"raw": data.decode(errors="replace")}
        if resp.status >= 400:
            raise ServerError(resp.status,
                              obj.get("error", obj.get("raw", "")),
                              retry_after=retry_after)
        return obj

    # -- API ---------------------------------------------------------------
    def generate(self, prompt, *, model: Optional[str] = None,
                 strategy: Optional[str] = None,
                 steps: Optional[int] = None,
                 gen_length: Optional[int] = None,
                 block_size: Optional[int] = None,
                 cache_policy: Optional[str] = None,
                 deadline_s: Optional[float] = None,
                 trace: Optional[bool] = None,
                 wait: bool = True) -> Dict:
        """Submit a prompt (token-id list, or a string if the server has
        a tokenizer).  ``wait=True`` blocks for the final result;
        ``wait=False`` returns ``{"rid", "model", "stream"}``.
        ``trace=True`` enables on-device step telemetry for this request
        (read it back with :meth:`trace`)."""
        body = {"prompt": list(prompt) if not isinstance(prompt, str)
                else prompt, "wait": wait}
        for key, val in (("model", model), ("strategy", strategy),
                         ("steps", steps), ("gen_length", gen_length),
                         ("block_size", block_size),
                         ("cache_policy", cache_policy),
                         ("deadline_s", deadline_s),
                         ("trace", trace)):
            if val is not None:
                body[key] = val
        return self._request("POST", "/v1/generate", body)

    def stream(self, rid: int, model: Optional[str] = None
               ) -> Iterator[Tuple[str, Dict]]:
        """SSE stream for a request: yields ``(event_name, data)`` pairs,
        ending after the terminal (``final``) event.  Connection errors
        are retried only while NOTHING has been yielded yet (the server
        replays from the start — a reconnect after the first yield would
        duplicate events for the caller)."""
        path = f"/v1/stream/{rid}"
        if model:
            path += "?model=" + urllib.parse.quote(model)
        attempt = 0
        while True:
            started = False
            try:
                for item in self._stream_once(path):
                    started = True
                    yield item
                return
            except _RETRYABLE_CONN:
                if started or attempt >= self.max_retries:
                    raise
                attempt += 1
                self._sleep_before_retry(attempt, None)

    def _stream_once(self, path: str) -> Iterator[Tuple[str, Dict]]:
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            if resp.status >= 400:
                data = resp.read()
                try:
                    msg = json.loads(data).get("error", "")
                except json.JSONDecodeError:
                    msg = data.decode(errors="replace")
                raise ServerError(resp.status, msg)
            name, data_lines = None, []
            while True:
                raw = resp.readline()
                if not raw:
                    return                     # server closed the stream
                line = raw.decode().rstrip("\n").rstrip("\r")
                if line.startswith("event:"):
                    name = line[len("event:"):].strip()
                elif line.startswith("data:"):
                    data_lines.append(line[len("data:"):].strip())
                elif line == "" and data_lines:
                    event = json.loads("\n".join(data_lines))
                    yield (name or event.get("type", "message"), event)
                    if event.get("final"):
                        return
                    name, data_lines = None, []
        finally:
            conn.close()

    def generate_stream(self, prompt, **kwargs
                        ) -> Iterator[Tuple[str, Dict]]:
        """Submit then stream: yields the SSE events of a fresh request."""
        kwargs["wait"] = False
        sub = self.generate(prompt, **kwargs)
        yield from self.stream(sub["rid"], model=sub.get("model"))

    def cancel(self, rid: int, model: Optional[str] = None) -> bool:
        body = {"rid": rid}
        if model:
            body["model"] = model
        return bool(self._request("POST", "/v1/cancel", body)["cancelled"])

    def trace(self, rid: int, model: Optional[str] = None) -> Dict:
        """Chrome trace-event JSON for a finished request (``GET
        /v1/trace/{rid}``).  Feed it to Perfetto / ``chrome://tracing``
        or ``tools/trace_view.py``."""
        path = f"/v1/trace/{rid}"
        if model:
            path += "?model=" + urllib.parse.quote(model)
        return self._request("GET", path)

    def models(self) -> Dict:
        return self._request("GET", "/v1/models")

    def healthz(self) -> Dict:
        return self._request("GET", "/healthz")

    def metrics_text(self) -> str:
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)
        try:
            conn.request("GET", "/metrics")
            resp = conn.getresponse()
            data = resp.read().decode()
        finally:
            conn.close()
        if resp.status >= 400:
            raise ServerError(resp.status, data)
        return data


def _parse_retry_after(value: Optional[str]) -> Optional[float]:
    """Delta-seconds form only (what this server emits); an HTTP-date —
    or garbage — degrades to None, i.e. computed backoff."""
    if value is None:
        return None
    try:
        return max(float(value), 0.0)
    except ValueError:
        return None
