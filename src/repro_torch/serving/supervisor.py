"""Supervision primitives for the async serving loop.

The scheduler (``repro_torch.serving.scheduler``) owns the control flow; this
module owns the *policy* pieces, each independently testable:

* ``Backoff``        — capped exponential retry delays, seeded jitter.
* ``CircuitBreaker`` — sliding-window engine-crash counter; trips after
  ``threshold`` engine-fatal failures inside ``window_s``.  While
  tripped (until the next clean batch) the model reports ``degraded``
  on ``/healthz``.
* ``DegradationLadder`` — the cheapen-before-shed admission policy:
  maps queue-depth / deadline-headroom pressure to a rung that scales a
  request's effective step budget down (never below one step per
  block).  Rung 0 is full quality; the 429 cliff only applies past the
  top rung's capacity.
* ``WatchdogTimeout`` — raised when one block exceeds the per-block
  watchdog; classified engine-fatal (a wedged forward can't be
  distinguished from a wedged engine, and the abandoned executor thread
  can't be preempted — only not resumed).

The supervision state machine, end to end (see DESIGN.md "Failure
model"):

    decode attempt ──ok──────────────────────────▶ done events, breaker reset
        │ transient failure (InjectedFault, CorruptOutputError, ...)
        ▼
    retry with backoff (≤ max_retries) ──ok──▶ done events
        │ still failing
        ▼
    batch size 1?  ──yes──▶ QUARANTINE: terminal `error` event
        │ no
        ▼
    bisect: re-queue both halves in fresh cohorts (they cannot re-merge)

    engine-fatal failure (OOM-shaped, WatchdogTimeout)
        ▼
    breaker.record_fault() ──tripped──▶ rebuild engine via router hot-swap
        ▼
    re-queue the batch's requests (per-request retry cap → `error`)

    sticky CUDA error (illegal address, device-side assert, ...)
        ▼
    the context is lost: terminal `error` for the batch and every later
    one — no retry, no rebuild (neither can succeed in this process)

A copy of the reference's ``serving/supervisor.py``, plus the port's
``"poisoned"`` class of failure.
"""
from __future__ import annotations

import random
import time
from collections import deque
from typing import Deque, List, Optional

from repro_torch.configs.base import DecodeConfig, DegradeConfig
from repro_torch.serving.faults import (backoff_delay, is_context_poisoned,
                                        is_engine_fatal)


class WatchdogTimeout(RuntimeError):
    """One block's decode exceeded the per-block watchdog budget."""


class Backoff:
    """Capped exponential backoff with deterministic, seeded jitter."""

    def __init__(self, base_s: float, cap_s: float, seed: int = 0):
        self.base_s = base_s
        self.cap_s = cap_s
        self._rand = random.Random(seed)

    def delay(self, attempt: int) -> float:
        return backoff_delay(attempt, self.base_s, self.cap_s, self._rand)


class CircuitBreaker:
    """Sliding-window crash counter over engine-fatal failures.

    ``record_fault()`` returns True exactly when the breaker trips
    (``threshold`` faults inside ``window_s``); the caller reacts by
    rebuilding the engine.  ``degraded`` stays True from the trip until
    ``record_success()`` (the first clean batch on the rebuilt engine),
    which is what ``/healthz`` surfaces.
    """

    def __init__(self, threshold: int, window_s: float):
        self.threshold = max(threshold, 1)
        self.window_s = window_s
        self._faults: Deque[float] = deque()
        self.trips = 0
        self.degraded = False

    def record_fault(self, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        self._faults.append(now)
        while self._faults and now - self._faults[0] > self.window_s:
            self._faults.popleft()
        if len(self._faults) >= self.threshold:
            self._faults.clear()
            self.trips += 1
            self.degraded = True
            return True
        return False

    def record_success(self) -> None:
        self.degraded = False

    @property
    def pending_faults(self) -> int:
        return len(self._faults)


class DegradationLadder:
    """Maps admission-time pressure to a degradation rung.

    Pressure inputs: queue depth as a fraction of ``max_queue_depth``
    (the primary signal — every rung names the depth fraction at which
    it engages) and deadline headroom (a request whose deadline is
    shorter than the expected queue wait, ``depth x recent batch EMA``,
    is bumped one extra rung: decoding it cheaper is strictly better
    than letting it expire in the queue).
    """

    def __init__(self, dgcfg: DegradeConfig, max_queue_depth: int):
        self.dgcfg = dgcfg
        self.max_queue_depth = max(max_queue_depth, 1)
        # rungs sorted shallow → deep so rung index == count engaged
        self.rungs = tuple(sorted(dgcfg.rungs, key=lambda r: r.at_depth))

    def rung_for(self, queue_depth: int,
                 deadline_s: Optional[float] = None,
                 batch_ema_s: float = 0.0) -> int:
        """0 = full quality; i > 0 = ``rungs[i-1]`` engaged."""
        if not self.dgcfg.enabled or not self.rungs:
            return 0
        frac = queue_depth / self.max_queue_depth
        rung = sum(1 for r in self.rungs if frac >= r.at_depth)
        if deadline_s and batch_ema_s > 0 and \
                queue_depth * batch_ema_s > deadline_s:
            rung += 1
        return min(rung, len(self.rungs))

    def cheapen_steps(self, rung: int, dcfg: DecodeConfig,
                      steps: Optional[int], gen_length: Optional[int],
                      block_size: Optional[int]) -> Optional[int]:
        """The effective ``steps`` override for this rung (None = leave
        the request's own value).  Scales the requested (or default)
        budget by the rung's ``steps_scale``, floored at one step per
        block so the geometry stays feasible.  Infeasible geometry is
        left untouched — the engine's submission-boundary validation
        owns that error."""
        if rung <= 0:
            return steps
        gen = gen_length if gen_length is not None else dcfg.gen_length
        bs = block_size if block_size is not None else dcfg.block_size
        base = steps if steps is not None else dcfg.steps
        if bs < 1 or gen < 1 or gen % bs or base < 1:
            return steps
        num_blocks = gen // bs
        scaled = max(num_blocks,
                     int(base * self.rungs[rung - 1].steps_scale))
        return min(scaled, base)


def classify_failure(exc: BaseException) -> str:
    """``"poisoned"`` (a sticky CUDA error: the process's context is
    lost), ``"fatal"`` (engine suspect: rebuild territory) or
    ``"transient"`` (batch-local: retry → bisect territory)."""
    if is_context_poisoned(exc):
        return "poisoned"
    if isinstance(exc, WatchdogTimeout) or is_engine_fatal(exc):
        return "fatal"
    return "transient"


def bisect(requests: List) -> List[List]:
    """Split a failing batch's requests for re-queueing.  Both halves
    get fresh cohort ids downstream, so they can never re-form the
    failing batch; repeated failures shrink the poison request's cohort
    until it is alone and quarantined."""
    mid = max(len(requests) // 2, 1)
    halves = [requests[:mid]]
    if requests[mid:]:
        halves.append(requests[mid:])
    return halves
