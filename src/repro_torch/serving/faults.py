"""Deterministic fault injection at the engine / decode boundary.

Every recovery path in the serving stack — retry, bisection quarantine,
watchdog, circuit breaker, engine rebuild, the degradation ladder — is
only trustworthy if it can be *driven* in tier-1 tests, which means the
failures themselves must be schedulable and reproducible.  A
``FaultInjector`` holds a list of ``Fault`` specs and fires them at the
block grain of ``ServingEngine.decode_batch_blocks`` (the supervision
grain: the graph drivers replay each block's steps as captured CUDA
graphs, so the block boundary is the first host point where a failure
can be injected — and caught — without leaving the captured path).

Fault kinds:

* ``"error"``   — raise ``InjectedFault`` before the matching block (a
  generic transient decode failure: the retry / bisection path).
* ``"nan"``     — corrupt the committed block's tokens the way NaN/inf
  logits would (an argmax over a non-finite canvas yields garbage): the
  engine's always-on output validator catches the corruption and raises
  ``CorruptOutputError``.  This exercises the *detector*, not just the
  handler.
* ``"latency"`` — sleep ``delay_s`` before the matching block (an
  artificially slow forward: the watchdog path).
* ``"oom"``     — raise ``SimulatedOOM`` (shaped like the reference's
  RESOURCE_EXHAUSTED: the engine-fatal / circuit-breaker path).

Matching is composable: ``batch_index`` counts decode *attempts* as the
injector sees them (a retried batch is a new attempt), ``rid`` makes a
fault follow one poison request into every batch that contains it
(exactly what bisection quarantine needs), ``block`` picks the block
within a matching batch, and ``times`` bounds total firings.  A seeded
``chaos_rate`` adds random background faults for soak runs — same seed,
same schedule.

The injector is attached to a ``ServingEngine`` (constructor argument or
``set_fault_injector``) and only ever mutated from the decode thread, so
its counters need no locking.

A copy of the reference's ``serving/faults.py``.  The port's own
additions: ``is_engine_fatal`` also recognises the card's out-of-memory
error by its type (``torch.OutOfMemoryError``, whose message reads
``CUDA out of memory``), and ``is_context_poisoned`` recognises the
sticky CUDA errors after which no call in the process can succeed.
"""
from __future__ import annotations

import dataclasses
import math
import random
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


class InjectedFault(RuntimeError):
    """A scheduled decode failure (transient unless stated otherwise)."""


class SimulatedOOM(InjectedFault):
    """An injected engine-fatal failure, shaped like the accelerator
    runtime's out-of-memory error (supervision classifies on the
    RESOURCE_EXHAUSTED marker, same as for the real thing)."""

    def __init__(self, msg: str = "injected oom"):
        super().__init__(f"RESOURCE_EXHAUSTED: {msg}")


class CorruptOutputError(RuntimeError):
    """The engine's output validator found committed tokens outside the
    vocabulary — the downstream signature of NaN/inf logits."""


def validate_block_tokens(tokens: np.ndarray, vocab_size: int) -> None:
    """The always-on corruption detector: every committed token must be
    a valid vocabulary id.  NaN/inf logits don't raise inside the
    compiled decode — they commit garbage — so the engine checks each
    block's host-side slice before fanning it out to streams."""
    if tokens.size and ((tokens < 0) | (tokens >= vocab_size)).any():
        bad = tokens[(tokens < 0) | (tokens >= vocab_size)]
        raise CorruptOutputError(
            f"committed block contains {bad.size} out-of-vocab token(s) "
            f"(e.g. {int(bad.flat[0])}); non-finite logits upstream?")


@dataclasses.dataclass
class Fault:
    """One scheduled fault.  Fields compose as AND-filters; ``None``
    matches anything."""
    kind: str                          # error | nan | latency | oom
    batch_index: Optional[int] = None  # Nth decode attempt the injector sees
    rid: Optional[int] = None          # fires when this rid is in the batch
    block: Optional[int] = 0           # block within the matching batch
                                       # (None = every block)
    times: Optional[int] = 1           # total firings (None = unlimited)
    delay_s: float = 0.5               # latency kind: injected stall
    message: str = "injected fault"

    def __post_init__(self):
        if self.kind not in ("error", "nan", "latency", "oom"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        self.fired = 0

    def matches(self, batch_index: int, rids: Sequence[int],
                block: int) -> bool:
        if self.times is not None and self.fired >= self.times:
            return False
        if self.batch_index is not None and batch_index != self.batch_index:
            return False
        if self.rid is not None and self.rid not in rids:
            return False
        if self.block is not None and block != self.block:
            return False
        return True


class FaultInjector:
    """Schedules ``Fault``s into an engine's block-grain decode.

    ``chaos_rate`` > 0 additionally fires a random fault (drawn from
    ``chaos_kinds`` with ``random.Random(seed)``) before each block with
    that probability — the nightly soak's background noise.  Scheduled
    faults and chaos compose; determinism holds per (faults, seed,
    traffic order).
    """

    def __init__(self, faults: Sequence[Fault] = (), *,
                 chaos_rate: float = 0.0,
                 chaos_kinds: Sequence[str] = ("error", "nan", "latency"),
                 chaos_delay_s: float = 0.05,
                 seed: int = 0):
        self.faults: List[Fault] = list(faults)
        self.chaos_rate = chaos_rate
        self.chaos_kinds = tuple(chaos_kinds)
        self.chaos_delay_s = chaos_delay_s
        self._rand = random.Random(seed)
        self.batches_seen = 0          # decode attempts (retries included)
        self.counters: Dict[str, int] = {
            k: 0 for k in ("error", "nan", "latency", "oom")}

    # -- engine hooks (decode thread only) ---------------------------------
    def begin_batch(self) -> int:
        """Called once per decode attempt; returns this attempt's index."""
        bi = self.batches_seen
        self.batches_seen += 1
        return bi

    def before_block(self, batch_index: int, rids: Sequence[int],
                     block: int) -> None:
        """Fires error/oom/latency faults scheduled for this block.
        Raises or sleeps; ``nan`` faults fire in ``filter_tokens``."""
        for fault in self._firing(batch_index, rids, block,
                                  ("error", "oom", "latency")):
            if fault.kind == "latency":
                time.sleep(fault.delay_s)
            elif fault.kind == "oom":
                raise SimulatedOOM(fault.message)
            else:
                raise InjectedFault(
                    f"{fault.message} (batch {batch_index}, block {block})")

    def filter_tokens(self, batch_index: int, rids: Sequence[int],
                      block: int, tokens: np.ndarray) -> np.ndarray:
        """Applies ``nan`` faults: returns the block's tokens as a NaN
        forward would have committed them (out-of-vocab garbage the
        engine validator is expected to catch)."""
        for _fault in self._firing(batch_index, rids, block, ("nan",)):
            tokens = np.full_like(tokens, -1)
        return tokens

    def _firing(self, batch_index: int, rids: Sequence[int], block: int,
                kinds: Sequence[str]):
        fired = []
        for fault in self.faults:
            if fault.kind in kinds and \
                    fault.matches(batch_index, rids, block):
                fault.fired += 1
                self.counters[fault.kind] += 1
                fired.append(fault)
        chaos = self._chaos(kinds)
        if chaos is not None:
            fired.append(chaos)
        return fired

    def _chaos(self, kinds: Sequence[str]) -> Optional[Fault]:
        # one RNG draw per (block, kind-class) call keeps the schedule a
        # pure function of traffic order; "nan" is probed in its own
        # filter_tokens call so error-class and corrupt-class chaos stay
        # independent draws
        if not self.chaos_rate or not any(k in self.chaos_kinds
                                          for k in kinds):
            return None
        if self._rand.random() >= self.chaos_rate:
            return None
        pool = [k for k in self.chaos_kinds if k in kinds]
        if not pool:
            return None
        kind = self._rand.choice(pool)
        self.counters[kind] += 1
        return Fault(kind=kind, delay_s=self.chaos_delay_s,
                     message="chaos fault", times=None)

    # -- introspection -----------------------------------------------------
    @property
    def total_fired(self) -> int:
        return sum(self.counters.values())

    def summary(self) -> Dict[str, int]:
        return {"batches_seen": self.batches_seen, **self.counters}


def is_engine_fatal(exc: BaseException) -> bool:
    """Failure classification for supervision: does this exception mean
    the ENGINE (not the batch) is suspect?  OOM-shaped runtime errors
    poison allocator state; everything else is assumed transient /
    batch-local and goes down the retry → bisect path.  The card's OOM is
    recognised by its type: its message (``CUDA out of memory``) carries
    neither of the reference's markers."""
    text = f"{type(exc).__name__}: {exc}"
    return isinstance(exc, (SimulatedOOM, torch.OutOfMemoryError)) or \
        "RESOURCE_EXHAUSTED" in text or "Out of memory" in text


# the sticky CUDA errors: after one, every later call on the context fails
# with it, so no in-process retry or engine rebuild can succeed
_STICKY_CUDA_ERRORS = ("illegal memory access", "device-side assert",
                       "unspecified launch failure", "misaligned address",
                       "illegal instruction", "hardware stack error",
                       "invalid program counter")


def is_context_poisoned(exc: BaseException) -> bool:
    """Is this a sticky CUDA error?  Then the process's CUDA context is
    lost: supervision fails the batch's requests (and every later one)
    with a terminal ``error`` instead of retrying or rebuilding."""
    text = str(exc)
    return "CUDA error" in text and \
        any(marker in text for marker in _STICKY_CUDA_ERRORS)


def backoff_delay(attempt: int, base_s: float, cap_s: float,
                  rand: Optional[random.Random] = None) -> float:
    """Capped exponential backoff with jitter in [0.5, 1.5) — shared by
    the scheduler's retry loop and the blocking client."""
    delay = min(cap_s, base_s * math.pow(2.0, max(attempt - 1, 0)))
    if rand is not None:
        delay *= 0.5 + rand.random()
    return min(delay, cap_s)
