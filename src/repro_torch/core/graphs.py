"""CUDA-graph helpers of the device-resident decode drivers
(``core/loop.py``).  The port's own module: the reference's drivers are
``lax.while_loop``/``lax.scan`` programs and need none of this.

A captured graph cannot branch on the host, and the card's PyTorch (2.11)
has no capture into conditional IF nodes
(``CUDAGraph.begin_capture_to_if_node`` came later), so a branch on data
is a mask:

* ``run_masked(pred, fn, out)`` — the counterpart of a ``lax.cond`` whose
  else branch keeps ``out``: ``fn()`` returns new values for the tensors
  of ``out`` and they are written where the 0-dim bool ``pred`` holds.  On
  the card ``fn`` always runs and ``pred`` selects on the device: no sync,
  no host branch, the work of ``fn`` paid on every replay.  On the CPU it
  is a host branch, which gives the same values and draws the same random
  numbers as the eager driver.
* ``GraphSet`` — the graphs of one decode runner, keyed by the caller.
  ``run(key, fn)`` replays graph ``key``, capturing ``fn`` into it at its
  first use; on the CPU it calls ``fn()``, so the drivers run the same
  code there, eagerly.  Its graphs are captured on the side stream of a
  ``CapturePool`` into that pool's memory and replayed on the current
  stream; a warm run or a capture on the side stream is ordered after the
  current stream's queued work, and the current stream after it.  The
  set's ``torch.Generator`` is registered with every graph (only the
  default generator is registered on its own): a replay draws from it at
  the offset it holds, then advances it by the graph's draws.
* ``CapturePool`` — one graph memory pool and one capture stream, shared
  by every ``GraphSet`` given it (the runner cache gives one per device
  to all its runners).  Graphs may share a pool because none of them
  leaves a live tensor in it: a graph's results go into static buffers
  allocated outside any capture, and everything it allocates itself is
  dead when its capture ends, so a later capture reuses that memory and
  the pool holds the largest step's temporaries, not their sum.  The
  cost: their replays must never overlap, so every graph of a pool is
  replayed on one stream (the caller's current stream, as decodes do).

Executed launches.  A kernel wrapper's ``launches`` counter counts calls,
so a graph's replays do not move it.  A graph has no conditional node, so
every kernel recorded into it runs on every replay: ``GraphSet`` keeps the
wrapper launches recorded into each graph and the graph's replays, and
``executed_launches()`` multiplies the two.  ``REPLAYED`` sums the same
over every set of the process as its graphs run, so a set that the runner
cache has dropped (and freed) still counts.
"""
from __future__ import annotations

import time
from collections import Counter
from typing import Callable, Dict, Hashable, Optional

import torch

from repro_torch.kernels import confidence, flash_attention, selective_scan

KERNELS = {"confidence": confidence, "flash_attention": flash_attention,
           "selective_scan": selective_scan}

# kernel launches executed by every GraphSet's runs on the card, by kernel
# (the recorded launches of each graph at each of its runs); zeroed by the
# caller that counts
REPLAYED: Counter = Counter()


def wrapper_launches() -> Counter:
    """Every kernel wrapper's ``launches`` counter, by kernel."""
    return Counter({name: mod.launches for name, mod in KERNELS.items()})


def write_where(pred: torch.Tensor, out, new) -> None:
    """``out ← where(pred, new, out)`` over a tensor or nested tuples and
    lists of them, in place."""
    if isinstance(out, torch.Tensor):
        out.copy_(torch.where(pred, new, out))
        return
    for o, n in zip(out, new):
        write_where(pred, o, n)


def write(out, new) -> None:
    """``out ← new`` over a tensor or nested tuples and lists, in place."""
    if isinstance(out, torch.Tensor):
        if new is not out:
            out.copy_(new)
        return
    for o, n in zip(out, new):
        write(o, n)


def run_masked(pred: torch.Tensor, fn: Callable, out) -> None:
    """Write ``fn()``'s values into ``out`` where the 0-dim bool ``pred``
    holds (see the module docstring): a device-side select on the card, a
    host branch on the CPU."""
    if pred.is_cuda:
        write_where(pred, out, fn())
    elif bool(pred):
        write(out, fn())


class CapturePool:
    """A graph memory pool and the side stream its captures run on (see
    the module docstring)."""

    def __init__(self, device: torch.device):
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)


class GraphSet:
    """The captured graphs of one decode runner (see the module
    docstring).  ``captures`` and ``capture_seconds`` count the captures
    made so far; ``on_capture`` (if given) is called after each.
    ``capture`` is the ``CapturePool`` to capture into (a pool of its own
    if None)."""

    def __init__(self, device: torch.device,
                 generator: Optional[torch.Generator] = None,
                 on_capture: Optional[Callable[[], None]] = None,
                 capture: Optional[CapturePool] = None):
        self.device = device
        self.generator = generator
        self.on_capture = on_capture
        self.captures = 0
        self.capture_seconds = 0.0
        self.cuda = device.type == "cuda"
        self._graphs: Dict[Hashable, torch.cuda.CUDAGraph] = {}
        self._launches: Dict[Hashable, Counter] = {}   # recorded per graph
        self._replays: Counter = Counter()
        if self.cuda:
            # held by every set that captures into it: the runner cache
            # hands a pool out only while some set holds it, since a pool
            # whose graphs all died must not be captured into again
            self.capture = capture or CapturePool(device)
            self.pool = self.capture.pool
            self.stream = self.capture.stream

    def __len__(self) -> int:
        return len(self._graphs)

    def warm(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` once eagerly on the capture stream (CUDA only), so
        that every kernel is built and loaded and every library handle and
        workspace exists before any capture: ``nvcc`` never runs inside
        one.  ``fn`` runs on the static buffers, so the caller resets them
        afterwards."""
        if not self.cuda:
            return
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            fn()
        current.wait_stream(self.stream)

    def run(self, key: Hashable, fn: Callable[[], None]) -> None:
        """Replay graph ``key`` on the current stream, capturing ``fn``
        into it first if it has none; on the CPU call ``fn()``."""
        self._replays[key] += 1
        if not self.cuda:
            fn()
            return
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = self._capture(key, fn)
        graph.replay()
        REPLAYED.update(self._launches[key])

    def _capture(self, key: Hashable,
                 fn: Callable[[], None]) -> torch.cuda.CUDAGraph:
        t0 = time.perf_counter()
        # the capture stream runs work of its own before the capture (the
        # generator's seed and offset fills, into tensors the allocator
        # may have just handed on from a temporary of the current stream
        # that a queued copy still reads), so it waits for the current
        # stream first, and the current stream's replays wait for it
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        before = wrapper_launches()
        with torch.cuda.stream(self.stream):
            graph.capture_begin(pool=self.pool)
            try:
                fn()
            finally:
                graph.capture_end()
        current.wait_stream(self.stream)
        self._launches[key] = wrapper_launches() - before
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0
        if self.on_capture is not None:
            self.on_capture()
        return graph

    def reset_counts(self) -> None:
        """Zero the replay counts behind ``executed_launches``."""
        self._replays.clear()

    def replays(self, key: Optional[Hashable] = None) -> int:
        """Replays of graph ``key`` (of all graphs if None) since the last
        ``reset_counts``; on the CPU, calls of ``run``."""
        if key is not None:
            return self._replays[key]
        return sum(self._replays.values())

    def executed_launches(self) -> Counter:
        """Kernel launches executed by this set's replays since the last
        ``reset_counts``, by kernel."""
        out = Counter()
        for key, launches in self._launches.items():
            for name, n in launches.items():
                out[name] += n * self._replays[key]
        return +out                          # kernels that ran, only
