"""Named-model routing over multiple ServingEngines, under an explicit
bytes-budget LRU.

Models are *registered* as factories (``name -> () -> ServingEngine``)
and *built* lazily on first use, so a router can know about many more
models than fit in memory.  ``engine(name)`` returns the resident engine,
building it if needed, marking it most-recently-used, and then enforcing
the budget: while the summed parameter bytes of resident engines exceed
``RouterConfig.budget_bytes``, the least-recently-used IDLE engine is
force-dropped.  A busy engine (queued work or mid-decode, as reported by
its busy probe) is never evicted — the budget transiently overshoots
instead and converges as decodes drain.

Eviction actually frees the card: the evicted engine is released
(``ServingEngine.release`` drops its weights and the Decoders holding
them), the router holds no other reference, the factory loads or makes
the weights anew on each build, and the Decoder's process-wide runner
cache only *weakly* anchors the weights — so the weights' tensors go at
the eviction's ``gc.collect()``, their ``weakref.finalize`` anchors fire,
and their graph runs (static buffers, K/V caches, captured graphs) go
with them.  ``decode_cache_info().entries`` observably shrinks, and on
the card ``last_eviction`` records ``torch.cuda.memory_allocated`` just
before and after (read from the allocator's counters).  A scheduler that
still holds the released engine holds no weights.

Hot swap = rebuild: ``hot_swap(name)`` (optionally with a new factory)
drops the resident engine and builds a fresh one from the factory.

One router serves one ``device`` (``"cuda"`` by default: without a card
the constructor raises unless given ``device="cpu"``), and every engine
its factories build must decode there.  The server calls ``engine``,
and with it every build and eviction, on that device's worker thread
(``serving/worker.py``), so no CUDA call of the router's runs beside a
capture on another thread.

A copy of the reference's ``serving/router.py`` but for the release, the
device and ``last_eviction``.
"""
from __future__ import annotations

import gc
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.configs.base import RouterConfig
from repro_torch.device import resolve_device
from repro_torch.serving.engine import ServingEngine
from repro_torch.training.optimizer import leaves


def params_bytes(params) -> int:
    """Total bytes of a params tree's tensors."""
    return int(sum(t.nbytes for t in leaves(params)))


@dataclass
class _Slot:
    engine: ServingEngine
    nbytes: int
    last_used: float = 0.0
    # busy probe: the router alone can only see queued work; a scheduler
    # wrapping the engine also knows about the batch in flight and
    # installs a probe covering both (ServingServer does this)
    busy: Optional[Callable[[], bool]] = field(default=None)

    def is_busy(self) -> bool:
        if self.busy is not None:
            return bool(self.busy())
        return self.engine.queue_depth > 0


class ModelRouter:
    def __init__(self, rcfg: RouterConfig = RouterConfig(), *,
                 device="cuda", on_evict: Optional[Callable] = None):
        self.rcfg = rcfg
        self.device = resolve_device(device)
        self.on_evict = on_evict          # (name, engine) -> None
        # the last eviction: name, weights' bytes, and on the card the
        # allocator's allocated bytes just before and after it
        self.last_eviction: Optional[Dict] = None
        self._factories: "OrderedDict[str, Callable[[], ServingEngine]]" \
            = OrderedDict()
        self._slots: "OrderedDict[str, _Slot]" = OrderedDict()
        self.counters = {"builds": 0, "evictions": 0, "swaps": 0,
                         "rebuilds": 0}

    # -- registration ------------------------------------------------------
    def register(self, name: str,
                 factory: Callable[[], ServingEngine]) -> None:
        if self.rcfg.max_models and \
                len(self._factories) >= self.rcfg.max_models and \
                name not in self._factories:
            raise ValueError(
                f"router is capped at {self.rcfg.max_models} models")
        self._factories[name] = factory

    def names(self) -> List[str]:
        return list(self._factories)

    @property
    def default(self) -> str:
        if not self._factories:
            raise RuntimeError("no models registered")
        return next(iter(self._factories))

    # -- routing -----------------------------------------------------------
    def engine(self, name: str) -> ServingEngine:
        """Resident engine for ``name`` (built on demand), LRU-touched;
        enforces the bytes budget on the way out."""
        if name not in self._factories:
            raise KeyError(f"unknown model {name!r}; have {self.names()}")
        slot = self._slots.get(name)
        if slot is None:
            engine = self._factories[name]()
            if engine.device.type != self.device.type:
                raise ValueError(f"model {name!r} was built on "
                                 f"{engine.device}; this router serves "
                                 f"{self.device}")
            slot = _Slot(engine=engine, nbytes=params_bytes(engine.params))
            self._slots[name] = slot
            self.counters["builds"] += 1
        self._slots.move_to_end(name)
        slot.last_used = time.monotonic()
        self._enforce_budget(keep=name)
        return slot.engine

    def touch(self, name: str) -> Optional[ServingEngine]:
        """LRU-touch an ALREADY-RESIDENT engine and return it; None when
        not resident (or unknown).  Unlike ``engine()`` this never
        builds and never enforces the budget — residency only changes
        on builds — so it is the cheap fast path the server uses for
        warm models without hopping to an executor thread."""
        slot = self._slots.get(name)
        if slot is None:
            return None
        self._slots.move_to_end(name)
        slot.last_used = time.monotonic()
        return slot.engine

    def set_busy_probe(self, name: str,
                       probe: Optional[Callable[[], bool]]) -> None:
        slot = self._slots.get(name)
        if slot is not None:
            slot.busy = probe

    def resident(self, name: str) -> bool:
        return name in self._slots

    # -- eviction ----------------------------------------------------------
    def evict(self, name: str, force: bool = False) -> bool:
        """Drop a resident engine: it is released, so its weights and
        their runner-cache runs go (a decode still running on it keeps
        them until it ends).  Busy engines are refused unless
        ``force=True``."""
        slot = self._slots.get(name)
        if slot is None:
            return False
        if slot.is_busy() and not force:
            return False
        cuda = self.device.type == "cuda"
        before = torch.cuda.memory_allocated(self.device) if cuda else None
        del self._slots[name]
        if self.on_evict is not None:
            self.on_evict(name, slot.engine)
        slot.engine.release()
        self.counters["evictions"] += 1
        nbytes = slot.nbytes
        del slot
        # drop the last strong refs NOW so the weak runner cache's
        # finalizers fire deterministically (stray reference cycles would
        # otherwise defer them to an arbitrary later collection)
        gc.collect()
        self.last_eviction = {
            "name": name, "weights_bytes": nbytes,
            "allocated_before": before,
            "allocated_after": torch.cuda.memory_allocated(self.device)
            if cuda else None}
        return True

    def _enforce_budget(self, keep: Optional[str] = None) -> None:
        budget = self.rcfg.budget_bytes
        if not budget:
            return
        # oldest-first scan; the engine just touched is exempt (evicting
        # what we are about to hand out would be self-defeating)
        for name in list(self._slots):
            if self.resident_bytes() <= budget:
                return
            if name != keep:
                self.evict(name)

    def resident_bytes(self) -> int:
        return sum(s.nbytes for s in self._slots.values())

    # -- hot swap ----------------------------------------------------------
    def hot_swap(self, name: str,
                 factory: Optional[Callable[[], ServingEngine]] = None
                 ) -> ServingEngine:
        """Replace a model's weights: optionally install a new factory,
        force-drop the resident engine (queued requests on it are lost —
        drain its scheduler first for a graceful swap), and build the
        replacement.  The old engine's params and compiled runners free
        with it."""
        if name not in self._factories:
            raise KeyError(f"unknown model {name!r}; have {self.names()}")
        if factory is not None:
            self._factories[name] = factory
        self.evict(name, force=True)
        self.counters["swaps"] += 1
        return self.engine(name)

    def rebuild(self, name: str) -> ServingEngine:
        """Supervision-triggered hot swap (the circuit breaker tripped):
        same mechanics as ``hot_swap`` with the existing factory —
        force-drop, fresh build — but counted separately, because swaps
        are operator intent and rebuilds are the engine crashing."""
        engine = self.hot_swap(name)
        self.counters["rebuilds"] += 1
        return engine

    # -- introspection -----------------------------------------------------
    def info(self) -> Dict:
        return {"budget_bytes": self.rcfg.budget_bytes,
                "resident_bytes": self.resident_bytes(),
                **self.counters,
                "models": {name: {
                    "resident": name in self._slots,
                    "bytes": (self._slots[name].nbytes
                              if name in self._slots else 0),
                    "queued": (self._slots[name].engine.queue_depth
                               if name in self._slots else 0),
                    "busy": (self._slots[name].is_busy()
                             if name in self._slots else False),
                } for name in self._factories}}
