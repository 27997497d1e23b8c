"""A real metrics registry for the serving stack (Prometheus text
exposition, format 0.0.4).

The seed's ``/metrics`` endpoint hand-concatenated f-strings inside the
server — no HELP/TYPE metadata, no shared escaping, nothing any other
layer could register into.  This module replaces that with three typed
instruments and one registry:

* ``Counter``   — monotone; ``inc(amount)``.
* ``Gauge``     — settable; ``set(v)`` / ``inc`` / ``dec``.
* ``Histogram`` — cumulative buckets (Prometheus convention: each
  ``le``-labelled bucket counts observations ≤ its bound, ``+Inf``
  always present) plus ``_sum``/``_count`` series.

All three are label-aware: ``metric.labels(model="tiny").inc()`` keys a
child per label-value tuple.  Everything is thread-safe under one
registry lock — scrapes happen on the server's event loop while decode
worker threads observe latencies, so atomicity here is load-bearing,
not hygiene.

Two publication paths:

* **registered instruments** — created via ``registry.counter(...)``
  etc.; the scheduler's latency/queue-depth/tokens histograms and the
  per-strategy decode counters live here.
* **collector callbacks** — ``registry.register_collector(fn)`` where
  ``fn() -> iterable[Family]`` snapshots state that already has an
  owner (router residency, scheduler counters, decode-cache info) at
  scrape time, instead of mirroring it into gauges it could drift from.

``render()`` emits ``# HELP``/``# TYPE`` per family and escapes label
values (backslash, quote, newline) and help text per the exposition
format; ``CONTENT_TYPE`` is the matching Content-Type header value.

A copy of the reference's ``serving/metrics.py``.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

CONTENT_TYPE = "text/plain; version=0.0.4"

# Prometheus' default latency ladder: 5ms .. 10s
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0)


def escape_label_value(value: str) -> str:
    """Exposition-format label escaping: backslash first (escaping the
    escapes), then quote and newline — one unescaped quote corrupts the
    whole scrape."""
    return (str(value).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def escape_help(text: str) -> str:
    return str(text).replace("\\", r"\\").replace("\n", r"\n")


def format_value(v) -> str:
    """Ints render bare (``repro_up 1``, what the tests grep for);
    floats use repr; non-finite values use the exposition spellings."""
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def format_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    pairs = [f'{k}="{escape_label_value(v)}"' for k, v in labels.items()]
    return "{" + ",".join(pairs) + "}"


@dataclasses.dataclass
class Family:
    """One metric family as a collector callback reports it: a name, a
    type, help text, and ``(labels, value)`` samples.  ``suffix`` lets a
    histogram-shaped collector emit ``_bucket``/``_sum``/``_count``
    series under one family (unused by plain counter/gauge families)."""

    name: str
    mtype: str                     # "counter" | "gauge" | "histogram"
    help: str
    samples: List[Tuple[Dict[str, str], float]]
    suffixes: Optional[List[Tuple[str, Dict[str, str], float]]] = None

    def render(self) -> List[str]:
        lines = [f"# HELP {self.name} {escape_help(self.help)}",
                 f"# TYPE {self.name} {self.mtype}"]
        for labels, value in self.samples:
            lines.append(
                f"{self.name}{format_labels(labels)} {format_value(value)}")
        for suffix, labels, value in self.suffixes or ():
            lines.append(f"{self.name}{suffix}{format_labels(labels)} "
                         f"{format_value(value)}")
        return lines


class _Metric:
    """Shared label plumbing: a metric is a family; ``labels(**kv)``
    returns (creating on first use) the child for one label-value
    combination.  Unlabelled metrics have exactly one child, keyed ()."""

    mtype = "untyped"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = (), *,
                 lock: Optional[threading.Lock] = None):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lock or threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}
        if not self.labelnames:
            self._children[()] = self._make_child()

    def _make_child(self):
        raise NotImplementedError

    def labels(self, **kv):
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: got labels {sorted(kv)}, "
                f"declared {sorted(self.labelnames)}")
        key = tuple(str(kv[k]) for k in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make_child()
        return child

    def _label_dict(self, key: Tuple[str, ...]) -> Dict[str, str]:
        return dict(zip(self.labelnames, key))

    # default child for unlabelled convenience calls
    def _solo(self):
        if self.labelnames:
            raise ValueError(f"{self.name} is labelled; call "
                             f".labels(...) first")
        return self._children[()]

    def family(self) -> Family:
        raise NotImplementedError


class _CounterChild:
    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self.value += amount


class Counter(_Metric):
    mtype = "counter"

    def _make_child(self):
        return _CounterChild(self._lock)

    def inc(self, amount: float = 1.0) -> None:
        self._solo().inc(amount)

    def family(self) -> Family:
        with self._lock:
            samples = [(self._label_dict(k), c.value)
                       for k, c in self._children.items()]
        return Family(self.name, self.mtype, self.help, samples)


class _GaugeChild:
    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)


class Gauge(_Metric):
    mtype = "gauge"

    def _make_child(self):
        return _GaugeChild(self._lock)

    def set(self, v: float) -> None:
        self._solo().set(v)

    def inc(self, amount: float = 1.0) -> None:
        self._solo().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._solo().dec(amount)

    def family(self) -> Family:
        with self._lock:
            samples = [(self._label_dict(k), c.value)
                       for k, c in self._children.items()]
        return Family(self.name, self.mtype, self.help, samples)


class _HistogramChild:
    def __init__(self, bounds: Tuple[float, ...], lock: threading.Lock):
        self._lock = lock
        self.bounds = bounds
        self.bucket_counts = [0] * (len(bounds) + 1)   # last = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.sum += v
            self.count += 1
            for i, bound in enumerate(self.bounds):
                if v <= bound:
                    self.bucket_counts[i] += 1
                    break
            else:
                self.bucket_counts[-1] += 1


class Histogram(_Metric):
    mtype = "histogram"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = (), *,
                 buckets: Sequence[float] = DEFAULT_BUCKETS,
                 lock: Optional[threading.Lock] = None):
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("a histogram needs at least one bucket")
        super().__init__(name, help, labelnames, lock=lock)

    def _make_child(self):
        return _HistogramChild(self.buckets, self._lock)

    def observe(self, v: float) -> None:
        self._solo().observe(v)

    def family(self) -> Family:
        suffixes: List[Tuple[str, Dict[str, str], float]] = []
        with self._lock:
            children = list(self._children.items())
            for key, child in children:
                base = self._label_dict(key)
                cumulative = 0
                for bound, n in zip(child.bounds, child.bucket_counts):
                    cumulative += n
                    suffixes.append(("_bucket",
                                     {**base,
                                      "le": format_value(float(bound))},
                                     cumulative))
                cumulative += child.bucket_counts[-1]
                suffixes.append(("_bucket", {**base, "le": "+Inf"},
                                 cumulative))
                suffixes.append(("_sum", dict(base), child.sum))
                suffixes.append(("_count", dict(base), child.count))
        return Family(self.name, self.mtype, self.help, [], suffixes)


class MetricsRegistry:
    """Instrument factory + scrape-time renderer.  One per server.

    Instruments are created once and cached by name (re-declaring with a
    different type or label set is an error — silent merging is how two
    call sites end up fighting over one series).  Collector callbacks
    run at every ``render()``, so scraped state is always a live
    snapshot, never a mirror that can lag."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        self._order: List[str] = []
        self._collectors: List[Callable[[], Iterable[Family]]] = []

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if type(existing) is not cls or \
                        existing.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} re-declared with a different "
                        f"type or label set")
                return existing
            metric = cls(name, help, labelnames, **kw)
            self._metrics[name] = metric
            self._order.append(name)
            return metric

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (), *,
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def register_collector(
            self, fn: Callable[[], Iterable[Family]]) -> None:
        with self._lock:
            self._collectors.append(fn)

    def render(self) -> str:
        """The scrape body.  Collector families render first (they carry
        ``repro_up`` and the seed-era series the dashboards/tests pin),
        then registered instruments in declaration order."""
        with self._lock:
            collectors = list(self._collectors)
            metrics = [self._metrics[n] for n in self._order]
        lines: List[str] = []
        for fn in collectors:
            for family in fn():
                lines.extend(family.render())
        for metric in metrics:
            lines.extend(metric.family().render())
        return "\n".join(lines) + "\n"
