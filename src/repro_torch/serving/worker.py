"""One worker thread per device: the thread that does the serving stack's
card work.

CUDA's current stream is per thread, and the graph drivers' captured
graphs share static buffers and one memory pool per device
(``core/graphs.py``, the ``RunnerCache`` in ``core/decoder.py``).  So
the async scheduler runs every resumption of a decode on its device's
worker, and so do the engine builds, evictions and rebuilds that the
server and the scheduler start, and the profiler's start and stop.  One
thread per device, shared by every engine on it and by its rebuilds: a
watchdog-abandoned resumption and its retry, or a rebuilt engine, queue
behind one another and never replay the same graphs at once, and no
capture ever runs while another thread of the stack makes a CUDA call.
The event loop's thread touches host data only.
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional, TypeVar

import torch

T = TypeVar("T")

_LOCK = threading.Lock()
_WORKERS: Dict[str, ThreadPoolExecutor] = {}
_LOCAL = threading.local()


def _key(device) -> str:
    dev = torch.device(device)
    return f"{dev.type}:{dev.index or 0}"


def _mark(key: str) -> None:
    _LOCAL.device = key


def device_worker(device) -> ThreadPoolExecutor:
    """The single-thread executor of ``device`` (made on first use; it
    lives as long as the process)."""
    key = _key(device)
    with _LOCK:
        worker = _WORKERS.get(key)
        if worker is None:
            worker = _WORKERS[key] = ThreadPoolExecutor(
                1, thread_name_prefix=f"repro-torch-{key}",
                initializer=_mark, initargs=(key,))
    return worker


def run_on_worker(device, fn: Callable[..., T], *args,
                  timeout: Optional[float] = None) -> T:
    """``fn(*args)`` on ``device``'s worker, waited for (called directly
    when the caller is that worker already)."""
    if getattr(_LOCAL, "device", None) == _key(device):
        return fn(*args)
    return device_worker(device).submit(fn, *args).result(timeout)
