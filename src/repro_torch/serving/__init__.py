"""The port's serving stack, bottom-up (reference: ``src/repro/serving``):

* ``engine``     — batched, bucket-scheduled decoding over one model's
                   weights (synchronous; the batch-selection/decode split
                   the async layer builds on)
* ``faults``     — deterministic fault injection at the engine's block
                   grain, the output validator, failure classification
                   (the card's OOM by type; sticky CUDA errors)
* ``supervisor`` — supervision policy pieces: retry backoff, circuit
                   breaker, the degradation ladder, failure
                   classification
* ``worker``     — one worker thread per device, where all of the
                   stack's card work runs
* ``scheduler``  — the async continuous-batching loop: admission control
                   (depth / deadline / degradation ladder), per-request
                   event streams at the block grain, and batch
                   supervision (watchdog, retries, bisection quarantine,
                   engine rebuild, graceful drain)
* ``router``     — named-model routing over engines under a bytes-budget
                   LRU, with hot swap and eviction that frees the card
* ``metrics``    — Prometheus-text metrics registry behind ``/metrics``
* ``tracing``    — per-request span records + Chrome trace-event export
                   behind ``/v1/trace/{rid}``
* ``server``     — stdlib asyncio HTTP/1.1 + SSE front end over a router
* ``client``     — small blocking client with backoff retries
"""
from repro_torch.serving.client import ServerError, ServingClient
from repro_torch.serving.engine import Batch, Request, ServingEngine
from repro_torch.serving.faults import (CorruptOutputError, Fault,
                                        FaultInjector, InjectedFault,
                                        SimulatedOOM, is_context_poisoned,
                                        is_engine_fatal,
                                        validate_block_tokens)
from repro_torch.serving.metrics import (CONTENT_TYPE, Counter, Family,
                                         Gauge, Histogram, MetricsRegistry)
from repro_torch.serving.router import ModelRouter, params_bytes
from repro_torch.serving.scheduler import (AsyncScheduler, QueueFullError,
                                           SchedulerDrainingError,
                                           stats_dict)
from repro_torch.serving.server import ServerThread, ServingServer
from repro_torch.serving.supervisor import (Backoff, CircuitBreaker,
                                            DegradationLadder,
                                            WatchdogTimeout)
from repro_torch.serving.tracing import Span, TraceStore, chrome_trace
from repro_torch.serving.worker import run_on_worker

__all__ = [
    "Request", "Batch", "ServingEngine",
    "Fault", "FaultInjector", "InjectedFault", "SimulatedOOM",
    "CorruptOutputError", "is_engine_fatal", "is_context_poisoned",
    "validate_block_tokens",
    "Backoff", "CircuitBreaker", "DegradationLadder", "WatchdogTimeout",
    "AsyncScheduler", "QueueFullError", "SchedulerDrainingError",
    "stats_dict",
    "ModelRouter", "params_bytes",
    "CONTENT_TYPE", "Counter", "Gauge", "Histogram", "Family",
    "MetricsRegistry",
    "Span", "TraceStore", "chrome_trace",
    "ServingServer", "ServerThread",
    "ServingClient", "ServerError",
    "run_on_worker",
]
