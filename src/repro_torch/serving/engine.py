"""Batched serving engine of the port (reference:
``src/repro/serving/engine.py``).

Requests are queued, grouped into fixed-shape batches and each batch is
decoded through one ``Decoder``.  Scheduling is prompt-length bucketed:
the bucket holding the oldest request is served first, shorter prompts in
a batch are left-padded with the mask token (pad columns sit outside
every decode block, so they are never committed, and are sliced off the
results), and a short batch is filled to ``max_batch`` rows with copies
of its last prompt.  Per-request ``strategy``/``steps``/``gen_length``/
``block_size``/``cache_policy`` overrides are validated at ``submit`` and
become part of the batch key, so requests under different cache policies
never share a batch; a bisection cohort (``group``) is part of it too.
``on_cache_refresh(requests, block_index, t_start_s, t_end_s)``, when
set, observes each KV-cache capture of a cached batch, and
``on_batch_done(batch)`` each batch that finished decoding.

The engine is synchronous; the split into ``select_batch`` and
``decode_batch``/``decode_batch_blocks`` is what the async scheduler
(``serving/scheduler.py``) builds on, with the supervision hooks
(``cancel``, ``requeue``, ``record_failed``, ``adopt``,
``reap_expired``, per-request deadlines) the reference's.
``decode_batch_blocks`` is the fault boundary: an attached
``FaultInjector`` fires there, every committed block passes the output
validator, and it yields host numpy tokens, so nothing leaves the
decode's thread as a CUDA tensor.

A ``Batch`` carries the seed of its random draws, not a generator: the
decoder advances the generator it is given, so every attempt at a batch
builds a fresh one from the seed, and a retried batch draws exactly what
its first attempt drew (the reference keeps an immutable JAX key).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import DecodeConfig, ModelConfig
from repro_torch.core.decoder import (Decoder, SampleStats, check_kernel_flag,
                                      check_supported)
from repro_torch.core.strategies import resolve_strategy
from repro_torch.device import resolve_device
from repro_torch.serving.faults import (CorruptOutputError, FaultInjector,
                                        validate_block_tokens)

__all__ = ["Batch", "CorruptOutputError", "Request", "ServingEngine",
           "validate_block_tokens"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (Lp,) int
    result: Optional[np.ndarray] = None
    stats: Optional[SampleStats] = None
    submit_time: float = 0.0
    finish_time: float = 0.0
    dcfg: Optional[DecodeConfig] = None   # effective per-request config
    deadline: Optional[float] = None      # absolute perf_counter() time by
                                          # which decoding must have STARTED
    cancelled: bool = False
    expired: bool = False
    failed: bool = False                  # quarantined / retries exhausted
    pad_cols: int = 0                     # mask pad columns this request got
    retries: int = 0                      # supervision re-queues so far
    group: int = 0                        # bisection cohort (requests only
                                          # co-batch within a group)

    @property
    def latency(self) -> float:
        return self.finish_time - self.submit_time

    @property
    def status(self) -> str:
        if self.cancelled:
            return "cancelled"
        if self.expired:
            return "expired"
        if self.failed:
            return "error"
        return "done" if self.result is not None else "queued"


@dataclasses.dataclass
class Batch:
    """One schedulable unit: same effective DecodeConfig, same length
    bucket, padded to fixed shape.  ``Decoder(params, cfg, dcfg)
    .generate(seed, prompts)`` reproduces its decode."""
    requests: List[Request]
    prompts: np.ndarray                # (max_batch, Lp) — replicas included
    pads: List[int]                    # per-request mask pad columns
    dcfg: DecodeConfig
    seed: int                          # of the decode's random draws

    def generator(self, device: torch.device) -> torch.Generator:
        """A fresh generator for one attempt at this batch."""
        return torch.Generator(device=device).manual_seed(self.seed)


class ServingEngine:
    def __init__(self, params, cfg: ModelConfig, dcfg: DecodeConfig,
                 max_batch: int = 8, seed: int = 0,
                 length_bucket: int = 8,
                 on_block_committed: Optional[Callable] = None,
                 fault_injector: Optional[FaultInjector] = None,
                 device="cuda"):
        self.params = params
        self.cfg = cfg
        self.dcfg = dcfg
        self.device = resolve_device(device)
        self.decoder = Decoder(params, cfg, dcfg, device=self.device)
        self.max_batch = max_batch
        self.length_bucket = max(length_bucket, 1)
        self.on_block_committed = on_block_committed
        self.on_cache_refresh: Optional[Callable] = None
        self.on_batch_done: Optional[Callable[[Batch], None]] = None
        self.fault_injector = fault_injector
        self.queue: Deque[Request] = deque()
        self.done: Dict[int, Request] = {}
        self._next_id = 0
        self._next_group = 1
        self._seeds = np.random.SeedSequence(seed)
        self._decoders: Dict[DecodeConfig, Decoder] = {dcfg: self.decoder}

    def set_fault_injector(self,
                           injector: Optional[FaultInjector]) -> None:
        """Attach (or detach) the fault-injection harness; it fires inside
        ``decode_batch_blocks``."""
        self.fault_injector = injector

    def release(self) -> None:
        """Drop the engine's references to its weights (and the Decoders
        that hold them): the router's eviction, so that the weights, and
        with them their runner-cache runs, go as soon as no decode holds
        them.  The bookkeeping stays for ``adopt``; the engine decodes no
        more."""
        self.params = None
        self.decoder = None
        self._decoders.clear()

    # -- client API --------------------------------------------------------
    def submit(self, prompt: np.ndarray, *,
               strategy: Optional[str] = None,
               steps: Optional[int] = None,
               gen_length: Optional[int] = None,
               block_size: Optional[int] = None,
               cache_policy: Optional[str] = None,
               trace: Optional[bool] = None,
               deadline_s: Optional[float] = None) -> int:
        """Queue a prompt; returns the request id.  The overrides build the
        request's effective ``DecodeConfig``, validated HERE: an unknown
        strategy raises ``KeyError``, a bad geometry or a cache policy the
        model can never serve ``ValueError``, and a prompt token outside
        the vocabulary ``CorruptOutputError``.  ``deadline_s`` bounds QUEUE
        time: a request still queued after it is dropped as expired at
        the next reap."""
        over = {k: v for k, v in dict(
            strategy=strategy, steps=steps, gen_length=gen_length,
            block_size=block_size, cache_policy=cache_policy,
            trace=trace).items() if v is not None}
        dcfg = dataclasses.replace(self.dcfg, **over) if over else self.dcfg
        resolve_strategy(dcfg.strategy)
        check_supported(self.cfg, dcfg)
        check_kernel_flag(dcfg, self.device)
        for knob in ("gen_length", "block_size", "steps"):
            if getattr(dcfg, knob) < 1:
                raise ValueError(f"{knob}={getattr(dcfg, knob)} must be "
                                 f"a positive integer")
        if dcfg.gen_length % dcfg.block_size:
            raise ValueError(
                f"gen_length={dcfg.gen_length} is not a multiple of "
                f"block_size={dcfg.block_size}")
        num_blocks = dcfg.gen_length // dcfg.block_size
        if dcfg.steps < num_blocks:
            raise ValueError(
                f"steps={dcfg.steps} is infeasible: {num_blocks} blocks "
                f"need at least one step each")
        prompt = np.asarray(prompt)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError(f"prompt must be a non-empty 1-d token array, "
                             f"got shape {prompt.shape}")
        validate_block_tokens(prompt, self.cfg.vocab_size)
        rid = self._next_id
        self._next_id += 1
        now = time.perf_counter()
        self.queue.append(Request(
            rid=rid, prompt=prompt, submit_time=now, dcfg=dcfg,
            deadline=None if deadline_s is None else now + deadline_s))
        return rid

    def cancel(self, rid: int) -> bool:
        """Drop a still-queued request (it lands in ``done`` with
        ``cancelled=True``).  False if it already finished, was never
        submitted, or is decoding right now."""
        for req in self.queue:
            if req.rid == rid:
                self.queue.remove(req)
                req.cancelled = True
                req.finish_time = time.perf_counter()
                self.done[rid] = req
                return True
        return False

    def result(self, rid: int) -> Request:
        return self.done[rid]

    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    # -- scheduler ---------------------------------------------------------
    def _bucket_len(self, lp: int) -> int:
        q = self.length_bucket
        return -(-lp // q) * q

    def _bucket_key(self, req: Request) -> Tuple:
        """Requests batch together iff this matches: prompt-length bucket,
        effective DecodeConfig (the cache policy explicitly: policies
        decode differently, so mixing them would be a correctness bug)
        and bisection cohort."""
        return (self._bucket_len(req.prompt.shape[0]), req.dcfg,
                req.dcfg.cache_policy, req.group)

    # -- supervision hooks (used by the async scheduler) -------------------
    def requeue(self, requests: List[Request],
                fresh_group: bool = False) -> None:
        """Push requests back at the queue FRONT, in order;
        ``fresh_group=True`` moves them to a new bisection cohort, so the
        half of a failed batch never re-co-batches with the other half."""
        if fresh_group:
            group = self._next_group
            self._next_group += 1
            for req in requests:
                req.group = group
        for req in reversed(list(requests)):
            req.pad_cols = 0            # re-derived at the next select
            self.queue.appendleft(req)

    def record_failed(self, req: Request,
                      now: Optional[float] = None) -> None:
        """Terminal supervision failure: the request lands in ``done``
        with no result."""
        req.failed = True
        req.finish_time = time.perf_counter() if now is None else now
        self.done[req.rid] = req

    def adopt(self, old: "ServingEngine") -> None:
        """Carry another engine's queued requests, finished history and
        rid/cohort counters into this one (the supervisor's rebuild);
        hooks and the fault injector are not adopted."""
        self.queue.extend(old.queue)
        old.queue.clear()
        self.done.update(old.done)
        self._next_id = max(self._next_id, old._next_id)
        self._next_group = max(self._next_group, old._next_group)

    def reap_expired(self, now: Optional[float] = None) -> List[Request]:
        """Drop queued requests whose deadline passed; returns them (also
        recorded in ``done`` with ``expired=True``)."""
        now = time.perf_counter() if now is None else now
        expired = [r for r in self.queue
                   if r.deadline is not None and now > r.deadline]
        for req in expired:
            self.queue.remove(req)
            req.expired = True
            req.finish_time = now
            self.done[req.rid] = req
        return expired

    def select_batch(self) -> Optional[Batch]:
        """Pop one batch from the queue (no decoding): the group holding
        the oldest request, up to ``max_batch``, FIFO within the group.
        Host work only (the async scheduler calls it on its event loop);
        callers reap expired requests first."""
        if not self.queue:
            return None
        head = self._bucket_key(self.queue[0])
        batch: List[Request] = []
        rest: List[Request] = []
        for r in self.queue:
            if self._bucket_key(r) == head and len(batch) < self.max_batch:
                batch.append(r)
            else:
                rest.append(r)
        self.queue = deque(rest)
        # pad only to the batch's longest REAL prompt (mask pads cost
        # quality, so uniform-length workloads see none)
        lp = max(r.prompt.shape[0] for r in batch)
        pads = [lp - r.prompt.shape[0] for r in batch]
        for r, p in zip(batch, pads):
            r.pad_cols = p
        prompts = np.stack([
            np.concatenate([np.full((p,), self.cfg.mask_token_id,
                                    r.prompt.dtype), r.prompt])
            if p else r.prompt for r, p in zip(batch, pads)])
        pad = self.max_batch - len(batch)
        if pad:
            prompts = np.concatenate(
                [prompts, np.repeat(prompts[-1:], pad, 0)])
        seed = int(self._seeds.spawn(1)[0].generate_state(1)[0])
        return Batch(requests=batch, prompts=prompts, pads=pads,
                     dcfg=batch[0].dcfg or self.dcfg, seed=seed)

    def _decoder_for(self, dcfg: DecodeConfig) -> Decoder:
        dec = self._decoders.get(dcfg)
        if dec is None:
            if self.params is None:
                raise RuntimeError("engine was released (evicted); it "
                                   "decodes no more")
            # Decoders are cheap (graph runs live in the shared weak
            # cache keyed on the weights); a small table spares re-keying
            if len(self._decoders) > 32:
                self._decoders.clear()
                self._decoders[self.dcfg] = self.decoder
            dec = self._decoders[dcfg] = Decoder(self.params, self.cfg,
                                                 dcfg, device=self.device)
        return dec

    def decode_batch(self, batch: Batch,
                     on_block_committed: Optional[Callable] = None
                     ) -> List[int]:
        """Decode one selected batch to completion.  Every committed block
        passes ``validate_block_tokens``; ``on_block_committed(requests,
        block_index, lo, hi, x)`` observes it.  Returns finished rids."""
        blocks = self._blocks(batch)
        while True:
            try:
                ev = next(blocks)
            except StopIteration as fin:
                out, stats = fin.value
                return self._finish_batch(batch, out, stats)
            validate_block_tokens(ev.x[:, ev.lo:ev.hi].cpu().numpy(),
                                  self.cfg.vocab_size)
            if on_block_committed is not None:
                on_block_committed(batch.requests, ev.block, ev.lo, ev.hi,
                                   ev.x)

    def decode_batch_blocks(self, batch: Batch) -> Iterator[Tuple]:
        """Decode one selected batch at the BLOCK grain: a generator
        yielding ``(block_index, lo, hi, block_tokens)`` after each
        committed block — ``block_tokens`` the host ``(B, bs)`` numpy
        slice, replica rows included — and returning the finished rids.
        The engine-level ``on_block_committed`` hook fires here too.

        The FAULT BOUNDARY: an attached ``FaultInjector`` fires here
        (raised exceptions, simulated OOM or stalls before a block,
        NaN-style corruption after it), and every committed block passes
        the output validator.  A failed attempt never reaches
        ``_finish_batch``, and each attempt draws from a fresh generator
        of the batch's seed, so a retried batch equals a fault-free
        decode token for token."""
        inj = self.fault_injector
        bi = inj.begin_batch() if inj is not None else 0
        rids = [r.rid for r in batch.requests]
        blocks = self._blocks(batch)
        block_index = 0
        while True:
            if inj is not None:
                inj.before_block(bi, rids, block_index)
            try:
                ev = next(blocks)
            except StopIteration as fin:
                out, stats = fin.value
                return self._finish_batch(batch, out, stats)
            block_index += 1
            tokens = ev.x[:, ev.lo:ev.hi].cpu().numpy()
            if inj is not None:
                tokens = inj.filter_tokens(bi, rids, ev.block, tokens)
            validate_block_tokens(tokens, self.cfg.vocab_size)
            if self.on_block_committed is not None:
                self.on_block_committed(batch.requests, ev.block, ev.lo,
                                        ev.hi, ev.x)
            yield (ev.block, ev.lo, ev.hi, tokens)

    def _blocks(self, batch: Batch):
        """The batch's decode as a block generator, with the cache-refresh
        hook pointed at its requests (decoders are per config and the
        engine decodes one batch at a time, so this is race-free)."""
        dec = self._decoder_for(batch.dcfg)
        if self.on_cache_refresh is not None:
            dec.on_cache_refresh = (
                lambda blk, t0, t1, _reqs=batch.requests:
                self.on_cache_refresh(_reqs, blk, t0, t1))
        else:
            dec.on_cache_refresh = None
        return dec.generate_blocks(batch.generator(self.device),
                                   batch.prompts)

    def _finish_batch(self, batch: Batch, out: torch.Tensor,
                      stats: SampleStats) -> List[int]:
        """Per-request results and stats.  Each request gets its share of
        the batch's work — forwards, wall time and carry counters divided
        across the real (non-replica) members; ``steps`` stays the batch's
        (decode is batch-synchronous); phase counts are normalised by the
        padded row count (one flag per row per step), so they still sum to
        ``steps`` per request; a traced decode's ``DecodeTrace`` is cut to
        each request's own row."""
        out = out.cpu().numpy()
        now = time.perf_counter()
        real = len(batch.requests)
        rows = len(batch.prompts)
        for i, req in enumerate(batch.requests):
            req.result = out[i, batch.pads[i]:]
            req.stats = dataclasses.replace(
                stats,
                tokens_generated=batch.dcfg.gen_length,
                forward_equivalents=stats.forward_equivalents / real,
                wall_time=stats.wall_time / real,
                revocations=stats.revocations / real,
                skipped_forwards=stats.skipped_forwards / real,
                phase_counts={k: v / rows
                              for k, v in stats.phase_counts.items()},
                # per position, not pro-rated: the request's own row, its
                # pad columns cut so commit_step lines up with its result
                trace=stats.trace.slice_rows(i, batch.pads[i])
                if stats.trace is not None else None)
            req.finish_time = now
            self.done[req.rid] = req
        if self.on_batch_done is not None:
            self.on_batch_done(batch)
        return [r.rid for r in batch.requests]

    def step(self) -> List[int]:
        """Serve one batch from the queue.  Returns finished request ids."""
        self.reap_expired()
        batch = self.select_batch()
        if batch is None:
            return []
        return self.decode_batch(batch, self.on_block_committed)

    def run_until_idle(self) -> None:
        while self.queue:
            self.step()

    # -- metrics -----------------------------------------------------------
    def summary(self) -> Dict[str, float]:
        """Aggregate serving metrics over finished requests (the
        reference's ``summary``: per-request stats were pro-rated, so
        replica rows and pad columns inflate nothing; cancelled, expired
        and failed requests never count).  ``done`` may grow on the
        decode thread meanwhile, so it is snapshotted first."""
        reqs = [r for r in list(self.done.values()) if r.stats is not None]
        if not reqs:
            return {}
        lat = [r.latency for r in reqs]
        stats = [r.stats.as_dict() for r in reqs]
        toks = sum(s["tokens_generated"] for s in stats)
        fwds = sum(s["forward_equivalents"] for s in stats)
        decode_s = sum(s["wall_time_s"] for s in stats)
        span = max(r.finish_time for r in reqs) - \
            min(r.submit_time for r in reqs)
        return {"requests": len(reqs),
                "mean_latency_s": float(np.mean(lat)),
                "p95_latency_s": float(np.percentile(lat, 95)),
                "throughput_tps": toks / max(span, 1e-9),
                "decode_tps": toks / max(decode_s, 1e-9),
                "forward_equivalents": float(fwds),
                "revocations": float(sum(s["revocations"] for s in stats)),
                "skipped_forwards": float(sum(s["skipped_forwards"]
                                              for s in stats))}
