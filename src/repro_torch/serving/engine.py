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
never share a batch.  Every committed block passes the output validator;
``on_cache_refresh(requests, block_index, t_start_s, t_end_s)``, when
set, observes each KV-cache capture of a cached batch.

The async scheduler, router, HTTP server, supervisor and fault injector
are ROADMAP.md queue 1 item 8.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import DecodeConfig, ModelConfig
from repro_torch.core.decoder import (Decoder, SampleStats, check_kernel_flag,
                                      check_supported)
from repro_torch.core.strategies import resolve_strategy
from repro_torch.device import resolve_device


class CorruptOutputError(RuntimeError):
    """The output validator found committed tokens outside the vocabulary
    — the downstream signature of NaN/inf logits."""


def validate_block_tokens(tokens: np.ndarray, vocab_size: int) -> None:
    """Every committed token must be a valid vocabulary id (a copy of the
    reference's ``serving/faults.py:validate_block_tokens``)."""
    if tokens.size and ((tokens < 0) | (tokens >= vocab_size)).any():
        bad = tokens[(tokens < 0) | (tokens >= vocab_size)]
        raise CorruptOutputError(
            f"committed block contains {bad.size} out-of-vocab token(s) "
            f"(e.g. {int(bad.flat[0])}); non-finite logits upstream?")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (Lp,) int
    result: Optional[np.ndarray] = None
    stats: Optional[SampleStats] = None
    submit_time: float = 0.0
    finish_time: float = 0.0
    dcfg: Optional[DecodeConfig] = None   # effective per-request config
    pad_cols: int = 0                     # mask pad columns this request got

    @property
    def latency(self) -> float:
        return self.finish_time - self.submit_time

    @property
    def status(self) -> str:
        return "done" if self.result is not None else "queued"


@dataclasses.dataclass
class Batch:
    """One schedulable unit: same effective DecodeConfig, same length
    bucket, padded to fixed shape."""
    requests: List[Request]
    prompts: np.ndarray                # (max_batch, Lp) — replicas included
    pads: List[int]                    # per-request mask pad columns
    dcfg: DecodeConfig
    rng: torch.Generator


class ServingEngine:
    def __init__(self, params, cfg: ModelConfig, dcfg: DecodeConfig,
                 max_batch: int = 8, seed: int = 0,
                 length_bucket: int = 8,
                 on_block_committed: Optional[Callable] = None,
                 device="cuda"):
        self.params = params
        self.cfg = cfg
        self.dcfg = dcfg
        self.device = resolve_device(device)
        check_supported(cfg, dcfg)
        check_kernel_flag(dcfg, self.device)
        self.max_batch = max_batch
        self.length_bucket = max(length_bucket, 1)
        self.on_block_committed = on_block_committed
        self.on_cache_refresh: Optional[Callable] = None
        self.queue: Deque[Request] = deque()
        self.done: Dict[int, Request] = {}
        self._next_id = 0
        self._seeds = np.random.SeedSequence(seed)

    # -- client API --------------------------------------------------------
    def submit(self, prompt: np.ndarray, *,
               strategy: Optional[str] = None,
               steps: Optional[int] = None,
               gen_length: Optional[int] = None,
               block_size: Optional[int] = None,
               cache_policy: Optional[str] = None,
               trace: Optional[bool] = None) -> int:
        """Queue a prompt; returns the request id.  The overrides build the
        request's effective ``DecodeConfig``, validated HERE: an unknown
        strategy raises ``KeyError``, a bad geometry or a cache policy the
        model can never serve ``ValueError``, and an option the port does
        not run yet ``NotImplementedError``."""
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
        self.queue.append(Request(rid=rid, prompt=prompt,
                                  submit_time=time.perf_counter(),
                                  dcfg=dcfg))
        return rid

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
        return (self._bucket_len(req.prompt.shape[0]), req.dcfg)

    def select_batch(self) -> Optional[Batch]:
        """Pop one batch from the queue (no decoding): the group holding
        the oldest request, up to ``max_batch``, FIFO within the group."""
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
        rng = torch.Generator(device=self.device).manual_seed(seed)
        return Batch(requests=batch, prompts=prompts, pads=pads,
                     dcfg=batch[0].dcfg or self.dcfg, rng=rng)

    def decode_batch(self, batch: Batch,
                     on_block_committed: Optional[Callable] = None
                     ) -> List[int]:
        """Decode one selected batch to completion.  Every committed block
        passes ``validate_block_tokens``; ``on_block_committed(requests,
        block_index, lo, hi, x)`` observes it.  Returns finished rids."""
        dec = Decoder(self.params, self.cfg, batch.dcfg, device=self.device)
        if self.on_cache_refresh is not None:
            dec.on_cache_refresh = (
                lambda blk, t0, t1, _reqs=batch.requests:
                self.on_cache_refresh(_reqs, blk, t0, t1))
        blocks = dec.generate_blocks(batch.rng, batch.prompts)
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

    def _finish_batch(self, batch: Batch, out: torch.Tensor,
                      stats: SampleStats) -> List[int]:
        """Per-request results and stats.  Each request gets its share of
        the batch's work — forwards, wall time and carry counters divided
        across the real (non-replica) members; ``steps`` stays the batch's
        (decode is batch-synchronous); phase counts are normalised by the
        padded row count (one flag per row per step), so they still sum to
        ``steps`` per request."""
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
                              for k, v in stats.phase_counts.items()})
            req.finish_time = now
            self.done[req.rid] = req
        return [r.rid for r in batch.requests]

    def step(self) -> List[int]:
        """Serve one batch from the queue.  Returns finished request ids."""
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
        replica rows and pad columns inflate nothing)."""
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
