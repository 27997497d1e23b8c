"""On-device step telemetry: the traced strategy adapter and its host
read-back (reference: ``src/repro/core/tracebuffer.py``).

The graph drivers run a whole block with no host turn per step, so the
trace rides what already crosses every step: the strategy carry.
``TracingStrategy`` wraps any ``Strategy`` and widens its carry with
fixed-shape buffers written at a device pointer in ``step`` and
``device_step``, so every driver (eager, per-block and whole-request
graph, cached or not) records the same trace with no change of its own.
Per decode of ``S`` steps on a (B, L) canvas, ``cap = gen_length·4``
(every driver caps a block at ``block_size·4`` steps):

* positional half (column-aligned, windowed on the cached path):
  ``commit_step`` (B, L) i32, the step at which each position's surviving
  token committed (-1: prompt or never; a revoked position records its
  last commit), and ``commit_conf`` (B, L) f32, the strategy's confidence
  for it (NaN: no attribution);
* global half: per step ``commits``/``revocations`` (cap,) i32,
  ``skipped`` (cap,) bool (the step ran no forward), ``phase`` (cap,) i32
  (FDM-A's regime, -1 n/a), ``block`` (cap,) i32; the write pointer
  ``ptr`` (steps recorded, also the step index) and the block index
  ``blk`` (advanced by ``begin_block``).

Commits and revocations are a canvas diff against the mask token around
the inner step.  A strategy with ``trace_confidence_tap`` gets its first
full-canvas forward's logits re-scored (a second confidence launch per
step); one without gives ``trace_confidence`` from its carry, or NaN.
The writes at ``ptr`` never read it back (a 0-dim device index would
sync, which a captured step must not): each is a ``scatter`` at the
clamped pointer, masked to keep the old value once ``ptr`` reaches
``cap`` (the reference's ``mode="drop"``).

``DecodeTrace`` is the host-side view, made by ONE readback at the end
of the decode (``core/loop.py:_read``).  ``tracing(strategy)`` memoizes
the wrapper per inner strategy: the runner cache keys on the strategy's
identity, so a fresh wrapper per decode would build a run per decode.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import DecodeConfig, ModelConfig
from repro_torch.core.confidence import score_logits
from repro_torch.core.loop import read_tree
from repro_torch.core.strategies import Strategy


def trace_capacity(dcfg: DecodeConfig) -> int:
    """Steps a decode can take at most: ``block_size·4`` per block, over
    ``gen_length/block_size`` blocks."""
    return dcfg.gen_length * 4


@dataclasses.dataclass(frozen=True)
class DecodeTrace:
    """Host-side (numpy) view of one decode's trace.  Step arrays are cut
    to the recorded steps; ``commit_step``/``commit_conf`` keep the whole
    canvas (prompt columns -1/NaN)."""

    commit_step: np.ndarray    # (B, L) i32; -1 = never committed
    commit_conf: np.ndarray    # (B, L) f32; NaN = no attribution
    commits: np.ndarray        # (S,) i32 raw commits per step
    revocations: np.ndarray    # (S,) i32 re-masked per step
    skipped: np.ndarray        # (S,) bool: the step ran without a forward
    phase: np.ndarray          # (S,) i32 FDM-A regime; -1 = n/a
    block: np.ndarray          # (S,) i32 semi-AR block of each step

    @property
    def steps(self) -> int:
        return int(self.commits.shape[0])

    def commit_histogram(self) -> np.ndarray:
        """(steps,) FINAL commits per step: where each surviving token
        committed, so it sums to the committed positions
        (``tokens_generated`` for a finished decode), which the raw
        ``commits`` do not under revocation."""
        if self.steps == 0:
            return np.zeros((0,), np.int64)
        flat = self.commit_step[self.commit_step >= 0]
        return np.bincount(flat, minlength=self.steps)[: self.steps]

    def slice_rows(self, row: int, pad_cols: int = 0) -> "DecodeTrace":
        """Batch row ``row``'s view, its ``pad_cols`` left-padding columns
        cut off (serving); the step arrays are the batch's."""
        return dataclasses.replace(
            self,
            commit_step=self.commit_step[row:row + 1, pad_cols:],
            commit_conf=self.commit_conf[row:row + 1, pad_cols:])

    def summary(self) -> Dict[str, float]:
        conf = self.commit_conf[self.commit_step >= 0]
        finite = conf[np.isfinite(conf)]
        return {
            "steps": self.steps,
            "tokens_committed": int((self.commit_step >= 0).sum()),
            "revocations": int(self.revocations.sum()),
            "skipped_forwards": int(self.skipped.sum()),
            "mean_commit_conf": float(finite.mean()) if finite.size
            else float("nan"),
        }


def _put(buf: torch.Tensor, ptr: torch.Tensor, value) -> torch.Tensor:
    """A new ``buf`` with ``value`` at index ``ptr`` (0-dim int32 on the
    device), or ``buf`` unchanged where ``ptr`` is past its end; no read
    of ``ptr`` on the host."""
    idx = ptr.clamp(max=buf.shape[0] - 1).long().reshape(1)
    if isinstance(value, torch.Tensor):
        value = value.to(buf.dtype).reshape(1)
    else:       # a fill, not a host-to-device copy (which would sync)
        value = torch.full((1,), value, dtype=buf.dtype, device=buf.device)
    new = torch.where(ptr < buf.shape[0], value, buf.gather(0, idx))
    return buf.scatter(0, idx, new)


class TracingStrategy(Strategy):
    """Decodes exactly like ``inner`` while recording the trace in a
    widened carry::

        ((inner_pos, (commit_step, commit_conf)),
         (inner_glob, (commits, revocations, skipped, phase, block, ptr,
                       blk)))

    ``(inner_pos, inner_glob)`` is the inner carry's positional split
    (``((), carry)`` for a non-positional inner), so the cached path
    windows the inner positional tensors and the commit maps together."""

    positional_carry = True

    def __init__(self, inner: Strategy):
        if isinstance(inner, TracingStrategy):
            raise TypeError("refusing to double-wrap a TracingStrategy")
        self.inner = inner
        self.name = f"{inner.name}+trace"
        self.supports_fused = inner.supports_fused

    # -- carry plumbing ----------------------------------------------------
    def _split(self, inner_carry) -> Tuple:
        if self.inner.positional_carry:
            pos, glob = inner_carry
            return pos, glob
        return (), inner_carry

    def _join(self, pos, glob):
        return (pos, glob) if self.inner.positional_carry else glob

    def inner_carry(self, carry):
        (ipos, _), (iglob, _) = carry
        return self._join(ipos, iglob)

    def init_carry(self, cfg: ModelConfig, dcfg: DecodeConfig, device):
        raise TypeError(
            "a traced decode carries per-position state; decode through "
            "Decoder (which calls init_carry_shaped), not the deprecated "
            "carry-less entry points")

    def init_carry_shaped(self, cfg: ModelConfig, dcfg: DecodeConfig,
                          batch: int, length: int, device):
        inner0 = self.inner.init_carry_shaped(cfg, dcfg, batch, length,
                                              device)
        ipos, iglob = self._split(inner0)
        cap = trace_capacity(dcfg)

        def full(shape, value, dtype):
            return torch.full(shape, value, dtype=dtype, device=device)
        pos_t = (full((batch, length), -1, torch.int32),
                 full((batch, length), float("nan"), torch.float32))
        glob_t = (full((cap,), 0, torch.int32),          # commits
                  full((cap,), 0, torch.int32),          # revocations
                  full((cap,), False, torch.bool),       # skipped
                  full((cap,), -1, torch.int32),         # phase
                  full((cap,), 0, torch.int32),          # block
                  full((), 0, torch.int32),              # ptr (steps)
                  full((), -1, torch.int32))             # blk
        return (ipos, pos_t), (iglob, glob_t)

    def begin_block(self, carry, x, in_block):
        (ipos, pos_t), (iglob, glob_t) = carry
        inner_c = self.inner.begin_block(self._join(ipos, iglob), x,
                                         in_block)
        ipos, iglob = self._split(inner_c)
        glob_t = glob_t[:-1] + (glob_t[-1] + 1,)         # blk += 1
        return (ipos, pos_t), (iglob, glob_t)

    def phase_counts(self, carry) -> Dict[str, int]:
        return self.inner.phase_counts(self.inner_carry(carry))

    def carry_stats(self, carry) -> Dict[str, float]:
        return self.inner.carry_stats(self.inner_carry(carry))

    # -- the traced step ---------------------------------------------------
    def step(self, rng, carry, x, active, model_fn, cfg, dcfg, n):
        return self._run(self.inner.step, rng, carry, x, active, model_fn,
                         cfg, dcfg, n)

    def device_step(self, rng, carry, x, active, model_fn, cfg, dcfg, n):
        return self._run(self.inner.device_step, rng, carry, x, active,
                         model_fn, cfg, dcfg, n)

    def _run(self, step_fn, rng, carry, x, active, model_fn, cfg, dcfg, n):
        (ipos, (cstep, cconf)), (iglob, glob_t) = carry
        commits, revs, skips, phases, blocks, ptr, blk = glob_t
        inner_c = self._join(ipos, iglob)

        taps = []
        mf = model_fn
        if self.inner.trace_confidence_tap:
            def mf(t):
                logits = model_fn(t)
                # the first full-canvas call only (FDM's K-candidate
                # forward has K·B rows)
                if not taps and logits.shape[:2] == x.shape:
                    taps.append(logits)
                return logits

        new_x, new_inner, df = step_fn(rng, inner_c, x, active, mf, cfg,
                                       dcfg, n)

        mask = cfg.mask_token_id
        commit = (x == mask) & (new_x != mask)
        revoke = (x != mask) & (new_x == mask)
        if taps:
            conf = score_logits(taps[0]).max_prob.float()
        else:
            conf = self.inner.trace_confidence(new_inner, dcfg)
        nan = torch.full_like(cconf, float("nan"))
        conf_map = nan if conf is None else conf.float()
        cstep = torch.where(commit, ptr, torch.where(
            revoke, torch.full_like(cstep, -1), cstep))
        cconf = torch.where(commit, conf_map,
                            torch.where(revoke, nan, cconf))

        ph = self.inner.trace_phase(inner_c, new_inner)
        skipped = df == 0 if isinstance(df, torch.Tensor) else float(df) == 0
        glob_t = (_put(commits, ptr, commit.sum(dtype=torch.int32)),
                  _put(revs, ptr, revoke.sum(dtype=torch.int32)),
                  _put(skips, ptr, skipped),
                  _put(phases, ptr, -1 if ph is None else ph),
                  _put(blocks, ptr, blk),
                  ptr + 1, blk)
        ipos, iglob = self._split(new_inner)
        return new_x, ((ipos, (cstep, cconf)), (iglob, glob_t)), df

    # -- host read-back ----------------------------------------------------
    def extract(self, carry) -> DecodeTrace:
        """The final carry's trace, in ONE readback."""
        (_, (cstep, cconf)), (_, glob_t) = carry
        host = read_tree((cstep, cconf) + tuple(glob_t[:-1]))
        cstep, cconf, commits, revs, skips, phases, blocks, ptr = (
            t.numpy() for t in host)
        s = int(ptr)
        return DecodeTrace(
            commit_step=cstep, commit_conf=cconf, commits=commits[:s],
            revocations=revs[:s], skipped=skips[:s], phase=phases[:s],
            block=blocks[:s])


_TRACING: Dict[int, TracingStrategy] = {}


def tracing(strategy: Strategy) -> TracingStrategy:
    """One ``TracingStrategy`` per inner strategy, ever: the runner cache
    keys on the strategy's identity.  The wrapper holds ``inner``, so the
    keying ``id`` stays that strategy's."""
    if isinstance(strategy, TracingStrategy):
        return strategy
    wrapped = _TRACING.get(id(strategy))
    if wrapped is None or wrapped.inner is not strategy:
        wrapped = _TRACING[id(strategy)] = TracingStrategy(strategy)
    return wrapped
