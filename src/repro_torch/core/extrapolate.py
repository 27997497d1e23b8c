"""Confidence extrapolation / local determinism propagation,
``extrapolate`` (reference: ``src/repro/core/extrapolate.py``): the
strategy that skips model forwards.

Per canvas position the carry tracks ``ema`` (B, L) f32, the exponential
moving average of the max-probability (decay ``extrap_beta``), ``slope``
(B, L) f32, its last increment, ``cand`` (B, L) i32, the argmax of the
last forward, and ``nobs`` (B, L) i32, the observations; plus the count
of skipped forwards, ``skipped`` () f32.  A position is *ready* when it
has ``extrap_min_obs`` observations and ``ema + extrap_horizon·slope``
reaches ``extrap_tau`` on a slope that does not fall.  When every row can
fill its commit width from ready positions, the step commits the carried
candidates and runs no forward; otherwise it is ``probability``'s step
(one forward, the top-n by max-prob) plus the carry's update.

The skip is a branch on data.  ``step`` (the eager driver) takes it on
the host, so the card really skips the forward.  ``device_step`` (the
graph drivers) cannot: the card's PyTorch has no conditional-node
capture, so the forward runs in every replay and its commit is kept only
where the step does not skip (``graphs.run_masked``, as FDM-A's search).
Either way ``skipped_forwards`` counts the logical skips, so on the plain
path ``steps == forward_equivalents + skipped_forwards``; on the cached
path forwards are scaled by the window's share and skips are not.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import DecodeConfig, ModelConfig
from repro_torch.core.confidence import score_logits
from repro_torch.core.graphs import run_masked
from repro_torch.core.strategies import (NEG, ModelFn, Strategy, commit_topn,
                                         register_strategy)


class ExtrapolationStrategy(Strategy):
    """Confidence-trajectory extrapolation with forward skipping."""

    name = "extrapolate"
    positional_carry = True

    def init_carry(self, cfg: ModelConfig, dcfg: DecodeConfig, device):
        raise TypeError(
            "strategy 'extrapolate' carries per-decode positional state; "
            "it needs the canvas shape — decode through Decoder (which "
            "calls init_carry_shaped), not the deprecated carry-less "
            "entry points")

    def init_carry_shaped(self, cfg: ModelConfig, dcfg: DecodeConfig,
                          batch: int, length: int, device):
        def zeros(dtype):
            return torch.zeros((batch, length), dtype=dtype, device=device)
        pos = (zeros(torch.float32), zeros(torch.float32),     # ema, slope
               zeros(torch.int32), zeros(torch.int32))         # cand, nobs
        return pos, (torch.zeros((), device=device),)          # skipped

    def carry_stats(self, carry) -> Dict[str, float]:
        _, (skipped,) = carry
        return {"skipped_forwards": float(skipped)}

    def trace_confidence(self, carry, dcfg: DecodeConfig):
        """The trace's commit confidence: the extrapolated trajectory the
        commit decision used, from the post-step carry."""
        (ema, slope, _, _), _ = carry
        return ema + dcfg.extrap_horizon * slope

    def _plan(self, carry, active, dcfg: DecodeConfig, n):
        """(ready, pred, skip): the positions that may commit from the
        carry, their extrapolated confidence, and whether every row can
        fill its width that way (0-dim bool)."""
        (ema, slope, _, nobs), _ = carry
        pred = ema + dcfg.extrap_horizon * slope
        ready = active & (pred >= dcfg.extrap_tau) & (slope >= 0.0) \
            & (nobs >= dcfg.extrap_min_obs)
        need = active.sum(-1, dtype=torch.int32).clamp(max=n)
        skip = (ready.sum(-1, dtype=torch.int32) >= need).all()
        return ready, pred, skip

    def _skip_commit(self, carry, x, ready, pred, n):
        """Commit the carried candidates of the top-n ready positions, no
        model call; the trajectories stay as they are."""
        pos, (skipped,) = carry
        return commit_topn(x, pred, pos[2], ready, n), \
            (pos, (skipped + 1.0,)), 0

    def _forward(self, carry, x, active, model_fn, cfg, dcfg, n):
        (ema, slope, cand, nobs), (skipped,) = carry
        s = score_logits(model_fn(x))
        # trajectories move wherever the forward scored a masked position:
        # the active block and the still-masked blocks after it
        masked = x == cfg.mask_token_id
        new_ema = torch.where(masked, dcfg.extrap_beta * ema
                              + (1.0 - dcfg.extrap_beta) * s.max_prob, ema)
        new_slope = torch.where(masked, new_ema - ema, slope)
        new_cand = torch.where(masked, s.argmax.to(cand.dtype), cand)
        new_nobs = torch.where(masked, nobs + 1, nobs)
        conf = torch.where(active, s.max_prob,
                           torch.full_like(s.max_prob, NEG))
        new_x = commit_topn(x, conf, s.argmax, active, n)
        return new_x, ((new_ema, new_slope, new_cand, new_nobs),
                       (skipped,)), 1

    def step(self, rng, carry, x, active, model_fn: ModelFn,
             cfg: ModelConfig, dcfg: DecodeConfig, n) -> Tuple:
        ready, pred, skip = self._plan(carry, active, dcfg, n)
        if bool(skip):                         # the host's early-out
            return self._skip_commit(carry, x, ready, pred, n)
        return self._forward(carry, x, active, model_fn, cfg, dcfg, n)

    def device_step(self, rng, carry, x, active, model_fn: ModelFn,
                    cfg: ModelConfig, dcfg: DecodeConfig, n) -> Tuple:
        """``step`` without the host check: the skip's commit, unless the
        step does not skip (``run_masked``), where the forward's commit,
        carry and count replace it.  The carry's tensors are copied, since
        ``run_masked`` writes into its outputs."""
        ready, pred, skip = self._plan(carry, active, dcfg, n)
        new_x, new_carry, _ = self._skip_commit(carry, x, ready, pred, n)
        pos, glob = new_carry
        out = (new_x, (tuple(t.clone() for t in pos), glob),
               torch.zeros((), device=x.device))

        def forward():
            fx, fcarry, fwd = self._forward(carry, x, active, model_fn, cfg,
                                            dcfg, n)
            return fx, fcarry, torch.full_like(out[2], fwd)

        run_masked(~skip, forward, out)
        return out


register_strategy(ExtrapolationStrategy())
