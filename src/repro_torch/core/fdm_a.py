"""FDM-A — Acceleration with the Foreseeing Decoding Method, Algorithm 2
(reference: ``src/repro/core/fdm_a.py``).

Each example picks its phase from the max-probability profile of its
masked positions: exploration (nothing above η₁: one token, full FDM
search), acceleration (≥ N above η₁: commit min(NUM, N) locally),
balance (qualified and borderline coexist: search over γ=η₂ survivors),
or local-only (qualified, no borderline).  The K-candidate forward runs
once for the batch when any example searches and is skipped entirely when
none does: one host check in ``step``.  ``device_step``, the graph
drivers' form, cannot branch on the host: on the card it runs the search
every step and keeps its result only where any example searches (the
reference's ``lax.cond`` as a select, ``graphs.run_masked``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import DecodeConfig, ModelConfig
from repro_torch.core.confidence import score_logits
from repro_torch.core.fdm import fdm_select
from repro_torch.core.graphs import run_masked
from repro_torch.core.strategies import (ModelFn, Strategy, commit_topn,
                                         register_strategy)

PHASES = ("explore", "accel", "local_only", "balance")


def fdm_a_plan(logits: torch.Tensor, active: torch.Tensor,
               dcfg: DecodeConfig):
    """Vectorised phase decision.  Returns (scores, n, gamma, need_search,
    (explore, accel, local_only, balance)), each (B,)."""
    s = score_logits(logits)
    p = torch.where(active, s.max_prob, torch.zeros_like(s.max_prob))
    qualified = p > dcfg.eta1
    borderline = (p > dcfg.eta2) & ~qualified
    q_cnt = qualified.sum(dim=-1)
    b_cnt = borderline.sum(dim=-1)
    explore = q_cnt == 0
    accel = q_cnt >= dcfg.n_max
    local_only = ~explore & ~accel & (b_cnt == 0)
    balance = ~explore & ~accel & (b_cnt > 0)
    n = torch.where(explore, torch.ones_like(q_cnt),
                    torch.clamp(q_cnt, max=dcfg.n_max)).to(torch.int32)
    gamma = torch.where(explore, torch.full_like(p[:, 0], dcfg.gamma1),
                        torch.full_like(p[:, 0], dcfg.eta2))
    need_search = explore | balance
    return s, n, gamma, need_search, (explore, accel, local_only, balance)


class FDMAStrategy(Strategy):
    """Algorithm 2 as a registered ``Strategy``.  The carry is a ``(4,)``
    int32 per-phase counter on the canvas's device: each step adds how
    many batch rows landed in each phase, read back once at the end."""

    name = "fdm_a"
    # the scoring forward is unconditional and full-canvas (the search's
    # forward has K·B rows, which the tracing adapter's tap skips)
    trace_confidence_tap = True

    def init_carry(self, cfg: ModelConfig, dcfg: DecodeConfig, device):
        return torch.zeros(4, dtype=torch.int32, device=device)

    def phase_counts(self, carry) -> Dict[str, int]:
        return {k: int(v) for k, v in zip(PHASES, carry.tolist())}

    def trace_phase(self, carry_before, carry_after):
        """The step's phase for the trace: the argmax of the step's
        increment of the phase histogram, the batch's dominant phase
        (exact at batch 1; the first on a tie)."""
        return torch.argmax(carry_after - carry_before).to(torch.int32)

    def _plan(self, carry, x, active, model_fn: ModelFn,
              dcfg: DecodeConfig):
        logits = model_fn(x)
        s, nn, gamma, need_search, phases = fdm_a_plan(logits, active, dcfg)
        carry = carry + torch.stack([p.sum() for p in phases]).to(
            torch.int32)
        x_local = commit_topn(x, s.max_prob, s.argmax, active, nn)
        return logits, nn, gamma, need_search, carry, x_local

    def step(self, rng, carry, x, active, model_fn: ModelFn,
             cfg: ModelConfig, dcfg: DecodeConfig, n) -> Tuple:
        logits, nn, gamma, need_search, carry, x_local = self._plan(
            carry, x, active, model_fn, dcfg)
        # early-out: skip the K-forward entirely if nobody searches
        if not bool(need_search.any()):
            return x_local, carry, 1
        x_search, extra = fdm_select(x, logits, active, model_fn, cfg,
                                     k=dcfg.k1, gamma=gamma, n=nn)
        new_x = torch.where(need_search[:, None], x_search, x_local)
        return new_x, carry, 1 + extra

    def device_step(self, rng, carry, x, active, model_fn: ModelFn,
                    cfg: ModelConfig, dcfg: DecodeConfig, n) -> Tuple:
        """``step`` without the host check: the K-candidate search's
        canvas and its count (1 + K₁, else 1) are kept where
        ``any(need_search)`` (``run_masked``)."""
        logits, nn, gamma, need_search, carry, x_local = self._plan(
            carry, x, active, model_fn, dcfg)
        fwd = torch.ones((), dtype=torch.float32, device=x.device)

        def search():
            x_search, extra = fdm_select(x, logits, active, model_fn, cfg,
                                         k=dcfg.k1, gamma=gamma, n=nn)
            return (torch.where(need_search[:, None], x_search, x_local),
                    torch.full_like(fwd, 1 + extra))

        run_masked(need_search.any(), search, (x_local, fwd))
        return x_local, carry, fwd


FDM_A = FDMAStrategy()
register_strategy(FDM_A)
