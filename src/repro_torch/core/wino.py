"""WINO revocation, ``wino_r`` (reference: ``src/repro/core/wino.py``):
the stateless ``wino`` baseline's verify pass moved to the next step's
forward, with the pending set in the strategy carry.

* **wide-in** — every active position above τ₁ (``wino_tau1``), plus the
  schedule's top-``n``, commits and is flagged *pending*;
* **narrow-out** — the next step's one forward re-scores the pending
  tokens in their new context: the f32 log-softmax over the vocab,
  gathered at the committed token (plain PyTorch, as the reference's
  jnp; no confidence-kernel reduction gives it).  A pending token below
  ``wino_revoke_tau`` is re-masked, the lowest re-scores first, at most
  the row's remaining budget (a rank, not a host loop).

One forward per step.  A step's net commits may be negative, so a block
can run past its schedule row: ``Decoder._geometry`` pads the row with its
final width, and the drivers' ``block_size·4`` cap and the budget bound
the overrun.  ``begin_block`` clears the pending set, so a block already
handed out is never re-opened.

The carry is positional: ``((pending (B, L) bool,), (budget (B,) i32,
revoked () i32))``.  The step is tensor math with no sync, so the graph
drivers run it as it is (``Strategy.device_step``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import DecodeConfig, ModelConfig
from repro_torch.core.confidence import score_logits
from repro_torch.core.strategies import (NEG, ModelFn, Strategy, rank_desc,
                                         register_strategy)


class WINORevocationStrategy(Strategy):
    """WINO-style commit-then-revoke with the pending set in the carry."""

    name = "wino_r"
    positional_carry = True
    trace_confidence_tap = True    # one unconditional full-canvas forward

    def init_carry(self, cfg: ModelConfig, dcfg: DecodeConfig, device):
        raise TypeError(
            "strategy 'wino_r' carries per-decode positional state; it "
            "needs the canvas shape — decode through Decoder (which calls "
            "init_carry_shaped), not the deprecated carry-less entry "
            "points")

    def init_carry_shaped(self, cfg: ModelConfig, dcfg: DecodeConfig,
                          batch: int, length: int, device):
        pending = torch.zeros((batch, length), dtype=torch.bool,
                              device=device)
        budget = torch.full((batch,), dcfg.wino_revoke_budget,
                            dtype=torch.int32, device=device)
        revoked = torch.zeros((), dtype=torch.int32, device=device)
        return (pending,), (budget, revoked)

    def begin_block(self, carry, x, in_block):
        # a block already handed out keeps its last-step commits
        (pending,), glob = carry
        return (torch.zeros_like(pending),), glob

    def carry_stats(self, carry) -> Dict[str, float]:
        _, (_, revoked) = carry
        return {"revocations": float(revoked)}

    def step(self, rng, carry, x, active, model_fn: ModelFn,
             cfg: ModelConfig, dcfg: DecodeConfig, n) -> Tuple:
        (pending,), (budget, revoked) = carry
        logits = model_fn(x)
        s = score_logits(logits)

        # narrow-out: verify the pending commits under the fresh forward
        logp = torch.log_softmax(logits.float(), dim=-1)
        p_tok = torch.exp(torch.gather(logp, -1, x[..., None].long())[..., 0])
        fail = pending & (p_tok < dcfg.wino_revoke_tau)
        # the budget cap: the lowest re-scores first
        fail_rank = rank_desc(torch.where(fail, -p_tok,
                                          torch.full_like(p_tok, NEG)))
        revoke = fail & (fail_rank < budget[:, None])
        x = torch.where(revoke, torch.full_like(x, cfg.mask_token_id), x)
        budget = budget - revoke.sum(-1, dtype=torch.int32)
        revoked = revoked + revoke.sum(dtype=torch.int32)

        # wide-in: τ₁ overflow plus the schedule's top-n; a position just
        # revoked is not in ``active`` and re-decodes on a later step
        conf = torch.where(active, s.max_prob,
                           torch.full_like(s.max_prob, NEG))
        commit = active & ((s.max_prob > dcfg.wino_tau1)
                           | (rank_desc(conf) < n))
        x = torch.where(commit, s.argmax.to(x.dtype), x)
        # every earlier pending position was verified or revoked: the new
        # pending set is this step's commits
        return x, ((commit,), (budget, revoked)), 1


register_strategy(WINORevocationStrategy())
