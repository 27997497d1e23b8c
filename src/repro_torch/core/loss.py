"""Eq. 4 — the masked-diffusion training objective (reference:
``src/repro/core/loss.py``).

L(θ) = E_{x, t} [ 1/t · Σ_j 1[x_t^(j) = Mask] · (-log p_θ(x^(j) | x_t, q)) ]

divided by the batch's masked count (at least 1).  The 1/t weight uses
``max(t, 1e-3)``; log-probabilities are taken in f32.

Under an active mesh (``parallel.ctx``) both functions take this rank's
rows and, where the head is vocab-sharded, this rank's vocab slice of the
logits: the log-softmax takes its max and Σ exp over ``model``, the
target's logit comes from the shard that holds it, the argmax is global
(ties to the lower id, as ``argmax``), and the masked count is the whole
batch's (summed over ``data``).  Each data rank's loss and accuracy are
then its rows' shares, which sum to the whole batch's.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.parallel import ctx


def _count(masked: torch.Tensor) -> torch.Tensor:
    """The whole batch's masked count, at least 1."""
    return torch.clamp_min(ctx.sum_data(masked.sum()), 1)


def _target_nll(logits: torch.Tensor, targets: torch.Tensor,
                offset: int) -> torch.Tensor:
    """−log p(target) from this rank's vocab slice (from id ``offset``)."""
    z = logits.float()
    m = ctx.gather_model(z.detach().amax(-1)).amax(0)[..., None]
    lse = torch.log(ctx.sum_model(torch.exp(z - m).sum(-1))) + m[..., 0]
    local = targets.long() - offset
    inside = (local >= 0) & (local < z.shape[-1])
    zt = torch.gather(z, -1, local.clamp(0, z.shape[-1] - 1)[..., None])
    return lse - ctx.sum_model(torch.where(inside, zt[..., 0], 0.0))


def masked_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                         masked: torch.Tensor, t: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (B, L, V), targets (B, L) int, masked (B, L) bool, t (B,).

    Returns (scalar loss, per-example masked-token count)."""
    offset = ctx.vocab_offset(logits.shape[-1])
    if offset is None:
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    else:
        nll = _target_nll(logits, targets, offset)
    w = masked.float() / torch.clamp_min(t, 1e-3)[:, None]
    return torch.sum(nll * w) / _count(masked), masked.sum(dim=-1)


def token_accuracy(logits: torch.Tensor, targets: torch.Tensor,
                   masked: torch.Tensor) -> torch.Tensor:
    """Fraction of masked positions whose argmax equals the target."""
    offset = ctx.vocab_offset(logits.shape[-1])
    if offset is None:
        pred = torch.argmax(logits, dim=-1)
    else:
        z = logits.float()
        idx = torch.argmax(z, dim=-1)
        best = torch.gather(z, -1, idx[..., None])[..., 0]
        both = ctx.gather_model(torch.stack([best, (idx + offset).float()]))
        # the first rank holding the global max: the lowest id on ties
        first = (both[:, 0] == both[:, 0].amax(0)).float().argmax(0)
        pred = torch.gather(both[:, 1], 0, first[None])[0].long()
    hit = (pred == targets) & masked
    return hit.sum() / _count(masked)
