"""Eq. 4 — the masked-diffusion training objective (reference:
``src/repro/core/loss.py``).

L(θ) = E_{x, t} [ 1/t · Σ_j 1[x_t^(j) = Mask] · (-log p_θ(x^(j) | x_t, q)) ]

divided by the batch's masked count (at least 1).  The 1/t weight uses
``max(t, 1e-3)``; log-probabilities are taken in f32.
"""
from __future__ import annotations

from typing import Tuple

import torch


def masked_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                         masked: torch.Tensor, t: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (B, L, V), targets (B, L) int, masked (B, L) bool, t (B,).

    Returns (scalar loss, per-example masked-token count)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    w = masked.float() / torch.clamp_min(t, 1e-3)[:, None]
    count = torch.clamp_min(masked.sum(), 1)
    return torch.sum(nll * w) / count, masked.sum(dim=-1)


def token_accuracy(logits: torch.Tensor, targets: torch.Tensor,
                   masked: torch.Tensor) -> torch.Tensor:
    """Fraction of masked positions whose argmax equals the target."""
    hit = (torch.argmax(logits, dim=-1) == targets) & masked
    return hit.sum() / torch.clamp_min(masked.sum(), 1)
