"""Confidence scoring (reference: ``src/repro/core/confidence.py``).

Local confidence (Eq. 11) per masked position — max probability, top-2
margin, negative entropy — and global confidence (Eq. 10), the foreseeing
term: the negative total predictive entropy of a hypothetical next state.
Both come from one reduction of the logits over the vocab, served by the
confidence kernel (``kernels.confidence``) on a card and by its plain
version on the CPU.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.confidence import confidence_fused


class Scores(NamedTuple):
    """Per-position decode scores, each (B, L)."""
    argmax: torch.Tensor       # int32 — candidate token per position
    max_prob: torch.Tensor     # p(argmax)
    margin: torch.Tensor       # p(top1) - p(top2)
    neg_entropy: torch.Tensor  # Σ_v p log p  (≤ 0)


def score_logits(logits: torch.Tensor) -> Scores:
    """One pass over the vocab axis -> all four per-position scores."""
    return Scores(*confidence_fused(logits.contiguous()))


def local_confidence(scores: Scores, metric: str) -> torch.Tensor:
    """The heuristic ranking score (higher = more confident), (B, L)."""
    if metric == "probability":
        return scores.max_prob
    if metric == "margin":
        return scores.margin
    if metric == "entropy":
        return scores.neg_entropy
    raise ValueError(f"unknown local-confidence metric {metric!r}")


def global_confidence(logits: torch.Tensor,
                      still_masked: torch.Tensor) -> torch.Tensor:
    """Eq. 10 over a hypothetical next state's logits (…, L, V) with
    ``still_masked`` (…, L): Σ_j 1[masked] · Σ_v p log p, shape (…,).
    The per-position Σ p log p is the confidence kernel's ``neg_entropy``."""
    neg_ent = score_logits(logits).neg_entropy
    return torch.sum(neg_ent * still_masked.float(), dim=-1)
