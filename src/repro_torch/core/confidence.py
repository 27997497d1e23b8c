"""Confidence scoring (reference: ``src/repro/core/confidence.py``).

Local confidence (Eq. 11) per masked position — max probability, top-2
margin, negative entropy — and global confidence (Eq. 10), the foreseeing
term: the negative total predictive entropy of a hypothetical next state.
Both come from one reduction of the logits over the vocab, served by the
confidence kernel (``kernels.confidence``) on a card and by its plain
version on the CPU.

Under a tensor-parallel mesh whose head is vocab-sharded, each rank holds
a vocab slice of the logits (``parallel.ctx.vocab_offset``), and
``score_logits`` takes ``score_logits_sharded``: the kernel's per-shard
partials, one gather over ``model`` and a merge of ``tp × rows`` values,
so every rank holds the same four scores of the whole row.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.confidence import (Partials, confidence_fused,
                                           confidence_partials)
from repro_torch.parallel import ctx


class Scores(NamedTuple):
    """Per-position decode scores, each (B, L)."""
    argmax: torch.Tensor       # int32 — candidate token per position
    max_prob: torch.Tensor     # p(argmax)
    margin: torch.Tensor       # p(top1) - p(top2)
    neg_entropy: torch.Tensor  # Σ_v p log p  (≤ 0)


def score_logits(logits: torch.Tensor) -> Scores:
    """One pass over the vocab axis -> all four per-position scores; for
    a vocab slice under a mesh, ``score_logits_sharded``."""
    offset = ctx.vocab_offset(logits.shape[-1])
    if offset is not None:
        return score_logits_sharded(logits, offset)
    return Scores(*confidence_fused(logits.contiguous()))


def merge_partials(p: Partials) -> Scores:
    """The four scores of whole rows from their shards' ``Partials``, each
    (tp, ...) in vocab order (reference: ``score_logits_sharded``'s
    reductions, here over shards): the global max M, the argmax the lowest
    global index at M, M2 = M where the max occurs twice (in one shard, or
    in two), s and u rescaled by exp(m_r − M)."""
    big = torch.iinfo(torch.int32).max
    mx = p.m.max(dim=0).values
    at = p.m == mx
    argmax = torch.where(at, p.i1, big).min(dim=0).values
    m2 = torch.where(at, p.m2, p.m).max(dim=0).values
    m2 = torch.where(at.sum(0) > 1, mx, m2)
    scale = torch.exp(p.m - mx)
    s = (p.s * scale).sum(0)
    u = (p.u * scale).sum(0)
    inv_s = 1.0 / s
    return Scores(argmax=argmax.to(torch.int32), max_prob=inv_s,
                  margin=inv_s - torch.exp(m2 - mx) * inv_s,
                  neg_entropy=u * inv_s - (mx + torch.log(s)))


def score_logits_sharded(logits: torch.Tensor, vocab_offset: int) -> Scores:
    """Scores of rows whose vocab is split across the ``model`` ranks
    (``logits``: this rank's slice, its first id ``vocab_offset``): the
    partials kernel, one gather of 5 × rows values a rank, the merge."""
    part = confidence_partials(logits.contiguous(), vocab_offset)
    packed = torch.stack([part.m, part.s, part.u, part.m2,
                          part.i1.float()])
    g = ctx.gather_model(packed)                        # (tp, 5, ...)
    return merge_partials(Partials(g[:, 0], g[:, 1], g[:, 2], g[:, 3],
                                   g[:, 4].to(torch.int32)))


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
