"""FDM — the Foreseeing Decoding Method, Algorithm 1 (reference:
``src/repro/core/fdm.py``, whose docstring states the n > 1
generalisation used by FDM-A's balance phase).

Per step: score every masked position; prune candidates with p ≤ γ; the
top-K survivors by C_local form Λ; commit each λ ∈ Λ into a hypothetical
next state and score all K states in ONE batched forward (candidates
folded into the batch axis, candidate-major); commit the candidate that
maximises C_local + C_global (Eq. 15), or fall back to the local top-n
commit when Λ is empty.  C_global's per-position entropies come from the
confidence kernel over the K·B·L candidate rows.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import DecodeConfig, ModelConfig
from repro_torch.core.confidence import global_confidence, score_logits
from repro_torch.core.strategies import (NEG, ModelFn, StatelessStrategy,
                                         commit_topn, rank_desc,
                                         register_strategy)


def _per_row(v, b: int, dtype, device) -> torch.Tensor:
    """A scalar or (B,) tensor as a (B,) tensor, without a host-to-device
    copy (which would synchronise the stream)."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype).expand(b)
    return torch.full((b,), v, dtype=dtype, device=device)


def fdm_select(x: torch.Tensor, logits: torch.Tensor, active: torch.Tensor,
               model_fn: ModelFn, cfg: ModelConfig, k: int,
               gamma, n) -> Tuple[torch.Tensor, int]:
    """The FDM search core; gamma/n are scalars or (B,) tensors.
    Returns (new_x, extra_forward_count)."""
    b, l = x.shape
    dev = x.device
    s = score_logits(logits)
    gamma_arr = _per_row(gamma, b, torch.float32, dev)
    n_arr = _per_row(n, b, torch.int32, dev)
    argmax = s.argmax.to(x.dtype)

    c_local_log = torch.log(torch.clamp(s.max_prob, min=1e-30))   # Eq. 11

    eligible = active & (s.max_prob > gamma_arr[:, None])
    conf_el = torch.where(eligible, s.max_prob,
                          torch.full_like(s.max_prob, NEG))
    ranks_el = rank_desc(conf_el)
    first = (n_arr - 1)[:, None]
    safe = eligible & (ranks_el < first)
    contender = eligible & (ranks_el >= first) & (ranks_el < first + k)
    has_search = contender.any(dim=-1)                        # Λ ≠ ∅ per ex.

    x_safe = torch.where(safe, argmax, x)

    # the K hypothetical next states: contender slot j committed on top of
    # the safe set
    slot = ranks_el - first
    sel_k = contender[None] & (slot[None] == torch.arange(
        k, device=dev)[:, None, None])                        # (K, B, L)
    xc = torch.where(sel_k, argmax[None], x_safe[None])       # (K, B, L)
    valid = sel_k.any(dim=-1)                                 # (K, B)

    # ONE batched foreseeing forward over all K candidates
    logits_c = model_fn(xc.reshape(k * b, l)).reshape(k, b, l, -1)
    still_masked = xc == cfg.mask_token_id
    c_glob = global_confidence(logits_c, still_masked)        # (K, B)
    c_loc = torch.sum(torch.where(sel_k, c_local_log[None],
                                  torch.zeros_like(c_local_log[None])),
                      dim=-1)
    total = torch.where(valid, c_loc + c_glob,
                        torch.full_like(c_glob, NEG))         # Eq. 15
    winner = torch.argmax(total, dim=0)                       # first max

    win_commit = torch.gather(
        sel_k, 0, winner[None, :, None].expand(1, b, l))[0]   # (B, L)
    x_search = torch.where(win_commit, argmax, x_safe)

    # Λ = ∅ fallback: pure local top-n commit (no γ filter)
    x_local = commit_topn(x, s.max_prob, argmax, active, n_arr)
    new_x = torch.where(has_search[:, None], x_search, x_local)
    return new_x, k


def fdm_step(rng, x, active, model_fn: ModelFn, cfg: ModelConfig,
             dcfg: DecodeConfig, n) -> Tuple[torch.Tensor, int]:
    """Algorithm 1 with the paper defaults: n=1 token per step."""
    new_x, extra = fdm_select(x, model_fn(x), active, model_fn, cfg,
                              k=dcfg.k, gamma=dcfg.gamma, n=1)
    return new_x, 1 + extra


register_strategy(StatelessStrategy("fdm", fdm_step))
