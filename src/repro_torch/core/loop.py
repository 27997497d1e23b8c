"""The block drivers of the port: one semi-AR block's denoising steps as an
eager loop (reference semantics: ``src/repro/core/loop.py:drive_block``),
uncached over the whole canvas or cached over the policy's live window
(``drive_cached_block``).

Per step the loop checks once on the host whether the block still has a
masked position, picks the step's commit width from the block's schedule
row (the index clamps to the last entry), and calls the strategy's step.
A block stops after at most ``block_size·4`` steps, the reference's
safety cap.  Forward-equivalents are summed as the steps return them,
each scaled by the window's share of the canvas, in the order the
reference's host driver sums them.  The device-resident driver (CUDA
graphs) is ROADMAP.md queue 1 item 5.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import DecodeConfig, ModelConfig
from repro_torch.core.strategies import Strategy


def run_block(strategy: Strategy, model_fn: Callable, cfg: ModelConfig,
              dcfg: DecodeConfig, sched: np.ndarray, x: torch.Tensor,
              rng: Optional[torch.Generator], in_block: torch.Tensor,
              carry=(), fwd: float = 0.0, fwd_scale: float = 1.0):
    """Decode the block marked by ``in_block`` (L,) bool over ``x``'s
    columns.  ``fwd`` is the running forward-equivalent count, advanced
    by each step's forwards times ``fwd_scale``.  Returns ``(x, carry,
    steps, fwd)``: the block's step count and the advanced count."""
    steps = 0
    last = len(sched) - 1
    for i in range(dcfg.block_size * 4):
        active = in_block[None, :] & (x == cfg.mask_token_id)
        if not bool(active.any()):
            break
        n = int(sched[min(i, last)])
        x, carry, fwd_n = strategy.step(rng, carry, x, active, model_fn,
                                        cfg, dcfg, n)
        steps += 1
        fwd += float(fwd_n) * fwd_scale
    return x, carry, steps, fwd


# --------------------------------------------------------------------------
# the cached path (cache_policy = prefix | dual)
# --------------------------------------------------------------------------

def window_geometry(dcfg: DecodeConfig, total: int
                    ) -> Tuple[int, Optional[int]]:
    """(window width, fixed window start or None) for a cache policy.

    ``prefix`` keeps the whole generation live: width ``gen_length`` at
    the fixed offset ``total - gen_length`` (only the prompt's K/V are
    frozen).  ``dual`` keeps only the active block live: width
    ``block_size`` at the block's own offset; prompt, committed blocks and
    the masked suffix come from the cache (the suffix's K/V go stale
    within a block, the documented approximation)."""
    if dcfg.cache_policy == "prefix":
        return dcfg.gen_length, total - dcfg.gen_length
    return dcfg.block_size, None


def carry_window(strategy: Strategy, carry, lo: int, width: int):
    """Slice a positional carry's per-column tensors to the live window
    ``[:, lo:lo+width]``, like the canvas.  The carry of a strategy
    without ``positional_carry`` passes through whole."""
    if not strategy.positional_carry:
        return carry
    pos, glob = carry
    return tuple(a[:, lo:lo + width] for a in pos), glob


def carry_unwindow(strategy: Strategy, carry_full, carry_win, lo: int):
    """Write a block's window carry back into new full-canvas positional
    tensors (the inverse of ``carry_window``)."""
    if not strategy.positional_carry:
        return carry_win
    pos_full, _ = carry_full
    pos_win, glob = carry_win
    return tuple(_write(f, w, lo) for f, w in zip(pos_full, pos_win)), glob


def _write(full: torch.Tensor, win: torch.Tensor, lo: int) -> torch.Tensor:
    """A new tensor: ``full`` with ``win`` at columns ``lo:``.  Never
    written in place: a canvas already handed out in a ``BlockEvent``
    must not change under its holder."""
    out = full.clone()
    out[:, lo:lo + win.shape[1]] = win
    return out


def run_cached_block(strategy: Strategy, cached_fn: Callable,
                     cfg: ModelConfig, dcfg: DecodeConfig, sched: np.ndarray,
                     x: torch.Tensor, rng: Optional[torch.Generator],
                     lo: int, state, carry=(), fwd: float = 0.0):
    """One block of cached decoding: slice the policy's live window out of
    the canvas, run ``run_block`` on it against the read-only cache
    ``state`` (``cached_fn(x_win, win_lo, state) -> logits``), and write
    the window back into a new canvas.  Forward-equivalents are scaled by
    ``window / total``.  Returns ``(x, carry, steps, fwd)``; refreshing
    ``state`` is the caller's business."""
    total = x.shape[1]
    win, fixed_lo = window_geometry(dcfg, total)
    win_lo = lo if fixed_lo is None else fixed_lo
    x_win = x[:, win_lo:win_lo + win]
    wpos = win_lo + torch.arange(win, device=x.device)
    in_block = (wpos >= lo) & (wpos < lo + dcfg.block_size)
    wcarry = carry_window(strategy, carry, win_lo, win)
    x_win, wcarry, steps, fwd = run_block(
        strategy, lambda w: cached_fn(w, win_lo, state), cfg, dcfg, sched,
        x_win, rng, in_block, wcarry, fwd, fwd_scale=win / total)
    return (_write(x, x_win, win_lo),
            carry_unwindow(strategy, carry, wcarry, win_lo), steps, fwd)
