"""The block driver of the port: one semi-AR block's denoising steps as an
eager loop (reference semantics: ``src/repro/core/loop.py:drive_block``).

Per step the loop checks once on the host whether the block still has a
masked position, picks the step's commit width from the block's schedule
row (the index clamps to the last entry), and calls the strategy's step.
A block stops after at most ``block_size·4`` steps, the reference's
safety cap.  Forward-equivalents are counted as the steps return them.
The device-resident driver (CUDA graphs) is ROADMAP.md queue 1 item 5.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import DecodeConfig, ModelConfig
from repro_torch.core.strategies import Strategy


def run_block(strategy: Strategy, model_fn: Callable, cfg: ModelConfig,
              dcfg: DecodeConfig, sched: np.ndarray, x: torch.Tensor,
              rng: Optional[torch.Generator], in_block: torch.Tensor,
              carry=()):
    """Decode the block marked by ``in_block`` (L,) bool over ``x``'s
    columns.  Returns ``(x, carry, steps, forward_equivalents)`` for the
    block."""
    steps, fwd = 0, 0.0
    last = len(sched) - 1
    for i in range(dcfg.block_size * 4):
        active = in_block[None, :] & (x == cfg.mask_token_id)
        if not bool(active.any()):
            break
        n = int(sched[min(i, last)])
        x, carry, fwd_n = strategy.step(rng, carry, x, active, model_fn,
                                        cfg, dcfg, n)
        steps += 1
        fwd += float(fwd_n)
    return x, carry, steps, fwd
