"""Inference start states of masked-diffusion decoding (reference:
``src/repro/core/masking.py``; the training-time corruption comes with the
training slice)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig


def fully_masked(cfg: ModelConfig, prompt: torch.Tensor,
                 gen_length: int) -> torch.Tensor:
    """[prompt | Mask × gen_length]."""
    tail = torch.full((prompt.shape[0], gen_length), cfg.mask_token_id,
                      dtype=prompt.dtype, device=prompt.device)
    return torch.cat([prompt, tail], dim=1)


def mask_positions(tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(B, L) bool: which positions are still masked."""
    return tokens == cfg.mask_token_id
