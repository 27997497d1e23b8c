"""The forward (noising) process of masked-diffusion LMs and the inference
start states (reference: ``src/repro/core/masking.py``).

LLaDA's training corruption (Eq. 4): a mask ratio t ~ U(eps, 1] per row,
then each maskable position becomes ``Mask`` iff its uniform draw u < t.
The draws come from an explicit ``torch.Generator``, so they cannot match
the reference's JAX PRNG bit for bit: the trainer takes the corruption
``(corrupted, masked, t)`` as an input of its step, and the tests inject
the reference's draws there.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig


def sample_mask_ratio(generator: torch.Generator, batch: int, device,
                      eps: float = 1e-3) -> torch.Tensor:
    """t ~ U(eps, 1] per row, f32 on ``device`` (the generator's, or meta
    for the dry-run's stand-ins, which a CPU generator draws)."""
    u = torch.rand(batch, generator=generator, device=device)
    return 1.0 - (1.0 - eps) * u


def apply_mask(generator: torch.Generator, tokens: torch.Tensor,
               t: torch.Tensor, cfg: ModelConfig,
               maskable: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Corrupt ``tokens`` (B, L): a position -> Mask iff u < t[b] and it
    is ``maskable`` (the answer region; prompts are never masked).
    Returns (corrupted tokens, mask indicator (B, L) bool)."""
    u = torch.rand(tokens.shape, generator=generator, device=tokens.device)
    masked = u < t[:, None]
    if maskable is not None:
        masked = masked & maskable
    corrupted = torch.where(masked, cfg.mask_token_id, tokens)
    return corrupted, masked


def fully_masked(cfg: ModelConfig, prompt: torch.Tensor,
                 gen_length: int) -> torch.Tensor:
    """[prompt | Mask × gen_length]."""
    tail = torch.full((prompt.shape[0], gen_length), cfg.mask_token_id,
                      dtype=prompt.dtype, device=prompt.device)
    return torch.cat([prompt, tail], dim=1)


def mask_positions(tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(B, L) bool: which positions are still masked."""
    return tokens == cfg.mask_token_id
