"""Block assembly of the port (reference: ``src/repro/models/blocks.py``):
the dense bidirectional block, norm → attention → norm → SwiGLU, with
residuals.  The other families (MoE, SSM, hybrid, encoder-decoder) raise
``NotImplementedError`` until their slice (ROADMAP.md queue 1 item 9).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import attention_forward, init_attention
from repro_torch.models.layers import (Params, apply_mlp, apply_norm,
                                       init_mlp, init_norm)


def check_dense(cfg: ModelConfig) -> None:
    if cfg.arch_type != "dense" or cfg.is_moe or cfg.is_encdec \
            or not cfg.d_ff:
        raise NotImplementedError(
            f"{cfg.name!r} (arch_type={cfg.arch_type!r}): the port runs the "
            f"dense block only so far (ROADMAP.md queue 1 item 9)")


def init_block(gen: torch.Generator, cfg: ModelConfig, idx: int, device,
               dtype) -> Params:
    check_dense(cfg)
    return {"norm1": init_norm(cfg, device),
            "attn": init_attention(gen, cfg, device, dtype),
            "norm2": init_norm(cfg, device),
            "mlp": init_mlp(gen, cfg, device, dtype)}


def block_forward(p: Params, x: torch.Tensor, positions: torch.Tensor,
                  cfg: ModelConfig, idx: int) -> torch.Tensor:
    """x (B, L, d) -> x'.  (The reference also returns an MoE aux loss,
    which is always zero for a dense block.)"""
    h = apply_norm(p["norm1"], x, cfg)
    x = x + attention_forward(p["attn"], h, positions, cfg)
    h = apply_norm(p["norm2"], x, cfg)
    return x + apply_mlp(p["mlp"], h, cfg)
