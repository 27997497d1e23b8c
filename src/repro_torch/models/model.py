"""The diffusion LM of the port (reference: ``src/repro/models/model.py``).

Parameters are a plain dict of tensors, held per layer: ``{"embed":
{"tok", "head"}, "norm_f": {"scale"}, "blocks": [layer dict, ...]}`` —
the reference's tree with its stacked layer axis unstacked into a list
(``repro_torch.convert`` bridges the two).  PyTorch runs eagerly, so the
layers are a Python loop.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import blocks as blocks_lib
from repro_torch.models.layers import (Params, apply_norm, compute_dtype,
                                       embed_tokens, init_embed, init_norm,
                                       lm_head)


def init_model(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
               device="cuda", dtype: Optional[torch.dtype] = None) -> Params:
    """Seeded random weights, made directly on ``device`` in ``dtype``
    (default: the config's compute dtype; norm scales and the Mamba
    head's a_log, dt_bias and mix scales stay f32, as the reference's).
    ``generator`` must live on ``device``; ``None`` seeds one with 0."""
    dev = resolve_device(device)
    dt = dtype or compute_dtype(cfg)
    blocks_lib.check_ported(cfg)
    gen = generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(0)
    params: Params = {"embed": init_embed(gen, cfg, dev, dt),
                      "norm_f": init_norm(cfg, dev)}
    params["blocks"] = [blocks_lib.init_block(gen, cfg, i, dev, dt)
                        for i in range(cfg.num_layers)]
    return params


def make_positions(cfg: ModelConfig, batch: int, length: int,
                   offset: int = 0, device="cuda") -> torch.Tensor:
    """(B, L) int32 position ids (standard RoPE)."""
    pos = offset + torch.arange(length, dtype=torch.int32, device=device)
    return pos[None].expand(batch, length)


def forward(params: Params, tokens: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """tokens (B, L) -> logits (B, L, V) float32.  Bidirectional: every
    position is scored."""
    b, l = tokens.shape
    x = embed_tokens(params["embed"], tokens, cfg)
    positions = make_positions(cfg, b, l, device=tokens.device)
    for i, p in enumerate(params["blocks"]):
        x = blocks_lib.block_forward(p, x, positions, cfg, i)
    x = apply_norm(params["norm_f"], x, cfg)
    return lm_head(params["embed"], x, cfg)
