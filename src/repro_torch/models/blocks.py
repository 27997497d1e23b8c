"""Block assembly of the port (reference: ``src/repro/models/blocks.py``):

* dense:           norm → attention → norm → SwiGLU;
* hybrid (Hymba):  norm → [attention ∥ Mamba], fused mean → norm → SwiGLU;

with residuals.  The dense block also has the fixed-shape block cache's
two entry points (``block_capture``, ``block_cached``); a hybrid config
never reaches them, since the decoder refuses its cache policies first.
The other families (MoE, SSM/xLSTM, encoder-decoder,
VLM) raise ``NotImplementedError`` until their slice (ROADMAP.md queue 1
item 9).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.attention import (KVCache, attention_cached,
                                          attention_capture,
                                          attention_forward, init_attention)
from repro_torch.models.layers import (Params, Rope, apply_mlp, apply_norm,
                                       init_mlp, init_norm, rope_tables,
                                       rotary_dim)


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a block family not ported yet."""
    if cfg.arch_type not in ("dense", "hybrid") or cfg.is_moe \
            or cfg.is_encdec or not cfg.d_ff \
            or (cfg.arch_type == "hybrid" and cfg.ssm is None):
        raise NotImplementedError(
            f"{cfg.name!r} (arch_type={cfg.arch_type!r}): the port runs the "
            f"dense and hybrid blocks only so far (ROADMAP.md queue 1 "
            f"item 9)")


def init_block(gen: torch.Generator, cfg: ModelConfig, idx: int, device,
               dtype) -> Params:
    check_ported(cfg)
    p: Params = {"norm1": init_norm(cfg, device),
                 "attn": init_attention(gen, cfg, device, dtype),
                 "norm2": init_norm(cfg, device)}
    if cfg.arch_type == "hybrid":
        p["mamba"] = ssm_lib.init_mamba(gen, cfg, device, dtype)
        # learnable fusion of the two parallel head groups (f32, as the
        # reference keeps them)
        p["mix_attn"] = torch.ones(cfg.d_model, dtype=torch.float32,
                                   device=device)
        p["mix_ssm"] = torch.ones(cfg.d_model, dtype=torch.float32,
                                  device=device)
    p["mlp"] = init_mlp(gen, cfg, device, dtype)
    return p


def block_forward(p: Params, x: torch.Tensor, rope, cfg: ModelConfig,
                  idx: int) -> torch.Tensor:
    """x (B, L, d) -> x'.  ``rope``: the forward's ``Rope`` tables, or the
    (B, L) positions to build them from.  (The reference also returns an
    MoE aux loss, which is always zero for these blocks.)"""
    if isinstance(rope, torch.Tensor):
        rope = rope_tables(rope, rotary_dim(cfg, cfg.head_dim), cfg,
                           x.dtype)
    h = apply_norm(p["norm1"], x, cfg)
    attn_out = attention_forward(p["attn"], h, rope, cfg)
    if cfg.arch_type == "hybrid":
        ssm_out = ssm_lib.mamba_forward(p["mamba"], h, cfg)
        x = x + 0.5 * (attn_out * p["mix_attn"].to(x.dtype)
                       + ssm_out * p["mix_ssm"].to(x.dtype))
    else:
        x = x + attn_out
    h = apply_norm(p["norm2"], x, cfg)
    return x + apply_mlp(p["mlp"], h, cfg)


# --------------------------------------------------------------------------
# fixed-shape block cache (cache_policy = prefix | dual; dense blocks)
# --------------------------------------------------------------------------

def _check_dense(cfg: ModelConfig) -> None:
    if cfg.arch_type != "dense":
        raise ValueError(
            f"{cfg.name!r} (arch_type={cfg.arch_type!r}): the block cache "
            f"needs an attention-only block")


def block_capture(p: Params, x: torch.Tensor, rope: Rope,
                  cfg: ModelConfig, idx: int
                  ) -> Tuple[torch.Tensor, KVCache]:
    """The full-sequence block that also returns this layer's K/V cache
    (prefill and block-boundary refresh)."""
    _check_dense(cfg)
    h = apply_norm(p["norm1"], x, cfg)
    attn_out, kv = attention_capture(p["attn"], h, rope, cfg)
    x = x + attn_out
    h = apply_norm(p["norm2"], x, cfg)
    return x + apply_mlp(p["mlp"], h, cfg), kv


def block_cached(p: Params, x: torch.Tensor, rope: Rope,
                 cfg: ModelConfig, idx: int, cache: KVCache,
                 win_start: int) -> torch.Tensor:
    """A W-row live window (B, W, d) against this layer's full-length
    cache; read-only with respect to the cache."""
    _check_dense(cfg)
    h = apply_norm(p["norm1"], x, cfg)
    x = x + attention_cached(p["attn"], h, rope, cfg, cache, win_start)
    h = apply_norm(p["norm2"], x, cfg)
    return x + apply_mlp(p["mlp"], h, cfg)
