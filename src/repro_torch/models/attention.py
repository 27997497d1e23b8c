"""Bidirectional GQA/MHA attention of the port (reference:
``src/repro/models/attention.py``).

The full-sequence path only: q/k/v projections, standard RoPE, and the
attention itself through ``kernels.flash_attention`` (the hand-written
kernel on a card, its plain version on the CPU) with GQA heads grouped
inside the kernel.  MLA, q/k norm and the KV-cache entry points raise
``NotImplementedError``: they arrive with later slices (ROADMAP.md).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import Params, apply_rope, dense_init


def init_attention(gen: torch.Generator, cfg: ModelConfig, device,
                   dtype) -> Params:
    _check_supported(cfg)
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    return {"wq": dense_init(gen, (d, nq * hd), device, dtype),
            "wk": dense_init(gen, (d, nkv * hd), device, dtype),
            "wv": dense_init(gen, (d, nkv * hd), device, dtype),
            "wo": dense_init(gen, (nq * hd, d), device, dtype)}


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.attention == "mla":
        raise NotImplementedError(
            "MLA attention is not ported yet (ROADMAP.md queue 1 item 9)")
    if cfg.qk_norm:
        raise NotImplementedError(
            "qk_norm is not ported yet (ROADMAP.md queue 1 item 9)")


def self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   window: int = 0) -> torch.Tensor:
    """q (B, L, H, hd), k/v (B, L, G, hd) -> (B, L, H, hd); scale hd^-½.
    The reference's ``self_attention``/``_sdpa`` pair, served by the flash
    kernel (which needs no q-chunking: it never builds the (L, L) scores)."""
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           window)


def _project_qkv(p: Params, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ModelConfig):
    dt = x.dtype
    b, l, _ = x.shape
    hd, nq, nkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    q = (x @ p["wq"].to(dt)).reshape(b, l, nq, hd)
    k = (x @ p["wk"].to(dt)).reshape(b, l, nkv, hd)
    v = (x @ p["wv"].to(dt)).reshape(b, l, nkv, hd)
    return apply_rope(q, positions, cfg), apply_rope(k, positions, cfg), v


def gqa_forward(p: Params, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """Full bidirectional attention over x (B, L, d)."""
    q, k, v = _project_qkv(p, x, positions, cfg)
    out = self_attention(q, k, v, window=cfg.sliding_window)
    return out.reshape(*x.shape[:2], -1) @ p["wo"].to(x.dtype)


def attention_forward(p: Params, x: torch.Tensor, positions: torch.Tensor,
                      cfg: ModelConfig) -> torch.Tensor:
    _check_supported(cfg)
    return gqa_forward(p, x, positions, cfg)


def _not_ported(name: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"{name} (the KV-cache path) is not ported yet: ROADMAP.md "
            f"queue 1 item 6")
    fn.__name__ = name
    return fn


gqa_capture = _not_ported("gqa_capture")
gqa_cached = _not_ported("gqa_cached")
attention_capture = _not_ported("attention_capture")
attention_cached = _not_ported("attention_cached")
