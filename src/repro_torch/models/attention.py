"""Bidirectional GQA/MHA attention of the port (reference:
``src/repro/models/attention.py``).

q/k/v projections, Qwen3's per-head q/k RMSNorm (``qk_norm``), RoPE
(standard or half, from tables the model builds once per forward), and
the attention itself through
``kernels.flash_attention`` (the hand-written kernel on a card, its plain
version on the CPU) with GQA heads grouped inside the kernel: the
full-sequence path and the fixed-shape block cache's capture and cached
window; both cache paths go through ``_project_qkv``, so they norm q
and k as the full path does.  MLA raises ``NotImplementedError``: it
arrives with a later slice (ROADMAP.md queue 1 item 9).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import (Params, Rope, dense_init,
                                       rms_norm_headwise, rotate)


def init_attention(gen: torch.Generator, cfg: ModelConfig, device,
                   dtype) -> Params:
    _check_supported(cfg)
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    p = {"wq": dense_init(gen, (d, nq * hd), device, dtype),
         "wk": dense_init(gen, (d, nkv * hd), device, dtype),
         "wv": dense_init(gen, (d, nkv * hd), device, dtype),
         "wo": dense_init(gen, (nq * hd, d), device, dtype)}
    if cfg.qk_norm:                           # f32, as the reference's
        p["q_scale"] = torch.ones(hd, dtype=torch.float32, device=device)
        p["k_scale"] = torch.ones(hd, dtype=torch.float32, device=device)
    return p


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.attention == "mla":
        raise NotImplementedError(
            "MLA attention is not ported yet (ROADMAP.md queue 1 item 9)")


def self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   window: int = 0) -> torch.Tensor:
    """q (B, L, H, hd), k/v (B, L, G, hd) -> (B, L, H, hd); scale hd^-½.
    The reference's ``self_attention``/``_sdpa`` pair, served by the flash
    kernel (which needs no q-chunking: it never builds the (L, L) scores)."""
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           window)


def _project_qkv(p: Params, x: torch.Tensor, rope: Rope, cfg: ModelConfig):
    dt = x.dtype
    b, l, _ = x.shape
    hd, nq, nkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    q = (x @ p["wq"].to(dt)).reshape(b, l, nq, hd)
    k = (x @ p["wk"].to(dt)).reshape(b, l, nkv, hd)
    v = (x @ p["wv"].to(dt)).reshape(b, l, nkv, hd)
    if cfg.qk_norm:
        q = rms_norm_headwise(q, p["q_scale"])
        k = rms_norm_headwise(k, p["k_scale"])
    return rotate(q, rope), rotate(k, rope), v


def gqa_forward(p: Params, x: torch.Tensor, rope: Rope,
                cfg: ModelConfig) -> torch.Tensor:
    """Full bidirectional attention over x (B, L, d)."""
    q, k, v = _project_qkv(p, x, rope, cfg)
    out = self_attention(q, k, v, window=cfg.sliding_window)
    return out.reshape(*x.shape[:2], -1) @ p["wo"].to(x.dtype)


def attention_forward(p: Params, x: torch.Tensor, rope: Rope,
                      cfg: ModelConfig) -> torch.Tensor:
    _check_supported(cfg)
    return gqa_forward(p, x, rope, cfg)


# --------------------------------------------------------------------------
# fixed-shape block cache (cache_policy = prefix | dual)
# --------------------------------------------------------------------------
#
# The cache covers ALL ``total`` positions of the canvas.  A live window
# writes its fresh K/V into a copy at its offset and attends over every
# key: cached context outside the window, fresh inside it.  The copy is a
# fresh contiguous allocation, so the bf16 kernel's 16-byte alignment
# holds; the kernel is never handed a slice of the cache.

class KVCache(NamedTuple):
    """One layer's K and V, each (B, total, G, hd) in the compute dtype."""
    k: torch.Tensor
    v: torch.Tensor


def gqa_capture(p: Params, x: torch.Tensor, rope: Rope,
                cfg: ModelConfig) -> Tuple[torch.Tensor, KVCache]:
    """Full attention that also returns the K/V it computed: the prefill
    and refresh op of the block cache."""
    q, k, v = _project_qkv(p, x, rope, cfg)
    out = self_attention(q, k, v, window=cfg.sliding_window)
    return (out.reshape(*x.shape[:2], -1) @ p["wo"].to(x.dtype),
            KVCache(k, v))


def _scatter(full: torch.Tensor, new: torch.Tensor,
             start: int) -> torch.Tensor:
    """A copy of ``full`` with ``new`` written at ``start`` along axis 1
    (both in the compute dtype: the cache holds what the capture made)."""
    return torch.cat([full[:, :start], new, full[:, start + new.shape[1]:]],
                     dim=1)


def gqa_cached(p: Params, x: torch.Tensor, rope: Rope,
               cfg: ModelConfig, cache: KVCache,
               win_start: int) -> torch.Tensor:
    """A W-row live window attends over the full fixed-length cache with
    its own fresh K/V written in at ``win_start``.  Read-only with respect
    to the cache (refreshes go through ``gqa_capture``)."""
    q, k_new, v_new = _project_qkv(p, x, rope, cfg)
    k = _scatter(cache.k, k_new, win_start)
    v = _scatter(cache.v, v_new, win_start)
    out = flash_attention(q, k, v, cfg.sliding_window, q_offset=win_start)
    return out.reshape(*x.shape[:2], -1) @ p["wo"].to(x.dtype)


def attention_capture(p: Params, x: torch.Tensor, rope: Rope,
                      cfg: ModelConfig) -> Tuple[torch.Tensor, KVCache]:
    _check_supported(cfg)
    return gqa_capture(p, x, rope, cfg)


def attention_cached(p: Params, x: torch.Tensor, rope: Rope,
                     cfg: ModelConfig, cache: KVCache,
                     win_start: int) -> torch.Tensor:
    _check_supported(cfg)
    return gqa_cached(p, x, rope, cfg, cache, win_start)
