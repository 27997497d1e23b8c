"""Bidirectional attention of the port (reference:
``src/repro/models/attention.py``): GQA/MHA and DeepSeek-V2's MLA.

* GQA/MHA: q/k/v projections, Qwen3's per-head q/k RMSNorm
  (``qk_norm``), RoPE (standard or half, from tables the model builds
  once per forward), and the attention itself through
  ``kernels.flash_attention`` (the hand-written kernel on a card, its
  plain version on the CPU) with GQA heads grouped inside the kernel:
  the full-sequence path and the fixed-shape block cache's capture and
  cached window; both cache paths go through ``_project_qkv``, so they
  norm q and k as the full path does.
* MLA (``cfg.attention == "mla"``): queries through a normed low-rank
  latent, keys and values from one normed kv latent ``c_kv`` plus a rope
  key shared by all heads (``_mla_latents``).  Every path materialises
  the per-head K (nope ‖ rope, dqk wide) and V (dv wide) from the
  latents (``_mla_heads``) and runs the flash kernel at (dqk, dv) with
  the scale dqk^-½; the block cache keeps the latents ``(c_kv, k_rope)``
  and rebuilds K/V over the whole canvas for each window.  The absorbed
  ``mla_decode`` and ``mla_window`` serve the reference's single-token
  decode and shrinking window, which the port has not ported
  (ROADMAP.md queue 1 item 11).
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
    if cfg.attention == "mla":
        return _init_mla(gen, cfg, device, dtype)
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


def _init_mla(gen: torch.Generator, cfg: ModelConfig, device,
              dtype) -> Params:
    """The reference's MLA tree: names and shapes; the two latent norms'
    scales f32."""
    m, d, nq = cfg.mla, cfg.d_model, cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": dense_init(gen, (d, m.q_lora_rank), device, dtype),
        "q_norm": torch.ones(m.q_lora_rank, dtype=torch.float32,
                             device=device),
        "wq_b": dense_init(gen, (m.q_lora_rank, nq * qk), device, dtype),
        "wkv_a": dense_init(gen, (d, m.kv_lora_rank + m.qk_rope_head_dim),
                            device, dtype),
        "kv_norm": torch.ones(m.kv_lora_rank, dtype=torch.float32,
                              device=device),
        "wk_b": dense_init(gen, (m.kv_lora_rank, nq * m.qk_nope_head_dim),
                           device, dtype),
        "wv_b": dense_init(gen, (m.kv_lora_rank, nq * m.v_head_dim), device,
                           dtype),
        "wo": dense_init(gen, (nq * m.v_head_dim, d), device, dtype)}


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
    if cfg.attention == "mla":
        return mla_forward(p, x, rope, cfg)
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
    """One layer's cache in the compute dtype: K and V, each (B, total, G,
    hd); for MLA the latents, ``k`` = c_kv (B, total, kv_lora) and ``v`` =
    the rope key k_rope (B, total, qk_rope), as the reference's."""
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
    if cfg.attention == "mla":
        return mla_capture(p, x, rope, cfg)
    return gqa_capture(p, x, rope, cfg)


def attention_cached(p: Params, x: torch.Tensor, rope: Rope,
                     cfg: ModelConfig, cache: KVCache,
                     win_start: int) -> torch.Tensor:
    if cfg.attention == "mla":
        return mla_cached(p, x, rope, cfg, cache, win_start)
    return gqa_cached(p, x, rope, cfg, cache, win_start)


# --------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# --------------------------------------------------------------------------

def _mla_latents(p: Params, x: torch.Tensor, rope: Rope, cfg: ModelConfig):
    """The shared front half: query heads (nope (B, L, H, nope) and rotated
    rope (B, L, H, rope) parts), the normed kv latent c_kv (B, L, kv_lora)
    and the rotated rope key k_rope (B, L, rope), one head shared by all.
    ``rope``: tables at ``mla.qk_rope_head_dim``."""
    m, dt = cfg.mla, x.dtype
    b, l, _ = x.shape
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    q_lat = rms_norm_headwise(x @ p["wq_a"].to(dt), p["q_norm"])
    q = (q_lat @ p["wq_b"].to(dt)).reshape(b, l, cfg.num_heads, qk)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], -1)
    kv = x @ p["wkv_a"].to(dt)                    # (B, L, kv_lora + rope)
    c_kv, k_rope = kv.split([m.kv_lora_rank, m.qk_rope_head_dim], -1)
    c_kv = rms_norm_headwise(c_kv, p["kv_norm"])
    k_rope = rotate(k_rope[:, :, None, :], rope)[:, :, 0]
    return q_nope, rotate(q_rope, rope), c_kv, k_rope


def _mla_heads(p: Params, q_nope: torch.Tensor, q_rope: torch.Tensor,
               c_kv: torch.Tensor, k_rope: torch.Tensor, cfg: ModelConfig):
    """Per-head q (B, L, H, dqk), k (B, S, H, dqk) and v (B, S, H, dv) from
    the latents of S key positions: k is nope ‖ the rope key broadcast to
    every head, written out (``cat`` makes contiguous tensors: the bf16
    kernel needs 16-byte-aligned storage, not a broadcast view)."""
    m, dt = cfg.mla, c_kv.dtype
    b, s, _ = c_kv.shape
    nq = cfg.num_heads
    k_nope = (c_kv @ p["wk_b"].to(dt)).reshape(b, s, nq, m.qk_nope_head_dim)
    v = (c_kv @ p["wv_b"].to(dt)).reshape(b, s, nq, m.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, nq, m.qk_rope_head_dim)], dim=-1)
    return q, k, v


def _mla_attend(p: Params, q, k, v, x: torch.Tensor) -> torch.Tensor:
    """The flash kernel at (dqk, dv), scale dqk^-½ (q's own width), then
    the output projection."""
    out = flash_attention(q, k, v)
    return out.reshape(*x.shape[:2], -1) @ p["wo"].to(x.dtype)


def mla_forward(p: Params, x: torch.Tensor, rope: Rope,
                cfg: ModelConfig) -> torch.Tensor:
    """MLA over x (B, L, d) with per-head K/V materialised from the
    latents (the reference's train and prefill path)."""
    q_nope, q_rope, c_kv, k_rope = _mla_latents(p, x, rope, cfg)
    return _mla_attend(p, *_mla_heads(p, q_nope, q_rope, c_kv, k_rope, cfg),
                       x)


def mla_capture(p: Params, x: torch.Tensor, rope: Rope,
                cfg: ModelConfig) -> Tuple[torch.Tensor, KVCache]:
    """``mla_forward`` that also returns the latent cache (c_kv, k_rope)."""
    q_nope, q_rope, c_kv, k_rope = _mla_latents(p, x, rope, cfg)
    out = _mla_attend(p, *_mla_heads(p, q_nope, q_rope, c_kv, k_rope, cfg),
                      x)
    return out, KVCache(c_kv, k_rope)


def mla_cached(p: Params, x: torch.Tensor, rope: Rope, cfg: ModelConfig,
               cache: KVCache, win_start: int) -> torch.Tensor:
    """A W-row live window against the full-length latent cache: its own
    latents written in at ``win_start``, per-head K/V rebuilt from all
    ``total`` latents.  Read-only with respect to the cache."""
    q_nope, q_rope, c_new, kr_new = _mla_latents(p, x, rope, cfg)
    c_all = _scatter(cache.k, c_new, win_start)
    kr_all = _scatter(cache.v, kr_new, win_start)
    return _mla_attend(p, *_mla_heads(p, q_nope, q_rope, c_all, kr_all, cfg),
                       x)
