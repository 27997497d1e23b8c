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
  and rebuilds K/V over the whole canvas for each window.
* The decode state (the reference's stateful decode): ``init_cache``
  allocates one layer's ``KVCache`` of a capacity (a sliding-window
  config a ring of ``min(length, window)`` slots; MLA the latents
  ``c_kv`` and ``k_rope``) with ``length``, the valid count, a host int.
  ``gqa_decode`` writes one token's K/V in place at a slot computed on
  the device (``pos0 % cap`` on a ring, else ``min(pos0, cap − 1)``, pos0
  row 0's position) and attends over the first ``min(pos0 + 1, cap)``
  slots through the flash kernel's device-side valid count, so no host
  read of the position happens and the cache is never copied.  MLA's
  ``mla_decode`` runs in absorbed form (``q_nope·W_UKᵀ`` against
  ``c_kv`` plus ``q_rope·k_rope``, ``W_UV`` after the weighted sum) in
  torch products with f32 results, as the reference's einsums; no kernel
  serves it (its scores are 576 wide).  ``gqa_window``/``mla_window``
  score a W-token window against the valid prefix ``[:length]`` plus
  itself (flash with no mask: the reference's ``-1e30`` mask over ``cap +
  W`` keys), and with ``extend`` write the window's K/V (latents) in
  place at ``length``, clamped as ``dynamic_update_slice`` clamps.

Under a tensor-parallel mesh (``parallel/ctx.py``) GQA runs on this
rank's heads, H/tp and G/tp (read from its ``wq``/``wk`` shards), its
input and Qwen3's q/k norm scales entering the region through
``ctx.enter_model``, with ``wo`` row-parallel (``layers.row_parallel``:
summed over ``model``), and
``init_cache`` allocates the local kv heads; a split off the heads'
boundaries raises ``ValueError``.  MLA runs on H/tp heads too, with the
reference's layout: ``wq_a`` and ``wkv_a`` are column-parallel and their
latents gathered over ``model`` (the RMSNorms and the shared rope key
need the whole latent; ``ctx.gather_cols``, whose gradient is summed over
``model``, then cut to this rank's columns), ``wq_b``/``wk_b``/``wv_b``
hold this rank's heads and ``wo`` is row-parallel; every path, the
absorbed decode included, reads its head count from ``wk_b``'s shard.
The latent cache stays whole on every model rank, since every local
head reads all of it (``init_cache``, ``sharding.state_pspecs``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import (Params, Rope, dense_init,
                                       rms_norm_headwise, rotate,
                                       row_parallel, sharded)
from repro_torch.parallel import ctx


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
    """q (B, L, H, hd), k/v (B, L, G, hd) of this rank's heads (all of
    them off a mesh): their counts from the projections' widths."""
    dt = x.dtype
    b, l, _ = x.shape
    hd = cfg.head_dim
    nq, nkv = p["wq"].shape[1] // hd, p["wk"].shape[1] // hd
    # local heads: x and the per-head norm scales enter the
    # tensor-parallel region (their gradients summed over the ranks)
    enter = ctx.enter_model if sharded(nq * hd, cfg.num_heads * hd,
                                       "attn/wq") else (lambda t: t)
    x = enter(x)
    q = (x @ p["wq"].to(dt)).reshape(b, l, nq, hd)
    k = (x @ p["wk"].to(dt)).reshape(b, l, nkv, hd)
    v = (x @ p["wv"].to(dt)).reshape(b, l, nkv, hd)
    if cfg.qk_norm:
        q = rms_norm_headwise(q, enter(p["q_scale"]))
        k = rms_norm_headwise(k, enter(p["k_scale"]))
    return rotate(q, rope), rotate(k, rope), v


def _out(p: Params, out: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The heads' outputs (B, L, H, hd) through ``wo`` (row-parallel under
    a mesh)."""
    return row_parallel(out.reshape(*out.shape[:2], -1), p["wo"],
                        cfg.num_heads * cfg.head_dim)


def gqa_forward(p: Params, x: torch.Tensor, rope: Rope,
                cfg: ModelConfig) -> torch.Tensor:
    """Full bidirectional attention over x (B, L, d)."""
    q, k, v = _project_qkv(p, x, rope, cfg)
    return _out(p, self_attention(q, k, v, window=cfg.sliding_window), cfg)


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
    the rope key k_rope (B, total, qk_rope), as the reference's.  In the
    decode state (``init_cache``) ``length`` is the reference's count of
    valid positions, a host int; the block cache leaves it 0 and never
    reads it (its cache covers the whole canvas)."""
    k: torch.Tensor
    v: torch.Tensor
    length: int = 0


def gqa_capture(p: Params, x: torch.Tensor, rope: Rope,
                cfg: ModelConfig) -> Tuple[torch.Tensor, KVCache]:
    """Full attention that also returns the K/V it computed: the prefill
    and refresh op of the block cache."""
    q, k, v = _project_qkv(p, x, rope, cfg)
    out = self_attention(q, k, v, window=cfg.sliding_window)
    return _out(p, out, cfg), KVCache(k, v)


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
    return _out(p, out, cfg)


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

def _mla_latent(xe: torch.Tensor, w: torch.Tensor, full: int,
                what: str) -> torch.Tensor:
    """xe @ w, a latent's projection, whole on every rank: under a model
    axis ``w`` is this rank's column shard (the reference's rule;
    ``blocks.check_tp`` requires the split) and the product of the
    entered input ``xe`` is gathered over ``model`` (its gradient summed
    over ``model``, then this rank's columns)."""
    y = xe @ w.to(xe.dtype)
    return ctx.gather_cols(y) if sharded(w.shape[1], full, what) else y


def _mla_latents(p: Params, x: torch.Tensor, rope: Rope, cfg: ModelConfig):
    """The shared front half: query heads (nope (B, L, H, nope) and rotated
    rope (B, L, H, rope) parts, this rank's H/tp heads under a model
    axis), the normed kv latent c_kv (B, L, kv_lora) and the rotated rope
    key k_rope (B, L, rope), one head shared by all; the latents are
    whole on every rank (``_mla_latent``), and their norms' replicated
    scales enter the tensor-parallel region, as the heads that read them
    are local.  ``rope``: tables at ``mla.qk_rope_head_dim``."""
    m, dt = cfg.mla, x.dtype
    b, l, _ = x.shape
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    xe = ctx.enter_model(x)
    q_lat = rms_norm_headwise(
        _mla_latent(xe, p["wq_a"], m.q_lora_rank, "attn/wq_a"),
        ctx.enter_model(p["q_norm"]))
    q = (q_lat @ p["wq_b"].to(dt)).reshape(b, l, -1, qk)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], -1)
    kv = _mla_latent(xe, p["wkv_a"], m.kv_lora_rank + m.qk_rope_head_dim,
                     "attn/wkv_a")               # (B, L, kv_lora + rope)
    c_kv, k_rope = kv.split([m.kv_lora_rank, m.qk_rope_head_dim], -1)
    c_kv = rms_norm_headwise(c_kv, ctx.enter_model(p["kv_norm"]))
    k_rope = rotate(k_rope[:, :, None, :], rope)[:, :, 0]
    return q_nope, rotate(q_rope, rope), c_kv, k_rope


def _mla_local_heads(p: Params, cfg: ModelConfig) -> int:
    """This rank's MLA heads (all of them off a mesh), from ``wk_b``'s
    width."""
    n = p["wk_b"].shape[1] // cfg.mla.qk_nope_head_dim
    sharded(n, cfg.num_heads, "attn/wk_b's heads")
    return n


def _mla_heads(p: Params, q_nope: torch.Tensor, q_rope: torch.Tensor,
               c_kv: torch.Tensor, k_rope: torch.Tensor, cfg: ModelConfig):
    """Per-head q (B, L, H, dqk), k (B, S, H, dqk) and v (B, S, H, dv) from
    the latents of S key positions (this rank's heads under a model axis):
    k is nope ‖ the rope key broadcast to every head, written out (``cat``
    makes contiguous tensors: the bf16 kernel needs 16-byte-aligned
    storage, not a broadcast view)."""
    m, dt = cfg.mla, c_kv.dtype
    b, s, _ = c_kv.shape
    nq = _mla_local_heads(p, cfg)
    k_nope = (c_kv @ p["wk_b"].to(dt)).reshape(b, s, nq, m.qk_nope_head_dim)
    v = (c_kv @ p["wv_b"].to(dt)).reshape(b, s, nq, m.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, nq, m.qk_rope_head_dim)], dim=-1)
    return q, k, v


def _mla_out(p: Params, out: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The heads' outputs (B, L, H, dv) through ``wo`` (row-parallel under a
    model axis)."""
    return row_parallel(out.reshape(*out.shape[:2], -1), p["wo"],
                        cfg.num_heads * cfg.mla.v_head_dim)


def _mla_attend(p: Params, q, k, v, cfg: ModelConfig) -> torch.Tensor:
    """The flash kernel at (dqk, dv), scale dqk^-½ (q's own width), then
    the output projection."""
    return _mla_out(p, flash_attention(q, k, v), cfg)


def mla_forward(p: Params, x: torch.Tensor, rope: Rope,
                cfg: ModelConfig) -> torch.Tensor:
    """MLA over x (B, L, d) with per-head K/V materialised from the
    latents (the reference's train and prefill path)."""
    q_nope, q_rope, c_kv, k_rope = _mla_latents(p, x, rope, cfg)
    return _mla_attend(p, *_mla_heads(p, q_nope, q_rope, c_kv, k_rope, cfg),
                       cfg)


def mla_capture(p: Params, x: torch.Tensor, rope: Rope,
                cfg: ModelConfig) -> Tuple[torch.Tensor, KVCache]:
    """``mla_forward`` that also returns the latent cache (c_kv, k_rope)."""
    q_nope, q_rope, c_kv, k_rope = _mla_latents(p, x, rope, cfg)
    out = _mla_attend(p, *_mla_heads(p, q_nope, q_rope, c_kv, k_rope, cfg),
                      cfg)
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
                       cfg)


# --------------------------------------------------------------------------
# the decode state: one token against a fixed-capacity cache, and the
# shrinking window against the valid prefix
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, length: int,
               dtype: torch.dtype = torch.bfloat16,
               valid_length: Optional[int] = None,
               device="cuda") -> KVCache:
    """One layer's zeroed decode cache of capacity ``length`` (a
    sliding-window config: a ring of ``min(length, window)`` slots; MLA:
    the latents (B, S, kv_lora) and (B, S, qk_rope), whole under a model
    axis too: every local head reads all of them).  ``valid_length``
    is the initial valid count (0 for a sampler that fills it block by
    block; default ``length``, a warm cache)."""
    dev = resolve_device(device)
    vl = length if valid_length is None else valid_length
    if cfg.attention == "mla":
        m = cfg.mla
        return KVCache(
            torch.zeros(batch, length, m.kv_lora_rank, dtype=dtype,
                        device=dev),
            torch.zeros(batch, length, m.qk_rope_head_dim, dtype=dtype,
                        device=dev), vl)
    eff = min(length, cfg.sliding_window) if cfg.sliding_window else length
    shape = (batch, eff, ctx.local_count(cfg.num_kv_heads, "kv heads"),
             cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=dev),
                   torch.zeros(shape, dtype=dtype, device=dev), vl)


def _pos0(positions: torch.Tensor) -> torch.Tensor:
    """Row 0's position as a (1,) view on its device: positions (B, L), or
    M-RoPE's (3, B, L) (its t stream)."""
    return (positions if positions.dim() == 2 else positions[0])[0, :1]


def _write_slot(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                slot: torch.Tensor) -> None:
    """One position's K/V (or latents) written in place at ``slot``, a (1,)
    int64 device tensor (``index_copy_``: no host read, capturable)."""
    cache.k.index_copy_(1, slot, k_new.to(cache.k.dtype))
    cache.v.index_copy_(1, slot, v_new.to(cache.v.dtype))


def _extend(cache: KVCache, k_new: torch.Tensor,
            v_new: torch.Tensor) -> KVCache:
    """A window's K/V written in place at the valid length, the start
    clamped to [0, cap − W] as ``dynamic_update_slice`` clamps it; the
    valid length grows by W."""
    cap, w = cache.k.shape[1], k_new.shape[1]
    if w > cap:
        raise ValueError(f"a window of {w} positions does not fit a cache "
                         f"of {cap}")
    start = max(0, min(int(cache.length), cap - w))
    cache.k[:, start:start + w] = k_new.to(cache.k.dtype)
    cache.v[:, start:start + w] = v_new.to(cache.v.dtype)
    return cache._replace(length=int(cache.length) + w)


def _with_prefix(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                 dt: torch.dtype):
    """[the cache's valid prefix | the window's own], K and V (or MLA's
    latents) in ``dt``: a copy of the prefix at sampler scale, as the
    reference's concatenation (its ``-1e30`` mask over the invalid slots
    leaves exactly these keys)."""
    n = min(int(cache.length), cache.k.shape[1])
    return (torch.cat([cache.k[:, :n].to(dt), k_new], dim=1),
            torch.cat([cache.v[:, :n].to(dt), v_new], dim=1))


def gqa_decode(p: Params, x: torch.Tensor, rope: Optional[Rope],
               positions: torch.Tensor, cfg: ModelConfig,
               cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
    """One new token x (B, 1, d) at ``positions`` (row 0's decides, as in
    the reference) against the cache: its K/V are written IN PLACE at
    ``pos0 % cap`` (a sliding window's ring) or ``min(pos0, cap − 1)``,
    then it attends over the slots ≤ pos0 (all of them once a ring is
    warm) through the flash kernel with the count ``min(pos0 + 1, cap)``
    read on the device.  Returns (out, the same buffers with length + 1)."""
    dt = x.dtype
    q, k_new, v_new = _project_qkv(p, x, rope, cfg)
    cap = cache.k.shape[1]
    pos0 = _pos0(positions).long()
    slot = pos0.remainder(cap) if cfg.sliding_window else \
        pos0.clamp(max=cap - 1)
    _write_slot(cache, k_new, v_new, slot)
    kv_len = (pos0 + 1).clamp(max=cap).to(torch.int32)
    out = flash_attention(q, cache.k.to(dt), cache.v.to(dt), kv_len=kv_len)
    return _out(p, out, cfg), cache._replace(length=int(cache.length) + 1)


def gqa_window(p: Params, x: torch.Tensor, rope: Optional[Rope],
               cfg: ModelConfig, cache: KVCache,
               extend: bool = False) -> Tuple[torch.Tensor, KVCache]:
    """A W-token window x (B, W, d) attends over [the valid prefix | itself]
    (the cached semi-AR path; a copy of the prefix at sampler scale, as
    the reference's concatenation).  ``extend=True`` then writes the
    window's K/V into the cache at the valid length."""
    q, k_new, v_new = _project_qkv(p, x, rope, cfg)
    out = flash_attention(q, *_with_prefix(cache, k_new, v_new, x.dtype))
    return _out(p, out, cfg), \
        _extend(cache, k_new, v_new) if extend else cache


def mla_window(p: Params, x: torch.Tensor, rope: Optional[Rope],
               cfg: ModelConfig, cache: KVCache,
               extend: bool = False) -> Tuple[torch.Tensor, KVCache]:
    """The window against MLA's latent cache: per-head K/V rebuilt from the
    valid latents and the window's own, flash at (dqk, dv).  ``extend``
    writes the window's latents at the valid length."""
    q_nope, q_rope, c_new, kr_new = _mla_latents(p, x, rope, cfg)
    c_all, kr_all = _with_prefix(cache, c_new, kr_new, x.dtype)
    out = _mla_attend(p, *_mla_heads(p, q_nope, q_rope, c_all, kr_all, cfg),
                      cfg)
    return out, _extend(cache, c_new, kr_new) if extend else cache


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (batched) as f32 products of compute-dtype operands, f32
    accumulation and an f32 result (the reference's
    ``preferred_element_type=float32``): cuBLAS's f32-output GEMM on the
    card (and on the dry-run's meta stand-ins), the operands widened on
    the CPU (the same exact products)."""
    if a.dtype == torch.float32:
        return a @ b
    if a.device.type in ("cuda", "meta"):
        return torch.bmm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def mla_decode(p: Params, x: torch.Tensor, rope: Optional[Rope],
               positions: torch.Tensor, cfg: ModelConfig,
               cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
    """Absorbed-form MLA decode against the latent cache (cache.k = c_kv
    (B, S, kv_lora), cache.v = k_rope (B, S, qk_rope)): the new latents
    written in place at ``min(pos0, S − 1)``; scores = (q_nope·W_UKᵀ)·c_kv
    + q_rope·k_rope, scaled by (qk_nope + qk_rope)^-½, over the slots ≤
    pos0; the weighted sum of c_kv absorbed through W_UV.  Per-head K/V
    over the cache are never built.  Every product has an f32 result,
    cast to the compute dtype where the reference casts."""
    m, dt = cfg.mla, x.dtype
    b, l, _ = x.shape
    nq, r = _mla_local_heads(p, cfg), m.kv_lora_rank
    q_nope, q_rope, c_new, kr_new = _mla_latents(p, x, rope, cfg)
    cap = cache.k.shape[1]
    pos0 = _pos0(positions).long()
    _write_slot(cache, c_new, kr_new, pos0.clamp(max=cap - 1))
    c_kv, k_rope = cache.k.to(dt), cache.v.to(dt)
    # W_UK absorbed into the query, per head: q_lat (B, L, H, r)
    wk_b = p["wk_b"].to(dt).reshape(r, nq, m.qk_nope_head_dim)
    q_lat = _bmm_f32(q_nope.permute(2, 0, 1, 3).reshape(nq, b * l, -1),
                     wk_b.permute(1, 2, 0)).to(dt)        # (H, B·L, r)
    q_lat = q_lat.reshape(nq, b, l, r).permute(1, 2, 0, 3)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    scores = (_bmm_f32(q_lat.reshape(b, l * nq, r), c_kv.transpose(1, 2))
              + _bmm_f32(q_rope.reshape(b, l * nq, -1),
                         k_rope.transpose(1, 2))) * scale  # (B, L·H, S)
    valid = torch.arange(cap, device=x.device) <= pos0
    scores = torch.where(valid, scores, torch.full_like(scores, -1e30))
    w = torch.softmax(scores, dim=-1).to(dt)
    o_lat = _bmm_f32(w, c_kv).to(dt)                      # (B, L·H, r)
    wv_b = p["wv_b"].to(dt).reshape(r, nq, m.v_head_dim)
    out = _bmm_f32(o_lat.reshape(b * l, nq, r).transpose(0, 1),
                   wv_b.transpose(0, 1)).to(dt)           # (H, B·L, dv)
    out = _mla_out(p, out.transpose(0, 1).reshape(b, l, nq, -1), cfg)
    return out, cache._replace(length=int(cache.length) + 1)


def attention_decode(p: Params, x: torch.Tensor, rope: Optional[Rope],
                     positions: torch.Tensor, cfg: ModelConfig,
                     cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
    if cfg.attention == "mla":
        return mla_decode(p, x, rope, positions, cfg, cache)
    return gqa_decode(p, x, rope, positions, cfg, cache)


def attention_window(p: Params, x: torch.Tensor, rope: Optional[Rope],
                     cfg: ModelConfig, cache: KVCache,
                     extend: bool = False) -> Tuple[torch.Tensor, KVCache]:
    if cfg.attention == "mla":
        return mla_window(p, x, rope, cfg, cache, extend)
    return gqa_window(p, x, rope, cfg, cache, extend)
