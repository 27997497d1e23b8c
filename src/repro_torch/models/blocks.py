"""Block assembly of the port (reference: ``src/repro/models/blocks.py``):

* dense / vlm:     norm → attention → norm → SwiGLU (a VLM's block is the
                   dense one; its patch stream and M-RoPE live in the
                   model);
* moe:             norm → attention → norm → MoE (``models/moe.py``: top-k
                   routed experts), in every layer from
                   ``moe.first_k_dense`` on (the layers before it, and every
                   layer of a config with no experts, are dense);
* ssm (xLSTM):     norm → {mLSTM | sLSTM} (``models/ssm.py``; the kind of
                   layer i is ``xlstm_pattern[i % len]``), no second norm
                   and no MLP;
* hybrid (Hymba):  norm → [attention ∥ Mamba], fused mean → norm → SwiGLU;
* encdec decoder:  norm → self-attention → norm → cross-attention over the
                   encoder's output → norm → MLP (whisper: LayerNorm, GELU);
                   the cross path runs only when the forward is given the
                   encoder's output, as in the reference;

with residuals.  Attention is GQA/MHA or DeepSeek-V2's MLA
(``models/attention.py``); an MoE layer may add shared experts.  The
attention-only blocks (dense, vlm, MoE, encoder-decoder) also have the
fixed-shape block cache's two entry points (``block_capture``,
``block_cached``); a hybrid or xLSTM config never reaches them, since
the decoder refuses its cache policies first.  An MoE block's aux loss is
returned on request (``return_aux``: the trainer's objective).

Every family also has the reference's stateful entry points over a
per-layer decode state (``init_layer_state``: a ``KVCache``, an xLSTM
state, or Hymba's (``KVCache``, ``MambaState``) pair): ``block_decode``
(one token; an MoE layer dispatches the step's B tokens at capacity
factor 2.0; an encoder-decoder cross-attends over the state's
``enc_out``) and ``block_window`` (W tokens against the frozen prefix;
``extend`` None, ``"kv"`` or ``"recurrent"``, as the reference's).

Under a tensor-parallel mesh (``parallel/ctx.py``) the dense and MoE
blocks, GQA's and MLA's, run on their shards (``check_tp``), and train
on FSDP shards (``check_fsdp``); norms and residuals stay replicated,
every rank holding the whole hidden state.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.attention import (KVCache, attention_cached,
                                          attention_capture,
                                          attention_decode,
                                          attention_forward,
                                          attention_window, init_attention,
                                          init_cache)
from repro_torch.models.layers import (Params, Rope, apply_mlp, apply_norm,
                                       init_mlp, init_norm, model_rotary_dim,
                                       mrope_sections_ok, rope_tables)
from repro_torch.parallel import ctx


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a config that no block family of the port
    (nor of the reference, which fails on them too) can build: a hybrid
    or xLSTM config without its ``ssm`` config, an attention block
    without a feed-forward, M-RoPE sections that do not split rot/2."""
    if cfg.arch_type not in ("dense", "vlm", "hybrid", "moe", "encdec",
                             "ssm"):
        raise ValueError(f"{cfg.name!r}: unknown arch_type "
                         f"{cfg.arch_type!r}")
    if cfg.arch_type in ("ssm", "hybrid") and cfg.ssm is None:
        raise ValueError(
            f"{cfg.name!r} (arch_type={cfg.arch_type!r}) has no ssm config "
            f"(SSMConfig): its recurrent mixer cannot be built")
    if cfg.arch_type != "ssm" and not cfg.d_ff:
        raise ValueError(
            f"{cfg.name!r} (arch_type={cfg.arch_type!r}): d_ff=0 leaves an "
            f"attention block without its feed-forward (only an xLSTM "
            f"block has none)")
    rot = model_rotary_dim(cfg)
    if cfg.rope == "mrope" and not mrope_sections_ok(cfg, rot):
        raise ValueError(
            f"{cfg.name!r}: mrope_sections {cfg.mrope_sections} must sum "
            f"to rot/2 = {rot // 2}")


def check_tp(cfg: ModelConfig) -> None:
    """Under a model axis of more than one rank: raise
    ``NotImplementedError`` for a family whose tensor parallelism waits
    (Hymba's Mamba, the xLSTM, the encoder-decoder, the VLM), and
    ``ValueError`` where the heads (or MLA's latent columns) do not split
    whole over the axis.  The dense and MoE stacks run on local heads,
    GQA's and MLA's."""
    if ctx.model_size() == 1:
        return
    if cfg.arch_type not in ("dense", "moe") or \
            cfg.attention not in ("gqa", "mla"):
        raise NotImplementedError(
            f"{cfg.name!r} (arch_type={cfg.arch_type!r}, attention="
            f"{cfg.attention!r}): tensor parallelism covers the dense and "
            f"MoE stacks (GQA and MLA); this family's waits (ROADMAP "
            f"queue 1, item 3)")
    ctx.local_count(cfg.num_heads, "query heads")
    if cfg.attention == "gqa":
        ctx.local_count(cfg.num_kv_heads, "kv heads")
    else:                           # MLA's column-parallel latents
        ctx.local_count(cfg.mla.q_lora_rank, "q latent columns")
        ctx.local_count(cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim,
                        "kv latent columns")


def check_fsdp(cfg: ModelConfig) -> None:
    """Training on FSDP shards (``model.forward(..., param_specs=)``, any
    mesh) covers the dense GQA stacks and the MoE stacks (Mixtral's GQA,
    DeepSeek-V2's MLA): raise ``NotImplementedError`` for the others."""
    if not ((cfg.arch_type == "dense" and cfg.attention == "gqa") or
            (cfg.arch_type == "moe" and cfg.attention in ("gqa", "mla"))):
        raise NotImplementedError(
            f"{cfg.name!r} (arch_type={cfg.arch_type!r}, attention="
            f"{cfg.attention!r}): training under a mesh covers the dense "
            f"GQA and the MoE stacks; this family's waits (ROADMAP queue "
            f"1, item 3)")


def _is_moe_layer(cfg: ModelConfig, idx: int) -> bool:
    return cfg.is_moe and idx >= cfg.moe.first_k_dense


def init_block(gen: torch.Generator, cfg: ModelConfig, idx: int, device,
               dtype) -> Params:
    check_ported(cfg)
    if cfg.arch_type == "ssm":
        return {"norm1": init_norm(cfg, device),
                "mixer": ssm_lib.init_xlstm_layer(gen, cfg, idx, device,
                                                  dtype)}
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
    if _is_moe_layer(cfg, idx):
        p["moe"] = moe_lib.init_moe(gen, cfg, device, dtype)
    else:
        p["mlp"] = init_mlp(gen, cfg, device, dtype)
    if cfg.is_encdec:
        p["norm_x"] = init_norm(cfg, device)
        p["xattn"] = init_attention(gen, cfg, device, dtype)
    return p


def cross_attention(p: Params, x: torch.Tensor, enc_out: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """The decoder's queries x (B, Lq, d) over the encoder's output
    enc_out (B, Lk, d): no RoPE, no band, scale head_dim^-½, through the
    flash kernel at Lq ≠ Lk."""
    dt = x.dtype
    b, lq, _ = x.shape
    lk = enc_out.shape[1]
    hd, nq, nkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    enc = enc_out.to(dt)
    q = (x @ p["wq"].to(dt)).reshape(b, lq, nq, hd)
    k = (enc @ p["wk"].to(dt)).reshape(b, lk, nkv, hd)
    v = (enc @ p["wv"].to(dt)).reshape(b, lk, nkv, hd)
    out = flash_attention(q, k, v)
    return out.reshape(b, lq, -1) @ p["wo"].to(dt)


def _feed_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, idx: int,
                  capacity_factor: float, need_aux: bool = False
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The residual's second half: norm, then the layer's MoE or SwiGLU;
    returns (x', aux: the MoE aux loss when ``need_aux``, else None)."""
    h = apply_norm(p["norm2"], x, cfg)
    if _is_moe_layer(cfg, idx):
        out, aux = moe_lib.moe_forward(p["moe"], h, cfg, capacity_factor,
                                       need_aux)
        return x + out, aux
    return x + apply_mlp(p["mlp"], h, cfg), None


def _mix(p: Params, x: torch.Tensor, attn_out: torch.Tensor,
         ssm_out: torch.Tensor) -> torch.Tensor:
    """Hymba's fused mean of its two parallel paths, added to x."""
    return x + 0.5 * (attn_out * p["mix_attn"].to(x.dtype)
                      + ssm_out * p["mix_ssm"].to(x.dtype))


def block_forward(p: Params, x: torch.Tensor, rope, cfg: ModelConfig,
                  idx: int, return_aux: bool = False,
                  enc_out: Optional[torch.Tensor] = None):
    """x (B, L, d) -> x', or (x', aux) with ``return_aux``: an MoE layer's
    aux loss (f32 scalar), None for any other layer.  ``rope``: the
    forward's ``Rope`` tables (None: no RoPE), or the (B, L) positions
    (M-RoPE's (3, B, L)) to build them from; an xLSTM layer ignores it.
    An MoE layer dispatches at capacity factor 1.25.  An
    encoder-decoder's layer attends over ``enc_out`` (B, S, d) when it
    is given."""
    if cfg.arch_type == "ssm":
        x = x + ssm_lib.xlstm_forward(p["mixer"], apply_norm(p["norm1"], x,
                                                             cfg), cfg, idx)
        return (x, None) if return_aux else x
    if isinstance(rope, torch.Tensor):
        rope = rope_tables(rope, model_rotary_dim(cfg), cfg, x.dtype)
    h = apply_norm(p["norm1"], x, cfg)
    attn_out = attention_forward(p["attn"], h, rope, cfg)
    if cfg.arch_type == "hybrid":
        x = _mix(p, x, attn_out, ssm_lib.mamba_forward(p["mamba"], h, cfg))
    else:
        x = x + attn_out
    if cfg.is_encdec and enc_out is not None:
        x = x + cross_attention(p["xattn"], apply_norm(p["norm_x"], x, cfg),
                                enc_out, cfg)
    x, aux = _feed_forward(p, x, cfg, idx, 1.25, return_aux)
    return (x, aux) if return_aux else x


# --------------------------------------------------------------------------
# fixed-shape block cache (cache_policy = prefix | dual; dense, MoE, and
# unconditioned VLM and encoder-decoder blocks (the decoder refuses
# conditioning extras under a cache policy, as the reference's does); MoE
# dispatches at capacity factor 2.0, as the reference's)
# --------------------------------------------------------------------------

def _check_dense(cfg: ModelConfig) -> None:
    if cfg.arch_type not in ("dense", "vlm", "moe", "encdec"):
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
    x, _ = _feed_forward(p, x + attn_out, cfg, idx, 2.0)
    return x, kv


def block_cached(p: Params, x: torch.Tensor, rope: Rope,
                 cfg: ModelConfig, idx: int, cache: KVCache,
                 win_start: int) -> torch.Tensor:
    """A W-row live window (B, W, d) against this layer's full-length
    cache; read-only with respect to the cache."""
    _check_dense(cfg)
    h = apply_norm(p["norm1"], x, cfg)
    x = x + attention_cached(p["attn"], h, rope, cfg, cache, win_start)
    return _feed_forward(p, x, cfg, idx, 2.0)[0]


# --------------------------------------------------------------------------
# the decode state: one token, or a W-token window, against per-layer
# state (KVCache | xLSTM state | (KVCache, MambaState))
# --------------------------------------------------------------------------

LayerState = Any


def init_layer_state(cfg: ModelConfig, idx: int, batch: int, length: int,
                     dtype: torch.dtype = torch.bfloat16,
                     valid_length: Optional[int] = None,
                     device="cuda") -> LayerState:
    if cfg.arch_type == "ssm":
        return ssm_lib.init_xlstm_state(cfg, idx, batch, device)
    kv = init_cache(cfg, batch, length, dtype, valid_length, device)
    if cfg.arch_type == "hybrid":
        return kv, ssm_lib.init_mamba_state(cfg, batch, dtype, device)
    return kv


def layer_cache(state: LayerState) -> Optional[KVCache]:
    """The attention cache in a layer's state: the state itself, the first
    of Hymba's (``KVCache``, ``MambaState``) pair, or None (an xLSTM
    state)."""
    if isinstance(state, KVCache):
        return state
    if isinstance(state, tuple) and len(state) == 2 and \
            isinstance(state[0], KVCache):
        return state[0]
    return None


def _cross_and_ff(p: Params, x: torch.Tensor, cfg: ModelConfig, idx: int,
                  enc_out: Optional[torch.Tensor]) -> torch.Tensor:
    """The block's second half: cross-attention over ``enc_out`` (an
    encoder-decoder given one), then the feed-forward (MoE at capacity
    factor 2.0)."""
    if cfg.is_encdec and enc_out is not None:
        x = x + cross_attention(p["xattn"], apply_norm(p["norm_x"], x, cfg),
                                enc_out, cfg)
    return _feed_forward(p, x, cfg, idx, 2.0)[0]


def block_decode(p: Params, x: torch.Tensor, rope: Optional[Rope],
                 positions: torch.Tensor, cfg: ModelConfig, idx: int,
                 state: LayerState,
                 enc_out: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, LayerState]:
    """One token x (B, 1, d) at ``positions`` (its ``rope`` tables built
    from them) against this layer's state; the attention cache is written
    in place.  Returns (x', the layer's new state)."""
    h = apply_norm(p["norm1"], x, cfg)
    if cfg.arch_type == "ssm":
        out, st = ssm_lib.xlstm_step(p["mixer"], h, cfg, idx, state)
        return x + out, st
    if cfg.arch_type == "hybrid":
        kv, ms = state
        attn_out, kv = attention_decode(p["attn"], h, rope, positions, cfg,
                                        kv)
        ssm_out, ms = ssm_lib.mamba_step(p["mamba"], h, cfg, ms)
        x, state = _mix(p, x, attn_out, ssm_out), (kv, ms)
    else:
        attn_out, state = attention_decode(p["attn"], h, rope, positions,
                                           cfg, state)
        x = x + attn_out
    return _cross_and_ff(p, x, cfg, idx, enc_out), state


def block_window(p: Params, x: torch.Tensor, rope: Optional[Rope],
                 cfg: ModelConfig, idx: int, state: LayerState,
                 enc_out: Optional[torch.Tensor] = None,
                 extend: Optional[str] = None
                 ) -> Tuple[torch.Tensor, LayerState]:
    """W tokens x (B, W, d) against this layer's frozen prefix state.
    ``extend`` selects which half of the state a commit pass updates, as
    in the reference:
      None         — pure scoring (within-block denoising steps);
      "kv"         — append the window's K/V to the attention cache
                     (callers pass the live window incl. future masks, then
                     reset the valid length to the committed block with
                     ``model.set_valid_length``);
      "recurrent"  — advance the causal recurrent states (xLSTM, Mamba)
                     over the window (callers pass the committed block
                     only)."""
    h = apply_norm(p["norm1"], x, cfg)
    if cfg.arch_type == "ssm":
        if extend == "recurrent":
            out, st = ssm_lib.xlstm_forward(p["mixer"], h, cfg, idx,
                                            state=state, return_state=True)
            return x + out, st
        return x + ssm_lib.xlstm_forward(p["mixer"], h, cfg, idx,
                                         state=state), state
    if cfg.arch_type == "hybrid":
        kv, ms = state
        attn_out, kv = attention_window(p["attn"], h, rope, cfg, kv,
                                        extend=extend == "kv")
        if extend == "recurrent":
            ssm_out, ms = ssm_lib.mamba_forward(p["mamba"], h, cfg,
                                                state=ms, return_state=True)
        else:
            ssm_out = ssm_lib.mamba_forward(p["mamba"], h, cfg, state=ms)
        x, state = _mix(p, x, attn_out, ssm_out), (kv, ms)
    else:
        attn_out, state = attention_window(p["attn"], h, rope, cfg, state,
                                           extend=extend == "kv")
        x = x + attn_out
    return _cross_and_ff(p, x, cfg, idx, enc_out), state
