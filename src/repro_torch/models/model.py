"""The diffusion LM of the port (reference: ``src/repro/models/model.py``).

Parameters are a plain dict of tensors, held per layer: ``{"embed":
{"tok", "head"}, "norm_f": {"scale"}, "blocks": [layer dict, ...]}`` —
the reference's tree with its stacked layer axis unstacked into a list
(``repro_torch.convert`` bridges the two).  PyTorch runs eagerly, so the
layers are a Python loop; with ``cfg.remat == "block"`` a forward that
autograd records checkpoints each block.

MoE layers (``models/moe.py``) dispatch at capacity factor 1.25 in
``forward`` and 2.0 in the cache's two passes, as the reference's do.

An encoder-decoder (whisper) adds ``params["encoder"]`` = {"blocks",
"norm_f"}: a dense bidirectional stack (``encoder_config``) over the
caller's frame embeddings ``enc_embeds`` (B, S, d), the conv/mel frontend
being a stub.  ``forward(..., enc_embeds=...)`` encodes them inside every
forward, as the reference does, and each decoder layer cross-attends over
the result; without ``enc_embeds`` the cross path is skipped.  Its token
positions are the sinusoidal table's rows, added at the embedding; the
encoder adds none.

The fixed-shape block cache (DESIGN.md "The KV cache"): ``capture_cache``
runs one full pass over the canvas and keeps every layer's K/V,
``forward_cached`` scores a live window against it.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import blocks as blocks_lib
from repro_torch.models.attention import KVCache
from repro_torch.models.layers import (Params, Rope, apply_norm,
                                       compute_dtype, embed_tokens,
                                       init_embed, init_norm, lm_head,
                                       model_rotary_dim, rope_tables)


def encoder_config(cfg: ModelConfig) -> ModelConfig:
    """The whisper-style encoder: a dense bidirectional stack of
    ``encdec.encoder_layers`` layers (the reference's ``encoder_config``)."""
    return dataclasses.replace(
        cfg, arch_type="dense", num_layers=cfg.encdec.encoder_layers,
        encdec=None, sliding_window=0, remat=cfg.remat)


def init_model(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
               device="cuda", dtype: Optional[torch.dtype] = None) -> Params:
    """Seeded random weights, made directly on ``device`` in ``dtype``
    (default: the config's compute dtype; norm scales and biases, the
    sinusoidal table and the Mamba head's a_log, dt_bias and mix scales
    stay f32, as the reference's).  ``generator`` must live on
    ``device``; ``None`` seeds one with 0."""
    dev = resolve_device(device)
    dt = dtype or compute_dtype(cfg)
    blocks_lib.check_ported(cfg)
    gen = generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(0)
    params: Params = {"embed": init_embed(gen, cfg, dev, dt),
                      "norm_f": init_norm(cfg, dev)}
    params["blocks"] = [blocks_lib.init_block(gen, cfg, i, dev, dt)
                        for i in range(cfg.num_layers)]
    if cfg.is_encdec:
        ecfg = encoder_config(cfg)
        params["encoder"] = {
            "blocks": [blocks_lib.init_block(gen, ecfg, i, dev, dt)
                       for i in range(ecfg.num_layers)],
            "norm_f": init_norm(ecfg, dev)}
    return params


def make_positions(cfg: ModelConfig, batch: int, length: int,
                   offset: int = 0, device="cuda") -> torch.Tensor:
    """(B, L) int32 position ids (standard RoPE)."""
    pos = offset + torch.arange(length, dtype=torch.int32, device=device)
    return pos[None].expand(batch, length)


def forward_rope(cfg: ModelConfig, length: int, offset: int = 0,
                 device="cuda") -> Optional[Rope]:
    """The RoPE tables of one forward over ``length`` positions from
    ``offset``, (1, L, 1, rot/2) in the compute dtype (rot: the rotary
    dim, ``model_rotary_dim``: MLA's rope dims alone): built once and
    shared by every layer (they broadcast over the batch).  None under
    sinusoidal positions."""
    return rope_tables(make_positions(cfg, 1, length, offset, device),
                       model_rotary_dim(cfg), cfg, compute_dtype(cfg))


def _run_blocks(blocks: List[Params], x: torch.Tensor, rope,
                cfg: ModelConfig, return_aux: bool,
                enc_out: Optional[torch.Tensor] = None):
    """The layers over x: (x', summed aux loss or None)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device) \
        if return_aux else None
    for i, p in enumerate(blocks):
        if cfg.remat == "block" and torch.is_grad_enabled() and \
                _requires_grad(p):
            # the reference's jax.checkpoint per layer: keep the block's
            # input, recompute its insides in the backward (decodes never
            # get here: their params do not require grad); a block draws
            # no random numbers, so no RNG state is stashed
            out = checkpoint(blocks_lib.block_forward, p, x, rope, cfg, i,
                             return_aux, enc_out, use_reentrant=False,
                             preserve_rng_state=False)
        else:
            out = blocks_lib.block_forward(p, x, rope, cfg, i, return_aux,
                                           enc_out)
        if return_aux:
            x, aux = out
            if aux is not None:
                aux_total = aux_total + aux
        else:
            x = out
    return x, aux_total


def encode(params: Params, enc_embeds: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """The encoder stack over the stub frame embeddings (B, S, d), cast
    to the compute dtype (no positions are added, as in the reference),
    then its final norm: (B, S, d) in the compute dtype."""
    ecfg = encoder_config(cfg)
    x = enc_embeds.to(compute_dtype(cfg))
    rope = forward_rope(ecfg, x.shape[1], device=x.device)
    x, _ = _run_blocks(params["encoder"]["blocks"], x, rope, ecfg, False)
    return apply_norm(params["encoder"]["norm_f"], x, ecfg)


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            return_aux: bool = False,
            enc_embeds: Optional[torch.Tensor] = None):
    """tokens (B, L) -> logits (B, L, V) float32.  Bidirectional: every
    position is scored.  ``return_aux=True`` returns (logits, aux): the
    MoE layers' summed aux loss (f32 scalar; 0 without MoE layers), as
    the reference's ``forward`` does; a decode never asks for it.  An
    encoder-decoder given ``enc_embeds`` (B, S, d) encodes them and
    cross-attends over the result in every layer."""
    x = embed_tokens(params["embed"], tokens, cfg)
    rope = forward_rope(cfg, tokens.shape[1], device=tokens.device)
    enc_out = encode(params, enc_embeds, cfg) \
        if cfg.is_encdec and enc_embeds is not None else None
    x, aux_total = _run_blocks(params["blocks"], x, rope, cfg, return_aux,
                               enc_out)
    x = apply_norm(params["norm_f"], x, cfg)
    logits = lm_head(params["embed"], x, cfg)
    return (logits, aux_total) if return_aux else logits


def _requires_grad(tree) -> bool:
    if isinstance(tree, dict):
        return any(_requires_grad(v) for v in tree.values())
    return tree.requires_grad


# the block cache's state: one KVCache per layer, each covering the whole
# canvas: (B, total, G, hd) K and V, or MLA's latents (``KVCache``)
DecodeState = List[KVCache]


def capture_cache(params: Params, tokens: torch.Tensor,
                  cfg: ModelConfig) -> DecodeState:
    """One full bidirectional pass over the canvas (B, total) keeping every
    layer's K/V: the prefill and block-boundary refresh of the block
    cache.  No LM head: refresh logits are never used (the next window
    forward scores the live rows anyway)."""
    x = embed_tokens(params["embed"], tokens, cfg)
    rope = forward_rope(cfg, tokens.shape[1], device=tokens.device)
    state: DecodeState = []
    for i, p in enumerate(params["blocks"]):
        x, kv = blocks_lib.block_capture(p, x, rope, cfg, i)
        state.append(kv)
    return state


def forward_cached(params: Params, tokens: torch.Tensor, win_start: int,
                   state: DecodeState, cfg: ModelConfig) -> torch.Tensor:
    """Score a W-row live window (B, W) at ``win_start`` against the cache
    from ``capture_cache``.  Read-only with respect to the cache: each
    layer writes its fresh window K/V into a copy and attends over all
    ``total`` keys.  Returns logits (B, W, V) float32."""
    x = embed_tokens(params["embed"], tokens, cfg, win_start)
    rope = forward_rope(cfg, tokens.shape[1], win_start, tokens.device)
    for i, (p, kv) in enumerate(zip(params["blocks"], state)):
        x = blocks_lib.block_cached(p, x, rope, cfg, i, kv, win_start)
    x = apply_norm(params["norm_f"], x, cfg)
    return lm_head(params["embed"], x, cfg)
