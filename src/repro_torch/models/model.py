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

A VLM (qwen2-vl) adds ``params["projector"]["w"]`` (d, d): ``forward(...,
patch_embeds=...)`` projects the caller's patch embeddings (B, P, d) (the
vision encoder being a stub), puts them in front of the token
embeddings, and slices their rows off after the final norm, so the
logits stay (B, L, V) over the text.  Its M-RoPE positions are three
streams (``make_positions``): patches at t = 0 on an h/w grid, text at
t = h = w = its index past the patches + 1 (so text alone starts at 1,
in the block cache's passes too).  An xLSTM stack (arch_type ``ssm``)
has no attention and no positions.

The fixed-shape block cache (DESIGN.md "The KV cache"): ``capture_cache``
runs one full pass over the canvas and keeps every layer's K/V
(``CacheState``), ``forward_cached`` scores a live window against it.

The decode state (the reference's ``DecodeState``: per-layer states and
the encoder's output): ``init_decode_state`` allocates it, ``decode_step``
scores one token against it (the serving shapes: decode_32k, and
long_500k on the sub-quadratic stacks), ``forward_window`` scores a
W-token window against the frozen prefix and with ``extend`` advances
it, ``set_valid_length`` resets the caches' valid count.  A step writes
the attention caches' K/V IN PLACE (a 32k cache is never copied): the
state returned shares those buffers with the state given, whose
recurrent states and valid lengths stay as they were; use the returned
state, and clone one that a caller wants to keep.

Under a tensor-parallel mesh (``parallel.ctx.activation_mesh``) every
entry point here runs the dense and MoE stacks (GQA and MLA) on this
rank's shards (``blocks.check_tp`` refuses the others); the model's values do
not change, but a vocab-sharded head returns this rank's vocab slice of
the logits, which ``core.confidence.score_logits`` scores through the
confidence kernel's partials.  A training forward (``param_specs``) also
runs on each weight's data-axis part (FSDP), gathering it at its use.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Optional

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
from repro_torch.parallel.sharding import use_params


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
    sinusoidal table, the Mamba head's a_log, dt_bias and mix scales, and
    the xLSTM's gate weights and biases stay f32, as the reference's).
    ``generator`` must live on ``device`` (on ``"meta"``, a CPU
    generator: a meta one cannot draw); ``None`` seeds one with 0."""
    dev = resolve_device(device)
    dt = dtype or compute_dtype(cfg)
    blocks_lib.check_ported(cfg)
    gen = generator if generator is not None else torch.Generator(
        device="cpu" if dev.type == "meta" else dev).manual_seed(0)
    params: Params = {"embed": init_embed(gen, cfg, dev, dt),
                      "norm_f": init_norm(cfg, dev)}
    params["blocks"] = [blocks_lib.init_block(gen, cfg, i, dev, dt)
                        for i in range(cfg.num_layers)]
    if cfg.encdec is not None and cfg.encdec.frontend == "vision_stub":
        # the projector from the stub's patch embeddings to d_model
        params["projector"] = {"w": (torch.randn(
            cfg.d_model, cfg.d_model, generator=gen, device=dev,
            dtype=torch.float32) * cfg.d_model ** -0.5).to(dt)}
    if cfg.is_encdec:
        ecfg = encoder_config(cfg)
        params["encoder"] = {
            "blocks": [blocks_lib.init_block(gen, ecfg, i, dev, dt)
                       for i in range(ecfg.num_layers)],
            "norm_f": init_norm(ecfg, dev)}
    return params


def make_positions(cfg: ModelConfig, batch: int, length: int,
                   offset: int = 0, device="cuda",
                   num_patches: int = 0) -> torch.Tensor:
    """Position ids of ``length`` positions from ``offset``: (B, L) int32,
    or under M-RoPE the (3, B, L) t/h/w streams of the reference's
    ``make_positions``: the first ``num_patches`` positions are patches,
    t = 0 with h, w on a side × side grid (side = ⌊√num_patches⌋, at
    least 1; a count that is not square wraps the grid), and text takes
    t = h = w = position − num_patches + 1."""
    pos = offset + torch.arange(length, dtype=torch.int32, device=device)
    pos = pos[None].expand(batch, length)
    if cfg.rope != "mrope":
        return pos
    side = max(int(num_patches ** 0.5), 1)
    patch = pos < num_patches
    t = torch.where(patch, 0, pos - num_patches + 1)
    hh = torch.where(patch, (pos % (side * side)) // side, t)
    ww = torch.where(patch, pos % side, t)
    return torch.stack([t, hh, ww]).to(torch.int32)


def forward_rope(cfg: ModelConfig, length: int, offset: int = 0,
                 device="cuda", num_patches: int = 0) -> Optional[Rope]:
    """The RoPE tables of one forward over ``length`` positions from
    ``offset`` (the first ``num_patches`` of them patches),
    (1, L, 1, rot/2) in the compute dtype (rot: the rotary dim,
    ``model_rotary_dim``: MLA's rope dims alone): built once and shared by
    every layer (they broadcast over the batch, as every row has the same
    positions).  None under sinusoidal positions or without RoPE."""
    return rope_tables(make_positions(cfg, 1, length, offset, device,
                                      num_patches),
                       model_rotary_dim(cfg), cfg, compute_dtype(cfg))


def _used(tree: Params, specs, dtype, keys=None) -> Params:
    """``tree`` (its ``keys``, default all) as the layers use it: without
    specs as it is; with the training layout's specs each leaf gathered
    over the data axes and promoted to ``dtype``
    (``parallel.sharding.use_params``)."""
    if specs is None:
        return tree
    keys = tree.keys() if keys is None else [k for k in keys if k in tree]
    return use_params({k: tree[k] for k in keys},
                      {k: specs[k] for k in keys}, dtype)


def _block(p: Params, spec, *args):
    """``block_forward`` on a block whose weights are gathered here, inside
    the block (so under ``remat="block"`` the gathered weights of one
    block are alive at a time, and the recomputation gathers again)."""
    return blocks_lib.block_forward(_used(p, spec, compute_dtype(args[2])),
                                    *args)


def _run_blocks(blocks: List[Params], x: torch.Tensor, rope,
                cfg: ModelConfig, return_aux: bool,
                enc_out: Optional[torch.Tensor] = None, specs=None):
    """The layers over x: (x', summed aux loss or None).  ``specs``: the
    blocks' training-layout specs (each block gathers its weights)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device) \
        if return_aux else None
    for i, p in enumerate(blocks):
        spec = None if specs is None else specs[i]
        if cfg.remat == "block" and torch.is_grad_enabled() and \
                _requires_grad(p):
            # the reference's jax.checkpoint per layer: keep the block's
            # input, recompute its insides in the backward (decodes never
            # get here: their params do not require grad); a block draws
            # no random numbers, so no RNG state is stashed
            out = checkpoint(_block, p, spec, x, rope, cfg, i, return_aux,
                             enc_out, use_reentrant=False,
                             preserve_rng_state=False)
        else:
            out = _block(p, spec, x, rope, cfg, i, return_aux, enc_out)
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
            enc_embeds: Optional[torch.Tensor] = None,
            patch_embeds: Optional[torch.Tensor] = None,
            return_hidden: bool = False, param_specs=None):
    """tokens (B, L) -> logits (B, L, V) float32.  Bidirectional: every
    position is scored.  ``return_aux=True`` returns (logits, aux): the
    MoE layers' summed aux loss (f32 scalar; 0 without MoE layers), as
    the reference's ``forward`` does; a decode never asks for it.  An
    encoder-decoder given ``enc_embeds`` (B, S, d) encodes them and
    cross-attends over the result in every layer.  A VLM given
    ``patch_embeds`` (B, P, d) projects them (in the compute dtype) in
    front of the text and drops their rows before the head.
    ``return_hidden=True`` skips the LM head and returns the final hidden
    states (B, L, d) in its place (prefill scoring applies the head
    itself).

    ``param_specs``: ``params`` are this rank's shards in the training
    layout (``parallel.sharding.shard_params(..., fsdp=True)``) under the
    active mesh, and these their specs (a tree of the same keys): each
    block gathers its weights' data-axis dims inside itself, the token
    table and the head at their use (the dense GQA and the MoE stacks:
    ``blocks.check_fsdp``)."""
    blocks_lib.check_tp(cfg)
    specs = param_specs or {}
    if param_specs is not None:
        blocks_lib.check_fsdp(cfg)
    embed = params["embed"]
    # the tables are looked up in their own dtype, as the reference's
    # (the lookup's gradient is accumulated in it)
    x = embed_tokens(_used(embed, specs.get("embed"), None, ("tok", "pos")),
                     tokens, cfg)
    num_patches = 0
    if patch_embeds is not None:
        dt = x.dtype
        proj = patch_embeds.to(dt) @ params["projector"]["w"].to(dt)
        x = torch.cat([proj, x], dim=1)
        num_patches = patch_embeds.shape[1]
    rope = forward_rope(cfg, x.shape[1], device=tokens.device,
                        num_patches=num_patches)
    enc_out = encode(params, enc_embeds, cfg) \
        if cfg.is_encdec and enc_embeds is not None else None
    x, aux_total = _run_blocks(params["blocks"], x, rope, cfg, return_aux,
                               enc_out, specs.get("blocks"))
    dt = compute_dtype(cfg)
    x = apply_norm(_used(params["norm_f"], specs.get("norm_f"), dt), x, cfg)
    if num_patches:
        x = x[:, num_patches:]
    head = ("tok",) if cfg.tie_embeddings else ("head",)
    out = x if return_hidden else lm_head(
        _used(embed, specs.get("embed"), dt, head), x, cfg)
    return (out, aux_total) if return_aux else out


def _requires_grad(tree) -> bool:
    if isinstance(tree, dict):
        return any(_requires_grad(v) for v in tree.values())
    return tree.requires_grad


# the block cache's state: one KVCache per layer, each covering the whole
# canvas: (B, total, G, hd) K and V, or MLA's latents (``KVCache``)
CacheState = List[KVCache]


def capture_cache(params: Params, tokens: torch.Tensor,
                  cfg: ModelConfig) -> CacheState:
    """One full bidirectional pass over the canvas (B, total) keeping every
    layer's K/V: the prefill and block-boundary refresh of the block
    cache.  No LM head: refresh logits are never used (the next window
    forward scores the live rows anyway)."""
    blocks_lib.check_tp(cfg)
    x = embed_tokens(params["embed"], tokens, cfg)
    rope = forward_rope(cfg, tokens.shape[1], device=tokens.device)
    state: CacheState = []
    for i, p in enumerate(params["blocks"]):
        x, kv = blocks_lib.block_capture(p, x, rope, cfg, i)
        state.append(kv)
    return state


def forward_cached(params: Params, tokens: torch.Tensor, win_start: int,
                   state: CacheState, cfg: ModelConfig) -> torch.Tensor:
    """Score a W-row live window (B, W) at ``win_start`` against the cache
    from ``capture_cache``.  Read-only with respect to the cache: each
    layer writes its fresh window K/V into a copy and attends over all
    ``total`` keys.  Its RoPE tables are those of positions ``win_start
    ..`` of the canvas (under M-RoPE the text-only streams, from 1, as
    the capture's).  Returns logits (B, W, V) float32."""
    blocks_lib.check_tp(cfg)
    x = embed_tokens(params["embed"], tokens, cfg, win_start)
    rope = forward_rope(cfg, tokens.shape[1], win_start, tokens.device)
    for i, (p, kv) in enumerate(zip(params["blocks"], state)):
        x = blocks_lib.block_cached(p, x, rope, cfg, i, kv, win_start)
    x = apply_norm(params["norm_f"], x, cfg)
    return lm_head(params["embed"], x, cfg)


# --------------------------------------------------------------------------
# the decode state: one token (decode_step) or a W-token window
# (forward_window) against per-layer caches and recurrent states
# --------------------------------------------------------------------------

class DecodeState(NamedTuple):
    """The reference's decode state: one entry per layer (a ``KVCache``,
    an xLSTM state, or Hymba's (``KVCache``, ``MambaState``) pair; the
    reference stacks each homogeneous group of layers instead) and the
    encoder's output (B, S, d) that an encoder-decoder's layers
    cross-attend over (None: no cross path)."""
    layer_states: List[Any]
    enc_out: Optional[torch.Tensor]


def init_decode_state(cfg: ModelConfig, batch: int, length: int,
                      dtype: torch.dtype = torch.bfloat16,
                      enc_out: Optional[torch.Tensor] = None,
                      valid_length: Optional[int] = None,
                      device="cuda") -> DecodeState:
    """Zeroed per-layer state for ``batch`` rows and a cache of
    ``length`` positions (the attention layers' K/V in ``dtype``; a
    sliding window's ring holds ``min(length, window)``).
    ``valid_length``: the caches' initial valid count (default
    ``length``: a warm cache, the serving contract; 0 for the cached
    sampler, which fills it block by block)."""
    dev = resolve_device(device)
    blocks_lib.check_tp(cfg)
    return DecodeState(
        [blocks_lib.init_layer_state(cfg, i, batch, length, dtype,
                                     valid_length, dev)
         for i in range(cfg.num_layers)], enc_out)


def _positions_and_rope(cfg: ModelConfig, positions: torch.Tensor,
                        dtype: torch.dtype):
    """The layers' positions ((B, L); M-RoPE's three streams all equal to
    it, (3, B, L)) and their RoPE tables."""
    if cfg.rope == "mrope":
        positions = positions[None].expand(3, *positions.shape)
    return positions, rope_tables(positions, model_rotary_dim(cfg), cfg,
                                  dtype)


def decode_step(params: Params, token: torch.Tensor, position: torch.Tensor,
                state: DecodeState, cfg: ModelConfig):
    """token (B, 1) at ``position`` (B, 1) -> (logits (B, 1, V) float32,
    the new state).  The attention caches of ``state`` are written in
    place at the step's slot (the returned state shares them); the
    slot and the valid count come from ``position`` on the device, so
    nothing is read back to the host."""
    blocks_lib.check_tp(cfg)
    x = embed_tokens(params["embed"], token, cfg, positions=position)
    positions, rope = _positions_and_rope(cfg, position, x.dtype)
    new_states = []
    for i, (p, st) in enumerate(zip(params["blocks"], state.layer_states)):
        x, st = blocks_lib.block_decode(p, x, rope, positions, cfg, i, st,
                                        state.enc_out)
        new_states.append(st)
    x = apply_norm(params["norm_f"], x, cfg)
    return lm_head(params["embed"], x, cfg), DecodeState(new_states,
                                                         state.enc_out)


def forward_window(params: Params, tokens: torch.Tensor,
                   positions: torch.Tensor, state: DecodeState,
                   cfg: ModelConfig, extend: Optional[str] = None):
    """Score a W-token window tokens (B, W) at ``positions`` (B, W) against
    the frozen prefix state (the cached semi-AR path): -> (logits (B, W, V)
    float32, the state).  ``extend`` (None, ``"kv"``, ``"recurrent"``:
    ``blocks.block_window``) advances one half of the state by the
    window; a ``"kv"`` extend writes the caches in place."""
    blocks_lib.check_tp(cfg)
    x = embed_tokens(params["embed"], tokens, cfg, positions=positions)
    _, rope = _positions_and_rope(cfg, positions, x.dtype)
    new_states = []
    for i, (p, st) in enumerate(zip(params["blocks"], state.layer_states)):
        x, st = blocks_lib.block_window(p, x, rope, cfg, i, st,
                                        state.enc_out, extend)
        new_states.append(st)
    x = apply_norm(params["norm_f"], x, cfg)
    return lm_head(params["embed"], x, cfg), DecodeState(new_states,
                                                         state.enc_out)


def set_valid_length(state: DecodeState, length: int) -> DecodeState:
    """The state with every attention cache's valid count set to
    ``length`` (after a ``"kv"`` extend wrote K/V for the future masks
    past the committed block)."""
    def fix(st):
        kv = blocks_lib.layer_cache(st)
        if kv is None:
            return st
        new = kv._replace(length=int(length))
        return new if st is kv else (new, st[1])
    return DecodeState([fix(st) for st in state.layer_states],
                       state.enc_out)
