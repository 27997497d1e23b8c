"""Stand-ins of every dry-run combination's step arguments (reference:
``src/repro/launch/specs.py``).

``input_specs(cfg, shape_name, batch)`` returns ``SpecBundle(kind,
args)``: the positional arguments of ``make_steps(cfg)[kind]`` built on
torch's ``meta`` device — the counterpart of ``jax.eval_shape``: shapes
and dtypes, no storage.  One card forms no mesh, so there are no
partition specs.  ``step_args`` builds the same arguments on any device
(the tests hold a meta run against a CPU run of the same arguments).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import compute_dtype
from repro_torch.models.model import init_decode_state, init_model
from repro_torch.training.optimizer import adamw_init, tree_map

# shape id -> (step kind, seq_len, global_batch)
SHAPES: Dict[str, Tuple[str, int, int]] = {
    "train_4k":    ("train",   4_096, 256),
    "prefill_32k": ("prefill", 32_768, 32),
    "decode_32k":  ("serve",   32_768, 128),
    "long_500k":   ("serve",   524_288, 1),
}


class SpecBundle(NamedTuple):
    kind: str
    args: Tuple            # positional args for the step fn (meta tensors)


def shape_admissible(cfg: ModelConfig, shape_name: str) -> bool:
    """long_500k only for sub-quadratic archs (DESIGN.md §Arch-applicability)."""
    if shape_name == "long_500k":
        return cfg.subquadratic
    return True


def _extras(cfg: ModelConfig, batch: int, gen: torch.Generator,
            dev: torch.device) -> dict:
    """Stub-frontend inputs: seeded frame / patch embeddings."""
    out = {}
    if cfg.encdec is None:
        return out
    dt = compute_dtype(cfg)
    if cfg.encdec.frontend == "audio_stub":
        out["enc_embeds"] = torch.randn(
            batch, cfg.encdec.encoder_seq, cfg.d_model, generator=gen,
            device=dev).to(dt)
    if cfg.encdec.frontend == "vision_stub":
        out["patch_embeds"] = torch.randn(
            batch, cfg.encdec.num_patch_tokens, cfg.d_model, generator=gen,
            device=dev).to(dt)
    return out


def step_args(cfg: ModelConfig, kind: str, seq: int, batch: int,
              device="meta", generator: Optional[torch.Generator] = None
              ) -> tuple:
    """The positional arguments of ``make_steps(cfg)[kind]`` on
    ``device``, drawn from ``generator`` (a CPU generator seeded with 0 by
    default; it draws meta stand-ins too):

    * train   — (f32 masters that require grad, ``adamw_init`` of them,
                the generator, {tokens (B, L) int64, maskable (B, L) bool,
                the config's extra inputs});
    * prefill — (params in the compute dtype, {tokens, extras});
    * serve   — (params in the compute dtype, token (B, 1) int64, its
                position seq − 1 (B, 1) int32, ``init_decode_state(cfg,
                B, seq)`` in the compute dtype, warm, with whisper's
                ``enc_out``)."""
    dev = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    if kind == "train":
        params = tree_map(lambda p: p.requires_grad_(True),
                          init_model(cfg, gen, dev, dtype=torch.float32))
        batch_in = {"tokens": torch.zeros(batch, seq, dtype=torch.int64,
                                          device=dev),
                    "maskable": torch.ones(batch, seq, dtype=torch.bool,
                                           device=dev),
                    **_extras(cfg, batch, gen, dev)}
        return params, adamw_init(params), gen, batch_in
    params = init_model(cfg, gen, dev)
    if kind == "prefill":
        return params, {"tokens": torch.zeros(batch, seq, dtype=torch.int64,
                                              device=dev),
                        **_extras(cfg, batch, gen, dev)}
    if kind != "serve":
        raise ValueError(f"unknown step kind {kind!r}")
    enc = _extras(cfg, batch, gen, dev).get("enc_embeds")
    state = init_decode_state(cfg, batch, seq, compute_dtype(cfg),
                              enc_out=enc, device=dev)
    token = torch.zeros(batch, 1, dtype=torch.int64, device=dev)
    position = torch.full((batch, 1), seq - 1, dtype=torch.int32,
                          device=dev)
    return params, token, position, state


def input_specs(cfg: ModelConfig, shape_name: str,
                batch: Optional[int] = None) -> SpecBundle:
    """Meta stand-ins of ``shape_name``'s step arguments at ``batch``
    (default: the shape's global batch)."""
    kind, seq, shape_batch = SHAPES[shape_name]
    return SpecBundle(kind, step_args(cfg, kind, seq,
                                      batch or shape_batch, "meta"))
