"""``make_model_fn``: a conditioned forward built from params (reference:
``src/repro/core/sampler.py``).

The semi-autoregressive block sampler is the ``Decoder``
(``core/decoder.py``), re-exported here as the reference does::

    Decoder(model_fn, cfg, dcfg).generate(rng, prompt)        # plain
    Decoder(params, cfg, dcfg).generate(rng, prompt, enc_embeds=e)
    Decoder(params, cfg, dcfg).generate(rng, prompt, patch_embeds=p)
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.decoder import (Decoder, SampleStats,  # noqa: F401
                                      _tiling_forward)


def make_model_fn(params, cfg: ModelConfig, **extras) -> Callable:
    """tokens (B', L) -> logits, with the conditioning inputs
    (``enc_embeds``, ``patch_embeds``) tiled to match B'.  FDM folds its K candidates into
    the batch axis (B' = K·B, candidate-major), so the conditioning is
    replicated candidate-major too, as the reference's ``jnp.tile``."""
    return _tiling_forward(params, cfg, {k: torch.as_tensor(v)
                                         for k, v in extras.items()})
