"""The three production step functions (reference:
``src/repro/launch/steps.py``), one semantics for tests, examples and the
card alike.

* ``train``   — the Eq. 4 loss + AdamW update (``training.TrainStep``);
* ``prefill`` — one full bidirectional forward + confidence scoring, i.e.
                step 0 of the sampler;
* ``serve``   — ONE new token against a frozen KV/recurrent state of the
                contract length + confidence scoring (decode_32k,
                long_500k).

Scoring is ``core.confidence.score_logits``: the confidence kernel on a
card, its plain version on the CPU.  With a ``mesh`` (``launch/mesh.py``)
the steps run under it (``parallel.ctx.activation_mesh``) on this rank's
shards, the batch on ``data`` (each rank is given its own rows), and a
vocab-sharded head is scored by ``score_logits_sharded`` (the kernel's
per-shard partials, one gather over ``model``, the merge): the
reference's ``prefill`` scores the same way, and its ``serve`` with
``score_logits`` (its full-row top-k), which gives the same scores.
``train`` runs on the training layout's shards
(``parallel.sharding.shard_params(..., fsdp=True)``: FSDP over ``data``)
and its rows (``parallel.sharding.train_rows``), prefill and serve on the
serving layout's.

``serve`` writes the state's attention caches in place (``decode_step``):
the state it returns shares their buffers with the one it was given.
"""
from __future__ import annotations

from contextlib import ExitStack
from typing import Callable, Dict, Optional, Tuple

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.confidence import score_logits
from repro_torch.models.layers import lm_head
from repro_torch.models.model import decode_step, forward
from repro_torch.parallel import ctx
from repro_torch.training.trainer import TrainStep


def extra_input_names(cfg: ModelConfig) -> Tuple[str, ...]:
    """The batch's conditioning inputs a model's forward takes: an
    encoder-decoder's frame embeddings, a VLM's patch embeddings."""
    if cfg.encdec is None:
        return ()
    if cfg.encdec.frontend == "audio_stub":
        return ("enc_embeds",)
    if cfg.encdec.frontend == "vision_stub":
        return ("patch_embeds",)
    return ()


def make_steps(cfg: ModelConfig, tcfg: Optional[TrainConfig] = None,
               opts: frozenset = frozenset(),
               mesh=None) -> Dict[str, Callable]:
    """{"train", "prefill", "serve"} for ``cfg``.  ``opts`` may hold
    ``microbatch<n>`` (accumulate n slices' gradients) and
    ``bf16_gather`` (bf16 params in the loss, f32 masters), as the
    reference's.  ``mesh``: every step runs under it."""
    tcfg = tcfg or TrainConfig()
    extras = extra_input_names(cfg)
    micro = 1
    for o in opts:
        if o.startswith("microbatch"):
            micro = int(o[len("microbatch"):] or 1)

    def scope() -> ExitStack:
        stack = ExitStack()
        if mesh is not None:
            stack.enter_context(ctx.activation_mesh(mesh))
        stack.enter_context(ctx.with_vocab(cfg.vocab_size))
        return stack

    class ScopedTrainStep(TrainStep):
        """``TrainStep`` whose every call runs inside ``scope()``."""

        def grads(self, *args):
            with scope():
                return super().grads(*args)

        def apply(self, *args):
            with scope():
                return super().apply(*args)

        def __call__(self, *args):
            with scope():
                return super().__call__(*args)

    train_step = ScopedTrainStep(cfg, tcfg, extras,
                                 bf16_params="bf16_gather" in opts,
                                 microbatch=micro)

    def prefill_step(params, batch):
        """Full forward + confidence scoring: ``batch`` = {tokens (B, L),
        and each of the config's extra inputs} -> ``Scores``, each (B, L)."""
        kw = {k: batch[k] for k in extras}
        with scope():
            hidden = forward(params, batch["tokens"], cfg,
                             return_hidden=True, **kw)
            return score_logits(lm_head(params["embed"], hidden, cfg))

    def serve_step(params, token, position, state):
        """token (B, 1) at position (B, 1) -> (``Scores``, each (B, 1),
        the new state)."""
        with scope():
            logits, new_state = decode_step(params, token, position, state,
                                            cfg)
            return score_logits(logits), new_state

    return {"train": train_step, "prefill": prefill_step,
            "serve": serve_step}
