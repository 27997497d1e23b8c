"""The training loop: the Eq. 4 masked-diffusion objective + AdamW
(reference: ``src/repro/training/trainer.py``).

Gradients come from autograd over the model's forward: on the card that
forward runs the flash-attention kernel, whose ``autograd.Function``
recomputes the probabilities in its backward
(``kernels/flash_attention.py``), and the bf16 LM head's f32-output GEMM
(``models/layers.py:HeadMatmul``), and for Hymba the selective-scan
kernel, whose ``autograd.Function`` recomputes the state chunk by chunk
in its backward (``kernels/selective_scan.py``).  An MoE model's
objective is the masked cross-entropy plus its layers' router aux loss,
as the reference's: autograd reaches the experts through the dispatch's
gathers and the router through the sorted gates and the aux term
(``models/moe.py``).  The confidence kernel
is never on a training path (it raises under grad).  Master weights are
f32; the forward casts them to the compute dtype at each matmul.

A step is split at the corruption: ``TrainStep.__call__`` draws
``(corrupted, masked, t)`` from its generator, ``TrainStep.apply`` takes
them as given, so a test can inject the reference's draws.

Under a mesh (a step run inside ``parallel.ctx.activation_mesh``, as
``launch.steps.make_steps(..., mesh=)`` runs it) the step runs on this
rank's shards in the training layout (``parallel.sharding.shard_params(..., fsdp=True)``:
FSDP weights and AdamW moments over ``data``; heads, ffn columns and the
vocab over ``model``) and on its rows of the batch
(``parallel.sharding.train_rows``), as the reference's one step lowers on
a mesh: the forward gathers each weight at its use, the loss is the
rank's rows' share of the whole batch's (``core/loss.py``), the
gradients come back summed over ``data`` and cut to the rank's shards,
the clip's norm is the whole tree's, and the metrics are the whole
batch's on every rank.  The corruption is drawn for the whole batch from
the one generator and each rank keeps its rows, so the draws are one
rank's.  The dense GQA stacks and the MoE stacks (Mixtral's GQA,
DeepSeek-V2's MLA) train so (``models.blocks.check_fsdp``).  An MoE
model's objective on a data rank is its rows' share of the
cross-entropy plus the whole aux loss, and every weight's gradient is
summed over ``data``; the aux loss back-propagates ``g / n`` on each data
rank (``models/moe.py``), so the sum holds it once, and the gradient is
the reference's ``loss + aux``; the ``aux`` metric is the whole aux.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.loss import masked_cross_entropy, token_accuracy
from repro_torch.core.masking import apply_mask, sample_mask_ratio
from repro_torch.device import resolve_device
from repro_torch.models.blocks import check_fsdp
from repro_torch.models.model import forward, init_model
from repro_torch.parallel import ctx
from repro_torch.parallel.sharding import (local_shape, map_specs,
                                           param_pspecs, train_rows)
from repro_torch.training.checkpoint import save
from repro_torch.training.optimizer import (AdamWState, adamw_init,
                                            adamw_update, cosine_schedule,
                                            leaves, tree_map)

# a step's corruption: (corrupted tokens (B, L), masked (B, L) bool,
# t (B,) f32)
Corruption = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def corrupt(generator: torch.Generator, tokens: torch.Tensor,
            maskable: torch.Tensor, cfg: ModelConfig,
            rows: Optional[Tuple[int, np.ndarray]] = None) -> Corruption:
    """Draw a step's corruption: t per row, then the masked positions.
    ``rows`` (the whole batch's row count, the indices of ``tokens``' rows
    in it; default: ``tokens`` is the whole batch): drawn for the whole
    batch, these rows kept."""
    n, idx = rows if rows is not None else \
        (tokens.shape[0], np.arange(tokens.shape[0]))
    idx = torch.as_tensor(idx, device=tokens.device)
    whole = tokens.new_zeros((n,) + tokens.shape[1:]).index_copy_(
        0, idx, tokens)
    keep = maskable.new_zeros(whole.shape).index_copy_(0, idx, maskable)
    t = sample_mask_ratio(generator, n, tokens.device)
    corrupted, masked = apply_mask(generator, whole, t, cfg, keep)
    return corrupted[idx], masked[idx], t[idx]


class TrainStep:
    """``step(params, opt_state, generator, batch) -> (params, opt_state,
    metrics)``; ``batch`` = {tokens (B, L) int, maskable (B, L) bool,
    and each key of ``extra_inputs``}, on the params' device.  The
    objective is ``loss + aux`` (the MoE layers' aux loss, 0 without
    them); the metrics are the masked cross-entropy ``loss`` alone, ``aux``
    and ``acc``.  ``extra_inputs`` names the batch's conditioning inputs
    that go to the forward (an encoder-decoder's ``("enc_embeds",)``).

    ``bf16_params=True`` casts the f32 masters to bf16 once at the top of
    the loss (the reference's mixed-precision ZeRO option); the optimizer
    still updates the f32 masters.  ``microbatch > 1`` accumulates the
    gradients of that many equal slices of the batch, then averages them
    and the metrics.

    Under the active mesh (``parallel.ctx.activation_mesh``) the step runs
    on this rank's shards in the training layout and on its rows (the
    module docstring)."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig,
                 extra_inputs: Tuple[str, ...] = (),
                 bf16_params: bool = False, microbatch: int = 1):
        self.cfg, self.tcfg = cfg, tcfg
        self.extra_inputs = tuple(extra_inputs)
        self.bf16_params, self.microbatch = bf16_params, microbatch
        self.sched = cosine_schedule(tcfg.lr, tcfg.warmup, tcfg.steps)
        self._layouts = {}

    def _specs(self, params):
        """None off a mesh; under the active mesh the training layout's
        spec tree (``param_pspecs(..., fsdp=True)`` of the config's params
        on ``meta``), whose shards ``params`` must be (``ValueError``
        otherwise)."""
        mesh = ctx.active()
        if mesh is None:
            return None
        check_fsdp(self.cfg)
        key = tuple(sorted(mesh.shape.items()))
        if key not in self._layouts:
            full = init_model(self.cfg, device="meta", dtype=torch.float32)
            self._layouts[key] = (full, param_pspecs(full, mesh, fsdp=True))
        full, specs = self._layouts[key]

        def check(pair, p):
            want = local_shape(tuple(pair[0].shape), pair[1], mesh)
            if tuple(p.shape) != want:
                raise ValueError(
                    f"a leaf of shape {tuple(p.shape)} where this mesh's "
                    f"training layout has {want}: train on "
                    f"parallel.sharding.shard_params(params, mesh, "
                    f"fsdp=True)")
        map_specs(check, map_specs(lambda f, s: (f, s), full, specs), params)
        return specs

    def loss(self, params, batch: Dict[str, torch.Tensor],
             corruption: Corruption, specs=None):
        """(objective, metrics) of one (micro)batch under ``corruption``:
        the objective is the masked cross-entropy plus the aux loss.
        ``specs``: ``params`` are training-layout shards under the active
        mesh; the loss and accuracy are then this rank's rows' shares."""
        tokens = batch["tokens"]
        if self.bf16_params:
            params = tree_map(lambda p: p.to(torch.bfloat16)
                              if p.dtype == torch.float32 else p, params)
        corrupted, masked, t = corruption
        kw = {k: batch[k] for k in self.extra_inputs}
        logits, aux = forward(params, corrupted, self.cfg, return_aux=True,
                              param_specs=specs, **kw)
        loss, _ = masked_cross_entropy(logits, tokens, masked, t)
        acc = token_accuracy(logits.detach(), tokens, masked)
        return loss + aux, {"loss": loss.detach(), "aux": aux.detach(),
                            "acc": acc}

    def grads(self, params, batch: Dict[str, torch.Tensor],
              corruption: Corruption):
        """(gradients of the objective in the tree of ``params``, metrics).
        With ``microbatch > 1`` each slice is a forward of its own (an MoE
        layer's capacity is reckoned from the slice's tokens, as in the
        reference), and the gradients and metrics are the slices' means.
        Under a mesh: this rank's shards' gradients of the whole batch's
        objective, and the whole batch's metrics."""
        specs = self._specs(params)
        leaf = leaves(params)
        n = self.microbatch
        if n == 1:
            loss, metrics = self.loss(params, batch, corruption, specs)
            flat = list(torch.autograd.grad(loss, leaf))
        else:
            flat, mets = None, []
            for i in range(n):
                sl = slice(i * len(batch["tokens"]) // n,
                           (i + 1) * len(batch["tokens"]) // n)
                loss, met = self.loss(params, {k: v[sl] for k, v in
                                               batch.items()},
                                      tuple(c[sl] for c in corruption),
                                      specs)
                g = torch.autograd.grad(loss, leaf)
                flat = list(g) if flat is None else \
                    torch._foreach_add(flat, g)
                mets.append(met)
            torch._foreach_div_(flat, float(n))
            metrics = {k: torch.stack([m[k] for m in mets]).mean(0)
                       for k in mets[0]}
        if specs is not None:
            # the data ranks' shares of the whole batch's loss and accuracy
            metrics = {"loss": ctx.sum_data(metrics["loss"]),
                       "aux": ctx.mean_data(metrics["aux"]),
                       "acc": ctx.sum_data(metrics["acc"])}
        it = iter(flat)
        return tree_map(lambda _: next(it), params), metrics

    def apply(self, params, opt_state: AdamWState,
              batch: Dict[str, torch.Tensor], corruption: Corruption):
        """The step under a given corruption: gradients, then AdamW (the
        masters and the moments are updated in place)."""
        grads, metrics = self.grads(params, batch, corruption)
        params, opt_state = adamw_update(
            grads, opt_state, params, self.sched,
            weight_decay=self.tcfg.weight_decay,
            clip_norm=self.tcfg.clip_norm, specs=self._specs(params))
        return params, opt_state, metrics

    def __call__(self, params, opt_state: AdamWState,
                 generator: torch.Generator,
                 batch: Dict[str, torch.Tensor]):
        mesh = ctx.active()
        tokens = batch["tokens"]
        rows = None
        if mesh is not None:
            n = tokens.shape[0] * mesh.shape["data"]
            rows = (n, train_rows(n, mesh, microbatch=self.microbatch))
        corruption = corrupt(generator, tokens, batch["maskable"], self.cfg,
                             rows)
        return self.apply(params, opt_state, batch, corruption)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    extra_inputs: Tuple[str, ...] = (),
                    bf16_params: bool = False,
                    microbatch: int = 1) -> TrainStep:
    return TrainStep(cfg, tcfg, extra_inputs, bf16_params=bf16_params,
                     microbatch=microbatch)


def to_device_batch(batch: Dict[str, np.ndarray], device
                    ) -> Dict[str, torch.Tensor]:
    """A ``TaskDataset`` batch -> {tokens int64, maskable bool} on
    ``device``."""
    return {"tokens": torch.from_numpy(np.asarray(batch["tokens"],
                                                  np.int64)).to(device),
            "maskable": torch.from_numpy(np.asarray(batch["maskable"],
                                                    bool)).to(device)}


def masters(params) -> dict:
    """f32 copies of ``params`` that require grad (the caller's tensors
    are left as they are)."""
    return tree_map(lambda p: p.detach().to(torch.float32, copy=True)
                    .requires_grad_(True), params)


def train(cfg: ModelConfig, tcfg: TrainConfig,
          batches: Iterator[Dict[str, np.ndarray]], params=None,
          log: Optional[Callable[[str], None]] = print,
          eval_fn: Optional[Callable] = None,
          device="cuda") -> Tuple[dict, Dict]:
    """Run ``tcfg.steps`` steps over the ``batches`` iterator on
    ``device``.  ``params`` (default: ``init_model`` from ``tcfg.seed``)
    are copied to f32 masters.  Returns the trained f32 params, with
    ``requires_grad`` off (ready for ``Decoder`` and ``ServingEngine``),
    and a history of ``loss``, ``aux``, ``acc`` and ``seconds`` (since the
    first step) at each logged step (``step`` 1, every ``tcfg.log_every``-th and
    the last).  ``eval_fn(params, step)`` runs every
    ``tcfg.eval_every`` steps.  With ``tcfg.ckpt_dir`` the result is saved
    to ``final.npz`` there, in the reference's layout."""
    dev = resolve_device(device)
    generator = torch.Generator(device=dev).manual_seed(tcfg.seed)
    if params is None:
        params = init_model(cfg, generator, dev, dtype=torch.float32)
    params = masters(params)
    opt_state = adamw_init(params)
    step_fn = make_train_step(cfg, tcfg)
    history = {"step": [], "loss": [], "aux": [], "acc": [], "seconds": []}
    t0 = time.perf_counter()
    for step in range(1, tcfg.steps + 1):
        batch = to_device_batch(next(batches), dev)
        params, opt_state, metrics = step_fn(params, opt_state, generator,
                                             batch)
        if step % tcfg.log_every == 0 or step == 1 or step == tcfg.steps:
            loss, acc = float(metrics["loss"]), float(metrics["acc"])
            history["step"].append(step)
            history["loss"].append(loss)
            history["aux"].append(float(metrics["aux"]))
            history["acc"].append(acc)
            history["seconds"].append(time.perf_counter() - t0)
            if log:
                log(f"step {step:5d}  loss {loss:.4f}  masked-acc "
                    f"{acc:.3f}  ({history['seconds'][-1]:.1f}s)")
        if eval_fn and step % tcfg.eval_every == 0:
            eval_fn(params, step)
    params = tree_map(lambda p: p.detach().requires_grad_(False), params)
    if tcfg.ckpt_dir:
        save(f"{tcfg.ckpt_dir}/final.npz", params, opt_state, tcfg.steps)
    return params, history
