"""AdamW with a cosine-with-warmup schedule (reference:
``src/repro/training/optimizer.py``), as functions over the port's
parameter tree (``{"embed": {...}, "norm_f": {...}, "blocks": [...]}``).

The update keeps the reference's exact form: the step is incremented
first, ``lr = sched(step)``, gradients are clipped by their global norm,
β = (0.9, 0.95), eps = 1e-8, ``p − lr·(m̂/(√v̂ + eps) + wd·p)``, with
weight decay on every leaf, the norm scales included.  The step and the
schedule live on the host (a Python int, f32 arithmetic in numpy), so a
step on the card never waits for a readback.  ``adamw_update`` writes the
parameters and the moments in place and returns them: at LLaDA-8B's
width a second copy of either would not fit beside the first.

Sharded (``specs``: the training layout's spec tree, under the active
mesh), every rank updates its own shards of the parameters and moments;
the update is elementwise but for the clip, whose global norm sums each
leaf's squares over the mesh axes the leaf is cut on (a replicated copy
counts once): the same norm on every rank, the unsharded tree's.
"""
from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.parallel import ctx
from repro_torch.parallel.sharding import map_specs


class AdamWState(NamedTuple):
    step: int
    mu: dict
    nu: dict


def leaves(tree) -> List[torch.Tensor]:
    """The tree's tensors in a fixed order (dict keys as stored, list
    slots in order)."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def cosine_schedule(lr: float, warmup: int, total: int
                    ) -> Callable[[int], float]:
    """step -> learning rate: linear warmup to ``lr``, then a cosine to 0
    at ``total``; computed in f32 as the reference does."""
    f32 = np.float32

    def sched(step: int) -> float:
        s = f32(step)
        if s < warmup:
            return float(f32(lr) * (s / f32(max(warmup, 1))))
        prog = np.clip((s - f32(warmup)) / f32(max(total - warmup, 1)),
                       f32(0), f32(1))
        return float(f32(lr) * (f32(0.5) * (f32(1) + np.cos(f32(math.pi)
                                                            * prog))))
    return sched


def adamw_init(params) -> AdamWState:
    return AdamWState(step=0, mu=tree_map(torch.zeros_like, params),
                      nu=tree_map(torch.zeros_like, params))


def global_norm(tree) -> torch.Tensor:
    """√(Σ x²) over every leaf, as a 0-dim f32 tensor on the leaves'
    device."""
    norms = torch._foreach_norm([t.float() for t in leaves(tree)])
    return torch.linalg.vector_norm(torch.stack(norms))


def sharded_global_norm(tree, specs) -> torch.Tensor:
    """``global_norm`` of the whole tree of which ``tree`` holds this
    rank's shards under ``specs`` and the active mesh: the squares of the
    leaves cut on ``data`` summed over ``data``, then those cut on
    ``model`` over ``model`` (one all-reduce an axis, in f32).  A leaf's
    squares are summed as a dot product: blocked on the CPU, where f32
    norms sum one element at a time (~1e-5 off at 10⁶ elements)."""
    pairs = leaves(map_specs(lambda t, s: (t, s), tree, specs))
    dev = pairs[0][0].device
    # a leaf's slot: 0 replicated, 1 on data only, 2 on model only, 3 both
    slots = []
    for _, spec in pairs:
        axes = {a for e in spec for a in ctx.entry_axes(e)}
        slots.append(("data" in axes) + 2 * ("model" in axes))
    squares = torch.stack([torch.dot(x, x) for x in
                           (t.float().reshape(-1) for t, _ in pairs)])
    sq = torch.zeros(4, dtype=torch.float32, device=dev).index_add_(
        0, torch.tensor(slots, device=dev), squares)
    sq[1:4:2] = ctx.sum_data(sq[1:4:2])
    sq[2:] = ctx.sum_model(sq[2:])
    return torch.sqrt(sq.sum())


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, sched,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.01, clip_norm: float = 1.0,
                 specs=None) -> Tuple[dict, AdamWState]:
    """One AdamW step.  ``grads`` (consumed: scaled in place) has the
    tree of ``params``; ``params`` and the state's moments are written in
    place.  ``specs``: the three trees are this rank's shards in the
    training layout under the active mesh (the clip's norm is then
    ``sharded_global_norm``).  Returns ``(params, new state)``."""
    step = state.step + 1
    g, p = leaves(grads), leaves(params)
    m, v = leaves(state.mu), leaves(state.nu)
    gnorm = global_norm(grads) if specs is None else \
        sharded_global_norm(grads, specs)
    scale = torch.clamp(clip_norm / torch.clamp_min(gnorm, 1e-9), max=1.0)
    torch._foreach_mul_(g, scale)
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, g, alpha=1 - b1)
    torch._foreach_mul_(v, b2)
    torch._foreach_addcmul_(v, g, g, value=1 - b2)
    f32 = np.float32
    bc1 = float(f32(1) - f32(b1) ** f32(step))
    bc2 = float(f32(1) - f32(b2) ** f32(step))
    lr = sched(step)
    # one leaf at a time: the update's temporaries stay one leaf's size
    for pi, mi, vi in zip(p, m, v):
        denom = torch.sqrt(vi / bc2).add_(eps)
        upd = (mi / bc1).div_(denom).add_(pi, alpha=weight_decay)
        pi.add_(upd, alpha=-lr)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu)
