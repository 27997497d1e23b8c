"""Mixture-of-Experts of the port (reference: ``src/repro/models/moe.py``):
a top-k router and a capacity-based, sort-and-gather dispatch over
stacked expert weights.

* Routing: an f32 softmax over the router's logits, the top k with ties
  to the lower expert id (``jax.lax.top_k``'s rule, here a stable
  descending sort), the gates divided by their sum.
* Dispatch: the (token, slot) pairs are sorted stably by expert id, and
  expert e reads the contiguous run [offset_e, offset_e + C) of that order
  into its row of the (E, C) slot grid (slots past its count are zeroed).
  One batched SwiGLU runs over the grid; the combine gathers each pair's
  output back by its rank in the sort, zeroes the pairs past capacity
  (dropped, as in Switch/GShard) and sums the k outputs weighted by the
  gates.
* Capacity C = ⌊T·k·factor/E⌋ + 1, rounded up to a multiple of 128, is a
  Python int of the static T = B·L, so the dispatch has fixed shapes and
  runs inside a captured CUDA graph: no op here reads a device value back
  (no ``nonzero``, boolean-mask indexing, ``bincount`` or ``.item()``).
  T counts every row of a batch, so which tokens drop can depend on a
  request's batchmates, as in the reference.

The expert products are ``torch.bmm`` over the stacked weights (the
reference's einsums, outside any Pallas kernel): f32 accumulation, the
result rounded to the compute dtype, ``silu(gate) · up`` in that dtype.
DeepSeek-style shared experts (``moe.num_shared_experts``) are one
always-on SwiGLU of width ``moe_d_ff × num_shared_experts`` over every
token, added to the routed output.
Under a mesh (``parallel/ctx.py``), as the reference's rules place the
experts (``parallel/sharding.py``):

* expert-parallel when E divides the model axis: each rank holds E/tp
  experts, routes every token as every other rank does (same router, same
  capacity from the same T, so drops and slots are the reference's),
  runs the batched GEMMs of its own experts and combines only their
  pairs; a sum over ``model`` completes the output.  Otherwise the
  experts are tensor-parallel in their ffn dim: every rank runs every
  expert's column shard, and the same sum completes the row-parallel
  down product;
* the grouped dispatch (the reference's ``vmap`` over data groups): with
  the experts not expert-parallel and each data rank holding T/g ≥ 1024
  tokens, each data rank dispatches its own rows at its own capacity and
  the aux loss is the mean over groups.  Where the reference keeps the
  dispatch global (expert-parallel, or fewer tokens), the tokens are
  gathered over ``data`` first, so capacity and drops match, and each
  rank keeps its own rows of the output.

Training under a mesh takes the gradients the reference's one program
has.  Under the model axis each rank back-propagates only its own
experts' (or ffn columns') share of the dispatch: the experts' input and
the router logits behind the gates enter the tensor-parallel region
(``ctx.enter_model``: their gradients summed over ``model``), while the
aux loss, which every model rank computes whole from the same logits,
reaches the replicated router outside it, once.  Over the data axis
every weight's gradient is summed (``ctx.use_param``), so a term that
each data rank's objective holds whole counts once only as ``g / n``: the
grouped dispatch's mean over groups (``ctx.mean_data``) and the global
dispatch's aux over the gathered tokens (``ctx.share_data``) both
back-propagate that share, and the gathered tokens' gradient is summed
over ``data`` before each rank takes its rows (``ctx.gather_data``).
The shared experts follow the dense MLP's tensor parallelism.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (Params, apply_mlp, dense_init,
                                       init_mlp, sharded)
from repro_torch.parallel import ctx


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def capacity(num_tokens: int, cfg: ModelConfig, factor: float = 1.25) -> int:
    """Slots per expert for ``num_tokens`` tokens (the reference's rule)."""
    e, k = cfg.moe.num_experts, cfg.moe.num_experts_per_tok
    c = int(num_tokens * k * factor / e) + 1
    return max(_round_up(c, 128), 128)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init_moe(gen: torch.Generator, cfg: ModelConfig, device,
             dtype) -> Params:
    """The router (d, E) and the stacked SwiGLU experts (E, d, ff),
    (E, d, ff), (E, ff, d); with shared experts also ``shared``, one
    SwiGLU of width ff × ``num_shared_experts``.  ``dense_init`` takes the
    fan-in from ``shape[0]``, so the experts are drawn with σ = 1/√E, as
    the reference's are: kept on purpose, so both packages' random
    weights share one distribution."""
    m = cfg.moe
    d, ff, e = cfg.d_model, m.moe_d_ff, m.num_experts
    p = {"router": dense_init(gen, (d, e), device, dtype, scale=0.02),
         "w_gate": dense_init(gen, (e, d, ff), device, dtype),
         "w_up": dense_init(gen, (e, d, ff), device, dtype),
         "w_down": dense_init(gen, (e, ff, d), device, dtype)}
    if m.num_shared_experts:
        p["shared"] = init_mlp(gen, cfg, device, dtype,
                               d_ff=ff * m.num_shared_experts)
    return p


# --------------------------------------------------------------------------
# routing
# --------------------------------------------------------------------------

def router_topk(logits: torch.Tensor,
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (T, E) -> (gates (T, k) f32 normalised, expert ids (T, k)).
    A stable descending sort keeps tied experts in id order, so the top k
    break ties toward the lower id, as ``jax.lax.top_k`` does."""
    probs = torch.softmax(logits.float(), dim=-1)
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[..., :k], ids[..., :k]
    return gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9), ids


def load_balance_loss(logits: torch.Tensor, ids: torch.Tensor,
                      num_experts: int) -> torch.Tensor:
    """Switch-style aux loss E · Σ_e f_e · P_e, plus 1e-3 × the router
    z-loss (f32 scalar)."""
    lf = logits.float()
    probs = torch.softmax(lf, dim=-1)                            # (T, E)
    frac_routed = F.one_hot(ids, num_experts).float().mean(dim=(0, 1))
    frac_prob = probs.mean(dim=0)
    aux = num_experts * torch.sum(frac_routed * frac_prob)
    z = torch.mean(torch.square(torch.logsumexp(lf, dim=-1)))
    return aux + 1e-3 * z


class Routing(NamedTuple):
    """Where each (token, slot) pair goes: pair j = token j // k, slot
    j % k.  ``slot[j]`` is the pair's position in its expert's run of the
    sorted order; it is dropped when ``slot[j] >= capacity``."""
    gates: torch.Tensor       # (T, k) f32
    ids: torch.Tensor         # (T, k) int64 expert ids
    order: torch.Tensor       # (T·k,) pairs stably sorted by expert id
    counts: torch.Tensor      # (E,) pairs routed to each expert
    offsets: torch.Tensor     # (E,) start of each expert's run in ``order``
    slot: torch.Tensor        # (T·k,)
    capacity: int


def route(logits: torch.Tensor, cfg: ModelConfig, cap: int) -> Routing:
    """The top-k routing of router logits (T, E) and the sort that lays
    the pairs out by expert, for ``cap`` slots per expert."""
    e, k = cfg.moe.num_experts, cfg.moe.num_experts_per_tok
    gates, ids = router_topk(logits, k)
    flat_e = ids.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    rank = torch.argsort(order, stable=True)                     # inverse
    # one_hot with num_classes checks nothing on a card (no readback)
    counts = F.one_hot(flat_e, e).sum(0)
    offsets = torch.cumsum(counts, 0) - counts
    return Routing(gates, ids, order, counts, offsets,
                   rank - offsets[flat_e], cap)


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _dispatch(p: Params, tokens: torch.Tensor, cfg: ModelConfig,
              capacity_factor: float, need_aux: bool
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """tokens (T, d) -> (out (T, d), aux f32 scalar or None)."""
    m = cfg.moe
    t, d = tokens.shape
    k, e = m.num_experts_per_tok, m.num_experts
    dt = tokens.dtype
    # this rank's experts [e0, e0 + el): all of them off a mesh or under
    # the ffn split, E/tp of them expert-parallel
    el = p["w_gate"].shape[0]
    ep = sharded(el, e, "moe/w_gate's experts")
    ffn_tp = sharded(p["w_down"].shape[1], m.moe_d_ff, "moe/w_down's rows")
    e0 = ctx.model_rank() * el if ep else 0
    # under either split the experts' input and the gates' logits enter
    # the tensor-parallel region: each rank back-propagates only its
    # experts' or columns' share of them; the aux loss, whole on every
    # rank, back-propagates outside it (once)
    enter = ctx.enter_model if ep or ffn_tp else (lambda x: x)

    logits = tokens @ p["router"].to(dt)                         # (T, E)
    r = route(enter(logits), cfg, capacity(t, cfg, capacity_factor))
    c = r.capacity
    aux = load_balance_loss(logits, r.ids, e) * m.router_aux_coef \
        if need_aux else None

    # each expert's slot row reads its contiguous run of the sorted order
    slots = torch.arange(c, device=tokens.device)
    offsets, counts = r.offsets[e0:e0 + el], r.counts[e0:e0 + el]
    slot_idx = (offsets[:, None] + slots[None, :]).clamp_(0, t * k - 1)
    slot_valid = slots[None, :] < counts[:, None]                # (E, C)
    tok = (r.order // k)[slot_idx]                               # (E, C)
    xs = enter(tokens).index_select(0, tok.reshape(-1)).reshape(el, c, d) \
        * slot_valid[..., None].to(dt)

    # one batched SwiGLU over the experts
    h = F.silu(torch.bmm(xs, p["w_gate"].to(dt))) \
        * torch.bmm(xs, p["w_up"].to(dt))
    ys = torch.bmm(h, p["w_down"].to(dt))                        # (E, C, d)

    # combine: pair j sits at expert ids[j], position slot[j]
    keep = r.slot < c
    ids = r.ids.reshape(-1)
    if ep:                      # only this rank's experts' pairs
        ids = ids - e0
        keep = keep & (ids >= 0) & (ids < el)
        ids = ids.clamp(0, el - 1)
    flat_out = ys[ids, r.slot.clamp(0, c - 1)] * keep[:, None].to(dt)
    out = (flat_out.reshape(t, k, d) * r.gates[..., None].to(dt)).sum(1)
    return (ctx.sum_model(out) if ep or ffn_tp else out), aux


def moe_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                capacity_factor: float = 1.25, need_aux: bool = True
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x (B, L, d) -> (out (B, L, d), aux loss f32 scalar); the dispatch is
    global over all B·L tokens (of every data rank, under a mesh), or
    grouped by data rank (the module's docstring); the shared experts, if
    any, see the same input as the router.  ``need_aux=False`` skips the
    aux loss (a decode never reads it) and returns ``None`` in its
    place."""
    m = cfg.moe
    b, l, d = x.shape
    tokens = x.reshape(b * l, d)
    gd, _ = ctx.shard_counts()
    msize = ctx.model_size()
    if msize > 1 and m.num_experts % msize == 0:
        gd = 1                  # expert-parallel: the global dispatch
    if gd > 1 and b * l >= 1024:
        out, aux = _dispatch(p, tokens, cfg, capacity_factor, need_aux)
        aux = ctx.mean_data(aux) if need_aux else None
    elif ctx.axis_size("data") > 1:
        everyone = ctx.gather_data(tokens).reshape(-1, d)
        out, aux = _dispatch(p, everyone, cfg, capacity_factor, need_aux)
        # every data rank computed the same aux over the gathered tokens
        aux = ctx.share_data(aux) if need_aux else None
        rank = ctx.axis_rank("data")
        out = out[rank * b * l:(rank + 1) * b * l]
    else:
        out, aux = _dispatch(p, tokens, cfg, capacity_factor, need_aux)
    if m.num_shared_experts:
        out = out + apply_mlp(p["shared"], tokens, cfg,
                              d_ff=m.moe_d_ff * m.num_shared_experts)
    return out.reshape(b, l, d), aux
