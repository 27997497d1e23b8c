"""The active mesh and the collectives at the model's seams (reference:
``src/repro/parallel/ctx.py``).

The reference annotates layouts (``constrain``) and lets GSPMD insert the
collectives.  The port has no GSPMD: its layers run on their shards
(local heads, local ffn columns, local experts, a vocab slice, and in
training each weight's data-axis part) and call the few collectives GSPMD
would have inserted, through this module.  Those on a training path are
``torch.autograd.Function``s, so a backward through them is the
partitioned backward GSPMD would have derived (Megatron's conjugate
pairs, and FSDP's):

* ``sum_model`` — the all-reduce after a row-parallel product (attention
  ``wo``, MLP ``down``, the experts) and after the vocab-parallel
  embedding lookup, summed in f32 and cast back; its gradient passes
  through (every model rank holds the same one);
* ``enter_model`` — the entry to a tensor-parallel region (the input of
  the column-parallel q/k/v, MLA latent and gate/up products, of the
  vocab-parallel head and of the experts' dispatch, the router logits
  behind the MoE's gates, and the replicated norm scales applied to local
  heads or to a gathered latent): the identity, its gradient summed over
  ``model`` (each rank back-propagates only its own heads', columns',
  experts' or vocab slice's share);
* ``use_param`` — a weight as a layer uses it under FSDP: its dim on
  ``data`` all-gathered, the gradient summed over ``data`` and cut back to
  this rank's part (a reduce-scatter); a leaf with no dim on ``data`` (a
  norm scale) passes through, its gradient summed over ``data``;
* ``gather_cols`` — MLA's column-parallel latents gathered over ``model``
  (the norms and the shared rope key need the whole latent); its
  gradient summed over ``model`` and cut back to this rank's columns;
* ``gather_data`` — the MoE's tokens under a global dispatch, every data
  rank's rows on every rank; its gradient summed over ``data`` in f32,
  then this rank's rows;
* ``mean_data`` — the grouped MoE dispatch's aux loss, the mean over the
  data axis; ``share_data`` — a term every data rank computed whole (the
  global dispatch's aux loss): the identity.  The gradient of either is
  ``g / n`` on each rank, so the sum over ``data`` that every weight's
  gradient takes counts the term once, as in the reference's one
  objective;
* ``gather_model`` — small partials (the confidence kernel's per-shard
  accumulators) gathered to every rank of the axis; ``gather_full`` — a
  tensor's sharded dims gathered (full trees for tests and checkpoints);
  ``sum_data`` — counts and metrics over the data axis.

Each is at most one ``all_reduce`` a direction (a gather writes its slot
into a zero-filled buffer, a reduce-scatter is an all-reduce and a
slice), so gloo and NCCL
both serve it, on CPU and CUDA tensors alike.  Sums run in f32; a gather
runs in its tensor's dtype (exact: one slot is not zero), so a bf16
weight is gathered as bf16.  With no active mesh, or an axis of size 1,
every collective is the identity, so every path outside a mesh is
unchanged.

``activation_mesh(mesh)`` makes a mesh active for a block of code (the
reference's context of the same name).  ``with_vocab(V)`` records the
model's full vocab, so ``core.confidence.score_logits`` can tell this
rank's vocab slice of the logits (``vocab_offset``) from a replicated
row (whisper's odd V).

The reference's layout-only options ``seq_shard`` (sequence parallelism
between blocks), ``seq_attn`` and ``xgather`` change where GSPMD keeps
activations, not any value, and have no counterpart here.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Optional, Tuple

import torch
import torch.distributed as dist

_STATE = {"mesh": None, "vocab": None}


@contextmanager
def activation_mesh(mesh):
    """Make ``mesh`` (``launch/mesh.py:Mesh``) active inside the block."""
    prev = _STATE["mesh"]
    _STATE["mesh"] = mesh
    try:
        yield mesh
    finally:
        _STATE["mesh"] = prev


@contextmanager
def with_vocab(vocab_size: int):
    """Record the model's full vocab for ``vocab_offset`` inside the
    block (the decoder and the step functions enter it)."""
    prev = _STATE["vocab"]
    _STATE["vocab"] = int(vocab_size)
    try:
        yield
    finally:
        _STATE["vocab"] = prev


def active():
    """The active mesh, or None."""
    return _STATE["mesh"]


def axis_size(axis: str) -> int:
    mesh = _STATE["mesh"]
    return 1 if mesh is None else int(mesh.shape.get(axis, 1))


def axis_rank(axis: str) -> int:
    mesh = _STATE["mesh"]
    return 0 if mesh is None else mesh.coords()[axis]


def model_size() -> int:
    return axis_size("model")


def model_rank() -> int:
    return axis_rank("model")


def _data_axes(mesh) -> Tuple[str, ...]:
    return tuple(n for n in mesh.axis_names if n in ("pod", "data"))


def shard_counts() -> Tuple[int, int]:
    """(data-axes product, 1): the grid the shard-local MoE dispatch groups
    tokens by; (1, 1) off-mesh.  Groups run over the data axes only, as
    the reference's (its measurements found the model axis better left
    to the experts).  The reference's ``local_moe=False`` (always the
    global dispatch) has no caller here and is not ported."""
    mesh = _STATE["mesh"]
    if mesh is None:
        return 1, 1
    gd = 1
    for a in _data_axes(mesh):
        gd *= mesh.shape[a]
    return gd, 1


def local_count(n: int, what: str) -> int:
    """``n`` heads (or experts) split over ``model``: n / model, raising
    ``ValueError`` where the split would not fall on their boundaries."""
    tp = model_size()
    if n % tp:
        raise ValueError(f"{n} {what} do not split over a model axis of "
                         f"{tp}: the port's tensor parallelism needs "
                         f"whole {what} on every rank")
    return n // tp


def vocab_offset(width: int) -> Optional[int]:
    """This rank's first vocab id when logits of ``width`` columns are a
    vocab slice (the head sharded on ``model``), else None (no mesh, a
    model axis of 1, or a replicated head)."""
    tp = model_size()
    if tp == 1:
        return None
    vocab = _STATE["vocab"]
    if vocab is None:
        raise ValueError("logits under a tensor-parallel mesh: enter "
                         "parallel.ctx.with_vocab(cfg.vocab_size) so a "
                         "vocab slice can be told from a full row")
    if width == vocab:
        return None
    if width * tp != vocab:
        raise ValueError(f"logits of {width} columns are neither the vocab "
                         f"of {vocab} nor its 1/{tp} slice")
    return model_rank() * width


def _group(axis: str):
    return _STATE["mesh"].groups[axis]


def _all_reduce(x: torch.Tensor, axis: str, op) -> torch.Tensor:
    dist.all_reduce(x, op=op, group=_group(axis))
    return x


def _sum_f32(x: torch.Tensor, group) -> torch.Tensor:
    """Σ of x over ``group``'s ranks in f32 (into a fresh buffer), cast
    back to x's dtype."""
    buf = x.to(torch.float32, copy=True).contiguous()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(x.dtype)


class _SumModel(torch.autograd.Function):
    """Σ over ``model`` forward; the gradient passes through."""

    @staticmethod
    def forward(fctx, x):
        return _sum_f32(x, _group("model"))

    @staticmethod
    def backward(fctx, g):
        return g


class _EnterModel(torch.autograd.Function):
    """The identity forward; the gradient summed over ``model``."""

    @staticmethod
    def forward(fctx, x):
        fctx.group = _group("model")
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return _sum_f32(g, fctx.group)


def sum_model(x: torch.Tensor) -> torch.Tensor:
    """Σ over the model axis in f32, cast back to x's dtype (a
    row-parallel product's partials); the gradient passes through."""
    if model_size() == 1:
        return x
    return _SumModel.apply(x)


def enter_model(x: torch.Tensor) -> torch.Tensor:
    """x as the input of a tensor-parallel region: the identity, its
    gradient summed over the model axis in f32."""
    if model_size() == 1:
        return x
    return _EnterModel.apply(x)


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _gather_dim(x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
    """Every rank's x along ``axis``, concatenated in rank order along
    ``dim``, in x's dtype."""
    n = axis_size(axis)
    buf = torch.zeros((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    buf[axis_rank(axis)] = x
    _all_reduce(buf, axis, dist.ReduceOp.SUM)
    shape = x.shape[:dim] + (n * x.shape[dim],) + x.shape[dim + 1:]
    return buf.movedim(0, dim).reshape(shape)


class _Gather(torch.autograd.Function):
    """x's dim ``dim`` all-gathered over ``axis`` (every rank's part in
    rank order) and cast to ``dtype``; the gradient summed over ``axis`` in
    f32 and cut to this rank's part, in x's dtype (a reduce-scatter: a
    copy of the part, so the summed buffer is freed)."""

    @staticmethod
    def forward(fctx, x, dim, axis, dtype):
        fctx.dim, fctx.xdtype = dim, x.dtype
        fctx.group = _group(axis)
        fctx.start, fctx.width = axis_rank(axis) * x.shape[dim], x.shape[dim]
        return _gather_dim(x, dim, axis).to(dtype)

    @staticmethod
    def backward(fctx, g):
        part = _sum_f32(g, fctx.group).narrow(fctx.dim, fctx.start,
                                              fctx.width)
        return part.to(fctx.xdtype, copy=True), None, None, None


class _SumDataGrad(torch.autograd.Function):
    """A data-replicated weight cast to ``dtype``; its gradient summed
    over ``data`` in f32, in the weight's dtype."""

    @staticmethod
    def forward(fctx, w, dtype):
        fctx.wdtype, fctx.group = w.dtype, _group("data")
        return w.to(dtype, copy=True)

    @staticmethod
    def backward(fctx, g):
        return _sum_f32(g, fctx.group).to(fctx.wdtype), None


def use_param(w: torch.Tensor, spec: tuple,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The weight ``w`` (this rank's shard under ``spec``, the training
    layout: ``parallel.sharding.param_pspecs(..., fsdp=True)``) as a layer
    uses it: its dim on ``data`` all-gathered (its gradient then summed
    over ``data`` and cut to this rank's part), or, with no dim on
    ``data``, as it is (its gradient summed over ``data``); dims on
    ``model`` stay cut.  ``dtype``: the forward's compute dtype, to which
    the result is promoted (a bf16 weight of an f32 forward is gathered in
    bf16 and widened after the gather, so its gradient is summed over the
    ranks in f32 and rounded to bf16 once)."""
    out = w.dtype if dtype is None else torch.promote_types(w.dtype, dtype)
    if axis_size("data") == 1:
        return w.to(out)
    dims = [d for d, e in enumerate(spec) if "data" in entry_axes(e)]
    if not dims:
        return _SumDataGrad.apply(w, out)
    if len(dims) > 1 or entry_axes(spec[dims[0]]) != ("data",):
        raise ValueError(f"spec {spec}: one dim on the data axis alone is "
                         f"the training layout's FSDP dim")
    return _Gather.apply(w, dims[0], "data", out)


@torch.no_grad()
def gather_full(x: torch.Tensor, spec: tuple) -> torch.Tensor:
    """The whole tensor of which x is this rank's shard under ``spec``:
    every sharded dim gathered over its axes (on every rank)."""
    for dim, entry in enumerate(spec):
        for axis in reversed(entry_axes(entry)):   # the minor axis first
            if axis_size(axis) > 1:
                x = _gather_dim(x, dim, axis)
    return x


def sum_data(x: torch.Tensor) -> torch.Tensor:
    """Σ over the data axis in f32, cast back to x's dtype (counts and
    metrics: no gradient)."""
    if axis_size("data") == 1:
        return x
    return _sum_f32(x.detach(), _group("data"))


def _gather(x: torch.Tensor, axis: str) -> torch.Tensor:
    if axis_size(axis) == 1:
        return x[None]
    return _gather_dim(x.float()[None], 0, axis).to(x.dtype)


def gather_model(x: torch.Tensor) -> torch.Tensor:
    """(model, *x.shape): every model rank's x, in rank order, on every
    rank (values pass through f32: exact for bf16 and for integers below
    2**24)."""
    return _gather(x, "model")


def gather_cols(x: torch.Tensor) -> torch.Tensor:
    """x's last dim, this rank's columns, gathered over the model axis in
    rank order (in x's dtype); the gradient summed over ``model`` in f32,
    then this rank's columns."""
    if model_size() == 1:
        return x
    return _Gather.apply(x, x.dim() - 1, "model", x.dtype)


def gather_data(x: torch.Tensor) -> torch.Tensor:
    """(data, *x.shape): every data rank's x, in rank order; the gradient
    summed over ``data`` in f32, then this rank's slot."""
    if axis_size("data") == 1:
        return x[None]
    return _Gather.apply(x[None], 0, "data", x.dtype)


class _ShareData(torch.autograd.Function):
    """The mean over ``data`` in f32, cast back (``mean``), or x as it is;
    the gradient ``g / n``."""

    @staticmethod
    def forward(fctx, x, mean):
        fctx.n = axis_size("data")
        if mean:
            return _sum_f32(x, _group("data")).div_(fctx.n)
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return g / fctx.n, None


def mean_data(x: torch.Tensor) -> torch.Tensor:
    """The mean over the data axis (each rank's x one term); the
    gradient ``g / n``: every rank's objective holds the whole mean, and
    the sum over ``data`` of the weights' gradients counts it once."""
    if axis_size("data") == 1:
        return x
    return _ShareData.apply(x, True)


def share_data(x: torch.Tensor) -> torch.Tensor:
    """x, the same on every data rank (a term each computed whole), as it
    is; the gradient ``g / n``, so the sum over ``data`` counts it once."""
    if axis_size("data") == 1:
        return x
    return _ShareData.apply(x, False)
