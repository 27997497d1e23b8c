"""The active mesh and the collectives at the model's seams (reference:
``src/repro/parallel/ctx.py``).

The reference annotates layouts (``constrain``) and lets GSPMD insert the
collectives.  The port has no GSPMD: its layers run on their shards
(local heads, local ffn columns, local experts, a vocab slice) and call
the few collectives GSPMD would have inserted, through this module:

* ``sum_model`` — the all-reduce after a row-parallel product (attention
  ``wo``, MLP ``down``, the experts) and after the vocab-parallel
  embedding lookup, summed in f32 and cast back;
* ``gather_model`` / ``gather_data`` — small partials (the confidence
  kernel's per-shard accumulators; the MoE's tokens under a global
  dispatch) gathered to every rank of the axis;
* ``mean_data`` — the grouped MoE dispatch's aux loss over the data axis.

Each is one ``all_reduce`` (a gather writes its slot into a zero-filled
buffer), so gloo and NCCL both serve it, on CPU and CUDA tensors alike.
With no active mesh, or an axis of size 1, every collective is the
identity, so every path outside a mesh is unchanged.

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


def sum_model(x: torch.Tensor) -> torch.Tensor:
    """Σ over the model axis in f32, cast back to x's dtype (a
    row-parallel product's partials; an f32 x is reduced in place)."""
    if model_size() == 1:
        return x
    return _all_reduce(x.float().contiguous(), "model",
                       dist.ReduceOp.SUM).to(x.dtype)


def _gather(x: torch.Tensor, axis: str) -> torch.Tensor:
    n = axis_size(axis)
    if n == 1:
        return x[None]
    buf = torch.zeros((n,) + tuple(x.shape), dtype=torch.float32,
                      device=x.device)
    buf[axis_rank(axis)] = x
    return _all_reduce(buf, axis, dist.ReduceOp.SUM).to(x.dtype)


def gather_model(x: torch.Tensor) -> torch.Tensor:
    """(model, *x.shape): every model rank's x, in rank order, on every
    rank (values pass through f32: exact for bf16 and for integers below
    2**24)."""
    return _gather(x, "model")


def gather_data(x: torch.Tensor) -> torch.Tensor:
    """(data, *x.shape): every data rank's x, in rank order."""
    return _gather(x, "data")


def mean_data(x: torch.Tensor) -> torch.Tensor:
    """The mean over the data axis."""
    n = axis_size("data")
    if n == 1:
        return x
    return _all_reduce(x.float().clone(), "data",
                       dist.ReduceOp.SUM).div_(n).to(x.dtype)
