"""Sharding rules of the port (reference: ``src/repro/parallel/sharding.py``).

The reference's rules, without JAX: a spec is a tuple with one entry per
dim (``None``, an axis name, or a tuple of axis names), right-padded with
``None`` as a ``PartitionSpec`` is; a mesh is anything with ``shape``
({axis: size}) and ``axis_names`` (``launch/mesh.py:Mesh``), or a plain
size dict such as ``{"data": 1, "model": 4}``.

Tensor parallelism (Megatron-style) on the ``model`` axis and fully
sharded data parallelism (FSDP) on the ``data`` (+ ``pod``) axes:

* column-parallel (output dim on ``model``): q/k/v projections, MLP
  gate/up, SSM in-projections;
* row-parallel (input dim on ``model``): output projections, MLP down,
  SSM out-projections, each followed by a sum over ``model``;
* the other large dim of every ≥ 2-D weight on the data axes (FSDP: the
  training layout, ``shard_params(..., fsdp=True)``; ``fsdp=False``
  leaves it replicated: the serving layout);
* expert-parallel: stacked expert weights put the expert axis on
  ``model`` when E divides it; otherwise the experts are tensor-parallel
  in their ffn dim;
* every rule is divisibility-guarded: a dim that does not divide its
  axes is replicated (whisper's odd vocab).

The port's parameter tree holds its layers as a list (``convert.py``), so
a block leaf has no stacked layer axis; the rules are right-aligned and
match on the same leaf names, so they give the reference's spec less its
leading layer entry.  ``cache_pspecs`` applies the reference's rule to a
per-layer leaf as if it had that axis.

``shard_tree`` cuts one rank's shard out of a full tree by its specs,
``gather_tree`` puts the full tree back together on every rank (tests,
checkpoints), ``use_params`` is a shard tree as a sharded training
forward uses it (``parallel.ctx.use_param``: each weight's data-axis dim
gathered), and ``rank_bytes`` counts the bytes one rank holds, on
``meta`` params as well.  The specs travel with the shards as a tree of
the same keys (``map_specs``): which dim of a leaf is cut is never
guessed from a shard's shape (the testbed's d = 256 and d_ff = 1024
would make shapes ambiguous).  ``train_rows`` are the rows of a training
batch that one rank holds.  ``state_pspecs`` is the layout the port's
tensor-parallel decode state really has (batch on the data axes, GQA's kv
heads on ``model``, MLA's latents whole), which differs from
``cache_pspecs``' choice of the trailing head or latent dim (ROADMAP
queue 3 lists it).
"""
from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple

import numpy as np

from repro_torch.launch.mesh import Mesh
from repro_torch.parallel import ctx

Spec = Tuple

# symbolic rule entries:
#   "model"  — tensor-parallel dim         "fsdp" — data-axes dim
#   "expert" — expert axis (model if divisible, else fall back to ffn TP)
#   "vocab"  — model if divisible else replicated
# first regex match wins; unmatched leaves are replicated.
_PARAM_RULES: List[Tuple[str, Tuple]] = [
    # --- MoE stacked experts ----------------------------------------------
    (r"moe/w_(gate|up)$",   ("expert", "fsdp", "model")),
    (r"moe/w_down$",        ("expert", "model", "fsdp")),
    (r"moe/router$",        (None, None)),
    (r"moe/shared/(gate|up)$", ("fsdp", "model")),
    (r"moe/shared/down$",   ("model", "fsdp")),
    # --- attention ----------------------------------------------------------
    (r"attn/w(q|k|v)$",     ("fsdp", "model")),
    (r"attn/wq_[ab]$",      ("fsdp", "model")),
    (r"attn/w(kv_a|k_b|v_b)$", ("fsdp", "model")),
    (r"attn/wo$",           ("model", "fsdp")),
    # --- dense MLP ----------------------------------------------------------
    (r"mlp/(gate|up|fc1)$", ("fsdp", "model")),
    (r"mlp/(down|fc2)$",    ("model", "fsdp")),
    # --- xLSTM / mamba mixers -----------------------------------------------
    (r"(mixer|mamba)/w_(up|q|k|v|in|gates)$", ("fsdp", "model")),
    (r"mixer/r_gates$",     ("fsdp", "model")),
    (r"(mixer|mamba)/w_(down|out)$", ("model", "fsdp")),
    (r"(mixer|mamba)/w_(i|f|bcdt)$", ("model", None)),
    (r"(mixer|mamba)/a_log$", ("model", None)),
    (r"(mixer|mamba)/conv_w$", (None, "model")),
    # --- embeddings / head ---------------------------------------------------
    (r"embed/tok$",         ("vocab", "fsdp")),
    (r"embed/head$",        ("fsdp", "vocab")),
    (r"embed/pos$",         (None, "model")),
    (r"projector/w$",       ("fsdp", "model")),
]


def _sizes(mesh) -> dict:
    return dict(mesh) if isinstance(mesh, dict) else dict(mesh.shape)


def _axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh) if isinstance(mesh, dict) else tuple(mesh.axis_names)


def data_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes: ('pod', 'data') multi-pod, ('data',)."""
    return tuple(n for n in _axis_names(mesh) if n in ("pod", "data"))


def _entry(axes: Tuple[str, ...]):
    """A spec entry of ``axes``: one name alone, as ``PartitionSpec``
    normalises a 1-tuple."""
    return axes[0] if len(axes) == 1 else axes


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)


def _resolve(rule: Tuple, shape: Tuple[int, ...], mesh,
             fsdp: bool) -> Spec:
    """Symbolic rule -> concrete spec: right-aligned, divisibility
    guarded, no mesh axis used twice."""
    sizes = _sizes(mesh)
    daxes = data_axes(mesh)
    full = [None] * (len(shape) - len(rule)) + list(rule)
    trailing = shape[len(shape) - len(rule):]
    # expert fallback: if the expert axis can't take `model`, move `model`
    # pressure onto the ffn dims (per-expert tensor parallelism)
    if rule and rule[0] == "expert":
        e = trailing[0]
        if e % sizes["model"] == 0:
            full[-len(rule)] = "model"
            full = [("fsdp" if a == "model" and i != len(full) - len(rule)
                     else a) for i, a in enumerate(full)]
            # drop the duplicate fsdp if the rule already placed one
            seen_fsdp = False
            for i, a in enumerate(full):
                if a == "fsdp":
                    if seen_fsdp:
                        full[i] = None
                    seen_fsdp = True
        else:
            full[-len(rule)] = None
    out: List[Any] = []
    used = set()
    for dim, ax in zip(shape, full):
        concrete: Optional[Tuple[str, ...]] = None
        if ax == "model" or ax == "vocab":
            concrete = ("model",)
        elif ax == "fsdp":
            concrete = daxes if fsdp else None
        elif isinstance(ax, str):
            concrete = (ax,)
        if concrete is not None:
            size = int(np.prod([sizes[a] for a in concrete]))
            if dim % size != 0 or any(a in used for a in concrete):
                concrete = None
        if concrete is not None:
            used.update(concrete)
            out.append(concrete[0] if len(concrete) == 1 else concrete)
        else:
            out.append(None)
    return tuple(out)


def is_spec(x) -> bool:
    """A spec: a plain tuple of None, axis names or tuples of them."""
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        e is None or isinstance(e, str) or (
            isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def _map(fn, tree, path: str = "", specs: bool = False):
    """``fn(path, leaf)`` over a tree of dicts, lists, tuples and named
    tuples; ``None`` stays ``None``.  ``specs``: a plain tuple is a leaf
    (a spec), not a node."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, v, f"{path}{k}/", specs)
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v, f"{path}{k}/", specs)
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)) and not (specs and is_spec(tree)):
        return type(tree)(_map(fn, v, f"{path}{i}/", specs)
                          for i, v in enumerate(tree))
    return fn(path[:-1], tree)


def param_pspecs(params: Any, mesh, fsdp: bool = True) -> Any:
    """The spec tree of a parameter tree (the port's: per-layer lists)."""
    def spec(path, leaf):
        shape = _shape(leaf)
        for pat, rule in _PARAM_RULES:
            if re.search(pat, path) and len(shape) >= len(rule):
                return _resolve(rule, shape, mesh, fsdp)
        return ()   # replicate by default (norms, biases, scalars)
    return _map(spec, params)


def batch_pspec(mesh, ndim: int = 2) -> Spec:
    """Input batch (B, L, ...) sharded on the data axes."""
    return (_entry(data_axes(mesh)),) + (None,) * (ndim - 1)


def seq_pspec(mesh, ndim: int = 2) -> Spec:
    """Context parallelism for batch=1 long-context: the seq axis."""
    return (None, _entry(data_axes(mesh))) + (None,) * (ndim - 2)


def cache_pspecs(state: Any, mesh, batch: int) -> Any:
    """The reference's decode-state rule, applied to each per-layer leaf
    as if it had the reference's leading stacked-layer axis (which the
    rule never shards), that entry dropped.  Leaves without a shape (a
    cache's host-int valid length) are replicated."""
    sizes = _sizes(mesh)
    daxes = data_axes(mesh)
    dsize = int(np.prod([sizes[a] for a in daxes]))
    msize = sizes["model"]
    dentry = _entry(daxes)
    batch_ok = batch % dsize == 0 and batch >= dsize

    def rule(_, leaf):
        if not hasattr(leaf, "shape"):
            return ()
        shape = (1,) + _shape(leaf)
        if len(shape) <= 1:
            return ()
        spec: List = [None] * len(shape)
        if batch_ok:
            for d in range(1, len(shape)):
                if shape[d] == batch:
                    spec[d] = dentry
                    break
        else:
            # context parallelism: the longest data-divisible axis
            cands = [d for d in range(1, len(shape))
                     if shape[d] >= 1024 and shape[d] % dsize == 0]
            if cands:
                d = max(cands, key=lambda i: shape[i])
                spec[d] = dentry
        # model axis: prefer TRAILING dims (kv-heads / head-dim / latent) so
        # the one-slot decode write stays shard-local; the sequence axis is
        # the fallback
        cands = [d for d in range(len(shape) - 1, 0, -1)
                 if spec[d] is None and shape[d] % msize == 0
                 and shape[d] >= 2 * msize]
        if cands:
            spec[cands[0]] = "model"
        return tuple(spec[1:])

    return _map(rule, state)


def state_pspecs(state: Any, mesh) -> Any:
    """The layout of the port's tensor-parallel decode state, the one
    ``attention.init_cache`` allocates under an active mesh: the batch on
    the data axes (where it divides them); a GQA cache leaf (B, S, G, hd)
    with its kv heads on ``model``, MLA's latents (B, S, kv_lora) and
    (B, S, qk_rope) whole on every model rank (each local head reads all
    of them)."""
    sizes = _sizes(mesh)
    daxes = data_axes(mesh)
    dsize = int(np.prod([sizes[a] for a in daxes]))

    def rule(_, leaf):
        shape = _shape(leaf) if hasattr(leaf, "shape") else ()
        if len(shape) not in (3, 4):
            return ()
        batch = _entry(daxes) if shape[0] % dsize == 0 else None
        return (batch, None, "model", None) if len(shape) == 4 else \
            (batch, None, None)
    return _map(rule, state)


def _index(coords: dict, axes: Tuple[str, ...], sizes: dict) -> int:
    """A rank's row-major index along ``axes``."""
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + coords[a]
    return idx


def shard_tree(tree: Any, specs: Any, mesh, rank: int) -> Any:
    """Rank ``rank``'s shard of a full tree (tensors or numpy arrays) under
    ``specs`` (same structure): each sharded dim cut into equal parts,
    the part at the rank's coordinate along the dim's axes.  A torch
    shard is a copy (so the full tensor can be freed); an unsharded leaf
    is returned as it is."""
    sizes = _sizes(mesh)
    coords = Mesh(sizes, _axis_names(mesh), rank).coords()
    flat_specs = {}
    _map(lambda p, s: flat_specs.__setitem__(p, s), specs, specs=True)

    def cut(path, leaf):
        spec = flat_specs[path]
        if not spec or all(e is None for e in spec):
            return leaf
        shape = _shape(leaf)
        index = []
        for dim, (n, e) in enumerate(zip(shape, tuple(spec) + (None,) * (
                len(shape) - len(spec)))):
            if e is None:
                index.append(slice(None))
                continue
            axes = e if isinstance(e, tuple) else (e,)
            parts = int(np.prod([sizes[a] for a in axes]))
            if n % parts:
                raise ValueError(f"{path}: dim {dim} of {n} does not split "
                                 f"into {parts} parts over {axes}")
            i = _index(coords, axes, sizes)
            index.append(slice(i * n // parts, (i + 1) * n // parts))
        out = leaf[tuple(index)]
        return out.clone() if hasattr(out, "clone") else out
    return _map(cut, tree)


def shard_params(params: Any, mesh, rank: Optional[int] = None,
                 fsdp: bool = False) -> Any:
    """Rank ``rank``'s (default the mesh's own) shard of full port params:
    the serving layout (``param_pspecs(..., fsdp=False)``: weights split
    on ``model`` only), or with ``fsdp`` the training layout (each
    weight's other large dim also split over the data axes)."""
    rank = getattr(mesh, "rank", 0) if rank is None else rank
    return shard_tree(params, param_pspecs(params, mesh, fsdp=fsdp), mesh,
                      rank)


def map_specs(fn, tree: Any, specs: Any) -> Any:
    """``fn(leaf, spec)`` over a tree of dicts and lists and its spec tree,
    walked by the tree's keys (so the two may order their keys
    differently)."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_specs(fn, v, s) for v, s in zip(tree, specs)]
    return fn(tree, specs)


def use_params(tree: Any, specs: Any, dtype=None) -> Any:
    """A shard tree in the training layout as a forward under the active
    mesh uses it: ``ctx.use_param`` of every leaf (data-axis dims
    gathered, gradients summed over ``data``; promoted to ``dtype``)."""
    return map_specs(lambda w, s: ctx.use_param(w, s, dtype), tree, specs)


def gather_tree(tree: Any, specs: Any) -> Any:
    """The full tree of this rank's shards under ``specs`` and the active
    mesh, on every rank (a collective: every rank calls it)."""
    return map_specs(ctx.gather_full, tree, specs)


def _parts(spec: Spec, sizes: dict) -> List[int]:
    """Into how many parts each dim of a leaf is cut."""
    return [int(np.prod([sizes[a] for a in ctx.entry_axes(e)]))
            for e in spec]


def local_shape(shape: Tuple[int, ...], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's shard of a leaf of ``shape``."""
    parts = _parts(spec, _sizes(mesh))
    parts += [1] * (len(shape) - len(parts))
    return tuple(n // p for n, p in zip(shape, parts))


def rank_bytes(params: Any, specs: Any, mesh) -> int:
    """The bytes of the full tree ``params`` (real tensors or ``meta``
    stand-ins) that one rank holds under ``specs``."""
    sizes = _sizes(mesh)
    total = [0]

    def add(leaf, spec):
        total[0] += leaf.numel() * leaf.element_size() // int(
            np.prod(_parts(spec, sizes)))
    map_specs(add, params, specs)
    return total[0]


def train_rows(batch: int, mesh, rank: Optional[int] = None,
               microbatch: int = 1) -> np.ndarray:
    """The row indices of a training batch of ``batch`` rows that rank
    ``rank`` (default the mesh's own) holds: the batch's ``microbatch``
    equal slices (the reference's microbatches, in order) are each cut
    into equal parts over the data axes, and a rank holds its part of each
    slice in turn, so its i-th local slice is its part of the batch's i-th
    microbatch (with one microbatch: the ``batch_pspec`` rows)."""
    sizes = _sizes(mesh)
    daxes = data_axes(mesh)
    parts = int(np.prod([sizes[a] for a in daxes]))
    if batch % (parts * microbatch):
        raise ValueError(f"a batch of {batch} rows does not split into "
                         f"{microbatch} microbatches over {parts} data ranks")
    rank = getattr(mesh, "rank", 0) if rank is None else rank
    d = _index(Mesh(sizes, _axis_names(mesh), rank).coords(), daxes, sizes)
    mb = batch // microbatch
    per = mb // parts
    return np.concatenate([np.arange(i * mb + d * per, i * mb + (d + 1) * per)
                           for i in range(microbatch)])
