"""Weights bridge between the reference's parameter tree and the port's.

The reference stacks the layers of each homogeneous group on a leading
axis (``params["blocks"]`` is a list of groups, every leaf ``(len(group),
...)``); the port holds one dict per layer.  A group is a maximal run of
layers with the same parameter tree: for the dense, hybrid and Mixtral
stacks every layer is one group; a config with ``moe.first_k_dense``
starts with a dense group.  An MoE layer's ``moe`` group (``router``
(d, E) and the experts ``w_gate``/``w_up`` (E, d, ff), ``w_down``
(E, ff, d)) keeps its expert axis: layers are unstacked, experts are not;
its shared experts (``shared``: ``gate``, ``up``, ``down``) are one SwiGLU.
MLA's attention tree (``wq_a``, ``q_norm``, ``wq_b``, ``wkv_a``,
``kv_norm``, ``wk_b``, ``wv_b``, ``wo``) goes through leaf for leaf.  An
encoder-decoder's ``encoder`` group (``blocks``, stacked like the
decoder's, and ``norm_f``), its layers' ``norm_x``/``xattn``, LayerNorm's
``bias``, the GELU MLP's ``fc1``/``fc2`` and the sinusoidal table
``embed/pos`` go through the same way, as do a VLM's ``projector``
(``w`` (d, d)) and an xLSTM layer's ``mixer`` (the mLSTM's ``w_up``,
``w_q``/``w_k``/``w_v``, ``w_i``/``w_f``, ``b_i``/``b_f``, ``w_down``,
``skip_scale``; the sLSTM's ``w_up``, ``w_gates``, ``r_gates``,
``b_gates``, ``w_down``), its mLSTM and sLSTM layers each a group of
their own.

* ``from_jax_params(tree)`` — a reference tree whose leaves are numpy
  arrays (``jax.device_get(params)``) -> the port's params; with
  ``mesh=`` (``launch/mesh.py``) and ``rank=``, that rank's shard in the
  serving layout (``parallel.sharding.shard_params``).
* ``from_npz(path)`` — the same from a reference checkpoint
  (``training/checkpoint.py``: keys are ``"params/"`` + "/"-joined tree
  paths, list indices as numbers).
* ``to_flat(params)`` — the port's params -> that flat ``{path: array}``
  form with the layer axis restacked, so a round trip can be checked leaf
  by leaf; ``from_flat`` is its inverse.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device

# the reference's f32 vectors stay f32 under a dtype cast: norm scales and
# LayerNorm's biases, the per-head q/k norm scales (qk_norm), MLA's two
# latent norm scales, the sinusoidal position table, the Mamba head's
# a_log and dt_bias (used in f32: a bf16 a_log would move every decay)
# and mix scales, the sLSTM's gate weights and bias (its recurrence
# multiplies by them in f32) and the mLSTM's gate biases (added to f32
# pre-activations)
_KEEP_F32 = ("scale", "bias", "q_scale", "k_scale", "q_norm", "kv_norm",
             "pos", "a_log", "dt_bias", "mix_attn", "mix_ssm", "w_gates",
             "r_gates", "b_gates", "b_i", "b_f")


def _tensor(a, device, dtype, key: str) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    if dtype is not None and key not in _KEEP_F32:
        t = t.to(dtype)
    return t.to(device)


def _convert(tree, device, dtype, key=""):
    if isinstance(tree, dict):
        return {k: _convert(v, device, dtype, k) for k, v in tree.items()}
    return _tensor(tree, device, dtype, key)


def _unstack(group: dict, n: int, device, dtype):
    def pick(tree, i, key=""):
        if isinstance(tree, dict):
            return {k: pick(v, i, k) for k, v in tree.items()}
        return _tensor(np.asarray(tree)[i], device, dtype, key)
    return [pick(group, i) for i in range(n)]


def _group_len(group: dict) -> int:
    leaf = group
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return int(np.asarray(leaf).shape[0])


def from_jax_params(tree: dict, device="cuda",
                    dtype: Optional[torch.dtype] = None, mesh=None,
                    rank: Optional[int] = None) -> dict:
    """Reference params (numpy leaves) -> port params on ``device``.
    ``dtype`` casts the matrices (the ``_KEEP_F32`` vectors stay f32);
    ``None`` keeps f32.  With ``mesh``, rank ``rank``'s shard (default
    the mesh's own rank)."""
    if mesh is not None:
        from repro_torch.parallel.sharding import shard_params
        return shard_params(from_jax_params(tree, device, dtype), mesh, rank)
    dev = resolve_device(device)
    unknown = set(tree) - {"embed", "norm_f", "blocks", "encoder",
                           "projector"}
    if unknown:
        raise ValueError(f"unknown parameter groups {sorted(unknown)}")
    out = {"embed": _convert(tree["embed"], dev, dtype),
           "norm_f": _convert(tree["norm_f"], dev, dtype),
           "blocks": _layers(tree["blocks"], dev, dtype)}
    if "projector" in tree:
        out["projector"] = _convert(tree["projector"], dev, dtype)
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = {"blocks": _layers(enc["blocks"], dev, dtype),
                          "norm_f": _convert(enc["norm_f"], dev, dtype)}
    return out


def _layers(groups: list, device, dtype) -> list:
    """The reference's stacked layer groups -> one dict per layer."""
    return [layer for group in groups
            for layer in _unstack(group, _group_len(group), device, dtype)]


def _nest(flat: Dict[str, np.ndarray]) -> dict:
    """"/"-joined paths -> nested dicts; numeric keys become list slots."""
    root: dict = {}
    for path, arr in flat.items():
        node = root
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = arr

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(root)


def from_flat(flat: Dict[str, np.ndarray], device="cuda",
              dtype: Optional[torch.dtype] = None, mesh=None,
              rank: Optional[int] = None) -> dict:
    """``{reference path: array}`` (``to_flat``'s form) -> port params
    (with ``mesh``, a rank's shard, as ``from_jax_params``)."""
    return from_jax_params(_nest(flat), device=device, dtype=dtype,
                           mesh=mesh, rank=rank)


def from_npz(path: str, device="cuda",
             dtype: Optional[torch.dtype] = None) -> dict:
    """Reference ``.npz`` checkpoint -> port params on ``device``."""
    with np.load(path) as z:
        flat = {k[len("params/"):]: z[k] for k in z.files
                if k.startswith("params/")}
    if not flat:
        raise ValueError(f"{path}: no 'params/' entries")
    return from_flat(flat, device=device, dtype=dtype)


def to_flat(params: dict) -> Dict[str, np.ndarray]:
    """Port params -> ``{reference path: f32 array}``, each maximal run of
    layers with the same leaves restacked as one group (the reference's
    ``_layer_groups``)."""
    flat: Dict[str, np.ndarray] = {}
    _walk(params["embed"], "embed/", flat)
    _walk(params["norm_f"], "norm_f/", flat)
    _stack_layers(params["blocks"], "blocks/", flat)
    if "projector" in params:
        _walk(params["projector"], "projector/", flat)
    if "encoder" in params:
        _stack_layers(params["encoder"]["blocks"], "encoder/blocks/", flat)
        _walk(params["encoder"]["norm_f"], "encoder/norm_f/", flat)
    return flat


def _stack_layers(blocks: list, prefix: str,
                  flat: Dict[str, np.ndarray]) -> None:
    """One dict per layer -> ``prefix`` + group index + leaf path, each
    maximal run of layers with the same leaves stacked as one group."""
    groups = []
    for layer in blocks:
        leaves: Dict[str, np.ndarray] = {}
        _walk(layer, "", leaves)
        if groups and set(groups[-1][0]) == set(leaves):
            groups[-1].append(leaves)
        else:
            groups.append([leaves])
    for g, layers in enumerate(groups):
        for key in layers[0]:
            flat[f"{prefix}{g}/{key}"] = np.stack([d[key] for d in layers])


def _walk(node: dict, prefix: str, out: Dict[str, np.ndarray]) -> None:
    for k, v in node.items():
        if isinstance(v, dict):
            _walk(v, f"{prefix}{k}/", out)
        else:
            out[f"{prefix}{k}"] = v.detach().float().cpu().numpy()
