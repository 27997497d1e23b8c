"""The ranks' side of ``test_torch_mla_tp.py``: one function that each of
four gloo ranks runs (``parallel.launch.spawn``), imported by name in fresh
processes, so this module imports torch and the port only (no JAX).

``mla_tp_rank(rank, spec)`` makes the (1, 4) and (2, 2) meshes over the
four ranks and serves reduced DeepSeek-V2 on each, in the serving layout
(``shard_params``): ``make_steps``' ``prefill`` and four ``serve`` steps
over the seeded latent cache (``state_pspecs``: the batch on ``data``, the
latents whole), ``forward_window``'s calls over an empty state, and
``Decoder.generate`` (eager) at a data axis of 1: at (1, 4), and on each
data row of the (2, 2) mesh, a (1, 2) mesh over that row's model group.
Returns its outputs (numpy).
"""
import numpy as np
import torch
from torch_tp_ranks import WINDOWS, _flat, _rows

from repro_torch.configs import DecodeConfig, get_config
from repro_torch.convert import from_flat
from repro_torch.core import Decoder
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.launch.steps import make_steps
from repro_torch.models.attention import KVCache
from repro_torch.models.model import (DecodeState, forward_window,
                                      init_decode_state, set_valid_length)
from repro_torch.parallel.ctx import activation_mesh
from repro_torch.parallel.sharding import (shard_params, shard_tree,
                                           state_pspecs)


def _state(path, length):
    """The seeded latent state: per layer ``c<i>`` (B, S, kv_lora) and
    ``r<i>`` (B, S, qk_rope)."""
    z = _flat(path)
    n = len([k for k in z if k.startswith("c")])
    return DecodeState([KVCache(torch.from_numpy(z[f"c{i}"]),
                                torch.from_numpy(z[f"r{i}"]), length)
                        for i in range(n)], None)


def _serve(cfg, params, mesh, rank, spec):
    """Four serve steps over the seeded cache; the scores each step and
    the local caches at the end."""
    state = _state(spec["state"], spec["length"])
    state = shard_tree(state, state_pspecs(state, mesh), mesh, rank)
    serve = make_steps(cfg, mesh=mesh)["serve"]
    scores = []
    for i, tok in enumerate(spec["serve_tokens"]):
        pos = np.full(tok.shape, spec["serve_pos"] + i, np.int32)
        sc, state = serve(params, _rows(tok, mesh, rank),
                          _rows(pos, mesh, rank), state)
        scores.append(tuple(sc))
    return {"scores": scores,
            "c": [kv.k for kv in state.layer_states],
            "r": [kv.v for kv in state.layer_states],
            "length": [kv.length for kv in state.layer_states]}


def _window(cfg, params, mesh, rank, spec):
    """``forward_window`` from an empty state of 16 positions on this
    rank's rows (``torch_tp_ranks.WINDOWS``); its logits after each call."""
    toks = _rows(spec["window_tokens"], mesh, rank)
    with activation_mesh(mesh):
        state = init_decode_state(cfg, toks.shape[0], 16, torch.float32,
                                  valid_length=0, device="cpu")
        logits = []
        for lo, hi, extend in WINDOWS:
            pos = torch.arange(lo, hi, dtype=torch.int32).expand(
                toks.shape[0], hi - lo)
            lg, state = forward_window(params, toks[:, lo:hi], pos, state,
                                       cfg, extend)
            logits.append(lg)
            if extend == "kv":
                state = set_valid_length(state, lo + 4)
    return logits


def _generate(cfg, params, mesh, spec):
    with activation_mesh(mesh):
        dec = Decoder(params, cfg, DecodeConfig(**spec["decode"],
                                                fused_loop=False),
                      device="cpu")
        toks, st = dec.generate(None, spec["prompt"])
    return {"tokens": toks, "steps": st.steps,
            "forward_equivalents": st.forward_equivalents}


def mla_tp_rank(rank, spec):
    torch.set_num_threads(1)
    cfg = get_config("deepseek-v2-236b").reduced()
    full = from_flat(_flat(spec["params"]), device="cpu")
    out = {}
    for shape in ((1, 4), (2, 2)):
        mesh = make_mesh(*shape)
        params = shard_params(full, mesh)
        key = f"{shape[0]}x{shape[1]}"
        out[f"{key}/heads"] = params["blocks"][0]["attn"]["wk_b"].shape[1] \
            // cfg.mla.qk_nope_head_dim
        out[f"{key}/latent"] = params["blocks"][0]["attn"]["wkv_a"].shape[1]
        out[f"{key}/prefill"] = tuple(make_steps(cfg, mesh=mesh)["prefill"](
            params, {"tokens": _rows(spec["tokens"], mesh, rank)}))
        out[f"{key}/serve"] = _serve(cfg, params, mesh, rank, spec)
        out[f"{key}/window"] = _window(cfg, params, mesh, rank, spec)
        if shape[0] > 1:
            # a (1, 2) mesh on this rank's data row: its model group
            mesh = Mesh({"data": 1, "model": shape[1]}, rank=rank,
                        groups={"model": mesh.groups["model"]})
            params = shard_params(full, mesh)
        out[f"{key}/generate"] = _generate(cfg, params, mesh, spec)
    return out
