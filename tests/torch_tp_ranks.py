"""The ranks' side of ``test_torch_tp.py``: one function that each of four
gloo ranks runs (``parallel.launch.spawn``), imported by name in fresh
processes, so this module imports torch and the port only (no JAX).

``tp_rank(rank, spec)`` makes the three meshes over the four ranks in turn
and runs every check of the file on them, returning its outputs (numpy);
the test compares them with the reference's in the parent process.
``spec`` holds numpy inputs and the paths of ``.npz`` files written by
the parent (reference trees flattened as ``convert.to_flat`` lays them
out).
"""
import numpy as np
import torch

from repro_torch.configs import DecodeConfig, get_config
from repro_torch.convert import from_flat
from repro_torch.core import Decoder
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import make_steps
from repro_torch.models.attention import KVCache
from repro_torch.models.model import (DecodeState, forward, forward_window,
                                      init_decode_state, set_valid_length)
from repro_torch.models.moe import moe_forward
from repro_torch.parallel.ctx import activation_mesh
from repro_torch.parallel.sharding import (batch_pspec, shard_params,
                                           shard_tree, state_pspecs)


# forward_window's calls (lo, hi, extend); after a "kv" window the valid
# length is cut to lo + 4 (its committed block)
WINDOWS = ((0, 8, "kv"), (4, 8, None), (4, 12, "kv"), (8, 12, None))


def _flat(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _state(path, length):
    """The full decode state of the seeded cache file: per layer
    ``k<i>``/``v<i>`` (B, S, G, hd)."""
    z = _flat(path)
    n = len([k for k in z if k.startswith("k")])
    return DecodeState([KVCache(torch.from_numpy(z[f"k{i}"]),
                                torch.from_numpy(z[f"v{i}"]), length)
                        for i in range(n)], None)


def _rows(x, mesh, rank):
    """This rank's batch rows (the batch on the data axes)."""
    x = torch.from_numpy(np.asarray(x))
    return shard_tree(x, batch_pspec(mesh, x.dim()), mesh, rank)


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
            "k": [kv.k for kv in state.layer_states],
            "v": [kv.v for kv in state.layer_states],
            "length": [kv.length for kv in state.layer_states]}


def _window(cfg, params, mesh, spec):
    """``forward_window`` from an empty state of 16 positions: a live
    window written with ``extend="kv"``, cut to 4 (``set_valid_length``),
    a scoring window, a second ``"kv"`` window; this rank's logits after
    each call."""
    toks = torch.from_numpy(spec["window_tokens"])
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


def tp_rank(rank, spec):
    torch.set_num_threads(1)
    out = {}
    cfg = get_config("llada-8b").reduced()
    llada = from_flat(_flat(spec["llada"]), device="cpu")

    mesh = make_mesh(1, 4)
    params = shard_params(llada, mesh)
    out["prefill"] = tuple(make_steps(cfg, mesh=mesh)["prefill"](
        params, {"tokens": torch.from_numpy(spec["tokens"])}))
    out["serve"] = _serve(cfg, params, mesh, rank, spec)
    out["window"] = _window(cfg, params, mesh, spec)
    with activation_mesh(mesh):
        for name, kw in spec["cases"].items():
            dec = Decoder(params, cfg, DecodeConfig(**kw, fused_loop=False),
                          device="cpu")
            toks, st = dec.generate(None, spec["prompt"])
            out[f"generate/{name}"] = {
                "tokens": toks, "steps": st.steps,
                "forward_equivalents": st.forward_equivalents,
                "phases": dict(st.phase_counts)}
    mcfg = get_config("mixtral-8x22b").reduced()
    mixtral = from_flat(_flat(spec["mixtral"]), device="cpu", mesh=mesh)
    out["mixtral/experts"] = mixtral["blocks"][0]["moe"]["w_gate"].shape[0]
    with activation_mesh(mesh):
        out["mixtral/logits"] = forward(
            mixtral, torch.from_numpy(spec["mixtral_tokens"]), mcfg)

    mesh = make_mesh(2, 2)
    out["serve22"] = _serve(cfg, shard_params(llada, mesh), mesh, rank, spec)

    mesh = make_mesh(4, 1)
    moe = from_flat(_flat(spec["mixtral"]), device="cpu")["blocks"][0]["moe"]
    with activation_mesh(mesh):
        for name, x in spec["moe_inputs"].items():
            got, aux = moe_forward(moe, _rows(x, mesh, rank), mcfg,
                                   spec["moe_factor"])
            out[f"moe/{name}"] = {"out": got, "aux": aux}
    return out


def fail_on_rank_1(rank):
    """Rank 1 raises; rank 0 then waits in a collective until terminated."""
    if rank == 1:
        raise RuntimeError("rank 1 raises on purpose")
    torch.distributed.barrier()
