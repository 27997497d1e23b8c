"""The ranks' side of ``test_torch_moe_mesh.py``: one function that each of
four gloo ranks runs (``parallel.launch.spawn``), imported by name in fresh
processes, so this module imports torch and the port only (no JAX).

``moe_mesh_rank(rank, spec)`` makes the three meshes over the four ranks,
in one order on every rank, then runs each case of ``spec["cases"]``: the
case's reference params (an ``.npz`` in ``convert.to_flat``'s layout) cut
to this rank's shards in the training layout (``shard_params(...,
fsdp=True)``), then for each step of the case batch's reference corruption
this rank's rows (``train_rows``), the ``grads`` and ``apply`` of
``make_steps(cfg, tcfg, mesh=)["train"]``.  Rank 0 writes the trees
gathered back from the shards (gradients, then params and moments after
the step) to ``<out>/<case>_<step>.npz``; every rank returns its metrics
and its own gradients of the leaves that other ranks hold the same part
of.
"""
import numpy as np
import torch
from torch_fsdp_ranks import MESHES, _flat, _gathered, _replicated

from repro_torch.configs import TrainConfig
from repro_torch.convert import from_flat
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import make_steps
from repro_torch.models import init_model
from repro_torch.parallel.sharding import (param_pspecs, shard_params,
                                           train_rows)
from repro_torch.training import adamw_init
from repro_torch.training.trainer import masters


def case_config(arch: str, experts: int = 0, remat: bool = False):
    """The reduced config of ``arch``; ``experts`` > 0 replaces its
    expert count (the ffn tensor-parallel fallback where it does not
    divide the model axis); ``remat``: ``remat="block"``."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(arch).reduced(remat="block" if remat else "none")
    if experts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=experts))
    return cfg


def moe_mesh_rank(rank, spec):
    torch.set_num_threads(1)
    meshes = {shape: make_mesh(*shape) for shape in MESHES}
    out = {}
    for name, case in spec["cases"].items():
        mesh = meshes[case["mesh"]]
        cfg = case_config(case["arch"], case["experts"], case["remat"])
        step = make_steps(cfg, TrainConfig(**case["tcfg"]), mesh=mesh)[
            "train"]
        full = from_flat(_flat(spec["params"][case["params"]]), device="cpu")
        params = masters(shard_params(full, mesh, fsdp=True))
        specs = param_pspecs(init_model(cfg, device="meta",
                                        dtype=torch.float32), mesh, fsdp=True)
        opt = adamw_init(params)
        batch = spec["batches"][case["batch"]]
        rows = train_rows(len(batch["tokens"]), mesh)
        local = {k: torch.from_numpy(v[rows]) for k, v in batch.items()}
        res = {"metrics": [], "replicated": [], "coords": mesh.coords(),
               "experts": params["blocks"][-1]["moe"]["w_gate"].shape[0]}
        for s, corruption in enumerate(spec["corruptions"][case["batch"]]):
            corr = tuple(torch.from_numpy(c[rows]) for c in corruption)
            grads, metrics = step.grads(params, local, corr)
            res["replicated"].append(_replicated(grads, specs, mesh))
            trees = _gathered(grads, specs, mesh, "grad")
            params, opt, met = step.apply(params, opt, local, corr)
            res["metrics"].append({k: (float(v), float(met[k]))
                                   for k, v in metrics.items()})
            for prefix, tree in (("param", params), ("mu", opt.mu),
                                 ("nu", opt.nu)):
                trees.update(_gathered(tree, specs, mesh, prefix))
            if rank == 0:
                np.savez(f"{spec['out']}/{name}_{s}.npz", **trees)
        out[name] = res
    return out
