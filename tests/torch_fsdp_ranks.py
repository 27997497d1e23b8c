"""The ranks' side of ``test_torch_fsdp.py``: one function that each of four
gloo ranks runs (``parallel.launch.spawn``), imported by name in fresh
processes, so this module imports torch and the port only (no JAX).

``fsdp_rank(rank, spec)`` makes the three meshes over the four ranks, in
one order on every rank, then runs each case of ``spec["cases"]``: the
case's reference params (an ``.npz`` in ``convert.to_flat``'s layout) cut
to this rank's shards in the training layout (``shard_params(...,
fsdp=True)``), then for each step of the reference's corruption this
rank's rows (``train_rows``), the step's ``grads`` and ``apply``: of
``make_steps(..., mesh=)["train"]``, or of a bare ``TrainStep`` called
inside the rank's ``activation_mesh``.
Rank 0 writes the trees gathered back from the shards (gradients, then
params and moments after the step) to ``<out>/<case>_<step>.npz``; every
rank returns its metrics and its own gradients of the leaves that other
ranks hold the same part of.
"""
import numpy as np
import torch

from repro_torch.configs import TrainConfig, get_config
from repro_torch.convert import from_flat, to_flat
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import make_steps
from repro_torch.models import init_model
from repro_torch.parallel.ctx import (activation_mesh, entry_axes,
                                     with_vocab)
from repro_torch.parallel.sharding import (gather_tree, map_specs,
                                           param_pspecs, shard_params,
                                           train_rows)
from repro_torch.training import adamw_init, make_train_step, save
from repro_torch.training.optimizer import leaves
from repro_torch.training.trainer import masters

MESHES = ((4, 1), (2, 2), (1, 4))


def _flat(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _replicated(grads, specs, mesh):
    """{leaf index: (the axes that cut it, this rank's gradient)} of the
    leaves that some mesh axis of more than one rank does not cut (other
    ranks hold the same part)."""
    big = {a for a, n in mesh.shape.items() if n > 1}
    out = {}
    for i, (g, s) in enumerate(leaves(map_specs(lambda g, s: (g, s), grads,
                                                specs))):
        axes = {a for e in s for a in entry_axes(e)}
        if big - axes:
            out[i] = (sorted(axes), g.detach().numpy().copy())
    return out


def _opts(kw):
    """``make_steps``' options of the TrainStep keywords ``kw``."""
    return frozenset(["bf16_gather"] * kw.get("bf16_params", False)
                     + [f"microbatch{kw.get('microbatch', 1)}"])


def _gathered(tree, specs, mesh, prefix):
    """The whole tree gathered from this rank's shards, flat, its keys
    under ``prefix``."""
    with activation_mesh(mesh):
        return {f"{prefix}/{k}": v.copy()
                for k, v in to_flat(gather_tree(tree, specs)).items()}


def fsdp_rank(rank, spec):
    torch.set_num_threads(1)
    meshes = {shape: make_mesh(*shape) for shape in MESHES}
    batch = {k: torch.from_numpy(v) for k, v in spec["batch"].items()}
    out = {}
    for name, case in spec["cases"].items():
        mesh = meshes[case["mesh"]]
        cfg = get_config(case["arch"]).reduced(**case["over"])
        tcfg = TrainConfig(**case["tcfg"])
        if case["bare"]:
            # a bare TrainStep run inside the rank's activation_mesh (once
            # a model rank's upstream gradients were its own heads' share)
            step = make_train_step(cfg, tcfg, **case["kw"])
        else:
            step = make_steps(cfg, tcfg, _opts(case["kw"]), mesh=mesh)[
                "train"]
        full = from_flat(_flat(spec["params"][case["arch"]]), device="cpu")
        params = masters(shard_params(full, mesh, fsdp=True))
        specs = param_pspecs(init_model(cfg, device="meta",
                                        dtype=torch.float32), mesh, fsdp=True)
        opt = adamw_init(params)
        rows = train_rows(len(batch["tokens"]), mesh,
                          microbatch=case["kw"].get("microbatch", 1))
        local = {k: v[rows] for k, v in batch.items()}
        res = {"metrics": [], "replicated": [], "coords": mesh.coords()}

        def run(fn, *args):
            """A step's call: a bare step inside the rank's mesh, a
            ``make_steps`` step as it comes (inside its own scope)."""
            if not case["bare"]:
                return fn(*args)
            with activation_mesh(mesh), with_vocab(cfg.vocab_size):
                return fn(*args)

        for s, corruption in enumerate(spec["corruptions"]):
            corr = tuple(torch.from_numpy(c)[rows] for c in corruption)
            grads, metrics = run(step.grads, params, local, corr)
            res["replicated"].append(_replicated(grads, specs, mesh))
            trees = _gathered(grads, specs, mesh, "grad")
            params, opt, met = run(step.apply, params, opt, local, corr)
            res["metrics"].append({k: (float(v), float(met[k]))
                                   for k, v in metrics.items()})
            for prefix, tree in (("param", params), ("mu", opt.mu),
                                 ("nu", opt.nu)):
                trees.update(_gathered(tree, specs, mesh, prefix))
            if rank == 0:
                np.savez(f"{spec['out']}/{name}_{s}.npz", **trees)
        if case.get("save"):
            with activation_mesh(mesh):
                save(spec["checkpoint"], params, opt, step=opt.step,
                     specs=specs)
        out[name] = res
    return out
