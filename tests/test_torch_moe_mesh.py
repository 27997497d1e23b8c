"""The MoE families trained under a mesh: the port's ``make_steps(cfg, tcfg,
mesh=)["train"]`` of reduced Mixtral-8x22B and DeepSeek-V2 on four gloo
ranks on the CPU, against the reference's train step and the port's own
unsharded one.

One spawn of four ranks (``parallel.launch.spawn``, a ``FileStore`` under
the test's temporary directory) runs every case of ``CASES`` on its mesh
(``torch_moe_mesh_ranks.moe_mesh_rank``): the reference's initial params
cut to the rank's training-layout shards, then two steps on the rank's
rows of the reference's corruption of the case's batch.  The reduced
configs have 4 experts, so they are expert-parallel at every model axis
above 1 (at (4, 1) they are whole and FSDP-sharded on ``data``); the case
with 6 experts at (1, 4) trains the experts' ffn tensor-parallel
fallback.  DeepSeek-V2's MLA runs on tensor-parallel heads, its latent
(64 + 16 columns, 20 a rank at (1, 4)) cut across the ``c_kv``/``k_rope``
seam, and its shared experts follow the dense MLP's split.

References, in this process meanwhile: the reference's two unsharded
steps (its loss, ``jax.grad`` and ``adamw_update``, as
``test_torch_fsdp.py`` runs them) and the port's two unsharded steps
(``make_steps(cfg, tcfg)["train"]``).  The ``grouped`` case holds 1024
tokens a data rank at (4, 1), so the MoE dispatches each data rank's rows
apart (the reference's grouped dispatch) and its aux loss is the mean over
the groups: its reference is the reference's step under its
``activation_mesh`` over four host devices, run in a subprocess
(``XLA_FLAGS`` must be set before JAX starts); an unsharded step
dispatches globally and is no reference for it.

Tolerances (``test_torch_fsdp.py``'s, f32): loss, aux and accuracy within
1e-5 of their scale (the loss's and the aux's magnitude; 1 for the
accuracy), every rank's metrics equal; each gradient and ``mu`` leaf
within 1e-5 of its max |value|, each ``nu`` leaf within 2e-5 (it holds
g²: a gradient within ε of its leaf's scale puts g² within 2ε of its
own, and DeepSeek-V2's q_norm scale, a sum over every token and head of
products that cancel, reads ~8e-6 in its gradient against the reference,
whose sums run in another order, ~2.5e-6 against the port's unsharded
step); parameters within 1e-5 of their max
|value| wherever the gradient of every step so far is zero or lies above
1e-4 of its leaf's max (an element whose gradient is within the
gradients' own tolerance of zero may step either way).  An aux loss
counted once a data rank or once a model rank moves the router's
gradient and ``mu`` by far more (``NO_CLIP`` cases, whose update is not
rescaled); the gradients of a leaf are equal, bit for bit, on every
rank that holds the same part of it.
"""
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import _jax_adamw, _jax_init, _jflat
from torch_moe_mesh_ranks import case_config, moe_mesh_rank
from torch_threads import one_torch_thread  # noqa: F401

from repro.configs import TrainConfig as JaxTrainConfig
from repro.configs import get_config as jax_get_config
from repro.core.loss import masked_cross_entropy as jax_mce
from repro.core.loss import token_accuracy as jax_token_accuracy
from repro.core.masking import apply_mask as jax_apply_mask
from repro.core.masking import sample_mask_ratio as jax_sample_mask_ratio
from repro.models.model import forward as jax_forward
from repro.training import adamw_init as jax_adamw_init
from repro_torch.configs import TrainConfig
from repro_torch.convert import from_flat, to_flat
from repro_torch.launch.steps import make_steps
from repro_torch.models import init_model
from repro_torch.models import model as model_mod
from repro_torch.parallel.launch import spawn
from repro_torch.parallel.sharding import (param_pspecs, rank_bytes,
                                           shard_tree)
from repro_torch.training import adamw_init
from repro_torch.training.optimizer import leaves
from repro_torch.training.trainer import masters

STEPS = 2
CLIP, NO_CLIP = 1.0, 1e4
# batch name -> (rows, positions): "short" is 4 rows a data rank at
# (4, 1), below the grouped dispatch's 1024 tokens (and past Mixtral's
# band of 32); "long" 1024 tokens a data rank at (4, 1)
BATCHES = {"short": (16, 48), "long": (32, 128)}
# params name -> (arch, experts: 0 keeps the reduced config's 4)
PARAMS = {"mixtral": ("mixtral-8x22b", 0), "mixtral-6": ("mixtral-8x22b", 6),
          "deepseek": ("deepseek-v2-236b", 0)}
# name -> (params, mesh, batch, clip norm); every case runs
# make_steps(cfg, tcfg, mesh=)["train"]; "remat" cases set remat="block"
CASES = {
    "mixtral-4x1-grouped": ("mixtral", (4, 1), "long", CLIP),
    "mixtral-4x1": ("mixtral", (4, 1), "short", NO_CLIP),
    "mixtral-2x2-remat": ("mixtral", (2, 2), "short", CLIP),
    "mixtral-1x4": ("mixtral", (1, 4), "short", NO_CLIP),
    "mixtral-6-experts-1x4": ("mixtral-6", (1, 4), "short", CLIP),
    "deepseek-4x1": ("deepseek", (4, 1), "short", NO_CLIP),
    "deepseek-2x2-remat": ("deepseek", (2, 2), "short", NO_CLIP),
    "deepseek-1x4": ("deepseek", (1, 4), "short", CLIP),
}
GROUPED = "mixtral-4x1-grouped"

REFERENCE_GROUPED = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import TrainConfig, get_config
from repro.core.loss import masked_cross_entropy, token_accuracy
from repro.models.model import forward, init_model
from repro.parallel.ctx import activation_mesh
from repro.training import adamw_init, adamw_update, cosine_schedule
arch, tcfg, src, dst = sys.argv[1], json.loads(sys.argv[2]), *sys.argv[3:5]
cfg = get_config(arch).reduced()
tcfg = TrainConfig(**tcfg)
z = dict(np.load(src))
path = lambda p: "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                          for k in p)
params = jax.tree_util.tree_map_with_path(
    lambda p, _: jnp.asarray(z["params/" + path(p)]),
    jax.eval_shape(lambda: init_model(jax.random.PRNGKey(0), cfg)))
sched = cosine_schedule(tcfg.lr, tcfg.warmup, tcfg.steps)
update = jax.jit(lambda g, s, p: adamw_update(
    g, s, p, sched, weight_decay=tcfg.weight_decay,
    clip_norm=tcfg.clip_norm))

def loss_fn(params, corrupted, tokens, masked, t):
    logits, aux = forward(params, corrupted, cfg)
    loss, _ = masked_cross_entropy(logits, tokens, masked, t)
    return loss + aux, (loss, aux, token_accuracy(logits, tokens, masked))

flat = lambda tree: {path(p): np.asarray(v, np.float32) for p, v in
                     jax.tree_util.tree_flatten_with_path(tree)[0]}
auto = (jax.sharding.AxisType.Auto,) * 2
out, state = {}, adamw_init(params)
with activation_mesh(jax.make_mesh((4, 1), ("data", "model"),
                                   axis_types=auto)):
    grad_fn = jax.jit(jax.grad(loss_fn, has_aux=True))
    for s in range(int(z["steps"])):
        g, met = grad_fn(params, *(jnp.asarray(z[f"{k}{s}"]) for k in
                                   ("corrupted", "tokens", "masked", "t")))
        params, state = update(g, state, params)
        out[f"{s}/metrics"] = np.asarray([float(m) for m in met])
        for name, tree in (("grad", g), ("param", params), ("mu", state.mu),
                           ("nu", state.nu)):
            out.update({f"{s}/{name}/{k}": v for k, v in flat(tree).items()})
np.savez(dst, **out)
"""


def _tcfg(name):
    rows, length = BATCHES[CASES[name][2]]
    return TrainConfig(batch_size=rows, seq_len=length, steps=100,
                       clip_norm=CASES[name][3])


def _jcfg(params_name):
    arch, experts = PARAMS[params_name]
    jcfg = jax_get_config(arch).reduced()
    if experts:
        import dataclasses
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, num_experts=experts))
    return jcfg


def _batch(name, seed):
    """Seeded tokens; the first quarter of each row never masked."""
    rows, length = BATCHES[name]
    rs = np.random.default_rng(seed)
    maskable = np.ones((rows, length), bool)
    maskable[:, :length // 4] = False
    return {"tokens": rs.integers(0, 511, (rows, length)).astype(np.int64),
            "maskable": maskable}


def _corruptions(batch, seed):
    """The reference's draws of each step (t, then the masked positions)
    on the whole batch."""
    out = []
    jcfg = jax_get_config("mixtral-8x22b").reduced()   # the mask id, 511
    for s in range(STEPS):
        r1, r2 = jax.random.split(jax.random.PRNGKey(seed + s))
        t = jax_sample_mask_ratio(r1, batch["tokens"].shape[0])
        corrupted, masked = jax_apply_mask(
            r2, jnp.asarray(batch["tokens"]), t, jcfg,
            jnp.asarray(batch["maskable"]))
        out.append((np.array(corrupted, np.int64), np.array(masked),
                    np.array(t)))
    return out


def _reference_steps(jcfg, clip, jp, batch, corruptions):
    """The reference's unsharded steps: per step (metrics, gradients,
    params, mu, nu), each tree flattened."""
    def loss_fn(params, corrupted, tokens, masked, t):
        logits, aux = jax_forward(params, corrupted, jcfg)
        loss, _ = jax_mce(logits, tokens, masked, t)
        return loss + aux, (loss, aux,
                            jax_token_accuracy(logits, tokens, masked))
    grad_fn = jax.jit(jax.grad(loss_fn, has_aux=True))
    rows, length = batch["tokens"].shape
    update = _jax_adamw(JaxTrainConfig(batch_size=rows, seq_len=length,
                                       steps=100, clip_norm=clip))
    state, out = jax_adamw_init(jp), []
    for corrupted, masked, t in corruptions:
        g, met = grad_fn(jp, corrupted, jnp.asarray(batch["tokens"]), masked,
                         t)
        jp, state = update(g, state, jp)
        out.append((dict(zip(("loss", "aux", "acc"), map(float, met))),
                    _jflat(g), _jflat(jp), _jflat(state.mu),
                    _jflat(state.nu)))
    return out


def _port_steps(name, flat, batch, corruptions):
    """The port's unsharded steps of the case, as ``_reference_steps``."""
    cfg = case_config(*PARAMS[CASES[name][0]])
    step = make_steps(cfg, _tcfg(name))["train"]
    params = masters(from_flat(flat, device="cpu"))
    opt = adamw_init(params)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = []
    for corruption in corruptions:
        corr = tuple(torch.from_numpy(c) for c in corruption)
        grads, met = step.grads(params, b, corr)
        params, opt, _ = step.apply(params, opt, b, corr)
        trees = [_port_flat(t) for t in (grads, params, opt.mu, opt.nu)]
        out.append(({k: float(v) for k, v in met.items()}, *trees))
    return out


def _port_flat(tree):
    """A copy of a port tree, flat (AdamW updates the tensors in place)."""
    return {k: v.copy() for k, v in to_flat(tree).items()}


def _grouped_reference(d, flat, batch, corruptions):
    """The reference's grouped steps in a subprocess (started here, read
    by ``_read_grouped``)."""
    np.savez(d / "grouped_in.npz", steps=STEPS,
             **{f"params/{k}": v for k, v in flat.items()},
             **{f"{k}{s}": v for s, c in enumerate(corruptions)
                for k, v in zip(("corrupted", "masked", "t"), c)},
             **{f"tokens{s}": batch["tokens"] for s in range(STEPS)})
    tc = _tcfg(GROUPED)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    return subprocess.Popen(
        [sys.executable, "-c", REFERENCE_GROUPED, "mixtral-8x22b",
         json.dumps({"batch_size": tc.batch_size, "seq_len": tc.seq_len,
                     "steps": tc.steps, "clip_norm": tc.clip_norm}),
         str(d / "grouped_in.npz"), str(d / "grouped_out.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _read_grouped(proc, path):
    log, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, log
    with np.load(path) as z:
        out = []
        for s in range(STEPS):
            met = dict(zip(("loss", "aux", "acc"), z[f"{s}/metrics"]))
            trees = [{k[len(f"{s}/{n}/"):]: z[k] for k in z.files
                      if k.startswith(f"{s}/{n}/")}
                     for n in ("grad", "param", "mu", "nu")]
            out.append((met, *trees))
    return out


@pytest.fixture(scope="module")
def moe_mesh(tmp_path_factory):
    """The references and the four ranks' results."""
    d = tmp_path_factory.mktemp("moe_mesh")
    batches = {n: _batch(n, i) for i, n in enumerate(BATCHES)}
    corruptions = {n: _corruptions(b, 10 + 7 * i)
                   for i, (n, b) in enumerate(batches.items())}
    jps, flats, paths = {}, {}, {}
    for name in PARAMS:
        jps[name] = jax.device_get(_jax_init(_jcfg(name)))
        flats[name] = _jflat(jps[name])
        paths[name] = str(d / f"{name}.npz")
        np.savez(paths[name], **flats[name])
    out = d / "trees"
    out.mkdir()
    spec = {"params": paths, "batches": batches, "corruptions": corruptions,
            "out": str(out),
            "cases": {name: {"arch": PARAMS[p][0], "experts": PARAMS[p][1],
                             "params": p, "mesh": mesh, "batch": b,
                             "remat": name.endswith("remat"),
                             "tcfg": dict(vars(_tcfg(name)))}
                      for name, (p, mesh, b, _) in CASES.items()}}
    grouped = _grouped_reference(d, flats["mixtral"], batches["long"],
                                 corruptions["long"])
    pool = ThreadPoolExecutor(1)
    ranks = pool.submit(spawn, moe_mesh_rank, 4, "gloo", str(d / "store"),
                        spec)
    ref, port = {}, {}
    for name, (p, _, b, clip) in CASES.items():
        if name == GROUPED:
            continue
        ref[name] = _reference_steps(_jcfg(p), clip, jps[p], batches[b],
                                     corruptions[b])
        port[name] = _port_steps(name, flats[p], batches[b], corruptions[b])
    # the global dispatch's aux on the grouped case's first corruption
    cfg = case_config("mixtral-8x22b")
    with torch.no_grad():
        _, global_aux = model_mod.forward(
            from_flat(flats["mixtral"], device="cpu"),
            torch.from_numpy(corruptions["long"][0][0]), cfg,
            return_aux=True)
    port[GROUPED] = float(global_aux)
    ref[GROUPED] = _read_grouped(grouped, d / "grouped_out.npz")
    ranks = ranks.result()
    pool.shutdown()
    return ref, port, ranks, spec


def _trees(spec, case, step):
    with np.load(os.path.join(spec["out"], f"{case}_{step}.npz")) as z:
        return {k: z[k] for k in z.files}


def _scale_err(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _hold(trees, steps, what):
    """The gathered trees of every step against ``steps`` (a reference's
    or the port's unsharded steps: metrics, gradients, params, mu, nu):
    the module docstring's tolerances."""
    grads = []
    for s, (_, want_g, want_p, want_mu, want_nu) in enumerate(steps):
        got = trees[s]
        grads.append(want_g)
        assert sorted(k[5:] for k in got if k.startswith("grad/")) == \
            sorted(want_g), what
        for name, want_tree, tol in (("grad", want_g, 1e-5),
                                     ("mu", want_mu, 1e-5),
                                     ("nu", want_nu, 2e-5)):
            for key, want in want_tree.items():
                err = _scale_err(got[f"{name}/{key}"], want)
                assert err <= tol, (what, s, name, key, err)
        for key, want in want_p.items():
            sure = np.all([(np.abs(g[key]) > 1e-4 * np.abs(g[key]).max())
                           | (g[key] == 0) for g in grads], axis=0)
            assert sure.any(), key
            err = np.abs(got["param/" + key] - want)[sure]
            assert np.all(err <= 1e-5 * np.abs(want).max()), (what, s, key)


def _metrics_match(ranks, case, steps):
    first = ranks[0][case]["metrics"]
    for r in ranks[1:]:
        assert r[case]["metrics"] == first, "metrics differ between ranks"
    for s, want in enumerate(steps):
        for key in ("loss", "aux", "acc"):
            got = np.asarray(first[s][key])     # grads' and apply's
            scale = 1.0 if key == "acc" else abs(want[0][key])
            assert np.all(np.abs(got - want[0][key]) <= 1e-5 * scale), \
                (s, key, got, want[0][key])


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_moe_step_matches_the_reference(moe_mesh, case):
    ref, _, ranks, spec = moe_mesh
    _metrics_match(ranks, case, ref[case])
    _hold([_trees(spec, case, s) for s in range(STEPS)], ref[case], case)


@pytest.mark.parametrize("case", sorted(set(CASES) - {GROUPED}))
def test_sharded_moe_step_matches_one_rank(moe_mesh, case):
    _, port, ranks, spec = moe_mesh
    _metrics_match(ranks, case, port[case])
    _hold([_trees(spec, case, s) for s in range(STEPS)], port[case], case)


def test_grouped_dispatch_ran_and_its_aux_is_the_groups_mean(moe_mesh):
    """The grouped case's aux is the reference's mean over its four
    groups, not the global dispatch's aux over the 4096 tokens."""
    ref, port, ranks, _ = moe_mesh
    got = ranks[0][GROUPED]["metrics"][0]["aux"][0]
    want = ref[GROUPED][0][0]["aux"]
    assert abs(got - want) <= 1e-5 * abs(want)
    assert abs(port[GROUPED] - want) > 1e-3 * abs(want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_ranks_holding_one_part_have_equal_gradients(moe_mesh, case):
    """Every pair of ranks whose coordinates agree on the axes that cut a
    leaf holds the same part of it: their gradients are equal."""
    _, _, ranks, _ = moe_mesh
    steps = ranks[0][case]["replicated"]
    assert steps and all(steps), "no leaf is held by two ranks"
    pairs = 0
    for s in range(len(steps)):
        for a in ranks:
            for b in ranks:
                ca, cb = a[case]["coords"], b[case]["coords"]
                if ca == cb:
                    continue
                for i, (axes, ga) in a[case]["replicated"][s].items():
                    if all(ca[x] == cb[x] for x in axes):
                        assert np.array_equal(
                            ga, b[case]["replicated"][s][i][1]), (s, i)
                        pairs += 1
    assert pairs


def test_expert_layout_follows_the_reference_rule(moe_mesh):
    """Experts on ``model`` where E divides it, else whole on every rank
    with their ffn dim split (the 6 experts at (1, 4))."""
    _, _, ranks, _ = moe_mesh
    want = {"mixtral-4x1-grouped": 4, "mixtral-4x1": 4,
            "mixtral-2x2-remat": 2, "mixtral-1x4": 1,
            "mixtral-6-experts-1x4": 6, "deepseek-4x1": 4,
            "deepseek-2x2-remat": 2, "deepseek-1x4": 1}
    assert sorted(want) == sorted(CASES)
    for r in ranks:
        assert {c: r[c]["experts"] for c in CASES} == want


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "deepseek-v2-236b"])
@pytest.mark.parametrize("shape", [(4, 1), (2, 2), (1, 4)])
def test_moe_rank_bytes_equals_the_summed_shard_sizes(arch, shape):
    mesh = {"data": shape[0], "model": shape[1]}
    cfg = case_config(arch)
    full = init_model(cfg, device="cpu", dtype=torch.float32)
    specs = param_pspecs(full, mesh, fsdp=True)
    meta = init_model(cfg, device="meta", dtype=torch.float32)
    for rank in range(4):
        held = sum(t.numel() * t.element_size()
                   for t in leaves(shard_tree(full, specs, mesh, rank)))
        assert rank_bytes(full, specs, mesh) == held
        assert rank_bytes(meta, specs, mesh) == held
    assert rank_bytes(full, specs, mesh) < sum(t.numel() * 4
                                               for t in leaves(full))
