"""The reference's training step under a mesh: the port's FSDP and
tensor-parallel ``TrainStep`` on four gloo ranks on the CPU, against the
reference's unsharded step.

One spawn of four ranks (``parallel.launch.spawn``, a ``FileStore`` under
the test's temporary directory) runs every case of ``CASES`` on its mesh
(``torch_fsdp_ranks.fsdp_rank``): the reference's initial params cut to
the rank's training-layout shards, then two steps (the ``grads`` and
``apply`` of ``make_steps(..., mesh=)["train"]``, or of a bare
``TrainStep`` inside the rank's ``activation_mesh``) on the rank's rows of the reference's corruption
of one 16-row batch.  Meanwhile this process runs the reference's two
steps on the whole batch (its loss, ``jax.grad`` and ``adamw_update``, as
``test_torch_train.py:_reference_step`` does, carried over two steps).

Tolerances, against the reference's step (gathered back from the shards):

* loss, aux and accuracy within 1e-5 of their scale (the loss's
  magnitude; 1 for the accuracy, a fraction), each data rank's shares
  summed; every rank's metrics equal;
* each gradient, ``mu`` and ``nu`` leaf within 1e-5 of its max |value|;
  parameters within 1e-5 of their max |value| wherever the gradient of
  every step so far is zero or lies above 1e-4 of its leaf's max (an
  element whose gradient is within the gradients' own tolerance of zero
  may step either way: step 1's update is lr·g/(|g| + eps));
* with ``bf16_params`` each gradient element is rounded to bf16 in both
  packages, so f32 noise before that rounding may move an element by one
  bf16 ulp of itself: gradients within one ulp of the element plus 1e-4
  of the leaf's max (``test_torch_train.py``'s rule); the token table's
  rows are sums over the positions that look them up, accumulated in
  bf16 in both packages (the reference's lookup is on the bf16 table),
  in another order where the positions lie on several data ranks: each
  within twice the sequential sum's error bound, (n − 1)·2^-8·Σ|term|
  for n terms (``_grad_tol``); the moments within the gradients'
  tolerance carried through their update plus 1e-5 of their max, the
  parameters within the widest step AdamW takes from moments anywhere in
  those bounds (``_update_tol``), summed over the steps;
* the gradients of a leaf are equal, bit for bit, on every rank that
  holds the same part of it (a norm scale on all four).
"""
import functools
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import _jax_adamw, _jax_init, _jflat
from torch_fsdp_ranks import fsdp_rank
from torch_threads import one_torch_thread  # noqa: F401

from repro.configs import TrainConfig as JaxTrainConfig
from repro.configs import get_config as jax_get_config
from repro.core.loss import masked_cross_entropy as jax_mce
from repro.core.loss import token_accuracy as jax_token_accuracy
from repro.core.masking import apply_mask as jax_apply_mask
from repro.core.masking import sample_mask_ratio as jax_sample_mask_ratio
from repro.data import CharTokenizer as JaxCharTokenizer
from repro.data import TaskDataset as JaxTaskDataset
from repro.models.model import forward as jax_forward
from repro.training import adamw_init as jax_adamw_init
from repro.training import load as jax_load
from repro_torch.configs import TrainConfig, get_config
from repro_torch.convert import from_flat, to_flat
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.launch.steps import make_steps
from repro_torch.models import init_model
from repro_torch.models import model as model_mod
from repro_torch.models.blocks import check_fsdp
from repro_torch.parallel.launch import spawn
from repro_torch.parallel.sharding import (param_pspecs, rank_bytes,
                                           shard_tree, train_rows)
from repro_torch.training import load
from repro_torch.training.optimizer import leaves
from repro_torch.training.trainer import corrupt, masters

ROWS, STEPS = 16, 2
# the clip's norm: the untrained models' gradient norms lie near 10, so
# 1.0 clips every step and 1e4 none
CLIP, NO_CLIP = 1.0, 1e4
ARCHS = {"llada": "llada-8b", "qwen3": "qwen3-14b", "chatglm3": "chatglm3-6b"}
# name -> (arch, mesh, port overrides of the reduced config, TrainStep
# keywords, clip norm); the reference runs the reduced config without
# remat (the same gradients)
CASES = {
    "llada-4x1": ("llada", (4, 1), {}, {}, CLIP),
    "llada-2x2-remat": ("llada", (2, 2), dict(remat="block"), {}, NO_CLIP),
    "llada-1x4-remat": ("llada", (1, 4), dict(remat="block"), {}, CLIP),
    "llada-1x4": ("llada", (1, 4), {}, {}, NO_CLIP),
    "llada-2x2-bf16-params": ("llada", (2, 2), {}, dict(bf16_params=True),
                              CLIP),
    "llada-2x2-microbatch2": ("llada", (2, 2), {}, dict(microbatch=2), CLIP),
    # Qwen3's replicated f32 q/k norm scales act on the local heads
    "qwen3-2x2": ("qwen3", (2, 2), {}, {}, CLIP),
    "chatglm3-4x1": ("chatglm3", (4, 1), {}, {}, CLIP),
    # a bare TrainStep run inside activation_mesh on model shards (once a
    # model rank's upstream gradients were its own heads' share); the
    # other cases run make_steps(..., mesh=)["train"]
    "llada-1x4-activation-mesh": ("llada", (1, 4), {}, {}, CLIP),
}
CHECKPOINT_CASE = "llada-2x2-remat"


def _tcfg(clip):
    return TrainConfig(batch_size=ROWS, seq_len=16, steps=100,
                       clip_norm=clip)


@functools.lru_cache(maxsize=None)
def _grad_fn(jcfg, bf16_params):
    """The reference's loss (as ``test_torch_train.py:_reference_step``'s)
    with its accuracy, differentiated and compiled once."""
    def loss_fn(params, corrupted, tokens, masked, t):
        if bf16_params:
            params = jax.tree.map(lambda p: p.astype(jnp.bfloat16)
                                  if p.dtype == jnp.float32 else p, params)
        logits, aux = jax_forward(params, corrupted, jcfg)
        loss, _ = jax_mce(logits, tokens, masked, t)
        return loss + aux, (loss, aux,
                            jax_token_accuracy(logits, tokens, masked))
    return jax.jit(jax.grad(loss_fn, has_aux=True))


def _reference_steps(case, jp, batch, corruptions):
    """The reference's unsharded steps: per step (metrics, gradients,
    params, mu, nu), each tree flattened."""
    arch, _, _, kw, clip = CASES[case]
    grad_fn = _grad_fn(jax_get_config(ARCHS[arch]).reduced(),
                       kw.get("bf16_params", False))
    update = _jax_adamw(JaxTrainConfig(**vars(_tcfg(clip))))
    n = kw.get("microbatch", 1)
    tokens = jnp.asarray(batch["tokens"])
    state, out = jax_adamw_init(jp), []
    for corrupted, masked, t in corruptions:
        grads, mets = None, []
        for i in range(n):
            sl = slice(i * ROWS // n, (i + 1) * ROWS // n)
            g, met = grad_fn(jp, corrupted[sl], tokens[sl], masked[sl], t[sl])
            grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
            mets.append([float(m) for m in met])
        grads = jax.tree.map(lambda a: a / n, grads)
        jp, state = update(grads, state, jp)
        out.append((dict(zip(("loss", "aux", "acc"), np.mean(mets, 0))),
                    _jflat(grads), _jflat(jp), _jflat(state.mu),
                    _jflat(state.nu)))
    return out


@pytest.fixture(scope="module")
def fsdp(tmp_path_factory):
    """The reference's steps and the four ranks' results."""
    d = tmp_path_factory.mktemp("fsdp")
    ds = JaxTaskDataset("sum", JaxCharTokenizer(512))
    batch = {k: np.asarray(v)[:ROWS] for k, v in
             next(ds.batches(32, seed=3)).items() if k != "answers"}
    batch = {"tokens": batch["tokens"].astype(np.int64),
             "maskable": batch["maskable"].astype(bool)}
    jps, paths = {}, {}
    for arch, name in ARCHS.items():
        jps[arch] = jax.device_get(_jax_init(jax_get_config(name).reduced()))
        paths[name] = str(d / f"{arch}.npz")
        np.savez(paths[name], **_jflat(jps[arch]))
    corruptions = []
    for s in range(STEPS):
        r1, r2 = jax.random.split(jax.random.PRNGKey(10 + s))
        # the three archs share the reduced vocab and its mask id
        jcfg = jax_get_config("llada-8b").reduced()
        t = jax_sample_mask_ratio(r1, ROWS)
        corrupted, masked = jax_apply_mask(
            r2, jnp.asarray(batch["tokens"]), t, jcfg,
            jnp.asarray(batch["maskable"]))
        corruptions.append(tuple(np.asarray(a) for a in (corrupted, masked,
                                                         t)))
    out = d / "trees"
    out.mkdir()
    spec = {"params": paths, "batch": batch, "out": str(out),
            "checkpoint": str(d / "sharded.npz"),
            "corruptions": [(c.astype(np.int64), m, t)
                            for c, m, t in corruptions],
            "cases": {name: {"arch": ARCHS[arch], "mesh": mesh,
                             "over": over, "kw": kw,
                             "tcfg": vars(_tcfg(clip)),
                             "save": name == CHECKPOINT_CASE,
                             "bare": name.endswith("activation-mesh")}
                      for name, (arch, mesh, over, kw, clip)
                      in CASES.items()}}
    pool = ThreadPoolExecutor(1)
    ranks = pool.submit(spawn, fsdp_rank, 4, "gloo", str(d / "store"), spec)
    ref = {name: _reference_steps(name, jps[CASES[name][0]], batch,
                                  corruptions) for name in CASES}
    ranks = ranks.result()
    pool.shutdown()
    return ref, ranks, spec


def _flat(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _trees(spec, case, step):
    return _flat(os.path.join(spec["out"], f"{case}_{step}.npz"))


def _scale_err(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _bf16_ulp(x):
    mag = np.abs(x)
    return np.where(mag > 0, np.exp2(np.floor(np.log2(np.where(
        mag > 0, mag, 1.0))) - 7), 0.0)


def _table_terms(flat, batch, corruption, monkeypatch):
    """(Σ |term|, count) per row of the token table: the terms its bf16
    gradient accumulates, one a position that looks the row up (the
    embedding's cotangent there, from the port's unsharded bf16 step on
    the params ``flat``), and how many there are."""
    cfg = get_config("llada-8b").reduced()
    looked_up = []
    real = model_mod.embed_tokens

    def grab(*args, **kw):
        looked_up.append(real(*args, **kw))
        return looked_up[-1]
    monkeypatch.setattr(model_mod, "embed_tokens", grab)
    step = make_steps(cfg, _tcfg(CLIP), frozenset({"bf16_gather"}))["train"]
    loss, _ = step.loss(masters(from_flat(flat, device="cpu")),
                        {k: torch.from_numpy(v) for k, v in batch.items()},
                        tuple(torch.tensor(c) for c in corruption))
    (g,) = torch.autograd.grad(loss, looked_up)
    ids = torch.from_numpy(corruption[0]).reshape(-1) % cfg.vocab_size
    terms = torch.zeros(cfg.vocab_size, cfg.d_model).index_add_(
        0, ids, g.abs().reshape(ids.shape[0], -1))
    return terms.numpy(), np.bincount(ids.numpy(), minlength=cfg.vocab_size)


def _grad_tol(key, want, table):
    """The elementwise tolerance of a bf16-params gradient leaf: one bf16
    ulp of the element plus 1e-4 of the leaf's max; the token table's
    rows are sums over the positions that look them up, accumulated in
    bf16 in both packages, in another order where the positions lie on
    several data ranks: each sum of n terms within twice the sequential
    sum's error bound, (n − 1)·2^-8·Σ|term|, of the reference's."""
    tol = _bf16_ulp(want) + 1e-4 * np.abs(want).max()
    if key == "embed/tok":
        terms, n = table
        tol = tol + 2 * np.maximum(n - 1, 0)[:, None] * 2.0 ** -8 * terms
    return tol


def _update_tol(step, mu, nu, tmu, tnu, b1=0.9, b2=0.95, eps=1e-8):
    """How far AdamW's step ``step`` may move a parameter when its moments
    lie anywhere within ``tmu``/``tnu`` of ``mu``/``nu``: lr times the
    widest change of m̂/(√v̂ + eps) over the corners of that box (the
    update is monotone in each moment)."""
    lr = _tcfg(CLIP).lr * min(step / _tcfg(CLIP).warmup, 1.0)
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step

    def upd(m, v):
        return (m / bc1) / (np.sqrt(np.maximum(v, 0) / bc2) + eps)
    mid = upd(mu, nu)
    return lr * np.max([np.abs(upd(mu + dm, nu + dv) - mid)
                        for dm in (-tmu, tmu) for dv in (-tnu, tnu)], axis=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_step_matches_the_unsharded_reference(fsdp, case,
                                                     monkeypatch):
    ref, ranks, spec = fsdp
    bf16 = CASES[case][3].get("bf16_params", False)
    first = ranks[0][case]["metrics"]
    for r in ranks[1:]:
        assert r[case]["metrics"] == first, "metrics differ between ranks"
    ref_grads, mtol, ptol = [], {}, {}
    before = _flat(spec["params"]["llada-8b"])
    for s, (want_met, want_g, want_p, want_mu, want_nu) in enumerate(
            ref[case]):
        for key in ("loss", "aux", "acc"):
            got = np.asarray(first[s][key]).reshape(-1)
            scale = 1.0 if key == "acc" else abs(want_met[key])
            assert np.all(np.abs(got - want_met[key]) <= 1e-5 * scale), key
        trees = _trees(spec, case, s)
        ref_grads.append(want_g)
        assert sorted(k[5:] for k in trees if k.startswith("grad/")) == \
            sorted(want_g)
        table = _table_terms(before, spec["batch"], spec["corruptions"][s],
                             monkeypatch) if bf16 else None
        for key, want in want_g.items():
            got = trees["grad/" + key]
            if bf16:
                tol = _grad_tol(key, want, table)
                assert np.all(np.abs(got - want) <= tol), (s, key)
                # the moments' tolerance: the gradients' carried through
                # their updates
                m, v = mtol.get(key, (0.0, 0.0))
                mtol[key] = (0.9 * m + 0.1 * tol, 0.95 * v + 0.05 * (
                    2 * np.abs(want) + tol) * tol)
            else:
                assert _scale_err(got, want) <= 1e-5, (s, key)
        before = want_p
        for i, (name, want_tree) in enumerate((("mu", want_mu),
                                               ("nu", want_nu))):
            for key, want in want_tree.items():
                tol = 1e-5 * np.abs(want).max() + (mtol[key][i] if bf16
                                                   else 0.0)
                got = trees[f"{name}/{key}"]
                assert np.all(np.abs(got - want) <= tol), (s, name, key)
                if bf16:
                    mtol[key] = mtol[key][:i] + (tol,) + mtol[key][i + 1:]
        for key, want in want_p.items():
            err = np.abs(trees["param/" + key] - want)
            if bf16:
                ptol[key] = ptol.get(key, 0.0) + _update_tol(
                    s + 1, want_mu[key], want_nu[key], *mtol[key])
                assert np.all(err <= ptol[key] + 2 * np.spacing(np.abs(
                    want)) + 1e-6 * np.abs(want).max()), (s, key)
                continue
            sure = np.all([(np.abs(g[key]) > 1e-4 * np.abs(g[key]).max())
                           | (g[key] == 0) for g in ref_grads], axis=0)
            assert sure.any(), key
            assert np.all(err[sure] <= 1e-5 * np.abs(want).max()), (s, key)


@pytest.mark.parametrize("case", sorted(CASES))
def test_ranks_holding_one_part_have_equal_gradients(fsdp, case):
    """Every pair of ranks whose coordinates agree on the axes that cut a
    leaf holds the same part of it: their gradients are equal."""
    _, ranks, _ = fsdp
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


def test_clip_is_active_and_not(fsdp):
    ref, _, _ = fsdp
    for case, (_, _, _, _, clip) in CASES.items():
        g = ref[case][0][1]
        norm = float(np.sqrt(sum(np.square(v.astype(np.float64)).sum()
                                 for v in g.values())))
        assert (norm > clip) == (clip == CLIP), (case, norm)


def test_sharded_checkpoint_loads_in_both_packages(fsdp):
    _, _, spec = fsdp
    trees = _trees(spec, CHECKPOINT_CASE, STEPS - 1)
    template = _jax_init(jax_get_config("llada-8b").reduced(), seed=1)
    jparams, jopt, jstep = jax_load(spec["checkpoint"], template,
                                    jax_adamw_init(template))
    params, opt, step = load(spec["checkpoint"], device="cpu")
    assert jstep == step == opt.step == int(jopt.step) == STEPS
    for name, jtree, tree in (("param", jparams, params),
                              ("mu", jopt.mu, opt.mu),
                              ("nu", jopt.nu, opt.nu)):
        for key, arr in _jflat(jtree).items():
            np.testing.assert_array_equal(arr, trees[f"{name}/{key}"])
        for key, arr in to_flat(tree).items():
            np.testing.assert_array_equal(arr, trees[f"{name}/{key}"])


@pytest.mark.parametrize("shape", [(4, 1), (2, 2), (1, 4)])
def test_rank_bytes_equals_the_summed_shard_sizes(shape):
    mesh = {"data": shape[0], "model": shape[1]}
    cfg = get_config("llada-8b").reduced()
    full = init_model(cfg, device="cpu", dtype=torch.float32)
    specs = param_pspecs(full, mesh, fsdp=True)
    meta = init_model(cfg, device="meta", dtype=torch.float32)
    for rank in range(4):
        shard = shard_tree(full, specs, mesh, rank)
        held = sum(t.numel() * t.element_size() for t in leaves(shard))
        assert rank_bytes(full, specs, mesh) == held
        assert rank_bytes(meta, specs, mesh) == held
    total = sum(t.numel() * 4 for t in leaves(full))
    assert rank_bytes(full, specs, mesh) < total


def test_train_rows_and_the_whole_batch_draws():
    """A rank's rows: its part of each microbatch in turn; its corruption
    is the whole batch's draws at those rows."""
    mesh = Mesh({"data": 2, "model": 2})
    assert [train_rows(16, mesh, r, 2).tolist() for r in range(4)] == \
        [[0, 1, 2, 3, 8, 9, 10, 11]] * 2 + [[4, 5, 6, 7, 12, 13, 14, 15]] * 2
    assert train_rows(16, mesh, 3).tolist() == list(range(8, 16))
    with pytest.raises(ValueError):
        train_rows(6, mesh, 0, 2)
    cfg = get_config("llada-8b").reduced()
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, 500, (8, 12), generator=gen)
    maskable = torch.rand(8, 12, generator=gen) < 0.7
    whole = corrupt(torch.Generator().manual_seed(5), tokens, maskable, cfg)
    rows = train_rows(8, Mesh({"data": 4, "model": 1}), 2)
    mine = corrupt(torch.Generator().manual_seed(5), tokens[rows],
                   maskable[rows], cfg, (8, rows))
    for a, b in zip(whole, mine):
        assert torch.equal(a[rows], b)


@pytest.mark.parametrize("mesh", ["host", "2x2"])
def test_moe_training_under_a_mesh_raises(mesh):
    """Training under a mesh covers the dense GQA and the MoE stacks
    (``test_torch_moe_mesh.py`` trains them); a family still refused there
    (Hymba under the host mesh, whisper under 2x2) raises before any
    collective (the 2x2 mesh has no process groups)."""
    m = make_host_mesh() if mesh == "host" else Mesh({"data": 2, "model": 2})
    for arch in ("mixtral-8x22b", "deepseek-v2-236b"):
        check_fsdp(get_config(arch).reduced())
    cfg = get_config("hymba-1.5b" if mesh == "host"
                     else "whisper-medium").reduced()
    train = make_steps(cfg, TrainConfig(batch_size=4, seq_len=8),
                       mesh=m)["train"]
    params = init_model(cfg, device="cpu", dtype=torch.float32)
    batch = {"tokens": torch.zeros(4, 8, dtype=torch.long),
             "maskable": torch.ones(4, 8, dtype=torch.bool)}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train(params, None, torch.Generator().manual_seed(0), batch)
