"""The port's training stack against the reference's, on the CPU.

Same weights (bridged), same batches (numpy), and the reference's
corruption ``(corrupted, masked, t)`` injected into the port's step (the
two packages' generators cannot draw the same bits).  Tolerances:

* loss: rel 1e-5 (f32);
* a gradient leaf (f32): max abs error ≤ 1e-4 × the leaf's max |g|;
* with ``bf16_params`` every leaf's gradient is rounded to bf16 in both
  packages (the transpose of the cast), so f32 noise before that rounding
  may move an element by one bf16 ulp of itself: each element agrees
  within one ulp of its own magnitude (2^(⌊log2 |g|⌋ − 7)) plus the f32
  tolerance above;
* AdamW: ``mu``/``nu`` within 1e-5 × their max (the clip's global norm
  sums ~10⁶ squares, in another order in each package), ``step`` equal,
  parameter deltas within (steps + 1) f32 spacings of the parameter plus
  1e-6 × their max (a delta of ~lr is ~1e-4 of a parameter, so the
  parameters' own rounding shows); after a real step likewise with two
  spacings, where the gradient is zero or lies above its tolerance (an
  element whose gradient is within the tolerance of zero may take either
  sign at step 1, where the update is lr·g/(|g| + eps));
* attention's backward: 1e-5 × max |g| against autograd of the plain
  version and ``jax.grad`` of the reference's ``_sdpa``.
"""
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro.configs import TrainConfig as JaxTrainConfig
from repro.configs import get_config as jax_get_config
from repro.core.loss import masked_cross_entropy as jax_mce
from repro.core.loss import token_accuracy as jax_token_accuracy
from repro.core.masking import apply_mask as jax_apply_mask
from repro.core.masking import sample_mask_ratio as jax_sample_mask_ratio
from repro.data import CharTokenizer as JaxCharTokenizer
from repro.data import TaskDataset as JaxTaskDataset
from repro.models.attention import _sdpa, band_mask
from repro.models.model import forward as jax_forward
from repro.models.model import init_model as jax_init_model
from repro.training import adamw_init as jax_adamw_init
from repro.training import adamw_update as jax_adamw_update
from repro.training import cosine_schedule as jax_cosine_schedule
from repro.training import load as jax_load
from repro.training import save as jax_save
from repro_torch.configs import TrainConfig, get_config
from repro_torch.convert import from_jax_params, to_flat
from repro_torch.core.loss import masked_cross_entropy, token_accuracy
from repro_torch.data import TASKS, CharTokenizer, TaskDataset
from repro_torch.kernels.confidence import confidence_fused
from repro_torch.kernels.flash_attention import (attention_backward,
                                                 attention_ref,
                                                 flash_attention)
from repro_torch.kernels.selective_scan import selective_scan
from repro_torch.training import (adamw_init, adamw_update, cosine_schedule,
                                  load, make_train_step, save, train)
from repro_torch.training.optimizer import leaves, tree_map
from repro_torch.training.trainer import masters, to_device_batch

REPO = Path(__file__).resolve().parents[1]
# the testbed: the paper's arch family at benchmarks/common.py's overrides
TESTBED = dict(num_layers=4, d_model=256, num_heads=4, num_kv_heads=4,
               d_ff=1024)
CASES = {"llada": ("llada-8b", TESTBED, {}),
         "llada-remat": ("llada-8b", dict(TESTBED, remat="block"), {}),
         "llada-microbatch": ("llada-8b", TESTBED, dict(microbatch=2)),
         "llada-bf16-params": ("llada-8b", TESTBED,
                               dict(bf16_params=True)),
         "hymba-tiny": ("hymba-1.5b", {}, {}),
         # MoE: the objective is loss + the router's aux loss
         "mixtral-tiny": ("mixtral-8x22b", {}, {}),
         "mixtral-microbatch": ("mixtral-8x22b", {}, dict(microbatch=2)),
         "mixtral-bf16-params": ("mixtral-8x22b", {},
                                 dict(bf16_params=True)),
         "deepseek-tiny": ("deepseek-v2-236b", {}, {})}
# rows of the batch per case: the reference's chunked Mamba scan takes
# seconds per row-batch of 32 on the CPU, so Hymba's step runs on 8
ROWS = {"hymba-tiny": 8, "deepseek-tiny": 8}


def _jflat(tree) -> dict:
    """A reference tree -> {checkpoint path: f32 array}."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = np.asarray(leaf, np.float32)
    return out


def _rel_err(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _within_f32_ulps(got: np.ndarray, want: np.ndarray, params: np.ndarray,
                     ulps: int, rel: float) -> bool:
    """|got − want| ≤ ``ulps`` f32 spacings of the parameter each delta
    was added to, plus ``rel`` × max |want|."""
    tol = ulps * np.spacing(np.abs(params).astype(np.float32)) + \
        rel * np.abs(want).max()
    return bool(np.all(np.abs(got - want) <= tol))


def _within_bf16_ulp(got: np.ndarray, want: np.ndarray) -> bool:
    """|got − want| ≤ one bf16 ulp of the element + 1e-4 × max |want|."""
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.where(mag > 0, mag, 1.0))) - 7)
    tol = np.where(mag > 0, ulp, 0.0) + 1e-4 * np.abs(want).max()
    return bool(np.all(np.abs(got - want) <= tol))


@functools.lru_cache(maxsize=None)
def _jax_init(jcfg, seed: int = 0):
    """The reference's ``init_model``, compiled once (op by op it
    compiles every primitive of every leaf shape)."""
    return jax.jit(jax_init_model, static_argnums=1)(
        jax.random.PRNGKey(seed), jcfg)


@pytest.fixture(scope="module")
def task():
    ds = JaxTaskDataset("sum", JaxCharTokenizer(512))
    return ds, next(ds.batches(32, seed=3))


# --------------------------------------------------------------------------
# data, loss
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(TASKS))
def test_task_batches_equal_reference(name):
    ours = TaskDataset(name, CharTokenizer(512))
    ref = JaxTaskDataset(name, JaxCharTokenizer(512))
    assert ours.seq_len == ref.seq_len
    assert ours.answer_slice == ref.answer_slice
    gb, wb = ours.batches(8, seed=5), ref.batches(8, seed=5)
    pairs = [(next(gb), next(wb)) for _ in range(3)]
    pairs.append((ours.eval_batch(16), ref.eval_batch(16)))
    for g, w in pairs:
        assert g["tokens"].tobytes() == w["tokens"].tobytes()
        assert g["tokens"].dtype == w["tokens"].dtype
        assert g["maskable"].tobytes() == w["maskable"].tobytes()
        assert g["answers"] == w["answers"]


def test_loss_and_accuracy_match_reference():
    rs = np.random.default_rng(0)
    logits = (3 * rs.standard_normal((4, 9, 33))).astype(np.float32)
    targets = rs.integers(0, 33, (4, 9)).astype(np.int32)
    masked = rs.random((4, 9)) < 0.5
    masked[2] = False                                 # a row with none
    t = np.asarray([0.3, 1e-4, 0.9, 0.05], np.float32)   # one below 1e-3
    targets[0, masked[0]] = logits[0, masked[0]].argmax(-1)  # some hits
    want, want_count = jax_mce(jnp.asarray(logits), jnp.asarray(targets),
                               jnp.asarray(masked), jnp.asarray(t))
    got, count = masked_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(targets),
        torch.from_numpy(masked), torch.from_numpy(t))
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    np.testing.assert_array_equal(count.numpy(), np.asarray(want_count))
    acc = token_accuracy(torch.from_numpy(logits), torch.from_numpy(targets),
                         torch.from_numpy(masked))
    want_acc = jax_token_accuracy(jnp.asarray(logits), jnp.asarray(targets),
                                  jnp.asarray(masked))
    assert 0 < float(acc) < 1
    assert float(acc) == pytest.approx(float(want_acc), rel=1e-6)
    none = torch.zeros(4, 9, dtype=torch.bool)
    loss0, _ = masked_cross_entropy(torch.from_numpy(logits),
                                    torch.from_numpy(targets), none,
                                    torch.from_numpy(t))
    assert float(loss0) == 0.0                        # count clamped to 1


# --------------------------------------------------------------------------
# attention's backward
# --------------------------------------------------------------------------

# (B, Lq, Lk, H, G, d, window, q_offset, chunk)
ATTN_GRAD_CASES = {"mha": (2, 12, 12, 4, 4, 32, 0, 0, 1024),
                   "gqa": (2, 12, 12, 4, 2, 32, 0, 0, 1024),
                   "band-q-offset": (2, 6, 16, 4, 2, 32, 5, 7, 1024),
                   "chunked-band": (1, 13, 13, 2, 1, 64, 4, 0, 4)}


@pytest.mark.parametrize("case", sorted(ATTN_GRAD_CASES))
def test_attention_backward_matches_autograd_and_jax(case):
    b, lq, lk, h, g, d, window, q_offset, chunk = ATTN_GRAD_CASES[case]
    rs = np.random.default_rng(lq + g)
    q, k, v = (rs.standard_normal(s).astype(np.float32)
               for s in ((b, lq, h, d), (b, lk, g, d), (b, lk, g, d)))
    dout = rs.standard_normal((b, lq, h, d)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = attention_ref(tq, tk, tv, window, q_offset)
    want = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    got = attention_backward(tq.detach(), tk.detach(), tv.detach(),
                             out.detach(), torch.from_numpy(dout), window,
                             q_offset, chunk=chunk)
    mask = band_mask(q_offset + jnp.arange(lq), jnp.arange(lk), window) \
        if window else None

    def jax_loss(q, k, v):
        return jnp.sum(_sdpa(q, k, v, mask, d ** -0.5) * dout)
    jax_grads = jax.jit(jax.grad(jax_loss, argnums=(0, 1, 2)))(q, k, v)
    for gt, wt, jt, name in zip(got, want, jax_grads, "qkv"):
        assert gt.dtype == torch.float32 and gt.shape == wt.shape
        assert _rel_err(gt.numpy(), wt.numpy()) <= 1e-5, name
        assert _rel_err(gt.numpy(), np.asarray(jt)) <= 1e-5, name


def test_attention_backward_keeps_the_input_dtype():
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 8, 2, 32, generator=gen).bfloat16()
               for _ in range(3))
    out = attention_ref(q, k, v)
    grads = attention_backward(q, k, v, out, torch.ones_like(out))
    assert all(t.dtype == torch.bfloat16 for t in grads)


def test_cpu_wrappers_keep_their_gradients():
    """On the CPU every wrapper runs its plain version, which autograd
    differentiates."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 8, 2, 32, generator=gen, requires_grad=True)
               for _ in range(3))
    assert flash_attention(q, k, v).grad_fn is not None
    logits = torch.randn(3, 17, generator=gen, requires_grad=True)
    _, maxp, margin, negent = confidence_fused(logits)
    assert all(t.grad_fn is not None for t in (maxp, margin, negent))
    x, delta = (torch.rand(1, 5, 4, generator=gen, requires_grad=True)
                for _ in range(2))
    bs, cs = (torch.randn(1, 5, 3, generator=gen) for _ in range(2))
    y = selective_scan(x, delta, bs, cs, torch.zeros(4, 3))
    assert y.grad_fn is not None
    y.sum().backward()
    assert x.grad is not None and delta.grad is not None


# --------------------------------------------------------------------------
# one train step, AdamW
# --------------------------------------------------------------------------

def _configs(name, over):
    jcfg = jax_get_config(name).reduced(**over)
    return jcfg, get_config(name).reduced(**over)


def _reference_step(jcfg, tcfg, jp, batch, corruption, bf16_params,
                    microbatch):
    """The reference's step from its public functions, on a given
    corruption: loss, gradients (averaged over microbatches, as its
    ``make_train_step`` does) and the AdamW update."""
    corrupted, masked, t = corruption
    tokens = jnp.asarray(batch["tokens"])

    def loss_fn(params, corrupted, tokens, masked, t):
        if bf16_params:
            params = jax.tree.map(lambda p: p.astype(jnp.bfloat16)
                                  if p.dtype == jnp.float32 else p, params)
        logits, aux = jax_forward(params, corrupted, jcfg)
        loss, _ = jax_mce(logits, tokens, masked, t)
        return loss + aux, (loss, aux)

    grad_fn = jax.jit(jax.grad(loss_fn, has_aux=True))
    n = tokens.shape[0] // microbatch
    grads, losses, auxes = None, [], []
    for i in range(microbatch):
        sl = slice(i * n, (i + 1) * n)
        g, (loss, aux) = grad_fn(jp, corrupted[sl], tokens[sl], masked[sl],
                                 t[sl])
        grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
        losses.append(float(loss))
        auxes.append(float(aux))
    grads = jax.tree.map(lambda a: a / microbatch, grads)
    new_p, opt = _jax_adamw(tcfg)(grads, jax_adamw_init(jp), jp)
    return (float(np.mean(losses)), float(np.mean(auxes)), grads, new_p,
            opt)


@functools.lru_cache(maxsize=None)
def _jax_adamw(tcfg):
    """The reference's ``adamw_update`` under ``tcfg``, compiled once (op
    by op it compiles every primitive of every leaf shape)."""
    sched = jax_cosine_schedule(tcfg.lr, tcfg.warmup, tcfg.steps)
    return jax.jit(lambda g, state, p: jax_adamw_update(
        g, state, p, sched, weight_decay=tcfg.weight_decay,
        clip_norm=tcfg.clip_norm))


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_train_step_matches_reference(task, case):
    _step_matches_reference(task, case)


def test_hymba_step_through_the_scan_backward_matches_reference(
        task, monkeypatch):
    """Hymba-tiny's step with every layer's scan gradient from
    ``selective_scan_backward`` (through ``SelectiveScan``, the card's
    op, whose forward on the CPU is the plain version), equal to the
    reference's step as the plain autograd step is."""
    from repro_torch.kernels import selective_scan as scan_mod
    from repro_torch.models import ssm
    calls = []
    real = scan_mod.selective_scan_backward

    def backward(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)
    monkeypatch.setattr(scan_mod, "selective_scan_backward", backward)

    def scan(x, d, b, c, a, h0=None, return_state=False):
        assert h0 is None and not return_state      # a stateless forward
        return scan_mod.SelectiveScan.apply(x, d, b, c, a.float())
    monkeypatch.setattr(ssm, "selective_scan", scan)
    _step_matches_reference(task, "hymba-tiny")
    # one backward per layer in each gradient: the helper takes it for
    # the comparison (``grads``) and again in the update (``apply``)
    assert len(calls) == 2 * get_config("hymba-1.5b").reduced().num_layers


def _step_matches_reference(task, case):
    name, over, kw = CASES[case]
    jcfg, cfg = _configs(name, over)
    ds, batch = task
    rows = ROWS.get(case, 32)
    batch = {k: v[:rows] for k, v in batch.items()}
    tcfg = TrainConfig(batch_size=rows, seq_len=ds.seq_len, steps=100)
    jp = _jax_init(jcfg)
    r1, r2 = jax.random.split(jax.random.PRNGKey(1))
    t = jax_sample_mask_ratio(r1, rows)
    corrupted, masked = jax_apply_mask(r2, jnp.asarray(batch["tokens"]), t,
                                       jcfg, jnp.asarray(batch["maskable"]))
    want_loss, want_aux, want_g, want_p, want_opt = _reference_step(
        jcfg, JaxTrainConfig(**vars(tcfg)), jp, batch,
        (corrupted, masked, t), kw.get("bf16_params", False),
        kw.get("microbatch", 1))

    params = masters(from_jax_params(jax.device_get(jp), device="cpu"))
    before = {k: v.copy() for k, v in to_flat(params).items()}
    step = make_train_step(cfg, tcfg, **kw)
    tb = to_device_batch(batch, "cpu")
    corruption = tuple(torch.from_numpy(np.array(a)) for a in
                       (corrupted, masked, t))
    grads, metrics = step.grads(params, tb, corruption)
    assert float(metrics["loss"]) == pytest.approx(want_loss, rel=1e-5)
    # the aux term: 0 without MoE layers, else near its balanced value
    # of router_aux_coef (plus the z-loss) in both packages
    assert float(metrics["aux"]) == pytest.approx(want_aux, rel=1e-6)
    assert (want_aux > 0) == cfg.is_moe
    got_g, ref_g = to_flat(grads), _jflat(want_g)
    assert sorted(got_g) == sorted(ref_g)
    for key, ref in ref_g.items():
        if kw.get("bf16_params"):
            assert _within_bf16_ulp(got_g[key], ref), key
        else:
            assert _rel_err(got_g[key], ref) <= 1e-4, key

    params, opt, _ = step.apply(params, adamw_init(params), tb, corruption)
    assert opt.step == int(want_opt.step) == 1
    got_p, ref_p = to_flat(params), _jflat(want_p)
    for key, ref in ref_p.items():
        g = ref_g[key]
        # an element whose gradient lies within its tolerance of zero
        # (and is not exactly zero) may step either way
        sure = (np.abs(g) > 1e-4 * np.abs(g).max()) | (g == 0)
        assert sure.any(), key
        assert _within_f32_ulps(got_p[key][sure], ref[sure],
                                before[key][sure], 2, 1e-6), key


def test_adamw_three_steps_match_reference():
    """Both optimizers fed the same three gradient trees: equal moments,
    step and parameter deltas (step 1's lr is lr/warmup, so comparing
    the parameters alone would prove little)."""
    jcfg, cfg = _configs("llada-8b", dict(TESTBED, num_layers=2))
    jp = _jax_init(jcfg)
    params = masters(from_jax_params(jax.device_get(jp), device="cpu"))
    start = {k: v.copy() for k, v in to_flat(params).items()}
    tcfg = TrainConfig(steps=10, warmup=2)
    jsched = jax_cosine_schedule(tcfg.lr, tcfg.warmup, tcfg.steps)
    jax_update = _jax_adamw(tcfg)
    sched = cosine_schedule(tcfg.lr, tcfg.warmup, tcfg.steps)
    for s in range(0, 12):
        assert sched(s) == pytest.approx(float(jsched(s)), rel=1e-6,
                                         abs=1e-12)
    rs = np.random.default_rng(0)
    jstate, state = jax_adamw_init(jp), adamw_init(params)
    for i in range(3):
        # the third step's gradients are small enough to leave the clip
        scale = (1.0, 0.5, 1e-4)[i]
        gtree = jax.tree.map(lambda a: (scale * rs.standard_normal(a.shape))
                             .astype(np.float32), jax.device_get(jp))
        grads = from_jax_params(gtree, device="cpu")
        jp, jstate = jax_update(gtree, jstate, jp)
        params, state = adamw_update(grads, state, params, sched,
                                     weight_decay=tcfg.weight_decay,
                                     clip_norm=tcfg.clip_norm)
        assert state.step == int(jstate.step) == i + 1
        for ours, ref in ((to_flat(state.mu), _jflat(jstate.mu)),
                          (to_flat(state.nu), _jflat(jstate.nu))):
            for key in ref:
                assert _rel_err(ours[key], ref[key]) <= 1e-5, key
        got, want = to_flat(params), _jflat(jp)
        for key in want:
            assert _within_f32_ulps(got[key] - start[key],
                                    want[key] - start[key], want[key],
                                    i + 2, 1e-6), key


def test_remat_block_gives_the_same_gradients_and_skips_decodes(
        monkeypatch):
    """``remat="block"`` checkpoints each block when autograd records the
    forward (same gradients as without); without params that require grad
    (a decode) nothing is checkpointed."""
    from repro_torch.models import forward, init_model
    from repro_torch.models import model as model_mod
    cfg = get_config("llada-8b").reduced()
    remat = get_config("llada-8b").reduced(remat="block")
    params = masters(init_model(cfg, device="cpu"))
    tokens = torch.randint(0, cfg.vocab_size, (2, 12),
                           generator=torch.Generator().manual_seed(0))
    grads = [torch.autograd.grad(forward(params, tokens, c).square().mean(),
                                 leaves(params)) for c in (cfg, remat)]
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)
    calls = []
    checkpoint = model_mod.checkpoint
    monkeypatch.setattr(model_mod, "checkpoint", lambda *a, **k: (
        calls.append(1), checkpoint(*a, **k))[1])
    forward(tree_map(lambda p: p.detach(), params), tokens, remat)
    assert not calls
    forward(params, tokens, remat)
    assert len(calls) == remat.num_layers


# --------------------------------------------------------------------------
# checkpoints, the loop, the launcher
# --------------------------------------------------------------------------

def test_checkpoints_load_in_both_packages(tmp_path, task):
    jcfg, cfg = _configs("llada-8b", {})
    ds, batch = task
    tcfg = TrainConfig(batch_size=32, seq_len=ds.seq_len, steps=5)
    params, history = train(cfg, tcfg, ds.batches(32, seed=7), log=None,
                            device="cpu", params=from_jax_params(
                                jax.device_get(_jax_init(jcfg)),
                                device="cpu"))
    # two more steps by hand, for an optimizer state to save
    step = make_train_step(cfg, tcfg)
    params = masters(params)
    state = adamw_init(params)
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        params, state, _ = step(params, state, gen,
                                to_device_batch(batch, "cpu"))
    ours = str(tmp_path / "port.npz")
    save(ours, params, state, step=7)
    template = _jax_init(jcfg, seed=1)
    jparams, jopt, jstep = jax_load(ours, template, jax_adamw_init(template))
    assert jstep == 7 and int(jopt.step) == 2
    for ref_tree, tree in ((jparams, params), (jopt.mu, state.mu),
                           (jopt.nu, state.nu)):
        got = _jflat(ref_tree)
        for key, arr in to_flat(tree).items():
            np.testing.assert_array_equal(got[key], arr)

    theirs = str(tmp_path / "ref.npz")
    jax_save(theirs, jparams, jopt, step=9)
    with np.load(theirs) as a, np.load(ours) as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                   for k in a.files)
    p2, s2, step2 = load(theirs, device="cpu")
    assert step2 == 9 and s2.step == 2
    for tree, ref in ((p2, params), (s2.mu, state.mu), (s2.nu, state.nu)):
        for t1, t2 in zip(leaves(tree), leaves(ref)):
            assert t1.dtype == torch.float32
            assert torch.equal(t1, t2.detach())


def test_port_train_lowers_the_loss(tmp_path):
    """The reference's own check (``tests/test_system.py``): 150 steps of
    batch 32 on ``sum`` bring the loss under 0.7 of its start; ``eval_fn``
    runs every ``eval_every`` steps, and ``ckpt_dir`` holds the result in
    the reference's layout."""
    cfg = get_config("llada-8b").reduced()
    ds = TaskDataset("sum", CharTokenizer(cfg.vocab_size))
    tcfg = TrainConfig(batch_size=32, seq_len=ds.seq_len, steps=150,
                       log_every=1000, eval_every=50,
                       ckpt_dir=str(tmp_path))
    evals = []
    params, history = train(cfg, tcfg, ds.batches(32), log=None,
                            device="cpu", eval_fn=lambda p, step: evals.append(
                                (step, p["embed"]["tok"].requires_grad)))
    assert evals == [(50, True), (100, True), (150, True)]
    assert history["step"] == [1, 150]
    assert history["loss"][-1] < history["loss"][0] * 0.7
    assert not any(t.requires_grad for t in leaves(params))
    jcfg = jax_get_config("llada-8b").reduced()
    template = _jax_init(jcfg)
    jparams, _, step = jax_load(str(tmp_path / "final.npz"), template)
    assert step == 150
    for key, arr in to_flat(params).items():
        np.testing.assert_array_equal(_jflat(jparams)[key], arr)


def test_launch_train_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "llada-8b-tiny", "--steps", "3", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert res.returncode == 0, res.stderr
    assert "final loss" in res.stdout
