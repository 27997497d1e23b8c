"""The port's step functions (``launch/steps.py``: ``make_steps``' train,
prefill and serve) against the reference's, on the CPU, for LLaDA and
every reduced config of ``ASSIGNED_ARCHS``: the VLM with its patch
embeddings and the encoder-decoder with its frame embeddings (the
configs' ``extra_input_names``), the xLSTM with an mLSTM and an sLSTM
layer, the MoE models with their aux loss.

Same weights (the reference's ``init_model``, bridged), same seeded
inputs, f32.  ``train``: the reference's corruption ``(corrupted,
masked, t)`` injected into the port's step (``TrainStep.grads``/
``apply``, as ``test_torch_train.py`` does); loss within rel 1e-5, the
aux loss within rel 1e-6, every gradient leaf within rel 1e-4 of its
largest element.  ``prefill`` and ``serve``: argmaxes exact, max-prob,
margin and Σ p log p within 1e-5 of their scale; serve's state leaf for
leaf within 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_decode_state import _close, _same_state
from torch_threads import one_torch_thread  # noqa: F401

from repro.configs import get_config as jax_get_config
from repro.core.loss import masked_cross_entropy as jax_mce
from repro.core.masking import apply_mask as jax_apply_mask
from repro.core.masking import sample_mask_ratio as jax_sample_mask_ratio
from repro.launch import steps as jsteps
from repro.models import model as jm
from repro_torch.configs import ASSIGNED_ARCHS, TrainConfig, get_config
from repro_torch.convert import from_jax_params, to_flat
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as tm
from repro_torch.training.optimizer import adamw_init
from repro_torch.training.trainer import TrainStep, masters

ARCHS = ["llada-8b"] + list(ASSIGNED_ARCHS)
B, L = 2, 16


_MODELS = {}


def _model(name):
    if name not in _MODELS:
        jcfg = jax_get_config(name).reduced()
        over = {}
        if name == "xlstm-125m":         # an mLSTM and an sLSTM layer
            over = dict(ssm=dataclasses.replace(jcfg.ssm,
                                                xlstm_pattern="ms"))
        jcfg = jax_get_config(name).reduced(**over)
        cfg = get_config(name).reduced(**over)
        jp = jax.device_get(jax.jit(jm.init_model, static_argnums=1)(
            jax.random.PRNGKey(0), jcfg))
        _MODELS[name] = jcfg, cfg, jp, from_jax_params(jp, device="cpu")
    return _MODELS[name]


def _batch(cfg, seed=0):
    """tokens, maskable (the first 4 columns a prompt) and the config's
    extra inputs, numpy."""
    rs = np.random.default_rng(seed)
    batch = {"tokens": rs.integers(0, cfg.vocab_size - 1, (B, L)),
             "maskable": np.ones((B, L), bool)}
    batch["maskable"][:, :4] = False
    for name in tsteps.extra_input_names(cfg):
        rows = 8 if name == "enc_embeds" else cfg.encdec.num_patch_tokens
        batch[name] = rs.standard_normal((B, rows, cfg.d_model)).astype(
            np.float32)
    return batch


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _same_scores(js, ts, what):
    assert np.array_equal(np.asarray(js.argmax), ts.argmax.numpy()), what
    for field in ("max_prob", "margin", "neg_entropy"):
        _close(getattr(ts, field), getattr(js, field), f"{what} {field}")


@pytest.mark.parametrize("arch", ARCHS)
def test_extra_input_names_match_reference(arch):
    assert tsteps.extra_input_names(get_config(arch)) == \
        jsteps.extra_input_names(jax_get_config(arch))


# --------------------------------------------------------------------------
# train
# --------------------------------------------------------------------------

def _reference_grads(jcfg, jp, batch, corruption, extras):
    corrupted, masked, t = corruption

    def loss_fn(params):
        kw = {k: jnp.asarray(batch[k]) for k in extras}
        logits, aux = jm.forward(params, corrupted, jcfg, **kw)
        loss, _ = jax_mce(logits, jnp.asarray(batch["tokens"]), masked, t)
        return loss + aux, (loss, aux)

    return jax.jit(jax.grad(loss_fn, has_aux=True))(jp)


def _jflat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = np.asarray(leaf, np.float32)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """``make_steps(cfg)["train"]`` under the reference's corruption:
    loss, aux and every gradient leaf against ``jax.grad`` of the
    reference's objective (``forward(..., **extras)`` + the masked
    cross-entropy + aux), then one AdamW step that moves the params."""
    jcfg, cfg, jp, tp = _model(arch)
    batch = _batch(cfg)
    r1, r2 = jax.random.split(jax.random.PRNGKey(1))
    t = jax_sample_mask_ratio(r1, B)
    corrupted, masked = jax_apply_mask(r2, jnp.asarray(batch["tokens"]), t,
                                       jcfg, jnp.asarray(batch["maskable"]))
    extras = jsteps.extra_input_names(jcfg)
    want_g, (want_loss, want_aux) = _reference_grads(
        jcfg, jp, batch, (corrupted, masked, t), extras)

    step = tsteps.make_steps(cfg, TrainConfig(steps=10))["train"]
    assert isinstance(step, TrainStep) and step.extra_inputs == extras
    params = masters(tp)
    corruption = tuple(torch.from_numpy(np.array(a)) for a in
                       (corrupted, masked, t))
    grads, metrics = step.grads(params, _tbatch(batch), corruption)
    assert float(metrics["loss"]) == pytest.approx(float(want_loss),
                                                   rel=1e-5)
    assert float(metrics["aux"]) == pytest.approx(float(want_aux), rel=1e-6)
    got_g, ref_g = to_flat(grads), _jflat(want_g)
    assert sorted(got_g) == sorted(ref_g)
    for key, ref in ref_g.items():
        err = np.abs(got_g[key] - ref).max()
        assert err <= 1e-4 * max(np.abs(ref).max(), 1e-30), key
    before = {k: v.copy() for k, v in to_flat(params).items()}
    params, opt, met = step.apply(params, adamw_init(params), _tbatch(batch),
                                  corruption)
    assert opt.step == 1 and np.isfinite(float(met["loss"]))
    assert any(not np.array_equal(before[k], v)
               for k, v in to_flat(params).items())


def test_train_options_reach_the_step():
    """``microbatch<n>`` and ``bf16_gather`` as the reference reads them;
    the step draws its own corruption from a generator and stays
    finite."""
    jcfg, cfg, jp, tp = _model("llada-8b")
    steps = tsteps.make_steps(cfg, TrainConfig(steps=10),
                              frozenset({"microbatch2", "bf16_gather"}))
    step = steps["train"]
    assert step.microbatch == 2 and step.bf16_params
    assert tsteps.make_steps(cfg)["train"].microbatch == 1
    params = masters(tp)
    batch = _tbatch(_batch(cfg))
    params, _, met = step(params, adamw_init(params),
                          torch.Generator().manual_seed(0), batch)
    assert np.isfinite(float(met["loss"])) and float(met["loss"]) > 0


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "xlstm-125m"])
def test_train_steps_follow_reference(arch):
    """Four steps of the reference's jitted ``make_steps(cfg)["train"]``
    (its corruption drawn from its key) and of the port's under each
    step's same corruption, from the same weights over one fixed batch
    (the VLM's patches included): each step's loss within rel 1e-4 (f32
    differences carried through three AdamW updates), then every master
    within 1e-4 of its leaf's scale (max |value|, at least 1)."""
    from repro.configs import TrainConfig as JaxTrainConfig
    from repro.training.optimizer import adamw_init as jax_adamw_init
    jcfg, cfg, jp, tp = _model(arch)
    batch = _batch(cfg, seed=2)
    jb = _jbatch(batch)
    jstep = jax.jit(jsteps.make_steps(jcfg, JaxTrainConfig(
        batch_size=B, seq_len=L, steps=4))["train"])
    step = tsteps.make_steps(cfg, TrainConfig(batch_size=B, seq_len=L,
                                              steps=4))["train"]
    params, opt = masters(tp), adamw_init(masters(tp))
    jparams, jopt = jp, jax_adamw_init(jp)
    key = jax.random.PRNGKey(7)
    for i in range(4):
        key, k = jax.random.split(key)
        r1, r2 = jax.random.split(k)            # as the reference's step
        t = jax_sample_mask_ratio(r1, B)
        corrupted, masked = jax_apply_mask(r2, jb["tokens"], t, jcfg,
                                           jb["maskable"])
        jparams, jopt, jmet = jstep(jparams, jopt, k, jb)
        params, opt, met = step.apply(
            params, opt, _tbatch(batch), tuple(
                torch.from_numpy(np.array(a)) for a in (corrupted, masked,
                                                        t)))
        assert float(met["loss"]) == pytest.approx(float(jmet["loss"]),
                                                   rel=1e-4), f"step {i}"
    got, want = to_flat(params), _jflat(jparams)
    for key, ref in want.items():
        err = np.abs(got[key] - ref).max()
        assert err <= 1e-4 * max(np.abs(ref).max(), 1.0), key


# --------------------------------------------------------------------------
# prefill, serve
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch):
    """One full forward scored (the reference scores its vocab-sharded
    logits by reductions alone, the port in one pass: the same four
    scores)."""
    jcfg, cfg, jp, tp = _model(arch)
    batch = _batch(cfg, seed=1)
    want = jax.jit(jsteps.make_steps(jcfg)["prefill"])(jp, _jbatch(batch))
    got = tsteps.make_steps(cfg)["prefill"](tp, _tbatch(batch))
    assert got.argmax.shape == (B, L)
    _same_scores(want, got, "prefill")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_reference(arch):
    """Four serve steps against a warm 16-position state (the serving
    contract: ``init_decode_state`` with the default valid length),
    positions 12..15: scores each step, the state at the end."""
    jcfg, cfg, jp, tp = _model(arch)
    enc = None
    if cfg.is_encdec:
        enc = np.random.default_rng(4).standard_normal(
            (B, 8, cfg.d_model)).astype(np.float32)
    js = jm.init_decode_state(jcfg, B, L, jnp.float32,
                              enc_out=None if enc is None else
                              jnp.asarray(enc))
    ts = tm.init_decode_state(cfg, B, L, torch.float32,
                              enc_out=None if enc is None else
                              torch.from_numpy(enc), device="cpu")
    jserve = jax.jit(jsteps.make_steps(jcfg)["serve"])
    tserve = tsteps.make_steps(cfg)["serve"]
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size - 1,
                                             (4, B, 1))
    for i, tok in enumerate(toks):
        pos = np.full((B, 1), 12 + i, np.int32)
        jsc, js = jserve(jp, jnp.asarray(tok), jnp.asarray(pos), js)
        tsc, ts = tserve(tp, torch.from_numpy(tok), torch.from_numpy(pos),
                         ts)
        assert tsc.argmax.shape == (B, 1)
        _same_scores(jsc, tsc, f"serve step {i}")
    _same_state(jcfg, js, ts)
