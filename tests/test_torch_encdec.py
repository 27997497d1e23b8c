"""The encoder-decoder family of the port (whisper-medium) against the
reference's, on the CPU: the config, LayerNorm, the GELU MLP, the
sinusoidal table and the tied head, the weights bridge with the
``encoder`` group, ``encode`` and the forward with and without
``enc_embeds``, the unconditioned block cache, conditioned decodes on
every driver and unconditioned ones under ``prefix``/``dual``, the
refusals of extras, ``make_model_fn``, and a train step with
``extra_inputs=("enc_embeds",)``.

Same weights (the reference's ``init_model``, bridged), same inputs
(numpy).  whisper-medium-tiny: 2 decoder and 2 encoder layers, d=256, 4
MHA heads of 64, V=512, 32 encoder frames, positions up to 128; its
``tie_embeddings=True`` variant has no head matrix.  Tolerances: layers
atol = rtol = 1e-5 (f32), the sinusoidal table exact; logits and
``encode`` atol = rtol = 1e-4, as ``test_torch_archs.py``; tokens,
steps, forward-equivalents and FDM-A phase counts exact against the
reference's host driver; the train step as ``test_torch_train.py``'s.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro.configs import DecodeConfig as JaxDecodeConfig
from repro.configs import TrainConfig as JaxTrainConfig
from repro.configs import get_config as jax_get_config
from repro.core import Decoder as JaxDecoder
from repro.core.loss import masked_cross_entropy as jax_mce
from repro.core.masking import apply_mask as jax_apply_mask
from repro.core.masking import sample_mask_ratio as jax_sample_mask_ratio
from repro.core.sampler import make_model_fn as jax_make_model_fn
from repro.models import layers as jax_layers
from repro.models.model import capture_cache as jax_capture_cache
from repro.models.model import encode as jax_encode
from repro.models.model import forward as jax_forward
from repro.models.model import forward_cached as jax_forward_cached
from repro.models.model import init_model as jax_init_model
from repro.training import adamw_init as jax_adamw_init
from repro.training.checkpoint import _flatten, save
from repro.training.trainer import make_train_step as jax_make_train_step
from repro_torch.configs import (DecodeConfig, TrainConfig, get_config,
                                 list_configs)
from repro_torch.convert import from_jax_params, from_npz, to_flat
from repro_torch.core import Decoder, make_model_fn
from repro_torch.models import (capture_cache, encode, forward,
                                forward_cached, init_model)
from repro_torch.models import layers
from repro_torch.training import adamw_init, make_train_step
from repro_torch.training.trainer import masters

NAME = "whisper-medium"
VARIANTS = {"reduced": {}, "tied": dict(tie_embeddings=True)}
PROMPT, GEN, BLOCK = 16, 24, 8
DECODE = dict(gen_length=GEN, block_size=BLOCK, steps=12)
# untrained weights keep max-probs near 1/V (whisper-tiny's conditioned
# masked rows: 0.018-0.029): the knobs make FDM's search and every phase
# of FDM-A really run
STRATEGIES = {"fdm": dict(strategy="fdm", gamma=0.0),
              "fdm_a": dict(strategy="fdm_a", eta1=0.0235, eta2=0.0231,
                            gamma1=0.0, n_max=3),
              "probability": dict(strategy="probability")}
DRIVERS = {"eager": dict(fused_loop=False), "block": dict(fused_blocks=False),
           "request": {}}


_CACHE = {}


def _model(variant="reduced"):
    """Both reduced configs, the reference's weights (LayerNorm scales
    and biases drawn away from 1 and 0, so a dropped one shows) and the
    port's copy."""
    if variant not in _CACHE:
        over = VARIANTS[variant]
        jcfg = jax_get_config(NAME).reduced(**over)
        cfg = get_config(NAME).reduced(**over)
        jp = jax.device_get(jax_init_model(jax.random.PRNGKey(0), jcfg))
        rs = np.random.default_rng(5)

        def jitter(tree):
            for k, v in (tree.items() if isinstance(tree, dict)
                         else enumerate(tree)):
                if isinstance(v, (dict, list)):
                    jitter(v)
                elif k in ("scale", "bias"):
                    tree[k] = (v + 0.3 * rs.standard_normal(v.shape)
                               ).astype(np.float32)
        jitter(jp)
        _CACHE[variant] = jcfg, cfg, jp, from_jax_params(jp, device="cpu")
    return _CACHE[variant]


def _enc(cfg, batch=2, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.encdec.encoder_seq, cfg.d_model)).astype(np.float32)


def _prompt(cfg, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size - 1, (2, PROMPT)).astype(np.int32)


# --------------------------------------------------------------------------
# config and layers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_field_for_field(reduced):
    jc, tc = jax_get_config(NAME), get_config(NAME)
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
        assert tc == get_config(f"{NAME}-tiny")
        assert (tc.num_layers, tc.encdec.encoder_layers,
                tc.encdec.encoder_seq, tc.d_model, tc.head_dim,
                tc.max_seq_len) == (2, 2, 32, 256, 64, 128)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert tc.is_encdec and NAME in list_configs()
    assert tc.param_count() == jc.param_count()
    if not reduced:
        assert tc.param_count() == 810_960_896


def test_layers_match_reference():
    """LayerNorm (population variance, eps 1e-6), the tanh GELU MLP, the
    sinusoidal table and the tied head against the reference's functions."""
    jcfg, cfg, _, _ = _model()
    rs = np.random.default_rng(1)
    x = (3 * rs.standard_normal((2, 7, cfg.d_model)) + 1).astype(np.float32)
    norm = {"scale": rs.standard_normal(cfg.d_model).astype(np.float32),
            "bias": rs.standard_normal(cfg.d_model).astype(np.float32)}
    # the reference's functions compiled whole (op by op each primitive
    # compiles on its own)
    want = jax.jit(jax_layers.apply_norm, static_argnums=2)(
        norm, jnp.asarray(x), jcfg)
    got = layers.apply_norm({k: torch.from_numpy(v) for k, v in
                             norm.items()}, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert set(layers.init_norm(cfg, "cpu")) == {"scale", "bias"}

    mlp = {"fc1": (rs.standard_normal((cfg.d_model, cfg.d_ff)) / 16
                   ).astype(np.float32),
           "fc2": (rs.standard_normal((cfg.d_ff, cfg.d_model)) / 22
                   ).astype(np.float32)}
    want = jax.jit(jax_layers.apply_mlp, static_argnums=2)(
        mlp, jnp.asarray(x), jcfg)
    got = layers.apply_mlp({k: torch.from_numpy(v) for k, v in mlp.items()},
                           torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # the tanh approximation, not the erf GELU
    h = torch.from_numpy(x) @ torch.from_numpy(mlp["fc1"])
    erf = torch.nn.functional.gelu(h) @ torch.from_numpy(mlp["fc2"])
    assert (erf - got).abs().max() > 1e-5

    for length, dim in ((128, 256), (4096, 1024), (5, 6)):
        np.testing.assert_array_equal(
            layers.sinusoidal_embedding(length, dim).numpy(),
            np.asarray(jax_layers.sinusoidal_embedding(length, dim)))

    tied = dataclasses.replace(cfg, tie_embeddings=True)
    jtied = dataclasses.replace(jcfg, tie_embeddings=True)
    tok = (0.02 * rs.standard_normal((cfg.vocab_size, cfg.d_model))
           ).astype(np.float32)
    want = jax.jit(jax_layers.lm_head, static_argnums=2)(
        {"tok": jnp.asarray(tok)}, jnp.asarray(x), jtied)
    got = layers.lm_head({"tok": torch.from_numpy(tok)},
                         torch.from_numpy(x), tied)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# --------------------------------------------------------------------------
# the tree and the bridge
# --------------------------------------------------------------------------

@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_init_model_has_the_reference_tree(variant):
    jcfg, cfg, jp, _ = _model(variant)
    want = _flatten(jp)
    got = to_flat(init_model(cfg, device="cpu"))
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    assert "encoder/blocks/0/attn/wq" in got
    assert "blocks/0/xattn/wk" in got and "blocks/0/norm_x/bias" in got
    assert ("embed/head" in got) == (variant != "tied")
    np.testing.assert_array_equal(got["embed/pos"], want["embed/pos"])


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_bridge_round_trips_through_a_reference_checkpoint(variant,
                                                           tmp_path):
    """The ``encoder`` group, ``norm_x``/``xattn``, LayerNorm biases,
    ``fc1``/``fc2`` and ``embed/pos`` go through ``from_jax_params``,
    ``to_flat`` and a reference-written checkpoint leaf for leaf; under a
    bf16 cast the vectors the reference keeps f32 stay f32."""
    _, _, jp, tp = _model(variant)
    want = _flatten(jp)
    got = to_flat(tp)
    assert sorted(got) == sorted(want)
    for key, arr in want.items():
        np.testing.assert_array_equal(got[key], arr, err_msg=key)
    path = str(tmp_path / "ckpt.npz")
    save(path, jp, step=1)
    back = to_flat(from_npz(path, device="cpu"))
    for key, arr in want.items():
        np.testing.assert_array_equal(back[key], arr, err_msg=key)
    bf = from_jax_params(jp, device="cpu", dtype=torch.bfloat16)
    enc = bf["encoder"]["blocks"][0]
    assert enc["mlp"]["fc1"].dtype == bf["blocks"][1]["xattn"]["wq"].dtype \
        == torch.bfloat16
    assert enc["norm1"]["bias"].dtype == torch.float32
    assert bf["encoder"]["norm_f"]["bias"].dtype == torch.float32
    assert bf["embed"]["pos"].dtype == torch.float32


# --------------------------------------------------------------------------
# forwards
# --------------------------------------------------------------------------

@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_encode_and_forward_match_reference(variant):
    """``encode``, and the logits with ``enc_embeds`` (every decoder
    layer's cross path) and without (the cross path skipped)."""
    jcfg, cfg, jp, tp = _model(variant)
    enc = _enc(cfg)
    want = jax_encode(jp, jnp.asarray(enc), jcfg)
    got = encode(tp, torch.from_numpy(enc), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)
    logits = {}
    for cond in (False, True):
        kw = dict(enc_embeds=enc) if cond else {}
        want = jax_forward(jp, jnp.asarray(tokens), jcfg,
                           **{k: jnp.asarray(v) for k, v in kw.items()})[0]
        got = forward(tp, torch.from_numpy(tokens).long(), cfg,
                      **{k: torch.from_numpy(v) for k, v in kw.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
        logits[cond] = got
    assert (logits[True] - logits[False]).abs().max() > 1e-2


def test_cache_paths_match_reference():
    """The unconditioned block cache: ``capture_cache`` and
    ``forward_cached`` at the ``prefix`` and a ``dual`` window, whose
    tokens take the sinusoidal rows of their offsets."""
    jcfg, cfg, jp, tp = _model()
    rs = np.random.default_rng(3)
    canvas = rs.integers(0, cfg.vocab_size - 1,
                         (2, PROMPT + GEN)).astype(np.int32)
    canvas[:, PROMPT + 5:] = cfg.mask_token_id
    jstate = jax.jit(jax_capture_cache, static_argnums=2)(
        jp, jnp.asarray(canvas), jcfg)
    tstate = capture_cache(tp, torch.from_numpy(canvas).long(), cfg)
    (stacked,) = jstate.layer_states
    for i, kv in enumerate(tstate):
        np.testing.assert_allclose(kv.k.numpy(), np.asarray(stacked.k[i]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(kv.v.numpy(), np.asarray(stacked.v[i]),
                                   rtol=1e-5, atol=1e-5)
    for win_start, width in ((PROMPT, GEN), (PROMPT + BLOCK, BLOCK)):
        window = canvas[:, win_start:win_start + width]
        want = jax.jit(jax_forward_cached, static_argnums=4)(
            jp, jnp.asarray(window), jnp.int32(win_start), jstate, jcfg)
        got = forward_cached(tp, torch.from_numpy(window).long(), win_start,
                             tstate, cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="sinusoidal table"):
        forward_cached(tp, torch.zeros(2, 8, dtype=torch.long),
                       cfg.max_seq_len - 4, tstate, cfg)


# --------------------------------------------------------------------------
# decodes
# --------------------------------------------------------------------------

def _assert_same(got, st, want, wstats, label):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                  err_msg=label)
    assert st.steps == wstats.steps, label
    assert st.forward_equivalents == wstats.forward_equivalents, label
    assert st.phase_counts == wstats.phase_counts, label
    assert st.tokens_generated == wstats.tokens_generated, label


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_conditioned_decodes_match_reference_on_every_driver(strategy):
    """``generate(..., enc_embeds=...)`` under ``none``: the port's three
    drivers against the reference's host driver (FDM's K·B fold tiles the
    frames candidate-major)."""
    jcfg, cfg, jp, tp = _model()
    prompt, enc = _prompt(cfg), _enc(cfg)
    kw = {**DECODE, **STRATEGIES[strategy]}
    want, wstats = JaxDecoder(jp, jcfg, JaxDecodeConfig(
        **kw, fused_loop=False)).generate(jax.random.PRNGKey(0),
                                          jnp.asarray(prompt),
                                          enc_embeds=jnp.asarray(enc))
    if strategy == "fdm_a":
        assert all(wstats.phase_counts.values()), wstats.phase_counts
    for driver, over in DRIVERS.items():
        got, st = Decoder(tp, cfg, DecodeConfig(**kw, **over),
                          device="cpu").generate(
            None, prompt, enc_embeds=torch.from_numpy(enc))
        _assert_same(got, st, want, wstats, driver)
    if strategy != "probability":
        return
    # generate_blocks takes them too; other frames decode otherwise
    blocks = Decoder(tp, cfg, DecodeConfig(**kw), device="cpu") \
        .generate_blocks(None, prompt, enc_embeds=enc)
    while True:
        try:
            next(blocks)
        except StopIteration as fin:
            got, _ = fin.value
            break
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    other, _ = Decoder(tp, cfg, DecodeConfig(**kw), device="cpu").generate(
        None, prompt, enc_embeds=_enc(cfg, seed=9))
    assert not torch.equal(other, got)


@pytest.mark.parametrize("policy", ["prefix", "dual"])
@pytest.mark.parametrize("strategy", ["fdm_a", "probability"])
def test_unconditioned_cached_decodes_match_reference(strategy, policy):
    """An unconditioned decode under the cache policies (the window's
    tokens take the sinusoidal rows of their offsets); FDM-A's
    exploration runs FDM's K-candidate search over the tiled cache."""
    jcfg, cfg, jp, tp = _model()
    prompt = _prompt(cfg, seed=1)
    kw = {**DECODE, **STRATEGIES[strategy], "cache_policy": policy}
    want, wstats = JaxDecoder(jp, jcfg, JaxDecodeConfig(
        **kw, fused_loop=False)).generate(jax.random.PRNGKey(0),
                                          jnp.asarray(prompt))
    for driver, over in DRIVERS.items():
        got, st = Decoder(tp, cfg, DecodeConfig(**kw, **over),
                          device="cpu").generate(None, prompt)
        _assert_same(got, st, want, wstats, driver)


def test_extras_are_refused_as_the_reference_refuses_them():
    """Extras under a cache policy, an unknown key and extras with a bare
    model_fn raise the reference's error types, with its messages."""
    jcfg, cfg, jp, tp = _model()
    prompt, enc = _prompt(cfg), _enc(cfg)
    cached = dict(DECODE, cache_policy="prefix")
    cases = [
        (lambda: JaxDecoder(jp, jcfg, JaxDecodeConfig(**cached)).generate(
            jax.random.PRNGKey(0), jnp.asarray(prompt),
            enc_embeds=jnp.asarray(enc)),
         lambda: Decoder(tp, cfg, DecodeConfig(**cached),
                         device="cpu").generate(None, prompt,
                                                enc_embeds=enc),
         ValueError, "not supported with cache_policy"),
        (lambda: JaxDecoder(jp, jcfg, JaxDecodeConfig(**DECODE)).generate(
            jax.random.PRNGKey(0), jnp.asarray(prompt),
            audio=jnp.asarray(enc)),
         lambda: Decoder(tp, cfg, DecodeConfig(**DECODE),
                         device="cpu").generate(None, prompt, audio=enc),
         TypeError, "conditioning extras must be one of"),
        (lambda: JaxDecoder(lambda t: jax_forward(jp, t, jcfg)[0], jcfg,
                            JaxDecodeConfig(**DECODE)).generate(
            jax.random.PRNGKey(0), jnp.asarray(prompt),
            enc_embeds=jnp.asarray(enc)),
         lambda: Decoder(lambda t: forward(tp, t, cfg), cfg,
                         DecodeConfig(**DECODE), device="cpu").generate(
            None, prompt, enc_embeds=enc),
         ValueError, "extras require a params-mode Decoder")]
    for ref, ours, err, match in cases:
        with pytest.raises(err, match=match):
            ref()
        with pytest.raises(err, match=match):
            ours()
    for drv in DRIVERS.values():          # every driver refuses up front
        with pytest.raises(ValueError, match="params-mode"):
            Decoder(lambda t: forward(tp, t, cfg), cfg,
                    DecodeConfig(**DECODE, **drv),
                    device="cpu").generate_blocks(None, prompt,
                                                  enc_embeds=enc)


def test_make_model_fn_matches_reference():
    """The conditioned forward from params at a K·B fold (K=2, B=2: the
    frames tiled candidate-major, so row b + j·B sees frames b)."""
    jcfg, cfg, jp, tp = _model()
    enc = _enc(cfg)
    jfn = jax_make_model_fn(jp, jcfg, enc_embeds=jnp.asarray(enc))
    fn = make_model_fn(tp, cfg, enc_embeds=enc)
    tokens = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (4, 20)).astype(np.int32)
    got = fn(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jfn(jnp.asarray(tokens))),
                               rtol=1e-4, atol=1e-4)
    single = fn(torch.from_numpy(tokens[:2]).long())
    torch.testing.assert_close(single, got[:2], rtol=1e-5, atol=1e-5)
    folded = torch.from_numpy(np.tile(tokens[:2], (2, 1))).long()
    out = fn(folded)
    torch.testing.assert_close(out[:2], out[2:], rtol=0, atol=0)


# --------------------------------------------------------------------------
# training with the conditioning
# --------------------------------------------------------------------------

def test_train_step_with_enc_embeds_matches_reference():
    """``make_train_step(cfg, tcfg, extra_inputs=("enc_embeds",))``: the
    reference's step on its own corruption, and the port's given the same
    corruption: loss, aux (0) and accuracy, every gradient leaf within
    1e-4 of its max |g| (encoder included), the AdamW-updated params
    within two f32 spacings where the gradient is sure of its sign (as
    ``test_torch_train.py``)."""
    jcfg, cfg, jp, tp = _model()
    rs = np.random.default_rng(6)
    rows, length = 4, 24
    tokens = rs.integers(0, cfg.vocab_size - 1, (rows, length)) \
        .astype(np.int32)
    maskable = np.zeros((rows, length), bool)
    maskable[:, 8:] = True
    enc = _enc(cfg, rows, seed=7)
    tcfg = TrainConfig(batch_size=rows, seq_len=length, steps=10)
    jtcfg = JaxTrainConfig(**vars(tcfg))
    rng = jax.random.PRNGKey(1)
    jbatch = {"tokens": jnp.asarray(tokens),
              "maskable": jnp.asarray(maskable),
              "enc_embeds": jnp.asarray(enc)}
    want_p, _, want_m = jax.jit(jax_make_train_step(
        jcfg, jtcfg, extra_inputs=("enc_embeds",)))(
        jp, jax_adamw_init(jp), rng, jbatch)
    # the step's corruption, drawn as its loss_fn draws it
    r1, r2 = jax.random.split(rng)
    t = jax_sample_mask_ratio(r1, rows)
    corrupted, masked = jax_apply_mask(r2, jbatch["tokens"], t, jcfg,
                                       jbatch["maskable"])

    def loss_fn(params):
        logits, aux = jax_forward(params, corrupted, jcfg,
                                  enc_embeds=jbatch["enc_embeds"])
        return jax_mce(logits, jbatch["tokens"], masked, t)[0] + aux
    want_g = _flatten(jax.device_get(jax.jit(jax.grad(loss_fn))(jp)))

    params = masters(tp)
    before = {k: v.copy() for k, v in to_flat(params).items()}
    step = make_train_step(cfg, tcfg, extra_inputs=("enc_embeds",))
    batch = {"tokens": torch.from_numpy(tokens).long(),
             "maskable": torch.from_numpy(maskable),
             "enc_embeds": torch.from_numpy(enc)}
    corruption = tuple(torch.from_numpy(np.array(a))
                       for a in (corrupted, masked, t))
    grads, met = step.grads(params, batch, corruption)
    assert float(met["loss"]) == pytest.approx(float(want_m["loss"]),
                                               rel=1e-5)
    assert float(met["aux"]) == float(want_m["aux"]) == 0.0
    assert float(met["acc"]) == pytest.approx(float(want_m["acc"]),
                                              abs=1e-6)
    got_g = to_flat(grads)
    assert sorted(got_g) == sorted(want_g)
    assert np.abs(got_g["encoder/blocks/0/attn/wq"]).max() > 0
    for key, ref in want_g.items():
        scale = max(np.abs(ref).max(), 1e-30)
        assert np.abs(got_g[key] - ref).max() <= 1e-4 * scale, key
    params, opt, _ = step.apply(params, adamw_init(params), batch,
                                corruption)
    got_p, ref_p = to_flat(params), _flatten(jax.device_get(want_p))
    for key, ref in ref_p.items():
        g = want_g[key]
        sure = (np.abs(g) > 1e-4 * np.abs(g).max()) | (g == 0)
        tol = 2 * np.spacing(np.abs(before[key][sure])) + \
            1e-6 * np.abs(ref[sure]).max()
        assert np.all(np.abs(got_p[key][sure] - ref[sure]) <= tol), key
