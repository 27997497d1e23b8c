"""The xLSTM family of the port (xlstm-125m: mLSTM and sLSTM blocks, no
attention) against the reference's, on the CPU: the config, the tree and
the bridge (the sLSTM's gate weights and bias and the mLSTM's gate
biases kept f32 under a bf16 cast), ``mlstm_forward`` on a padded, a
whole and a two-chunk canvas, ``slstm_forward``, the logits in f32 and
bf16, decodes on every driver, and the cache policies' refusal.

Same weights (the reference's ``init_model``, bridged), same inputs
(numpy).  xlstm-125m-tiny: 2 layers, d=256, 2 heads, inner width 512,
V=512; its pattern ``mmmmmms`` puts both layers on the mLSTM, so the
``ms`` variant (layer 1 an sLSTM) holds the sLSTM.  Tolerances: mixers
and f32 logits atol = rtol = 1e-4; bf16 logits within 2e-2 of their
scale; tokens, steps, forward-equivalents and FDM-A phase counts exact
against the reference's host driver.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro.configs import DecodeConfig as JaxDecodeConfig
from repro.configs import get_config as jax_get_config
from repro.core import Decoder as JaxDecoder
from repro.models import ssm as jax_ssm
from repro.models.model import forward as jax_forward
from repro.models.model import init_model as jax_init_model
from repro.training.checkpoint import _flatten, save
from repro_torch.configs import DecodeConfig, get_config, list_configs
from repro_torch.convert import from_jax_params, from_npz, to_flat
from repro_torch.core import Decoder
from repro_torch.models import forward, init_model, ssm

NAME = "xlstm-125m"
F32_KEYS = ("w_gates", "r_gates", "b_gates", "b_i", "b_f")
PROMPT, GEN, BLOCK = 16, 24, 8
DECODE = dict(gen_length=GEN, block_size=BLOCK, steps=12)
STRATEGIES = {"fdm": dict(strategy="fdm", gamma=0.0),
              "fdm_a": dict(strategy="fdm_a", eta1=0.0, eta2=0.0,
                            gamma1=0.0, n_max=3),
              "probability": dict(strategy="probability")}
DRIVERS = {"eager": dict(fused_loop=False), "block": dict(fused_blocks=False),
           "request": {}}


def _configs(variant):
    """(reference config, port config): reduced, or reduced with the
    pattern ``ms`` (layer 0 an mLSTM, layer 1 an sLSTM)."""
    jcfg, cfg = jax_get_config(NAME).reduced(), get_config(NAME).reduced()
    if variant == "ms":
        jcfg = jcfg.reduced(ssm=dataclasses.replace(jcfg.ssm,
                                                    xlstm_pattern="ms"))
        cfg = cfg.reduced(ssm=dataclasses.replace(cfg.ssm,
                                                  xlstm_pattern="ms"))
    return jcfg, cfg


VARIANTS = ("reduced", "ms")


_CACHE = {}


def _model(variant="ms"):
    """The reference's weights (the gate biases and skip scales drawn
    away from their constants, so a dropped one shows) and the port's
    copy."""
    if variant not in _CACHE:
        jcfg, cfg = _configs(variant)
        jp = jax.device_get(jax_init_model(jax.random.PRNGKey(0), jcfg))
        rs = np.random.default_rng(7)
        for group in jp["blocks"]:
            for key in ("b_i", "b_f", "b_gates", "skip_scale"):
                if key in group["mixer"]:
                    v = group["mixer"][key]
                    group["mixer"][key] = (
                        v + 0.5 * rs.standard_normal(v.shape)
                    ).astype(np.float32)
        _CACHE[variant] = jcfg, cfg, jp, from_jax_params(jp, device="cpu")
    return _CACHE[variant]


def _layer(jp, idx):
    """Layer ``idx``'s mixer from the reference's stacked groups (every
    group here holds one layer)."""
    return jax.tree.map(lambda a: a[0], jp["blocks"][idx]["mixer"])


def _x(cfg, length, seed=0, batch=2):
    return np.random.default_rng(seed).standard_normal(
        (batch, length, cfg.d_model)).astype(np.float32)


# --------------------------------------------------------------------------
# config, tree, bridge
# --------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_field_for_field(reduced):
    jc, tc = jax_get_config(NAME), get_config(NAME)
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
        assert tc == get_config(f"{NAME}-tiny")
        assert (tc.num_layers, tc.d_model, tc.ssm.num_ssm_heads,
                tc.ssm.xlstm_pattern) == (2, 256, 2, "mmmmmms")
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert NAME in list_configs() and tc.arch_type == "ssm" and not tc.d_ff
    assert tc.param_count() == jc.param_count()
    if not reduced:
        assert tc.param_count() == 119_771_136
        assert [ssm.xlstm_kind(tc, i) for i in range(12)] == \
            list("mmmmmmsmmmmm")


@pytest.mark.parametrize("variant", VARIANTS)
def test_init_model_has_the_reference_tree(variant):
    """The reference's leaves and shapes; under bf16 the five gate keys
    stay f32, the matrices are bf16."""
    jcfg, cfg, jp, _ = _model(variant)
    want = {k: v.shape for k, v in _flatten(jp).items()}
    got = to_flat(init_model(cfg, device="cpu"))
    assert {k: v.shape for k, v in got.items()} == want
    bf = init_model(cfg, device="cpu", dtype=torch.bfloat16)
    kinds = [ssm.xlstm_kind(cfg, i) for i in range(cfg.num_layers)]
    assert kinds == (["m", "s"] if variant == "ms" else ["m", "m"])
    for kind, layer in zip(kinds, bf["blocks"]):
        assert set(layer) == {"norm1", "mixer"}
        mixer = layer["mixer"]
        assert mixer["w_up"].dtype == mixer["w_down"].dtype == torch.bfloat16
        for key in F32_KEYS:
            if key in mixer:
                assert mixer[key].dtype == torch.float32, key
        assert ("w_gates" in mixer) == (kind == "s")


@pytest.mark.parametrize("variant", VARIANTS)
def test_bridge_round_trips_and_keeps_the_gates_f32(variant, tmp_path):
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
    seen = set()
    for layer in bf["blocks"]:
        for key, leaf in layer["mixer"].items():
            want_dt = torch.float32 if key in F32_KEYS else torch.bfloat16
            assert leaf.dtype == want_dt, key
            seen.add(key)
    assert seen >= ({"b_i", "b_f"} | ({"w_gates", "r_gates", "b_gates"}
                                      if variant == "ms" else set()))


# --------------------------------------------------------------------------
# the mixers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("length", [105, 128, 200])
def test_mlstm_forward_matches_reference(length):
    """A canvas off the chunk (padded with identity steps), one whole
    chunk, and two chunks (the carried state)."""
    jcfg, cfg, jp, tp = _model()
    x = _x(cfg, length, seed=length)
    want = jax.jit(jax_ssm.mlstm_forward, static_argnums=2)(
        _layer(jp, 0), jnp.asarray(x), jcfg)
    got = ssm.mlstm_forward(tp["blocks"][0]["mixer"], torch.from_numpy(x),
                            cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_mlstm_pads_with_identity_steps():
    """The rows of a padded canvas equal those of the same canvas run
    longer: the padding neither feeds nor drains the state (zeros in
    place of the identity gates would)."""
    _, cfg, _, tp = _model()
    x = torch.from_numpy(_x(cfg, 140, seed=3))
    p = tp["blocks"][0]["mixer"]
    short = ssm.mlstm_forward(p, x[:, :100], cfg)
    torch.testing.assert_close(short, ssm.mlstm_forward(p, x, cfg)[:, :100],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("length", [37, 128])
def test_slstm_forward_matches_reference(length):
    jcfg, cfg, jp, tp = _model()
    x = _x(cfg, length, seed=length + 1)
    want = jax.jit(jax_ssm.slstm_forward, static_argnums=2)(
        _layer(jp, 1), jnp.asarray(x), jcfg)
    got = ssm.slstm_forward(tp["blocks"][1]["mixer"], torch.from_numpy(x),
                            cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


# --------------------------------------------------------------------------
# forwards
# --------------------------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
def test_forward_matches_reference(variant):
    jcfg, cfg, jp, tp = _model(variant)
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)
    want = jax_forward(jp, jnp.asarray(tokens), jcfg)[0]
    got = forward(tp, torch.from_numpy(tokens).long(), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_bf16_forward_matches_reference():
    """bf16 compute over the bridged f32 masters (the reference casts at
    use, the port holds bf16 matrices and the five f32 gate keys): within
    2e-2 of the logits' scale, and the f32 gates matter (rounded to bf16,
    the sLSTM's logits move further)."""
    jcfg, cfg, jp, _ = _model()
    jb, tb = (dataclasses.replace(c, dtype="bfloat16") for c in (jcfg, cfg))
    tp = from_jax_params(jp, device="cpu", dtype=torch.bfloat16)
    tokens = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)
    want = np.asarray(jax_forward(jp, jnp.asarray(tokens), jb)[0])
    got = forward(tp, torch.from_numpy(tokens).long(), tb).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 2e-2 * scale
    rounded = dict(tp, blocks=[dict(layer, mixer={
        k: v.to(torch.bfloat16) for k, v in layer["mixer"].items()})
        for layer in tp["blocks"]])
    worse = forward(rounded, torch.from_numpy(tokens).long(), tb).numpy()
    assert np.abs(worse - want).max() > np.abs(got - want).max()


# --------------------------------------------------------------------------
# decodes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_decodes_match_reference_on_every_driver(strategy):
    """The ``ms`` stack (an sLSTM layer) under ``none``: the port's three
    drivers against the reference's host driver."""
    jcfg, cfg, jp, tp = _model()
    prompt = np.random.default_rng(5).integers(
        0, cfg.vocab_size - 1, (2, PROMPT)).astype(np.int32)
    kw = {**DECODE, **STRATEGIES[strategy]}
    want, wstats = JaxDecoder(jp, jcfg, JaxDecodeConfig(
        **kw, fused_loop=False)).generate(jax.random.PRNGKey(0),
                                          jnp.asarray(prompt))
    for driver, over in DRIVERS.items():
        got, st = Decoder(tp, cfg, DecodeConfig(**kw, **over),
                          device="cpu").generate(None, prompt)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=driver)
        assert st.steps == wstats.steps, driver
        assert st.forward_equivalents == wstats.forward_equivalents, driver
        assert st.phase_counts == wstats.phase_counts, driver
        assert st.tokens_generated == wstats.tokens_generated, driver


@pytest.mark.parametrize("policy", ["prefix", "dual"])
def test_cache_policies_raise_value_error(policy):
    """Recurrent state has no rows to scatter a window into: both
    packages refuse the block cache with ``ValueError`` (the reference at
    ``generate``, the port already at ``Decoder``)."""
    jcfg, cfg, jp, tp = _model()
    prompt = np.zeros((2, PROMPT), np.int32)
    with pytest.raises(ValueError, match="attention-backed"):
        JaxDecoder(jp, jcfg, JaxDecodeConfig(
            **DECODE, cache_policy=policy)).generate(
            jax.random.PRNGKey(0), jnp.asarray(prompt))
    with pytest.raises(ValueError, match="attention-backed"):
        Decoder(tp, cfg, DecodeConfig(**DECODE, cache_policy=policy),
                device="cpu").generate(None, prompt)
