"""The dense GQA family of the port (qwen3-14b, chatglm3-6b, stablelm-3b,
stablelm-12b) against the reference's, on the CPU: the configs, the
weights bridge with Qwen3's per-head q/k norm scales, the headwise norm
and ChatGLM's half RoPE, the forwards, the block cache, and decodes on
every driver.

Same weights (the reference's ``init_model``, bridged), same tokens
(numpy).  Tolerances as ``test_torch_model.py``: f32 logits to
atol = rtol = 1e-4; tokens, steps, forward-equivalents and FDM-A phase
counts exact (against the reference's host driver, which sums
forward-equivalents in the port's order).
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
from repro.models import layers as jax_layers
from repro.models.model import capture_cache as jax_capture_cache
from repro.models.model import forward as jax_forward
from repro.models.model import forward_cached as jax_forward_cached
from repro.models.model import init_model as jax_init_model
from repro.training.checkpoint import _flatten
from repro_torch.configs import DecodeConfig, get_config, list_configs
from repro_torch.convert import from_jax_params, to_flat
from repro_torch.core import Decoder
from repro_torch.models import (capture_cache, forward, forward_cached,
                                init_model)
from repro_torch.models import layers

ARCHS = ("qwen3-14b", "chatglm3-6b", "stablelm-3b", "stablelm-12b")
# reduced configs and two variants: qwen3 with GQA (reduced gives 4:4) and
# stablelm-3b at its full model's head dim (80)
VARIANTS = {"qwen3-14b": ("qwen3-14b", {}),
            "qwen3-14b-gqa": ("qwen3-14b", dict(num_kv_heads=2)),
            "chatglm3-6b": ("chatglm3-6b", {}),
            "stablelm-3b": ("stablelm-3b", {}),
            "stablelm-3b-d80": ("stablelm-3b", dict(d_model=320)),
            "stablelm-12b": ("stablelm-12b", {})}


def _weights(name, over, seed=0):
    """Both configs and both param trees; qwen3's q/k norm scales are
    drawn away from their initial ones, so a dropped scale shows."""
    jcfg = jax_get_config(name).reduced(**over)
    cfg = get_config(name).reduced(**over)
    jp = jax.device_get(jax_init_model(jax.random.PRNGKey(seed), jcfg))
    if jcfg.qk_norm:
        rs = np.random.default_rng(seed + 11)
        attn = jp["blocks"][0]["attn"]
        for key in ("q_scale", "k_scale"):
            attn[key] = (1 + 0.5 * rs.standard_normal(attn[key].shape)
                         ).astype(np.float32)
    return jcfg, cfg, jp, from_jax_params(jp, device="cpu")


_CACHE = {}


def _model(variant):
    if variant not in _CACHE:
        _CACHE[variant] = _weights(*VARIANTS[variant])
    return _CACHE[variant]


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", ARCHS)
def test_configs_match_field_for_field(name, reduced):
    jc, tc = jax_get_config(name), get_config(name)
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
        assert tc == get_config(f"{name}-tiny")
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert name in list_configs()


@pytest.mark.parametrize("name", ["qwen3-14b", "chatglm3-6b"])
def test_init_model_has_the_reference_tree(name):
    """The port's seeded init makes the reference's leaves (paths,
    shapes), with the q/k norm scales f32 ones under a bf16 config."""
    jcfg = jax_get_config(name).reduced()
    cfg = dataclasses.replace(get_config(name).reduced(), dtype="bfloat16")
    want = _flatten(jax.device_get(jax_init_model(jax.random.PRNGKey(0),
                                                  jcfg)))
    params = init_model(cfg, device="cpu")
    got = to_flat(params)
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    attn = params["blocks"][1]["attn"]
    assert ("q_scale" in attn) == cfg.qk_norm
    if cfg.qk_norm:
        for key in ("q_scale", "k_scale"):
            assert attn[key].dtype == torch.float32
            assert torch.equal(attn[key], torch.ones(cfg.head_dim))
    assert attn["wq"].dtype == torch.bfloat16


def test_bridge_round_trips_and_keeps_qk_scales_f32():
    _, cfg, jp, tp = _model("qwen3-14b")
    want = _flatten(jp)
    assert "blocks/0/attn/q_scale" in want
    got = to_flat(tp)
    assert sorted(got) == sorted(want)
    for key, arr in want.items():
        np.testing.assert_array_equal(got[key], arr, err_msg=key)
    bf = from_jax_params(jp, device="cpu", dtype=torch.bfloat16)
    for layer, i in ((bf["blocks"][0]["attn"], 0), (bf["blocks"][1]["attn"],
                                                    1)):
        for key in ("q_scale", "k_scale"):
            assert layer[key].dtype == torch.float32
            np.testing.assert_array_equal(
                layer[key].numpy(), jp["blocks"][0]["attn"][key][i])
        assert layer["wq"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_headwise_matches_reference(dtype):
    rs = np.random.default_rng(5)
    x = rs.standard_normal((2, 7, 4, 80)).astype(np.float32)
    scale = (1 + rs.standard_normal(80)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    tol = 1e-6
    if dtype == "bfloat16":
        jx, tx, tol = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16), 0.0
    want = jax_layers.rms_norm_headwise(jx, jnp.asarray(scale))
    got = layers.rms_norm_headwise(tx, torch.from_numpy(scale))
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("hd", [64, 80])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_half_rope_matches_reference(dtype, hd):
    """'half' turns x[..., :hd/2] as split halves and passes the rest
    through: the tables are (…, hd/4), as ``forward_rope`` builds them."""
    jcfg = jax_get_config("chatglm3-6b").reduced()
    cfg = get_config("chatglm3-6b").reduced()
    rs = np.random.default_rng(hd)
    x = rs.standard_normal((2, 9, 4, hd)).astype(np.float32)
    pos = np.tile(np.arange(3, 12, dtype=np.int32), (2, 1))
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    tol = 1e-5
    if dtype == "bfloat16":
        jx, tx, tol = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16), 2e-2
    want = jax_layers.apply_rope(jx, jnp.asarray(pos), jcfg)
    got = layers.apply_rope(tx, torch.from_numpy(pos), cfg)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    assert torch.equal(got[..., hd // 2:], tx[..., hd // 2:])
    rope = layers.rope_tables(torch.from_numpy(pos),
                              layers.rotary_dim(cfg, hd), cfg, tx.dtype)
    assert rope.cos.shape == (2, 9, 1, hd // 4)
    assert torch.equal(layers.rotate(tx, rope), got)


def test_standard_rope_is_unchanged():
    """'standard' still turns the whole head, bit for bit the split-halves
    formula over (…, hd/2) tables."""
    cfg = get_config("llada-8b").reduced()
    rs = np.random.default_rng(2)
    x = torch.from_numpy(rs.standard_normal((2, 6, 4, 64)).astype(
        np.float32)).to(torch.bfloat16)
    pos = torch.arange(6)[None].expand(2, 6)
    rope = layers.rope_tables(pos, 64, cfg, x.dtype)
    assert layers.rotary_dim(cfg, 64) == 64
    x1, x2 = x[..., :32], x[..., 32:]
    want = torch.cat([x1 * rope.cos - x2 * rope.sin,
                      x2 * rope.cos + x1 * rope.sin], dim=-1)
    assert torch.equal(layers.rotate(x, rope), want)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_logits_match_reference(variant):
    jcfg, cfg, jp, tp = _model(variant)
    rs = np.random.default_rng(0)
    tokens = rs.integers(0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    tokens[:, 20:] = jcfg.mask_token_id
    want = np.asarray(jax_forward(jp, jnp.asarray(tokens), jcfg)[0])
    got = forward(tp, torch.from_numpy(tokens).long(), cfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


PROMPT, GEN, BLOCK = 16, 32, 8


@pytest.mark.parametrize("variant", ["qwen3-14b", "qwen3-14b-gqa",
                                     "chatglm3-6b"])
def test_cache_paths_match_reference(variant):
    """``capture_cache`` (K/V per layer: q/k normed and turned before they
    are kept) and ``forward_cached`` at the ``prefix`` and a ``dual``
    window, the cache captured from a stale canvas."""
    jcfg, cfg, jp, tp = _model(variant)
    rs = np.random.default_rng(3)
    canvas = rs.integers(0, cfg.vocab_size - 1,
                         (2, PROMPT + GEN)).astype(np.int32)
    canvas[:, PROMPT + 5:] = cfg.mask_token_id
    stale = canvas.copy()
    stale[:, PROMPT:] = cfg.mask_token_id
    jstate = jax_capture_cache(jp, jnp.asarray(stale), jcfg)
    tstate = capture_cache(tp, torch.from_numpy(stale).long(), cfg)
    (stacked,) = jstate.layer_states
    for i, kv in enumerate(tstate):
        np.testing.assert_allclose(kv.k.numpy(), np.asarray(stacked.k[i]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(kv.v.numpy(), np.asarray(stacked.v[i]),
                                   rtol=1e-5, atol=1e-5)
    for win_start, width in ((PROMPT, GEN), (PROMPT + 2 * BLOCK, BLOCK)):
        window = canvas[:, win_start:win_start + width]
        want = jax_forward_cached(jp, jnp.asarray(window),
                                  jnp.int32(win_start), jstate, jcfg)
        got = forward_cached(tp, torch.from_numpy(window).long(), win_start,
                             tstate, cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


DECODE = dict(gen_length=GEN, block_size=BLOCK, steps=16)
# untrained weights keep max-probs near 1/V: the knobs make FDM's search
# and FDM-A's phases really run (test_torch_decode.py's cases)
STRATEGIES = {"fdm": dict(strategy="fdm", gamma=0.0),
              "fdm_a": dict(strategy="fdm_a", eta1=0.025, eta2=0.02,
                            gamma1=0.0, n_max=4),
              "probability": dict(strategy="probability")}
DRIVERS = {"eager": dict(fused_loop=False), "block": dict(fused_blocks=False),
           "request": {}}


@pytest.mark.parametrize("policy", ["none", "dual"])
@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
@pytest.mark.parametrize("variant", ["qwen3-14b", "chatglm3-6b"])
def test_decodes_match_reference_on_every_driver(variant, strategy, policy):
    jcfg, cfg, jp, tp = _model(variant)
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size - 1, (2, PROMPT)).astype(np.int32)
    kw = {**DECODE, **STRATEGIES[strategy], "cache_policy": policy}
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
