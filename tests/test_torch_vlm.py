"""The VLM family of the port (qwen2-vl-72b: the dense block, M-RoPE and
a stream of stub patch embeddings in front of the text) against the
reference's, on the CPU: the config, the tree and the bridge with the
``projector`` group, ``make_positions``' three streams, M-RoPE's
rotation, the forward with and without ``patch_embeds``, the text-only
block cache, decodes with patches on every driver, text-only decodes
under ``dual``, the refusal of patches under a cache policy, and
``make_model_fn``.  Then the slice's gate: for every architecture of the
reference's ``ASSIGNED_ARCHS``, the reduced config's logits.

Same weights (the reference's ``init_model``, bridged), same inputs
(numpy).  qwen2-vl-72b-tiny: 2 layers, d=256, 4 MHA heads of 64, M-RoPE
sections (16, 8, 8), V=512, 16 patches.  Tolerances: RoPE tables and
rotations atol = rtol = 1e-5 in f32, within 2 bf16 spacings of their
scale in bf16; logits and the cache's K/V atol = rtol = 1e-4; positions
exact; tokens, steps, forward-equivalents and FDM-A phase counts exact
against the reference's host driver.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro.configs import ASSIGNED_ARCHS as JAX_ASSIGNED_ARCHS
from repro.configs import DecodeConfig as JaxDecodeConfig
from repro.configs import get_config as jax_get_config
from repro.core import Decoder as JaxDecoder
from repro.core.sampler import make_model_fn as jax_make_model_fn
from repro.models import layers as jax_layers
from repro.models.model import capture_cache as jax_capture_cache
from repro.models.model import forward as jax_forward
from repro.models.model import forward_cached as jax_forward_cached
from repro.models.model import init_model as jax_init_model
from repro.models.model import make_positions as jax_make_positions
from repro.training.checkpoint import _flatten, save
from repro_torch.configs import (ASSIGNED_ARCHS, DecodeConfig, get_config,
                                 list_configs)
from repro_torch.convert import from_jax_params, from_npz, to_flat
from repro_torch.core import Decoder, make_model_fn
from repro_torch.models import (capture_cache, forward, forward_cached,
                                init_model, make_positions)
from repro_torch.models import layers

NAME = "qwen2-vl-72b"
PROMPT, GEN, BLOCK = 16, 24, 8
DECODE = dict(gen_length=GEN, block_size=BLOCK, steps=12)
# untrained weights keep max-probs low (qwen2-vl-tiny's masked rows with
# patches: 0.012-0.050): the knobs make FDM's search and every phase of
# FDM-A really run
STRATEGIES = {"fdm": dict(strategy="fdm", gamma=0.0),
              "fdm_a": dict(strategy="fdm_a", eta1=0.03, eta2=0.029,
                            gamma1=0.0, n_max=3),
              "probability": dict(strategy="probability")}
DRIVERS = {"eager": dict(fused_loop=False), "block": dict(fused_blocks=False),
           "request": {}}


_CACHE = {}


def _model():
    if not _CACHE:
        jcfg, cfg = jax_get_config(NAME).reduced(), get_config(NAME).reduced()
        jp = jax.device_get(jax_init_model(jax.random.PRNGKey(0), jcfg))
        _CACHE["model"] = jcfg, cfg, jp, from_jax_params(jp, device="cpu")
    return _CACHE["model"]


def _patches(cfg, n=None, batch=2, seed=0):
    n = cfg.encdec.num_patch_tokens if n is None else n
    return np.random.default_rng(seed).standard_normal(
        (batch, n, cfg.d_model)).astype(np.float32)


def _prompt(cfg, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size - 1, (2, PROMPT)).astype(np.int32)


# --------------------------------------------------------------------------
# config, tree, bridge
# --------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_field_for_field(reduced):
    jc, tc = jax_get_config(NAME), get_config(NAME)
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
        assert tc == get_config(f"{NAME}-tiny")
        assert (tc.num_layers, tc.d_model, tc.head_dim, tc.mrope_sections,
                tc.encdec.num_patch_tokens) == (2, 256, 64, (16, 8, 8), 16)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert NAME in list_configs() and tc.arch_type == "vlm"
    assert not tc.is_encdec and tc.rope == "mrope"
    assert tc.param_count() == jc.param_count()
    if not reduced:      # the card's cut: 8 of 80 layers (projector aside)
        assert dataclasses.replace(tc, num_layers=8).param_count() == \
            9_512_812_544
    assert ASSIGNED_ARCHS == list(JAX_ASSIGNED_ARCHS)


def test_init_model_tree_and_bridge_round_trip(tmp_path):
    """The reference's leaves and shapes, ``projector/w`` (d, d) among
    them; the bridge and a reference checkpoint leaf for leaf; a bf16
    cast casts the projector."""
    jcfg, cfg, jp, tp = _model()
    want = _flatten(jp)
    got = to_flat(init_model(cfg, device="cpu"))
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    assert got["projector/w"].shape == (cfg.d_model, cfg.d_model)
    flat = to_flat(tp)
    assert sorted(flat) == sorted(want)
    for key, arr in want.items():
        np.testing.assert_array_equal(flat[key], arr, err_msg=key)
    path = str(tmp_path / "ckpt.npz")
    save(path, jp, step=1)
    back = to_flat(from_npz(path, device="cpu"))
    for key, arr in want.items():
        np.testing.assert_array_equal(back[key], arr, err_msg=key)
    bf = from_jax_params(jp, device="cpu", dtype=torch.bfloat16)
    assert bf["projector"]["w"].dtype == torch.bfloat16
    assert init_model(cfg, device="cpu", dtype=torch.bfloat16)[
        "projector"]["w"].dtype == torch.bfloat16


# --------------------------------------------------------------------------
# positions and M-RoPE
# --------------------------------------------------------------------------

@pytest.mark.parametrize("length,offset,patches", [
    (40, 0, 16), (40, 0, 20), (24, 0, 0), (16, 9, 0)],
    ids=["16-square", "20-wraps", "text-only", "offset"])
def test_make_positions_matches_reference(length, offset, patches):
    """(3, B, L) streams: patches at t = 0 on the h/w grid (20 wraps a
    4 × 4 grid), text at t = h = w from 1, a window's from its offset."""
    jcfg, cfg, _, _ = _model()
    want = np.asarray(jax_make_positions(jcfg, 2, length, offset, patches))
    got = make_positions(cfg, 2, length, offset, "cpu", patches)
    assert got.dtype == torch.int32 and got.shape == (3, 2, length)
    np.testing.assert_array_equal(got.numpy(), want)
    if offset == patches == 0:
        assert (got[:, :, 0] == 1).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mrope_rotation_matches_reference(dtype):
    """``apply_rope`` over the three streams (16 patches and text) in f32
    and bf16 (the angles f32, the tables cast to the compute dtype)."""
    jcfg, cfg, _, _ = _model()
    rs = np.random.default_rng(1)
    x = rs.standard_normal((2, 40, cfg.num_heads, cfg.head_dim)).astype(
        np.float32)
    pos = np.array(jax_make_positions(jcfg, 2, 40, 0, 16))
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(jax.jit(jax_layers.apply_rope, static_argnums=2)(
        jx, jnp.asarray(pos), jcfg).astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = layers.apply_rope(tx, torch.from_numpy(pos), cfg)
    assert got.dtype == tx.dtype
    got = got.float().numpy()
    tol = 1e-5 if dtype == "float32" else 2 * 2.0 ** -8 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-5 if tol == 1e-5 else 0,
                               atol=tol)
    # the streams matter: the text-only tables turn the patch rows otherwise
    plain = layers.apply_rope(torch.from_numpy(x), torch.arange(40)[None]
                              .expand(2, 40), cfg).numpy()
    assert np.abs(plain - want).max() > 1e-2


# --------------------------------------------------------------------------
# forwards
# --------------------------------------------------------------------------

@pytest.mark.parametrize("with_patches", [False, True],
                         ids=["text-only", "patches"])
def test_forward_matches_reference(with_patches):
    """Logits over the text rows: (B, L, V), the patch rows projected in
    front and dropped before the head."""
    jcfg, cfg, jp, tp = _model()
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)
    kw = dict(patch_embeds=_patches(cfg)) if with_patches else {}
    want = jax_forward(jp, jnp.asarray(tokens), jcfg,
                       **{k: jnp.asarray(v) for k, v in kw.items()})[0]
    got = forward(tp, torch.from_numpy(tokens).long(), cfg,
                  **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert got.shape == (2, 40, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    if with_patches:
        other = forward(tp, torch.from_numpy(tokens).long(), cfg,
                        patch_embeds=torch.from_numpy(_patches(cfg, seed=9)))
        assert (other - got).abs().max() > 1e-2


def test_cache_paths_match_reference():
    """The text-only block cache: ``capture_cache`` (M-RoPE positions
    from 1) and ``forward_cached`` at the ``prefix`` and a ``dual``
    window (the canvas's streams sliced at the window's start)."""
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
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(kv.v.numpy(), np.asarray(stacked.v[i]),
                                   rtol=1e-4, atol=1e-4)
    for win_start, width in ((PROMPT, GEN), (PROMPT + BLOCK, BLOCK)):
        window = canvas[:, win_start:win_start + width]
        want = jax.jit(jax_forward_cached, static_argnums=4)(
            jp, jnp.asarray(window), jnp.int32(win_start), jstate, jcfg)
        got = forward_cached(tp, torch.from_numpy(window).long(), win_start,
                             tstate, cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


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
def test_decodes_with_patches_match_reference_on_every_driver(strategy):
    """``generate(..., patch_embeds=...)`` under ``none``: the port's three
    drivers against the reference's host driver (FDM's K·B fold tiles the
    patches candidate-major)."""
    jcfg, cfg, jp, tp = _model()
    prompt, pe = _prompt(cfg), _patches(cfg)
    kw = {**DECODE, **STRATEGIES[strategy]}
    want, wstats = JaxDecoder(jp, jcfg, JaxDecodeConfig(
        **kw, fused_loop=False)).generate(jax.random.PRNGKey(0),
                                          jnp.asarray(prompt),
                                          patch_embeds=jnp.asarray(pe))
    if strategy == "fdm_a":
        assert all(wstats.phase_counts.values()), wstats.phase_counts
    for driver, over in DRIVERS.items():
        got, st = Decoder(tp, cfg, DecodeConfig(**kw, **over),
                          device="cpu").generate(
            None, prompt, patch_embeds=torch.from_numpy(pe))
        _assert_same(got, st, want, wstats, driver)
    if strategy != "probability":
        return
    other, _ = Decoder(tp, cfg, DecodeConfig(**kw), device="cpu").generate(
        None, prompt, patch_embeds=_patches(cfg, seed=9))
    assert not torch.equal(other, got)


@pytest.mark.parametrize("strategy", ["fdm_a", "probability"])
def test_text_only_dual_decodes_match_reference(strategy):
    """A text-only decode under ``dual`` (the windows' M-RoPE streams
    sliced from the canvas's), on every driver."""
    jcfg, cfg, jp, tp = _model()
    prompt = _prompt(cfg, seed=1)
    kw = {**DECODE, **STRATEGIES[strategy], "cache_policy": "dual"}
    want, wstats = JaxDecoder(jp, jcfg, JaxDecodeConfig(
        **kw, fused_loop=False)).generate(jax.random.PRNGKey(0),
                                          jnp.asarray(prompt))
    for driver, over in DRIVERS.items():
        got, st = Decoder(tp, cfg, DecodeConfig(**kw, **over),
                          device="cpu").generate(None, prompt)
        _assert_same(got, st, want, wstats, driver)


def test_patches_under_a_cache_policy_raise_value_error():
    """The cache capture runs the text stack only: both packages refuse
    patches under ``prefix`` with ``ValueError``."""
    jcfg, cfg, jp, tp = _model()
    prompt, pe = _prompt(cfg), _patches(cfg)
    cached = dict(DECODE, cache_policy="prefix")
    with pytest.raises(ValueError, match="not supported with cache_policy"):
        JaxDecoder(jp, jcfg, JaxDecodeConfig(**cached)).generate(
            jax.random.PRNGKey(0), jnp.asarray(prompt),
            patch_embeds=jnp.asarray(pe))
    for over in DRIVERS.values():
        with pytest.raises(ValueError,
                           match="not supported with cache_policy"):
            Decoder(tp, cfg, DecodeConfig(**cached, **over),
                    device="cpu").generate(None, prompt, patch_embeds=pe)


def test_make_model_fn_matches_reference():
    """The conditioned forward from params at a K·B fold (K=2, B=2: the
    patches tiled candidate-major)."""
    jcfg, cfg, jp, tp = _model()
    pe = _patches(cfg)
    jfn = jax_make_model_fn(jp, jcfg, patch_embeds=jnp.asarray(pe))
    fn = make_model_fn(tp, cfg, patch_embeds=pe)
    tokens = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (4, 20)).astype(np.int32)
    got = fn(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jfn(jnp.asarray(tokens))),
                               rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------
# the gate: every assigned architecture's reduced logits
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", JAX_ASSIGNED_ARCHS)
def test_assigned_arch_reduced_logits_match_reference(name):
    """``get_config(name).reduced()`` of every architecture the reference
    assigns: the port builds it from the reference's weights and its
    logits match (a VLM with patches, an encoder-decoder with frames)."""
    jcfg, cfg = jax_get_config(name).reduced(), get_config(name).reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    jp = jax.device_get(jax_init_model(jax.random.PRNGKey(1), jcfg))
    tp = from_jax_params(jp, device="cpu")
    rs = np.random.default_rng(5)
    tokens = rs.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    kw = {}
    if cfg.encdec is not None and cfg.encdec.frontend == "vision_stub":
        kw["patch_embeds"] = _patches(cfg)
    elif cfg.is_encdec:
        kw["enc_embeds"] = rs.standard_normal(
            (2, cfg.encdec.encoder_seq, cfg.d_model)).astype(np.float32)
    want = jax_forward(jp, jnp.asarray(tokens), jcfg,
                       **{k: jnp.asarray(v) for k, v in kw.items()})[0]
    got = forward(tp, torch.from_numpy(tokens).long(), cfg,
                  **{k: torch.from_numpy(v) for k, v in kw.items()})
    scale = max(1.0, float(np.abs(np.asarray(want)).max()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4 * scale)
