"""DeepSeek-V2's blocks in the port (deepseek-v2-236b) against the
reference's, on the CPU: the config, MLA (``_mla_latents``,
``mla_forward``, ``mla_capture``, ``mla_cached``), the shared experts,
the weights bridge (MLA's latent norm scales kept f32), the forwards with
a dense first layer, the block cache of latents, decodes on every driver,
and flash attention's plain version and backward at a value head dim
that differs from the query/key one.  (The trainer refuses DeepSeek-V2 by
the MoE check that ``test_torch_moe.py`` covers.)

Same weights (the reference's ``init_model``, bridged), same inputs
(numpy).  At the reduced size MLA's heads are 48 wide for q and k (32
"nope" + 16 rope) and 32 for v.  Tolerances: MLA's outputs and latents
atol = rtol = 1e-5 in f32; MoE outputs 1e-5 of their scale (the experts
are drawn with σ = 1/√E, so outputs are of order 10², as in
``test_torch_moe.py``); logits atol = rtol = 1e-4, as
``test_torch_archs.py``; tokens, steps, forward-equivalents and FDM-A
phase counts exact against the reference's host driver.
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
from repro.models import attention as jax_attention
from repro.models import moe as jax_moe
from repro.models.model import capture_cache as jax_capture_cache
from repro.models.model import forward as jax_forward
from repro.models.model import forward_cached as jax_forward_cached
from repro.models.model import init_model as jax_init_model
from repro.training.checkpoint import _flatten, save
from repro_torch.configs import DecodeConfig, get_config, list_configs
from repro_torch.convert import from_jax_params, from_npz, to_flat
from repro_torch.core import Decoder
from repro_torch.kernels.flash_attention import (attention_backward,
                                                 attention_ref)
from repro_torch.models import (capture_cache, forward, forward_cached,
                                init_model)
from repro_torch.models import attention, layers, moe

NAME = "deepseek-v2-236b"


_CACHE = {}


def _model():
    """Both reduced configs, the reference's weights and the port's copy;
    the latent norm scales are drawn away from 1, so a dropped or rounded
    scale shows."""
    if not _CACHE:
        jcfg = jax_get_config(NAME).reduced()
        cfg = get_config(NAME).reduced()
        jp = jax.device_get(jax_init_model(jax.random.PRNGKey(0), jcfg))
        rs = np.random.default_rng(11)
        for group in jp["blocks"]:
            for key in ("q_norm", "kv_norm"):
                shape = group["attn"][key].shape
                group["attn"][key] = (1 + 0.5 * rs.standard_normal(shape)
                                      ).astype(np.float32)
        _CACHE["model"] = jcfg, cfg, jp, from_jax_params(jp, device="cpu")
    return _CACHE["model"]


def _layer(jp, tp, idx):
    """Layer ``idx``'s reference params (its group's stacked leaves at its
    place in the group) and the port's."""
    group, pos = (0, 0) if idx == 0 else (1, idx - 1)
    return (jax.tree_util.tree_map(lambda a: a[pos], jp["blocks"][group]),
            tp["blocks"][idx])


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_field_for_field(reduced):
    jc, tc = jax_get_config(NAME), get_config(NAME)
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
        assert tc == get_config(f"{NAME}-tiny")
        m = tc.mla
        assert (tc.num_layers, tc.d_model, tc.num_heads, tc.head_dim,
                tc.moe.num_experts, tc.moe.num_experts_per_tok,
                tc.moe.num_shared_experts, tc.moe.first_k_dense) == \
            (2, 256, 4, 64, 4, 2, 1, 1)
        assert (m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim,
                m.kv_lora_rank, m.q_lora_rank) == (48, 32, 64, 96)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert tc.attention == "mla" and tc.is_moe
    assert layers.model_rotary_dim(tc) == tc.mla.qk_rope_head_dim
    assert NAME in list_configs()


def test_init_model_has_the_reference_tree():
    """Leaves (paths, shapes) as the reference's: MLA's eight, the shared
    experts' SwiGLU in the MoE layer, a dense first layer; the latent
    norms f32 ones under a bf16 config."""
    jcfg = jax_get_config(NAME).reduced()
    cfg = dataclasses.replace(get_config(NAME).reduced(), dtype="bfloat16")
    want = _flatten(jax.device_get(jax_init_model(jax.random.PRNGKey(0),
                                                  jcfg)))
    params = init_model(cfg, device="cpu")
    got = to_flat(params)
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    assert "mlp" in params["blocks"][0] and "moe" in params["blocks"][1]
    attn = params["blocks"][1]["attn"]
    for key in ("q_norm", "kv_norm"):
        assert attn[key].dtype == torch.float32
        assert torch.equal(attn[key], torch.ones_like(attn[key]))
    assert attn["wq_a"].dtype == torch.bfloat16
    assert set(params["blocks"][1]["moe"]["shared"]) == {"gate", "up",
                                                         "down"}


def test_bridge_round_trips_and_keeps_latent_norms_f32(tmp_path):
    """The MLA tree and ``moe.shared`` go through ``from_jax_params``,
    ``to_flat`` and a reference-written checkpoint leaf for leaf, in two
    layer groups; under a bf16 cast ``q_norm`` and ``kv_norm`` stay f32
    with the reference's values."""
    _, cfg, jp, tp = _model()
    want = _flatten(jp)
    assert "blocks/1/moe/shared/gate" in want and "blocks/0/mlp/gate" in want
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
    for idx in (0, 1):
        jl, _ = _layer(jp, tp, idx)
        attn = bf["blocks"][idx]["attn"]
        for key in ("q_norm", "kv_norm"):
            assert attn[key].dtype == torch.float32
            np.testing.assert_array_equal(attn[key].numpy(),
                                          jl["attn"][key])
        assert attn["wkv_a"].dtype == torch.bfloat16
    assert bf["blocks"][1]["moe"]["shared"]["up"].dtype == torch.bfloat16


def _attn_inputs(jcfg, cfg, length, offset=0, seed=0):
    """x (2, length, d) and positions from ``offset``: the reference's
    positions and the port's RoPE tables at MLA's rope dim."""
    rs = np.random.default_rng(seed)
    x = rs.standard_normal((2, length, cfg.d_model)).astype(np.float32)
    pos = offset + np.arange(length, dtype=np.int32)[None].repeat(2, 0)
    rope = layers.rope_tables(torch.from_numpy(pos),
                              layers.model_rotary_dim(cfg), cfg,
                              torch.float32)
    return x, jnp.asarray(pos), rope


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("idx", [0, 1])
def test_mla_latents_and_forward_match_reference(idx):
    """``_mla_latents`` (the normed latents, q's and k's rope parts turned
    at the rope dim of 16) and ``mla_forward`` (per-head K/V at (48, 32),
    scale 48^-½) in both layers."""
    jcfg, cfg, jp, tp = _model()
    jl, tl = _layer(jp, tp, idx)
    x, pos, rope = _attn_inputs(jcfg, cfg, 24, seed=idx)
    want = jax_attention._mla_latents(jl["attn"], jnp.asarray(x), pos, jcfg)
    got = attention._mla_latents(tl["attn"], torch.from_numpy(x), rope, cfg)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w)
    want = jax_attention.mla_forward(jl["attn"], jnp.asarray(x), pos, jcfg)
    got = attention.attention_forward(tl["attn"], torch.from_numpy(x), rope,
                                      cfg)
    assert tuple(got.shape) == (2, 24, cfg.d_model)
    _close(got, want)


def test_mla_capture_and_cached_match_reference():
    """``mla_capture`` (output and the latent cache (c_kv, k_rope)) over a
    40-token canvas, then ``mla_cached`` for a window at 16 and one at 32,
    whose own latents are written into the cache."""
    jcfg, cfg, jp, tp = _model()
    jl, tl = _layer(jp, tp, 1)
    x, pos, rope = _attn_inputs(jcfg, cfg, 40, seed=2)
    want_out, want_kv = jax_attention.mla_capture(jl["attn"], jnp.asarray(x),
                                                  pos, jcfg)
    got_out, got_kv = attention.attention_capture(tl["attn"],
                                                  torch.from_numpy(x), rope,
                                                  cfg)
    _close(got_out, want_out)
    assert tuple(got_kv.k.shape) == (2, 40, cfg.mla.kv_lora_rank)
    assert tuple(got_kv.v.shape) == (2, 40, cfg.mla.qk_rope_head_dim)
    _close(got_kv.k, want_kv.k)
    _close(got_kv.v, want_kv.v)
    for win_start, width in ((16, 24), (32, 8)):
        xw, wpos, wrope = _attn_inputs(jcfg, cfg, width, win_start, seed=5)
        want = jax_attention.mla_cached(jl["attn"], jnp.asarray(xw), wpos,
                                        jcfg, want_kv, jnp.int32(win_start))
        got = attention.attention_cached(tl["attn"], torch.from_numpy(xw),
                                         wrope, cfg, got_kv, win_start)
        _close(got, want)


@pytest.mark.parametrize("factor", [1.25, 2.0])
def test_moe_with_shared_experts_matches_reference(factor):
    """The routed experts plus the shared SwiGLU (width moe_d_ff × 1 at the
    reduced size) on the router's input."""
    jcfg, cfg, jp, tp = _model()
    jl, tl = _layer(jp, tp, 1)
    x = np.random.default_rng(4).standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32)
    want, want_aux = jax.jit(jax_moe.moe_forward, static_argnums=(2, 3))(
        jl["moe"], jnp.asarray(x), jcfg, factor)
    got, aux = moe.moe_forward(tl["moe"], torch.from_numpy(x), cfg, factor)
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.numpy() / scale, np.asarray(want) / scale,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6,
                               atol=1e-6)
    routed = dict(tl["moe"])
    del routed["shared"]
    plain = moe._dispatch(routed, torch.from_numpy(x).reshape(80, -1), cfg,
                          factor, False)[0].reshape(got.shape)
    shared = layers.apply_mlp(tl["moe"]["shared"], torch.from_numpy(x), cfg)
    torch.testing.assert_close(got, plain + shared, rtol=1e-6, atol=1e-5)
    assert shared.abs().max() > 1e-2


def test_forward_logits_match_reference():
    """The dense layer 0 then an MoE layer with MLA in both: logits and the
    aux loss."""
    jcfg, cfg, jp, tp = _model()
    rs = np.random.default_rng(0)
    tokens = rs.integers(0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    tokens[:, 20:] = jcfg.mask_token_id
    want, want_aux = jax.jit(jax_forward, static_argnums=2)(
        jp, jnp.asarray(tokens), jcfg)
    got, aux = forward(tp, torch.from_numpy(tokens).long(), cfg,
                       return_aux=True)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5,
                               atol=1e-6)


PROMPT, GEN, BLOCK = 16, 24, 8


def test_cache_paths_match_reference():
    """``capture_cache`` keeps each layer's latents (c_kv, k_rope);
    ``forward_cached`` at the ``prefix`` and a ``dual`` window."""
    jcfg, cfg, jp, tp = _model()
    rs = np.random.default_rng(3)
    canvas = rs.integers(0, cfg.vocab_size - 1,
                         (2, PROMPT + GEN)).astype(np.int32)
    canvas[:, PROMPT + 5:] = cfg.mask_token_id
    stale = canvas.copy()
    stale[:, PROMPT:] = cfg.mask_token_id
    jstate = jax.jit(jax_capture_cache, static_argnums=2)(
        jp, jnp.asarray(stale), jcfg)
    tstate = capture_cache(tp, torch.from_numpy(stale).long(), cfg)
    assert len(jstate.layer_states) == 2 and len(tstate) == 2
    for kv, stacked in zip(tstate, jstate.layer_states):
        assert tuple(kv.k.shape) == (2, PROMPT + GEN, cfg.mla.kv_lora_rank)
        _close(kv.k, stacked.k[0])
        _close(kv.v, stacked.v[0])
    for win_start, width in ((PROMPT, GEN), (PROMPT + BLOCK, BLOCK)):
        window = canvas[:, win_start:win_start + width]
        want = jax.jit(jax_forward_cached, static_argnums=4)(
            jp, jnp.asarray(window), jnp.int32(win_start), jstate, jcfg)
        got = forward_cached(tp, torch.from_numpy(window).long(), win_start,
                             tstate, cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


DECODE = dict(gen_length=GEN, block_size=BLOCK, steps=12)
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
def test_decodes_match_reference_on_every_driver(strategy, policy):
    """deepseek-v2-236b-tiny: the port's three drivers (the dual window's
    K-candidate batch tiles the latent cache) against the reference's
    host driver."""
    jcfg, cfg, jp, tp = _model()
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size - 1, (2, PROMPT)).astype(np.int32)
    kw = {**DECODE, **STRATEGIES[strategy], "cache_policy": policy}
    want, wstats = JaxDecoder(jp, jcfg, JaxDecodeConfig(
        **kw, fused_loop=False)).generate(jax.random.PRNGKey(0),
                                          jnp.asarray(prompt))
    if strategy == "fdm_a":
        assert all(wstats.phase_counts.values()), wstats.phase_counts
    for driver, over in DRIVERS.items():
        got, st = Decoder(tp, cfg, DecodeConfig(**kw, **over),
                          device="cpu").generate(None, prompt)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=driver)
        assert st.steps == wstats.steps, driver
        assert st.forward_equivalents == wstats.forward_equivalents, driver
        assert st.phase_counts == wstats.phase_counts, driver
        assert st.tokens_generated == wstats.tokens_generated, driver


# (B, Lq, Lk, H, G, dqk, dv, window, q_offset): MLA's reduced heads, its
# dual window at an offset, a GQA band, and the full size's (192, 128)
MIXED = [(2, 24, 24, 4, 4, 48, 32, 0, 0), (2, 8, 40, 4, 4, 48, 32, 0, 16),
         (1, 40, 40, 4, 2, 48, 32, 9, 0), (1, 16, 16, 2, 2, 192, 128, 0, 0)]


@pytest.mark.parametrize("b,lq,lk,h,g,dqk,dv,w,qo", MIXED)
def test_attention_ref_at_mixed_head_dims_matches_reference(b, lq, lk, h, g,
                                                            dqk, dv, w, qo):
    """The flash kernel's plain version with v narrower than q and k
    against the reference's ``_sdpa`` (scale dqk^-½)."""
    rs = np.random.default_rng(lq + dqk + w)
    q, k, v = (rs.standard_normal(s).astype(np.float32)
               for s in ((b, lq, h, dqk), (b, lk, g, dqk), (b, lk, g, dv)))
    mask = jax_attention.band_mask(qo + jnp.arange(lq), jnp.arange(lk), w) \
        if w else None
    want = jax_attention._sdpa(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), mask, dqk ** -0.5)
    got = attention_ref(*(torch.from_numpy(t) for t in (q, k, v)), w, qo)
    assert tuple(got.shape) == (b, lq, h, dv)
    _close(got, want)


@pytest.mark.parametrize("b,lq,lk,h,g,dqk,dv,w,qo", MIXED[:3])
def test_attention_backward_at_mixed_head_dims_matches_autograd(
        b, lq, lk, h, g, dqk, dv, w, qo):
    """dq, dk (dqk wide) and dv (dv wide) of ``attention_backward`` against
    autograd of ``attention_ref``, in f32, within 1e-5."""
    gen = torch.Generator().manual_seed(lq + w)
    q, k, v = (torch.randn(*s, generator=gen)
               for s in ((b, lq, h, dqk), (b, lk, g, dqk), (b, lk, g, dv)))
    dout = torch.randn(b, lq, h, dv, generator=gen)
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = attention_ref(*ins, w, qo)
    want = torch.autograd.grad(out, ins, dout)
    got = attention_backward(q, k, v, out.detach(), dout, w, qo, chunk=5)
    for gt, wt in zip(got, want):
        assert gt.shape == wt.shape
        torch.testing.assert_close(gt, wt, rtol=1e-5, atol=1e-5)

