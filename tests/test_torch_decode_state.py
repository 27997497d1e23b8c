"""The port's decode state against the reference's, on the CPU: the
single-token ``decode_step`` and the shrinking window ``forward_window``
(``extend`` None, "kv" with ``set_valid_length``, "recurrent") for LLaDA
and every reduced config of ``ASSIGNED_ARCHS``, a sliding window's ring
decoded past its width, MLA's absorbed decode, whisper's ``enc_out``,
M-RoPE and RoPE at long_500k's positions, the selective scan's initial
and end states, and the flash plain version's valid count.

Same weights (the reference's ``init_model``, bridged by
``from_jax_params``), same inputs (numpy, seeded), f32.  Tolerances:
logits and every state leaf within 1e-5 of their scale (max |value|,
at least 1); argmaxes exact; the caches' valid lengths exact.  A step
writes the port's caches in place, so a state that is compared after a
later step is cloned first.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro.configs import ASSIGNED_ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as jm
from repro.models import ssm as jssm
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.convert import from_jax_params
from repro_torch.kernels.flash_attention import attention_ref
from repro_torch.kernels.selective_scan import selective_scan_ref
from repro_torch.models import attention as tattn
from repro_torch.models.blocks import layer_cache
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tm
from repro_torch.models import ssm as tssm

ARCHS = ["llada-8b"] + list(ASSIGNED_ARCHS)
B, S, STEPS, TOL = 2, 16, 8, 1e-5


def test_arch_lists_agree():
    assert list(ASSIGNED_ARCHS) == list(JAX_ARCHS)


_MODELS = {}


def _configs(name, **over):
    jcfg = jax_get_config(name).reduced(**over)
    if name == "xlstm-125m":             # an mLSTM and an sLSTM layer
        over = dict(over, ssm=dataclasses.replace(jcfg.ssm,
                                                  xlstm_pattern="ms"))
        jcfg = jax_get_config(name).reduced(**over)
    return jcfg, get_config(name).reduced(**over)


def _model(name, **over):
    key = (name, tuple(sorted(over.items())))
    if key not in _MODELS:
        jcfg, cfg = _configs(name, **over)
        jp = jax.device_get(jm.init_model(jax.random.PRNGKey(0), jcfg))
        _MODELS[key] = jcfg, cfg, jp, from_jax_params(jp, device="cpu")
    return _MODELS[key]


def _enc(cfg, seed=3):
    """Seeded encoder output for an encoder-decoder (None otherwise)."""
    if not cfg.is_encdec:
        return None
    return np.random.default_rng(seed).standard_normal(
        (B, 8, cfg.d_model)).astype(np.float32)


def _states(jcfg, cfg, length, valid_length=None, enc=None):
    js = jm.init_decode_state(jcfg, B, length, jnp.float32,
                              enc_out=None if enc is None else
                              jnp.asarray(enc), valid_length=valid_length)
    ts = tm.init_decode_state(cfg, B, length, torch.float32,
                              enc_out=None if enc is None else
                              torch.from_numpy(enc),
                              valid_length=valid_length, device="cpu")
    return js, ts


def _ref_layers(jcfg, jstate):
    """The reference's group-stacked layer states as one state per layer."""
    out = []
    for group, g_state in zip(jm._layer_groups(jcfg), jstate.layer_states):
        for i in range(len(group)):
            out.append(jax.tree.map(lambda a, i=i: np.asarray(a)[i],
                                    g_state))
    return out


def _close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, f"{what}: {err} > {TOL} x {scale}"


def _same_state(jcfg, jstate, tstate, what=""):
    """Every layer's state leaf for leaf; KVCache lengths exact."""
    ref = _ref_layers(jcfg, jstate)
    assert len(ref) == len(tstate.layer_states)
    for i, (r, t) in enumerate(zip(ref, tstate.layer_states)):
        _same_tree(r, t, f"{what} layer {i}")


def _same_tree(r, t, what):
    if isinstance(t, tuple):
        assert type(t).__name__ == type(r).__name__, what
        for j, (a, b) in enumerate(zip(r, t)):
            _same_tree(a, b, f"{what}.{j}")
    elif isinstance(t, int):
        assert int(r) == t, f"{what}: length {t} != {int(r)}"
    else:
        _close(t, r, what)


def _same_logits(jl, tl, what):
    jl, tl = np.asarray(jl), tl.numpy()
    assert (jl.argmax(-1) == tl.argmax(-1)).all(), what
    _close(tl, jl, what)


_JIT = {}


def _jit(fn, *static):
    if (fn, static) not in _JIT:
        _JIT[(fn, static)] = jax.jit(fn, static_argnums=static)
    return _JIT[(fn, static)]


def _tokens(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size - 1,
                                                (n, B, 1))


def _decode_both(jcfg, cfg, jp, tp, js, ts, toks, start=0):
    step = _jit(jm.decode_step, 4)
    for i, tok in enumerate(toks):
        pos = np.full((B, 1), start + i, np.int32)
        jl, js = step(jp, jnp.asarray(tok), jnp.asarray(pos), js, jcfg)
        tl, ts = tm.decode_step(tp, torch.from_numpy(tok),
                                torch.from_numpy(pos), ts, cfg)
        _same_logits(jl, tl, f"step {i}")
    return js, ts


# --------------------------------------------------------------------------
# decode_step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("valid_length", [None, 0])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch, valid_length):
    """Eight tokens, one at a time, into a 16-position state: logits and
    every layer's state (K/V, valid length, Mamba/xLSTM state)."""
    jcfg, cfg, jp, tp = _model(arch)
    js, ts = _states(jcfg, cfg, S, valid_length, _enc(cfg))
    js, ts = _decode_both(jcfg, cfg, jp, tp, js, ts, _tokens(cfg, STEPS))
    _same_state(jcfg, js, ts)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "mixtral-8x22b"])
def test_sliding_window_ring_wraps(arch):
    """A window-32 config decoding 40 tokens into a 64-position state:
    the ring of 32 slots wraps (slot = pos % 32) and every slot stays
    valid once it is warm."""
    jcfg, cfg, jp, tp = _model(arch)
    assert cfg.sliding_window == 32
    js, ts = _states(jcfg, cfg, 64)
    kv = layer_cache(ts.layer_states[0])
    assert kv.k.shape[1] == 32
    js, ts = _decode_both(jcfg, cfg, jp, tp, js, ts, _tokens(cfg, 40, 1))
    _same_state(jcfg, js, ts)


def test_decode_writes_the_cache_in_place():
    """The serve step never copies the cache: the returned state's K/V are
    the given state's buffers, written at the step's slot."""
    jcfg, cfg, jp, tp = _model("llada-8b")
    _, ts = _states(jcfg, cfg, S)
    before = [(kv.k.data_ptr(), kv.v.data_ptr()) for kv in ts.layer_states]
    tok = torch.from_numpy(_tokens(cfg, 1)[0])
    _, ts2 = tm.decode_step(tp, tok, torch.full((B, 1), 5, dtype=torch.int32),
                            ts, cfg)
    after = [(kv.k.data_ptr(), kv.v.data_ptr()) for kv in ts2.layer_states]
    assert after == before
    k = ts.layer_states[0].k
    assert k[:, 5].abs().sum() > 0 and k[:, :5].abs().sum() == 0 and \
        k[:, 6:].abs().sum() == 0
    assert ts2.layer_states[0].length == S + 1


def test_decode_matches_forward_for_dense():
    """The reference's ``test_decode_matches_forward_for_dense`` on the
    port: one layer, tokens decoded one at a time; the last step's logits
    equal the full forward's last position (rtol = atol = 2e-3, as the
    reference's), and the reference's decode within 1e-5."""
    jcfg, cfg, jp, tp = _model("stablelm-3b", num_layers=1)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size - 1, (1, 8))
    full = tm.forward(tp, torch.from_numpy(toks), cfg)
    js = jm.init_decode_state(jcfg, 1, 8, jnp.float32)
    ts = tm.init_decode_state(cfg, 1, 8, torch.float32, device="cpu")
    step = _jit(jm.decode_step, 4)
    for i in range(8):
        pos = np.full((1, 1), i, np.int32)
        jl, js = step(jp, jnp.asarray(toks[:, i:i + 1]), jnp.asarray(pos),
                      js, jcfg)
        tl, ts = tm.decode_step(tp, torch.from_numpy(toks[:, i:i + 1]),
                                torch.from_numpy(pos), ts, cfg)
    np.testing.assert_allclose(tl[0, 0].numpy(), full[0, 7].numpy(),
                               rtol=2e-3, atol=2e-3)
    _same_logits(jl, tl, "last step")


def test_whisper_decodes_with_its_encoder_output():
    """whisper's cross path in decode: with the state's ``enc_out`` the
    logits move, and equal the reference's both with and without it."""
    jcfg, cfg, jp, tp = _model("whisper-medium")
    toks = _tokens(cfg, 3, 5)
    runs = {}
    for enc in (None, _enc(cfg)):
        js, ts = _states(jcfg, cfg, S, enc=enc)
        js, ts = _decode_both(jcfg, cfg, jp, tp, js, ts, toks)
        _same_state(jcfg, js, ts)
        tl, _ = tm.decode_step(tp, torch.from_numpy(toks[0]),
                               torch.full((B, 1), 3, dtype=torch.int32), ts,
                               cfg)
        runs[enc is None] = tl
    assert not torch.allclose(runs[True], runs[False])


# --------------------------------------------------------------------------
# MLA's absorbed decode
# --------------------------------------------------------------------------

def test_mla_absorbed_decode_matches_reference():
    """``mla_decode`` on one DeepSeek-V2-tiny layer against a latent cache
    of seeded contents, the token at position 9 of 12 (slots past it
    masked): output and the latents written at slot 9."""
    jcfg, cfg, jp, tp = _model("deepseek-v2-236b")
    jl = jax.tree.map(lambda a: a[0], jp["blocks"][0]["attn"])
    tl = tp["blocks"][0]["attn"]
    m = cfg.mla
    rs = np.random.default_rng(6)
    c = rs.standard_normal((B, 12, m.kv_lora_rank)).astype(np.float32)
    kr = rs.standard_normal((B, 12, m.qk_rope_head_dim)).astype(np.float32)
    x = rs.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    pos = np.full((B, 1), 9, np.int32)
    jout, jc = jattn.mla_decode(jl, jnp.asarray(x), jnp.asarray(pos), jcfg,
                                jattn.KVCache(jnp.asarray(c), jnp.asarray(kr),
                                              12))
    tpos = torch.from_numpy(pos)
    rope = tlayers.rope_tables(tpos, tlayers.model_rotary_dim(cfg), cfg,
                               torch.float32)
    cache = tattn.KVCache(torch.from_numpy(c.copy()),
                          torch.from_numpy(kr.copy()), 12)
    tout, tc = tattn.mla_decode(tl, torch.from_numpy(x), rope, tpos, cfg,
                                cache)
    _close(tout, jout, "out")
    _close(tc.k, jc.k, "c_kv")
    _close(tc.v, jc.v, "k_rope")
    assert tc.length == 13 and tc.k.data_ptr() == cache.k.data_ptr()
    assert not np.allclose(tc.k[:, 9].numpy(), c[:, 9])


def test_init_cache_shapes_match_reference():
    """Capacities and dtypes: MLA's latents, a sliding window's ring
    (min(length, window)), GQA's K/V; the valid length."""
    for arch, length in (("deepseek-v2-236b", 20), ("mixtral-8x22b", 48),
                         ("mixtral-8x22b", 20), ("qwen3-14b", 20)):
        jcfg, cfg = _configs(arch)
        for vl in (None, 0):
            jc = jattn.init_cache(jcfg, B, length, jnp.float32, vl)
            tc = tattn.init_cache(cfg, B, length, torch.float32, vl, "cpu")
            assert tuple(tc.k.shape) == jc.k.shape
            assert tuple(tc.v.shape) == jc.v.shape
            assert tc.length == jc.length


# --------------------------------------------------------------------------
# forward_window: the three extends
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_window_matches_reference(arch):
    """From an empty state (valid_length 0): a live window of 8 written
    with ``extend="kv"`` then cut to its 4 committed positions
    (``set_valid_length``), the committed block advanced through the
    recurrent states (``extend="recurrent"``), then a scoring window
    (``extend=None``) and a second ``"kv"`` window: logits after every
    call, every layer's state at the end."""
    jcfg, cfg, jp, tp = _model(arch)
    js, ts = _states(jcfg, cfg, S, 0, _enc(cfg))
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size - 1, (B, 16))
    win = _jit(jm.forward_window, 4, 5)

    def both(lo, hi, extend):
        nonlocal js, ts
        t = toks[:, lo:hi]
        pos = np.broadcast_to(np.arange(lo, hi, dtype=np.int32),
                              t.shape).copy()
        jl, js = win(jp, jnp.asarray(t), jnp.asarray(pos), js, jcfg, extend)
        tl, ts = tm.forward_window(tp, torch.from_numpy(t),
                                   torch.from_numpy(pos), ts, cfg, extend)
        _same_logits(jl, tl, f"window {lo}:{hi} extend={extend}")

    both(0, 8, "kv")
    js, ts = jm.set_valid_length(js, 4), tm.set_valid_length(ts, 4)
    both(0, 4, "recurrent")
    both(4, 8, None)
    both(4, 12, "kv")
    js, ts = jm.set_valid_length(js, 8), tm.set_valid_length(ts, 8)
    both(4, 8, "recurrent")
    both(8, 12, None)
    _same_state(jcfg, js, ts)


# --------------------------------------------------------------------------
# RoPE at long positions, M-RoPE in decode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llada-8b", "chatglm3-6b", "qwen2-vl-72b"])
def test_rope_at_long_positions_matches_reference(arch):
    """RoPE's rotation of a seeded (B, 1, H, hd) query at positions up to
    long_500k's 524287 (standard, half and M-RoPE's three equal streams,
    as a decode step broadcasts them): the reference's formula and op
    order, within 1e-5 of the scale."""
    jcfg, cfg = _configs(arch)
    q = np.random.default_rng(8).standard_normal(
        (B, 1, cfg.num_heads, cfg.head_dim)).astype(np.float32)
    for p in (0, 4096, 32767, 524287):
        pos = np.full((B, 1), p, np.int32)
        jpos = jnp.asarray(pos)
        tpos = torch.from_numpy(pos)
        if cfg.rope == "mrope":
            jpos = jnp.broadcast_to(jpos[None], (3, B, 1))
            tpos = tpos[None].expand(3, B, 1)
        want = jlayers.apply_rope(jnp.asarray(q), jpos, jcfg)
        got = tlayers.apply_rope(torch.from_numpy(q), tpos, cfg)
        _close(got, want, f"position {p}")


def test_mrope_decode_positions_broadcast_to_three_streams():
    """qwen2-vl-tiny's decode at text positions 20..23: its M-RoPE tables
    are the three equal streams (3, B, 1), and the logits equal the
    reference's."""
    jcfg, cfg, jp, tp = _model("qwen2-vl-72b")
    assert cfg.rope == "mrope"
    pos, rope = tm._positions_and_rope(
        cfg, torch.full((B, 1), 20, dtype=torch.int32), torch.float32)
    assert pos.shape == (3, B, 1) and rope.cos.shape[:2] == (B, 1)
    js, ts = _states(jcfg, cfg, 32)
    js, ts = _decode_both(jcfg, cfg, jp, tp, js, ts, _tokens(cfg, 4, 9),
                          start=20)
    _same_state(jcfg, js, ts)


# --------------------------------------------------------------------------
# the scan's initial and end states; flash's valid count
# --------------------------------------------------------------------------

def _mamba(seed=0):
    jcfg, cfg, jp, tp = _model("hymba-1.5b")
    jmp = jax.tree.map(lambda a: a[0], jp["blocks"][0]["mamba"])
    return jcfg, cfg, jmp, tp["blocks"][0]["mamba"]


@pytest.mark.parametrize("length", [300, 37])
def test_mamba_state_in_and_out_matches_reference(length):
    """``mamba_forward(state=…, return_state=True)`` at an L that is not a
    multiple of the reference's MAMBA_CHUNK (300: one chunk and a padded
    one; 37: one padded chunk): output, the end state (the reference
    re-scans the unpadded steps: ``selective_last_state``) and the conv's
    tail; then ``mamba_step`` from that state."""
    jcfg, cfg, jmp, tmp = _mamba()
    assert length % jssm.MAMBA_CHUNK
    rs = np.random.default_rng(length)
    x = (0.5 * rs.standard_normal((B, length, cfg.d_model))).astype(
        np.float32)
    di, n = cfg.ssm.expand * cfg.d_model, cfg.ssm.state_size
    h0 = (0.3 * rs.standard_normal((B, di, n))).astype(np.float32)
    conv = rs.standard_normal((B, cfg.ssm.conv_kernel - 1, di)).astype(
        np.float32)
    jst = jssm.MambaState(jnp.asarray(h0), jnp.asarray(conv))
    tst = tssm.MambaState(torch.from_numpy(h0), torch.from_numpy(conv))
    jout, jend = jssm.mamba_forward(jmp, jnp.asarray(x), jcfg, state=jst,
                                    return_state=True)
    tout, tend = tssm.mamba_forward(tmp, torch.from_numpy(x), cfg,
                                    state=tst, return_state=True)
    _close(tout, jout, "out")
    _close(tend.h, jend.h, "end state")
    _close(tend.conv, jend.conv, "conv tail")
    x1 = x[:, :1]
    jo, jst2 = jssm.mamba_step(jmp, jnp.asarray(x1), jcfg, jend)
    to, tst2 = tssm.mamba_step(tmp, torch.from_numpy(x1), cfg, tend)
    _close(to, jo, "step out")
    _close(tst2.h, jst2.h, "step state")
    _close(tst2.conv, jst2.conv, "step conv")


def test_selective_scan_ref_states_match_selective_last_state():
    """The plain scan from h0 with its end state against the reference's
    ``selective_last_state`` over the same conv output, at L = 300."""
    jcfg, cfg, jmp, tmp = _mamba()
    rs = np.random.default_rng(11)
    di, n = cfg.ssm.expand * cfg.d_model, cfg.ssm.state_size
    xc = (0.5 * rs.standard_normal((B, 300, di))).astype(np.float32)
    h0 = (0.3 * rs.standard_normal((B, di, n))).astype(np.float32)
    want = jssm.selective_last_state(jmp, jnp.asarray(xc), jcfg,
                                     jnp.asarray(h0))
    delta, b_sel, c_sel = tssm._mamba_scan_terms(tmp, torch.from_numpy(xc),
                                                 cfg)
    y, h = selective_scan_ref(torch.from_numpy(xc), delta, b_sel, c_sel,
                              tmp["a_log"], torch.from_numpy(h0), True)
    _close(h, want, "end state")
    y0 = selective_scan_ref(torch.from_numpy(xc), delta, b_sel, c_sel,
                            tmp["a_log"])
    assert y.shape == y0.shape and not torch.allclose(y, y0)


@pytest.mark.parametrize("kv_len", [1, 5, 13, 16])
def test_attention_ref_valid_count_matches_sdpa_mask(kv_len):
    """``attention_ref(..., kv_len=n)`` against the reference's ``_sdpa``
    under the validity mask ``arange(Lk) < n`` (GQA 4:2, one query)."""
    rs = np.random.default_rng(kv_len)
    q = rs.standard_normal((B, 1, 4, 32)).astype(np.float32)
    k, v = (rs.standard_normal((B, 16, 2, 32)).astype(np.float32)
            for _ in range(2))
    valid = jnp.arange(16) < kv_len
    want = jattn._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       valid[None, None], 32 ** -0.5)
    got = attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v),
                        kv_len=torch.tensor([kv_len], dtype=torch.int32))
    _close(got, want, f"kv_len {kv_len}")
