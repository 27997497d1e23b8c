"""The port's fixed-shape block cache against the reference's, module by
module, on the CPU: the band's q offset in the plain attention, the
cache capture, the windowed forward at the ``prefix`` and ``dual``
offsets, and the candidate-major tiling of the cache.  Same weights
(bridged), same tokens (numpy), f32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro.configs import get_config as jax_get_config
from repro.core.decoder import _tile_state as jax_tile_state
from repro.models.attention import _sdpa, band_mask
from repro.models.model import capture_cache as jax_capture_cache
from repro.models.model import forward_cached as jax_forward_cached
from repro.models.model import init_model as jax_init_model
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.core.decoder import _tile_state
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.models import capture_cache, forward, forward_cached
from repro_torch.models.attention import KVCache

PROMPT, GEN, BLOCK = 16, 32, 8
TOTAL = PROMPT + GEN
# LLaDA's reduced stack, and the same with GQA and a band narrower than
# the canvas, so the windowed forward's q offset moves the band
VARIANTS = {"llada": {}, "gqa_band": dict(num_kv_heads=2,
                                          sliding_window=12)}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def model(request):
    over = VARIANTS[request.param]
    jcfg = jax_get_config("llada-8b").reduced(**over)
    cfg = get_config("llada-8b").reduced(**over)
    jp = jax_init_model(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, from_jax_params(jax.device_get(jp), device="cpu")


@pytest.fixture(scope="module")
def canvas():
    rs = np.random.default_rng(3)
    cfg = get_config("llada-8b").reduced()
    x = rs.integers(0, cfg.vocab_size - 1, (2, TOTAL)).astype(np.int32)
    x[:, PROMPT + 5:] = cfg.mask_token_id       # a partly decoded canvas
    return x


@pytest.mark.parametrize("lq,lk,h,g,window,q_offset", [
    (8, 48, 4, 4, 12, 0),
    (8, 48, 4, 2, 12, 16),
    (8, 48, 4, 1, 5, 40),
    (32, 48, 4, 2, 3, 16),
    (16, 48, 4, 4, 0, 24),
    (4, 300, 2, 1, 100, 150),
])
def test_attention_ref_q_offset_matches_reference_band(lq, lk, h, g, window,
                                                       q_offset):
    """``attention_ref(..., window, q_offset)`` against the reference's
    ``_sdpa`` with ``band_mask(q_offset + arange(w), arange(total))``."""
    rs = np.random.default_rng(lq + lk + q_offset)
    b, d = 2, 32
    q, k, v = (rs.standard_normal(s).astype(np.float32)
               for s in ((b, lq, h, d), (b, lk, g, d), (b, lk, g, d)))
    mask = band_mask(q_offset + jnp.arange(lq), jnp.arange(lk), window) \
        if window else None
    want = _sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask,
                 d ** -0.5)
    got = fa_mod.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), window, q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_negative_q_offset_is_refused():
    q = torch.zeros(1, 4, 2, 32)
    fa_mod._check(q, q, q, 0, 0)
    with pytest.raises(ValueError, match="q_offset -1 < 0"):
        fa_mod._check(q, q, q, 0, -1)


def test_capture_cache_matches_reference(model, canvas):
    jcfg, cfg, jp, tp = model
    want = jax_capture_cache(jp, jnp.asarray(canvas), jcfg)
    (stacked,) = want.layer_states              # one group of layers
    got = capture_cache(tp, torch.from_numpy(canvas).long(), cfg)
    assert len(got) == cfg.num_layers
    for i, kv in enumerate(got):
        assert isinstance(kv, KVCache)
        assert kv.k.shape == (2, TOTAL, cfg.num_kv_heads, cfg.head_dim)
        np.testing.assert_allclose(kv.k.numpy(), np.asarray(stacked.k[i]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(kv.v.numpy(), np.asarray(stacked.v[i]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("policy,win_start,width", [
    ("prefix", PROMPT, GEN),
    *[("dual", PROMPT + j * BLOCK, BLOCK) for j in range(GEN // BLOCK)],
])
def test_forward_cached_matches_reference(model, canvas, policy, win_start,
                                          width):
    """Logits of the live window at the policy's offset, the cache
    captured from a stale canvas (the window's rows differ from it)."""
    jcfg, cfg, jp, tp = model
    stale = canvas.copy()
    stale[:, PROMPT:] = cfg.mask_token_id
    window = canvas[:, win_start:win_start + width]
    jstate = jax_capture_cache(jp, jnp.asarray(stale), jcfg)
    want = jax_forward_cached(jp, jnp.asarray(window), jnp.int32(win_start),
                              jstate, jcfg)
    tstate = capture_cache(tp, torch.from_numpy(stale).long(), cfg)
    got = forward_cached(tp, torch.from_numpy(window).long(), win_start,
                         tstate, cfg)
    assert got.dtype == torch.float32
    assert got.shape == (2, width, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("win_start,width", [(PROMPT, GEN), (PROMPT, BLOCK),
                                             (PROMPT + 3 * BLOCK, BLOCK),
                                             (0, TOTAL)])
def test_forward_cached_on_current_canvas_equals_forward(model, canvas,
                                                         win_start, width):
    """With the cache captured from the canvas itself, the windowed
    forward is the full forward's window rows; the cache is unchanged."""
    _, cfg, _, tp = model
    x = torch.from_numpy(canvas).long()
    state = capture_cache(tp, x, cfg)
    before = [(kv.k.clone(), kv.v.clone()) for kv in state]
    got = forward_cached(tp, x[:, win_start:win_start + width], win_start,
                         state, cfg)
    want = forward(tp, x, cfg)[:, win_start:win_start + width]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for kv, (k, v) in zip(state, before):
        assert torch.equal(kv.k, k) and torch.equal(kv.v, v)


def test_tile_state_is_candidate_major(model, canvas):
    """``_tile_state`` repeats the batch as b0, b1, b0, b1 (the
    reference's ``jnp.tile``), the order FDM folds candidates in."""
    jcfg, cfg, jp, tp = model
    tstate = capture_cache(tp, torch.from_numpy(canvas).long(), cfg)
    tiled = _tile_state(tstate, 3)
    assert _tile_state(tstate, 1) is tstate
    (jstacked,) = jax_tile_state(
        jax_capture_cache(jp, jnp.asarray(canvas), jcfg), 3).layer_states
    for i, (kv, tkv) in enumerate(zip(tstate, tiled)):
        assert tkv.k.shape[0] == 6
        for c in range(3):
            assert torch.equal(tkv.k[2 * c:2 * c + 2], kv.k)
            assert torch.equal(tkv.v[2 * c:2 * c + 2], kv.v)
        np.testing.assert_allclose(tkv.k.numpy(), np.asarray(jstacked.k[i]),
                                   rtol=1e-5, atol=1e-5)
