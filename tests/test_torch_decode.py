"""The port's decoding stack against the reference's, on the CPU.

Same weights (bridged), same prompts (numpy), same ``DecodeConfig``
fields: every strategy that draws no randomness must give exactly the
reference's tokens, ``steps`` and ``forward_equivalents`` (and FDM-A's
phase counts).  On the reduced LLaDA config the smallest top-2
probability gap is far above f32 noise, so exact parity is a fair demand.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro.configs import DecodeConfig as JaxDecodeConfig
from repro.configs import get_config as jax_get_config
from repro.core import Decoder as JaxDecoder
from repro.core.confidence import global_confidence as jax_global_confidence
from repro.models.model import init_model as jax_init_model
from repro_torch.configs import DecodeConfig, get_config
from repro_torch.convert import from_jax_params
from repro_torch.core import Decoder, global_confidence, resolve_strategy
from repro_torch.core.decoder import check_kernel_flag
from repro_torch.models import forward

JCFG = jax_get_config("llada-8b").reduced()
CFG = get_config("llada-8b").reduced()
BASE = dict(gen_length=32, block_size=8, steps=20)

CASES = {s: dict(strategy=s) for s in
         ("probability", "margin", "entropy", "eb", "wino", "fdm", "fdm_a")}
# untrained weights keep every max-prob near 1/V, below the paper's
# thresholds: these two lower them so the foreseeing search, and all four
# FDM-A phases, really run
CASES["fdm_search"] = dict(strategy="fdm", gamma=0.0, steps=32)
CASES["fdm_a_phases"] = dict(strategy="fdm_a", eta1=0.025, eta2=0.02,
                             gamma1=0.0, n_max=4, steps=32)


@pytest.fixture(scope="module")
def weights():
    jp = jax_init_model(jax.random.PRNGKey(0), JCFG)
    return jp, from_jax_params(jax.device_get(jp), device="cpu")


@pytest.fixture(scope="module")
def prompt():
    return np.random.default_rng(0).integers(
        0, CFG.vocab_size - 1, (2, 16)).astype(np.int32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_matches_reference_exactly(weights, prompt, case):
    jp, tp = weights
    kw = {**BASE, **CASES[case]}
    want, wstats = JaxDecoder(jp, JCFG, JaxDecodeConfig(**kw)).generate(
        jax.random.PRNGKey(0), jnp.asarray(prompt))
    got, gstats = Decoder(tp, CFG, DecodeConfig(**kw),
                          device="cpu").generate(None, prompt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert gstats.steps == wstats.steps
    assert gstats.forward_equivalents == wstats.forward_equivalents
    assert gstats.phase_counts == wstats.phase_counts
    assert gstats.tokens_generated == wstats.tokens_generated
    assert (got[:, 16:] != CFG.mask_token_id).all()
    if case == "fdm_a_phases":
        assert all(v > 0 for v in gstats.phase_counts.values())
    if case.startswith("fdm"):
        assert gstats.steps == kw["gen_length"] or case == "fdm_a_phases"


HJCFG = jax_get_config("hymba-1.5b").reduced()
HCFG = get_config("hymba-1.5b").reduced()


@pytest.fixture(scope="module")
def hymba_weights():
    jp = jax_init_model(jax.random.PRNGKey(0), HJCFG)
    return jp, from_jax_params(jax.device_get(jp), device="cpu")


@pytest.mark.parametrize("case", sorted(CASES))
def test_hymba_decode_matches_reference_exactly(hymba_weights, prompt,
                                                case):
    """The hybrid stack (attention ∥ Mamba, window 32 over a 48-token
    canvas): the same exactness as the dense stack's."""
    jp, tp = hymba_weights
    kw = {**BASE, **CASES[case]}
    want, wstats = JaxDecoder(jp, HJCFG, JaxDecodeConfig(**kw)).generate(
        jax.random.PRNGKey(0), jnp.asarray(prompt))
    got, gstats = Decoder(tp, HCFG, DecodeConfig(**kw),
                          device="cpu").generate(None, prompt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert gstats.steps == wstats.steps
    assert gstats.forward_equivalents == wstats.forward_equivalents
    assert gstats.phase_counts == wstats.phase_counts
    assert (got[:, 16:] != HCFG.mask_token_id).all()
    if case == "fdm_a_phases":
        assert all(v > 0 for v in gstats.phase_counts.values())


@pytest.mark.parametrize("gen,bs,steps", [(32, 8, 20), (32, 8, 32),
                                          (24, 8, 10), (16, 16, 5),
                                          (32, 8, 64), (32, 8, 3)])
def test_geometry_matches_reference(gen, bs, steps):
    kw = dict(gen_length=gen, block_size=bs, steps=steps)
    jdec = JaxDecoder(lambda t: t, JCFG, JaxDecodeConfig(**kw))
    tdec = Decoder(lambda t: t, CFG, DecodeConfig(**kw), device="cpu")
    if steps < gen // bs:
        with pytest.raises(ValueError, match="infeasible"):
            jdec._geometry()
        with pytest.raises(ValueError, match="infeasible"):
            tdec._geometry()
        return
    want, got = jdec._geometry(), tdec._geometry()
    assert got[:3] == want[:3]
    np.testing.assert_array_equal(got[3], want[3])


def test_global_confidence_matches_reference():
    rs = np.random.default_rng(5)
    logits = (3 * rs.standard_normal((2, 3, 10, 64))).astype(np.float32)
    masked = rs.random((2, 3, 10)) < 0.5
    want = jax.vmap(jax_global_confidence)(jnp.asarray(logits),
                                           jnp.asarray(masked))
    got = global_confidence(torch.from_numpy(logits),
                            torch.from_numpy(masked))
    assert got.shape == (2, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


def test_random_strategy_commits_n_argmax_tokens_in_block(weights):
    """The reference draws from the JAX PRNG, so ``random`` is checked by
    its properties: n commits per row per step, inside the block, each the
    position's argmax token; a seed fixes the draw."""
    _, tp = weights
    strat = resolve_strategy("random")
    dcfg = DecodeConfig(**BASE, strategy="random")
    x = torch.full((3, 24), CFG.mask_token_id, dtype=torch.long)
    x[:, :8] = 5
    in_block = (torch.arange(24) >= 8) & (torch.arange(24) < 16)
    active = in_block[None] & (x == CFG.mask_token_id)
    model_fn = lambda t: forward(tp, t, CFG)          # noqa: E731
    argmax = model_fn(x).argmax(-1)
    picks = []
    for seed in (1, 1, 2):
        gen = torch.Generator().manual_seed(seed)
        new_x, _, fwd = strat.step(gen, (), x, active, model_fn, CFG, dcfg,
                                   3)
        changed = new_x != x
        assert fwd == 1
        assert (changed.sum(-1) == 3).all()
        assert not (changed & ~in_block[None]).any()
        assert torch.equal(new_x[changed], argmax[changed])
        picks.append(changed)
    assert torch.equal(picks[0], picks[1])
    assert not torch.equal(picks[0], picks[2])
    out, stats = Decoder(tp, CFG, dcfg, device="cpu").generate(7, x[:, :8])
    assert stats.steps == 20 and (out != CFG.mask_token_id).all()


@pytest.mark.parametrize("over,exc", [
    (dict(cache_policy="prefix"), ValueError),
    (dict(cache_policy="dual"), ValueError),
    (dict(trace=True), None),
])
def test_unported_decode_options_raise(weights, prompt, over, exc):
    """A cache policy is ported, but a ``Decoder`` built from a bare
    callable cannot drive it: the reference's ``ValueError`` at
    ``generate``, as ``repro``'s ``_check_cached``.  ``trace`` is ported:
    it decodes as the reference's, with the same ``DecodeTrace``."""
    if exc is None:
        jp, tp = weights
        kw = dict(BASE, strategy="probability", **over)
        want, wstats = JaxDecoder(jp, JCFG, JaxDecodeConfig(
            **kw, fused_loop=False)).generate(jax.random.PRNGKey(0),
                                              jnp.asarray(prompt))
        got, gstats = Decoder(tp, CFG, DecodeConfig(**kw),
                              device="cpu").generate(None, prompt)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (gstats.steps, gstats.forward_equivalents) == \
            (wstats.steps, wstats.forward_equivalents)
        for field in ("commit_step", "commits", "skipped", "block"):
            np.testing.assert_array_equal(getattr(gstats.trace, field),
                                          getattr(wstats.trace, field))
        np.testing.assert_allclose(gstats.trace.commit_conf,
                                   wstats.trace.commit_conf, atol=1e-5)
        return
    kw = dict(BASE, **over)
    jdec = JaxDecoder(lambda t: t, JCFG, JaxDecodeConfig(**kw))
    with pytest.raises(exc) as want:
        jdec.generate(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    dec = Decoder(lambda t: t, CFG, DecodeConfig(**kw), device="cpu")
    with pytest.raises(exc) as got:
        dec.generate(None, np.zeros((1, 4), np.int32))
    assert str(got.value) == str(want.value)
    assert "requires a Decoder built from params" in str(got.value)


@pytest.mark.parametrize("policy", ["prefix", "dual"])
def test_cache_policy_on_hybrid_raises_value_error(policy):
    """A recurrent-state model can never serve a block cache: ValueError
    with the reference's reason, at construction."""
    from repro.core.decoder import validate_cache_policy as jax_validate
    kw = dict(BASE, cache_policy=policy)
    with pytest.raises(ValueError) as want:
        jax_validate(HJCFG, JaxDecodeConfig(**kw))
    with pytest.raises(ValueError) as got:
        Decoder(lambda t: t, HCFG, DecodeConfig(**kw), device="cpu")
    assert str(got.value) == str(want.value)
    assert "recurrent state cannot ride" in str(got.value)
    Decoder(lambda t: t, HCFG, DecodeConfig(**BASE), device="cpu")


@pytest.mark.parametrize("name", ["wino_r", "extrapolate"])
def test_unported_strategies_raise(weights, prompt, name):
    """Both strategies are ported: resolved by name, they decode (at their
    default knobs) as the reference's; an unknown name still raises."""
    strat = resolve_strategy(name)
    assert strat.name == name and strat.positional_carry
    jp, tp = weights
    kw = dict(BASE, strategy=name)
    want, wstats = JaxDecoder(jp, JCFG, JaxDecodeConfig(
        **kw, fused_loop=False)).generate(jax.random.PRNGKey(0),
                                          jnp.asarray(prompt))
    got, gstats = Decoder(tp, CFG, DecodeConfig(**kw),
                          device="cpu").generate(None, prompt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (gstats.steps, gstats.forward_equivalents, gstats.revocations,
            gstats.skipped_forwards) == \
        (wstats.steps, wstats.forward_equivalents, wstats.revocations,
         wstats.skipped_forwards)
    with pytest.raises(KeyError, match="unknown strategy"):
        resolve_strategy("no-such-strategy")


def test_kernel_flag_false_is_refused_on_the_card_only():
    dcfg = DecodeConfig(use_pallas_kernel=False)
    with pytest.raises(ValueError, match="use_pallas_kernel=False"):
        check_kernel_flag(dcfg, torch.device("cuda"))
    check_kernel_flag(dcfg, torch.device("cpu"))
    check_kernel_flag(DecodeConfig(), torch.device("cuda"))
    Decoder(lambda t: t, CFG, dcfg, device="cpu")
