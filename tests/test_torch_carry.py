"""The port's carry-ful strategies (``core/wino.py``, ``core/extrapolate.py``)
and the protocol parts they need, against the reference's, on the CPU.

The same seed-made weights go through ``convert.py``; the same prompts and
``DecodeConfig`` fields through both packages.  Tokens, steps,
``revocations`` and ``skipped_forwards`` must be equal, and
forward-equivalents too: exactly against the reference's host driver
(whose Python-float sum the port's drivers reproduce), to rel 1e-6
against its fused drivers (which sum in f32).  Every case runs on the
port's three drivers (eager, per-block graph, whole-request graph) under
``none``, ``prefix``, ``dual`` and ``prefix`` without refreshes.  Random
weights keep every confidence near 1/V, so the reference test's knobs
(``tests/test_carry_strategies.py``) force each mechanism: SKIP floors the
extrapolation threshold, REVOKE fails every pending commit.

The module's decodes share one model fixture and one torch thread.
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
from repro.models.model import init_model as jax_init_model
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch.configs import DecodeConfig, get_config
from repro_torch.convert import from_jax_params
from repro_torch.core import (Decoder, Strategy, as_strategy,
                              available_strategies, register_strategy,
                              resolve_strategy, tracing, unregister_strategy)
from repro_torch.core import strategies as S
from repro_torch.core.graphs import write
from repro_torch.core.loop import carry_unwindow, carry_window, tree_leaves
from repro_torch.serving import ServingEngine

JCFG = jax_get_config("llada-8b").reduced()
CFG = get_config("llada-8b").reduced()
HJCFG = jax_get_config("hymba-1.5b").reduced()
HCFG = get_config("hymba-1.5b").reduced()
BASE = dict(gen_length=32, block_size=8, steps=20)
SKIP_KNOBS = dict(extrap_tau=0.0, extrap_min_obs=1)
REVOKE_KNOBS = dict(wino_revoke_tau=0.99, wino_revoke_budget=4)
CASES = {"wino_r": dict(strategy="wino_r"),
         "wino_r_revoke": dict(strategy="wino_r", **REVOKE_KNOBS),
         "extrapolate": dict(strategy="extrapolate"),
         "extrapolate_skip": dict(strategy="extrapolate", **SKIP_KNOBS)}
POLICIES = {"none": {}, "prefix": dict(cache_policy="prefix"),
            "dual": dict(cache_policy="dual"),
            "prefix_off": dict(cache_policy="prefix", cache_refresh="off")}
DRIVERS = {"eager": dict(fused_loop=False),
           "block": dict(fused_blocks=False),
           "request": {}}


@pytest.fixture(scope="module")
def weights():
    jp = jax_init_model(jax.random.PRNGKey(0), JCFG)
    return jp, from_jax_params(jax.device_get(jp), device="cpu")


@pytest.fixture(scope="module")
def hymba_weights():
    jp = jax_init_model(jax.random.PRNGKey(0), HJCFG)
    return jp, from_jax_params(jax.device_get(jp), device="cpu")


@pytest.fixture(scope="module")
def prompt():
    return np.random.default_rng(0).integers(
        0, CFG.vocab_size - 1, (2, 16)).astype(np.int32)


_REFERENCE = {}


def reference(jp, jcfg, prompt, kw, fused=False):
    """The reference's decode (its host driver unless ``fused``), made
    once per module and arguments."""
    key = (id(jp), jcfg.name, prompt.tobytes(), prompt.shape,
           tuple(sorted(kw.items())), fused)
    if key not in _REFERENCE:
        dcfg = JaxDecodeConfig(**kw, fused_loop=fused)
        out, stats = JaxDecoder(jp, jcfg, dcfg).generate(
            jax.random.PRNGKey(0), jnp.asarray(prompt))
        _REFERENCE[key] = np.asarray(out), stats
    return _REFERENCE[key]


def port(tp, cfg, prompt, kw, driver):
    out, stats = Decoder(tp, cfg, DecodeConfig(**kw, **DRIVERS[driver]),
                         device="cpu").generate(None, prompt)
    return out.numpy(), stats


def assert_same_decode(got, want, exact_fwd=True):
    (out, st), (wout, wst) = got, want
    np.testing.assert_array_equal(out, wout)
    assert st.steps == wst.steps
    if exact_fwd:
        assert st.forward_equivalents == wst.forward_equivalents
    else:
        assert st.forward_equivalents == pytest.approx(
            wst.forward_equivalents, rel=1e-6)
    assert st.revocations == wst.revocations
    assert st.skipped_forwards == wst.skipped_forwards
    assert st.tokens_generated == wst.tokens_generated


# --------------------------------------------------------------------------
# parity: every case, policy and driver against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("driver", sorted(DRIVERS))
@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_carry_strategy_matches_reference(weights, prompt, case, policy,
                                          driver):
    jp, tp = weights
    kw = {**BASE, **CASES[case], **POLICIES[policy]}
    got = port(tp, CFG, prompt, kw, driver)
    want = reference(jp, JCFG, prompt, kw)
    assert_same_decode(got, want)
    assert (got[0][:, 16:] != CFG.mask_token_id).all()
    if case == "wino_r_revoke":
        assert got[1].revocations > 0
    if case == "extrapolate_skip":
        assert got[1].skipped_forwards > 0


@pytest.mark.parametrize("policy", ["prefix", "dual"])
@pytest.mark.parametrize("case", ["wino_r_revoke", "extrapolate_skip"])
def test_carry_strategy_matches_reference_fused_drivers(weights, prompt,
                                                        case, policy):
    """The reference's default (whole-request fused) driver: its f32 sum
    of window-scaled forwards agrees to rel 1e-6."""
    jp, tp = weights
    kw = {**BASE, **CASES[case], **POLICIES[policy]}
    assert_same_decode(port(tp, CFG, prompt, kw, "request"),
                       reference(jp, JCFG, prompt, kw, fused=True),
                       exact_fwd=False)


@pytest.mark.parametrize("driver", sorted(DRIVERS))
@pytest.mark.parametrize("case", ["wino_r_revoke", "extrapolate_skip"])
def test_hymba_carry_strategy_matches_reference(hymba_weights, prompt,
                                                case, driver):
    jp, tp = hymba_weights
    kw = {**BASE, **CASES[case]}
    assert_same_decode(port(tp, HCFG, prompt, kw, driver),
                       reference(jp, HJCFG, prompt, kw))


# --------------------------------------------------------------------------
# accounting and geometry (the reference's tests/test_carry_strategies.py)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_extrapolate_steps_are_forwards_plus_skips(weights, prompt, driver):
    """Plain path: every step pays one forward or skips one."""
    kw = {**BASE, **CASES["extrapolate_skip"]}
    _, st = port(weights[1], CFG, prompt, kw, driver)
    assert st.skipped_forwards > 0
    assert st.steps == st.forward_equivalents + st.skipped_forwards


def test_extrapolate_never_skipping_is_probability(weights, prompt):
    """With an unreachable threshold the strategy is confidence decoding:
    probability's tokens and counts, no skip."""
    out_e, s_e = port(weights[1], CFG, prompt,
                      {**BASE, "strategy": "extrapolate",
                       "extrap_tau": 1.1}, "request")
    out_p, s_p = port(weights[1], CFG, prompt,
                      {**BASE, "strategy": "probability"}, "request")
    np.testing.assert_array_equal(out_e, out_p)
    assert s_e.skipped_forwards == 0
    assert (s_e.steps, s_e.forward_equivalents) == \
        (s_p.steps, s_p.forward_equivalents)


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_wino_r_zero_budget_never_revokes(weights, prompt, driver):
    jp, tp = weights
    kw = {**BASE, "strategy": "wino_r", "wino_revoke_tau": 0.99,
          "wino_revoke_budget": 0}
    got = port(tp, CFG, prompt, kw, driver)
    assert_same_decode(got, reference(jp, JCFG, prompt, kw))
    assert got[1].revocations == 0
    assert got[1].steps == BASE["steps"]
    assert got[1].forward_equivalents == got[1].steps


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_wino_r_schedule_overrun_stops_where_the_reference_stops(
        weights, driver):
    """Revocations push blocks past their schedule rows (padded with the
    final width): every block must stop at the reference's step, which
    the traces' per-step block indices show."""
    jp, tp = weights
    prompt = np.full((2, 6), 2, np.int32)
    kw = dict(gen_length=16, block_size=4, steps=10, strategy="wino_r",
              trace=True, **REVOKE_KNOBS)
    got = port(tp, CFG, prompt, kw, driver)
    want = reference(jp, JCFG, prompt, kw)
    assert_same_decode(got, want)
    np.testing.assert_array_equal(got[1].trace.block, want[1].trace.block)
    per_block = np.bincount(got[1].trace.block, minlength=4)
    assert got[1].revocations > 0
    assert got[1].steps > kw["steps"] and got[1].steps < 4 * 4 * 4
    # a block overran its budget (10 steps over 4 blocks: 3, 3, 2, 2)
    assert (per_block > np.array([3, 3, 2, 2])).any()
    assert (got[0][:, 6:] != CFG.mask_token_id).all()


@pytest.mark.parametrize("name", ["wino_r", "extrapolate", "traced"])
def test_shapeless_init_carry_raises(name):
    """A positional carry needs the canvas shape: the shape-less
    ``init_carry`` refuses; ``init_carry_shaped`` builds it."""
    strat = tracing(resolve_strategy("probability")) if name == "traced" \
        else resolve_strategy(name)
    dcfg = DecodeConfig(**BASE)
    with pytest.raises(TypeError, match="per-"):
        strat.init_carry(CFG, dcfg, "cpu")
    pos, glob = strat.init_carry_shaped(CFG, dcfg, 2, 48, "cpu")
    assert strat.positional_carry
    for t in tree_leaves(pos):
        assert t.shape[:2] == (2, 48)


def test_nested_carry_window_round_trip():
    """``carry_window`` walks a nested positional tree (the traced carry's
    shape) and gives views, so a write into the window lands in the
    carry; ``carry_unwindow`` writes a window back into new tensors."""
    strat = tracing(resolve_strategy("wino_r"))
    carry = strat.init_carry_shaped(CFG, DecodeConfig(**BASE), 2, 48, "cpu")
    (ipos, pos_t), glob = carry
    win = carry_window(strat, carry, 16, 8)
    (wpos, wpos_t), wglob = win
    assert wglob is glob
    assert wpos[0].shape == (2, 8) and wpos_t[1].shape == (2, 8)
    write(win[0], (((torch.ones(2, 8, dtype=torch.bool),),
                    (torch.full((2, 8), 7, dtype=torch.int32),
                     torch.full((2, 8), 0.5)))))
    assert ipos[0][:, 16:24].all() and not ipos[0][:, :16].any()
    assert (pos_t[0][:, 16:24] == 7).all() and (pos_t[0][:, 24:] == -1).all()
    assert (pos_t[1][:, 16:24] == 0.5).all()
    fresh = strat.init_carry_shaped(CFG, DecodeConfig(**BASE), 2, 48, "cpu")
    back = carry_unwindow(strat, fresh, win, 16)
    (bpos, bpos_t), bglob = back
    assert bglob is glob
    assert torch.equal(bpos[0], ipos[0]) and torch.equal(bpos_t[0],
                                                         pos_t[0])
    assert not fresh[0][0][0].any()          # written into new tensors


# --------------------------------------------------------------------------
# the registry surface
# --------------------------------------------------------------------------

def test_registry_lists_and_resolves_the_carry_strategies():
    names = available_strategies()
    assert {"wino_r", "extrapolate", "fdm", "fdm_a"} <= set(names)
    assert resolve_strategy("wino_r").name == "wino_r"
    assert resolve_strategy("extrapolate").supports_fused
    assert as_strategy("wino_r") is resolve_strategy("wino_r")
    with pytest.raises(KeyError, match="unknown strategy"):
        resolve_strategy("no-such-strategy")
    with pytest.raises(TypeError):
        as_strategy(3)


def test_register_strategy_decorator_forms():
    @register_strategy
    class Mine(Strategy):
        name = "test-mine"

    @register_strategy(name="test-alias")
    class Other(Strategy):
        name = "test-other"
    try:
        assert isinstance(resolve_strategy("test-mine"), Mine)
        assert isinstance(resolve_strategy("test-alias"), Other)
        with pytest.raises(ValueError, match="already registered"):
            register_strategy(Mine)
        register_strategy(Mine, replace=True)
        legacy = as_strategy(lambda rng, x, *a: (x, 1))
        assert legacy.name == "<lambda>" and legacy.trace_confidence_tap
    finally:
        unregister_strategy("test-mine")
        unregister_strategy("test-alias")


def test_entry_points_load_the_port_group_and_skip_broken(monkeypatch):
    """The port loads its own group (``repro_torch.strategies``, never the
    reference's JAX strategies); a plugin that fails is skipped."""
    import importlib.metadata as md

    class Plugin(Strategy):
        name = "test-plugin"

    class EP:
        def __init__(self, name, obj):
            self.name, self._obj = name, obj

        def load(self):
            if isinstance(self._obj, Exception):
                raise self._obj
            return self._obj

    groups = []

    def entry_points(group):
        groups.append(group)
        return [EP("test-broken", ImportError("no such module")),
                EP("test-plugin", Plugin)]

    monkeypatch.setattr(md, "entry_points", entry_points)
    monkeypatch.setattr(S, "_ENTRY_POINTS_LOADED", False)
    try:
        assert isinstance(resolve_strategy("test-plugin"), Plugin)
        assert groups == ["repro_torch.strategies"]
        assert "test-broken" not in available_strategies()
    finally:
        unregister_strategy("test-plugin")


# --------------------------------------------------------------------------
# the serving engine pro-rates the carry counters
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["wino_r_revoke", "extrapolate_skip"])
def test_engine_pro_rates_carry_counters_like_reference(weights, case):
    jp, tp = weights
    kw = dict(gen_length=8, block_size=8, steps=8, **CASES[case])
    prompts = [np.full((6,), 3 + i, np.int32) for i in range(3)]

    def serve(engine):
        rids = [engine.submit(p) for p in prompts]
        engine.run_until_idle()
        return [engine.result(r) for r in rids], engine.summary()

    got, gsum = serve(ServingEngine(tp, CFG, DecodeConfig(**kw),
                                    max_batch=4, length_bucket=8,
                                    device="cpu"))
    want, wsum = serve(JaxServingEngine(jp, JCFG, JaxDecodeConfig(**kw),
                                        max_batch=4, length_bucket=8))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.result, np.asarray(w.result))
        for key in ("steps", "forward_equivalents", "revocations",
                    "skipped_forwards"):
            assert getattr(g.stats, key) == getattr(w.stats, key), key
    key = "revocations" if case == "wino_r_revoke" else "skipped_forwards"
    assert gsum[key] == wsum[key] > 0
    assert getattr(got[0].stats, key) == pytest.approx(
        gsum[key] / len(prompts))
    assert got[0].stats.trace is None
