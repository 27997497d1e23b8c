"""The port's cached decoding (``cache_policy`` ``prefix`` and ``dual``)
against the reference's, on the CPU, end to end: every strategy case of
``test_torch_decode.py`` under both policies, ``prefix`` without block
refreshes, the engine, and the refresh hooks.

Tokens, steps and phase counts must be equal.  Forward-equivalents: the
reference's default (fused) drivers sum each windowed step's
``forwards · window/total`` in float32, its host driver and the port in
Python floats, so against the fused drivers they agree to rel 1e-6 (as
the reference's own ``tests/test_kv_cache.py`` compares its drivers) and
against the host driver exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_decode import BASE, CASES
from torch_threads import one_torch_thread  # noqa: F401

from repro.configs import DecodeConfig as JaxDecodeConfig
from repro.configs import get_config as jax_get_config
from repro.core import Decoder as JaxDecoder
from repro.models.model import init_model as jax_init_model
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch.configs import DecodeConfig, get_config
from repro_torch.convert import from_jax_params
from repro_torch.core import Decoder
from repro_torch.serving import ServingEngine

JCFG = jax_get_config("llada-8b").reduced()
CFG = get_config("llada-8b").reduced()
POLICIES = {"prefix": dict(cache_policy="prefix"),
            "dual": dict(cache_policy="dual"),
            "prefix_off": dict(cache_policy="prefix", cache_refresh="off")}


@pytest.fixture(scope="module")
def weights():
    jp = jax_init_model(jax.random.PRNGKey(0), JCFG)
    return jp, from_jax_params(jax.device_get(jp), device="cpu")


@pytest.fixture(scope="module")
def prompt():
    return np.random.default_rng(0).integers(
        0, CFG.vocab_size - 1, (2, 16)).astype(np.int32)


def _both(weights, prompt, kw, **jax_over):
    jp, tp = weights
    want, wstats = JaxDecoder(
        jp, JCFG, JaxDecodeConfig(**kw, **jax_over)).generate(
        jax.random.PRNGKey(0), jnp.asarray(prompt))
    got, gstats = Decoder(tp, CFG, DecodeConfig(**kw),
                          device="cpu").generate(None, prompt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert gstats.steps == wstats.steps
    assert gstats.phase_counts == wstats.phase_counts
    assert gstats.tokens_generated == wstats.tokens_generated
    assert (got[:, 16:] != CFG.mask_token_id).all()
    return gstats, wstats


@pytest.mark.parametrize("policy", ["prefix", "dual"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_cached_decode_matches_reference(weights, prompt, case, policy):
    kw = {**BASE, **CASES[case], **POLICIES[policy]}
    gstats, wstats = _both(weights, prompt, kw)
    assert gstats.forward_equivalents == pytest.approx(
        wstats.forward_equivalents, rel=1e-6)
    if case == "fdm_a_phases":
        # under dual the window's scores differ, and local_only never
        # occurs at this seed; the search phases do under both policies
        assert gstats.phase_counts["explore"] > 0
        assert gstats.phase_counts["balance"] > 0
        assert gstats.phase_counts["accel"] > 0


@pytest.mark.parametrize("case", ["probability", "fdm_search",
                                  "fdm_a_phases"])
def test_prefix_without_refresh_matches_reference(weights, prompt, case):
    kw = {**BASE, **CASES[case], **POLICIES["prefix_off"]}
    gstats, wstats = _both(weights, prompt, kw)
    assert gstats.forward_equivalents == pytest.approx(
        wstats.forward_equivalents, rel=1e-6)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_cached_decode_matches_reference_host_driver_exactly(
        weights, prompt, policy):
    """The reference's host step loop sums forward-equivalents in Python
    floats, in the port's order: equal to the last bit."""
    kw = {**BASE, **CASES["fdm_search"], **POLICIES[policy]}
    gstats, wstats = _both(weights, prompt, kw, fused_loop=False)
    assert gstats.forward_equivalents == wstats.forward_equivalents


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_forward_equivalents_of_the_policies(weights, prompt, policy):
    """probability at gen 32, block 8, 32 steps over a 48-token canvas:
    32 windowed steps at window/total plus one forward per refresh."""
    kw = {**BASE, **POLICIES[policy], "strategy": "probability",
          "steps": 32}
    _, st = Decoder(weights[1], CFG, DecodeConfig(**kw),
                    device="cpu").generate(None, prompt)
    want = {"prefix": 32 * 32 / 48 + 4, "dual": 32 * 8 / 48 + 4,
            "prefix_off": 32 * 32 / 48 + 1}[policy]
    assert st.steps == 32
    assert st.forward_equivalents == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("policy", ["prefix", "dual"])
def test_random_strategy_under_a_cache(weights, prompt, policy):
    """``random`` draws from its own generator, so against the reference
    only what the draw cannot move is compared: steps and
    forward-equivalents; every generated token is committed."""
    kw = {**BASE, **POLICIES[policy], "strategy": "random"}
    _, wstats = JaxDecoder(weights[0], JCFG, JaxDecodeConfig(
        **kw, fused_loop=False)).generate(jax.random.PRNGKey(0),
                                          jnp.asarray(prompt))
    out, gstats = Decoder(weights[1], CFG, DecodeConfig(**kw),
                          device="cpu").generate(3, prompt)
    assert (out[:, 16:] != CFG.mask_token_id).all()
    assert gstats.steps == wstats.steps
    assert gstats.forward_equivalents == wstats.forward_equivalents


def test_cached_policy_needs_params():
    """The reference's ValueError, at the decode and not at construction."""
    dcfg = DecodeConfig(**BASE, cache_policy="dual")
    dec = Decoder(lambda t: t, CFG, dcfg, device="cpu")
    with pytest.raises(ValueError, match="requires a Decoder built from "
                                         "params"):
        dec.generate_blocks(None, np.zeros((1, 4), np.int32))


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_refresh_hook_fires_once_per_refresh(weights, prompt, policy):
    """``on_cache_refresh(block, t0, t1)``: the prefill as block 0, then
    every later block under ``cache_refresh="block"``, as the
    reference's blockwise driver fires it."""
    jp, tp = weights
    kw = {**BASE, **POLICIES[policy], "strategy": "probability"}
    want, got = [], []
    jdec = JaxDecoder(jp, JCFG, JaxDecodeConfig(**kw))
    jdec.on_cache_refresh = lambda blk, t0, t1: want.append(blk)
    blocks = jdec.generate_blocks(jax.random.PRNGKey(0), jnp.asarray(prompt))
    for _ in blocks:
        pass
    dec = Decoder(tp, CFG, DecodeConfig(**kw), device="cpu")
    dec.on_cache_refresh = lambda blk, t0, t1: got.append((blk, t0, t1))
    events = list(dec.generate_blocks(None, prompt))
    assert [blk for blk, _, _ in got] == want
    assert want == ([0] if policy == "prefix_off" else [0, 1, 2, 3])
    assert all(t0 <= t1 for _, t0, t1 in got)
    # every event's canvas is its own: later blocks never write into it
    for ev in events:
        assert (ev.x[:, ev.hi:] == CFG.mask_token_id).all()


SERVE_BASE = dict(gen_length=16, block_size=8, steps=16, strategy="fdm")
REQUESTS = [(8, "fdm", "dual"), (6, "fdm", "dual"),
            (11, "probability", "dual"), (8, "fdm_a", "dual"),
            (16, "entropy", "prefix"), (8, "fdm_a", "none"),
            (8, "fdm", "prefix")]


def _serve(engine, prompts):
    rids = [engine.submit(p, strategy=s, cache_policy=c)
            for p, (_, s, c) in zip(prompts, REQUESTS)]
    engine.run_until_idle()
    return [engine.result(r) for r in rids]


def test_engine_matches_reference_under_cache_policies(weights):
    """Mixed prompt lengths, strategies and cache policies behind the
    engine: the reference engine's results and per-request stats, and no
    batch mixes two policies."""
    jp, tp = weights
    rs = np.random.default_rng(4)
    prompts = [rs.integers(0, CFG.vocab_size - 1, n).astype(np.int32)
               for n, _, _ in REQUESTS]
    want = _serve(JaxServingEngine(jp, JCFG, JaxDecodeConfig(**SERVE_BASE),
                                   max_batch=2, length_bucket=8), prompts)
    batches, refreshes = [], []
    engine = ServingEngine(tp, CFG, DecodeConfig(**SERVE_BASE), max_batch=2,
                           length_bucket=8, device="cpu",
                           on_block_committed=lambda reqs, blk, *_:
                           batches.append(reqs) if blk == 0 else None)
    engine.on_cache_refresh = lambda reqs, blk, t0, t1: refreshes.append(
        (tuple(r.rid for r in reqs), blk))
    got = _serve(engine, prompts)
    for g, w in zip(got, want):
        assert g.status == w.status == "done"
        np.testing.assert_array_equal(g.result, np.asarray(w.result))
        assert g.pad_cols == w.pad_cols
        for key in ("steps", "tokens_generated", "phase_counts"):
            assert getattr(g.stats, key) == getattr(w.stats, key), key
        assert g.stats.forward_equivalents == pytest.approx(
            w.stats.forward_equivalents, rel=1e-6)
    for reqs in batches:
        assert len({r.dcfg.cache_policy for r in reqs}) == 1
    cached = [tuple(r.rid for r in reqs) for reqs in batches
              if reqs[0].dcfg.cache_policy != "none"]
    blocks = SERVE_BASE["gen_length"] // SERVE_BASE["block_size"]
    assert refreshes == [(rids, blk) for rids in cached
                         for blk in range(blocks)]


def test_submit_with_a_cache_policy_queues(weights):
    engine = ServingEngine(weights[1], CFG,
                           DecodeConfig(**SERVE_BASE), device="cpu")
    rid = engine.submit(np.full((6,), 3, np.int32), cache_policy="dual")
    assert engine.queue_depth == 1
    assert engine.queue[0].dcfg == dataclasses.replace(
        DecodeConfig(**SERVE_BASE), cache_policy="dual")
    engine.run_until_idle()
    assert engine.result(rid).status == "done"
