"""The port's three decode drivers against each other and the reference's,
on the CPU, and the runner cache that keeps the graph drivers' state.

The drivers (``core/loop.py``): eager (``fused_loop=False``), per-block
graph (``fused_blocks=False``) and whole-request graph (the default).  On
the CPU the graph drivers run their step functions as plain calls, so the
same driver code as on the card decodes here; all three must give the
same tokens, steps, forward-equivalents (to the last bit: the graph
drivers sum in float64 in the eager driver's order) and FDM-A phase
counts, ``random`` included (on the CPU every driver draws the same
stream).  ``test_torch_decode.py`` and ``test_torch_cache_decode.py``
already hold the default driver against the reference's; here only the
cached whole-request driver meets the reference's ``drive_request_cached``
again, for the FDM-A case that takes both branches of its search skip.
"""
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_decode import BASE, CASES, prompt, weights  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

from repro.configs import DecodeConfig as JaxDecodeConfig
from repro.configs import get_config as jax_get_config
from repro.core import Decoder as JaxDecoder
from repro_torch.configs import DecodeConfig, get_config
from repro_torch.core import (Decoder, RunnerCache, Strategy,
                              decode_cache_info, decode_cache_scope,
                              reset_decode_cache_stats, resolve_strategy)
from repro_torch.core.graphs import run_masked
from repro_torch.models import init_model

JCFG = jax_get_config("llada-8b").reduced()
CFG = get_config("llada-8b").reduced()
DRIVERS = {"eager": dict(fused_loop=False),
           "block": dict(fused_blocks=False),
           "request": {}}
POLICIES = {"none": {}, "prefix": dict(cache_policy="prefix"),
            "dual": dict(cache_policy="dual")}
DRIVER_CASES = ["probability", "eb", "wino", "fdm", "fdm_search",
                "fdm_a_phases", "random"]


def _case(name):
    return CASES.get(name, dict(strategy=name))


def _decode(tp, prompt, kw, driver, seed=None):
    dcfg = DecodeConfig(**kw, **DRIVERS[driver])
    rng = None if seed is None else torch.Generator().manual_seed(seed)
    return Decoder(tp, CFG, dcfg, device="cpu").generate(rng, prompt)


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("case", DRIVER_CASES)
def test_three_drivers_decode_alike(weights, prompt, case, policy):
    _, tp = weights
    kw = {**BASE, **_case(case), **POLICIES[policy]}
    seed = 11 if case == "random" else None
    runs = {d: _decode(tp, prompt, kw, d, seed) for d in DRIVERS}
    out, st = runs["eager"]
    assert (out[:, 16:] != CFG.mask_token_id).all()
    for driver in ("block", "request"):
        got, gst = runs[driver]
        assert torch.equal(got, out), driver
        assert gst.steps == st.steps, driver
        assert gst.forward_equivalents == st.forward_equivalents, driver
        assert gst.phase_counts == st.phase_counts, driver
        assert gst.tokens_generated == st.tokens_generated
    if case == "fdm_a_phases":
        assert st.phase_counts["explore"] > 0 and st.phase_counts["accel"] > 0


@pytest.mark.parametrize("policy", ["prefix", "dual"])
def test_whole_request_cached_driver_matches_reference(weights, prompt,
                                                       policy):
    """The port's whole-request cached decode (the default flags) against
    the reference's ``drive_request_cached`` (its default flags): tokens,
    steps and phase counts exact; forward-equivalents to rel 1e-6 (the
    reference sums them in float32)."""
    jp, tp = weights
    kw = {**BASE, **CASES["fdm_a_phases"], **POLICIES[policy]}
    want, wst = JaxDecoder(jp, JCFG, JaxDecodeConfig(**kw)).generate(
        jax.random.PRNGKey(0), jnp.asarray(prompt))
    got, gst = _decode(tp, prompt, kw, "request")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert gst.steps == wst.steps
    assert gst.phase_counts == wst.phase_counts
    assert gst.forward_equivalents == pytest.approx(wst.forward_equivalents,
                                                    rel=1e-6)


def test_events_and_callbacks_agree_across_drivers(weights, prompt):
    """``on_block_committed`` fires once per block, in order, with the
    canvas as it stood after the block, under every driver."""
    _, tp = weights
    kw = {**BASE, **POLICIES["dual"], "strategy": "probability"}
    seen = {}
    for driver in DRIVERS:
        calls = []
        Decoder(tp, CFG, DecodeConfig(**kw, **DRIVERS[driver]),
                device="cpu").generate(None, prompt, on_block_committed=(
                    lambda blk, lo, hi, x, _c=calls: _c.append(
                        (blk, lo, hi, x))))
        seen[driver] = calls
    assert [c[:3] for c in seen["eager"]] == [
        (b, 16 + 8 * b, 24 + 8 * b) for b in range(4)]
    for driver in ("block", "request"):
        assert [c[:3] for c in seen[driver]] == [c[:3] for c in
                                                  seen["eager"]]
        for (*_, x), (*_, want) in zip(seen[driver], seen["eager"]):
            assert torch.equal(x, want)


class CountingStrategy(Strategy):
    """``probability`` with a count of ``begin_block`` calls."""

    name = "counting"

    def __init__(self):
        self.inner = resolve_strategy("probability")
        self.blocks = []

    def begin_block(self, carry, x, in_block):
        self.blocks.append(int(in_block.sum()))
        return carry

    def step(self, rng, carry, x, active, model_fn, cfg, dcfg, n):
        return self.inner.step(rng, carry, x, active, model_fn, cfg, dcfg,
                               n)


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_begin_block_fires_once_per_block(weights, prompt, driver, policy):
    _, tp = weights
    strat = CountingStrategy()
    kw = {**BASE, **POLICIES[policy]}
    for _ in range(2):               # the second decode reuses the run
        Decoder(tp, CFG, DecodeConfig(**kw, **DRIVERS[driver]),
                device="cpu").generate(None, prompt, strategy=strat)
    assert strat.blocks == [8] * 8


@pytest.mark.parametrize("case", ["probability", "fdm_a_accel"])
def test_graph_driver_runs_no_step_past_a_seen_end(weights, prompt, case):
    """On the CPU every replay has run when the host polls, so a block
    whose steps the host sees end replays no further: the step graph runs
    exactly the decode's steps, whether its blocks keep to their budgets
    (probability) or end inside them (FDM-A accelerating in every step,
    n_max tokens a step)."""
    _, tp = weights
    kw = {**BASE, **(dict(strategy="fdm_a", eta1=0.0, eta2=0.0, n_max=4)
                     if case == "fdm_a_accel" else dict(strategy=case))}
    with decode_cache_scope() as cache:
        _, st = _decode(tp, prompt, kw, "request")
        (run,) = cache.values()
    assert run.graphs.replays() == st.steps
    assert st.steps == (8 if case == "fdm_a_accel" else 20)


@pytest.mark.parametrize("pred", [False, True])
def test_run_masked_on_the_cpu_is_a_host_branch(pred):
    """On the CPU the body runs (and draws) only where the predicate
    holds, as the eager driver's host branch does."""
    ran = []
    out = (torch.zeros(3), [torch.zeros((), dtype=torch.int32)])

    def fn():
        ran.append(1)
        return torch.ones(3), [torch.full((), 7, dtype=torch.int32)]
    run_masked(torch.tensor(pred), fn, out)
    assert ran == ([1] if pred else [])
    assert torch.equal(out[0], torch.full((3,), float(pred)))
    assert int(out[1][0]) == (7 if pred else 0)


# --------------------------------------------------------------------------
# the runner cache (the reference's tests/test_decoder.py cache tests)
# --------------------------------------------------------------------------

SMALL = dict(gen_length=8, block_size=8, steps=8)
PROMPT = np.full((1, 4), 2, np.int32)


def _params(seed):
    return init_model(CFG, torch.Generator().manual_seed(seed),
                      device="cpu")


def test_repeat_decode_builds_nothing(weights):
    """A second decode with the same weights, even through a new
    Decoder, is all hits, in the plain and the cached path."""
    _, tp = weights
    with decode_cache_scope():
        for policy in ("none", "prefix"):
            Decoder(tp, CFG, DecodeConfig(**SMALL, cache_policy=policy),
                    device="cpu").generate(None, PROMPT)
        before = decode_cache_info()
        for policy in ("none", "prefix"):
            Decoder(tp, CFG, DecodeConfig(**SMALL, cache_policy=policy),
                    device="cpu").generate(1, PROMPT)
        after = decode_cache_info()
        assert after.misses == before.misses == 2
        assert after.hits == before.hits + 2
        assert after.captures == 0          # no graphs on the CPU
        # the per-block driver shares the whole-request driver's run
        Decoder(tp, CFG, DecodeConfig(**SMALL, fused_blocks=False),
                device="cpu").generate(None, PROMPT)
        assert decode_cache_info().misses == 2
        # an eager decode never touches the cache
        Decoder(tp, CFG, DecodeConfig(**SMALL, fused_loop=False),
                device="cpu").generate(None, PROMPT)
        assert decode_cache_info().hits == after.hits + 1


def test_cache_stats_reset_keeps_runners(weights):
    _, tp = weights
    with decode_cache_scope():
        Decoder(tp, CFG, DecodeConfig(**SMALL), device="cpu").generate(
            None, PROMPT)
        reset_decode_cache_stats()
        zeroed = decode_cache_info()
        assert (zeroed.hits, zeroed.misses, zeroed.captures) == (0, 0, 0)
        assert zeroed.runners == 1
        Decoder(tp, CFG, DecodeConfig(**SMALL), device="cpu").generate(
            None, PROMPT)
        assert decode_cache_info().hits == 1
        assert decode_cache_info().misses == 0


def test_cache_scope_restores_previous_cache(weights):
    _, tp = weights
    outer = decode_cache_info()
    with decode_cache_scope() as scoped:
        Decoder(tp, CFG, DecodeConfig(**SMALL), device="cpu").generate(
            None, PROMPT)
        assert scoped.info().misses == 1
    assert decode_cache_info() == outer


def test_cache_entry_evicted_when_params_dropped():
    cache = RunnerCache()
    dcfg = DecodeConfig(**SMALL)
    p1 = _params(1)
    Decoder(p1, CFG, dcfg, device="cpu", cache=cache).generate(None, PROMPT)
    assert cache.info().entries == 1
    del p1
    gc.collect()
    assert cache.info().entries == 0, "dropped params still cached"
    p2 = _params(2)
    Decoder(p2, CFG, dcfg, device="cpu", cache=cache).generate(None, PROMPT)
    assert cache.info().entries == 1


def test_cache_evicts_when_any_params_tensor_dies():
    """The key is every tensor's id; a dead non-first tensor evicts the
    entry (a recycled id must never alias it), and the survivors'
    finalizers are detached."""
    cache = RunnerCache()
    p1 = _params(1)
    first = p1["embed"]["tok"]               # noqa: F841 — kept alive
    Decoder(p1, CFG, DecodeConfig(**SMALL), device="cpu",
            cache=cache).generate(None, PROMPT)
    assert cache.info().entries == 1
    p1["blocks"][1]["mlp"]["up"] = p1["blocks"][1]["mlp"]["up"].clone()
    gc.collect()
    assert cache.info().entries == 0
    del p1, first
    gc.collect()
    assert cache.info().entries == 0


def test_cache_evicts_model_fn_entries(weights):
    _, tp = weights
    from repro_torch.models import forward
    cache = RunnerCache()

    def mf(t):
        return forward(tp, t, CFG)
    Decoder(mf, CFG, DecodeConfig(**SMALL), device="cpu",
            cache=cache).generate(None, PROMPT)
    assert cache.info().entries == 1
    del mf
    gc.collect()
    assert cache.info().entries == 0


def test_interleaved_decodes_of_one_key_raise(weights, prompt):
    """Two interleaved decodes of one key raise nothing: the second finds
    the first's run held and gets a run of its own, each decodes what it
    would alone, and the cache keeps both runs for later decodes."""
    _, tp = weights
    with decode_cache_scope() as cache:
        dec = Decoder(tp, CFG, DecodeConfig(**BASE, strategy="probability"),
                      device="cpu")
        want, wst = dec.generate(None, prompt)
        first = dec.generate_blocks(None, prompt)
        next(first)
        got, gst = dec.generate(None, prompt)
        with pytest.raises(StopIteration) as fin:
            while True:
                next(first)
        out, st = fin.value.value
        for x, stats in ((got, gst), (out, st)):
            assert torch.equal(x, want)
            assert (stats.steps, stats.forward_equivalents) == (
                wst.steps, wst.forward_equivalents)
        assert (cache.info().runners, cache.info().misses) == (2, 2)
        dec.generate(None, prompt)
        assert cache.info().misses == 2


def test_abandoned_decode_frees_its_run(weights, prompt):
    """A ``generate_blocks`` generator dropped halfway lets go of its run:
    the next decode of the key reuses it and decodes as if alone."""
    _, tp = weights
    with decode_cache_scope() as cache:
        dec = Decoder(tp, CFG, DecodeConfig(**BASE, strategy="probability"),
                      device="cpu")
        blocks = dec.generate_blocks(None, prompt)
        next(blocks)
        del blocks
        gc.collect()
        got, _ = dec.generate(None, prompt)
        assert (cache.info().runners, cache.info().misses) == (1, 1)
        want, _ = Decoder(tp, CFG, DecodeConfig(
            **BASE, strategy="probability", fused_loop=False),
            device="cpu").generate(None, prompt)
        assert torch.equal(got, want)


def test_cache_keeps_at_most_max_runners_per_weights(weights):
    """Each prompt length is a key of its own; past ``max_runners`` runs
    the least recently used key's run goes."""
    _, tp = weights
    cache = RunnerCache(max_runners=2)
    seen = []
    for lp in (3, 4, 5, 4, 3, 4):
        Decoder(tp, CFG, DecodeConfig(**SMALL), device="cpu",
                cache=cache).generate(None, np.full((1, lp), 2, np.int32))
        info = cache.info()
        seen.append((info.runners, info.hits, info.misses))
    # 3, 4 built; 5 evicts 3; 4 hits; 3 evicts 5 (4 was used later); 4 hits
    assert seen == [(1, 0, 1), (2, 0, 2), (2, 0, 3), (2, 1, 3), (2, 1, 4),
                    (2, 2, 4)]
    with pytest.raises(ValueError, match="max_runners"):
        RunnerCache(max_runners=0)


@pytest.mark.parametrize("policy", ["prefix", "dual"])
def test_cached_runs_do_not_pin_the_weights(policy):
    """A cached run keeps the K/V it captured, never the params (a decode
    passes them in), so the entry goes when they do."""
    cache = RunnerCache()
    p1 = _params(1)
    Decoder(p1, CFG, DecodeConfig(**SMALL, cache_policy=policy),
            device="cpu", cache=cache).generate(None, PROMPT)
    assert cache.info().runners == 1
    del p1
    gc.collect()
    assert cache.info().entries == 0
