"""The port's on-device step telemetry (``core/tracebuffer.py``) against the
reference's, on the CPU: ``dcfg.trace`` on five strategies (fdm, fdm_a,
probability, wino_r, extrapolate) under every cache policy and on the
port's three drivers.

Tokens and stats must equal the reference host driver's, and so must the
``DecodeTrace`` fields ``commit_step``, ``commits``, ``revocations``,
``skipped``, ``phase`` and ``block``; ``commit_conf`` must agree within
1e-5, with NaN exactly where the reference has NaN.  Also: trace on
decodes as trace off (and in runs of its own), the final-commit histogram
sums to ``tokens_generated``, the wrapper is memoized and refuses a double
wrap, and the engine hands each request its own row of the trace.

The module shares ``test_torch_carry.py``'s fixtures (one model, one torch
thread).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_carry import (BASE, CASES, CFG, DRIVERS, HCFG, HJCFG,  # noqa: F401,E501
                              JCFG, POLICIES, assert_same_decode,
                              hymba_weights, one_torch_thread, port, prompt,
                              reference, weights)

from repro.configs import DecodeConfig as JaxDecodeConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch.configs import DecodeConfig
from repro_torch.core import (DecodeTrace, Decoder, TracingStrategy,
                              decode_cache_info, decode_cache_scope,
                              resolve_strategy, trace_capacity, tracing)
from repro_torch.serving import ServingEngine

TRACE_CASES = {
    "fdm": dict(strategy="fdm", gamma=0.0),
    "fdm_a": dict(strategy="fdm_a", eta1=0.025, eta2=0.02, gamma1=0.0,
                  n_max=4),
    "probability": dict(strategy="probability"),
    "wino_r": CASES["wino_r_revoke"],
    "extrapolate": CASES["extrapolate_skip"],
}
FIELDS = ("commit_step", "commits", "revocations", "skipped", "phase",
          "block")


def assert_same_trace(got: DecodeTrace, want) -> None:
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(got, field),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    conf, wconf = got.commit_conf, np.asarray(want.commit_conf)
    np.testing.assert_array_equal(np.isnan(conf), np.isnan(wconf))
    np.testing.assert_allclose(conf[~np.isnan(conf)],
                               wconf[~np.isnan(wconf)], rtol=0, atol=1e-5)


@pytest.mark.parametrize("driver", sorted(DRIVERS))
@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("case", sorted(TRACE_CASES))
def test_trace_matches_reference(weights, prompt, case, policy, driver):
    jp, tp = weights
    kw = {**BASE, **TRACE_CASES[case], **POLICIES[policy], "trace": True}
    got = port(tp, CFG, prompt, kw, driver)
    want = reference(jp, JCFG, prompt, kw)
    assert_same_decode(got, want)
    assert got[1].phase_counts == want[1].phase_counts
    assert_same_trace(got[1].trace, want[1].trace)
    trace = got[1].trace
    assert trace.commit_histogram().sum() == got[1].tokens_generated
    if case == "fdm_a":
        assert (trace.phase >= 0).all() and len(set(trace.phase)) > 1
    else:
        assert (trace.phase == -1).all()
    if case == "extrapolate":
        assert trace.skipped.sum() == got[1].skipped_forwards
    if case == "wino_r":
        assert trace.revocations.sum() == got[1].revocations > 0


@pytest.mark.parametrize("driver", sorted(DRIVERS))
@pytest.mark.parametrize("case", ["fdm_a", "extrapolate"])
def test_hymba_trace_matches_reference(hymba_weights, prompt, case, driver):
    jp, tp = hymba_weights
    kw = {**BASE, **TRACE_CASES[case], "trace": True}
    got = port(tp, HCFG, prompt, kw, driver)
    want = reference(jp, HJCFG, prompt, kw)
    assert_same_decode(got, want)
    assert_same_trace(got[1].trace, want[1].trace)


@pytest.mark.parametrize("case", sorted(TRACE_CASES))
def test_trace_on_decodes_as_trace_off(weights, prompt, case):
    """The telemetry is passive: the same tokens and stats; the traced
    decode takes runs of its own, and the untraced repeat finds its run
    again."""
    tp = weights[1]
    kw = {**BASE, **TRACE_CASES[case]}
    with decode_cache_scope():
        off = port(tp, CFG, prompt, kw, "request")
        base = decode_cache_info()
        on = port(tp, CFG, prompt, {**kw, "trace": True}, "request")
        after_on = decode_cache_info()
        off2 = port(tp, CFG, prompt, kw, "request")
        after = decode_cache_info()
    np.testing.assert_array_equal(on[0], off[0])
    np.testing.assert_array_equal(off2[0], off[0])
    for a, b in ((on[1], off[1]), (off2[1], off[1])):
        assert (a.steps, a.forward_equivalents, a.revocations,
                a.skipped_forwards, a.phase_counts) == \
            (b.steps, b.forward_equivalents, b.revocations,
             b.skipped_forwards, b.phase_counts)
    assert off[1].trace is None and on[1].trace is not None
    assert after_on.misses == base.misses + 1
    assert after.hits == after_on.hits + 1 and after.misses == \
        after_on.misses


@pytest.mark.parametrize("case", ["probability", "wino_r"])
def test_commit_histogram_sums_to_tokens_generated(weights, prompt, case):
    """Under revocation the raw per-step commits overcount; the
    final-commit histogram sums exactly to the generated tokens."""
    kw = {**BASE, **TRACE_CASES[case], "trace": True}
    _, st = port(weights[1], CFG, prompt, kw, "request")
    trace = st.trace
    hist = trace.commit_histogram()
    assert hist.sum() == st.tokens_generated
    assert hist.shape == (trace.steps,) == (st.steps,)
    assert trace.steps <= trace_capacity(DecodeConfig(**kw))
    assert (trace.commit_step >= 0).sum() == st.tokens_generated
    assert (trace.commit_step[:, :16] == -1).all()       # the prompt
    if case == "wino_r":
        assert trace.commits.sum() > hist.sum()
    summary = trace.summary()
    assert summary["tokens_committed"] == st.tokens_generated
    assert summary["revocations"] == st.revocations
    assert np.isfinite(summary["mean_commit_conf"])


def test_tracing_wrapper_memoized_and_refuses_double_wrap():
    inner = resolve_strategy("probability")
    wrapped = tracing(inner)
    assert tracing(inner) is wrapped           # one run-cache identity
    assert tracing(wrapped) is wrapped         # never wraps twice
    assert wrapped.name == "probability+trace" and wrapped.positional_carry
    with pytest.raises(TypeError, match="double-wrap"):
        TracingStrategy(wrapped)


def test_decoder_wraps_only_traced_configs(weights, prompt):
    """The decoder's strategy is the memoized wrapper under ``trace`` and
    the inner strategy otherwise (whose decodes never see it)."""
    tp = weights[1]
    dec = Decoder(tp, CFG, DecodeConfig(**BASE, trace=True), device="cpu")
    assert dec._strategy("wino_r") is tracing(resolve_strategy("wino_r"))
    dec = Decoder(tp, CFG, DecodeConfig(**BASE), device="cpu")
    assert dec._strategy("wino_r") is resolve_strategy("wino_r")


def test_engine_hands_each_request_its_row(weights):
    """Two prompts of different lengths in one traced batch: each request
    gets its row of the batch's trace with its pad columns cut, as the
    reference's engine gives it."""
    jp, tp = weights
    kw = dict(gen_length=16, block_size=8, steps=16, strategy="fdm_a",
              trace=True)
    rs = np.random.default_rng(5)
    prompts = [rs.integers(0, CFG.vocab_size - 1, n).astype(np.int32)
               for n in (6, 3)]

    def serve(engine):
        rids = [engine.submit(p) for p in prompts]
        engine.run_until_idle()
        return [engine.result(r) for r in rids]

    got = serve(ServingEngine(tp, CFG, DecodeConfig(**kw), max_batch=2,
                              device="cpu"))
    want = serve(JaxServingEngine(jp, JCFG, JaxDecodeConfig(**kw),
                                  max_batch=2))
    assert got[1].pad_cols == want[1].pad_cols > 0
    for g, w, p in zip(got, want, prompts):
        np.testing.assert_array_equal(g.result, np.asarray(w.result))
        assert_same_trace(g.stats.trace, w.stats.trace)
        assert g.stats.trace.commit_step.shape == (1, len(p) + 16)
        assert g.stats.trace.commit_histogram().sum() == 16
