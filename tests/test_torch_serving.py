"""The port's ServingEngine against the reference's, on the CPU: the same
requests (mixed prompt lengths, mixed strategies, bridged weights) must
give the same results and per-request stats; bad submissions fail at the
boundary."""
import jax
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro.configs import DecodeConfig as JaxDecodeConfig
from repro.configs import get_config as jax_get_config
from repro.models.model import init_model as jax_init_model
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch.configs import DecodeConfig, get_config
from repro_torch.convert import from_jax_params
from repro_torch.serving import (CorruptOutputError, ServingEngine,
                                 validate_block_tokens)

JCFG = jax_get_config("llada-8b").reduced()
CFG = get_config("llada-8b").reduced()
BASE = dict(gen_length=16, block_size=8, steps=16, strategy="fdm")
REQUESTS = [(8, "fdm"), (6, "fdm"), (11, "probability"), (8, "fdm_a"),
            (16, "entropy"), (13, "fdm"), (8, "fdm_a")]


@pytest.fixture(scope="module")
def weights():
    jp = jax_init_model(jax.random.PRNGKey(0), JCFG)
    return jp, from_jax_params(jax.device_get(jp), device="cpu")


def _prompts():
    rs = np.random.default_rng(4)
    return [rs.integers(0, CFG.vocab_size - 1, n).astype(np.int32)
            for n, _ in REQUESTS]


def _serve(engine):
    rids = [engine.submit(p, strategy=s)
            for p, (_, s) in zip(_prompts(), REQUESTS)]
    engine.run_until_idle()
    return [engine.result(r) for r in rids]


def test_engine_matches_reference(weights):
    jp, tp = weights
    jengine = JaxServingEngine(jp, JCFG, JaxDecodeConfig(**BASE),
                               max_batch=2, length_bucket=8)
    want = _serve(jengine)
    batches = []
    engine = ServingEngine(tp, CFG, DecodeConfig(**BASE), max_batch=2,
                           length_bucket=8, device="cpu",
                           on_block_committed=lambda reqs, blk, *_:
                           batches.append([r.rid for r in reqs]))
    got = _serve(engine)
    assert len(batches) > 3          # several buckets and strategies
    for g, w in zip(got, want):
        assert g.status == w.status == "done"
        np.testing.assert_array_equal(g.result, np.asarray(w.result))
        assert g.pad_cols == w.pad_cols
        for key in ("steps", "forward_equivalents", "tokens_generated",
                    "phase_counts"):
            assert getattr(g.stats, key) == getattr(w.stats, key), key
        assert (g.result[-BASE["gen_length"]:] != CFG.mask_token_id).all()
    assert any(r.pad_cols for r in got)        # left padding exercised
    s = engine.summary()
    assert set(s) == set(jengine.summary())
    assert s["requests"] == len(REQUESTS)
    assert s["forward_equivalents"] == sum(r.stats.forward_equivalents
                                           for r in want)


def test_phase_counts_are_per_row_shares(weights):
    _, tp = weights
    engine = ServingEngine(tp, CFG, DecodeConfig(**BASE), max_batch=3,
                           device="cpu")
    rid = engine.submit(_prompts()[0], strategy="fdm_a")
    engine.run_until_idle()
    st = engine.result(rid).stats
    assert sum(st.phase_counts.values()) == pytest.approx(st.steps)


def test_submit_validates_at_the_boundary(weights):
    _, tp = weights
    engine = ServingEngine(tp, CFG, DecodeConfig(**BASE), max_batch=2,
                           device="cpu")
    prompt = np.full((6,), 3, np.int32)
    with pytest.raises(KeyError, match="unknown strategy"):
        engine.submit(prompt, strategy="nope")
    with pytest.raises(ValueError, match="not a multiple"):
        engine.submit(prompt, gen_length=12, block_size=8)
    with pytest.raises(ValueError, match="infeasible"):
        engine.submit(prompt, steps=1)
    with pytest.raises(ValueError, match="positive"):
        engine.submit(prompt, block_size=0)
    with pytest.raises(ValueError, match="positive"):
        engine.submit(prompt, gen_length=-8)
    with pytest.raises(CorruptOutputError):
        engine.submit(np.array([3, CFG.vocab_size], np.int32))
    with pytest.raises(ValueError, match="1-d"):
        engine.submit(np.zeros((2, 3), np.int32))
    assert engine.queue_depth == 0
    engine.submit(prompt, cache_policy="prefix")       # ported: it queues
    assert engine.queue_depth == 1
    assert engine.queue[0].dcfg.cache_policy == "prefix"
    # trace and wino_r are ported too: they queue, and decode as the
    # reference's engine does, each traced request with its own row
    engine.queue.clear()
    jp, _ = weights
    jengine = JaxServingEngine(jp, JCFG, JaxDecodeConfig(**BASE),
                               max_batch=2)
    short = prompt[:4]
    rids = []
    for eng in (engine, jengine):
        rids.append([eng.submit(prompt, trace=True),
                     eng.submit(short, trace=True),
                     eng.submit(prompt, strategy="wino_r")])
        eng.run_until_idle()
    for rid, jrid, p in zip(*rids, (prompt, short, prompt)):
        got, want = engine.result(rid), jengine.result(jrid)
        np.testing.assert_array_equal(got.result, np.asarray(want.result))
        assert (got.stats.steps, got.stats.revocations) == \
            (want.stats.steps, want.stats.revocations)
        if got.stats.trace is None:
            assert want.stats.trace is None
            continue
        np.testing.assert_array_equal(got.stats.trace.commit_step,
                                      want.stats.trace.commit_step)
        assert got.stats.trace.commit_step.shape == (1, len(p) + 16)
        assert got.stats.trace.commit_histogram().sum() == 16


def test_output_validator():
    validate_block_tokens(np.array([[0, 511]]), 512)
    with pytest.raises(CorruptOutputError, match="out-of-vocab"):
        validate_block_tokens(np.array([[0, 512]]), 512)
    with pytest.raises(CorruptOutputError):
        validate_block_tokens(np.array([-1]), 512)


HJCFG = jax_get_config("hymba-1.5b").reduced()
HCFG = get_config("hymba-1.5b").reduced()


@pytest.fixture(scope="module")
def hymba_weights():
    jp = jax_init_model(jax.random.PRNGKey(2), HJCFG)
    return jp, from_jax_params(jax.device_get(jp), device="cpu")


def test_hybrid_engine_matches_reference(hymba_weights):
    """The slice's path end to end: Hymba behind the engine, mixed prompt
    lengths and strategies, against the reference engine."""
    jp, tp = hymba_weights
    reqs = REQUESTS[:4]
    prompts = _prompts()[:4]

    def serve(engine):
        rids = [engine.submit(p, strategy=s)
                for p, (_, s) in zip(prompts, reqs)]
        engine.run_until_idle()
        return [engine.result(r) for r in rids]

    want = serve(JaxServingEngine(jp, HJCFG, JaxDecodeConfig(**BASE),
                                  max_batch=2, length_bucket=8))
    got = serve(ServingEngine(tp, HCFG, DecodeConfig(**BASE), max_batch=2,
                              length_bucket=8, device="cpu"))
    for g, w in zip(got, want):
        assert g.status == w.status == "done"
        np.testing.assert_array_equal(g.result, np.asarray(w.result))
        for key in ("steps", "forward_equivalents", "phase_counts"):
            assert getattr(g.stats, key) == getattr(w.stats, key), key


@pytest.mark.parametrize("policy", ["prefix", "dual"])
def test_submit_refuses_cache_policy_on_hybrid(hymba_weights, policy):
    """As the reference's engine: ValueError (a 400), not 'not ported'."""
    jp, tp = hymba_weights
    prompt = np.full((6,), 3, np.int32)
    jengine = JaxServingEngine(jp, HJCFG, JaxDecodeConfig(**BASE))
    with pytest.raises(ValueError, match="recurrent state"):
        jengine.submit(prompt, cache_policy=policy)
    engine = ServingEngine(tp, HCFG, DecodeConfig(**BASE), device="cpu")
    with pytest.raises(ValueError, match="recurrent state"):
        engine.submit(prompt, cache_policy=policy)
    assert engine.queue_depth == 0
