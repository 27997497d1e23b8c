"""The trained-weight gate: the port decodes like the reference on weights
the reference trained, on the CPU.

Random weights keep every max-probability near 1/V, so FDM finds nothing
above γ and FDM-A never leaves exploration (PERF.md §4).  Here a module
fixture trains the ``sum`` testbed with the reference's ``train`` (150
steps of batch 32, as ``tests/test_system.py`` does), and the port
decodes its held-out prompts from the converted weights: tokens, steps,
forward-equivalents and FDM-A's phase counts must equal the reference's
host driver's exactly, for ``fdm``, ``fdm_a``, ``probability`` and ``eb``
under ``none``, ``prefix`` and ``dual`` on the port's eager driver, and
for one case per policy on its graph driver (the default, whose graphs
are plain calls on the CPU); and ``wino_r`` and ``extrapolate`` at their
default knobs (with ``revocations`` and ``skipped_forwards``) on both.  FDM-A must take a step that skips the
search (acceleration or local-only), which random weights never reach.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro.configs import DecodeConfig as JaxDecodeConfig
from repro.configs import TrainConfig as JaxTrainConfig
from repro.configs import get_config as jax_get_config
from repro.core import Decoder as JaxDecoder
from repro.data import CharTokenizer, TaskDataset
from repro.training import train as jax_train
from repro_torch.configs import DecodeConfig, get_config
from repro_torch.convert import from_jax_params
from repro_torch.core import Decoder

JCFG = jax_get_config("llada-8b").reduced()
CFG = get_config("llada-8b").reduced()
STRATEGIES = ["fdm", "fdm_a", "probability", "eb"]
POLICIES = ["none", "prefix", "dual"]
EVAL_ROWS = 16


@pytest.fixture(scope="module")
def trained():
    ds = TaskDataset("sum", CharTokenizer(JCFG.vocab_size))
    tcfg = JaxTrainConfig(batch_size=32, seq_len=ds.seq_len, steps=150,
                          log_every=1000)
    jp, history = jax_train(JCFG, tcfg, ds.batches(tcfg.batch_size),
                            log=None)
    assert history["loss"][-1] < history["loss"][0] * 0.7
    batch = ds.eval_batch(EVAL_ROWS)
    prompt = np.asarray(ds.prompts_only(batch), np.int32)
    gen = ds.seq_len - prompt.shape[1]             # the answer and EOS
    return jp, from_jax_params(jax.device_get(jp), device="cpu"), prompt, gen


@pytest.fixture(scope="module")
def reference(trained):
    """The reference's host-driver decodes, one per (strategy, policy),
    made on first use."""
    jp, _, prompt, gen = trained
    cache = {}

    def get(strategy, policy):
        if (strategy, policy) not in cache:
            out, st = JaxDecoder(jp, JCFG, JaxDecodeConfig(
                **_kw(strategy, policy, gen), fused_loop=False)).generate(
                jax.random.PRNGKey(0), jnp.asarray(prompt))
            cache[strategy, policy] = (np.asarray(out), st)
        return cache[strategy, policy]
    return get


def _kw(strategy, policy, gen):
    return dict(gen_length=gen, block_size=2, steps=gen, strategy=strategy,
                k=2, k1=2, cache_policy=policy)


def _check(trained, reference, strategy, policy, complete=True, **over):
    _, tp, prompt, gen = trained
    want, wst = reference(strategy, policy)
    got, gst = Decoder(tp, CFG, DecodeConfig(
        **_kw(strategy, policy, gen), **over), device="cpu").generate(
        None, prompt)
    np.testing.assert_array_equal(got.numpy(), want)
    assert gst.steps == wst.steps
    assert gst.forward_equivalents == wst.forward_equivalents
    assert gst.phase_counts == wst.phase_counts
    assert gst.tokens_generated == wst.tokens_generated
    assert gst.revocations == wst.revocations
    assert gst.skipped_forwards == wst.skipped_forwards
    if complete:
        assert (got[:, prompt.shape[1]:] != CFG.mask_token_id).all()
    return gst


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_eager_decode_matches_reference(trained, reference, strategy,
                                        policy):
    _check(trained, reference, strategy, policy, fused_loop=False)


@pytest.mark.parametrize("policy", POLICIES)
def test_graph_decode_matches_reference(trained, reference, policy):
    _check(trained, reference, "fdm_a", policy)


@pytest.mark.parametrize("policy", POLICIES)
def test_fdm_a_skips_the_search_on_trained_weights(trained, reference,
                                                   policy):
    """Trained weights reach what random ones never do: steps that
    accelerate or decode locally without the K₁-candidate search."""
    st = _check(trained, reference, "fdm_a", policy, fused_loop=False)
    assert st.phase_counts["accel"] + st.phase_counts["local_only"] > 0


@pytest.mark.parametrize("driver", ["eager", "graph"])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("strategy", ["wino_r", "extrapolate"])
def test_carry_strategies_match_reference(trained, reference, strategy,
                                          policy, driver):
    """The carry-ful strategies at their default knobs, where trained
    confidences (not forced thresholds) decide the revocations and
    skips.  The testbed's argmax is at times the mask token itself, which
    a revocation can leave in place until the block's step cap, as in the
    reference: the tokens are held equal, not to be free of it."""
    _check(trained, reference, strategy, policy, complete=False,
           fused_loop=driver == "graph")
