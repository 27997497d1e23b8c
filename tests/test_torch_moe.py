"""The MoE stack of the port (mixtral-8x22b) against the reference's, on
the CPU: the config, ``capacity``, the router's top k on tied
probabilities, the dispatch with and without overflow, the aux loss, the
weights bridge with the per-layer ``moe`` group, the forwards with the
sliding-window band live, the block cache, decodes on every driver, and
training.

Same weights (the reference's ``init_model``, bridged), same inputs
(numpy).  Tolerances: routing (ids, counts, slots, drops) exact; MoE
outputs atol = rtol = 1e-5 of their scale (max |out|: the reference's
experts are drawn with σ = 1/√E, so a layer's outputs are of order 10²
and f32 sums in another order differ by ~1e-4 absolute) and the aux
loss 1e-6 in f32; logits
atol = rtol = 1e-4, as ``test_torch_archs.py``; tokens, steps,
forward-equivalents and FDM-A phase counts exact against the
reference's host driver.  The trainer's step on an MoE config (its
reference parity is in ``test_torch_train.py``), the parameter counts of
every registered config and the launcher on ``mixtral-8x22b-tiny``.
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
from repro.models import moe as jax_moe
from repro.models.model import capture_cache as jax_capture_cache
from repro.models.model import forward as jax_forward
from repro.models.model import forward_cached as jax_forward_cached
from repro.models.model import init_model as jax_init_model
from repro.training.checkpoint import _flatten, save
from repro_torch.configs import (DecodeConfig, TrainConfig, get_config,
                                 list_configs)
from repro_torch.convert import from_jax_params, from_npz, to_flat
from repro_torch.core import Decoder
from repro_torch.models import (capture_cache, forward, forward_cached,
                                init_model)
from repro_torch.models import moe
from repro_torch.training import TrainStep, make_train_step, train

NAME = "mixtral-8x22b"
# the reduced config (4 experts top-2, 4:4 heads, window 32), its GQA
# variant, and one whose first layer stays dense (two layer groups)
VARIANTS = {"reduced": {}, "gqa": dict(num_kv_heads=2),
            "first-dense": dict(first_k_dense=1)}


def _configs(over):
    over = dict(over)
    if "first_k_dense" in over:
        k = over.pop("first_k_dense")
        return tuple(dataclasses.replace(
            c, moe=dataclasses.replace(c.moe, first_k_dense=k))
            for c in (jax_get_config(NAME).reduced(**over),
                      get_config(NAME).reduced(**over)))
    return jax_get_config(NAME).reduced(**over), get_config(NAME).reduced(
        **over)


_CACHE = {}


def _model(variant):
    if variant not in _CACHE:
        jcfg, cfg = _configs(VARIANTS[variant])
        jp = jax.device_get(jax_init_model(jax.random.PRNGKey(0), jcfg))
        _CACHE[variant] = jcfg, cfg, jp, from_jax_params(jp, device="cpu")
    return _CACHE[variant]


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_field_for_field(reduced):
    jc, tc = jax_get_config(NAME), get_config(NAME)
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
        assert tc == get_config(f"{NAME}-tiny")
        assert (tc.num_layers, tc.d_model, tc.num_heads, tc.num_kv_heads,
                tc.moe.num_experts, tc.moe.num_experts_per_tok,
                tc.moe.moe_d_ff, tc.sliding_window) == \
            (2, 256, 4, 4, 4, 2, 256, 32)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert tc.is_moe and tc.arch_type == "moe"
    assert NAME in list_configs()


@pytest.mark.parametrize("factor", [1.25, 2.0])
def test_capacity_matches_reference(factor):
    for jc, tc in ((jax_get_config(NAME), get_config(NAME)),
                   (jax_get_config(NAME).reduced(), get_config(NAME).reduced())):
        for t in (*range(1, 700, 7), 1023, 1024, 1025, 4160, 8192, 65536):
            assert moe.capacity(t, tc, factor) == \
                jax_moe.capacity(t, jc, factor), (t, factor)
    full = get_config(NAME)
    # the serving shapes: the scoring batch, the K-candidate batch, the
    # dual window
    assert moe.capacity(256, full) == 128
    assert moe.capacity(512, full) == 256
    assert moe.capacity(64, full, 2.0) == 128


def test_router_topk_breaks_ties_toward_the_lower_id():
    """Exactly tied probabilities: inside the top k (gates exactly ½),
    across its edge (the lower id wins) and all E tied."""
    logits = np.array([[1.0, 3.0, 3.0, 0.0],
                       [3.0, 1.0, 1.0, 0.0],
                       [0.5, 0.5, 0.5, 0.5],
                       [0.0, 2.0, 0.0, 2.0],
                       [-1.0, -1.0, 4.0, -1.0]], np.float32)
    jg, ji = jax_moe.router_topk(jnp.asarray(logits), 2)
    tg, ti = moe.router_topk(torch.from_numpy(logits), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti.numpy(), [[1, 2], [0, 1], [0, 1],
                                               [1, 3], [2, 0]])
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(tg.numpy()[[0, 2, 3]], 0.5)
    assert tg.dtype == torch.float32


def _dispatch_inputs(experts, overflow, seed=0):
    """The reduced config's MoE weights (reference init) with ``experts``
    experts, and 400 tokens; with ``overflow`` every token's first choice
    is expert 0 (a constant feature times a large router weight), so 400
    pairs meet its capacity."""
    jcfg, cfg = (dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, num_experts=experts)) for c in _configs({}))
    jp = jax.device_get(jax_moe.init_moe(jax.random.PRNGKey(seed), jcfg))
    rs = np.random.default_rng(seed)
    x = rs.standard_normal((2, 200, cfg.d_model)).astype(np.float32)
    if overflow:
        x[..., 0] = 4.0
        jp["router"] = np.array(jp["router"])
        jp["router"][0, 0] = 10.0
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jcfg, cfg, jp, tp, x


def _reference_routing(jp, x, jcfg, factor):
    """ids, counts, each pair's slot and the drops from the reference's
    router, laid out by a stable sort in numpy."""
    m = jcfg.moe
    tokens = jnp.asarray(x.reshape(-1, x.shape[-1]))
    logits = tokens @ jnp.asarray(jp["router"])
    _, ids = jax_moe.router_topk(logits, m.num_experts_per_tok)
    flat = np.asarray(ids).reshape(-1)
    counts = np.bincount(flat, minlength=m.num_experts)
    order = np.argsort(flat, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    slot = rank - (np.cumsum(counts) - counts)[flat]
    cap = jax_moe.capacity(tokens.shape[0], jcfg, factor)
    return np.asarray(ids), counts, slot, int((slot >= cap).sum())


# (experts, forced overflow, factor): an expert takes at most one pair a
# token, so with 4 experts at factor 2.0 (capacity > T) nothing can drop;
# with 8 (Mixtral's E) a forced expert overflows at both factors
DISPATCH = [(4, False, 1.25), (4, False, 2.0), (4, True, 1.25),
            (8, True, 1.25), (8, True, 2.0)]


@pytest.mark.parametrize("experts,overflow,factor", DISPATCH)
def test_dispatch_matches_reference(experts, overflow, factor):
    jcfg, cfg, jp, tp, x = _dispatch_inputs(experts, overflow)
    ids, counts, slot, drops = _reference_routing(jp, x, jcfg, factor)
    tokens = torch.from_numpy(x.reshape(-1, cfg.d_model))
    t = tokens.shape[0]
    r = moe.route(tokens @ tp["router"], cfg, moe.capacity(t, cfg, factor))
    np.testing.assert_array_equal(r.ids.numpy(), ids)
    np.testing.assert_array_equal(r.counts.numpy(), counts)
    np.testing.assert_array_equal(r.slot.numpy(), slot)
    assert int((r.slot >= r.capacity).sum()) == drops
    if overflow:              # expert 0 is every token's first choice
        assert counts[0] == t and r.capacity < t
        assert drops == t - r.capacity > 0
    else:
        assert drops == 0
    want, want_aux = jax.jit(jax_moe.moe_forward, static_argnums=(2, 3))(
        jp, jnp.asarray(x), jcfg, factor)
    got, aux = moe.moe_forward(tp, torch.from_numpy(x), cfg, factor)
    scale = float(np.abs(np.asarray(want)).max())
    assert scale > 10
    np.testing.assert_allclose(got.numpy() / scale, np.asarray(want) / scale,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6,
                               atol=1e-6)
    plain, none = moe.moe_forward(tp, torch.from_numpy(x), cfg, factor,
                                  need_aux=False)
    assert none is None and torch.equal(plain, got)


def test_load_balance_loss_matches_reference():
    rs = np.random.default_rng(4)
    logits = (3 * rs.standard_normal((96, 4))).astype(np.float32)
    _, ids = jax_moe.router_topk(jnp.asarray(logits), 2)
    want = jax_moe.load_balance_loss(jnp.asarray(logits), ids, 4)
    got = moe.load_balance_loss(torch.from_numpy(logits),
                                torch.from_numpy(np.array(ids)).long(), 4)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_bridge_round_trips_through_a_reference_checkpoint(variant,
                                                           tmp_path):
    """The per-layer ``moe`` group (router and stacked experts) goes
    through ``from_jax_params``, ``to_flat`` and a reference-written
    checkpoint leaf for leaf; a dense first layer is a group of its own."""
    jcfg, cfg, jp, tp = _model(variant)
    want = _flatten(jp)
    assert "blocks/0/moe/w_gate" in want or "blocks/1/moe/w_gate" in want
    got = to_flat(tp)
    assert sorted(got) == sorted(want)
    for key, arr in want.items():
        np.testing.assert_array_equal(got[key], arr, err_msg=key)
    path = str(tmp_path / "ckpt.npz")
    save(path, jp, step=1)
    back = to_flat(from_npz(path, device="cpu"))
    for key, arr in want.items():
        np.testing.assert_array_equal(back[key], arr, err_msg=key)
    first = 1 if variant == "first-dense" else 0
    assert "mlp" in tp["blocks"][0] if first else "moe" in tp["blocks"][0]
    layer = tp["blocks"][1]["moe"]
    e, d, ff = cfg.moe.num_experts, cfg.d_model, cfg.moe.moe_d_ff
    assert {k: tuple(v.shape) for k, v in layer.items()} == {
        "router": (d, e), "w_gate": (e, d, ff), "w_up": (e, d, ff),
        "w_down": (e, ff, d)}
    bf = from_jax_params(jp, device="cpu", dtype=torch.bfloat16)
    assert bf["blocks"][1]["moe"]["router"].dtype == torch.bfloat16


def test_init_model_has_the_reference_tree():
    """The port's seeded init makes the reference's leaves (paths and
    shapes), the experts drawn with σ = 1/√E as the reference's are
    (``dense_init`` takes the fan-in from the expert axis)."""
    jcfg, cfg = _configs({})
    want = _flatten(jax.device_get(jax_init_model(jax.random.PRNGKey(0),
                                                  jcfg)))
    params = init_model(cfg, device="cpu")
    got = to_flat(params)
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    w = params["blocks"][0]["moe"]["w_gate"]
    sigma = float(w.std())
    assert abs(sigma - 0.9866 / np.sqrt(cfg.moe.num_experts)) < 0.01


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_logits_match_reference(variant):
    """L = 48 > the window of 32: the band is live in every layer."""
    jcfg, cfg, jp, tp = _model(variant)
    assert cfg.sliding_window == 32
    rs = np.random.default_rng(0)
    tokens = rs.integers(0, jcfg.vocab_size, (2, 48)).astype(np.int32)
    tokens[:, 24:] = jcfg.mask_token_id
    want, want_aux = jax.jit(jax_forward, static_argnums=2)(
        jp, jnp.asarray(tokens), jcfg)
    got, aux = forward(tp, torch.from_numpy(tokens).long(), cfg,
                       return_aux=True)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(forward(tp, torch.from_numpy(tokens).long(), cfg),
                       got)


PROMPT, GEN, BLOCK = 16, 32, 8


@pytest.mark.parametrize("variant", ["reduced", "gqa"])
def test_cache_paths_match_reference(variant):
    """``capture_cache`` and ``forward_cached`` (MoE at capacity factor
    2.0) at the ``prefix`` and a ``dual`` window over a 48-token canvas,
    longer than the window of 32: the band is live (without it the
    window's logits differ)."""
    jcfg, cfg, jp, tp = _model(variant)
    rs = np.random.default_rng(3)
    canvas = rs.integers(0, cfg.vocab_size - 1,
                         (2, PROMPT + GEN)).astype(np.int32)
    canvas[:, PROMPT + 5:] = cfg.mask_token_id
    stale = canvas.copy()
    stale[:, PROMPT:] = cfg.mask_token_id
    assert canvas.shape[1] > cfg.sliding_window
    jstate = jax.jit(jax_capture_cache, static_argnums=2)(
        jp, jnp.asarray(stale), jcfg)
    tstate = capture_cache(tp, torch.from_numpy(stale).long(), cfg)
    (stacked,) = jstate.layer_states
    for i, kv in enumerate(tstate):
        np.testing.assert_allclose(kv.k.numpy(), np.asarray(stacked.k[i]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(kv.v.numpy(), np.asarray(stacked.v[i]),
                                   rtol=1e-5, atol=1e-5)
    unbanded = dataclasses.replace(cfg, sliding_window=0)
    for win_start, width in ((PROMPT, GEN), (PROMPT + 2 * BLOCK, BLOCK)):
        window = torch.from_numpy(canvas[:, win_start:win_start + width])
        want = jax.jit(jax_forward_cached, static_argnums=4)(
            jp, jnp.asarray(window.numpy()), jnp.int32(win_start), jstate,
            jcfg)
        got = forward_cached(tp, window.long(), win_start, tstate, cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
        full = forward_cached(tp, window.long(), win_start, tstate,
                              unbanded)
        assert (full - got).abs().max() > 1e-3


# a 40-token canvas (prompt 16, gen 24): longer than the window of 32
DECODE = dict(gen_length=24, block_size=BLOCK, steps=12)
# untrained weights keep max-probs near 1/V: the knobs make FDM's search
# and FDM-A's phases really run (test_torch_decode.py's cases)
STRATEGIES = {"fdm": dict(strategy="fdm", gamma=0.0),
              "fdm_a": dict(strategy="fdm_a", eta1=0.025, eta2=0.02,
                            gamma1=0.0, n_max=4),
              "probability": dict(strategy="probability")}
DRIVERS = {"eager": dict(fused_loop=False), "block": dict(fused_blocks=False),
           "request": {}}


@pytest.mark.parametrize("policy", ["none", "prefix", "dual"])
@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_decodes_match_reference_on_every_driver(strategy, policy):
    """mixtral-8x22b-tiny over a 40-token canvas (band live): the port's
    three drivers against the reference's host driver."""
    jcfg, cfg, jp, tp = _model("reduced")
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


def test_trainer_refuses_an_moe_config():
    """The id of the test that held the old refusal: the trainer now
    trains an MoE config with the router's aux loss in the objective, so
    each of its three entry points builds and takes a step (the reference
    parity of that step is ``test_torch_train.py``'s); an SSM/xLSTM stack
    without its ``ssm`` config is refused at init, and the card is still
    the default."""
    _, cfg, _, tp = _model("reduced")
    tcfg = TrainConfig(batch_size=2, seq_len=12, steps=1)
    tokens = torch.randint(0, cfg.vocab_size - 1, (2, 12),
                           generator=torch.Generator().manual_seed(0))
    batch = {"tokens": tokens, "maskable": torch.ones(2, 12, dtype=bool)}
    gen = torch.Generator().manual_seed(0)
    from repro_torch.training import adamw_init
    from repro_torch.training.trainer import masters
    for make in (lambda: TrainStep(cfg, tcfg),
                 lambda: make_train_step(cfg, tcfg)):
        params = masters(tp)
        params, opt, met = make()(params, adamw_init(params), gen, batch)
        assert opt.step == 1 and float(met["aux"]) > 0
        assert np.isfinite(float(met["loss"]))
    params, hist = train(cfg, tcfg, iter([{k: v.numpy() for k, v in
                                           batch.items()}]),
                         params=tp, device="cpu", log=None)
    assert hist["step"] == [1] and hist["aux"][0] > 0
    with pytest.raises(ValueError, match="no ssm config"):
        init_model(dataclasses.replace(cfg, arch_type="ssm"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train(cfg, tcfg, iter(()), params=tp)


@pytest.mark.parametrize("reduced", [False, True])
def test_param_counts_match_reference_for_every_config(reduced):
    """``param_count``/``active_param_count``/``subquadratic`` equal the
    reference's for every registered config and its ``.reduced()``."""
    for name in list_configs():
        jc, tc = jax_get_config(name), get_config(name)
        if reduced:
            jc, tc = jc.reduced(), tc.reduced()
        assert tc.param_count() == jc.param_count(), name
        assert tc.active_param_count() == jc.active_param_count(), name
        assert tc.subquadratic == jc.subquadratic, name
    full = get_config(NAME)
    assert full.active_param_count() < full.param_count()
    assert dataclasses.replace(full, num_layers=1).param_count() == \
        2_906_714_112


def test_launch_train_runs_an_moe_config_on_the_cpu():
    import os
    import subprocess
    import sys
    from pathlib import Path
    repo = Path(__file__).resolve().parents[1]
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         f"{NAME}-tiny", "--steps", "2", "--batch", "4", "--device",
         "cpu"], env=dict(os.environ, PYTHONPATH=str(repo / "src")),
        capture_output=True, text=True, timeout=300, cwd=repo)
    assert res.returncode == 0, res.stderr
    params = get_config(f"{NAME}-tiny").param_count()
    assert f"({params / 1e6:.1f} M params)" in res.stdout
    assert "final loss" in res.stdout and " aux " in res.stdout
