"""DeepSeek-V2's MLA served on tensor-parallel heads: the port's reduced
DeepSeek-V2 on four gloo ranks on the CPU, against the reference's
unsharded functions.

One spawn of four ranks (``parallel.launch.spawn``, a ``FileStore`` under
the test's temporary directory) serves the reduced config (4 heads, its
latent 64 + 16 columns wide, a dense MLA layer then an MoE layer with 4
experts and a shared one, V = 512, f32) at the meshes (1, 4) (one head, a
quarter of the latent's columns (20: the last rank's cross the
``c_kv``/``k_rope`` seam) and of the vocab, one expert a rank) and (2, 2)
(the batch on ``data``), in the serving layout
(``torch_mla_tp_ranks.mla_tp_rank``):

* ``make_steps``' ``prefill``, then four ``serve`` steps (the absorbed
  decode on local heads) over a seeded 16-position latent cache, which
  stays whole on every model rank (``state_pspecs``), against the
  reference's ``make_steps``; the vocab-sharded head is scored through
  the confidence partials (``score_logits_sharded``);
* ``forward_window``'s extends over an empty 16-position state against
  the reference's;
* ``Decoder.generate`` (eager, ``fdm`` with γ = 0) against the
  reference's unsharded decode (its host driver), at (1, 4) and at a
  model axis of 2: each data row of the (2, 2) mesh a (1, 2) mesh, the
  decoder refusing a data axis above 1.

Tolerances (``test_torch_tp.py``'s): scores, logits and the latent caches
within 1e-5 of their scale (``test_torch_decode_state.TOL``; the
row-parallel partials are summed in f32 in another order than the
reference's products), argmaxes exact; decodes: tokens, steps and
forward-equivalents exact; every rank's scores equal to those of the
ranks holding its rows.
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_decode_state import _close, _ref_layers
from test_torch_tp import _init, _jflat, _same_scores
from torch_mla_tp_ranks import mla_tp_rank
from torch_threads import one_torch_thread  # noqa: F401
from torch_tp_ranks import WINDOWS

from repro.configs import DecodeConfig as JaxDecodeConfig
from repro.configs import get_config as jax_get_config
from repro.core import Decoder as JaxDecoder
from repro.launch import steps as jsteps
from repro.models import model as jm
from repro_torch.parallel.launch import spawn

JCFG = jax_get_config("deepseek-v2-236b").reduced()
B, L = 2, 16
SERVE_POS = 12
DECODE = dict(gen_length=32, block_size=8, steps=32, strategy="fdm",
              gamma=0.0)
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}


@pytest.fixture(scope="module")
def mla_tp(tmp_path_factory):
    """The reference's results and the four ranks' outputs."""
    d = tmp_path_factory.mktemp("mla_tp")
    rs = np.random.default_rng(1)
    jp = _init(JCFG)
    np.savez(d / "deepseek.npz", **_jflat(jp))
    m = JCFG.mla
    lat = {(leaf, i): rs.standard_normal((B, L, width)).astype(np.float32)
           for i in range(JCFG.num_layers)
           for leaf, width in (("c", m.kv_lora_rank),
                               ("r", m.qk_rope_head_dim))}
    np.savez(d / "state.npz", **{f"{leaf}{i}": v
                                 for (leaf, i), v in lat.items()})
    spec = {
        "params": str(d / "deepseek.npz"), "state": str(d / "state.npz"),
        "length": L,
        "tokens": rs.integers(0, JCFG.vocab_size - 1, (B, L)),
        "serve_tokens": rs.integers(0, JCFG.vocab_size - 1, (4, B, 1)),
        "serve_pos": SERVE_POS,
        "prompt": rs.integers(0, JCFG.vocab_size - 1, (2, 16)).astype(
            np.int32),
        "decode": DECODE,
        "window_tokens": rs.integers(0, JCFG.vocab_size - 1, (B, 12))}
    pool = ThreadPoolExecutor(1)
    ranks_future = pool.submit(spawn, mla_tp_rank, 4, "gloo",
                               str(d / "store"), spec)

    steps = jsteps.make_steps(JCFG)
    ref = {"prefill": jax.jit(steps["prefill"])(
        jp, {"tokens": jnp.asarray(spec["tokens"])})}
    js = jm.init_decode_state(JCFG, B, L, jnp.float32)
    groups, first = [], 0
    for group, g_state in zip(jm._layer_groups(JCFG), js.layer_states):
        idx = range(first, first + len(group))
        first += len(group)
        groups.append(g_state._replace(
            k=jnp.asarray(np.stack([lat["c", i] for i in idx])),
            v=jnp.asarray(np.stack([lat["r", i] for i in idx]))))
    js = js._replace(layer_states=tuple(groups))
    serve = jax.jit(steps["serve"])
    ref["serve"] = []
    for i, tok in enumerate(spec["serve_tokens"]):
        sc, js = serve(jp, jnp.asarray(tok), jnp.full((B, 1), SERVE_POS + i,
                                                      jnp.int32), js)
        ref["serve"].append(sc)
    ref["state"] = _ref_layers(JCFG, js)
    toks, st = JaxDecoder(jp, JCFG, JaxDecodeConfig(
        **DECODE, fused_loop=False)).generate(jax.random.PRNGKey(0),
                                              jnp.asarray(spec["prompt"]))
    ref["generate"] = (np.asarray(toks), st)
    ref["window"] = []
    jw = jm.init_decode_state(JCFG, B, 16, jnp.float32, valid_length=0)
    window = jax.jit(jm.forward_window, static_argnums=(4, 5))
    for lo, hi, extend in WINDOWS:
        pos = jnp.broadcast_to(jnp.arange(lo, hi, dtype=jnp.int32),
                               (B, hi - lo))
        lg, jw = window(jp, jnp.asarray(spec["window_tokens"][:, lo:hi]),
                        pos, jw, JCFG, extend)
        ref["window"].append(np.asarray(lg))
        if extend == "kv":
            jw = jm.set_valid_length(jw, lo + 4)
    ranks = ranks_future.result()
    pool.shutdown()
    return ref, ranks


def _rows_of(mesh, r):
    """The batch rows rank r holds (the batch on ``data``)."""
    data, model = MESHES[mesh]
    per = B // data
    return slice((r // model) * per, (r // model + 1) * per)


def test_heads_and_latent_columns_are_split(mla_tp):
    _, ranks = mla_tp
    for r in ranks:
        assert (r["1x4/heads"], r["1x4/latent"]) == (1, 20)
        assert (r["2x2/heads"], r["2x2/latent"]) == (2, 40)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mla_prefill_matches_reference(mla_tp, mesh):
    ref, ranks = mla_tp
    for r, out in enumerate(ranks):
        w = type(ref["prefill"])(*(np.asarray(a)[_rows_of(mesh, r)]
                                   for a in ref["prefill"]))
        _same_scores(w, out[f"{mesh}/prefill"], f"prefill {mesh} rank {r}")


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mla_serve_matches_reference(mla_tp, mesh):
    """Scores each step; the latent caches at the end, whole on every
    model rank."""
    ref, ranks = mla_tp
    for step, want in enumerate(ref["serve"]):
        for r, out in enumerate(ranks):
            w = type(want)(*(np.asarray(a)[_rows_of(mesh, r)] for a in want))
            _same_scores(w, out[f"{mesh}/serve"]["scores"][step],
                         f"serve {mesh} step {step} rank {r}")
    for layer, want in enumerate(ref["state"]):
        for r, out in enumerate(ranks):
            got = out[f"{mesh}/serve"]
            assert got["length"][layer] == int(want.length)
            for leaf, field in (("c", "k"), ("r", "v")):
                _close(got[leaf][layer],
                       np.asarray(getattr(want, field))[_rows_of(mesh, r)],
                       f"{mesh} layer {layer} {leaf} rank {r}")


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mla_forward_window_matches_reference(mla_tp, mesh):
    ref, ranks = mla_tp
    _, model = MESHES[mesh]
    for i, want in enumerate(ref["window"]):
        for row in range(0, 4, model):      # the ranks of one data row
            got = np.concatenate([ranks[r][f"{mesh}/window"][i]
                                  for r in range(row, row + model)], axis=-1)
            w = want[_rows_of(mesh, row)]
            assert (got.argmax(-1) == w.argmax(-1)).all(), (mesh, i)
            _close(got, w, f"window {mesh} {WINDOWS[i]}")


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mla_generate_matches_unsharded_reference(mla_tp, mesh):
    ref, ranks = mla_tp
    want, wstats = ref["generate"]
    for r, out in enumerate(ranks):
        got = out[f"{mesh}/generate"]
        assert np.array_equal(got["tokens"], want), f"rank {r}"
        assert got["steps"] == wstats.steps, f"rank {r}"
        assert got["forward_equivalents"] == wstats.forward_equivalents
