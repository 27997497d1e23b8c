"""Tensor- and expert-parallel serving of the port on four gloo ranks on
the CPU, against the reference's unsharded functions.

One spawn of four ranks (``parallel.launch.spawn``, a ``FileStore`` under
the test's temporary directory) runs every check of the file on three
meshes over the same ranks (``torch_tp_ranks.tp_rank``):

* mesh (1, 4), the testbed LLaDA (reduced: 4 heads, V = 512, f32; one
  head, a quarter of the ffn and of the vocab a rank): ``make_steps``'
  ``prefill`` and four ``serve`` steps over a seeded 16-position cache
  against the reference's ``make_steps``; ``Decoder.generate`` (eager)
  under ``fdm`` (γ = 0), ``fdm_a`` (its four phases) and ``probability``
  and ``fdm`` under the ``prefix`` block cache against the reference's
  unsharded decode (its host driver); ``forward_window``'s extends over
  an empty 16-position state against the reference's; the reduced Mixtral
  expert-parallel (one of its 4 experts a rank) against the reference's
  ``forward``;
* mesh (2, 2): the four serve steps with the batch on ``data``;
* mesh (4, 1): ``moe_forward``'s grouped dispatch (1024 tokens a data
  rank) and its global one (32 a rank, gathered over ``data``), at
  capacity factor 0.5 so that drops tell the two apart, against
  the reference's ``moe_forward`` under its ``activation_mesh`` over four
  host devices, run in a subprocess (``XLA_FLAGS`` must be set before
  JAX starts).

Tolerances: scores, logits and caches within 1e-5 of their scale
(``test_torch_decode_state.TOL``; the row-parallel partials are summed
in f32 in another order than the reference's products), argmaxes exact;
decodes: tokens, steps, forward-equivalents and FDM-A's phase counts
exact; every rank's scores and tokens equal to rank 0's.  MoE outputs
(of order 10², as the reference's experts are drawn) and the aux loss
within 1e-5 of their scale.
"""
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_decode_state import _close, _ref_layers
from torch_threads import one_torch_thread  # noqa: F401
from torch_tp_ranks import WINDOWS, tp_rank

from repro.configs import DecodeConfig as JaxDecodeConfig
from repro.configs import get_config as jax_get_config
from repro.core import Decoder as JaxDecoder
from repro.launch import steps as jsteps
from repro.models import model as jm
from repro_torch.parallel.launch import spawn

JCFG = jax_get_config("llada-8b").reduced()
MJCFG = jax_get_config("mixtral-8x22b").reduced()
B, L = 2, 16
SERVE_POS = 12
BASE = dict(gen_length=32, block_size=8, steps=20)
# untrained weights keep every max-prob near 1/V: these knobs make FDM's
# search and all four FDM-A phases run (test_torch_decode.py's cases)
CASES = {"fdm": dict(BASE, strategy="fdm", gamma=0.0, steps=32),
         "fdm_a": dict(BASE, strategy="fdm_a", eta1=0.025, eta2=0.02,
                       gamma1=0.0, n_max=4, steps=32),
         "probability": dict(BASE, strategy="probability"),
         # the block cache (capture_cache, forward_cached) under the mesh
         "fdm_prefix": dict(BASE, strategy="fdm", gamma=0.0, steps=32,
                            cache_policy="prefix")}
MOE_INPUTS = {"grouped": (4, 1024), "global": (4, 32)}
# under capacity factor 0.5 experts drop pairs, so the grouped dispatch
# (capacity from 1024 tokens) and the global one (from 4096) differ
MOE_FACTOR = 0.5

REFERENCE_MOE = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.models.moe import moe_forward
from repro.parallel.ctx import activation_mesh
cfg = get_config("mixtral-8x22b").reduced()
z = np.load(sys.argv[1])
p = {k[len("moe/"):]: jnp.asarray(z[k]) for k in z.files
     if k.startswith("moe/")}
f = jax.jit(lambda p, x: moe_forward(p, x, cfg, float(sys.argv[3])))
out = {}
auto = (jax.sharding.AxisType.Auto,) * 2
with activation_mesh(jax.make_mesh((4, 1), ("data", "model"),
                                   axis_types=auto)):
    for name in sys.argv[4:]:
        o, aux = f(p, jnp.asarray(z["x/" + name]))
        out[name + "/out"], out[name + "/aux"] = np.asarray(o), np.asarray(aux)
np.savez(sys.argv[2], **out)
"""


def _jflat(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _init(jcfg):
    return jax.device_get(jax.jit(jm.init_model, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg))


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """The reference's results and the four ranks' outputs."""
    d = tmp_path_factory.mktemp("tp")
    rs = np.random.default_rng(0)
    jp, mp = _init(JCFG), _init(MJCFG)
    np.savez(d / "llada.npz", **_jflat(jp))
    np.savez(d / "mixtral.npz", **_jflat(mp))
    # the reference's grouped dispatch, beside the ranks
    moe_x = {n: rs.standard_normal((b, l, MJCFG.d_model)).astype(np.float32)
             for n, (b, l) in MOE_INPUTS.items()}
    np.savez(d / "moe.npz",
             **{f"moe/{k}": np.asarray(v)[0]
                for k, v in mp["blocks"][0]["moe"].items()},
             **{f"x/{n}": x for n, x in moe_x.items()})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref_moe = subprocess.Popen(
        [sys.executable, "-c", REFERENCE_MOE, str(d / "moe.npz"),
         str(d / "moe_out.npz"), str(MOE_FACTOR), *MOE_INPUTS], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    hd = JCFG.d_model // JCFG.num_heads
    shape = (JCFG.num_layers, B, L, JCFG.num_kv_heads, hd)
    k, v = (rs.standard_normal(shape).astype(np.float32) for _ in range(2))
    np.savez(d / "state.npz", **{f"k{i}": k[i] for i in range(shape[0])},
             **{f"v{i}": v[i] for i in range(shape[0])})
    spec = {
        "llada": str(d / "llada.npz"), "mixtral": str(d / "mixtral.npz"),
        "state": str(d / "state.npz"), "length": L,
        "tokens": rs.integers(0, JCFG.vocab_size - 1, (B, L)),
        "serve_tokens": rs.integers(0, JCFG.vocab_size - 1, (4, B, 1)),
        "serve_pos": SERVE_POS,
        "prompt": rs.integers(0, JCFG.vocab_size - 1, (2, 16)).astype(
            np.int32),
        "cases": CASES,
        "mixtral_tokens": rs.integers(0, MJCFG.vocab_size - 1, (B, L)),
        "window_tokens": rs.integers(0, JCFG.vocab_size - 1, (B, 12)),
        "moe_inputs": moe_x, "moe_factor": MOE_FACTOR}
    # the ranks run while this process computes the reference's side
    pool = ThreadPoolExecutor(1)
    ranks_future = pool.submit(spawn, tp_rank, 4, "gloo", str(d / "store"),
                               spec)

    ref = {"prefill": jax.jit(jsteps.make_steps(JCFG)["prefill"])(
        jp, {"tokens": jnp.asarray(spec["tokens"])})}
    js = jm.init_decode_state(JCFG, B, L, jnp.float32)
    js = js._replace(layer_states=(js.layer_states[0]._replace(
        k=jnp.asarray(k), v=jnp.asarray(v)),))
    serve = jax.jit(jsteps.make_steps(JCFG)["serve"])
    ref["serve"] = []
    for i, tok in enumerate(spec["serve_tokens"]):
        sc, js = serve(jp, jnp.asarray(tok), jnp.full((B, 1), SERVE_POS + i,
                                                      jnp.int32), js)
        ref["serve"].append(sc)
    ref["state"] = _ref_layers(JCFG, js)
    for name, kw in CASES.items():
        # the host driver: its forward-equivalents are exact
        toks, st = JaxDecoder(jp, JCFG, JaxDecodeConfig(
            **kw, fused_loop=False)).generate(jax.random.PRNGKey(0),
                                              jnp.asarray(spec["prompt"]))
        ref[f"generate/{name}"] = (np.asarray(toks), st)
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
    ref["mixtral"] = np.asarray(jm.forward(
        mp, jnp.asarray(spec["mixtral_tokens"]), MJCFG)[0])
    log, _ = ref_moe.communicate(timeout=600)
    assert ref_moe.returncode == 0, log
    with np.load(d / "moe_out.npz") as z:
        ref["moe"] = {k: z[k] for k in z.files}
    ranks = ranks_future.result()
    pool.shutdown()
    return ref, ranks, spec


def _same_scores(want, got, what):
    assert np.array_equal(np.asarray(want.argmax), got[0]), what
    for i, field in enumerate(("max_prob", "margin", "neg_entropy")):
        _close(got[i + 1], getattr(want, field), f"{what} {field}")


def _equal_on_every_rank(ranks, key):
    first = ranks[0][key]
    for r in ranks[1:]:
        for a, b in zip(first, r[key]):
            assert np.array_equal(a, b), key


def test_prefill_1x4_matches_reference(tp):
    ref, ranks, _ = tp
    _equal_on_every_rank(ranks, "prefill")
    _same_scores(ref["prefill"], ranks[0]["prefill"], "prefill")


def _check_serve(ref, outs, rows, heads, what):
    """``outs[r]``: rank r's serve output; ``rows[r]``/``heads[r]``: the
    batch rows and kv heads it holds."""
    for step, want in enumerate(ref["serve"]):
        for r, out in enumerate(outs):
            w = type(want)(*(np.asarray(a)[rows[r]] for a in want))
            _same_scores(w, out["scores"][step], f"{what} step {step} "
                                                 f"rank {r}")
    for layer, want in enumerate(ref["state"]):
        for r, out in enumerate(outs):
            assert out["length"][layer] == int(want.length)
            for leaf in ("k", "v"):
                _close(out[leaf][layer],
                       np.asarray(getattr(want, leaf))[rows[r]][:, :,
                                                                 heads[r]],
                       f"{what} layer {layer} {leaf} rank {r}")


def test_serve_1x4_matches_reference(tp):
    ref, ranks, _ = tp
    g = JCFG.num_kv_heads // 4
    _check_serve(ref, [r["serve"] for r in ranks], [slice(None)] * 4,
                 [slice(r * g, (r + 1) * g) for r in range(4)], "serve 1x4")


def test_serve_2x2_matches_reference(tp):
    ref, ranks, _ = tp
    g = JCFG.num_kv_heads // 2
    _check_serve(ref, [r["serve22"] for r in ranks],
                 [slice(r // 2, r // 2 + 1) for r in range(4)],
                 [slice((r % 2) * g, (r % 2 + 1) * g) for r in range(4)],
                 "serve 2x2")


@pytest.mark.parametrize("case", sorted(CASES))
def test_generate_1x4_matches_unsharded_reference(tp, case):
    ref, ranks, _ = tp
    want, wstats = ref[f"generate/{case}"]
    for r, out in enumerate(ranks):
        got = out[f"generate/{case}"]
        assert np.array_equal(got["tokens"], want), f"rank {r}"
        assert got["steps"] == wstats.steps, f"rank {r}"
        assert got["forward_equivalents"] == wstats.forward_equivalents
        assert got["phases"] == wstats.phase_counts
    if case == "fdm_a":
        assert all(v > 0 for v in wstats.phase_counts.values())


def test_forward_window_1x4_matches_reference(tp):
    ref, ranks, _ = tp
    for i, want in enumerate(ref["window"]):
        got = np.concatenate([r["window"][i] for r in ranks], axis=-1)
        assert (got.argmax(-1) == want.argmax(-1)).all(), i
        _close(got, want, f"window {WINDOWS[i]}")


def test_mixtral_expert_parallel_matches_reference(tp):
    ref, ranks, _ = tp
    assert [r["mixtral/experts"] for r in ranks] == [1] * 4
    got = np.concatenate([r["mixtral/logits"] for r in ranks], axis=-1)
    assert got.shape == ref["mixtral"].shape
    assert (got.argmax(-1) == ref["mixtral"].argmax(-1)).all()
    _close(got, ref["mixtral"], "mixtral logits")


@pytest.mark.parametrize("name", sorted(MOE_INPUTS))
def test_moe_dispatch_4x1_matches_reference(tp, name):
    ref, ranks, spec = tp
    b = spec["moe_inputs"][name].shape[0] // 4
    for r, out in enumerate(ranks):
        got = out[f"moe/{name}"]
        _close(got["out"], ref["moe"][f"{name}/out"][r * b:(r + 1) * b],
               f"{name} rank {r}")
        _close(got["aux"], ref["moe"][f"{name}/aux"], f"{name} aux")
    if name == "grouped":       # the global dispatch would differ
        from repro_torch.convert import from_flat
        from repro_torch.configs import get_config
        from repro_torch.models.moe import moe_forward
        with np.load(spec["mixtral"]) as z:
            p = from_flat({k: z[k] for k in z.files}, device="cpu")
        one, _ = moe_forward(p["blocks"][0]["moe"],
                             torch.from_numpy(spec["moe_inputs"][name]),
                             get_config("mixtral-8x22b").reduced(),
                             MOE_FACTOR)
        assert np.abs(one.numpy() - ref["moe"][f"{name}/out"]).max() > 1e-2
