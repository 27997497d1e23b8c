"""The port's sharding rules, its sharded scoring and its refusals, on the
CPU, against the reference's.

* ``param_pspecs``/``cache_pspecs`` (``parallel/sharding.py``) against the
  reference's for LLaDA and every config of ``ASSIGNED_ARCHS``, reduced
  and at full shape (shapes only: the reference's trees from
  ``jax.eval_shape``, the port's on the meta device), under meshes
  (1, 4), (2, 2), (4, 1), (16, 16) and (2, 16, 16).  The reference is
  given a stand-in mesh with ``shape`` and ``axis_names``, all its rules
  read (``AbstractMesh``'s signature changed under JAX 0.9, which is why
  ``test_sharding.py`` fails there).  A port block leaf is one layer of
  the reference's group-stacked leaf: its spec must equal the
  reference's less the leading layer entry, exactly.
* The merge of the confidence kernel's per-shard partials (their plain
  version) against the reference's ``score_logits_sharded`` at tp = 1, 2
  and 4: ties within a shard and across shards, the maximum in the last
  shard, bf16 logits, −inf logits.  Argmaxes exact, margins exactly 0 on
  ties, the rest within 1e-5 of their scale (f32 sums in another order).
  The reference's Σ p log p multiplies a −inf logit by 0 (NaN); the
  kernel and its partials count it as 0 (its limit), so −inf rows are
  held against the reference on the same logits with −inf replaced by
  −1e30.
* ``shard_tree`` against slicing, the launcher's failure path on two
  gloo ranks, and every refusal of the slice under a stand-in mesh
  (raised before any collective).
"""
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401
from torch_tp_ranks import fail_on_rank_1

from repro.configs import get_config as jax_get_config
from repro.core.confidence import score_logits_sharded as jax_sharded
from repro.models import model as jm
from repro.parallel import sharding as jsh
from repro_torch.configs import ASSIGNED_ARCHS, DecodeConfig, get_config
from repro_torch.core import Decoder
from repro_torch.core.confidence import merge_partials
from repro_torch.kernels.confidence import (Partials, confidence_partials,
                                            confidence_partials_ref)
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.models import model as tm
from repro_torch.models.layers import row_parallel
from repro_torch.parallel import ctx
from repro_torch.parallel import sharding as tsh
from repro_torch.parallel.launch import spawn

ARCHS = ["llada-8b"] + list(ASSIGNED_ARCHS)
MESHES = {"1x4": {"data": 1, "model": 4}, "2x2": {"data": 2, "model": 2},
          "4x1": {"data": 4, "model": 1}, "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
# the two cache regimes: the batch on the data axes, and batch 1 with the
# sequence on them (context parallelism)
STATE_SHAPES = ((4, 64), (1, 2048))
TOL = 1e-5


class StandInMesh:
    """What the reference's rules read of a mesh."""

    def __init__(self, sizes):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)


def _configs(arch, size):
    if size == "reduced":
        return jax_get_config(arch).reduced(), get_config(arch).reduced()
    return jax_get_config(arch), get_config(arch)


def _path(path):
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _full(spec, ndim):
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


@functools.lru_cache(maxsize=None)
def _trees(arch, size):
    """(reference ShapeDtypeStruct params, port meta params)."""
    jcfg, cfg = _configs(arch, size)
    sds = jax.eval_shape(functools.partial(jm.init_model,
                                           jax.random.PRNGKey(0), jcfg))
    return sds, tm.init_model(cfg, device="meta")


def _layer_of(groups):
    """port layer index -> (reference group, index in it)."""
    return {i: (g, j) for g, grp in enumerate(groups)
            for j, i in enumerate(grp)}


def _port_leaves(tree, prefix="", specs=False):
    """(path, leaf) of a port tree (``specs``: its spec tuples are
    leaves)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _port_leaves(v, f"{prefix}{k}/", specs)
    elif isinstance(tree, (list, tuple)) and not (specs
                                                  and tsh.is_spec(tree)):
        for i, v in enumerate(tree):
            yield from _port_leaves(v, f"{prefix}{i}/", specs)
    else:
        yield prefix[:-1], tree


def _ref_path(path, jcfg):
    """A port leaf path -> (the reference's path, index in its stacked
    layer axis or None)."""
    parts = path.split("/")
    for top, cfg_of in (("blocks", lambda c: c),
                        ("encoder", jm.encoder_config)):
        if parts[0] == top:
            at = 1 if top == "blocks" else 2
            if top == "encoder" and parts[1] != "blocks":
                return path, None
            g, j = _layer_of(jm._layer_groups(cfg_of(jcfg)))[int(parts[at])]
            return "/".join(parts[:at] + [str(g)] + parts[at + 1:]), j
    return path, None


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("size", ["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, size, mesh):
    jcfg, _ = _configs(arch, size)
    sds, params = _trees(arch, size)
    sizes = MESHES[mesh]
    jspecs = jsh.param_pspecs(sds, StandInMesh(sizes))
    ref = {_path(p): (leaf.shape, spec) for (p, leaf), (_, spec) in zip(
        jax.tree_util.tree_flatten_with_path(sds)[0],
        jax.tree_util.tree_flatten_with_path(
            jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
        )[0])}
    specs = dict(_port_leaves(tsh.param_pspecs(params, sizes), specs=True))
    seen = set()
    for path, leaf in _port_leaves(params):
        rpath, j = _ref_path(path, jcfg)
        shape, spec = ref[rpath]
        want = _full(spec, len(shape))
        if j is not None:       # the rules never shard the layer axis
            assert want[0] is None, (rpath, spec)
            shape, want = shape[1:], want[1:]
        assert tuple(leaf.shape) == tuple(shape), path
        assert _full(specs[path], leaf.dim()) == want, (path, specs[path],
                                                       spec)
        seen.add(rpath)
    assert seen == set(ref)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_and_seq_specs_match_reference(mesh):
    sizes = MESHES[mesh]
    for ndim in (2, 3):
        assert tsh.batch_pspec(sizes, ndim) == _full(
            jsh.batch_pspec(StandInMesh(sizes), ndim), ndim)
        assert tsh.seq_pspec(sizes, ndim) == _full(
            jsh.seq_pspec(StandInMesh(sizes), ndim), ndim)


@functools.lru_cache(maxsize=None)
def _states(arch, size, batch, length):
    jcfg, cfg = _configs(arch, size)
    sds = jax.eval_shape(lambda: jm.init_decode_state(jcfg, batch, length))
    return sds, tm.init_decode_state(cfg, batch, length, device="meta")


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("size", ["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, size, mesh):
    """Each layer's state leaves (B, ...) against one layer of the
    reference's group-stacked leaves, in both cache regimes."""
    jcfg, _ = _configs(arch, size)
    sizes = MESHES[mesh]
    layer_of = _layer_of(jm._layer_groups(jcfg))
    for batch, length in STATE_SHAPES:
        sds, state = _states(arch, size, batch, length)
        jspecs = jsh.cache_pspecs(sds, StandInMesh(sizes), batch)
        specs = tsh.cache_pspecs(state, sizes, batch)
        for i, (st, sp) in enumerate(zip(state.layer_states,
                                         specs.layer_states)):
            g = layer_of[i][0]
            ref = [(r, s) for r, s in zip(
                jax.tree_util.tree_leaves(sds.layer_states[g]),
                jax.tree_util.tree_leaves(jspecs.layer_states[g],
                                          is_leaf=lambda x: isinstance(
                                              x, jax.sharding.PartitionSpec)))
                if r.ndim > 1]
            got = [(t, s) for (_, t), (_, s) in zip(
                _port_leaves(st), _port_leaves(sp, specs=True))
                if isinstance(t, torch.Tensor)]
            assert len(got) == len(ref), (arch, i)
            for (t, s), (r, rs) in zip(got, ref):
                assert tuple(t.shape) == tuple(r.shape[1:]), (arch, i)
                assert _full(s, t.dim()) == _full(rs, r.ndim)[1:], (
                    arch, size, mesh, batch, i, s, rs)


# --------------------------------------------------------------------------
# the sharded scores: partials, gather, merge
# --------------------------------------------------------------------------

V = 64


def _logits(case, dtype):
    rs = np.random.default_rng(1)
    x = rs.standard_normal((5, V)).astype(np.float32)
    if case == "tie_within_shard":
        x[:, 5] = x[:, 6] = 9.0
    elif case == "tie_across_shards":
        x[:, 3] = x[:, 40] = 9.0
    elif case == "max_in_last_shard":
        x[:, 63] = 9.0
    elif case == "neg_inf":
        x[:, :16] = -np.inf             # a whole shard at tp = 4
        x[1, 20:60] = -np.inf
    if dtype == "bfloat16":             # the same values in both
        x = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["random", "tie_within_shard",
                                  "tie_across_shards", "max_in_last_shard",
                                  "neg_inf"])
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_merged_partials_match_reference_sharded_scores(tp, case, dtype):
    x = _logits(case, dtype)
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    w = V // tp
    parts = [confidence_partials(t[:, r * w:(r + 1) * w].contiguous(), r * w)
             for r in range(tp)]
    got = merge_partials(Partials(*(torch.stack([getattr(p, f)
                                                 for p in parts])
                                    for f in Partials._fields)))
    want = jax_sharded(jnp.asarray(np.where(np.isinf(x), -1e30, x),
                                   jnp.float32))
    assert np.array_equal(got.argmax.numpy(), np.asarray(want.argmax))
    for field in ("max_prob", "margin", "neg_entropy"):
        g, r = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert np.abs(g - r).max() <= TOL * max(1.0, np.abs(r).max()), field
    if case.startswith("tie"):
        assert (got.margin.numpy() == 0).all()


def test_partials_wrapper_is_the_plain_version_on_the_cpu():
    x = torch.from_numpy(_logits("random", "float32"))
    for a, b in zip(confidence_partials(x, 7), confidence_partials_ref(x, 7)):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# shards, meshes, the launcher
# --------------------------------------------------------------------------

def test_mesh_coordinates_are_row_major():
    mesh = Mesh({"data": 2, "model": 2}, rank=3)
    assert [mesh.coords(r) for r in range(4)] == [
        {"data": d, "model": m} for d in range(2) for m in range(2)]
    assert make_host_mesh().size == 1 and make_host_mesh().coords() == {
        "data": 0, "model": 0}


def test_shard_tree_cuts_each_ranks_part():
    cfg = get_config("mixtral-8x22b").reduced()
    params = tm.init_model(cfg, device="cpu")
    sizes = {"data": 2, "model": 2}
    shards = [tsh.shard_params(params, sizes, r) for r in range(4)]
    full = params["blocks"][0]
    # column-parallel: model rank m holds columns m/2 of wq, rows of wo,
    # experts m/2 (expert-parallel: 4 experts on 2); data ranks alike
    for r, sh in enumerate(shards):
        m = r % 2
        blk = sh["blocks"][0]
        n = full["attn"]["wq"].shape[1] // 2
        assert torch.equal(blk["attn"]["wq"],
                           full["attn"]["wq"][:, m * n:(m + 1) * n])
        assert torch.equal(blk["attn"]["wo"],
                           full["attn"]["wo"][m * n:(m + 1) * n])
        assert torch.equal(blk["moe"]["w_gate"],
                           full["moe"]["w_gate"][2 * m:2 * m + 2])
        assert torch.equal(blk["moe"]["router"], full["moe"]["router"])
        v = cfg.vocab_size // 2
        assert torch.equal(sh["embed"]["head"],
                           params["embed"]["head"][:, m * v:(m + 1) * v])
        assert torch.equal(sh["norm_f"]["scale"], params["norm_f"]["scale"])


def test_a_failing_rank_fails_the_run(tmp_path):
    with pytest.raises(RuntimeError, match="of 2 failed") as err:
        spawn(fail_on_rank_1, 2, "gloo", str(tmp_path / "store"))
    assert "rank 1 raises on purpose" in str(err.value)
    with pytest.raises(ValueError, match="backend"):
        spawn(fail_on_rank_1, 2, "auto", str(tmp_path / "store"))


# --------------------------------------------------------------------------
# refusals under a mesh (all raised before any collective)
# --------------------------------------------------------------------------

MESH_1x4 = Mesh({"data": 1, "model": 4})
MESH_2x2 = Mesh({"data": 2, "model": 2})


@pytest.fixture(scope="module")
def llada():
    cfg = get_config("llada-8b").reduced()
    return cfg, tm.init_model(cfg, device="cpu")


@pytest.mark.parametrize("mesh,kw,error,match", [
    (MESH_1x4, dict(strategy="fdm"), ValueError, "graph drivers"),
    (MESH_1x4, dict(strategy="wino_r", fused_loop=False),
     NotImplementedError, "full-vocab"),
    (MESH_2x2, dict(strategy="fdm", fused_loop=False), NotImplementedError,
     "data axis")], ids=["graph_driver", "full_vocab_strategy", "data_axis"])
def test_decoder_refuses_under_a_mesh(llada, mesh, kw, error, match):
    cfg, params = llada
    dec = Decoder(params, cfg, DecodeConfig(gen_length=8, block_size=8,
                                            steps=4, **kw), device="cpu")
    with ctx.activation_mesh(mesh), pytest.raises(error, match=match):
        dec.generate(None, np.zeros((1, 8), np.int32))


@pytest.mark.parametrize("arch,error", [
    ("chatglm3-6b", ValueError), ("qwen2-vl-72b", NotImplementedError),
    ("hymba-1.5b", NotImplementedError), ("whisper-medium",
                                          NotImplementedError)])
def test_families_without_tensor_parallelism_refuse(arch, error):
    """ChatGLM3's 2 kv heads do not split whole over 4 ranks; the VLM,
    the hybrid and the encoder-decoder wait for a later slice."""
    cfg = get_config(arch).reduced()
    with ctx.activation_mesh(MESH_1x4), pytest.raises(error):
        tm.init_decode_state(cfg, 1, 8, device="meta")


def test_foreign_shards_and_unknown_vocab_refuse(llada):
    """A half of ``wo`` is no shard of a model axis of 4; logits under a
    mesh need the vocab to tell a slice from a row."""
    _, params = llada
    wo = params["blocks"][0]["attn"]["wo"]
    with ctx.activation_mesh(MESH_1x4), pytest.raises(ValueError,
                                                      match="no shard"):
        row_parallel(torch.zeros(1, wo.shape[0] // 2), wo[:wo.shape[0] // 2],
                     wo.shape[0])
    with ctx.activation_mesh(MESH_1x4), pytest.raises(ValueError,
                                                      match="with_vocab"):
        ctx.vocab_offset(128)
    with ctx.activation_mesh(MESH_1x4), ctx.with_vocab(512):
        assert ctx.vocab_offset(512) is None
        assert ctx.vocab_offset(128) == 0
    assert ctx.vocab_offset(128) is None            # no mesh
