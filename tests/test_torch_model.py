"""The port's model against the reference's: the weights bridge, the layers
and the full forward, in f32 on the CPU with the same weights.

Tolerance of the forward: atol = rtol = 1e-4 on f32 logits — the two
frameworks sum the same f32 products in different orders.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro.configs import get_config as jax_get_config
from repro.models import layers as jax_layers
from repro.models.model import forward as jax_forward
from repro.models.model import init_model as jax_init_model
from repro.training.checkpoint import _flatten, save
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params, from_npz, to_flat
from repro_torch.models import forward, init_model
from repro_torch.models import layers

TESTBED = dict(num_layers=4, d_model=256, num_heads=4, num_kv_heads=4,
               d_ff=1024)             # benchmarks/common.py:41-42
CONFIGS = {"reduced": {}, "testbed": TESTBED}


def _configs(over):
    return (jax_get_config("llada-8b").reduced(**over),
            get_config("llada-8b").reduced(**over))


@pytest.fixture(scope="module")
def jax_params():
    jcfg, _ = _configs({})
    return jax.device_get(jax_init_model(jax.random.PRNGKey(0), jcfg))


def test_configs_match_field_for_field():
    import repro.configs.base as jb
    import repro_torch.configs.base as tb
    for jc, tc in ((jax_get_config("llada-8b"), get_config("llada-8b")),
                   (jax_get_config("llada-8b").reduced(**TESTBED),
                    get_config("llada-8b").reduced(**TESTBED)),
                   (jax_get_config("hymba-1.5b"), get_config("hymba-1.5b")),
                   (jax_get_config("hymba-1.5b-tiny"),
                    get_config("hymba-1.5b-tiny"))):
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert dataclasses.asdict(jb.DecodeConfig()) == \
        dataclasses.asdict(tb.DecodeConfig())
    for gen in (8, 12, 13, 64, 256):
        assert jb.default_block_size(gen) == tb.default_block_size(gen)
    assert get_config("llada-8b-tiny") == get_config("llada-8b").reduced()
    assert get_config("hymba-1.5b-tiny") == \
        get_config("hymba-1.5b").reduced()


def test_bridge_round_trips_every_leaf(jax_params):
    params = from_jax_params(jax_params, device="cpu")
    want = _flatten(jax_params)
    got = to_flat(params)
    assert sorted(got) == sorted(want)
    for key, arr in want.items():
        np.testing.assert_array_equal(got[key], arr, err_msg=key)
    _, cfg = _configs({})
    assert len(params["blocks"]) == cfg.num_layers


def test_bridge_reads_reference_checkpoint(jax_params, tmp_path):
    path = str(tmp_path / "ckpt.npz")
    save(path, jax_params, step=3)
    got = to_flat(from_npz(path, device="cpu"))
    for key, arr in _flatten(jax_params).items():
        np.testing.assert_array_equal(got[key], arr, err_msg=key)


def test_bridge_casts_matrices_keeps_norms_f32(jax_params):
    params = from_jax_params(jax_params, device="cpu",
                             dtype=torch.bfloat16)
    assert params["embed"]["head"].dtype == torch.bfloat16
    assert params["blocks"][1]["mlp"]["down"].dtype == torch.bfloat16
    assert params["blocks"][0]["norm1"]["scale"].dtype == torch.float32
    assert params["norm_f"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_logits_match_reference(name):
    jcfg, tcfg = _configs(CONFIGS[name])
    jp = jax_init_model(jax.random.PRNGKey(1), jcfg)
    tp = from_jax_params(jax.device_get(jp), device="cpu")
    rs = np.random.default_rng(0)
    tokens = rs.integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    tokens[:, 12:] = jcfg.mask_token_id
    want = np.asarray(jax_forward(jp, jnp.asarray(tokens), jcfg)[0])
    got = forward(tp, torch.from_numpy(tokens).long(), tcfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("part", ["norm", "rope", "rope_bf16", "mlp",
                                  "lm_head"])
def test_layers_match_reference(jax_params, part):
    jcfg, tcfg = _configs({})
    rs = np.random.default_rng(7)
    blk = jax.tree.map(lambda a: a[0], jax_params["blocks"][0])
    if part == "norm":
        x = rs.standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
        scale = rs.standard_normal(jcfg.d_model).astype(np.float32)
        want = jax_layers.apply_norm({"scale": jnp.asarray(scale)},
                                     jnp.asarray(x), jcfg)
        got = layers.apply_norm({"scale": torch.from_numpy(scale)},
                                torch.from_numpy(x), tcfg)
        tol = 1e-5
    elif part.startswith("rope"):
        x = rs.standard_normal((2, 9, 4, 64)).astype(np.float32)
        pos = np.tile(np.arange(3, 12, dtype=np.int32), (2, 1))
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
        tol = 1e-5
        if part == "rope_bf16":
            jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
            tol = 2e-2
        want = jax_layers.apply_rope(jx, jnp.asarray(pos), jcfg)
        got = layers.apply_rope(tx, torch.from_numpy(pos), tcfg)
    elif part == "mlp":
        x = rs.standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
        want = jax_layers.apply_mlp(blk["mlp"], jnp.asarray(x), jcfg)
        tp = {k: torch.from_numpy(np.array(v))
              for k, v in blk["mlp"].items()}
        got = layers.apply_mlp(tp, torch.from_numpy(x), tcfg)
        tol = 1e-5
    else:
        x = rs.standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
        want = jax_layers.lm_head(jax_params["embed"], jnp.asarray(x), jcfg)
        tp = {k: torch.from_numpy(np.array(v))
              for k, v in jax_params["embed"].items()}
        got = layers.lm_head(tp, torch.from_numpy(x), tcfg)
        tol = 1e-4
    assert got.dtype == {"float32": torch.float32,
                         "bfloat16": torch.bfloat16}[str(want.dtype)]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_lm_head_gives_f32_logits_from_bf16_operands():
    cfg = get_config("llada-8b").reduced(dtype="bfloat16")
    rs = np.random.default_rng(2)
    head = torch.from_numpy(rs.standard_normal((256, 512)).astype(
        np.float32)).to(torch.bfloat16)
    x = torch.from_numpy(rs.standard_normal((3, 256)).astype(
        np.float32)).to(torch.bfloat16)
    got = layers.lm_head({"head": head}, x, cfg)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, x.double().matmul(head.double()).float(),
                               rtol=1e-5, atol=1e-4)


def test_init_model_matches_reference_tree_and_scale():
    jcfg, tcfg = _configs(TESTBED)
    shapes = jax.eval_shape(
        lambda: jax_init_model(jax.random.PRNGKey(0), jcfg))
    want = {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                shapes)[0]}
    params = init_model(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert {k: v.shape for k, v in to_flat(params).items()} == want
    w = params["blocks"][0]["attn"]["wq"]
    std = 1 / np.sqrt(tcfg.d_model)
    assert abs(float(w.std()) / std - 0.986) < 0.03   # truncated at 3σ
    assert float(w.abs().max()) <= 3 * std + 1e-6
    assert torch.equal(params["norm_f"]["scale"],
                       torch.ones(tcfg.d_model))
    again = init_model(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["embed"]["tok"], params["embed"]["tok"])


def test_init_model_makes_compute_dtype_directly():
    cfg = get_config("llada-8b").reduced(dtype="bfloat16")
    params = init_model(cfg, device="cpu")
    assert params["embed"]["head"].dtype == torch.bfloat16
    assert params["blocks"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert params["blocks"][0]["norm1"]["scale"].dtype == torch.float32
    logits = forward(params, torch.zeros(1, 6, dtype=torch.long), cfg)
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    from repro_torch.configs import DecodeConfig
    from repro_torch.core import Decoder
    from repro_torch.serving import ServingEngine
    cfg = get_config("llada-8b-tiny")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_model(cfg)
    params = init_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Decoder(params, cfg, DecodeConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(params, cfg, DecodeConfig())


# The ids of the old refusals stay.  A VLM block is the dense block, so
# ``arch_type="vlm"`` builds and matches the reference (as LayerNorm's
# case does); an xLSTM config without its ``ssm`` config and M-RoPE without
# sections that split the rotary dims are still refused, with the port's
# messages (the reference fails on both too: AttributeError at init, an
# assertion in the forward).
@pytest.mark.parametrize("over,match", [
    pytest.param(dict(arch_type="vlm"), None,
                 id="over0-dense and hybrid blocks only"),
    pytest.param(dict(arch_type="ssm"), "no ssm config",
                 id="over1-dense and hybrid blocks only"),
    pytest.param(dict(rope="mrope"), "mrope_sections",
                 id="over2-only 'standard' and 'half' RoPE"),
    pytest.param(dict(norm="layernorm"), None, id="over3-RMSNorm only"),
])
def test_unported_architectures_raise(over, match):
    cfg = dataclasses.replace(get_config("llada-8b-tiny"), **over)
    jcfg = dataclasses.replace(jax_get_config("llada-8b-tiny"), **over)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 10)).astype(np.int32)
    if match is None:
        jp = jax.device_get(jax_init_model(jax.random.PRNGKey(0), jcfg))
        tp = from_jax_params(jp, device="cpu")
        ours = init_model(cfg, device="cpu")
        assert ("bias" in ours["blocks"][0]["norm1"]) == \
            (cfg.norm == "layernorm")
        assert {k: v.shape for k, v in to_flat(ours).items()} == \
            {k: v.shape for k, v in _flatten(jp).items()}
        want = jax_forward(jp, jnp.asarray(tokens), jcfg)[0]
        got = forward(tp, torch.from_numpy(tokens).long(), cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
        return
    with pytest.raises((AttributeError, AssertionError)):
        jp = jax_init_model(jax.random.PRNGKey(0), jcfg)
        jax_forward(jp, jnp.asarray(tokens), jcfg)
    with pytest.raises(ValueError, match=match):
        params = init_model(cfg, device="cpu")
        forward(params, torch.zeros(1, 4, dtype=torch.long), cfg)


def test_moe_arch_without_experts_builds_dense_blocks():
    """``arch_type="moe"`` with ``num_experts=0`` builds the dense block,
    as the reference does (a layer is MoE only when the config has
    experts): the same weights and logits as the dense config's."""
    dense = get_config("llada-8b-tiny")
    cfg = dataclasses.replace(dense, arch_type="moe")
    assert not cfg.is_moe
    params = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    want = init_model(dense, torch.Generator().manual_seed(0), device="cpu")
    assert all("mlp" in p and "moe" not in p for p in params["blocks"])
    got_flat, want_flat = to_flat(params), to_flat(want)
    assert sorted(got_flat) == sorted(want_flat)
    for key, arr in want_flat.items():
        np.testing.assert_array_equal(got_flat[key], arr, err_msg=key)
    tokens = torch.randint(0, cfg.vocab_size, (2, 12),
                           generator=torch.Generator().manual_seed(1))
    assert torch.equal(forward(params, tokens, cfg),
                       forward(want, tokens, dense))


# --------------------------------------------------------------------------
# the hybrid (Hymba) stack: attention ∥ Mamba
# --------------------------------------------------------------------------

# hymba reduced has window 32, so a 48-token canvas crosses the band; the
# G=5 variant groups heads like the full model's 25:5
HYBRID = {"reduced": {}, "gqa5": dict(d_model=320, num_heads=5,
                                      num_kv_heads=1)}


def _hybrid(over):
    jcfg = jax_get_config("hymba-1.5b").reduced(**over)
    jp = jax_init_model(jax.random.PRNGKey(1), jcfg)
    return jcfg, get_config("hymba-1.5b").reduced(**over), jp, \
        from_jax_params(jax.device_get(jp), device="cpu")


@pytest.mark.parametrize("name", sorted(HYBRID))
def test_hybrid_forward_logits_match_reference(name):
    jcfg, tcfg, jp, tp = _hybrid(HYBRID[name])
    assert tcfg.sliding_window == 32
    rs = np.random.default_rng(0)
    tokens = rs.integers(0, jcfg.vocab_size, (2, 48)).astype(np.int32)
    tokens[:, 20:] = jcfg.mask_token_id
    want = np.asarray(jax_forward(jp, jnp.asarray(tokens), jcfg)[0])
    got = forward(tp, torch.from_numpy(tokens).long(), tcfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", sorted(HYBRID))
def test_hybrid_block_matches_reference(name):
    from repro.models.blocks import block_forward as jax_block_forward
    from repro.models.model import make_positions as jax_positions
    from repro_torch.models.blocks import block_forward
    jcfg, tcfg, jp, tp = _hybrid(HYBRID[name])
    x = np.random.default_rng(4).standard_normal(
        (2, 48, jcfg.d_model)).astype(np.float32)
    blk = jax.tree.map(lambda a: a[1], jp["blocks"][0])
    blk = dict(blk, mix_attn=blk["mix_attn"] * 0.7,
               mix_ssm=blk["mix_ssm"] * 1.3)
    tblk = dict(tp["blocks"][1], **{
        k: torch.from_numpy(np.array(blk[k])) for k in ("mix_attn",
                                                         "mix_ssm")})
    want, _ = jax_block_forward(blk, jnp.asarray(x),
                                jax_positions(jcfg, 2, 48), jcfg, 1)
    got = block_forward(tblk, torch.from_numpy(x),
                        torch.arange(48)[None].expand(2, 48), tcfg, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_hybrid_bridge_round_trips_and_keeps_f32_vectors():
    jcfg, tcfg, jp, _ = _hybrid({})
    tree = jax.device_get(jp)
    want = _flatten(tree)
    got = to_flat(from_jax_params(tree, device="cpu"))
    assert sorted(got) == sorted(want)
    for key, arr in want.items():
        np.testing.assert_array_equal(got[key], arr, err_msg=key)
    assert "blocks/0/mamba/a_log" in got and "blocks/0/mix_ssm" in got
    bf = from_jax_params(tree, device="cpu", dtype=torch.bfloat16)
    layer = bf["blocks"][1]
    assert layer["mamba"]["w_in"].dtype == torch.bfloat16
    assert layer["mamba"]["conv_w"].dtype == torch.bfloat16
    for key in ("a_log", "dt_bias"):
        assert layer["mamba"][key].dtype == torch.float32
        np.testing.assert_array_equal(layer["mamba"][key].numpy(),
                                      want[f"blocks/0/mamba/{key}"][1])
    assert layer["mix_attn"].dtype == torch.float32


def test_hybrid_init_model_matches_reference_tree():
    jcfg, tcfg = (jax_get_config("hymba-1.5b").reduced(),
                  get_config("hymba-1.5b").reduced())
    shapes = jax.eval_shape(
        lambda: jax_init_model(jax.random.PRNGKey(0), jcfg))
    want = {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): (tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                shapes)[0]}
    params = init_model(tcfg, torch.Generator().manual_seed(0), device="cpu")
    got = {k: (v.shape, str(v.dtype)) for k, v in to_flat(params).items()}
    assert got == want
    m = params["blocks"][0]["mamba"]
    n = tcfg.ssm.state_size
    torch.testing.assert_close(m["a_log"][5], torch.log(
        torch.arange(1, n + 1, dtype=torch.float32)))
    assert torch.equal(m["dt_bias"], torch.full_like(m["dt_bias"], -4.6))
    assert torch.equal(params["blocks"][1]["mix_ssm"],
                       torch.ones(tcfg.d_model))
    bcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    bf = init_model(bcfg, device="cpu")
    assert bf["blocks"][0]["mamba"]["w_in"].dtype == torch.bfloat16
    assert bf["blocks"][0]["mamba"]["a_log"].dtype == torch.float32
    logits = forward(bf, torch.zeros(1, 6, dtype=torch.long), bcfg)
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
