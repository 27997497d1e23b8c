"""The port's kernel modules against the reference's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; it is held against
the reference's Pallas kernel in interpret mode and against the
reference's jnp oracle, on the same inputs made with numpy, at the shapes
and tolerances of ``tests/test_kernels.py``.  The hand-written CUDA
kernels are held against the plain versions on the card by
``tests/test_torch_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.confidence import ROWS, VTILE
from repro.kernels.confidence import confidence_fused as jax_confidence
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.ref import attention_ref as jax_attention_ref
from repro.kernels.ref import confidence_ref as jax_confidence_ref
from repro.models.attention import _sdpa, band_mask
from repro_torch.kernels import _build
from repro_torch.kernels import confidence as conf_mod
from repro_torch.kernels import flash_attention as fa_mod

CONF_SHAPES = [
    ((4, 7), 1000),        # ragged rows and vocab
    ((2, 3), VTILE + 3),   # one lane over a tile boundary
    ((5,), 2 * VTILE),     # exact tiles
    ((2, 2), 130),         # single partial tile
    ((ROWS + 1, 2), 513),  # row padding
]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(a: np.ndarray, dtype: str):
    """The same values as a JAX and a torch array (f32 -> bf16 rounds to
    nearest even in both)."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jnp.float32).astype(jdt), \
        torch.from_numpy(np.asarray(a, np.float32)).to(tdt)


def _assert_scores(got, want):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("shape,vocab", CONF_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_confidence_plain_matches_pallas_and_oracle(shape, vocab, dtype):
    rs = np.random.default_rng(abs(hash((shape, vocab))) % 2**31)
    jx, tx = _both(5 * rs.standard_normal(shape + (vocab,)), dtype)
    got = conf_mod.confidence_fused(tx)
    assert got[0].dtype == torch.int32 and got[0].shape == shape
    _assert_scores(got, jax_confidence(jx))
    _assert_scores(got, jax_confidence_ref(jx))


def test_confidence_duplicate_max_far_apart():
    """Tied maxima give margin exactly 0 and the lower index, as the
    reference's kernel and oracle do."""
    rs = np.random.default_rng(3)
    x = rs.standard_normal((3, 700)).astype(np.float32)
    x[1, 5] = x[1, 690] = x[1].max() + 1
    x[2, :] = 0.0
    jx, tx = _both(x, "float32")
    got = conf_mod.confidence_fused(tx)
    assert int(got[0][1]) == 5 and float(got[2][1]) == 0.0
    assert int(got[0][2]) == 0 and float(got[2][2]) == 0.0
    np.testing.assert_allclose(float(got[1][2]), 1 / 700, rtol=1e-5)
    _assert_scores(got, jax_confidence(jx))


def test_confidence_extreme_logits():
    x = np.array([[1e4, -1e4, 0.0, 5.0] * 200], np.float32)
    jx, tx = _both(x, "float32")
    got = conf_mod.confidence_fused(tx)
    want = jax_confidence_ref(jx)
    assert int(got[0][0]) == int(want[0][0])
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-5)
    assert torch.isfinite(got[3]).all()


ATTN_SHAPES = [
    (2, 100, 100, 2, 64, 0),
    (1, 256, 256, 1, 128, 0),
    (1, 300, 300, 2, 64, 50),     # banded + ragged
    (2, 128, 256, 1, 32, 0),      # cross lengths
    (1, 257, 257, 1, 64, 128),    # band wider than one tile
]


@pytest.mark.parametrize("b,lq,lk,h,d,w", ATTN_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_plain_matches_pallas_and_oracle(b, lq, lk, h, d, w,
                                                   dtype):
    rs = np.random.default_rng(1)
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(rs.standard_normal(s), dtype)
        for s in ((b, lq, h, d), (b, lk, h, d), (b, lk, h, d)))
    got = fa_mod.flash_attention(tq, tk, tv, w).float().numpy()
    tol = 2e-4 if dtype == "float32" else 2e-2
    for want in (jax_flash(jq, jk, jv, window=w),
                 jax_attention_ref(jq, jk, jv, window=w)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("h,g,w", [(8, 2, 0), (8, 1, 0), (4, 4, 0),
                                   (8, 2, 5)])
def test_attention_gqa_matches_reference_sdpa(h, g, w):
    """Native GQA grouping (kv head = h // (H/G)) against the reference
    model's ``_sdpa``, f32."""
    rs = np.random.default_rng(h * 10 + g + w)
    b, l, d = 2, 40, 32
    q, k, v = (rs.standard_normal(s).astype(np.float32)
               for s in ((b, l, h, d), (b, l, g, d), (b, l, g, d)))
    mask = band_mask(jnp.arange(l), jnp.arange(l), w) if w else None
    want = _sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask,
                 d ** -0.5)
    got = fa_mod.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_wrappers_refuse_other_devices():
    x = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        conf_mod.confidence_fused(x)
    q = torch.empty(1, 4, 2, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa_mod.flash_attention(q, q, q)


def test_plain_path_does_not_count_launches():
    before = (conf_mod.launches, fa_mod.launches)
    conf_mod.confidence_fused(torch.zeros(2, 16))
    q = torch.zeros(1, 4, 2, 32)
    fa_mod.flash_attention(q, q, q)
    assert (conf_mod.launches, fa_mod.launches) == before


def test_missing_toolchain_fails_the_build(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()


def test_library_is_keyed_by_source_and_built_in_ignored_dir():
    for name in _build.SOURCES:
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith(name + "-") and path.suffix == ".so"
    repo = _build.BUILD_DIR.parents[1]
    ignored = (repo / ".gitignore").read_text().split()
    assert "build/" in ignored
