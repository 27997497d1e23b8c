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


class _Elsewhere(torch.Tensor):
    """A CPU tensor that reports a device the wrappers do not take (meta
    tensors now get the kernels' stand-ins: ``test_torch_dryrun.py``)."""

    @property
    def device(self):
        return torch.device("xpu")


def test_wrappers_refuse_other_devices():
    x = torch.empty(2, 8).as_subclass(_Elsewhere)
    with pytest.raises(ValueError, match="unsupported device"):
        conf_mod.confidence_fused(x)
    q = torch.empty(1, 4, 2, 32).as_subclass(_Elsewhere)
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


# The card kernel (csrc/confidence.cu) emulated in plain f32 torch: one CTA
# of CTA_THREADS threads per row, CTA_LOADS 16-byte loads per thread in each
# body step — the kernel's kThreads and kLoads.
CTA_THREADS, CTA_LOADS = 256, 4
_NEG = -3.4e38                     # the kernel's kNeg, accumulator start
_LOG2E = 1.4426950408889634


def _cta_groups(vocab, mis, width, threads, loads):
    """The kernel's cut of one row whose first logit lies ``mis`` elements
    past a 16-byte boundary (``width`` logits per 16 bytes): the groups
    each thread folds, in its order, as ``(threads, g)`` index arrays with
    -1 where the value is masked.  Head (one logit for each of the first
    threads, up to the row's first 16-byte boundary), body steps (``loads``
    whole chunks per thread, at c0 + k*threads; the last step's surplus
    chunks masked), tail (one logit each, fewer than one chunk)."""
    t = np.arange(threads)
    head = min((width - mis) % width, vocab)
    chunks = (vocab - head) // width
    body_end = head + chunks * width
    groups = [np.where(t < head, t, -1)[:, None]]
    for c0 in range(0, chunks, loads * threads):
        c = c0 + t[:, None] + threads * np.arange(loads)[None, :]
        idx = head + c[:, :, None] * width + np.arange(width)
        idx = np.where((c < chunks)[:, :, None], idx, -1)
        groups.append(idx.reshape(threads, loads * width))
    groups.append(np.where(t < vocab - body_end, body_end + t, -1)[:, None])
    return groups


def _merge(a, b):
    """The kernel's ``merge`` of two partials (m, s, u, m2, i1): equal
    maxima give m2 = m and keep the lower index."""
    am, a_s, au, am2, ai = a
    bm, b_s, bu, bm2, bi = b
    m = torch.maximum(am, bm)
    ea, eb = torch.exp(am - m), torch.exp(bm - m)
    s = a_s * ea + b_s * eb
    u = torch.where(a_s > 0, au * ea, 0.0) + torch.where(b_s > 0, bu * eb, 0.0)
    m2 = torch.where(am > bm, torch.maximum(am2, bm),
                     torch.where(bm > am, torch.maximum(bm2, am), m))
    i1 = torch.where(am > bm, ai,
                     torch.where(bm > am, bi, torch.minimum(ai, bi)))
    return m, s, u, m2, i1


def _shfl_down(acc, off):
    """``__shfl_down_sync`` over the last (lane) axis: lane l reads lane
    l + off, or keeps its own value past the warp's end."""
    return tuple(torch.cat([a[..., off:], a[..., 32 - off:]], dim=-1)
                 for a in acc)


def _init(n):
    return (torch.full((n,), _NEG), torch.zeros(n), torch.zeros(n),
            torch.full((n,), _NEG), torch.zeros(n, dtype=torch.int64))


def _emulate_cta(row, mis, width, threads=CTA_THREADS, loads=CTA_LOADS):
    """One CTA of the kernel on one row (1-d f32): every thread folds its
    groups — the group's top two and first argmax by comparisons alone, a
    rescale only where the running max rises, then 2**((l - m)·log2 e)
    added without branches, a -inf logit adding exactly 0 to s and u —
    then the warp-shuffle tree and the tree across warps.  Returns
    (argmax, max_prob, margin, neg_entropy) as Python numbers."""
    values = torch.cat([row, torch.tensor([float("-inf")])])  # -1: masked
    m, s, u, m2, i1 = _init(threads)
    for idx in _cta_groups(row.numel(), mis, width, threads, loads):
        idx = torch.from_numpy(idx)
        v = values[idx]
        gm = torch.full((threads,), float("-inf"))
        g2 = gm.clone()
        gi = torch.zeros(threads, dtype=torch.int64)
        for p in range(v.shape[1]):
            g2 = torch.maximum(g2, torch.minimum(gm, v[:, p]))
            gi = torch.where(v[:, p] > gm, idx[:, p], gi)
            gm = torch.maximum(gm, v[:, p])
        rise = gm > m
        alpha = torch.exp2((m - gm) * _LOG2E)
        s = torch.where(rise, s * alpha, s)
        u = torch.where(rise, u * alpha, u)
        m2 = torch.where(rise, torch.maximum(m, g2), torch.maximum(m2, gm))
        i1 = torch.where(rise, gi, i1)
        m = torch.where(rise, gm, m)
        for p in range(v.shape[1]):
            e = torch.exp2((v[:, p] - m) * _LOG2E)
            s = s + e
            u = u + torch.maximum(v[:, p], torch.tensor(_NEG)) * e
    warps = threads // 32
    acc = tuple(a.reshape(warps, 32) for a in (m, s, u, m2, i1))
    for off in (16, 8, 4, 2, 1):
        acc = _merge(acc, _shfl_down(acc, off))
    acc = tuple(torch.cat([a[:, 0], b[warps:]])
                for a, b in zip(acc, _init(32)))
    off = warps // 2
    while off:
        acc = _merge(acc, _shfl_down(acc, off))
        off //= 2
    m, s, u, m2, i1 = (a[0] for a in acc)
    inv_s = 1.0 / s
    p2 = torch.exp(m2 - m) * inv_s
    return (int(i1), float(inv_s), float(inv_s - p2),
            float(u * inv_s - (m + torch.log(s))))


def _emulate_rows(tx, mis, threads=CTA_THREADS, loads=CTA_LOADS):
    """``_emulate_cta`` on every row of ``tx`` (f32 or bf16, as the kernel
    reads it), each row ``mis`` elements past a 16-byte boundary; returns
    the four outputs as tensors, like ``confidence_fused``."""
    width = 16 // tx.element_size()
    outs = [_emulate_cta(r, mis, width, threads, loads) for r in tx.float()]
    return (torch.tensor([o[0] for o in outs], dtype=torch.int32),
            *(torch.tensor([o[j] for o in outs]) for j in (1, 2, 3)))


@pytest.mark.parametrize("dtype,mis", [("float32", m) for m in range(4)] +
                         [("bfloat16", m) for m in range(8)])
def test_confidence_cta_emulation_row_offsets(dtype, mis):
    """Every row offset mod 16 (4 for f32, 8 for bf16) at the kernel's
    thread count and loads: a head, full body steps, a partial step and
    a tail, held against the plain version and the Pallas kernel."""
    rs = np.random.default_rng(40 + mis)
    jx, tx = _both(5 * rs.standard_normal((2, 10009)), dtype)
    got = _emulate_rows(tx, mis)
    _assert_scores(got, conf_mod.confidence_ref(tx))
    _assert_scores(got, jax_confidence(jx))


@pytest.mark.parametrize("threads,loads,mis", [(32, 1, 1), (64, 2, 3),
                                               (128, 8, 2)])
def test_confidence_cta_emulation_other_widths(threads, loads, mis):
    """The same cut and merge trees at other thread counts and loads per
    step: many full steps, one warp, a four-warp tree."""
    rs = np.random.default_rng(threads + loads)
    jx, tx = _both(5 * rs.standard_normal((2, 10009)), "float32")
    got = _emulate_rows(tx, mis, threads, loads)
    _assert_scores(got, conf_mod.confidence_ref(tx))
    _assert_scores(got, jax_confidence(jx))


# tied maxima, placed by the cut of a row at the offset below: (where,
# indices as a function of head, width, body_end, vocab)
TIES = {
    "head_and_body": lambda h, w, be, v: (1, v // 2),
    "body_and_tail": lambda h, w, be, v: (v // 2, v - 1),
    "head_and_tail": lambda h, w, be, v: (h - 1, be),
    "one_group": lambda h, w, be, v: (h + 1, h + CTA_THREADS * w + 2),
    "one_thread_two_steps": lambda h, w, be, v: (
        h, h + CTA_LOADS * CTA_THREADS * w),
    # the lower index in thread 1, the higher in thread 0's second step
    "two_threads": lambda h, w, be, v: (
        h + w, h + CTA_LOADS * CTA_THREADS * w + 1),
    "two_warps": lambda h, w, be, v: (h + 40 * w + 1, h + 300 * w),
}


@pytest.mark.parametrize("where", sorted(TIES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_confidence_cta_emulation_tied_maxima(where, dtype):
    """A maximum that occurs twice gives margin exactly 0 and the lower
    index, wherever the two copies lie: head, body, tail, one thread's
    group or steps, two threads, two warps."""
    mis, vocab = (1, 10009) if dtype == "float32" else (3, 10010)
    width = 4 if dtype == "float32" else 8
    head = (width - mis) % width
    body_end = head + (vocab - head) // width * width
    assert 0 < head and body_end < vocab
    i, j = TIES[where](head, width, body_end, vocab)
    rs = np.random.default_rng(7)
    x = 5 * rs.standard_normal((1, vocab))
    x[0, [i, j]] = x.max() + 1
    jx, tx = _both(x, dtype)
    got = _emulate_rows(tx, mis)
    assert int(got[0][0]) == min(i, j) and float(got[2][0]) == 0.0
    _assert_scores(got, conf_mod.confidence_ref(tx))
    _assert_scores(got, jax_confidence(jx))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_confidence_cta_emulation_all_equal_row(dtype):
    """Every logit tied: argmax 0, margin exactly 0, max prob 1/V."""
    jx, tx = _both(np.full((1, 3001), 0.5), dtype)
    got = _emulate_rows(tx, 1)
    assert int(got[0][0]) == 0 and float(got[2][0]) == 0.0
    np.testing.assert_allclose(float(got[1][0]), 1 / 3001, rtol=1e-5)
    _assert_scores(got, jax_confidence(jx))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_confidence_cta_emulation_extreme_and_neginf_logits(dtype):
    """±1e4 logits, and -inf logits, which add exactly 0 to s and u: the
    plain version (whose Σ p log p takes 0·(-inf) = NaN there) is held
    against on the same row with -inf as the lowest finite f32."""
    rs = np.random.default_rng(11)
    x = 5 * rs.standard_normal((3, 3001))
    x[0, ::3], x[0, 1::3] = 1e4, -1e4
    x[1, ::5] = -np.inf
    x[2, :] = -np.inf
    x[2, [7, 2000]] = 1.0
    jx, tx = _both(x, dtype)
    got = _emulate_rows(tx, 2)
    assert all(torch.isfinite(g).all() for g in got[1:])
    finite = torch.nan_to_num(tx.float(),
                              neginf=torch.finfo(torch.float32).min)
    _assert_scores(got, conf_mod.confidence_ref(finite))
    _assert_scores(tuple(g[:1] for g in got), jax_confidence(jx[:1]))
    assert int(got[0][2]) == 7 and float(got[2][2]) == 0.0
    np.testing.assert_allclose(float(got[1][2]), 0.5, rtol=1e-6)


@pytest.mark.parametrize("dtype,mis,vocab", [
    ("float32", 0, 3),     # shorter than one chunk: all tail
    ("float32", 1, 2),     # shorter than the head
    ("float32", 3, 4),     # head 1, tail 3
    ("float32", 2, 7),     # head 2, one chunk, tail 1
    ("bfloat16", 0, 7),    # shorter than one chunk
    ("bfloat16", 1, 5),    # shorter than the head
    ("bfloat16", 5, 11),   # head 3, one chunk
    ("bfloat16", 7, 12),   # head 1, one chunk, tail 3
])
def test_confidence_cta_emulation_short_rows(dtype, mis, vocab):
    rs = np.random.default_rng(vocab + mis)
    jx, tx = _both(5 * rs.standard_normal((3, vocab)), dtype)
    got = _emulate_rows(tx, mis)
    _assert_scores(got, conf_mod.confidence_ref(tx))
    _assert_scores(got, jax_confidence(jx))


@pytest.mark.parametrize("vocab", [32001, 126464])
@pytest.mark.parametrize("width", [4, 8])
def test_confidence_cta_cut_covers_vocab_once(vocab, width):
    """At Hymba's and LLaDA's V, for every row offset: the head ends on a
    16-byte boundary, every vocab index is read exactly once, and each
    thread's indices rise along its stream (the argmax tie rule)."""
    for mis in range(width):
        groups = _cta_groups(vocab, mis, width, CTA_THREADS, CTA_LOADS)
        head = int((groups[0] >= 0).sum())
        assert head < width and (mis + head) % width == 0
        assert int((groups[-1] >= 0).sum()) < width
        idx = np.concatenate(groups, axis=1)
        np.testing.assert_array_equal(np.sort(idx[idx >= 0]),
                                      np.arange(vocab))
        for stream in idx:
            assert np.all(np.diff(stream[stream >= 0]) > 0)
