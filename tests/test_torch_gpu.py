"""The port's hand-written kernels against their plain versions, and its
CUDA-graph decode drivers against the eager one, on the card.

Every test here is marked ``gpu`` and skips without a CUDA card.  The file
imports nothing of JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest \\
        tests/test_torch_gpu.py

(``--noconftest``: the suite's ``conftest.py`` imports JAX.)  Tolerances
are the reference's kernel tests': 2e-4 in f32, 2e-2 (attention) and 3e-2
(selective scan, y rounded to bf16) in bf16.  Attention in f32 runs the
FMA kernel, in bf16 the tensor-core kernel.
"""
import pytest
import torch

from repro_torch.kernels import confidence as conf_mod
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import selective_scan as scan_mod

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("rows,vocab", [(512, 126464), (512, 32001),
                                        (7, 1000), (5, 513)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_confidence_kernel_matches_plain(cuda, rows, vocab, dtype):
    gen = torch.Generator(device=cuda).manual_seed(rows)
    x = (5 * torch.randn(rows, vocab, generator=gen, device=cuda)).to(dtype)
    x[1, 2] = x[1, vocab - 3] = x[1].max() + 1
    before = conf_mod.launches
    got = conf_mod.confidence_fused(x)
    torch.cuda.synchronize()
    assert conf_mod.launches == before + 1
    want = conf_mod.confidence_ref(x)
    assert torch.equal(got[0], want[0]) and float(got[2][1]) == 0.0
    torch.testing.assert_close(got[1], want[1], rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(got[2], want[2], rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(got[3], want[3], rtol=2e-3, atol=2e-4)


def _conf_logits(device, rows, vocab, dtype, seed):
    """Logits with a maximum tied at two far-apart indices in row 1."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = (5 * torch.randn(rows, vocab, generator=gen, device=device)).to(dtype)
    x[1, 2] = x[1, vocab - 3] = x[1].max() + 1
    return x


def _check_conf_kernel(x):
    """One launch, argmax exact, margin 0 on row 1's tie, the rest within
    the tolerances of ``test_confidence_kernel_matches_plain``."""
    before = conf_mod.launches
    got = conf_mod.confidence_fused(x)
    torch.cuda.synchronize()
    assert conf_mod.launches == before + 1
    want = conf_mod.confidence_ref(x)
    assert torch.equal(got[0], want[0]) and float(got[2][1]) == 0.0
    torch.testing.assert_close(got[1], want[1], rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(got[2], want[2], rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(got[3], want[3], rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_confidence_kernel_hymba_scoring_shape(cuda, dtype):
    """Hymba's scoring batch, 256 x 32001: f32 rows start 0, 4, 8 and 12
    bytes past a 16-byte boundary, bf16 rows 0, 2, ... 14."""
    _check_conf_kernel(_conf_logits(cuda, 256, 32001, dtype, seed=256))


@pytest.mark.parametrize("vocab", [32001, 126464])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_confidence_kernel_misaligned_base(cuda, dtype, vocab):
    """Logits in a contiguous view that starts one element into a larger
    buffer: every row's head is peeled from its own address."""
    x = _conf_logits(cuda, 16, vocab, dtype, seed=vocab)
    flat = torch.empty(x.numel() + 1, device=cuda, dtype=dtype)
    shifted = flat[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    _check_conf_kernel(shifted)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_confidence_kernel_is_bitwise_deterministic(cuda, dtype):
    """No atomics and a fixed merge order: equal inputs, equal bits."""
    x = _conf_logits(cuda, 512, 32001, dtype, seed=9)
    first = conf_mod.confidence_fused(x)
    second = conf_mod.confidence_fused(x)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("b,l,h,g,d,w,dtype", [
    (2, 128, 32, 32, 128, 0, torch.bfloat16),
    (2, 128, 32, 8, 128, 0, torch.bfloat16),
    (1, 300, 2, 2, 64, 50, torch.float32),
    (1, 257, 1, 1, 256, 128, torch.bfloat16),
    (2, 128, 25, 5, 64, 1024, torch.bfloat16),    # Hymba's heads
    (1, 600, 25, 5, 64, 256, torch.float32),      # Hymba's, band live
])
def test_flash_kernel_matches_plain(cuda, b, l, h, g, d, w, dtype):
    gen = torch.Generator(device=cuda).manual_seed(l)
    q = torch.randn(b, l, h, d, generator=gen, device=cuda).to(dtype)
    k = torch.randn(b, l, g, d, generator=gen, device=cuda).to(dtype)
    v = torch.randn(b, l, g, d, generator=gen, device=cuda).to(dtype)
    before = fa_mod.launches
    got = fa_mod.flash_attention(q, k, v, w)
    torch.cuda.synchronize()
    assert fa_mod.launches == before + 1
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(),
                               fa_mod.attention_ref(q, k, v, w).float(),
                               rtol=tol, atol=tol)


# head dims that are multiples of 16 but not of 32 (and stablelm-12b's
# 160): stablelm-3b's serving shape at d=80 with and without a band, a
# ragged L, and one shape per other new dim
@pytest.mark.parametrize("b,l,h,g,d,w", [
    (2, 128, 32, 32, 80, 0),
    (2, 128, 32, 32, 80, 32),
    (1, 130, 4, 2, 80, 17),
    (2, 128, 32, 8, 160, 0),
    *[(1, 130, 4, 1, d, 0) for d in (48, 112, 144, 176, 208, 240)],
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_multiples_of_16_match_plain(cuda, b, l, h, g, d, w,
                                                  dtype):
    gen = torch.Generator(device=cuda).manual_seed(l + d + w)
    q = torch.randn(b, l, h, d, generator=gen, device=cuda).to(dtype)
    k = torch.randn(b, l, g, d, generator=gen, device=cuda).to(dtype)
    v = torch.randn(b, l, g, d, generator=gen, device=cuda).to(dtype)
    before = fa_mod.launches
    got = fa_mod.flash_attention(q, k, v, w)
    torch.cuda.synchronize()
    assert fa_mod.launches == before + 1 and got.shape == q.shape
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(),
                               fa_mod.attention_ref(q, k, v, w).float(),
                               rtol=tol, atol=tol)


def _bf16_qkv(device, b, lq, lk, h, g, d, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(b, lq, h, d, generator=gen, device=device)
            .to(torch.bfloat16),
            torch.randn(b, lk, g, d, generator=gen, device=device)
            .to(torch.bfloat16),
            torch.randn(b, lk, g, d, generator=gen, device=device)
            .to(torch.bfloat16))


@pytest.mark.parametrize("b,lq,lk,h,g,d,w", [
    (1, 130, 130, 2, 2, 32, 0),          # d=32, L not a multiple of 64
    (1, 130, 130, 4, 1, 96, 0),          # d=96, one kv head
    (1, 200, 200, 2, 1, 256, 17),        # d=256 (Q re-read per k-step)
    (2, 64, 200, 8, 8, 64, 0),           # Lq < Lk
    (1, 200, 64, 4, 2, 128, 0),          # Lq > Lk
    (1, 64, 200, 4, 4, 64, 17),          # Lq < Lk under a band
    (1, 130, 130, 25, 5, 64, 1),         # band of one key, G=5
    (2, 130, 130, 32, 8, 128, 17),       # band inside a tile, G=8
    (1, 130, 130, 8, 1, 128, 0),         # G=1
    (1, 300, 300, 25, 5, 64, 64),        # band of exactly one tile width
])
def test_flash_bf16_tensor_core_edges(cuda, b, lq, lk, h, g, d, w):
    """The bf16 tensor-core kernel at its edges: every head dim class,
    ragged and unequal lengths, bands narrower than a tile, GQA groups."""
    q, k, v = _bf16_qkv(cuda, b, lq, lk, h, g, d, seed=lq + 7 * lk + d + w)
    before = fa_mod.launches
    got = fa_mod.flash_attention(q, k, v, w)
    torch.cuda.synchronize()
    assert fa_mod.launches == before + 1 and got.shape == q.shape
    torch.testing.assert_close(got.float(),
                               fa_mod.attention_ref(q, k, v, w).float(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("b,lq,lk,h,g,d,w,q_offset", [
    (2, 64, 2048, 25, 5, 64, 1024, 1024),   # whole key tiles skipped
    (2, 32, 128, 32, 32, 128, 32, 64),      # a dual window under a band
    (1, 70, 300, 4, 2, 64, 17, 100),        # ragged rows, band mid-tile
    (1, 64, 200, 4, 4, 32, 40, 136),        # window at the canvas's end
    (2, 64, 128, 8, 8, 128, 0, 64),         # no band: the offset is inert
    (4, 64, 128, 32, 32, 128, 0, 64),       # the prefix K-candidate batch
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_q_offset_matches_plain(cuda, b, lq, lk, h, g, d, w,
                                             q_offset, dtype):
    """The band of a cached window: query row i at position q_offset + i,
    in both kernels."""
    gen = torch.Generator(device=cuda).manual_seed(lq + lk + q_offset)
    q = torch.randn(b, lq, h, d, generator=gen, device=cuda).to(dtype)
    k = torch.randn(b, lk, g, d, generator=gen, device=cuda).to(dtype)
    v = torch.randn(b, lk, g, d, generator=gen, device=cuda).to(dtype)
    before = fa_mod.launches
    got = fa_mod.flash_attention(q, k, v, w, q_offset)
    torch.cuda.synchronize()
    assert fa_mod.launches == before + 1
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(
        got.float(), fa_mod.attention_ref(q, k, v, w, q_offset).float(),
        rtol=tol, atol=tol)


def test_flash_refuses_negative_q_offset(cuda):
    q, k, v = _bf16_qkv(cuda, 1, 64, 64, 2, 2, 64, seed=6)
    with pytest.raises(ValueError, match="q_offset"):
        fa_mod.flash_attention(q, k, v, 8, -1)


def test_flash_bf16_refuses_misaligned_storage(cuda):
    """The tensor-core kernel copies 16-byte chunks: a contiguous bf16
    view that starts off a 16-byte boundary is refused, not misread."""
    q, k, v = _bf16_qkv(cuda, 1, 64, 64, 2, 2, 64, seed=5)
    flat = torch.empty(q.numel() + 1, device=cuda, dtype=torch.bfloat16)
    shifted = flat[1:].view(q.shape)
    shifted.copy_(q)
    assert shifted.is_contiguous()
    with pytest.raises(RuntimeError, match="launch failed"):
        fa_mod.flash_attention(shifted, k, v)


def test_flash_bf16_is_bitwise_deterministic(cuda):
    """No atomics and no order that varies: equal inputs, equal bits."""
    q, k, v = _bf16_qkv(cuda, 2, 300, 300, 25, 5, 64, seed=3)
    first = fa_mod.flash_attention(q, k, v, 128)
    second = fa_mod.flash_attention(q, k, v, 128)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def _scan_args(device, b, l, di, n, xdt, rdt):
    gen = torch.Generator(device=device).manual_seed(l + di)
    x = torch.randn(b, l, di, generator=gen, device=device).to(xdt)
    delta = torch.nn.functional.softplus(
        torch.randn(b, l, di, generator=gen, device=device) - 2).to(rdt)
    bs = torch.randn(b, l, n, generator=gen, device=device).to(rdt)
    cs = torch.randn(b, l, n, generator=gen, device=device).to(rdt)
    a_log = torch.log(torch.arange(1, n + 1, device=device,
                                   dtype=torch.float32))[None].repeat(di, 1)
    return x, delta, bs, cs, a_log


@pytest.mark.parametrize("b,l,di,n,xdt,rdt", [
    (2, 128, 3200, 16, torch.bfloat16, torch.float32),   # serving shape
    (2, 300, 130, 16, torch.float32, torch.float32),     # ragged L and di
    (1, 256, 128, 8, torch.bfloat16, torch.bfloat16),
    (1, 600, 64, 4, torch.float32, torch.float32),
    (1, 70, 40, 32, torch.float32, torch.bfloat16),
    (1, 33, 17, 5, torch.float32, torch.float32),        # N not a power of 2
    (1, 2048, 3200, 16, torch.bfloat16, torch.float32),  # 16 chunks of 128
    (4, 128, 3200, 16, torch.bfloat16, torch.float32),   # K-candidate batch
    (1, 1, 64, 16, torch.float32, torch.float32),        # L = 1: one pass
    (1, 15, 33, 5, torch.float32, torch.float32),        # L under one chunk
])
def test_scan_kernel_matches_plain(cuda, b, l, di, n, xdt, rdt):
    args = _scan_args(cuda, b, l, di, n, xdt, rdt)
    before = scan_mod.launches
    got = scan_mod.selective_scan(*args)
    torch.cuda.synchronize()
    assert scan_mod.launches == before + 1 and got.dtype == xdt
    tol = 2e-4 if xdt == torch.float32 else 3e-2
    want = scan_mod.selective_scan_ref(*args)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_scan_is_bitwise_deterministic(cuda):
    """No atomics and a fixed carry-fold order: equal inputs, equal bits."""
    args = _scan_args(cuda, 2, 300, 3200, 16, torch.bfloat16, torch.float32)
    first = scan_mod.selective_scan(*args)
    second = scan_mod.selective_scan(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("name", ["llada-8b", "hymba-1.5b"])
def test_reduced_forward_on_card_matches_cpu(cuda, name):
    """The whole forward through the kernels (f32) against the plain
    versions on the CPU, same weights: within 1e-4, as the CPU parity
    tests hold the port to the reference."""
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_model
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(name).reduced()
    params = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 48),
                           generator=torch.Generator().manual_seed(1))
    want = forward(params, tokens, cfg)

    def to_cuda(tree):
        if isinstance(tree, dict):
            return {k: to_cuda(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_cuda(v) for v in tree]
        return tree.to(cuda)
    before = (fa_mod.launches, scan_mod.launches)
    got = forward(to_cuda(params), tokens.to(cuda), cfg)
    torch.cuda.synchronize()
    assert fa_mod.launches == before[0] + cfg.num_layers
    assert scan_mod.launches == before[1] + (
        cfg.num_layers if cfg.arch_type == "hybrid" else 0)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("win_start,width", [(16, 32), (16, 8), (40, 8)])
def test_reduced_forward_cached_on_card_matches_cpu(cuda, win_start, width):
    """The block cache through the kernels (f32): capture on a stale
    canvas, then a live window's logits, against the plain versions on
    the CPU from the same weights: equal argmaxes, logits within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.models import capture_cache, forward_cached, init_model
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("llada-8b").reduced()
    params = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    canvas = torch.randint(0, cfg.vocab_size, (2, 48),
                           generator=torch.Generator().manual_seed(2))
    stale = canvas.clone()
    stale[:, 16:] = cfg.mask_token_id
    window = canvas[:, win_start:win_start + width]
    want = forward_cached(params, window, win_start,
                          capture_cache(params, stale, cfg), cfg)

    def to_cuda(tree):
        if isinstance(tree, dict):
            return {k: to_cuda(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_cuda(v) for v in tree]
        return tree.to(cuda)
    gp = to_cuda(params)
    before = fa_mod.launches
    state = capture_cache(gp, stale.to(cuda), cfg)
    got = forward_cached(gp, window.to(cuda), win_start, state, cfg)
    torch.cuda.synchronize()
    assert fa_mod.launches == before + 2 * cfg.num_layers
    assert torch.equal(got.argmax(-1).cpu(), want.argmax(-1))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------
# the CUDA-graph drivers (core/graphs.py, core/loop.py)
# --------------------------------------------------------------------------

def _reduced(cuda, name="llada-8b"):
    """A reduced config's seeded weights on the card (f32) and a prompt."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(name).reduced()
    params = init_model(cfg, torch.Generator(device=cuda).manual_seed(0),
                        device=cuda)
    prompt = torch.randint(0, cfg.vocab_size - 1, (2, 16), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(1))
    return cfg, params, prompt


def _capture(fn):
    """``fn`` captured into a graph on a side stream, after one warm-up."""
    from repro_torch.core.graphs import GraphSet
    graphs = GraphSet(torch.device("cuda"))
    graphs.warm(fn)
    return lambda: graphs.run("g", fn)


def test_masked_body_writes_only_where_its_predicate_holds(cuda):
    """``run_masked`` under capture: the body's values land on a replay
    exactly when the predicate, read on the card at replay time, holds."""
    from repro_torch.core.graphs import run_masked
    pred = torch.zeros((), dtype=torch.bool, device=cuda)
    out = (torch.zeros(4, device=cuda), torch.zeros((), dtype=torch.int32,
                                                    device=cuda))
    replay = _capture(lambda: run_masked(pred, lambda: (out[0] + 1,
                                                        out[1] + 2), out))
    for t in out:
        t.zero_()
    for p, want in ((False, 0), (True, 1), (True, 2), (False, 2)):
        pred.fill_(p)
        replay()
        torch.cuda.synchronize()
        assert torch.equal(out[0], torch.full_like(out[0], want))
        assert int(out[1]) == 2 * want


def test_kernels_in_a_graph_match_eager(cuda):
    """All three hand-written kernels recorded into one graph (the
    selective scan's second pass is a programmatic dependent launch) give
    the eager call's results, and count as executed launches once per
    replay."""
    from repro_torch.core.graphs import GraphSet
    gen = torch.Generator(device=cuda).manual_seed(3)
    logits = torch.randn(64, 1000, generator=gen, device=cuda)
    q, k, v = (torch.randn(2, 48, 4, 64, generator=gen, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    x = torch.randn(2, 300, 130, generator=gen, device=cuda)
    delta = torch.nn.functional.softplus(x - 2)
    bs, cs = (torch.randn(2, 300, 16, generator=gen, device=cuda)
              for _ in range(2))
    a_log = torch.log(torch.arange(1, 17, device=cuda,
                                   dtype=torch.float32))[None].repeat(130, 1)
    static = {name: torch.zeros(shape, device=cuda) for name, shape in (
        ("conf", (64,)), ("attn", (2, 48, 4, 64)), ("scan", (2, 300, 130)))}

    def body():
        return {"conf": conf_mod.confidence_fused(logits)[1],
                "attn": fa_mod.flash_attention(q, k, v, 0, 0).float(),
                "scan": scan_mod.selective_scan(x, delta, bs, cs, a_log)}

    def graph_body():
        for key, val in body().items():
            static[key].copy_(val)

    graphs = GraphSet(cuda)
    graphs.warm(graph_body)
    for t in static.values():
        t.zero_()
    graphs.run("g", graph_body)
    graphs.run("g", None)
    want = body()
    torch.cuda.synchronize()
    for key in want:
        assert torch.equal(static[key], want[key]), key
    assert graphs.executed_launches() == {
        "confidence": 2, "flash_attention": 2, "selective_scan": 2}
    graphs.reset_counts()
    assert not graphs.executed_launches()


def test_registered_generator_draws_in_a_graph(cuda):
    """The set's generator, registered with the graph: a replay draws from
    its state and advances it; the same state draws the same numbers."""
    from repro_torch.core.graphs import GraphSet
    gen = torch.Generator(device=cuda).manual_seed(5)
    graphs = GraphSet(cuda, gen)
    out = torch.zeros(1000, device=cuda)

    def fn():
        out.copy_(torch.rand(1000, generator=gen, device=cuda))
    graphs.warm(fn)
    gen.manual_seed(7)
    state = gen.get_state()
    draws = []
    for _ in range(2):
        graphs.run("g", fn)
        draws.append(out.clone())
    gen.set_state(state)
    graphs.run("g", fn)
    torch.cuda.synchronize()
    assert not torch.equal(draws[0], draws[1])
    assert torch.equal(out, draws[0])
    assert 0.4 < float(out.mean()) < 0.6


def test_copy_into_a_static_buffer_is_seen_by_the_next_replay(cuda):
    """A cache refresh writes into the buffers a step graph reads, by
    ``copy_``; the next replay sees the new contents."""
    cache = torch.ones(8, device=cuda)
    out = torch.zeros(8, device=cuda)
    replay = _capture(lambda: out.copy_(cache * 2))
    replay()
    cache.copy_(torch.arange(8, device=cuda, dtype=torch.float32))
    replay()
    torch.cuda.synchronize()
    assert torch.equal(out, 2 * torch.arange(8, device=cuda,
                                             dtype=torch.float32))


STRATS = [dict(strategy="probability"), dict(strategy="fdm", gamma=0.0),
          dict(strategy="fdm_a", eta1=0.025, eta2=0.02, gamma1=0.0,
               n_max=4), dict(strategy="eb")]


@pytest.mark.parametrize("policy", ["none", "prefix", "dual"])
@pytest.mark.parametrize("kw", STRATS, ids=lambda kw: kw["strategy"])
def test_graph_drivers_match_the_eager_driver(cuda, kw, policy):
    """A captured step equals the eager step: the whole-request and the
    per-block graph drivers decode the eager driver's tokens, steps,
    forward-equivalents and phase counts on the card."""
    import dataclasses
    from repro_torch.configs import DecodeConfig
    from repro_torch.core import Decoder
    cfg, params, prompt = _reduced(cuda)
    dcfg = DecodeConfig(gen_length=32, block_size=8, steps=32,
                        cache_policy=policy, **kw)
    runs = []
    for over in (dict(fused_loop=False), dict(fused_blocks=False), {}):
        dec = Decoder(params, cfg, dataclasses.replace(dcfg, **over),
                      device=cuda)
        for _ in range(2):               # the second reuses the graphs
            runs.append(dec.generate(None, prompt))
    for out, st in runs[1:]:
        assert torch.equal(out, runs[0][0])
        assert st.steps == runs[0][1].steps
        assert st.forward_equivalents == runs[0][1].forward_equivalents
        assert st.phase_counts == runs[0][1].phase_counts


CARRY_CASES = {
    "wino_r": dict(strategy="wino_r", wino_revoke_tau=0.99,
                   wino_revoke_budget=4),
    "extrapolate": dict(strategy="extrapolate", extrap_tau=0.0,
                        extrap_min_obs=1),
    "fdm_a+trace": dict(strategy="fdm_a", eta1=0.025, eta2=0.02,
                        gamma1=0.0, n_max=4, trace=True),
    "wino_r+trace": dict(strategy="wino_r", wino_revoke_tau=0.99,
                         wino_revoke_budget=4, trace=True),
    "extrapolate+trace": dict(strategy="extrapolate", extrap_tau=0.0,
                              extrap_min_obs=1, trace=True)}


def _same_trace(got, want):
    import numpy as np
    for field in ("commit_step", "commits", "revocations", "skipped",
                  "phase", "block"):
        assert np.array_equal(getattr(got, field), getattr(want, field)), \
            field
    assert np.array_equal(np.isnan(got.commit_conf),
                          np.isnan(want.commit_conf))
    np.testing.assert_allclose(got.commit_conf, want.commit_conf,
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("policy", ["none", "prefix", "dual"])
@pytest.mark.parametrize("case", sorted(CARRY_CASES))
def test_carry_and_traced_graph_decodes_match_eager(cuda, case, policy):
    """The carry-ful strategies and traced decodes on captured graphs
    (the positional carry windowed into the static buffers, the trace
    written at a device pointer) equal the eager driver on the card:
    tokens, steps, forward-equivalents, revocations, skips and trace."""
    import dataclasses
    from repro_torch.configs import DecodeConfig
    from repro_torch.core import Decoder
    cfg, params, prompt = _reduced(cuda)
    dcfg = DecodeConfig(gen_length=32, block_size=8, steps=20,
                        cache_policy=policy, **CARRY_CASES[case])
    runs = []
    for over in (dict(fused_loop=False), dict(fused_blocks=False), {}):
        dec = Decoder(params, cfg, dataclasses.replace(dcfg, **over),
                      device=cuda)
        for _ in range(2):               # the second reuses the graphs
            runs.append(dec.generate(None, prompt))
    want, ws = runs[0]
    assert ws.revocations > 0 or ws.skipped_forwards > 0 or \
        case.startswith("fdm_a")
    for out, st in runs[1:]:
        assert torch.equal(out, want)
        assert (st.steps, st.forward_equivalents, st.revocations,
                st.skipped_forwards, st.phase_counts) == \
            (ws.steps, ws.forward_equivalents, ws.revocations,
             ws.skipped_forwards, ws.phase_counts)
        if dcfg.trace:
            _same_trace(st.trace, ws.trace)


@pytest.mark.parametrize("case", ["wino_r+trace", "extrapolate+trace"])
def test_traced_decode_does_not_sync(cuda, case):
    """The trace's writes at the device pointer read nothing back: the
    steps capture, and a whole-request traced decode makes no implicit
    synchronising call."""
    from repro_torch.configs import DecodeConfig
    from repro_torch.core import Decoder
    cfg, params, prompt = _reduced(cuda)
    dcfg = DecodeConfig(gen_length=32, block_size=8, steps=20,
                        cache_policy="dual", **CARRY_CASES[case])
    dec = Decoder(params, cfg, dcfg, device=cuda)
    want, ws = dec.generate(None, prompt)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, st = dec.generate(None, prompt)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got, want)
    assert st.trace.commit_histogram().sum() == st.tokens_generated
    assert st.trace.steps == st.steps == ws.steps


@pytest.mark.parametrize("case", ["fdm_a+trace", "wino_r+trace"])
def test_first_capture_waits_for_the_current_stream(cuda, case,
                                                    monkeypatch):
    """A new run's first decode with the current stream still busy when
    its first step is captured: the capture stream's own work before the
    capture (the generator's seed and offset fills) must not overtake the
    reset the current stream has queued, so the trace has no commit in a
    prompt column and equals the eager driver's."""
    import dataclasses
    from repro_torch.configs import DecodeConfig
    from repro_torch.core import Decoder, decode_cache_scope, loop
    cfg, params, prompt = _reduced(cuda)
    dcfg = DecodeConfig(gen_length=32, block_size=8, steps=20,
                        **CARRY_CASES[case])
    want, ws = Decoder(params, cfg, dataclasses.replace(
        dcfg, fused_loop=False), device=cuda).generate(None, prompt)
    busy = torch.randn(4096, 4096, device=cuda)
    start = loop.GraphRun.start

    def busy_start(run, *args):
        for _ in range(40):
            busy @ busy
        start(run, *args)

    monkeypatch.setattr(loop.GraphRun, "start", busy_start)
    for _ in range(3):
        with decode_cache_scope():       # a new run: warm, then capture
            got, st = Decoder(params, cfg, dcfg,
                              device=cuda).generate(None, prompt)
        assert (st.trace.commit_step[:, :prompt.shape[1]] == -1).all()
        assert torch.equal(got, want)
        _same_trace(st.trace, ws.trace)


def test_extrapolate_forward_runs_in_every_replay(cuda):
    """Without conditional nodes the graph step's forward runs in every
    replay, skipped or not: executed flash launches are the step replays
    times the layers, while ``skipped_forwards`` counts logical skips."""
    from repro_torch.configs import DecodeConfig
    from repro_torch.core import Decoder, decode_cache_scope
    cfg, params, prompt = _reduced(cuda)
    dcfg = DecodeConfig(gen_length=32, block_size=8, steps=20,
                        **CARRY_CASES["extrapolate"])
    with decode_cache_scope() as cache:
        dec = Decoder(params, cfg, dcfg, device=cuda)
        dec.generate(None, prompt)
        (run,) = cache.values()
        run.graphs.reset_counts()
        _, st = dec.generate(None, prompt)
        flash = run.graphs.executed_launches()["flash_attention"]
        replays = run.graphs.replays()
    assert st.skipped_forwards > 0
    assert st.steps == st.forward_equivalents + st.skipped_forwards
    assert flash == replays * cfg.num_layers and replays >= st.steps


def test_hymba_graph_decode_matches_eager(cuda):
    """Hymba's graph-driven decode (the selective scan inside the
    captured steps) equals its eager decode on the card."""
    import dataclasses
    from repro_torch.configs import DecodeConfig
    from repro_torch.core import Decoder
    cfg, params, prompt = _reduced(cuda, "hymba-1.5b")
    dcfg = DecodeConfig(gen_length=32, block_size=8, steps=32,
                        strategy="fdm", gamma=0.0)
    want, ws = Decoder(params, cfg, dataclasses.replace(
        dcfg, fused_loop=False), device=cuda).generate(None, prompt)
    got, gs = Decoder(params, cfg, dcfg, device=cuda).generate(None, prompt)
    assert torch.equal(got, want)
    assert (gs.steps, gs.forward_equivalents) == (ws.steps,
                                                  ws.forward_equivalents)


def test_block_event_canvas_is_unchanged_by_later_replays(cuda):
    from repro_torch.configs import DecodeConfig
    from repro_torch.core import Decoder
    cfg, params, prompt = _reduced(cuda)
    dcfg = DecodeConfig(gen_length=32, block_size=8, steps=32,
                        strategy="probability", cache_policy="dual")
    events = list(Decoder(params, cfg, dcfg, device=cuda)
                  .generate_blocks(None, prompt))
    assert len(events) == 4
    for ev in events:
        assert (ev.x[:, ev.hi:] == cfg.mask_token_id).all()
        assert (ev.x[:, 16:ev.hi] != cfg.mask_token_id).all()


@pytest.mark.parametrize("policy", ["none", "dual"])
def test_whole_request_decode_does_not_sync(cuda, policy):
    """After its graphs are captured, a whole-request decode makes no
    implicit synchronising call: it waits on the card only through its
    explicit reads (event waits on pinned copies: each block's masked
    count, polled behind the card, and the final readback)."""
    from repro_torch.configs import DecodeConfig
    from repro_torch.core import Decoder
    cfg, params, prompt = _reduced(cuda)
    dcfg = DecodeConfig(gen_length=32, block_size=8, steps=32,
                        strategy="fdm_a", eta1=0.025, eta2=0.02,
                        gamma1=0.0, n_max=4, cache_policy=policy)
    dec = Decoder(params, cfg, dcfg, device=cuda)
    want, _ = dec.generate(None, prompt)
    gen = torch.Generator(device=cuda).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, stats = dec.generate(gen, prompt)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got, want) and stats.steps >= 4


def test_graph_block_stops_one_replay_after_an_early_end(cuda):
    """The host polls a block's masked count two steps behind the card: a
    block that keeps to its step budget costs no replay past its end, one
    that ends inside it (FDM-A accelerating in every step: n_max tokens a
    step) costs one."""
    from repro_torch.configs import DecodeConfig
    from repro_torch.core import Decoder, decode_cache_scope
    cfg, params, prompt = _reduced(cuda)
    for kw, extra in ((dict(strategy="probability"), 0),
                      (dict(strategy="fdm_a", eta1=0.0, eta2=0.0,
                            n_max=4), 1)):
        dcfg = DecodeConfig(gen_length=32, block_size=8, steps=20, **kw)
        with decode_cache_scope() as cache:
            _, st = Decoder(params, cfg, dcfg, device=cuda).generate(
                None, prompt)
            (run,) = cache.values()
            assert run.graphs.replays() == st.steps + 4 * extra, kw


def test_interleaved_graph_decodes_share_one_pool(cuda):
    """Two interleaved decodes of one key on the card: the second gets a
    run of its own, captured into the same memory pool, and both decode
    what the eager driver does."""
    import dataclasses
    from repro_torch.configs import DecodeConfig
    from repro_torch.core import Decoder, decode_cache_scope
    cfg, params, prompt = _reduced(cuda)
    dcfg = DecodeConfig(gen_length=32, block_size=8, steps=32,
                        strategy="probability", cache_policy="dual")
    want, _ = Decoder(params, cfg, dataclasses.replace(
        dcfg, fused_loop=False), device=cuda).generate(None, prompt)
    with decode_cache_scope() as cache:
        dec = Decoder(params, cfg, dcfg, device=cuda)
        first = dec.generate_blocks(None, prompt)
        next(first)
        got, _ = dec.generate(None, prompt)
        with pytest.raises(StopIteration) as fin:
            while True:
                next(first)
        runs = cache.values()
    assert torch.equal(got, want)
    assert torch.equal(fin.value.value[0], want)
    assert len(runs) == 2 and runs[0].graphs.pool == runs[1].graphs.pool


# --------------------------------------------------------------------------
# training on the card: the flash kernel's gradient, the kernels without one
# --------------------------------------------------------------------------

# (B, Lq, Lk, H, G, d, window, q_offset, dtype): LLaDA-8B's heads in bf16,
# the f32 testbed's heads, and a GQA band at a q offset in both dtypes
FLASH_GRAD_CASES = [(2, 128, 128, 32, 32, 128, 0, 0, torch.bfloat16),
                    (2, 11, 11, 4, 4, 64, 0, 0, torch.float32),
                    (2, 32, 128, 8, 2, 64, 32, 64, torch.float32),
                    (2, 32, 128, 8, 2, 64, 32, 64, torch.bfloat16)]


def _rel(got, want):
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("b,lq,lk,h,g,d,w,qo,dtype", FLASH_GRAD_CASES)
def test_flash_gradient_matches_plain(cuda, b, lq, lk, h, g, d, w, qo, dtype):
    """dq, dk, dv through the kernel's ``autograd.Function`` against
    autograd of the plain version on the card: max abs error within 1e-4
    (f32) or 2e-2 (bf16) of the largest gradient; one launch in the
    forward, none in the backward."""
    gen = torch.Generator(device=cuda).manual_seed(lq + g)
    q, k, v = (torch.randn(*s, generator=gen, device=cuda).to(dtype)
               for s in ((b, lq, h, d), (b, lk, g, d), (b, lk, g, d)))
    dout = torch.randn(b, lq, h, d, generator=gen, device=cuda).to(dtype)
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = fa_mod.launches
    out = fa_mod.flash_attention(*ins, w, qo)
    assert out.grad_fn is not None and fa_mod.launches == before + 1
    got = torch.autograd.grad(out, ins, dout)
    torch.cuda.synchronize()
    assert fa_mod.launches == before + 1
    ref_ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(fa_mod.attention_ref(*ref_ins, w, qo),
                               ref_ins, dout)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for gt, wt in zip(got, want):
        assert gt.dtype == dtype and gt.shape == wt.shape
        assert _rel(gt, wt) <= tol


def test_kernels_without_a_backward_raise_under_grad(cuda):
    """The confidence kernel has no backward: on a card it raises where
    autograd would need one, and runs under ``no_grad``.  (The selective
    scan has one since it runs inside ``SelectiveScan``.)"""
    logits = torch.randn(4, 1000, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        conf_mod.confidence_fused(logits)
    with torch.no_grad():
        conf_mod.confidence_fused(logits)


# (B, L, di, N, x dtype): Hymba's serving width at L=128, a ragged L over
# several backward chunks, f32 throughout
@pytest.mark.parametrize("b,l,di,n,xdt", [
    (2, 128, 3200, 16, torch.bfloat16),
    (1, 300, 130, 16, torch.float32),
])
def test_scan_gradient_matches_plain_autograd(cuda, b, l, di, n, xdt):
    """``SelectiveScan`` on the card: one kernel launch for the forward,
    none in the backward (``selective_scan_backward``'s f32 ops), every
    gradient against autograd of the plain version within 1e-4 of its
    leaf's max |g| (2e-2 for a bf16 leaf)."""
    gen = torch.Generator(device=cuda).manual_seed(l + di)
    x = torch.randn(b, l, di, generator=gen, device=cuda).to(xdt)
    delta = torch.nn.functional.softplus(
        torch.randn(b, l, di, generator=gen, device=cuda) - 2)
    bs, cs = (torch.randn(b, l, n, generator=gen, device=cuda)
              for _ in range(2))
    a_log = torch.log(torch.arange(1, n + 1, device=cuda,
                                   dtype=torch.float32)).repeat(di, 1)
    dy = torch.randn(b, l, di, generator=gen, device=cuda).to(xdt)
    ins = [t.clone().requires_grad_(True) for t in (x, delta, bs, cs, a_log)]
    before = scan_mod.launches
    y = scan_mod.selective_scan(*ins)
    assert y.grad_fn is not None and scan_mod.launches == before + 1
    got = torch.autograd.grad(y, ins, dy)
    torch.cuda.synchronize()
    assert scan_mod.launches == before + 1
    ref_ins = [t.clone().requires_grad_(True) for t in
               (x, delta, bs, cs, a_log)]
    want = torch.autograd.grad(scan_mod.selective_scan_ref(*ref_ins),
                               ref_ins, dy)
    for gt, wt in zip(got, want):
        assert gt.dtype == wt.dtype and gt.shape == wt.shape
        assert _rel(gt, wt) <= (2e-2 if gt.dtype == torch.bfloat16
                                else 1e-4)


def test_bf16_head_gradient_matches_f32_autograd(cuda):
    """The bf16 LM head's f32-output GEMM (``HeadMatmul``) against
    autograd of the same operands widened to f32: logits within 1e-5,
    gradients within 2e-2 of the largest."""
    from repro_torch.models.layers import HeadMatmul
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(96, 256, generator=gen, device=cuda).bfloat16()
    w = torch.randn(256, 1000, generator=gen, device=cuda).bfloat16()
    dl = torch.randn(96, 1000, generator=gen, device=cuda)
    ins = [t.clone().requires_grad_(True) for t in (x, w)]
    out = HeadMatmul.apply(*ins)
    got = torch.autograd.grad(out, ins, dl)
    ref_ins = [t.float().requires_grad_(True) for t in (x, w)]
    ref = ref_ins[0] @ ref_ins[1]
    want = torch.autograd.grad(ref, ref_ins, dl)
    assert out.dtype == torch.float32
    assert _rel(out, ref) <= 1e-5
    for gt, wt in zip(got, want):
        assert gt.dtype == torch.bfloat16 and _rel(gt, wt) <= 2e-2


@pytest.mark.parametrize("remat", ["none", "block"])
def test_card_trains_the_testbed(cuda, remat):
    """Two steps of ``train`` on the card: finite losses, params back
    without ``requires_grad``, and per step one flash launch per layer in
    the forward, plus one more per layer when ``remat="block"``
    recomputes each block in the backward."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import CharTokenizer, TaskDataset
    from repro_torch.training import train
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("llada-8b").reduced(num_layers=4, d_model=256,
                                         num_heads=4, num_kv_heads=4,
                                         d_ff=1024, remat=remat)
    ds = TaskDataset("sum", CharTokenizer(cfg.vocab_size))
    tcfg = TrainConfig(batch_size=8, seq_len=ds.seq_len, steps=2,
                       log_every=1)
    before = fa_mod.launches
    params, history = train(cfg, tcfg, ds.batches(8), log=None, device=cuda)
    per_layer = 2 if remat == "block" else 1
    assert fa_mod.launches - before == 2 * per_layer * cfg.num_layers
    assert len(history["loss"]) == 2
    assert all(torch.isfinite(torch.tensor(history["loss"])))
    assert params["embed"]["tok"].is_cuda
    assert not params["embed"]["tok"].requires_grad


def test_card_trains_hymba(cuda):
    """Two steps of ``train`` of a reduced Hymba on the card, the scan's
    gradient from ``SelectiveScan``: finite losses, one scan and one
    flash launch per layer a step (no remat), nothing else."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import CharTokenizer, TaskDataset
    from repro_torch.training import train
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("hymba-1.5b").reduced()
    ds = TaskDataset("sum", CharTokenizer(cfg.vocab_size))
    tcfg = TrainConfig(batch_size=4, seq_len=ds.seq_len, steps=2,
                       log_every=1)
    before = (fa_mod.launches, scan_mod.launches)
    params, history = train(cfg, tcfg, ds.batches(4), log=None, device=cuda)
    assert fa_mod.launches - before[0] == 2 * cfg.num_layers
    assert scan_mod.launches - before[1] == 2 * cfg.num_layers
    assert all(torch.isfinite(torch.tensor(history["loss"])))
    assert params["blocks"][0]["mamba"]["a_log"].is_cuda


# --------------------------------------------------------------------------
# the serving stack on the card
# --------------------------------------------------------------------------

def test_card_oom_is_engine_fatal(cuda):
    """A real out-of-memory on the card is classified engine-fatal (its
    message reads "CUDA out of memory", which the reference's markers
    miss), not a sticky error."""
    from repro_torch.serving import is_context_poisoned, is_engine_fatal
    from repro_torch.serving.supervisor import classify_failure
    _, total = torch.cuda.mem_get_info()
    with pytest.raises(torch.OutOfMemoryError) as err:
        torch.empty(2 * total, dtype=torch.uint8, device=cuda)
    assert "out of memory" in str(err.value)
    assert is_engine_fatal(err.value)
    assert not is_context_poisoned(err.value)
    assert classify_failure(err.value) == "fatal"
    torch.ones(8, device=cuda).sum().item()       # the context lives on


def test_worker_replays_graphs_captured_on_another_thread(cuda):
    """A decode's graphs captured on this thread replay on the device's
    worker thread (no new capture) and decode the same tokens; and a
    capture made on the worker replays here."""
    import threading
    from repro_torch.configs import DecodeConfig
    from repro_torch.core import Decoder, decode_cache_scope
    from repro_torch.serving import run_on_worker
    cfg, params, prompt = _reduced(cuda)
    dcfg = DecodeConfig(gen_length=32, block_size=8, steps=32,
                        strategy="fdm", gamma=0.0, cache_policy="dual")
    with decode_cache_scope() as cache:
        dec = Decoder(params, cfg, dcfg, device=cuda)
        want, _ = dec.generate(None, prompt)
        captures = cache.info().captures
        assert captures > 0

        def decode():
            out, _ = dec.generate(None, prompt)
            torch.cuda.synchronize()
            return threading.current_thread().name, out

        name, got = run_on_worker(cuda, decode)
        assert name.startswith("repro-torch-cuda:0")
        assert torch.equal(got, want)
        assert cache.info().captures == captures
    with decode_cache_scope() as cache:
        dec = Decoder(params, cfg, dcfg, device=cuda)
        _, first = run_on_worker(cuda, decode)
        captures = cache.info().captures
        got, _ = dec.generate(None, prompt)
        assert torch.equal(got, first) and torch.equal(got, want)
        assert cache.info().captures == captures


def test_scheduler_serves_on_the_card_through_the_worker(cuda):
    """The async stack on the card: requests of two cache policies
    decode on the worker thread, equal to a direct decode of their own
    batch (same prompts, config and seed)."""
    import asyncio
    import numpy as np
    from repro_torch.configs import DecodeConfig
    from repro_torch.core import Decoder
    from repro_torch.serving import AsyncScheduler, ServingEngine
    cfg, params, _ = _reduced(cuda)
    dcfg = DecodeConfig(gen_length=32, block_size=8, steps=32,
                        strategy="fdm", gamma=0.0)
    engine = ServingEngine(params, cfg, dcfg, max_batch=4, device=cuda)
    batches = []
    engine.on_batch_done = batches.append
    rs = np.random.default_rng(0)
    prompts = [rs.integers(0, cfg.vocab_size - 1, n) for n in (9, 12, 16)]

    async def main():
        sched = AsyncScheduler(engine)
        rids = [sched.submit(p, cache_policy=pol) for p in prompts
                for pol in ("none", "dual")]
        await sched.start()
        out = {rid: await sched.result(rid) for rid in rids}
        await sched.close()
        return out

    finals = asyncio.run(main())
    assert all(e["type"] == "done" for e in finals.values())
    assert len(batches) == 2
    for batch in batches:
        want, _ = Decoder(params, cfg, batch.dcfg, device=cuda).generate(
            batch.seed, batch.prompts)
        want = want.cpu().numpy()
        for i, req in enumerate(batch.requests):
            assert finals[req.rid]["tokens"] == \
                want[i, batch.pads[i]:].tolist()


# --------------------------------------------------------------------------
# the MoE block (mixtral-8x22b)
# --------------------------------------------------------------------------

def _overflow_moe(experts=8, seed=0):
    """A reduced Mixtral MoE layer (f32) with ``experts`` experts on the
    CPU and 400 tokens whose first choice is expert 0 (a constant feature
    times a large router weight): it overflows at factors 1.25 and 2.0."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config("mixtral-8x22b").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=experts))
    gen = torch.Generator().manual_seed(seed)
    p = moe.init_moe(gen, cfg, "cpu", torch.float32)
    p["router"][0, 0] = 10.0
    x = torch.randn(2, 200, cfg.d_model, generator=gen)
    x[..., 0] = 4.0
    return cfg, p, x


@pytest.mark.parametrize("factor", [1.25, 2.0])
def test_moe_dispatch_on_card_matches_cpu_under_overflow(cuda, factor):
    """The dispatch on the card against its CPU run, same weights and
    tokens, with one expert over capacity: expert ids, counts, slots and
    drops exact; outputs within 1e-5 of their scale (f32 products summed
    in another order; the σ = 1/√E experts make outputs of order 10²)."""
    from repro_torch.models import moe
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, p, x = _overflow_moe()
    pc = {k: v.to(cuda) for k, v in p.items()}
    t = x.shape[0] * x.shape[1]
    cap = moe.capacity(t, cfg, factor)
    want_r = moe.route(x.reshape(t, -1) @ p["router"], cfg, cap)
    got_r = moe.route(x.reshape(t, -1).to(cuda) @ pc["router"], cfg, cap)
    for name in ("ids", "counts", "slot"):
        assert torch.equal(getattr(got_r, name).cpu(),
                           getattr(want_r, name)), name
    drops = int((want_r.slot >= cap).sum())
    assert drops == t - cap > 0
    want, want_aux = moe.moe_forward(p, x, cfg, factor)
    got, aux = moe.moe_forward(pc, x.to(cuda), cfg, factor)
    scale = float(want.abs().max())
    torch.testing.assert_close(got.cpu() / scale, want / scale, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-5, atol=1e-6)


def test_moe_forward_in_a_graph_matches_eager(cuda):
    """The dispatch has fixed shapes and reads nothing back, so it
    captures: a replay equals the eager call, under overflow."""
    from repro_torch.models import moe
    cfg, p, x = _overflow_moe()
    pc = {k: v.to(cuda) for k, v in p.items()}
    xc = x.to(cuda)
    out = torch.zeros_like(xc)

    def body():
        out.copy_(moe.moe_forward(pc, xc, cfg, 1.25, need_aux=False)[0])
    replay = _capture(body)
    out.zero_()
    replay()
    want = moe.moe_forward(pc, xc, cfg, 1.25, need_aux=False)[0]
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.parametrize("policy", ["none", "prefix", "dual"])
def test_mixtral_graph_decode_matches_eager(cuda, policy):
    """Reduced Mixtral (MoE blocks, window 32 over a 48-token canvas):
    the whole-request graph driver decodes the eager driver's tokens,
    steps and forward-equivalents on the card."""
    import dataclasses
    from repro_torch.configs import DecodeConfig
    from repro_torch.core import Decoder
    cfg, params, prompt = _reduced(cuda, "mixtral-8x22b")
    dcfg = DecodeConfig(gen_length=32, block_size=8, steps=32,
                        strategy="fdm", gamma=0.0, cache_policy=policy)
    want, ws = Decoder(params, cfg, dataclasses.replace(
        dcfg, fused_loop=False), device=cuda).generate(None, prompt)
    got, gs = Decoder(params, cfg, dcfg, device=cuda).generate(None, prompt)
    assert torch.equal(got, want)
    assert (gs.steps, gs.forward_equivalents) == (ws.steps,
                                                  ws.forward_equivalents)


# MLA's heads, q/k dqk wide and v dv wide (B, Lq, Lk, H, G, dqk, dv, window,
# q_offset): DeepSeek-V2 at full width (192, 128; 128 heads) at the scoring
# and K-candidate batches and the dual window at a q offset, and reduced
# (48, 32) at a ragged L, a window at an offset, a band and a GQA group
MLA_FLASH_CASES = [(2, 128, 128, 128, 128, 192, 128, 0, 0),
                   (4, 128, 128, 128, 128, 192, 128, 0, 0),
                   (2, 32, 128, 128, 128, 192, 128, 0, 96),
                   (1, 130, 130, 4, 4, 48, 32, 0, 0),
                   (2, 16, 48, 4, 4, 48, 32, 0, 16),
                   (1, 200, 200, 4, 2, 48, 32, 17, 0),
                   (1, 70, 300, 8, 8, 192, 128, 40, 100)]


@pytest.mark.parametrize("b,lq,lk,h,g,dqk,dv,w,qo", MLA_FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_mla_heads_match_plain(cuda, b, lq, lk, h, g, dqk, dv,
                                            w, qo, dtype):
    """v narrower than q and k: the kernel computes the dv-wide product
    itself (one launch, output (B, Lq, H, dv)), scale dqk^-½."""
    gen = torch.Generator(device=cuda).manual_seed(lq + lk + dqk + qo)
    q = torch.randn(b, lq, h, dqk, generator=gen, device=cuda).to(dtype)
    k = torch.randn(b, lk, g, dqk, generator=gen, device=cuda).to(dtype)
    v = torch.randn(b, lk, g, dv, generator=gen, device=cuda).to(dtype)
    before = fa_mod.launches
    got = fa_mod.flash_attention(q, k, v, w, qo)
    torch.cuda.synchronize()
    assert fa_mod.launches == before + 1
    assert got.shape == (b, lq, h, dv) and got.dtype == dtype
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(
        got.float(), fa_mod.attention_ref(q, k, v, w, qo).float(),
        rtol=tol, atol=tol)


def test_flash_refuses_unbuilt_mixed_head_dims(cuda):
    q, k, _ = _bf16_qkv(cuda, 1, 64, 64, 2, 2, 128, seed=8)
    v = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        fa_mod.flash_attention(q, k, v)


@pytest.mark.parametrize("b,lq,lk,h,g,dqk,dv,w,qo,dtype", [
    (2, 48, 48, 4, 4, 48, 32, 0, 0, torch.float32),
    (2, 16, 48, 4, 4, 48, 32, 0, 16, torch.float32),
    (2, 48, 48, 4, 4, 48, 32, 0, 0, torch.bfloat16),
    (2, 128, 128, 16, 16, 192, 128, 0, 0, torch.bfloat16)])
def test_flash_gradient_mla_heads_matches_plain(cuda, b, lq, lk, h, g, dqk,
                                                dv, w, qo, dtype):
    """dq, dk (dqk wide) and dv (dv wide) through ``FlashAttention``
    against autograd of the plain version: within 1e-4 (f32) or 2e-2
    (bf16) of the largest gradient."""
    gen = torch.Generator(device=cuda).manual_seed(lq + dqk)
    q, k, v = (torch.randn(*s, generator=gen, device=cuda).to(dtype)
               for s in ((b, lq, h, dqk), (b, lk, g, dqk), (b, lk, g, dv)))
    dout = torch.randn(b, lq, h, dv, generator=gen, device=cuda).to(dtype)
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fa_mod.flash_attention(*ins, w, qo)
    got = torch.autograd.grad(out, ins, dout)
    ref_ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(fa_mod.attention_ref(*ref_ins, w, qo),
                               ref_ins, dout)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for gt, wt in zip(got, want):
        assert gt.dtype == dtype and gt.shape == wt.shape
        assert _rel(gt, wt) <= tol


@pytest.mark.parametrize("policy", ["none", "prefix", "dual"])
def test_deepseek_graph_decode_matches_eager(cuda, policy):
    """Reduced DeepSeek-V2 (MLA at (48, 32), a dense first layer, shared
    experts; the block cache keeps MLA's latents): the whole-request
    graph driver decodes the eager driver's tokens, steps and
    forward-equivalents on the card."""
    import dataclasses
    from repro_torch.configs import DecodeConfig
    from repro_torch.core import Decoder
    cfg, params, prompt = _reduced(cuda, "deepseek-v2-236b")
    dcfg = DecodeConfig(gen_length=32, block_size=8, steps=32,
                        strategy="fdm", gamma=0.0, cache_policy=policy)
    want, ws = Decoder(params, cfg, dataclasses.replace(
        dcfg, fused_loop=False), device=cuda).generate(None, prompt)
    got, gs = Decoder(params, cfg, dcfg, device=cuda).generate(None, prompt)
    assert torch.equal(got, want)
    assert (gs.steps, gs.forward_equivalents) == (ws.steps,
                                                  ws.forward_equivalents)


# --------------------------------------------------------------------------
# MoE training and the encoder-decoder (whisper) on the card
# --------------------------------------------------------------------------

# (B, Lq, Lk, H, G, dqk, dv, dtype): DeepSeek-V2's MLA heads (q/k 192, v
# 128) and whisper's cross-attention (128 queries over 1500 frames)
NEW_FLASH_GRAD_CASES = [(2, 128, 128, 128, 128, 192, 128, torch.bfloat16),
                        (2, 128, 1500, 16, 16, 64, 64, torch.bfloat16),
                        (2, 128, 1500, 16, 16, 64, 64, torch.float32)]


@pytest.mark.parametrize("b,lq,lk,h,g,d,dv,dtype", NEW_FLASH_GRAD_CASES)
def test_flash_gradient_at_mla_and_cross_shapes(cuda, b, lq, lk, h, g, d,
                                                dv, dtype):
    """As ``test_flash_gradient_matches_plain``, at MLA's (192, 128) and
    at whisper's cross shape (Lq != Lk, a ragged key tail: 1500 = 23·64 +
    28)."""
    gen = torch.Generator(device=cuda).manual_seed(lk + d)
    q, k, v = (torch.randn(*s, generator=gen, device=cuda).to(dtype)
               for s in ((b, lq, h, d), (b, lk, g, d), (b, lk, g, dv)))
    dout = torch.randn(b, lq, h, dv, generator=gen, device=cuda).to(dtype)
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = fa_mod.launches
    got = torch.autograd.grad(fa_mod.flash_attention(*ins), ins, dout)
    torch.cuda.synchronize()
    assert fa_mod.launches == before + 1
    ref_ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(fa_mod.attention_ref(*ref_ins), ref_ins,
                               dout)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for gt, wt in zip(got, want):
        assert gt.dtype == dtype and gt.shape == wt.shape
        assert _rel(gt, wt) <= tol


# whisper-medium's attention (16 MHA heads at d=64): the encoder's 1500
# frames at B=2 and at the K·B fold, and the cross shape
@pytest.mark.parametrize("b,lq,lk", [(2, 1500, 1500), (4, 1500, 1500),
                                     (2, 128, 1500)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_at_whisper_shapes(cuda, b, lq, lk, dtype):
    gen = torch.Generator(device=cuda).manual_seed(lq)
    q = torch.randn(b, lq, 16, 64, generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn(b, lk, 16, 64, generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    got = fa_mod.flash_attention(q, k, v)
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(),
                               fa_mod.attention_ref(q, k, v).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_confidence_kernel_at_whisper_shape(cuda, dtype):
    """256 rows of V = 51865 (odd: rows start off the 16-byte
    boundary)."""
    _check_conf_kernel(_conf_logits(cuda, 256, 51865, dtype, 51865))


WHISPER_STRATS = [dict(strategy="probability"),
                  dict(strategy="fdm", gamma=0.0),
                  dict(strategy="fdm_a", eta1=0.0235, eta2=0.0231,
                       gamma1=0.0, n_max=3)]


@pytest.mark.parametrize("kw", WHISPER_STRATS, ids=lambda kw: kw["strategy"])
def test_whisper_conditioned_graph_decode_matches_eager(cuda, kw):
    """whisper-tiny (f32) decoding with ``enc_embeds``: the whole-request
    and the per-block graph drivers (the frames a static buffer of the
    run, tiled inside the captured forward) equal the eager driver, twice
    (the second decode reuses the graphs with other frames copied in);
    and the CPU's eager decode of the same weights."""
    import dataclasses
    from repro_torch.configs import DecodeConfig
    from repro_torch.core import Decoder
    cfg, params, prompt = _reduced(cuda, "whisper-medium")
    gen = torch.Generator(device=cuda).manual_seed(2)
    frames = [torch.randn(2, cfg.encdec.encoder_seq, cfg.d_model,
                          generator=gen, device=cuda) for _ in range(2)]
    dcfg = DecodeConfig(gen_length=32, block_size=8, steps=32, **kw)
    want = [Decoder(params, cfg, dataclasses.replace(dcfg, fused_loop=False),
                    device=cuda).generate(None, prompt, enc_embeds=f)
            for f in frames]
    assert not torch.equal(want[0][0], want[1][0])
    for over in (dict(fused_blocks=False), {}):
        dec = Decoder(params, cfg, dataclasses.replace(dcfg, **over),
                      device=cuda)
        for f, (out, st) in zip(frames, want):
            got, gst = dec.generate(None, prompt, enc_embeds=f)
            assert torch.equal(got, out)
            assert gst.steps == st.steps and gst.phase_counts == \
                st.phase_counts
            assert gst.forward_equivalents == st.forward_equivalents
    out, _ = Decoder(_tree_to(params, "cpu"), cfg, dataclasses.replace(dcfg, fused_loop=False),
                     device="cpu").generate(None, prompt.cpu(),
                                            enc_embeds=frames[0].cpu())
    assert torch.equal(out, want[0][0].cpu())


@pytest.mark.parametrize("name", ["mixtral-8x22b", "deepseek-v2-236b"])
def test_moe_train_step_on_card_matches_cpu(cuda, name):
    """One f32 MoE train step (the objective: loss + the router's aux
    loss) on the card against the CPU's, same weights, batch and
    corruption: loss and aux within rel 1e-5, every gradient leaf within
    1e-4 of its max |g| (the router's included)."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.convert import to_flat
    from repro_torch.data import CharTokenizer, TaskDataset
    from repro_torch.models import init_model
    from repro_torch.training import make_train_step
    from repro_torch.training.trainer import corrupt, masters, to_device_batch
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(name).reduced()
    ds = TaskDataset("sum", CharTokenizer(cfg.vocab_size))
    tcfg = TrainConfig(batch_size=16, seq_len=ds.seq_len, steps=10)
    batch = to_device_batch(next(ds.batches(16)), "cpu")
    corruption = corrupt(torch.Generator().manual_seed(0), batch["tokens"],
                         batch["maskable"], cfg)
    init = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    step = make_train_step(cfg, tcfg)
    out = {}
    for dev in ("cpu", cuda):
        params = masters(_tree_to(init, dev))
        grads, met = step.grads(params, {k: v.to(dev) for k, v in
                                         batch.items()},
                                tuple(c.to(dev) for c in corruption))
        out[str(dev)] = (float(met["loss"]), float(met["aux"]),
                         to_flat(grads))
    (loss, aux, g), (card_loss, card_aux, card_g) = out["cpu"], \
        out[str(cuda)]
    assert aux > 0
    assert card_loss == pytest.approx(loss, rel=1e-5)
    assert card_aux == pytest.approx(aux, rel=1e-5)
    for key, want in g.items():
        scale = max(abs(want).max(), 1e-30)
        assert abs(card_g[key] - want).max() <= 1e-4 * scale, key


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


# --------------------------------------------------------------------------
# qwen2-vl (M-RoPE, patch embeddings) and xLSTM (mLSTM, sLSTM)
# --------------------------------------------------------------------------

def _xlstm_ms():
    """xlstm-125m-tiny with the pattern "ms": layer 1 an sLSTM (the reduced
    pattern "mmmmmms" puts both layers on the mLSTM)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config("xlstm-125m").reduced()
    return cfg.reduced(ssm=dataclasses.replace(cfg.ssm, xlstm_pattern="ms"))


@pytest.mark.parametrize("patches", [0, 16, 1024])
def test_mrope_tables_on_card_match_cpu(cuda, patches):
    """M-RoPE's cos/sin over the three streams (patches on the h/w grid,
    text from 1) on the card equal the CPU's: f32 within 1e-6, bf16 within
    one bf16 spacing."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.model import forward_rope
    for cfg in (get_config("qwen2-vl-72b").reduced(),
                get_config("qwen2-vl-72b")):
        for dtype in ("float32", "bfloat16"):
            c = dataclasses.replace(cfg, dtype=dtype)
            length = patches + 128
            got = forward_rope(c, length, device=cuda, num_patches=patches)
            want = forward_rope(c, length, device="cpu", num_patches=patches)
            tol = 1e-6 if dtype == "float32" else 2 ** -8
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and g.shape == w.shape
                torch.testing.assert_close(g.cpu().float(), w.float(),
                                           rtol=0, atol=tol)


@pytest.mark.parametrize("name", ["qwen2-vl-72b", "xlstm-ms"])
def test_vlm_and_xlstm_forwards_on_card_match_cpu(cuda, name):
    """f32 logits of tiny qwen2-vl with 16 patches (flash over the patch
    rows, M-RoPE) and of the xLSTM stack with an sLSTM layer, on the card
    against the CPU from the same weights, within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_model
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _xlstm_ms() if name == "xlstm-ms" else get_config(name).reduced()
    params = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 150), generator=gen)
    kw = {}
    if cfg.arch_type == "vlm":
        kw["patch_embeds"] = torch.randn(2, 16, cfg.d_model, generator=gen)
    want = forward(params, tokens, cfg, **kw)
    got = forward(_tree_to(params, cuda), tokens.to(cuda), cfg,
                  **{k: v.to(cuda) for k, v in kw.items()})
    assert got.shape == (2, 150, cfg.vocab_size)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_at_vlm_shape(cuda, dtype):
    """qwen2-vl-72b's attention over its longest canvas: 64 query heads
    over 8 at d=128, 1024 patches + 128 text positions (B=2)."""
    gen = torch.Generator(device=cuda).manual_seed(1152)
    q = torch.randn(2, 1152, 64, 128, generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn(2, 1152, 8, 128, generator=gen, device=cuda)
            .to(dtype) for _ in range(2))
    got = fa_mod.flash_attention(q, k, v)
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(),
                               fa_mod.attention_ref(q, k, v).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("vocab", [152064, 50304])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_confidence_kernel_at_vlm_and_xlstm_vocabs(cuda, vocab, dtype):
    _check_conf_kernel(_conf_logits(cuda, 256, vocab, dtype, vocab))


@pytest.mark.parametrize("kw", WHISPER_STRATS, ids=lambda kw: kw["strategy"])
@pytest.mark.parametrize("name", ["qwen2-vl-72b", "xlstm-ms"])
def test_vlm_and_xlstm_graph_decodes_match_eager(cuda, name, kw):
    """Tiny qwen2-vl with 16 patches (a static buffer of the run) and the
    xLSTM stack with an sLSTM layer (its time loop inside the captured
    forward): the whole-request and the per-block graph drivers equal the
    eager driver (tokens, steps, forward-equivalents, phases)."""
    import dataclasses
    from repro_torch.configs import DecodeConfig, get_config
    from repro_torch.core import Decoder
    from repro_torch.models import init_model
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _xlstm_ms() if name == "xlstm-ms" else get_config(name).reduced()
    params = init_model(cfg, torch.Generator(device=cuda).manual_seed(0),
                        device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size - 1, (2, 16), device=cuda,
                           generator=gen)
    extras = {"patch_embeds": torch.randn(2, 16, cfg.d_model, device=cuda,
                                          generator=gen)} \
        if cfg.arch_type == "vlm" else {}
    dcfg = DecodeConfig(gen_length=32, block_size=8, steps=32, **kw)
    want, wst = Decoder(params, cfg, dataclasses.replace(
        dcfg, fused_loop=False), device=cuda).generate(None, prompt,
                                                       **extras)
    for over in (dict(fused_blocks=False), {}):
        got, st = Decoder(params, cfg, dataclasses.replace(dcfg, **over),
                          device=cuda).generate(None, prompt, **extras)
        assert torch.equal(got, want)
        assert (st.steps, st.forward_equivalents, st.phase_counts) == \
            (wst.steps, wst.forward_equivalents, wst.phase_counts)


# --------------------------------------------------------------------------
# the decode state: flash's device-side valid count, the scan's initial
# and end states, decode_step and the serve step on the card
# --------------------------------------------------------------------------

@pytest.mark.parametrize("b,lq,lk,h,g,d,n,w,qo", [
    (2, 1, 300, 8, 2, 128, 1, 0, 0), (2, 1, 300, 8, 2, 128, 65, 0, 0),
    (2, 1, 300, 8, 2, 128, 300, 0, 0), (2, 1, 300, 8, 2, 128, 999, 0, 0),
    (1, 1, 1024, 25, 5, 64, 1024, 0, 0), (2, 64, 256, 4, 4, 64, 130, 32, 64),
    (1, 1, 200, 16, 16, 192, 77, 0, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_valid_count_matches_plain(cuda, b, lq, lk, h, g, d, n,
                                                w, qo, dtype):
    """Keys at or past the count (an int32 on the card; one past Lk
    clamps) are masked as the ragged end is: the single-token decode over
    a fixed-capacity cache, one launch."""
    gen = torch.Generator(device=cuda).manual_seed(n + lk)
    dv = 128 if d == 192 else d
    q = torch.randn(b, lq, h, d, generator=gen, device=cuda).to(dtype)
    k = torch.randn(b, lk, g, d, generator=gen, device=cuda).to(dtype)
    v = torch.randn(b, lk, g, dv, generator=gen, device=cuda).to(dtype)
    kv_len = torch.tensor([n], dtype=torch.int32, device=cuda)
    before = fa_mod.launches
    got = fa_mod.flash_attention(q, k, v, w, qo, kv_len=kv_len)
    torch.cuda.synchronize()
    assert fa_mod.launches == before + 1
    want = fa_mod.attention_ref(q, k, v, w, qo, kv_len)
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if n < lk:                     # the masked keys do not matter
        k2, v2 = k.clone(), v.clone()
        k2[:, n:], v2[:, n:] = 7.0, -7.0
        again = fa_mod.flash_attention(q, k2, v2, w, qo, kv_len=kv_len)
        assert torch.equal(again, got)


def test_flash_valid_count_refuses_grad(cuda):
    q = torch.randn(1, 1, 2, 32, device=cuda, requires_grad=True)
    k = torch.randn(1, 8, 2, 32, device=cuda)
    kv_len = torch.tensor([4], dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        fa_mod.flash_attention(q, k, k, kv_len=kv_len)
    with torch.no_grad():
        fa_mod.flash_attention(q, k, k, kv_len=kv_len)


@pytest.mark.parametrize("b,l,di,n,xdtype", [
    (2, 128, 3200, 16, torch.bfloat16), (1, 2048, 3200, 16, torch.bfloat16),
    (2, 300, 130, 16, torch.float32), (2, 1, 64, 16, torch.float32),
    (1, 37, 200, 4, torch.float32)])
def test_selective_scan_state_matches_plain(cuda, b, l, di, n, xdtype):
    """The scan from an initial state h0 with its end state out, against
    the plain version (y within the kernel tests' tolerance, the f32 end
    state within 2e-4), one launch; without h0 the end state is the zero
    start's; the output alone equals the stateless kernel's."""
    gen = torch.Generator(device=cuda).manual_seed(l + di)
    x = torch.randn(b, l, di, generator=gen, device=cuda).to(xdtype)
    delta = torch.nn.functional.softplus(
        torch.randn(b, l, di, generator=gen, device=cuda) - 2)
    bs, cs = (torch.randn(b, l, n, generator=gen, device=cuda)
              for _ in range(2))
    a_log = torch.log(torch.arange(1, n + 1, device=cuda,
                                   dtype=torch.float32))[None].repeat(di, 1)
    h0 = 0.5 * torch.randn(b, di, n, generator=gen, device=cuda)
    tol = 2e-4 if xdtype == torch.float32 else 3e-2
    for start in (h0, None):
        before = scan_mod.launches
        y, h = scan_mod.selective_scan(x, delta, bs, cs, a_log, h0=start,
                                       return_state=True)
        torch.cuda.synchronize()
        assert scan_mod.launches == before + 1
        wy, wh = scan_mod.selective_scan_ref(x, delta, bs, cs, a_log, start,
                                             True)
        torch.testing.assert_close(y.float(), wy.float(), rtol=tol, atol=tol)
        torch.testing.assert_close(h, wh, rtol=2e-4, atol=2e-4)
    y1 = scan_mod.selective_scan(x, delta, bs, cs, a_log, h0=h0)
    assert torch.equal(y1, scan_mod.selective_scan(x, delta, bs, cs, a_log,
                                                   h0=h0,
                                                   return_state=True)[0])
    assert torch.equal(scan_mod.selective_scan(x, delta, bs, cs, a_log),
                       scan_mod.selective_scan(x, delta, bs, cs, a_log,
                                               return_state=True)[0])


def test_selective_scan_state_refuses_grad(cuda):
    x = torch.randn(1, 8, 16, device=cuda, requires_grad=True)
    d = torch.rand(1, 8, 16, device=cuda)
    bs = torch.randn(1, 8, 4, device=cuda)
    a_log = torch.zeros(16, 4, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        scan_mod.selective_scan(x, d, bs, bs, a_log, return_state=True)
    with pytest.raises(RuntimeError, match="no backward"):
        scan_mod.selective_scan(x, d, bs, bs, a_log,
                                h0=torch.zeros(1, 16, 4, device=cuda))


@pytest.mark.parametrize("name", ["llada-8b", "hymba-1.5b", "qwen2-vl-72b",
                                  "deepseek-v2-236b", "xlstm-ms"])
def test_decode_step_on_card_matches_cpu(cuda, name):
    """f32 ``decode_step`` of a tiny config on the card (flash with the
    device-side count; MLA absorbed; the Mamba and xLSTM steps) against
    the CPU from the same weights: 8 tokens, argmaxes exact, logits and
    every state leaf within 1e-4; then a ``forward_window`` with
    ``extend="recurrent"`` (the scan from h0 on Hymba) likewise."""
    from repro_torch.configs import get_config
    from repro_torch.models import (forward_window, init_decode_state,
                                    init_model)
    from repro_torch.models import decode_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _xlstm_ms() if name == "xlstm-ms" else get_config(name).reduced()
    params = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    dparams = _tree_to(params, cuda)
    cs = init_decode_state(cfg, 2, 48, torch.float32, device="cpu")
    ds = init_decode_state(cfg, 2, 48, torch.float32, device=cuda)
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size - 1, (8, 2, 1), generator=gen)
    for i, tok in enumerate(toks):
        pos = torch.full((2, 1), 30 + i, dtype=torch.int32)
        want, cs = decode_step(params, tok, pos, cs, cfg)
        got, ds = decode_step(dparams, tok.to(cuda), pos.to(cuda), ds, cfg)
        assert torch.equal(got.argmax(-1).cpu(), want.argmax(-1))
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    win = torch.randint(0, cfg.vocab_size - 1, (2, 8), generator=gen)
    pos = torch.arange(38, 46, dtype=torch.int32)[None].expand(2, 8)
    want, cs = forward_window(params, win, pos, cs, cfg, "recurrent")
    got, ds = forward_window(dparams, win.to(cuda), pos.to(cuda), ds, cfg,
                             "recurrent")
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    leaves = [(a, b) for a, b in zip(_leaves(ds.layer_states),
                                     _leaves(cs.layer_states))]
    for a, b in leaves:
        if isinstance(b, torch.Tensor):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
        else:
            assert a == b


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def test_mla_absorbed_decode_bf16_on_card_matches_cpu(cuda):
    """bf16 ``mla_decode`` (cuBLAS's f32-output batched GEMMs) against the
    CPU's (operands widened: the same products) on one DeepSeek-V2-tiny
    layer, within 2e-2."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention, init_model
    from repro_torch.models.layers import model_rotary_dim, rope_tables
    cfg = get_config("deepseek-v2-236b").reduced()
    p = init_model(cfg, torch.Generator().manual_seed(0), device="cpu",
                   dtype=torch.bfloat16)["blocks"][0]["attn"]
    gen = torch.Generator().manual_seed(2)
    m = cfg.mla
    c = torch.randn(2, 40, m.kv_lora_rank, generator=gen).bfloat16()
    kr = torch.randn(2, 40, m.qk_rope_head_dim, generator=gen).bfloat16()
    x = torch.randn(2, 1, cfg.d_model, generator=gen).bfloat16()
    pos = torch.full((2, 1), 25, dtype=torch.int32)
    outs = []
    for dev in ("cpu", cuda):
        rope = rope_tables(pos.to(dev), model_rotary_dim(cfg), cfg,
                           torch.bfloat16)
        out, cache = attention.mla_decode(
            _tree_to(p, dev), x.to(dev), rope, pos.to(dev), cfg,
            attention.KVCache(c.to(dev).clone(), kr.to(dev).clone(), 40))
        outs.append((out.cpu().float(), cache.k.cpu().float()))
    torch.testing.assert_close(outs[1][0], outs[0][0], rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(outs[1][1], outs[0][1], rtol=2e-2, atol=2e-2)


def test_serve_step_replays_from_a_cuda_graph(cuda):
    """LLaDA-tiny's ``serve`` step captured once into a CUDA graph (the
    slot, the valid count and the cache writes all on the device: no
    host read) and replayed at four positions equals the eager step on a
    copy of the state."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_steps
    from repro_torch.models import init_decode_state, init_model
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("llada-8b").reduced()
    params = init_model(cfg, torch.Generator(device=cuda).manual_seed(0),
                        device=cuda)
    serve = make_steps(cfg)["serve"]
    state = init_decode_state(cfg, 2, 32, torch.float32, device=cuda)
    eager = type(state)([type(kv)(kv.k.clone(), kv.v.clone(), kv.length)
                         for kv in state.layer_states], None)
    token = torch.zeros(2, 1, dtype=torch.long, device=cuda)
    position = torch.zeros(2, 1, dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        serve(params, token, position, state)      # warm (writes slot 0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        scores, _ = serve(params, token, position, state)
    gen = torch.Generator(device=cuda).manual_seed(3)
    for p in range(4):
        tok = torch.randint(0, cfg.vocab_size - 1, (2, 1), device=cuda,
                            generator=gen)
        token.copy_(tok)
        position.fill_(p)
        graph.replay()
        want, eager = serve(params, tok, position.clone(), eager)
        torch.cuda.synchronize()
        assert torch.equal(scores.argmax, want.argmax)
        torch.testing.assert_close(scores.max_prob, want.max_prob,
                                   rtol=1e-5, atol=1e-6)
    for kv, ekv in zip(state.layer_states, eager.layer_states):
        torch.testing.assert_close(kv.k[:, :4], ekv.k[:, :4], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("name", ["qwen2-vl-72b", "xlstm-ms"])
def test_make_steps_train_on_card_matches_cpu(cuda, name):
    """One f32 ``make_steps(cfg)["train"]`` step of tiny qwen2-vl with its
    patch embeddings (the config's extra input: prepended, then sliced
    off) and of the xLSTM stack with an sLSTM layer (its time loop), on
    the card against the CPU's, same weights, batch and corruption: the
    loss within rel 1e-5, every gradient leaf within 1e-4 of its max |g|
    (as ``test_moe_train_step_on_card_matches_cpu``)."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.convert import to_flat
    from repro_torch.launch.steps import extra_input_names, make_steps
    from repro_torch.models import init_model
    from repro_torch.training.trainer import corrupt, masters
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _xlstm_ms() if name == "xlstm-ms" else get_config(name).reduced()
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size - 1, (4, 48),
                                     generator=gen),
             "maskable": torch.ones(4, 48, dtype=torch.bool)}
    batch["maskable"][:, :8] = False
    if "patch_embeds" in extra_input_names(cfg):
        batch["patch_embeds"] = torch.randn(4, cfg.encdec.num_patch_tokens,
                                            cfg.d_model, generator=gen)
    corruption = corrupt(torch.Generator().manual_seed(0), batch["tokens"],
                         batch["maskable"], cfg)
    init = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    step = make_steps(cfg, TrainConfig(batch_size=4, seq_len=48,
                                       steps=10))["train"]
    out = {}
    for dev in ("cpu", cuda):
        params = masters(_tree_to(init, dev))
        grads, met = step.grads(params, {k: v.to(dev) for k, v in
                                         batch.items()},
                                tuple(c.to(dev) for c in corruption))
        out[str(dev)] = (float(met["loss"]), to_flat(grads))
    (loss, g), (card_loss, card_g) = out["cpu"], out[str(cuda)]
    assert card_loss == pytest.approx(loss, rel=1e-5)
    assert sorted(card_g) == sorted(g)
    for key, want in g.items():
        scale = max(abs(want).max(), 1e-30)
        assert abs(card_g[key] - want).max() <= 1e-4 * scale, key


# --------------------------------------------------------------------------
# the one-card dry-run's meta stand-ins (launch/dryrun.py) against the
# kernels' launches
# --------------------------------------------------------------------------

def _stand_in_case(case, device):
    """(module, wrapper, args, kwargs) on ``device``: flash plain, flash at
    MLA's (48, 32) with a valid count, confidence in bf16, the scan, the
    scan from h0 with its end state."""
    gen = torch.Generator(device=device).manual_seed(31)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=device).to(dtype)
    bf = torch.bfloat16
    if case == "flash":
        return fa_mod, fa_mod.flash_attention, (
            rand(2, 40, 4, 64, dtype=bf), rand(2, 56, 2, 64, dtype=bf),
            rand(2, 56, 2, 64, dtype=bf)), {}
    if case == "flash_mla_count":
        return fa_mod, fa_mod.flash_attention, (
            rand(2, 1, 4, 48, dtype=bf), rand(2, 64, 2, 48, dtype=bf),
            rand(2, 64, 2, 32, dtype=bf)), {
                "kv_len": torch.tensor([37], dtype=torch.int32,
                                       device=device)}
    if case == "confidence":
        return conf_mod, conf_mod.confidence_fused, (
            rand(3, 7, 1000, dtype=bf),), {}
    scan = (rand(2, 300, 64, dtype=bf), rand(2, 300, 64).abs() * 0.1,
            rand(2, 300, 16), rand(2, 300, 16), rand(64, 16))
    if case == "scan":
        return scan_mod, scan_mod.selective_scan, scan, {}
    return scan_mod, scan_mod.selective_scan, scan, {
        "h0": rand(2, 64, 16), "return_state": True}


def _layout(out):
    outs = out if isinstance(out, tuple) else (out,)
    return [(tuple(t.shape), t.dtype, t.stride()) for t in outs]


@pytest.mark.parametrize("case", ["flash", "flash_mla_count", "confidence",
                                  "scan", "scan_state"])
def test_meta_stand_ins_match_the_launch(cuda, case):
    """A wrapper's meta stand-in has the shapes, dtypes and strides of what
    its kernel's launch returns on the card; the launch counts one, the
    stand-in none."""
    mod, fn, args, kw = _stand_in_case(case, cuda)
    before = mod.launches
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    assert mod.launches == before + 1
    meta = fn(*(a.to("meta") for a in args),
              **{k: v.to("meta") if isinstance(v, torch.Tensor) else v
                 for k, v in kw.items()})
    assert mod.launches == before + 1
    assert all(t.device.type == "meta" for t in
               (meta if isinstance(meta, tuple) else (meta,)))
    assert _layout(meta) == _layout(got)


@pytest.mark.parametrize("case", ["flash", "confidence", "scan"])
def test_wrappers_still_launch_or_raise_on_the_card(cuda, case):
    """Beside the meta stand-ins a CUDA tensor still launches the kernel
    (counted) or raises: in float16, which no kernel takes, each wrapper
    raises ``ValueError`` and counts nothing."""
    mod, fn, args, kw = _stand_in_case(case, cuda)
    before = mod.launches
    fn(*args, **kw)
    assert mod.launches == before + 1
    with pytest.raises(ValueError):
        fn(*(a.half() if a.dtype == torch.bfloat16 else a for a in args),
           **kw)
    assert mod.launches == before + 1


# --------------------------------------------------------------------------
# the confidence kernel's partials epilogue (a vocab shard's accumulators)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("rows,vocab,offset", [(2, 31616, 94848),
                                               (256, 31616, 31616),
                                               (256, 8192, 8192),
                                               (5, 513, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_confidence_partials_match_plain(cuda, rows, vocab, offset, dtype):
    """One launch (its own count); i1 (offset), m and m2 exact, s within
    rel 2e-4, u / s within (2e-3, 2e-4); a tie gives m2 = m."""
    x = _conf_logits(cuda, rows, vocab, dtype, rows + vocab)
    before, fused = conf_mod.partials_launches, conf_mod.launches
    got = conf_mod.confidence_partials(x, offset)
    torch.cuda.synchronize()
    assert conf_mod.partials_launches == before + 1
    assert conf_mod.launches == fused
    want = conf_mod.confidence_partials_ref(x, offset)
    for name in ("i1", "m", "m2"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert float(got.m2[1]) == float(got.m[1])
    torch.testing.assert_close(got.s, want.s, rtol=2e-4, atol=0.0)
    torch.testing.assert_close(got.u / got.s, want.u / want.s, rtol=2e-3,
                               atol=2e-4)


@pytest.mark.parametrize("vocab", [126464, 32768])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_merged_partials_match_the_fused_kernel(cuda, vocab, dtype):
    """Four shards' partials merged (``core.confidence.merge_partials``)
    against ``confidence_fused`` on the whole rows: argmaxes exact (row 1
    ties across shards 0 and 3, row 2 across the boundary of shards 0 and
    1), margins 0 there, the rest at the fused kernel's tolerances."""
    from repro_torch.core.confidence import merge_partials
    x = _conf_logits(cuda, 64, vocab, dtype, vocab)
    w = vocab // 4
    x[2, w - 1] = x[2, w] = x[2].max() + 1
    parts = [conf_mod.confidence_partials(x[:, r * w:(r + 1) * w]
                                          .contiguous(), r * w)
             for r in range(4)]
    got = merge_partials(conf_mod.Partials(*(
        torch.stack([getattr(p, f) for p in parts])
        for f in conf_mod.Partials._fields)))
    want = conf_mod.confidence_fused(x)
    assert torch.equal(got.argmax, want[0])
    assert float(got.margin[1]) == 0.0 and float(got.margin[2]) == 0.0
    torch.testing.assert_close(got.max_prob, want[1], rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(got.margin, want[2], rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(got.neg_entropy, want[3], rtol=2e-3,
                               atol=2e-4)


# --------------------------------------------------------------------------
# the sharded training step (parallel/, training/trainer.py under a mesh)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("remat", ["none", "block"])
def test_train_step_at_mesh_1x1_matches_no_mesh_on_card(cuda, remat):
    """Two f32 ``make_steps(cfg, mesh=(1, 1))["train"]`` steps of the
    testbed on the card (the sharded path: specs, ``use_params``, the
    mesh-aware loss and clip norm, every collective the identity) against
    the same steps with no mesh, from one seed: the first loss equal, the
    second and the params after both within rel 1e-6 of their scale (the
    clip's norm sums the squares in another order), and the same flash
    launches, 2 × layers a step under ``remat="block"``, else 1 ×."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.convert import to_flat
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_steps
    from repro_torch.models import init_model
    from repro_torch.training import adamw_init
    from repro_torch.training.trainer import masters
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("llada-8b").reduced(num_layers=4, d_model=256,
                                         num_heads=4, num_kv_heads=4,
                                         d_ff=1024, remat=remat)
    gen = torch.Generator(device=cuda).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size - 1, (8, 48),
                                     generator=gen, device=cuda),
             "maskable": torch.ones(8, 48, dtype=torch.bool, device=cuda)}
    batch["maskable"][:, :8] = False
    init = init_model(cfg, torch.Generator(device=cuda).manual_seed(0),
                      device=cuda, dtype=torch.float32)
    tcfg = TrainConfig(batch_size=8, seq_len=48, steps=10)
    out = {}
    for mesh in (None, make_host_mesh()):
        step = make_steps(cfg, tcfg, mesh=mesh)["train"]
        params = masters(init)
        opt = adamw_init(params)
        draws = torch.Generator(device=cuda).manual_seed(3)
        before, losses = fa_mod.launches, []
        for _ in range(2):
            params, opt, met = step(params, opt, draws, batch)
            losses.append(float(met["loss"]))
        out[mesh is None] = (losses, to_flat(params),
                             fa_mod.launches - before)
    (losses, p, n), (mlosses, mp, mn) = out[True], out[False]
    assert mlosses[0] == losses[0]
    assert mlosses[1] == pytest.approx(losses[1], rel=1e-6)
    assert mn == n == 2 * (2 if remat == "block" else 1) * cfg.num_layers
    for key, want in p.items():
        assert abs(mp[key] - want).max() <= 1e-6 * abs(want).max(), key
