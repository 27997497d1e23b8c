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
    """The confidence and selective-scan kernels have no backward: on a
    card they raise where autograd would need one, and run under
    ``no_grad``."""
    logits = torch.randn(4, 1000, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        conf_mod.confidence_fused(logits)
    with torch.no_grad():
        conf_mod.confidence_fused(logits)
    x = torch.randn(1, 16, 32, device=cuda, requires_grad=True)
    delta = torch.rand(1, 16, 32, device=cuda)
    bs, cs = (torch.randn(1, 16, 4, device=cuda) for _ in range(2))
    a_log = torch.zeros(32, 4, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        scan_mod.selective_scan(x, delta, bs, cs, a_log)
    with torch.no_grad():
        scan_mod.selective_scan(x, delta, bs, cs, a_log)


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


def test_hymba_training_on_the_card_raises(cuda):
    """The scan has no gradient on the card yet (ROADMAP.md): training a
    Hymba config there raises rather than dropping the Mamba branch's
    gradient."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import CharTokenizer, TaskDataset
    from repro_torch.training import train
    cfg = get_config("hymba-1.5b").reduced()
    ds = TaskDataset("sum", CharTokenizer(cfg.vocab_size))
    with pytest.raises(RuntimeError, match="no backward"):
        train(cfg, TrainConfig(batch_size=4, seq_len=ds.seq_len, steps=1),
              ds.batches(4), log=None, device=cuda)


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
