"""The port's selective scan and Mamba head against the reference's.

On the CPU ``selective_scan`` runs its plain version; it is held against
the reference's Pallas kernel (interpret mode) and its jnp oracle on the
same inputs made with numpy, at the shapes and tolerances of
``tests/test_kernels.py`` (rtol = atol = 2e-4 in f32, 3e-2 in bf16).
``mamba_forward`` is held against the reference's chunked associative
scan on bridged weights within 1e-4 in f32: the two scans sum in
different orders.  The hand-written kernel is held against the plain
version on the card by ``tests/test_torch_gpu.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro.configs import get_config as jax_get_config
from repro.kernels.ref import selective_scan_ref as jax_scan_ref
from repro.kernels.selective_scan import selective_scan as jax_scan
from repro.models import ssm as jax_ssm
from repro.models.ssm import MAMBA_CHUNK
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.kernels import selective_scan as scan_mod
from repro_torch.models import ssm

SCAN_SHAPES = [
    (2, 300, 130, 16),    # ragged time + channel tiles
    (1, 256, 128, 8),     # exact tiles
    (2, 100, 64, 16),     # single partial tile
]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(a: np.ndarray, dtype: str):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jnp.float32).astype(jdt), \
        torch.from_numpy(np.asarray(a, np.float32)).to(tdt)


def _scan_inputs(b, l, di, n, seed):
    rs = np.random.default_rng(seed)
    x = rs.standard_normal((b, l, di))
    delta = np.log1p(np.exp(rs.standard_normal((b, l, di)) - 2))
    bs = rs.standard_normal((b, l, n))
    cs = rs.standard_normal((b, l, n))
    a_log = np.log(np.arange(1, n + 1, dtype=np.float32))[None].repeat(di, 0)
    return x, delta, bs, cs, a_log


@pytest.mark.parametrize("b,l,di,n", SCAN_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_plain_matches_pallas_and_oracle(b, l, di, n, dtype):
    x, delta, bs, cs, a_log = _scan_inputs(b, l, di, n, l + di)
    (jx, tx), (jd, td), (jb, tb), (jc, tc) = (
        _both(a, dtype) for a in (x, delta, bs, cs))
    ja, ta = jnp.asarray(a_log), torch.from_numpy(a_log)
    got = scan_mod.selective_scan(tx, td, tb, tc, ta)
    assert got.dtype == tx.dtype and got.shape == (b, l, di)
    tol = 2e-4 if dtype == "float32" else 3e-2
    for want in (jax_scan(jx, jd, jb, jc, ja),
                 jax_scan_ref(jx, jd, jb, jc, ja)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


def test_scan_mixed_dtypes_match_oracle():
    """The serving path's mix: x bf16, Δ/B/C f32; y comes back bf16."""
    x, delta, bs, cs, a_log = _scan_inputs(2, 70, 48, 16, 5)
    jx, tx = _both(x, "bfloat16")
    rest = [_both(a, "float32") for a in (delta, bs, cs)]
    got = scan_mod.selective_scan(tx, *(t for _, t in rest),
                                  torch.from_numpy(a_log))
    want = jax_scan_ref(jx, *(j for j, _ in rest), jnp.asarray(a_log))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=3e-2, atol=3e-2)


def test_scan_state_carries_across_tiles():
    """A constant drive with slow decay must accumulate monotonically far
    beyond one Pallas time tile (the state is carried, not reset)."""
    b, l, di, n = 1, 600, 64, 4
    x = torch.ones(b, l, di)
    delta = torch.full((b, l, di), 0.01)
    bs = torch.ones(b, l, n)
    cs = torch.ones(b, l, n)
    a_log = torch.full((di, n), -3.0)   # A ≈ -0.05: slow decay
    y = scan_mod.selective_scan(x, delta, bs, cs, a_log)
    assert float(y[0, 599, 0]) > float(y[0, 100, 0]) > float(y[0, 5, 0])
    want = jax_scan(*(jnp.asarray(t.numpy()) for t in
                      (x, delta, bs, cs, a_log)))
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def _two_pass_scan(x, delta, b_sel, c_sel, a_log):
    """The card kernel's chunked two-pass scan, emulated in plain f32
    torch: ``scan_mod.chunk_len``'s split of L; pass 1 walks every chunk
    but the last from h = 0, keeping its end state and decay product;
    pass 2 folds the earlier chunks' carries, H = P_i·H + h_end_i, and
    walks its chunk again from H for y."""
    a = -torch.exp(a_log)
    bsz, length, di = x.shape
    chunk = scan_mod.chunk_len(bsz, length, di)
    bounds = [(t0, min(length, t0 + chunk))
              for t0 in range(0, length, chunk)]
    assert len(bounds) <= scan_mod.MAX_CHUNKS
    assert all(t1 - t0 >= scan_mod.MIN_CHUNK for t0, t1 in bounds[:-1])

    def walk(h, t0, t1, ys):
        prod = torch.ones_like(h)
        for t in range(t0, t1):
            dt = delta[:, t, :, None]
            decay = torch.exp(dt * a)
            h = decay * h + dt * b_sel[:, t, None, :] * x[:, t, :, None]
            prod = prod * decay
            ys.append(torch.sum(h * c_sel[:, t, None, :], dim=-1))
        return h, prod

    zeros = torch.zeros(bsz, di, a.shape[-1])
    carries = [walk(zeros, t0, t1, []) for t0, t1 in bounds[:-1]]
    ys = []
    for j, (t0, t1) in enumerate(bounds):
        h = zeros
        for h_end, prod in carries[:j]:
            h = prod * h + h_end
        walk(h, t0, t1, ys)
    return torch.stack(ys, dim=1)


@pytest.mark.parametrize("b,l,di,n", [
    (2, 300, 130, 16),    # L not a multiple of the chunk; ragged di
    (1, 10, 64, 16),      # L shorter than one chunk
    (1, 1, 64, 16),       # L = 1
    (1, 40, 33, 5),       # N = 5, ragged di and L
    (3, 64, 48, 8),       # B = 3
    (1, 2048, 8, 4),      # the most chunks, 128 steps each
])
def test_two_pass_chunk_arithmetic_matches_plain_and_oracle(b, l, di, n):
    """The chunk split, carry fold and re-walk of the card kernel, in f32
    on the CPU, against the plain sequential scan and the JAX oracle."""
    x, delta, bs, cs, a_log = _scan_inputs(b, l, di, n, 7 * l + di)
    ts = [torch.from_numpy(np.asarray(t, np.float32))
          for t in (x, delta, bs, cs, a_log)]
    got = _two_pass_scan(*ts)
    assert got.shape == (b, l, di)
    for want in (scan_mod.selective_scan_ref(*ts),
                 jax_scan_ref(*(jnp.asarray(t.numpy()) for t in ts))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                                   rtol=2e-4, atol=2e-4)


class _Elsewhere(torch.Tensor):
    """A CPU tensor that reports a device the wrapper does not take (meta
    tensors now get the kernel's stand-in: ``test_torch_dryrun.py``)."""

    @property
    def device(self):
        return torch.device("xpu")


def test_scan_wrapper_refuses_other_devices_and_counts_no_plain_launch():
    x = torch.empty(1, 4, 8).as_subclass(_Elsewhere)
    bs = torch.empty(1, 4, 16).as_subclass(_Elsewhere)
    with pytest.raises(ValueError, match="unsupported device"):
        scan_mod.selective_scan(x, x, bs, bs, torch.empty(8, 16))
    before = scan_mod.launches
    scan_mod.selective_scan(torch.zeros(1, 4, 8), torch.zeros(1, 4, 8),
                            torch.zeros(1, 4, 16), torch.zeros(1, 4, 16),
                            torch.zeros(8, 16))
    assert scan_mod.launches == before


@pytest.mark.parametrize("bad,match", [
    (dict(delta=(1, 5, 8)), "must be one"),
    (dict(b_sel=(1, 4, 8)), "do not fit"),
    (dict(a_log=(8, 40), b_sel=(1, 4, 40), c_sel=(1, 4, 40)), "state size"),
    (dict(dtype=torch.float16), "float32 or bfloat16"),
])
def test_scan_kernel_checks_refuse_what_it_cannot_take(bad, match):
    """``_check`` guards the kernel's launch; it runs on meta tensors."""
    shapes = dict(x=(1, 4, 8), delta=(1, 4, 8), b_sel=(1, 4, 16),
                  c_sel=(1, 4, 16), a_log=(8, 16))
    dtype = bad.pop("dtype", torch.float32)
    shapes.update(bad)
    ts = {k: torch.empty(v, device="meta") for k, v in shapes.items()}
    ts["x"] = ts["x"].to(dtype)
    with pytest.raises(ValueError, match=match):
        scan_mod._check(ts["x"], ts["delta"], ts["b_sel"], ts["c_sel"],
                        ts["a_log"])


# --------------------------------------------------------------------------
# the Mamba head against the reference's (chunked associative scan)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mamba_weights():
    jcfg = jax_get_config("hymba-1.5b").reduced()
    jp = jax_ssm.init_mamba(jax.random.PRNGKey(3), jcfg)
    # a spread of decays and biases, so the scan is not near-trivial
    rs = np.random.default_rng(3)
    jp = dict(jp, dt_bias=jnp.asarray(rs.uniform(-3, 0, jp["dt_bias"].shape),
                                      jnp.float32))
    tp = from_jax_params({"embed": {}, "norm_f": {}, "blocks": [
        jax.tree.map(lambda a: np.asarray(a)[None], jp)]},
        device="cpu")["blocks"][0]
    return jcfg, get_config("hymba-1.5b").reduced(), jp, tp


@pytest.mark.parametrize("length", [48, MAMBA_CHUNK + 44])
def test_mamba_forward_matches_reference(mamba_weights, length):
    """L = 300 > MAMBA_CHUNK crosses the reference's chunk carry."""
    jcfg, tcfg, jp, tp = mamba_weights
    x = np.random.default_rng(length).standard_normal(
        (2, length, jcfg.d_model)).astype(np.float32)
    want = jax_ssm.mamba_forward(jp, jnp.asarray(x), jcfg)
    got = ssm.mamba_forward(tp, torch.from_numpy(x), tcfg)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("part", ["conv", "scan_terms"])
def test_mamba_parts_match_reference(mamba_weights, part):
    jcfg, tcfg, jp, tp = mamba_weights
    rs = np.random.default_rng(11)
    di = jcfg.ssm.expand * jcfg.d_model
    x = (3 * rs.standard_normal((2, 20, di))).astype(np.float32)
    if part == "conv":
        want = [jax_ssm._mamba_conv_full(jp, jnp.asarray(x), jcfg)]
        got = [ssm._mamba_conv_full(tp, torch.from_numpy(x), tcfg)]
    else:
        # a bias spread over ±40 takes softplus into both of its tails
        tp = dict(tp, dt_bias=torch.linspace(-40, 40, di))
        jp = dict(jp, dt_bias=jnp.linspace(-40, 40, di))
        _, _, c_want = jax_ssm._mamba_scan_terms(jp, jnp.asarray(x), jcfg)
        delta, b_sel, c_sel = ssm._mamba_scan_terms(tp, torch.from_numpy(x),
                                                    tcfg)
        bcdt = np.asarray(jnp.asarray(x) @ jp["w_bcdt"])
        n = jcfg.ssm.state_size
        want = [jax.nn.softplus(bcdt[..., 2 * n:] + jp["dt_bias"]),
                bcdt[..., :n], c_want]
        got = [delta, b_sel, c_sel]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


# --------------------------------------------------------------------------
# the scan's gradient: ``selective_scan_backward`` (the card's backward)
# --------------------------------------------------------------------------

def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _within_bf16_ulp(got, want) -> bool:
    """|got − want| ≤ one bf16 ulp of the element + 1e-4 × max |want|: a
    bf16 leaf is the same f32 sum rounded once, which may round the other
    way where the two sums straddle a rounding boundary."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.where(mag > 0, mag, 1.0))) - 7)
    tol = np.where(mag > 0, ulp, 0.0) + 1e-4 * np.abs(want).max()
    return bool(np.all(np.abs(got - want) <= tol))


# (B, L, di, N, x dtype, chunk of the backward): one chunk; a ragged L
# over several chunks, each ragged against the walked round of 16; the
# serving path's mix of dtypes (x bf16, Δ/B/C f32) over two chunks
SCAN_GRAD_CASES = {"one-chunk": (2, 48, 24, 16, "float32", 128),
                   "ragged": (2, 101, 20, 8, "float32", 24),
                   "mixed-dtypes": (2, 70, 32, 16, "bfloat16", 40)}


@pytest.mark.parametrize("case", sorted(SCAN_GRAD_CASES))
def test_scan_backward_matches_autograd_and_jax(case):
    """dx, dΔ, dB, dC and d a_log against autograd of the plain version
    and ``jax.grad`` of the reference's oracle (``kernels/ref.py``), each
    to 1e-4 of its leaf's max |g| (a bf16 leaf within one bf16 ulp)."""
    b, l, di, n, xdt, chunk = SCAN_GRAD_CASES[case]
    x, delta, bs, cs, a_log = _scan_inputs(b, l, di, n, l + di)
    a_log = a_log + 0.3 * np.random.default_rng(1).standard_normal(
        a_log.shape).astype(np.float32)
    dy = np.random.default_rng(2).standard_normal((b, l, di))
    (jx, tx), (jdy, tdy) = _both(x, xdt), _both(dy, xdt)
    rest = [_both(a, "float32") for a in (delta, bs, cs, a_log)]
    ins = [tx] + [t for _, t in rest]
    got = scan_mod.selective_scan_backward(*ins, tdy, chunk=chunk)
    leaves = [t.detach().requires_grad_(True) for t in ins]
    want = torch.autograd.grad(scan_mod.selective_scan_ref(*leaves), leaves,
                               tdy)

    def loss(*args):
        y = jax_scan_ref(*args).astype(jnp.float32)
        return jnp.sum(y * jdy.astype(jnp.float32))
    jax_grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(
        jx, *(j for j, _ in rest))
    for name, g, w, j, t in zip(("x", "delta", "b", "c", "a_log"), got,
                                want, jax_grads, ins):
        assert g.dtype == t.dtype and g.shape == t.shape, name
        if t.dtype == torch.bfloat16:
            assert _within_bf16_ulp(g.float(), w.float()), name
            assert _within_bf16_ulp(g.float(), np.asarray(j, np.float32)), \
                name
        else:
            assert _rel_err(g, w) <= 1e-4, name
            assert _rel_err(g, j) <= 1e-4, name


def test_scan_function_runs_the_plain_forward_on_the_cpu():
    """``SelectiveScan`` on CPU tensors: the plain forward, no launch, and
    ``selective_scan_backward`` as its gradient."""
    x, delta, bs, cs, a_log = (torch.from_numpy(np.asarray(a, np.float32))
                               for a in _scan_inputs(1, 30, 8, 4, 9))
    ins = [t.requires_grad_(True) for t in (x, delta, bs, cs, a_log)]
    before = scan_mod.launches
    y = scan_mod.SelectiveScan.apply(*ins)
    assert scan_mod.launches == before
    assert torch.equal(y, scan_mod.selective_scan_ref(x, delta, bs, cs,
                                                      a_log))
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(0))
    got = torch.autograd.grad(y, ins, dy)
    want = scan_mod.selective_scan_backward(
        *(t.detach() for t in ins), dy)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _scan_through_backward(monkeypatch):
    """Route ``mamba_forward``'s scan through ``SelectiveScan`` (on the
    CPU: the plain forward, ``selective_scan_backward`` as the gradient);
    returns the list its backward calls are counted in."""
    calls = []

    def backward(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)
    real = scan_mod.selective_scan_backward
    monkeypatch.setattr(scan_mod, "selective_scan_backward", backward)

    def scan(x, d, b, c, a, h0=None, return_state=False):
        assert h0 is None and not return_state      # a stateless forward
        return scan_mod.SelectiveScan.apply(x, d, b, c, a.float())
    monkeypatch.setattr(ssm, "selective_scan", scan)
    return calls


def test_mamba_gradient_through_the_scan_backward_matches_jax(
        mamba_weights, monkeypatch):
    """Every gradient of ``mamba_forward`` (x and each Mamba weight) with
    the scan's part from ``selective_scan_backward``, against ``jax.grad``
    of the reference's chunked ``associative_scan`` at L = 300 (two of its
    chunks, three of the backward's), each to 1e-4 of its max |g|."""
    jcfg, tcfg, jp, tp = mamba_weights
    calls = _scan_through_backward(monkeypatch)
    rs = np.random.default_rng(4)
    length = MAMBA_CHUNK + 44
    x = rs.standard_normal((2, length, jcfg.d_model)).astype(np.float32)
    dout = rs.standard_normal(x.shape).astype(np.float32)

    def loss(p, x):
        return jnp.sum(jax_ssm.mamba_forward(p, x, jcfg) * dout)
    jg_p, jg_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves = {k: v.detach().requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out = ssm.mamba_forward(leaves, tx, tcfg)
    grads = torch.autograd.grad(out, [tx, *leaves.values()],
                                torch.from_numpy(dout))
    assert calls == [(2, length, 2 * jcfg.d_model)]
    assert _rel_err(grads[0], jg_x) <= 1e-4, "x"
    for (key, _), g in zip(leaves.items(), grads[1:]):
        assert _rel_err(g, jg_p[key]) <= 1e-4, key
