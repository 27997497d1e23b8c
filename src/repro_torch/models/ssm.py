"""Recurrent sequence mixers of the port (reference:
``src/repro/models/ssm.py``): the Mamba-style selective SSM head of
Hymba's blocks, and xLSTM's mLSTM and sLSTM.

Mamba: input projection, the depthwise causal conv, the selective
parameters (B, C, Δ), and the scan itself through
``kernels.selective_scan`` (the hand-written kernel on a card, its plain
version on the CPU).  The reference's chunked ``associative_scan`` is
not ported: the fused kernel takes its place, as the reference's own
note at ``mamba_forward`` asks.  xLSTM: the mLSTM in the reference's
chunkwise-parallel form (chunks of ``CHUNK`` tokens, the (head, dk, dv)
matrix state carried from chunk to chunk, a masked quadratic inside each
chunk), and the sLSTM as its strict time recurrence in f32, a Python
loop over L (inside a CUDA-graph capture a few launches a step,
replayed; nothing syncs).

The decode state, as the reference's: ``MambaState`` (the (B, di, N)
state and the conv's rolling (B, K−1, di) tail), ``MLSTMState`` (C, n,
m) and ``SLSTMState`` (c, n, m, h), each with ``init_*_state`` and a
one-token ``*_step``; every full-sequence mixer takes ``state=`` (start
from a frozen prefix) and ``return_state=True`` (also return the end
state).  Mamba's start and end states go through the scan kernel itself
(its ``h0`` and end-state outputs), so the end state is exact at any
length, with no padding to re-scan.

Rounding follows the reference where it shows: the conv is the same
shifted sum over the K taps (not ``F.conv1d``, which cuDNN runs in TF32 by
default), ``bcdt`` is rounded to the compute dtype before it is widened to
f32, and softplus is ``jax.nn.softplus``'s ``logaddexp(x, 0)``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from typing import NamedTuple, Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.selective_scan import selective_scan
from repro_torch.models.layers import Params, dense_init, matmul

CHUNK = 128  # mLSTM chunk length, as the reference's


class MambaState(NamedTuple):
    """h: (B, di, N) f32 diagonal SSM state; conv: (B, K−1, di) rolling
    buffer of the conv's last inputs."""
    h: torch.Tensor
    conv: torch.Tensor


class MLSTMState(NamedTuple):
    """C (B, H, dk, dv), n (B, H, dk), m (B, H), all f32."""
    c: torch.Tensor
    n: torch.Tensor
    m: torch.Tensor


class SLSTMState(NamedTuple):
    """c, n, m and the hidden h fed back into the gates, each (B, di) f32."""
    c: torch.Tensor
    n: torch.Tensor
    m: torch.Tensor
    h: torch.Tensor


def init_mamba(gen: torch.Generator, cfg: ModelConfig, device,
               dtype) -> Params:
    s = cfg.ssm
    d, n = cfg.d_model, s.state_size
    di = s.expand * d
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device=device))
    return {
        "w_in": dense_init(gen, (d, 2 * di), device, dtype),   # x and gate z
        "conv_w": dense_init(gen, (s.conv_kernel, di), device, dtype,
                             scale=0.5),
        "w_bcdt": dense_init(gen, (di, 2 * n + 1), device, dtype,
                             scale=0.02),                      # B, C, dt
        "a_log": a_log[None, :].repeat(di, 1),   # (di, N) neg-real A, f32
        "dt_bias": torch.full((di,), -4.6, dtype=torch.float32,
                              device=device),    # softplus ≈ 0.01
        "w_out": dense_init(gen, (di, d), device, dtype),
    }


def _mamba_inputs(p: Params, x: torch.Tensor, cfg: ModelConfig):
    xz = matmul(x, p["w_in"], x.dtype)
    return xz.chunk(2, dim=-1)                          # xin, z (B, L, di)


def _mamba_conv_full(p: Params, xin: torch.Tensor, cfg: ModelConfig,
                     prev: Optional[torch.Tensor] = None):
    """Depthwise causal conv along L (width K), xin (B, L, di); its left
    pad is ``prev`` (B, K−1, di), a frozen prefix's tail, or zeros."""
    k, length = cfg.ssm.conv_kernel, xin.shape[1]
    pad = F.pad(xin, (0, 0, k - 1, 0)) if prev is None else \
        torch.cat([prev.to(xin.dtype), xin], dim=1)
    w = p["conv_w"].to(xin.dtype)                       # (K, di)
    out = sum(pad[:, i:i + length] * w[i] for i in range(k))
    return F.silu(out)


def _softplus(v: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(v, 0) = max(v, 0) + log1p(e^-|v|)
    (torch's ``F.softplus`` turns into the identity above 20)."""
    return v.clamp_min(0) + torch.log1p(torch.exp(-v.abs()))


def _mamba_scan_terms(p: Params, xc: torch.Tensor, cfg: ModelConfig):
    """The selective parameters: Δ (B, L, di) and B, C (B, L, N), f32."""
    n = cfg.ssm.state_size
    bcdt = matmul(xc, p["w_bcdt"], xc.dtype).float()
    b_sel, c_sel, dt_pre = torch.split(bcdt, [n, n, 1], dim=-1)
    # low-rank dt: a scalar per position, broadcast over the channels, plus
    # a per-channel bias (the rank-1 form of mamba's dt projection)
    delta = _softplus(dt_pre + p["dt_bias"])
    return delta, b_sel.contiguous(), c_sel.contiguous()


def mamba_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  state: Optional[MambaState] = None,
                  return_state: bool = False):
    """x (B, L, d) -> (B, L, d) in x's dtype.  ``state`` seeds it (a
    frozen prefix: the conv's left pad is the prefix's tail, the scan
    starts from its h); ``return_state=True`` also returns the end state
    (the scan's exact h_L and the conv's new tail)."""
    xin, z = _mamba_inputs(p, x, cfg)
    xc = _mamba_conv_full(p, xin, cfg, None if state is None
                          else state.conv)              # (B, L, di)
    delta, b_sel, c_sel = _mamba_scan_terms(p, xc, cfg)
    res = selective_scan(xc, delta, b_sel, c_sel, p["a_log"],
                         h0=None if state is None else state.h,
                         return_state=return_state)
    y, h_end = res if return_state else (res, None)
    out = matmul(y * F.silu(z), p["w_out"], x.dtype)
    if not return_state:
        return out
    k = cfg.ssm.conv_kernel
    prev = state.conv.to(xin.dtype) if state is not None else \
        xin.new_zeros(xin.shape[0], k - 1, xin.shape[2])
    tail = torch.cat([prev, xin], dim=1)[:, xin.shape[1]:].contiguous()
    return out, MambaState(h_end, tail)


def mamba_step(p: Params, x: torch.Tensor, cfg: ModelConfig,
               state: MambaState):
    """One token x (B, 1, d): the rolling conv buffer and one diagonal
    state update.  Returns (out (B, 1, d), the new state)."""
    xin, z = _mamba_inputs(p, x, cfg)                   # (B, 1, di)
    buf = torch.cat([state.conv, xin], dim=1)           # (B, K, di)
    w = p["conv_w"].to(x.dtype)
    xc = F.silu(torch.sum(buf * w[None], dim=1, keepdim=True))
    delta, b_sel, c_sel = _mamba_scan_terms(p, xc, cfg)
    a = -torch.exp(p["a_log"].float())                  # (di, N)
    dt = delta[:, 0, :, None]                           # (B, di, 1)
    h_new = torch.exp(dt * a) * state.h + \
        dt * b_sel[:, 0, None, :] * xc[:, 0].float()[..., None]
    y = torch.einsum("bcn,bn->bc", h_new, c_sel[:, 0])[:, None]
    out = matmul(y.to(x.dtype) * F.silu(z), p["w_out"], x.dtype)
    return out, MambaState(h_new, buf[:, 1:])


def init_mamba_state(cfg: ModelConfig, batch: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device="cuda") -> MambaState:
    s = cfg.ssm
    dev = resolve_device(device)
    di = s.expand * cfg.d_model
    return MambaState(
        torch.zeros(batch, di, s.state_size, dtype=torch.float32,
                    device=dev),
        torch.zeros(batch, s.conv_kernel - 1, di, dtype=dtype, device=dev))


# ==========================================================================
# xLSTM: mLSTM (matrix memory, chunkwise parallel) and sLSTM (scalar
# memory, exponential gating, a strict recurrence)
# ==========================================================================

def _f32(shape, value: float, device) -> torch.Tensor:
    return torch.full(shape, value, dtype=torch.float32, device=device)


def init_mlstm(gen: torch.Generator, cfg: ModelConfig, device,
               dtype) -> Params:
    """The reference's mLSTM tree; the gate biases ``b_i``/``b_f`` stay
    f32 (they add to f32 pre-activations)."""
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    h = s.num_ssm_heads
    return {
        "w_up": dense_init(gen, (d, di), device, dtype),
        "w_q": dense_init(gen, (di, di), device, dtype),
        "w_k": dense_init(gen, (di, di), device, dtype),
        "w_v": dense_init(gen, (di, di), device, dtype),
        "w_i": dense_init(gen, (di, h), device, dtype, scale=0.02),
        "w_f": dense_init(gen, (di, h), device, dtype, scale=0.02),
        "b_i": _f32((h,), 0.0, device),
        "b_f": _f32((h,), 3.0, device),       # bias toward remembering
        "w_down": dense_init(gen, (di, d), device, dtype),
        "skip_scale": torch.ones(di, dtype=dtype, device=device),
    }


def _mlstm_heads(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """x (B, L, d) -> inner (B, L, di), q, k, v (B, L, H, dh) in x's dtype
    (k scaled by dh^-½ in that dtype) and the f32 gate pre-activations
    (B, L, H)."""
    dt = x.dtype
    inner = matmul(x, p["w_up"], dt)
    b, l, di = inner.shape
    h = cfg.ssm.num_ssm_heads
    dh = di // h
    q = matmul(inner, p["w_q"], dt).reshape(b, l, h, dh)
    k = matmul(inner, p["w_k"], dt).reshape(b, l, h, dh) * (dh ** -0.5)
    v = matmul(inner, p["w_v"], dt).reshape(b, l, h, dh)
    i_pre = matmul(inner, p["w_i"], dt).float() + p["b_i"]
    f_pre = matmul(inner, p["w_f"], dt).float() + p["b_f"]
    return inner, q, k, v, i_pre, f_pre


def mlstm_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  state: Optional[MLSTMState] = None,
                  return_state: bool = False):
    """The chunkwise-parallel mLSTM over x (B, L, d) -> (B, L, d) in x's
    dtype: exponential gating in log space with the stabiliser m (from
    -1e30, or ``state``'s), the (C, n, m) state carried over chunks of
    ``CHUNK``, a masked quadratic inside each, every product in f32, the
    normaliser max(|n·q|, exp(-m)) + 1e-6, then the learnable skip and
    the down projection.  A length off the chunk is padded with identity
    steps (input gate -30, forget gate +30), not zeros; their outputs are
    cut, and the carry past them is the end state ``return_state=True``
    adds."""
    dt = x.dtype
    inner, q, k, v, i_pre, f_pre = _mlstm_heads(p, x, cfg)
    b, l, h, dh = q.shape
    pad = (-l) % CHUNK
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        i_pre = F.pad(i_pre, (0, 0, 0, pad), value=-30.0)
        f_pre = F.pad(f_pre, (0, 0, 0, pad), value=30.0)
    nc = q.shape[1] // CHUNK

    def rs(a):                                    # (B, nc, C, ...)
        return a.reshape(b, nc, CHUNK, *a.shape[2:])

    qc, kc, vc = (rs(a).float() for a in (q, k, v))   # (B, nc, C, H, dh)
    ic = rs(i_pre)                                      # (B, nc, C, H)
    csum = torch.cumsum(F.logsigmoid(rs(f_pre)), dim=2)
    tri = torch.ones(CHUNK, CHUNK, dtype=torch.bool,
                     device=x.device).tril()[None, :, :, None]
    if state is None:
        state = init_mlstm_state(cfg, b, x.device)
    c_state, n_state, m_state = state
    outs = []
    for c in range(nc):
        qch, kch, vch = qc[:, c], kc[:, c], vc[:, c]
        a, log_i = csum[:, c], ic[:, c]               # (B, C, H)
        total = a[:, -1]                              # (B, H)
        m_new = torch.maximum(m_state + total,
                              (log_i + (total[:, None] - a)).amax(dim=1))
        # inter-chunk: queries decayed from the chunk's start
        q_scale = torch.exp(a + m_state[:, None] - m_new[:, None])
        qs = qch * q_scale[..., None]
        inter = torch.einsum("bchk,bhkv->bchv", qs, c_state)
        n_inter = torch.einsum("bchk,bhk->bch", qs, n_state)
        # intra-chunk: decay from j to t (j <= t), masked above
        dmat = a[:, :, None] - a[:, None, :]          # (B, C, C, H)
        gate = torch.exp(dmat + log_i[:, None] - m_new[:, None, None])
        gate = torch.where(tri, gate, torch.zeros((), device=x.device))
        scores = torch.einsum("bthk,bjhk->btjh", qch, kch) * gate
        intra = torch.einsum("btjh,bjhv->bthv", scores, vch)
        n_intra = scores.sum(dim=2)                   # (B, C, H)
        den = torch.maximum((n_inter + n_intra).abs(),
                            torch.exp(-m_new)[:, None]) + 1e-6
        outs.append(((inter + intra) / den[..., None]).to(dt))
        # the state after the chunk
        k_scale = torch.exp((total[:, None] - a) + log_i - m_new[:, None])
        kw = kch * k_scale[..., None]
        decay = torch.exp(m_state + total - m_new)
        c_state = decay[..., None, None] * c_state + \
            torch.einsum("bchk,bchv->bhkv", kw, vch)
        n_state = decay[..., None] * n_state + kw.sum(dim=1)
        m_state = m_new
    out = torch.cat(outs, dim=1)[:, :l].reshape(b, l, h * dh)
    out = out + inner * F.silu(p["skip_scale"].to(dt))
    out = matmul(out, p["w_down"], dt)
    if return_state:
        return out, MLSTMState(c_state, n_state, m_state)
    return out


def mlstm_step(p: Params, x: torch.Tensor, cfg: ModelConfig,
               state: MLSTMState):
    """One token x (B, 1, d) carrying (C, n, m): O(d²) a token.  Returns
    (out (B, 1, d), the new state)."""
    dt = x.dtype
    inner, q, k, v, i_pre, f_pre = _mlstm_heads(p, x, cfg)
    b, _, h, dh = q.shape
    q1, k1, v1 = (a[:, 0].float() for a in (q, k, v))   # (B, H, dh)
    logf = F.logsigmoid(f_pre[:, 0])                    # (B, H)
    logi = i_pre[:, 0]
    m_new = torch.maximum(state.m + logf, logi)
    fdec = torch.exp(state.m + logf - m_new)
    iw = torch.exp(logi - m_new)
    c_new = fdec[..., None, None] * state.c + iw[..., None, None] * \
        torch.einsum("bhk,bhv->bhkv", k1, v1)
    n_new = fdec[..., None] * state.n + iw[..., None] * k1
    num = torch.einsum("bhk,bhkv->bhv", q1, c_new)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", q1, n_new).abs(),
                        torch.exp(-m_new)) + 1e-6
    out = (num / den[..., None]).to(dt).reshape(b, 1, h * dh)
    out = out + inner * F.silu(p["skip_scale"].to(dt))
    return matmul(out, p["w_down"], dt), MLSTMState(c_new, n_new, m_new)


def init_mlstm_state(cfg: ModelConfig, batch: int,
                     device="cuda") -> MLSTMState:
    s = cfg.ssm
    dev = resolve_device(device)
    h = s.num_ssm_heads
    dh = s.expand * cfg.d_model // h
    return MLSTMState(
        torch.zeros(batch, h, dh, dh, dtype=torch.float32, device=dev),
        torch.zeros(batch, h, dh, dtype=torch.float32, device=dev),
        _f32((batch, h), -1e30, dev))


def init_slstm(gen: torch.Generator, cfg: ModelConfig, device,
               dtype) -> Params:
    """The reference's sLSTM tree; the gate weights and biases
    (``w_gates``, ``r_gates``, ``b_gates``) stay f32: the recurrence
    multiplies by them in f32."""
    di = cfg.ssm.expand * cfg.d_model
    return {
        "w_up": dense_init(gen, (cfg.d_model, di), device, dtype),
        "w_gates": dense_init(gen, (di, 4 * di), device,
                              torch.float32),        # z, i, f, o from input
        "r_gates": dense_init(gen, (di, 4 * di), device, torch.float32,
                              scale=0.02),           # recurrent
        "b_gates": torch.cat([_f32((2 * di,), 0.0, device),
                              _f32((di,), 3.0, device),
                              _f32((di,), 0.0, device)]),
        "w_down": dense_init(gen, (di, cfg.d_model), device, dtype),
    }


def _slstm_cell(xw: torch.Tensor, st: SLSTMState, r_gates: torch.Tensor,
                b_gates: torch.Tensor) -> SLSTMState:
    """One exponential-gated step from the input's gate product ``xw``
    (B, 4·di) f32: pre = xw + h @ r_gates + b_gates, in that order."""
    pre = torch.addmm(xw, st.h, r_gates) + b_gates
    z, i_pre, f_pre, o = pre.chunk(4, dim=-1)
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + st.m, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(logf + st.m - m_new)
    c = f_g * st.c + i_g * torch.tanh(z)
    n = f_g * st.n + i_g
    h = torch.sigmoid(o) * c / torch.clamp_min(n, 1e-6)
    return SLSTMState(c, n, m_new, h)


def slstm_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  state: Optional[SLSTMState] = None,
                  return_state: bool = False):
    """The sLSTM over x (B, L, d) -> (B, L, d) in x's dtype: a strict
    recurrence in f32 over ``inner = (x @ w_up)`` widened to f32, from
    ``state`` (default c = n = h = 0 and m = -1e30).  The input's gate
    products are one f32 GEMM over all steps (each step's row as the
    reference's per-step product); each step adds h @ r_gates, then
    b_gates.  ``return_state=True`` also returns the last step's state."""
    dt = x.dtype
    inner = matmul(x, p["w_up"], dt).float()           # (B, L, di)
    b, l, di = inner.shape
    xw = inner @ p["w_gates"].float()                  # (B, L, 4·di)
    r_gates, b_gates = p["r_gates"].float(), p["b_gates"].float()
    st = state if state is not None else init_slstm_state(cfg, b, x.device)
    hs = []
    for t in range(l):
        st = _slstm_cell(xw[:, t], st, r_gates, b_gates)
        hs.append(st.h)
    out = matmul(torch.stack(hs, dim=1).to(dt), p["w_down"], dt)
    return (out, st) if return_state else out


def slstm_step(p: Params, x: torch.Tensor, cfg: ModelConfig,
               state: SLSTMState):
    """One token x (B, 1, d).  Returns (out (B, 1, d), the new state)."""
    dt = x.dtype
    inner = matmul(x, p["w_up"], dt).float()[:, 0]     # (B, di)
    st = _slstm_cell(inner @ p["w_gates"].float(), state,
                     p["r_gates"].float(), p["b_gates"].float())
    return matmul(st.h.to(dt)[:, None], p["w_down"], dt), st


def init_slstm_state(cfg: ModelConfig, batch: int,
                     device="cuda") -> SLSTMState:
    dev = resolve_device(device)
    di = cfg.ssm.expand * cfg.d_model
    zeros = torch.zeros(batch, di, dtype=torch.float32, device=dev)
    return SLSTMState(zeros, zeros.clone(), _f32((batch, di), -1e30, dev),
                      zeros.clone())


def xlstm_kind(cfg: ModelConfig, layer_idx: int) -> str:
    """'m' or 's': ``xlstm_pattern`` cycled over the layers."""
    pat = cfg.ssm.xlstm_pattern
    return pat[layer_idx % len(pat)]


def init_xlstm_layer(gen: torch.Generator, cfg: ModelConfig, idx: int,
                     device, dtype) -> Params:
    if xlstm_kind(cfg, idx) == "s":
        return init_slstm(gen, cfg, device, dtype)
    return init_mlstm(gen, cfg, device, dtype)


def xlstm_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, idx: int,
                  state=None, return_state: bool = False):
    if xlstm_kind(cfg, idx) == "s":
        return slstm_forward(p, x, cfg, state, return_state)
    return mlstm_forward(p, x, cfg, state, return_state)


def xlstm_step(p: Params, x: torch.Tensor, cfg: ModelConfig, idx: int,
               state) -> Tuple[torch.Tensor, tuple]:
    if xlstm_kind(cfg, idx) == "s":
        return slstm_step(p, x, cfg, state)
    return mlstm_step(p, x, cfg, state)


def init_xlstm_state(cfg: ModelConfig, idx: int, batch: int,
                     device="cuda"):
    if xlstm_kind(cfg, idx) == "s":
        return init_slstm_state(cfg, batch, device)
    return init_mlstm_state(cfg, batch, device)
