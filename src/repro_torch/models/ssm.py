"""Recurrent sequence mixers of the port (reference:
``src/repro/models/ssm.py``): the Mamba-style selective SSM head of
Hymba's blocks, and xLSTM's mLSTM and sLSTM.

The full-sequence paths only.  Mamba: input projection, the depthwise
causal conv, the selective parameters (B, C, Δ), and the scan itself
through ``kernels.selective_scan`` (the hand-written kernel on a card,
its plain version on the CPU).  The reference's chunked
``associative_scan`` is not ported: the fused kernel takes its place, as
the reference's own note at ``mamba_forward`` asks.  xLSTM: the mLSTM in
the reference's chunkwise-parallel form (chunks of ``CHUNK`` tokens, the
(head, dk, dv) matrix state carried from chunk to chunk, a masked
quadratic inside each chunk), and the sLSTM as its strict time
recurrence in f32, a Python loop over L (inside a CUDA-graph capture a
few launches a step, replayed; nothing syncs).  The decode-state paths
(``MambaState``/``mamba_step``, ``MLSTMState``/``mlstm_step``,
``SLSTMState``/``slstm_step``) come with the single-token decode
(ROADMAP.md queue 1 item 11).

Rounding follows the reference where it shows: the conv is the same
shifted sum over the K taps (not ``F.conv1d``, which cuDNN runs in TF32 by
default), ``bcdt`` is rounded to the compute dtype before it is widened to
f32, and softplus is ``jax.nn.softplus``'s ``logaddexp(x, 0)``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.selective_scan import selective_scan
from repro_torch.models.layers import Params, dense_init, matmul

CHUNK = 128  # mLSTM chunk length, as the reference's


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


def _mamba_conv_full(p: Params, xin: torch.Tensor, cfg: ModelConfig):
    """Depthwise causal conv along L (width K), xin (B, L, di)."""
    k, length = cfg.ssm.conv_kernel, xin.shape[1]
    pad = F.pad(xin, (0, 0, k - 1, 0))
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


def mamba_forward(p: Params, x: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """x (B, L, d) -> (B, L, d) in x's dtype."""
    xin, z = _mamba_inputs(p, x, cfg)
    xc = _mamba_conv_full(p, xin, cfg)                  # (B, L, di)
    delta, b_sel, c_sel = _mamba_scan_terms(p, xc, cfg)
    y = selective_scan(xc, delta, b_sel, c_sel, p["a_log"])
    return matmul(y * F.silu(z), p["w_out"], x.dtype)


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


def mlstm_forward(p: Params, x: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """The chunkwise-parallel mLSTM over x (B, L, d) -> (B, L, d) in x's
    dtype: exponential gating in log space with the stabiliser m (from
    -1e30), the (C, n, m) state carried over chunks of ``CHUNK``, a
    masked quadratic inside each, every product in f32, the normaliser
    max(|n·q|, exp(-m)) + 1e-6, then the learnable skip and the down
    projection.  A length off the chunk is padded with identity steps
    (input gate -30, forget gate +30), not zeros; their outputs are cut."""
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
    c_state = torch.zeros(b, h, dh, dh, dtype=torch.float32, device=x.device)
    n_state = torch.zeros(b, h, dh, dtype=torch.float32, device=x.device)
    m_state = _f32((b, h), -1e30, x.device)
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
    return matmul(out, p["w_down"], dt)


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


def slstm_forward(p: Params, x: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """The sLSTM over x (B, L, d) -> (B, L, d) in x's dtype: a strict
    recurrence in f32 over ``inner = (x @ w_up)`` widened to f32, from
    c = n = h = 0 and m = -1e30.  The input's gate products are one f32
    GEMM over all steps (each step's row as the reference's per-step
    product); each step adds h @ r_gates, then b_gates."""
    dt = x.dtype
    inner = matmul(x, p["w_up"], dt).float()           # (B, L, di)
    b, l, di = inner.shape
    xw = inner @ p["w_gates"].float()                  # (B, L, 4·di)
    r_gates, b_gates = p["r_gates"].float(), p["b_gates"].float()
    c = torch.zeros(b, di, dtype=torch.float32, device=x.device)
    n, h = torch.zeros_like(c), torch.zeros_like(c)
    m = _f32((b, di), -1e30, x.device)
    hs = []
    for t in range(l):
        pre = torch.addmm(xw[:, t], h, r_gates) + b_gates
        z, i_pre, f_pre, o = pre.chunk(4, dim=-1)
        logf = F.logsigmoid(f_pre)
        m_new = torch.maximum(logf + m, i_pre)
        i_g = torch.exp(i_pre - m_new)
        f_g = torch.exp(logf + m - m_new)
        c = f_g * c + i_g * torch.tanh(z)
        n = f_g * n + i_g
        h = torch.sigmoid(o) * c / torch.clamp_min(n, 1e-6)
        m = m_new
        hs.append(h)
    return matmul(torch.stack(hs, dim=1).to(dt), p["w_down"], dt)


def xlstm_kind(cfg: ModelConfig, layer_idx: int) -> str:
    """'m' or 's': ``xlstm_pattern`` cycled over the layers."""
    pat = cfg.ssm.xlstm_pattern
    return pat[layer_idx % len(pat)]


def init_xlstm_layer(gen: torch.Generator, cfg: ModelConfig, idx: int,
                     device, dtype) -> Params:
    if xlstm_kind(cfg, idx) == "s":
        return init_slstm(gen, cfg, device, dtype)
    return init_mlstm(gen, cfg, device, dtype)


def xlstm_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  idx: int) -> torch.Tensor:
    if xlstm_kind(cfg, idx) == "s":
        return slstm_forward(p, x, cfg)
    return mlstm_forward(p, x, cfg)
