"""The Mamba-style selective SSM head of Hymba's blocks (reference:
``src/repro/models/ssm.py``, the Mamba half).

The full-sequence path only: input projection, the depthwise causal conv,
the selective parameters (B, C, Δ), and the scan itself through
``kernels.selective_scan`` (the hand-written kernel on a card, its plain
version on the CPU).  The reference's chunked ``associative_scan`` is not
ported: the fused kernel takes its place, as the reference's own note at
``mamba_forward`` asks.  The decode-state paths (``MambaState``,
``mamba_step``) and mLSTM/sLSTM (xLSTM) are not ported yet (ROADMAP.md
queue 1 item 9).

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
