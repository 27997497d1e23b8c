"""Shared layers: RMSNorm (and per head, for q/k), standard and half
RoPE, SwiGLU, embedding and LM head.

Functional style like the reference (``src/repro/models/layers.py``):
``init_*`` builds a dict of tensors, the matching apply function reads it.
Matrices are stored in the compute dtype (``cfg.dtype``); norm scales stay
float32.  Every projection casts its operands to the compute dtype and
accumulates in float32 (cuBLAS does for bf16; the CPU runs f32 configs),
rounding the result back to the compute dtype, as the reference's
``matmul`` does.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import torch_dtype

Params = dict


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.dtype)


# --------------------------------------------------------------------------
# initializers
# --------------------------------------------------------------------------

_LO, _HI = 0.5 * math.erfc(3 / math.sqrt(2)), 0.5 * math.erfc(-3 / math.sqrt(2))


def dense_init(gen: torch.Generator, shape, device, dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated normal on [-3σ, 3σ], σ = ``scale`` or 1/√fan_in — the
    reference's initializer in distribution (the two generators draw
    different numbers).  Drawn in f32 by inverse CDF, then cast."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    u = u.mul_(_HI - _LO).add_(_LO).mul_(2).sub_(1)
    z = u.erfinv_().mul_(math.sqrt(2) * std).clamp_(-3 * std, 3 * std)
    return z.to(dtype)


def matmul(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype):
    return torch.matmul(x.to(dtype), w.to(dtype))


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, device) -> Params:
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(
            f"norm={cfg.norm!r}: the port has RMSNorm only so far "
            f"(LayerNorm comes with the other architectures, ROADMAP.md)")
    return {"scale": torch.ones(cfg.d_model, dtype=torch.float32,
                                device=device)}


def apply_norm(p: Params, x: torch.Tensor, cfg: ModelConfig,
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32, cast back to x's dtype."""
    if "bias" in p:
        raise NotImplementedError("LayerNorm is not ported yet (ROADMAP.md)")
    return rms_norm_headwise(x, p["scale"], eps)


def rms_norm_headwise(x: torch.Tensor, scale: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim in f32, cast back to x's dtype: per head
    for Qwen3's q/k norm (``qk_norm``: x (..., head_dim), scale
    (head_dim,) f32), and ``apply_norm``'s over d_model."""
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale).to(x.dtype)


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------

def rope_frequencies(dim: int, theta: float, device) -> torch.Tensor:
    # a Python-scalar base: no host-to-device copy (which would sync)
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / torch.pow(float(theta), exps)


class Rope(NamedTuple):
    """RoPE tables for a run of positions, each (B or 1, L, 1, rot/2):
    rot is the rotary dim, ``rotary_dim(cfg, hd)``."""
    cos: torch.Tensor
    sin: torch.Tensor


def _check_rope(cfg: ModelConfig) -> None:
    if cfg.rope not in ("standard", "half"):
        raise NotImplementedError(
            f"rope={cfg.rope!r}: only 'standard' and 'half' RoPE are "
            f"ported; the other modes come with the other architectures "
            f"(ROADMAP.md queue 1 item 9)")


def rotary_dim(cfg: ModelConfig, head_dim: int) -> int:
    """The dims of a head that RoPE turns: all of them ('standard'), or
    the first half ('half': ChatGLM's 2d RoPE; the rest pass through)."""
    _check_rope(cfg)
    return head_dim // 2 if cfg.rope == "half" else head_dim


def model_rotary_dim(cfg: ModelConfig) -> int:
    """The rotary dim of the model's RoPE tables: ``rotary_dim`` of its
    heads, which for MLA are the rope part of q and k alone
    (``mla.qk_rope_head_dim``; the "nope" dims never turn)."""
    hd = cfg.mla.qk_rope_head_dim if cfg.attention == "mla" \
        else cfg.head_dim
    return rotary_dim(cfg, hd)


def rope_tables(positions: torch.Tensor, rot_dim: int, cfg: ModelConfig,
                dtype: torch.dtype) -> Rope:
    """cos/sin of ``positions`` (B, L) over ``rot_dim`` rotary dims
    (``rotary_dim``) in f32, cast to ``dtype``: built once per forward
    and shared by every layer's q and k."""
    _check_rope(cfg)
    inv = rope_frequencies(rot_dim, cfg.rope_theta, positions.device)
    ang = positions.float()[..., None] * inv                   # (B, L, rot/2)
    return Rope(torch.cos(ang)[:, :, None, :].to(dtype),
                torch.sin(ang)[:, :, None, :].to(dtype))


def rotate(x: torch.Tensor, rope: Rope) -> torch.Tensor:
    """x (B, L, H, hd) rotated by the tables, split halves (not
    interleaved pairs) of its first rot = 2 × the tables' width dims; the
    dims past rot pass through ('half' RoPE)."""
    hd, rot = x.shape[-1], 2 * rope.cos.shape[-1]
    xr = x if rot == hd else x[..., :rot]
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    turned = torch.cat([x1 * rope.cos - x2 * rope.sin,
                        x2 * rope.cos + x1 * rope.sin], dim=-1)
    return turned if rot == hd else torch.cat([turned, x[..., rot:]], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig):
    """x (B, L, H, hd), positions (B, L): tables then rotation, for a
    caller that has only positions (the model builds its tables once per
    forward, ``rope_tables``)."""
    return rotate(x, rope_tables(positions, rotary_dim(cfg, x.shape[-1]),
                                 cfg, x.dtype))


# --------------------------------------------------------------------------
# MLP (SwiGLU)
# --------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg: ModelConfig, device, dtype,
             d_ff: Optional[int] = None) -> Params:
    """A SwiGLU of hidden width ``d_ff`` (default ``cfg.d_ff``)."""
    if cfg.act != "silu":
        raise NotImplementedError(
            f"act={cfg.act!r}: only SwiGLU is ported (ROADMAP.md)")
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    return {"gate": dense_init(gen, (d, ff), device, dtype),
            "up": dense_init(gen, (d, ff), device, dtype),
            "down": dense_init(gen, (ff, d), device, dtype)}


def apply_mlp(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = x.dtype
    h = torch.nn.functional.silu(matmul(x, p["gate"], dt)) \
        * matmul(x, p["up"], dt)
    return matmul(h, p["down"], dt)


# --------------------------------------------------------------------------
# embeddings / head
# --------------------------------------------------------------------------

def init_embed(gen: torch.Generator, cfg: ModelConfig, device,
               dtype) -> Params:
    if cfg.tie_embeddings or cfg.rope == "sinusoidal":
        raise NotImplementedError(
            "tied or sinusoidal embeddings are not ported yet (ROADMAP.md)")
    return {"tok": dense_init(gen, (cfg.vocab_size, cfg.d_model), device,
                              dtype, scale=0.02),
            "head": dense_init(gen, (cfg.d_model, cfg.vocab_size), device,
                               dtype)}


def embed_tokens(p: Params, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    return p["tok"][tokens].to(compute_dtype(cfg))


class HeadMatmul(torch.autograd.Function):
    """``x2 @ w`` of bf16 operands to f32 logits on the card: cuBLAS's
    f32-output bf16 GEMM (``torch.mm(..., out_dtype=torch.float32)``),
    which has no derivative in the card's torch, with a backward of two
    GEMMs in the operands' dtype (f32 accumulation): the cotangent is cast
    to it, and so are the gradients."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, dlogits):
        x2, w = ctx.saved_tensors
        g = dlogits.to(x2.dtype)
        return g @ w.t(), x2.t() @ g


def lm_head(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """f32 logits from compute-dtype operands with f32 accumulation (the
    reference's ``preferred_element_type=float32``).  A bf16 matmul would
    round the logits to bf16 and move argmaxes and margins, so on the card
    the product goes through cuBLAS's f32-output bf16 GEMM
    (``HeadMatmul``); on the CPU the operands are widened to f32, which
    computes the same exact products."""
    dt = compute_dtype(cfg)
    w = p["head"].to(dt)
    x2 = x.to(dt).reshape(-1, x.shape[-1])
    if dt == torch.float32:
        logits = x2 @ w
    elif x2.device.type == "cuda":
        logits = HeadMatmul.apply(x2, w)
    else:
        logits = x2.float() @ w.float()
    return logits.reshape(*x.shape[:-1], w.shape[1])
