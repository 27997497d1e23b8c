"""Shared layers: RMSNorm (and per head, for q/k) and LayerNorm,
standard, half and M-RoPE and sinusoidal positions, SwiGLU and the GELU MLP,
embedding and LM head (its own matrix, or tied to the embedding).

Functional style like the reference (``src/repro/models/layers.py``):
``init_*`` builds a dict of tensors, the matching apply function reads it.
Matrices are stored in the compute dtype (``cfg.dtype``); norm scales and
biases and the sinusoidal table stay float32.  Every projection casts its operands to the compute dtype and
accumulates in float32 (cuBLAS does for bf16; the CPU runs f32 configs),
rounding the result back to the compute dtype, as the reference's
``matmul`` does.

Under a tensor-parallel mesh (``parallel/ctx.py``) a layer runs on the
shards it is given (``parallel/sharding.py``'s rules): SwiGLU's gate/up
are column-parallel and its down row-parallel (``row_parallel``: the
partial products in f32, summed over ``model``, cast back; within one
rounding of the compute dtype of the unsharded product, bit-equal in
f32 up to the order of the sum); a vocab-sharded token table is looked
up for the ids of its slice and summed over ``model``; a vocab-sharded
head gives this rank's vocab slice of the logits.  A leaf is sharded
where it is narrower than the config says.  The input of a
column-parallel product or of a vocab-sharded head enters the
tensor-parallel region through ``ctx.enter_model``, so a backward sums
the ranks' shares of its gradient.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import torch_dtype
from repro_torch.parallel import ctx

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


def mm_f32(x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x2 (N, k) @ w (k, n) of compute-dtype operands to f32 with f32
    accumulation: cuBLAS's f32-output GEMM on the card and on meta
    (``HeadMatmul``), the operands widened on the CPU (the same exact
    products)."""
    if x2.dtype == torch.float32:
        return x2 @ w
    if x2.device.type in ("cuda", "meta"):
        return HeadMatmul.apply(x2, w)
    return x2.float() @ w.float()


def sharded(n: int, full: int, what: str) -> bool:
    """Whether a dim of ``n`` is this rank's shard of ``full`` under the
    active model axis (never off a mesh); a width that is neither raises."""
    tp = ctx.model_size()
    if tp == 1 or n == full:
        return False
    if n * tp != full:
        raise ValueError(f"{what}: {n} of {full} is no shard of a model "
                         f"axis of {tp}")
    return True


def row_parallel(x: torch.Tensor, w: torch.Tensor,
                 rows: int) -> torch.Tensor:
    """x @ w in x's dtype, for a weight of ``rows`` input rows that may be
    this rank's row shard: then the partial product in f32, summed over
    ``model`` and cast back."""
    dt = x.dtype
    w = w.to(dt)
    if not sharded(w.shape[0], rows, "a row-parallel weight"):
        return x @ w
    part = mm_f32(x.reshape(-1, x.shape[-1]), w)
    return ctx.sum_model(part).to(dt).reshape(*x.shape[:-1], w.shape[1])


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, device) -> Params:
    """RMSNorm's f32 scale; LayerNorm (``cfg.norm == "layernorm"``) adds
    an f32 bias."""
    p = {"scale": torch.ones(cfg.d_model, dtype=torch.float32,
                             device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(cfg.d_model, dtype=torch.float32,
                                device=device)
    return p


def apply_norm(p: Params, x: torch.Tensor, cfg: ModelConfig,
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm, or LayerNorm where the params have a bias (the
    reference's test): in f32, cast back to x's dtype.  LayerNorm takes
    the population variance and the reference's eps of 1e-6 (not
    torch's 1e-5)."""
    if "bias" in p:
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        return ((xf - mu) * torch.rsqrt(var + eps) * p["scale"]
                + p["bias"]).to(x.dtype)
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
    if cfg.rope not in ("standard", "half", "mrope", "sinusoidal", "none"):
        raise NotImplementedError(
            f"rope={cfg.rope!r}: the port knows 'standard', 'half' and "
            f"'mrope' RoPE, sinusoidal positions and 'none'")


def rotary_dim(cfg: ModelConfig, head_dim: int) -> int:
    """The dims of a head that RoPE turns: all of them ('standard', and
    'mrope', whose frequencies are split into sections driven by three
    position streams), the first half ('half': ChatGLM's 2d RoPE; the
    rest pass through), or none ('sinusoidal': the positions are added
    at the embedding; 'none': an attention-free model has no heads to
    turn)."""
    _check_rope(cfg)
    if cfg.rope in ("sinusoidal", "none"):
        return 0
    return head_dim // 2 if cfg.rope == "half" else head_dim


def model_rotary_dim(cfg: ModelConfig) -> int:
    """The rotary dim of the model's RoPE tables: ``rotary_dim`` of its
    heads, which for MLA are the rope part of q and k alone
    (``mla.qk_rope_head_dim``; the "nope" dims never turn)."""
    hd = cfg.mla.qk_rope_head_dim if cfg.attention == "mla" \
        else cfg.head_dim
    return rotary_dim(cfg, hd)


def mrope_sections_ok(cfg: ModelConfig, rot_dim: int) -> bool:
    """M-RoPE's (t, h, w) sections split the rot/2 frequencies exactly
    (the reference asserts it)."""
    return sum(cfg.mrope_sections) == rot_dim // 2


def rope_tables(positions: torch.Tensor, rot_dim: int, cfg: ModelConfig,
                dtype: torch.dtype) -> Optional[Rope]:
    """cos/sin of ``positions`` over ``rot_dim`` rotary dims
    (``rotary_dim``) in f32, cast to ``dtype``: built once per forward
    and shared by every layer's q and k.  ``positions`` is (B, L), or
    M-RoPE's (3, B, L) t/h/w streams (a (B, L) one drives all three):
    the sections ``cfg.mrope_sections`` lie end to end over the rot/2
    frequencies, and each frequency takes its angle from its section's
    stream.
    None under sinusoidal positions or ``rope="none"``, which turn
    nothing (``rotate`` passes x through)."""
    _check_rope(cfg)
    if cfg.rope in ("sinusoidal", "none"):
        return None
    inv = rope_frequencies(rot_dim, cfg.rope_theta, positions.device)
    if cfg.rope == "mrope":
        if not mrope_sections_ok(cfg, rot_dim):
            raise ValueError(
                f"mrope_sections {cfg.mrope_sections} must sum to rot/2 = "
                f"{rot_dim // 2}")
        pos3 = positions if positions.dim() == 3 else \
            positions[None].expand(3, *positions.shape)
        # each stream's angles over its own section of the frequencies
        # (slices of the same products: no index tensor to copy in)
        ends = np.cumsum((0,) + tuple(cfg.mrope_sections))
        ang = torch.cat([pos3[s].float()[..., None] * inv[ends[s]:ends[s + 1]]
                         for s in range(3)], dim=-1)           # (B, L, rot/2)
    else:
        ang = positions.float()[..., None] * inv                # (B, L, rot/2)
    return Rope(torch.cos(ang)[:, :, None, :].to(dtype),
                torch.sin(ang)[:, :, None, :].to(dtype))


def rotate(x: torch.Tensor, rope: Optional[Rope]) -> torch.Tensor:
    """x (B, L, H, hd) rotated by the tables, split halves (not
    interleaved pairs) of its first rot = 2 × the tables' width dims; the
    dims past rot pass through ('half' RoPE).  No tables (sinusoidal
    positions, ``rope="none"``): x as it is."""
    if rope is None:
        return x
    hd, rot = x.shape[-1], 2 * rope.cos.shape[-1]
    xr = x if rot == hd else x[..., :rot]
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    turned = torch.cat([x1 * rope.cos - x2 * rope.sin,
                        x2 * rope.cos + x1 * rope.sin], dim=-1)
    return turned if rot == hd else torch.cat([turned, x[..., rot:]], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig):
    """x (B, L, H, hd), positions (B, L) (or M-RoPE's (3, B, L)): tables
    then rotation, for a caller that has only positions (the model builds
    its tables once per forward, ``rope_tables``)."""
    return rotate(x, rope_tables(positions, rotary_dim(cfg, x.shape[-1]),
                                 cfg, x.dtype))


def sinusoidal_embedding(length: int, dim: int) -> torch.Tensor:
    """The absolute position table (length, dim): sin ‖ cos of pos /
    10000^(2i/dim), computed in float64 numpy and then cast to f32, as
    the reference computes it."""
    pos = np.arange(length)[:, None]
    i = np.arange(dim // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / dim)
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(emb.astype(np.float32))


# --------------------------------------------------------------------------
# MLP (SwiGLU / GELU)
# --------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg: ModelConfig, device, dtype,
             d_ff: Optional[int] = None) -> Params:
    """A SwiGLU (``act="silu"``: gate, up, down) or a GELU MLP (fc1, fc2;
    no biases, as the reference's) of hidden width ``d_ff`` (default
    ``cfg.d_ff``)."""
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act == "silu":
        return {"gate": dense_init(gen, (d, ff), device, dtype),
                "up": dense_init(gen, (d, ff), device, dtype),
                "down": dense_init(gen, (ff, d), device, dtype)}
    return {"fc1": dense_init(gen, (d, ff), device, dtype),
            "fc2": dense_init(gen, (ff, d), device, dtype)}


def apply_mlp(p: Params, x: torch.Tensor, cfg: ModelConfig,
              d_ff: Optional[int] = None) -> torch.Tensor:
    """SwiGLU, or GELU in the tanh approximation (``jax.nn.gelu``'s
    default), in the compute dtype.  ``d_ff``: the full hidden width
    (default ``cfg.d_ff``), against which a SwiGLU's down is told to be a
    row shard (then summed over ``model``)."""
    dt = x.dtype
    if "gate" in p:
        if sharded(p["gate"].shape[1], d_ff or cfg.d_ff, "mlp/gate"):
            x = ctx.enter_model(x)
        h = torch.nn.functional.silu(matmul(x, p["gate"], dt)) \
            * matmul(x, p["up"], dt)
        return row_parallel(h, p["down"], d_ff or cfg.d_ff)
    h = torch.nn.functional.gelu(matmul(x, p["fc1"], dt),
                                 approximate="tanh")
    return matmul(h, p["fc2"], dt)


# --------------------------------------------------------------------------
# embeddings / head
# --------------------------------------------------------------------------

def init_embed(gen: torch.Generator, cfg: ModelConfig, device,
               dtype) -> Params:
    """The token table; the head (d, V) unless ``tie_embeddings`` (then
    the head is ``tok``ᵀ); the f32 sinusoidal table ``pos``
    (``max_seq_len`` rows) under ``rope="sinusoidal"``."""
    p = {"tok": dense_init(gen, (cfg.vocab_size, cfg.d_model), device,
                           dtype, scale=0.02)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), device,
                               dtype)
    if cfg.rope == "sinusoidal":
        p["pos"] = sinusoidal_embedding(cfg.max_seq_len,
                                        cfg.d_model).to(device)
    return p


def embed_tokens(p: Params, tokens: torch.Tensor, cfg: ModelConfig,
                 offset: int = 0,
                 positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens (B, L) -> (B, L, d) in the compute dtype; with a sinusoidal
    table, plus its rows ``offset .. offset + L`` (the tokens' positions:
    a cached window's start its offset in the canvas), or the rows
    ``positions`` (B, L) (M-RoPE's (3, B, L): its t stream) where given,
    gathered on the device (the decode state's steps).  A vocab-sharded
    table looks up the ids of its slice (zeros elsewhere), summed over
    ``model``."""
    tok = p["tok"]
    if sharded(tok.shape[0], cfg.vocab_size, "embed/tok"):
        local = tokens - ctx.model_rank() * tok.shape[0]
        inside = (local >= 0) & (local < tok.shape[0])
        x = tok[local.clamp(0, tok.shape[0] - 1)].to(compute_dtype(cfg))
        x = ctx.sum_model(torch.where(inside[..., None], x, 0))
    else:
        x = tok[tokens].to(compute_dtype(cfg))
    if "pos" in p and positions is not None:
        rows = positions if positions.dim() == 2 else positions[0]
        return x + p["pos"][rows.long()].to(x.dtype)
    if "pos" in p:
        length = tokens.shape[1]
        if offset + length > p["pos"].shape[0]:
            raise ValueError(
                f"positions {offset}..{offset + length} run past the "
                f"sinusoidal table's {p['pos'].shape[0]} rows "
                f"(max_seq_len)")
        x = x + p["pos"][offset:offset + length].to(x.dtype)
    return x


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
    computes the same exact products (on meta tensors, the dry-run's
    stand-ins, the card's way).  A tied head is the token table
    transposed (a view: cuBLAS reads it transposed).  A vocab-sharded
    head gives this rank's vocab slice (``core.confidence.score_logits``
    scores it through the partials)."""
    dt = compute_dtype(cfg)
    w = p["tok"].to(dt).t() if cfg.tie_embeddings else p["head"].to(dt)
    if sharded(w.shape[1], cfg.vocab_size, "the LM head"):
        x = ctx.enter_model(x)
    x2 = x.to(dt).reshape(-1, x.shape[-1])
    return mm_f32(x2, w).reshape(*x.shape[:-1], w.shape[1])
