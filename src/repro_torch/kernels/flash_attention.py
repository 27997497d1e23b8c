"""Bidirectional flash attention: wrapper, plain version and launch count.

``flash_attention(q, k, v, window=0, q_offset=0, kv_len=None)`` takes the
reference's
layout — q ``(B, Lq, H, dqk)``, k ``(B, Lk, G, dqk)`` and v ``(B, Lk, G,
dv)`` with G dividing H (query head h reads kv head ``h // (H // G)``) —
and returns ``(B, Lq, H, dv)`` in q's dtype: ``softmax(q kᵀ dqk^-½) v``,
optionally
restricted to the band ``|(q_offset + i) − j| < window``: query row i sits
at position ``q_offset + i`` (a cached window's rows start at their offset
in the canvas).  ``kv_len``, a one-element int32 tensor on q's device,
counts the live keys: keys at or past it are masked (the single-token
decode's first ``min(pos + 1, cap)`` slots of a fixed-capacity cache; the
kernel reads the count from device memory, so the host never syncs on
it).  The kernel has no backward with a count: on a card it then raises
under grad.  On a CUDA tensor it launches the hand-written kernel
in ``csrc/flash_attention.cu`` or raises; on a CPU tensor it runs
``attention_ref``, the plain version.  There is no fallback between them.
On a meta tensor (the dry-run's stand-ins) it returns an empty meta output
of the kernel's shape and dtype, and never runs the plain version: its
f32 score tensor is memory the card never allocates.
In bf16 the kernel runs on the tensor cores and copies 16-byte chunks, so
a bf16 tensor whose storage starts off a 16-byte boundary (a view at an
odd element offset; never a fresh allocation) is refused with a
``RuntimeError``; f32 runs the FMA kernel.  The kernels take dqk = dv at
every multiple of 16 in [32, 256] and MLA's pairs ``MIXED_HEAD_DIMS``
(value heads narrower than the query/key heads; V is never padded).

The card's result is differentiable: the kernel runs inside
``FlashAttention``, an ``autograd.Function`` whose backward is
``attention_backward``, explicit tensor ops that recompute the
probabilities in f32 (there is no backward kernel: the reference
differentiates its plain jnp attention, and no Pallas kernel has a
backward).  On the CPU autograd differentiates ``attention_ref``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

# wrapper calls that launched the kernel (never the plain path): eager
# launches, and launches recorded into a CUDA graph while it was captured;
# a graph's replays launch again without a call, so the graphs count
# executed launches (core/graphs.py:GraphSet.executed_launches)
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p] + [ctypes.c_int] * 9 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
# (dqk, dv) pairs with dv != dqk the kernels are built for
# (csrc/flash_attention.cu: FLASH_HEAD_DIM_PAIRS): DeepSeek-V2's MLA heads
# at full (128 + 64 | 128) and reduced (32 + 16 | 32) size
MIXED_HEAD_DIMS = ((192, 128), (48, 32))


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  window: int = 0, q_offset: int = 0,
                  kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version (mirrors the reference's ``kernels/ref.py``
    ``attention_ref``, plus GQA grouping and a value head dim of its own):
    f32 scores and softmax, f32 PV, cast to q's dtype.  Keys at or past
    ``kv_len`` score -1e30, as the reference's ``_sdpa`` masks them."""
    b, lq, h, d = q.shape
    lk, g = k.shape[1], k.shape[2]
    rep = h // g
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * (d ** -0.5)
    if window:
        qi = q_offset + torch.arange(lq, device=q.device)[:, None]
        ki = torch.arange(lk, device=q.device)[None, :]
        band = (qi - ki).abs() < window
        scores = torch.where(band, scores, torch.full_like(scores, -1e30))
    if kv_len is not None:
        live = torch.arange(lk, device=q.device) < kv_len.reshape(())
        scores = torch.where(live, scores, torch.full_like(scores, -1e30))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhe->bqhe", w, vf).to(q.dtype)


def _check(q, k, v, window, q_offset, kv_len=None):
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k and v must share a device")
    if q.dtype not in _DTYPE_CODE or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype}; need one of float32 or bfloat16")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4 or \
            v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, lq, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if (d, v.shape[3]) not in MIXED_HEAD_DIMS and (
            v.shape[3] != d or d % 16 or not 32 <= d <= 256):
        raise ValueError(f"flash_attention: head dims {d} (q, k) and "
                         f"{v.shape[3]} (v): need equal multiples of 16 in "
                         f"[32, 256] or a pair of {MIXED_HEAD_DIMS}")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} < 0")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    if kv_len is not None and (kv_len.dtype != torch.int32 or
                               kv_len.numel() != 1 or
                               kv_len.device != q.device):
        raise ValueError(f"flash_attention: kv_len must be one int32 on "
                         f"{q.device}, not {kv_len.dtype} "
                         f"{tuple(kv_len.shape)} on {kv_len.device}")


# query rows per recomputation in the backward: the reference's SDPA_CHUNK,
# so no (B, H, Lq, Lk) f32 tensor is held for more rows than that
BACKWARD_CHUNK = 1024


def attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       out: torch.Tensor, dout: torch.Tensor,
                       window: int = 0, q_offset: int = 0,
                       chunk: int = BACKWARD_CHUNK):
    """(dq, dk, dv) of ``out = softmax(q kᵀ dqk^-½) v`` (band and q offset
    as in the forward) from q, k, v, the forward's ``out`` and its
    cotangent ``dout``, in the inputs' dtypes; v, out and dout may be
    narrower than q and k (MLA).  P is recomputed in f32, ``chunk`` query
    rows at a time; then dV = Pᵀ dO, dP = dO Vᵀ,
    dS = P ⊙ (dP − rowsum(dO ⊙ O)) (the rowsum over v's dims),
    dQ = dS K dqk^-½ and dK = dSᵀ Q dqk^-½, with dK and dV summed over
    each kv head's H/G query heads."""
    b, lq, h, d = q.shape
    lk, g, e = k.shape[1], k.shape[2], v.shape[3]
    rep = h // g
    scale = d ** -0.5
    kf = k.float().repeat_interleave(rep, dim=2)          # (B, Lk, H, d)
    vf = v.float().repeat_interleave(rep, dim=2)          # (B, Lk, H, e)
    dq = torch.empty(b, lq, h, d, dtype=torch.float32, device=q.device)
    dk = torch.zeros(b, lk, h, d, dtype=torch.float32, device=q.device)
    dv = torch.zeros(b, lk, h, e, dtype=torch.float32, device=q.device)
    ki = torch.arange(lk, device=q.device)
    for lo in range(0, lq, chunk):
        hi = min(lo + chunk, lq)
        qc, doc = q[:, lo:hi].float(), dout[:, lo:hi].float()
        scores = torch.einsum("bqhd,bkhd->bhqk", qc, kf) * scale
        if window:
            qi = q_offset + lo + torch.arange(hi - lo, device=q.device)
            band = (qi[:, None] - ki[None, :]).abs() < window
            scores = torch.where(band, scores, torch.full_like(scores, -1e30))
        p = torch.softmax(scores, dim=-1)
        dv += torch.einsum("bhqk,bqhe->bkhe", p, doc)
        dp = torch.einsum("bqhe,bkhe->bhqk", doc, vf)
        rowsum = (doc * out[:, lo:hi].float()).sum(-1)     # (B, q, H)
        ds = p * (dp - rowsum.transpose(1, 2)[..., None])
        dq[:, lo:hi] = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
        dk += torch.einsum("bhqk,bqhd->bkhd", ds, qc) * scale
    if rep > 1:
        dk = dk.reshape(b, lk, g, rep, d).sum(3)
        dv = dv.reshape(b, lk, g, rep, e).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _launch(q, k, v, window, q_offset, kv_len=None):
    _check(q, k, v, window, q_offset, kv_len)
    b, lq, h, d = q.shape
    lk, g, dv = k.shape[1], k.shape[2], v.shape[3]
    out = q.new_empty(b, lq, h, dv)
    if q.device.type == "meta":
        return out
    fn = _build.function("flash_attention", "repro_flash_attention", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, lq, lk, h, g, d, dv, int(window), int(q_offset),
                 float(d ** -0.5), _DTYPE_CODE[q.dtype],
                 None if kv_len is None else kv_len.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA "
                           f"error {err}")
    global launches
    launches += 1
    return out


class FlashAttention(torch.autograd.Function):
    """The kernel as a differentiable op: forward launches it (on meta
    tensors, its stand-in) and saves q, k, v and its output; backward is
    ``attention_backward``."""

    @staticmethod
    def forward(ctx, q, k, v, window, q_offset):
        out = _launch(q, k, v, window, q_offset)
        ctx.save_for_backward(q, k, v, out)
        ctx.band = (window, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        return (*attention_backward(q, k, v, out, dout, *ctx.band),
                None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: int = 0, q_offset: int = 0,
                    kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    if q.device.type == "cpu":
        return attention_ref(q, k, v, window, q_offset, kv_len)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if kv_len is not None:
        _build.refuse_grad("flash_attention with kv_len", q, k, v)
        return _launch(q, k, v, window, q_offset, kv_len)
    return FlashAttention.apply(q, k, v, window, q_offset)
