"""Fused decode-confidence kernel: wrapper, plain version and launch count.

``confidence_fused(logits)`` maps logits ``(..., V)`` (f32 or bf16) to
``(argmax int32, max_prob, margin, neg_entropy)``, each ``(...,)`` f32 —
the function of the reference's Pallas ``confidence_fused``.  On a CUDA
tensor it launches the hand-written kernel in ``csrc/confidence.cu`` once
(one CTA per row, one pass over the vocab: the row's head up to its first
16-byte boundary, then 16-byte vector loads, four in flight per thread,
then the tail) or raises; on a CPU tensor it runs ``confidence_ref``, the
plain version.  There is no fallback from one to the other.

``confidence_partials(logits, vocab_offset)`` is the kernel's other
epilogue, for a vocab split across ranks: per row the accumulators a
shard hands on (``Partials``: max m, s = Σ exp(l − m), u = Σ l·exp(l − m),
the second max m2 (= m when the max repeats), the first argmax i1 plus
the shard's first vocab id), one launch, counted in
``partials_launches``; ``confidence_partials_ref`` is its plain version.
``core/confidence.py:merge_partials`` turns the gathered shards' partials
into the four scores.  On a meta
tensor (the dry-run's stand-ins) it returns empty meta outputs of the
kernel's shapes and dtypes.  The kernel has no backward, so on a card it
raises under grad (``_build.refuse_grad``).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build

# wrapper calls that launched the kernel (never the plain path): eager
# launches, and launches recorded into a CUDA graph while it was captured;
# a graph's replays launch again without a call, so the graphs count
# executed launches (core/graphs.py:GraphSet.executed_launches)
launches = 0

# the same for confidence_partials
partials_launches = 0

# the kernel's floor for a running max: a row (or shard) of -inf logits
# keeps m = m2 = -3.4e38 and s = u = 0
NEG = -3.4e38

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p]
_PARTIALS_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_void_p]


def confidence_ref(logits: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The plain version (mirrors the reference's ``kernels/ref.py``):
    full softmax, then the top-2 of the probabilities with ties going to
    the lower index, as ``lax.top_k`` does."""
    lf = logits.float()
    logp = torch.log_softmax(lf, dim=-1)
    p = torch.exp(logp)
    i1 = torch.argmax(p, dim=-1)                 # first maximum
    p1 = torch.gather(p, -1, i1[..., None])[..., 0]
    p2 = torch.max(p.scatter(-1, i1[..., None], float("-inf")), dim=-1).values
    neg_ent = torch.sum(p * logp, dim=-1)
    return i1.to(torch.int32), p1, p1 - p2, neg_ent


class Partials(NamedTuple):
    """A vocab shard's accumulators per row, each (...,): f32 but ``i1``
    (int32, a global vocab id)."""
    m: torch.Tensor
    s: torch.Tensor
    u: torch.Tensor
    m2: torch.Tensor
    i1: torch.Tensor


def confidence_partials_ref(logits: torch.Tensor,
                            vocab_offset: int = 0) -> Partials:
    """The plain version of the partials epilogue: the kernel's
    accumulators in torch ops (m and m2 floored at ``NEG`` as the
    kernel's; a -inf logit adds exactly 0 to s and u)."""
    lf = logits.float()
    m = lf.max(dim=-1).values.clamp(min=NEG)
    hit = lf >= m[..., None]
    dup = hit.sum(-1) > 1
    m2 = torch.where(hit, float("-inf"), lf).max(dim=-1).values.clamp(min=NEG)
    m2 = torch.where(dup, m, m2)
    e = torch.exp(lf - m[..., None])
    s = e.sum(-1)
    u = (torch.where(e > 0, lf, 0.0) * e).sum(-1)
    i1 = torch.argmax(lf, dim=-1).to(torch.int32) + vocab_offset
    return Partials(m, s, u, m2, i1)


def _check(name: str, logits: torch.Tensor) -> Tuple[int, int]:
    """The kernel's input checks; (rows, vocab)."""
    if logits.device.type not in ("cuda", "meta"):
        raise ValueError(f"{name}: unsupported device {logits.device}")
    _build.refuse_grad(name, logits)
    if logits.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: dtype {logits.dtype} not supported "
                         f"(float32 or bfloat16)")
    if not logits.is_contiguous():
        raise ValueError(f"{name}: logits must be contiguous")
    if logits.ndim < 1 or logits.shape[-1] < 1 or logits.numel() == 0:
        raise ValueError(f"{name}: bad shape {tuple(logits.shape)}")
    vocab = logits.shape[-1]
    rows = logits.numel() // vocab
    if rows >= 2 ** 31 or vocab >= 2 ** 31:
        raise ValueError(f"{name}: too many rows or vocab entries")
    return rows, vocab


def confidence_partials(logits: torch.Tensor,
                        vocab_offset: int = 0) -> Partials:
    """A vocab shard's ``Partials`` (logits (..., V/tp), this shard's first
    vocab id ``vocab_offset``): the kernel's partials epilogue on a CUDA
    tensor (one launch), the plain version on a CPU tensor."""
    if logits.device.type == "cpu":
        return confidence_partials_ref(logits, vocab_offset)
    rows, vocab = _check("confidence_partials", logits)
    if not 0 <= vocab_offset < 2 ** 31 - vocab:
        raise ValueError(f"confidence_partials: vocab_offset {vocab_offset}")
    lead = logits.shape[:-1]
    i1 = torch.empty(lead, dtype=torch.int32, device=logits.device)
    m, s, u, m2 = (torch.empty(lead, dtype=torch.float32,
                               device=logits.device) for _ in range(4))
    if logits.device.type == "meta":
        return Partials(m, s, u, m2, i1)
    fn = _build.function("confidence", "repro_confidence_partials",
                         _PARTIALS_ARGTYPES)
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(logits.data_ptr(), rows, vocab, _DTYPE_CODE[logits.dtype],
                 vocab_offset, i1.data_ptr(), m.data_ptr(), s.data_ptr(),
                 u.data_ptr(), m2.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"confidence partials kernel launch failed: CUDA "
                           f"error {err}")
    global partials_launches
    partials_launches += 1
    return Partials(m, s, u, m2, i1)


def confidence_fused(logits: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    if logits.device.type == "cpu":
        return confidence_ref(logits)
    rows, vocab = _check("confidence_fused", logits)
    lead = logits.shape[:-1]
    argmax = torch.empty(lead, dtype=torch.int32, device=logits.device)
    maxp, margin, negent = (torch.empty(lead, dtype=torch.float32,
                                        device=logits.device)
                            for _ in range(3))
    if logits.device.type == "meta":
        return argmax, maxp, margin, negent
    fn = _build.function("confidence", "repro_confidence", _ARGTYPES)
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(logits.data_ptr(), rows, vocab, _DTYPE_CODE[logits.dtype],
                 argmax.data_ptr(), maxp.data_ptr(), margin.data_ptr(),
                 negent.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"confidence kernel launch failed: CUDA error "
                           f"{err}")
    global launches
    launches += 1
    return argmax, maxp, margin, negent
