"""Fused decode-confidence kernel: wrapper, plain version and launch count.

``confidence_fused(logits)`` maps logits ``(..., V)`` (f32 or bf16) to
``(argmax int32, max_prob, margin, neg_entropy)``, each ``(...,)`` f32 —
the function of the reference's Pallas ``confidence_fused``.  On a CUDA
tensor it launches the hand-written kernel in ``csrc/confidence.cu`` once
(one CTA per row, one pass over the vocab: the row's head up to its first
16-byte boundary, then 16-byte vector loads, four in flight per thread,
then the tail) or raises; on a CPU tensor it runs ``confidence_ref``, the
plain version.  There is no fallback from one to the other.  On a meta
tensor (the dry-run's stand-ins) it returns empty meta outputs of the
kernel's shapes and dtypes.  The kernel has no backward, so on a card it
raises under grad (``_build.refuse_grad``).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

# wrapper calls that launched the kernel (never the plain path): eager
# launches, and launches recorded into a CUDA graph while it was captured;
# a graph's replays launch again without a call, so the graphs count
# executed launches (core/graphs.py:GraphSet.executed_launches)
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
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


def confidence_fused(logits: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    if logits.device.type == "cpu":
        return confidence_ref(logits)
    if logits.device.type not in ("cuda", "meta"):
        raise ValueError(f"confidence_fused: unsupported device "
                         f"{logits.device}")
    _build.refuse_grad("confidence_fused", logits)
    if logits.dtype not in _DTYPE_CODE:
        raise ValueError(f"confidence_fused: dtype {logits.dtype} not "
                         f"supported (float32 or bfloat16)")
    if not logits.is_contiguous():
        raise ValueError("confidence_fused: logits must be contiguous")
    if logits.ndim < 1 or logits.shape[-1] < 1 or logits.numel() == 0:
        raise ValueError(f"confidence_fused: bad shape {tuple(logits.shape)}")
    lead = logits.shape[:-1]
    vocab = logits.shape[-1]
    rows = logits.numel() // vocab
    if rows >= 2 ** 31 or vocab >= 2 ** 31:
        raise ValueError("confidence_fused: too many rows or vocab entries")
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
