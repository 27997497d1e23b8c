"""Fused selective scan (Mamba): wrapper, plain version and launch count.

``selective_scan(x, delta, b_sel, c_sel, a_log)`` takes the reference's
layout — x/delta ``(B, L, di)``, b_sel/c_sel ``(B, L, N)``, a_log
``(di, N)`` — and returns y ``(B, L, di)`` in x's dtype:

    A = -exp(a_log);  h_t = exp(Δ_t·A) ⊙ h_{t-1} + Δ_t·B_t·x_t;
    y_t = ⟨h_t, C_t⟩;  h_0 = 0, f32 accumulators.

x, delta, b_sel and c_sel may each be f32 or bf16.  On a CUDA tensor it
launches the hand-written kernel in ``csrc/selective_scan.cu`` or raises;
on a CPU tensor it runs ``selective_scan_ref``, the plain version.  There
is no fallback between them.  The kernel is a chunked two-pass scan: L
is cut into chunks of ``chunk_len(B, L, di)`` steps, pass 1 writes each
chunk's end state and decay product to an f32 workspace that this
wrapper allocates, and pass 2 folds those carries and walks each chunk
again for y.  It never writes the ``(B, L, di, N)`` decay/drive tensors.
Its two launches count as one in ``launches``.  The kernel has no
backward, so on a card it raises under grad (``_build.refuse_grad``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# wrapper calls that launched the kernel (never the plain path): eager
# launches, and launches recorded into a CUDA graph while it was captured;
# a graph's replays launch again without a call, so the graphs count
# executed launches (core/graphs.py:GraphSet.executed_launches)
launches = 0

_BF16 = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
MAX_STATE = 32        # N the kernel takes (a thread holds all N in registers)
MIN_CHUNK = 16        # fewest steps in a chunk of the two-pass scan
MAX_CHUNKS = 16       # most chunks one row's L is cut into
# threads a call aims at: three blocks of 128 on each of an H100's 132 SMs
TARGET_THREADS = 51_200


def chunk_len(batch: int, length: int, di: int) -> int:
    """Steps per chunk of the kernel's two-pass scan: enough chunks for
    ``TARGET_THREADS`` threads (one per row, channel and chunk), at most
    ``MAX_CHUNKS`` of them and each of at least ``MIN_CHUNK`` steps; the
    last chunk is shorter where ``length`` is ragged."""
    chunks = min(MAX_CHUNKS, -(-TARGET_THREADS // (batch * di)))
    return max(MIN_CHUNK, -(-length // chunks))


def selective_scan_ref(x: torch.Tensor, delta: torch.Tensor,
                       b_sel: torch.Tensor, c_sel: torch.Tensor,
                       a_log: torch.Tensor) -> torch.Tensor:
    """The plain version (mirrors the reference's ``kernels/ref.py``
    ``selective_scan_ref``): a sequential loop over t in f32."""
    a = -torch.exp(a_log.float())                        # (di, N)
    xf, df = x.float(), delta.float()
    bf, cf = b_sel.float(), c_sel.float()
    bsz, length, di = x.shape
    h = torch.zeros(bsz, di, a.shape[-1], dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(length):
        dt = df[:, t, :, None]
        h = torch.exp(dt * a) * h + dt * bf[:, t, None, :] \
            * xf[:, t, :, None]
        ys.append(torch.sum(h * cf[:, t, None, :], dim=-1))
    return torch.stack(ys, dim=1).to(x.dtype)


def _check(x, delta, b_sel, c_sel, a_log):
    ts = (x, delta, b_sel, c_sel, a_log)
    if any(t.device != x.device for t in ts):
        raise ValueError("selective_scan: all inputs must share a device")
    if any(t.dtype not in _BF16 for t in ts):
        raise ValueError(f"selective_scan: dtypes "
                         f"{[str(t.dtype) for t in ts]}; each must be "
                         f"float32 or bfloat16")
    if x.ndim != 3 or delta.shape != x.shape:
        raise ValueError(f"selective_scan: x {tuple(x.shape)} and delta "
                         f"{tuple(delta.shape)} must be one (B, L, di)")
    bsz, length, di = x.shape
    n = a_log.shape[-1] if a_log.ndim == 2 else -1
    if a_log.shape != (di, n) or b_sel.shape != (bsz, length, n) \
            or c_sel.shape != b_sel.shape:
        raise ValueError(f"selective_scan: b_sel {tuple(b_sel.shape)}, "
                         f"c_sel {tuple(c_sel.shape)}, a_log "
                         f"{tuple(a_log.shape)} do not fit x "
                         f"{tuple(x.shape)}")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"selective_scan: state size {n} not in "
                         f"[1, {MAX_STATE}]")
    if x.numel() == 0 or bsz >= 2 ** 16:
        raise ValueError(f"selective_scan: bad shape {tuple(x.shape)}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("selective_scan: inputs must be contiguous")


def selective_scan(x: torch.Tensor, delta: torch.Tensor, b_sel: torch.Tensor,
                   c_sel: torch.Tensor, a_log: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return selective_scan_ref(x, delta, b_sel, c_sel, a_log)
    if x.device.type != "cuda":
        raise ValueError(f"selective_scan: unsupported device {x.device}")
    _build.refuse_grad("selective_scan", x, delta, b_sel, c_sel, a_log)
    a_log = a_log.float()
    _check(x, delta, b_sel, c_sel, a_log)
    bsz, length, di = x.shape
    n = a_log.shape[1]
    chunk = chunk_len(bsz, length, di)
    nch = -(-length // chunk)
    y = torch.empty_like(x)
    # pass 1's carries: h_end then P, each (B, nch - 1, N, di)
    ws = torch.empty(2 * bsz * (nch - 1) * n * di, dtype=torch.float32,
                     device=x.device)
    fn = _build.function("selective_scan", "repro_selective_scan", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), delta.data_ptr(), b_sel.data_ptr(),
                 c_sel.data_ptr(), a_log.data_ptr(), ws.data_ptr(),
                 y.data_ptr(), bsz, length, di, n, chunk, _BF16[x.dtype],
                 _BF16[delta.dtype], _BF16[b_sel.dtype], _BF16[c_sel.dtype],
                 stream)
    if err != 0:
        raise RuntimeError(f"selective scan kernel launch failed: CUDA "
                           f"error {err}")
    global launches
    launches += 1
    return y
