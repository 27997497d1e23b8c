"""Fused selective scan (Mamba): wrapper, plain version and launch count.

``selective_scan(x, delta, b_sel, c_sel, a_log, h0=None,
return_state=False)`` takes the reference's layout — x/delta ``(B, L,
di)``, b_sel/c_sel ``(B, L, N)``, a_log ``(di, N)`` — and returns y ``(B,
L, di)`` in x's dtype:

    A = -exp(a_log);  h_t = exp(Δ_t·A) ⊙ h_{t-1} + Δ_t·B_t·x_t;
    y_t = ⟨h_t, C_t⟩;  h_0 = 0, f32 accumulators.

``h0`` ``(B, di, N)`` f32 replaces the zero initial state (a frozen
prefix's end state), and ``return_state=True`` returns ``(y, h_L)`` with
the exact end state ``h_L`` ``(B, di, N)`` f32 (the reference's
``selective_last_state``).  The kernel has no backward for either, so on
a card a call with one of them raises under grad (no training path
carries state).

x, delta, b_sel and c_sel may each be f32 or bf16.  On a CUDA tensor it
launches the hand-written kernel in ``csrc/selective_scan.cu`` or raises;
on a CPU tensor it runs ``selective_scan_ref``, the plain version.  There
is no fallback between them.  On a meta tensor (the dry-run's stand-ins)
it returns empty meta outputs of the kernel's shapes and dtypes, after
allocating the workspace as the card does.  The kernel is a chunked
two-pass scan: L is cut into chunks of ``chunk_len(B, L, di)`` steps,
pass 1 writes each
chunk's end state and decay product to an f32 workspace that this
wrapper allocates, and pass 2 folds those carries and walks each chunk
again for y.  It never writes the ``(B, L, di, N)`` decay/drive tensors.
Its two launches count as one in ``launches``.

The card's result is differentiable: the kernel runs inside
``SelectiveScan``, an ``autograd.Function`` whose backward is
``selective_scan_backward``, explicit f32 tensor ops over a recomputed
state (there is no backward kernel: the reference differentiates its
chunked ``associative_scan``, and no Pallas kernel has a backward),
captured into a CUDA graph per shape at its first call and replayed
after (``graphed_backward``: launched one by one, its hundreds of small
ops a call leave the card waiting on the host).  On the CPU autograd
differentiates ``selective_scan_ref``.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from repro_torch.kernels import _build

# wrapper calls that launched the kernel (never the plain path): eager
# launches, and launches recorded into a CUDA graph while it was captured;
# a graph's replays launch again without a call, so the graphs count
# executed launches (core/graphs.py:GraphSet.executed_launches)
launches = 0

_BF16 = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
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
                       a_log: torch.Tensor,
                       h0: Optional[torch.Tensor] = None,
                       return_state: bool = False):
    """The plain version (mirrors the reference's ``kernels/ref.py``
    ``selective_scan_ref``): a sequential loop over t in f32, from ``h0``
    (zeros without one); ``return_state`` adds the end state."""
    a = -torch.exp(a_log.float())                        # (di, N)
    xf, df = x.float(), delta.float()
    bf, cf = b_sel.float(), c_sel.float()
    bsz, length, di = x.shape
    h = h0.float() if h0 is not None else torch.zeros(
        bsz, di, a.shape[-1], dtype=torch.float32, device=x.device)
    ys = []
    for t in range(length):
        dt = df[:, t, :, None]
        h = torch.exp(dt * a) * h + dt * bf[:, t, None, :] \
            * xf[:, t, :, None]
        ys.append(torch.sum(h * cf[:, t, None, :], dim=-1))
    y = torch.stack(ys, dim=1).to(x.dtype)
    return (y, h) if return_state else y


# steps of one chunk of the backward: its (B, chunk, di, N) f32 decays,
# drives, states and cotangents are the only ones alive at a time (one
# such tensor is 105 MB at Hymba-1.5B's training shape B=2, di=3200)
BACKWARD_CHUNK = 128
# steps a chunk's scan walks one at a time, its sub-chunks side by side
BACKWARD_ROUND = 16


def _linear_scan(a: torch.Tensor, u: torch.Tensor, h0: torch.Tensor,
                 reverse: bool = False) -> torch.Tensor:
    """h_t = a_t ⊙ h_{t-1} + u_t along dim 1 of (B, T, di, N) f32, from
    ``h0`` (B, di, N) before the first step; with ``reverse``, h_t = a_t ⊙
    h_{t+1} + u_t from ``h0`` after the last step.  Returns every h_t.

    T is cut into sub-chunks of ``BACKWARD_ROUND`` steps (padded with
    a = 1, u = 0, which carry the state through), walked one step at a
    time side by side from zero; then the states entering the sub-chunks
    are folded in order and added back, scaled by each step's running
    decay product within its sub-chunk (a cumulative product)."""
    bsz, t, di, n = a.shape
    r = min(BACKWARD_ROUND, t)
    s = -(-t // r)
    if s * r != t:
        a = torch.cat([a, a.new_ones(bsz, s * r - t, di, n)], 1)
        u = torch.cat([u, u.new_zeros(bsz, s * r - t, di, n)], 1)
    a = a.reshape(bsz, s, r, di, n)
    u = u.reshape(bsz, s, r, di, n)
    prod = torch.cumprod(a.flip(2), 2).flip(2) if reverse else \
        torch.cumprod(a, 2)
    h = torch.empty_like(u)
    steps = range(r - 1, -1, -1) if reverse else range(r)
    h[:, :, steps[0]] = u[:, :, steps[0]]
    for prev, i in zip(steps, steps[1:]):
        torch.addcmul(u[:, :, i], a[:, :, i], h[:, :, prev],
                      out=h[:, :, i])
    end = steps[-1]
    enter = torch.empty(bsz, s, di, n, dtype=h.dtype, device=h.device)
    state = h0
    for j in (range(s - 1, -1, -1) if reverse else range(s)):
        enter[:, j] = state
        state = torch.addcmul(h[:, j, end], prod[:, j, end], state)
    h = torch.addcmul(h, prod, enter[:, :, None])
    return h.reshape(bsz, s * r, di, n)[:, :t]


def selective_scan_backward(x: torch.Tensor, delta: torch.Tensor,
                            b_sel: torch.Tensor, c_sel: torch.Tensor,
                            a_log: torch.Tensor, dy: torch.Tensor,
                            chunk: int = BACKWARD_CHUNK):
    """(dx, dΔ, dB, dC, d a_log) of ``y = selective_scan(x, Δ, B, C,
    a_log)`` from its inputs and the cotangent ``dy``, each in its input's
    dtype, by f32 tensor ops ``chunk`` steps at a time.

    With a_t = exp(Δ_t A) and u_t = Δ_t B_t x_t, h_t = a_t h_{t-1} + u_t:
    a first pass keeps only the state entering each chunk; then, last
    chunk first, the chunk's states are recomputed and the reverse
    recurrence g_t = C_t dy_t + a_{t+1} ⊙ g_{t+1} (g = ∂/∂h_t) runs with
    the carry g and a of the chunk after.  Then dx = Δ Σ_n g B,
    dΔ = x Σ_n g B + Σ_n w A, dB = Σ_c g Δ x, dC = Σ_c h dy and
    dA = Σ_{b,t} w Δ, with w = g ⊙ h_{t-1} ⊙ a_t; d a_log = dA ⊙ A, since
    A = −exp(a_log)."""
    am = -torch.exp(a_log.float())                        # A (di, N)
    xf, df, gy = x.float(), delta.float(), dy.float()
    bf, cf = b_sel.float(), c_sel.float()
    dfx = df * xf
    bsz, length, di = x.shape
    n = am.shape[1]

    def terms(lo, hi):
        dec = torch.exp(df[:, lo:hi, :, None] * am)       # a_t (B, T, di, N)
        drv = dfx[:, lo:hi, :, None] * bf[:, lo:hi, None, :]
        return dec, drv

    los = list(range(0, length, chunk))
    enter = [torch.zeros(bsz, di, n, dtype=torch.float32, device=x.device)]
    # the carried states are copies: a view would keep its chunk alive
    for lo in los[:-1]:
        hs = _linear_scan(*terms(lo, lo + chunk), enter[-1])
        enter.append(hs[:, -1].clone())
    dx, ddelta = torch.empty_like(xf), torch.empty_like(df)
    db, dc = torch.empty_like(bf), torch.empty_like(cf)
    da = torch.zeros_like(am)
    g = torch.zeros_like(enter[0])        # g of the chunk after's first step
    a_next = torch.zeros_like(g)          # and its decay
    for lo, h0 in zip(reversed(los), reversed(enter)):
        hi = min(lo + chunk, length)
        dec, drv = terms(lo, hi)
        hs = _linear_scan(dec, drv, h0)
        del drv
        v = gy[:, lo:hi, :, None] * cf[:, lo:hi, None, :]
        gs = _linear_scan(torch.cat([dec[:, 1:], a_next[:, None]], 1), v, g,
                          reverse=True)
        del v
        dc[:, lo:hi] = torch.einsum("btcn,btc->btn", hs, gy[:, lo:hi])
        w = torch.cat([h0[:, None], hs[:, :-1]], 1).mul_(dec).mul_(gs)
        del hs
        gb = torch.einsum("btcn,btn->btc", gs, bf[:, lo:hi])
        dx[:, lo:hi] = gb * df[:, lo:hi]
        ddelta[:, lo:hi] = gb * xf[:, lo:hi] + torch.einsum(
            "btcn,cn->btc", w, am)
        db[:, lo:hi] = torch.einsum("btcn,btc->btn", gs, dfx[:, lo:hi])
        da += torch.einsum("btcn,btc->cn", w, df[:, lo:hi])
        g, a_next = gs[:, 0].clone(), dec[:, 0].clone()
    return (dx.to(x.dtype), ddelta.to(delta.dtype), db.to(b_sel.dtype),
            dc.to(c_sel.dtype), (da * am).to(a_log.dtype))


def _check(x, delta, b_sel, c_sel, a_log, h0=None):
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
    if h0 is not None and (h0.shape != (bsz, di, n) or
                           h0.dtype != torch.float32 or
                           h0.device != x.device or
                           not h0.is_contiguous()):
        raise ValueError(f"selective_scan: h0 {tuple(h0.shape)} "
                         f"{h0.dtype} must be a contiguous f32 "
                         f"{(bsz, di, n)} on {x.device}")


def _launch(x, delta, b_sel, c_sel, a_log, h0=None, return_state=False):
    _check(x, delta, b_sel, c_sel, a_log, h0)
    bsz, length, di = x.shape
    n = a_log.shape[1]
    chunk = chunk_len(bsz, length, di)
    nch = -(-length // chunk)
    y = torch.empty_like(x)
    h_out = torch.empty(bsz, di, n, dtype=torch.float32, device=x.device) \
        if return_state else None
    # pass 1's carries: h_end then P, each (B, nch - 1, N, di)
    ws = torch.empty(2 * bsz * (nch - 1) * n * di, dtype=torch.float32,
                     device=x.device)
    if x.device.type == "meta":
        return (y, h_out) if return_state else y
    fn = _build.function("selective_scan", "repro_selective_scan", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), delta.data_ptr(), b_sel.data_ptr(),
                 c_sel.data_ptr(), a_log.data_ptr(), ws.data_ptr(),
                 y.data_ptr(), None if h0 is None else h0.data_ptr(),
                 None if h_out is None else h_out.data_ptr(),
                 bsz, length, di, n, chunk, _BF16[x.dtype],
                 _BF16[delta.dtype], _BF16[b_sel.dtype], _BF16[c_sel.dtype],
                 stream)
    if err != 0:
        raise RuntimeError(f"selective scan kernel launch failed: CUDA "
                           f"error {err}")
    global launches
    launches += 1
    return (y, h_out) if return_state else y


class _BackwardGraph:
    """``selective_scan_backward`` at one shape, captured once into a CUDA
    graph and replayed: its ~100 small ops per chunk cost one launch.
    The inputs are copied into static buffers before each replay and the
    gradients cloned out after it; the graph's private memory pool holds
    one chunk's temporaries and those buffers."""

    def __init__(self, args):
        self.inputs = [t.clone() for t in args]
        current = torch.cuda.current_stream(args[0].device)
        stream = torch.cuda.Stream(args[0].device)
        # warm on the side stream (library handles and workspaces exist
        # before the capture), then capture there; both after the current
        # stream's queued work, which in turn waits for them
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            selective_scan_backward(*self.inputs)
            self.graph = torch.cuda.CUDAGraph()
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.outputs = selective_scan_backward(*self.inputs)
            finally:
                self.graph.capture_end()
        current.wait_stream(stream)

    def __call__(self, args):
        for static, t in zip(self.inputs, args):
            static.copy_(t)
        self.graph.replay()
        return tuple(t.clone() for t in self.outputs)


# the captured backwards, by device, shapes and dtypes; at most
# ``BACKWARD_GRAPHS`` of them, the oldest dropped first
BACKWARD_GRAPHS = 4
_backward_graphs: dict = {}
_backward_graphs_lock = threading.Lock()


def graphed_backward(*args):
    """``selective_scan_backward(*args)`` replayed from its CUDA graph
    (captured at the first call per shape): the card's backward."""
    key = tuple((t.device, tuple(t.shape), t.dtype) for t in args)
    with _backward_graphs_lock:
        graph = _backward_graphs.get(key)
        if graph is None:
            while len(_backward_graphs) >= BACKWARD_GRAPHS:
                _backward_graphs.pop(next(iter(_backward_graphs)))
            graph = _backward_graphs[key] = _BackwardGraph(args)
    return graph(args)


class SelectiveScan(torch.autograd.Function):
    """The kernel as a differentiable op: forward launches it (on a CPU
    tensor it runs the plain version, so the CPU tests can hold this
    backward inside a model's gradient) and saves its inputs; backward
    is ``selective_scan_backward``, on the card replayed from a CUDA
    graph captured at its first call per shape (on meta tensors, the
    kernel's stand-in forward and the plain backward's ops)."""

    @staticmethod
    def forward(ctx, x, delta, b_sel, c_sel, a_log):
        if x.device.type == "cpu":
            y = selective_scan_ref(x, delta, b_sel, c_sel, a_log)
        else:
            y = _launch(x, delta, b_sel, c_sel, a_log)
        ctx.save_for_backward(x, delta, b_sel, c_sel, a_log)
        return y

    @staticmethod
    def backward(ctx, dy):
        args = (*ctx.saved_tensors, dy.contiguous())
        if dy.device.type == "cuda":
            return graphed_backward(*args)
        return selective_scan_backward(*args)


def selective_scan(x: torch.Tensor, delta: torch.Tensor, b_sel: torch.Tensor,
                   c_sel: torch.Tensor, a_log: torch.Tensor,
                   h0: Optional[torch.Tensor] = None,
                   return_state: bool = False):
    if x.device.type == "cpu":
        return selective_scan_ref(x, delta, b_sel, c_sel, a_log, h0,
                                  return_state)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"selective_scan: unsupported device {x.device}")
    if h0 is not None or return_state:
        ins = (x, delta, b_sel, c_sel, a_log) + (
            () if h0 is None else (h0,))
        _build.refuse_grad("selective_scan with a state", *ins)
        return _launch(x, delta, b_sel, c_sel, a_log.float(), h0,
                       return_state)
    return SelectiveScan.apply(x, delta, b_sel, c_sel, a_log.float())
