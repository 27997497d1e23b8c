#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device  — requires CUDA; prints the card's name and power limit;
2. build   — builds the hand-written kernels from ``src/repro_torch/
             kernels/csrc`` (one nvcc per source, all in parallel);
             requires no ptxas spills in the confidence kernels;
3. kernels — holds each kernel against its plain PyTorch version on the
             card at the serving paths' shapes (LLaDA-8B's and
             Hymba-1.5B's, plus a ragged and a long selective scan, a
             long banded and an Lq != Lk attention, the cached windows'
             attention and confidence calls, and banded windows at a q
             offset in bf16 and f32) and times kernel,
             plain version and, for attention, SDPA (a yardstick only),
             each call to call and on the device alone (with each
             confidence shape's share of its bound); counts the
             tensor-core instructions (HMMA/HGMMA) in the bf16 attention
             kernels' SASS and requires no ptxas spills in them at d=64
             and d=128, nor in the selective scan's two passes at N=16;
4. reference — decodes reduced LLaDA and Hymba configs on the card
             (kernels) and on the CPU (plain versions) from the same
             weights, on the card by the eager, the per-block graph and
             the whole-request graph driver, and requires identical
             tokens, steps, forward-equivalents and phase counts; LLaDA
             under every cache policy (``none``, ``prefix``, ``dual``,
             ``prefix`` without refreshes), Hymba under ``none``;
5. serving — full-width, full-depth LLaDA-8B, then Hymba-1.5B (random
             bf16 weights from a seed; LLaDA's weights and graphs are
             freed first) behind ``ServingEngine`` on the graph drivers
             (the default): mixed prompt lengths, strategies fdm, fdm_a
             and probability; one warm pass captures each batch key's
             graphs (its cost printed apart), then the measured pass;
             checks results and stats, and that every kernel of the
             model's path ran in the measured pass, by executed launches
             (each graph's recorded launches times its replays; for
             Hymba, one selective scan per flash-attention call).  LLaDA
             serves the same requests on the same weights under the cache
             policies ``none``, ``prefix`` and ``dual``, one path each,
             with each batch's forward-equivalents held to its strategy's
             count (fdm, probability) or range (fdm_a); then serves
             3·max_runners requests of distinct prompt lengths under
             ``dual`` (a batch key each) and requires the runner cache to
             stay at max_runners runs and the card's allocated and
             reserved memory to stop growing once it is full;
6. KV A/B  — (between LLaDA's serving and Hymba's) one B=2 request at the
             reference's ``BENCH_kv_cache.json`` geometry (prompt 128,
             gen 128, block 32, probability) on full-width LLaDA-8B under
             each policy, by the eager and the graph driver interleaved:
             seconds, tokens/s, steps/s, capture seconds, graph count and
             pool bytes, and forward-equivalents of exactly 128, 68 and
             20; one graph-driven request under sync debug mode "error"
             and one under ``torch.profiler`` (busy share, device
             activities per step, idle gaps between them, executed
             launches against the trace's);
             then one full, one ``prefix`` and one ``dual`` window forward
             on the card's clock against host enqueue time (interleaved),
             each with a capture by its kernels on the card, and the
             forwards by where the host's time goes (cProfile); then the
             strategy A/B: eb and an always-accelerating FDM-A at the same
             geometry under ``none``, eager against graph, with the
             graph's executed step replays beside the logical steps;
7. flash gradient — dq, dk, dv through the flash kernel's
             ``autograd.Function`` against autograd of the plain version
             at four shapes (bf16 and f32, a GQA band at a q offset); the
             confidence and scan kernels must raise under grad; the
             backward's device ms at the full-width training shape;
8. train step — one f32 step of the ``sum`` testbed on the card against
             the same step on the CPU (loss, every gradient leaf, the
             updated params);
9. testbed — the testbed trained on the card (batch 64, up to 600 steps),
             then decoded with fdm under each cache policy on the graph
             drivers (EM, forward-equivalents, tokens equal to a CPU
             decode of the same weights) and FDM-A graph against eager;
10. training — full-width LLaDA-8B cut to 4 of its 32 layers trained a
             few steps (B=2, L=512): ms/step, tokens/s, peak memory, the
             initial NLL, exactly 2 flash launches per layer and step
             (the path's launch count), and one step's device profile;
11. http serving — the async stack (``ServerThread`` → ``ModelRouter`` →
             ``AsyncScheduler`` → ``ServingEngine``, every decode on the
             card's worker thread) over real sockets: full-width LLaDA-8B
             (random bf16 weights, seed 0) at the engine's default batch
             of 8 with Hymba-1.5B registered beside it; 8 concurrent
             clients stream 24 requests (prompts 41-64, gen 64, block 32,
             64 steps; fdm, fdm_a, probability; none, prefix, dual), and
             every request's tokens must equal its own batch decoded
             directly by ``Decoder.generate`` (the engine records each
             batch's prompts, config and seed); decode and wall tokens/s,
             latency, queue wait, batches and real rows per batch,
             forward-equivalents per token, executed launches (the path
             ``llada-8b-http``); then a seeded fault schedule (a poison
             request quarantined with one terminal error, the survivors
             equal to a fault-free run), Hymba's first request under a
             budget that holds one model (LLaDA evicted: allocated memory
             must fall by at least its weights' bytes), a drain with
             requests in flight (503 during it, one terminal event per
             stream), and ``python -m repro_torch.launch.serve
             --selftest``.

The last lines are a ``{"kernels": [...]}`` JSON line, the card's name
and power limit, and ``{"ok": true, "device": {...}}``.  Imports nothing
of JAX or of the reference package.
"""
from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
MEM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
BF16_OPS_PER_S = 989e12          # dense tensor-core bf16
F32_OPS_PER_S = 67e12            # f32 outside the tensor cores
# exp on the SFU: 16 per clock per SM x 132 SMs x 1.98 GHz (H100 SXM boost)
SFU_OPS_PER_S = 16 * 132 * 1.98e9
# the serving phase's geometry (also the shapes the kernel phase checks)
MAX_BATCH, GEN, BLOCK, K = 2, 64, 32, 2
CANVAS = 64 + GEN                # longest prompt + generation
REQUESTS = [(64, "fdm"), (60, "fdm"), (48, "fdm_a"), (48, "fdm_a"),
            (64, "probability"), (41, "probability")]
FORWARD_REPS = 5
POLICIES = ("none", "prefix", "dual")
PROFILE_MARGIN_S = 0.5           # idle time on each side of a profiled request
# the KV A/B phase: the reference's BENCH_kv_cache.json geometry and counts
KV_PROMPT, KV_GEN, KV_BLOCK = 128, 128, 32
KV_FWD = {"none": 128.0, "prefix": 68.0, "dual": 20.0}
# the strategy A/B at the KV A/B geometry under ``none``: eb (on random
# weights one token per step, its schedule) and FDM-A with η₁ = η₂ = 0
# (acceleration in every step: n_max tokens per step, so a block ends far
# inside its step budget, and the K-candidate search that the eager driver
# skips on the host runs masked in every replay of the graph driver)
STRATEGY_AB = {"eb": dict(strategy="eb"),
               "fdm_a-accel": dict(strategy="fdm_a", eta1=0.0, eta2=0.0)}
# confidence shapes of the kernel phase, (rows, V, dtype): LLaDA-8B's
# K-candidate and scoring batches in f32 and bf16, and Hymba-1.5B's
# K-candidate and scoring batches (V = 32001: rows off 16-byte boundaries),
# and the dual window's scoring and K-candidate rows (B·block, K·B·block)
CONF_SHAPES = ((K * MAX_BATCH * CANVAS, 126464, "float32"),
               (MAX_BATCH * CANVAS, 126464, "float32"),
               (K * MAX_BATCH * CANVAS, 126464, "bfloat16"),
               (K * MAX_BATCH * CANVAS, 32001, "float32"),
               (MAX_BATCH * CANVAS, 32001, "float32"),
               (MAX_BATCH * BLOCK, 126464, "float32"),
               (K * MAX_BATCH * BLOCK, 126464, "float32"))
# attention shapes of the kernel phase, (B, Lq, Lk, H, G, d, window,
# q_offset), bf16: LLaDA-8B's scoring and K-candidate batches, a GQA and a
# banded variant, Hymba-1.5B's heads at serving length and at 2048 with its
# band live, a block of queries against the whole canvas (Lq != Lk: the
# dual window at B=2), the prefix window and the K-candidate batches of
# the dual and the prefix window, and two banded windows at a q offset (the
# first skips whole key tiles), which also run in f32 (ATTN_F32)
ATTN_SHAPES = ((MAX_BATCH, CANVAS, CANVAS, 32, 32, 128, 0, 0),
               (K * MAX_BATCH, CANVAS, CANVAS, 32, 32, 128, 0, 0),
               (MAX_BATCH, CANVAS, CANVAS, 32, 8, 128, 0, 0),
               (MAX_BATCH, CANVAS, CANVAS, 32, 32, 128, 32, 0),
               (MAX_BATCH, CANVAS, CANVAS, 25, 5, 64, 1024, 0),
               (MAX_BATCH, 2048, 2048, 25, 5, 64, 1024, 0),
               (MAX_BATCH, BLOCK, CANVAS, 32, 32, 128, 0, 0),
               (MAX_BATCH, GEN, CANVAS, 32, 32, 128, 0, 0),
               (K * MAX_BATCH, BLOCK, CANVAS, 32, 32, 128, 0, 0),
               (K * MAX_BATCH, GEN, CANVAS, 32, 32, 128, 0, 0),
               (MAX_BATCH, 64, 2048, 25, 5, 64, 1024, 1024),
               (MAX_BATCH, BLOCK, CANVAS, 32, 32, 128, 32, 64))
ATTN_F32 = ATTN_SHAPES[-2:]
# selective-scan shapes of the kernel phase, (B, L, di, N, x dtype), Δ/B/C
# f32: Hymba-1.5B's Mamba branch at the scoring and K-candidate batches, a
# ragged L and di in f32, and one 2048-token row (Hymba's window is 1024)
SCAN_SHAPES = ((MAX_BATCH, CANVAS, 3200, 16, "bfloat16"),
               (K * MAX_BATCH, CANVAS, 3200, 16, "bfloat16"),
               (2, 300, 130, 16, "float32"),
               (1, 2048, 3200, 16, "bfloat16"))


def log(*args):
    print(*args, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 7, inner: int = 10) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back
    calls, from CUDA events, after warm-up."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_ms(fn, reps: int = 5, inner: int = 20) -> float:
    """Median over ``reps`` of the mean device time of ``inner``
    back-to-back calls, enqueued while the card spins
    (``torch.cuda._sleep``) so that host dispatch leaves no gap between
    them: the kernel's own time, without the wrapper's."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(10_000_000)          # ~5 ms of spinning
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def short_symbol(sym: str) -> str:
    """``_ZN12_GLOBAL__N_12tc15flash_tc_kernelILi64EEEv...`` ->
    ``tc::flash_tc_kernel<64>``; the symbol itself where the pattern
    does not fit."""
    i, names = 3, []
    if not sym.startswith("_ZN"):
        return sym
    while i < len(sym) and sym[i].isdigit():
        j = i
        while sym[j].isdigit():
            j += 1
        n = int(sym[i:j])
        names.append(sym[j:j + n])
        i = j + n
    names = [n for n in names if not n.startswith("_GLOBAL__N")]
    m = re.match(r"I((?:f|13__nv_bfloat16|Li-?\d+E|Lb[01]E)+)E", sym[i:])
    if not names:
        return sym
    if not m:
        return "::".join(names)
    args = [a or ("bf16" if b else c or d) for a, b, c, d in re.findall(
        r"(f)|(13__nv_bfloat16)|Li(-?\d+)E|Lb([01])E", m.group(1))]
    args = ["float" if a == "f" else a for a in args]
    return "::".join(names) + "<" + ",".join(args) + ">"


def ptxas_report(text: str) -> dict:
    """Per kernel of one ``nvcc -Xptxas -v`` log: registers and spill
    bytes, keyed by the short symbol."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(_Z\w+)", line)
        if m:
            cur = out.setdefault(short_symbol(m.group(1)), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def sass_mma_counts(lib_path) -> dict:
    """Tensor-core instructions (HMMA, HGMMA) per kernel in a built
    library's SASS, from ``cuobjdump -sass``."""
    from repro_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib_path)],
                          capture_output=True, text=True,
                          check=True).stdout
    counts, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = short_symbol(m.group(1))
            counts[cur] = 0
        elif cur is not None and re.search(r"\bH(?:G)?MMA\b", line):
            counts[cur] += 1
    return counts


def conf_inputs(torch, rows: int, vocab: int, dtype: str):
    """Logits for the confidence kernel, with duplicated maxima in every
    eighth row; returns the kernel's arguments."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + rows)
    x = (5 * torch.randn(rows, vocab, generator=gen, device="cuda")).to(
        getattr(torch, dtype))
    for r in range(0, rows, max(rows // 8, 1)):
        top = x[r].float().max() + 1
        x[r, 3 + r % 7] = top
        x[r, vocab - 5 - r % 11] = top
    return (x,)


def attn_inputs(torch, b, lq, lk, h, g, d, window, q_offset=0,
                dtype="bfloat16"):
    """q, k, v in ``dtype`` (bf16 by default), the band and its q offset
    for the attention kernel."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + lk + g + window)
    q, k, v = (torch.randn(*shape, generator=gen, device="cuda").to(
        getattr(torch, dtype)) for shape in ((b, lq, h, d), (b, lk, g, d),
                                             (b, lk, g, d)))
    return q, k, v, window, q_offset


def scan_inputs(torch, b, l, di, n, xdtype: str):
    """x in ``xdtype`` and f32 Δ/B/C as on the serving path, a_log with a
    spread of decays; returns the kernel's arguments."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + l + di)
    x = torch.randn(b, l, di, generator=gen, device="cuda").to(
        getattr(torch, xdtype))
    delta = torch.nn.functional.softplus(
        torch.randn(b, l, di, generator=gen, device="cuda") - 2)
    bs = torch.randn(b, l, n, generator=gen, device="cuda")
    cs = torch.randn(b, l, n, generator=gen, device="cuda")
    a_log = torch.log(torch.arange(1, n + 1, device="cuda",
                                   dtype=torch.float32))[None].repeat(di, 1)
    return x, delta, bs, cs, a_log


def check_confidence(conf_mod, torch, rows: int, vocab: int, dtype: str):
    """Kernel vs plain version; argmax exact, the rest within the
    tolerances of tests/test_kernels.py.  Returns a dict: max_abs_err,
    ms and plain_ms call to call, device_ms on the device alone,
    bound_ms."""
    (x,) = conf_inputs(torch, rows, vocab, dtype)
    got = conf_mod.confidence_fused(x)
    torch.cuda.synchronize()
    ref = conf_mod.confidence_ref(x)
    if not torch.equal(got[0], ref[0]):
        bad = int((got[0] != ref[0]).sum())
        raise AssertionError(f"confidence argmax differs on {bad} rows")
    dup_rows = list(range(0, rows, max(rows // 8, 1)))
    if not torch.all(got[2][dup_rows] == 0):
        raise AssertionError("confidence margin is not 0 on tied maxima")
    for g, r, rtol, atol in ((got[1], ref[1], 2e-4, 2e-5),
                             (got[2], ref[2], 2e-4, 2e-5),
                             (got[3], ref[3], 2e-3, 2e-4)):
        torch.testing.assert_close(g, r, rtol=rtol, atol=atol)

    def kernel():
        return conf_mod.confidence_fused(x)
    nbytes = x.numel() * x.element_size() + rows * 16
    ops = 5 * x.numel()                   # max, sub, exp, add, fma per logit
    return dict(
        max_abs_err=max(float((g - r).abs().max())
                        for g, r in zip(got[1:], ref[1:])),
        ms=time_ms(kernel), device_ms=device_ms(kernel),
        plain_ms=time_ms(lambda: conf_mod.confidence_ref(x), reps=3,
                         inner=2),
        bound_ms=1e3 * max(nbytes / MEM_BYTES_PER_S, ops / F32_OPS_PER_S))


def check_attention(fa_mod, torch, b, lq, lk, h, g, d, window, q_offset,
                    dtype="bfloat16"):
    """Kernel vs plain version (tolerance 2e-2 in bf16, 2e-4 in f32, as
    the reference's kernel tests).  Returns a dict: max_abs_err, ms,
    plain_ms, library_ms (SDPA) call to call, device_ms and
    library_device_ms on the device alone, bound_ms and bound_by."""
    import torch.nn.functional as F
    q, k, v, _, _ = attn_inputs(torch, b, lq, lk, h, g, d, window, q_offset,
                                dtype)
    got = fa_mod.flash_attention(q, k, v, window, q_offset)
    torch.cuda.synchronize()
    ref = fa_mod.attention_ref(q, k, v, window, q_offset)
    tol = 2e-2 if dtype == "bfloat16" else 2e-4
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    qpos = q_offset + torch.arange(lq)
    band = (qpos[:, None] - torch.arange(lk)[None, :]).abs() < window
    mask = band.cuda() if window else None

    def kernel():
        return fa_mod.flash_attention(q, k, v, window, q_offset)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=g != h)
    out = dict(max_abs_err=float((got.float() - ref.float()).abs().max()),
               ms=time_ms(kernel),
               plain_ms=time_ms(lambda: fa_mod.attention_ref(
                   q, k, v, window, q_offset)),
               library_ms=time_ms(sdpa), device_ms=device_ms(kernel),
               library_device_ms=device_ms(sdpa))
    pairs = int(band.sum()) if window else lq * lk
    ops = 4 * b * h * pairs * d
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    peak = BF16_OPS_PER_S if dtype == "bfloat16" else F32_OPS_PER_S
    t_bytes, t_ops = nbytes / MEM_BYTES_PER_S, ops / peak
    out.update(bound_ms=1e3 * max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    return out


def check_scan(scan_mod, torch, b, l, di, n, xdtype: str):
    """Kernel vs plain version, x in ``xdtype`` and Δ/B/C f32 as on the
    serving path (tolerance 3e-2 with bf16 x, 2e-4 in f32, as the
    reference's kernel tests).  Returns a dict: max_abs_err, ms and
    plain_ms call to call, device_ms on the device alone, bound_ms and
    bound_by (one exp per state and step), and design_floor_ms (the two
    passes' exps, 2 per state and step, on the SFU)."""
    args = scan_inputs(torch, b, l, di, n, xdtype)
    got = scan_mod.selective_scan(*args)
    torch.cuda.synchronize()
    ref = scan_mod.selective_scan_ref(*args)
    tol = 2e-4 if xdtype == "float32" else 3e-2
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)

    def kernel():
        return scan_mod.selective_scan(*args)
    nbytes = sum(t.numel() * t.element_size() for t in args) + \
        got.numel() * got.element_size()
    exps = b * l * di * n                 # one exp per state per step
    flops = 7 * b * l * di * n            # Δ·A, Δ·B·x, fma, h·C, sum
    t_bytes = nbytes / MEM_BYTES_PER_S
    t_ops = max(exps / SFU_OPS_PER_S, flops / F32_OPS_PER_S)
    return dict(
        max_abs_err=float((got.float() - ref.float()).abs().max()),
        ms=time_ms(kernel), device_ms=device_ms(kernel),
        plain_ms=time_ms(lambda: scan_mod.selective_scan_ref(*args),
                         reps=3, inner=2),
        bound_ms=1e3 * max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        design_floor_ms=1e3 * 2 * exps / SFU_OPS_PER_S)


def _to(tree, device="cuda"):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


# the reference phase's decodes: every strategy case under every policy
# (LLaDA; Hymba under ``none`` only), each by the three drivers; the FDM-A
# phases case lowers the thresholds so that all four phases occur and the
# K-candidate search is skipped in some steps (random weights otherwise
# keep FDM-A in exploration)
FDM_A_PHASES = dict(strategy="fdm_a", eta1=0.025, eta2=0.02, gamma1=0.0,
                    n_max=4)
REFERENCE_CASES = [dict(strategy="fdm", gamma=0.0), dict(strategy="fdm_a"),
                   FDM_A_PHASES, dict(strategy="probability"),
                   dict(strategy="eb")]
REFERENCE_POLICIES = {"none": {}, "prefix": dict(cache_policy="prefix"),
                      "dual": dict(cache_policy="dual"),
                      "prefix-off": dict(cache_policy="prefix",
                                         cache_refresh="off")}
DRIVERS = {"eager": dict(fused_loop=False), "block": dict(fused_blocks=False),
           "request": {}}


def reference_phase(torch, name: str, policies):
    """The port on the card (kernels, f32) against the port on the CPU
    (plain versions) on a reduced config: same weights, same prompts.  On
    the card each case runs under the eager, the per-block graph and the
    whole-request graph driver; all four decodes must give identical
    tokens, steps, forward-equivalents and phase counts."""
    import dataclasses
    from repro_torch.configs import DecodeConfig, get_config
    from repro_torch.core import Decoder
    from repro_torch.models import init_model
    cfg = get_config(name).reduced()
    cpu_params = init_model(cfg, torch.Generator().manual_seed(SEED),
                            device="cpu")
    gpu_params = _to(cpu_params)
    gen = torch.Generator().manual_seed(SEED)
    prompt = torch.randint(0, cfg.vocab_size - 1, (2, 16), generator=gen)
    for policy in policies:
        for kw in REFERENCE_CASES:
            dcfg = DecodeConfig(gen_length=32, block_size=16, steps=32,
                                **REFERENCE_POLICIES[policy], **kw)
            x_cpu, s_cpu = Decoder(cpu_params, cfg, dcfg,
                                   device="cpu").generate(None, prompt)
            want = (x_cpu, s_cpu.steps, s_cpu.forward_equivalents,
                    s_cpu.phase_counts)
            for driver, over in DRIVERS.items():
                x, st = Decoder(gpu_params, cfg, dataclasses.replace(
                    dcfg, **over), device="cuda").generate(None, prompt)
                got = (x.cpu(), st.steps, st.forward_equivalents,
                       st.phase_counts)
                same = torch.equal(got[0], want[0]) and got[1:] == want[1:]
                log(f"reference {name} {policy} {kw} {driver}: tokens and "
                    f"stats equal={same} steps {s_cpu.steps}/{st.steps} "
                    f"forward_equivalents {s_cpu.forward_equivalents}/"
                    f"{st.forward_equivalents} phases {st.phase_counts}")
                if not same:
                    raise AssertionError(f"card decode of {name} ({driver}"
                                         f" driver) differs from the CPU "
                                         f"reference for {policy} {kw}")
            if kw is FDM_A_PHASES and not all(s_cpu.phase_counts.values()):
                raise AssertionError(f"{name} {policy}: the FDM-A phases "
                                     f"case missed a phase: "
                                     f"{s_cpu.phase_counts}")


def graph_stats(torch, runs) -> dict:
    """The graphs of ``runs`` (``GraphRun``s): count, captures, capture
    seconds and their memory pools' reserved bytes (from the allocator's
    snapshot)."""
    pools = {tuple(r.graphs.pool) for r in runs}
    segments = torch.cuda.memory._snapshot()["segments"]
    pool_bytes = sum(seg["total_size"] for seg in segments
                     if tuple(seg.get("segment_pool_id") or ()) in pools)
    return {"graphs": sum(len(r.graphs) for r in runs),
            "captures": sum(r.graphs.captures for r in runs),
            "capture_s": sum(r.graphs.capture_seconds for r in runs),
            "pool_bytes": pool_bytes}


def executed_launches(runs, mods: dict) -> dict:
    """Kernel launches executed since the counts were reset: every
    graph's recorded launches times its replays, plus the wrappers' own
    counts (launches made outside any graph)."""
    from collections import Counter
    total = Counter({k: mod.launches for k, mod in mods.items()})
    for run in runs:
        total.update(run.graphs.executed_launches())
    return {k: total[k] for k in mods}


def reset_launches(runs, mods: dict) -> None:
    for mod in mods.values():
        mod.launches = 0
    for run in runs:
        run.graphs.reset_counts()


def count_params(tree) -> int:
    """Leaves counted recursively: a hybrid layer holds tensors (mix
    scales) beside its sub-dicts."""
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(count_params(v) for v in tree)
    return tree.numel()


def make_model(torch, name: str):
    """Full-width, full-depth random weights of ``name`` on the card, from
    the seed.  Returns ``(cfg, params)``."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    cfg = get_config(name)
    t0 = time.perf_counter()
    params = init_model(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                        device="cuda")
    torch.cuda.synchronize()
    log(f"serving: {name} full width and depth ({cfg.num_layers} layers, "
        f"d={cfg.d_model}, {cfg.num_heads} heads / {cfg.num_kv_heads} kv, "
        f"d_ff={cfg.d_ff}, V={cfg.vocab_size}, window "
        f"{cfg.sliding_window}, {cfg.arch_type}, {cfg.dtype}); "
        f"{count_params(params)} parameters made in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    return cfg, params


def serving_phase(torch, cfg, params, mods: dict, scope,
                  policy: str = "none"):
    """Serve ``REQUESTS`` on ``params`` under ``policy`` through the graph
    drivers (the default): one warm pass that builds and captures every
    batch key's graphs, then the main path's run.  ``mods`` maps each
    kernel of the path to its module; launch counts (the wrappers' and the
    graphs' executed launches in ``scope``'s runs) are set to 0 just
    before the run and read just after.  Returns those counts."""
    import numpy as np
    from repro_torch.configs import DecodeConfig
    from repro_torch.serving import ServingEngine
    name = f"{cfg.name}" + ("" if policy == "none" else f"-{policy}")
    dcfg = DecodeConfig(gen_length=GEN, block_size=BLOCK, steps=GEN,
                        strategy="fdm", k=K, k1=K, cache_policy=policy)

    def serve():
        batches = []
        engine = ServingEngine(params, cfg, dcfg, max_batch=MAX_BATCH,
                               seed=SEED, on_block_committed=lambda reqs,
                               blk, *_: batches.append([r.rid for r in reqs])
                               if blk == 0 else None)
        rs = np.random.default_rng(SEED)
        rids = {}
        for lp, strat in REQUESTS:
            prompt = rs.integers(0, cfg.vocab_size - 1, lp).astype(np.int64)
            rids[engine.submit(prompt, strategy=strat)] = (lp, strat)
        t0 = time.perf_counter()
        engine.run_until_idle()
        torch.cuda.synchronize()
        return engine, rids, batches, time.perf_counter() - t0

    before = graph_stats(torch, scope.values())
    _, _, _, warm = serve()
    after = graph_stats(torch, scope.values())
    log(f"serving {name} warm pass (builds and captures each batch key's "
        f"graphs): {warm:.2f} s; {after['captures'] - before['captures']} "
        f"captures in {after['capture_s'] - before['capture_s']:.3f} s; "
        f"graphs {after['graphs']}, pool bytes {after['pool_bytes']}")
    reset_launches(scope.values(), mods)
    engine, rids, batches, wall = serve()
    launches = executed_launches(scope.values(), mods)
    log(f"serving {name}: {len(rids)} requests in {len(batches)} batches, "
        f"{wall:.2f} s; executed kernel launches {launches}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel was not launched on the {name} "
                             f"serving path: {launches}")
    if "selective_scan" in launches and \
            launches["selective_scan"] != launches["flash_attention"]:
        raise AssertionError(f"{name}: one selective scan per attention "
                             f"call expected, got {launches}")

    for rid, (lp, strat) in rids.items():
        req = engine.result(rid)
        gen_tokens = req.result[-GEN:]
        if req.status != "done" or req.result.shape != (lp + GEN,):
            raise AssertionError(f"request {rid} did not finish properly")
        if ((gen_tokens < 0) | (gen_tokens >= cfg.vocab_size)).any() or \
                (gen_tokens == cfg.mask_token_id).any():
            raise AssertionError(f"request {rid}: masked or out-of-vocab "
                                 f"token in the generation")
        st = req.stats
        log(f"request {rid}: prompt {lp}, {strat}, latency "
            f"{req.latency:.3f} s, steps {st.steps}, forward_equivalents "
            f"{st.forward_equivalents}, phase_counts {st.phase_counts}")
    for members in batches:
        reqs = [engine.result(r) for r in members]
        strat = reqs[0].dcfg.strategy
        steps = reqs[0].stats.steps
        batch_fwd = reqs[0].stats.forward_equivalents * len(reqs)
        if any(r.stats.steps != steps or r.stats.forward_equivalents !=
               reqs[0].stats.forward_equivalents for r in reqs):
            raise AssertionError(f"batch {members}: stats not pro-rated "
                                 f"evenly")
        if steps != GEN:                      # every strategy here: 1/step
            raise AssertionError(f"batch {members}: {steps} steps")
        # forwards per step: fdm 1+K, probability 1, fdm_a between; a
        # cached step costs window/total of a forward, and each of the
        # GEN/BLOCK cache captures one
        total = len(reqs[0].result) + reqs[0].pad_cols
        scale = {"none": 1.0, "prefix": GEN / total,
                 "dual": BLOCK / total}[policy]
        refreshes = 0 if policy == "none" else GEN // BLOCK
        lo, hi = (refreshes + steps * n * scale for n in (1, 1 + K))
        want = {"fdm": hi, "probability": lo}.get(strat)
        # exact but for the order of the float sum (per step, as the
        # reference's host driver adds them)
        if want is not None and abs(batch_fwd - want) > 1e-9 * want:
            raise AssertionError(f"batch {members} ({strat}, {policy}): "
                                 f"{batch_fwd} forward-equivalents, want "
                                 f"{want}")
        if strat == "fdm_a":
            if not lo - 1e-9 <= batch_fwd <= hi + 1e-9:
                raise AssertionError(f"fdm_a batch {members} ({policy}): "
                                     f"{batch_fwd} not in [{lo}, {hi}]")
            for r in reqs:
                if abs(sum(r.stats.phase_counts.values()) - steps) > 1e-9:
                    raise AssertionError(f"fdm_a request {r.rid}: phase "
                                         f"counts do not sum to steps")
        log(f"batch {members} ({strat}): steps {steps}, "
            f"forward_equivalents {batch_fwd}")
    summary = engine.summary()
    log(f"serving {name} summary: " + json.dumps(summary))
    log(f"serving {name} decode tokens/s: {summary['decode_tps']}; latency "
        f"mean {summary['mean_latency_s']:.3f} s p95 "
        f"{summary['p95_latency_s']:.3f} s; forward-equivalents per "
        f"request {summary['forward_equivalents'] / len(rids)}; launches "
        f"{launches}")
    return launches


def card_vs_host(torch, calls: dict) -> None:
    """Each call of ``calls`` (label -> fn) on the card's clock against the
    host's time to enqueue it: median (and range) of FORWARD_REPS rounds,
    each round calling every fn once, each call started on an idle card
    (interleaved, so a drift in the host's speed reaches every label
    alike)."""
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    card = {label: [] for label in calls}
    host = {label: [] for label in calls}
    for _ in range(FORWARD_REPS):
        for label, fn in calls.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            fn()
            end.record()
            host[label].append(1e3 * (time.perf_counter() - t0))
            torch.cuda.synchronize()
            card[label].append(start.elapsed_time(end))
    for label in calls:
        c, h = card[label], host[label]
        log(f"forward {label}: {statistics.median(c):.3f} ms on the card's "
            f"clock [{min(c):.3f}, {max(c):.3f}], "
            f"{statistics.median(h):.3f} ms to enqueue on the host "
            f"[{min(h):.3f}, {max(h):.3f}] (median [range] of "
            f"{FORWARD_REPS}, interleaved)")


def host_profile(torch, label: str, fn, top: int = 10) -> None:
    """Where the host's time goes in one call of ``fn``: cProfile's own
    time per function (cProfile adds its own per-call cost, so only the
    shares are meaningful)."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    fn()
    prof.disable()
    torch.cuda.synchronize()
    rows = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: -kv[1][2])
    total = sum(v[2] for _, v in rows)
    log(f"host profile of one {label}: {1e3 * total:.2f} ms of own time in "
        f"{sum(v[1] for _, v in rows)} calls; top {top}:")
    for (path, line, name), (_, calls, own, _, _) in rows[:top]:
        log(f"  {1e3 * own:8.2f} ms {calls:6d} calls  {name} "
            f"({os.path.basename(path)}:{line})")


def device_profile(torch, label: str, fn, reps: int = 2,
                   top: int = 6, groups=None) -> None:
    """The card's kernels in ``reps`` calls of ``fn`` after warm-up, from
    ``torch.profiler`` (device activity only: host events would slow the
    trace's processing by seconds): per call the synchronised wall time,
    the summed kernel time, the kernel count, the share of the wall the
    card was busy, and the ``top`` kernels by device time; with
    ``groups`` (label -> name substrings, first match wins) also the
    device ms per call of each group and of the rest."""
    from collections import defaultdict
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = defaultdict(lambda: [0, 0.0])
    busy, end = 0.0, float("-inf")
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
        if e.time_range.end > end:
            busy += e.time_range.end - max(e.time_range.start, end)
            end = e.time_range.end
    summed = sum(t for _, t in by_name.values())
    log(f"device profile {label}: wall {wall_us / reps / 1e3:.3f} ms per "
        f"call (profiled); kernels {summed / reps / 1e3:.3f} ms per call "
        f"({len(kernels) // reps} kernels), busy share of the wall "
        f"{busy / wall_us:.3f}")
    for name, (n, t) in sorted(by_name.items(),
                               key=lambda kv: -kv[1][1])[:top]:
        log(f"  {t / reps / 1e3:8.3f} ms {n // reps:5d}x  {name[:100]}")
    if groups:
        sums = defaultdict(lambda: [0, 0.0])
        for name, (n, t) in by_name.items():
            g = next((g for g, pats in groups.items()
                      if any(p in name for p in pats)), "other")
            sums[g][0] += n
            sums[g][1] += t
        log(f"device profile {label} by group (ms per call, kernels): " +
            "; ".join(f"{g} {t / reps / 1e3:.3f} ({n // reps})"
                      for g, (n, t) in sorted(sums.items(),
                                              key=lambda kv: -kv[1][1])))


def forward_phase(torch, cfg, params) -> None:
    """Forwards at the scoring and the K-candidate batch on the card's
    clock against host enqueue time, then where the host's time goes in
    one forward."""
    from repro_torch.models import forward
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    calls = {}
    for b in (MAX_BATCH, K * MAX_BATCH):
        tokens = torch.randint(0, cfg.vocab_size - 1, (b, CANVAS),
                               generator=gen, device="cuda")
        calls[f"{cfg.name} B={b} L={CANVAS}"] = \
            lambda t=tokens: forward(params, t, cfg)
    card_vs_host(torch, calls)
    host_profile(torch, f"{cfg.name} forward B={K * MAX_BATCH}",
                 lambda: forward(params, tokens, cfg))


def graph_profile(torch, label: str, fn, run, mods) -> None:
    """One call of ``fn`` (a graph-driven request) under ``torch.profiler``
    (device activity only): wall, kernel time, kernel count per step, the
    share of the wall the card was busy, and the hand-written kernels'
    launches in the trace against the ones ``run``'s graphs count."""
    from collections import Counter
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    names = {"confidence": "confidence_kernel", "selective_scan": "true>",
             "flash_attention": "flash_"}
    reset_launches([run], mods)
    # the trace can lose device activities at the edges of the profiler's
    # window (one H100 run's trace of a 128-step request lacked the last
    # 2.6 steps' kernels, which had run): the window opens and closes
    # PROFILE_MARGIN_S away from the work, and the log gives how far the
    # first and last activities lie from the host's clock readings
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        host0 = time.time_ns()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
        host1 = time.time_ns()
        time.sleep(PROFILE_MARGIN_S)
    t1 = time.perf_counter()
    spans, seen = [], Counter()
    first, last = float("inf"), float("-inf")
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        spans.append((e.start_ns() / 1e3, e.duration_ns() / 1e3))
        first = min(first, e.start_ns())
        last = max(last, e.start_ns() + e.duration_ns())
        for k, pat in names.items():
            if pat in e.name() and (k != "selective_scan"
                                    or "sscan_chunk_kernel" in e.name()):
                seen[k] += 1
    busy, end, gaps = 0.0, float("-inf"), []
    for start, dur in sorted(spans):
        if start > end > float("-inf"):
            gaps.append(start - end)
        if start + dur > end:
            busy += start + dur - max(start, end)
            end = start + dur
    long_gaps = [g for g in gaps if g > 1000]
    counted = executed_launches([run], mods)
    steps = run.graphs.replays() - run.graphs.replays(("refresh",))
    log(f"device profile {label}: wall {wall_us / 1e3:.3f} ms (profiled); "
        f"kernels {sum(d for _, d in spans) / 1e3:.3f} ms, {len(spans)} "
        f"device activities in {steps} step replays "
        f"({len(spans) / max(steps, 1):.1f} per step, refreshes "
        f"included), busy share of the wall {busy / wall_us:.3f}; idle "
        f"between activities {sum(gaps) / 1e3:.1f} ms in {len(gaps)} gaps, "
        f"{len(long_gaps)} of them over 1 ms ({sum(long_gaps) / 1e3:.1f} "
        f"ms, largest {max(gaps, default=0) / 1e3:.2f} ms); "
        f"hand-written kernels in the trace {dict(seen)}, counted by the "
        f"graphs {counted}; trace read in {time.perf_counter() - t1:.1f} s")
    edges = (f"first activity {(first - host0) / 1e6:+.3f} ms from the "
             f"host's start, last one ends {(last - host1) / 1e6:+.3f} ms "
             f"from the host's end (of a {PROFILE_MARGIN_S} s margin)")
    log(f"device profile {label}: {edges}")
    if spans and any(seen[k] != counted[k] for k in counted):
        raise AssertionError(f"{label}: executed launches counted by the "
                             f"graphs {counted} differ from the trace's "
                             f"{dict(seen)}; {edges}")


def kv_ab_phase(torch, cfg, params, mods: dict) -> None:
    """One B=2 request at the reference's ``BENCH_kv_cache.json`` geometry
    under each cache policy, by the eager and the graph driver
    interleaved (eager, graph, graph, eager, after one cold graph decode
    that captures): seconds, tokens/s and steps/s of each, capture
    seconds, graph count and pool bytes, forward-equivalents of exactly
    128, 68 and 20 under both drivers; one graph-driven request under
    ``torch.cuda.set_sync_debug_mode("error")`` and one under
    ``torch.profiler``.  Then on the last canvas: one full forward, one
    window forward per cached policy and one cache capture, on the card's
    clock against host enqueue time, by their kernels on the card, and
    where the host's time goes in each forward (cProfile)."""
    import dataclasses
    from repro_torch.configs import DecodeConfig
    from repro_torch.core import Decoder, decode_cache_scope
    from repro_torch.models import capture_cache, forward, forward_cached
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    prompt = torch.randint(0, cfg.vocab_size - 1, (2, KV_PROMPT),
                           generator=gen, device="cuda")
    total = KV_PROMPT + KV_GEN
    tps = {}
    for policy in POLICIES:
        dcfg = DecodeConfig(gen_length=KV_GEN, block_size=KV_BLOCK,
                            steps=KV_GEN, strategy="probability",
                            cache_policy=policy)
        with decode_cache_scope() as scope:
            decs = {"eager": Decoder(params, cfg, dataclasses.replace(
                dcfg, fused_loop=False)), "graph": Decoder(params, cfg,
                                                           dcfg)}
            t0 = time.perf_counter()
            decs["graph"].generate(None, prompt)
            torch.cuda.synchronize()
            cold = time.perf_counter() - t0
            (run,) = scope.values()
            gs = graph_stats(torch, [run])
            secs = {"eager": [], "graph": []}
            outs = {}
            for driver in ("eager", "graph", "graph", "eager"):
                t0 = time.perf_counter()
                out, st = decs[driver].generate(None, prompt)
                torch.cuda.synchronize()
                secs[driver].append(time.perf_counter() - t0)
                outs[driver] = out
                if st.forward_equivalents != KV_FWD[policy] or \
                        st.steps != KV_GEN:
                    raise AssertionError(
                        f"kv a/b {policy} {driver}: {st.steps} steps, "
                        f"{st.forward_equivalents} forward-equivalents, "
                        f"want {KV_GEN} and {KV_FWD[policy]}")
                if (out[:, KV_PROMPT:] == cfg.mask_token_id).any():
                    raise AssertionError(f"kv a/b {policy} {driver}: "
                                         f"masked token left")
            for driver, ss in secs.items():
                med = statistics.median(ss)
                tps[policy, driver] = 2 * KV_GEN / med
                log(f"kv a/b {cfg.name} {policy} {driver}: prompt "
                    f"{KV_PROMPT} gen {KV_GEN} block {KV_BLOCK} B=2 "
                    f"probability: {med:.3f} s (runs "
                    f"{', '.join(f'{x:.3f}' for x in ss)}), tokens/s "
                    f"{2 * KV_GEN / med:.2f}, steps/s {KV_GEN / med:.2f}, "
                    f"forward_equivalents {KV_FWD[policy]}")
            log(f"kv a/b {cfg.name} {policy} graph driver: cold decode "
                f"{cold:.3f} s of which {gs['capture_s']:.3f} s in "
                f"{gs['captures']} captures; graphs {gs['graphs']}, pool "
                f"bytes {gs['pool_bytes']}; graph tokens equal eager's: "
                f"{torch.equal(outs['graph'], outs['eager'])}")
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                _, st = decs["graph"].generate(None, prompt)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            log(f"kv a/b {policy}: a whole-request graph decode made no "
                f"implicit sync (sync debug mode 'error'; its waits are "
                f"event waits on the block's masked count, polled two steps "
                f"behind the card, and the final readback)")
            graph_profile(torch, f"{cfg.name} graph-driven request "
                          f"{policy} B=2 gen {KV_GEN}",
                          lambda: decs["graph"].generate(None, prompt),
                          run, mods)
    for driver in ("eager", "graph"):
        log(f"kv a/b {driver} driver tokens/s against none: prefix "
            f"{tps['prefix', driver] / tps['none', driver]:.3f}x, dual "
            f"{tps['dual', driver] / tps['none', driver]:.3f}x")
    for policy in POLICIES:
        log(f"kv a/b {policy}: graph driver at "
            f"{tps[policy, 'graph'] / tps[policy, 'eager']:.3f}x the "
            f"eager driver's tokens/s")
    canvas = out
    state = capture_cache(params, canvas, cfg)
    lo = KV_PROMPT + KV_BLOCK
    calls = {
        f"{cfg.name} full B=2 L={total}":
            lambda: forward(params, canvas, cfg),
        f"{cfg.name} prefix window B=2 W={KV_GEN} of {total}":
            lambda: forward_cached(params, canvas[:, KV_PROMPT:], KV_PROMPT,
                                   state, cfg),
        f"{cfg.name} dual window B=2 W={KV_BLOCK} of {total}":
            lambda: forward_cached(params, canvas[:, lo:lo + KV_BLOCK], lo,
                                   state, cfg)}
    card_vs_host(torch, calls)
    calls[f"{cfg.name} cache capture B=2 L={total}"] = \
        lambda: capture_cache(params, canvas, cfg)
    for label, fn in calls.items():
        device_profile(torch, label, fn)
    for label, fn in list(calls.items())[:3]:
        host_profile(torch, label, fn)


def memory_phase(torch, cfg, params) -> None:
    """Serving traffic of many prompt lengths on one set of weights:
    3·max_runners requests under ``dual``, each of a length of its own (so
    a batch key, a run and graphs of its own), one batch at a time through
    ``ServingEngine``.  The runner cache must hold at most max_runners
    runs, and the card's memory must stop growing once the cache is full:
    the allocated and the reserved bytes' growth over the last third stay
    within 10% + 256 MiB of their peak over the first two thirds."""
    import numpy as np
    from repro_torch.configs import DecodeConfig
    from repro_torch.core import decode_cache_scope
    from repro_torch.serving import ServingEngine
    dcfg = DecodeConfig(gen_length=GEN, block_size=BLOCK, steps=8,
                        strategy="probability", cache_policy="dual")
    with decode_cache_scope() as scope:
        cap = scope.max_runners
        engine = ServingEngine(params, cfg, dcfg, max_batch=MAX_BATCH,
                               seed=SEED)
        rs = np.random.default_rng(SEED + 2)
        lens = rs.choice(np.arange(16, 129), size=3 * cap, replace=False)
        torch.cuda.synchronize()
        base = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
        growth = []
        t0 = time.perf_counter()
        for lp in lens:
            engine.submit(rs.integers(0, cfg.vocab_size - 1, int(lp)))
            engine.step()
            torch.cuda.synchronize()
            growth.append((torch.cuda.memory_allocated() - base[0],
                           torch.cuda.memory_reserved() - base[1]))
        info = scope.info()
        pool_bytes = graph_stats(torch, scope.values())["pool_bytes"]
    log(f"memory llada-8b dual: {len(lens)} prompt lengths in "
        f"{time.perf_counter() - t0:.1f} s; runner cache {info}; graph pool "
        f"bytes {pool_bytes}; growth (allocated, reserved) MiB after each "
        f"batch: {[(a >> 20, r >> 20) for a, r in growth]}")
    if info.runners > cap or info.misses != len(lens):
        raise AssertionError(f"memory phase: runner cache {info}, want at "
                             f"most {cap} runners and {len(lens)} misses")
    for i, what in enumerate(("allocated", "reserved")):
        fill = max(g[i] for g in growth[:2 * cap])
        late = max(g[i] for g in growth[2 * cap:])
        if late > 1.1 * max(fill, 0) + 256 * 2**20:
            raise AssertionError(f"memory phase: {what} bytes still grow "
                                 f"with new prompt lengths: peak {late} "
                                 f"after the cache filled, {fill} before")


def strategy_ab_phase(torch, cfg, params) -> None:
    """``STRATEGY_AB`` at the KV A/B geometry under ``none``: one B=2
    request by the eager and the graph driver interleaved (eager, graph,
    graph, eager, after one cold graph decode): seconds and tokens/s of
    each, steps, forward-equivalents and phase counts (equal under both
    drivers, as are the tokens), and the graph driver's executed step
    replays per request (a replay past a block's end changes nothing and
    costs a full step, the masked search included)."""
    import dataclasses
    from repro_torch.configs import DecodeConfig
    from repro_torch.core import Decoder, decode_cache_scope
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    prompt = torch.randint(0, cfg.vocab_size - 1, (2, KV_PROMPT),
                           generator=gen, device="cuda")
    for label, kw in STRATEGY_AB.items():
        dcfg = DecodeConfig(gen_length=KV_GEN, block_size=KV_BLOCK,
                            steps=KV_GEN, **kw)
        with decode_cache_scope() as scope:
            decs = {"eager": Decoder(params, cfg, dataclasses.replace(
                dcfg, fused_loop=False)), "graph": Decoder(params, cfg,
                                                           dcfg)}
            decs["graph"].generate(None, prompt)
            (run,) = scope.values()
            run.graphs.reset_counts()
            secs = {"eager": [], "graph": []}
            outs = {}
            for driver in ("eager", "graph", "graph", "eager"):
                t0 = time.perf_counter()
                out, st = decs[driver].generate(None, prompt)
                torch.cuda.synchronize()
                secs[driver].append(time.perf_counter() - t0)
                got = (st.steps, st.forward_equivalents, st.phase_counts)
                if driver in outs and (not torch.equal(out, outs[driver][0])
                                       or got != outs[driver][1]):
                    raise AssertionError(f"strategy a/b {label}: two "
                                         f"{driver} decodes differ")
                outs[driver] = (out, got)
            replays = run.graphs.replays() / 2
        if not torch.equal(outs["graph"][0], outs["eager"][0]) or \
                outs["graph"][1] != outs["eager"][1]:
            raise AssertionError(f"strategy a/b {label}: graph decode "
                                 f"{outs['graph'][1]} differs from eager "
                                 f"{outs['eager'][1]}")
        steps, fwd, phases = outs["eager"][1]
        med = {d: statistics.median(ss) for d, ss in secs.items()}
        for driver, ss in secs.items():
            log(f"strategy a/b {cfg.name} {label} {driver}: prompt "
                f"{KV_PROMPT} gen {KV_GEN} block {KV_BLOCK} B=2 none: "
                f"{med[driver]:.3f} s (runs "
                f"{', '.join(f'{x:.3f}' for x in ss)}), tokens/s "
                f"{2 * KV_GEN / med[driver]:.2f}")
        log(f"strategy a/b {cfg.name} {label}: steps {steps}, "
            f"forward_equivalents {fwd}, phases {phases}; graph driver "
            f"{replays:.0f} step replays per request ({replays - steps:.0f} "
            f"past a block's end), graph at "
            f"{med['eager'] / med['graph']:.3f}x the eager driver's "
            f"tokens/s")


# --------------------------------------------------------------------------
# http serving (phase 11): the async stack over real sockets
# --------------------------------------------------------------------------

# LLaDA-8B behind ServerThread → ModelRouter → AsyncScheduler → engine at
# the engine's default batch (8), Hymba-1.5B registered beside it; 8
# concurrent clients send 3 requests each (prompts 41-64, gen 64, block
# 32, 64 steps; fdm, fdm_a, probability; each client's requests under
# none, then prefix, then dual), one length bucket for all prompts
HTTP_MAX_BATCH = 8
HTTP_CLIENTS = 8
HTTP_STRATEGIES = ("fdm", "fdm_a", "probability")
HTTP_BUCKET = 32
HTTP_FAULT_PROMPTS = 4            # one batch under a seeded fault schedule
HTTP_DRAIN_REQUESTS = 6
HTTP_DRAIN_DEADLINE_S = 0.5
HTTP_DEVICE = "cuda"


def _http_router(torch, records: list):
    """A router of LLaDA-8B and Hymba-1.5B on the card: each factory makes
    its model's random bf16 weights from the seed (on the card's worker,
    where the server builds) and records each decoded batch of its
    engine (``records``: (model, Batch))."""
    from repro_torch.configs import DecodeConfig, RouterConfig, get_config
    from repro_torch.models import init_model
    from repro_torch.serving import ModelRouter, ServingEngine

    def factory(name):
        def build():
            cfg = get_config(name)
            params = init_model(cfg, torch.Generator(
                device=HTTP_DEVICE).manual_seed(SEED), device=HTTP_DEVICE)
            engine = ServingEngine(
                params, cfg, DecodeConfig(gen_length=GEN, block_size=BLOCK,
                                          steps=GEN, strategy="fdm", k=K,
                                          k1=K),
                max_batch=HTTP_MAX_BATCH, seed=SEED,
                length_bucket=HTTP_BUCKET, device=HTTP_DEVICE)
            engine.on_batch_done = lambda b: records.append((name, b))
            return engine
        return build

    router = ModelRouter(RouterConfig(), device=HTTP_DEVICE)
    router.register("llada-8b", factory("llada-8b"))
    router.register("hymba-1.5b", factory("hymba-1.5b"))
    return router


def _stream(client, prompt, **kw):
    """One request's SSE stream: its events, checked to be blocks then
    exactly one terminal event."""
    events = list(client.generate_stream(prompt, **kw))
    finals = [e for name, e in events if e.get("final")]
    if len(finals) != 1 or not events[-1][1].get("final"):
        raise AssertionError(f"stream without exactly one terminal event "
                             f"at its end: {[n for n, _ in events]}")
    return events


def _redecode_batches(torch, router, name, batches, tokens) -> int:
    """Each recorded batch of ``name`` decoded again directly by
    ``Decoder.generate`` from its prompts, config and seed, on the card's
    worker; every request's tokens (``tokens``: rid -> list) must equal
    its row.  Returns the number of requests checked."""
    from repro_torch.core import Decoder
    from repro_torch.serving import run_on_worker

    def redecode():
        engine = router.touch(name)
        out = []
        for batch in batches:
            x, _ = Decoder(engine.params, engine.cfg, batch.dcfg,
                           device=HTTP_DEVICE).generate(batch.seed,
                                                        batch.prompts)
            out.append(x.cpu().numpy())
        return out

    checked = 0
    for batch, x in zip(batches, run_on_worker(HTTP_DEVICE, redecode)):
        for i, req in enumerate(batch.requests):
            if req.rid not in tokens:
                continue
            if tokens[req.rid] != x[i, batch.pads[i]:].tolist():
                raise AssertionError(
                    f"http {name}: request {req.rid}'s tokens differ from "
                    f"its batch ({len(batch.requests)} real rows, "
                    f"{batch.dcfg.strategy}, {batch.dcfg.cache_policy}) "
                    f"decoded directly")
            checked += 1
    return checked


def http_phase(torch, mods: dict) -> dict:
    """Phase 11 (module docstring).  Returns the traffic's executed kernel
    launches (counts set to 0 just before it, read just after)."""
    import threading
    import numpy as np
    from repro_torch.configs import ServerConfig
    from repro_torch.core import decode_cache_scope, graphs
    from repro_torch.serving import ServerThread
    records = []
    t0 = time.perf_counter()
    with decode_cache_scope():
        router = _http_router(torch, records)
        handle = ServerThread(router, ServerConfig(port=0)).start()
        try:
            launches = _http_traffic(torch, handle, router, records, mods,
                                     graphs, threading, np)
            _http_faults(handle, records, np)
            _http_eviction(torch, handle, router, records, np)
            _http_drain(handle, threading, np)
        finally:
            handle.stop()
    # the CLI's own selftest on the card (train, park, serve one request)
    t1 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--selftest",
         "--train-steps", "50", "--device", HTTP_DEVICE],
        capture_output=True, text=True,
        timeout=600, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    tail = res.stdout.strip().splitlines()[-12:]
    log("http selftest (python -m repro_torch.launch.serve --selftest): "
        f"exit {res.returncode} in {time.perf_counter() - t1:.1f} s; "
        + " | ".join(tail))
    if res.returncode != 0 or "selftest OK" not in res.stdout:
        raise AssertionError(f"serve --selftest failed: {res.stderr[-2000:]}")
    log(f"http serving phase: {time.perf_counter() - t0:.1f} s")
    return launches


def _http_traffic(torch, handle, router, records, mods, graphs, threading,
                  np) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core import decode_cache_info
    from repro_torch.serving import ServingClient
    vocab = get_config("llada-8b").vocab_size
    rs = np.random.default_rng(SEED + 11)
    plan = [[(rs.integers(0, vocab - 1, int(rs.integers(41, 65))).tolist(),
              HTTP_STRATEGIES[c % len(HTTP_STRATEGIES)], policy)
             for policy in POLICIES] for c in range(HTTP_CLIENTS)]
    results, errors = {}, []

    def client_main(c):
        client = ServingClient(handle.host, handle.port, timeout=900)
        try:
            for prompt, strategy, policy in plan[c]:
                t0 = time.perf_counter()
                events = _stream(client, prompt, model="llada-8b",
                                 strategy=strategy, cache_policy=policy,
                                 gen_length=GEN, block_size=BLOCK,
                                 steps=GEN)
                results[(c, policy)] = (events, time.perf_counter() - t0)
        except Exception as e:              # surfaced below
            errors.append((c, repr(e)))

    captures = decode_cache_info().captures
    for mod in mods.values():
        mod.launches = 0
    graphs.REPLAYED.clear()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client_main, args=(c,))
               for c in range(HTTP_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    launches = {k: mod.launches + graphs.REPLAYED[k]
                for k, mod in mods.items()}
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"http llada-8b: client failures {errors}")
    log(f"http llada-8b: {len(results)} requests from {HTTP_CLIENTS} "
        f"concurrent clients in {wall:.2f} s (weights built and "
        f"{decode_cache_info().captures - captures} graphs captured "
        f"inside it); executed kernel launches {launches}")
    if not (launches["confidence"] and launches["flash_attention"]):
        raise AssertionError(f"a kernel was not launched on the http "
                             f"serving path: {launches}")

    tokens, fwd, latency, gen_tokens = {}, 0.0, [], 0
    for (c, policy), (events, secs) in sorted(results.items()):
        done = events[-1][1]
        if done["type"] != "done" or done["status"] != "ok":
            raise AssertionError(f"http llada-8b client {c} {policy}: "
                                 f"{done}")
        blocks = [e for name, e in events if name == "block"]
        streamed = sum((e["tokens"] for e in blocks), [])
        prompt = plan[c][POLICIES.index(policy)][0]
        if [e["block"] for e in blocks] != list(range(GEN // BLOCK)) or \
                streamed != done["tokens"][len(prompt):] or \
                done["tokens"][:len(prompt)] != prompt:
            raise AssertionError(f"http llada-8b client {c} {policy}: the "
                                 f"SSE blocks do not tile the result")
        tokens[done["rid"]] = done["tokens"]
        fwd += done["stats"]["forward_equivalents"]
        gen_tokens += GEN
        latency.append(secs)
    batches = [b for name, b in records if name == "llada-8b"]
    del records[:]
    t0 = time.perf_counter()
    checked = _redecode_batches(torch, router, "llada-8b", batches, tokens)
    redecode_s = time.perf_counter() - t0
    if checked != len(tokens):
        raise AssertionError(f"http llada-8b: {checked} of {len(tokens)} "
                             f"requests found in the recorded batches")
    client = ServingClient(handle.host, handle.port)
    waits = []
    for rid in tokens:
        spans = client.trace(rid, model="llada-8b")["traceEvents"]
        waits += [e["dur"] / 1e6 for e in spans
                  if e.get("name") == "queue_wait"]
    summary = router.touch("llada-8b").summary()
    rows = [len(b.requests) for b in batches]
    log(f"http llada-8b: every request's tokens equal its own batch "
        f"decoded directly ({checked} requests, {len(batches)} batches, "
        f"re-decoded in {redecode_s:.2f} s)")
    log(f"http llada-8b: decode tokens/s {summary['decode_tps']:.2f}; wall "
        f"tokens/s {gen_tokens / wall:.2f}; latency mean "
        f"{statistics.mean(latency):.3f} s p95 "
        f"{float(np.percentile(latency, 95)):.3f} s (client side); queue "
        f"wait mean {statistics.mean(waits):.3f} s p95 "
        f"{float(np.percentile(waits, 95)):.3f} s; batches {len(batches)}, "
        f"real rows per batch {statistics.mean(rows):.2f} (of "
        f"{HTTP_MAX_BATCH}: {rows}); forward-equivalents per token "
        f"{fwd / gen_tokens:.4f}; launches {launches}")
    return launches


def _http_faults(handle, records, np):
    """One seeded fault schedule on LLaDA: a poison request (every batch
    holding it fails: retries, bisection, quarantine) and one NaN-style
    corruption of a committed block (a transient failure, retried).  The
    survivors must equal a fault-free run of the same prompts (one length,
    so no pads; every batch is 8 rows), and the poison request must get
    exactly one terminal ``error``."""
    from repro_torch.configs import get_config
    from repro_torch.serving import Fault, FaultInjector, ServingClient
    rs = np.random.default_rng(SEED + 12)
    prompts = [rs.integers(0, get_config("llada-8b").vocab_size - 1, 48)
               for _ in range(HTTP_FAULT_PROMPTS)]
    sched = handle.call(handle.server.scheduler, "llada-8b")
    client = ServingClient(handle.host, handle.port, timeout=900)

    def run(schedule):
        async def submit():
            # on the server's loop, with no await: the worker sees the
            # whole group (one batch) and the armed injector together
            rids = [sched.submit(p, strategy="probability",
                                 cache_policy="dual", gen_length=GEN,
                                 block_size=BLOCK, steps=GEN)
                    for p in prompts]
            sched.engine.set_fault_injector(schedule(rids))
            return rids
        rids = handle.call(submit)
        return rids, {rid: [e for _, e in client.stream(rid,
                                                        model="llada-8b")]
                      for rid in rids}

    before = dict(sched.counters)
    clean_rids, clean = run(lambda rids: None)
    t0 = time.perf_counter()
    rids, faulted = run(lambda rids: FaultInjector(
        [Fault(kind="nan", block=0, times=1),
         Fault(kind="error", rid=rids[2], times=None)], seed=SEED))
    secs = time.perf_counter() - t0

    async def disarm():
        sched.engine.set_fault_injector(None)

    handle.call(disarm)
    counters = {k: sched.counters[k] - before[k] for k in
                ("batches", "retries", "requeued", "quarantined", "errors",
                 "resets")}
    for i, rid in enumerate(rids):
        finals = [e for e in faulted[rid] if e.get("final")]
        if len(finals) != 1:
            raise AssertionError(f"http faults: request {rid} got "
                                 f"{len(finals)} terminal events")
        if i == 2:
            if finals[0]["type"] != "error":
                raise AssertionError(f"http faults: the poison request "
                                     f"ended {finals[0]['type']}")
        elif finals[0]["type"] != "done" or finals[0]["tokens"] != \
                clean[clean_rids[i]][-1]["tokens"]:
            raise AssertionError(f"http faults: survivor {rid} differs "
                                 f"from the fault-free run")
    if counters["quarantined"] != 1:
        raise AssertionError(f"http faults: counters {counters}")
    records[:] = [r for r in records if r[0] != "llada-8b"]
    log(f"http faults llada-8b: poison request {rids[2]} quarantined with "
        f"one terminal error ({faulted[rids[2]][-1].get('error')}); "
        f"{HTTP_FAULT_PROMPTS - 1} survivors equal the fault-free run; "
        f"{secs:.2f} s; supervision counters {counters}")


def _http_eviction(torch, handle, router, records, np):
    """A budget that holds one model: Hymba's first request makes the
    router build it (on the card's worker) and evict the idle LLaDA.  The
    card's allocated memory must fall by at least LLaDA's weights' bytes
    across the eviction, LLaDA's weights must be gone (a weakref dies)
    and the runner cache must hold only Hymba's runs after its
    request."""
    import dataclasses
    import weakref
    from repro_torch.core import decode_cache_info
    from repro_torch.serving import ServingClient, run_on_worker
    llada_bytes = router.info()["models"]["llada-8b"]["bytes"]
    # the budget is read at each build: room for LLaDA, not for both
    router.rcfg = dataclasses.replace(router.rcfg,
                                      budget_bytes=int(1.1 * llada_bytes))
    ref = run_on_worker(HTTP_DEVICE, lambda: weakref.ref(
        router.touch("llada-8b").params["embed"]["tok"]))
    entries = decode_cache_info().entries
    client = ServingClient(handle.host, handle.port, timeout=900)
    from repro_torch.configs import get_config
    rs = np.random.default_rng(SEED + 13)
    prompt = rs.integers(0, get_config("hymba-1.5b").vocab_size - 1,
                         56).tolist()
    t0 = time.perf_counter()
    events = _stream(client, prompt, model="hymba-1.5b",
                     strategy="probability", gen_length=GEN,
                     block_size=BLOCK, steps=GEN)
    secs = time.perf_counter() - t0
    ev = router.last_eviction
    if events[-1][1]["type"] != "done":
        raise AssertionError(f"http hymba-1.5b: {events[-1][1]}")
    if router.resident("llada-8b") or ev is None or \
            ev["name"] != "llada-8b":
        raise AssertionError(f"http eviction: LLaDA not evicted ({ev})")
    freed = ev["allocated_before"] - ev["allocated_after"]
    after = decode_cache_info().entries
    log(f"http eviction: building hymba-1.5b evicted llada-8b "
        f"({ev['weights_bytes']} bytes of weights): "
        f"torch.cuda.memory_allocated {ev['allocated_before']} -> "
        f"{ev['allocated_after']} bytes (freed {freed}); runner-cache "
        f"entries {entries} -> {after}; hymba's first request (build "
        f"included) {secs:.2f} s")
    if freed < ev["weights_bytes"] or ref() is not None or after != 1:
        raise AssertionError(f"http eviction did not free LLaDA: freed "
                             f"{freed} of {ev['weights_bytes']} bytes, "
                             f"weights alive {ref() is not None}, cache "
                             f"entries {after}")
    batches = [b for name, b in records if name == "hymba-1.5b"]
    del records[:]
    _redecode_batches(torch, router, "hymba-1.5b", batches,
                      {events[-1][1]["rid"]: events[-1][1]["tokens"]})


def _http_drain(handle, threading, np):
    """A drain while requests are in flight on Hymba: new submits answer
    503 with Retry-After during it, and every open stream ends with
    exactly one terminal event (``done`` or ``shutdown``)."""
    import asyncio
    from repro_torch.configs import get_config
    from repro_torch.serving import ServerError, ServingClient
    client = ServingClient(handle.host, handle.port, timeout=900,
                           max_retries=0)
    vocab = get_config("hymba-1.5b").vocab_size
    rs = np.random.default_rng(SEED + 14)
    t0 = time.perf_counter()
    rids = [client.generate(rs.integers(0, vocab - 1, 50).tolist(),
                            model="hymba-1.5b", strategy=strategy,
                            gen_length=GEN, block_size=BLOCK, steps=GEN,
                            wait=False)["rid"]
            for strategy in ("fdm", "probability")
            for _ in range(HTTP_DRAIN_REQUESTS // 2)]
    streams = {}

    def read(rid):
        streams[rid] = list(ServingClient(handle.host, handle.port,
                                          timeout=900).stream(
            rid, model="hymba-1.5b"))

    readers = [threading.Thread(target=read, args=(r,)) for r in rids]
    for t in readers:
        t.start()
    time.sleep(0.2)                 # the first batch is decoding
    drain = asyncio.run_coroutine_threadsafe(
        handle.server.drain(HTTP_DRAIN_DEADLINE_S), handle._loop)
    for _ in range(100):
        if client.healthz()["status"] == "draining":
            break
        time.sleep(0.01)
    try:
        client.generate([1, 2, 3], model="hymba-1.5b", wait=False)
        refused = None
    except ServerError as e:
        refused = (e.status, e.retry_after)
    drain.result(120)
    for t in readers:
        t.join(timeout=120)
    if any(t.is_alive() for t in readers):
        raise AssertionError("http drain: a stream did not end")
    kinds = {}
    for rid, events in streams.items():
        finals = [e for _, e in events if e.get("final")]
        if len(finals) != 1 or finals[0]["type"] not in ("done",
                                                          "shutdown"):
            raise AssertionError(f"http drain: request {rid} ended with "
                                 f"{finals}")
        kinds[rid] = finals[0]["type"]
    if refused is None or refused[0] != 503 or not refused[1]:
        raise AssertionError(f"http drain: a submit during the drain got "
                             f"{refused}, want 503 with Retry-After")
    log(f"http drain: {time.perf_counter() - t0:.2f} s, deadline "
        f"{HTTP_DRAIN_DEADLINE_S} s with "
        f"{len(rids)} requests in flight or queued; terminal events "
        f"{kinds}; a submit during the drain: {refused[0]} with "
        f"Retry-After {refused[1]}")


# --------------------------------------------------------------------------
# training (phases 7-10)
# --------------------------------------------------------------------------

# the sum testbed: LLaDA's family at benchmarks/common.py's overrides, f32,
# batch 64, up to 600 steps (fewer if the loop would pass TESTBED_BUDGET_S)
TESTBED = dict(num_layers=4, d_model=256, num_heads=4, num_kv_heads=4,
               d_ff=1024)
TESTBED_BATCH, TESTBED_STEPS, TESTBED_BUDGET_S = 64, 600, 60.0
# the reference's own numbers at this task (BENCH_kv_cache.json: its
# trained weights, probability, prompt 128 / gen 128 for the
# forward-equivalents): context for the card's EM, not a gate
REF_KV_EM = {"none": 0.8125, "prefix": 0.875, "dual": 0.875}
# full-width LLaDA-8B training: depth cut 32 -> 4 (f32 masters, gradients
# and AdamW moments cost 16 B a parameter: 128 GB for all 8.0 B, the card
# has 80), B=2, L=512 with the second half of each row maskable
FULL_TRAIN_LAYERS, FULL_TRAIN_B, FULL_TRAIN_L, FULL_TRAIN_STEPS = 4, 2, 512, 4
# flash-gradient shapes, (B, Lq, Lk, H, G, d, window, q_offset, dtype):
# LLaDA-8B's heads in bf16, the f32 testbed's, a GQA band at a q offset
FLASH_GRAD_SHAPES = ((2, 128, 128, 32, 32, 128, 0, 0, "bfloat16"),
                     (TESTBED_BATCH, 11, 11, 4, 4, 64, 0, 0, "float32"),
                     (2, 64, 256, 32, 8, 128, 32, 64, "bfloat16"),
                     (2, 64, 256, 32, 8, 128, 32, 64, "float32"))


def _rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def flash_grad_phase(torch, fa_mod, conf_mod, scan_mod) -> dict:
    """dq, dk, dv through the flash kernel's ``autograd.Function`` against
    autograd of the plain version on the card, at ``FLASH_GRAD_SHAPES``
    (max abs error within 1e-4 of the largest gradient in f32, 2e-2 in
    bf16); the other two kernels must raise under grad.  Then, at the
    full-width training shape (B=2, L=512, LLaDA-8B's heads, bf16): the
    backward's device ms (``attention_backward``), the kernel's forward,
    the plain version's forward + backward and SDPA's (a yardstick),
    and the backward's bound.  Returns those numbers."""
    import torch.nn.functional as F
    for b, lq, lk, h, g, d, w, qo, dt in FLASH_GRAD_SHAPES:
        q, k, v, _, _ = attn_inputs(torch, b, lq, lk, h, g, d, w, qo, dt)
        dout = torch.randn_like(q)
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        got = torch.autograd.grad(fa_mod.flash_attention(*ins, w, qo), ins,
                                  dout)
        ref_ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        want = torch.autograd.grad(fa_mod.attention_ref(*ref_ins, w, qo),
                                   ref_ins, dout)
        errs = [_rel_err(a, b_) for a, b_ in zip(got, want)]
        tol = 2e-2 if dt == "bfloat16" else 1e-4
        log(f"flash gradient B={b} Lq={lq} Lk={lk} H={h} G={g} d={d} "
            f"window={w} q_offset={qo} {dt}: dq/dk/dv max abs error over "
            f"max |g| {errs} (tolerance {tol})")
        if max(errs) > tol or any(a.dtype != q.dtype for a in got):
            raise AssertionError(f"flash gradient off at "
                                 f"{(b, lq, lk, h, g, d, w, qo, dt)}: "
                                 f"{errs}")
    for name, call in (
            ("confidence_fused", lambda: conf_mod.confidence_fused(
                torch.randn(4, 1000, device="cuda", requires_grad=True))),
            ("selective_scan", lambda: scan_mod.selective_scan(
                *[t.requires_grad_(True) if i == 0 else t for i, t in
                  enumerate(scan_inputs(torch, 1, 16, 32, 4,
                                        "float32"))]))):
        try:
            call()
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
            log(f"{name} under grad on the card raises: {e}")
        else:
            raise AssertionError(f"{name} returned a result without a "
                                 f"gradient path under grad")
    b, l, h, d = FULL_TRAIN_B, FULL_TRAIN_L, 32, 128
    q, k, v, _, _ = attn_inputs(torch, b, l, l, h, h, d, 0)
    dout = torch.randn_like(q)
    out = fa_mod.flash_attention(q, k, v)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    plain_ins = [t.clone().requires_grad_(True) for t in (q, k, v)]

    def plain():
        return torch.autograd.grad(fa_mod.attention_ref(*plain_ins), plain_ins,
                                   dout)

    def sdpa():
        return torch.autograd.grad(F.scaled_dot_product_attention(qt, kt, vt),
                                   (qt, kt, vt), dout.transpose(1, 2))
    r = dict(backward_device_ms=device_ms(lambda: fa_mod.attention_backward(
        q, k, v, out, dout), reps=3, inner=5),
        forward_device_ms=device_ms(lambda: fa_mod.flash_attention(q, k, v)),
        plain_ms=time_ms(plain, reps=3, inner=3),
        library_ms=time_ms(sdpa, reps=3, inner=3))
    # the backward's least time: q, k, v, o, dO read and dq, dk, dv written
    # once (bf16); its recomputed QKᵀ and four more L×L×d products in f32
    nbytes = 8 * q.numel() * q.element_size()
    ops = 5 * 2 * b * h * l * l * d
    r["bound_ms"] = 1e3 * max(nbytes / MEM_BYTES_PER_S, ops / F32_OPS_PER_S)
    log(f"flash backward at the full-width training shape (B={b}, L={l}, "
        f"H={h}, d={d}, bf16): attention_backward on the device alone "
        f"{r['backward_device_ms']:.4f} ms (bound {r['bound_ms']:.4f} ms, "
        f"operations: f32); the kernel's forward "
        f"{r['forward_device_ms']:.4f} ms; the plain version's forward + "
        f"backward {r['plain_ms']:.4f} ms, SDPA's {r['library_ms']:.4f} ms "
        f"(call to call)")
    return r


def _testbed(torch):
    """The sum testbed's config and dataset."""
    from repro_torch.configs import get_config
    from repro_torch.data import CharTokenizer, TaskDataset
    cfg = get_config("llada-8b").reduced(**TESTBED)
    return cfg, TaskDataset("sum", CharTokenizer(cfg.vocab_size))


def train_step_phase(torch) -> None:
    """One f32 train step of the testbed on the card against the same
    step on the CPU: same params, batch and corruption.  Loss within rel
    1e-5, every gradient leaf's max abs error within 1e-4 of its max |g|,
    and the updated params within two f32 spacings plus 1e-2 of the
    step's learning rate wherever the gradient lies above that tolerance
    (the first update is lr·ĝ/(|ĝ| + eps) with ĝ the clipped gradient,
    so a gradient within the tolerance of zero may step either way, and
    one near eps moves its step by up to ~1e-3·lr per 1e-6 of gradient
    noise)."""
    import numpy as np
    from repro_torch.configs import TrainConfig
    from repro_torch.convert import to_flat
    from repro_torch.models import init_model
    from repro_torch.training import adamw_init, make_train_step
    from repro_torch.training.trainer import corrupt, masters, to_device_batch
    cfg, ds = _testbed(torch)
    tcfg = TrainConfig(batch_size=TESTBED_BATCH, seq_len=ds.seq_len,
                       steps=TESTBED_STEPS)
    batch = to_device_batch(next(ds.batches(TESTBED_BATCH)), "cpu")
    corruption = corrupt(torch.Generator().manual_seed(SEED),
                         batch["tokens"], batch["maskable"], cfg)
    init = init_model(cfg, torch.Generator().manual_seed(SEED), device="cpu")
    step = make_train_step(cfg, tcfg)
    out = {}
    for dev in ("cpu", "cuda"):
        params = masters(_to(init) if dev == "cuda" else init)
        on_dev = ({k: v.to(dev) for k, v in batch.items()},
                  tuple(c.to(dev) for c in corruption))
        grads, met = step.grads(params, *on_dev)
        g = {k: v.copy() for k, v in to_flat(grads).items()}
        params, _, _ = step.apply(params, adamw_init(params), *on_dev)
        out[dev] = float(met["loss"]), g, to_flat(params)
    before = to_flat(init)
    lr = step.sched(1)
    (cpu_loss, cpu_g, cpu_p), (gpu_loss, gpu_g, gpu_p) = out["cpu"], \
        out["cuda"]
    g_err = {k: float(np.abs(gpu_g[k] - v).max() / np.abs(v).max())
             for k, v in cpu_g.items()}
    p_err, bad = {}, []
    for k, g in cpu_g.items():
        sure = np.abs(g) > 1e-4 * np.abs(g).max()
        off = np.abs((gpu_p[k] - before[k]) - (cpu_p[k] - before[k]))
        off = (off - 2 * np.spacing(np.abs(before[k])))[sure]
        p_err[k] = float(off.max() / lr) if off.size else 0.0
        if p_err[k] > 1e-2:
            bad.append(k)
    log(f"train step card vs cpu (testbed f32, B={TESTBED_BATCH}, "
        f"L={ds.seq_len}): loss {gpu_loss} / {cpu_loss}; gradient max abs "
        f"error over max |g|, worst leaf {max(g_err.values()):.3e} "
        f"({max(g_err, key=g_err.get)}); updated params beyond two f32 "
        f"spacings, in units of lr = {lr:.3e}: worst leaf "
        f"{max(p_err.values()):.3e} ({max(p_err, key=p_err.get)}); off "
        f"the rule in {bad or 'no'} leaves")
    if abs(gpu_loss - cpu_loss) > 1e-5 * abs(cpu_loss) or \
            max(g_err.values()) > 1e-4 or bad:
        raise AssertionError("the card's train step differs from the CPU's")


def testbed_phase(torch) -> None:
    """The sum testbed trained on the card (``train``, f32, batch 64, up to
    600 steps), then decoded on these weights: ``fdm`` on
    ``eval_batch(64)`` under ``none``, ``prefix`` and ``dual`` on the
    graph drivers, tokens equal to a CPU decode of the same weights, EM
    and forward-equivalents; then FDM-A's strategy A/B (graph against
    eager, phase counts and step replays)."""
    import dataclasses
    from repro_torch.configs import DecodeConfig, TrainConfig
    from repro_torch.core import Decoder, decode_cache_scope
    from repro_torch.training import train
    cfg, ds = _testbed(torch)
    probe = TrainConfig(batch_size=TESTBED_BATCH, seq_len=ds.seq_len,
                        steps=20, log_every=10)
    _, hist = train(cfg, probe, ds.batches(TESTBED_BATCH), log=None)
    per_step = (hist["seconds"][-1] - hist["seconds"][1]) / 10
    steps = min(TESTBED_STEPS, int(TESTBED_BUDGET_S / per_step))
    tcfg = TrainConfig(batch_size=TESTBED_BATCH, seq_len=ds.seq_len,
                       steps=steps, log_every=max(steps // 5, 1))
    t0 = time.perf_counter()
    params, hist = train(cfg, tcfg, ds.batches(TESTBED_BATCH), log=None)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    log(f"testbed training on the card ({cfg.name}, {steps} of "
        f"{TESTBED_STEPS} steps, batch {TESTBED_BATCH}, L={ds.seq_len}, "
        f"f32): loss at steps {hist['step']}: "
        f"{[round(x, 4) for x in hist['loss']]}, masked-acc "
        f"{[round(x, 3) for x in hist['acc']]}; {total:.2f} s, "
        f"{1e3 * total / steps:.2f} ms/step")
    if not hist["loss"][-1] < 0.7 * hist["loss"][0]:
        raise AssertionError(f"testbed training did not lower the loss: "
                             f"{hist['loss']}")
    cpu_params = _to(params, "cpu")
    batch = ds.eval_batch(64)
    prompt = torch.from_numpy(ds.prompts_only(batch)).long()
    gen = ds.seq_len - prompt.shape[1]
    block = gen if gen <= 16 else max(gen // 2, 1)   # evaluate_strategy's
    for policy in POLICIES:
        dcfg = DecodeConfig(gen_length=gen, block_size=block, steps=gen,
                            strategy="fdm", k=2, cache_policy=policy)
        with decode_cache_scope():
            t0 = time.perf_counter()
            out, st = Decoder(params, cfg, dcfg).generate(None, prompt.cuda())
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        want, wst = Decoder(cpu_params, cfg, dcfg, device="cpu").generate(
            None, prompt)
        same = torch.equal(out.cpu(), want) and \
            (st.steps, st.forward_equivalents, st.phase_counts) == \
            (wst.steps, wst.forward_equivalents, wst.phase_counts)
        em = ds.exact_match(out.cpu().numpy(), batch)
        log(f"testbed decode fdm {policy} (graph driver, 64 prompts, gen "
            f"{gen}, block {block}): EM {em}, steps {st.steps}, "
            f"forward_equivalents {st.forward_equivalents}, {secs:.3f} s "
            f"(cold); card tokens equal the CPU's: {same}; the reference's "
            f"BENCH_kv_cache.json (other weights, probability, for context "
            f"only): EM {REF_KV_EM[policy]}, forward-equivalents "
            f"{KV_FWD[policy]} at prompt {KV_PROMPT} gen {KV_GEN}")
        if not same:
            raise AssertionError(f"testbed fdm {policy}: the card's decode "
                                 f"differs from the CPU's")
    dcfg = DecodeConfig(gen_length=gen, block_size=block, steps=gen,
                        strategy="fdm_a", k1=2)
    with decode_cache_scope() as scope:
        decs = {"eager": Decoder(params, cfg, dataclasses.replace(
            dcfg, fused_loop=False)), "graph": Decoder(params, cfg, dcfg)}
        decs["graph"].generate(None, prompt.cuda())
        (run,) = scope.values()
        run.graphs.reset_counts()
        secs, outs = {"eager": [], "graph": []}, {}
        for driver in ("eager", "graph", "graph", "eager"):
            t0 = time.perf_counter()
            out, st = decs[driver].generate(None, prompt.cuda())
            torch.cuda.synchronize()
            secs[driver].append(time.perf_counter() - t0)
            outs[driver] = (out, (st.steps, st.forward_equivalents,
                                  st.phase_counts))
        replays = run.graphs.replays() / 2
    same = torch.equal(outs["graph"][0], outs["eager"][0]) and \
        outs["graph"][1] == outs["eager"][1]
    med = {d: statistics.median(x) for d, x in secs.items()}
    steps_, fwd, phases = outs["eager"][1]
    log(f"testbed strategy a/b fdm_a (trained weights, 64 prompts, gen "
        f"{gen}): steps {steps_}, forward_equivalents {fwd}, phases "
        f"{phases}; eager {med['eager']:.4f} s, graph {med['graph']:.4f} s "
        f"({replays:.0f} step replays per request), graph at "
        f"{med['eager'] / med['graph']:.3f}x the eager driver's tokens/s; "
        f"EM {ds.exact_match(outs['graph'][0].cpu().numpy(), batch)}; "
        f"graph equals eager: {same}")
    if not same:
        raise AssertionError("testbed fdm_a: graph decode differs from eager")



def full_train_phase(torch, fa_mod) -> dict:
    """Full-width LLaDA-8B (4 of its 32 layers, bf16 compute, f32 masters,
    ``remat="block"``) trained for ``FULL_TRAIN_STEPS`` steps through
    ``train`` on seeded random tokens.  The flash launch count is set to
    0 just before and read just after: exactly 2 × layers per step (the
    forward and the checkpoint's recomputation; the backward launches
    none).  Prints ms/step, tokens/s, peak memory and the first loss
    (≈ ln V at random init).  Returns the path's launches."""
    import dataclasses
    import math
    import numpy as np
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.training import train
    cfg = dataclasses.replace(get_config("llada-8b"),
                              num_layers=FULL_TRAIN_LAYERS)
    rs = np.random.default_rng(SEED)

    def batches():
        maskable = np.zeros((FULL_TRAIN_B, FULL_TRAIN_L), bool)
        maskable[:, FULL_TRAIN_L // 2:] = True
        while True:
            yield {"tokens": rs.integers(0, cfg.vocab_size - 1,
                                         (FULL_TRAIN_B, FULL_TRAIN_L)),
                   "maskable": maskable}
    tcfg = TrainConfig(batch_size=FULL_TRAIN_B, seq_len=FULL_TRAIN_L,
                       steps=FULL_TRAIN_STEPS, log_every=1, seed=SEED)
    # the first step's loss carries the 1/t weight (1/mean t over the
    # batch's masked positions), so the initial weights' plain masked NLL
    # is read apart, from the same seeded init: ≈ ln V + ½ (unit-RMS
    # hidden states against a head of std d^-½ give logits of variance 1)
    nll = initial_nll(torch, cfg, next(batches()))
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa_mod.launches = 0
    t0 = time.perf_counter()
    params, hist = train(cfg, tcfg, batches(), log=None)
    launches = {"flash_attention": fa_mod.launches}
    total = time.perf_counter() - t0
    n = count_params(params)
    step_s = [float(x) for x in np.diff(hist["seconds"])]   # steps 2..
    ms = 1e3 * statistics.median(step_s)
    log(f"full-width training {cfg.name} ({cfg.num_layers} of 32 layers, "
        f"d={cfg.d_model}, {cfg.num_heads} heads, d_ff={cfg.d_ff}, "
        f"V={cfg.vocab_size}, {cfg.dtype}, remat {cfg.remat}; {n} "
        f"parameters, f32 masters; B={FULL_TRAIN_B}, L={FULL_TRAIN_L}): "
        f"{FULL_TRAIN_STEPS} steps in {total:.2f} s with init; losses "
        f"{[round(x, 4) for x in hist['loss']]} (ln V = "
        f"{math.log(cfg.vocab_size):.4f}); step ms "
        f"{[round(1e3 * x, 2) for x in step_s]}, median {ms:.2f} ms, tokens/s "
        f"{FULL_TRAIN_B * FULL_TRAIN_L / (ms / 1e3):.1f}; peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, reserved "
        f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB; flash "
        f"launches {launches['flash_attention']} "
        f"({launches['flash_attention'] / FULL_TRAIN_STEPS:.0f} per step); "
        f"{nvidia_smi()}")
    log(f"full-width training: initial masked NLL {nll:.4f} (ln V + 1/2 = "
        f"{math.log(cfg.vocab_size) + 0.5:.4f}); first weighted loss "
        f"{hist['loss'][0]:.4f}")
    train_step_profile(torch, cfg, tcfg, params, next(batches()))
    want = 2 * cfg.num_layers * FULL_TRAIN_STEPS
    if launches["flash_attention"] != want:
        raise AssertionError(f"full-width training: {launches} flash "
                             f"launches, want {want}")
    if not all(math.isfinite(x) for x in hist["loss"]) or \
            abs(nll - math.log(cfg.vocab_size) - 0.5) > 0.5:
        raise AssertionError(f"full-width training: initial NLL {nll}, "
                             f"losses {hist['loss']}")
    return launches


# kernel groups of a training step's device profile (first match wins)
TRAIN_GROUPS = {"GEMMs (cuBLAS)": ("gemm", "xmma", "nvjet", "cutlass"),
                "foreach (AdamW moments, clip scale)":
                    ("multi_tensor_apply",),
                "flash forward (hand-written)": ("flash_",),
                "softmax": ("softmax",),
                "reductions": ("reduce_kernel",),
                "index, gather, scatter": ("index", "gather", "scatter"),
                "elementwise": ("elementwise",)}


def train_step_profile(torch, cfg, tcfg, params, batch) -> None:
    """Where a full-width training step's device time goes: the trained
    params as masters with fresh AdamW state, two profiled steps after
    two warm ones, kernels grouped by ``TRAIN_GROUPS``."""
    from repro_torch.training import adamw_init, make_train_step
    from repro_torch.training.trainer import masters, to_device_batch
    state = {"p": masters(params)}
    state["opt"] = adamw_init(state["p"])
    step = make_train_step(cfg, tcfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    batch = to_device_batch(batch, "cuda")

    def one():
        state["p"], state["opt"], _ = step(state["p"], state["opt"], gen,
                                           batch)
    device_profile(torch, f"{cfg.name} ({cfg.num_layers} layers) training "
                   f"step B={FULL_TRAIN_B} L={FULL_TRAIN_L}", one, top=10,
                   groups=TRAIN_GROUPS)


def initial_nll(torch, cfg, batch) -> float:
    """The mean NLL over ``batch``'s maskable positions, all masked, of
    the weights ``train`` starts from (``init_model`` on the card from
    ``SEED``, f32), under ``no_grad``."""
    from repro_torch.core.loss import masked_cross_entropy
    from repro_torch.models import forward, init_model
    params = init_model(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                        device="cuda", dtype=torch.float32)
    tokens = torch.from_numpy(batch["tokens"]).cuda()
    masked = torch.from_numpy(batch["maskable"]).cuda()
    with torch.no_grad():
        logits = forward(params, torch.where(masked, cfg.mask_token_id,
                                             tokens), cfg)
        loss, _ = masked_cross_entropy(logits, tokens, masked,
                                       torch.ones(len(tokens),
                                                  device="cuda"))
    return float(loss)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import confidence as conf_mod
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import selective_scan as scan_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = nvidia_smi()
    log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
        f"torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"python {sys.version.split()[0]}")

    # 2. build
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.last_build['seconds']:.2f} s)")
    # no spills allowed in the bf16 attention kernels at d=64 and d=128,
    # in both scan passes at NP=16 (Hymba's N) and in both confidence
    # kernels (at most 64 registers: four CTAs per SM)
    no_spill = (r"tc::flash_tc_kernel<(64|128)>|sscan_chunk_kernel<16,[01]>"
                r"|confidence_kernel<(float|bf16)>")
    for name, text in _build.last_build["ptxas"].items():
        report = ptxas_report(text)
        for fn, rep in report.items():
            log(f"  ptxas {name} {fn}: {rep}")
            if re.fullmatch(no_spill, fn) and (
                    rep.get("spill_stores") or rep.get("spill_loads")):
                raise AssertionError(f"ptxas spills in {fn}: {rep}")
        if name == "selective_scan" and not any(
                re.fullmatch(no_spill, fn) for fn in report):
            raise AssertionError(f"no NP=16 scan kernel in the ptxas "
                                 f"report: {sorted(report)}")
        if name == "confidence" and sum(
                fn.startswith("confidence_kernel<") for fn in report) != 2:
            raise AssertionError(f"not one confidence kernel per dtype in "
                                 f"the ptxas report: {sorted(report)}")
    mma = sass_mma_counts(libs["flash_attention"])
    tc_counts = {fn: n for fn, n in mma.items() if "flash_tc_kernel" in fn}
    log(f"sass flash_attention: HMMA/HGMMA per kernel: "
        f"{json.dumps(mma, sort_keys=True)}")
    if len(tc_counts) != 8 or not all(tc_counts.values()):
        raise AssertionError(f"the bf16 attention kernels are not all on "
                             f"the tensor cores: {tc_counts}")

    # 3. kernels against their plain versions, main-path shapes
    conf_errs = []
    for rows, vocab, dtype in CONF_SHAPES:
        r = check_confidence(conf_mod, torch, rows, vocab, dtype)
        conf_errs.append(r["max_abs_err"])
        log(f"confidence rows={rows} V={vocab} {dtype}: max_abs_err "
            f"{r['max_abs_err']} kernel {r['ms']:.4f} ms, on the device "
            f"alone {r['device_ms']:.4f} ms; plain {r['plain_ms']:.4f} ms "
            f"bound {r['bound_ms']:.4f} ms (bytes); share of the bound on "
            f"the device alone {r['bound_ms'] / r['device_ms']:.3f}")
        if (rows, vocab, dtype) == CONF_SHAPES[0]:
            conf_entry = r
    conf_entry["max_abs_err"] = max(conf_errs)
    attn_errs = []
    attn_runs = [(shape, "bfloat16") for shape in ATTN_SHAPES] + \
        [(shape, "float32") for shape in ATTN_F32]
    for (b, lq, lk, h, g, d, w, qo), dt in attn_runs:
        r = check_attention(fa_mod, torch, b, lq, lk, h, g, d, w, qo, dt)
        attn_errs.append(r["max_abs_err"])
        log(f"attention B={b} Lq={lq} Lk={lk} H={h} G={g} d={d} window={w} "
            f"q_offset={qo} {dt}: max_abs_err {r['max_abs_err']} kernel "
            f"{r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms sdpa "
            f"{r['library_ms']:.4f} ms (kernel/sdpa "
            f"{r['ms'] / r['library_ms']:.3f}); on the device alone kernel "
            f"{r['device_ms']:.4f} ms sdpa {r['library_device_ms']:.4f} ms "
            f"(kernel/sdpa {r['device_ms'] / r['library_device_ms']:.3f}); "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        if ((b, lq, lk, h, g, d, w, qo), dt) == attn_runs[0]:
            attn_entry = r
    attn_entry["max_abs_err"] = max(attn_errs)
    scan_errs = []
    for b, l, di, n, xdt in SCAN_SHAPES:
        r = check_scan(scan_mod, torch, b, l, di, n, xdt)
        scan_errs.append(r["max_abs_err"])
        log(f"selective_scan B={b} L={l} di={di} N={n} x {xdt}, f32 "
            f"delta/B/C: max_abs_err {r['max_abs_err']} kernel "
            f"{r['ms']:.4f} ms, on the device alone {r['device_ms']:.4f} "
            f"ms; plain {r['plain_ms']:.4f} ms library none bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), two-pass exp "
            f"floor {r['design_floor_ms']:.4f} ms")
        if (b, l) == (MAX_BATCH, CANVAS):
            scan_entry = r
    scan_entry["max_abs_err"] = max(scan_errs)

    # 4. end-to-end agreement with the CPU reference on small configs
    t0 = time.perf_counter()
    reference_phase(torch, "llada-8b", REFERENCE_POLICIES)
    reference_phase(torch, "hymba-1.5b", ["none"])
    log(f"reference phase: {time.perf_counter() - t0:.1f} s")

    # 5. the main paths, one model at a time (each frees its weights and
    # its graphs); 6. the KV A/B on LLaDA's weights
    from repro_torch.core import clear_decode_cache, decode_cache_scope
    t0 = time.perf_counter()
    cfg, params = make_model(torch, "llada-8b")
    mods = {"confidence": conf_mod, "flash_attention": fa_mod}
    llada = {}
    for policy in POLICIES:              # a runner cache for each path
        with decode_cache_scope() as scope:
            llada[policy] = serving_phase(torch, cfg, params, mods, scope,
                                          policy)
    del scope
    memory_phase(torch, cfg, params)
    forward_phase(torch, cfg, params)
    log(f"serving phase llada-8b: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kv_ab_phase(torch, cfg, params, mods)
    strategy_ab_phase(torch, cfg, params)
    log(f"kv a/b phase llada-8b: {time.perf_counter() - t0:.1f} s")
    clear_decode_cache()
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg, params = make_model(torch, "hymba-1.5b")
    with decode_cache_scope() as scope:
        hymba = serving_phase(torch, cfg, params, {
            "confidence": conf_mod, "flash_attention": fa_mod,
            "selective_scan": scan_mod}, scope)
    forward_phase(torch, cfg, params)
    log(f"serving phase hymba-1.5b: {time.perf_counter() - t0:.1f} s")
    clear_decode_cache()
    del params
    torch.cuda.empty_cache()

    # 7.-10. training: the flash gradient, one step against the CPU, the
    # testbed trained and decoded, full-width LLaDA-8B's steps
    t0 = time.perf_counter()
    flash_grad = flash_grad_phase(torch, fa_mod, conf_mod, scan_mod)
    log(f"flash gradient phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_step_phase(torch)
    log(f"train step phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    testbed_phase(torch)
    clear_decode_cache()
    log(f"testbed phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    training = full_train_phase(torch, fa_mod)
    log(f"full-width training phase: {time.perf_counter() - t0:.1f} s")
    clear_decode_cache()
    torch.cuda.empty_cache()

    # 11. the async serving stack over HTTP
    http = http_phase(torch, {"confidence": conf_mod,
                              "flash_attention": fa_mod,
                              "selective_scan": scan_mod})

    def launches(kernel):
        by_path = {"llada-8b" + ("" if p == "none" else f"-{p}"):
                   llada[p].get(kernel, 0) for p in POLICIES}
        by_path["hymba-1.5b"] = hymba[kernel]
        by_path["llada-8b-train"] = training.get(kernel, 0)
        by_path["llada-8b-http"] = http.get(kernel, 0)
        return {"launches": sum(by_path.values()),
                "launches_by_path": by_path}

    kernels = [
        {"name": "confidence", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/confidence.cu",
         "replaces": "src/repro/kernels/confidence.py:102",
         **launches("confidence"),
         "max_abs_err": conf_entry["max_abs_err"], "ms": conf_entry["ms"],
         "plain_ms": conf_entry["plain_ms"],
         "bound_ms": conf_entry["bound_ms"], "bound_by": "bytes",
         "library_ms": None, "device_ms": conf_entry["device_ms"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:83",
         **launches("flash_attention"),
         "max_abs_err": attn_entry["max_abs_err"], "ms": attn_entry["ms"],
         "plain_ms": attn_entry["plain_ms"],
         "bound_ms": attn_entry["bound_ms"],
         "bound_by": attn_entry["bound_by"],
         "library_ms": attn_entry["library_ms"],
         "device_ms": attn_entry["device_ms"],
         "library_device_ms": attn_entry["library_device_ms"],
         "backward": flash_grad},
        {"name": "selective_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/selective_scan.cu",
         "replaces": "src/repro/kernels/selective_scan.py:67",
         **launches("selective_scan"),
         "max_abs_err": scan_entry["max_abs_err"], "ms": scan_entry["ms"],
         "plain_ms": scan_entry["plain_ms"],
         "bound_ms": scan_entry["bound_ms"],
         "bound_by": scan_entry["bound_by"], "library_ms": None,
         "device_ms": scan_entry["device_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
