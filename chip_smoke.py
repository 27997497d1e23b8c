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
             weights and requires identical tokens, steps and
             forward-equivalents; LLaDA also under the cache policies
             ``prefix``, ``dual`` and ``prefix`` without refreshes;
5. serving — full-width, full-depth LLaDA-8B, then Hymba-1.5B (random
             bf16 weights from a seed; LLaDA's are freed first) behind
             ``ServingEngine``: mixed prompt lengths, strategies fdm, fdm_a
             and probability; checks results and stats, and that every
             kernel of the model's path was launched in its run (for
             Hymba, one selective scan per flash-attention call).  LLaDA
             serves the same requests on the same weights under the cache
             policies ``none``, ``prefix`` and ``dual``, one path each,
             with each batch's forward-equivalents held to its strategy's
             count (fdm, probability) or range (fdm_a);
6. KV A/B  — (between LLaDA's serving and Hymba's) one B=2 request at the
             reference's ``BENCH_kv_cache.json`` geometry (prompt 128,
             gen 128, block 32, probability) on full-width LLaDA-8B under
             each policy: seconds, and forward-equivalents of exactly 128,
             68 and 20; one full, one ``prefix`` and one ``dual`` window
             forward on the card's clock against host enqueue time
             (interleaved), each with a capture by its kernels on the card
             (``torch.profiler``), and the forwards by where the host's
             time goes (cProfile).

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
# the KV A/B phase: the reference's BENCH_kv_cache.json geometry and counts
KV_PROMPT, KV_GEN, KV_BLOCK = 128, 128, 32
KV_FWD = {"none": 128.0, "prefix": 68.0, "dual": 20.0}
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


def _to_cuda(tree):
    if isinstance(tree, dict):
        return {k: _to_cuda(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cuda(v) for v in tree]
    return tree.cuda()


# the reference phase's decodes: every config uncached, and LLaDA under
# each cache policy
REFERENCE_CASES = [dict(strategy="fdm", gamma=0.0), dict(strategy="fdm_a"),
                   dict(strategy="probability"), dict(strategy="eb")]
CACHED_REFERENCE_CASES = [
    dict(strategy=s, cache_policy=p, cache_refresh=r, **g)
    for p, r in (("prefix", "block"), ("dual", "block"), ("prefix", "off"))
    for s, g in (("fdm", dict(gamma=0.0)), ("fdm_a", {}),
                 ("probability", {}))]


def reference_phase(torch, name: str, cases):
    """The port on the card (kernels, f32) against the port on the CPU
    (plain versions) on a reduced config: same weights, same prompts,
    identical decodes required, forward-equivalents exactly equal."""
    from repro_torch.configs import DecodeConfig, get_config
    from repro_torch.core import Decoder
    from repro_torch.models import init_model
    cfg = get_config(name).reduced()
    cpu_params = init_model(cfg, torch.Generator().manual_seed(SEED),
                            device="cpu")
    gpu_params = _to_cuda(cpu_params)
    gen = torch.Generator().manual_seed(SEED)
    prompt = torch.randint(0, cfg.vocab_size - 1, (2, 16), generator=gen)
    for kw in cases:
        dcfg = DecodeConfig(gen_length=32, block_size=16, steps=32, **kw)
        x_cpu, s_cpu = Decoder(cpu_params, cfg, dcfg,
                               device="cpu").generate(None, prompt)
        x_gpu, s_gpu = Decoder(gpu_params, cfg, dcfg,
                               device="cuda").generate(None, prompt)
        same = torch.equal(x_cpu, x_gpu.cpu())
        log(f"reference {name} {kw}: tokens equal={same} steps "
            f"{s_cpu.steps}/"
            f"{s_gpu.steps} forward_equivalents {s_cpu.forward_equivalents}"
            f"/{s_gpu.forward_equivalents}")
        if not same or s_cpu.steps != s_gpu.steps or \
                s_cpu.forward_equivalents != s_gpu.forward_equivalents:
            raise AssertionError(f"card decode of {name} differs from "
                                 f"the CPU reference for {kw}")


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


def serving_phase(torch, cfg, params, mods: dict, policy: str = "none"):
    """Serve ``REQUESTS`` on ``params`` under ``policy``: one main path.
    ``mods`` maps each kernel of the path to its module, whose launch
    count is set to 0 just before the run and read just after.  Returns
    those counts."""
    import numpy as np
    from repro_torch.configs import DecodeConfig
    from repro_torch.serving import ServingEngine
    name = f"{cfg.name}" + ("" if policy == "none" else f"-{policy}")
    dcfg = DecodeConfig(gen_length=GEN, block_size=BLOCK, steps=GEN,
                        strategy="fdm", k=K, k1=K, cache_policy=policy)
    batches = []
    engine = ServingEngine(params, cfg, dcfg, max_batch=MAX_BATCH,
                           seed=SEED, on_block_committed=lambda reqs, blk, *_:
                           batches.append([r.rid for r in reqs])
                           if blk == 0 else None)
    rs = np.random.default_rng(SEED)
    rids = {}
    for lp, strat in REQUESTS:
        prompt = rs.integers(0, cfg.vocab_size - 1, lp).astype(np.int64)
        rids[engine.submit(prompt, strategy=strat)] = (lp, strat)

    for mod in mods.values():
        mod.launches = 0
    t0 = time.perf_counter()
    engine.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: mod.launches for k, mod in mods.items()}
    log(f"serving {name}: {len(rids)} requests in {len(batches)} batches, "
        f"{wall:.2f} s; kernel launches {launches}")
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
                   top: int = 6) -> None:
    """The card's kernels in ``reps`` calls of ``fn`` after warm-up, from
    ``torch.profiler`` (device activity only: host events would slow the
    trace's processing by seconds): per call the synchronised wall time,
    the summed kernel time, the kernel count, the share of the wall the
    card was busy, and the ``top`` kernels by device time."""
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


def kv_ab_phase(torch, cfg, params) -> None:
    """One B=2 request at the reference's ``BENCH_kv_cache.json`` geometry
    under each cache policy, through ``Decoder.generate``: seconds and
    forward-equivalents (exactly 128, 68 and 20 required).  Then on the
    last canvas: one full forward, one window forward per cached policy
    and one cache capture, on the card's clock against host enqueue time,
    by their kernels on the card (``torch.profiler``), and where the
    host's time goes in each forward (cProfile)."""
    from repro_torch.configs import DecodeConfig
    from repro_torch.core import Decoder
    from repro_torch.models import capture_cache, forward, forward_cached
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    prompt = torch.randint(0, cfg.vocab_size - 1, (2, KV_PROMPT),
                           generator=gen, device="cuda")
    total = KV_PROMPT + KV_GEN
    for policy in POLICIES:
        dcfg = DecodeConfig(gen_length=KV_GEN, block_size=KV_BLOCK,
                            steps=KV_GEN, strategy="probability",
                            cache_policy=policy)
        t0 = time.perf_counter()
        out, st = Decoder(params, cfg, dcfg).generate(None, prompt)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        log(f"kv a/b {cfg.name} {policy}: prompt {KV_PROMPT} gen {KV_GEN} "
            f"block {KV_BLOCK} B=2 probability: {secs:.3f} s, steps "
            f"{st.steps}, forward_equivalents {st.forward_equivalents}, "
            f"tokens/s {st.tps:.2f}")
        if st.forward_equivalents != KV_FWD[policy] or st.steps != KV_GEN:
            raise AssertionError(f"kv a/b {policy}: {st.steps} steps, "
                                 f"{st.forward_equivalents} forward-"
                                 f"equivalents, want {KV_GEN} and "
                                 f"{KV_FWD[policy]}")
        if (out[:, KV_PROMPT:] == cfg.mask_token_id).any():
            raise AssertionError(f"kv a/b {policy}: masked token left")
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
    reference_phase(torch, "llada-8b",
                    REFERENCE_CASES + CACHED_REFERENCE_CASES)
    reference_phase(torch, "hymba-1.5b", REFERENCE_CASES)
    log(f"reference phase: {time.perf_counter() - t0:.1f} s")

    # 5. the main paths, one model at a time (each frees its weights); 6.
    # the KV A/B on LLaDA's weights
    t0 = time.perf_counter()
    cfg, params = make_model(torch, "llada-8b")
    llada = {}
    for policy in POLICIES:
        llada[policy] = serving_phase(
            torch, cfg, params, {"confidence": conf_mod,
                                 "flash_attention": fa_mod}, policy)
    forward_phase(torch, cfg, params)
    log(f"serving phase llada-8b: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kv_ab_phase(torch, cfg, params)
    log(f"kv a/b phase llada-8b: {time.perf_counter() - t0:.1f} s")
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg, params = make_model(torch, "hymba-1.5b")
    hymba = serving_phase(torch, cfg, params, {
        "confidence": conf_mod, "flash_attention": fa_mod,
        "selective_scan": scan_mod})
    forward_phase(torch, cfg, params)
    log(f"serving phase hymba-1.5b: {time.perf_counter() - t0:.1f} s")

    def launches(kernel):
        by_path = {"llada-8b" + ("" if p == "none" else f"-{p}"):
                   llada[p].get(kernel, 0) for p in POLICIES}
        by_path["hymba-1.5b"] = hymba[kernel]
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
         "library_device_ms": attn_entry["library_device_ms"]},
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
