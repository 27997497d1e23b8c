#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device  — requires CUDA; prints the card's name and power limit;
2. build   — builds the hand-written kernels from ``src/repro_torch/
             kernels/csrc`` (one nvcc per source, in parallel);
3. kernels — holds each kernel against its plain PyTorch version on the
             card at the serving path's shapes and times kernel, plain
             version and, for attention, SDPA (a yardstick only);
4. reference — decodes a reduced LLaDA config on the card (kernels) and on
             the CPU (plain versions) from the same weights and requires
             identical tokens, steps and forward-equivalents;
5. serving — full-width LLaDA-8B (random bf16 weights from a seed) behind
             ``ServingEngine``: mixed prompt lengths, strategies fdm, fdm_a
             and probability; checks results, stats and that both kernels'
             launch counters grew during this phase.

The last lines are a ``{"kernels": [...]}`` JSON line, the card's name
and power limit, and ``{"ok": true, "device": {...}}``.  Imports nothing
of JAX or of the reference package.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
MEM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
BF16_OPS_PER_S = 989e12          # dense tensor-core bf16
F32_OPS_PER_S = 67e12            # f32 outside the tensor cores
# the serving phase's geometry (also the shapes the kernel phase checks)
MAX_BATCH, GEN, BLOCK, K = 2, 64, 32, 2
CANVAS = 64 + GEN                # longest prompt + generation
REQUESTS = [(64, "fdm"), (60, "fdm"), (48, "fdm_a"), (48, "fdm_a"),
            (64, "probability"), (41, "probability")]


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


def check_confidence(conf_mod, torch, rows: int, vocab: int, dtype):
    """Kernel vs plain version; argmax exact, the rest within the
    tolerances of tests/test_kernels.py.  Returns (max_abs_err, ms,
    plain_ms, bound_ms)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + rows)
    x = (5 * torch.randn(rows, vocab, generator=gen, device="cuda")).to(dtype)
    for r in range(0, rows, max(rows // 8, 1)):      # duplicated maxima
        top = x[r].float().max() + 1
        x[r, 3 + r % 7] = top
        x[r, vocab - 5 - r % 11] = top
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
    err = max(float((g - r).abs().max()) for g, r in zip(got[1:], ref[1:]))
    ms = time_ms(lambda: conf_mod.confidence_fused(x))
    plain_ms = time_ms(lambda: conf_mod.confidence_ref(x), reps=3, inner=2)
    nbytes = x.numel() * x.element_size() + rows * 16
    ops = 5 * x.numel()                   # max, sub, exp, add, fma per logit
    bound = 1e3 * max(nbytes / MEM_BYTES_PER_S, ops / F32_OPS_PER_S)
    return err, ms, plain_ms, bound


def check_attention(fa_mod, torch, b, l, h, g, d, window, dtype):
    """Kernel vs plain version (bf16 tolerance 2e-2, as the reference's
    kernel tests).  Returns (max_abs_err, ms, plain_ms, sdpa_ms,
    bound_ms)."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(SEED + l + g + window)
    q = torch.randn(b, l, h, d, generator=gen, device="cuda").to(dtype)
    k = torch.randn(b, l, g, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b, l, g, d, generator=gen, device="cuda").to(dtype)
    got = fa_mod.flash_attention(q, k, v, window)
    torch.cuda.synchronize()
    ref = fa_mod.attention_ref(q, k, v, window)
    torch.testing.assert_close(got.float(), ref.float(), rtol=2e-2,
                               atol=2e-2)
    err = float((got.float() - ref.float()).abs().max())
    ms = time_ms(lambda: fa_mod.flash_attention(q, k, v, window))
    plain_ms = time_ms(lambda: fa_mod.attention_ref(q, k, v, window))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = None
    if window:
        idx = torch.arange(l, device="cuda")
        mask = (idx[:, None] - idx[None, :]).abs() < window
    sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=g != h))
    idx = torch.arange(l)
    pairs = int(((idx[:, None] - idx[None, :]).abs() < window).sum()) \
        if window else l * l
    ops = 4 * b * h * pairs * d
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    bound = 1e3 * max(nbytes / MEM_BYTES_PER_S, ops / BF16_OPS_PER_S)
    return err, ms, plain_ms, sdpa_ms, bound, \
        "bytes" if nbytes / MEM_BYTES_PER_S >= ops / BF16_OPS_PER_S \
        else "operations"


def _to_cuda(tree):
    if isinstance(tree, dict):
        return {k: _to_cuda(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cuda(v) for v in tree]
    return tree.cuda()


def reference_phase(torch):
    """The port on the card (kernels, f32) against the port on the CPU
    (plain versions) on a reduced LLaDA config: same weights, same prompts,
    identical decodes required."""
    from repro_torch.configs import DecodeConfig, get_config
    from repro_torch.core import Decoder
    from repro_torch.models import init_model
    cfg = get_config("llada-8b").reduced()
    cpu_params = init_model(cfg, torch.Generator().manual_seed(SEED),
                            device="cpu")
    gpu_params = _to_cuda(cpu_params)
    gen = torch.Generator().manual_seed(SEED)
    prompt = torch.randint(0, cfg.vocab_size - 1, (2, 16), generator=gen)
    for kw in (dict(strategy="fdm", gamma=0.0), dict(strategy="fdm_a"),
               dict(strategy="probability"), dict(strategy="eb")):
        dcfg = DecodeConfig(gen_length=32, block_size=16, steps=32, **kw)
        x_cpu, s_cpu = Decoder(cpu_params, cfg, dcfg,
                               device="cpu").generate(None, prompt)
        x_gpu, s_gpu = Decoder(gpu_params, cfg, dcfg,
                               device="cuda").generate(None, prompt)
        same = torch.equal(x_cpu, x_gpu.cpu())
        log(f"reference {kw}: tokens equal={same} steps {s_cpu.steps}/"
            f"{s_gpu.steps} forward_equivalents {s_cpu.forward_equivalents}"
            f"/{s_gpu.forward_equivalents}")
        if not same or s_cpu.steps != s_gpu.steps or \
                s_cpu.forward_equivalents != s_gpu.forward_equivalents:
            raise AssertionError(f"card decode differs from the CPU "
                                 f"reference for {kw}")


def serving_phase(torch, conf_mod, fa_mod):
    import numpy as np
    from repro_torch.configs import DecodeConfig, get_config
    from repro_torch.models import init_model
    from repro_torch.serving import ServingEngine
    cfg = get_config("llada-8b")
    t0 = time.perf_counter()
    params = init_model(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                        device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for layer in params["blocks"]
                   for sub in layer.values() for t in sub.values()) + \
        sum(t.numel() for grp in ("embed", "norm_f")
            for t in params[grp].values())
    log(f"serving: llada-8b full width and depth ({cfg.num_layers} layers, "
        f"d={cfg.d_model}, {cfg.num_heads} heads, d_ff={cfg.d_ff}, "
        f"V={cfg.vocab_size}, {cfg.dtype}); {n_params} parameters made in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    dcfg = DecodeConfig(gen_length=GEN, block_size=BLOCK, steps=GEN,
                        strategy="fdm", k=K, k1=K)
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

    conf_mod.launches = 0
    fa_mod.launches = 0
    t0 = time.perf_counter()
    engine.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"confidence": conf_mod.launches,
                "flash_attention": fa_mod.launches}
    log(f"serving: {len(rids)} requests in {len(batches)} batches, "
        f"{wall:.2f} s; kernel launches {launches}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel was not launched on the serving "
                             f"path: {launches}")

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
        want = {"fdm": GEN * (1 + K), "probability": GEN}.get(strat)
        if want is not None and batch_fwd != want:
            raise AssertionError(f"batch {members} ({strat}): "
                                 f"{batch_fwd} forward-equivalents, "
                                 f"want {want}")
        if strat == "fdm_a":
            if not GEN <= batch_fwd <= GEN * (1 + K):
                raise AssertionError(f"fdm_a batch {members}: {batch_fwd}")
            for r in reqs:
                if abs(sum(r.stats.phase_counts.values()) - steps) > 1e-9:
                    raise AssertionError(f"fdm_a request {r.rid}: phase "
                                         f"counts do not sum to steps")
        log(f"batch {members} ({strat}): steps {steps}, "
            f"forward_equivalents {batch_fwd}")
    summary = engine.summary()
    log("serving summary: " + json.dumps(summary))
    log(f"serving decode tokens/s: {summary['decode_tps']}")

    # one forward at the scoring and the K-candidate batch: the span on
    # the card's clock against the host's time to enqueue it
    from repro_torch.models import forward
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for b in (MAX_BATCH, K * MAX_BATCH):
        tokens = torch.randint(0, cfg.vocab_size - 1, (b, CANVAS),
                               generator=gen, device="cuda")
        forward(params, tokens, cfg)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        forward(params, tokens, cfg)
        end.record()
        host_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        log(f"forward B={b} L={CANVAS}: {start.elapsed_time(end):.3f} ms "
            f"on the card's clock, {host_ms:.3f} ms to enqueue on the host")

    # where the host's time goes in one forward (cProfile adds its own
    # per-call cost, so only the shares are meaningful)
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    forward(params, tokens, cfg)
    prof.disable()
    torch.cuda.synchronize()
    rows = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: -kv[1][2])
    total = sum(v[2] for _, v in rows)
    log(f"host profile of one forward B={K * MAX_BATCH}: {1e3 * total:.2f} ms "
        f"of own time in {sum(v[1] for _, v in rows)} calls; top 10:")
    for (path, line, fn), (_, calls, own, _, _) in rows[:10]:
        log(f"  {1e3 * own:8.2f} ms {calls:6d} calls  {fn} "
            f"({os.path.basename(path)}:{line})")
    return launches


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import confidence as conf_mod
    from repro_torch.kernels import flash_attention as fa_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = nvidia_smi()
    log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
        f"torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"python {sys.version.split()[0]}")

    # 2. build
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.last_build['seconds']:.2f} s)")
    for name, text in _build.last_build["ptxas"].items():
        for line in text.splitlines():
            if "registers" in line or "spill stores" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # 3. kernels against their plain versions, main-path shapes
    vocab = 126464
    conf_rows = K * MAX_BATCH * CANVAS
    for rows, dtype in ((conf_rows, torch.float32),
                        (MAX_BATCH * CANVAS, torch.float32),
                        (conf_rows, torch.bfloat16)):
        err, ms, plain, bound = check_confidence(conf_mod, torch, rows,
                                                 vocab, dtype)
        log(f"confidence rows={rows} V={vocab} {dtype}: max_abs_err {err} "
            f"kernel {ms:.4f} ms plain {plain:.4f} ms bound {bound:.4f} ms "
            f"(bytes)")
        if (rows, dtype) == (conf_rows, torch.float32):
            conf_entry = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                              bound_ms=bound)
    attn_errs = []
    for b, h, g, w in ((MAX_BATCH, 32, 32, 0), (K * MAX_BATCH, 32, 32, 0),
                       (MAX_BATCH, 32, 8, 0), (MAX_BATCH, 32, 32, 32)):
        err, ms, plain, sdpa, bound, by = check_attention(
            fa_mod, torch, b, CANVAS, h, g, 128, w, torch.bfloat16)
        attn_errs.append(err)
        log(f"attention B={b} L={CANVAS} H={h} G={g} d=128 window={w} bf16: "
            f"max_abs_err {err} kernel {ms:.4f} ms plain {plain:.4f} ms "
            f"sdpa {sdpa:.4f} ms bound {bound:.4f} ms ({by})")
        if (b, g, w) == (MAX_BATCH, 32, 0):
            attn_entry = dict(ms=ms, plain_ms=plain, library_ms=sdpa,
                              bound_ms=bound, bound_by=by)
    attn_entry["max_abs_err"] = max(attn_errs)

    # 4. end-to-end agreement with the CPU reference on a small config
    reference_phase(torch)

    # 5. the main path
    launches = serving_phase(torch, conf_mod, fa_mod)

    kernels = [
        {"name": "confidence", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/confidence.cu",
         "replaces": "src/repro/kernels/confidence.py:101",
         "launches": launches["confidence"],
         "max_abs_err": conf_entry["max_abs_err"], "ms": conf_entry["ms"],
         "plain_ms": conf_entry["plain_ms"],
         "bound_ms": conf_entry["bound_ms"], "bound_by": "bytes",
         "library_ms": None},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:81",
         "launches": launches["flash_attention"],
         "max_abs_err": attn_entry["max_abs_err"], "ms": attn_entry["ms"],
         "plain_ms": attn_entry["plain_ms"],
         "bound_ms": attn_entry["bound_ms"],
         "bound_by": attn_entry["bound_by"],
         "library_ms": attn_entry["library_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
