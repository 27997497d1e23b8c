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
             kernels' SASS (one kernel per (dqk, dv) pair of
             ``FLASH_HEAD_DIM_PAIRS``: dqk = dv at every multiple of 16 in
             [32, 256], and MLA's (192, 128) and (48, 32)) and requires no
             ptxas spills in them at d=64, 80 and 128 and at (192, 128),
             nor in the selective scan's two passes at N=16; also the
             dense GQA
             family's attention (``ARCH_ATTN_SHAPES``: d=80 in
             bf16 and f32 with a band and a ragged L, Qwen3's 40:8,
             ChatGLM3's 32:2, StableLM-12B's d=160) and confidence at
             Qwen3's V = 151936; and Mixtral-8x22B's (``MOE_ATTN_SHAPES``:
             48:8 at d=128 at the serving batch and over 4160 tokens with
             its band of 4096 live, bf16 and f32; ``MOE_CONF_SHAPES``:
             256 x 32768, f32 and bf16); and DeepSeek-V2's MLA heads
             (``MLA_ATTN_SHAPES``: 128 heads with q/k 192 and v 128 wide,
             at the serving batch, the K-candidate batch, the ``dual``
             window and one 4096-token row, bf16 and f32;
             ``DEEPSEEK_CONF_SHAPES``: 256 x 102400, f32 and bf16); and
             whisper-medium's (``WHISPER_ATTN_SHAPES``: 16 heads at d=64
             over its encoder's 1500 frames at B=2 and at the K-candidate
             fold's B=4, and the cross shape, 128 queries over the 1500
             frames, bf16 and f32; ``WHISPER_CONF_SHAPES``: 256 x 51865,
             f32 and bf16); and qwen2-vl-72b's (``VLM_ATTN_SHAPES``: 64
             heads over 8 at d=128 over 1024 patches + 128 text positions,
             bf16 and f32; ``VLM_CONF_SHAPES``: 256 x 152064) and
             xlstm-125m's confidence (``XLSTM_CONF_SHAPES``: 256 x 50304),
             f32 and bf16; and the sharded training step's
             (``FSDP_ATTN_SHAPES``: f32 at a rank's rows and local heads);
             and the MoE families' under the mesh
             (``MOE_MESH_ATTN_SHAPES``: Mixtral's 12:2 and 24:4 at d=128;
             ``MOE_MESH_MLA_SHAPES``: DeepSeek-V2's MLA at 32 local heads
             in f32 and bf16, at 64 in f32);
             and the decode state's calls
             (``DECODE_ATTN_SHAPES``: flash at Lq = 1 with its valid key
             count read on the card, over LLaDA-8B's 32k cache in bf16
             and f32, Hymba's 25:5 over its 1024-slot ring and Qwen3-14B's
             40:8 over 32k; ``SCAN_STATE_SHAPES``: the scan from an
             initial state h0 with its end state out; ``SERVE_CONF_SHAPES``:
             confidence at the serve step's 2 rows);
4. reference — decodes reduced LLaDA and Hymba configs on the card
             (kernels) and on the CPU (plain versions) from the same
             weights, on the card by the eager, the per-block graph and
             the whole-request graph driver (the other families below by
             the eager and the whole-request one), and requires identical
             tokens, steps, forward-equivalents, phase counts,
             revocations, skipped forwards and step traces (their commit
             confidences within 1e-5); LLaDA under every cache policy
             (``none``, ``prefix``, ``dual``, ``prefix`` without
             refreshes), Hymba under ``none``; the cases include
             ``wino_r`` and ``extrapolate`` with knobs that make them
             revoke and skip, and traced FDM-A, wino_r and extrapolate;
             then reduced qwen3-14b (q/k norm, its scales drawn
             away from 1), chatglm3-6b (half RoPE, GQA) and stablelm-3b,
             and stablelm-3b at d_model=320 (head dim 80 in the f32
             kernel), each under ``none``, ``prefix`` and ``dual``
             (``ARCH_CASES``: fdm, FDM-A with its phases, probability);
             then reduced mixtral-8x22b as is and with GQA
             (``MOE_REFERENCE``: MoE blocks, window 32 over a 48-token
             canvas) likewise; then the MoE dispatch (``moe_dispatch_
             phase``): card against CPU on a reduced layer with 8 experts
             and one expert over capacity at factors 1.25 and 2.0 (ids,
             counts, slots, drops exact; outputs within 1e-5 of their
             scale; a CUDA-graph replay equal to eager), and a full-width
             layer at T = 256 and 512 (no drop; each token's two experts
             computed plainly within 1e-2 of the scale; device ms against
             the experts' bytes); then reduced deepseek-v2-236b (MLA at
             (48, 32), a dense first layer, shared experts; the block
             cache keeps MLA's latents) under every policy with
             ``ARCH_CASES``; then reduced whisper-medium conditioned by
             seeded frame embeddings (``enc_embeds``) under ``none`` with
             every case, and unconditioned under ``prefix`` and ``dual``
             with ``ARCH_CASES``; then reduced qwen2-vl-72b (M-RoPE)
             conditioned by 16 seeded patch embeddings (``patch_embeds``)
             under ``none`` and text-only under ``prefix`` and ``dual``,
             and reduced xlstm-125m with the pattern "ms" (an mLSTM and an
             sLSTM layer) under ``none``, each with ``ARCH_CASES``; then
             the decode state (``steps_reference_phase``): LLaDA and every
             reduced config of ``ASSIGNED_ARCHS`` in f32, eight
             ``decode_step``s and a ``forward_window`` sequence (extend
             "kv" then ``set_valid_length``, "recurrent", None, "kv"),
             card against CPU: argmaxes exact, logits and every state leaf
             within ``STEPS_REFERENCE_TOL`` of their scale;
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
             reserved memory to stop growing once it is full; then,
             after Hymba (each model's weights and graphs freed before
             the next): full-width, full-depth Qwen3-14B under ``none``,
             ``prefix`` and ``dual``, ChatGLM3-6B and StableLM-3B under
             ``none`` (``ARCH_SERVING``); then full-width Mixtral-8x22B
             cut to ``MIXTRAL_LAYERS`` (2) of its 56 layers under the
             three policies (``moe_model_phase``), its serving batch's
             forwards on the card's clock, one profiled graph-driven fdm
             request split into kernel groups (expert GEMMs, other GEMMs,
             sort/gather/index, flash, confidence, elementwise) with its
             hand-written kernels' launches in the trace equal to the
             graphs' count, and one eager forward over 4160 tokens (the
             band live: finite logits, one flash launch a layer); then
             full-width DeepSeek-V2 cut to ``DEEPSEEK_LAYERS`` (2) of its
             60 layers (the dense layer 0 and 1 MoE layer of 160 routed
             experts top-6 and 2 shared; MLA in every layer) likewise
             (``moe_model_phase`` again), its long forward over 4096
             tokens; then full-width, full-depth whisper-medium (24
             encoder and 24 decoder layers) decoding with seeded bf16
             frame embeddings of 1500 frames through ``Decoder.generate``
             on the graph drivers (``whisper_phase``: one B=2 request per
             strategy, fdm, fdm_a, probability, captured on a first pass,
             measured on a second; 72 flash launches a forward call; one
             profiled fdm request by kernel group, and eager forwards
             split into the encoder, the cross K/V projections and the
             rest); then full-width qwen2-vl-72b cut to ``VLM_LAYERS`` (2)
             of its 80 layers decoding with 1024 seeded bf16 patch
             embeddings through ``Decoder.generate`` on the graph drivers
             (``vlm_phase``: one B=2 request per strategy, captured on a
             first pass, measured on a second; 4 flash launches a forward
             call; one profiled fdm request by kernel group; the
             conditioned forwards on the card's clock), then served
             text-only under ``none``, ``prefix`` and ``dual``; then
             full-width, full-depth xlstm-125m (``xlstm_phase``: 12 layers,
             layer 6 the sLSTM) served under ``none``, its forwards timed
             and one profiled fdm request by kernel group.  The serve step
             (``serve_step_phase``: ``make_steps(cfg)["serve"]``, one token
             a step against a warm ``init_decode_state``, 16 steps): after
             LLaDA's carry phase, all 32 layers of LLaDA-8B at B=2 over a
             32k bf16 cache (``llada-8b-serve``: ms a step, tokens/s, the
             bytes a step must move (``roofline.step_cost``) and its share
             of that bound, flash's and confidence's device ms a step,
             peak memory above what was held before the state); then, on
             the same weights, the dry-run and prefill_32k
             (``prefill_phase``): the one-card dry-run's rows of
             ``DRYRUN_ROWS`` (``launch/dryrun.py``: meta runs on the host,
             the fit and the roofline terms; the card's memory held to
             ``roofline.HBM_BYTES``), then ``make_steps(cfg)["prefill"]``
             at B=1 over 32768 tokens, all 32 layers (``llada-8b-prefill``:
             ms a step, tokens/s, mfu, the share of ``step_cost``'s bound,
             a device profile by group, the peak above the inputs' baseline
             beside the dry-run's), and flash at (1, 32768, 32:32, d=128)
             and confidence over 32768 × 126464 f32, each held to its plain
             version on a subset of rows; after
             Hymba's serving, Hymba-1.5B at long_500k's position 524287
             (B=1, its 1024-slot ring and the Mamba state) plus one
             32-token ``forward_window(extend="recurrent")``, the scan from
             h0 (``hymba-1.5b-serve``); after the xLSTM's, xlstm-125m
             there likewise (``xlstm-125m-serve``);
6. KV A/B  — (between LLaDA's serving and Hymba's) one B=2 request at the
             reference's ``BENCH_kv_cache.json`` geometry (prompt 128,
             gen 128, block 32, probability) on full-width LLaDA-8B under
             each policy, by the eager driver and the graph driver once
             each:
             seconds, tokens/s, steps/s, capture seconds, graph count and
             pool bytes, and forward-equivalents of exactly 128, 68 and
             20; one graph-driven request under sync debug mode "error";
             under ``dual`` one more under ``torch.profiler`` (busy share,
             device activities per step, idle gaps between them, executed
             launches against the trace's);
             then one full, one ``prefix`` and one ``dual`` window forward
             on the card's clock against host enqueue time (interleaved),
             each with a capture by its kernels on the card, and the
             forwards by where the host's time goes (cProfile); then the
             strategy A/B: eb and an always-accelerating FDM-A at the same
             geometry under ``none``, eager against graph, with the
             graph's executed step replays beside the logical steps;
6b. carry — full-width LLaDA-8B at the serving geometry (B=2, prompt 64,
             gen 64, block 32) under ``none``, ``prefix`` and ``dual`` on
             the graph drivers: ``wino_r`` (defaults) and ``extrapolate``
             (knobs that make it skip) tokens/s, steps, revocations,
             skipped forwards and step replays (the forward runs in every
             replay); under ``none`` extrapolate also by the eager driver
             (which really skips), interleaved; FDM-A traced against
             untraced, one timed decode each after a warm one (equal
             tokens and stats, the final commits summing to the generated
             tokens); the phase's executed launches are
             the path ``llada-8b-carry``; then one profiled, traced,
             graph-driven wino_r request whose trace's kernels must equal
             the graphs' executed launches (two confidence launches a
             step: the scoring and the trace's re-score);
7. flash gradient — dq, dk, dv through the flash kernel's
             ``autograd.Function`` against autograd of the plain version
             at four shapes (bf16 and f32, a GQA band at a q offset); the
             confidence kernel must raise under grad; the backward's
             device ms at the full-width training shape; then the
             scan gradient: ``SelectiveScan``'s backward against autograd
             of the plain scan at Hymba's width (L = 128 and the training
             shape's 512), with its device ms and bound;
8. train step — one f32 step of the ``sum`` testbed on the card against
             the same step on the CPU (loss, every gradient leaf, the
             updated params); then the same for Hymba-tiny (the
             scan's gradient from ``SelectiveScan``), and for
             Mixtral-tiny and DeepSeek-V2-tiny (the objective adds the
             router's aux loss, equal on both);
9. testbed — the testbed trained on the card (batch 64, up to 600 steps),
             then decoded with fdm under each cache policy on the graph
             drivers (EM, forward-equivalents, tokens equal to a CPU
             decode of the same weights), then with ``wino_r`` and
             ``extrapolate`` at their defaults likewise (EM, revocations,
             skips), and FDM-A graph against eager;
9b. tp     — tensor and expert parallelism (``parallel/``): the confidence
             kernel's partials epilogue against its plain version at
             vocab-shard shapes (``PARTIALS_SHAPES``, with the shard's
             vocab offset; device-alone ms beside the bytes bound), and
             whole rows scored from four shards' partials
             (``merge_partials``) against the unsharded kernel
             (``MERGE_SHAPES``, ties across shards and across a shard
             boundary); then one-rank references on this card and four
             gloo ranks (``parallel.launch.spawn``; NCCL refuses two ranks
             on one device) sharing it (one spawn, ``mesh_phases``, runs
             the ranks of 9b, the fsdp part and 9d in turn), every rank's
             flash and partials
             launches on the card: the trained testbed at mesh (1, 4)
             decoded eagerly under fdm, fdm_a and probability (tokens,
             steps, forward-equivalents and phases equal to one rank's,
             on every rank), full-width LLaDA-8B cut to
             ``TP_LLADA_LAYERS`` (4) of 32 layers (``make_steps``'
             prefill at B=2, L=128, and 4 serve steps over a seeded
             4096-position cache at mesh (1, 4), the serve steps at
             (2, 2)) and Mixtral-8x22B cut to ``TP_MIXTRAL_LAYERS`` (2) of
             56, expert-parallel (prefill at (1, 4); f32 compute, see
             ``TP_F32_TOL``), each rank's shard cut from the whole seeded
             bf16 weights: logits within ``TP_LOGIT_TOL`` (Mixtral
             ``TP_F32_TOL``) of one rank's, argmaxes equal where one
             rank's top-2 gap exceeds twice it; per-rank peak memory and
             seconds (four processes sharing one card: not the speed of
             four cards); the paths ``testbed-tp``, ``llada-8b-tp``,
             ``llada-8b-tp-2x2``, ``mixtral-8x22b-tp``; then the sharded
             training step (``fsdp_rank``, the same four ranks): the
             testbed (f32, ``remat="block"``) at meshes (4, 1), (2, 2)
             and (1, 4) and full-width LLaDA-8B cut to
             ``FSDP_LLADA_LAYERS`` (1) of 32 layers with f32 compute at
             (2, 2) and (4, 1), each rank on its training-layout shards
             (FSDP over ``data``, heads and vocab over ``model``) taking
             two steps (LLaDA-8B at (4, 1): one) of
             ``make_steps(cfg, mesh=)["train"]`` on its rows of the
             batch, against one rank's steps on the same corruption
             (taken by the ranks in turn, each rank's shards on the host
             meanwhile): losses and metrics, and every rank's shards of the params
             and both AdamW moments against its part of one rank's,
             within 1e-5 of their leaf's scale (LLaDA-8B 1e-4), every
             rank's metrics equal,
             flash exactly 2 × layers × steps a rank; per-rank peak memory
             beside ``rank_bytes``, seconds a step, and full-depth
             LLaDA-8B's ``rank_bytes`` at (4, 1) and (2, 2) from
             ``meta`` params; the paths ``testbed-fsdp-*`` and
             ``llada-8b-fsdp-*``;
9d. moe-mesh — the MoE families under the mesh (``moe_mesh_rank``,
             the same four ranks): full-width Mixtral-8x22B cut to 1 of
             its 56 layers (f32, ``remat="block"``; its 8 experts 2 a rank
             at (1, 4), 4 a rank FSDP-cut on ``data`` at (2, 2)) and
             DeepSeek-V2's dense MLA layer (1 of 60, 64 heads a rank at
             (2, 2)), one step of ``make_steps(cfg, mesh=)["train"]`` a
             mesh, held to one rank as ``fsdp_phase`` holds them (the
             shards moved to the host while the ranks take the one-rank
             step in turn: Mixtral's one-rank state is ~43 GiB), flash
             exactly 2 a rank; DeepSeek-V2 cut to 2 of 60 layers served at
             (1, 4) (32 heads, 144 of the latent's 576 columns and 40 of
             160 experts a rank; bf16 weights, f32 compute): prefill,
             4 serve steps over a 4096-position latent cache (whole on
             every rank) and one eager fdm decode, within ``TP_F32_TOL`` of
             one rank (the decode exact); then its dense MLA layer alone
             with bf16 compute (no routing): prefill and the serve steps
             within ``TP_LOGIT_TOL`` of one rank, argmaxes equal wherever
             one rank's top-2 gap exceeds twice it; on each path each
             rank's flash and partials launches equal one rank's flash
             and confidence launches; the f32 flash kernel's ptxas
             registers and spills at (192, 128); full-depth
             ``rank_bytes`` of both at (4, 1), (2, 2) and (1, 4); the
             paths ``mixtral-8x22b-fsdp-*``, ``deepseek-v2-236b-fsdp-2x2``,
             ``deepseek-v2-236b-tp`` and ``deepseek-v2-236b-tp-bf16``;
10. training — full-width LLaDA-8B cut to 4 of its 32 layers trained a
             few steps (B=2, L=512): ms/step, tokens/s, peak memory, the
             initial NLL, exactly 2 flash launches per layer and step
             (the path's launch count), and one step's device profile;
             then full-width, full-depth Hymba-1.5B likewise
             (all 32 layers: 2 flash and 2 scan launches per layer and
             step, the path ``hymba-1.5b-train``); then full-width
             Mixtral-8x22B cut to 1 of its 56 layers and DeepSeek-V2 cut
             to 1 of its 60 (its dense MLA layer) likewise (the paths
             ``mixtral-8x22b-train`` and ``deepseek-v2-236b-train``; each
             step's aux loss; the expert GEMMs apart in Mixtral's
             profile); then the MoE gradient phase (``moe_grad_phase``):
             one full-width MoE layer of each at T = 1024, forward and
             backward with its aux loss, device ms against its bound,
             peak memory, the router's gradient moved by the aux term;
             then training through ``make_steps(cfg)["train"]``
             (``steps_train_phase``): xlstm-125m whole (B=2, L=512) and
             qwen2-vl-72b cut to 1 of its 80 layers with 1024 seeded patch
             embeddings (B=2, 128 text positions), 4 steps each: ms a
             step, tokens/s, peak memory, finite losses, flash 2 a layer
             and step (``xlstm-125m-train``, ``qwen2-vl-72b-train``);
11. http serving — the async stack (``ServerThread`` → ``ModelRouter`` →
             ``AsyncScheduler`` → ``ServingEngine``, every decode on the
             card's worker thread) over real sockets: full-width LLaDA-8B
             (random bf16 weights, seed 0) at the engine's default batch
             of 8 with Hymba-1.5B registered beside it; 3 concurrent
             clients stream 9 requests (prompts 41-64, gen 64, block 32,
             64 steps; fdm, fdm_a, probability; none, prefix, dual), and
             every request's tokens must equal its own batch decoded
             directly by ``Decoder.generate`` (the engine records each
             batch's prompts, config and seed); then a ``"trace": true``
             FDM-A request (``/v1/trace/{rid}`` must carry one counter a
             step, its final commits summing to the generation), a
             ``wino_r`` and an ``extrapolate`` request, each 200 and equal
             to its batch re-decoded; decode and wall tokens/s,
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

The last lines are a ``{"kernels": [...]}`` JSON line (the confidence
kernel's partials epilogue its own entry), the card's name
and power limit, and ``{"ok": true, "device": {...}}``.  Imports nothing
of JAX or of the reference package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
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
# the policy whose graph-driven request is profiled (its trace's kernel
# counts held to the executed ones; every policy until the fsdp phase
# took the time)
KV_PROFILED = ("dual",)
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
# the dual window's scoring and K-candidate rows (B·block, K·B·block), and
# Qwen3-14B's scoring batch (V = 151936)
CONF_SHAPES = ((K * MAX_BATCH * CANVAS, 126464, "float32"),
               (MAX_BATCH * CANVAS, 126464, "float32"),
               (K * MAX_BATCH * CANVAS, 126464, "bfloat16"),
               (K * MAX_BATCH * CANVAS, 32001, "float32"),
               (MAX_BATCH * CANVAS, 32001, "float32"),
               (MAX_BATCH * BLOCK, 126464, "float32"),
               (K * MAX_BATCH * BLOCK, 126464, "float32"),
               (MAX_BATCH * CANVAS, 151936, "float32"))
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
# (dqk, dv) pairs the flash kernels are built for (csrc/flash_attention.cu:
# FLASH_HEAD_DIM_PAIRS): one bf16 tensor-core kernel each
FLASH_HEAD_DIM_PAIRS = tuple((d, d) for d in range(32, 257, 16)) + (
    (192, 128), (48, 32))
# the dense GQA family's attention at the serving geometry, (B, Lq, Lk, H,
# G, d, window, q_offset, dtype): StableLM-3B (d=80) in bf16 and f32,
# with a band and with a ragged L; Qwen3-14B (40 heads over 8), ChatGLM3-6B
# (32 over 2), StableLM-12B (d=160, 32 over 8)
ARCH_ATTN_SHAPES = tuple(
    (*shape, dt) for shape in ((MAX_BATCH, CANVAS, CANVAS, 32, 32, 80, 0, 0),
                               (MAX_BATCH, CANVAS, CANVAS, 32, 32, 80, 32, 0),
                               (MAX_BATCH, 130, 130, 32, 32, 80, 17, 0))
    for dt in ("bfloat16", "float32")) + (
    (MAX_BATCH, CANVAS, CANVAS, 40, 8, 128, 0, 0, "bfloat16"),
    (MAX_BATCH, CANVAS, CANVAS, 32, 2, 128, 0, 0, "bfloat16"),
    (MAX_BATCH, CANVAS, CANVAS, 32, 8, 160, 0, 0, "bfloat16"))
MIXTRAL_LAYERS, MIXTRAL_LONG = 2, 4160   # see MOE_REFERENCE
# Mixtral-8x22B's attention (48 heads over 8 at d=128, window 4096; B, Lq,
# Lk, H, G, d, window, q_offset, dtype): the serving batch (the band is
# inactive below 4096) and one 4160-token row (the band live), each in
# bf16 and f32; its confidence at the serving batch's 256 rows x V = 32768
MOE_ATTN_SHAPES = tuple(
    (*shape, dt) for shape in ((MAX_BATCH, CANVAS, CANVAS, 48, 8, 128, 4096,
                                0),
                               (1, MIXTRAL_LONG, MIXTRAL_LONG, 48, 8, 128,
                                4096, 0))
    for dt in ("bfloat16", "float32"))
MOE_CONF_SHAPES = ((MAX_BATCH * CANVAS, 32768, "float32"),
                   (MAX_BATCH * CANVAS, 32768, "bfloat16"))
DEEPSEEK_LAYERS, DEEPSEEK_LONG = 2, 4096   # see DEEPSEEK_REFERENCE
# DeepSeek-V2's MLA heads (128 heads, q/k 192 = 128 + 64 rope wide, v 128;
# B, Lq, Lk, H, G, dqk, dv, window, q_offset, dtype): the serving batch,
# the K-candidate batch, the dual window (32 rows against the 128-token
# canvas at its offset) and one 4096-token row, each in bf16 and f32; its
# confidence at the serving batch's 256 rows x V = 102400
MLA_ATTN_SHAPES = tuple(
    (*shape, dt) for shape in (
        (MAX_BATCH, CANVAS, CANVAS, 128, 128, 192, 128, 0, 0),
        (K * MAX_BATCH, CANVAS, CANVAS, 128, 128, 192, 128, 0, 0),
        (MAX_BATCH, BLOCK, CANVAS, 128, 128, 192, 128, 0, CANVAS - BLOCK),
        (1, DEEPSEEK_LONG, DEEPSEEK_LONG, 128, 128, 192, 128, 0, 0))
    for dt in ("bfloat16", "float32"))
DEEPSEEK_CONF_SHAPES = ((MAX_BATCH * CANVAS, 102400, "float32"),
                        (MAX_BATCH * CANVAS, 102400, "bfloat16"))
# whisper-medium (24 encoder and 24 decoder layers, d=1024, 16 MHA heads at
# d=64, V=51865) over WHISPER_FRAMES encoder frames: its attention (B, Lq,
# Lk, H, G, d, window, q_offset, dtype) at the encoder's shape (1500 =
# 23·64 + 28: the ragged key tail is live), at the K-candidate fold (B=4)
# and at the cross shape (the 128-token canvas over the frames), each in
# bf16 and f32; its confidence at the serving batch's 256 rows x V = 51865
# (odd: rows start off the 16-byte boundary)
WHISPER_FRAMES = 1500
WHISPER_ATTN_SHAPES = tuple(
    (*shape, dt) for shape in (
        (MAX_BATCH, WHISPER_FRAMES, WHISPER_FRAMES, 16, 16, 64, 0, 0),
        (K * MAX_BATCH, WHISPER_FRAMES, WHISPER_FRAMES, 16, 16, 64, 0, 0),
        (MAX_BATCH, CANVAS, WHISPER_FRAMES, 16, 16, 64, 0, 0))
    for dt in ("bfloat16", "float32"))
WHISPER_CONF_SHAPES = ((MAX_BATCH * CANVAS, 51865, "float32"),
                       (MAX_BATCH * CANVAS, 51865, "bfloat16"))
# qwen2-vl-72b (64 heads over 8 at d=128, M-RoPE, V=152064) served cut to
# VLM_LAYERS of its 80 layers, conditioned by VLM_PATCHES seeded patch
# embeddings in front of the text: its attention (B, Lq, Lk, H, G, d,
# window, q_offset, dtype) over the longest canvas (1024 patches + 128
# text positions) in bf16 and f32; its confidence at the serving batch's
# 256 rows x V = 152064, and xlstm-125m's at V = 50304, f32 and bf16
VLM_LAYERS, VLM_PATCHES = 2, 1024
# qwen2-vl-72b trained through make_steps at 1 of its 80 layers (3.44 B
# parameters with the embedding, head and projector: 55 GB of f32 masters,
# gradients and AdamW's moments)
VLM_TRAIN_LAYERS = 1
VLM_ATTN_SHAPES = tuple(
    (MAX_BATCH, VLM_PATCHES + CANVAS, VLM_PATCHES + CANVAS, 64, 8, 128, 0, 0,
     dt) for dt in ("bfloat16", "float32"))
# the sharded training step's attention (fsdp_phase), f32 at a rank's
# rows and local heads: the testbed's 16 rows of 64 (4 heads at d=64) at
# meshes (4, 1), (2, 2), (1, 4), and LLaDA-8B's 4 rows of 256 at (4, 1)
# (32:32) and (2, 2) (16:16)
FSDP_ATTN_SHAPES = ((4, 64, 64, 4, 4, 64, 0, 0, "float32"),
                    (8, 64, 64, 2, 2, 64, 0, 0, "float32"),
                    (16, 64, 64, 1, 1, 64, 0, 0, "float32"),
                    (1, 256, 256, 32, 32, 128, 0, 0, "float32"),
                    (2, 256, 256, 16, 16, 128, 0, 0, "float32"))
# the MoE families under the mesh (phase 9d) at a rank's rows and local
# heads: Mixtral-8x22B's training at (1, 4) (12:2) and (2, 2) (24:4),
# d=128, f32, its band of 4096 not live at L=256; DeepSeek-V2's MLA
# (dqk 192, dv 128) served at (1, 4) (32 heads: prefill B=2, L=128, in
# f32 and in bf16; the eager decode's canvas of 64 at B=1 and its K=2
# candidates, f32 there and bf16 as a user serving in bf16 runs them) and
# trained at (2, 2) (64 heads, B=2, L=256, f32)
MOE_MESH_ATTN_SHAPES = ((4, 256, 256, 12, 2, 128, 4096, 0, "float32"),
                        (2, 256, 256, 24, 4, 128, 4096, 0, "float32"))
MOE_MESH_MLA_SHAPES = ((2, 128, 128, 32, 32, 192, 128, 0, 0, "float32"),
                       (1, 64, 64, 32, 32, 192, 128, 0, 0, "float32"),
                       (2, 64, 64, 32, 32, 192, 128, 0, 0, "float32"),
                       (2, 256, 256, 64, 64, 192, 128, 0, 0, "float32"),
                       (2, 128, 128, 32, 32, 192, 128, 0, 0, "bfloat16"),
                       (1, 64, 64, 32, 32, 192, 128, 0, 0, "bfloat16"),
                       (2, 64, 64, 32, 32, 192, 128, 0, 0, "bfloat16"))
VLM_CONF_SHAPES = ((MAX_BATCH * CANVAS, 152064, "float32"),
                   (MAX_BATCH * CANVAS, 152064, "bfloat16"))
XLSTM_CONF_SHAPES = ((MAX_BATCH * CANVAS, 50304, "float32"),
                     (MAX_BATCH * CANVAS, 50304, "bfloat16"))
# selective-scan shapes of the kernel phase, (B, L, di, N, x dtype), Δ/B/C
# f32: Hymba-1.5B's Mamba branch at the scoring and K-candidate batches, a
# ragged L and di in f32, and one 2048-token row (Hymba's window is 1024)
SCAN_SHAPES = ((MAX_BATCH, CANVAS, 3200, 16, "bfloat16"),
               (K * MAX_BATCH, CANVAS, 3200, 16, "bfloat16"),
               (2, 300, 130, 16, "float32"),
               (1, 2048, 3200, 16, "bfloat16"))


STARTED = time.perf_counter()


def log(*args):
    """A line of the run's log, led by the seconds since the script
    started (a phase's cost is the difference of two such stamps)."""
    print(f"[{time.perf_counter() - STARTED:7.1f} s]", *args, flush=True)


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


def device_ms(fn, reps: int = 5, inner: int = 20,
              spin: int = 10_000_000) -> float:
    """Median over ``reps`` of the mean device time of ``inner``
    back-to-back calls, enqueued while the card spins ``spin`` cycles
    (``torch.cuda._sleep``; 10 M ≈ 5 ms) so that host dispatch leaves no
    gap between them: the kernel's own time, without the wrapper's."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
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
                dtype="bfloat16", dv=None, q_scale=1.0):
    """q, k, v in ``dtype`` (bf16 by default), the band and its q offset
    for the attention kernel; v is ``dv`` wide (default d); q times
    ``q_scale`` before the cast (a larger one peaks the softmax)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + lk + g + window)
    q, k, v = (s * torch.randn(*shape, generator=gen, device="cuda")
               for s, shape in ((q_scale, (b, lq, h, d)), (1, (b, lk, g, d)),
                                (1, (b, lk, g, dv or d))))
    q, k, v = (t.to(getattr(torch, dtype)) for t in (q, k, v))
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
    from repro_torch.launch.roofline import F32_FLOPS, HBM_BW
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
        bound_ms=1e3 * max(nbytes / HBM_BW, ops / F32_FLOPS))


def check_attention(fa_mod, torch, b, lq, lk, h, g, d, window, q_offset,
                    dtype="bfloat16", dv=None, kv_len=None):
    """Kernel vs plain version (tolerance 2e-2 in bf16, 2e-4 in f32, as
    the reference's kernel tests), q and k ``d`` wide, v ``dv`` (default
    d); with ``kv_len`` the kernel reads that count of live keys from the
    card (the single-token decode), and SDPA gets the live keys alone.
    A decode's q is scaled by ``DECODE_Q_SCALE``, which peaks its softmax
    over many keys (outputs of order 1, not 1/sqrt(keys)), and its error
    is also held to the tolerance times the output's max |value|
    (``rel_err``); with a count below Lk the masked keys must change the
    plain version's answer by more than 5x that (``count_effect``).
    Returns a dict: max_abs_err, ms, plain_ms, library_ms (SDPA) call to
    call, device_ms and library_device_ms on the device alone, bound_ms
    and bound_by."""
    from repro_torch.launch.roofline import F32_FLOPS, HBM_BW, PEAK_FLOPS
    import torch.nn.functional as F
    q, k, v, _, _ = attn_inputs(
        torch, b, lq, lk, h, g, d, window, q_offset, dtype, dv,
        1.0 if kv_len is None else DECODE_Q_SCALE)
    count = None if kv_len is None else torch.tensor(
        [kv_len], dtype=torch.int32, device="cuda")
    n = lk if kv_len is None else kv_len
    got = fa_mod.flash_attention(q, k, v, window, q_offset, count)
    torch.cuda.synchronize()
    ref = fa_mod.attention_ref(q, k, v, window, q_offset, count)
    tol = 2e-2 if dtype == "bfloat16" else 2e-4
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)
    checks = {}
    if kv_len is not None:
        scale = float(ref.float().abs().max())
        err = float((got.float() - ref.float()).abs().max())
        checks["rel_err"] = err / scale
        if err > tol * scale:
            raise AssertionError(f"flash decode: error {err} > {tol} x the "
                                 f"output's max |value| {scale}")
        if kv_len < lk:
            full = fa_mod.attention_ref(q, k, v, window, q_offset, None)
            checks["count_effect"] = float(
                (full.float() - ref.float()).abs().max()) / scale
            if checks["count_effect"] <= 5 * tol:
                raise AssertionError(
                    f"flash decode: masking keys {kv_len}.. changes the "
                    f"plain answer by only {checks['count_effect']} of its "
                    f"scale")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k[:, :n], v[:, :n]))
    qpos = q_offset + torch.arange(lq)
    band = (qpos[:, None] - torch.arange(n)[None, :]).abs() < window
    mask = band.cuda() if window else None

    def kernel():
        return fa_mod.flash_attention(q, k, v, window, q_offset, count)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=g != h)
    out = dict(max_abs_err=float((got.float() - ref.float()).abs().max()),
               **checks, ms=time_ms(kernel),
               plain_ms=time_ms(lambda: fa_mod.attention_ref(
                   q, k, v, window, q_offset, count)),
               library_ms=time_ms(sdpa), device_ms=device_ms(kernel),
               library_device_ms=device_ms(sdpa))
    pairs = int(band.sum()) if window else lq * n
    # Q Kᵀ over d and P V over v's width, 2 operations a multiply-add; q
    # and the live keys' k and v read once, the output (v's width) written
    # once
    ops = 2 * b * h * pairs * (d + v.shape[-1])
    nbytes = (q.numel() + (k.numel() + v.numel()) * n // lk +
              got.numel()) * q.element_size()
    peak = PEAK_FLOPS if dtype == "bfloat16" else F32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BW, ops / peak
    out.update(bound_ms=1e3 * max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    return out


def check_scan(scan_mod, torch, b, l, di, n, xdtype: str,
               state: bool = False):
    """Kernel vs plain version, x in ``xdtype`` and Δ/B/C f32 as on the
    serving path (tolerance 3e-2 with bf16 x, 2e-4 in f32, as the
    reference's kernel tests); with ``state``, from a seeded initial
    state h0 with the end state out (the f32 end state within 2e-4).
    Returns a dict: max_abs_err, ms and plain_ms call to call, device_ms
    on the device alone, bound_ms and bound_by (one exp per state and
    step), and design_floor_ms (the two passes' exps, 2 per state and
    step, on the SFU)."""
    from repro_torch.launch.roofline import F32_FLOPS, HBM_BW, SFU_OPS_PER_S
    args = scan_inputs(torch, b, l, di, n, xdtype)
    kw = {}
    if state:
        gen = torch.Generator(device="cuda").manual_seed(SEED + 7 * l)
        kw = dict(h0=0.5 * torch.randn(b, di, n, generator=gen,
                                       device="cuda"), return_state=True)
    got = scan_mod.selective_scan(*args, **kw)
    torch.cuda.synchronize()
    ref = scan_mod.selective_scan_ref(*args, **kw)
    outs = got if state else (got,)
    refs = ref if state else (ref,)
    tol = 2e-4 if xdtype == "float32" else 3e-2
    torch.testing.assert_close(outs[0].float(), refs[0].float(), rtol=tol,
                               atol=tol)
    if state:
        torch.testing.assert_close(outs[1], refs[1], rtol=2e-4, atol=2e-4)

    def kernel():
        return scan_mod.selective_scan(*args, **kw)
    # inputs read once, y (and h_L) written once; h0 read once
    nbytes = sum(t.numel() * t.element_size() for t in args) + \
        sum(t.numel() * t.element_size() for t in outs) + \
        (outs[1].numel() * 4 if state else 0)
    exps = b * l * di * n                 # one exp per state per step
    flops = 7 * b * l * di * n            # Δ·A, Δ·B·x, fma, h·C, sum
    t_bytes = nbytes / HBM_BW
    t_ops = max(exps / SFU_OPS_PER_S, flops / F32_FLOPS)
    return dict(
        max_abs_err=max(float((o.float() - r.float()).abs().max())
                        for o, r in zip(outs, refs)),
        ms=time_ms(kernel), device_ms=device_ms(kernel),
        plain_ms=time_ms(lambda: scan_mod.selective_scan_ref(*args, **kw),
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
# the carry-ful strategies' knobs that make their mechanisms act on random
# weights (the reference's tests/test_carry_strategies.py): every pending
# wino_r commit fails its verify; every observed extrapolate trajectory
# qualifies, so steps skip their forward
REVOKE = dict(strategy="wino_r", wino_revoke_tau=0.99, wino_revoke_budget=4)
SKIP = dict(strategy="extrapolate", extrap_tau=0.0, extrap_min_obs=1)
REFERENCE_CASES = [dict(strategy="fdm", gamma=0.0), dict(strategy="fdm_a"),
                   FDM_A_PHASES, dict(strategy="probability"),
                   dict(strategy="eb"), REVOKE, SKIP,
                   dict(FDM_A_PHASES, trace=True), dict(REVOKE, trace=True),
                   dict(SKIP, trace=True)]
REFERENCE_POLICIES = {"none": {}, "prefix": dict(cache_policy="prefix"),
                      "dual": dict(cache_policy="dual"),
                      "prefix-off": dict(cache_policy="prefix",
                                         cache_refresh="off")}
DRIVERS = {"eager": dict(fused_loop=False), "block": dict(fused_blocks=False),
           "request": {}}
# the other families' reference phases: the eager and the whole-request
# graph driver (the per-block graph driver runs the same forwards as the
# whole-request one; LLaDA and Hymba hold all three; every family held
# all three until the fsdp phase took the time)
FAMILY_DRIVERS = {k: DRIVERS[k] for k in ("eager", "request")}
# the dense GQA family in the reference phase, (name, overrides of the
# reduced config): q/k norm (qwen3), half RoPE with GQA (chatglm3), and
# stablelm-3b at its reduced width and at d_model=320, whose head dim of 80
# runs the f32 kernel's masked last column round; each under ``none``,
# ``prefix`` and ``dual`` with ``ARCH_CASES``
ARCH_REFERENCE = (("qwen3-14b", {}), ("chatglm3-6b", {}), ("stablelm-3b", {}),
                  ("stablelm-3b", dict(d_model=320, num_heads=4)))
ARCH_CASES = [dict(strategy="fdm", gamma=0.0), FDM_A_PHASES,
              dict(strategy="probability")]
# the dense GQA family served at full width and depth after Hymba, on the
# graph drivers: (name, cache policies), each policy a path of its own
ARCH_SERVING = (("qwen3-14b", POLICIES), ("chatglm3-6b", ("none",)),
                ("stablelm-3b", ("none",)))
# Mixtral-8x22B (the MoE block, window 4096): reduced in the reference
# phase, as is and with GQA (reduced gives 4:4), under every policy with
# ARCH_CASES (the reduced window of 32 is live over the 48-token canvas);
# served at full width cut to MIXTRAL_LAYERS of its 56 layers (a layer is
# ~2.50 B parameters, 2 of them ~10.0 GB of bf16 beside the 0.8 GB of
# embedding and head: all 56 would be ~281 GB; 8 until the script's time
# grew with the serve step's phases, 4 until the fsdp phase's); then one
# eager forward
# over MIXTRAL_LONG tokens, past the window, so the band is live at full
# width
MOE_REFERENCE = (("mixtral-8x22b", {}), ("mixtral-8x22b",
                                         dict(num_kv_heads=2)))
# DeepSeek-V2 (MLA, a dense first layer, shared experts): reduced in the
# reference phase under every policy with ARCH_CASES; served at full width
# cut to DEEPSEEK_LAYERS of its 60 layers (layer 0 dense, then MoE layers
# of ~3.97 B parameters: 3 layers are ~18.7 GB of bf16, all 60 ~471 GB;
# 3 until the fsdp phase took the time); then one eager forward over
# DEEPSEEK_LONG tokens
DEEPSEEK_REFERENCE = (("deepseek-v2-236b", {}),)


def _stats_key(st) -> tuple:
    """What a decode must reproduce besides its tokens: steps,
    forward-equivalents, phase counts, revocations, skipped forwards and,
    for a traced decode, the trace's integer fields."""
    trace = () if st.trace is None else tuple(
        getattr(st.trace, f).tolist() for f in (
            "commit_step", "commits", "revocations", "skipped", "phase",
            "block"))
    return (st.steps, st.forward_equivalents, st.phase_counts,
            st.revocations, st.skipped_forwards, trace)


def _same_conf(got, want, tol: float = 1e-5) -> bool:
    """Two traces' commit confidences agree within ``tol``, NaN where the
    other has NaN (True without a trace)."""
    import numpy as np
    if got.trace is None or want.trace is None:
        return got.trace is None and want.trace is None
    a, b = got.trace.commit_conf, want.trace.commit_conf
    return bool(np.array_equal(np.isnan(a), np.isnan(b)) and np.allclose(
        a[~np.isnan(a)], b[~np.isnan(b)], rtol=0, atol=tol))


def reference_phase(torch, name: str, policies, over=None,
                    cases=REFERENCE_CASES, conditioned: bool = False,
                    drivers=FAMILY_DRIVERS):
    """The port on the card (kernels, f32) against the port on the CPU
    (plain versions) on a reduced config (with ``over``): same weights,
    same prompts.  On the card each case runs under each of ``drivers``
    (the eager and the whole-request graph driver, or ``DRIVERS``: also
    the per-block graph driver); every decode and the CPU's
    must give identical tokens, steps, forward-equivalents, phase counts,
    revocations, skipped forwards and trace (its commit confidences within
    1e-5).  A q/k norm's scales (and MLA's latent norms') are drawn from
    the seed in [0.5, 1.5], so that a scale the card dropped would show.
    ``conditioned``: an encoder-decoder decodes with seeded frame
    embeddings (``enc_embeds``) of its encoder's length, a VLM with seeded
    patch embeddings (``patch_embeds``) of its reduced count (16)."""
    import dataclasses
    from repro_torch.configs import DecodeConfig, get_config
    from repro_torch.core import Decoder
    from repro_torch.models import init_model
    cfg = get_config(name).reduced(**(over or {}))
    gen = torch.Generator().manual_seed(SEED)
    cpu_params = init_model(cfg, gen, device="cpu")
    norms = ("q_norm", "kv_norm") if cfg.attention == "mla" else \
        ("q_scale", "k_scale") if cfg.qk_norm else ()
    for layer in cpu_params["blocks"]:
        for key in norms:
            layer["attn"][key].uniform_(0.5, 1.5, generator=gen)
    gpu_params = _to(cpu_params)
    label = name + "".join(f" {k}={v}" for k, v in (over or {}).items())
    gen = torch.Generator().manual_seed(SEED)
    prompt = torch.randint(0, cfg.vocab_size - 1, (2, 16), generator=gen)
    cpu_kw = {}
    if conditioned:
        vision = cfg.encdec.frontend == "vision_stub"
        key = "patch_embeds" if vision else "enc_embeds"
        rows = cfg.encdec.num_patch_tokens if vision else \
            cfg.encdec.encoder_seq
        cpu_kw[key] = torch.randn(2, rows, cfg.d_model, generator=gen)
    card_kw = {k: v.cuda() for k, v in cpu_kw.items()}
    label += " conditioned" if conditioned else ""
    for policy in policies:
        for kw in cases:
            dcfg = DecodeConfig(gen_length=32, block_size=16, steps=32,
                                **REFERENCE_POLICIES[policy], **kw)
            x_cpu, s_cpu = Decoder(cpu_params, cfg, dcfg,
                                   device="cpu").generate(None, prompt,
                                                          **cpu_kw)
            for driver, over in drivers.items():
                x, st = Decoder(gpu_params, cfg, dataclasses.replace(
                    dcfg, **over), device="cuda").generate(None, prompt,
                                                           **card_kw)
                same = torch.equal(x.cpu(), x_cpu) and \
                    _stats_key(st) == _stats_key(s_cpu) and \
                    _same_conf(st, s_cpu)
                log(f"reference {label} {policy} {kw} {driver}: tokens and "
                    f"stats equal={same} steps {s_cpu.steps}/{st.steps} "
                    f"forward_equivalents {s_cpu.forward_equivalents}/"
                    f"{st.forward_equivalents} phases {st.phase_counts} "
                    f"revocations {st.revocations} skipped "
                    f"{st.skipped_forwards}"
                    + ("" if st.trace is None else
                       f" trace steps {st.trace.steps}"))
                if not same:
                    raise AssertionError(f"card decode of {label} ({driver}"
                                         f" driver) differs from the CPU "
                                         f"reference for {policy} {kw}")
            # (only LLaDA's and Hymba's reduced weights are known to take
            # every FDM-A phase at this geometry)
            if kw is FDM_A_PHASES and cases is REFERENCE_CASES and \
                    name in ("llada-8b", "hymba-1.5b") and \
                    not all(s_cpu.phase_counts.values()):
                raise AssertionError(f"{name} {policy}: the FDM-A phases "
                                     f"case missed a phase: "
                                     f"{s_cpu.phase_counts}")
            if (kw.get("strategy") == "wino_r" and not s_cpu.revocations) \
                    or (kw.get("strategy") == "extrapolate"
                        and not s_cpu.skipped_forwards):
                raise AssertionError(f"{name} {policy} {kw}: the knobs did "
                                     f"not make the strategy act")


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


def make_model(torch, name: str, layers: int = 0):
    """Full-width random weights of ``name`` on the card, from the seed, at
    full depth or cut to its first ``layers`` layers.  Returns ``(cfg,
    params)``."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    cfg = get_config(name)
    depth = (f"full width, {layers} of {cfg.num_layers} layers" if layers
             else f"full width and depth ({cfg.num_layers} layers")
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    t0 = time.perf_counter()
    params = init_model(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                        device="cuda")
    torch.cuda.synchronize()
    moe = (f", {cfg.moe.num_experts} experts top-"
           f"{cfg.moe.num_experts_per_tok} at moe_d_ff {cfg.moe.moe_d_ff}"
           if cfg.is_moe else "")
    log(f"serving: {name} {depth}{' (' if layers else ', '}"
        f"d={cfg.d_model}, {cfg.num_heads} heads / {cfg.num_kv_heads} kv, "
        f"d_ff={cfg.d_ff}{moe}, V={cfg.vocab_size}, window "
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
    device ms per call of each group and of the rest, which it returns
    (label -> ms per call; None without ``groups``)."""
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
        log(f"device profile {label} by group (ms per call, kernels): " +
            "; ".join(f"{g} {t / reps / 1e3:.3f} ({n // reps})"
                      for g, (n, t) in by_group(by_name, groups).items()))
        return {g: t / reps / 1e3
                for g, (n, t) in by_group(by_name, groups).items()}
    return None


def by_group(by_name: dict, groups: dict) -> dict:
    """Kernel name -> [count, µs] summed into ``groups`` (label -> name
    substrings, first match wins; the rest is "other"), largest first."""
    sums = {}
    for name, (n, t) in by_name.items():
        g = next((g for g, pats in groups.items()
                  if any(p in name for p in pats)), "other")
        acc = sums.setdefault(g, [0, 0.0])
        acc[0] += n
        acc[1] += t
    return dict(sorted(sums.items(), key=lambda kv: -kv[1][1]))


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


def graph_profile(torch, label: str, fn, run, mods, groups=None) -> dict:
    """One call of ``fn`` (a graph-driven request) under ``torch.profiler``
    (device activity only): wall, kernel time, kernel count per step, the
    share of the wall the card was busy, and the hand-written kernels'
    launches in the trace against the ones ``run``'s graphs count; with
    ``groups`` (as ``device_profile``'s) also the device ms and kernel
    count of each group.  Returns kernel name -> [count, µs]."""
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
    spans, seen, by_name = [], Counter(), {}
    first, last = float("inf"), float("-inf")
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        spans.append((e.start_ns() / 1e3, e.duration_ns() / 1e3))
        acc = by_name.setdefault(e.name(), [0, 0.0])
        acc[0] += 1
        acc[1] += e.duration_ns() / 1e3
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
    if groups:
        log(f"device profile {label} by group (ms, kernels): " +
            "; ".join(f"{g} {t / 1e3:.3f} ({n})"
                      for g, (n, t) in by_group(by_name, groups).items()))
    if spans and any(seen[k] != counted[k] for k in counted):
        raise AssertionError(f"{label}: executed launches counted by the "
                             f"graphs {counted} differ from the trace's "
                             f"{dict(seen)}; {edges}")
    return by_name


def kv_ab_phase(torch, cfg, params, mods: dict) -> None:
    """One B=2 request at the reference's ``BENCH_kv_cache.json`` geometry
    under each cache policy, by the eager and the graph driver (eager,
    graph, after one cold graph decode that captures): seconds, tokens/s
    and steps/s of each, capture seconds, graph count and pool bytes,
    forward-equivalents of exactly 128, 68 and 20 under both drivers; one
    graph-driven request under ``torch.cuda.set_sync_debug_mode("error")``
    and, under ``KV_PROFILED``, one under ``torch.profiler``.  Then on the last canvas: one full forward, one
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
            for driver in ("eager", "graph"):
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
            if policy in KV_PROFILED:
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
# the carry phase (6b): the carry-ful strategies and the step telemetry
# --------------------------------------------------------------------------

# full-width LLaDA-8B at the serving geometry (B=2, prompt 64, gen 64,
# block 32, 64 steps): wino_r at its defaults (on random weights every
# pending commit fails its verify, so it revokes up to its budget) and
# extrapolate with SKIP's knobs (at its defaults it never skips there)
CARRY_CASES = {"wino_r": dict(strategy="wino_r"), "extrapolate": SKIP}


def _timed(torch, decs: dict, order, prompt, check) -> dict:
    """Decode ``prompt`` with ``decs[k]`` for each k of ``order``;
    ``check(k, out, st)`` after each.  Returns the seconds of each k's
    decodes."""
    secs = {k: [] for k in decs}
    for k in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, st = decs[k].generate(None, prompt)
        torch.cuda.synchronize()
        secs[k].append(time.perf_counter() - t0)
        check(k, out, st)
    return secs


def carry_phase(torch, cfg, params, mods: dict) -> dict:
    """Phase 6b (module docstring).  Returns the executed kernel launches
    of its decodes (counts set to 0 just before them, read just after)."""
    import dataclasses
    from repro_torch.configs import DecodeConfig
    from repro_torch.core import Decoder, decode_cache_scope, graphs
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    prompt = torch.randint(0, cfg.vocab_size - 1, (MAX_BATCH, 64),
                           generator=gen, device="cuda")
    tokens = MAX_BATCH * GEN
    for mod in mods.values():
        mod.launches = 0
    graphs.REPLAYED.clear()
    profiled = None
    for policy in POLICIES:
        base = dict(gen_length=GEN, block_size=BLOCK, steps=GEN,
                    cache_policy=policy)
        for label, kw in CARRY_CASES.items():
            dcfg = DecodeConfig(**base, **kw)
            with decode_cache_scope() as scope:
                decs = {"graph": Decoder(params, cfg, dcfg)}
                order = ["graph", "graph"]
                if policy == "none" and label == "extrapolate":
                    decs["eager"] = Decoder(params, cfg, dataclasses.replace(
                        dcfg, fused_loop=False))
                    order = ["eager", "graph", "graph", "eager"]
                seen = {}

                def check(k, out, st):
                    key = (out.cpu(), (st.steps, st.forward_equivalents,
                                       st.revocations, st.skipped_forwards))
                    if (out[:, -GEN:] == cfg.mask_token_id).any():
                        raise AssertionError(f"carry {label} {policy} {k}: "
                                             f"masked token left")
                    first = seen.setdefault("any", key)
                    if not torch.equal(key[0], first[0]) or \
                            key[1] != first[1]:
                        raise AssertionError(
                            f"carry {label} {policy}: {k} decode {key[1]} "
                            f"differs from another ({first[1]})")
                for dec in decs.values():        # captures the graphs
                    dec.generate(None, prompt)
                (run,) = scope.values()
                run.graphs.reset_counts()
                secs = _timed(torch, decs, order, prompt, check)
                replays = (run.graphs.replays() - run.graphs.replays(
                    ("refresh",))) / order.count("graph")
            steps, fwd, revs, skips = seen["any"][1]
            for k, ss in secs.items():
                med = statistics.median(ss)
                log(f"carry {cfg.name} {label} {policy} {k}: B={MAX_BATCH} "
                    f"prompt 64 gen {GEN} block {BLOCK}: {med:.3f} s (runs "
                    f"{', '.join(f'{x:.3f}' for x in ss)}), tokens/s "
                    f"{tokens / med:.2f}")
            log(f"carry {cfg.name} {label} {policy}: steps {steps}, "
                f"forward_equivalents {fwd}, revocations {revs}, "
                f"skipped_forwards {skips}; graph driver {replays:.0f} step "
                f"replays per request, each running the forward"
                + (f"; graph at {statistics.median(secs['eager']) / statistics.median(secs['graph']):.3f}x "  # noqa: E501
                   f"the eager driver's tokens/s" if "eager" in secs else ""))
            if (label == "wino_r" and not revs) or \
                    (label == "extrapolate" and not skips):
                raise AssertionError(f"carry {label} {policy}: the "
                                     f"strategy did not act")
        # FDM-A traced against untraced (as served: K₁ = 2; on random
        # weights it explores, so its search runs in every step)
        dcfg = DecodeConfig(**base, strategy="fdm_a", k1=K)
        with decode_cache_scope():
            decs = {"off": Decoder(params, cfg, dcfg),
                    "on": Decoder(params, cfg, dataclasses.replace(
                        dcfg, trace=True))}
            outs = {}

            def check(k, out, st):
                outs.setdefault(k, (out.cpu(), st))
                if k == "on" and st.trace.commit_histogram().sum() != tokens:
                    raise AssertionError(f"carry fdm_a trace {policy}: the "
                                         f"final commits do not sum to "
                                         f"{tokens}")
            for dec in decs.values():
                dec.generate(None, prompt)
            secs = _timed(torch, decs, ["off", "on"], prompt, check)
        (x_off, s_off), (x_on, s_on) = outs["off"], outs["on"]
        if not torch.equal(x_off, x_on) or \
                (s_off.steps, s_off.forward_equivalents, s_off.phase_counts) \
                != (s_on.steps, s_on.forward_equivalents, s_on.phase_counts):
            raise AssertionError(f"carry fdm_a {policy}: the traced decode "
                                 f"differs from the untraced one")
        med = {k: statistics.median(v) for k, v in secs.items()}
        log(f"carry {cfg.name} fdm_a traced {policy}: untraced "
            f"{tokens / med['off']:.2f} tokens/s (runs "
            f"{', '.join(f'{x:.3f}' for x in secs['off'])} s), traced "
            f"{tokens / med['on']:.2f} tokens/s (runs "
            f"{', '.join(f'{x:.3f}' for x in secs['on'])} s): traced at "
            f"{med['off'] / med['on']:.4f}x; steps {s_on.steps}, phases "
            f"{s_on.phase_counts}, trace steps {s_on.trace.steps}, summary "
            f"{s_on.trace.summary()}")
    launches = {k: mod.launches + graphs.REPLAYED[k]
                for k, mod in mods.items()}
    log(f"carry {cfg.name}: executed kernel launches {launches}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel was not launched on the carry "
                             f"path: {launches}")
    # one profiled, traced, graph-driven wino_r request: its trace's
    # kernels against the graphs' executed launches (two confidence
    # launches a step: the scoring and the trace's re-score)
    dcfg = DecodeConfig(gen_length=GEN, block_size=BLOCK, steps=GEN,
                        strategy="wino_r", trace=True)
    with decode_cache_scope() as scope:
        dec = Decoder(params, cfg, dcfg)
        dec.generate(None, prompt)
        (profiled,) = scope.values()
        graph_profile(torch, f"{cfg.name} traced wino_r graph-driven "
                      f"request none B={MAX_BATCH} gen {GEN}",
                      lambda: dec.generate(None, prompt), profiled, mods)
        conf = executed_launches([profiled], mods)["confidence"]
        steps = profiled.graphs.replays()
        if conf != 2 * steps:
            raise AssertionError(f"traced wino_r: {conf} confidence "
                                 f"launches in {steps} step replays, want "
                                 f"two a step")
    return launches


# --------------------------------------------------------------------------
# http serving (phase 11): the async stack over real sockets
# --------------------------------------------------------------------------

# LLaDA-8B behind ServerThread → ModelRouter → AsyncScheduler → engine at
# the engine's default batch (8), Hymba-1.5B registered beside it; 8
# concurrent clients send 3 requests each (prompts 41-64, gen 64, block
# 32, 64 steps; fdm, fdm_a, probability; each client's requests under
# none, then prefix, then dual), one length bucket for all prompts
# the MoE dispatch phase: a reduced Mixtral layer with Mixtral's own 8
# experts (f32), every token's first choice forced onto expert 0 (a
# constant feature times a large router weight: 400 pairs meet 128 or 256
# slots), at the block cache's and the forward's capacity factors; then a
# full-width layer at the serving batches' token counts (T = B·L: the
# scoring and the K-candidate batch)
MOE_FACTORS = (1.25, 2.0)
MOE_FULL_TOKENS = (MAX_BATCH * CANVAS, K * MAX_BATCH * CANVAS)
# kernel groups of Mixtral's graph-driven request (first match wins; the
# expert GEMMs' kernel names are learned at run time, ``gemm_names``;
# what no group matches is elementwise: norms, RoPE, SwiGLU's products,
# casts, fills)
MOE_PROFILE_GROUPS = {
    "flash attention (hand-written)": ("flash_",),
    "confidence (hand-written)": ("confidence_kernel",),
    "other GEMMs (cuBLAS: attention projections, router, shared experts, "
    "dense SwiGLU, head)":
        ("gemm", "xmma", "nvjet", "cutlass", "splitKreduce"),
    "sort, gather, scatter, index, scan (the dispatch, the combine, the "
    "strategy's)": ("sort", "Sort", "radix", "Radix", "index", "Index",
                    "gather", "scatter", "scan", "Scan")}


def _overflow_moe(torch):
    """The dispatch phase's reduced layer on the CPU: (cfg, params,
    tokens (2, 200, d))."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config("mixtral-8x22b").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=8))
    gen = torch.Generator().manual_seed(SEED)
    p = moe.init_moe(gen, cfg, "cpu", torch.float32)
    p["router"][0, 0] = 10.0
    x = torch.randn(2, 200, cfg.d_model, generator=gen)
    x[..., 0] = 4.0
    return cfg, p, x


def moe_dispatch_phase(torch) -> None:
    """The MoE dispatch (``models/moe.py``) on the card against its CPU
    run, same weights and tokens (reduced, f32, one expert over capacity),
    at factors 1.25 and 2.0: expert ids, counts, slots and drops exact,
    outputs within 1e-5 of their scale (f32 products summed in another
    order; the σ = 1/√E experts make outputs of order 10²); the same call
    captured in a CUDA graph and replayed equals the eager call.  Then one
    full-width layer (bf16, random weights) at T = 256 and 512: nothing
    drops, the outputs are within 1e-2 of their scale of a plain
    computation of each token's two experts (expert by expert over the
    tokens routed to it, in the same dtype order: bf16 operands, f32
    accumulation; the products' rows differ, so bf16 roundings do), and
    the layer's device ms against its bound (the experts' bytes)."""
    from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS
    from repro_torch.configs import get_config
    from repro_torch.core.graphs import GraphSet
    from repro_torch.models import moe
    cfg, p, x = _overflow_moe(torch)
    pc = {k: v.cuda() for k, v in p.items()}
    xc = x.cuda()
    t = x.shape[0] * x.shape[1]
    for factor in MOE_FACTORS:
        cap = moe.capacity(t, cfg, factor)
        want_r = moe.route(x.reshape(t, -1) @ p["router"], cfg, cap)
        got_r = moe.route(xc.reshape(t, -1) @ pc["router"], cfg, cap)
        same = all(torch.equal(getattr(got_r, f).cpu(), getattr(want_r, f))
                   for f in ("ids", "counts", "slot"))
        drops = [int((r.slot >= cap).sum().cpu()) for r in (want_r, got_r)]
        want, _ = moe.moe_forward(p, x, cfg, factor)
        got, _ = moe.moe_forward(pc, xc, cfg, factor)
        scale = float(want.abs().max())
        err = float((got.cpu() - want).abs().max()) / scale
        out = torch.zeros_like(xc)

        def body():
            out.copy_(moe.moe_forward(pc, xc, cfg, factor,
                                      need_aux=False)[0])
        graphs = GraphSet(xc.device)
        graphs.warm(body)
        out.zero_()
        graphs.run("moe", body)
        replay_equal = torch.equal(out, got)
        log(f"moe dispatch (reduced, {cfg.moe.num_experts} experts top-"
            f"{cfg.moe.num_experts_per_tok}, f32, T={t}, factor {factor}, "
            f"capacity {cap}): card vs CPU ids/counts/slots equal={same}, "
            f"drops {drops[1]} (CPU {drops[0]}), max abs err "
            f"{err * scale:.3e} ({err:.2e} of the scale {scale:.1f}); "
            f"graph replay equals eager: {replay_equal}")
        if not same or drops[0] != drops[1] or drops[0] != t - cap or \
                err > 1e-5 or not replay_equal:
            raise AssertionError(f"moe dispatch at factor {factor}: card vs "
                                 f"CPU routing equal {same}, drops {drops} "
                                 f"(want {t - cap}), error {err:.2e} of the "
                                 f"scale, replay equal {replay_equal}")
    full = get_config("mixtral-8x22b")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    p = moe.init_moe(gen, full, "cuda", torch.bfloat16)
    e, k = full.moe.num_experts, full.moe.num_experts_per_tok
    wbytes = sum(w.numel() * w.element_size() for w in p.values())
    for t in MOE_FULL_TOKENS:
        # unit-RMS rows, as the block's norm hands them over
        x = torch.randn(t, full.d_model, generator=gen,
                        device="cuda").to(torch.bfloat16)
        cap = moe.capacity(t, full)
        r = moe.route(x @ p["router"], full, cap)
        drops = int((r.slot >= cap).sum())
        got = moe.moe_forward(p, x[None], full, need_aux=False)[0][0]
        pairs = torch.zeros(t, k, full.d_model, dtype=x.dtype, device="cuda")
        for ex in range(e):
            tok, j = (r.ids == ex).nonzero(as_tuple=True)
            h = torch.nn.functional.silu(x[tok] @ p["w_gate"][ex]) \
                * (x[tok] @ p["w_up"][ex])
            pairs[tok, j] = (h @ p["w_down"][ex]) \
                * r.gates[tok, j][:, None].to(x.dtype)
        want = pairs.sum(1)
        scale = float(want.float().abs().max())
        err = float((got.float() - want.float()).abs().max()) / scale
        ms = device_ms(lambda: moe.moe_forward(p, x[None], full,
                                               need_aux=False), reps=3)
        flops = 2 * 3 * t * k * full.d_model * full.moe.moe_d_ff
        t_bytes, t_ops = wbytes / HBM_BW, flops / PEAK_FLOPS
        bound = 1e3 * max(t_bytes, t_ops)
        log(f"moe dispatch full width (d={full.d_model}, {e} experts top-{k}"
            f" at moe_d_ff {full.moe.moe_d_ff}, bf16, T={t}, capacity {cap}"
            f"): drops {drops}, expert loads {r.counts.tolist()}; max abs "
            f"err against each token's two experts {err * scale:.3e} "
            f"({err:.2e} of the scale {scale:.1f}); on the device alone "
            f"{ms:.4f} ms, bound {bound:.4f} ms "
            f"({'bytes' if t_bytes >= t_ops else 'operations'}: "
            f"{wbytes / 1e9:.3f} GB of experts), share {bound / ms:.3f}; "
            f"the slot grid holds {e * cap} rows for {t * k} pairs")
        if drops or err > 1e-2 or not torch.isfinite(got).all():
            raise AssertionError(f"moe full width T={t}: drops {drops}, "
                                 f"error {err:.2e} of the scale")
    del p
    torch.cuda.empty_cache()


def traced_kernel_names(torch, fn) -> set:
    """The device kernels one call of ``fn`` runs, by name, memsets left
    out (a library runs them beside many ops).  The profiler's window
    opens and closes ``PROFILE_MARGIN_S`` away from the call (a trace can
    lose activities at its edges: one lost all of a window this short);
    fails after three empty traces."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_MARGIN_S)
            fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_MARGIN_S)
        names = {e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and "Memset" not in e.name}
        if names:
            return names
    raise AssertionError("three traces held no device kernel")


def gemm_names(torch, cfg, params) -> tuple:
    """(expert, other): the names of the kernels cuBLAS runs for an MoE
    forward's expert products (``torch.bmm`` at the slots of the serving
    batches' T = 256 and 512: 128 and 256 for Mixtral, 128 for both for
    DeepSeek-V2) and for its other products at those T (every matrix of
    the first MoE layer's attention, its router and shared experts, a
    dense layer's SwiGLU, the f32-output head), each traced alone."""
    from repro_torch.models import moe
    layer = next(p for p in params["blocks"] if "moe" in p)
    head = params["embed"]["head"]
    dt = head.dtype
    e, d, ff = cfg.moe.num_experts, cfg.d_model, cfg.moe.moe_d_ff
    caps = sorted({moe.capacity(t, cfg) for t in MOE_FULL_TOKENS})
    xs = {c: torch.zeros(e, c, d, dtype=dt, device="cuda") for c in caps}
    hs = {c: torch.zeros(e, c, ff, dtype=dt, device="cuda") for c in caps}
    mats = [w for sub in (layer["attn"], layer["moe"],
                          layer["moe"].get("shared", {}),
                          params["blocks"][0].get("mlp", {}))
            for w in sub.values()
            if isinstance(w, torch.Tensor) and w.ndim == 2]

    def experts():
        for c in xs:
            torch.bmm(xs[c], layer["moe"]["w_gate"])
            torch.bmm(hs[c], layer["moe"]["w_down"])

    def others():
        for t in MOE_FULL_TOKENS:
            for w in mats:
                torch.zeros(t, w.shape[0], dtype=dt, device="cuda") @ w
            torch.mm(torch.zeros(t, d, dtype=dt, device="cuda"), head,
                     out_dtype=torch.float32)
    return (traced_kernel_names(torch, experts),
            traced_kernel_names(torch, others))


def moe_model_phase(torch, mods: dict, name: str, layers: int,
                    long: int) -> dict:
    """Full-width ``name`` cut to ``layers`` layers (random bf16 weights
    from the seed: Mixtral-8x22B at ``MIXTRAL_LAYERS`` with
    ``MIXTRAL_LONG``, DeepSeek-V2 at ``DEEPSEEK_LAYERS`` with
    ``DEEPSEEK_LONG``) served like the others (``serving_phase``) under
    ``none``, ``prefix`` and ``dual`` on the graph drivers, each policy a
    path of its own; the serving batch's forwards on the card's clock; one
    profiled graph-driven request (fdm, ``none``) split into kernel
    groups, its hand-written kernels' launches in the trace equal to the
    graphs' count; one eager forward over ``long`` tokens: finite logits,
    one flash launch a layer, its peak memory.  Frees the weights and
    graphs.  Returns the launches by path."""
    from repro_torch.configs import DecodeConfig
    from repro_torch.core import Decoder, clear_decode_cache, decode_cache_scope
    from repro_torch.models import forward
    cfg, params = make_model(torch, name, layers)
    counts = {}
    for policy in POLICIES:
        with decode_cache_scope() as scope:
            counts[cfg.name + ("" if policy == "none" else f"-{policy}")] = \
                serving_phase(torch, cfg, params, mods, scope, policy)
    del scope
    forward_phase(torch, cfg, params)
    expert, other = gemm_names(torch, cfg, params)
    names = expert - other
    log(f"{cfg.name}: the expert products' kernels {sorted(expert)}, the "
        f"other products' {sorted(other)}")
    groups = {"expert GEMMs (cuBLAS, batched over the experts)":
              tuple(names),
              "GEMMs whose kernel runs expert and other products":
              tuple(expert & other), **MOE_PROFILE_GROUPS}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    prompt = torch.randint(0, cfg.vocab_size - 1, (MAX_BATCH, CANVAS - GEN),
                           generator=gen, device="cuda")
    dcfg = DecodeConfig(gen_length=GEN, block_size=BLOCK, steps=GEN,
                        strategy="fdm", k=K)
    with decode_cache_scope() as scope:
        dec = Decoder(params, cfg, dcfg)
        dec.generate(None, prompt)                    # captures
        (run,) = scope.values()
        by_name = graph_profile(
            torch, f"{cfg.name} graph-driven request none B={MAX_BATCH} fdm "
            f"gen {GEN}", lambda: dec.generate(None, prompt), run, mods,
            groups)
        steps = run.graphs.replays()
    del scope, dec
    n_expert = sum(n for k, (n, _) in by_name.items() if k in expert)
    n_flash = sum(n for k, (n, _) in by_name.items() if "flash_" in k)
    n_moe = sum("moe" in p for p in params["blocks"])
    log(f"{cfg.name} graph-driven request: {n_expert} kernels of the "
        f"expert products' names in {steps} step replays "
        f"({n_expert / max(steps, 1):.1f} a step) against 3 products for "
        f"each MoE layer's share ({n_moe} of {cfg.num_layers}) of the "
        f"trace's {n_flash} flash launches (one a layer and forward "
        f"call): {3 * n_flash * n_moe // cfg.num_layers}; names shared "
        f"with other products: {sorted(expert & other)}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    tokens = torch.randint(0, cfg.vocab_size - 1, (1, long),
                           generator=gen, device="cuda")
    fa_mod = mods["flash_attention"]
    before = fa_mod.launches
    torch.cuda.reset_peak_memory_stats()
    logits = forward(params, tokens, cfg)
    torch.cuda.synchronize()
    flash = fa_mod.launches - before
    finite = bool(torch.isfinite(logits).all())
    band = ": the band live" if 0 < cfg.sliding_window < long else ""
    log(f"{cfg.name} eager forward B=1 L={long} (window "
        f"{cfg.sliding_window}{band}): logits "
        f"{tuple(logits.shape)} finite={finite}, flash launches {flash}; "
        f"peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB")
    if not finite or flash != cfg.num_layers or \
            tuple(logits.shape) != (1, long, cfg.vocab_size):
        raise AssertionError(f"{cfg.name} long forward: finite {finite}, "
                             f"flash launches {flash}, shape "
                             f"{tuple(logits.shape)}")
    del logits
    card_vs_host(torch, {f"{cfg.name} B=1 L={long}":
                         lambda: forward(params, tokens, cfg)})
    clear_decode_cache()
    del params
    torch.cuda.empty_cache()
    return counts


HTTP_MAX_BATCH = 8
# 8 until the tp phase took its time, 4 until the moe-mesh phase's (3 keep
# every strategy under every policy: client c sends strategy c % 3)
HTTP_CLIENTS = 3
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
            _http_carry(torch, handle, router, records, np)
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


# the requests the port answered 501 before the carry-ful strategies and
# the step telemetry were ported: each must stream 200 and equal its batch
# re-decoded; the traced one's /v1/trace must carry the device's counters
HTTP_CARRY = ({"strategy": "fdm_a", "trace": True},
              {"strategy": "wino_r", "cache_policy": "prefix"},
              {"strategy": "extrapolate", "cache_policy": "dual"})


def _http_carry(torch, handle, router, records, np) -> None:
    from repro_torch.configs import get_config
    from repro_torch.serving import ServingClient
    vocab = get_config("llada-8b").vocab_size
    rs = np.random.default_rng(SEED + 13)
    client = ServingClient(handle.host, handle.port, timeout=900)
    t0 = time.perf_counter()
    tokens = {}
    for over in HTTP_CARRY:
        prompt = rs.integers(0, vocab - 1, 48).tolist()
        events = _stream(client, prompt, model="llada-8b", gen_length=GEN,
                         block_size=BLOCK, steps=GEN, **over)
        done = events[-1][1]
        if done["type"] != "done" or done["status"] != "ok":
            raise AssertionError(f"http carry {over}: {done}")
        tokens[done["rid"]] = done["tokens"]
        st = done["stats"]
        counters = [e["args"] for e in client.trace(
            done["rid"], model="llada-8b")["traceEvents"]
            if e.get("name") == "commits"]
        if over.get("trace") and (
                len(counters) != st["steps"]
                or sum(c["commits"] for c in counters) != GEN):
            raise AssertionError(f"http carry {over}: /v1/trace has "
                                 f"{len(counters)} step counters summing to "
                                 f"{sum(c['commits'] for c in counters)}, "
                                 f"want {st['steps']} and {GEN}")
        log(f"http carry {over}: 200 and {len(events) - 1} block events; "
            f"steps {st['steps']}, forward_equivalents "
            f"{st['forward_equivalents']}, revocations {st['revocations']}, "
            f"skipped_forwards {st['skipped_forwards']}; /v1/trace step "
            f"counters {len(counters)} (final commits "
            f"{sum(c['commits'] for c in counters)})")
    batches = [b for name, b in records if name == "llada-8b"]
    del records[:]
    checked = _redecode_batches(torch, router, "llada-8b", batches, tokens)
    if checked != len(tokens):
        raise AssertionError(f"http carry: {checked} of {len(tokens)} "
                             f"requests found in the recorded batches")
    log(f"http carry: {checked} requests each equal to its batch decoded "
        f"directly; {time.perf_counter() - t0:.1f} s")


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


def flash_grad_phase(torch, fa_mod, conf_mod) -> dict:
    """dq, dk, dv through the flash kernel's ``autograd.Function`` against
    autograd of the plain version on the card, at ``FLASH_GRAD_SHAPES``
    (max abs error within 1e-4 of the largest gradient in f32, 2e-2 in
    bf16); the confidence kernel must raise under grad.  Then, at the
    full-width training shape (B=2, L=512, LLaDA-8B's heads, bf16): the
    backward's device ms (``attention_backward``), the kernel's forward,
    the plain version's forward + backward and SDPA's (a yardstick),
    and the backward's bound.  Returns those numbers."""
    from repro_torch.launch.roofline import F32_FLOPS, HBM_BW
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
    try:
        conf_mod.confidence_fused(torch.randn(4, 1000, device="cuda",
                                              requires_grad=True))
    except RuntimeError as e:
        if "no backward" not in str(e):
            raise
        log(f"confidence_fused under grad on the card raises: {e}")
    else:
        raise AssertionError("confidence_fused returned a result without "
                             "a gradient path under grad")
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
    r["bound_ms"] = 1e3 * max(nbytes / HBM_BW, ops / F32_FLOPS)
    log(f"flash backward at the full-width training shape (B={b}, L={l}, "
        f"H={h}, d={d}, bf16): attention_backward on the device alone "
        f"{r['backward_device_ms']:.4f} ms (bound {r['bound_ms']:.4f} ms, "
        f"operations: f32); the kernel's forward "
        f"{r['forward_device_ms']:.4f} ms; the plain version's forward + "
        f"backward {r['plain_ms']:.4f} ms, SDPA's {r['library_ms']:.4f} ms "
        f"(call to call)")
    return r


# scan-gradient shapes, (B, L, di, N, x dtype), Δ/B/C f32: Hymba-1.5B's
# Mamba branch at the serving length and at the training shape
SCAN_GRAD_SHAPES = ((MAX_BATCH, CANVAS, 3200, 16, "bfloat16"),
                    (2, 512, 3200, 16, "bfloat16"))


def scan_grad_phase(torch, scan_mod) -> dict:
    """dx, dΔ, dB, dC and d a_log through ``SelectiveScan`` (the kernel's
    forward, ``selective_scan_backward``'s f32 ops replayed from a CUDA
    graph) against autograd of
    the plain version at ``SCAN_GRAD_SHAPES``: each leaf's max abs error
    within 1e-4 of its max |g| (2e-2 for the bf16 x), one kernel launch
    per forward and none in the backward.  Then the backward's device ms
    (graph replay and eager ops) and call-to-call ms, and its bound at
    each shape: the bytes of the inputs, dy and the five
    gradients once, one exp per state and step on the SFU, ~20 f32 flops
    per state and step (both recurrences, the five reductions).  Returns
    the numbers of the training shape."""
    from repro_torch.launch.roofline import F32_FLOPS, HBM_BW, SFU_OPS_PER_S
    out = {}
    for b, l, di, n, xdt in SCAN_GRAD_SHAPES:
        args = scan_inputs(torch, b, l, di, n, xdt)
        dy = torch.randn_like(args[0])
        ins = [t.clone().requires_grad_(True) for t in args]
        before = scan_mod.launches
        got = torch.autograd.grad(scan_mod.selective_scan(*ins), ins, dy)
        torch.cuda.synchronize()
        launched = scan_mod.launches - before
        ref_ins = [t.clone().requires_grad_(True) for t in args]
        want = torch.autograd.grad(scan_mod.selective_scan_ref(*ref_ins),
                                   ref_ins, dy)
        errs = [_rel_err(a, w) for a, w in zip(got, want)]
        tols = [2e-2 if t.dtype == torch.bfloat16 else 1e-4 for t in args]
        # the backward as the card runs it (one CUDA graph replay) and as
        # plain eager ops, on the device alone and call to call
        bwd = device_ms(lambda: scan_mod.graphed_backward(*args, dy),
                        reps=3, inner=5)
        bwd_call = time_ms(lambda: scan_mod.graphed_backward(*args, dy),
                           reps=3, inner=5)
        eager = device_ms(lambda: scan_mod.selective_scan_backward(*args, dy),
                          reps=3, inner=2, spin=200_000_000)
        eager_call = time_ms(
            lambda: scan_mod.selective_scan_backward(*args, dy), reps=3,
            inner=2)
        nbytes = 2 * sum(t.numel() * t.element_size() for t in args) + \
            dy.numel() * dy.element_size()
        t_bytes = nbytes / HBM_BW
        t_ops = max(b * l * di * n / SFU_OPS_PER_S,
                    20 * b * l * di * n / F32_FLOPS)
        r = dict(shape=[b, l, di, n, xdt], backward_device_ms=bwd,
                 backward_ms=bwd_call, eager_device_ms=eager,
                 eager_ms=eager_call,
                 bound_ms=1e3 * max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations",
                 rel_err=errs)
        log(f"scan gradient B={b} L={l} di={di} N={n} x {xdt}, f32 "
            f"delta/B/C: dx/ddelta/dB/dC/da_log max abs error over max |g| "
            f"{errs} (tolerances {tols}); kernel launches {launched}; "
            f"the backward (graph replay) on the device alone {bwd:.4f} "
            f"ms, call to call {bwd_call:.4f} ms; eager ops on the device "
            f"alone {eager:.4f} ms, call to call {eager_call:.4f} ms; "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        if launched != 1 or any(e > t for e, t in zip(errs, tols)) or \
                any(a.dtype != t.dtype for a, t in zip(got, args)):
            raise AssertionError(f"scan gradient off at "
                                 f"{(b, l, di, n, xdt)}: {errs}, "
                                 f"{launched} launches")
        out = r
    return out


def _testbed(torch):
    """The sum testbed's config and dataset."""
    from repro_torch.configs import get_config
    from repro_torch.data import CharTokenizer, TaskDataset
    cfg = get_config("llada-8b").reduced(**TESTBED)
    return cfg, TaskDataset("sum", CharTokenizer(cfg.vocab_size))


def train_step_phase(torch, cfg=None) -> None:
    """One f32 train step of ``cfg`` (the testbed by default) on the ``sum``
    task on the card against the same step on the CPU: same params, batch
    and corruption.  Loss (and an MoE config's aux loss, which the
    objective adds) within rel
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
    label = "testbed" if cfg is None else cfg.name
    if cfg is None:
        cfg, ds = _testbed(torch)
    else:
        from repro_torch.data import CharTokenizer, TaskDataset
        ds = TaskDataset("sum", CharTokenizer(cfg.vocab_size))
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
        out[dev] = float(met["loss"]), float(met["aux"]), g, to_flat(params)
    before = to_flat(init)
    lr = step.sched(1)
    (cpu_loss, cpu_aux, cpu_g, cpu_p), (gpu_loss, gpu_aux, gpu_g, gpu_p) = \
        out["cpu"], out["cuda"]
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
    log(f"train step card vs cpu ({label} f32, B={TESTBED_BATCH}, "
        f"L={ds.seq_len}): loss {gpu_loss} / {cpu_loss}; aux {gpu_aux} / "
        f"{cpu_aux}; gradient max abs "
        f"error over max |g|, worst leaf {max(g_err.values()):.3e} "
        f"({max(g_err, key=g_err.get)}); updated params beyond two f32 "
        f"spacings, in units of lr = {lr:.3e}: worst leaf "
        f"{max(p_err.values()):.3e} ({max(p_err, key=p_err.get)}); off "
        f"the rule in {bad or 'no'} leaves")
    if abs(gpu_loss - cpu_loss) > 1e-5 * abs(cpu_loss) or \
            abs(gpu_aux - cpu_aux) > 1e-5 * abs(cpu_aux) or \
            (cpu_aux > 0) != cfg.is_moe or \
            max(g_err.values()) > 1e-4 or bad:
        raise AssertionError("the card's train step differs from the CPU's")


def testbed_phase(torch) -> dict:
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
    # the carry-ful strategies at their defaults, where the trained
    # confidences decide the revocations and the skips
    for strategy in ("wino_r", "extrapolate"):
        for policy in POLICIES:
            dcfg = DecodeConfig(gen_length=gen, block_size=block, steps=gen,
                                strategy=strategy, cache_policy=policy)
            with decode_cache_scope():
                out, st = Decoder(params, cfg, dcfg).generate(None,
                                                              prompt.cuda())
            want, wst = Decoder(cpu_params, cfg, dcfg,
                                device="cpu").generate(None, prompt)
            same = torch.equal(out.cpu(), want) and \
                _stats_key(st) == _stats_key(wst)
            log(f"testbed decode {strategy} {policy} (graph driver, 64 "
                f"prompts, gen {gen}, block {block}): EM "
                f"{ds.exact_match(out.cpu().numpy(), batch)}, steps "
                f"{st.steps}, forward_equivalents {st.forward_equivalents}, "
                f"revocations {st.revocations}, skipped_forwards "
                f"{st.skipped_forwards}; card tokens equal the CPU's: "
                f"{same}")
            if not same:
                raise AssertionError(f"testbed {strategy} {policy}: the "
                                     f"card's decode differs from the CPU's")
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
    return {"cfg": cfg, "params": cpu_params, "prompt": prompt, "gen": gen,
            "block": block}



def full_train_phase(torch, mods: dict, name: str = "llada-8b",
                     layers: int = FULL_TRAIN_LAYERS) -> dict:
    """Full-width ``name`` (``layers`` of its layers, bf16 compute, f32
    masters, ``remat="block"``) trained for ``FULL_TRAIN_STEPS`` steps
    through ``train`` on seeded random tokens.  The launch counts of
    ``mods`` (each kernel of the path: flash, and for Hymba the scan) are
    set to 0 just before and read just after: exactly 2 × layers per step
    each (the forward and the checkpoint's recomputation; the backwards
    launch none).  Prints ms/step, tokens/s, peak memory and the first
    loss (≈ ln V at random init); for an MoE config also each step's aux
    loss, which must lie between 0.9 × its balanced value (the number of
    MoE layers × ``router_aux_coef``: E·Σ f·P is 1 for a balanced router)
    and E times that (all tokens on the same k experts), and the step's
    profile splits the expert GEMMs from the others.  Returns the path's launches."""
    import dataclasses
    import math
    import numpy as np
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.training import train
    cfg = dataclasses.replace(get_config(name), num_layers=layers)
    full_depth = get_config(name).num_layers
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
    for mod in mods.values():
        mod.launches = 0
    t0 = time.perf_counter()
    params, hist = train(cfg, tcfg, batches(), log=None)
    launches = {k: mod.launches for k, mod in mods.items()}
    total = time.perf_counter() - t0
    n = count_params(params)
    step_s = [float(x) for x in np.diff(hist["seconds"])]   # steps 2..
    per_step = {k: n / FULL_TRAIN_STEPS for k, n in launches.items()}
    ms = 1e3 * statistics.median(step_s)
    log(f"full-width training {cfg.name} ({cfg.num_layers} of {full_depth} "
        f"layers, "
        f"d={cfg.d_model}, {cfg.num_heads} heads, d_ff={cfg.d_ff}, "
        f"V={cfg.vocab_size}, {cfg.dtype}, remat {cfg.remat}; {n} "
        f"parameters, f32 masters; B={FULL_TRAIN_B}, L={FULL_TRAIN_L}): "
        f"{FULL_TRAIN_STEPS} steps in {total:.2f} s with init; losses "
        f"{[round(x, 4) for x in hist['loss']]}, aux {hist['aux']} (ln V = "
        f"{math.log(cfg.vocab_size):.4f}); step ms "
        f"{[round(1e3 * x, 2) for x in step_s]}, median {ms:.2f} ms, tokens/s "
        f"{FULL_TRAIN_B * FULL_TRAIN_L / (ms / 1e3):.1f}; peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, reserved "
        f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB; launches "
        f"{launches} ({per_step} per step); {nvidia_smi()}")
    log(f"full-width training: initial masked NLL {nll:.4f} (ln V + 1/2 = "
        f"{math.log(cfg.vocab_size) + 0.5:.4f}); first weighted loss "
        f"{hist['loss'][0]:.4f}")
    n_moe = sum(i >= cfg.moe.first_k_dense for i in range(cfg.num_layers)) \
        if cfg.is_moe else 0
    train_step_profile(torch, cfg, tcfg, params, next(batches()),
                       moe_train_groups(torch, cfg) if n_moe
                       else TRAIN_GROUPS)
    want = 2 * cfg.num_layers * FULL_TRAIN_STEPS
    # E·Σ f·P is 1 for a balanced router and at most E (every token on the
    # same k experts); the z-loss adds 1e-3 · mean logsumexp²
    balanced = n_moe * cfg.moe.router_aux_coef
    if not all(math.isfinite(a) for a in hist["aux"]) or (
            not 0.9 * balanced <= min(hist["aux"])
            <= max(hist["aux"]) <= cfg.moe.num_experts * balanced if n_moe
            else any(hist["aux"])):
        raise AssertionError(f"full-width training {cfg.name}: aux "
                             f"{hist['aux']}, balanced {balanced}")
    if any(n != want for n in launches.values()):
        raise AssertionError(f"full-width training {cfg.name}: launches "
                             f"{launches}, want {want} of each")
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
                "selective scan forward (hand-written)": ("sscan_",),
                "softmax": ("softmax",),
                "reductions": ("reduce_kernel",),
                "index, gather, scatter": ("index", "gather", "scatter"),
                "elementwise": ("elementwise",)}


def train_step_profile(torch, cfg, tcfg, params, batch,
                       groups=TRAIN_GROUPS) -> None:
    """Where a full-width training step's device time goes: the trained
    params as masters with fresh AdamW state, two profiled steps after
    two warm ones, kernels grouped by ``groups``."""
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
                   groups=groups)


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


# --------------------------------------------------------------------------
# MoE training (the router's aux loss in the objective) and the
# encoder-decoder (whisper-medium)
# --------------------------------------------------------------------------

# Mixtral-8x22B trained at full width cut to 1 of its 56 layers (2.91 B
# parameters by ``param_count()``: 46.5 GB of f32 masters, gradients and
# AdamW's two moments; 2 layers would be 86.6 GB), DeepSeek-V2 at 1 of its
# 60 (its dense MLA layer: 1.39 B, 22.2 GB); one MoE layer of each alone
# in the gradient phase (DeepSeek-V2's MoE layer with AdamW's state would
# be 63.6 GB before the embedding and head)
MIXTRAL_TRAIN_LAYERS, DEEPSEEK_TRAIN_LAYERS = 1, 1
MOE_GRAD_MODELS = ("mixtral-8x22b", "deepseek-v2-236b")
GEMM_PATTERNS = ("gemm", "xmma", "nvjet", "cutlass", "splitKreduce")


def moe_train_groups(torch, cfg) -> dict:
    """``TRAIN_GROUPS`` with the expert GEMMs apart, and the dispatch's
    sorts: the expert GEMMs are the GEMM kernels cuBLAS runs for the
    experts' batched products at the step's capacity, forward and
    backward, traced alone, and not for a plain product of the step's
    tokens (names shared by both are a group of their own)."""
    from repro_torch.models import moe
    t = FULL_TRAIN_B * FULL_TRAIN_L
    e, d, ff = cfg.moe.num_experts, cfg.d_model, cfg.moe.moe_d_ff
    cap, bf = moe.capacity(t, cfg), torch.bfloat16

    def grad_of(*shapes, op):
        ins = [torch.zeros(*sh, dtype=bf, device="cuda", requires_grad=True)
               for sh in shapes]
        y = op(*ins)
        torch.autograd.grad(y, ins, torch.zeros_like(y))

    expert = traced_kernel_names(torch, lambda: grad_of(
        (e, cap, d), (e, d, ff), (e, ff, d),
        op=lambda x, w1, w2: torch.bmm(torch.bmm(x, w1), w2)))
    other = traced_kernel_names(torch, lambda: grad_of(
        (t, d), (d, d), op=lambda x, w: x @ w))

    def gemms(names):
        return tuple(n for n in names if any(p in n for p in GEMM_PATTERNS))
    return {"expert GEMMs (cuBLAS, batched over the experts)":
            gemms(expert - other),
            "GEMMs whose kernel runs expert and other products":
            gemms(expert & other), **TRAIN_GROUPS,
            "sort (the dispatch's)": ("sort", "Sort", "radix", "Radix")}


def moe_grad_phase(torch, name: str) -> None:
    """One full-width MoE layer of ``name`` (Mixtral-8x22B: 8 experts
    top-2; DeepSeek-V2: 160 routed experts top-6 and 2 shared) with f32
    masters that the dispatch casts to bf16 at each product, as the
    trainer's forward does, over T = FULL_TRAIN_B × FULL_TRAIN_L bf16
    hidden states of unit RMS: forward and backward of a seeded
    projection of its output (over its mean magnitude) plus its aux loss, every gradient (the
    masters' and the hidden states') finite; the router's gradient with
    the aux term differs from the one without it; device ms against the
    bound (the masters read and their gradients written in f32, the
    hidden states and their gradient in bf16; the routed pairs' and
    shared experts' products, forward and two backward GEMMs each, at the
    bf16 peak) and the peak memory."""
    from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS
    import math
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.training.optimizer import leaves
    cfg = get_config(name)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    p = moe.init_moe(gen, cfg, "cuda", torch.float32)
    ws = leaves(p)
    for w in ws:
        w.requires_grad_(True)
    b, l, d = FULL_TRAIN_B, FULL_TRAIN_L, cfg.d_model
    t, k = b * l, cfg.moe.num_experts_per_tok
    x = torch.randn(b, l, d, generator=gen, device="cuda") \
        .to(torch.bfloat16).requires_grad_(True)
    r = torch.randn(d, generator=gen, device="cuda") / d ** 0.5
    # the projection over the output's mean |out| (of order 10²: σ = 1/√E
    # experts): its gradient into the router's bf16 logits stays within a
    # bf16 rounding of the aux term's, which would otherwise vanish in it
    with torch.no_grad():
        scale = float(moe.moe_forward(p, x, cfg, 1.25, need_aux=False)[0]
                      .float().abs().mean())

    def objective(with_aux: bool):
        out, aux = moe.moe_forward(p, x, cfg, 1.25, need_aux=True)
        obj = (out.float() * r).sum() / (t * scale)
        return (obj + aux if with_aux else obj), aux

    def step():
        return torch.autograd.grad(objective(True)[0], ws + [x])

    grads = step()
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    del grads
    obj, aux = objective(True)
    (with_aux,) = torch.autograd.grad(obj, [p["router"]])
    aux = aux.detach()
    (without,) = torch.autograd.grad(objective(False)[0], [p["router"]])
    diff = float((with_aux - without).abs().max() / without.abs().max())
    del with_aux, without, obj
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    ms = device_ms(step, reps=3, inner=3)
    n = sum(w.numel() for w in ws)
    ff, shared = cfg.moe.moe_d_ff, cfg.moe.num_shared_experts
    nbytes = 2 * 4 * n + 2 * 2 * x.numel()
    # forward 2·m·n·k a product, backward twice that: 3 × (SwiGLU's three
    # products over the routed pairs and the shared width, the router)
    ops = 3 * 2 * (3 * d * ff * (t * k + t * shared)
                   + t * d * cfg.moe.num_experts)
    t_bytes, t_ops = nbytes / HBM_BW, ops / PEAK_FLOPS
    bound = 1e3 * max(t_bytes, t_ops)
    log(f"moe gradient {name} (one full-width layer: d={d}, "
        f"{cfg.moe.num_experts} experts top-{k} at moe_d_ff {ff}, {shared} "
        f"shared; {n} f32 master parameters; T={t} bf16, capacity "
        f"{moe.capacity(t, cfg)}; output mean |out| {scale:.2f}): aux "
        f"{float(aux):.6f} "
        f"({float(aux) / cfg.moe.router_aux_coef:.4f} x router_aux_coef); "
        f"gradients finite {finite}; the router's gradient with the aux term "
        f"differs from the one without by {diff:.3e} of its max; forward + "
        f"backward on the device alone {ms:.3f} ms, bound {bound:.3f} ms "
        f"({'bytes' if t_bytes >= t_ops else 'operations'}: "
        f"{nbytes / 1e9:.2f} GB, {ops / 1e12:.3f} TFLOP), share "
        f"{bound / ms:.3f}; peak allocated {peak / 2**30:.2f} GiB; "
        f"{nvidia_smi()}")
    if not finite or not diff > 0 or not math.isfinite(float(aux)):
        raise AssertionError(f"moe gradient {name}: finite {finite}, "
                             f"router difference {diff}, aux {float(aux)}")
    del p, ws, x, r
    torch.cuda.empty_cache()


# the conditioned decodes (whisper-medium, qwen2-vl-72b): prompt length per
# strategy (B=2 each)
COND_PROMPTS = {"fdm": 64, "fdm_a": 48, "probability": 41}
DECODE_GROUPS = {"flash attention (hand-written)": ("flash_",),
                  "confidence (hand-written)": ("confidence_kernel",),
                  "GEMMs (cuBLAS)": GEMM_PATTERNS}


def conditioned_decodes(torch, cfg, params, mods: dict, prompts: dict,
                        extras: dict, per_forward: int, label: str):
    """One B=2 request per strategy of ``prompts`` (strategy -> prompt)
    conditioned by ``extras`` through ``Decoder.generate`` on the graph
    drivers under ``none`` (gen 64, block 32, 64 steps, K=K₁=2), each
    strategy in a runner cache of its own: captured on a first pass,
    measured on a second (launch counts set to 0 just before it and read
    just after).  Each forward call launches flash ``per_forward`` times,
    and a step replay makes one or two forward calls; tokens in vocab, no
    mask left.  Returns (decoders, runs, launches), by strategy."""
    import dataclasses
    from repro_torch.configs import DecodeConfig
    from repro_torch.core import Decoder, decode_cache_scope
    dcfg = DecodeConfig(gen_length=GEN, block_size=BLOCK, steps=GEN, k=K,
                        k1=K)
    scopes, decs = {}, {}
    t0 = time.perf_counter()
    for s, prompt in prompts.items():
        with decode_cache_scope() as scopes[s]:
            decs[s] = Decoder(params, cfg, dataclasses.replace(
                dcfg, strategy=s))
            decs[s].generate(None, prompt, **extras)
    torch.cuda.synchronize()
    runs = {s: list(sc.values()) for s, sc in scopes.items()}
    stats = graph_stats(torch, [r for rs in runs.values() for r in rs])
    log(f"{label} warm pass (captures): "
        f"{time.perf_counter() - t0:.2f} s; {stats}")
    all_runs = [r for rs in runs.values() for r in rs]
    reset_launches(all_runs, mods)
    results, total_s = {}, 0.0
    for s, prompt in prompts.items():        # each Decoder keeps its scope
        t0 = time.perf_counter()
        out, st = decs[s].generate(None, prompt, **extras)
        torch.cuda.synchronize()
        results[s] = (out, st, time.perf_counter() - t0)
        total_s += results[s][2]
    launches = executed_launches(all_runs, mods)
    for s, (out, st, sec) in results.items():
        flash = sum(r.graphs.executed_launches()["flash_attention"]
                    for r in runs[s])
        replays = sum(r.graphs.replays() for r in runs[s])
        calls = flash / (per_forward * max(replays, 1))
        gen_tokens = out[:, -GEN:]
        lp = prompts[s].shape[1]
        ok = tuple(out.shape) == (MAX_BATCH, lp + GEN) and \
            bool(((gen_tokens >= 0) & (gen_tokens < cfg.vocab_size)
                  & (gen_tokens != cfg.mask_token_id)).all())
        log(f"{label} {s} (B={MAX_BATCH}, prompt {lp}, gen {GEN}): "
            f"{sec:.3f} s, {MAX_BATCH * GEN / sec:.2f} tokens/s; steps "
            f"{st.steps}, forward_equivalents {st.forward_equivalents}, "
            f"phases {st.phase_counts}; {replays} step replays, flash "
            f"launches {flash} = {per_forward} x {calls} "
            f"forward calls a replay; tokens valid {ok}")
        if not ok or calls != int(calls) or calls not in (1, 2):
            raise AssertionError(f"{label} {s}: tokens valid {ok}, "
                                 f"{calls} forward calls a replay")
    log(f"{label} decode: {len(results) * MAX_BATCH * GEN / total_s:.2f}"
        f" tokens/s over the three requests ({total_s:.3f} s), latency "
        f"per request {[round(r[2], 3) for r in results.values()]} s; "
        f"executed launches {launches}; {nvidia_smi()}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel was not launched on the {label} "
                             f"path: {launches}")
    return decs, runs, launches


def whisper_phase(torch, mods: dict) -> dict:
    """Full-width, full-depth whisper-medium (random bf16 weights from the
    seed) decoding with seeded bf16 frame embeddings ``enc_embeds`` (B=2,
    WHISPER_FRAMES frames) through ``conditioned_decodes``
    (``COND_PROMPTS``: prompts 41-64).  Every forward re-encodes the
    frames, as the reference's does, so each forward call launches flash
    once per encoder layer and twice per decoder layer (self and cross:
    72 times).  Then one profiled graph-driven fdm request by kernel
    group, and eager forwards split into the encoder, the cross K/V
    projections and the rest.  Returns the path's launches."""
    from repro_torch.core import clear_decode_cache
    from repro_torch.models import encode, forward
    cfg, params = make_model(torch, "whisper-medium")
    per_forward = cfg.encdec.encoder_layers + 2 * cfg.num_layers
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    frames = torch.randn(MAX_BATCH, WHISPER_FRAMES, cfg.d_model,
                         generator=gen, device="cuda").to(torch.bfloat16)
    prompts = {s: torch.randint(0, cfg.vocab_size - 1, (MAX_BATCH, lp),
                                generator=gen, device="cuda")
               for s, lp in COND_PROMPTS.items()}
    decs, runs, launches = conditioned_decodes(
        torch, cfg, params, mods, prompts, {"enc_embeds": frames},
        per_forward, "whisper-medium")
    (run,) = runs["fdm"]
    graph_profile(torch, f"whisper-medium graph-driven request none "
                  f"B={MAX_BATCH} fdm gen {GEN}",
                  lambda: decs["fdm"].generate(None, prompts["fdm"],
                                               enc_embeds=frames),
                  run, mods, DECODE_GROUPS)
    gemm = "GEMMs (cuBLAS)"
    for b in (MAX_BATCH, K * MAX_BATCH):
        tiled = frames.repeat(b // MAX_BATCH, 1, 1)
        tokens = torch.randint(0, cfg.vocab_size - 1, (b, CANVAS),
                               generator=gen, device="cuda")
        enc_out = encode(params, tiled, cfg)

        def cross_kv():
            for layer in params["blocks"]:
                enc_out @ layer["xattn"]["wk"]
                enc_out @ layer["xattn"]["wv"]
        parts = {}
        with torch.no_grad():
            for part, fn in (
                    ("forward", lambda: forward(params, tokens, cfg,
                                                enc_embeds=tiled)),
                    ("encoder", lambda: encode(params, tiled, cfg)),
                    ("cross K/V projections", cross_kv)):
                parts[part] = device_profile(
                    torch, f"whisper-medium {part} B={b} (canvas {CANVAS}, "
                    f"{WHISPER_FRAMES} frames)", fn, top=4,
                    groups=DECODE_GROUPS)
        fwd = parts["forward"]
        log(f"whisper-medium forward B={b} by part (ms on the device): "
            f"total {sum(fwd.values()):.3f}; encoder GEMMs "
            f"{parts['encoder'].get(gemm, 0):.3f} (encoder total "
            f"{sum(parts['encoder'].values()):.3f}); cross K/V GEMMs "
            f"{parts['cross K/V projections'].get(gemm, 0):.3f}; other "
            f"GEMMs {fwd.get(gemm, 0) - parts['encoder'].get(gemm, 0) - parts['cross K/V projections'].get(gemm, 0):.3f}; "
            f"flash {fwd.get('flash attention (hand-written)', 0):.3f}; "
            f"elementwise and the rest {fwd.get('other', 0):.3f}")
    del decs, runs, run
    clear_decode_cache()
    del params
    torch.cuda.empty_cache()
    return {"whisper-medium": launches}


def vlm_phase(torch, mods: dict) -> dict:
    """Full-width qwen2-vl-72b cut to VLM_LAYERS of its 80 layers (random
    bf16 weights from the seed, the projector included) decoding with
    VLM_PATCHES seeded bf16 patch embeddings (``patch_embeds``) in front
    of the text through ``conditioned_decodes`` (``COND_PROMPTS``: the
    canvas 1024 + 105 to 1024 + 128 positions under M-RoPE; every forward
    re-runs the patch rows, as the reference's does: one flash launch a
    layer and forward call); one profiled graph-driven fdm request by
    kernel group; the conditioned forwards on the card's clock; then
    served text-only like the others (``serving_phase``) under ``none``,
    ``prefix`` and ``dual``, each a path of its own.  Frees the weights
    and graphs.  Returns the launches by path."""
    from repro_torch.core import clear_decode_cache, decode_cache_scope
    from repro_torch.models import forward
    cfg, params = make_model(torch, "qwen2-vl-72b", VLM_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    patches = torch.randn(MAX_BATCH, VLM_PATCHES, cfg.d_model,
                          generator=gen, device="cuda").to(torch.bfloat16)
    prompts = {s: torch.randint(0, cfg.vocab_size - 1, (MAX_BATCH, lp),
                                generator=gen, device="cuda")
               for s, lp in COND_PROMPTS.items()}
    label = f"{cfg.name} with {VLM_PATCHES} patches"
    decs, runs, launches = conditioned_decodes(
        torch, cfg, params, mods, prompts, {"patch_embeds": patches},
        cfg.num_layers, label)
    (run,) = runs["fdm"]
    graph_profile(torch, f"{label} graph-driven request none B={MAX_BATCH} "
                  f"fdm gen {GEN}",
                  lambda: decs["fdm"].generate(None, prompts["fdm"],
                                               patch_embeds=patches),
                  run, mods, DECODE_GROUPS)
    del decs, runs, run
    clear_decode_cache()
    calls = {}
    for b in (MAX_BATCH, K * MAX_BATCH):
        tokens = torch.randint(0, cfg.vocab_size - 1, (b, CANVAS),
                               generator=gen, device="cuda")
        tiled = patches.repeat(b // MAX_BATCH, 1, 1)
        calls[f"{cfg.name} B={b} L={CANVAS} + {VLM_PATCHES} patches"] = \
            lambda t=tokens, pe=tiled: forward(params, t, cfg,
                                               patch_embeds=pe)
    with torch.no_grad():
        card_vs_host(torch, calls)
    counts = {f"{cfg.name}-patches": launches}
    for policy in POLICIES:
        with decode_cache_scope() as scope:
            counts[cfg.name + ("" if policy == "none" else f"-{policy}")] = \
                serving_phase(torch, cfg, params, mods, scope, policy)
    del scope
    clear_decode_cache()
    del params
    torch.cuda.empty_cache()
    return counts


def xlstm_phase(torch, mods: dict) -> dict:
    """Full-width, full-depth xlstm-125m (12 layers, layer 6 the sLSTM;
    random bf16 weights from the seed, the gate weights and biases f32)
    served like the others (``serving_phase``) under ``none`` (its only
    policy); its forwards on the card's clock and by where the host's time
    goes; one profiled graph-driven fdm request by kernel group (the
    sLSTM's time loop: a few small launches a step of the canvas, replayed
    from the graph); then its serve step at long_500k's last position
    (B=1, ``serve_step_phase``: the recurrent states alone, O(1) a token)
    and one 32-token recurrent window.  Returns the launches of the
    paths."""
    from repro_torch.configs import DecodeConfig
    from repro_torch.core import Decoder, clear_decode_cache, decode_cache_scope
    cfg, params = make_model(torch, "xlstm-125m")
    with decode_cache_scope() as scope:
        launches = serving_phase(torch, cfg, params, mods, scope)
    del scope
    forward_phase(torch, cfg, params)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    prompt = torch.randint(0, cfg.vocab_size - 1, (MAX_BATCH, CANVAS - GEN),
                           generator=gen, device="cuda")
    dcfg = DecodeConfig(gen_length=GEN, block_size=BLOCK, steps=GEN,
                        strategy="fdm", k=K)
    with decode_cache_scope() as scope:
        dec = Decoder(params, cfg, dcfg)
        dec.generate(None, prompt)                    # captures
        (run,) = scope.values()
        graph_profile(torch, f"{cfg.name} graph-driven request none "
                      f"B={MAX_BATCH} fdm gen {GEN}",
                      lambda: dec.generate(None, prompt), run, mods,
                      DECODE_GROUPS)
    del scope, dec, run
    clear_decode_cache()
    serve = serve_step_phase(torch, cfg, params, mods, 1, LONG_POS + 1,
                             LONG_POS, window=32)
    del params
    torch.cuda.empty_cache()
    return {cfg.name: launches, f"{cfg.name}-serve": serve}


# --------------------------------------------------------------------------
# the decode state and the step functions (``launch/steps.py``): the serve
# step at decode_32k and long_500k, the reference phase of decode_step and
# forward_window, training through ``make_steps``
# --------------------------------------------------------------------------

# the flash kernel at the single-token decode (Lq = 1) with its valid count
# read on the card, (B, Lk, H, G, d, count, dtype): LLaDA-8B's serve step
# over the 32k cache (all keys valid once warm) in bf16 and f32, and a
# cache still filling (20000 of its 32768 slots valid), Hymba's 25:5 at
# d=64 over its 1024-slot ring at long_500k (B=1), Qwen3-14B's 40:8 over a
# 32k cache; q is scaled by DECODE_Q_SCALE (see check_attention)
SERVE_B, SERVE_CACHE, SERVE_STEPS = 2, 32768, 16
LONG_POS = 524287                    # long_500k's last position
DECODE_Q_SCALE = 3.0
DECODE_ATTN_SHAPES = ((SERVE_B, SERVE_CACHE, 32, 32, 128, SERVE_CACHE,
                       "bfloat16"),
                      (SERVE_B, SERVE_CACHE, 32, 32, 128, SERVE_CACHE,
                       "float32"),
                      (SERVE_B, SERVE_CACHE, 32, 32, 128, 20000,
                       "bfloat16"),
                      (1, 1024, 25, 5, 64, 1024, "bfloat16"),
                      (1, 1024, 25, 5, 64, 1024, "float32"),
                      (SERVE_B, SERVE_CACHE, 40, 8, 128, SERVE_CACHE,
                       "bfloat16"))
# the scan from an initial state with its end state out, (B, L, di, N, x
# dtype), Δ/B/C f32: Hymba's Mamba branch at the serving batch and over a
# 2048-token row (a frozen prefix's window, forward_window's shapes)
SCAN_STATE_SHAPES = ((MAX_BATCH, CANVAS, 3200, 16, "bfloat16"),
                     (1, 2048, 3200, 16, "bfloat16"))
# confidence at the serve step's rows: LLaDA-8B's B=2 single tokens
SERVE_CONF_SHAPES = ((SERVE_B, 126464, "float32"),)


STEPS_REFERENCE_TOL = 1e-4


def _leaves(tree) -> list:
    """The leaves of nested dicts, lists and tuples (a ``KVCache``'s
    valid length among them)."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def steps_reference_phase(torch) -> None:
    """LLaDA and every reduced config of ``ASSIGNED_ARCHS`` (the xLSTM with
    the pattern "ms"), f32, on the card against the CPU port from the
    same weights: eight ``decode_step``s (B=2, a 16-position state) and a
    ``forward_window`` sequence ("kv" then ``set_valid_length``,
    "recurrent", None, "kv" again); argmaxes exact, logits and every state
    leaf within ``STEPS_REFERENCE_TOL`` (f32 stays off the tensor cores;
    whisper with a seeded ``enc_out``)."""
    from repro_torch.configs import ASSIGNED_ARCHS, get_config
    from repro_torch.models import (decode_step, forward_window,
                                    init_decode_state, init_model,
                                    set_valid_length)
    for name in ["llada-8b"] + list(ASSIGNED_ARCHS):
        cfg = get_config(name).reduced()
        if name == "xlstm-125m":
            cfg = cfg.reduced(ssm=dataclasses.replace(cfg.ssm,
                                                      xlstm_pattern="ms"))
        params = init_model(cfg, torch.Generator().manual_seed(SEED),
                            device="cpu")
        dparams = _to(params)
        gen = torch.Generator().manual_seed(SEED + 1)
        enc = torch.randn(2, 8, cfg.d_model, generator=gen) \
            if cfg.is_encdec else None
        states = {}
        for dev in ("cpu", "cuda"):
            states[dev] = init_decode_state(
                cfg, 2, 16, torch.float32, None if enc is None else
                enc.to(dev), device=dev)
        worst = 0.0

        def both(fn, *args):
            nonlocal worst
            want, states["cpu"] = fn(params, *args, states["cpu"])
            got, states["cuda"] = fn(dparams, *(_to(a) for a in args),
                                     states["cuda"])
            if not torch.equal(got.argmax(-1).cpu(), want.argmax(-1)):
                raise AssertionError(f"steps reference {name}: argmax "
                                     f"differs")
            err = float((got.cpu() - want).abs().max())
            worst = max(worst, err / max(1.0, float(want.abs().max())))
        toks = torch.randint(0, cfg.vocab_size - 1, (8, 2, 1), generator=gen)
        for i, tok in enumerate(toks):
            both(lambda p, t, pos, s: decode_step(p, t, pos, s, cfg), tok,
                 torch.full((2, 1), i, dtype=torch.int32))
        for dev in states:
            states[dev] = set_valid_length(states[dev], 0)
        win = torch.randint(0, cfg.vocab_size - 1, (2, 16), generator=gen)
        for lo, hi, extend, valid in ((0, 8, "kv", 4), (0, 4, "recurrent",
                                                         None),
                                      (4, 8, None, None), (4, 12, "kv", 8)):
            pos = torch.arange(lo, hi, dtype=torch.int32)[None].expand(2, -1)
            both(lambda p, t, ps, s, e=extend: forward_window(
                p, t, ps, s, cfg, e), win[:, lo:hi], pos.contiguous())
            if valid is not None:
                for dev in states:
                    states[dev] = set_valid_length(states[dev], valid)
        for a, b in zip(_leaves(states["cuda"].layer_states),
                        _leaves(states["cpu"].layer_states)):
            if isinstance(b, torch.Tensor):
                err = float((a.cpu() - b).abs().max())
                worst = max(worst, err / max(1.0, float(b.abs().max())))
            elif a != b:
                raise AssertionError(f"steps reference {name}: valid "
                                     f"length {a} != {b}")
        if worst > STEPS_REFERENCE_TOL:
            raise AssertionError(f"steps reference {name}: {worst} > "
                                 f"{STEPS_REFERENCE_TOL} of the scale")
        log(f"steps reference {name}: 8 decode_steps and 4 forward_windows "
            f"card vs CPU, argmaxes equal, worst error {worst:.2e} of the "
            f"scale (tolerance {STEPS_REFERENCE_TOL})")


SERVE_GROUPS = {"flash attention (hand-written)": ("flash_",),
                "confidence (hand-written)": ("confidence_",),
                "GEMMs (cuBLAS)": ("gemm", "xmma", "nvjet", "cutlass",
                                   "splitKreduce", "gemv")}


def serve_step_phase(torch, cfg, params, mods: dict, batch: int,
                     length: int, last_pos: int, window: int = 0) -> dict:
    """``make_steps(cfg)["serve"]`` over a warm ``init_decode_state(cfg,
    batch, length)`` in the compute dtype (the attention caches filled
    with seeded values), ``SERVE_STEPS`` tokens ending at position
    ``last_pos``; with ``window``, then one ``forward_window`` of that
    many tokens with ``extend="recurrent"`` (the scan from the state's
    h0, its end state out).  The launch counts of ``mods`` are set to 0
    just before the steps and read after the window.  Prints ms a step,
    tokens/s, the bytes a step must move and the share of that bound,
    flash's and confidence's device ms a step (a profile of two steps),
    the peak memory above what was allocated before the state was built;
    checks the scores.  The bound is ``roofline.step_cost``'s bytes (every
    slot of the state live).  Returns the launches."""
    from repro_torch.launch.roofline import HBM_BW, step_cost
    from repro_torch.launch.steps import make_steps
    from repro_torch.models import forward_window, init_decode_state
    from repro_torch.models.blocks import layer_cache
    from repro_torch.models.layers import compute_dtype
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_decode_state(cfg, batch, length, compute_dtype(cfg),
                              device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    for kv in map(layer_cache, state.layer_states):
        if kv is not None:
            kv.k.normal_(0.0, 0.5, generator=gen)
            kv.v.normal_(0.0, 0.5, generator=gen)
    torch.cuda.synchronize()
    made = time.perf_counter() - t0
    cache_gb = sum(t.numel() * t.element_size() for t in
                   _leaves(state.layer_states)
                   if isinstance(t, torch.Tensor)) / 1e9
    serve = make_steps(cfg)["serve"]
    first = last_pos - SERVE_STEPS + 1
    toks = torch.randint(0, cfg.vocab_size - 1, (SERVE_STEPS, batch, 1),
                         generator=gen, device="cuda")
    pos = [torch.full((batch, 1), first + i, dtype=torch.int32,
                      device="cuda") for i in range(SERVE_STEPS)]
    holder = {"state": state}

    def step(i):
        scores, holder["state"] = serve(params, toks[i], pos[i],
                                        holder["state"])
        return scores
    for i in range(2):                            # warm: positions first..
        step(i)
    torch.cuda.synchronize()
    for mod in mods.values():
        mod.launches = 0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    outs = [step(i) for i in range(SERVE_STEPS)]
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / SERVE_STEPS
    win_ms = None
    if window:
        wt = torch.randint(0, cfg.vocab_size - 1, (batch, window),
                           generator=gen, device="cuda")
        wp = (last_pos + 1 + torch.arange(window, dtype=torch.int32,
                                          device="cuda"))[None].expand(
            batch, window).contiguous()
        start.record()
        logits, holder["state"] = forward_window(params, wt, wp,
                                                 holder["state"], cfg,
                                                 "recurrent")
        end.record()
        torch.cuda.synchronize()
        win_ms = start.elapsed_time(end)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"serve {cfg.name}: the window's logits "
                                 f"are not finite")
    launches = {k: mod.launches for k, mod in mods.items()}
    for sc in outs:
        if not (bool(torch.isfinite(sc.max_prob).all()) and
                bool(((sc.max_prob > 0) & (sc.max_prob <= 1)).all()) and
                bool((sc.neg_entropy <= 1e-6).all()) and
                bool(((sc.argmax >= 0) &
                      (sc.argmax < cfg.vocab_size)).all())):
            raise AssertionError(f"serve {cfg.name}: scores out of range")
    kv_len = min(last_pos + 1, length)
    _, nbytes = step_cost(cfg, "serve", length, batch)
    bound = 1e3 * nbytes / HBM_BW
    peak = torch.cuda.max_memory_allocated() / 2**30
    above = peak - base / 2**30
    groups = device_profile(
        torch, f"{cfg.name} serve step B={batch} cache {length} at "
        f"position {last_pos}", lambda: step(SERVE_STEPS - 1), top=6,
        groups=SERVE_GROUPS)
    log(f"serve {cfg.name} ({cfg.num_layers} layers, B={batch}, state of "
        f"{length} positions ({cache_gb:.2f} GB, made in {made:.2f} s), "
        f"positions {first}..{last_pos}, valid keys {kv_len}): "
        f"{ms:.3f} ms a step, {batch * 1e3 / ms:.1f} tokens/s; bytes a "
        f"step {nbytes / 1e9:.3f} GB (bound {bound:.3f} ms at 3.35 TB/s, "
        f"share {bound / ms:.3f}); device ms a step by group {groups}; "
        f"peak allocated {peak:.2f} GiB, {above:.2f} GiB above the "
        f"{base / 2**30:.2f} GiB held before the state was built; window "
        f"of {window} tokens "
        f"(extend=recurrent) {win_ms} ms; launches {launches}; "
        f"{nvidia_smi()}")
    want_flash = cfg.num_layers * SERVE_STEPS if cfg.arch_type != "ssm" \
        else 0
    if window and cfg.arch_type != "ssm":
        want_flash += cfg.num_layers
    if launches.get("confidence") != SERVE_STEPS or \
            launches.get("flash_attention", 0) != want_flash or (
                "selective_scan" in launches and
                launches["selective_scan"] != cfg.num_layers):
        raise AssertionError(f"serve {cfg.name}: launches {launches}, want "
                             f"confidence {SERVE_STEPS}, flash "
                             f"{want_flash}, scan {cfg.num_layers} (the "
                             f"window)")
    del holder, state, outs
    torch.cuda.empty_cache()
    return launches


# the one-card dry-run (``launch/dryrun.py``): the rows of the contract's
# combinations this script runs on the card (``--all`` runs every
# admissible one on the host's CPU, for minutes: PERF.md)
DRYRUN_ROWS = (("llada-8b", "prefill_32k"), ("llada-8b", "decode_32k"),
               ("hymba-1.5b", "long_500k"), ("xlstm-125m", "long_500k"))
# prefill_32k at B=1: one warm step, then PREFILL_REPS timed; the kernels
# held at its shapes on row subsets (the plain versions cannot hold the
# whole shape: flash's f32 scores would be 137 GB)
PREFILL_L, PREFILL_REPS = 32768, 3
PREFILL_FLASH_ROWS, PREFILL_CONF_ROWS = 128, 256
PREFILL_TAIL_KEYS = 4096


def dryrun_rows() -> dict:
    """The dry-run's rows of ``DRYRUN_ROWS`` (meta runs on the host: no
    card memory), printed; returns them by (arch, shape)."""
    from repro_torch.launch import dryrun
    rows = {}
    for arch, shape in DRYRUN_ROWS:
        t0 = time.perf_counter()
        rows[arch, shape] = dryrun.dryrun(arch, shape, verbose=False)
        log(f"dryrun {dryrun.format_row(rows[arch, shape])} "
            f"({time.perf_counter() - t0:.1f} s)")
    return rows


def prefill_kernel_checks(torch, fa_mod, conf_mod) -> dict:
    """Flash at prefill_32k's (1, 32768, 32:32, d=128) bf16 on the whole
    shape, held on ``PREFILL_FLASH_ROWS`` query rows (spread over L)
    against the plain version over all keys (tolerance 2e-2, the kernel
    phase's).  As in ``check_attention``'s decode cases, q is scaled by
    ``DECODE_Q_SCALE`` (a peaked softmax: outputs of order 1, not
    1/sqrt(keys)) and the error is also held to the tolerance times the
    output's max |value| (``rel_err``); the last ``PREFILL_TAIL_KEYS``
    keys must move the plain answer by more than 5x that
    (``tail_effect``), so a kernel that dropped them would fail.
    Confidence over 32768 × 126464 f32 logits (duplicated maxima
    in every 4096th row) on ``PREFILL_CONF_ROWS`` rows (every 128th, the
    tied ones among them) against the plain version (argmax exact, margin
    0 on ties, the kernel phase's tolerances).  Each with its device ms,
    call-to-call ms, bound, the plain version's ms on its rows and, for
    flash, SDPA's ms on the whole shape.  Returns {kernel: dict}."""
    from repro_torch.launch.roofline import F32_FLOPS, HBM_BW, PEAK_FLOPS
    import torch.nn.functional as F
    out = {}
    length = PREFILL_L
    q, k, v, _, _ = attn_inputs(torch, 1, length, length, 32, 32, 128, 0,
                                q_scale=DECODE_Q_SCALE)
    got = fa_mod.flash_attention(q, k, v)
    torch.cuda.synchronize()
    rows = torch.linspace(0, length - 1, PREFILL_FLASH_ROWS,
                          device="cuda").long()
    ref = fa_mod.attention_ref(q[:, rows], k, v)
    tol = 2e-2
    torch.testing.assert_close(got[:, rows].float(), ref.float(),
                               rtol=tol, atol=tol)
    scale = float(ref.float().abs().max())
    err = float((got[:, rows].float() - ref.float()).abs().max())
    if err > tol * scale:
        raise AssertionError(f"flash at prefill_32k: error {err} > {tol} x "
                             f"the output's max |value| {scale}")
    cut = length - PREFILL_TAIL_KEYS
    tail_effect = float((fa_mod.attention_ref(
        q[:, rows], k[:, :cut], v[:, :cut]).float() - ref.float()
    ).abs().max()) / scale
    if tail_effect <= 5 * tol:
        raise AssertionError(f"flash at prefill_32k: dropping the last "
                             f"{PREFILL_TAIL_KEYS} keys changes the plain "
                             f"answer by only {tail_effect} of its scale")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def kernel():
        return fa_mod.flash_attention(q, k, v)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt)
    ops = 2 * 32 * length * length * (128 + 128)
    nbytes = 4 * q.numel() * q.element_size()
    t_ops, t_bytes = ops / PEAK_FLOPS, nbytes / HBM_BW
    out["flash_attention"] = dict(
        shape=f"(1, 32768, 32:32, d=128) bf16, q x {DECODE_Q_SCALE}",
        rows=PREFILL_FLASH_ROWS, max_abs_err=err, rel_err=err / scale,
        tail_effect=tail_effect,
        ms=time_ms(kernel, reps=3, inner=2),
        device_ms=device_ms(kernel, reps=3, inner=2),
        library_ms=time_ms(sdpa, reps=3, inner=2),
        library_device_ms=device_ms(sdpa, reps=3, inner=2),
        plain_ms_rows=time_ms(lambda: fa_mod.attention_ref(q[:, rows], k, v),
                              reps=3, inner=2),
        bound_ms=1e3 * max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes")
    del q, k, v, qt, kt, vt, got, ref
    torch.cuda.empty_cache()
    vocab = 126464
    (x,) = conf_inputs(torch, length, vocab, "float32")
    got = conf_mod.confidence_fused(x)
    torch.cuda.synchronize()
    rows = torch.arange(0, length, length // PREFILL_CONF_ROWS,
                        device="cuda")
    ref = conf_mod.confidence_ref(x[rows])
    sub = [t[rows] for t in got]
    if not torch.equal(sub[0], ref[0]):
        raise AssertionError(f"confidence at {length} x {vocab}: argmax "
                             f"differs on {int((sub[0] != ref[0]).sum())} "
                             f"of {PREFILL_CONF_ROWS} rows")
    tied = list(range(0, length, max(length // 8, 1)))
    if not torch.all(got[2][tied] == 0):
        raise AssertionError("confidence margin is not 0 on tied maxima")
    for g, r, rtol, atol in ((sub[1], ref[1], 2e-4, 2e-5),
                             (sub[2], ref[2], 2e-4, 2e-5),
                             (sub[3], ref[3], 2e-3, 2e-4)):
        torch.testing.assert_close(g, r, rtol=rtol, atol=atol)

    def conf():
        return conf_mod.confidence_fused(x)
    nbytes = x.numel() * x.element_size() + length * 16
    t_ops, t_bytes = 5 * x.numel() / F32_FLOPS, nbytes / HBM_BW
    out["confidence"] = dict(
        shape=f"{length} x {vocab} f32", rows=PREFILL_CONF_ROWS,
        max_abs_err=max(float((g - r).abs().max())
                        for g, r in zip(sub[1:], ref[1:])),
        ms=time_ms(conf, reps=3, inner=2),
        device_ms=device_ms(conf, reps=3, inner=2),
        plain_ms_rows=time_ms(lambda: conf_mod.confidence_ref(x[rows]),
                              reps=3, inner=2),
        bound_ms=1e3 * max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=None)
    del x, got, ref, sub
    torch.cuda.empty_cache()
    for name, r in out.items():
        log(f"{name} at prefill_32k's {r['shape']}: max_abs_err "
            f"{r['max_abs_err']} on {r['rows']} rows" + (
                f" ({r['rel_err']:.2e} of the output's max |value|; the "
                f"last {PREFILL_TAIL_KEYS} keys move the plain answer "
                f"{r['tail_effect']:.3f} of it)" if "rel_err" in r else "")
            + f"; kernel {r['ms']:.4f} "
            f"ms, on the device alone {r['device_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), share of the bound "
            f"{r['bound_ms'] / r['device_ms']:.3f}; plain on the rows "
            f"{r['plain_ms_rows']:.4f} ms" + (
                f"; sdpa {r['library_ms']:.4f} ms, on the device alone "
                f"{r['library_device_ms']:.4f} ms (kernel/sdpa "
                f"{r['device_ms'] / r['library_device_ms']:.3f})"
                if r["library_ms"] else "") + f"; {nvidia_smi()}")
    return out


def prefill_phase(torch, cfg, params, mods: dict) -> dict:
    """The dry-run and prefill_32k.  Prints ``DRYRUN_ROWS``' rows (the
    card's ``total_memory`` held to ``HBM_BYTES``), then runs
    ``make_steps(cfg)["prefill"]`` on ``params`` (full width and depth,
    bf16) at B=1 over ``PREFILL_L`` seeded tokens: one warm step, then
    ``PREFILL_REPS`` timed with ``torch.cuda.synchronize``: ms a step,
    tokens/s, ``mfu`` (``model_flops_per_step`` over the step at
    ``PEAK_FLOPS``), the share of ``step_cost``'s bound, a device profile
    of one step by group, and the peak allocated above what was held
    before the inputs were made, beside the dry-run's peak less the
    weights.  The launch counts of ``mods`` are set to 0 just before the
    timed steps and read just after (flash one a layer and step,
    confidence one a step).  Then ``prefill_kernel_checks``.  Returns
    {"launches", "kernels"}."""
    from repro_torch.launch.roofline import (HBM_BW, HBM_BYTES, PEAK_FLOPS,
                                             model_flops_per_step,
                                             step_cost, tree_bytes)
    from repro_torch.launch.steps import make_steps
    total = torch.cuda.get_device_properties(0).total_memory
    if not 0.95 * HBM_BYTES <= total <= HBM_BYTES:
        raise AssertionError(f"the card's total_memory {total} is not "
                             f"within 5% under HBM_BYTES {HBM_BYTES}")
    rows = dryrun_rows()
    log(f"dryrun: the card's total_memory {total / 2**30:.2f} GiB, "
        f"HBM_BYTES {HBM_BYTES / 2**30:.2f} GiB")
    weights = tree_bytes(params)
    predicted = rows["llada-8b", "prefill_32k"]["peak_b1"] - weights
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    batch = {"tokens": torch.randint(0, cfg.vocab_size - 1, (1, PREFILL_L),
                                     generator=gen, device="cuda")}
    prefill = make_steps(cfg)["prefill"]
    prefill(params, batch)
    torch.cuda.synchronize()
    for mod in mods.values():
        mod.launches = 0
    secs = []
    for _ in range(PREFILL_REPS):
        t0 = time.perf_counter()
        scores = prefill(params, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = {k: mod.launches for k, mod in mods.items()}
    peak = torch.cuda.max_memory_allocated() - base
    sc = scores
    if not (tuple(sc.max_prob.shape) == (1, PREFILL_L) and
            bool(torch.isfinite(sc.max_prob).all()) and
            bool(((sc.max_prob > 0) & (sc.max_prob <= 1)).all()) and
            bool((sc.neg_entropy <= 1e-6).all()) and
            bool(((sc.argmax >= 0) & (sc.argmax < cfg.vocab_size)).all())):
        raise AssertionError("prefill_32k: scores out of range")
    del scores, sc
    if launches != {"confidence": PREFILL_REPS,
                    "flash_attention": cfg.num_layers * PREFILL_REPS}:
        raise AssertionError(f"prefill_32k: launches {launches}, want "
                             f"confidence {PREFILL_REPS}, flash "
                             f"{cfg.num_layers * PREFILL_REPS}")
    ms = 1e3 * statistics.median(secs)
    flops, nbytes = step_cost(cfg, "prefill", PREFILL_L, 1)
    t_compute, t_memory = flops / PEAK_FLOPS, nbytes / HBM_BW
    mfu = model_flops_per_step(cfg, "prefill", PREFILL_L, 1) / (
        ms / 1e3 * PEAK_FLOPS)
    groups = device_profile(
        torch, f"{cfg.name} prefill B=1 L={PREFILL_L}",
        lambda: prefill(params, batch), reps=1, top=6, groups=SERVE_GROUPS)
    log(f"prefill_32k {cfg.name} ({cfg.num_layers} layers, B=1, "
        f"L={PREFILL_L}): {ms:.2f} ms a step (runs "
        f"{', '.join(f'{1e3 * x:.2f}' for x in secs)}), "
        f"{PREFILL_L * 1e3 / ms:.1f} tokens/s; mfu {mfu:.4f}; bound "
        f"{1e3 * max(t_compute, t_memory):.2f} ms (compute "
        f"{1e3 * t_compute:.2f} ms: {flops:.4e} flops; memory "
        f"{1e3 * t_memory:.2f} ms: {nbytes / 1e9:.2f} GB), share of the "
        f"bound {max(t_compute, t_memory) / (ms / 1e3):.4f}; device ms a "
        f"step by group {groups}; peak allocated {peak / 2**30:.2f} GiB "
        f"above the {base / 2**30:.2f} GiB held before the inputs (weights "
        f"{weights / 2**30:.2f} GiB); the dry-run's peak less the weights "
        f"{predicted / 2**30:.2f} GiB (measured / predicted "
        f"{peak / predicted:.4f}); launches {launches}; {nvidia_smi()}")
    del batch
    torch.cuda.empty_cache()
    return {"launches": launches,
            "kernels": prefill_kernel_checks(torch, mods["flash_attention"],
                                             mods["confidence"])}


def steps_train_phase(torch, mods: dict, name: str, layers: int = 0,
                      patches: int = 0, seq: int = FULL_TRAIN_L) -> dict:
    """Full-width ``name`` (cut to ``layers`` layers where given) trained
    ``FULL_TRAIN_STEPS`` steps through ``make_steps(cfg)["train"]`` on
    seeded tokens (B = ``FULL_TRAIN_B``, L = ``seq``, the second half
    maskable) and, for a VLM, ``patches`` seeded patch embeddings (the
    config's ``extra_input_names``); f32 masters made in place (no
    second copy), bf16 compute, ``remat="block"``.  The launch counts of
    ``mods`` are set to 0 just before the steps and read just after
    (flash: 2 a layer and step, the forward and the recomputation).
    Prints ms a step (median of steps 2..), tokens/s, peak memory and the
    losses, which must be finite.  Eq. 4's loss weighs each masked token
    by 1/t of its row, so it also prints each step's mean weight (the
    step's draw of the corruption replayed from the generator's state)
    and the loss over it: the masked tokens' weighted mean NLL, which
    starts near ln V.  Returns the launches."""
    import math
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.launch.steps import extra_input_names, make_steps
    from repro_torch.models import init_model
    from repro_torch.training import adamw_init
    from repro_torch.training.optimizer import tree_map
    from repro_torch.training.trainer import corrupt
    cfg = get_config(name)
    depth = cfg.num_layers
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = tree_map(lambda p: p.requires_grad_(True), init_model(
        cfg, gen, device="cuda", dtype=torch.float32))
    n = count_params(params)
    opt = adamw_init(params)
    tcfg = TrainConfig(batch_size=FULL_TRAIN_B, seq_len=seq,
                       steps=FULL_TRAIN_STEPS, seed=SEED)
    step = make_steps(cfg, tcfg)["train"]
    batch = {"tokens": torch.randint(0, cfg.vocab_size - 1,
                                     (FULL_TRAIN_B, seq), generator=gen,
                                     device="cuda"),
             "maskable": torch.zeros(FULL_TRAIN_B, seq, dtype=torch.bool,
                                     device="cuda")}
    batch["maskable"][:, seq // 2:] = True
    extras = extra_input_names(cfg)
    if "patch_embeds" in extras:
        batch["patch_embeds"] = torch.randn(
            FULL_TRAIN_B, patches, cfg.d_model, generator=gen,
            device="cuda").to(torch.bfloat16)
    for mod in mods.values():
        mod.launches = 0
    times, losses, weights = [], [], []
    for _ in range(FULL_TRAIN_STEPS):
        drawn = gen.get_state()
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, gen, batch)
        losses.append(float(met["loss"]))
        times.append(time.perf_counter() - t0)
        replay = torch.Generator(device="cuda")
        replay.set_state(drawn)
        _, masked, t = corrupt(replay, batch["tokens"], batch["maskable"],
                               cfg)
        weights.append(float((masked / t.clamp_min(1e-3)[:, None]).sum() /
                             masked.sum().clamp_min(1)))
    launches = {k: mod.launches for k, mod in mods.items()}
    ms = 1e3 * statistics.median(times[1:])
    tokens = FULL_TRAIN_B * (seq + patches)
    log(f"make_steps training {cfg.name} ({cfg.num_layers} of {depth} "
        f"layers, d={cfg.d_model}, V={cfg.vocab_size}, {cfg.dtype}, remat "
        f"{cfg.remat}; {n} parameters, f32 masters; B={FULL_TRAIN_B}, "
        f"L={seq}, extras {extras} with {patches} patches): losses "
        f"{[round(x, 4) for x in losses]}, mean 1/t weights "
        f"{[round(w, 4) for w in weights]}, losses over them "
        f"{[round(x / w, 4) for x, w in zip(losses, weights)]} (ln V = "
        f"{math.log(cfg.vocab_size):.4f}); step ms "
        f"{[round(1e3 * t, 2) for t in times]}, median of steps 2.. "
        f"{ms:.2f} ms, tokens/s {tokens / (ms / 1e3):.1f} (patch rows "
        f"counted); peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, reserved "
        f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB; launches "
        f"{launches}; {nvidia_smi()}")
    want = 2 * cfg.num_layers * FULL_TRAIN_STEPS if cfg.arch_type != "ssm" \
        else 0
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"make_steps training {cfg.name}: losses "
                             f"{losses}")
    if launches.get("flash_attention", 0) != want:
        raise AssertionError(f"make_steps training {cfg.name}: launches "
                             f"{launches}, want {want} flash")
    del params, opt, step, batch
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------
# 9b. tensor and expert parallelism: four gloo ranks sharing the one card
# --------------------------------------------------------------------------

# the confidence kernel's partials epilogue at vocab-shard shapes (rows, V/4
# of four ranks, dtype, the shard's first vocab id): LLaDA-8B's serve rows
# and 256 prefill rows of its 126464 / 4, Mixtral-8x22B's 32768 / 4
PARTIALS_SHAPES = ((2, 31616, "float32", 3 * 31616),
                   (256, 31616, "float32", 31616),
                   (256, 31616, "bfloat16", 2 * 31616),
                   (256, 8192, "float32", 8192),
                   # DeepSeek-V2's V/4 in phase 9d: prefill, serve, decode
                   (256, 25600, "float32", 25600),
                   (2, 25600, "float32", 3 * 25600),
                   (64, 25600, "float32", 2 * 25600))
# whole rows scored from four shards' partials, against the unsharded
# kernel on the same rows
MERGE_SHAPES = ((2, 126464, "float32"), (256, 126464, "float32"),
                (256, 126464, "bfloat16"), (256, 32768, "float32"))
TP_WORLD = 4
MESH_DEVICE = "cuda"              # phases 9b-9d
# full width, cut in depth for the script's time: LLaDA-8B 4 of 32 layers,
# Mixtral-8x22B 2 of 56 (expert-parallel: 2 of its 8 experts a rank)
TP_LLADA_LAYERS, TP_MIXTRAL_LAYERS = 4, 2
TP_B, TP_L, TP_CACHE, TP_STEPS = 2, 128, 4096, 4
TP_TESTBED = {"fdm": dict(strategy="fdm", k=2),
              "fdm_a": dict(strategy="fdm_a", k1=2),
              "probability": dict(strategy="probability")}
# LLaDA-8B in bf16: the row-parallel partials are summed in f32 in
# another order than one rank's GEMMs, so hidden states differ by bf16
# roundings that grow over the layers; logits are held to TP_LOGIT_TOL
# (absolute), max-probs to 2x it (relative: p ~ exp(logit)), Σ p log p to
# 2x it, and argmaxes must agree wherever one rank's top-2 logit gap
# exceeds 2x it.  Mixtral's bf16 weights run with f32 compute: in bf16 a
# rounding can move a near-tied token to another expert, which changes
# its row by far more than any small tolerance; in f32 the sums' order
# leaves the logits within TP_F32_TOL
TP_LOGIT_TOL, TP_F32_TOL = 0.1, 1e-3


def check_partials(conf_mod, torch, rows: int, vocab: int, dtype: str,
                   offset: int) -> dict:
    """The partials epilogue against its plain version on the same logits:
    i1 (with the shard's offset), m and m2 exact; s within rel 2e-4 and
    u / s within (2e-3, 2e-4) (the ex2.approx sums of the full kernel's
    tolerances).  max_abs_err: the larger of |s / s_plain − 1| and
    |u / s − u_plain / s_plain|."""
    from repro_torch.launch.roofline import F32_FLOPS, HBM_BW
    (x,) = conf_inputs(torch, rows, vocab, dtype)
    got = conf_mod.confidence_partials(x, offset)
    torch.cuda.synchronize()
    ref = conf_mod.confidence_partials_ref(x, offset)
    for name in ("i1", "m", "m2"):
        if not torch.equal(getattr(got, name), getattr(ref, name)):
            raise AssertionError(f"confidence partials {name} differs at "
                                 f"{rows} x {vocab} {dtype}")
    torch.testing.assert_close(got.s, ref.s, rtol=2e-4, atol=0.0)
    torch.testing.assert_close(got.u / got.s, ref.u / ref.s, rtol=2e-3,
                               atol=2e-4)

    def kernel():
        return conf_mod.confidence_partials(x, offset)
    nbytes = x.numel() * x.element_size() + rows * 20
    ops = 5 * x.numel()
    return dict(
        max_abs_err=max(float((got.s / ref.s - 1).abs().max()),
                        float((got.u / got.s - ref.u / ref.s).abs().max())),
        ms=time_ms(kernel), device_ms=device_ms(kernel),
        plain_ms=time_ms(lambda: conf_mod.confidence_partials_ref(x, offset),
                         reps=3, inner=2),
        bound_ms=1e3 * max(nbytes / HBM_BW, ops / F32_FLOPS))


def check_merge(conf_mod, torch, rows: int, vocab: int, dtype: str) -> float:
    """Whole rows scored from ``TP_WORLD`` contiguous shards' partials and
    ``core.confidence.merge_partials`` against ``confidence_fused`` on the
    same rows (ties across shards 0 and 3 in every eighth row, a tie
    across the boundary of shards 0 and 1 in the last): argmaxes exact,
    margins 0 on the ties, the rest at ``check_confidence``'s
    tolerances.  Returns the max abs error."""
    from repro_torch.core.confidence import merge_partials
    (x,) = conf_inputs(torch, rows, vocab, dtype)
    w = vocab // TP_WORLD
    top = x[-1].float().max() + 1
    x[-1, w - 1] = top
    x[-1, w] = top
    parts = [conf_mod.confidence_partials(x[:, r * w:(r + 1) * w].contiguous(),
                                          r * w) for r in range(TP_WORLD)]
    got = merge_partials(conf_mod.Partials(*(
        torch.stack([getattr(p, f) for p in parts])
        for f in conf_mod.Partials._fields)))
    want = conf_mod.confidence_fused(x)
    torch.cuda.synchronize()
    if not torch.equal(got.argmax, want[0]):
        raise AssertionError(f"merged argmax differs at {rows} x {vocab} "
                             f"{dtype}")
    ties = list(range(0, rows, max(rows // 8, 1))) + [rows - 1]
    if not torch.all(got.margin[ties] == 0):
        raise AssertionError("merged margin is not 0 on tied maxima")
    for g, r, rtol, atol in ((got.max_prob, want[1], 2e-4, 2e-5),
                             (got.margin, want[2], 2e-4, 2e-5),
                             (got.neg_entropy, want[3], 2e-3, 2e-4)):
        torch.testing.assert_close(g, r, rtol=rtol, atol=atol)
    return max(float((g - r).abs().max()) for g, r in zip(
        (got.max_prob, got.margin, got.neg_entropy), want[1:]))


def _tp_inputs(torch, cfg) -> dict:
    """Seeded tokens: prefill (B, L), serve (steps, B, 1)."""
    gen = torch.Generator().manual_seed(SEED + 9)
    return {"tokens": torch.randint(0, cfg.vocab_size - 1, (TP_B, TP_L),
                                    generator=gen),
            "serve": torch.randint(0, cfg.vocab_size - 1,
                                   (TP_STEPS, TP_B, 1), generator=gen)}


def _tp_state(torch, cfg, dev):
    """The whole seeded bf16 decode state (B, TP_CACHE, G, hd) a layer,
    made outside any mesh."""
    from repro_torch.models import init_decode_state
    state = init_decode_state(cfg, TP_B, TP_CACHE, torch.bfloat16,
                              device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    for kv in state.layer_states:
        for t in (kv.k, kv.v):
            t.copy_(torch.randn(t.shape, generator=gen, device=dev))
    return state


# (layers, compute dtype, tolerance) of the full-width models; the weights
# are bf16 in both
TP_MODELS = {"llada-8b": (TP_LLADA_LAYERS, "bfloat16", TP_LOGIT_TOL),
             "mixtral-8x22b": (TP_MIXTRAL_LAYERS, "float32", TP_F32_TOL)}


def _tp_model(torch, name, dev):
    """Full width, cut to ``TP_MODELS``' depth, seeded bf16 weights."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    layers, compute, _ = TP_MODELS[name]
    cfg = dataclasses.replace(get_config(name), num_layers=layers,
                              dtype=compute)
    return cfg, init_model(cfg, torch.Generator(device=dev).manual_seed(SEED),
                           device=dev, dtype=torch.bfloat16)


def _tp_run(torch, cfg, params, dev, mesh=None, rank=0, serve=True,
            prefill=True):
    """Prefill scores and logits, then ``TP_STEPS`` serve steps over the
    seeded cache, each on this rank's batch rows (all of them without a
    mesh).  Returns CPU tensors."""
    from repro_torch.launch.steps import make_steps
    from repro_torch.models import forward
    from repro_torch.parallel.ctx import activation_mesh
    from repro_torch.parallel.sharding import (batch_pspec, shard_tree,
                                               state_pspecs)
    inp = _tp_inputs(torch, cfg)

    def rows(x):
        if mesh is None:
            return x.to(dev)
        return shard_tree(x, batch_pspec(mesh, x.dim()), mesh, rank).to(dev)
    steps = make_steps(cfg, mesh=mesh)
    out = {}
    if prefill:
        toks = rows(inp["tokens"])
        out["prefill"] = [t.cpu() for t in steps["prefill"](
            params, {"tokens": toks})]
        with (activation_mesh(mesh) if mesh is not None
              else contextlib.nullcontext()):
            out["logits"] = forward(params, toks, cfg).cpu()
    if serve:
        state = _tp_state(torch, cfg, dev)
        if mesh is not None:
            state = shard_tree(state, state_pspecs(state, mesh), mesh, rank)
        out["serve"] = []
        for i, tok in enumerate(inp["serve"]):
            pos = torch.full(tok.shape, TP_CACHE - TP_STEPS + i,
                             dtype=torch.int32)
            sc, state = steps["serve"](params, rows(tok), rows(pos), state)
            out["serve"].append([t.cpu() for t in sc])
        del state
    if dev == "cuda":
        torch.cuda.synchronize()
    return out


def _tp_decodes(torch, cfg, params, job, dev) -> dict:
    """The testbed's eager decodes under ``TP_TESTBED``: tokens, steps,
    forward-equivalents and phase counts."""
    from repro_torch.configs import DecodeConfig
    from repro_torch.core import Decoder
    out = {}
    prompt = job["prompt"].to(dev)
    for name, kw in TP_TESTBED.items():
        dcfg = DecodeConfig(gen_length=job["gen"], block_size=job["block"],
                            steps=job["gen"], fused_loop=False, **kw)
        toks, st = Decoder(params, cfg, dcfg, device=dev).generate(None,
                                                                   prompt)
        out[name] = (toks.cpu(), st.steps, st.forward_equivalents,
                     dict(st.phase_counts))
    return out


def tp_rank(rank: int, job: dict) -> dict:
    """The ``tp`` phase's part of one of the four ranks (``mesh_rank``):
    the testbed at mesh (1, 4), LLaDA-8B at (1, 4) and (2, 2), Mixtral at
    (1, 4), each rank building the whole weights from the seed
    (four at once for LLaDA, two for Mixtral's 10.5 GB) and keeping its
    shard.  Returns
    outputs, executed launches by path (counts set to 0 just before each
    path, read just after), seconds by path and the peak memory."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import confidence as conf_mod
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.ctx import activation_mesh
    from repro_torch.parallel.sharding import shard_params
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = job["device"]
    out, launches, secs = {}, {}, {}

    def reset():
        fa_mod.launches = conf_mod.launches = conf_mod.partials_launches = 0

    def counts():
        return {"flash_attention": fa_mod.launches,
                "confidence": conf_mod.launches,
                "confidence_partials": conf_mod.partials_launches}

    def in_turn(name, meshes, at_once):
        """The whole weights made by ``at_once`` ranks at a time (the
        card's memory); each rank keeps its shard for each mesh."""
        shards = None
        for turn in range(0, TP_WORLD, at_once):
            if turn <= rank < turn + at_once:
                cfg, full = _tp_model(torch, name, dev)
                shards = [shard_params(full, m) for m in meshes]
                del full
                torch.cuda.empty_cache()
            dist.barrier()
        return cfg, shards

    m14, m22 = make_mesh(1, TP_WORLD), make_mesh(2, TP_WORLD // 2)
    t0 = time.perf_counter()
    from repro_torch.configs import get_config
    cfg = get_config("llada-8b").reduced(**TESTBED)
    params = shard_params(_to(job["testbed"], dev), m14)
    reset()
    with activation_mesh(m14):
        out["testbed"] = _tp_decodes(torch, cfg, params, job, dev)
    launches["testbed-tp"] = counts()
    secs["testbed"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cfg, (p14, p22) = in_turn("llada-8b", (m14, m22), 4)
    secs["llada-8b build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    reset()
    out["llada-8b"] = _tp_run(torch, cfg, p14, dev, m14, rank)
    launches["llada-8b-tp"] = counts()
    reset()
    out["llada-8b-2x2"] = _tp_run(torch, cfg, p22, dev, m22, rank,
                                  prefill=False)
    launches["llada-8b-tp-2x2"] = counts()
    secs["llada-8b"] = time.perf_counter() - t0
    del p14, p22
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cfg, (pm,) = in_turn("mixtral-8x22b", (m14,), 2)
    out["mixtral experts"] = pm["blocks"][0]["moe"]["w_gate"].shape[0]
    secs["mixtral-8x22b build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    reset()
    out["mixtral-8x22b"] = _tp_run(torch, cfg, pm, dev, m14, rank,
                                   serve=False)
    launches["mixtral-8x22b-tp"] = counts()
    secs["mixtral-8x22b"] = time.perf_counter() - t0
    return {"out": out, "launches": launches, "secs": secs,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30
            if dev == "cuda" else 0.0}


def _tp_scores(label, want, got, tol) -> dict:
    """One rank's scores ``want`` (argmax, max_prob, margin, neg_entropy)
    against the merged ones ``got`` on the same rows (module docstring's
    tolerances); returns the errors."""
    import torch
    want = [torch.as_tensor(t) for t in want]
    got = [torch.as_tensor(t) for t in got]
    gap = -torch.log1p(-(want[2] / want[1]).clamp(max=1 - 1e-7))
    sure = gap > 2 * tol
    err = {"max_prob_rel": float(((got[1] - want[1]).abs()
                                  / want[1]).max()),
           "neg_entropy": float((got[3] - want[3]).abs().max()),
           "argmax_diff_sure": int(((got[0] != want[0]) & sure).sum()),
           "argmax_diff": int((got[0] != want[0]).sum()),
           "rows": int(want[0].numel()), "sure": int(sure.sum())}
    if err["argmax_diff_sure"] or err["max_prob_rel"] > 2 * tol or \
            err["neg_entropy"] > 2 * tol:
        raise AssertionError(f"tp {label}: scores off one rank's: {err}")
    return err


def tp_phase(torch, conf_mod, testbed: dict) -> dict:
    """Phase 9b's work on one rank (module docstring): the partials kernel
    and the merge, and the one-rank references.  Returns the partials'
    kernel entry fields, the references and the ranks' job (``tp_rank``;
    ``tp_report`` holds the ranks to the references)."""
    t_phase = time.perf_counter()
    dev = MESH_DEVICE
    # 1. the partials kernel and the merge
    entry = None
    errs = []
    for rows, vocab, dtype, offset in PARTIALS_SHAPES:
        r = check_partials(conf_mod, torch, rows, vocab, dtype, offset)
        errs.append(r["max_abs_err"])
        log(f"tp confidence partials rows={rows} V/4={vocab} {dtype} offset "
            f"{offset}: max_abs_err {r['max_abs_err']:.3e} kernel "
            f"{r['ms']:.4f} ms, on the device alone {r['device_ms']:.4f} "
            f"ms; plain {r['plain_ms']:.4f} ms library none bound "
            f"{r['bound_ms']:.4f} ms (bytes); share of the bound on the "
            f"device alone {r['bound_ms'] / r['device_ms']:.3f}")
        if (rows, dtype) == (256, "float32") and entry is None:
            entry = r
    merge_err = 0.0
    for rows, vocab, dtype in MERGE_SHAPES:
        e = check_merge(conf_mod, torch, rows, vocab, dtype)
        merge_err = max(merge_err, e)
        log(f"tp merged scores from {TP_WORLD} shards rows={rows} V={vocab} "
            f"{dtype}: argmaxes equal the unsharded kernel's, margins 0 on "
            f"ties (across shards and across a shard boundary), max abs "
            f"error {e:.3e}")
    entry["max_abs_err"] = max(errs)
    entry["merge_max_abs_err"] = merge_err

    # 2. one rank on this card: the references
    t0 = time.perf_counter()
    want = {"testbed": _tp_decodes(torch, testbed["cfg"],
                                   _to(testbed["params"], dev), testbed,
                                   dev)}
    for name in TP_MODELS:
        cfg, params = _tp_model(torch, name, dev)
        want[name] = _tp_run(torch, cfg, params, dev,
                             serve=name == "llada-8b")
        del params
        torch.cuda.empty_cache()
    log(f"tp one-rank references (testbed decodes, llada-8b {TP_LLADA_LAYERS}"
        f" of 32 layers, mixtral-8x22b {TP_MIXTRAL_LAYERS} of 56): "
        f"{time.perf_counter() - t0:.1f} s")
    job = {k: testbed[k] for k in ("params", "prompt", "gen", "block")}
    job["testbed"] = job.pop("params")
    return {"entry": entry, "want": want, "job": job, "testbed": testbed,
            "s": time.perf_counter() - t_phase}


def tp_report(torch, pre: dict, ranks: list, secs: float) -> dict:
    """Phase 9b's ranks (``tp_rank``' results, ``secs`` on rank 0) held
    to one rank's references (``tp_phase``).  Returns the partials'
    kernel entry fields and the executed launches by path."""
    import numpy as np
    want, testbed = pre["want"], pre["testbed"]
    for r, res in enumerate(ranks):
        log(f"tp rank {r}: peak {res['peak_gib']:.2f} GiB allocated; seconds "
            f"{ {k: round(v, 1) for k, v in res['secs'].items()} }")

    # the testbed: exact
    for name in TP_TESTBED:
        w = want["testbed"][name]
        for r, res in enumerate(ranks):
            g = res["out"]["testbed"][name]
            same = torch.equal(torch.as_tensor(g[0]), w[0]) and \
                tuple(g[1:]) == tuple(w[1:])
            if not same:
                raise AssertionError(f"tp testbed {name}: rank {r}'s decode "
                                     f"differs from one rank's")
        log(f"tp testbed {name} at mesh (1, {TP_WORLD}) (eager, "
            f"{w[0].shape[0]} prompts, gen {testbed['gen']}): tokens, steps "
            f"{w[1]}, forward-equivalents {w[2]} and phases {w[3]} equal "
            f"one rank's on every rank")
    # LLaDA-8B and Mixtral: within their tolerances of one rank
    for name, (_, compute, tol) in TP_MODELS.items():
        w = want[name]
        first = ranks[0]["out"][name]["prefill"]
        for res in ranks[1:]:
            if not all(np.array_equal(a, b) for a, b in
                       zip(first, res["out"][name]["prefill"])):
                raise AssertionError(f"tp {name}: ranks' scores differ")
        err = _tp_scores(f"{name} prefill", w["prefill"], first, tol)
        logits = np.concatenate([res["out"][name]["logits"]
                                 for res in ranks], axis=-1)
        lerr = float(np.abs(logits - w["logits"].numpy()).max())
        if lerr > tol:
            raise AssertionError(f"tp {name}: logits {lerr} off one rank's")
        log(f"tp {name} prefill at mesh (1, {TP_WORLD}) (B={TP_B}, "
            f"L={TP_L}, bf16 weights, {compute} compute): logits max abs "
            f"error {lerr:.3e} (of {float(w['logits'].abs().max()):.2f}; "
            f"tolerance {tol}), scores {err}")
        if name == "mixtral-8x22b":
            experts = {res["out"]["mixtral experts"] for res in ranks}
            log(f"tp mixtral-8x22b: {experts} experts a rank "
                f"(expert-parallel)")
            continue
        for key, mesh in (("llada-8b", (1, TP_WORLD)),
                          ("llada-8b-2x2", (2, TP_WORLD // 2))):
            errs = []
            for step in range(TP_STEPS):
                for r, res in enumerate(ranks):
                    d = r // mesh[1]
                    b = slice(None) if mesh[0] == 1 else slice(d, d + 1)
                    errs.append(_tp_scores(
                        f"{key} serve step {step} rank {r}",
                        [t[b] for t in w["serve"][step]],
                        res["out"][key]["serve"][step], TP_LOGIT_TOL))
            log(f"tp llada-8b serve at mesh {mesh} ({TP_STEPS} steps over a "
                f"{TP_CACHE}-position cache): max-prob rel error "
                f"{max(e['max_prob_rel'] for e in errs):.3e}, Σ p log p "
                f"{max(e['neg_entropy'] for e in errs):.3e}, argmaxes "
                f"differ in {sum(e['argmax_diff'] for e in errs)} of "
                f"{sum(e['rows'] for e in errs)} rank-rows (none where one "
                f"rank's gap exceeds {2 * TP_LOGIT_TOL})")

    launches = {}
    for path in ranks[0]["launches"]:
        launches[path] = {k: sum(res["launches"][path][k] for res in ranks)
                          for k in ranks[0]["launches"][path]}
        if not (launches[path]["flash_attention"]
                and launches[path]["confidence_partials"]):
            raise AssertionError(f"tp {path}: a kernel of the path was not "
                                 f"launched: {launches[path]}")
    log(f"tp executed launches by path (all ranks): {launches}")
    log(f"tp phase: the ranks' part {secs:.1f} s (their times are four "
        f"processes sharing one card, not the speed of four cards); the "
        f"one-rank part {pre['s']:.1f} s")
    return {"entry": pre["entry"], "launches": launches}


# --------------------------------------------------------------------------
# 9c. the sharded training step: FSDP over data, tensor parallelism over
# model, four gloo ranks sharing the one card
# --------------------------------------------------------------------------

FSDP_LLADA_LAYERS = 1
# full-width models' cut depths in the sharded training runs: LLaDA-8B's
# here, the MoE families' in phase 9d (Mixtral-8x22B's one MoE layer,
# DeepSeek-V2's dense MLA layer, first_k_dense = 1)
FSDP_LAYERS = {"llada-8b": FSDP_LLADA_LAYERS, "mixtral-8x22b": 1,
               "deepseek-v2-236b": 1}
# ((mesh, steps) runs, batch rows, positions, tolerance) of each model: the
# testbed (f32, remat "block") two steps at every mesh of four ranks, held
# to one rank within 1e-5 of the scale; LLaDA-8B at full width cut to
# FSDP_LLADA_LAYERS of 32 layers with f32 compute (bf16 rounding could not
# hold four ranks to one), two steps at (2, 2) and one at (4, 1) (its
# gloo-bound step costs 18-33 s there, and the testbed holds two steps at
# that mesh), held within 1e-4 of the scale (its sums run over rows 4096
# and 12288 wide, in another order on a shard).  Every run holds the
# params and both AdamW moments: after step 1 mu is 0.1·g and nu 0.05·g²,
# so a gradient off by a factor or a share shows there, where the params'
# lr·g/(|g| + eps) hides it
FSDP_MODELS = {"testbed": ((((4, 1), 2), ((2, 2), 2), ((1, 4), 2)),
                           16, 64, 1e-5),
               "llada-8b": ((((2, 2), 2), ((4, 1), 1)), 4, 256, 1e-4)}
# the full-depth reckoning's meshes
FSDP_RECKON_MESHES = ((4, 1), (2, 2))


def _fsdp_model(torch, name, dev):
    """(cfg, seeded f32 weights): the testbed, or a model at full width
    cut to its ``FSDP_LAYERS`` layers with f32 compute; remat "block"."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    if name == "testbed":
        cfg = get_config("llada-8b").reduced(**TESTBED, remat="block")
    else:
        cfg = dataclasses.replace(get_config(name),
                                  num_layers=FSDP_LAYERS[name],
                                  dtype="float32", remat="block")
    return cfg, init_model(cfg, torch.Generator(device=dev).manual_seed(SEED),
                           device=dev, dtype=torch.float32)


def _fsdp_batch(torch, cfg, rows, length, dev):
    """Seeded tokens; the first quarter of each row never masked."""
    gen = torch.Generator().manual_seed(SEED + 11)
    tokens = torch.randint(0, cfg.vocab_size - 1, (rows, length),
                           generator=gen)
    maskable = torch.ones(rows, length, dtype=torch.bool)
    maskable[:, :length // 4] = False
    return {"tokens": tokens.to(dev), "maskable": maskable.to(dev)}


def _fsdp_tcfg(rows, length):
    from repro_torch.configs import TrainConfig
    return TrainConfig(batch_size=rows, seq_len=length, steps=100)


def _fsdp_draws(torch, dev, step):
    """The generator of a step's corruption: a new one a step, the same for
    one rank and for four (each of which keeps its rows of the draws)."""
    return torch.Generator(device=dev).manual_seed(SEED + 20 + step)


def _fsdp_sync(torch, dev) -> None:
    if dev == "cuda":
        torch.cuda.synchronize()


def _fsdp_one_rank(torch, name, dev, steps, models) -> dict:
    """One rank's ``steps`` steps of ``make_steps(cfg)["train"]`` on
    the whole batch (its ``grads`` and AdamW, as its ``__call__`` does):
    metrics, seconds a step, the trees of the params and moments after the
    last step, and of where each parameter's gradient was zero or above
    1e-4 of its leaf's max in every step (a gradient within the tolerance
    of zero may step either way: step 1 moves each parameter by
    lr·g/(|g| + eps))."""
    from repro_torch.launch.steps import make_steps
    from repro_torch.training import adamw_init, adamw_update
    from repro_torch.training.optimizer import leaves, tree_map
    from repro_torch.training.trainer import corrupt, masters
    _, rows, length, _ = models[name]
    cfg, init = _fsdp_model(torch, name, dev)
    params = masters(init)
    del init
    step = make_steps(cfg, _fsdp_tcfg(rows, length))["train"]
    opt = adamw_init(params)
    batch = _fsdp_batch(torch, cfg, rows, length, dev)
    sure, mets, secs = None, [], []
    for s in range(steps):
        t0 = time.perf_counter()
        corruption = corrupt(_fsdp_draws(torch, dev, s), batch["tokens"],
                             batch["maskable"], cfg)
        grads, met = step.grads(params, batch, corruption)
        ok = [(g.abs() > 1e-4 * g.abs().max()) | (g == 0)
              for g in leaves(grads)]
        sure = ok if sure is None else [a & b for a, b in zip(sure, ok)]
        params, opt = adamw_update(grads, opt, params, step.sched,
                                   weight_decay=step.tcfg.weight_decay,
                                   clip_norm=step.tcfg.clip_norm)
        del grads, ok
        _fsdp_sync(torch, dev)
        secs.append(time.perf_counter() - t0)
        mets.append({k: float(v) for k, v in met.items()})
    it = iter(sure)
    return {"params": tree_map(lambda p: p.detach(), params),
            "mu": opt.mu, "nu": opt.nu,
            "sure": tree_map(lambda _: next(it), params),
            "metrics": mets, "secs": secs}


def _fsdp_error(torch, mine, specs, mesh, rank, want, sure=None) -> float:
    """max over leaves of max |shard − want's part| / max |want's leaf|
    (on the ``sure`` elements where given): ``mine`` this rank's shards,
    ``want`` the one-rank tree, cut to this rank's part as the shards
    were."""
    from repro_torch.parallel.sharding import shard_tree
    from repro_torch.training.optimizer import leaves
    scales = [max(float(w.abs().max()), 1e-30) for w in leaves(want)]
    part = leaves(shard_tree(want, specs, mesh, rank))
    keep = None if sure is None else leaves(shard_tree(sure, specs, mesh,
                                                       rank))
    err = 0.0
    for i, (m, w) in enumerate(zip(leaves(mine), part)):
        d = (m.detach().to(w.device) - w).abs()
        if keep is not None:
            d = d[keep[i]]
        if d.numel():
            err = max(err, float(d.max()) / scales[i])
    return err


def _fsdp_warm(torch, dev, meshes) -> None:
    """Every rank's first work on the card at once (its context, cuBLAS,
    the flash module, gloo's staging of CUDA tensors)."""
    from repro_torch.models import forward
    from repro_torch.parallel.ctx import activation_mesh, sum_data, sum_model
    from repro_torch.training.trainer import masters
    cfg, init = _fsdp_model(torch, "testbed", dev)
    forward(masters(init), _fsdp_batch(torch, cfg, 1, 16, dev)["tokens"],
            cfg).sum().backward()
    for mesh in meshes.values():
        with activation_mesh(mesh):
            sum_data(sum_model(torch.ones(1, device=dev)))


def _fsdp_runs(torch, rank, models, dev, meshes) -> dict:
    """For each run of ``models`` (a model, a mesh and a number of steps),
    every rank builds the whole seeded weights, keeps its training-layout
    shards, and takes the steps of ``make_steps(cfg, mesh=)["train"]`` on
    its rows of the batch (flash launches counted from 0 just before them,
    read just after); then the ranks in turn, each while the others wait,
    take one rank's steps on the whole batch (``_fsdp_one_rank``) and hold
    their shards of the params and both moments to its trees' parts, each
    rank's shards moved to the host before the turns (Mixtral-8x22B's
    one-rank state needs most of the card).  Returns per
    model and mesh: metrics, seconds a step, flash launches, the peak
    memory above what was held before the steps, the errors, the one-rank
    steps' metrics and seconds, and the comparison's seconds."""
    import torch.distributed as dist
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.launch.steps import make_steps
    from repro_torch.models import init_model
    from repro_torch.parallel.sharding import (param_pspecs, shard_params,
                                               train_rows)
    from repro_torch.training import adamw_init
    from repro_torch.training.optimizer import tree_map
    from repro_torch.training.trainer import masters
    cuda = dev == "cuda"
    out = {}
    for name, (runs, rows, length, _) in models.items():
        for shape, steps in runs:
            mesh = meshes[shape]
            cfg, init = _fsdp_model(torch, name, dev)
            params = masters(shard_params(init, mesh, fsdp=True))
            del init
            if cuda:
                torch.cuda.empty_cache()
            batch = _fsdp_batch(torch, cfg, rows, length, dev)
            step = make_steps(cfg, _fsdp_tcfg(rows, length), mesh=mesh)[
                "train"]
            opt = adamw_init(params)
            idx = torch.as_tensor(train_rows(rows, mesh), device=dev)
            local = {k: v[idx] for k, v in batch.items()}
            _fsdp_sync(torch, dev)
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated() if cuda else 0
            fa_mod.launches = 0
            mets, secs = [], []
            for s in range(steps):
                t0 = time.perf_counter()
                params, opt, met = step(params, opt,
                                        _fsdp_draws(torch, dev, s), local)
                _fsdp_sync(torch, dev)
                secs.append(time.perf_counter() - t0)
                mets.append({k: float(v) for k, v in met.items()})
            launches = fa_mod.launches
            peak = torch.cuda.max_memory_allocated() - held if cuda else 0
            mine = {"params": params, "mu": opt.mu, "nu": opt.nu}
            del params, opt, local, batch
            mine = tree_map(lambda t: t.detach().cpu(), mine)
            if cuda:
                torch.cuda.empty_cache()
            specs = param_pspecs(init_model(cfg, device="meta",
                                            dtype=torch.float32),
                                 mesh, fsdp=True)
            dist.barrier()
            t_cmp = time.perf_counter()
            for r in range(dist.get_world_size()):
                if r == rank:
                    t0 = time.perf_counter()
                    ref = _fsdp_one_rank(torch, name, dev, steps, models)
                    one_rank_s = time.perf_counter() - t0
                    errs = {"params": _fsdp_error(torch, mine["params"],
                                                  specs, mesh, rank,
                                                  ref["params"],
                                                  ref["sure"])}
                    for k in ("mu", "nu"):
                        errs[k] = _fsdp_error(torch, mine[k], specs, mesh,
                                              rank, ref[k])
                    one_rank = {"metrics": ref["metrics"],
                                "secs": ref["secs"], "s": one_rank_s}
                    del ref
                    if cuda:
                        torch.cuda.empty_cache()
                dist.barrier()
            out[f"{name} {shape[0]}x{shape[1]}"] = {
                "metrics": mets, "secs": secs, "launches": launches,
                "steps": steps, "layers": cfg.num_layers,
                "peak_gib": peak / 2 ** 30, "held_gib": held / 2 ** 30,
                "errors": errs, "one_rank": one_rank,
                "compare_s": time.perf_counter() - t_cmp}
            del mine
            if cuda:
                torch.cuda.empty_cache()
    return out


def fsdp_rank(rank: int, job: dict) -> dict:
    """The ``fsdp`` phase's part of one of the four ranks (``mesh_rank``):
    every run of ``FSDP_MODELS`` (``_fsdp_runs``)."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = job["device"]
    meshes = {}
    for runs, *_ in FSDP_MODELS.values():
        for shape, _ in runs:
            if shape not in meshes:
                meshes[shape] = make_mesh(*shape)
    _fsdp_warm(torch, dev, meshes)
    return _fsdp_runs(torch, rank, FSDP_MODELS, dev, meshes)


def _fsdp_reckoning(torch, name, layers, meshes) -> dict:
    """``rank_bytes`` of ``name``'s f32 params on ``meta`` in the training
    layout, at each of ``layers`` depths and each of ``meshes``:
    {(layers, mesh): bytes a rank}."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.parallel.sharding import param_pspecs, rank_bytes
    out = {}
    full = get_config(name)
    for n in layers:
        meta = init_model(dataclasses.replace(full, num_layers=n),
                          device="meta", dtype=torch.float32)
        for data, model in meshes:
            mesh = {"data": data, "model": model}
            out[n, (data, model)] = rank_bytes(
                meta, param_pspecs(meta, mesh, fsdp=True), mesh)
        del meta
    return out


def _fsdp_report(torch, label, ranks, models) -> dict:
    """Hold every run's ranks to one rank (``_fsdp_runs``' results): equal
    metrics on every rank, flash 2 × layers × steps a rank, metrics and
    each rank's shards within the model's tolerance; logs each run with
    its cut depth's ``rank_bytes``.  Returns the flash launches by path,
    summed over the ranks."""
    launches = {}
    for key, res0 in ranks[0].items():
        name, shape = key.split()
        tol = models[name][3]
        want = res0["one_rank"]["metrics"]
        for r, res in enumerate(ranks):
            got = res[key]
            if got["metrics"] != res0["metrics"]:
                raise AssertionError(f"{label} {key}: rank {r}'s metrics "
                                     f"{got['metrics']} differ from rank "
                                     f"0's {res0['metrics']}")
            if got["launches"] != 2 * got["layers"] * got["steps"]:
                raise AssertionError(
                    f"{label} {key}: rank {r} launched flash "
                    f"{got['launches']} times, want 2 x {got['layers']} "
                    f"layers x {got['steps']} steps")
        merr = max(max(abs(g["loss"] - w["loss"]) / abs(w["loss"]),
                       abs(g["acc"] - w["acc"]),
                       abs(g["aux"] - w["aux"]) / max(abs(w["aux"]), 1.0))
                   for g, w in zip(res0["metrics"], want))
        errs = {k: max(res[key]["errors"][k] for res in ranks)
                for k in res0["errors"]}
        if merr > tol or max(errs.values()) > tol:
            raise AssertionError(f"{label} {key}: metrics error {merr:.3e}, "
                                 f"errors {errs} against one rank, "
                                 f"tolerance {tol}")
        launches[f"{name}-fsdp-{shape}"] = {"flash_attention": sum(
            res[key]["launches"] for res in ranks)}
        secs = [s for res in ranks for s in res[key]["secs"]]
        log(f"{label} {name} at mesh {shape} ({res0['layers']} layers, B="
            f"{models[name][1]}, L={models[name][2]}, f32, "
            f"{res0['steps']} steps of make_steps(cfg, mesh=)['train']): "
            f"losses {[round(m['loss'], 6) for m in res0['metrics']]} "
            f"against one rank's {[round(m['loss'], 6) for m in want]}, aux "
            f"{[m['aux'] for m in res0['metrics']]} against "
            f"{[m['aux'] for m in want]}; metrics error "
            f"{merr:.3e}; every rank's shards against its part of one "
            f"rank's trees: "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f" of their leaf's scale (tolerance {tol}; params where every "
            f"step's gradient is 0 or above 1e-4 of its leaf's max; the "
            f"four one-rank runs and comparisons {res0['compare_s']:.1f} s); "
            f"every "
            f"rank's metrics equal; flash {res0['launches']} launches a rank "
            f"(2 x {res0['layers']} x {res0['steps']}); seconds a step (four "
            f"processes sharing one card over gloo) {min(secs):.3f}-"
            f"{max(secs):.3f}, one rank alone "
            + ", ".join(f"{s:.3f}" for s in res0["one_rank"]["secs"]))
        if name == "testbed":
            continue
        cut = res0["layers"]
        b = _fsdp_reckoning(torch, name, (cut,), (tuple(
            map(int, shape.split("x"))),))[cut, tuple(map(int,
                                                         shape.split("x")))]
        for r, res in enumerate(ranks):
            log(f"{label} {key} rank {r}: peak {res[key]['peak_gib']:.2f} "
                f"GiB above the {res[key]['held_gib']:.2f} GiB held before "
                f"the steps; rank_bytes f32 params {b / 2 ** 30:.2f} GiB, "
                f"with gradients and AdamW's moments {4 * b / 2 ** 30:.2f} "
                f"GiB")
    return launches


def _full_depth_reckoning(torch, label, name, meshes) -> None:
    """Logs ``rank_bytes`` of ``name`` at full depth (meta params) at each
    of ``meshes``: f32 params, and with gradients and AdamW's moments."""
    from repro_torch.configs import get_config
    depth = get_config(name).num_layers
    reckon = _fsdp_reckoning(torch, name, (depth,), meshes)
    for shape in meshes:
        b = reckon[depth, shape]
        log(f"{label} reckoning {name} full depth ({depth} layers) at mesh "
            f"{shape}: rank_bytes of the f32 params {b / 2 ** 30:.2f} GiB a "
            f"rank, with gradients and AdamW's two moments "
            f"{4 * b / 2 ** 30:.2f} GiB, against the card's 80 GB (from "
            f"meta params; activations come on top)")


def fsdp_report(torch, ranks: list, secs: float) -> dict:
    """Phase 9c (module docstring) from its ranks' results (``fsdp_rank``,
    ``secs`` on rank 0).  Returns the executed flash launches by path
    (summed over the ranks)."""
    launches = _fsdp_report(torch, "fsdp", ranks, FSDP_MODELS)
    _full_depth_reckoning(torch, "fsdp", "llada-8b", FSDP_RECKON_MESHES)
    log(f"fsdp executed launches by path (all ranks): {launches}")
    log(f"fsdp phase: the ranks' part {secs:.1f} s (four processes "
        f"sharing one card, not the speed of four cards)")
    return {"launches": launches}


# --------------------------------------------------------------------------
# 9d. the MoE families under the mesh: Mixtral-8x22B trained with its
# experts on model and FSDP on data, DeepSeek-V2's MLA served and trained
# on tensor-parallel heads; four gloo ranks sharing the one card
# --------------------------------------------------------------------------

# ((mesh, steps) runs, batch rows, positions, tolerance) of the training
# runs: full width at FSDP_LAYERS' depth (Mixtral-8x22B's one MoE layer,
# its 8 experts 2 a rank at (1, 4) and 4 a rank at (2, 2), there FSDP-cut
# on data; DeepSeek-V2's dense MLA layer, 32 or 64 heads a rank), f32
# masters and compute, remat "block", one step a mesh, held to one rank
# within LLaDA-8B's 1e-4 of the scale.  Mixtral's one-rank state is ~43
# GiB (2.91 B parameters x 16 B), so each rank moves its shards to the
# host before the ranks take the one-rank step in turn
MOE_MESH_TRAIN = {"mixtral-8x22b": ((((1, 4), 1), ((2, 2), 1)), 4, 256,
                                    1e-4),
                  "deepseek-v2-236b": ((((2, 2), 1),), 4, 256, 1e-4)}
# DeepSeek-V2 served at (1, 4): its dense MLA layer and one MoE layer
# (40 of its 160 experts a rank), bf16 weights with f32 compute (in bf16 a
# rounding can move a token near a tie among 160 routed experts to
# another, as Mixtral's in the tp phase); prefill, TP_STEPS serve steps
# over a TP_CACHE-position latent cache and one eager decode, held to one
# rank within TP_F32_TOL (logits; the scores within 2x it) and exactly
# (the decode's tokens, steps and forward-equivalents).  Then the dense
# MLA layer alone (no routing) with bf16 compute: prefill and the serve
# steps, held to one rank as the tp phase holds LLaDA-8B (TP_LOGIT_TOL,
# argmaxes equal wherever one rank's top-2 gap exceeds 2x it)
MOE_MESH_SERVE_LAYERS = 2
MOE_MESH_DECODE = dict(gen_length=32, block_size=32, steps=32,
                       strategy="fdm", k=2)
MOE_MESH_PROMPT = 32
MOE_MESH_RECKON = ((4, 1), (2, 2), (1, 4))


def _moe_mesh_serve_model(torch, dev):
    """DeepSeek-V2 at full width cut to ``MOE_MESH_SERVE_LAYERS`` layers,
    f32 compute over seeded bf16 weights."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    cfg = dataclasses.replace(get_config("deepseek-v2-236b"),
                              num_layers=MOE_MESH_SERVE_LAYERS,
                              dtype="float32")
    return cfg, init_model(cfg, torch.Generator(device=dev).manual_seed(
        SEED), device=dev, dtype=torch.bfloat16)


def _moe_mesh_bf16(cfg, params):
    """(cfg, params) of DeepSeek-V2's dense MLA layer alone (the first of
    ``params``' blocks, whole or a rank's shards) with bf16 compute."""
    return (dataclasses.replace(cfg, num_layers=1, dtype="bfloat16"),
            dict(params, blocks=params["blocks"][:1]))


def _moe_mesh_decode(torch, cfg, params, dev) -> tuple:
    """One eager ``Decoder.generate`` (``MOE_MESH_DECODE``) of a seeded
    prompt: (tokens, steps, forward-equivalents)."""
    from repro_torch.configs import DecodeConfig
    from repro_torch.core import Decoder
    gen = torch.Generator().manual_seed(SEED + 12)
    prompt = torch.randint(0, cfg.vocab_size - 1, (1, MOE_MESH_PROMPT),
                           generator=gen).to(dev)
    dcfg = DecodeConfig(**MOE_MESH_DECODE, fused_loop=False)
    toks, st = Decoder(params, cfg, dcfg, device=dev).generate(None, prompt)
    return toks.cpu(), st.steps, st.forward_equivalents


def moe_mesh_rank(rank: int, job: dict) -> dict:
    """The ``moe-mesh`` phase's part of one of the four ranks
    (``mesh_rank``): the training runs of ``MOE_MESH_TRAIN``
    (``_fsdp_runs``, the shards moved to the host for the one-rank turns),
    then DeepSeek-V2 served at (1, 4) (the whole weights built two ranks at
    a time, each keeping its serving-layout shard): prefill, serve steps
    and the eager decode in f32 compute, then prefill and serve steps of
    its dense MLA layer in bf16 compute (``_moe_mesh_bf16``); each path's
    kernel counts set to 0 just before it and read just after."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import confidence as conf_mod
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.ctx import activation_mesh
    from repro_torch.parallel.sharding import shard_params
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = job["device"]
    cuda = dev == "cuda"
    meshes = {shape: make_mesh(*shape) for shape in ((1, 4), (2, 2))}
    _fsdp_warm(torch, dev, meshes)
    out = {"train": _fsdp_runs(torch, rank, MOE_MESH_TRAIN, dev, meshes)}
    m14 = meshes[(1, 4)]
    t0 = time.perf_counter()
    for turn in range(0, TP_WORLD, 2):
        if turn <= rank < turn + 2:
            cfg, full = _moe_mesh_serve_model(torch, dev)
            params = shard_params(full, m14)
            del full
            if cuda:
                torch.cuda.empty_cache()
        dist.barrier()
    build_s = time.perf_counter() - t0
    attn = params["blocks"][0]["attn"]
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    def counts():
        return {"flash_attention": fa_mod.launches,
                "confidence": conf_mod.launches,
                "confidence_partials": conf_mod.partials_launches}
    fa_mod.launches = conf_mod.launches = conf_mod.partials_launches = 0
    t0 = time.perf_counter()
    res = _tp_run(torch, cfg, params, dev, m14, rank)
    with activation_mesh(m14):
        res["decode"] = _moe_mesh_decode(torch, cfg, params, dev)
    _fsdp_sync(torch, dev)
    out["serve"] = {
        "out": res, "secs": {"build": build_s,
                             "serve": time.perf_counter() - t0},
        "launches": counts(),
        "heads": attn["wk_b"].shape[1] // cfg.mla.qk_nope_head_dim,
        "latent": attn["wkv_a"].shape[1],
        "experts": params["blocks"][1]["moe"]["w_gate"].shape[0]}
    fa_mod.launches = conf_mod.launches = conf_mod.partials_launches = 0
    t0 = time.perf_counter()
    res = _tp_run(torch, *_moe_mesh_bf16(cfg, params), dev, m14, rank)
    out["serve_bf16"] = {"out": res, "launches": counts(),
                         "secs": {"serve": time.perf_counter() - t0}}
    out["serve"]["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30 \
        if cuda else 0.0
    return out


def _moe_mesh_served(label, want, one, serve, tol) -> tuple:
    """Every rank's DeepSeek-V2 serving (``_tp_run``' outputs) against one
    rank's ``want``: the prefill scores equal on every rank and within
    ``tol`` (``_tp_scores``), the logits gathered over the ranks within
    ``tol``, each serve step's scores within ``tol``, and each rank's flash
    and partials launches equal to one rank's flash and confidence
    launches (``one``).  Returns (logits error, [prefill scores' errors,
    then the serve steps'])."""
    import numpy as np
    import torch
    first = serve[0]["out"]["prefill"]
    for res in serve[1:]:
        if not all(np.array_equal(a, b)
                   for a, b in zip(first, res["out"]["prefill"])):
            raise AssertionError(f"moe-mesh deepseek {label}: ranks' "
                                 f"scores differ")
    errs = [_tp_scores(f"deepseek-v2-236b {label} prefill", want["prefill"],
                       first, tol)]
    logits = np.concatenate([res["out"]["logits"] for res in serve], axis=-1)
    lerr = float(np.abs(logits - want["logits"].numpy()).max())
    if lerr > tol:
        raise AssertionError(f"moe-mesh deepseek {label}: logits {lerr} off "
                             f"one rank's (tolerance {tol})")
    errs += [_tp_scores(f"deepseek-v2-236b {label} serve step {i} rank {r}",
                        want["serve"][i], res["out"]["serve"][i], tol)
             for i in range(TP_STEPS) for r, res in enumerate(serve)]
    for r, res in enumerate(serve):
        n = res["launches"]
        if (n["flash_attention"], n["confidence_partials"],
                n["confidence"]) != (one["flash_attention"],
                                     one["confidence"], 0):
            raise AssertionError(
                f"moe-mesh deepseek {label}: rank {r} launched {n}; one "
                f"rank launched {one} (each rank's flash and partials must "
                f"equal one rank's flash and confidence)")
    return lerr, errs


def moe_mesh_phase(torch, conf_mod, fa_mod, ptxas: dict) -> dict:
    """Phase 9d's work on one rank (module docstring): the f32 flash
    kernel's ptxas report at (192, 128), and DeepSeek-V2's one-rank
    serving references, which ``moe_mesh_report`` holds the ranks to."""
    t_phase = time.perf_counter()
    dev = MESH_DEVICE
    for fn, rep in ptxas_report(ptxas.get("flash_attention", "")).items():
        if fn.endswith("flash_kernel<float,192,128>"):
            log(f"moe-mesh f32 flash at MLA's (192, 128), the training "
                f"path's: ptxas {fn}: {rep}")
    # one rank on this card: DeepSeek-V2's serving references
    t0 = time.perf_counter()
    cfg, params = _moe_mesh_serve_model(torch, dev)
    fa_mod.launches = conf_mod.launches = conf_mod.partials_launches = 0
    want = _tp_run(torch, cfg, params, dev)
    want["decode"] = _moe_mesh_decode(torch, cfg, params, dev)
    one = {"flash_attention": fa_mod.launches,
           "confidence": conf_mod.launches}
    fa_mod.launches = conf_mod.launches = 0
    want16 = _tp_run(torch, *_moe_mesh_bf16(cfg, params), dev)
    one16 = {"flash_attention": fa_mod.launches,
             "confidence": conf_mod.launches}
    del params
    torch.cuda.empty_cache()
    log(f"moe-mesh one-rank references (deepseek-v2-236b "
        f"{MOE_MESH_SERVE_LAYERS} of 60 layers: prefill, {TP_STEPS} serve "
        f"steps, one eager decode; its dense MLA layer in bf16: prefill and "
        f"the serve steps): {time.perf_counter() - t0:.1f} s; launches "
        f"{one}, bf16 {one16}")
    return {"want": want, "one": one, "want16": want16, "one16": one16,
            "s": time.perf_counter() - t_phase}


def moe_mesh_report(torch, pre: dict, ranks: list, secs: float) -> dict:
    """Phase 9d (module docstring) from its ranks' results
    (``moe_mesh_rank``, ``secs`` on rank 0) and ``moe_mesh_phase``'s
    references.  Returns the executed launches by path (summed over the
    ranks)."""
    want, one, want16, one16 = (pre[k] for k in ("want", "one", "want16",
                                                 "one16"))
    launches = _fsdp_report(torch, "moe-mesh", [r["train"] for r in ranks],
                            MOE_MESH_TRAIN)

    # DeepSeek-V2 served at (1, 4): within TP_F32_TOL of one rank, the
    # decode exact; its dense MLA layer in bf16 within TP_LOGIT_TOL
    serve = [r["serve"] for r in ranks]
    lerr, errs = _moe_mesh_served("f32 compute", want, one, serve,
                                  TP_F32_TOL)
    for r, res in enumerate(serve):
        got = res["out"]["decode"]
        if not (torch.equal(torch.as_tensor(got[0]), want["decode"][0])
                and tuple(got[1:]) == tuple(want["decode"][1:])):
            raise AssertionError(f"moe-mesh deepseek: rank {r}'s decode "
                                 f"differs from one rank's")
    s0 = serve[0]
    log(f"moe-mesh deepseek-v2-236b served at mesh (1, {TP_WORLD}) "
        f"({MOE_MESH_SERVE_LAYERS} layers, {s0['heads']} heads, "
        f"{s0['latent']} of the latent's 576 columns and {s0['experts']} "
        f"experts a rank; bf16 weights, f32 compute): prefill (B={TP_B}, "
        f"L={TP_L}) logits max abs error {lerr:.3e} (of "
        f"{float(want['logits'].abs().max()):.2f}; tolerance {TP_F32_TOL}),"
        f" scores {errs[0]}; {TP_STEPS} serve steps over a {TP_CACHE}-"
        f"position latent cache: max-prob rel error "
        f"{max(e['max_prob_rel'] for e in errs[1:]):.3e}, Σ p log p "
        f"{max(e['neg_entropy'] for e in errs[1:]):.3e}, argmaxes differ in "
        f"{sum(e['argmax_diff'] for e in errs[1:])} of "
        f"{sum(e['rows'] for e in errs[1:])} rank-rows; the eager decode "
        f"(fdm, gen {MOE_MESH_DECODE['gen_length']}): tokens, steps "
        f"{want['decode'][1]} and forward-equivalents {want['decode'][2]} "
        f"equal one rank's on every rank; launches a rank "
        f"{s0['launches']} (one rank's {one})")
    serve16 = [r["serve_bf16"] for r in ranks]
    lerr, errs = _moe_mesh_served("bf16 compute", want16, one16, serve16,
                                  TP_LOGIT_TOL)
    log(f"moe-mesh deepseek-v2-236b's dense MLA layer served at mesh (1, "
        f"{TP_WORLD}) in bf16 compute (1 layer, {s0['heads']} heads a "
        f"rank): prefill logits max abs error {lerr:.3e} (of "
        f"{float(want16['logits'].abs().max()):.2f}; tolerance "
        f"{TP_LOGIT_TOL}), scores {errs[0]}; {TP_STEPS} serve steps: "
        f"max-prob rel error {max(e['max_prob_rel'] for e in errs[1:]):.3e}"
        f", Σ p log p {max(e['neg_entropy'] for e in errs[1:]):.3e}, "
        f"argmaxes differ in {sum(e['argmax_diff'] for e in errs[1:])} of "
        f"{sum(e['rows'] for e in errs[1:])} rank-rows (none where one "
        f"rank's gap exceeds {2 * TP_LOGIT_TOL}); launches a rank "
        f"{serve16[0]['launches']} (one rank's {one16})")
    for r, res in enumerate(serve):
        log(f"moe-mesh deepseek rank {r}: peak {res['peak_gib']:.2f} GiB "
            f"allocated; seconds {res['secs']}, bf16 "
            f"{serve16[r]['secs']}")
    for path, runs in (("deepseek-v2-236b-tp", serve),
                       ("deepseek-v2-236b-tp-bf16", serve16)):
        launches[path] = {k: sum(res["launches"][k] for res in runs)
                          for k in runs[0]["launches"]}
    for name in MOE_MESH_TRAIN:
        _full_depth_reckoning(torch, "moe-mesh", name, MOE_MESH_RECKON)
    for path, n in launches.items():
        if not n.get("flash_attention") or (
                "-tp" in path and not n["confidence_partials"]):
            raise AssertionError(f"moe-mesh {path}: a kernel of the path "
                                 f"was not launched: {n}")
    log(f"moe-mesh executed launches by path (all ranks): {launches}")
    log(f"moe-mesh phase: the ranks' part {secs:.1f} s (four processes "
        f"sharing one card, not the speed of four cards); the one-rank part "
        f"{pre['s']:.1f} s")
    return {"launches": launches}


# --------------------------------------------------------------------------
# 9b-9d in one spawn: the three phases' ranks run in the same four
# processes (one start, one process group), each phase's checks on one
# rank before it and its report after it
# --------------------------------------------------------------------------

MESH_PARTS = (("tp", tp_rank), ("fsdp", fsdp_rank),
              ("moe-mesh", moe_mesh_rank))


def mesh_rank(rank: int, job: dict) -> dict:
    """One of the four ranks of phases 9b-9d (``parallel.launch.spawn``):
    ``MESH_PARTS``' rank functions in turn, each part's results beside its
    seconds, the card's cache emptied between parts."""
    import torch
    out = {}
    for key, fn in MESH_PARTS:
        t0 = time.perf_counter()
        out[key] = (fn(rank, job), time.perf_counter() - t0)
        if job["device"] == "cuda":
            torch.cuda.empty_cache()
    return out


def mesh_phases(torch, conf_mod, fa_mod, testbed: dict, ptxas: dict):
    """Phases 9b-9d (module docstring): the tp and moe-mesh phases' work
    on one rank, then four gloo ranks sharing this card (``mesh_rank``,
    expandable segments in the card's allocator), then each phase's
    report.  Returns the tp, fsdp and moe-mesh phases' results."""
    from repro_torch.parallel.launch import spawn
    tp = tp_phase(torch, conf_mod, testbed)
    moe = moe_mesh_phase(torch, conf_mod, fa_mod, ptxas)
    torch.cuda.empty_cache()
    store = os.path.join(ROOT, "build", "mesh_store", "store")
    os.makedirs(os.path.dirname(store), exist_ok=True)
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    t0 = time.perf_counter()
    try:
        ranks = spawn(mesh_rank, TP_WORLD, "gloo", store,
                      dict(tp["job"], device=MESH_DEVICE), timeout_s=900)
    finally:
        if alloc is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    spawn_s = time.perf_counter() - t0

    def part(key):
        return [r[key][0] for r in ranks], ranks[0][key][1]
    out = (tp_report(torch, tp, *part("tp")),
           fsdp_report(torch, *part("fsdp")),
           moe_mesh_report(torch, moe, *part("moe-mesh")))
    log(f"mesh phases: four ranks in {spawn_s:.1f} s, of which rank 0's "
        f"parts " + ", ".join(f"{k} {ranks[0][k][1]:.1f}"
                              for k, _ in MESH_PARTS) + " s")
    return out


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
    from repro_torch.configs import get_config
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
    # no spills allowed in the bf16 attention kernels at d=64, 80 and 128
    # and at MLA's (192, 128),
    # in both scan passes at NP=16 (Hymba's N) and in the four confidence
    # kernels (each dtype, the scores' and the partials' epilogue; at most
    # 64 registers: four CTAs per SM)
    no_spill = (r"tc::flash_tc_kernel<(64,64|80,80|128,128|192,128)>"
                r"|sscan_chunk_kernel<16,[01]>"
                r"|confidence_kernel<(float|bf16),[01]>")
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
                fn.startswith("confidence_kernel<") for fn in report) != 4:
            raise AssertionError(f"not one confidence kernel per dtype and "
                                 f"epilogue (scores, partials) in the ptxas "
                                 f"report: {sorted(report)}")
    mma = sass_mma_counts(libs["flash_attention"])
    tc_counts = {fn: n for fn, n in mma.items() if "flash_tc_kernel" in fn}
    log(f"sass flash_attention: HMMA/HGMMA per kernel: "
        f"{json.dumps(mma, sort_keys=True)}")
    want_tc = {f"tc::flash_tc_kernel<{dq},{dv}>"
               for dq, dv in FLASH_HEAD_DIM_PAIRS}
    if set(tc_counts) != want_tc or not all(tc_counts.values()):
        raise AssertionError(f"the bf16 attention kernels are not one per "
                             f"head dim pair of {FLASH_HEAD_DIM_PAIRS}, all "
                             f"on the tensor cores: {tc_counts}")

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
    for rows, vocab, dtype in MOE_CONF_SHAPES:
        r = check_confidence(conf_mod, torch, rows, vocab, dtype)
        conf_errs.append(r["max_abs_err"])
        log(f"confidence (mixtral) rows={rows} V={vocab} {dtype}: "
            f"max_abs_err {r['max_abs_err']} kernel {r['ms']:.4f} ms, on "
            f"the device alone {r['device_ms']:.4f} ms; plain "
            f"{r['plain_ms']:.4f} ms library none bound {r['bound_ms']:.4f} "
            f"ms (bytes); share of the bound on the device alone "
            f"{r['bound_ms'] / r['device_ms']:.3f}")
    for rows, vocab, dtype in DEEPSEEK_CONF_SHAPES:
        r = check_confidence(conf_mod, torch, rows, vocab, dtype)
        conf_errs.append(r["max_abs_err"])
        log(f"confidence (deepseek) rows={rows} V={vocab} {dtype}: "
            f"max_abs_err {r['max_abs_err']} kernel {r['ms']:.4f} ms, on "
            f"the device alone {r['device_ms']:.4f} ms; plain "
            f"{r['plain_ms']:.4f} ms library none bound {r['bound_ms']:.4f} "
            f"ms (bytes); share of the bound on the device alone "
            f"{r['bound_ms'] / r['device_ms']:.3f}")
    for rows, vocab, dtype in WHISPER_CONF_SHAPES:
        r = check_confidence(conf_mod, torch, rows, vocab, dtype)
        conf_errs.append(r["max_abs_err"])
        log(f"confidence (whisper) rows={rows} V={vocab} {dtype}: "
            f"max_abs_err {r['max_abs_err']} kernel {r['ms']:.4f} ms, on "
            f"the device alone {r['device_ms']:.4f} ms; plain "
            f"{r['plain_ms']:.4f} ms library none bound {r['bound_ms']:.4f} "
            f"ms (bytes); share of the bound on the device alone "
            f"{r['bound_ms'] / r['device_ms']:.3f}")
    for label, shapes in (("qwen2-vl", VLM_CONF_SHAPES),
                          ("xlstm", XLSTM_CONF_SHAPES)):
        for rows, vocab, dtype in shapes:
            r = check_confidence(conf_mod, torch, rows, vocab, dtype)
            conf_errs.append(r["max_abs_err"])
            log(f"confidence ({label}) rows={rows} V={vocab} {dtype}: "
                f"max_abs_err {r['max_abs_err']} kernel {r['ms']:.4f} ms, "
                f"on the device alone {r['device_ms']:.4f} ms; plain "
                f"{r['plain_ms']:.4f} ms library none bound "
                f"{r['bound_ms']:.4f} ms (bytes); share of the bound on the "
                f"device alone {r['bound_ms'] / r['device_ms']:.3f}")
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
    for b, lq, lk, h, g, d, w, qo, dt in ARCH_ATTN_SHAPES:
        r = check_attention(fa_mod, torch, b, lq, lk, h, g, d, w, qo, dt)
        attn_errs.append(r["max_abs_err"])
        log(f"attention (dense GQA family) B={b} Lq={lq} Lk={lk} H={h} "
            f"G={g} d={d} window={w} q_offset={qo} {dt}: max_abs_err "
            f"{r['max_abs_err']} kernel {r['ms']:.4f} ms plain "
            f"{r['plain_ms']:.4f} ms sdpa {r['library_ms']:.4f} ms; on the "
            f"device alone kernel {r['device_ms']:.4f} ms sdpa "
            f"{r['library_device_ms']:.4f} ms (kernel/sdpa "
            f"{r['device_ms'] / r['library_device_ms']:.3f}); bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), share of the bound "
            f"on the device alone {r['bound_ms'] / r['device_ms']:.3f}")
    for b, lq, lk, h, g, d, w, qo, dt in MOE_ATTN_SHAPES:
        r = check_attention(fa_mod, torch, b, lq, lk, h, g, d, w, qo, dt)
        attn_errs.append(r["max_abs_err"])
        log(f"attention (mixtral) B={b} Lq={lq} Lk={lk} H={h} G={g} d={d} "
            f"window={w} q_offset={qo} {dt}: max_abs_err "
            f"{r['max_abs_err']} kernel {r['ms']:.4f} ms plain "
            f"{r['plain_ms']:.4f} ms sdpa {r['library_ms']:.4f} ms; on the "
            f"device alone kernel {r['device_ms']:.4f} ms sdpa "
            f"{r['library_device_ms']:.4f} ms (kernel/sdpa "
            f"{r['device_ms'] / r['library_device_ms']:.3f}); bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), share of the bound "
            f"on the device alone {r['bound_ms'] / r['device_ms']:.3f}")
    for b, lq, lk, h, g, d, dv, w, qo, dt in MLA_ATTN_SHAPES:
        r = check_attention(fa_mod, torch, b, lq, lk, h, g, d, w, qo, dt, dv)
        attn_errs.append(r["max_abs_err"])
        log(f"attention (deepseek mla) B={b} Lq={lq} Lk={lk} H={h} G={g} "
            f"dqk={d} dv={dv} window={w} q_offset={qo} {dt}: max_abs_err "
            f"{r['max_abs_err']} kernel {r['ms']:.4f} ms plain "
            f"{r['plain_ms']:.4f} ms sdpa {r['library_ms']:.4f} ms; on the "
            f"device alone kernel {r['device_ms']:.4f} ms sdpa "
            f"{r['library_device_ms']:.4f} ms (kernel/sdpa "
            f"{r['device_ms'] / r['library_device_ms']:.3f}); bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), share of the bound "
            f"on the device alone {r['bound_ms'] / r['device_ms']:.3f}")
    for b, lq, lk, h, g, d, w, qo, dt in WHISPER_ATTN_SHAPES:
        r = check_attention(fa_mod, torch, b, lq, lk, h, g, d, w, qo, dt)
        attn_errs.append(r["max_abs_err"])
        log(f"attention (whisper) B={b} Lq={lq} Lk={lk} H={h} G={g} d={d} "
            f"{dt}: max_abs_err {r['max_abs_err']} kernel {r['ms']:.4f} ms "
            f"plain {r['plain_ms']:.4f} ms sdpa {r['library_ms']:.4f} ms; on "
            f"the device alone kernel {r['device_ms']:.4f} ms sdpa "
            f"{r['library_device_ms']:.4f} ms (kernel/sdpa "
            f"{r['device_ms'] / r['library_device_ms']:.3f}); bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), share of the bound "
            f"on the device alone {r['bound_ms'] / r['device_ms']:.3f}")
    for b, lq, lk, h, g, d, w, qo, dt in VLM_ATTN_SHAPES:
        r = check_attention(fa_mod, torch, b, lq, lk, h, g, d, w, qo, dt)
        attn_errs.append(r["max_abs_err"])
        log(f"attention (qwen2-vl) B={b} Lq={lq} Lk={lk} H={h} G={g} d={d} "
            f"{dt}: max_abs_err {r['max_abs_err']} kernel {r['ms']:.4f} ms "
            f"plain {r['plain_ms']:.4f} ms sdpa {r['library_ms']:.4f} ms; on "
            f"the device alone kernel {r['device_ms']:.4f} ms sdpa "
            f"{r['library_device_ms']:.4f} ms (kernel/sdpa "
            f"{r['device_ms'] / r['library_device_ms']:.3f}); bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), share of the bound "
            f"on the device alone {r['bound_ms'] / r['device_ms']:.3f}")
    for b, lq, lk, h, g, d, w, qo, dt in FSDP_ATTN_SHAPES:
        r = check_attention(fa_mod, torch, b, lq, lk, h, g, d, w, qo, dt)
        attn_errs.append(r["max_abs_err"])
        log(f"attention (sharded training) B={b} Lq={lq} Lk={lk} H={h} "
            f"G={g} d={d} {dt}: max_abs_err {r['max_abs_err']} kernel "
            f"{r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms sdpa "
            f"{r['library_ms']:.4f} ms; on the device alone kernel "
            f"{r['device_ms']:.4f} ms sdpa {r['library_device_ms']:.4f} ms "
            f"(kernel/sdpa {r['device_ms'] / r['library_device_ms']:.3f}); "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), share of the "
            f"bound on the device alone "
            f"{r['bound_ms'] / r['device_ms']:.3f}")
    for b, lq, lk, h, g, d, w, qo, dt in MOE_MESH_ATTN_SHAPES:
        r = check_attention(fa_mod, torch, b, lq, lk, h, g, d, w, qo, dt)
        attn_errs.append(r["max_abs_err"])
        log(f"attention (mixtral under the mesh) B={b} Lq={lq} Lk={lk} "
            f"H={h} G={g} d={d} window={w} {dt}: max_abs_err "
            f"{r['max_abs_err']} kernel {r['ms']:.4f} ms plain "
            f"{r['plain_ms']:.4f} ms sdpa {r['library_ms']:.4f} ms; on the "
            f"device alone kernel {r['device_ms']:.4f} ms sdpa "
            f"{r['library_device_ms']:.4f} ms (kernel/sdpa "
            f"{r['device_ms'] / r['library_device_ms']:.3f}); bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), share of the bound "
            f"on the device alone {r['bound_ms'] / r['device_ms']:.3f}")
    for b, lq, lk, h, g, d, dv, w, qo, dt in MOE_MESH_MLA_SHAPES:
        r = check_attention(fa_mod, torch, b, lq, lk, h, g, d, w, qo, dt, dv)
        attn_errs.append(r["max_abs_err"])
        log(f"attention (deepseek mla under the mesh) B={b} Lq={lq} "
            f"Lk={lk} H={h} dqk={d} dv={dv} {dt}: max_abs_err "
            f"{r['max_abs_err']} kernel {r['ms']:.4f} ms plain "
            f"{r['plain_ms']:.4f} ms sdpa {r['library_ms']:.4f} ms; on the "
            f"device alone kernel {r['device_ms']:.4f} ms sdpa "
            f"{r['library_device_ms']:.4f} ms (kernel/sdpa "
            f"{r['device_ms'] / r['library_device_ms']:.3f}); bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), share of the bound "
            f"on the device alone {r['bound_ms'] / r['device_ms']:.3f}")
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
    # the decode state's kernel calls: flash at Lq = 1 with the count read
    # on the card, the scan from h0 with its end state, confidence at the
    # serve step's rows
    for b, lk, h, g, d, n, dt in DECODE_ATTN_SHAPES:
        r = check_attention(fa_mod, torch, b, 1, lk, h, g, d, 0, 0, dt,
                            kv_len=n)
        attn_errs.append(r["max_abs_err"])
        log(f"attention (decode, valid count on the card, q x "
            f"{DECODE_Q_SCALE}) B={b} Lq=1 Lk={lk} H={h} G={g} d={d} "
            f"count={n} {dt}: max_abs_err {r['max_abs_err']}, of the "
            f"output's max |value| {r['rel_err']:.2e}, masked keys' effect "
            f"{r.get('count_effect')} of it; kernel {r['ms']:.4f} ms plain "
            f"{r['plain_ms']:.4f} ms sdpa {r['library_ms']:.4f} ms; on the "
            f"device alone kernel {r['device_ms']:.4f} ms sdpa "
            f"{r['library_device_ms']:.4f} ms (kernel/sdpa "
            f"{r['device_ms'] / r['library_device_ms']:.3f}); bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), share of the bound "
            f"on the device alone {r['bound_ms'] / r['device_ms']:.3f}")
        if (b, lk, h, n, dt) == (SERVE_B, SERVE_CACHE, 32, SERVE_CACHE,
                                 "bfloat16"):
            attn_serve = r
    for b, l, di, n, xdt in SCAN_STATE_SHAPES:
        r = check_scan(scan_mod, torch, b, l, di, n, xdt, state=True)
        scan_errs.append(r["max_abs_err"])
        log(f"selective_scan from h0 with its end state B={b} L={l} "
            f"di={di} N={n} x {xdt}: max_abs_err {r['max_abs_err']} kernel "
            f"{r['ms']:.4f} ms, on the device alone {r['device_ms']:.4f} "
            f"ms; plain {r['plain_ms']:.4f} ms library none bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), two-pass exp floor "
            f"{r['design_floor_ms']:.4f} ms")
        if l == 2048:
            scan_state = r
    for rows, vocab, dtype in SERVE_CONF_SHAPES:
        r = check_confidence(conf_mod, torch, rows, vocab, dtype)
        conf_errs.append(r["max_abs_err"])
        conf_entry["max_abs_err"] = max(conf_errs)
        log(f"confidence (serve step) rows={rows} V={vocab} {dtype}: "
            f"max_abs_err {r['max_abs_err']} kernel {r['ms']:.4f} ms, on "
            f"the device alone {r['device_ms']:.4f} ms; plain "
            f"{r['plain_ms']:.4f} ms library none bound {r['bound_ms']:.4f} "
            f"ms (bytes); share of the bound on the device alone "
            f"{r['bound_ms'] / r['device_ms']:.3f}")
        conf_serve = r
    attn_entry["max_abs_err"] = max(attn_errs)
    scan_entry["max_abs_err"] = max(scan_errs)

    # 4. end-to-end agreement with the CPU reference on small configs
    t0 = time.perf_counter()
    reference_phase(torch, "llada-8b", REFERENCE_POLICIES, drivers=DRIVERS)
    reference_phase(torch, "hymba-1.5b", ["none"], drivers=DRIVERS)
    log(f"reference phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name, over in ARCH_REFERENCE:
        reference_phase(torch, name, POLICIES, over, ARCH_CASES)
    log(f"reference phase (dense GQA family): "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name, over in MOE_REFERENCE:
        reference_phase(torch, name, POLICIES, over, ARCH_CASES)
    moe_dispatch_phase(torch)
    log(f"reference and dispatch phase (mixtral): "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name, over in DEEPSEEK_REFERENCE:
        reference_phase(torch, name, POLICIES, over, ARCH_CASES)
    log(f"reference phase (deepseek): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    reference_phase(torch, "whisper-medium", ["none"], conditioned=True)
    reference_phase(torch, "whisper-medium", ["prefix", "dual"],
                    cases=ARCH_CASES)
    log(f"reference phase (whisper): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    reference_phase(torch, "qwen2-vl-72b", ["none"], cases=ARCH_CASES,
                    conditioned=True)
    reference_phase(torch, "qwen2-vl-72b", ["prefix", "dual"],
                    cases=ARCH_CASES)
    # the reduced pattern "mmmmmms" puts both reduced layers on the mLSTM:
    # the variant "ms" makes layer 1 an sLSTM
    xlstm_ms = dataclasses.replace(get_config("xlstm-125m").reduced().ssm,
                                   xlstm_pattern="ms")
    reference_phase(torch, "xlstm-125m", ["none"], dict(ssm=xlstm_ms),
                    ARCH_CASES)
    log(f"reference phase (qwen2-vl, xlstm): "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    steps_reference_phase(torch)
    log(f"reference phase (decode_step, forward_window): "
        f"{time.perf_counter() - t0:.1f} s")

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
    t0 = time.perf_counter()
    carry = carry_phase(torch, cfg, params, mods)
    log(f"carry phase llada-8b: {time.perf_counter() - t0:.1f} s")
    clear_decode_cache()
    t0 = time.perf_counter()
    llada_serve = serve_step_phase(torch, cfg, params, mods, SERVE_B,
                                   SERVE_CACHE, SERVE_CACHE - 1)
    log(f"serve step phase llada-8b: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    prefill = prefill_phase(torch, cfg, params, mods)
    log(f"dryrun and prefill_32k phase llada-8b: "
        f"{time.perf_counter() - t0:.1f} s")
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
    t0 = time.perf_counter()
    hymba_serve = serve_step_phase(
        torch, cfg, params, {"confidence": conf_mod,
                             "flash_attention": fa_mod,
                             "selective_scan": scan_mod}, 1, LONG_POS + 1,
        LONG_POS, window=32)
    log(f"serve step phase hymba-1.5b: {time.perf_counter() - t0:.1f} s")
    del params
    torch.cuda.empty_cache()
    archs = {}
    for name, policies in ARCH_SERVING:
        t0 = time.perf_counter()
        cfg, params = make_model(torch, name)
        for policy in policies:
            with decode_cache_scope() as scope:
                archs[name + ("" if policy == "none" else f"-{policy}")] = \
                    serving_phase(torch, cfg, params, {
                        "confidence": conf_mod, "flash_attention": fa_mod},
                        scope, policy)
        del scope
        clear_decode_cache()
        del params
        torch.cuda.empty_cache()
        log(f"serving phase {name}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mixtral = moe_model_phase(torch, {"confidence": conf_mod,
                                      "flash_attention": fa_mod},
                              "mixtral-8x22b", MIXTRAL_LAYERS, MIXTRAL_LONG)
    log(f"serving phase mixtral-8x22b: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    deepseek = moe_model_phase(torch, {"confidence": conf_mod,
                                       "flash_attention": fa_mod},
                               "deepseek-v2-236b", DEEPSEEK_LAYERS,
                               DEEPSEEK_LONG)
    log(f"serving phase deepseek-v2-236b: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    whisper = whisper_phase(torch, {"confidence": conf_mod,
                                    "flash_attention": fa_mod})
    log(f"decode phase whisper-medium: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    vlm = vlm_phase(torch, {"confidence": conf_mod, "flash_attention": fa_mod})
    log(f"serving phase qwen2-vl-72b: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    xlstm = xlstm_phase(torch, {"confidence": conf_mod})
    log(f"serving phase xlstm-125m: {time.perf_counter() - t0:.1f} s")

    # 7.-10. training: the flash gradient, one step against the CPU, the
    # testbed trained and decoded, full-width LLaDA-8B's steps
    t0 = time.perf_counter()
    flash_grad = flash_grad_phase(torch, fa_mod, conf_mod)
    log(f"flash gradient phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    scan_grad = scan_grad_phase(torch, scan_mod)
    log(f"scan gradient phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_step_phase(torch)
    train_step_phase(torch, get_config("hymba-1.5b").reduced())
    train_step_phase(torch, get_config("mixtral-8x22b").reduced())
    train_step_phase(torch, get_config("deepseek-v2-236b").reduced())
    log(f"train step phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    testbed = testbed_phase(torch)
    clear_decode_cache()
    log(f"testbed phase: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    tp, fsdp, moe_mesh = mesh_phases(torch, conf_mod, fa_mod, testbed,
                                     _build.last_build["ptxas"])
    del testbed
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    training = full_train_phase(torch, {"flash_attention": fa_mod})
    log(f"full-width training phase: {time.perf_counter() - t0:.1f} s")
    clear_decode_cache()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    hymba_train = full_train_phase(
        torch, {"flash_attention": fa_mod, "selective_scan": scan_mod},
        "hymba-1.5b", get_config("hymba-1.5b").num_layers)
    log(f"full-width training phase hymba-1.5b: "
        f"{time.perf_counter() - t0:.1f} s")
    clear_decode_cache()
    torch.cuda.empty_cache()
    moe_train = {}
    for name, layers in (("mixtral-8x22b", MIXTRAL_TRAIN_LAYERS),
                         ("deepseek-v2-236b", DEEPSEEK_TRAIN_LAYERS)):
        t0 = time.perf_counter()
        moe_train[f"{name}-train"] = full_train_phase(
            torch, {"flash_attention": fa_mod}, name, layers)
        torch.cuda.empty_cache()
        log(f"full-width training phase {name}: "
            f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name in MOE_GRAD_MODELS:
        moe_grad_phase(torch, name)
    log(f"moe gradient phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    steps_train = {
        "xlstm-125m-train": steps_train_phase(torch, {"confidence": conf_mod},
                                              "xlstm-125m"),
        "qwen2-vl-72b-train": steps_train_phase(
            torch, {"flash_attention": fa_mod}, "qwen2-vl-72b",
            VLM_TRAIN_LAYERS, VLM_PATCHES, CANVAS)}
    log(f"make_steps training phase (xlstm-125m, qwen2-vl-72b): "
        f"{time.perf_counter() - t0:.1f} s")

    # 11. the async serving stack over HTTP
    http = http_phase(torch, {"confidence": conf_mod,
                              "flash_attention": fa_mod,
                              "selective_scan": scan_mod})

    def launches(kernel):
        by_path = {"llada-8b" + ("" if p == "none" else f"-{p}"):
                   llada[p].get(kernel, 0) for p in POLICIES}
        by_path["hymba-1.5b"] = hymba.get(kernel, 0)
        by_path["llada-8b-train"] = training.get(kernel, 0)
        by_path["llada-8b-http"] = http.get(kernel, 0)
        by_path["llada-8b-carry"] = carry.get(kernel, 0)
        for path, counts in {**archs, **mixtral, **deepseek, **whisper,
                             **vlm, **xlstm, **moe_train}.items():
            by_path[path] = counts.get(kernel, 0)
        by_path["hymba-1.5b-train"] = hymba_train.get(kernel, 0)
        by_path["llada-8b-serve"] = llada_serve.get(kernel, 0)
        by_path["llada-8b-prefill"] = prefill["launches"].get(kernel, 0)
        by_path["hymba-1.5b-serve"] = hymba_serve.get(kernel, 0)
        for path, counts in {**steps_train, **tp["launches"],
                             **fsdp["launches"],
                             **moe_mesh["launches"]}.items():
            by_path[path] = counts.get(kernel, 0)
        return {"launches": sum(by_path.values()),
                "launches_by_path": by_path}

    conf_entry["max_abs_err"] = max(
        conf_entry["max_abs_err"],
        prefill["kernels"]["confidence"]["max_abs_err"])
    attn_entry["max_abs_err"] = max(
        attn_entry["max_abs_err"],
        prefill["kernels"]["flash_attention"]["max_abs_err"])
    kernels = [
        {"name": "confidence", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/confidence.cu",
         "replaces": "src/repro/kernels/confidence.py:102",
         **launches("confidence"),
         "max_abs_err": conf_entry["max_abs_err"], "ms": conf_entry["ms"],
         "plain_ms": conf_entry["plain_ms"],
         "bound_ms": conf_entry["bound_ms"], "bound_by": "bytes",
         "library_ms": None, "device_ms": conf_entry["device_ms"],
         "serve_shape": {k: conf_serve[k] for k in (
             "ms", "device_ms", "plain_ms", "bound_ms", "max_abs_err")},
         "prefill_shape": prefill["kernels"]["confidence"]},
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
         "backward": flash_grad,
         "serve_shape": {k: attn_serve[k] for k in (
             "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "library_device_ms", "max_abs_err")},
         "prefill_shape": prefill["kernels"]["flash_attention"]},
        {"name": "selective_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/selective_scan.cu",
         "replaces": "src/repro/kernels/selective_scan.py:67",
         **launches("selective_scan"),
         "max_abs_err": scan_entry["max_abs_err"], "ms": scan_entry["ms"],
         "plain_ms": scan_entry["plain_ms"],
         "bound_ms": scan_entry["bound_ms"],
         "bound_by": scan_entry["bound_by"], "library_ms": None,
         "device_ms": scan_entry["device_ms"], "backward": scan_grad,
         "state_shape": {k: scan_state[k] for k in (
             "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
             "max_abs_err")}},
        {"name": "confidence_partials", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/confidence.cu",
         "replaces": "src/repro/kernels/confidence.py:102",
         **launches("confidence_partials"),
         "max_abs_err": tp["entry"]["max_abs_err"], "ms": tp["entry"]["ms"],
         "plain_ms": tp["entry"]["plain_ms"],
         "bound_ms": tp["entry"]["bound_ms"], "bound_by": "bytes",
         "library_ms": None, "device_ms": tp["entry"]["device_ms"],
         "merge_max_abs_err": tp["entry"]["merge_max_abs_err"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
