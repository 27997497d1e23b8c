"""The decoding API of the port: ``Decoder``, ``SampleStats`` and the
runner cache (reference: ``src/repro/core/decoder.py``).

``Decoder(params_or_model_fn, cfg, dcfg, device="cuda")`` owns the
semi-AR block loop: ``generate`` decodes ``gen_length`` tokens after a
prompt, ``generate_blocks`` yields after every committed block.  Blocks,
per-block step budgets and commit widths follow the reference's
``_geometry`` exactly, so tokens, ``steps`` and ``forward_equivalents``
match the reference decode for every strategy that draws no randomness.

``dcfg.cache_policy`` selects the execution mode (DESIGN.md "The KV
cache"): ``none`` re-forwards the whole canvas every step; ``prefix`` and
``dual`` score a live window against the fixed-shape block cache
(``models.model.capture_cache``/``forward_cached``), which the prefill
captures and, under ``cache_refresh="block"``, every later block
boundary refreshes.  The cached path needs a ``Decoder`` built from
params; a hybrid or SSM config gets the reference's ``ValueError``.

``fused_loop`` and ``fused_blocks`` pick the driver as the reference's
do (``core/loop.py``), and all three decode identically:

* ``fused_loop ∧ fused_blocks`` (default): ``generate`` runs the whole
  request on the graph drivers with no per-block event (a canvas copy per
  block only for an ``on_block_committed`` callback), and reads its
  stats back once at the end;
* ``fused_loop ∧ ¬fused_blocks``, and every ``generate_blocks`` call: the
  same graph drivers, yielding a ``BlockEvent`` after each block;
* ``¬fused_loop``: the eager ``run_block``/``run_cached_block``, one host
  check per step, the parity oracle.

The card's PyTorch has no conditional-node capture, so the whole-request
and the per-block drivers are one block loop (``_graph_blocks_gen``):
each block's steps run until the host, polling the block's masked count
two steps behind the card, sees it done (``loop.graph_block``).  A step's
work is paid on every replay, the branches its strategy skips on the host
included (FDM-A's K-candidate search); ``forward_equivalents`` counts the
forwards a step needs, as the eager driver does, not the ones the card
ran.  The graph drivers' static buffers and captured CUDA graphs live in
a ``GraphRun`` per strategy × configs × batch × prompt length, kept in
the process-wide ``RunnerCache``: keyed weakly on the identity of every
params tensor (or of the model_fn), so every ``Decoder`` on the same
weights shares them (``ServingEngine`` builds one per batch) and they go
when the weights go; at most ``max_runners`` runs per weights, least
recently used dropped first.

Conditioning (``generate(..., enc_embeds=...)``, an encoder-decoder's
frame embeddings, or ``patch_embeds=...``, a VLM's patch embeddings)
needs a ``Decoder`` built from params and ``cache_policy="none"``, as in
the reference.  The forward tiles the
extras candidate-major to a K·B folded batch (``_tiling_forward``).  On
the graph drivers they are static input buffers of the ``GraphRun``
(their shapes and dtypes part of its key), copied in per request; the
tiled copy is made inside the captured forward.

With ``dcfg.trace`` the strategy decodes wrapped by
``tracebuffer.tracing`` (memoized, so traced decodes get runs of their
own in the runner cache) and ``SampleStats.trace`` holds the decode's
``DecodeTrace``.  Every driver builds the carry with
``Strategy.init_carry_shaped`` for the canvas and reads it back once at
the end, with the strategy's ``carry_stats`` (``revocations``,
``skipped_forwards``).  A strategy without ``supports_fused`` decodes on
the eager driver.

Under an active mesh of several ranks (``parallel.ctx.activation_mesh``,
weights sharded by ``parallel.sharding.shard_params``) ``generate`` runs
the eager driver only (``fused_loop=False``): the graph drivers raise,
since gloo's collectives cannot be captured (NCCL's capture waits for
several cards).  Every rank is given the same prompt (the data axis must
be 1) and holds the same merged scores, so every rank makes the same
commits.  Under a vocab-sharded head only the strategies that read
``Scores`` alone run (``SHARDED_VOCAB_STRATEGIES``); one that needs the
full-vocab logits raises.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import weakref
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import DecodeConfig, ModelConfig
from repro_torch.core.graphs import CapturePool
from repro_torch.core.loop import (GraphRun, graph_block,
                                   graph_cached_block, read_tree, run_block,
                                   run_cached_block, warm_run)
from repro_torch.core.masking import fully_masked
from repro_torch.core.strategies import Strategy, resolve_strategy
from repro_torch.core.tracebuffer import DecodeTrace, TracingStrategy, tracing
from repro_torch.device import resolve_device
from repro_torch.models.model import (CacheState, capture_cache, forward,
                                      forward_cached)
from repro_torch.parallel import ctx

# the strategies that read only the merged ``Scores``, so they decode under
# a vocab-sharded head (the others read the full-vocab logits)
SHARDED_VOCAB_STRATEGIES = frozenset({"fdm", "fdm_a", "probability",
                                      "margin", "entropy"})

# the conditioning inputs ``forward`` accepts (the reference's set);
# ``generate(**extras)`` validates against it, so a misspelt keyword fails
# at the call
_CONDITIONING_KEYS = frozenset({"enc_embeds", "patch_embeds"})


def _tiling_forward(params, cfg: ModelConfig,
                    extras: Dict[str, torch.Tensor]) -> Callable:
    """tokens (B', L) -> logits, with the conditioning inputs tiled
    candidate-major to a K·B folded batch (rows b0, b1, …, b0, b1, …:
    ``jnp.tile``, which is ``Tensor.repeat``, not ``repeat_interleave``)."""
    def mf(t):
        kw = {}
        for k, v in extras.items():
            reps = t.shape[0] // v.shape[0]
            kw[k] = v.repeat(reps, *(1,) * (v.ndim - 1)) if reps > 1 else v
        return forward(params, t, cfg, **kw)
    return mf


@dataclass
class SampleStats:
    steps: int = 0
    forward_equivalents: float = 0.0  # batched-forward count (K-search = K)
    wall_time: float = 0.0
    tokens_generated: int = 0
    phase_counts: Dict[str, float] = field(default_factory=dict)
    revocations: float = 0.0          # tokens re-masked (wino_r)
    skipped_forwards: float = 0.0     # forwards skipped (extrapolate)
    trace: Optional[DecodeTrace] = None   # dcfg.trace only; off the wire

    @property
    def tps(self) -> float:
        return self.tokens_generated / max(self.wall_time, 1e-9)

    @property
    def tokens_per_forward(self) -> float:
        return self.tokens_generated / max(self.forward_equivalents, 1)

    def as_dict(self) -> Dict[str, Any]:
        """The stable summary form (same keys as the reference's)."""
        return {
            "steps": int(self.steps),
            "forward_equivalents": float(self.forward_equivalents),
            "wall_time_s": float(self.wall_time),
            "tokens_generated": int(self.tokens_generated),
            "tps": float(self.tps),
            "tokens_per_forward": float(self.tokens_per_forward),
            "revocations": float(self.revocations),
            "skipped_forwards": float(self.skipped_forwards),
            "phase_counts": dict(self.phase_counts),
        }


class BlockEvent(NamedTuple):
    """One committed semi-AR block; ``x`` is the (B, L) canvas as it stood
    after the block, a tensor of its own that later blocks never write."""
    block: int
    lo: int
    hi: int
    x: Any


class CacheInfo(NamedTuple):
    entries: int     # distinct params/model_fn identities alive
    runners: int     # GraphRuns across all entries
    hits: int        # runner lookups served without building
    misses: int      # runner builds
    captures: int    # CUDA-graph captures (the reference counts traces)


def _param_leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [leaf for sub in items for leaf in _param_leaves(sub)]


class RunnerCache:
    """Weak, identity-keyed cache of the graph drivers' ``GraphRun``s (the
    reference's ``RunnerCache``).

    Key = the identity of every params tensor, or of the model_fn;
    ``weakref.finalize`` anchors on every keying object evict the whole
    entry as soon as any of them is collected (first finalizer wins): the
    key is a tuple of ``id()``s, unique only while the objects live, so a
    dead non-first tensor must evict too, or a recycled id could alias a
    stale entry.  A ``GraphRun`` never holds the weights (a decode passes
    them in), so eviction really fires; its graphs read the weights'
    memory, which lives exactly as long as the entry.

    Within an entry, each decode key (strategy, configs, batch, prompt
    length, device) has a list of runs: a decode takes one no other decode
    holds, or a new one (interleaved decodes of one key).  An entry keeps
    at most ``max_runners`` runs, least recently used key first out: a run
    holds its shape's static buffers (on the cached path the K/V cache and
    its K-candidate tiles) and its graphs, and serving brings a new key
    with every new longest prompt in a batch.  A run dropped while a
    decode holds it stays that decode's until it ends.  All runs of the
    cache capture into one ``CapturePool`` per device, so the graph memory
    is the largest step's temporaries, not their sum.
    """

    def __init__(self, max_runners: int = 8):
        if max_runners < 1:
            raise ValueError(f"max_runners={max_runners} must be >= 1")
        self.max_runners = max_runners
        self._entries: Dict[tuple, "OrderedDict[tuple, list]"] = {}
        self._finalizers: Dict[tuple, list] = {}
        # weak: a pool goes when the last run capturing into it does
        self._pools: Dict[str, weakref.ref] = {}
        self.hits = 0
        self.misses = 0
        self.captures = 0

    @staticmethod
    def key_for(model) -> Tuple[tuple, tuple]:
        """(cache key, weakref anchors) for a params tree or a callable."""
        if callable(model):
            return ("fn", id(model)), (model,)
        leaves = _param_leaves(model)
        if not leaves:
            raise ValueError("params tree has no tensors")
        return ("params", tuple(map(id, leaves))), tuple(leaves)

    def get(self, key: tuple, anchors: tuple, subkey: tuple,
            builder: Callable[[], GraphRun]) -> GraphRun:
        """A run of ``subkey`` in the entry of ``key`` that no decode
        holds; ``builder()`` makes one on a miss."""
        entry = self._entries.get(key)
        if entry is None:
            entry = self._entries[key] = OrderedDict()
            self._finalizers[key] = [
                weakref.finalize(a, self._evict, key) for a in anchors]
        if subkey in entry:
            entry.move_to_end(subkey)
            for run in entry[subkey]:
                if not run.held():
                    self.hits += 1
                    return run
        self.misses += 1
        # make room first: the new run's buffers may reuse what goes
        while sum(map(len, entry.values())) >= self.max_runners:
            oldest = next(iter(entry))
            entry[oldest].pop(0)
            if not entry[oldest]:
                del entry[oldest]
        run = builder()
        entry.setdefault(subkey, []).append(run)
        return run

    def capture_pool(self, device: torch.device) -> Optional[CapturePool]:
        """The ``CapturePool`` the cache's runs on ``device`` share (None
        off CUDA)."""
        if device.type != "cuda":
            return None
        ref = self._pools.get(str(device))
        pool = ref() if ref is not None else None
        if pool is None:
            pool = CapturePool(device)
            self._pools[str(device)] = weakref.ref(pool)
        return pool

    def _evict(self, key: tuple) -> None:
        self._entries.pop(key, None)
        # detach the survivors: a stale one firing later could evict a NEW
        # entry that reused the (recycled-id) key tuple
        for fin in self._finalizers.pop(key, ()):
            fin.detach()

    def note_capture(self) -> None:
        self.captures += 1

    def values(self) -> list:
        """Every cached runner."""
        return [run for entry in self._entries.values()
                for runs in entry.values() for run in runs]

    def info(self) -> CacheInfo:
        return CacheInfo(entries=len(self._entries),
                         runners=len(self.values()),
                         hits=self.hits, misses=self.misses,
                         captures=self.captures)

    def reset_stats(self) -> None:
        """Zero the counters without dropping any runner."""
        self.hits = self.misses = self.captures = 0

    def clear(self) -> None:
        for fins in list(self._finalizers.values()):
            for fin in fins:
                fin.detach()
        self._entries.clear()
        self._finalizers.clear()
        self._pools.clear()
        self.reset_stats()


_GLOBAL_CACHE = RunnerCache()


def decode_cache_info() -> CacheInfo:
    """Counters of the process-wide runner cache."""
    return _GLOBAL_CACHE.info()


def clear_decode_cache() -> None:
    """Drop every cached runner (its buffers and graphs with it)."""
    _GLOBAL_CACHE.clear()


def reset_decode_cache_stats() -> None:
    """Zero the process-wide cache's hit/miss/capture counters, keeping
    its runners: capture-count checks call this (or use
    ``decode_cache_scope``) first, so they count their own work."""
    _GLOBAL_CACHE.reset_stats()


@contextlib.contextmanager
def decode_cache_scope(cache: Optional[RunnerCache] = None):
    """Swap a fresh (or the given) ``RunnerCache`` in as the process-wide
    cache for the ``with`` block; Decoders made inside it (the ones
    ``ServingEngine`` builds too) resolve against it.  Yields it."""
    global _GLOBAL_CACHE
    prev = _GLOBAL_CACHE
    _GLOBAL_CACHE = cache if cache is not None else RunnerCache()
    try:
        yield _GLOBAL_CACHE
    finally:
        _GLOBAL_CACHE = prev


def validate_cache_policy(cfg: ModelConfig, dcfg: DecodeConfig) -> None:
    """The reference's boundary check of the cache-policy axis: raise
    ``ValueError`` if ``cfg`` cannot serve ``dcfg.cache_policy`` at all
    (``ServingEngine.submit`` callers map it to a 400).

    The fixed-shape block cache scatters fresh window K/V into full-length
    buffers; recurrent state (ssm/hybrid) is a running reduction and has
    no per-position rows to scatter into, so those archs only support
    ``cache_policy="none"``.
    """
    if dcfg.cache_policy == "none":
        return
    if cfg.arch_type in ("ssm", "hybrid") or cfg.attention == "none":
        raise ValueError(
            f"cache_policy={dcfg.cache_policy!r} requires an "
            f"attention-backed architecture (gqa/mla); "
            f"{cfg.name!r} is arch_type={cfg.arch_type!r} with "
            f"attention={cfg.attention!r} — recurrent state cannot ride "
            f"the fixed-shape block cache")


def check_supported(cfg: ModelConfig, dcfg: DecodeConfig) -> None:
    """Raise ``ValueError`` for a cache policy ``cfg`` can never serve (as
    the reference does)."""
    validate_cache_policy(cfg, dcfg)


def check_kernel_flag(dcfg: DecodeConfig, device: torch.device) -> None:
    """``use_pallas_kernel=False`` asked the reference for its plain jnp
    path.  On a card the port has no such path to take quietly, so it
    refuses; on the CPU the plain versions run whatever the flag says."""
    if device.type == "cuda" and dcfg.use_pallas_kernel is False:
        raise ValueError(
            "use_pallas_kernel=False on a CUDA device: the port runs its "
            "hand-written kernels on the card and has no plain path there; "
            "leave it None (or True), or decode with device='cpu'")


class Decoder:
    """Block orchestration for any registered ``Strategy``.

    ``model`` is the port's params dict (see ``models.model``) or a
    callable ``tokens (B', L) -> logits (B', L, V)`` (uncached decoding
    only).  ``device`` is where the canvas lives (default ``"cuda"``;
    raises without a card unless the caller asks for ``"cpu"``).
    ``on_cache_refresh(block_index, t_start_s, t_end_s)``, when set, fires
    around each cache capture of the cached path (and pays a synchronise
    for its times).  ``cache`` is the ``RunnerCache`` to resolve against
    (the process-wide one by default).
    """

    def __init__(self, model, cfg: ModelConfig, dcfg: DecodeConfig,
                 device="cuda", *, cache: Optional[RunnerCache] = None):
        self.cfg = cfg
        self.dcfg = dcfg
        self.device = resolve_device(device)
        check_supported(cfg, dcfg)
        check_kernel_flag(dcfg, self.device)
        self._cache = _GLOBAL_CACHE if cache is None else cache
        if callable(model):
            self._model_fn, self._params = model, None
        else:
            self._model_fn, self._params = \
                (lambda t: forward(model, t, cfg)), model
        self._key, self._anchor = RunnerCache.key_for(model)
        self.on_cache_refresh: Optional[Callable] = None

    # -- geometry ----------------------------------------------------------
    def _geometry(self) -> Tuple[int, int, int, np.ndarray]:
        """(gen, block_size, num_blocks, schedules): the reference's
        ``Decoder._geometry``.  ``steps`` is spread exactly across blocks
        (remainder to the leading blocks) and each block's widths spread
        ``block_size`` over its budget likewise; rows are padded with their
        final width, never zero."""
        dcfg = self.dcfg
        gen, bs = dcfg.gen_length, dcfg.block_size
        assert gen % bs == 0, (gen, bs)
        num_blocks = gen // bs
        if dcfg.steps < num_blocks:
            raise ValueError(
                f"DecodeConfig.steps={dcfg.steps} is infeasible: semi-AR "
                f"decoding runs at least one step per block and "
                f"gen_length={gen} / block_size={bs} gives {num_blocks} "
                f"blocks — raise steps or shrink the block count")
        base, rem = divmod(dcfg.steps, num_blocks)
        budgets = [base + (1 if b < rem else 0) for b in range(num_blocks)]
        sched = np.zeros((num_blocks, max(budgets)), np.int32)
        for b, spb in enumerate(budgets):
            w, wr = divmod(bs, spb)
            widths = [w + 1] * wr + [w] * (spb - wr)
            sched[b] = widths + [widths[-1]] * (sched.shape[1] - spb)
        return gen, bs, num_blocks, sched

    # -- decoding ----------------------------------------------------------
    def generate(self, rng, prompt, strategy=None,
                 on_block_committed: Optional[Callable] = None,
                 **extras) -> Tuple[torch.Tensor, SampleStats]:
        """Decode ``gen_length`` tokens after ``prompt`` (B, Lp).  Returns
        (tokens (B, Lp+gen) on the decoder's device, SampleStats).

        ``rng``: a ``torch.Generator`` on the device, an int seed, or
        ``None`` (seed 0) — only the ``random`` strategy draws from it.
        ``on_block_committed(block_index, lo, hi, x)`` fires after each
        committed block (``x`` a device tensor of its own; on the graph
        drivers the copy may still be queued on the card, so the callback
        should not sync if it wants none).  ``extras`` (params mode,
        ``cache_policy="none"``): conditioning tensors forwarded to the
        model (``enc_embeds`` (B, S, d), ``patch_embeds`` (B, P, d))."""
        strat = self._strategy(strategy)
        gen, prompt, geometry, extras = self._inputs(rng, prompt, extras)
        if self._fused(strat):
            blocks = self._graph_blocks_gen(
                strat, gen, prompt, geometry, extras,
                events=(on_block_committed is not None
                        or not self.dcfg.fused_blocks))
        else:
            blocks = self._blocks_gen(strat, gen, prompt, geometry, extras)
        while True:
            try:
                ev = next(blocks)
            except StopIteration as fin:
                return fin.value
            if on_block_committed is not None:
                on_block_committed(ev.block, ev.lo, ev.hi, ev.x)

    def generate_blocks(self, rng, prompt, strategy=None, **extras):
        """A generator of ``BlockEvent(block, lo, hi, x)``, one per
        committed block; its return value is ``(tokens, stats)``.  Runs
        the per-block graph driver, or the eager one under
        ``fused_loop=False``.  ``extras`` as in ``generate``."""
        strat = self._strategy(strategy)
        gen, prompt, geometry, extras = self._inputs(rng, prompt, extras)
        if self._fused(strat):
            return self._graph_blocks_gen(strat, gen, prompt, geometry,
                                          extras)
        return self._blocks_gen(strat, gen, prompt, geometry, extras)

    def _strategy(self, strategy) -> Strategy:
        """The decode's strategy, wrapped by the (memoized) tracing adapter
        under ``dcfg.trace``; refused under a mesh where it cannot run."""
        strat = resolve_strategy(strategy or self.dcfg.strategy)
        self._check_mesh(strat)
        return tracing(strat) if self.dcfg.trace else strat

    def _check_mesh(self, strat: Strategy) -> None:
        mesh = ctx.active()
        if mesh is None or mesh.size == 1:
            return
        if self.dcfg.fused_loop and strat.supports_fused:
            raise ValueError(
                "the graph drivers do not run under a mesh of several "
                "ranks (gloo's collectives cannot be captured); pass "
                "fused_loop=False for the eager driver")
        if ctx.axis_size("data") > 1:
            raise NotImplementedError(
                "generate under a data axis of more than 1 waits: every "
                "rank decodes the same prompt (make_steps' serve takes the "
                "batch on data)")
        if ctx.model_size() > 1 and self.cfg.vocab_size % ctx.model_size() \
                == 0 and strat.name not in SHARDED_VOCAB_STRATEGIES:
            raise NotImplementedError(
                f"strategy {strat.name!r} reads the full-vocab logits; under "
                f"a vocab-sharded head only {sorted(SHARDED_VOCAB_STRATEGIES)} "
                f"run (ROADMAP queue 1)")

    def _fused(self, strat: Strategy) -> bool:
        """The graph drivers, or the eager one for ``fused_loop=False`` and
        a strategy without a graph-safe step."""
        return self.dcfg.fused_loop and strat.supports_fused

    def _inputs(self, rng, prompt, extras: Dict[str, Any]):
        """(generator, prompt tensor, geometry, extras as device tensors);
        geometry, cache-policy and conditioning errors raise here, before
        any decoding, as the reference's do."""
        unknown = set(extras) - _CONDITIONING_KEYS
        if unknown:
            raise TypeError(
                f"got unexpected keyword argument(s) {sorted(unknown)}; "
                f"conditioning extras must be one of "
                f"{sorted(_CONDITIONING_KEYS)}")
        geometry = self._geometry()
        if self.dcfg.cache_policy != "none":
            if self._params is None:
                raise ValueError(
                    "cache_policy != 'none' requires a Decoder built from "
                    "params (a bare model_fn cannot drive the cache capture "
                    "or the windowed forwards)")
            if extras:
                raise ValueError(
                    "conditioning extras (enc_embeds / patch_embeds) are "
                    "not supported with cache_policy != 'none': the cache "
                    "capture runs the text stack only — decode uncached, "
                    "or drop the conditioning")
        if extras and self._params is None:
            raise ValueError("extras require a params-mode Decoder (a "
                             "model_fn already owns its conditioning)")
        prompt = torch.as_tensor(prompt, device=self.device).long()
        extras = {k: torch.as_tensor(v, device=self.device)
                  for k, v in extras.items()}
        return self._generator(rng), prompt, geometry, extras

    def _generator(self, rng) -> torch.Generator:
        if isinstance(rng, torch.Generator):
            return rng
        return torch.Generator(device=self.device).manual_seed(
            0 if rng is None else int(rng))

    def _timed_refresh(self, blk: int, fn: Callable[[], Any]) -> Any:
        """Run the cache capture ``fn``; with an ``on_cache_refresh`` hook,
        synchronise and report its times (only hooked runs pay that)."""
        hook = self.on_cache_refresh
        t0 = time.perf_counter()
        out = fn()
        if hook is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            hook(blk, t0, time.perf_counter())
        return out

    def _cached_fn(self, w: torch.Tensor, win_lo: int,
                   tiles: Dict[int, CacheState]) -> torch.Tensor:
        """``cached_fn`` of the cached drivers: the window's logits
        against the cache.  ``tiles`` maps a replication count to the
        cache tiled that many times candidate-major (``tiles[1]`` is the
        capture); a foreseeing strategy's K-candidate batch gets its tiled
        copy made once, not once per forward."""
        reps = w.shape[0] // tiles[1][0].k.shape[0]
        if reps not in tiles:
            tiles[reps] = _tile_state(tiles[1], reps)
        return forward_cached(self._params, w, win_lo, tiles[reps],
                              self.cfg)

    # -- the graph drivers -------------------------------------------------
    def _graph_run(self, strat: Strategy, batch: int, prompt_len: int,
                   sched: np.ndarray,
                   extras: Dict[str, torch.Tensor]) -> GraphRun:
        """A ``GraphRun`` of this decode's key that no other decode holds,
        from the cache; built on a miss (the cached path captures its
        first cache into it; a conditioned decode's run gets a static
        buffer for each of its extras)."""
        cfg, dcfg, cache = self.cfg, self.dcfg, self._cache
        # the per-block and whole-request drivers share runs and graphs
        subkey = ("graph", strat, cfg, dataclasses.replace(
            dcfg, fused_blocks=True), batch, prompt_len, str(self.device),
            tuple(sorted((k, tuple(v.shape), v.dtype)
                         for k, v in extras.items())))

        def build():
            run = GraphRun(strat, cfg, dcfg, batch, prompt_len, sched,
                           self.device, cache.note_capture,
                           cache.capture_pool(self.device))
            run.extras = {k: torch.empty_like(v) for k, v in extras.items()}
            if dcfg.cache_policy != "none":
                run.tiles[1] = capture_cache(self._params, run.x, cfg)
            return run

        return cache.get(self._key, self._anchor, subkey, build)

    def _refresh_body(self, run: GraphRun) -> Callable[[], None]:
        """The cache capture of ``run``'s canvas, written into its static
        cache and tiles: the body of its refresh graph."""
        params, cfg = self._params, self.cfg
        return lambda: _refresh_into(run.tiles,
                                     capture_cache(params, run.x, cfg))

    def _graph_refresh(self, run: GraphRun) -> Callable[[int], None]:
        """``refresh(blk)`` of the cached graph drivers: replay the refresh
        graph."""
        body = self._refresh_body(run)
        return lambda blk: self._timed_refresh(
            blk, lambda: run.graphs.run(("refresh",), body))

    def _run_model_fn(self, run: GraphRun) -> Callable:
        """The uncached graph drivers' ``model_fn``: the forward reading
        ``run``'s static extras, when it has any."""
        if not run.extras:
            return self._model_fn
        return _tiling_forward(self._params, self.cfg, run.extras)

    def _graph_start(self, strat: Strategy, gen: torch.Generator,
                     prompt: torch.Tensor, geometry,
                     extras: Dict[str, torch.Tensor]):
        """Take a free run of this key, copy the request's extras into its
        static buffers, warm it on first use, and reset it for ``prompt``.
        Returns ``(run, lease, t0)``: the decode holds the run while it
        keeps the lease."""
        b, lp = prompt.shape
        run = self._graph_run(strat, b, lp, geometry[3], extras)
        lease = run.take()
        for k, v in extras.items():
            run.extras[k].copy_(v)
        if self.dcfg.cache_policy != "none":
            lo0 = run.win_los[0]
            warm_run(strat, lambda w: self._cached_fn(w, lo0, run.tiles),
                     self.cfg, self.dcfg, run, self._refresh_body(run))
        else:
            warm_run(strat, self._run_model_fn(run), self.cfg, self.dcfg,
                     run)
        t0 = time.perf_counter()
        run.start(prompt, strat.init_carry_shaped(
            self.cfg, self.dcfg, b, lp + self.dcfg.gen_length, self.device),
            gen)
        return run, lease, t0

    def _graph_blocks_gen(self, strat: Strategy, gen: torch.Generator,
                          prompt: torch.Tensor, geometry,
                          extras: Dict[str, torch.Tensor],
                          events: bool = True):
        """The graph drivers' block loop, the cache's prefill and
        refreshes included; with ``events`` it yields a ``BlockEvent``
        (a device copy of the canvas) after each block."""
        cfg, dcfg = self.cfg, self.dcfg
        cached = dcfg.cache_policy != "none"
        # the lease holds the run until the decode returns, or until its
        # generator is dropped
        run, lease, t0 = self._graph_start(strat, gen, prompt, geometry,
                                           extras)
        lp, bs = prompt.shape[1], geometry[1]
        refresh = self._graph_refresh(run) if cached else None
        model_fn = self._run_model_fn(run)
        refreshes = 0
        for blk in range(geometry[2]):
            if cached:
                if blk == 0 or dcfg.cache_refresh == "block":
                    refresh(blk)
                    refreshes += 1
                graph_cached_block(strat, self._cached_fn, cfg, dcfg, run,
                                   blk)
            else:
                graph_block(strat, model_fn, cfg, dcfg, run, blk)
            if events:
                yield BlockEvent(blk, lp + blk * bs, lp + (blk + 1) * bs,
                                 run.x.clone())
        return self._graph_finish(run, strat, gen, geometry, t0,
                                  refreshes)

    def _graph_finish(self, run: GraphRun, strat: Strategy,
                      gen: torch.Generator, geometry, t0: float,
                      refreshes: int) -> Tuple[torch.Tensor, SampleStats]:
        """The decode's one readback: tokens stay on the device; steps,
        forward-equivalents and the carry come back together.  The
        caller's generator takes the run's generator's state, as if it
        had drawn the decode's numbers itself.  Frees the run."""
        out = run.x.clone()
        steps, fwd, carry = run.read_back()
        gen.set_state(run.generator.get_state())
        run.release()
        stats = SampleStats(tokens_generated=out.shape[0] * geometry[0],
                            steps=steps,
                            forward_equivalents=fwd + float(refreshes))
        _carry_stats(stats, strat, carry)
        stats.wall_time = time.perf_counter() - t0
        return out, stats

    # -- the eager driver --------------------------------------------------
    def _blocks_gen(self, strat: Strategy, gen: torch.Generator,
                    prompt: torch.Tensor, geometry,
                    extras: Dict[str, torch.Tensor]):
        cfg, dcfg = self.cfg, self.dcfg
        model_fn = _tiling_forward(self._params, cfg, extras) if extras \
            else self._model_fn
        cached = dcfg.cache_policy != "none"
        b, lp = prompt.shape
        gen_len, bs, num_blocks, sched = geometry
        x = fully_masked(cfg, prompt, gen_len)
        carry = strat.init_carry_shaped(cfg, dcfg, b, x.shape[1],
                                        self.device)
        stats = SampleStats(tokens_generated=b * gen_len)
        pos = torch.arange(x.shape[1], device=self.device)
        t0 = time.perf_counter()

        def refresh(canvas, blk):
            return {1: self._timed_refresh(
                blk, lambda: capture_cache(self._params, canvas, cfg))}
        # cached: the prefill capture is block 0's refresh; later blocks
        # refresh under cache_refresh="block".  Each capture is one
        # forward, added after the steps' forwards, as the reference's
        # host driver adds it.
        tiles = refresh(x, 0) if cached else None
        refresh_fwd = 1.0 if cached else 0.0
        for blk in range(num_blocks):
            lo, hi = lp + blk * bs, lp + (blk + 1) * bs
            if cached:
                if blk > 0 and dcfg.cache_refresh == "block":
                    tiles = refresh(x, blk)
                    refresh_fwd += 1.0
                with ctx.with_vocab(cfg.vocab_size):
                    x, carry, steps, stats.forward_equivalents = \
                        run_cached_block(strat, self._cached_fn, cfg, dcfg,
                                         sched[blk], x, gen, lo, tiles,
                                         carry, stats.forward_equivalents)
            else:
                in_block = (pos >= lo) & (pos < hi)
                with ctx.with_vocab(cfg.vocab_size):
                    x, carry, steps, stats.forward_equivalents = run_block(
                        strat, model_fn, cfg, dcfg, sched[blk], x, gen,
                        in_block, carry, stats.forward_equivalents)
            stats.steps += steps
            yield BlockEvent(blk, lo, hi, x)
        stats.forward_equivalents += refresh_fwd
        _carry_stats(stats, strat, read_tree(carry))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        stats.wall_time = time.perf_counter() - t0
        return x, stats

    # -- introspection -----------------------------------------------------
    def cache_info(self) -> CacheInfo:
        """Counters of the runner cache this Decoder resolves against."""
        return self._cache.info()


def _carry_stats(stats: SampleStats, strat: Strategy, carry) -> None:
    """The final carry (on the host) into ``stats``: phase counts, the
    strategy's ``carry_stats`` onto the fields of their names (the
    reference's ``_merge_carry_stats``), and a traced decode's
    ``DecodeTrace``."""
    pc = strat.phase_counts(carry)
    if pc:
        stats.phase_counts = pc
    for key, val in strat.carry_stats(carry).items():
        if not hasattr(stats, key):
            raise AttributeError(
                f"strategy {strat.name!r} reported carry stat {key!r} "
                f"which is not a SampleStats field")
        setattr(stats, key, val)
    if isinstance(strat, TracingStrategy):
        stats.trace = strat.extract(carry)


def _refresh_into(tiles: Dict[int, CacheState], state: CacheState) -> None:
    """Write a fresh capture into the static cache ``tiles[1]`` and every
    tiled copy of it, in place: the step graphs read these buffers."""
    for reps, tiled in tiles.items():
        for dst, src in zip(tiled, state):
            for d, s in ((dst.k, src.k), (dst.v, src.v)):
                d.view(reps, *s.shape).copy_(s.expand(reps, *s.shape))


def _tile_state(state: CacheState, reps: int) -> CacheState:
    """The cache replicated candidate-major along its batch axis (the
    reference's ``jnp.tile``): rows b0, b1, …, b0, b1, …"""
    if reps == 1:
        return state

    def tile(t):                 # (B, total, G, hd), or MLA's (B, total, r)
        return t.repeat(reps, *(1,) * (t.ndim - 1))
    return [kv._replace(k=tile(kv.k), v=tile(kv.v)) for kv in state]
