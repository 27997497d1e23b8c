"""The decoding API of the port: ``Decoder`` and ``SampleStats``
(reference: ``src/repro/core/decoder.py``).

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

Not ported yet (each raises ``NotImplementedError``): ``trace=True`` and
the strategies ``wino_r``/``extrapolate`` (ROADMAP.md queue 1 item 7).
``fused_loop`` and ``fused_blocks`` select among the reference's three
drivers, which decode identically; the port has one eager driver and
ignores them.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import DecodeConfig, ModelConfig
from repro_torch.core.loop import run_block, run_cached_block
from repro_torch.core.masking import fully_masked
from repro_torch.core.strategies import Strategy, resolve_strategy
from repro_torch.device import resolve_device
from repro_torch.models.model import (DecodeState, capture_cache, forward,
                                      forward_cached)


@dataclass
class SampleStats:
    steps: int = 0
    forward_equivalents: float = 0.0  # batched-forward count (K-search = K)
    wall_time: float = 0.0
    tokens_generated: int = 0
    phase_counts: Dict[str, float] = field(default_factory=dict)
    revocations: float = 0.0
    skipped_forwards: float = 0.0

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
    """One committed semi-AR block; ``x`` is the live (B, L) canvas."""
    block: int
    lo: int
    hi: int
    x: Any


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
    the reference does), then ``NotImplementedError`` for decode options
    not ported yet."""
    validate_cache_policy(cfg, dcfg)
    if dcfg.trace:
        raise NotImplementedError(
            "trace=True (step telemetry) is not ported yet: ROADMAP.md "
            "queue 1 item 7")


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
    around each cache capture of the cached path.
    """

    def __init__(self, model, cfg: ModelConfig, dcfg: DecodeConfig,
                 device="cuda"):
        self.cfg = cfg
        self.dcfg = dcfg
        self.device = resolve_device(device)
        check_supported(cfg, dcfg)
        check_kernel_flag(dcfg, self.device)
        if callable(model):
            self._model_fn, self._params = model, None
        else:
            self._model_fn, self._params = \
                (lambda t: forward(model, t, cfg)), model
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
                 on_block_committed: Optional[Callable] = None
                 ) -> Tuple[torch.Tensor, SampleStats]:
        """Decode ``gen_length`` tokens after ``prompt`` (B, Lp).  Returns
        (tokens (B, Lp+gen) on the decoder's device, SampleStats).

        ``rng``: a ``torch.Generator`` on the device, an int seed, or
        ``None`` (seed 0) — only the ``random`` strategy draws from it.
        ``on_block_committed(block_index, lo, hi, x)`` fires after each
        committed block."""
        blocks = self.generate_blocks(rng, prompt, strategy)
        while True:
            try:
                ev = next(blocks)
            except StopIteration as fin:
                return fin.value
            if on_block_committed is not None:
                on_block_committed(ev.block, ev.lo, ev.hi, ev.x)

    def generate_blocks(self, rng, prompt, strategy=None):
        """A generator of ``BlockEvent(block, lo, hi, x)``, one per
        committed block; its return value is ``(tokens, stats)``."""
        strat = resolve_strategy(strategy or self.dcfg.strategy)
        geometry = self._geometry()       # geometry errors raise HERE
        if self.dcfg.cache_policy != "none" and self._params is None:
            raise ValueError(
                "cache_policy != 'none' requires a Decoder built from "
                "params (a bare model_fn cannot drive the cache capture "
                "or the windowed forwards)")
        prompt = torch.as_tensor(prompt, device=self.device).long()
        return self._blocks_gen(strat, self._generator(rng), prompt,
                                geometry)

    def _generator(self, rng) -> torch.Generator:
        if isinstance(rng, torch.Generator):
            return rng
        return torch.Generator(device=self.device).manual_seed(
            0 if rng is None else int(rng))

    def _refresh(self, canvas: torch.Tensor, blk: int) -> DecodeState:
        """Capture the block cache from ``canvas``; timed for the
        ``on_cache_refresh`` hook, which alone pays for a synchronise."""
        hook = self.on_cache_refresh
        if hook is None:
            return capture_cache(self._params, canvas, self.cfg)
        t0 = time.perf_counter()
        state = capture_cache(self._params, canvas, self.cfg)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        hook(blk, t0, time.perf_counter())
        return state

    def _cached_fn(self, w: torch.Tensor, win_lo: int,
                   tiles: Dict[int, DecodeState]) -> torch.Tensor:
        """``cached_fn`` of ``run_cached_block``: the window's logits
        against the cache.  ``tiles`` maps a replication count to the
        cache tiled that many times candidate-major (``tiles[1]`` is the
        capture); a foreseeing strategy's K-candidate batch gets its tiled
        copy made once per capture, not once per forward."""
        reps = w.shape[0] // tiles[1][0].k.shape[0]
        if reps not in tiles:
            tiles[reps] = _tile_state(tiles[1], reps)
        return forward_cached(self._params, w, win_lo, tiles[reps],
                              self.cfg)

    def _blocks_gen(self, strat: Strategy, gen: torch.Generator,
                    prompt: torch.Tensor, geometry):
        cfg, dcfg = self.cfg, self.dcfg
        cached = dcfg.cache_policy != "none"
        b, lp = prompt.shape
        gen_len, bs, num_blocks, sched = geometry
        x = fully_masked(cfg, prompt, gen_len)
        carry = strat.init_carry(cfg, dcfg, self.device)
        stats = SampleStats(tokens_generated=b * gen_len)
        pos = torch.arange(x.shape[1], device=self.device)
        t0 = time.perf_counter()
        # cached: the prefill capture is block 0's refresh; later blocks
        # refresh under cache_refresh="block".  Each capture is one
        # forward, added after the steps' forwards, as the reference's
        # host driver adds it.
        tiles = {1: self._refresh(x, 0)} if cached else None
        refresh_fwd = 1.0 if cached else 0.0
        for blk in range(num_blocks):
            lo, hi = lp + blk * bs, lp + (blk + 1) * bs
            if cached:
                if blk > 0 and dcfg.cache_refresh == "block":
                    tiles = {1: self._refresh(x, blk)}
                    refresh_fwd += 1.0
                x, carry, steps, stats.forward_equivalents = \
                    run_cached_block(strat, self._cached_fn, cfg, dcfg,
                                     sched[blk], x, gen, lo, tiles, carry,
                                     stats.forward_equivalents)
            else:
                in_block = (pos >= lo) & (pos < hi)
                x, carry, steps, stats.forward_equivalents = run_block(
                    strat, self._model_fn, cfg, dcfg, sched[blk], x, gen,
                    in_block, carry, stats.forward_equivalents)
            stats.steps += steps
            yield BlockEvent(blk, lo, hi, x)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        stats.forward_equivalents += refresh_fwd
        stats.phase_counts = strat.phase_counts(carry)
        stats.wall_time = time.perf_counter() - t0
        return x, stats


def _tile_state(state: DecodeState, reps: int) -> DecodeState:
    """The cache replicated candidate-major along its batch axis (the
    reference's ``jnp.tile``): rows b0, b1, …, b0, b1, …"""
    if reps == 1:
        return state
    return [kv._replace(k=kv.k.repeat(reps, 1, 1, 1),
                        v=kv.v.repeat(reps, 1, 1, 1)) for kv in state]
