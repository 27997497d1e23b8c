"""The block drivers of the port (reference: ``src/repro/core/loop.py``).

Two families, which decode identically:

* **eager** — ``run_block`` (uncached, over the whole canvas) and
  ``run_cached_block`` (over the cache policy's live window): per step the
  loop checks once on the host whether the block still has a masked
  position, picks the step's commit width from the block's schedule row
  and calls the strategy's ``step``.  They keep the reference's host
  driver's semantics and are the parity oracle (``fused_loop=False``).
* **graph** — ``graph_block`` (counterpart of the reference's
  ``drive_block``) and ``graph_cached_block`` (``drive_cached_block``).
  Their state lives in the static device buffers of a ``GraphRun``:
  canvas, step counters, forward-equivalents, the strategy's carry,
  the block's schedule row and column mask, and a conditioned decode's
  inputs (``GraphRun.extras``, copied in per request).  One step is one captured
  CUDA graph: the commit width ``sched[min(i, S−1)]`` indexed on the
  device, the strategy's ``device_step``, and every write masked by
  ``live = any(active) & (steps_in_block < block_size·4)`` (the
  reference's ``while_loop`` condition; ``graphs.run_masked``: the card's
  PyTorch cannot capture conditional nodes, so a replay after the block
  is done costs a full step's device time and changes nothing).  Each
  step also leaves the block's masked count, which the host polls two
  steps behind the card (``graph_block``), so the card never waits for
  the host and a block stops within one replay of its end.  One step per
  graph (U = 1).  Under ``dual`` the window's offset is baked into the
  graph (the flash kernel's ``q_offset`` is a host argument), so each
  block offset has its own step graph; the other policies have one.  A
  cache refresh is a graph too, writing the fresh K/V into the static
  cache (and its K-candidate tiles) by ``copy_``.  The reference's
  whole-request drivers (``drive_request``, ``drive_request_cached``)
  have no function of their own here: without conditional nodes a whole
  request is the per-block loop, refreshes included, run by
  ``Decoder._graph_blocks_gen`` without handing out per-block events.
  On the CPU the graphs are plain calls (``graphs.GraphSet``), so the CPU
  tests run the same driver code.

In both families a block stops after at most ``block_size·4`` steps, and
forward-equivalents are summed per step, each scaled by the window's share
of the canvas, in the order the reference's host driver sums them: the
graph drivers sum on the device in float64, which gives the host's Python
floats to the last bit (the reference's fused drivers sum in float32,
within rel 1e-6 of these).
"""
from __future__ import annotations

import weakref
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import DecodeConfig, ModelConfig
from repro_torch.core.graphs import CapturePool, GraphSet, run_masked, write
from repro_torch.core.strategies import Strategy

# how many steps behind the card the graph drivers read a block's masked
# count (``graph_block``)
POLL_LAG = 2


def run_block(strategy: Strategy, model_fn: Callable, cfg: ModelConfig,
              dcfg: DecodeConfig, sched: np.ndarray, x: torch.Tensor,
              rng: Optional[torch.Generator], in_block: torch.Tensor,
              carry=(), fwd: float = 0.0, fwd_scale: float = 1.0):
    """Decode the block marked by ``in_block`` (L,) bool over ``x``'s
    columns.  ``fwd`` is the running forward-equivalent count, advanced
    by each step's forwards times ``fwd_scale``.  Returns ``(x, carry,
    steps, fwd)``: the block's step count and the advanced count."""
    steps = 0
    last = len(sched) - 1
    carry = strategy.begin_block(carry, x, in_block)
    for i in range(dcfg.block_size * 4):
        active = in_block[None, :] & (x == cfg.mask_token_id)
        if not bool(active.any()):
            break
        n = int(sched[min(i, last)])
        x, carry, fwd_n = strategy.step(rng, carry, x, active, model_fn,
                                        cfg, dcfg, n)
        steps += 1
        fwd += float(fwd_n) * fwd_scale
    return x, carry, steps, fwd


# --------------------------------------------------------------------------
# the cached path (cache_policy = prefix | dual)
# --------------------------------------------------------------------------

def window_geometry(dcfg: DecodeConfig, total: int
                    ) -> Tuple[int, Optional[int]]:
    """(window width, fixed window start or None) for a cache policy.

    ``prefix`` keeps the whole generation live: width ``gen_length`` at
    the fixed offset ``total - gen_length`` (only the prompt's K/V are
    frozen).  ``dual`` keeps only the active block live: width
    ``block_size`` at the block's own offset; prompt, committed blocks and
    the masked suffix come from the cache (the suffix's K/V go stale
    within a block, the documented approximation)."""
    if dcfg.cache_policy == "prefix":
        return dcfg.gen_length, total - dcfg.gen_length
    return dcfg.block_size, None


def tree_map(fn: Callable, *trees):
    """``fn`` over the tensors of one or more carries of the same
    structure (a tensor, or nested tuples and lists of them), like
    ``jax.tree.map``."""
    if isinstance(trees[0], torch.Tensor):
        return fn(*trees)
    return type(trees[0])(tree_map(fn, *subs) for subs in zip(*trees))


def carry_window(strategy: Strategy, carry, lo: int, width: int):
    """Slice a positional carry's per-column tensors to the live window
    ``[:, lo:lo+width]``, like the canvas: views, so a write into them
    (``graphs.write``/``write_where``) lands in ``carry``.  The carry of a
    strategy without ``positional_carry`` passes through whole."""
    if not strategy.positional_carry:
        return carry
    pos, glob = carry
    return tree_map(lambda a: a[:, lo:lo + width], pos), glob


def carry_unwindow(strategy: Strategy, carry_full, carry_win, lo: int):
    """Write a block's window carry back into new full-canvas positional
    tensors (the inverse of ``carry_window``)."""
    if not strategy.positional_carry:
        return carry_win
    pos_full, _ = carry_full
    pos_win, glob = carry_win
    return tree_map(lambda f, w: _write(f, w, lo), pos_full, pos_win), glob


def _write(full: torch.Tensor, win: torch.Tensor, lo: int) -> torch.Tensor:
    """A new tensor: ``full`` with ``win`` at columns ``lo:``.  Never
    written in place: a canvas already handed out in a ``BlockEvent``
    must not change under its holder."""
    out = full.clone()
    out[:, lo:lo + win.shape[1]] = win
    return out


def run_cached_block(strategy: Strategy, cached_fn: Callable,
                     cfg: ModelConfig, dcfg: DecodeConfig, sched: np.ndarray,
                     x: torch.Tensor, rng: Optional[torch.Generator],
                     lo: int, state, carry=(), fwd: float = 0.0):
    """One block of cached decoding: slice the policy's live window out of
    the canvas, run ``run_block`` on it against the read-only cache
    ``state`` (``cached_fn(x_win, win_lo, state) -> logits``), and write
    the window back into a new canvas.  Forward-equivalents are scaled by
    ``window / total``.  Returns ``(x, carry, steps, fwd)``; refreshing
    ``state`` is the caller's business."""
    total = x.shape[1]
    win, fixed_lo = window_geometry(dcfg, total)
    win_lo = lo if fixed_lo is None else fixed_lo
    x_win = x[:, win_lo:win_lo + win]
    wpos = win_lo + torch.arange(win, device=x.device)
    in_block = (wpos >= lo) & (wpos < lo + dcfg.block_size)
    wcarry = carry_window(strategy, carry, win_lo, win)
    x_win, wcarry, steps, fwd = run_block(
        strategy, lambda w: cached_fn(w, win_lo, state), cfg, dcfg, sched,
        x_win, rng, in_block, wcarry, fwd, fwd_scale=win / total)
    return (_write(x, x_win, win_lo),
            carry_unwindow(strategy, carry, wcarry, win_lo), steps, fwd)


# --------------------------------------------------------------------------
# the graph drivers
# --------------------------------------------------------------------------

def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a carry (a tensor, or nested tuples/lists of them)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for sub in tree for leaf in tree_leaves(sub)]


def _rebuild(tree, values):
    """``tree``'s structure with each tensor taken in turn from
    ``values``."""
    if isinstance(tree, torch.Tensor):
        return next(values)
    return type(tree)(_rebuild(sub, values) for sub in tree)


def _read(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Device tensors to the host in one pinned copy and one event wait:
    the drivers' only waits on the card."""
    packed = torch.cat([t.double().reshape(-1) for t in tensors])
    host = packed.to("cpu", non_blocking=True)
    if packed.is_cuda:
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
    parts = host.split([t.numel() for t in tensors])
    return [p.to(t.dtype).reshape(t.shape) for p, t in zip(parts, tensors)]


def read_tree(tree):
    """A carry's tensors copied to the host in one ``_read`` (the same
    structure, CPU tensors); a carry without tensors passes through."""
    leaves = tree_leaves(tree)
    if not leaves:
        return tree
    return _rebuild(tree, iter(_read(leaves)))


class Lease:
    """A decode's hold on a ``GraphRun``: the run is that decode's while
    its lease lives (until ``GraphRun.release``, or until an abandoned
    decode's frame, which holds it, is dropped)."""


class GraphRun:
    """The static device buffers and the graphs of the graph drivers for
    one decode shape (strategy, configs, batch, prompt length, device).
    One decode at a time holds them (``take``); a decode of the same key
    that finds every run of its key held gets a run of its own.

    ``sched`` is ``Decoder._geometry``'s (num_blocks, S) schedule table;
    the per-block schedule rows and column masks go to the device once,
    here, and each block copies its own into the static ``sched`` and
    ``in_block`` rows on the device.  ``capture`` is the
    ``graphs.CapturePool`` its graphs are captured into."""

    def __init__(self, strategy: Strategy, cfg: ModelConfig,
                 dcfg: DecodeConfig, batch: int, prompt_len: int,
                 sched: np.ndarray, device: torch.device,
                 on_capture: Optional[Callable[[], None]] = None,
                 capture: Optional[CapturePool] = None):
        total = prompt_len + dcfg.gen_length
        num_blocks = sched.shape[0]
        base, rem = divmod(dcfg.steps, num_blocks)
        self.budgets = [base + (1 if b < rem else 0)
                        for b in range(num_blocks)]
        cached = dcfg.cache_policy != "none"
        self.total = total
        self.win, fixed_lo = window_geometry(dcfg, total) if cached \
            else (total, 0)
        self.scale = self.win / total if cached else 1.0
        los = [prompt_len + b * dcfg.block_size for b in range(num_blocks)]
        self.win_los = [lo if fixed_lo is None else fixed_lo for lo in los]
        wpos = np.arange(self.win)
        masks = np.stack([(wlo + wpos >= lo) & (wlo + wpos < lo
                                                  + dcfg.block_size)
                          for lo, wlo in zip(los, self.win_los)])
        self.in_blocks = torch.as_tensor(masks, device=device)
        self.scheds = torch.as_tensor(sched, dtype=torch.int32,
                                      device=device)
        self.in_block = torch.zeros(self.win, dtype=torch.bool,
                                    device=device)
        self.sched = torch.zeros(sched.shape[1], dtype=torch.int32,
                                 device=device)
        self.mask_id = cfg.mask_token_id
        self.x = torch.full((batch, total), cfg.mask_token_id,
                            dtype=torch.long, device=device)
        self.i = torch.zeros((), dtype=torch.int32, device=device)
        self.steps = torch.zeros((), dtype=torch.int32, device=device)
        self.fwd = torch.zeros((), dtype=torch.float64, device=device)
        # masked positions left in the block's fullest row, written by
        # every step and polled by the host (``post``/``left_after``)
        self.left = torch.zeros((), dtype=torch.int32, device=device)
        self.carry = strategy.init_carry_shaped(cfg, dcfg, batch, total,
                                                device)
        self.generator = torch.Generator(device=device)
        self.graphs = GraphSet(device, self.generator, on_capture, capture)
        if self.graphs.cuda:
            self._left_host = torch.zeros(POLL_LAG, dtype=torch.int32,
                                          pin_memory=True)
            self._left_done = [torch.cuda.Event() for _ in range(POLL_LAG)]
        # the cached path's K/V: ``tiles[1]`` the capture, ``tiles[K]`` it
        # tiled K times candidate-major for a K-candidate forward
        self.tiles: Dict[int, list] = {}
        # a conditioned decode's inputs (``enc_embeds``): static buffers
        # the decoder allocates and copies each request's into; the
        # captured forward reads them (and tiles them inside the graph)
        self.extras: Dict[str, torch.Tensor] = {}
        self.warmed = False
        self._lease: Optional[weakref.ref] = None

    def window(self, blk: int) -> torch.Tensor:
        lo = self.win_los[blk]
        return self.x[:, lo:lo + self.win]

    def held(self) -> bool:
        return self._lease is not None and self._lease() is not None

    def take(self) -> Lease:
        """Hold the run for a new decode, which keeps the returned lease
        until it is done."""
        lease = Lease()
        self._lease = weakref.ref(lease)
        return lease

    def release(self) -> None:
        self._lease = None

    def start(self, prompt: torch.Tensor, carry,
              rng: torch.Generator) -> None:
        """Reset the buffers for a new decode of ``prompt`` (B, Lp), on the
        device: no sync, no host-to-device copy."""
        lp = prompt.shape[1]
        self.x[:, :lp].copy_(prompt)
        self.x[:, lp:].fill_(self.mask_id)
        self.steps.zero_()
        self.fwd.zero_()
        write(self.carry, carry)
        self.generator.set_state(rng.get_state())

    def post(self, j: int) -> None:
        """After step ``j``'s replay, queue a copy of its masked count to
        the host (a pinned slot and an event; CUDA only)."""
        if self.graphs.cuda:
            slot = j % POLL_LAG
            self._left_host[slot].copy_(self.left, non_blocking=True)
            self._left_done[slot].record()

    def left_after(self, j: int) -> int:
        """The block's masked count after step ``j``: on the card a wait
        for that step alone (later steps may still run); on the CPU, where
        every step has run, the count now."""
        if not self.graphs.cuda:
            return int(self.left)
        slot = j % POLL_LAG
        self._left_done[slot].synchronize()
        return int(self._left_host[slot])

    def read_back(self) -> Tuple[int, float, object]:
        """The decode's final readback: steps, forward-equivalents (before
        the caller adds refreshes) and the carry as CPU tensors."""
        leaves = tree_leaves(self.carry)
        host = _read([self.steps, self.fwd] + leaves)
        return (int(host[0]), float(host[1]),
                _rebuild(self.carry, iter(host[2:])))


def _step(strategy: Strategy, model_fn: Callable, cfg: ModelConfig,
          dcfg: DecodeConfig, run: GraphRun, blk: int) -> Callable:
    """One guarded denoising step of block ``blk`` over the static
    buffers: the body of a step graph.  Its writes are masked by ``live``
    (``run_masked``), the reference's ``while_loop`` condition."""
    cap = dcfg.block_size * 4
    last = run.sched.shape[0] - 1
    win_lo = run.win_los[blk]

    def step():
        x_win = run.window(blk)
        wcarry = carry_window(strategy, run.carry, win_lo, run.win)
        active = run.in_block[None, :] & (x_win == cfg.mask_token_id)
        live = active.any() & (run.i < cap)

        def body():
            # a gather: indexing with a 0-dim tensor would read it back
            n = run.sched.gather(0, run.i.clamp(max=last).long()
                                 .reshape(1)).reshape(())
            new_x, new_carry, fwd = strategy.device_step(
                run.generator, wcarry, x_win, active, model_fn, cfg, dcfg,
                n)
            return (new_x, new_carry, run.i + 1, run.steps + 1,
                    run.fwd + fwd.double() * run.scale)

        run_masked(live, body, (x_win, wcarry, run.i, run.steps, run.fwd))
        run.left.copy_((run.in_block[None, :] & (x_win == run.mask_id))
                       .sum(-1).max())
    return step


def _load_block(run: GraphRun, blk: int) -> None:
    """Load block ``blk``'s schedule row and column mask into the static
    rows (device to device) and zero its step counter."""
    run.in_block.copy_(run.in_blocks[blk])
    run.sched.copy_(run.scheds[blk])
    run.i.zero_()


def warm_run(strategy: Strategy, model_fn: Callable, cfg: ModelConfig,
             dcfg: DecodeConfig, run: GraphRun,
             refresh: Optional[Callable[[], None]] = None) -> None:
    """Before a new run's first capture: one refresh (cached path) and one
    step of block 0, eagerly on the capture stream (CUDA only;
    ``model_fn`` is block 0's).  ``start`` then resets what they wrote."""
    if not run.warmed and run.graphs.cuda:
        _load_block(run, 0)
        if refresh is not None:
            run.graphs.warm(refresh)
        run.graphs.warm(_step(strategy, model_fn, cfg, dcfg, run, 0))
    run.warmed = True


def graph_block(strategy: Strategy, model_fn: Callable, cfg: ModelConfig,
                dcfg: DecodeConfig, run: GraphRun, blk: int) -> None:
    """Decode block ``blk`` of ``run``'s canvas: the counterpart of the
    reference's ``drive_block``.  ``model_fn(tokens) -> logits``.

    Loads the block's rows, fires ``begin_block`` on the window's carry,
    then replays the step graph until the block has no masked position
    left, up to ``block_size·4`` steps.  Before replay ``j`` the host
    reads the count step ``j−2`` left (``POLL_LAG``): while it waits for
    that step, step ``j−1`` is queued, so the card never waits for the
    host, and a block that ends early costs one replay that changes
    nothing.  From the block's step budget on, where a strategy that
    keeps to its schedule ends, it waits for step ``j−1`` instead, so
    such a block costs no replay past its end (and the card idles for
    one host turn per block)."""
    _load_block(run, blk)
    win_lo = run.win_los[blk]
    wcarry = carry_window(strategy, run.carry, win_lo, run.win)
    write(wcarry, strategy.begin_block(wcarry, run.window(blk),
                                       run.in_block))
    step = _step(strategy, model_fn, cfg, dcfg, run, blk)
    cap = dcfg.block_size * 4
    budget = min(run.budgets[blk], cap)
    for j in range(cap):
        lag = POLL_LAG if j < budget else 1
        if j >= lag and run.left_after(j - lag) == 0:
            break
        run.graphs.run(("step", win_lo), step)
        run.post(j)


def graph_cached_block(strategy: Strategy, cached_fn: Callable,
                       cfg: ModelConfig, dcfg: DecodeConfig, run: GraphRun,
                       blk: int) -> None:
    """One block of cached decoding over the policy's live window of
    ``run``'s canvas, against the static cache ``run.tiles``
    (``cached_fn(x_win, win_lo, tiles) -> logits``, read-only with respect
    to it): the counterpart of the reference's ``drive_cached_block``.
    Refreshing the cache is the caller's business."""
    win_lo = run.win_los[blk]
    graph_block(strategy, lambda w: cached_fn(w, win_lo, run.tiles), cfg,
                dcfg, run, blk)
