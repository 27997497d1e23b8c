"""Start the ranks of a mesh as processes (``torch.multiprocessing``).

``spawn(fn, world, backend, store_path, *args)`` starts ``world`` fresh
processes (the ``spawn`` start method: no state is inherited), joins them
in one ``torch.distributed`` world through a ``FileStore`` at
``store_path`` (no TCP port, so concurrent test workers cannot clash),
runs ``fn(rank, *args)`` in each and returns the ranks' results in rank
order.  ``fn`` must be importable by name (a module-level function), and
its arguments and result picklable; tensors in the result (in dicts,
lists and tuples) come back as numpy arrays (bf16 widened to f32), since
a tensor shared through the queue would die with the rank that sent it.
Each rank makes its meshes itself (``launch/mesh.py:make_mesh``).

The backend is the caller's choice, ``"gloo"`` or ``"nccl"``; nothing
picks one for it.  NCCL refuses two ranks on one device, so four ranks
sharing one card run on gloo, whose all-reduce takes CUDA tensors too.

A rank that raises fails the whole run: the other ranks (which may be
waiting in a collective) are terminated, and ``spawn`` raises
``RuntimeError`` with the tracebacks that came back within ``GRACE_S``
of the first (a peer's broken collective may report before the rank
that raised).  Every process started here is
joined or terminated before ``spawn`` returns or raises.
"""
from __future__ import annotations

import datetime
import os
import queue as queue_mod
import time
import traceback
from typing import Any, Callable, List

import torch.distributed as dist
import torch.multiprocessing as mp

BACKENDS = ("gloo", "nccl")
POLL_S = 1.0
GRACE_S = 3.0


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_numpy(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    if hasattr(tree, "detach"):
        t = tree.detach().cpu()
        return (t.float() if t.is_floating_point() else t).numpy()
    return tree


def _rank_main(fn: Callable, rank: int, world: int, backend: str,
               store_path: str, timeout_s: float, results, args) -> None:
    try:
        if backend == "nccl":
            import torch
            torch.cuda.set_device(rank % torch.cuda.device_count())
        store = dist.FileStore(store_path, world)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, _to_numpy(out)))
    except BaseException:          # reported to the parent, then exit
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def _failures(results, failed: dict, world: int) -> str:
    """The failures reported within ``GRACE_S`` of the first, by rank."""
    end = time.monotonic() + GRACE_S
    while time.monotonic() < end:
        try:
            rank, ok, out = results.get(timeout=max(end - time.monotonic(),
                                                    0.01))
        except queue_mod.Empty:
            break
        if not ok:
            failed[rank] = out
    return f"ranks {sorted(failed)} of {world} failed:\n" + "\n".join(
        f"rank {r}:\n{failed[r]}" for r in sorted(failed))


def spawn(fn: Callable, world: int, backend: str, store_path: str,
          *args, timeout_s: float = 600.0) -> List[Any]:
    """Run ``fn(rank, *args)`` on ``world`` ranks; their results in rank
    order.  ``timeout_s`` bounds each collective and the whole run."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: pass one of {BACKENDS}")
    if os.path.exists(store_path):
        os.remove(store_path)       # a FileStore file is for one world
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, backend, store_path, timeout_s,
                               results, args), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(got) < world:
            try:
                rank, ok, out = results.get(timeout=POLL_S)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs) if r not in got
                        and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"spawn: ranks {dead} died without a "
                                       f"result (exit codes "
                                       f"{[procs[r].exitcode for r in dead]})")
                if time.monotonic() > deadline:
                    raise RuntimeError(f"spawn: no result within "
                                       f"{timeout_s} s")
                continue
            if not ok:
                raise RuntimeError(_failures(results, {rank: out}, world))
            got[rank] = out
    finally:
        for p in procs:
            p.join(timeout=30 if len(got) == world else 0.1)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return [got[r] for r in range(world)]
