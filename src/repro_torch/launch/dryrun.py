"""One-card dry-run: prove every (architecture × input shape) runs at full
width and depth, say whether it fits one H100, and at what batch, and
report its roofline terms (reference: ``src/repro/launch/dryrun.py``,
which compiles for a TPU pod; one card forms no mesh).

Per combination:
  1. the shape proof — ``make_steps(cfg)[kind]`` runs once on torch's
     ``meta`` device at batch 1 and at batch 2, and at 3 where batch 1
     makes other ops (``PeakModel``); the kernel wrappers return meta
     stand-ins of their outputs.  ``LiveBytes``, a dispatch mode,
     follows the bytes held by live storages after every op: the
     counterpart of ``memory_analysis``.  A step that cannot run on meta
     (one that reads a value back to the host) fails its row by name;
  2. the fit — the argument bytes at the shape's batch are exact (built
     on meta).  Two runs that make the same ops in the same order give
     the live bytes after each op, extrapolated linearly in the batch, as
     the reference extrapolates its costs over layers, and the peak at a
     batch is their largest: a step whose peak at batch 1 and 2 is its
     optimizer's still peaks in its backward at a larger batch.  It fits
     when the peak stays under ``HBM_BYTES`` less ``RESERVE_BYTES``;
     ``max_batch`` is the largest batch up to the shape's that fits (0 if
     none).  ``layer_bytes`` are one layer's mean bytes held for the whole
     step at batch 1 (weights, decode state; to train also gradients and
     AdamW's moments), ``max_layers`` the most such layers that fit
     beside the rest of the batch-1 peak: a cut depth.  A shape past a
     model's positional table (whisper's sinusoidal rows, ``max_seq_len``)
     is refused by the model, not run: its row says so and does not fit;
  3. the roofline terms at ``max_batch`` (batch 1 where none fits), from
     ``roofline.step_cost`` and ``model_flops_per_step``.

Usage:
    python -m repro_torch.launch.dryrun --arch llada-8b --shape prefill_32k
    python -m repro_torch.launch.dryrun --all [--json PATH]
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.roofline import (HBM_BYTES, Roofline,
                                         model_flops_per_step, step_cost,
                                         tree_bytes)
from repro_torch.launch.specs import (SHAPES, input_specs,
                                      shape_admissible)
from repro_torch.launch.steps import make_steps

# what the card holds besides the tensors the step allocates: the CUDA
# context, cuBLAS's workspaces and the caching allocator's rounding
RESERVE_BYTES = 3 * 2 ** 30
DRYRUN_ARCHS = ["llada-8b"] + list(ASSIGNED_ARCHS)


class LiveBytes(TorchDispatchMode):
    """Bytes held by the live storages that ops made while the mode was on,
    plus those of ``hold``'s tensors: ``live`` now, ``trace`` after every
    op (and every ``hold``), ``peak`` the largest.  A storage counts once
    however many views share it, from its first op until it dies
    (``weakref.finalize`` on the storage)."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.trace: List[int] = []
        self._sizes: Dict[int, int] = {}

    @property
    def peak(self) -> int:
        return max(self.trace, default=0)

    def hold(self, tree) -> None:
        """Count the storages of ``tree``'s tensors not yet counted (the
        step's arguments, an op's outputs)."""
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                key = st._cdata
                if key not in self._sizes:
                    self._sizes[key] = st.nbytes()
                    self.live += st.nbytes()
                    weakref.finalize(st, self._drop, key)
        self.trace.append(self.live)

    def _drop(self, key: int) -> None:
        self.live -= self._sizes.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.hold(out)
        return out


_SCALARS = (int, float, bool, str, type(None), torch.dtype, torch.device,
            torch.layout, torch.memory_format)


def _meta_key(x):
    """A hashable key of an op argument's metadata (tensors by shape,
    strides, dtype and device), or ``None`` if it holds anything else."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.stride(), x.dtype, x.device.type)
    if isinstance(x, (list, tuple)):
        keys = tuple(_meta_key(v) for v in x)
        return None if any(k is None for k in keys) else (type(x), keys)
    if isinstance(x, dict):
        return _meta_key(tuple(x.items()))
    return (x,) if isinstance(x, _SCALARS) else None


class MetaOpCache(TorchDispatchMode):
    """Answers a functional op on meta tensors from its first answer.

    Meta kernels of many ops are Python (``torch._refs``, meta
    registrations): 0.1–1.5 ms an op, and an sLSTM's or a chunked scan's
    time loop makes hundreds of thousands.  An op that mutates nothing and
    returns no alias makes outputs whose shapes, strides and dtypes follow
    from its arguments' metadata alone, so this mode runs it once per
    (op, arguments' metadata) and answers later calls with fresh empty
    meta tensors of the same layout.  An op whose first output shares a
    storage with an argument though its schema declares no alias
    (``aten._unsafe_view``) is never answered from the cache."""

    def __init__(self):
        super().__init__()
        self._outs: Dict[tuple, object] = {}
        self._aliasing: set = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        schema = func._schema
        key = None
        if func not in self._aliasing and not schema.is_mutable and not any(
                r.alias_info is not None for r in schema.returns):
            key = _meta_key((args, kwargs))
        if key is not None and (func, key) in self._outs:
            return self._make(self._outs[func, key])
        out = func(*args, **kwargs)
        if key is not None:
            spec = self._spec(out)
            ins = {t.untyped_storage()._cdata for t in tree_leaves(
                (args, kwargs)) if isinstance(t, torch.Tensor)}
            if any(t.untyped_storage()._cdata in ins for t in tree_leaves(out)
                   if isinstance(t, torch.Tensor)):
                self._aliasing.add(func)
            elif spec is not None:
                self._outs[func, key] = spec
        return out

    def _spec(self, out):
        if isinstance(out, torch.Tensor):
            if out.device.type != "meta":
                return None
            return ("t", tuple(out.shape), out.stride(), out.dtype)
        if isinstance(out, (list, tuple)):
            specs = [self._spec(o) for o in out]
            return None if any(s is None for s in specs) else \
                (type(out), specs)
        return None

    def _make(self, spec):
        if spec[0] == "t":
            return torch.empty_strided(spec[1], spec[2], dtype=spec[3],
                                       device="meta")
        return spec[0](self._make(s) for s in spec[1])


def meta_trace(cfg: ModelConfig, shape_name: str, batch: int) -> np.ndarray:
    """Live bytes after each op of one ``make_steps(cfg)[kind]`` run on
    meta at ``batch``, its arguments included."""
    bundle = input_specs(cfg, shape_name, batch)
    step = make_steps(cfg)[bundle.kind]
    mode = LiveBytes()
    mode.hold(bundle.args)
    with MetaOpCache(), mode:
        out = step(*bundle.args)
    del out, bundle
    return np.asarray(mode.trace, dtype=np.int64)


class PeakModel:
    """The peak bytes at any batch from live-bytes traces: two runs that
    make the same ops in the same order (batch ``lo`` and ``lo + 1``) are
    op by op linear in the batch; the peak is the largest.  Batch 1 can
    lay a reshape out as a view that copies at 2 and more, so where the
    runs at 1 and 2 differ in ops, the line goes through 2 and 3 and batch
    1 keeps its own run's peak."""

    def __init__(self, runs: Dict[int, np.ndarray]):
        self.p1 = int(runs[1].max())
        self.lo = 1 if runs[1].shape == runs[2].shape else 2
        t_lo, t_hi = runs[self.lo], runs[self.lo + 1]
        if t_lo.shape != t_hi.shape:
            raise RuntimeError(f"the runs at batch {self.lo} and "
                               f"{self.lo + 1} made {len(t_lo)} and "
                               f"{len(t_hi)} ops: their live bytes cannot "
                               f"be paired op by op")
        self.t_lo, self.slope = t_lo, t_hi - t_lo

    def peak(self, batch: int) -> int:
        if batch == 1:
            return self.p1
        return int((self.t_lo + (batch - self.lo) * self.slope).max())

    def max_batch(self, limit: int, usable: int) -> int:
        """The largest batch ≤ ``limit`` whose peak is ≤ ``usable`` (0 if
        none): the peak never falls as the batch grows."""
        lo, hi = 0, limit
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if self.peak(mid) <= usable:
                lo = mid
            else:
                hi = mid - 1
        return lo


def peak_model(cfg: ModelConfig, shape_name: str) -> PeakModel:
    """``PeakModel`` from meta runs at batch 1 and 2 (and 3 where batch 1
    makes other ops)."""
    runs = {b: meta_trace(cfg, shape_name, b) for b in (1, 2)}
    if runs[1].shape != runs[2].shape:
        runs[3] = meta_trace(cfg, shape_name, 3)
    return PeakModel(runs)


def _layer_bytes(cfg: ModelConfig, args, kind: str) -> float:
    """One layer's mean bytes held for the whole step: its weights (to
    train, also their gradients and AdamW's moments) and its decode
    state."""
    total = tree_bytes(args[0]["blocks"])
    if kind == "train":
        total += total + tree_bytes((args[1].mu["blocks"],
                                        args[1].nu["blocks"]))
    if kind == "serve":
        total += tree_bytes(args[3].layer_states)
    return total / cfg.num_layers


def refusal(params, seq: int) -> Optional[str]:
    """Why the model refuses ``seq`` positions (None if it takes them): a
    sinusoidal table of ``max_seq_len`` rows ends before them."""
    pos = params["embed"].get("pos")
    if pos is not None and seq > pos.shape[0]:
        return (f"positions 0..{seq} run past the sinusoidal table's "
                f"{pos.shape[0]} rows (max_seq_len)")
    return None


def dryrun(arch: str, shape_name: str, verbose: bool = True) -> dict:
    """The row of one (arch × shape): its fit and its roofline terms."""
    cfg = get_config(arch)
    kind, seq, batch = SHAPES[shape_name]
    usable = HBM_BYTES - RESERVE_BYTES
    one = input_specs(cfg, shape_name, 1).args
    layer = _layer_bytes(cfg, one, kind)
    refused = refusal(one[0], seq)
    del one
    args_bytes = tree_bytes(input_specs(cfg, shape_name, batch).args)
    row = {"arch": arch, "shape": shape_name, "kind": kind, "seq": seq,
           "batch": batch, "args_bytes": args_bytes, "refused": refused,
           "peak_b1": None, "peak_b2": None, "peak": None,
           "usable_bytes": usable, "fits": False, "max_batch": 0,
           "layer_bytes": layer, "max_layers_b1": 0, "meta_seconds": 0.0}
    if refused is None:
        t0 = time.perf_counter()
        model = peak_model(cfg, shape_name)
        row["meta_seconds"] = time.perf_counter() - t0
        rest = model.peak(1) - cfg.num_layers * layer
        row.update(peak_b1=model.peak(1), peak_b2=model.peak(2),
                   peak=model.peak(batch),
                   fits=model.peak(batch) <= usable,
                   max_batch=model.max_batch(batch, usable),
                   max_layers_b1=min(cfg.num_layers,
                                     int(max(usable - rest, 0) // layer)))
    at = max(row["max_batch"], 1)
    flops, nbytes = step_cost(cfg, kind, seq, at)
    roof = Roofline(arch=arch, shape=shape_name, batch=at, flops=flops,
                    bytes_accessed=nbytes,
                    model_flops=model_flops_per_step(cfg, kind, seq, at))
    row.update(roofline_batch=at, flops=flops, bytes=nbytes,
               model_flops=roof.model_flops, t_compute=roof.t_compute,
               t_memory=roof.t_memory, bottleneck=roof.bottleneck,
               useful_ratio=roof.useful_ratio, roofline_row=roof.row())
    if verbose:
        print(format_row(row), flush=True)
    return row


def format_row(r: dict) -> str:
    gb = 1e9
    head = (f"[{r['arch']} × {r['shape']}] {r['kind']} L={r['seq']} "
            f"B={r['batch']}: args {r['args_bytes'] / gb:.2f} GB, ")
    if r["refused"]:
        fit = f"refused by the model: {r['refused']}"
    else:
        fit = (f"peak {r['peak'] / gb:.2f} GB (B=1 {r['peak_b1'] / gb:.2f}, "
               f"B=2 {r['peak_b2'] / gb:.2f}) of {r['usable_bytes'] / gb:.2f}"
               f" GB usable: {'fits' if r['fits'] else 'does not fit'}, "
               f"largest batch {r['max_batch']}; {r['layer_bytes'] / gb:.3f}"
               f" GB a layer, {r['max_layers_b1']} layers fit at B=1")
    return (head + fit +
            f" | at B={r['roofline_batch']}: compute "
            f"{r['t_compute'] * 1e3:.2f} ms, memory {r['t_memory'] * 1e3:.2f}"
            f" ms -> {r['bottleneck']}-bound, useful "
            f"{r['useful_ratio']:.3f} | meta runs {r['meta_seconds']:.1f} s")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None,
                    help="architecture id (default: llada-8b and every "
                         "assigned one)")
    ap.add_argument("--shape", default=None,
                    help="input shape id (default: all four)")
    ap.add_argument("--all", action="store_true",
                    help="run every admissible (arch × shape)")
    ap.add_argument("--json", default=None, help="append JSONL rows here")
    args = ap.parse_args(argv)
    if not (args.all or args.arch or args.shape):
        ap.error("give --arch and/or --shape, or --all")
    archs = [args.arch] if args.arch else DRYRUN_ARCHS
    shapes = [args.shape] if args.shape else list(SHAPES)
    rows, failures = [], []
    t0 = time.perf_counter()
    for arch in archs:
        cfg = get_config(arch)
        for shape in shapes:
            if not shape_admissible(cfg, shape):
                print(f"[{arch} × {shape}] SKIP (full-attention arch)")
                continue
            try:
                rows.append(dryrun(arch, shape))
            except Exception as e:   # a step that cannot run on meta
                failures.append((arch, shape, repr(e)))
                traceback.print_exc()
    refused = sum(r["refused"] is not None for r in rows)
    print(f"\n=== dry-run summary: {len(rows)} ok, {len(failures)} failed; "
          f"{refused} of the ok refused by the model "
          f"({time.perf_counter() - t0:.1f} s) ===")
    for arch, shape, err in failures:
        print(f"  FAIL {arch} × {shape}: {err[:200]}")
    if rows:
        print("\n| arch | shape | batch | compute ms | memory ms | "
              "bottleneck | useful |\n|---|---|---|---|---|---|---|")
        for r in rows:
            print(r["roofline_row"])
    if args.json and rows:
        with open(args.json, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
