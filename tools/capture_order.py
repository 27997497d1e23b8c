#!/usr/bin/env python3
"""Counts traced decodes whose trace marks a prompt column committed, over
new graph runs, in one or two checkouts on one card.

    python3 tools/capture_order.py [--other DIR] [--runs N]

Each decode builds a new ``GraphRun`` (a fresh runner cache), so it warms
the run, resets it and captures its first step: the order of those three
across the current and the capture stream is what this counts.  Half the
decodes first queue ~0.1 s of matrix products on the current stream
before the run's reset, so that the reset's copies are still queued when
the capture starts.  A prompt column never commits, so any
``commit_step >= 0`` there is a write that overtook the reset.

Full-width LLaDA-8B (random bf16 weights, seed 0), B=8, prompt 48,
gen 64, block 32, 64 steps, ``none``, traced ``fdm_a`` and
``probability``, each through ``generate`` and ``generate_blocks``.  DIR
is another checkout of this repository (e.g. an earlier tree unpacked
with ``git archive`` into a directory that ``.gitignore`` lists); with
it the checkouts run in fresh processes in the order other, this, this,
other.  Each process prints one JSON line; the last line is the card's
name and power limit.  Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def measure(runs: int) -> dict:
    import numpy as np
    import torch
    from repro_torch.configs import DecodeConfig, get_config
    from repro_torch.core import Decoder, decode_cache_scope, loop
    from repro_torch.kernels import _build
    from repro_torch.models import init_model
    _build.build_all()
    cfg = get_config("llada-8b")
    params = init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size - 1,
                                                (8, 48))
    busy = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    start = loop.GraphRun.start

    def busy_start(run, *args):
        for _ in range(60):
            busy @ busy
        start(run, *args)

    out = {}
    for strategy in ("fdm_a", "probability"):
        dcfg = DecodeConfig(gen_length=64, block_size=32, steps=64,
                            strategy=strategy, k=2, k1=2, trace=True)
        hit = total = 0
        for busy_first in (True, False):
            loop.GraphRun.start = busy_start if busy_first else start
            for _ in range(runs):
                for blocks in (True, False):
                    with decode_cache_scope():
                        dec = Decoder(params, cfg, dcfg, device="cuda")
                        gen = torch.Generator(device="cuda").manual_seed(11)
                        if blocks:
                            it = dec.generate_blocks(gen, prompts)
                            while True:
                                try:
                                    next(it)
                                except StopIteration as fin:
                                    _, st = fin.value
                                    break
                        else:
                            _, st = dec.generate(gen, prompts)
                    hit += bool((st.trace.commit_step[:, :48] >= 0).any())
                    total += 1
        loop.GraphRun.start = start
        out[strategy] = {"decodes": total, "prompt_columns_committed": hit}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="another checkout to count beside")
    ap.add_argument("--runs", type=int, default=3,
                    help="new runs per strategy, driver and reset order")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("capture_order: needs a CUDA card")
    if args.child:
        print(json.dumps(measure(args.runs)), flush=True)
        return
    this = ("this", ROOT)
    other = ("other", os.path.abspath(args.other or ROOT))
    for name, tree in [this] if args.other is None else \
            [other, this, this, other]:
        res = subprocess.run(
            [sys.executable, os.path.join(ROOT, "tools", "capture_order.py"),
             "--child", "--runs", str(args.runs)],
            env=dict(os.environ, PYTHONPATH=os.path.join(tree, "src")),
            cwd=tree, capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            raise SystemExit(f"capture_order: {tree} failed:\n"
                             f"{res.stderr[-3000:]}")
        counts = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": name, **counts}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())


if __name__ == "__main__":
    main()
