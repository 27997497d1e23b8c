#!/usr/bin/env python3
"""Times the port's bf16 flash-attention kernel of two checkouts on one card.

    python3 tools/flash_ab.py --other DIR

DIR is another checkout of this repository, for example the parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists.
Each checkout builds its kernels into its own ``build/`` directory and is
timed in a fresh process, in the order other, this, this, other, at the
attention shapes of ``chip_smoke.py``'s kernel phase: call to call (host
dispatch included, like ``chip_smoke.py``'s "kernel" column) and on the
device alone (the calls enqueued while the card spins).  Each process
prints one JSON line; the last lines are a table of both checkouts' times
per shape and the card's name and power limit.  Needs a CUDA card;
imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (timing helpers and shapes)


def worker(root: str) -> None:
    """Times ``root``'s kernel at every shape; prints one JSON line."""
    import torch
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.kernels import flash_attention as fa_mod
    assert os.path.samefile(os.path.dirname(fa_mod.__file__),
                            os.path.join(root, "src", "repro_torch",
                                         "kernels"))
    rows = []
    for b, lq, lk, h, g, d, w in chip_smoke.ATTN_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
        q = torch.randn(b, lq, h, d, generator=gen, device="cuda").bfloat16()
        k = torch.randn(b, lk, g, d, generator=gen, device="cuda").bfloat16()
        v = torch.randn(b, lk, g, d, generator=gen, device="cuda").bfloat16()

        def kernel():
            return fa_mod.flash_attention(q, k, v, w)
        err = float((kernel().float() -
                     fa_mod.attention_ref(q, k, v, w).float()).abs().max())
        rows.append({"shape": [b, lq, lk, h, g, d, w], "max_abs_err": err,
                     "ms": chip_smoke.time_ms(kernel),
                     "device_ms": chip_smoke.device_ms(kernel)})
    print(json.dumps({"root": root, "rows": rows}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="the other checkout's root")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("flash_ab: needs a CUDA card")
    if args.worker:
        worker(args.worker)
        return
    if not args.other:
        ap.error("--other is required")
    other = os.path.abspath(args.other)
    runs = []
    for root in (other, ROOT, ROOT, other):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", root], stdout=subprocess.PIPE,
                             text=True, check=True).stdout
        line = out.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    print("shape (B, Lq, Lk, H, G, d, window): other | this, call-to-call "
          "ms (two processes each), then device-alone ms")
    for i, shape in enumerate(chip_smoke.ATTN_SHAPES):
        def col(root, key):
            return [r["rows"][i][key] for r in runs if r["root"] == root]
        o_ms, t_ms = col(other, "ms"), col(ROOT, "ms")
        o_dev, t_dev = col(other, "device_ms"), col(ROOT, "device_ms")
        print(f"{shape}: call {o_ms[0]:.4f} {o_ms[1]:.4f} | "
              f"{t_ms[0]:.4f} {t_ms[1]:.4f}; device {o_dev[0]:.4f} "
              f"{o_dev[1]:.4f} | {t_dev[0]:.4f} {t_dev[1]:.4f}; "
              f"other/this device "
              f"{statistics.mean(o_dev) / statistics.mean(t_dev):.2f}")
    print(chip_smoke.nvidia_smi())


if __name__ == "__main__":
    main()
