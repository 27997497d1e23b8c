#!/usr/bin/env python3
"""Times one of the port's kernels in two checkouts on one card.

    python3 tools/kernel_ab.py --kernel selective_scan --other DIR

KERNEL is ``confidence``, ``flash_attention`` or ``selective_scan``.  DIR
is another checkout of this repository, for example the parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists.
Each checkout builds its kernels into its own ``build/`` directory and is
timed in a fresh process, in the order other, this, this, other, at the
kernel's shapes in ``chip_smoke.py``'s kernel phase (the same inputs in
both): call to call (host dispatch included, like ``chip_smoke.py``'s
"kernel" column) and on the device alone (the calls enqueued while the
card spins).  Each process prints one JSON line; the last lines are a
table of both checkouts' times per shape and the card's name and power
limit.  Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (timing helpers, shapes and inputs)

# kernel: (shapes, input maker, kernel function, plain function)
KERNELS = {
    "confidence": (chip_smoke.CONF_SHAPES, chip_smoke.conf_inputs,
                   "confidence_fused", "confidence_ref"),
    "flash_attention": (chip_smoke.ATTN_SHAPES, chip_smoke.attn_inputs,
                        "flash_attention", "attention_ref"),
    "selective_scan": (chip_smoke.SCAN_SHAPES, chip_smoke.scan_inputs,
                       "selective_scan", "selective_scan_ref"),
}


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


def worker(root: str, kernel: str) -> None:
    """Times ``root``'s kernel at every shape; prints one JSON line."""
    import torch
    sys.path.insert(0, os.path.join(root, "src"))
    mod = importlib.import_module(f"repro_torch.kernels.{kernel}")
    assert os.path.samefile(os.path.dirname(mod.__file__),
                            os.path.join(root, "src", "repro_torch",
                                         "kernels"))
    shapes, inputs, fn, plain = KERNELS[kernel]
    rows = []
    for shape in shapes:
        args = inputs(torch, *shape)

        def call():
            return getattr(mod, fn)(*args)
        err = max(float((g.float() - r.float()).abs().max()) for g, r in
                  zip(_tuple(call()), _tuple(getattr(mod, plain)(*args))))
        rows.append({"shape": list(shape), "max_abs_err": err,
                     "ms": chip_smoke.time_ms(call),
                     "device_ms": chip_smoke.device_ms(call)})
    print(json.dumps({"root": root, "kernel": kernel, "rows": rows}),
          flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", required=True, choices=sorted(KERNELS))
    ap.add_argument("--other", help="the other checkout's root")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA card")
    if args.worker:
        worker(args.worker, args.kernel)
        return
    if not args.other:
        ap.error("--other is required")
    other = os.path.abspath(args.other)
    runs = []
    for root in (other, ROOT, ROOT, other):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--kernel", args.kernel, "--worker", root],
                             stdout=subprocess.PIPE, text=True,
                             check=True).stdout
        line = out.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    print(f"{args.kernel} shape: other | this, call-to-call ms (two "
          f"processes each), then device-alone ms")
    for i, shape in enumerate(KERNELS[args.kernel][0]):
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
