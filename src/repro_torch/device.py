"""Device resolution for the port's entry points.

Entry points default to ``"cuda"``.  Without a card they raise instead of
dropping to the CPU on their own: the CPU runs only when the caller asks
for it (``device="cpu"``), and there every kernel wrapper takes its plain
PyTorch version.  ``"meta"`` builds shape-only stand-ins for the one-card
dry-run (``launch/dryrun.py``): there every kernel wrapper returns empty
outputs of its kernel's shapes and dtypes.  No entry point defaults to it.
"""
from __future__ import annotations

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the card by default; "
            "pass device='cpu' to run the plain versions on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev!r}; use 'cuda' or 'cpu' "
                         f"('meta' for shape-only stand-ins)")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype string -> torch dtype."""
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; have {sorted(_DTYPES)}")
    return _DTYPES[name]
