"""nvcc build and ctypes loader for the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled on its own, with a plain C interface,
into a shared library under ``build/repro_torch/`` at the repository root
(listed in ``.gitignore``):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the source and the flags, so an edited
source is rebuilt and a stale library is never loaded.  The first CUDA
call builds every missing library, one ``nvcc`` per source, all started
together.  Nothing here runs at import: the CPU tests import every module
of the port on a machine with no ``nvcc``.  A missing toolchain raises.

``function(name, symbol, argtypes)`` is what a wrapper calls per launch:
the C function bound once (``argtypes``, ``restype``) when its library
loads, then a dictionary read with no lock, so a wrapper called while a
CUDA graph is capturing does nothing on the host but launch.

``refuse_grad(name, *inputs)`` guards a kernel that has no backward: its
ctypes call leaves no autograd node, so it raises where autograd would
need one.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("confidence", "flash_attention", "selective_scan")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[str, Callable] = {}
# what the last build did: seconds spent and each source's ptxas report
last_build: Dict[str, object] = {"seconds": 0.0, "ptxas": {}}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the port's CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, all in parallel.
    Returns ``{name: library path}``; raises on any compiler error."""
    paths = {name: library_path(name) for name in SOURCES}
    missing = {n: p for n, p in paths.items() if not p.exists()}
    if not missing:
        return paths
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name, out in missing.items():
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        last_build["ptxas"][name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {name}.cu:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    last_build["seconds"] = time.perf_counter() - t0
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(str(build_all()[name]))
        return lib


def function(name: str, symbol: str, argtypes: Sequence) -> Callable:
    """C function ``symbol`` of ``csrc/<name>.cu`` returning an int,
    with its argument types bound once."""
    fn = _FUNCS.get(symbol)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        _FUNCS[symbol] = fn
    return fn


def refuse_grad(name: str, *inputs: torch.Tensor) -> None:
    """Raise rather than return a kernel's result without a gradient path
    where autograd would need one (the CPU paths differentiate; ROADMAP.md
    queue 3 item 2)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward and an input "
            f"requires grad; call it under torch.no_grad(), or on the CPU "
            f"(ROADMAP.md queue 3 item 2)")
