"""Build the port's CUDA sources into shared libraries and load them.

Each library is compiled by `nvcc` straight into a shared object with a
plain C interface and loaded with `ctypes` (no PyTorch headers: a build
takes seconds, not minutes). Builds land in `build/torch_kernels/` at the
root of the checkout, keyed by a hash of the sources and flags, so a fresh
checkout builds everything on first use and an unchanged one reuses it.
Nothing is compiled at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# name -> {"seconds": build wall time (0.0 when reused), "log": nvcc's stderr}
BUILD_INFO: dict[str, dict] = {}

_COUNT_LOCK = threading.Lock()


def count_launch(module: str, counter: str = "launches") -> None:
    """Add one to the launch count `counter` of the wrapper module named
    `module`. One lock guards every count: the HTTP server launches kernels
    from its batch worker and its handler threads at once, and a bare
    `count += 1` can lose an increment between threads."""
    mod = sys.modules[module]
    with _COUNT_LOCK:
        setattr(mod, counter, getattr(mod, counter) + 1)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source at first use")


@functools.cache
def load_library(name: str, *sources: str) -> ctypes.CDLL:
    """Compile csrc/<sources> into lib<name>-<hash>.so (once) and load it."""
    paths = [CSRC / s for s in sources]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    so = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    info = {"seconds": 0.0, "log": ""}
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # per thread: two threads of one process may build the same library
        tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, paths)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {name}:\n{proc.stderr}")
        os.replace(tmp, so)
        info = {"seconds": time.perf_counter() - t0, "log": proc.stderr}
    BUILD_INFO[name] = info
    return ctypes.CDLL(str(so))
