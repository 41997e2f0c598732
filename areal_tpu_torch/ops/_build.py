"""Build the port's CUDA sources at first use and bind them with ctypes.

Each ``csrc/*.cu`` file has a plain C interface.  It is compiled by
``nvcc`` for ``sm_90a`` into a shared library under
``areal_tpu_torch/_build/`` (listed in ``.gitignore``), named by a hash of
its source and flags so an edited source is rebuilt, and loaded with
``ctypes``.  Nothing is built when a module is imported: the first kernel
launch (or an explicit :func:`load_library` call) builds.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class Library:
    cdll: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an up-to-date build was found on disk
    log: str  # nvcc's output (ptxas register/shared-memory report)


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(home) / "bin" / "nvcc"
        if cand.exists():
            nvcc = str(cand)
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (not on PATH, nor under $CUDA_HOME/bin or "
            "/usr/local/cuda/bin): the port's CUDA kernels are built from "
            "source at first use and need the CUDA toolkit"
        )
    return nvcc


def build(name: str) -> Library:
    """Compile ``csrc/<name>.cu`` (if its hashed build is missing) and load
    it."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}_{digest}.so"
    log, seconds = "", 0.0
    if not out.exists():
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".so.tmp-{os.getpid()}")
        tik = time.perf_counter()
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True,
        )
        seconds = time.perf_counter() - tik
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {src}:\n{log}")
        os.replace(tmp, out)
    return Library(ctypes.CDLL(str(out)), out, seconds, log)


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> Library:
    """The built library for ``csrc/<name>.cu``, built once per process.
    Raises when there is no CUDA device or no ``nvcc``: the kernels run
    only on a card."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            f"the CUDA kernel library {name!r} needs a CUDA device, and "
            "torch.cuda.is_available() is False"
        )
    return build(name)
