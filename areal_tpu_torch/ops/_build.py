"""Build the port's CUDA sources at first use and bind them with ctypes.

Each ``csrc/*.cu`` file has a plain C interface (helpers shared between
sources live in ``csrc/*.cuh``).  It is compiled by
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


def _target(name: str):
    """(source, hashed output path) of ``csrc/<name>.cu``.  The hash
    covers the source, the shared headers ``csrc/*.cuh`` and the flags."""
    src = CSRC_DIR / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}_{digest}.so"


def build_many(names) -> dict:
    """Compile every ``csrc/<name>.cu`` whose hashed build is missing, one
    ``nvcc`` process per source, all started together; then load each.
    Returns ``{name: Library}``."""
    jobs = {}
    for name in names:
        src, out = _target(name)
        if out.exists():
            continue
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".so.tmp-{os.getpid()}")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        jobs[name] = (src, out, tmp, proc, time.perf_counter())
    logs = {}
    for name, (src, out, tmp, proc, tik) in jobs.items():
        log = proc.communicate()[0]
        seconds = time.perf_counter() - tik
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {src}:\n{log}")
        os.replace(tmp, out)
        logs[name] = (log, seconds)
    libs = {}
    for name in names:
        _, out = _target(name)
        log, seconds = logs.get(name, ("", 0.0))
        libs[name] = Library(ctypes.CDLL(str(out)), out, seconds, log)
    return libs


def build(name: str) -> Library:
    """Compile ``csrc/<name>.cu`` (if its hashed build is missing) and load
    it."""
    return build_many([name])[name]


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


def load_libraries(*names: str) -> dict:
    """Build the named libraries in parallel (one nvcc each) and load them
    into :func:`load_library`'s cache.  Returns ``{name: Library}`` with
    each build's nvcc log and seconds."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            f"the CUDA kernel libraries {names} need a CUDA device, and "
            "torch.cuda.is_available() is False"
        )
    built = build_many(names)
    for name in names:
        load_library(name)  # finds the fresh builds on disk
    return built
