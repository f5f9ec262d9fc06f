"""Build and load the hand-written CUDA kernels; count their launches.

Each ``csrc/<name>.cu`` is compiled at first use by ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes``.  Libraries go
to ``build/kernels/`` at the repository root (git-ignored), named by a
hash of the source and flags, so a rebuild happens only when either
changes.  Nothing here runs at import time: the CPU tests import every
module, and a CPU-only PyTorch build has no CUDA at all.

``LAUNCHES`` holds one plain integer per kernel wrapper; a wrapper adds one
where it launches its kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

KERNELS = ("radial_gram", "panel_cholinv")

# kernel wrapper name -> launches since the last reset
LAUNCHES: dict[str, int] = {"radial_gram": 0, "radial_gram_diag": 0, "panel_cholinv": 0}

# kernel source name -> (library, build seconds, compiler log)
_LOADED: dict[str, tuple[ctypes.CDLL, float, str]] = {}
_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME is unset): cannot build kernels")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}: cannot build kernels")
    return str(nvcc)


def load(name: str) -> ctypes.CDLL:
    """The compiled library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        if name not in _LOADED:
            _LOADED[name] = _build(name)
        return _LOADED[name][0]


def build_info(name: str) -> tuple[float, str]:
    """(seconds spent building, compiler log) of a loaded kernel library;
    0 seconds when the library was already on disk (the log is the one
    kept from its build)."""
    load(name)
    _, seconds, log = _LOADED[name]
    return seconds, log


def _build(name: str) -> tuple[ctypes.CDLL, float, str]:
    source = PACKAGE_DIR / "csrc" / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"{name}-{digest[:16]}.so"
    log_path = lib_path.with_suffix(".log")
    seconds = 0.0
    if lib_path.exists():
        log = log_path.read_text() if log_path.exists() else ""
    else:
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        start = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
            capture_output=True,
            text=True,
        )
        seconds = time.perf_counter() - start
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {source.name}:\n{log}")
        log_path.write_text(log)
        os.replace(tmp, lib_path)
    return ctypes.CDLL(str(lib_path)), seconds, log


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if code != 0:
        lib.kernel_error_string.restype = ctypes.c_char_p
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        message = lib.kernel_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({message})")
