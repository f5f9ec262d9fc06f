"""Build and load the hand-written CUDA kernels; count their launches.

Each ``csrc/<name>.cu`` is compiled at first use by ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes``.  Libraries go
to ``build/kernels/`` at the repository root (git-ignored), named by a
hash of the source and flags, so a rebuild happens only when either
changes.  Nothing here runs at import time: the CPU tests import every
module, and a CPU-only PyTorch build has no CUDA at all.

``LAUNCHES`` holds one plain integer per kernel wrapper; a wrapper adds one
where it launches its kernel and nowhere else.  ``BACKWARDS`` counts the
calls of each kernel's autograd backward (plain PyTorch products, not a
launch of the kernel).
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

KERNELS = ("radial_gram", "panel_cholinv", "trailing_update", "whiten_sumsq")

# kernel wrapper name -> launches since the last reset; the gram kernel
# counts its four launch forms apart: the cross covariance, the square
# training covariance, the lazy-gram loop's column blocks and the
# walker-batched stack of training covariances, and each again with
# "_highd" in its tensor-core branch (f32, D >= 8), where the backward's
# squared-distance launches count as "radial_gram_d2_highd"; the panel
# kernel its single and its batched form; the trailing-update kernel its
# forward and its backward (one launch a panel each); the whitening kernel
# each of its 4 P - 1 launches a call
LAUNCHES: dict[str, int] = {"radial_gram": 0, "radial_gram_diag": 0, "radial_gram_cols": 0,
                            "radial_gram_diag_batched": 0, "radial_gram_highd": 0,
                            "radial_gram_diag_highd": 0, "radial_gram_cols_highd": 0,
                            "radial_gram_diag_batched_highd": 0, "radial_gram_d2_highd": 0,
                            "panel_cholinv": 0, "panel_cholinv_batched": 0,
                            "trailing_update": 0, "trailing_update_backward": 0, "whiten_sumsq": 0}
# kernel name -> calls of its autograd backward since the last reset
BACKWARDS: dict[str, int] = {"panel_cholinv": 0}

# kernel source name -> (library, build seconds, compiler log)
_LOADED: dict[str, tuple[ctypes.CDLL, float, str]] = {}
_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, BACKWARDS):
        for key in counts:
            counts[key] = 0


def count_launch(name: str, launches: int = 1) -> None:
    LAUNCHES[name] += launches


def count_backward(name: str) -> None:
    BACKWARDS[name] += 1


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
    if name not in _LOADED:
        load_all((name,))
    return _LOADED[name][0]


def load_all(names=KERNELS) -> None:
    """Load the named kernels' libraries, building those not on disk yet:
    one ``nvcc`` for each source, all started together."""
    with _LOCK:
        start = time.perf_counter()
        builds = []
        try:
            for name in names:
                if name in _LOADED:
                    continue
                source = PACKAGE_DIR / "csrc" / f"{name}.cu"
                digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
                lib_path = BUILD_DIR / f"{name}-{digest[:16]}.so"
                if lib_path.exists():
                    log_path = lib_path.with_suffix(".log")
                    log = log_path.read_text() if log_path.exists() else ""
                    _LOADED[name] = (ctypes.CDLL(str(lib_path)), 0.0, log)
                    continue
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
                proc = subprocess.Popen(
                    [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                    stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT,
                    text=True,
                )
                builds.append((name, proc, tmp, lib_path))
            for name, proc, tmp, lib_path in builds:
                log = proc.communicate()[0]
                seconds = time.perf_counter() - start
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed to build {name}.cu:\n{log}")
                lib_path.with_suffix(".log").write_text(log)
                os.replace(tmp, lib_path)
                _LOADED[name] = (ctypes.CDLL(str(lib_path)), seconds, log)
        finally:
            for _, proc, _, _ in builds:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()


def build_info(name: str) -> tuple[float, str]:
    """(seconds from the start of its build until the library was ready,
    compiler log) of a loaded kernel library; 0 seconds when the library
    was already on disk (the log is the one kept from its build)."""
    load(name)
    _, seconds, log = _LOADED[name]
    return seconds, log


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if code != 0:
        lib.kernel_error_string.restype = ctypes.c_char_p
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        message = lib.kernel_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({message})")
