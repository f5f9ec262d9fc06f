"""ctypes bindings for the native C++ host components (``native.cpp``).

The counterpart of ``albatross_tpu._native``, over a copy of its source.
The library is built by ``g++`` at first use into ``build/native/`` at the
repository root (git-ignored), named by a hash of the source, never beside
the source; nothing is built when the module is imported.  Callers keep a
pure-Python path for where no ``g++`` exists (``utils/csv.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

_SOURCE = Path(__file__).resolve().parent / "native.cpp"
BUILD_DIR = _SOURCE.parent.parent.parent / "build" / "native"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def available() -> bool:
    """Whether a C++ compiler is on the path to build the library."""
    return shutil.which("g++") is not None


def _build() -> Path:
    digest = hashlib.sha256(_SOURCE.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    path = BUILD_DIR / f"libalbatross_native-{digest}.so"
    if not path.exists():
        if not available():
            raise RuntimeError("g++ not found: cannot build the native library")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", *_FLAGS, str(_SOURCE), "-o", str(tmp)], check=True, capture_output=True)
        os.replace(tmp, path)
    return path


def _load() -> ctypes.CDLL:
    global _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(_build()))
        lib.csv_open.restype = ctypes.c_void_p
        lib.csv_open.argtypes = [ctypes.c_char_p]
        lib.csv_num_cols.restype = ctypes.c_int64
        lib.csv_num_cols.argtypes = [ctypes.c_void_p]
        lib.csv_num_rows.restype = ctypes.c_int64
        lib.csv_num_rows.argtypes = [ctypes.c_void_p]
        lib.csv_header.restype = ctypes.c_char_p
        lib.csv_header.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.csv_copy_column.restype = None
        lib.csv_copy_column.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_double)]
        lib.csv_free.restype = None
        lib.csv_free.argtypes = [ctypes.c_void_p]
        lib.mst_kruskal.restype = ctypes.c_int64
        lib.mst_kruskal.argtypes = [
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_uint8),
        ]
        _lib = lib
        return lib


def parse_csv(path: str) -> Dict[str, np.ndarray]:
    """Numeric CSV -> {column name: float64 array} by the C++ parser."""
    lib = _load()
    handle = lib.csv_open(str(path).encode())
    if not handle:
        raise IOError(f"could not open {path}")
    try:
        out: Dict[str, np.ndarray] = {}
        nrows = lib.csv_num_rows(handle)
        for i in range(lib.csv_num_cols(handle)):
            col = np.empty(nrows, dtype=np.float64)
            lib.csv_copy_column(handle, i, col.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
            out[lib.csv_header(handle, i).decode()] = col
        return out
    finally:
        lib.csv_free(handle)


def mst_kruskal(a, b, cost) -> np.ndarray:
    """Edge-selection mask of the minimum spanning tree (C++ Kruskal)."""
    lib = _load()
    a = np.ascontiguousarray(a, dtype=np.int64)
    b = np.ascontiguousarray(b, dtype=np.int64)
    cost = np.ascontiguousarray(cost, dtype=np.float64)
    mask = np.zeros(a.shape[0], dtype=np.uint8)
    lib.mst_kruskal(
        a.shape[0],
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cost.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return mask.astype(bool)
