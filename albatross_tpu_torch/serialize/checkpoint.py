"""Checkpoints: save and load models, fits, chains and RANSAC outputs.

Counterpart of ``albatross_tpu.serialize.checkpoint``, in the port's own
format.  The object graph is pickled with every tensor and numpy array
taken out of the pickle (``persistent_id``) and stored, with its dtype, in
one zlib-compressed ``.npz`` payload; the file is a magic string, then a
pickled dict of the version, the object graph and the arrays.

* The magic differs from the JAX package's (``b"ALBTPU01"``): a JAX
  checkpoint given to the port fails with a ValueError that says so, and
  the JAX package refuses the port's files the same way.
* Loading is restricted: a name resolves only if it is a class defined in
  ``albatross_tpu_torch`` or on the explicit lists of data types of
  ``builtins``, ``collections``, ``functools``, numpy and ``torch``
  (dtypes, ``torch.device``, ``torch.Size``).  No function resolves
  (``builtins.eval``, ``getattr`` or ``__import__`` included), nor any name
  reached through a module that a port module imports.  Tensors come back
  through their persistent ids, so no torch code is unpickled.
  ``CLASS_RENAMES`` maps (module, name) pairs of classes that moved to
  their new homes, so old checkpoints keep loading.
* ``SERIALIZATION_VERSION`` stamps every file; a newer file fails at the
  version gate with a clear error.
* Tensors load onto ``config.device(device)``: the card unless the caller
  asks for the CPU.  They load detached (no autograd history is saved).

Mesh-bound (sharded) state waits for the port's ``parallel`` package.
"""

from __future__ import annotations

import io
import pickle
import zlib
from typing import Any

import numpy as np
import torch

from .. import config

# Highest version this reader understands.  Version history:
#   1 -- the port's first format.
SERIALIZATION_VERSION = 1
MAGIC = b"ALBTORCH"
JAX_MAGIC = b"ALBTPU01"  # the JAX package's checkpoints

_PORT = "albatross_tpu_torch"
# (module, name) of every non-port global a checkpoint may reference
_ALLOWED_NAMES = frozenset(
    [("builtins", n) for n in ("set", "frozenset", "slice", "complex", "range", "bytearray", "bytes",
                               "list", "dict", "tuple", "int", "float", "str", "bool")]
    + [("collections", n) for n in ("OrderedDict", "defaultdict", "deque", "Counter")]
    + [("functools", "partial")]
    + [(m, n) for m in ("numpy", "numpy.core.multiarray", "numpy._core.multiarray")
       for n in ("dtype", "ndarray", "scalar", "_reconstruct")]
    + [("torch", n) for n in ("device", "Size", "float16", "bfloat16", "float32", "float64", "complex64",
                              "complex128", "uint8", "int8", "int16", "int32", "int64", "bool")]
)

# (old_module, old_name) -> (new_module, new_name); extend whenever a class
# that checkpoints hold moves between releases.
CLASS_RENAMES: dict = {}


class _ArrayPickler(pickle.Pickler):
    """Pickles the object graph with tensors and numpy arrays replaced by
    ("tensor" | "ndarray", index) ids into ``arrays``; an object seen twice
    gets one entry."""

    def __init__(self, file):
        super().__init__(file, protocol=pickle.HIGHEST_PROTOCOL)
        self.arrays: list = []
        self._index: dict = {}
        self._seen: list = []  # keeps each id()'s object alive while pickling

    def persistent_id(self, obj):
        if isinstance(obj, torch.Tensor):
            kind = "tensor"
        elif isinstance(obj, np.ndarray) and not obj.dtype.hasobject:
            kind = "ndarray"
        else:
            return None
        if id(obj) not in self._index:
            self._index[id(obj)] = len(self.arrays)
            self.arrays.append(obj.detach().cpu().numpy() if kind == "tensor" else obj)
            self._seen.append(obj)
        return kind, self._index[id(obj)]


class _RestrictedUnpickler(pickle.Unpickler):
    def __init__(self, file, arrays=None, device=None):
        super().__init__(file)
        self._arrays = arrays
        self._device = device
        self._loaded: dict = {}

    def find_class(self, module, name):
        module, name = CLASS_RENAMES.get((module, name), (module, name))
        if (module, name) in _ALLOWED_NAMES:
            return super().find_class(module, name)
        if module.split(".")[0] == _PORT:
            found = super().find_class(module, name)
            if isinstance(found, type) and found.__module__.split(".")[0] == _PORT:
                return found
        raise pickle.UnpicklingError(
            f"checkpoint references disallowed name {module}.{name}; only albatross_tpu_torch's classes "
            "and an explicit list of builtin, collections, functools, numpy and torch types may load"
        )

    def persistent_load(self, pid):
        kind, index = pid
        if kind not in ("tensor", "ndarray") or self._arrays is None:
            raise pickle.UnpicklingError(f"unknown persistent id {pid!r}")
        if pid not in self._loaded:
            array = self._arrays[f"arr_{index}"]
            if kind == "tensor":
                array = torch.from_numpy(array).to(config.device(self._device))
            self._loaded[pid] = array
        return self._loaded[pid]


def save_checkpoint(path: str, obj: Any) -> None:
    """Write any model, fit, chain or other object of the port to ``path``."""
    graph = io.BytesIO()
    pickler = _ArrayPickler(graph)
    pickler.dump(obj)
    arrays = io.BytesIO()
    np.savez(arrays, *pickler.arrays)
    payload = {
        "version": SERIALIZATION_VERSION,
        "objects": graph.getvalue(),
        "arrays": zlib.compress(arrays.getvalue(), level=3),
    }
    with open(path, "wb") as f:
        f.write(MAGIC)
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)


def load_checkpoint(path: str, device=None) -> Any:
    """Restore a checkpoint, its tensors on ``config.device(device)``."""
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic == JAX_MAGIC:
            raise ValueError(f"{path} is a checkpoint of the JAX package albatross_tpu, not of "
                             "albatross_tpu_torch: load it with albatross_tpu.serialize")
        if magic != MAGIC:
            raise ValueError(f"{path} is not an albatross_tpu_torch checkpoint")
        payload = _RestrictedUnpickler(io.BytesIO(f.read())).load()
    if payload["version"] > SERIALIZATION_VERSION:
        raise ValueError(f"checkpoint version {payload['version']} is newer than supported "
                         f"{SERIALIZATION_VERSION}")
    arrays = np.load(io.BytesIO(zlib.decompress(payload["arrays"])), allow_pickle=False)
    return _RestrictedUnpickler(io.BytesIO(payload["objects"]), arrays, device).load()
