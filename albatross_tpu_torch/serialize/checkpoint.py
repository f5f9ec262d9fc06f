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
* A distributed fit is saved by its mesh's signature, the dimension names
  and shape, never by a process group: each ``DeviceMesh`` becomes a
  ("mesh", names, shape) id and each ``DTensor`` (row-sharded, tiled or
  replicated) its whole value (gathered over the mesh, so every rank of the
  mesh calls ``save_checkpoint``; each
  writes the file whole and renames it into place) with its placements.
  ``load_checkpoint(path, mesh=...)`` rebinds them to the given mesh, or,
  without one, to a mesh of the same names and shape over the current
  world; a missing or mismatched mesh raises, with the JAX package's
  messages.  A checkpoint with a mesh is version 2, one without stays 1.
"""

from __future__ import annotations

import io
import os
import pickle
import zlib
from typing import Any

import numpy as np
import torch

from .. import config

# Highest version this reader understands.  Version history:
#   1 -- the port's first format;
#   2 -- the object graph may hold mesh and DTensor ids (distributed fits).
# Writers stamp the smallest version the payload needs.
SERIALIZATION_VERSION = 2
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
        self.used_mesh = False

    def persistent_id(self, obj):
        from torch.distributed.device_mesh import DeviceMesh
        from torch.distributed.tensor import DTensor

        if isinstance(obj, DeviceMesh):
            self.used_mesh = True
            return _mesh_id(obj)
        if isinstance(obj, DTensor):
            self.used_mesh = True
            if id(obj) not in self._index:
                self._index[id(obj)] = len(self.arrays)
                self.arrays.append(_whole(obj).detach().cpu().numpy())
                self._seen.append(obj)
            placements = tuple("S0" if p.is_shard(0) else "S1" if p.is_shard(1) else "R" for p in obj.placements)
            return "dtensor", self._index[id(obj)], placements, _mesh_id(obj.device_mesh)
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


def _mesh_id(mesh) -> tuple:
    return "mesh", tuple(mesh.mesh_dim_names or ()), tuple(mesh.shape)


def _whole(t):
    """A DTensor's whole value on every rank of its mesh: its rows (and,
    tiled, its columns) gathered over the mesh dimensions it is sharded
    on."""
    from ..parallel._comm import gather_cols, gather_rows, mesh_axis

    local = t.to_local()
    names = t.device_mesh.mesh_dim_names
    for name, p in zip(names, t.placements):
        with torch.no_grad():
            if p.is_shard(0):
                local = gather_rows(local, mesh_axis(t.device_mesh, name), local.shape[0])
            elif p.is_shard(1):
                local = gather_cols(local, mesh_axis(t.device_mesh, name))
            elif not p.is_replicate():
                raise ValueError(f"checkpoints hold row-sharded, tiled or replicated DTensors, not {t.placements}")
    return local


class _RestrictedUnpickler(pickle.Unpickler):
    def __init__(self, file, arrays=None, device=None, mesh=None):
        super().__init__(file)
        self._arrays = arrays
        self._device = device
        self._mesh = mesh
        self._meshes: dict = {}
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

    def _bind_mesh(self, pid):
        """The mesh a ("mesh", names, shape) id rebinds to."""
        _, names, shape = pid
        if pid in self._meshes:
            return self._meshes[pid]
        mesh = self._mesh
        if mesh is not None:
            if tuple(mesh.mesh_dim_names or ()) != tuple(names):
                raise ValueError(f"checkpoint mesh axes {tuple(names)} do not match the provided mesh axes "
                                 f"{tuple(mesh.mesh_dim_names or ())}")
            if tuple(mesh.shape) != tuple(shape):
                raise ValueError(f"checkpoint mesh grid {tuple(shape)} does not match the provided mesh grid "
                                 f"{tuple(mesh.shape)}")
        else:
            import torch.distributed as dist

            from ..parallel.mesh import make_mesh

            need = int(np.prod(shape))
            world = dist.get_world_size() if dist.is_initialized() else 1
            if world != need:
                seen = f"only {world} are visible" if world < need else \
                    f"this process's world has {world} and a mesh spans the whole world"
                raise ValueError(f"checkpoint was saved on a {tuple(shape)} device mesh ({need} devices) but "
                                 f"{seen}; pass load_checkpoint(..., mesh=...) to rebind explicitly")
            mesh = make_mesh(None, names, shape, device=self._device)
        self._meshes[pid] = mesh
        return mesh

    def persistent_load(self, pid):
        if pid[0] == "mesh" and len(pid) == 3:
            return self._bind_mesh(pid)
        if pid[0] == "dtensor" and len(pid) == 4 and self._arrays is not None:
            if pid not in self._loaded:
                self._loaded[pid] = self._load_dtensor(*pid[1:])
            return self._loaded[pid]
        kind, index = pid
        if kind not in ("tensor", "ndarray") or self._arrays is None:
            raise pickle.UnpicklingError(f"unknown persistent id {pid!r}")
        if pid not in self._loaded:
            array = self._arrays[f"arr_{index}"]
            if kind == "tensor":
                array = torch.from_numpy(array).to(config.device(self._device))
            self._loaded[pid] = array
        return self._loaded[pid]


    def _load_dtensor(self, index, placements, mesh_pid):
        from torch.distributed.tensor import DTensor, Replicate, Shard

        from ..parallel._comm import mesh_axis

        mesh = self._bind_mesh(mesh_pid)
        whole = torch.from_numpy(self._arrays[f"arr_{index}"]).to(config.device(self._device))
        local = whole
        for name, p in zip(mesh.mesh_dim_names, placements):
            if p in ("S0", "S1"):
                ax, dim = mesh_axis(mesh, name), int(p[1])
                b = whole.shape[dim] // ax.size
                local = local.narrow(dim, ax.rank * b, b)
        local = local.contiguous()
        kinds = [Shard(int(p[1])) if p in ("S0", "S1") else Replicate() for p in placements]
        return DTensor.from_local(local, mesh, kinds, run_check=False, shape=whole.shape, stride=whole.stride())


def save_checkpoint(path: str, obj: Any) -> None:
    """Write any model, fit, chain or other object of the port to ``path``.
    An object holding DTensors is saved by every rank of their mesh, each
    writing ``path`` whole (a temporary file renamed into place)."""
    graph = io.BytesIO()
    pickler = _ArrayPickler(graph)
    pickler.dump(obj)
    arrays = io.BytesIO()
    np.savez(arrays, *pickler.arrays)
    payload = {
        "version": 2 if pickler.used_mesh else 1,
        "objects": graph.getvalue(),
        "arrays": zlib.compress(arrays.getvalue(), level=3),
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def load_checkpoint(path: str, device=None, mesh=None) -> Any:
    """Restore a checkpoint, its tensors on ``config.device(device)``.
    ``mesh``: the ``DeviceMesh`` to rebind distributed state onto; by
    default a mesh of the saved names and shape over the current world."""
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
    return _RestrictedUnpickler(io.BytesIO(payload["objects"]), arrays, device, mesh).load()
