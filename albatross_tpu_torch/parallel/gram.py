"""Mesh-sharded gram assembly, 1-D row layout.

Counterpart of ``albatross_tpu.parallel.gram``'s ``sharded_gram`` and
``sharded_cross_gram``: rank d builds its row panel

    K[d b:(d + 1) b, :] = k(X_local, X_full),    b = N / ranks,

with the covariance DSL on two distinct feature batches, so the (N, N)
gram never exists on one rank.  A Euclidean radial term launches the gram
kernel (``radial_gram``) on each panel.  Because X_local and X_full are
distinct batches, the noise terms compare features by value, as the JAX
package's ``shard_map`` does: under ``assume_unique=True`` a duplicated
input puts sigma^2 off the diagonal of the sharded gram, where the
single-process gram's identity shortcut does not (the noise kernels'
contract).  The result is a row-sharded ``DTensor``.

The kernel's parameters and X_full are replicated values used in this
rank's rows, so they enter through ``vary``: a gradient with respect to
them sums every rank's rows.

Symmetry: entries (i, j) and (j, i) come from two cross-form launches.
Below D = 8, in f64 and on the CPU they are exact elementwise sums and
equal; in the gram kernel's f32 tensor-core branch (D >= 8) the
contraction is not transpose-exact, so they agree only to its rounding
(the JAX package's Pallas cross form at D >= 9 is alike).  The distributed factorizations read the lower block
triangle and factor each diagonal block as the single process does.

``sharded_gram_2d`` is the 2-D tile layout's gram (``_gram_tile`` of the
JAX package): rank (i, j) of an (R, C) mesh builds only its (N/R, N/C)
tile k(X_rows, X_cols), the kernel's cross form on two distinct batches
(one gram-kernel launch a tile for a Euclidean radial term; the noise
terms compare by value, as above), with the target variance added where
the global diagonal crosses the tile.  Its parameters vary over both
axes.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from ..core.dataset import feature_count, first_leaf, subset_features
from ..kernels.features import Measurement
from ._comm import Axis, _alone, mesh_axis, vary
from .mesh import row_sharded


def _rows(X, r0: int, b: int):
    if isinstance(X, torch.Tensor):
        return X[r0:r0 + b]
    return subset_features(X, torch.arange(r0, r0 + b))


def _varied(kernel, ax, device):
    """``kernel`` with each parameter that requires grad moved to
    ``device`` and marked by ``vary`` over ``ax`` (one axis or several; on
    the device, so the backward collectives of one pass run on one
    autograd thread)."""
    if _alone(ax):
        return kernel
    values = {name: vary(p.value.to(device), ax) for name, p in kernel.get_params().items()
              if isinstance(p.value, torch.Tensor) and p.value.requires_grad}
    return kernel.set_param_values(values) if values else kernel


def _local_gram_rows(kernel, X, ax: Axis, measurement: bool = False,
                    target_variance: Optional[torch.Tensor] = None) -> torch.Tensor:
    """This rank's (b, N) row panel of the gram of X (every rank holds X
    whole), with ``target_variance`` on its diagonal."""
    n = feature_count(X)
    if n % ax.size != 0:
        raise ValueError(f"N={n} not divisible by mesh axis size {ax.size}")
    b = n // ax.size
    r0 = ax.rank * b
    k = _varied(kernel, ax, first_leaf(X).device)
    if isinstance(X, torch.Tensor) and X.requires_grad:
        X = vary(X, ax)
    Xl, Xf = _rows(X, r0, b), X
    if measurement:
        Xl, Xf = Measurement(Xl), Measurement(Xf)
    panel = k.matrix_or_none(Xl, Xf)
    if panel is None:
        raise TypeError("covariance undefined for these features")
    if target_variance is not None:
        v = vary(target_variance, ax)[r0:r0 + b].to(panel.dtype)
        i = torch.arange(b, device=panel.device)
        panel = panel.index_put((i, i + r0), v, accumulate=True)
    return panel


def sharded_gram(
    kernel,
    X,
    mesh,
    axis: str = "data",
    measurement: bool = False,
    target_variance: Optional[torch.Tensor] = None,
) -> DTensor:
    """Row-sharded (N, N) gram of a feature batch that every rank holds.

    N must divide the mesh axis size.  ``measurement=True`` applies the
    Measurement tag to both sides (training covariance semantics);
    ``target_variance`` (N,) is added to the diagonal."""
    ax = mesh_axis(mesh, axis)
    panel = _local_gram_rows(kernel, X, ax, measurement, target_variance)
    n = panel.shape[1]
    return DTensor.from_local(panel, mesh, row_sharded(mesh, axis), run_check=False,
                              shape=torch.Size((n, n)), stride=(n, 1))


def sharded_cross_gram(kernel, X_train, X_test, mesh, axis: str = "data") -> DTensor:
    """(N_train, M) cross covariance, row-sharded over the train axis."""
    ax = mesh_axis(mesh, axis)
    n = feature_count(X_train)
    if n % ax.size != 0:
        raise ValueError(f"N={n} not divisible by mesh axis size {ax.size}")
    b = n // ax.size
    panel = _varied(kernel, ax, first_leaf(X_train).device).matrix_or_none(
        _rows(X_train, ax.rank * b, b), X_test)
    if panel is None:
        raise TypeError("covariance undefined for these features")
    return DTensor.from_local(panel, mesh, row_sharded(mesh, axis), run_check=False,
                              shape=torch.Size((n, panel.shape[1])), stride=(panel.shape[1], 1))


def _tile_placements(mesh, row_axis: str, col_axis: str) -> tuple:
    """DTensor placements of a matrix tiled over (row_axis, col_axis)."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names or ()
    for axis in (row_axis, col_axis):
        if axis not in names:
            raise ValueError(f"mesh has no axis {axis!r}; its axes are {names}")
    return tuple(Shard(0) if name == row_axis else Shard(1) if name == col_axis else Replicate()
                 for name in names)


def as_tiles(local: torch.Tensor, mesh, row_axis: str, col_axis: str) -> DTensor:
    """A DTensor of this rank's (N/R, N/C) tile of an (N, N) matrix."""
    n = local.shape[0] * mesh_axis(mesh, row_axis).size
    return DTensor.from_local(local, mesh, _tile_placements(mesh, row_axis, col_axis), run_check=False,
                              shape=torch.Size((n, n)), stride=(n, 1))


def tile_shape(n: int, rax: Axis, cax: Axis):
    """(br, bc) of an (n, n) matrix tiled over the two axes, with the JAX
    package's error when n does not divide."""
    if n % rax.size != 0 or n % cax.size != 0:
        raise ValueError(f"N={n} not divisible by mesh axes ({rax.size}, {cax.size})")
    return n // rax.size, n // cax.size


def _local_gram_tile(kernel, X, rax: Axis, cax: Axis, measurement: bool = False,
                     target_variance: Optional[torch.Tensor] = None) -> torch.Tensor:
    """This rank's (br, bc) tile of the gram of X (every rank holds X
    whole), with ``target_variance`` where the global diagonal crosses it."""
    n = feature_count(X)
    br, bc = tile_shape(n, rax, cax)
    r0, c0 = rax.rank * br, cax.rank * bc
    both = (rax, cax)
    k = _varied(kernel, both, first_leaf(X).device)
    if isinstance(X, torch.Tensor) and X.requires_grad:
        X = vary(X, both)
    Xr, Xc = _rows(X, r0, br), _rows(X, c0, bc)
    if measurement:
        Xr, Xc = Measurement(Xr), Measurement(Xc)
    tile = k.matrix_or_none(Xr, Xc)
    if tile is None:
        raise TypeError("covariance undefined for these features")
    if target_variance is not None:
        lo = max(r0, c0)
        g = torch.arange(lo, max(lo, min(r0 + br, c0 + bc)), device=tile.device)  # global diagonal here
        v = vary(target_variance.to(device=tile.device, dtype=tile.dtype), both)[g]
        tile = tile.index_put((g - r0, g - c0), v, accumulate=True)
    return tile


def sharded_gram_2d(
    kernel,
    X,
    mesh,
    row_axis: str = "data",
    col_axis: str = "model",
    measurement: bool = False,
    target_variance: Optional[torch.Tensor] = None,
) -> DTensor:
    """(N, N) gram of a feature batch that every rank holds, tiled over a
    2-D mesh: rank (i, j) computes and owns only its (N/R, N/C) tile, so a
    rank's gram memory is N^2/(R C).  N must divide both axis sizes;
    ``measurement`` and ``target_variance`` as for ``sharded_gram``."""
    rax, cax = mesh_axis(mesh, row_axis), mesh_axis(mesh, col_axis)
    tile = _local_gram_tile(kernel, X, rax, cax, measurement, target_variance)
    return as_tiles(tile, mesh, row_axis, col_axis)
