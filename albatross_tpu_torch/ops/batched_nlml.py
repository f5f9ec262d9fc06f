"""The NLML's two terms for a stack of training covariances, forward only.

The ensemble sampler's counterpart of ``jax.vmap`` over
``CholeskyFactor.nlml_terms`` (``albatross_tpu/samplers/ensemble.py``
evaluates each half of the ensemble as one vmapped batch): for a (W, n, n)
stack K and (W, n) right-hand sides r, ``batched_nlml_terms`` returns
(log|K_w|, L_w^-1 r_w) for every w, by the route ``nlml_terms`` takes for
one matrix:

* n <= 2048: the batched library Cholesky (``cholesky``, a non-PD matrix
  gives a NaN factor) and a batched triangular solve;
* above: the right-looking column-panel loop of ``_cols_core``
  (ops/blocked_cholesky.py), which takes the stack's leading dimension:
  each diagonal panel stack goes through the batched panel kernel
  (``panel_cholinv_batched``: one launch for the stack, its panels' tile
  steps, row solves and products taken from one queue by every SM, 0.67
  ms for 16 panels of 1024 on an H100 at 700 W against 0.88 ms for the
  launch-per-step form it replaced) for CUDA f32, its plain version on the CPU
  and for f64; the panel solve and the trailing updates are batched
  products (``torch.matmul``, ``baddbmm_``), as the JAX package leaves them
  to XLA.  The block size is ``default_block_size``.  When it divides n
  the column panels are views of K, factored in place; otherwise
  ``padded_column_panels`` pads copies of them with zero rows and an
  identity block, as ``blocked_cholesky_cols_fused`` does.

Every step works slice by slice, so one walker's non-PD covariance makes
that walker's terms non-finite and leaves the others as they are.  No
gradient is taken (the sampler needs none).

``walkers_per_batch`` bounds how many covariances one batch may hold on
the card: the caller splits a larger ensemble into batches of that size.
"""

from __future__ import annotations

import torch

from .blocked_cholesky import (
    DEFAULT_PANEL_SUB,
    _cols_core,
    cholesky,
    default_block_size,
    padded_column_panels,
)
from .compensated import accurate_sum_of_logs
from .linalg import _BLOCKED_MIN_N

# share of the card's available memory one batch may take
MEMORY_SHARE = 0.9


def bytes_per_walker(n: int, itemsize: int, device: torch.device) -> int:
    """Device bytes one walker's covariance takes through
    ``batched_nlml_terms``: n <= 2048 holds K, its factor and the NaN
    select of ``cholesky``; above, K (factored in place), the padded panel
    copies when the block size does not divide n, the panel product
    ``below`` and the diagonal panel's copies."""
    if n <= _BLOCKED_MIN_N:
        return 4 * n * n * itemsize
    b = default_block_size(n, device)
    m = -(-n // b) * b
    padded = 0 if m == n else m * (m + b) // 2
    return (n * n + padded + 2 * m * b + 4 * b * b) * itemsize


def available_bytes(device: torch.device) -> int:
    """The card's free memory plus what PyTorch's allocator holds unused."""
    free, _ = torch.cuda.mem_get_info(device)
    return free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)


def walkers_per_batch(w: int, n: int, itemsize: int, device: torch.device, available=None) -> int:
    """How many of w covariances of size n one batch holds: all of them on
    the CPU; on the card as many as ``MEMORY_SHARE`` of its available
    memory takes (``available`` overrides the reading).  Raises when not
    even one fits."""
    device = torch.device(device)
    if device.type != "cuda" and available is None:
        return w
    if available is None:
        available = available_bytes(device)
    per = bytes_per_walker(n, itemsize, device)
    fits = int(MEMORY_SHARE * available) // per
    if fits < 1:
        raise MemoryError(
            f"batched log-likelihood of {w} walkers at n = {n}: one walker's covariance takes "
            f"{per / 2**30:.2f} GiB and {available / 2**30:.2f} GiB are available on {device}"
        )
    return min(w, fits)


@torch.no_grad()
def batched_nlml_terms(K: torch.Tensor, rhs: torch.Tensor, jitter: float = 0.0):
    """(log|K_w| (W,), L_w^-1 rhs_w (W, n)) for a (W, n, n) stack of
    symmetric matrices, jitter added to each diagonal (in place: the stack
    is the caller's scratch and is overwritten)."""
    if K.ndim != 3 or K.shape[1] != K.shape[2] or rhs.shape != K.shape[:2]:
        raise ValueError(f"batched_nlml_terms needs a (W, n, n) stack and (W, n) right-hand sides, "
                         f"got {tuple(K.shape)} and {tuple(rhs.shape)}")
    rhs = rhs.to(K.dtype)
    if jitter:
        K.diagonal(dim1=-2, dim2=-1).add_(jitter)
    n = K.shape[-1]
    if n <= _BLOCKED_MIN_N:
        L = cholesky(K)
        white = torch.linalg.solve_triangular(L, rhs[..., None], upper=False)[..., 0]
        return 2.0 * accurate_sum_of_logs(torch.diagonal(L, dim1=-2, dim2=-1), dim=-1), white
    b = default_block_size(n, K.device, K.dtype)
    cols = padded_column_panels(lambda k0, bk: K[:, k0:, k0:k0 + bk], n, b)
    m = len(cols) * b
    diag, white = _cols_core(cols, m, b, torch.nn.functional.pad(rhs, (0, m - n)),
                             panel_sub=DEFAULT_PANEL_SUB, assemble=False)
    return 2.0 * accurate_sum_of_logs(diag[:, :n], dim=-1), white[:, :n]
