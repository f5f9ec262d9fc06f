"""Numerical diagnostics for ill-conditioned covariances.

Counterpart of ``albatross_tpu.ops.diagnostics``: the dominant entries of
the smallest or largest eigenvectors, so a user can see which features
drive near-singularity.  The text is the JAX package's, character for
character; the eigendecomposition (``torch.linalg.eigh``) runs on the
matrix's device and only its result is read back.
"""

from __future__ import annotations

import io

import numpy as np
import torch


def _eigen_directions(matrix: torch.Tensor, smallest: bool, k: int, top_entries: int) -> str:
    vals, vecs = torch.linalg.eigh(0.5 * (matrix + matrix.T))
    vals = vals.cpu().numpy()
    vecs = vecs.cpu().numpy()
    order = np.argsort(vals)
    picks = order[:k] if smallest else order[::-1][:k]
    out = io.StringIO()
    kind = "smallest" if smallest else "largest"
    for rank, idx in enumerate(picks):
        vec = vecs[:, idx]
        dominant = np.argsort(np.abs(vec))[::-1][:top_entries]
        out.write(f"{kind} eigenvalue #{rank}: {vals[idx]:.6e}\n")
        for j in dominant:
            out.write(f"    index {j}: {vec[j]:+.4f}\n")
    return out.getvalue()


def print_small_eigen_directions(matrix, k: int = 3, top_entries: int = 5, stream=None) -> str:
    """The ``k`` smallest eigenvalues of sym(matrix), each with the
    ``top_entries`` largest entries of its eigenvector; written to
    ``stream`` when one is given, and returned."""
    text = _eigen_directions(torch.as_tensor(matrix), True, k, top_entries)
    if stream is not None:
        stream.write(text)
    return text


def print_large_eigen_directions(matrix, k: int = 3, top_entries: int = 5, stream=None) -> str:
    """As ``print_small_eigen_directions``, for the ``k`` largest."""
    text = _eigen_directions(torch.as_tensor(matrix), False, k, top_entries)
    if stream is not None:
        stream.write(text)
    return text
