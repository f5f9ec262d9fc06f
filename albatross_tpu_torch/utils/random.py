"""Random sampling utilities.

Counterpart of ``albatross_tpu.utils.random`` (the reference's
``random_utils.hpp``): index sampling on the host with a numpy generator,
as the JAX package does; matrix and MVN draws from a ``torch.Generator``
(an int seeds one), whose numbers differ from JAX's keys, so each also
takes its normals (or uniforms) from the caller.
"""

from __future__ import annotations

import torch

from ..core.distributions import JointDistribution


def as_generator(key) -> torch.Generator:
    """``key`` as a CPU ``torch.Generator``: an int seeds a new one."""
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator(device="cpu").manual_seed(int(key))


def random_without_replacement(values, k: int, rng) -> list:
    """k of ``values`` without replacement, in their original order."""
    idx = rng.choice(len(values), size=k, replace=False)
    return [values[int(i)] for i in sorted(idx)]


def random_covariance_matrix(key, n: int, dtype=None, normals=None, eigenvalues=None) -> torch.Tensor:
    """SPD matrix Q diag(e) Q^T: Q from the QR of an (n, n) standard normal
    matrix, e ~ U(0.1, 1).  ``normals`` and ``eigenvalues`` replace the
    draws."""
    dtype = dtype or torch.float32
    generator = None if normals is not None and eigenvalues is not None else as_generator(key)
    A = torch.randn((n, n), generator=generator, dtype=dtype) if normals is None else torch.as_tensor(
        normals, dtype=dtype)
    Q, _ = torch.linalg.qr(A)
    if eigenvalues is None:
        eigenvalues = 0.1 + 0.9 * torch.rand(n, generator=generator, dtype=dtype)
    eigs = torch.as_tensor(eigenvalues, dtype=dtype, device=Q.device)
    return (Q * eigs[None, :]) @ Q.T


def sample_mvn(key, distribution: JointDistribution, num_samples: int = 1, normals=None) -> torch.Tensor:
    """Draws mean + L v through the Cholesky factor L of the covariance:
    (n,) for one sample, else (num_samples, n).  ``normals`` (n,
    num_samples) replaces the draw of v."""
    from ..ops.linalg import CholeskyFactor  # ops imports utils.profiling: no import cycle

    chol = CholeskyFactor.factorize(distribution.covariance)
    mean = distribution.mean
    if normals is None:
        normals = torch.randn((distribution.size, num_samples), generator=as_generator(key), dtype=mean.dtype)
    samples = mean[:, None] + chol.L @ torch.as_tensor(normals, dtype=mean.dtype).to(mean.device)
    return samples[:, 0] if num_samples == 1 else samples.T
