"""Port parity: albatross_tpu_torch.ops.panel_cholinv vs the Pallas panel kernel.

``pallas_panel_cholinv(interpret=True)`` (the JAX package's ``_panel_kernel``,
run as tests/test_pallas_chol.py runs it) and the port's ``panel_cholinv``
(on CPU tensors: torch.linalg.cholesky + blocked_tri_inverse) factor the
same f32 panels.  Bounds are the JAX test's: 1e-5 on U and 1e-4 on Wu,
relative to the max entry, against each other and against f64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from albatross_tpu.ops.pallas_chol import pallas_panel_cholinv
from albatross_tpu_torch import _build
from albatross_tpu_torch.ops.panel_cholinv import panel_cholinv

torch.set_num_threads(2)


def _spd(rng, b):
    A = rng.standard_normal((b, b))
    return (A @ A.T + b * np.eye(b)).astype(np.float32)


def _rel(a, b):
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


@pytest.mark.parametrize("b", [128, 256])
def test_panel_matches_pallas(b):
    K = _spd(np.random.default_rng(b), b)
    U_ref, Wu_ref = (np.asarray(t) for t in pallas_panel_cholinv(jnp.asarray(K), interpret=True))
    U, Wu = panel_cholinv(torch.as_tensor(K))
    assert U.dtype == Wu.dtype == torch.float32
    U, Wu = U.numpy(), Wu.numpy()
    assert _rel(U, U_ref) < 1e-5
    assert _rel(Wu, Wu_ref) < 1e-4
    L64 = np.linalg.cholesky(K.astype(np.float64))
    assert _rel(U.T, L64) < 1e-5
    assert _rel(Wu.T, np.linalg.inv(L64)) < 1e-4
    np.testing.assert_array_equal(np.tril(U, -1), 0.0)
    np.testing.assert_array_equal(np.tril(Wu, -1), 0.0)


@pytest.mark.parametrize("b", [100, 1152])
def test_panel_shape_guards(b):
    """The JAX kernel's guard and message, on every device."""
    with pytest.raises(ValueError, match="b % 128"):
        pallas_panel_cholinv(jnp.eye(b, dtype=jnp.float32), interpret=True)
    with pytest.raises(ValueError, match="b % 128"):
        panel_cholinv(torch.eye(b))


def test_panel_rejects_non_square_and_surfaces_nan():
    with pytest.raises(ValueError, match="square"):
        panel_cholinv(torch.zeros((128, 256)))
    A = torch.eye(128)
    A[7, 7] = -1.0
    U, Wu = panel_cholinv(A)
    assert torch.isnan(U).any() and torch.isnan(Wu).any()
    assert _build.LAUNCHES["panel_cholinv"] == 0  # CPU tensors never launch
