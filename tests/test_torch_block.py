"""Port parity of the block solvers (``ops/block.py``).

The same numpy blocks go through the JAX package's and the port's
BlockDiagonal, BlockDiagonalCholesky, DiagonalCholesky and BlockSymmetric
at f64 on the CPU.  Both factor with the library Cholesky and solve with
triangular solves, so results agree to 1e-9 relative to the largest entry
(f64 rounding of blocks whose condition is below 1e2).  Ragged sizes
exercise the identity padding; ``l1_norm`` and ``rcond`` are held against
the JAX package's and the exact values of the dense matrix.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import albatross_tpu.ops.block as jblock
import albatross_tpu_torch.ops.block as tblock
from albatross_tpu.indexing import Grouped as JGrouped
from albatross_tpu.ops.linalg import CholeskyFactor as JCholeskyFactor
from albatross_tpu_torch.indexing import Grouped
from albatross_tpu_torch.ops.linalg import CholeskyFactor

torch.set_num_threads(2)
RTOL = 1e-9
SIZES = {"ragged": (3, 5, 2, 7, 1), "uniform": (4, 4, 4), "single": (6,)}


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.max(np.abs(a - b)) <= rtol * max(np.max(np.abs(b)), 1e-300)


def _spd_blocks(sizes, seed):
    rng = np.random.default_rng(seed)
    blocks = []
    for n in sizes:
        M = rng.standard_normal((n, n))
        blocks.append(M @ M.T + (1.0 + n) * np.eye(n))
    return blocks


def _both(sizes, seed=0):
    blocks = _spd_blocks(sizes, seed)
    return (jblock.BlockDiagonal.from_blocks([jnp.asarray(b) for b in blocks]),
            tblock.BlockDiagonal.from_blocks([torch.as_tensor(b) for b in blocks]), blocks)


def test_pad_blocks_identity_padding():
    blocks = [torch.full((k, k), float(k), dtype=torch.float64) for k in (2, 4, 1)]
    stacked, sizes = tblock.pad_blocks(blocks)
    assert sizes == [2, 4, 1] and stacked.shape == (3, 4, 4)
    assert torch.equal(stacked[0, 2:, 2:], torch.eye(2, dtype=torch.float64))
    assert torch.equal(stacked[0, :2, 2:], torch.zeros(2, 2, dtype=torch.float64))
    assert torch.equal(stacked[2, 1:, 1:], torch.eye(3, dtype=torch.float64))


@pytest.mark.parametrize("kind", sorted(SIZES))
def test_block_diagonal_matches_jax(kind):
    jb, tb, blocks = _both(SIZES[kind], seed=len(kind))
    n = sum(SIZES[kind])
    assert tb.rows == n and tb.num_blocks == len(SIZES[kind])
    _close(tb.to_dense(), jb.to_dense(), rtol=0)
    _close(tb.diagonal(), jb.diagonal(), rtol=0)
    rng = np.random.default_rng(1)
    for rhs in (rng.standard_normal(n), rng.standard_normal((n, 3))):
        _close(tb @ torch.as_tensor(rhs), jb @ jnp.asarray(rhs))
        _close(tb.matmul(torch.as_tensor(rhs)), np.asarray(tb.to_dense()) @ rhs)


@pytest.mark.parametrize("kind", sorted(SIZES))
def test_block_diagonal_cholesky_matches_jax(kind):
    jb, tb, blocks = _both(SIZES[kind], seed=7 + len(kind))
    jc, tc = jb.factorize(), tb.factorize()
    _close(tc.L, jc.L)
    assert tc.rows == jc.rows
    n = sum(SIZES[kind])
    rng = np.random.default_rng(2)
    dense = np.asarray(tb.to_dense())
    for rhs in (rng.standard_normal(n), rng.standard_normal((n, 4))):
        t, j = torch.as_tensor(rhs), jnp.asarray(rhs)
        _close(tc.sqrt_solve(t), jc.sqrt_solve(j))
        _close(tc.sqrt_transpose_solve(t), jc.sqrt_transpose_solve(j))
        _close(tc.solve(t), jc.solve(j))
        _close(tc.solve(t), np.linalg.solve(dense, rhs))
    assert float(tc.log_determinant()) == pytest.approx(float(jc.log_determinant()), rel=RTOL)
    assert float(tc.log_determinant()) == pytest.approx(np.linalg.slogdet(dense)[1], rel=RTOL)


@pytest.mark.parametrize("kind", sorted(SIZES))
def test_block_diagonal_l1_norm_and_rcond(kind):
    """l1_norm leaves the identity padding out; rcond follows Hager's
    estimator exactly as the JAX package does, and stays within the
    estimator's slack of the exact reciprocal condition number."""
    jb, tb, _ = _both(SIZES[kind], seed=11 + len(kind))
    jc, tc = jb.factorize(), tb.factorize()
    dense = np.asarray(tb.to_dense())
    exact_l1 = np.abs(dense).sum(axis=0).max()
    assert tc.l1_norm() == pytest.approx(jc.l1_norm(), rel=RTOL)
    assert tc.l1_norm() == pytest.approx(exact_l1, rel=1e-12)
    est = tc.rcond()
    assert est == pytest.approx(jc.rcond(), rel=RTOL)
    exact = 1.0 / (exact_l1 * np.abs(np.linalg.inv(dense)).sum(axis=0).max())
    assert 0.0 < est <= 1.0
    np.testing.assert_allclose(est, exact, rtol=0.25)


def test_block_diagonal_cholesky_nan_on_an_indefinite_block():
    """A block that is not positive definite factors to NaN (the JAX
    package's Cholesky semantics) instead of raising; the others stay
    finite."""
    blocks = _spd_blocks((3, 4), seed=3)
    blocks[1][2, 2] = -5.0
    chol = tblock.BlockDiagonal.from_blocks([torch.as_tensor(b) for b in blocks]).factorize()
    assert torch.isnan(chol.L[1]).all() and torch.isfinite(chol.L[0]).all()


@pytest.mark.parametrize("n", [1, 9])
def test_diagonal_cholesky_matches_jax(n):
    rng = np.random.default_rng(n)
    d = rng.uniform(0.5, 3.0, n)
    jd, td = jblock.DiagonalCholesky(jnp.asarray(d)), tblock.DiagonalCholesky(torch.as_tensor(d))
    assert td.rows == n
    for rhs in (rng.standard_normal(n), rng.standard_normal((n, 2))):
        t, j = torch.as_tensor(rhs), jnp.asarray(rhs)
        for name in ("sqrt_solve", "sqrt_transpose_solve", "solve"):
            _close(getattr(td, name)(t), getattr(jd, name)(j))
    assert float(td.log_determinant()) == pytest.approx(float(jd.log_determinant()), rel=RTOL)


@pytest.mark.parametrize("from_C", [False, True])
@pytest.mark.parametrize("n_a, n_c", [(7, 4), (30, 1)])
def test_block_symmetric_matches_jax_and_dense(from_C, n_a, n_c):
    """The Schur-complement solve and log-determinant of M = [A B; B^T C]
    against the JAX package's and a dense solve of M, with A given as a
    dense factor and as a block-diagonal one."""
    rng = np.random.default_rng(n_a + n_c)
    G = rng.standard_normal((n_a + n_c, n_a + n_c))
    M = G @ G.T + (n_a + n_c) * np.eye(n_a + n_c)
    A, B, C = M[:n_a, :n_a], M[:n_a, n_a:], M[n_a:, n_a:]
    S = C - B.T @ np.linalg.solve(A, B)
    jA, tA = JCholeskyFactor.factorize(jnp.asarray(A)), CholeskyFactor.factorize(torch.as_tensor(A))
    if from_C:
        jm = jblock.build_block_symmetric_from_C(jA, jnp.asarray(B), jnp.asarray(C))
        tm = tblock.build_block_symmetric_from_C(tA, torch.as_tensor(B), torch.as_tensor(C))
    else:
        jm = jblock.build_block_symmetric(jA, jnp.asarray(B), JCholeskyFactor.factorize(jnp.asarray(S)))
        tm = tblock.build_block_symmetric(tA, torch.as_tensor(B), CholeskyFactor.factorize(torch.as_tensor(S)))
    assert tm.rows == n_a + n_c
    _close(tm.Ai_B, jm.Ai_B)
    for rhs in (rng.standard_normal(n_a + n_c), rng.standard_normal((n_a + n_c, 3))):
        _close(tm.solve(torch.as_tensor(rhs)), jm.solve(jnp.asarray(rhs)))
        _close(tm.solve(torch.as_tensor(rhs)), np.linalg.solve(M, rhs))
    assert float(tm.log_determinant()) == pytest.approx(float(jm.log_determinant()), rel=RTOL)
    assert float(tm.log_determinant()) == pytest.approx(np.linalg.slogdet(M)[1], rel=RTOL)


def test_block_symmetric_over_a_block_diagonal_A():
    blocks = _spd_blocks((3, 2, 4), seed=5)
    rng = np.random.default_rng(5)
    A = np.zeros((9, 9))
    o = 0
    for b in blocks:
        A[o:o + len(b), o:o + len(b)] = b
        o += len(b)
    B = 0.3 * rng.standard_normal((9, 2))
    C = 5.0 * np.eye(2)
    tA = tblock.BlockDiagonal.from_blocks([torch.as_tensor(b) for b in blocks]).factorize()
    tm = tblock.build_block_symmetric_from_C(tA, torch.as_tensor(B), torch.as_tensor(C))
    M = np.block([[A, B], [B.T, C]])
    rhs = rng.standard_normal(11)
    _close(tm.solve(torch.as_tensor(rhs)), np.linalg.solve(M, rhs))
    assert float(tm.log_determinant()) == pytest.approx(np.linalg.slogdet(M)[1], rel=RTOL)


def test_block_utils_match_jax():
    a = {0: np.ones((2, 2)), 1: 2.0 * np.ones((2, 2)), 3: -np.eye(2)}
    b = {0: np.eye(2), 1: np.arange(4.0).reshape(2, 2), 3: np.ones((2, 2))}
    ja = JGrouped({k: jnp.asarray(v) for k, v in a.items()})
    jb = JGrouped({k: jnp.asarray(v) for k, v in b.items()})
    ta = Grouped({k: torch.as_tensor(v) for k, v in a.items()})
    tb = Grouped({k: torch.as_tensor(v) for k, v in b.items()})
    _close(tblock.block_sum(ta), jblock.block_sum(ja), rtol=0)
    _close(tblock.block_product(ta, tb), jblock.block_product(ja, jb), rtol=0)
    _close(tblock.block_inner_product(ta, tb), jblock.block_inner_product(ja, jb), rtol=0)
    diff_t, diff_j = tblock.block_subtract(ta, tb), jblock.block_subtract(ja, jb)
    for k in a:
        _close(diff_t[k], diff_j[k], rtol=0)
    solvers_t = Grouped({k: CholeskyFactor.factorize(torch.as_tensor((k + 2.0) * np.eye(2))) for k in a})
    solvers_j = JGrouped({k: JCholeskyFactor.factorize(jnp.asarray((k + 2.0) * np.eye(2))) for k in a})
    solved_t, solved_j = tblock.block_diag_solve(solvers_t, tb), jblock.block_diag_solve(solvers_j, jb)
    for k in a:
        _close(solved_t[k], solved_j[k])
    with pytest.raises(ValueError, match="same keys"):
        tblock.block_product(ta, Grouped({0: torch.eye(2)}))
