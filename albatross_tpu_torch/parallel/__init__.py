"""Mesh-distributed linear algebra, the distributed exact GP and the
distributed sparse GP on ``torch.distributed``: the JAX package's
``albatross_tpu.parallel`` in its 1-D row layout and its 2-D tile
layout."""

from .cholesky import (
    distributed_cholesky,
    distributed_inverse_blocks,
    distributed_inverse_diagonal,
    distributed_log_determinant,
    distributed_solve,
    distributed_sqrt_solve,
)
from .cholesky2d import (
    distributed_cholesky_2d,
    distributed_inverse_blocks_2d,
    distributed_inverse_diagonal_2d,
    distributed_log_determinant_2d,
    distributed_solve_2d,
    distributed_sqrt_solve_2d,
    distributed_tri_inverse_2d,
)
from .gp import (
    DistributedCholesky,
    DistributedCholesky2D,
    DistributedGaussianProcess,
    distributed_gp_from_covariance,
)
from .gram import sharded_cross_gram, sharded_gram, sharded_gram_2d
from .mesh import make_mesh, pad_to_multiple, replicated, row_sharded, vector_sharded
from .sparse import (
    DistributedSparseGaussianProcessRegression,
    distributed_sparse_gp_from_covariance,
    distributed_tall_qr,
)

__all__ = [k for k in dir() if not k.startswith("_")]
