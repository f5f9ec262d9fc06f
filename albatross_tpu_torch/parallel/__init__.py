"""Mesh-distributed linear algebra and the distributed exact GP on
``torch.distributed``: the 1-D row-sharded layout of the JAX package's
``albatross_tpu.parallel``."""

from .cholesky import (
    distributed_cholesky,
    distributed_inverse_blocks,
    distributed_inverse_diagonal,
    distributed_log_determinant,
    distributed_solve,
    distributed_sqrt_solve,
)
from .gp import DistributedCholesky, DistributedGaussianProcess, distributed_gp_from_covariance
from .gram import sharded_cross_gram, sharded_gram
from .mesh import make_mesh, pad_to_multiple, replicated, row_sharded, vector_sharded

__all__ = [k for k in dir() if not k.startswith("_")]
