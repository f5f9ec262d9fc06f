from .blocked_cholesky import (
    auto_block_size,
    blocked_cholesky,
    blocked_cholesky_cols,
    blocked_tri_inverse,
    cuda_block_size,
)
from .compensated import accurate_log, accurate_sum_of_logs, dw_sum, two_prod, two_sum
from .linalg import CholeskyFactor
from .panel_cholinv import panel_cholinv, plain_panel_cholinv
from .radial_gram import (
    fused_training_covariance,
    match_fused_training_cov,
    plain_radial_gram,
    radial_gram,
)

__all__ = [k for k in dir() if not k.startswith("_")]
