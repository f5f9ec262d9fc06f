from .block import (
    BlockDiagonal,
    BlockDiagonalCholesky,
    BlockSymmetric,
    DiagonalCholesky,
    block_accumulate,
    block_diag_solve,
    block_inner_product,
    block_product,
    block_subtract,
    block_sum,
    build_block_symmetric,
    build_block_symmetric_from_C,
    pad_blocks,
)
from .blocked_cholesky import (
    auto_block_size,
    blocked_cholesky,
    blocked_cholesky_cols,
    blocked_cholesky_cols_fused,
    blocked_tri_inverse,
    cuda_block_size,
)
from .compensated import (
    accurate_log,
    accurate_log_guarded,
    accurate_sum_of_logs,
    blocked_cholesky_dw,
    compensated_nll,
    compensated_nll_dw,
    dot2,
    dw_add,
    dw_log_determinant,
    dw_matvec,
    dw_sum,
    refined_quadratic,
    two_prod,
    two_sum,
)
from .linalg import CholeskyFactor, DirectInverse, ExplainedCovariance, truncated_psd_solve, vertical_stack
from .nlml import blocked_lauum, spd_inverse_from_factor, tri_inverse_full
from .panel_cholinv import panel_cholinv, plain_panel_cholinv
from .radial_gram import (
    fused_training_covariance,
    fused_training_covariance_batched,
    match_fused_training_cov,
    plain_radial_gram,
    radial_gram,
    radial_gram_cols,
)

__all__ = [k for k in dir() if not k.startswith("_")]
