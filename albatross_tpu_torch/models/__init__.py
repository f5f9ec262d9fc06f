from .adapter import AdaptedModel
from .base import FitModel, ModelBase, Prediction
from .conditional import ConditionalFit, ConditionalGaussian
from .gp import (
    GaussianProcess,
    GPFit,
    gp_from_covariance,
    gp_from_covariance_and_mean,
    gp_joint_prediction,
    gp_marginal_prediction,
    gp_mean_prediction,
    negative_log_likelihood,
)
from .least_squares import LeastSquares, LeastSquaresFit, LinearRegression
from .null import NullModel
from .ransac import (
    ChiSquaredConsensusMetric,
    ChiSquaredIsValidCandidateMetric,
    DefaultGPRansacStrategy,
    DefaultRansacStrategy,
    DifferentialEntropyConsensusMetric,
    FeatureCountConsensusMetric,
    GaussianProcessRansacStrategy,
    GenericRansacStrategy,
    Ransac,
    RansacConfig,
    RansacOutput,
    RansacReturnCode,
    gp_ransac_strategy,
    ransac,
    ransac_success,
)
from .sparse_gp import (
    EveryPointGrouper,
    SparseGaussianProcessRegression,
    SparseGPFit,
    StateSpaceInducingPointStrategy,
    UniformlySpacedInducingPoints,
    rebase_inducing_points,
    sparse_gp_from_covariance,
    sparse_gp_from_covariance_and_mean,
)

__all__ = [k for k in dir() if not k.startswith("_")]
