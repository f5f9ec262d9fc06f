from .dataset import RegressionDataset, feature_count
from .distributions import JointDistribution, MarginalDistribution
from .module import Module
from .parameters import (
    Parameter,
    ParameterStore,
    map_join,
    parameter_prior_log_likelihood,
)
from .priors import (
    PRIOR_TYPES,
    FixedPrior,
    GaussianPrior,
    LogNormalPrior,
    LogScaleUniformPrior,
    NonNegativePrior,
    PositiveGaussianPrior,
    PositivePrior,
    Prior,
    UniformPrior,
    UninformativePrior,
)

__all__ = [k for k in dir() if not k.startswith("_")]
