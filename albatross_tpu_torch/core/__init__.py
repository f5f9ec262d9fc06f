from .dataset import (
    RegressionDataset,
    align_datasets,
    concatenate_datasets,
    concatenate_features,
    deduplicate,
    feature_count,
    subset_features,
    transform_dataset,
)
from .distributions import JointDistribution, MarginalDistribution, concatenate_joints, concatenate_marginals
from .module import Module
from .parameters import (
    Parameter,
    ParameterHandlingMixin,
    ParameterStore,
    TunableParameters,
    ensure_value_within_bounds,
    get_tunable_parameters,
    host_float,
    map_join,
    parameter_prior_log_likelihood,
    params_are_valid,
    pretty_param_details,
    pretty_params,
    pretty_priors,
    set_tunable_params,
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
