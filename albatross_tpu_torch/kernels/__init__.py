from .base import CallTreeNode, CovarianceFunction, ProductKernel, SumKernel
from .distances import (
    AngularDistance,
    DistanceMetric,
    EuclideanDistance,
    RadialDistance,
)
from .features import (
    LinearCombinationBatch,
    Measurement,
    as_measurement,
    as_measurements,
    difference_of,
    mean_of,
    strip_measurement,
    sum_of,
    to_linear_combination,
)
from .means import (
    ConstantMean,
    LinearMean,
    MeanFunction,
    ProductMean,
    SumMean,
    ZeroMean,
)
from .measurement import MeasurementOnly, measurement_only
from .noise import IndependentNoise, Nugget
from .polynomials import Constant, ConstantTerm, Polynomial
from .radial import (
    Exponential,
    Matern32,
    Matern52,
    SquaredExponential,
    derive_exponential_length_scale,
    derive_squared_exponential_length_scale,
    exponential_covariance,
    matern_32_covariance,
    matern_52_covariance,
    process_noise_equivalent,
    squared_exponential_covariance,
)
from .scaling import ScalingFunction, ScalingTerm
from .variants import ForTag, TaggedBatch, concatenate_mixed_datasets, for_tag

__all__ = [k for k in dir() if not k.startswith("_")]
