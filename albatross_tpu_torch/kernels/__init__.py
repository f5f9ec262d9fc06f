from .base import CovarianceFunction, ProductKernel, SumKernel
from .distances import EuclideanDistance
from .features import Measurement, as_measurement, strip_measurement
from .means import MeanFunction, ZeroMean
from .measurement import MeasurementOnly, measurement_only
from .noise import IndependentNoise, Nugget
from .radial import (
    Exponential,
    Matern32,
    Matern52,
    SquaredExponential,
    exponential_covariance,
    matern_32_covariance,
    matern_52_covariance,
    squared_exponential_covariance,
)

__all__ = [k for k in dir() if not k.startswith("_")]
