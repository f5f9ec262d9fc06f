"""albatross_tpu_torch -- the exact-GP main path of albatross_tpu in PyTorch.

A port of the JAX package ``albatross_tpu`` that keeps its module paths and
public names: covariance DSL (radial kernels, noise, measurement-only
terms), exact GP fit / predict / log-likelihood, and the blocked Cholesky
beneath them.  Its hot spots are hand-written CUDA kernels for Hopper
(``csrc/``), built with nvcc at first use; CPU tensors take each kernel's
plain PyTorch version.  Importing this package never imports JAX.
"""

from . import config, convert, core, kernels, models, ops
from .core import (
    FixedPrior,
    GaussianPrior,
    JointDistribution,
    LogNormalPrior,
    LogScaleUniformPrior,
    MarginalDistribution,
    NonNegativePrior,
    Parameter,
    PositiveGaussianPrior,
    PositivePrior,
    RegressionDataset,
    UniformPrior,
    UninformativePrior,
)
from .kernels import (
    EuclideanDistance,
    Exponential,
    IndependentNoise,
    Matern32,
    Matern52,
    MeanFunction,
    Measurement,
    Nugget,
    SquaredExponential,
    ZeroMean,
    as_measurement,
    measurement_only,
)
from .models import FitModel, GaussianProcess, gp_from_covariance

__version__ = "0.1.0"
__all__ = [k for k in dir() if not k.startswith("_")]
