"""albatross_tpu_torch -- albatross_tpu's Gaussian processes in PyTorch.

A port of the JAX package ``albatross_tpu`` that keeps its module paths and
public names: covariance DSL (radial kernels, noise, measurement-only
terms, distance metrics, polynomials, scaling terms, means, variant
(tagged) features, linear combinations, call traces), exact GP fit /
predict / log-likelihood and its gradient (with
the lazy-gram loop for large N), its online update, serving mode
(explicit inverse), fit_from_prediction and safe factorization, the
sparse FITC / PITC GP, the null, least-squares, conditional and adapted
models, RANSAC outlier rejection, the chi-squared and Gaussian
statistics (``stats``), fast LOO / LOGO cross-validation (``evaluation``,
``indexing``),
the tunable-parameter round trip and the tuners (``tuning``), the
ensemble MCMC sampler (``samplers``), checkpoints and parameter JSON
(``serialize``), host utilities (``utils``: CSV, random draws, graphs,
Chebyshev bases, profiling), and the blocked Cholesky and block solvers
beneath them.  Its hot
spots are hand-written CUDA kernels for Hopper (``csrc/``), built with
nvcc at first use; CPU tensors take each kernel's plain PyTorch version.
Importing this package never imports JAX.
"""

from . import (
    config,
    convert,
    core,
    evaluation,
    indexing,
    kernels,
    models,
    ops,
    samplers,
    serialize,
    stats,
    tuning,
    utils,
)
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
    concatenate_datasets,
)
from .kernels import (
    AngularDistance,
    Constant,
    ConstantTerm,
    EuclideanDistance,
    Exponential,
    ForTag,
    IndependentNoise,
    LinearMean,
    Matern32,
    Matern52,
    MeanFunction,
    Measurement,
    Nugget,
    Polynomial,
    RadialDistance,
    ScalingFunction,
    ScalingTerm,
    SquaredExponential,
    TaggedBatch,
    ZeroMean,
    as_measurement,
    measurement_only,
)
from .models import (
    ConditionalGaussian,
    DefaultGPRansacStrategy,
    DefaultRansacStrategy,
    FitModel,
    GaussianProcess,
    LeastSquares,
    LinearRegression,
    NullModel,
    Ransac,
    RansacConfig,
    SparseGaussianProcessRegression,
    StateSpaceInducingPointStrategy,
    UniformlySpacedInducingPoints,
    gp_from_covariance,
    gp_from_covariance_and_mean,
    rebase_inducing_points,
    sparse_gp_from_covariance,
    sparse_gp_from_covariance_and_mean,
)

__version__ = "0.1.0"
__all__ = [k for k in dir() if not k.startswith("_")]
