from .chi_squared import chi_squared_cdf, chi_squared_cdf_value
from .gauss_legendre import gauss_legendre_points
from .gaussian import gaussian_log_pdf, gaussian_pdf
from .incomplete_gamma import (
    lower_incomplete_gamma,
    regularized_lower_incomplete_gamma,
)
from .ks_test import uniform_ks_test

__all__ = [k for k in dir() if not k.startswith("_")]
