from .base import FitModel, ModelBase, Prediction
from .gp import GaussianProcess, GPFit, gp_from_covariance

__all__ = [k for k in dir() if not k.startswith("_")]
