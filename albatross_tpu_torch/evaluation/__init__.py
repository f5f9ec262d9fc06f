from .model_metrics import GaussianProcessNegativeLogLikelihood, ModelMetric

__all__ = [k for k in dir() if not k.startswith("_")]
