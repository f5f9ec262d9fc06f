from .finite_difference import compute_gradient
from .greedy import greedy_tune
from .tune import (
    GenericTuner,
    ModelTuner,
    TuningResult,
    get_tuner,
    mean_aggregator,
    tune_parameter_store,
)

__all__ = [k for k in dir() if not k.startswith("_")]
