from .callbacks import (
    CsvWritingCallback,
    MaximumLikelihoodTrackingCallback,
    NullCallback,
)
from .ensemble import (
    EnsembleChain,
    SamplerState,
    ensemble_sampler,
    ensemble_sampler_from_model,
    ensure_finite_initial_state,
    initial_params_from_jitter,
    stretch_move_step,
)

__all__ = [k for k in dir() if not k.startswith("_")]
