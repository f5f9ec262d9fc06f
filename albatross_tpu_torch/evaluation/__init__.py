from .cross_validation import CrossValidation, CVPrediction, predict_fold
from .cross_validation_utils import (
    BatchedGrouped,
    cross_validated_scores,
    held_out_predictions,
    leave_one_group_out_conditional,
    leave_one_out_conditional,
    leave_one_out_conditional_variance,
)
from .entropy import differential_entropy
from .folds import (
    RegressionFold,
    create_fold,
    folds_from_group_indexer,
    folds_from_grouper,
    k_fold_folds,
    leave_one_out_folds,
)
from .metrics import (
    ChiSquaredCdf,
    Crps,
    NegativeLogLikelihood,
    PredictionMetric,
    RootMeanSquareError,
    StandardDeviation,
    crps_normal,
    energy_score,
    expected_abs_normal_1,
    expected_abs_normal_2,
    negative_log_likelihood_joint,
    negative_log_likelihood_marginal,
    variogram_score,
    wasserstein_2,
)
from .model_metrics import (
    GaussianProcessNegativeLogLikelihood,
    LeaveOneGroupOutLikelihood,
    LeaveOneOutLikelihood,
    LeaveOneOutRMSE,
    ModelMetric,
)

__all__ = [k for k in dir() if not k.startswith("_")]
