"""Exact Gaussian-process regression.

Counterpart of ``albatross_tpu.models.gp`` (main path):
* fit: wrap the training batch as Measurements, build the training
  covariance (gram + noise + target variance + jitter, in one gram-kernel
  pass when the kernel matches), subtract the mean, factorize, and keep the
  information vector v = K^-1 y;
* predict mean  : K*^T v;
* predict marg. : prior_diag - colsum(K^-1 K* o K*), with the clamp of
  rounding-scale negatives;
* predict joint : K** - K*^T K^-1 K*;
* log_likelihood: -NLL(y - m(X), K(X, X)) + sum of prior log-pdfs, with no
  target variance added, as the reference does.  From
  ``config.CHOLESKY_FUSED_MIN_N`` points on (or with
  ``CHOLESKY_ALGORITHM = "right_fused"``) a kernel of the fused pattern
  takes the lazy-gram loop, which never holds the N x N covariance;
  ``safe_factorization`` materializes the covariance and escalates the
  jitter until it factors (CholeskyFactor.factorize_safe);
* update: grow the fit by new observations through the Schur complement
  (ops/block.py BlockSymmetric), without refactorizing the old block;
* fit_from_prediction: a fit whose predictions at the given features
  reproduce a joint prediction (ExplainedCovariance);
* cross_validated_predictions: fast LOO / LOGO from one fit;
* batched_log_likelihood: ``log_likelihood`` of a batch of models that
  differ only in their parameters (the ensemble sampler's walkers), from
  one walker-batched gram launch or a stack of their DSL covariances, and
  one batched factorization.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from .. import config
from ..core.dataset import RegressionDataset, concatenate_features
from ..core.distributions import JointDistribution, MarginalDistribution
from ..core.parameters import host_float, map_join
from ..kernels.base import CovarianceFunction
from ..kernels.features import Measurement, as_measurement
from ..kernels.means import MeanFunction, ZeroMean
from ..ops.batched_nlml import batched_nlml_terms, walkers_per_batch
from ..ops.block import build_block_symmetric
from ..ops.linalg import CholeskyFactor, ExplainedCovariance
from ..ops.radial_gram import (
    fused_training_covariance,
    fused_training_covariance_batched,
    match_fused_training_cov,
    radial_gram_cols,
)
from .base import FitModel, ModelBase

LOG_2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class GPFit:
    """Trained GP state: features, the training covariance in a form that
    solves (a CholeskyFactor, or after ``update`` a BlockSymmetric, after
    ``for_serving`` a DirectInverse, from ``fit_from_prediction`` an
    ExplainedCovariance), and the information vector v = K^-1 y."""

    train_features: Any
    train_covariance: Any
    information: torch.Tensor


def gp_mean_prediction(cross_cov, information):
    return cross_cov.T @ information


def gp_marginal_prediction(cross_cov, prior_variance, information, train_covariance):
    pred = gp_mean_prediction(cross_cov, information)
    explained = train_covariance.solve(cross_cov)
    explained_variance = torch.sum(explained * cross_cov, dim=0)
    # In f32 the cancellation prior - explained can round a few ulps
    # negative next to training points; clamp only rounding-scale negatives
    # (window 1e-3 of the magnitudes: the solve's forward error is
    # kappa-amplified), so a failed factorization still surfaces.
    raw = prior_variance - explained_variance
    scale = torch.abs(prior_variance) + torch.abs(explained_variance)
    rounding_negative = raw >= -1e-3 * scale
    return MarginalDistribution(
        pred, torch.where(rounding_negative, torch.clamp_min(raw, 0.0), raw)
    )


def gp_joint_prediction(cross_cov, prior_cov, information, train_covariance):
    pred = gp_mean_prediction(cross_cov, information)
    explained_cov = cross_cov.T @ train_covariance.solve(cross_cov)
    return JointDistribution(pred, prior_cov - explained_cov)


def _nll_from_whitened(log_det, white):
    """1/2 (log|K| + ||L^-1 dev||^2 + n log 2 pi); no target variance."""
    n = white.shape[0]
    return 0.5 * (log_det + torch.sum(white * white) + n * LOG_2PI)


def negative_log_likelihood(deviation, chol: CholeskyFactor):
    """1/2 (log|K| + dev^T K^-1 dev + n log 2 pi) from K's factor."""
    return _nll_from_whitened(chol.log_determinant(), chol.sqrt_solve(deviation))


def _make_gram_col_fn(x2, ls, sigma, diag_add, profile):
    """col_fn(j0, b) -> active rows j0..n of training-covariance column
    panel [j0, j0 + b), the diagonal (noise + jitter) included: the gram
    kernel's column block (ops/radial_gram.py radial_gram_cols).

    Everything the panels share is read once here: the scalars as host
    floats for the launches, the scalars moved to x2's device for the
    backward, and the (n,) diagonal whose slices the panels take (so the
    noise gradient sums over the panels)."""
    host_scalars = host_float(ls), host_float(sigma)
    if isinstance(ls, torch.Tensor):
        ls = ls.to(x2.device)
    if isinstance(sigma, torch.Tensor):
        sigma = sigma.to(x2.device)
    diag = torch.zeros((x2.shape[0],), dtype=x2.dtype, device=x2.device) + diag_add

    def col_fn(j0, b):
        return radial_gram_cols(x2, j0, b, ls, sigma, profile, diag, host_scalars)

    return col_fn


def _fused_gram_nlml(x2, ls, sigma, diag_add, rhs, *, profile: str):
    """(log|K|, L^-1 rhs) with the gram produced inside the factorization:
    no N x N covariance is ever written."""
    col_fn = _make_gram_col_fn(x2, ls, sigma, diag_add, profile)
    return CholeskyFactor.nlml_terms(None, rhs, col_fn=col_fn)


class GaussianProcess(ModelBase):
    """Exact GP regression model."""

    def __init__(
        self,
        covariance: CovarianceFunction,
        mean: Optional[MeanFunction] = None,
        model_name: Optional[str] = None,
        jitter: float = 0.0,
        safe_factorization: bool = False,
    ):
        self.covariance_function = covariance
        self.mean_function = mean if mean is not None else ZeroMean()
        self._model_name = model_name
        self.jitter = jitter
        # escalate the jitter until the training covariance factors
        self.safe_factorization = safe_factorization

    @property
    def model_name(self) -> str:
        if self._model_name:
            return self._model_name
        return f"mean:{self.mean_function.name}cov:{self.covariance_function.name}"

    def get_params(self):
        return map_join(
            self.mean_function.get_params(), self.covariance_function.get_params()
        )

    def compute_train_covariance(self, features) -> torch.Tensor:
        return self.covariance_function(as_measurement(features))

    def _training_covariance(self, measurements, target_variance):
        """(training covariance, jitter already included).  Kernels that
        match ``radial + diagonal-only noise`` get the whole covariance from
        one gram pass (ops/radial_gram.py fused_training_covariance)."""
        if isinstance(measurements, Measurement):
            fused = fused_training_covariance(
                self.covariance_function, measurements.value, target_variance, self.jitter
            )
            if fused is not None:
                return fused, True
        cov = self.covariance_function(measurements)
        if target_variance is not None:
            cov = cov + torch.diag(target_variance)
        return cov, False

    def _fit_impl(self, features, targets: MarginalDistribution) -> GPFit:
        measurements = as_measurement(features)
        cov, fused = self._training_covariance(measurements, targets.variance)
        zero_mean = self.mean_function.remove_from(measurements, targets.mean)
        chol = self._factorize(cov, jitter_applied=fused)
        return GPFit(features, chol, chol.solve(zero_mean))

    def _factorize(self, cov, jitter_applied: bool = False) -> CholeskyFactor:
        jitter = 0.0 if jitter_applied else self.jitter
        if self.safe_factorization:
            return CholeskyFactor.factorize_safe(cov, initial_jitter=jitter)
        # covariances from the DSL are symmetric by construction
        return CholeskyFactor.factorize(cov, jitter=jitter, assume_symmetric=True)

    def _cross(self, fit: GPFit, features):
        return self.covariance_function.matrix_or_none(fit.train_features, features)

    def _predict_mean(self, features, fit: GPFit):
        pred = gp_mean_prediction(self._cross(fit, features), fit.information)
        return self.mean_function.add_to(features, pred)

    def _predict_marginal(self, features, fit: GPFit) -> MarginalDistribution:
        cross = self._cross(fit, features)
        prior_variance = self.covariance_function.diag(features)
        pred = gp_marginal_prediction(
            cross, prior_variance, fit.information, fit.train_covariance
        )
        return MarginalDistribution(
            self.mean_function.add_to(features, pred.mean), pred.variance
        )

    def _predict_joint(self, features, fit: GPFit) -> JointDistribution:
        cross = self._cross(fit, features)
        prior_cov = self.covariance_function(features)
        pred = gp_joint_prediction(cross, prior_cov, fit.information, fit.train_covariance)
        return JointDistribution(
            self.mean_function.add_to(features, pred.mean), pred.covariance
        )

    def _update_impl(self, fit: GPFit, features, targets: MarginalDistribution) -> GPFit:
        """The fit grown by (features, targets): the new block's Schur
        complement is the predicted joint covariance plus the new target
        variance.  The new block is predicted from unwrapped features, so
        the update equals a refit only for kernels without measurement-only
        terms, as in the JAX package."""
        pred = self._predict_joint(features, fit)
        delta = targets.mean - pred.mean
        S = pred.covariance
        if targets.variance is not None:
            S = S + torch.diag(targets.variance)
        S_chol = CholeskyFactor.factorize(S, jitter=self.jitter)
        cross = self.covariance_function.matrix_or_none(fit.train_features, features)
        new_covariance = build_block_symmetric(fit.train_covariance, cross, S_chol)
        Si_delta = S_chol.solve(delta)
        top = fit.information - new_covariance.Ai_B @ Si_delta
        return GPFit(concatenate_features([fit.train_features, features]), new_covariance,
                     torch.cat([top, Si_delta]))

    def fit_from_prediction(self, features, prediction: JointDistribution) -> FitModel:
        """A fit whose predictions at ``features`` reproduce ``prediction``:
        C = K (K - P)^-1 K as the training covariance.  The mean function
        is removed from the prediction first, or predictions would add it
        twice."""
        zero_mean = self.mean_function.remove_from(features, prediction.mean)
        prior = self.covariance_function(features)
        prior_chol = CholeskyFactor.factorize(prior, jitter=self.jitter)
        fit = GPFit(features, ExplainedCovariance(prior, prior - prediction.covariance),
                    prior_chol.solve(zero_mean))
        return FitModel(self, fit)

    def prior(self, features) -> JointDistribution:
        measurements = as_measurement(features)
        return JointDistribution(self.mean_function(measurements), self.covariance_function(measurements))

    def _training_cov_fused_pieces(self, measurements):
        """``(x2, ls, sigma, diag_add, profile)`` when the training
        covariance is one radial term + diagonal-only noise over one (N,) or
        (N, D <= 8) feature tensor -- the pattern the lazy-gram loop builds
        column by column -- else None.  D > 8 stays on the materialized
        path, as in the JAX package."""
        if not isinstance(measurements, Measurement):
            return None
        matched = match_fused_training_cov(self.covariance_function, for_measurements=True)
        x = measurements.value
        if matched is None or not isinstance(x, torch.Tensor) or x.ndim > 2:
            return None
        x2 = x[:, None] if x.ndim == 1 else x
        if x2.shape[-1] > 8:
            return None
        radial, ls, sigma, diag_scalar = matched
        return x2, ls, sigma, diag_scalar + self.jitter, radial._profile_name

    def _training_cov_col_fn(self, measurements):
        """The lazy column producer over the matched pieces (for
        ``CholeskyFactor.nlml_terms(col_fn=...)``), or None."""
        pieces = self._training_cov_fused_pieces(measurements)
        if pieces is None:
            return None
        x2, ls, sigma, diag_add, profile = pieces
        return _make_gram_col_fn(x2, ls, sigma, diag_add, profile)

    def log_likelihood(self, dataset: RegressionDataset) -> torch.Tensor:
        """Log marginal likelihood plus the parameters' prior log-pdfs.

        The factor is never assembled (CholeskyFactor.nlml_terms).  The
        covariance is materialized, except on the lazy-gram loop: from
        ``config.CHOLESKY_FUSED_MIN_N`` points on, or always with
        ``CHOLESKY_ALGORITHM = "right_fused"``, above n = 2048 and for a
        kernel of the fused pattern.  With ``safe_factorization`` the
        covariance is always materialized and factored by factorize_safe."""
        measurements = as_measurement(dataset.features)
        zero_mean = self.mean_function.remove_from(measurements, dataset.targets.mean)
        n = zero_mean.shape[0]
        algorithm = config.cholesky_algorithm()
        if algorithm == "right" and config.CHOLESKY_FUSED_MIN_N and n >= config.CHOLESKY_FUSED_MIN_N:
            algorithm = "right_fused"
        pieces = None
        if algorithm == "right_fused" and n > 2048 and not self.safe_factorization:
            pieces = self._training_cov_fused_pieces(measurements)
        if pieces is not None:
            x2, ls, sigma, diag_add, profile = pieces
            ll = -_nll_from_whitened(*_fused_gram_nlml(x2, ls, sigma, diag_add, zero_mean, profile=profile))
        elif self.safe_factorization:
            cov, fused = self._training_covariance(measurements, None)
            ll = -negative_log_likelihood(zero_mean, self._factorize(cov, jitter_applied=fused))
        else:
            cov, fused = self._training_covariance(measurements, None)
            ll = -_nll_from_whitened(*CholeskyFactor.nlml_terms(
                cov, zero_mean, jitter=0.0 if fused else self.jitter, assume_symmetric=True
            ))
        return ll + self.prior_log_likelihood().to(device=ll.device, dtype=ll.dtype)

    @staticmethod
    def _batched_training_covariance(models, measurements) -> tuple[torch.Tensor, float]:
        """((W, n, n) stack of the models' training covariances, the jitter
        still to add).  Models of the fused pattern over one tensor of
        features: one batched gram launch writes the stack
        (ops/radial_gram.py fused_training_covariance_batched); any other
        kernel: each model's DSL covariance, written into its slice as it
        is built."""
        if isinstance(measurements, Measurement):
            K = fused_training_covariance_batched([m.covariance_function for m in models],
                                                  measurements.value, [m.jitter for m in models])
            if K is not None:
                return K, 0.0
        jitters = {m.jitter for m in models}
        if len(jitters) != 1:
            raise ValueError(f"batched_log_likelihood: the models' jitters differ ({sorted(jitters)})")
        K = None
        for w, m in enumerate(models):
            cov = m._training_covariance(measurements, None)[0]
            if K is None:
                K = cov.new_empty((len(models), *cov.shape))
            K[w] = cov
        return K, jitters.pop()

    @staticmethod
    def batched_log_likelihood(models, dataset: RegressionDataset) -> torch.Tensor:
        """``[m.log_likelihood(dataset) for m in models]`` as batches, for
        GaussianProcess models that differ only in their parameters: a
        (W, n, n) stack of training covariances and one batched
        factorization (``ops/batched_nlml.py``) a batch, forward only; each
        model's prior log-likelihood is added on the host in f64.  Returns a
        (W,) f64 CPU tensor; a model whose covariance does not factor gets a
        non-finite value.

        On the card a batch holds as many walkers as its free memory takes
        (``walkers_per_batch``), so a large ensemble runs in several batches
        of the same arithmetic, and a covariance too large for the card
        raises.  At ``config.CHOLESKY_FUSED_MIN_N`` points and above, where
        ``log_likelihood`` takes the lazy-gram loop because one N x N
        covariance is already large on the card, this raises too.  Below
        it, ``CHOLESKY_ALGORITHM = "right_fused"`` gives the same arithmetic
        as the materialized factorization used here.  ``safe_factorization``
        models are refused: their jitter search is one matrix at a time."""
        if any(m.safe_factorization for m in models):
            raise ValueError("batched_log_likelihood: safe_factorization models factor one at a time; "
                             "call log_likelihood on each")
        measurements = as_measurement(dataset.features)
        zero_mean = torch.stack([m.mean_function.remove_from(measurements, dataset.targets.mean)
                                 for m in models])
        w, n = zero_mean.shape
        if config.CHOLESKY_FUSED_MIN_N and n >= config.CHOLESKY_FUSED_MIN_N:
            raise ValueError(
                f"batched_log_likelihood: n = {n} is at or above config.CHOLESKY_FUSED_MIN_N = "
                f"{config.CHOLESKY_FUSED_MIN_N}, where log_likelihood takes the lazy-gram loop to save "
                f"the card's memory; a stack of {w} covariances of that size would not fit"
            )
        x = measurements.value if isinstance(measurements, Measurement) else None
        itemsize = max(zero_mean.element_size(), x.element_size() if isinstance(x, torch.Tensor) else 0)
        per_batch = walkers_per_batch(w, n, itemsize, zero_mean.device)
        lls = []
        for s in range(0, w, per_batch):
            part = models[s:s + per_batch]
            K, jitter = GaussianProcess._batched_training_covariance(part, measurements)
            log_det, white = batched_nlml_terms(K, zero_mean[s:s + per_batch], jitter)
            del K
            lls.append(-0.5 * (log_det + torch.sum(white * white, dim=-1) + n * LOG_2PI))
        ll = torch.cat(lls).to(device="cpu", dtype=torch.float64)  # the one read back
        return ll + torch.stack([m.prior_log_likelihood().to(torch.float64) for m in models])

    def cross_validated_predictions(self, dataset: RegressionDataset, indexers, predict_type):
        """Fast LOO / LOGO: fit once, then each group's held-out prediction
        from the diagonal blocks of the inverse.  The raw target mean is
        passed: the information vector already accounts for the mean
        function."""
        from ..evaluation.cross_validation_utils import held_out_predictions

        fit = self.fit(dataset).fit
        return held_out_predictions(fit.train_covariance, dataset.targets.mean, fit.information,
                                    indexers, predict_type)


def gp_from_covariance(
    covariance: CovarianceFunction, model_name: Optional[str] = None, **kwargs
) -> GaussianProcess:
    return GaussianProcess(covariance, model_name=model_name, **kwargs)


def gp_from_covariance_and_mean(
    covariance: CovarianceFunction, mean: MeanFunction, model_name: Optional[str] = None, **kwargs
) -> GaussianProcess:
    return GaussianProcess(covariance, mean, model_name=model_name, **kwargs)
