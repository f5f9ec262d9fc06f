"""RANSAC outlier rejection as a meta-model.

Counterpart of ``albatross_tpu.models.ransac``.  The control loop (draw
candidates, validate, fit, score every other group, keep the best
consensus) is host logic over host keys.  The GP strategy computes the
prior over the whole dataset once (a ConditionalGaussian), so a candidate
fit is a small dense conditioning instead of a refit.

``ransac_gp_batched`` is the GP strategy's batched loop: every candidate
conditions the same prior on the same number of indices, so all of them
are gathered into one (K, s u, s u) stack, factored by one batched
Cholesky, and all K x G group scores follow from batched triangular
solves, read back to the host once.  It gives the same ``RansacOutput`` as
the serial loop (the same numpy draws, audit trail and return codes).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.dataset import RegressionDataset
from ..core.distributions import JointDistribution, MarginalDistribution
from ..evaluation.entropy import differential_entropy
from ..evaluation.metrics import NegativeLogLikelihood
from ..evaluation.model_metrics import LeaveOneOutLikelihood
from ..indexing.grouping import Grouped, LeaveOneOutGrouper, group_by, indices_from_groups
from ..ops.blocked_cholesky import cholesky
from ..ops.compensated import accurate_sum_of_logs
from ..stats.chi_squared import chi_squared_cdf, chi_squared_cdf_value
from .base import FitModel, ModelBase
from .conditional import ConditionalGaussian

DEFAULT_CHI_SQUARED_THRESHOLD = 0.999
LOG_2PI = math.log(2.0 * math.pi)


class RansacReturnCode(enum.IntEnum):
    INVALID = -1
    SUCCESS = 0
    NO_CONSENSUS = 1
    INVALID_ARGUMENTS = 2
    EXCEEDED_MAX_FAILED_CANDIDATES = 3
    FAILURE = 4


def ransac_success(return_code: RansacReturnCode) -> bool:
    return return_code == RansacReturnCode.SUCCESS


@dataclasses.dataclass
class RansacConfig:
    inlier_threshold: float = float("nan")
    random_sample_size: int = 0
    min_consensus_size: int = 0
    max_iterations: int = 0
    max_failed_candidates: int = 0


@dataclasses.dataclass(eq=False)
class RansacIteration:
    """Audit trail of one iteration: the candidate groups, every other
    group's inlier metric by key, and the consensus metric."""

    candidates: List = dataclasses.field(default_factory=list)
    inliers: Dict = dataclasses.field(default_factory=dict)
    outliers: Dict = dataclasses.field(default_factory=dict)
    consensus_metric_value: float = float("nan")

    def consensus(self) -> List:
        return list(self.candidates) + list(self.inliers.keys())


@dataclasses.dataclass(eq=False)
class RansacOutput:
    return_code: RansacReturnCode = RansacReturnCode.INVALID
    best: RansacIteration = dataclasses.field(default_factory=RansacIteration)
    iterations: List[RansacIteration] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class RansacFunctions:
    """The loop's callbacks: groups -> fit, (group, fit) -> inlier metric,
    groups -> consensus metric (lower is better), groups -> valid."""

    fitter: Callable
    inlier_metric: Callable
    consensus_metric: Callable
    is_valid_candidate: Callable = lambda groups: True


def random_without_replacement(values: List, k: int, rng) -> List:
    idx = rng.choice(len(values), size=k, replace=False)
    return [values[int(i)] for i in sorted(idx)]


def _invalid_arguments(config: RansacConfig, n_groups: int) -> bool:
    return (config.min_consensus_size >= n_groups
            or config.min_consensus_size < config.random_sample_size
            or config.random_sample_size >= n_groups
            or config.random_sample_size <= 0
            or config.max_iterations <= 0)


def _keep_if_best(output: RansacOutput, iteration: RansacIteration) -> None:
    best = output.best.consensus_metric_value
    if math.isnan(best) or iteration.consensus_metric_value < best:
        output.best = iteration


def _finish(output: RansacOutput) -> RansacOutput:
    output.return_code = (RansacReturnCode.SUCCESS if output.best.consensus()
                          else RansacReturnCode.NO_CONSENSUS)
    return output


def ransac(functions: RansacFunctions, groups: List, config: RansacConfig, seed: int = 0) -> RansacOutput:
    """The serial loop: one host read of the inlier metric a group."""
    output = RansacOutput(return_code=RansacReturnCode.FAILURE)
    if _invalid_arguments(config, len(groups)):
        output.return_code = RansacReturnCode.INVALID_ARGUMENTS
        return output

    rng = np.random.default_rng(seed)
    i = 0
    failed_candidates = 0
    while i < config.max_iterations:
        iteration = RansacIteration()
        output.iterations.append(iteration)
        iteration.candidates = random_without_replacement(groups, config.random_sample_size, rng)
        if not functions.is_valid_candidate(iteration.candidates):
            failed_candidates += 1
            if failed_candidates >= config.max_failed_candidates:
                output.return_code = RansacReturnCode.EXCEEDED_MAX_FAILED_CANDIDATES
                return output
            continue

        fit = functions.fitter(iteration.candidates)
        candidates = set(iteration.candidates)
        for group in groups:
            if group not in candidates:
                value = float(functions.inlier_metric(group, fit))
                (iteration.inliers if value <= config.inlier_threshold else iteration.outliers)[group] = value

        consensus = iteration.consensus()
        if len(consensus) >= config.min_consensus_size:
            iteration.consensus_metric_value = float(functions.consensus_metric(consensus))
            _keep_if_best(output, iteration)
        i += 1
    return _finish(output)


# ---------------------------------------------------------------------------
# Generic strategy: refit the model on each candidate set
# ---------------------------------------------------------------------------
class GenericRansacStrategy:
    def __init__(self, inlier_metric, consensus_metric, grouper):
        self.inlier_metric = inlier_metric
        self.consensus_metric = consensus_metric
        self.grouper = grouper

    def get_indexer(self, dataset: RegressionDataset) -> Grouped:
        return group_by(dataset, self.grouper).indexers()

    def __call__(self, model, dataset: RegressionDataset) -> RansacFunctions:
        indexer = self.get_indexer(dataset)

        def fitter(groups):
            return model.fit(dataset.subset(indices_from_groups(indexer, groups)))

        def inlier_metric(group, fit_model):
            inds = indexer[group]
            return self.inlier_metric(fit_model.predict(dataset.subset(inds).features),
                                      dataset.targets.subset(inds))

        def consensus_metric(groups):
            return self.consensus_metric(dataset.subset(indices_from_groups(indexer, groups)), model)

        return RansacFunctions(fitter, inlier_metric, consensus_metric)


def DefaultRansacStrategy():
    return GenericRansacStrategy(NegativeLogLikelihood(JointDistribution),
                                 LeaveOneOutLikelihood(JointDistribution), LeaveOneOutGrouper())


# ---------------------------------------------------------------------------
# GP strategy: candidate fits condition one precomputed prior
# ---------------------------------------------------------------------------
class DifferentialEntropyConsensusMetric:
    def __call__(self, prior: JointDistribution, truth) -> float:
        return float(differential_entropy(prior.covariance))


class FeatureCountConsensusMetric:
    def __call__(self, prior, truth: MarginalDistribution) -> float:
        return -float(truth.size)


class ChiSquaredConsensusMetric:
    def __call__(self, prior: JointDistribution, truth) -> float:
        cov = prior.covariance + torch.diag(truth.get_variance())
        return float(chi_squared_cdf(prior.mean - truth.mean, cov))


class ChiSquaredIsValidCandidateMetric:
    def __init__(self, threshold: float = DEFAULT_CHI_SQUARED_THRESHOLD):
        self.threshold = threshold

    def __call__(self, pred: JointDistribution, truth) -> bool:
        cov = pred.covariance + torch.diag(truth.get_variance())
        return float(chi_squared_cdf(pred.mean - truth.mean, cov)) <= self.threshold


class AlwaysAcceptCandidateMetric:
    def __call__(self, pred, truth) -> bool:
        return True


class GaussianProcessRansacStrategy:
    def __init__(self, inlier_metric=None, consensus_metric=None, is_valid_candidate=None, grouper=None):
        self.inlier_metric = inlier_metric or NegativeLogLikelihood(JointDistribution)
        self.consensus_metric = consensus_metric or FeatureCountConsensusMetric()
        self.is_valid_candidate = is_valid_candidate or AlwaysAcceptCandidateMetric()
        self.grouper = grouper or LeaveOneOutGrouper()

    def get_indexer(self, dataset: RegressionDataset) -> Grouped:
        return group_by(dataset, self.grouper).indexers()

    def __call__(self, model, dataset: RegressionDataset) -> RansacFunctions:
        indexer = self.get_indexer(dataset)
        conditional = ConditionalGaussian(model.prior(dataset.features), dataset.targets)

        def fitter(groups):
            return conditional.fit_from_indices(indices_from_groups(indexer, groups))

        def inlier_metric(group, fit):
            inds = indexer[group]
            return self.inlier_metric(conditional._predict_joint(inds, fit), conditional.get_truth(inds))

        def consensus_metric(groups):
            inds = indices_from_groups(indexer, groups)
            return self.consensus_metric(conditional.get_prior(inds), conditional.get_truth(inds))

        def is_valid(groups):
            inds = indices_from_groups(indexer, groups)
            return self.is_valid_candidate(conditional.get_prior(inds), conditional.get_truth(inds))

        return RansacFunctions(fitter, inlier_metric, consensus_metric, is_valid)


def DefaultGPRansacStrategy():
    return GaussianProcessRansacStrategy()


def gp_ransac_strategy(inlier_metric, consensus_metric, grouper, is_valid_candidate=None):
    return GaussianProcessRansacStrategy(inlier_metric, consensus_metric, is_valid_candidate, grouper)


# ---------------------------------------------------------------------------
# Batched GP-RANSAC
# ---------------------------------------------------------------------------
def _candidate_factors(conditional: ConditionalGaussian, cand_indices: np.ndarray):
    """Every candidate's conditioning at once: the prior covariance of its
    s u rows plus the truth variance, (D, s u, s u), through one batched
    Cholesky (a matrix that does not factor gives a NaN factor, as in the
    serial path); with the rows as an index tensor and the whitened
    deviation truth - prior, (D, s u)."""
    prior, truth = conditional.prior, conditional.truth
    idx = torch.as_tensor(cand_indices, device=prior.mean.device)
    cov = prior.covariance[idx[:, :, None], idx[:, None, :]]
    cov = 0.5 * (cov + cov.transpose(1, 2)) + torch.diag_embed(truth.get_variance()[idx])
    L = cholesky(cov)
    deviation = (truth.mean[idx] - prior.mean[idx])[..., None]
    white = torch.linalg.solve_triangular(L, deviation, upper=False)
    return idx, L, white


def batched_inlier_metrics(conditional: ConditionalGaussian, cand_indices: np.ndarray,
                           idx_mat: np.ndarray) -> torch.Tensor:
    """(K, G) joint negative log likelihoods of each of the G groups
    (``idx_mat``, (G, u) row indices) under each of the K candidate
    conditionings (``cand_indices``, (K, s u)), on the prior's device."""
    return _scores(conditional, _candidate_factors(conditional, cand_indices), idx_mat)


def _scores(conditional: ConditionalGaussian, factors, idx_mat: np.ndarray) -> torch.Tensor:
    prior, truth = conditional.prior, conditional.truth
    idx, L, white = factors
    G, u = idx_mat.shape
    gidx = torch.as_tensor(idx_mat.reshape(-1), device=prior.mean.device)
    cross = prior.covariance[idx[:, :, None], gidx[None, None, :]]  # (K, s u, G u)
    V = torch.linalg.solve_triangular(L, cross, upper=False)
    # mean = cross^T K_c^-1 (y_c - m_c) + m_g = V^T (L^-1 (y_c - m_c)) + m_g
    mean = (V.transpose(1, 2) @ white)[..., 0] + prior.mean[gidx]
    deviation = (mean - truth.mean[gidx]).reshape(-1, G, u)
    Vg = V.reshape(V.shape[0], V.shape[1], G, u)
    explained = torch.einsum("kagi,kagj->kgij", Vg, Vg)
    g_rows = gidx.reshape(G, u)
    cov = prior.covariance[g_rows[:, :, None], g_rows[:, None, :]] - explained
    cov = 0.5 * (cov + cov.transpose(-1, -2)) + torch.diag_embed(truth.get_variance()[g_rows])
    Lg = cholesky(cov)
    w = torch.linalg.solve_triangular(Lg, deviation[..., None], upper=False)[..., 0]
    log_det = 2.0 * accurate_sum_of_logs(torch.diagonal(Lg, dim1=-2, dim2=-1), dim=-1)
    return 0.5 * (log_det + torch.sum(w * w, dim=-1) + u * LOG_2PI)


def _batched_validity(white: torch.Tensor, metric) -> np.ndarray:
    """The candidate-validity pass of ``AlwaysAcceptCandidateMetric`` or
    ``ChiSquaredIsValidCandidateMetric``, from the candidates' whitened
    deviations."""
    if type(metric) is AlwaysAcceptCandidateMetric:
        return np.ones(white.shape[0], dtype=bool)
    p = chi_squared_cdf_value(torch.sum(white[..., 0] ** 2, dim=-1), white.shape[1])
    return p.cpu().numpy() <= metric.threshold


def ransac_gp_batched(strategy: GaussianProcessRansacStrategy, model, dataset: RegressionDataset,
                      config: RansacConfig, seed: int = 0) -> Optional[RansacOutput]:
    """The GP strategy's loop with every candidate fit and score batched:
    the same RansacOutput as ``ransac()`` (the same rng draws, audit trail
    and return codes).

    The JAX package falls back to the serial loop when it cannot trace a
    user metric; this port does not trace, so it takes the batched path
    only for the metrics it knows and returns None otherwise (the caller
    then runs the serial loop): the inlier metric must be a
    ``NegativeLogLikelihood`` (joint, as the serial path's predictions
    are), the validity metric ``AlwaysAcceptCandidateMetric`` or
    ``ChiSquaredIsValidCandidateMetric``.  Ragged groups (unequal sizes)
    return None as well.  Consensus metrics run on the host, as in the
    serial loop."""
    if (type(strategy.inlier_metric) is not NegativeLogLikelihood
            or type(strategy.is_valid_candidate) not in (AlwaysAcceptCandidateMetric, ChiSquaredIsValidCandidateMetric)):
        return None
    indexer = strategy.get_indexer(dataset)
    keys = list(indexer.keys())
    if len({len(indexer[k]) for k in keys}) != 1:
        return None
    idx_mat = np.stack([np.asarray(indexer[k]) for k in keys])  # (G, u)

    output = RansacOutput(return_code=RansacReturnCode.FAILURE)
    if _invalid_arguments(config, len(keys)):
        output.return_code = RansacReturnCode.INVALID_ARGUMENTS
        return output
    conditional = ConditionalGaussian(model.prior(dataset.features), dataset.targets)

    # the serial loop's draws: one a pass, at most max_iterations valid and
    # max_failed_candidates invalid ones
    rng = np.random.default_rng(seed)
    draws = np.stack([np.sort(rng.choice(len(keys), size=config.random_sample_size, replace=False))
                      for _ in range(config.max_iterations + max(config.max_failed_candidates, 0))])
    factors = _candidate_factors(conditional, idx_mat[draws].reshape(len(draws), -1))  # (D, s u) rows
    validity = _batched_validity(factors[2], strategy.is_valid_candidate)

    # replay the serial control flow against the validity of each draw
    valid: List = []
    failed = 0
    for d in range(len(draws)):
        if len(valid) >= config.max_iterations:
            break
        iteration = RansacIteration(candidates=[keys[int(p)] for p in draws[d]])
        output.iterations.append(iteration)
        if not validity[d]:
            failed += 1
            if failed >= config.max_failed_candidates:
                output.return_code = RansacReturnCode.EXCEEDED_MAX_FAILED_CANDIDATES
                return output
            continue
        valid.append((d, iteration))

    if valid:
        rows = torch.as_tensor([d for d, _ in valid], device=factors[0].device)
        metrics = _scores(conditional, [t[rows] for t in factors], idx_mat)
        metrics = metrics.cpu().numpy()  # the one read back of all K x G scores
    key_array = np.empty(len(keys), dtype=object)
    for g, key in enumerate(keys):  # element by element: a key may be a tuple
        key_array[g] = key
    for k, (d, iteration) in enumerate(valid):
        # the serial loop's classification in group order, by whole rows
        scored = np.ones(len(keys), dtype=bool)
        scored[draws[d]] = False
        inlier = metrics[k] <= config.inlier_threshold  # NaN is an outlier
        for target, mask in ((iteration.inliers, scored & inlier), (iteration.outliers, scored & ~inlier)):
            target.update(zip(key_array[mask].tolist(), metrics[k][mask].tolist()))
        consensus = iteration.consensus()
        if len(consensus) >= config.min_consensus_size:
            if isinstance(strategy.consensus_metric, FeatureCountConsensusMetric):
                # every group holds idx_mat.shape[1] rows
                iteration.consensus_metric_value = -float(len(consensus) * idx_mat.shape[1])
            else:
                inds = indices_from_groups(indexer, consensus)
                iteration.consensus_metric_value = float(strategy.consensus_metric(
                    conditional.get_prior(inds), conditional.get_truth(inds)))
            _keep_if_best(output, iteration)
    return _finish(output)


# ---------------------------------------------------------------------------
# The meta-model
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class RansacFit:
    """The audit trail and the sub-model refit on the consensus set (None
    when RANSAC failed)."""

    ransac_output: RansacOutput
    fit_model: Optional[FitModel]


class Ransac(ModelBase):
    """``use_batched``: None picks the batched loop for a GP strategy whose
    metrics it knows (else the serial loop), True asks for the batched
    loop (a GP strategy is required), False the serial loop."""

    def __init__(self, sub_model, strategy, config: RansacConfig, seed: int = 0,
                 use_batched: Optional[bool] = None):
        self.sub_model = sub_model
        self.strategy = strategy
        self.config = config
        self.seed = seed
        self.use_batched = use_batched

    @property
    def model_name(self):
        return f"ransac[{self.sub_model.model_name}]"

    def get_params(self):
        return self.sub_model.get_params()

    def _replace_param(self, name, param):
        return self._replace(sub_model=self.sub_model._replace_param(name, param))

    def _fit_impl(self, features, targets) -> RansacFit:
        dataset = RegressionDataset.create(features, targets)
        indexer = self.strategy.get_indexer(dataset)
        output = None
        batchable = isinstance(self.strategy, GaussianProcessRansacStrategy)
        if self.use_batched and not batchable:
            raise ValueError("use_batched requires a GaussianProcessRansacStrategy")
        if batchable and self.use_batched is not False:
            output = ransac_gp_batched(self.strategy, self.sub_model, dataset, self.config, seed=self.seed)
        if output is None:
            functions = self.strategy(self.sub_model, dataset)
            output = ransac(functions, indexer.keys(), self.config, seed=self.seed)
        if not ransac_success(output.return_code):
            return RansacFit(output, None)
        good_inds = indices_from_groups(indexer, output.best.consensus())
        return RansacFit(output, self.sub_model.fit(dataset.subset(good_inds)))

    def _predict_marginal(self, features, fit: RansacFit):
        return self._check(fit).predict(features).marginal()

    def _predict_joint(self, features, fit: RansacFit):
        return self._check(fit).predict(features).joint()

    def _predict_mean(self, features, fit: RansacFit):
        return self._check(fit).predict(features).mean()

    @staticmethod
    def _check(fit: RansacFit) -> FitModel:
        if fit.fit_model is None:
            raise RuntimeError(f"RANSAC failed: {fit.ransac_output.return_code.name}")
        return fit.fit_model
