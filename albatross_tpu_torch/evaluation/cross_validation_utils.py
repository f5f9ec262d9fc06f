"""Fast held-out predictions (LOO / LOGO).

Counterpart of ``albatross_tpu.evaluation.cross_validation_utils``.  With
the full training covariance A factorized once, group g's held-out
prediction comes from the diagonal blocks of the inverse,

    mean_g = y_g - ((A^-1)_gg)^-1 v_g        cov_g = ((A^-1)_gg)^-1

(v = A^-1 y, the information vector).  Three paths, as in the JAX package:
leave-one-out without a joint is fully vectorized (variance =
1 / diag(A^-1)); groups of one size take one batched Cholesky of the
stacked blocks (``torch.linalg.cholesky`` + ``torch.cholesky_solve``);
ragged groups go one by one.  Index arrays are built on the host and go to
the device once.
"""

from __future__ import annotations

from typing import Type

import numpy as np
import torch

from ..core.distributions import JointDistribution, MarginalDistribution
from ..indexing.grouping import Grouped
from ..ops.blocked_cholesky import cholesky
from ..ops.linalg import CholeskyFactor


class BatchedGrouped(Grouped):
    """Array-backed Grouped: stacked per-group tensors are the storage, and
    per-group distribution objects are made only on mapping access."""

    def __init__(self, keys, means, variances=None, covariances=None, predict_type=None):
        self._keys_list = list(keys)
        self.means = means  # (G, b)
        self.variances = variances  # (G, b) | None
        self.covariances = covariances  # (G, b, b) | None
        self.predict_type = predict_type
        self._materialized = None

    def value_at(self, i: int):
        if self.predict_type is MarginalDistribution:
            return MarginalDistribution(self.means[i], self.variances[i])
        if self.predict_type is JointDistribution:
            return JointDistribution(self.means[i], self.covariances[i])
        return self.means[i]

    @property
    def _data(self):
        if self._materialized is None:
            self._materialized = {k: self.value_at(i) for i, k in enumerate(self._keys_list)}
        return self._materialized

    # mapping views that do not materialize
    def keys(self):
        return list(self._keys_list)

    def __len__(self):
        return len(self._keys_list)

    def __iter__(self):
        return iter(self._keys_list)

    def __contains__(self, key):
        return key in self._keys_list

    def __repr__(self):
        return f"BatchedGrouped(n_groups={len(self._keys_list)})"


def _index_matrix(indexers: Grouped, device) -> torch.Tensor:
    """The (G, b) index matrix of groups of one size, on ``device``."""
    return torch.as_tensor(np.stack(indexers.values()), device=device)


def leave_one_out_conditional_variance(chol: CholeskyFactor) -> torch.Tensor:
    """1 / diag(A^-1)."""
    return 1.0 / chol.inverse_diagonal()


def leave_one_out_conditional(prior: JointDistribution, truth: MarginalDistribution) -> MarginalDistribution:
    """The conditional of each variable given all the others."""
    chol = CholeskyFactor.factorize(prior.covariance + torch.diag(truth.get_variance()))
    loo_variance = leave_one_out_conditional_variance(chol)
    loo_mean = truth.mean - chol.solve(truth.mean - prior.mean) * loo_variance
    return MarginalDistribution(loo_mean, loo_variance)


def _grouped_inverse_blocks(chol, indexers: Grouped):
    """((A^-1)_gg by key, or None; the stacked (G, b, b) blocks and the
    (G, b) index matrix when the groups have one size, else None, None)."""
    if not isinstance(chol, CholeskyFactor):
        # another representation: its own inverse_blocks
        blocks = chol.inverse_blocks(list(indexers.values()))
        return dict(zip(indexers.keys(), blocks)), None, None
    Linv = chol._tri_inverse()
    if len({len(idx) for idx in indexers.values()}) == 1:
        idx_mat = _index_matrix(indexers, Linv.device)
        cols = Linv[:, idx_mat]  # (n, G, b)
        return None, torch.einsum("ngb,ngc->gbc", cols, cols), idx_mat
    out = {}
    for key, idx in indexers.items():
        cols = Linv[:, torch.as_tensor(idx, device=Linv.device)]
        out[key] = cols.T @ cols
    return out, None, None


def held_out_predictions(
    train_covariance: CholeskyFactor,
    target_mean: torch.Tensor,
    information: torch.Tensor,
    indexers: Grouped,
    predict_type: Type = MarginalDistribution,
) -> Grouped:
    """Each group's held-out prediction.  ``target_mean`` is the raw target
    mean: the information vector already accounts for the mean function."""
    sizes = {len(idx) for idx in indexers.values()}

    # -- leave-one-out, fully vectorized ------------------------------------
    if predict_type is not JointDistribution and sizes == {1}:
        variance = 1.0 / train_covariance.inverse_diagonal()
        order = torch.as_tensor(np.concatenate(indexers.values()), device=information.device)
        var_o = variance[order]
        mean = target_mean[order] - information[order] * var_o
        return BatchedGrouped(indexers.keys(), mean[:, None],
                              variances=var_o[:, None] if predict_type is MarginalDistribution else None,
                              predict_type=predict_type)

    blocks, stacked, idx_mat = _grouped_inverse_blocks(train_covariance, indexers)

    # -- groups of one size: one batched factorization ---------------------
    if stacked is not None:
        Lb = cholesky(stacked)  # (G, b, b)
        means = target_mean[idx_mat] - torch.cholesky_solve(information[idx_mat][..., None], Lb)[..., 0]
        eye = torch.eye(Lb.shape[-1], dtype=Lb.dtype, device=Lb.device).expand_as(Lb)
        invs = torch.cholesky_solve(eye, Lb)
        if predict_type is JointDistribution:
            return BatchedGrouped(indexers.keys(), means, covariances=invs, predict_type=JointDistribution)
        variances = torch.diagonal(invs, dim1=1, dim2=2) if predict_type is MarginalDistribution else None
        return BatchedGrouped(indexers.keys(), means, variances=variances, predict_type=predict_type)

    # -- ragged groups, one by one ------------------------------------------
    out = {}
    for key, idx in indexers.items():
        idx = torch.as_tensor(idx, device=information.device)
        bchol = CholeskyFactor.factorize(blocks[key])
        mean = target_mean[idx] - bchol.solve(information[idx])
        if predict_type is JointDistribution:
            out[key] = JointDistribution(mean, bchol.inverse())
        elif predict_type is MarginalDistribution:
            out[key] = MarginalDistribution(mean, bchol.inverse_diagonal())
        else:
            out[key] = mean
    return Grouped(out)


def leave_one_group_out_conditional(
    prior: JointDistribution,
    truth: MarginalDistribution,
    indexers: Grouped,
    predict_type: Type = MarginalDistribution,
) -> Grouped:
    """Each group's conditional given all the other groups."""
    chol = CholeskyFactor.factorize(prior.covariance + torch.diag(truth.get_variance()))
    information = chol.solve(truth.mean - prior.mean)
    return held_out_predictions(chol, truth.mean, information, indexers, predict_type)


def cross_validated_scores(metric, folds: Grouped, predictions: Grouped) -> torch.Tensor:
    """The metric of each fold's prediction against its test targets."""
    scores = [metric(predictions[key], fold.test_dataset.targets) for key, fold in folds.items()]
    return torch.stack([torch.as_tensor(s) for s in scores])


def batched_cross_validated_scores(metric, dataset, indexers: Grouped, predictions: BatchedGrouped):
    """Every fold's score in one ``torch.func.vmap`` over the stacked
    predictions, in the sorted key order of cross_validated_scores.  None
    when the groups differ in size, or when the metric has an operation
    without a vmap rule (the caller then scores fold by fold)."""
    if len({len(idx) for idx in indexers.values()}) != 1:
        return None
    means = predictions.means
    idx_mat = _index_matrix(indexers, means.device)
    t_mean = dataset.targets.mean[idx_mat]  # (G, b)
    t_var = dataset.targets.get_variance()[idx_mat]
    variances = predictions.variances if predictions.variances is not None else torch.zeros_like(means)
    covs = predictions.covariances
    if covs is None:
        covs = means.new_zeros(means.shape + means.shape[-1:])
    pt = predictions.predict_type

    def one(mean, var, cov, tm, tv):
        if pt is JointDistribution:
            pred = JointDistribution(mean, cov)
        elif pt is MarginalDistribution:
            pred = MarginalDistribution(mean, var)
        else:
            pred = mean
        return metric(pred, MarginalDistribution(tm, tv))

    try:
        return torch.func.vmap(one)(means, variances, covs, t_mean, t_var)
    except RuntimeError:  # torch's error for an operation with no batching rule
        return None
