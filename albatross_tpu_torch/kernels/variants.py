"""Mixed (variant) feature kinds as tagged batches.

Counterpart of ``albatross_tpu.kernels.variants``.  A ``TaggedBatch``
keeps one dense sub-batch per tag plus the permutation back to the user's
interleaved order.  A gram over mixed features is assembled from per-tag
blocks, each an ordinary batched kernel call; a block the kernel leaves
undefined is a zero block (variant semantics, not the error of a wholly
undefined call).  Tags flow through the composition tree by
``_tagged_matrix`` (kernels/base.py): plain kernels apply to every tag,
``ForTag`` restricts a term to some.  The bookkeeping (tags, order, index
arithmetic) lives on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from ..core.dataset import feature_count, float_like, host_array, subset_features
from .base import CovarianceFunction


@dataclasses.dataclass(frozen=True, eq=False)
class TaggedBatch:
    """Per-tag dense sub-batches and the inverse permutation.

    ``features[i]`` holds the rows whose tag is ``tags[i]``, in their
    original relative order; ``order[p]`` is the interleaved position of
    row p of the concatenated sub-batches."""

    tags: Tuple[int, ...]
    features: Tuple[Any, ...]
    order: Tuple[int, ...]

    @property
    def size(self) -> int:
        return len(self.order)

    def counts(self) -> Tuple[int, ...]:
        return tuple(feature_count(f) for f in self.features)

    def inverse_order(self, device) -> torch.Tensor:
        """argsort(order) as an index tensor on ``device``: row p of the
        interleaved batch is row inverse_order[p] of the concatenated
        sub-batches.  Built once a device and kept."""
        cache = self.__dict__.setdefault("_inverse_order", {})
        device = torch.device(device)
        if device not in cache:
            cache[device] = torch.as_tensor(np.argsort(np.asarray(self.order)), device=device)
        return cache[device]

    @classmethod
    def create(cls, tag_array, features_by_tag: Dict[int, Any]) -> "TaggedBatch":
        """From an (N,) tag array and per-tag feature batches whose rows
        are, in order, that tag's occurrences."""
        tag_array = host_array(tag_array)
        tags = tuple(sorted(features_by_tag))
        order: list = []
        for t in tags:
            order.extend(np.nonzero(tag_array == t)[0].tolist())
        if len(order) != tag_array.shape[0]:
            raise ValueError("features_by_tag does not cover every tag value")
        return cls(tags, tuple(features_by_tag[t] for t in tags), tuple(order))

    @classmethod
    def concatenate(cls, batches: Sequence["TaggedBatch"]) -> "TaggedBatch":
        """Row-concatenate tagged batches, keeping the interleaved order
        (so an online update may mix feature kinds)."""
        all_tags = tuple(sorted(set().union(*(set(b.tags) for b in batches))))
        feats: Dict[int, list] = {t: [] for t in all_tags}
        orders: Dict[int, list] = {t: [] for t in all_tags}
        offset = 0
        for b in batches:
            start = 0
            for t, f in zip(b.tags, b.features):
                n = feature_count(f)
                feats[t].append(f)
                orders[t].extend(offset + p for p in b.order[start:start + n])
                start += n
            offset += b.size
        merged = tuple(parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
                       for parts in (feats[t] for t in all_tags))
        return cls(all_tags, merged, tuple(p for t in all_tags for p in orders[t]))

    def subset(self, indices) -> "TaggedBatch":
        """The rows at interleaved positions ``indices`` (host index
        arithmetic: the result's structure depends on them)."""
        idx = np.asarray(indices, dtype=np.int64).reshape(-1)
        order = np.asarray(self.order, dtype=np.int64)
        pos_of_original = np.empty(order.shape[0], dtype=np.int64)
        pos_of_original[order] = np.arange(order.shape[0])
        positions = pos_of_original[idx]
        offsets = np.concatenate([[0], np.cumsum(self.counts())])
        tags, features, kept = [], [], []
        for i, tag in enumerate(self.tags):
            in_tag = (positions >= offsets[i]) & (positions < offsets[i + 1])
            if not in_tag.any():
                continue
            tags.append(tag)
            features.append(subset_features(self.features[i], positions[in_tag] - offsets[i]))
            kept.append(np.nonzero(in_tag)[0])
        new_order = np.concatenate(kept) if kept else np.zeros(0, dtype=np.int64)
        return TaggedBatch(tuple(tags), tuple(features), tuple(int(p) for p in new_order))


class ForTag(CovarianceFunction):
    """Restrict a kernel term to some variant tags."""

    def __init__(self, sub: CovarianceFunction, tags: Sequence[int]):
        self.sub = sub
        self.for_tags = tuple(sorted(tags))

    @property
    def name(self):
        return f"for_tags{list(self.for_tags)}[{self.sub.name}]"

    def _matrix(self, X, Y, x_meas, y_meas):
        # an untagged call: the sub-kernel applies to its plain features
        return self.sub._matrix(X, Y, x_meas, y_meas)

    def _tagged_matrix(self, X, Y, tx, ty, x_meas, y_meas):
        if (tx is not None and tx not in self.for_tags) or (ty is not None and ty not in self.for_tags):
            return None
        return self.sub._tagged_matrix(X, Y, tx, ty, x_meas, y_meas)

    def _diag(self, X, x_meas):
        return self.sub._diag(X, x_meas)

    def _tagged_diag(self, X, tx, x_meas):
        if tx is not None and tx not in self.for_tags:
            return None
        return self.sub._tagged_diag(X, tx, x_meas)

    def _symmetric_exact(self, X):
        return self.sub._symmetric_exact(X)


def for_tag(sub: CovarianceFunction, *tags: int) -> ForTag:
    return ForTag(sub, tags)


def tagged_gram(kernel: CovarianceFunction, X: TaggedBatch, Y, x_meas, y_meas):
    """The covariance over tagged batches from per-tag-pair blocks, with a
    zero block where a pair is undefined, in interleaved order (one
    index_select an axis).  A zero block takes the dtype and device of the
    computed blocks."""
    y_tagged = isinstance(Y, TaggedBatch)
    y_items = list(zip(Y.tags, Y.features)) if y_tagged else [(None, Y)]
    blocks = [[kernel._tagged_matrix(fx, fy, tx, ty, x_meas, y_meas) for ty, fy in y_items]
              for tx, fx in zip(X.tags, X.features)]
    like = next((b for row in blocks for b in row if b is not None), None)
    like = float_like(X) if like is None else {"dtype": like.dtype, "device": like.device}
    rows = []
    for fx, row in zip(X.features, blocks):
        rows.append(torch.cat([torch.zeros((feature_count(fx), feature_count(fy)), **like) if b is None else b
                               for (_, fy), b in zip(y_items, row)], dim=1))
    stacked = torch.cat(rows, dim=0).index_select(0, X.inverse_order(like["device"]))
    if y_tagged:
        stacked = stacked.index_select(1, Y.inverse_order(like["device"]))
    return stacked


def tagged_diag(kernel: CovarianceFunction, X: TaggedBatch, x_meas):
    parts = [kernel._tagged_diag(fx, tx, x_meas) for tx, fx in zip(X.tags, X.features)]
    like = next((p for p in parts if p is not None), None)
    like = float_like(X) if like is None else {"dtype": like.dtype, "device": like.device}
    stacked = torch.cat([torch.zeros((feature_count(fx),), **like) if p is None else p
                         for fx, p in zip(X.features, parts)])
    return stacked.index_select(0, X.inverse_order(like["device"]))


def concatenate_mixed_datasets(datasets, tags=None):
    """Datasets of different feature kinds as one tagged dataset (``tags``
    assigns each dataset its variant tag, 0..k-1 by default)."""
    from ..core.dataset import RegressionDataset
    from ..core.distributions import concatenate_marginals

    if tags is None:
        tags = list(range(len(datasets)))
    if len(set(tags)) != len(tags):
        raise ValueError("tags must be distinct per dataset")
    tag_array = np.concatenate([np.full(d.size, t) for d, t in zip(datasets, tags)])
    batch = TaggedBatch.create(tag_array, {t: d.features for t, d in zip(tags, datasets)})
    metadata = {}
    for d in datasets:
        metadata.update(d.metadata)
    return RegressionDataset(batch, concatenate_marginals([d.targets for d in datasets]), metadata)
