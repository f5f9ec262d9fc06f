"""Parameter priors: the closed forms of ``albatross_tpu.core.priors``.

Each prior gives ``log_pdf`` on a tensor (or float), its bounds, and the
``is_fixed`` / ``is_log_scale`` flags of the tunable-vector round trip.
Priors are immutable, hashable dataclasses.
"""

from __future__ import annotations

import dataclasses
import math

import torch

LOG_2 = 0.6931471805599453
LOG_2PI = 1.8378770664093453
LARGE_VAL = float("inf")
# std::numeric_limits<double>::epsilon(): the PositivePrior lower bound.
EPSILON = 2.220446049250313e-16


def _as_float_tensor(x) -> torch.Tensor:
    """A tensor as it is (integers to the default dtype); a Python or numpy
    number as f64, the JAX package's 64-bit mode (a default-dtype f32 would
    round a log-pdf such as -log(1.8e308) at the sixth digit)."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, dtype=torch.float64)
    return x if x.is_floating_point() else x.to(torch.get_default_dtype())


@dataclasses.dataclass(frozen=True)
class Prior:
    """Base prior: uninformative, unbounded."""

    def log_pdf(self, x) -> torch.Tensor:
        return torch.zeros_like(_as_float_tensor(x))

    @property
    def lower_bound(self) -> float:
        return -LARGE_VAL

    @property
    def upper_bound(self) -> float:
        return LARGE_VAL

    @property
    def is_log_scale(self) -> bool:
        return False

    @property
    def is_fixed(self) -> bool:
        return False

    @property
    def name(self) -> str:
        return "uninformative"


class UninformativePrior(Prior):
    pass


class FixedPrior(Prior):
    @property
    def is_fixed(self) -> bool:
        return True

    @property
    def name(self) -> str:
        return "fixed"


def _zero_or_neg_inf(inside: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return torch.where(
        inside, torch.zeros_like(like), torch.full_like(like, -LARGE_VAL)
    )


class PositivePrior(Prior):
    """log_pdf 0 for x>0, -inf otherwise; lower bound = machine epsilon."""

    def log_pdf(self, x):
        x = _as_float_tensor(x)
        return _zero_or_neg_inf(x > 0.0, x)

    @property
    def lower_bound(self) -> float:
        return EPSILON

    @property
    def name(self) -> str:
        return "positive"


class NonNegativePrior(Prior):
    def log_pdf(self, x):
        x = _as_float_tensor(x)
        return _zero_or_neg_inf(x >= 0.0, x)

    @property
    def lower_bound(self) -> float:
        return 0.0

    @property
    def name(self) -> str:
        return "non_negative"


@dataclasses.dataclass(frozen=True)
class UniformPrior(Prior):
    lower: float = 0.0
    upper: float = 1.0

    def __post_init__(self):
        if not self.upper > self.lower:
            raise ValueError("UniformPrior requires upper > lower")

    def log_pdf(self, x):
        x = _as_float_tensor(x)
        inside = (x >= self.lower) & (x <= self.upper)
        return torch.where(
            inside,
            torch.full_like(x, -math.log(self.upper - self.lower)),
            torch.full_like(x, -LARGE_VAL),
        )

    @property
    def lower_bound(self) -> float:
        return self.lower

    @property
    def upper_bound(self) -> float:
        return self.upper

    @property
    def name(self) -> str:
        return f"uniform[{self.lower},{self.upper}]"


@dataclasses.dataclass(frozen=True)
class LogScaleUniformPrior(UniformPrior):
    """Uniform prior whose parameter is tuned in log space."""

    lower: float = 1e-12
    upper: float = 1e12

    def __post_init__(self):
        super().__post_init__()
        if not (self.lower > 0.0 and self.upper > 0.0):
            raise ValueError("LogScaleUniformPrior requires positive bounds")

    @property
    def is_log_scale(self) -> bool:
        return True

    @property
    def name(self) -> str:
        return f"log_scale_uniform[{self.lower},{self.upper}]"


@dataclasses.dataclass(frozen=True)
class GaussianPrior(Prior):
    mu: float = 0.0
    sigma: float = 1.0

    def log_pdf(self, x):
        x = _as_float_tensor(x)
        deviation = (x - self.mu) / self.sigma
        # the reference expression, idiosyncratic normalization included
        return -0.5 * (LOG_2PI * 2.0 * math.log(self.sigma) + deviation * deviation)

    @property
    def name(self) -> str:
        return f"gaussian[{self.mu},{self.sigma}]"


@dataclasses.dataclass(frozen=True)
class PositiveGaussianPrior(Prior):
    """Half-normal: gaussian log-pdf + log(2), bounds [0, 10 sigma]."""

    mu: float = 0.0
    sigma: float = 1.0

    def log_pdf(self, x):
        x = _as_float_tensor(x)
        deviation = (x - self.mu) / self.sigma
        return (
            -0.5 * (LOG_2PI * 2.0 * math.log(self.sigma) + deviation * deviation)
            + LOG_2
        )

    @property
    def lower_bound(self) -> float:
        return 0.0

    @property
    def upper_bound(self) -> float:
        return 10.0 * self.sigma

    @property
    def name(self) -> str:
        return f"positive_gaussian[{self.mu},{self.sigma}]"


@dataclasses.dataclass(frozen=True)
class LogNormalPrior(Prior):
    mu: float = 0.0
    sigma: float = 1.0

    def log_pdf(self, x):
        x = _as_float_tensor(x)
        deviation = (torch.log(x) - self.mu) / self.sigma
        return (
            -0.5 * LOG_2PI
            - math.log(self.sigma)
            - torch.log(x)
            - deviation * deviation
        )

    @property
    def name(self) -> str:
        return f"log_normal[{self.mu},{self.sigma}]"


PRIOR_TYPES = (
    UninformativePrior,
    FixedPrior,
    NonNegativePrior,
    PositivePrior,
    UniformPrior,
    LogScaleUniformPrior,
    GaussianPrior,
    LogNormalPrior,
    PositiveGaussianPrior,
)
