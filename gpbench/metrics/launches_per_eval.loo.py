"""launches_per_eval.loo: kernels launched on the card a tuning step, by
the profiler's count over the traced span (copies and sets left out):
every kernel of the step, the factorization's, the gram's, the QR's and
the backward's alike."""

from gpbench.readings import tune_launches as read  # noqa: F401
