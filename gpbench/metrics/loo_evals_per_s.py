"""loo_evals_per_s: value+grad evaluations of the leave-one-out objective
completed in the window over the time from its start to the end of the
last one completed.  Apart from ``tune_evals_per_s`` so that each holds a
bound that fits its own spread."""

from gpbench.readings import tune_rate as read  # noqa: F401
