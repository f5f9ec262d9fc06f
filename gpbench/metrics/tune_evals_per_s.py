"""tune_evals_per_s: value+grad evaluations of the NLML (exact or sparse)
completed in the window over the time from its start to the end of the
last one completed."""

from gpbench.readings import tune_rate as read  # noqa: F401
