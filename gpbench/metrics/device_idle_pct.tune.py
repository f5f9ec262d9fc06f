"""device_idle_pct.tune: the share of a traced span of tuning steps in
which no operation ran on the card."""

from gpbench.readings import tune_idle as read  # noqa: F401
