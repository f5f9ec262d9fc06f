"""gram_roofline_pct.tune: the port's gram entry at the covariance that
the tuning step builds (``models/<model>.py``'s ``training_gram``: the
(N, N) training covariance with its diagonal in the exact GP, K_fu in
FITC), CUDA-event time against its roofline bound."""

from gpbench.readings import tune_gram_roofline as read  # noqa: F401
