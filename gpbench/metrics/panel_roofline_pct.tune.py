"""panel_roofline_pct.tune: the port's panel factor + inverse at the
blocked factorization's panel, b = 1024 in f32, CUDA-event time against
its roofline bound."""

from gpbench.readings import tune_panel_roofline as read  # noqa: F401
