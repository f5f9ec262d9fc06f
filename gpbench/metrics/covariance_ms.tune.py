"""covariance_ms.tune: device milliseconds a tuning step under the port
span ``albatross.covariance``, one evaluation of a covariance function
through the DSL (its metrics' ``albatross.covariance.metric`` inside),
forward and backward (``gpbench/spans.py``); None where the program opens
no such span."""

from gpbench import spans


def read(ctx):
    return spans.device_ms(spans.summary(ctx), "albatross.covariance")
