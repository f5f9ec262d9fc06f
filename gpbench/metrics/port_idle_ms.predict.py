"""port_idle_ms.predict: milliseconds a predict batch that the card stood
idle in gaps whose middle lies inside a port span (in a backward node, by
its forward's spans): the port's host code between launches
(``gpbench/spans.py``)."""

from gpbench import spans


def read(ctx):
    return spans.port_idle_ms(spans.summary(ctx))
