"""K3's share of its roofline, %: the least time its work needs on the card
(roofline.py, from the solves' shapes) over its device time in the
profiler."""

from benchmark.readers import roofline_pct


def read(run):
    return roofline_pct(run, "k3")
