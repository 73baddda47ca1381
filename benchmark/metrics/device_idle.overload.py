"""Share of the traced window with no kernel or copy on the card, %, from
the profiler's device events."""

from benchmark.readers import idle_pct


def read(run):
    return idle_pct(run)
