"""Quantiles, tails and spreads, as the benchmark reports them."""

from __future__ import annotations

import math


def quantile(values, q: float) -> float:
    """The nearest-rank q-quantile: the smallest value with at least a
    share q of the values at or below it."""
    xs = sorted(values)
    if not xs:
        raise ValueError("quantile of no values")
    return float(xs[max(0, math.ceil(q * len(xs)) - 1)])


def tail(latencies, missing, q: float) -> float:
    """The q-quantile over every request: `latencies` of those answered,
    and `missing`, one lower bound a request never answered (the time it
    had waited when the count closed), so each sits where its wait put
    it, above any limit it missed."""
    return quantile(list(latencies) + list(missing), q)


def rate(count: int, seconds: float) -> float:
    """Work over all the seconds of the window."""
    return count / seconds
