"""Virtual clock for the simulated control plane.

Everything time-dependent (TerminationDelay gang termination, breach
persistence, rolling-update timestamps) reads this clock, so tests can
advance hours in microseconds — the reference's 4h default TerminationDelay
(defaulting/podcliqueset.go:31) is untestable against a wall clock.
"""

from __future__ import annotations


class SimClock:
    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def now(self) -> float:
        return self._now

    def advance(self, seconds: float) -> float:
        if seconds < 0:  # explicit: must survive python -O
            raise ValueError("time only moves forward")
        self._now += seconds
        return self._now
