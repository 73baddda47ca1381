"""In-framework metrics: counters, gauges, histograms + Prometheus text.

The counterpart of grove_tpu/observability/metrics.py, copied whole. It
imports nothing of grove_tpu, so the two packages' objects compare field
by field.

Parity target: the reference exposes controller-runtime's default
Prometheus endpoint (manager.go:94-96) but defines no scheduler metrics of
its own. Here the registry carries the framework's north-star numbers —
gangs scheduled/sec, backlog bind latency, placement-score distribution,
repair fallbacks — fed by GangScheduler and PlacementEngine and consumed
by bench.py (the driver metric) and tests.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field


def _label_key(labels: dict[str, str] | None) -> tuple:
    return tuple(sorted((labels or {}).items()))


@dataclass
class Counter:
    name: str
    help: str = ""
    _values: dict[tuple, float] = field(default_factory=dict)

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = _label_key(labels)
        self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def remove(self, **labels: str) -> bool:
        """Drop one label series from the exposition (Gauge parity).
        Counters are cumulative by contract — only remove a series whose
        OWNING OBJECT is gone (a deleted node's per-node series), never
        to reset a live one. Returns whether the series existed."""
        return self._values.pop(_label_key(labels), None) is not None

    def label_sets(self) -> list[dict[str, str]]:
        """The label set of every live series (Gauge parity: public
        enumeration for owners reconciling per-object series)."""
        return [dict(key) for key in self._values]

    def total(self) -> float:
        return sum(self._values.values())


@dataclass
class Gauge:
    name: str
    help: str = ""
    _values: dict[tuple, float] = field(default_factory=dict)

    def set(self, value: float, **labels: str) -> None:
        self._values[_label_key(labels)] = value

    def value(self, **labels: str) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def remove(self, **labels: str) -> bool:
        """Drop one label series so /metrics stops exporting it — the
        per-object-series hygiene call (a deleted node's lifecycle
        series must not linger forever). Returns whether it existed."""
        return self._values.pop(_label_key(labels), None) is not None

    def label_sets(self) -> list[dict[str, str]]:
        """The label set of every live series (public enumeration for
        owners reconciling per-object series after a restart)."""
        return [dict(key) for key in self._values]


@dataclass
class Histogram:
    """Bounded-memory histogram with label support. observe() is O(1)
    append; the sort is deferred to the first percentile read after new
    observations, so per-gang latency observation stays cheap at
    10^5-gang scale (reads are rare — bench/render time — writes are the
    hot path). Label-less usage reads/writes the () series.

    Memory bound: each label series retains at most `max_observations`
    raw samples. Below the cap percentiles are EXACT; at the cap the
    series switches to deterministic reservoir downsampling (Algorithm R
    driven by a per-series LCG seeded from the label key — replayable,
    no `random` module), so percentiles become a uniform-sample estimate
    while `count`/`sum`/`mean` stay exact via separate accumulators.
    `reset()` drops all series for long-lived harnesses."""

    name: str
    help: str = ""
    #: per-series raw-sample cap; at 10^5-gang scale the bind-latency
    #: series would otherwise grow one float per gang forever
    max_observations: int = 65536
    _series: dict[tuple, list[float]] = field(default_factory=dict)
    _dirty: set = field(default_factory=set)
    #: exact per-series totals (survive downsampling)
    _counts: dict[tuple, int] = field(default_factory=dict)
    _sums: dict[tuple, float] = field(default_factory=dict)
    #: per-series LCG state for the deterministic reservoir
    _rng: dict[tuple, int] = field(default_factory=dict)

    def observe(self, value: float, **labels: str) -> None:
        key = _label_key(labels)
        n = self._counts.get(key, 0)
        self._counts[key] = n + 1
        self._sums[key] = self._sums.get(key, 0.0) + value
        obs = self._series.get(key)
        if obs is None:
            obs = self._series[key] = []
        if len(obs) < self.max_observations:
            obs.append(value)
            self._dirty.add(key)
            return
        # reservoir: keep each of the n+1 samples with equal probability,
        # driven by a deterministic per-series LCG (MMIX constants)
        state = self._rng.get(key)
        if state is None:
            state = zlib.crc32(repr(key).encode()) or 1
        state = (state * 6364136223846793005 + 1442695040888963407) % (1 << 64)
        self._rng[key] = state
        j = state % (n + 1)
        if j < self.max_observations:
            obs[j] = value
            self._dirty.add(key)

    def reset(self) -> None:
        """Drop every series (long-lived harness hygiene)."""
        self._series.clear()
        self._dirty.clear()
        self._counts.clear()
        self._sums.clear()
        self._rng.clear()

    def remove(self, **labels: str) -> bool:
        """Drop one label series from the exposition (Counter/Gauge
        parity). Only remove a series whose OWNING OBJECT is gone — a
        torn-down tenant's latency series — never to reset a live one.
        Returns whether the series existed."""
        key = _label_key(labels)
        existed = self._counts.pop(key, None) is not None
        existed = (self._series.pop(key, None) is not None) or existed
        self._sums.pop(key, None)
        self._rng.pop(key, None)
        self._dirty.discard(key)
        return existed

    def label_sets(self) -> list[dict[str, str]]:
        """The label set of every live series (Counter/Gauge parity:
        public enumeration for owners reconciling per-object series)."""
        return [dict(key) for key in self._counts]

    def is_estimated(self, **labels: str) -> bool:
        """Whether percentiles for this label series are reservoir
        estimates rather than exact: True once more observations have
        arrived than the series retains (past `max_observations`).
        Consumers that alert on percentiles should widen their
        confidence band when this flips."""
        key = _label_key(labels)
        return self._counts.get(key, 0) > len(self._series.get(key, ()))

    def count_over(self, threshold: float, **labels: str) -> int:
        """Observations strictly above `threshold` in one label series.
        Exact below the retention cap; past it, the retained reservoir
        is a uniform sample so the count is scaled up by the true/
        retained ratio (check `is_estimated` to know which you got)."""
        key = _label_key(labels)
        obs = self._series.get(key)
        if not obs:
            return 0
        retained_over = sum(1 for v in obs if v > threshold)
        total = self._counts.get(key, 0)
        if total <= len(obs):
            return retained_over
        return round(retained_over * (total / len(obs)))

    def _obs_for(self, labels: dict[str, str] | None) -> list[float]:
        return self._series.get(_label_key(labels), [])

    @property
    def count(self) -> int:
        return sum(self._counts.values())

    def series_count(self, **labels: str) -> int:
        """Observation count of ONE label series (the () series when
        unlabeled) — the public read debug dumps use. Exact even past
        the retention cap."""
        return self._counts.get(_label_key(labels), 0)

    @property
    def sum(self) -> float:
        return float(sum(self._sums.values()))

    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, q: float, **labels: str) -> float:
        """q in [0, 100]; nearest-rank on the sorted retained
        observations of one label series (the () series when unlabeled).
        Exact below max_observations, reservoir estimate past it."""
        key = _label_key(labels)
        obs = self._series.get(key)
        if not obs:
            return 0.0
        if key in self._dirty:
            obs.sort()
            self._dirty.discard(key)
        idx = min(len(obs) - 1, max(0, round(q / 100 * (len(obs) - 1))))
        return obs[int(idx)]


class MetricsRegistry:
    def __init__(self):
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_make(name, Counter, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_make(name, Gauge, help)

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get_or_make(name, Histogram, help)

    def _get_or_make(self, name, cls, help):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name=name, help=help)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}")
        return m

    def get(self, name: str):
        return self._metrics.get(name)

    def render(self) -> str:
        """Prometheus text exposition (the /metrics endpoint analog).
        Label values (quantile labels included — they flow through the
        same _fmt_labels path) and HELP text are escaped per the
        Prometheus text-format spec."""
        lines: list[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {_escape_help(m.help)}")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {name} counter")
                for key, v in sorted(m._values.items()):
                    lines.append(f"{name}{_fmt_labels(key)} {v}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {name} gauge")
                for key, v in sorted(m._values.items()):
                    lines.append(f"{name}{_fmt_labels(key)} {v}")
            else:
                lines.append(f"# TYPE {name} summary")
                for key in sorted(m._series):
                    labels = dict(key)
                    # quantiles past the retention cap are reservoir
                    # estimates — say so in the exposition rather than
                    # letting scrapers silently trust a sample
                    estimated = m.is_estimated(**labels)
                    for q in (50, 90, 99):
                        qlabels = {**labels, "quantile": f"0.{q}"}
                        if estimated:
                            qlabels["estimated"] = "true"
                        qk = _fmt_labels(tuple(sorted(qlabels.items())))
                        lines.append(f"{name}{qk} {m.percentile(q, **labels)}")
                    lines.append(
                        f"{name}_sum{_fmt_labels(key)} {m._sums[key]}"
                    )
                    lines.append(
                        f"{name}_count{_fmt_labels(key)} {m._counts[key]}"
                    )
        return "\n".join(lines) + ("\n" if lines else "")


def _escape_label_value(v: str) -> str:
    """Prometheus text-format label-value escaping: backslash, double
    quote and line feed are the three characters the spec requires."""
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _escape_help(text: str) -> str:
    """HELP text escaping per the spec: backslash and line feed."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_labels(key: tuple) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in key)
    return "{" + inner + "}"
