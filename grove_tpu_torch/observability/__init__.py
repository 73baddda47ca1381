"""Observability: the metrics registry, the span tracer, the decision
log with its unsat diagnosis, the event recorder, the structured logger
and the SLO engine.

The counterpart of grove_tpu/observability/__init__.py.
"""

from .events import ClusterEvent, EventRecorder

from .explain import (
    DecisionLog,
    DecisionRecord,
    UnsatCode,
    UnsatDiagnosis,
    diagnose_unplaced,
    score_decomposition,
    unsat_code,
    unsat_preemptible,
)
from .logging import Logger
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .slo import SLOEngine
from .tracing import NOOP_TRACER, Span, Tracer

__all__ = [
    "ClusterEvent",
    "Counter",
    "DecisionLog",
    "DecisionRecord",
    "Gauge",
    "EventRecorder",
    "Histogram",
    "Logger",
    "MetricsRegistry",
    "NOOP_TRACER",
    "SLOEngine",
    "Span",
    "Tracer",
    "UnsatCode",
    "UnsatDiagnosis",
    "diagnose_unplaced",
    "score_decomposition",
    "unsat_code",
    "unsat_preemptible",
]
