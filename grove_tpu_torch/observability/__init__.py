"""Observability: the metrics registry, the span tracer, the decision
log with its unsat diagnosis, the event recorder and the structured
logger.

The counterpart of grove_tpu/observability/__init__.py. The SLO engine
belongs to the service layer and arrives with it.
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
    "Span",
    "Tracer",
    "UnsatCode",
    "UnsatDiagnosis",
    "diagnose_unplaced",
    "score_decomposition",
    "unsat_code",
    "unsat_preemptible",
]
