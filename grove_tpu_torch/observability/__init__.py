"""Observability the placement engine reports into: the metrics
registry, the span tracer and the decision log with its unsat diagnosis.

The counterpart of grove_tpu/observability/__init__.py. The event
recorder and the structured logger belong to the cluster and the
controllers, and the SLO engine to the service layer; they arrive with
them.
"""

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
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .tracing import NOOP_TRACER, Span, Tracer

__all__ = [
    "Counter",
    "DecisionLog",
    "DecisionRecord",
    "Gauge",
    "Histogram",
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
