"""Streaming admission→solve front (docs/scheduling.md "Streaming
admission"): SLO-aware micro-batches, bounded queues with structured
DeadlineExceeded shedding, and the brownout ladder — the continuous
alternative to round-draining the whole backlog. The counterpart of
grove_tpu/streaming/; `GangScheduler` builds a `StreamFront` where
`config.stream.enabled` is set."""

from .front import (
    BAND_SHED_RANK,
    BROWNOUT_DEFRAG_LEVEL,
    BROWNOUT_SHED_LEVEL,
    BROWNOUT_WIDEN_LEVEL,
    StreamFront,
    StreamPlan,
    StreamShed,
)

__all__ = [
    "BAND_SHED_RANK",
    "BROWNOUT_DEFRAG_LEVEL",
    "BROWNOUT_SHED_LEVEL",
    "BROWNOUT_WIDEN_LEVEL",
    "StreamFront",
    "StreamPlan",
    "StreamShed",
]
