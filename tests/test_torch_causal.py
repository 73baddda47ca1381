"""tests/test_causal.py's classes run against the port's causal tracing.

The reference's test bodies run here (`inherit`, tests/test_torch_harness.py)
with its module's names swapped for the port's while this module runs:
the ledger, `next_token` and `tokens_of`, `Tracer`, `AggregateTracer`,
`Span`, `CriticalPathFolder`, `CriticalPathObservatory` and
`chrome_trace` of grove_tpu_torch.observability; `Harness` a port
Harness on the CPU that carries the reference's API objects across
(`to_port`); the metrics registry and the trace CLI imported in the
bodies are the port's too. Each assertion, written for
the JAX package's values (pinned virtual times and walls), so holds on
the port's.

Held: TestCausalLedger, TestTelescoping, TestObservatory,
TestAggregateMode, TestFlowEvents and TestEndToEnd (the stream front, 4
shards and the hierarchical solve on one traced Harness). Left out:
TestAggregateMode's test_matches_full_mode_exactly, the reference's own
flaky case T1 (ROADMAP.md §3: its interior split weights by wall time),
which a copy here would only double; TestChaosBitIdentity, with the
other chaos cases (ROADMAP.md item 8h-ii); TestSurfaces, whose two
scorecard cases tests/test_torch_slo.py holds in lockstep.
"""

from __future__ import annotations

import pytest

import test_causal as ref_causal
from grove_tpu_torch.controller import Harness as TorchHarness
from grove_tpu_torch.observability import causal as torch_causal
from grove_tpu_torch.observability import metrics as torch_metrics
from grove_tpu_torch.observability import trace as torch_trace
from grove_tpu_torch.observability import tracing as torch_tracing

from test_torch_harness import inherit, to_port


class PortHarness(TorchHarness):
    """The port's Harness on the CPU, built from and applied with the
    reference's objects (carried across by `to_port`)."""

    def __init__(self, nodes=None, config=None, **kwargs):
        super().__init__(nodes=to_port(nodes), config=to_port(config),
                         device="cpu", **kwargs)

    def apply(self, obj, *args, **kwargs):
        return super().apply(to_port(obj), *args, **kwargs)


#: the reference module's names, as the port's
PORT_NAMES = {
    "Harness": PortHarness,
    "CausalLedger": torch_causal.CausalLedger,
    "CriticalPathFolder": torch_causal.CriticalPathFolder,
    "CriticalPathObservatory": torch_causal.CriticalPathObservatory,
    "next_token": torch_causal.next_token,
    "tokens_of": torch_causal.tokens_of,
    "SEGMENTS": torch_causal.SEGMENTS,
    "AggregateTracer": torch_tracing.AggregateTracer,
    "Span": torch_tracing.Span,
    "Tracer": torch_tracing.Tracer,
    "chrome_trace": torch_tracing.chrome_trace,
}


@pytest.fixture(autouse=True)
def _causal_on_the_port(monkeypatch):
    for name, value in PORT_NAMES.items():
        monkeypatch.setattr(ref_causal, name, value)
    # imported inside the reference's test bodies
    monkeypatch.setattr("grove_tpu.observability.metrics.MetricsRegistry",
                        torch_metrics.MetricsRegistry)
    monkeypatch.setattr("grove_tpu.observability.trace.main",
                        torch_trace.main)


def test_names_are_the_ports():
    """The swap is real: the reference module sees the port's classes
    while a test runs, and the segments are the reference's."""
    from grove_tpu.observability import causal as jax_causal

    assert ref_causal.Tracer is torch_tracing.Tracer
    assert ref_causal.Harness is PortHarness
    assert tuple(torch_causal.SEGMENTS) == tuple(jax_causal.SEGMENTS)


globals().update(inherit(
    ref_causal, "Causal",
    classes=("TestCausalLedger", "TestTelescoping", "TestObservatory",
             "TestAggregateMode", "TestFlowEvents", "TestEndToEnd"),
    # T1 (ROADMAP.md §3): the reference's wall-weighted flaky case
    leave_out={"TestAggregateMode": ("test_matches_full_mode_exactly",)}))
