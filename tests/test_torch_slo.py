"""The port's SLO engine and trace CLI against the JAX package's, in lockstep.

tests/test_slo.py's tests run here against both packages. Its module's
names are swapped while this module runs: `Harness` is `LockstepHarness`,
`ChaosHarness` `LockstepChaosHarness`, and `SLOEngine`,
`MetricsRegistry` and `SimClock` build one object a package
(tests/torch_lockstep.py's `LockstepClass`); the scorecard helpers
(`compose_scorecard`, `render_scorecard`, `static_entry`,
`worst_verdict`) run in both and must agree, and the CLI (`slo_main`)
runs in both on the same files and must print the same text.
`PlacementService` is a pair of services (the port's engines on the CPU)
whose Debug dumps must agree less their uptime. Every sweep's stats,
every scorecard, every firing list read through the lockstep is held
equal to the port's, exactly (the SLO engine reads virtual time only),
and the planes after every harness step.

Inherited from other files that reach the SLO engine or the trace CLI:
test_causal.py's scorecard cases (a firing bind-latency SLO attaching its
worst offenders' critical paths, a healthy one attaching nothing) with
`SLOEngine`, `MetricsRegistry` and `Tracer` swapped for their pairs, and
the trace CLI cases of test_tracing.py and test_causal.py with the CLI
run in both packages (the same Chrome trace and the same report).
"""

from __future__ import annotations

import contextlib
import io
import json
import sys
from pathlib import Path

import pytest

import test_causal as ref_causal
import test_slo as ref_slo
import test_tracing as ref_tracing
import torch_lockstep as ls
from grove_tpu.api.config import load_operator_config as jax_load
from grove_tpu.cluster.clock import SimClock as JaxClock
from grove_tpu.observability import slo as jax_slo
from grove_tpu.observability import trace as jax_trace
from grove_tpu.observability.metrics import MetricsRegistry as JaxMetrics
from grove_tpu.observability.tracing import Tracer as JaxTracer
from grove_tpu.service.server import PlacementService as JaxService
from grove_tpu_torch.api.config import load_operator_config as torch_load
from grove_tpu_torch.cluster.clock import SimClock as TorchClock
from grove_tpu_torch.observability import slo as torch_slo
from grove_tpu_torch.observability import trace as torch_trace
from grove_tpu_torch.observability.metrics import MetricsRegistry as TorchMetrics
from grove_tpu_torch.observability.tracing import Tracer as TorchTracer
from grove_tpu_torch.service.server import PlacementService as TorchService

from test_torch_harness import (  # noqa: F401  (_compare_at_teardown: autouse)
    PATH_ROOTS,
    LockstepHarness,
    Mirror,
    _compare_at_teardown,
    _to_jax,
    inherit,
    to_port,
)

SLOEngine = ls.LockstepClass(jax_slo.SLOEngine, torch_slo.SLOEngine)
MetricsRegistry = ls.LockstepClass(JaxMetrics, TorchMetrics)
Tracer = ls.LockstepClass(JaxTracer, TorchTracer)


def _run_cli(main, argv):
    """`main(argv)` with its stdout and stderr captured: (code, out, err)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = main(argv)
    return code, out.getvalue(), err.getvalue()


def lockstep_cli(jax_main, port_main):
    """A CLI `main` run in both packages on the same arguments: the same
    exit code, standard output and standard error, and (for `-o PATH`)
    the same file contents, the port's written beside the JAX package's.
    The JAX package's output is printed and its code returned."""

    def main(argv):
        argv = list(argv)
        port_argv, out_path = list(argv), None
        if "-o" in argv:
            i = argv.index("-o") + 1
            out_path = argv[i]
            port_argv[i] = out_path + ".torch"
        rj = _run_cli(jax_main, argv)
        code, out, err = _run_cli(port_main, port_argv)
        if out_path is not None:
            # the port's file is named on its report line
            err = err.replace(out_path + ".torch", out_path)
        assert (code, out, err) == rj, (jax_main.__module__, argv)
        if out_path is not None:
            assert Path(port_argv[port_argv.index("-o") + 1]).read_text() \
                == Path(out_path).read_text()
        sys.stdout.write(rj[1])
        sys.stderr.write(rj[2])
        return rj[0]

    return main


def _dump_view(data: bytes) -> dict:
    """A service Debug dump less its uptime (a wall)."""
    dump = json.loads(data)
    dump.pop("uptime_seconds")
    return dump


class PlacementService:
    """`PlacementService(...)` of both packages (the port's engines on
    the CPU) as a Mirror; `PlacementService.debug(svc, request)` runs in
    both and the dumps must agree less their uptime."""

    def __new__(cls, **kwargs):
        return Mirror(JaxService(**_to_jax(kwargs)),
                      TorchService(device="cpu", **to_port(kwargs)), None)

    @staticmethod
    def debug(svc, request: bytes) -> bytes:
        want = JaxService.debug(svc._j, request)
        got = TorchService.debug(svc._t, request)
        assert _dump_view(got) == _dump_view(want)
        return want


@pytest.fixture(autouse=True, scope="module")
def _slo_in_lockstep():
    names = {
        "Harness": LockstepHarness,
        "ChaosHarness": ls.LockstepChaosHarness,
        "SLOEngine": SLOEngine,
        "MetricsRegistry": MetricsRegistry,
        "SimClock": ls.LockstepClass(JaxClock, TorchClock),
        "load_operator_config": ls.load_both(jax_load, torch_load),
        "settled_fingerprint": ls.settled_fingerprint,
        "PlacementService": PlacementService,
        "slo_main": lockstep_cli(jax_slo.main, torch_slo.main),
        **{name: ls.both(getattr(jax_slo, name), getattr(torch_slo, name))
           for name in ("compose_scorecard", "render_scorecard",
                        "static_entry", "worst_verdict")},
    }
    with pytest.MonkeyPatch.context() as mp:
        for name, value in names.items():
            mp.setattr(ref_slo, name, value)
        # the trace CLI, imported in the bodies of the inherited cases
        mp.setattr(jax_trace, "main",
                   lockstep_cli(jax_trace.main, torch_trace.main))
        yield


@pytest.fixture
def slo_pairs(monkeypatch):
    """test_causal.py's scorecard cases build their engine, registry and
    config in their bodies and their tracer from the module: the pairs."""
    monkeypatch.setattr(jax_slo, "SLOEngine", SLOEngine)
    monkeypatch.setattr("grove_tpu.observability.metrics.MetricsRegistry",
                        MetricsRegistry)
    monkeypatch.setattr("grove_tpu.api.config.load_operator_config",
                        ls.load_both(jax_load, torch_load))
    monkeypatch.setattr(ref_causal, "Tracer", Tracer)


@pytest.fixture
def tmp_path(tmp_path):
    """The test's directory, with the port's twin registered for it (a
    durable store's wal_dir)."""
    path, pair = ls.twin_tmp_path(tmp_path)
    yield path
    PATH_ROOTS.remove(pair)


globals().update(inherit(ref_slo, "SLO"))

# test_causal.py's SLO scorecard cases
TestCausalSurfaces = pytest.mark.usefixtures("slo_pairs")(inherit(
    ref_causal, "Causal", classes=("TestSurfaces",),
    only={"TestSurfaces": ("test_firing_bind_slo_attaches_worst_offenders",
                           "test_healthy_bind_slo_attaches_nothing")})[
        "TestCausalSurfaces"])

# the trace CLI cases of test_tracing.py and test_causal.py
globals().update(inherit(
    ref_tracing, "Tracing", classes=("TestChromeTrace",),
    only={"TestChromeTrace": ("test_cli_converts_trace_and_flight_dumps",)}))
globals().update(inherit(
    ref_causal, "CausalTrace", classes=("TestFlowEvents",),
    only={"TestFlowEvents": ("test_trace_cli_prints_critical_path",)}))


# -- the port's own cases -------------------------------------------------------------
def test_cli_lockstep_sees_a_divergence(tmp_path):
    """The CLI comparison is not vacuous: a port CLI that prints one more
    line fails it."""

    def louder(argv):
        code = torch_slo.main(argv)
        print("extra")
        return code

    with pytest.raises(AssertionError):
        lockstep_cli(jax_slo.main, louder)(["--demo"])


def test_slo_cli_runs_as_a_module(tmp_path):
    import subprocess

    from test_torch_harness import ROOT

    out = subprocess.run(
        [sys.executable, "-m", "grove_tpu_torch.observability.slo",
         "--demo", "--json"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    card = json.loads(out.stdout)
    assert card["slos"] and card["alert_history"]


def test_harness_with_slo_without_device_needs_the_card():
    """No device means the CUDA card: a Harness with the SLO engine is
    built only where its scheduler can solve."""
    import torch

    from grove_tpu_torch.controller import Harness as TorchHarness

    if torch.cuda.is_available():
        pytest.skip("a card is present: the engine would run there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchHarness(nodes=to_port(ref_slo.make_nodes(2)),
                     config={"slo": ref_slo.SLO_BASE})
