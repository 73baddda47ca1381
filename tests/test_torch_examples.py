"""examples/ against grove_tpu_torch.examples.

Each workload example's `build()` must equal the reference's object for
object (the JAX package's carried across with `convert.api_object`), and
its `run()` on `device="cpu"` must settle to the counts of
tests/test_examples.py (every pod bound and ready, every PodGang Running)
and to the reference run's settled fingerprint. The two operations tours
must print the same milestone lines, less the reconcile p99 walls and
the journal's byte count (the pickled records name each package's own
modules, tests/test_torch_durability.py `TestPickledModuleNames`).
Without the service's optional dependencies the port's tour prints
"service tour skipped" and nothing after it, as the reference's does.
"""

import importlib
import sys

import pytest
import torch

from grove_tpu.api.podgang import PodGangPhase as JaxPhase
from grove_tpu.chaos.harness import settled_fingerprint as jax_fingerprint

from grove_tpu_torch.api.podgang import PodGangPhase
from grove_tpu_torch.chaos.harness import settled_fingerprint
from grove_tpu_torch.convert import api_object
from grove_tpu_torch.examples import common
from grove_tpu_torch.examples.operations_tour import milestones
from test_examples import CASES  # puts examples/ on sys.path


def reference(module):
    return importlib.import_module(module)


def port(module):
    return importlib.import_module(f"grove_tpu_torch.examples.{module}")


@pytest.mark.parametrize("module", [c[0] for c in CASES])
def test_build_equals_reference(module):
    assert port(module).build() == api_object(reference(module).build())


@pytest.mark.parametrize("module,pods,gangs", CASES)
def test_run_settles_like_reference(module, pods, gangs):
    h = common.run(port(module).build(), nodes=64, device="cpu")
    pod_objs = h.store.list("Pod")
    assert len(pod_objs) == pods, [p.metadata.name for p in pod_objs]
    assert all(p.node_name and p.status.ready for p in pod_objs)
    gang_objs = h.store.list("PodGang")
    assert len(gang_objs) == gangs, [g.metadata.name for g in gang_objs]
    assert all(g.status.phase == PodGangPhase.RUNNING for g in gang_objs)
    ref_common = importlib.import_module("common")
    ref = ref_common.run(reference(module).build(), nodes=64)
    assert all(g.status.phase == JaxPhase.RUNNING
               for g in ref.store.list("PodGang"))
    assert settled_fingerprint(h.store) == jax_fingerprint(ref.store)


def test_operations_tour_prints_reference_milestones(capsys):
    reference("operations_tour").main()
    jax_out = capsys.readouterr().out
    port("operations_tour").main(["--device", "cpu"])
    port_out = capsys.readouterr().out
    assert "rack recovered" in port_out
    assert "re-settled to the identical fixpoint" in port_out
    assert milestones(port_out) == milestones(jax_out)


def test_operations_tour_skips_service_without_it(capsys, monkeypatch):
    """The service tour needs grpc and cryptography: where they are
    missing it prints the one skip line, after the two in-process tours
    ran whole."""
    monkeypatch.setitem(sys.modules, "grove_tpu_torch.service", None)
    port("operations_tour").main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[-1].startswith("service tour skipped (missing optional "
                              "dependency: ")
    assert any("a NEW process booted from the files" in ln for ln in out)
    assert not any("service Debug probe" in ln for ln in out)


def test_example_command_line_refuses_missing_card():
    """No CUDA and no `--device cpu`: the command raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        common.parse_device([])
