"""The port's streaming admission front against the JAX package's.

tests/test_streaming.py's own tests, run here against both packages:

- the front's unit cases (TestWindow, TestDeterminism, TestShedding,
  TestBrownout, TestReadmission, TestStall): the module's `front()`
  builds a `StreamFront` in each package from the same config and the
  same clock (the tests pass the virtual instant to every call), joined in
  one `Mirror` (tests/test_torch_harness.py) that forwards every call,
  attribute read and write to both and holds every result (each plan
  and shed whole, waits, levels, debug state) equal to the JAX
  package's;
- TestConfig: the module's `load_operator_config` decodes in both
  packages and the two must agree (the config, or the error and its
  text);
- TestSchedulerIntegration and the Harness case of TestBrownout: the
  module's `Harness` is `LockstepHarness`, the port's on the CPU, the
  planes compared after every step and at the end of each test.

TestChaos is left out: its seeded storms and stalls drive
`grove_tpu.chaos` (`FaultPlan`, `ChaosHarness`) and are later lockstep
work (ROADMAP item 8h).
"""

from __future__ import annotations

import pytest

import test_streaming as ref_streaming
import test_torch_harness as lockstep_mod
import torch_lockstep
from grove_tpu_torch.api.config import (
    load_operator_config as torch_load_config,
)
from grove_tpu_torch.observability import explain as torch_explain
from grove_tpu_torch.streaming import StreamFront as TorchStreamFront

from test_torch_harness import (  # noqa: F401  (_compare_at_teardown: autouse)
    Mirror,
    _compare_at_teardown,
    inherit,
    lockstep,
    to_port,
)

_REF_FRONT = ref_streaming.front
_REF_LOAD = ref_streaming.load_operator_config


def lockstep_front(metrics=None, tenancy=None, **over):
    """test_streaming's `front()` in both packages: the JAX package's
    front and the port's, built from the same config, as one Mirror."""
    assert metrics is None and tenancy is None
    fj = _REF_FRONT(**over)
    return Mirror(fj, TorchStreamFront(to_port(fj.cfg), None), None)


#: the operator config decoded by both packages: equal configs, or the
#: same error with the same text
load_both = torch_lockstep.load_both(_REF_LOAD, torch_load_config)


@pytest.fixture(autouse=True, scope="module")
def _streaming_in_lockstep():
    with lockstep(ref_streaming), pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_streaming, "front", lockstep_front)
        mp.setattr(ref_streaming, "load_operator_config", load_both)
        # the front's plans and sheds are data: held equal whole, on
        # every call
        mp.setattr(lockstep_mod, "_API_MODULES",
                   lockstep_mod._API_MODULES + ("grove_tpu.streaming.",))
        yield


globals().update(inherit(
    ref_streaming, "Stream",
    classes=("TestWindow", "TestDeterminism", "TestShedding",
             "TestBrownout", "TestReadmission", "TestStall", "TestConfig",
             "TestSchedulerIntegration")))


def test_deadline_code_matches_the_reference():
    """The port's DeadlineExceeded code: the reference's value, and not
    preemptible in either package."""
    assert torch_explain.UnsatCode.DEADLINE.value == \
        ref_streaming.UnsatCode.DEADLINE.value == "DeadlineExceeded"
    assert torch_explain.UnsatCode.DEADLINE not in \
        torch_explain.PREEMPTIBLE_CODES


def test_lockstep_front_sees_a_divergence():
    """The front's comparison is not vacuous: a waiter added on the
    port's side alone fails the next plan."""
    f = lockstep_front()
    ks = ref_streaming.keys(2)
    f.plan_round(ks, now=0.0)
    f._t._waiting[("default", "extra")] = -5.0  # an earlier arrival
    with pytest.raises(AssertionError, match="port != JAX"):
        f.plan_round(ks + [("default", "extra")], now=0.0)
