"""The chaos cases of the other reference test files, in lockstep.

tests/test_chaos.py runs in lockstep in tests/test_torch_chaos.py; the
other reference files have chaos cases of their own, which run here
against both packages:

- tests/test_defrag.py `TestDefragChaos` (migration storms);
- tests/test_device_state.py `TestIncrementalChaosFallback` (node faults
  between dirty ticks) and `TestChaosEquivalence` (three engine tiers
  under a node-fault storm, placements equal);
- tests/test_nodehealth.py `TestNodeFaultChaos` (the four node faults);
- tests/test_observability.py `test_chaos_fault_metrics_exported`;
- tests/test_serving.py `TestServingChaos` (traffic spikes, dropouts);
- tests/test_streaming.py `TestChaos` (burst storms, arrival stalls);
- tests/test_causal.py `TestChaosBitIdentity` (tracing off, full and
  aggregate converge alike).

While this module runs, each reference module's `Harness` is
`LockstepHarness` and its `PlacementEngine` `LockstepEngine`
(tests/test_torch_harness.py), and `ChaosHarness`, `settled_fingerprint`
and `check_invariants` (of the module, and of `grove_tpu.chaos`, which
most bodies import from) are their lockstep forms
(tests/torch_lockstep.py): one ChaosHarness a package from the same
seeded plan, the two planes and fault counts equal after every step, the
fingerprints and invariants computed in both and held equal. The
streaming cases run with tests/test_torch_streaming.py's lockstep front
and config decoder.
"""

from __future__ import annotations

import pytest

import test_causal as ref_causal
import test_chaos as ref_chaos
import test_defrag as ref_defrag
import test_device_state as ref_device_state
import test_nodehealth as ref_nodehealth
import test_observability as ref_observability
import test_serving as ref_serving
import test_streaming as ref_streaming
import test_torch_harness as lockstep_mod
import test_torch_streaming as torch_streaming
import torch_lockstep as ls

from test_torch_harness import (  # noqa: F401  (_compare_at_teardown: autouse)
    Mirror,
    _compare_at_teardown,
    inherit,
    lockstep,
)

REFERENCE = (ref_defrag, ref_device_state, ref_nodehealth, ref_observability,
             ref_serving, ref_streaming, ref_causal, ref_chaos)

#: the chaos names, as their lockstep forms
CHAOS_NAMES = {
    "ChaosHarness": ls.LockstepChaosHarness,
    "settled_fingerprint": ls.settled_fingerprint,
    "check_invariants": ls.check_invariants,
}


_FLIP = ref_device_state.flip_schedulable


def flip_schedulable(snap, rows):
    """test_device_state's rebuild-shaped snapshot, made on each side of
    a lockstep engine's snapshot."""
    return Mirror(_FLIP(snap._j, rows), _FLIP(snap._t, rows), None)


@pytest.fixture(autouse=True, scope="module")
def _chaos_cases_in_lockstep():
    with lockstep(*REFERENCE), pytest.MonkeyPatch.context() as mp:
        for mod in REFERENCE:
            for name, value in CHAOS_NAMES.items():
                if hasattr(mod, name):
                    mp.setattr(mod, name, value)
        # imported inside the reference's test bodies
        for name, value in CHAOS_NAMES.items():
            mp.setattr(f"grove_tpu.chaos.{name}", value)
        mp.setattr(ref_device_state, "flip_schedulable", flip_schedulable)
        mp.setattr(ref_streaming, "front", torch_streaming.lockstep_front)
        mp.setattr(ref_streaming, "load_operator_config",
                   torch_streaming.load_both)
        mp.setattr(lockstep_mod, "_API_MODULES",
                   lockstep_mod._API_MODULES + ("grove_tpu.streaming.",))
        yield


globals().update(inherit(ref_defrag, "Defrag",
                         classes=("TestDefragChaos",)))
globals().update(inherit(
    ref_device_state, "DeviceState",
    classes=("TestIncrementalChaosFallback", "TestChaosEquivalence")))
globals().update(inherit(ref_nodehealth, "NodeHealth",
                         classes=("TestNodeFaultChaos",)))
globals().update(inherit(
    ref_observability, "Observability",
    only={"TestResilienceMetrics": ("test_chaos_fault_metrics_exported",)},
    classes=("TestResilienceMetrics",)))
globals().update(inherit(ref_serving, "Serving",
                         classes=("TestServingChaos",)))
globals().update(inherit(ref_streaming, "Stream", classes=("TestChaos",)))
globals().update(inherit(ref_causal, "Causal",
                         classes=("TestChaosBitIdentity",)))


def test_chaos_names_are_lockstep():
    """The swap is real while this module runs: the reference modules
    and `grove_tpu.chaos` hand out the lockstep chaos harness."""
    import grove_tpu.chaos as jax_chaos

    assert jax_chaos.ChaosHarness is ls.LockstepChaosHarness
    assert ref_causal.ChaosHarness is ls.LockstepChaosHarness
    assert ref_nodehealth.settled_fingerprint is ls.settled_fingerprint
    assert ref_device_state.Harness is lockstep_mod.LockstepHarness
