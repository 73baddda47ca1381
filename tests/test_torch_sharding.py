"""The port's sharded control plane against the JAX package's, in lockstep.

tests/test_sharding.py's tests and tests/test_leaderelection.py's two
shard cases run here against both packages. The modules' `Harness` is
`LockstepHarness` (tests/test_torch_harness.py): one Harness a package
over the same nodes and config, the port's on the CPU, every call
forwarded to both, every piece of data read held equal to the port's,
and the planes compared after every step and at the end of each test.
With `controllers.shards > 1` each package builds its `ShardedManager`:
the same workers, the same shard map at every round (`ShardMap` is a
store object, so the planes hold it equal), the same leases expiring on
the same `SimClock`, and the ownership audit (`manager.audit = True`)
armed in both. `shard_of` is run in both and must agree.

The round write batcher's unit cases (`WriteBatch` with callbacks that
record into the test's own list) and the config validation case (which
imports the JAX package's decoder inside the test) run against the port
alone: the module's `WriteBatch`, or the decoder and its error class,
are the port's for the test, so the reference's own assertions hold the
port.
"""

from __future__ import annotations

import functools

import pytest

import grove_tpu.api.config as jax_config
import grove_tpu.api.validation as jax_validation
import test_leaderelection as ref_le
import test_sharding as ref_sharding
from grove_tpu.controller.sharding import shard_of as jax_shard_of
from grove_tpu_torch.api.config import load_operator_config as torch_load
from grove_tpu_torch.api.validation import ValidationError as TorchValidation
from grove_tpu_torch.controller.concurrency import WriteBatch as TorchBatch
from grove_tpu_torch.controller.sharding import shard_of as torch_shard_of

from test_torch_harness import (  # noqa: F401  (_compare_at_teardown: autouse)
    LockstepHarness,
    _compare_at_teardown,
)


def shard_of_both(namespace: str, name: str, num_shards: int) -> int:
    """`shard_of` of both packages, which must agree."""
    want = jax_shard_of(namespace, name, num_shards)
    assert torch_shard_of(namespace, name, num_shards) == want
    return want


def in_lockstep(fn, module, **names):
    """`fn` (a test of `module`) with the module's names swapped for the
    test: `Harness` -> `LockstepHarness`, plus `names`. An entry whose
    name holds a dot ("grove_tpu.api.config.load_operator_config") is an
    attribute of a JAX-package module, for a test that imports it inside
    its body."""
    swaps = {"Harness": LockstepHarness, **names}

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with pytest.MonkeyPatch.context() as mp:
            for name, value in swaps.items():
                if "." in name:
                    mp.setattr(name, value)
                elif hasattr(module, name):
                    mp.setattr(module, name, value)
            return fn(*args, **kwargs)

    return run


#: the port alone under the reference's assertions (see the docstring)
PORT_ALONE = {
    "test_write_batch_coalesces_and_flushes": {"WriteBatch": TorchBatch},
    "test_write_batch_requeues_failures_for_next_flush": {
        "WriteBatch": TorchBatch},
    "test_config_validation": {
        "grove_tpu.api.config.load_operator_config": torch_load,
        "grove_tpu.api.validation.ValidationError": TorchValidation,
    },
}

for _name, _fn in list(vars(ref_sharding).items()):
    if _name.startswith("test_") and callable(_fn):
        globals()[_name] = in_lockstep(
            _fn, ref_sharding,
            **PORT_ALONE.get(_name, {"shard_of": shard_of_both}))

#: test_leaderelection.py's shard cases (:143, :174)
for _name in ("test_shard_coordinator_role_fails_over_on_lease_expiry",
              "test_shard_worker_lease_renewal_rides_every_round"):
    globals()[_name] = in_lockstep(getattr(ref_le, _name), ref_le)
del _name, _fn


def test_port_alone_swaps_reach_the_port():
    """The port-alone cases are not vacuous: the swapped names are the
    port's while the test runs, and the JAX package's after."""
    seen = {}

    def probe():
        from grove_tpu.api.config import load_operator_config

        seen["load"] = load_operator_config
        seen["batch"] = ref_sharding.WriteBatch

    in_lockstep(probe, ref_sharding,
                **PORT_ALONE["test_config_validation"],
                WriteBatch=TorchBatch)()
    assert seen == {"load": torch_load, "batch": TorchBatch}
    assert jax_config.load_operator_config is not torch_load
    assert jax_validation.ValidationError is not TorchValidation


def test_sharded_planes_see_a_moved_shard():
    """The sharded lockstep is not vacuous: a shard reassigned in the
    port's map alone fails the next comparison (the ShardMap is a store
    object the planes hold equal)."""
    from grove_tpu_torch.controller.sharding import (
        SHARD_MAP_NAME,
        SHARD_NAMESPACE,
        ShardMap,
    )

    h = LockstepHarness(nodes=ref_sharding.make_nodes(8),
                        config=ref_sharding.SHARDED)
    h.settle()
    store = h._t.store
    m = store.get(ShardMap.KIND, SHARD_NAMESPACE, SHARD_MAP_NAME)
    shard = next(s for s, w in m.assignments.items() if w != "worker-0")
    m.assignments[shard] = "worker-0"
    store.update(m)
    with pytest.raises(AssertionError, match="differ"):
        h.compare("moved")
    import test_torch_harness

    test_torch_harness._PAIRS.remove(h)


def test_every_sharded_worker_solves_on_the_harness_device():
    """Each worker of the port's sharded plane builds its own
    GangScheduler on the Harness's device (here the CPU), and the worker
    that owns the reserved scheduler shard is the one whose engine
    solves."""
    from grove_tpu_torch.cluster import make_nodes
    from grove_tpu_torch.controller import Harness

    h = Harness(nodes=make_nodes(8), config={"controllers": {"shards": 3}},
                device="cpu")
    scheds = h.schedulers()
    assert len(scheds) == 3
    assert all(s._engine_kwargs["device"] == "cpu" for s in scheds)
    _s, owner = h.manager.shard_owner("", "schedule")
    worker = next(w for w in h.manager.workers if w.identity == owner)
    assert worker.components["scheduler"] is h.scheduler
