"""The port's federation against the JAX package's, in lockstep.

tests/test_federation.py's tests run here against both packages. Its
module's `FederationCoordinator` is `LockstepFederation`: one coordinator
a package from the same config and node lists (the port's members built
with device="cpu", their WALs, standbys and the coordinator's journal in
the twin directory, `PATH_ROOTS`), with every call forwarded to both. After
every step (`apply`, `settle`, `advance`, `check_health`,
`declare_outage`, `crash_recover`, `fail_cluster`, `heal_cluster`) and at
the end of each test the two federations are compared, exactly: the
coordinator's debug state (cells, routes, unroutable gangs, journal
head), its metrics, the merged workload fingerprint and every member's
plane (tests/test_torch_harness.py's `assert_same_planes`: pods, gangs,
statuses, events, leases, metrics, decisions). `FederationChaos` runs in
both from the same seeded plan and the two postmortems must agree;
`federation_fingerprint`, `federation_invariants`,
`cluster_level_aggregates` and `classify_domain_cuts` run in both and
must agree. A member's in-body Harness (the aggregates' cases) is
`LockstepHarness`.

Beside them, the port's own cases: every member's engine solves on the
coordinator's device, and a member declared dead has its engines
released at the fence.
"""

from __future__ import annotations

import pytest

import test_federation as ref_fed
import torch_lockstep as ls
from grove_tpu.api.config import load_operator_config as jax_load
from grove_tpu.chaos import FederationChaos as JaxChaos
from grove_tpu.chaos import federation_fingerprint as jax_fp
from grove_tpu.chaos import federation_invariants as jax_inv
from grove_tpu.federation import FederationCoordinator as JaxCoordinator
from grove_tpu.observability.explain import classify_domain_cuts as jax_cuts
from grove_tpu.solver.hierarchy import cluster_level_aggregates as jax_agg
from grove_tpu_torch.api.config import load_operator_config as torch_load
from grove_tpu_torch.chaos import FederationChaos as TorchChaos
from grove_tpu_torch.chaos import federation_fingerprint as torch_fp
from grove_tpu_torch.chaos import federation_invariants as torch_inv
from grove_tpu_torch.federation import FederationCoordinator as TorchCoordinator
from grove_tpu_torch.observability.explain import (
    classify_domain_cuts as torch_cuts,
)
from grove_tpu_torch.solver.hierarchy import (
    cluster_level_aggregates as torch_agg,
)

import test_torch_harness as lh
from test_torch_harness import (  # noqa: F401  (_compare_at_teardown: autouse)
    PATH_ROOTS,
    LockstepHarness,
    Mirror,
    _both,
    _compare_at_teardown,
    _raise_alike,
    _to_jax,
    _tree,
    assert_same_planes,
    inherit,
    to_port,
)
from test_torch_scheduler import metric_values

federation_fingerprint = ls.both(jax_fp, torch_fp)
federation_invariants = ls.both(jax_inv, torch_inv)


def _metrics(fed) -> dict:
    """The coordinator's metrics less its journal's byte counter (each
    package's pickles, `_WALLS`)."""
    return {k: v for k, v in metric_values(fed.metrics).items()
            if k != lh._WAL_BYTES}


class LockstepFederation(Mirror):
    """`FederationCoordinator(config, nodes, ...)` of both packages (the
    port's members on the CPU), compared after every step."""

    STEPS = frozenset({"apply", "settle", "advance", "check_health",
                       "declare_outage", "crash_recover", "fail_cluster",
                       "heal_cluster"})

    def __init__(self, config, nodes, engine_cls=None, audit=False):
        if engine_cls is not None:
            raise NotImplementedError("a lockstep federation builds its "
                                      "members' engines")
        LockstepHarness._sync_replica_counter()
        tconfig, tnodes = to_port(config), to_port(nodes)
        fj, ft, ej, et = _both(
            lambda: JaxCoordinator(_to_jax(config), _to_jax(nodes),
                                   audit=audit),
            lambda: TorchCoordinator(tconfig, tnodes, audit=audit,
                                     device="cpu"))
        _raise_alike(ej, et, "FederationCoordinator")
        super().__init__(fj, ft, None)
        object.__setattr__(self, "steps", 0)
        # the twin directories the port's paths map back through, kept
        # for the comparison at the end of the test
        object.__setattr__(self, "roots", list(PATH_ROOTS))
        lh._PAIRS.append(self)

    def __getattr__(self, name):
        value = super().__getattr__(name)
        if name in self.STEPS and isinstance(value, Mirror):
            return lh._Step(value, self, name)
        return value

    def compare(self, what: str = "") -> None:
        saved = list(PATH_ROOTS)
        PATH_ROOTS[:] = self.roots
        try:
            self._compare(what)
        finally:
            PATH_ROOTS[:] = saved

    def _compare(self, what: str) -> None:
        object.__setattr__(self, "steps", self.steps + 1)
        fj, ft = self._j, self._t
        assert _tree(ft.debug_state()) == _tree(fj.debug_state()), what
        assert _metrics(ft) == _metrics(fj), what
        assert _tree(torch_fp(ft)) == _tree(jax_fp(fj)), what
        for cj, ct in zip(fj.cells, ft.cells):
            assert ct.state == cj.state, (what, cj.name)
            assert_same_planes(cj.harness, ct.harness,
                               f"{what} [{cj.name}]")


class LockstepFederationChaos:
    """`FederationChaos(plan, fed)` of both packages from the same plan
    (the port's rebuilt from its fields) on the two sides of a lockstep
    federation: `run` drives both, and the postmortems must agree."""

    def __init__(self, plan, fed):
        self.fed = fed
        self._j = JaxChaos(plan, fed._j)
        self._t = TorchChaos(ls.port_plan(plan), fed._t)

    def run(self, workload, **kwargs):
        tw = to_port(workload)
        rj, rt, ej, et = _both(lambda: self._j.run(workload, **kwargs),
                               lambda: self._t.run(tw, **kwargs))
        _raise_alike(ej, et, "FederationChaos.run")
        assert _tree(rt) == _tree(rj), ("postmortems differ",
                                        lh._first_difference(_tree(rj),
                                                             _tree(rt)))
        self.fed.compare("FederationChaos.run")
        return rj


@pytest.fixture(autouse=True, scope="module")
def _federation_in_lockstep():
    names = {
        "FederationCoordinator": LockstepFederation,
        "FederationChaos": LockstepFederationChaos,
        "federation_fingerprint": federation_fingerprint,
        "federation_invariants": federation_invariants,
        "cluster_level_aggregates": ls.both(jax_agg, torch_agg),
        "classify_domain_cuts": ls.both(jax_cuts, torch_cuts),
        "load_operator_config": ls.load_both(jax_load, torch_load),
        "os": ls.twin_os,
    }
    import grove_tpu.controller

    with pytest.MonkeyPatch.context() as mp:
        for name, value in names.items():
            mp.setattr(ref_fed, name, value)
        # the aggregates' cases build their members in their bodies
        mp.setattr(grove_tpu.controller, "Harness", LockstepHarness)
        yield


@pytest.fixture
def tmp_path(tmp_path):
    """The test's directory, with the port's twin registered for it."""
    path, pair = ls.twin_tmp_path(tmp_path)
    yield path
    PATH_ROOTS.remove(pair)


globals().update(inherit(ref_fed, "Federation"))


# -- the lockstep itself, and the port's own cases -------------------------------
def test_federation_lockstep_sees_a_divergence(tmp_path):
    """The comparison is not vacuous: a gang applied to one member of the
    port's federation alone fails the next comparison."""
    fed = ref_fed.build_fed(tmp_path)
    fed.apply(ref_fed.gang("g0"))
    fed.settle()
    fed._t.cells[0].harness.apply(to_port(ref_fed.gang("extra")))
    with pytest.raises(AssertionError):
        fed.compare("diverged")
    lh._PAIRS.remove(fed)
    fed.close()


def _port_fed(tmp_path, **fe):
    cfg = to_port(ref_fed.fed_config(tmp_path, 3, **fe))
    nodes = [to_port(ref_fed.make_nodes(6, name_prefix=f"c{i}-n"))
             for i in range(3)]
    return TorchCoordinator(cfg, nodes, device="cpu")


def test_members_solve_on_the_coordinators_device_and_release_at_fence(
        tmp_path):
    """Every member's scheduler builds its engine on the coordinator's
    device; a member declared dead is fenced and its engines released
    (no resident state, no pending dispatch), while its gangs drain into
    the survivors, whose engines place them."""
    fed = _port_fed(tmp_path, outage_detection_window_seconds=15.0,
                    heartbeat_interval_seconds=2.0)
    homes = [fed.apply(to_port(ref_fed.gang(f"g{j}"))) for j in range(6)]
    fed.settle()
    for cell in fed.cells:
        assert cell.harness.device == "cpu"
        assert all(s._engine_kwargs["device"] == "cpu"
                   for s in cell.harness.schedulers())
    victim = fed.by_name[homes[0]]
    old = victim.harness.schedulers()
    engines = [s._engine for s in old]
    assert any(e is not None for e in engines)
    fed.fail_cluster(victim.name)
    for _ in range(10):
        fed.advance(5.0)
    assert victim.state == "drained"
    assert all(s._engine is None and s._pending is None for s in old)
    for e in engines:
        if e is not None:
            assert e._statics is None and e._free_buf is None
    assert torch_inv(fed) == []
    assert sorted(fed._routes) == sorted(("default", f"g{j}")
                                         for j in range(6))
    fed.close()


def test_federation_without_device_needs_the_card(tmp_path):
    """No device means the CUDA card: without one the coordinator is not
    built (its first member's scheduler raises where it is made)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the engine would run there")
    cfg = to_port(ref_fed.fed_config(tmp_path, 2))
    nodes = [to_port(ref_fed.make_nodes(2, name_prefix=f"c{i}-n"))
             for i in range(2)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchCoordinator(cfg, nodes)
