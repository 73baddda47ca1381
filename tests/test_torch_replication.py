"""The port's HA replication against the JAX package's, in lockstep.

tests/test_replication.py's tests run here against both packages. Its
module's names are swapped while this module runs, as
tests/test_torch_durability.py swaps the durable store's: `Harness` is
`LockstepHarness`, `ChaosHarness` `LockstepChaosHarness`, and
`ObjectStore` and `DurableLog` build one object a package
(tests/torch_lockstep.py); `WalTailer` is a pair whose polls must yield
the same records (kind, seq, clock, term, event) in both;
`settled_fingerprint` and `check_invariants` run in both and must agree.
Every object read is held equal to the port's, and the planes after every
step, the promotions included (a promotion rebuilds the managers, so it
is a step). `assert_bit_identical` holds a promoted store equal to the
recovered one field by field, as it does the reference's, on the Mirrors'
JAX sides, while the lockstep holds every field it reads equal to the
port's.

The port writes its WAL and its standby's journal into twin directories
beside the test's (`PATH_ROOTS`), and a test that removes a segment by
hand removes it in both trees. As in the durable store's suite, the
inherited cases run with the WAL's size cut raised past any history here
(`DUR_NO_SIZE_CUT`): the pickles name each package's modules, so a cut by
bytes lands on different records (test_torch_durability.py's
`TestPickledModuleNames`); byte counts are left out of the comparisons
(`_WALLS`). Everything else is exact.

Beside them, the port's own cases: a promotion rebuilds the scheduler's
engine on the harness's device and releases the deposed one; the lag
records and the standby's generations equal the reference's through a
semi-sync settle and a promotion.
"""

from __future__ import annotations

import pytest

import test_durability as ref_dur
import test_replication as ref_repl
import torch_lockstep as ls
from grove_tpu.api.config import load_operator_config as jax_load
from grove_tpu.cluster.durability import DurableLog as JaxLog
from grove_tpu.cluster.durability import WalTailer as JaxTailer
from grove_tpu.cluster.store import ObjectStore as JaxStore
from grove_tpu_torch.api.config import load_operator_config as torch_load
from grove_tpu_torch.cluster.durability import DurableLog as TorchLog
from grove_tpu_torch.cluster.durability import WalTailer as TorchTailer
from grove_tpu_torch.cluster.store import ObjectStore as TorchStore
from grove_tpu_torch.controller import Harness as TorchHarness

from test_torch_durability import DUR_NO_SIZE_CUT, _record_view
from test_torch_harness import (  # noqa: F401  (_compare_at_teardown: autouse)
    PATH_ROOTS,
    LockstepHarness,
    _both,
    _compare_at_teardown,
    _raise_alike,
    inherit,
    to_port,
)


class LockstepTailer:
    """`WalTailer(wal_dir, ...)` of both packages, the port's on the twin
    directory: each poll drains both and must yield the same decoded
    records (or raise alike); returns the JAX package's."""

    def __init__(self, wal_dir, *args, **kwargs):
        self._j = JaxTailer(wal_dir, *args, **kwargs)
        self._t = TorchTailer(to_port(wal_dir), *args, **kwargs)

    def poll(self):
        rj, rt, ej, et = _both(lambda: list(self._j.poll()),
                               lambda: list(self._t.poll()))
        _raise_alike(ej, et, "WalTailer.poll")
        assert [_record_view(r) for r in rt] == [_record_view(r) for r in rj]
        return rj


@pytest.fixture(autouse=True, scope="module")
def _replication_in_lockstep():
    names = {
        "Harness": LockstepHarness,
        "ChaosHarness": ls.LockstepChaosHarness,
        "ObjectStore": ls.LockstepClass(JaxStore, TorchStore),
        "DurableLog": ls.LockstepClass(JaxLog, TorchLog),
        "WalTailer": LockstepTailer,
        "settled_fingerprint": ls.settled_fingerprint,
        "check_invariants": ls.check_invariants,
        "load_operator_config": ls.load_both(jax_load, torch_load),
        "DUR": DUR_NO_SIZE_CUT,
        "os": ls.twin_os,
    }
    with pytest.MonkeyPatch.context() as mp:
        for name, value in names.items():
            mp.setattr(ref_repl, name, value)
        # the store's fields the recovery gate reads, on the stores the
        # lockstep hands it (test_durability's own helper, unchanged)
        mp.setattr(ref_dur, "ObjectStore", names["ObjectStore"])
        yield


@pytest.fixture
def tmp_path(tmp_path):
    """The test's directory, with the port's twin registered for it."""
    path, pair = ls.twin_tmp_path(tmp_path)
    yield path
    PATH_ROOTS.remove(pair)


globals().update(inherit(ref_repl, "Replication"))


# -- the port's own cases ---------------------------------------------------------
def _port_repl(tmp_path, **extra):
    cfg = {
        "durability": {"wal_dir": str(tmp_path / "wal"), "fsync": "never"},
        "replication": {"enabled": True, "ack_mode": "semi-sync",
                        "standby_wal_dir": str(tmp_path / "standby")},
        **extra,
    }
    h = TorchHarness(nodes=to_port(ref_repl.make_nodes(8)), config=cfg,
                     device="cpu")
    h.apply(to_port(ref_repl.workload()))
    h.settle()
    return h


def test_promotion_rebuilds_the_engine_on_the_device_and_releases_the_old(
        tmp_path):
    """Total leader loss: the promoted head is the committed head, the
    managers (and their engines) are rebuilt on the harness's device, the
    deposed scheduler's engine is released (no resident state), and the
    rebuilt engine places new sets."""
    h = _port_repl(tmp_path)
    committed = h.store.last_seq
    old = h.schedulers()
    engines = [s._engine for s in old]
    assert any(e is not None for e in engines)
    stats = h.promote_standby(catch_up=False)
    assert stats["lost_records"] == 0 and stats["applied_seq"] == committed
    assert all(s._engine is None and s._pending is None for s in old)
    for e in engines:
        if e is not None:
            assert e._statics is None and e._free_buf is None
    h.apply(to_port(ref_repl.workload(name="after", replicas=2)))
    h.settle()
    new = h.schedulers()
    assert not set(map(id, new)) & set(map(id, old))
    assert all(s._engine_kwargs["device"] == "cpu" for s in new)
    assert all(p.node_name for p in h.store.scan("Pod"))


def test_promotion_without_device_needs_the_card(tmp_path):
    """No device means the CUDA card: without one, a replicated Harness
    is not built (the scheduler raises where it is made), so a promotion
    never falls back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the engine would run there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchHarness(nodes=to_port(ref_repl.make_nodes(4)), config={
            "durability": {"wal_dir": str(tmp_path / "w"), "fsync": "never"},
            "replication": {"enabled": True,
                            "standby_wal_dir": str(tmp_path / "s")}})


@pytest.mark.parametrize("ack", ("semi-sync", "async"))
def test_lag_and_generations_match_the_reference(tmp_path, ack):
    """The standby's debug state (applied seq, lag records, generation,
    ack mode, terms) equals the reference's after a settle, a standby
    rebuild and a promotion, in both ack modes."""
    h = ref_repl.repl_harness(tmp_path, ack=ack)
    h.apply(ref_repl.workload())
    h.settle()
    state = h.cluster.standby.debug_state()
    assert state["ack_mode"] == ack
    h.cluster.rebuild_standby()
    h.cluster.standby.debug_state()
    h.promote_standby(force=True)
    h.settle()
    assert h.cluster.standby is None
