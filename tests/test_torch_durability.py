"""The port's durable store against the JAX package's, in lockstep.

tests/test_durability.py's and tests/test_partitioned_wal.py's tests run
here against both packages. Their modules' names are swapped while this
module runs: `Harness` is `LockstepHarness`, `ChaosHarness`
`LockstepChaosHarness`, and `ObjectStore`, `Cluster`, `PartitionedLog`,
`SimClock` and `MetricsRegistry` build one object a package
(tests/torch_lockstep.py); `settled_fingerprint` and `check_invariants`
run in both and must agree. Every object read is held equal to the
port's, and the planes (pods, gangs, statuses, events, leases, the
ShardMap, metrics, decisions) after every step, the cold restarts
included. `assert_bit_identical` then holds a store the port recovered
equal to the one it journaled, as it does the reference's.

The port writes its WAL into a twin directory beside the test's
(`PATH_ROOTS`); a test that edits the files by hand edits both trees.

What cannot be equal is the bytes. Records and snapshots are pickles
that name each package's own modules (`grove_tpu_torch.api.types`
against `grove_tpu.api.types`), so `wal_bytes_total`, the segments'
sizes and the CRCs differ, and with them a snapshot cut by size
(`wal_max_bytes`): the reference's suites cut at 64 KiB, and at the same
history the two packages cross that line on different records. So the
inherited suites run with `wal_max_bytes` raised past any history here
(4 MiB): both packages cut only on the virtual clock, on force and at
recovery, and all of it is held equal. `TestPickledModuleNames` shows
the difference at the reference's own 64 KiB: the decoded record stream
(kind, seq, lsn, clock, term, event) is the same, the bytes are not, each
package cuts where its own segment crosses the limit, and the stores each
recovers are equal object by object. Byte counts are left out of the
lockstep comparisons (`_WALLS` in tests/test_torch_harness.py).

The round write batcher's unit cases (callbacks that record into the
test's own list) run against the port alone: the module's `WriteBatch` is
the port's for those tests, and the reference's assertions hold it.
"""

from __future__ import annotations

import os
import pickle

import pytest

import test_durability as ref_dur
import test_partitioned_wal as ref_part
import torch_lockstep as ls
from grove_tpu.api.config import load_operator_config as jax_load
from grove_tpu.cluster.clock import SimClock as JaxClock
from grove_tpu.cluster.cluster import Cluster as JaxCluster
from grove_tpu.cluster.durability import PartitionedLog as JaxPartitioned
from grove_tpu.cluster.store import ObjectStore as JaxStore
from grove_tpu.controller import Harness as JaxHarness
from grove_tpu.observability import MetricsRegistry as JaxMetrics
from grove_tpu_torch.api.config import load_operator_config as torch_load
from grove_tpu_torch.cluster.clock import SimClock as TorchClock
from grove_tpu_torch.cluster.cluster import Cluster as TorchCluster
from grove_tpu_torch.cluster.durability import (
    PartitionedLog as TorchPartitioned,
)
from grove_tpu_torch.cluster.store import ObjectStore as TorchStore
from grove_tpu_torch.controller import Harness as TorchHarness
from grove_tpu_torch.controller.concurrency import WriteBatch as TorchBatch
from grove_tpu_torch.observability import MetricsRegistry as TorchMetrics

from test_torch_harness import (  # noqa: F401  (_compare_at_teardown: autouse)
    PATH_ROOTS,
    LockstepHarness,
    _compare_at_teardown,
    _tree,
    inherit,
    to_port,
)

#: the reference suites' durability cadence (64 KiB size cut), and the
#: same with the size cut out of reach (see the module docstring)
DUR_REFERENCE = dict(ref_dur.DUR)
DUR_NO_SIZE_CUT = {**DUR_REFERENCE, "wal_max_bytes": 1 << 22}

ObjectStore = ls.LockstepClass(JaxStore, TorchStore)
Cluster = ls.LockstepClass(JaxCluster, TorchCluster)


@pytest.fixture(autouse=True, scope="module")
def _durability_in_lockstep():
    names = {
        "Harness": LockstepHarness,
        "ChaosHarness": ls.LockstepChaosHarness,
        "ObjectStore": ObjectStore,
        "PartitionedLog": ls.LockstepClass(JaxPartitioned, TorchPartitioned),
        "SimClock": ls.LockstepClass(JaxClock, TorchClock),
        "MetricsRegistry": ls.LockstepClass(JaxMetrics, TorchMetrics),
        "settled_fingerprint": ls.settled_fingerprint,
        "check_invariants": ls.check_invariants,
        "load_operator_config": ls.load_both(jax_load, torch_load),
        "DUR": DUR_NO_SIZE_CUT,
        "os": ls.twin_os,
        "open": ls.twin_open,
    }
    with pytest.MonkeyPatch.context() as mp:
        for mod in (ref_dur, ref_part):
            for name, value in names.items():
                mp.setattr(mod, name, value, raising=False)
        # the in-body imports of the reference's cases
        mp.setattr("grove_tpu.cluster.cluster.Cluster", Cluster)
        mp.setattr(shutil_module(), "rmtree", ls.twin_rmtree)
        yield


def shutil_module():
    import shutil

    return shutil


@pytest.fixture
def tmp_path(tmp_path):
    """The test's directory, with the port's twin registered for it."""
    path, pair = ls.twin_tmp_path(tmp_path)
    yield path
    PATH_ROOTS.remove(pair)


@pytest.fixture
def port_batch(monkeypatch):
    """The write batcher's unit cases run on the port's WriteBatch."""
    monkeypatch.setattr(ref_part, "WriteBatch", TorchBatch)


globals().update(inherit(ref_dur, "Durability"))
globals().update(inherit(
    ref_part, "Partitioned",
    leave_out={"TestPartitionAwareWriteBatch": (
        "test_partition_failure_requeues_without_blocking_others",
        "test_unkeyed_tasks_share_the_residual_group",
        "test_without_partitioner_failure_halts_the_round")}))


@pytest.mark.usefixtures("port_batch")
class TestPartitionedWriteBatchOnThePort(
        ref_part.TestPartitionAwareWriteBatch):
    """test_partitioned_wal.TestPartitionAwareWriteBatch's unit cases on
    the port's WriteBatch alone (their callbacks append to the test's
    own list, so both packages cannot share them); its Harness case runs
    in lockstep above."""

    test_manager_flush_routes_by_store_partition = None


# -- the bytes: the pickles name each package's modules --------------------
def _history(h):
    """The reference's durable workload, then a second set."""
    h.apply(ref_dur.simple_pcs(cliques=[ref_dur.clique("w", replicas=3)]))
    h.settle()
    h.apply(ref_dur.simple_pcs(cliques=[ref_dur.clique("x", replicas=2)],
                               name="simple2"))
    h.settle()


def _records(package_durability, wal_dir):
    """Every record of a WAL directory's segments, in order."""
    out = []
    for name in sorted(os.listdir(wal_dir)):
        if not name.startswith("wal-"):
            continue
        path = os.path.join(wal_dir, name)
        for rec in package_durability._read_records(path):
            out.append(rec)
    return out


def _record_view(rec):
    """A decoded record as plain data: its kind, seq or lsn, clock and
    term, and the event it carries (class names and fields)."""
    kind = rec[0]
    if kind == "event":
        ev = rec[3]
        term = rec[4] if len(rec) > 4 else 0
        return (kind, rec[1], rec[2], term, _tree(ev))
    return tuple(rec)


class TestPickledModuleNames:
    """The reference's 64 KiB size cut, both packages, no lockstep: what
    the pickled module names change and what they do not."""

    @pytest.fixture
    def pair(self, tmp_path):
        cfg = {"durability": DUR_REFERENCE}
        hj = JaxHarness(nodes=ref_dur.make_nodes(ref_dur.NODES), config={
            "durability": {**cfg["durability"],
                           "wal_dir": str(tmp_path / "jax")}})
        ht = TorchHarness(nodes=to_port(ref_dur.make_nodes(ref_dur.NODES)),
                          config={"durability": {
                              **cfg["durability"],
                              "wal_dir": str(tmp_path / "torch")}},
                          device="cpu")
        _history(hj)
        _history(_PortHistory(ht))
        return hj, ht, tmp_path

    def test_record_stream_is_equal_and_bytes_are_not(self, pair):
        import grove_tpu.cluster.durability as jd
        import grove_tpu_torch.cluster.durability as td

        hj, ht, tmp = pair
        rj = _records(jd, str(tmp / "jax"))
        rt = _records(td, str(tmp / "torch"))
        assert [_record_view(r) for r in rt] == [_record_view(r) for r in rj]
        assert len(rj) == hj.cluster.durability.wal_records_total
        dj, dt = hj.cluster.durability, ht.cluster.durability
        assert dt.wal_records_total == dj.wal_records_total
        # the port's pickles are longer: "grove_tpu_torch" names each
        # class where the reference's says "grove_tpu"
        assert dt.wal_bytes_total > dj.wal_bytes_total
        # each package's byte counter counts its own bytes
        for h in (hj, ht):
            assert h.cluster.metrics.counter(
                "grove_store_wal_bytes_total").total() == \
                h.cluster.durability.wal_bytes_total
        payload_j = pickle.dumps(rj[-1], protocol=pickle.HIGHEST_PROTOCOL)
        payload_t = pickle.dumps(rt[-1], protocol=pickle.HIGHEST_PROTOCOL)
        assert b"grove_tpu_torch." in payload_t
        assert b"grove_tpu_torch." not in payload_j

    def test_each_package_cuts_where_its_own_segment_crosses(self, pair):
        """The size cut: each package snapshots at the first commit where
        its own genesis segment reached `wal_max_bytes` (the time cadence
        does not fire in this history), so the cut seqs follow each
        package's record sizes."""
        import grove_tpu.cluster.durability as jd
        import grove_tpu_torch.cluster.durability as td

        hj, ht, tmp = pair
        limit = DUR_REFERENCE["wal_max_bytes"]
        for pkg, h, sub in ((jd, hj, "jax"), (td, ht, "torch")):
            seg = os.path.join(str(tmp / sub), f"wal-{0:020d}.log")
            crossed, size = None, len(pkg.WAL_MAGIC)
            for rec in pkg._read_records(seg):
                payload = pickle.dumps(rec, protocol=pickle.HIGHEST_PROTOCOL)
                size += pkg._HDR.size + len(payload)
                if crossed is None and size >= limit:
                    crossed = rec[1]
            assert h.cluster.durability.snapshot_seqs()[0] == crossed
        assert (hj.cluster.durability.snapshot_seqs()
                != ht.cluster.durability.snapshot_seqs())

    def test_recovered_stores_are_equal(self, pair):
        """Cut at different records, both recover to stores equal object
        by object, with equal counters and fingerprints."""
        hj, ht, tmp = pair
        sj = JaxStore.recover(str(tmp / "jax"))
        st = TorchStore.recover(str(tmp / "torch"))
        for attr in ("last_seq", "compaction_horizon", "_kind_serial",
                     "_uid", "event_log_length"):
            assert getattr(st, attr) == getattr(sj, attr), attr
        assert _tree(st._objs) == _tree(sj._objs)
        assert _tree(list(st._events)) == _tree(list(sj._events))
        assert _tree(ls.torch_fingerprint(st)) == _tree(
            ls.jax_fingerprint(sj))
        stats_j, stats_t = sj.recovery_stats, st.recovery_stats
        assert stats_t["outcome"] == stats_j["outcome"] == "clean"
        # the snapshot each recovered from sits at its own cut
        assert stats_t["snapshot_seq"] == \
            ht.cluster.durability.snapshot_seqs()[-1]
        assert stats_j["snapshot_seq"] == \
            hj.cluster.durability.snapshot_seqs()[-1]


class _PortHistory:
    """`_history`'s calls on a port harness, its objects carried over."""

    def __init__(self, h):
        self._h = h

    def apply(self, pcs):
        return self._h.apply(to_port(pcs))

    def settle(self):
        self._h.settle()


# -- the port's own cases -------------------------------------------------------
def test_a_wal_the_port_wrote_recovers_in_the_port(tmp_path):
    """No JAX package in the loop: the port journals, a new process of
    the port boots from its files alone, on the CPU, and reaches the same
    fixpoint; the native store's C clone is still the store's."""
    from grove_tpu_torch.chaos import settled_fingerprint as fp
    from grove_tpu_torch.cluster import store as store_mod

    cfg = {"durability": {"wal_dir": str(tmp_path / "wal"),
                          "fsync": "commit"}}
    old = TorchHarness(nodes=to_port(ref_dur.make_nodes(8)), config=cfg,
                       device="cpu")
    old.apply(to_port(ref_dur.workload()))
    old.settle()
    want = fp(old.store)
    native = store_mod.NATIVE_STORE_ACTIVE
    old.cluster.durability.close()
    h = TorchHarness.recover(cfg, device="cpu")
    assert h.store.recovery_stats["outcome"] == "clean"
    assert h.scheduler._engine_kwargs["device"] == "cpu"
    h.settle()
    assert fp(h.store) == want
    assert store_mod.NATIVE_STORE_ACTIVE == native


def test_nothing_on_the_card_goes_into_a_snapshot(tmp_path):
    """The snapshot state is the store's objects, events, kind serials
    and clock: after a settle with a solve, no object of the store holds
    a tensor, a CUDA stream, a ctypes handle or a native store object,
    and the snapshot pickles without them."""
    import ctypes

    import torch

    from grove_tpu_torch.cluster import durability as td

    h = TorchHarness(nodes=to_port(ref_dur.make_nodes(8)), config={
        "durability": {"wal_dir": str(tmp_path / "wal"), "fsync": "never"}},
        device="cpu")
    h.apply(to_port(ref_dur.workload()))
    h.settle()
    forbidden = (torch.Tensor, torch.Stream, ctypes._SimpleCData,
                 ctypes._Pointer, ctypes.Structure)

    def walk(v, seen):
        if id(v) in seen:
            return
        seen.add(id(v))
        assert not isinstance(v, forbidden), type(v)
        assert type(v).__module__.split(".")[0] in (
            "builtins", "grove_tpu_torch", "enum", "datetime"), type(v)
        children = (v.values() if isinstance(v, dict) else
                    v if isinstance(v, (list, tuple, set, frozenset)) else
                    vars(v).values() if hasattr(v, "__dict__") else ())
        for c in children:
            walk(c, seen)

    store = h.store
    walk([store._objs, list(store._events), store._kind_serial], set())
    seq = h.cluster.durability.snapshot(store, force=True)
    state = td._try_load_snapshot(h.cluster.durability._snapshot_path(seq))
    assert state is not None and state["last_seq"] == store.last_seq


def test_cold_restart_releases_the_old_engines(tmp_path):
    """A cold restart rebuilds the managers, and with them every engine,
    on the harness's device; the engines of the crashed managers are
    released (no pending dispatch, no resident state)."""
    h = TorchHarness(nodes=to_port(ref_dur.make_nodes(8)), config={
        "durability": {"wal_dir": str(tmp_path / "wal"), "fsync": "never"},
        "controllers": {"shards": 2}}, device="cpu")
    h.apply(to_port(ref_dur.workload()))
    h.settle()
    old = h.schedulers()
    engines = [s._engine for s in old]
    assert any(e is not None for e in engines)
    h.cold_restart()
    assert all(s._engine is None and s._pending is None for s in old)
    for e in engines:
        if e is not None:
            assert e._statics is None and e._free_buf is None
    h.settle()
    assert all(s._engine_kwargs["device"] == "cpu" for s in h.schedulers())
    assert not set(map(id, h.schedulers())) & set(map(id, old))


def test_fsync_policy_is_the_configs(tmp_path, monkeypatch):
    """`fsync: commit` syncs every append (the config's default), and
    `never` none: the port keeps the policy it is given."""
    from grove_tpu_torch.cluster import durability as td

    calls = []
    monkeypatch.setattr(td.os, "fsync", lambda fd: calls.append(fd))
    for policy in ("commit", "never"):
        calls.clear()
        h = TorchHarness(nodes=to_port(ref_dur.make_nodes(4)), config={
            "durability": {"wal_dir": str(tmp_path / policy),
                           "fsync": policy}}, device="cpu")
        records = h.cluster.durability.wal_records_total
        assert records > 0
        assert (len(calls) >= records) if policy == "commit" else not calls
        h.cluster.durability.close()


def test_wal_tailer_reads_what_the_reference_reads(tmp_path):
    """`WalTailer.poll` over the same history in both packages yields the
    same records in the same order, and picks up records appended after
    its first poll."""
    import grove_tpu.cluster.durability as jd
    import grove_tpu_torch.cluster.durability as td

    hj = JaxHarness(nodes=ref_dur.make_nodes(8), config={"durability": {
        "wal_dir": str(tmp_path / "jax"), "fsync": "never"}})
    ht = TorchHarness(nodes=to_port(ref_dur.make_nodes(8)), config={
        "durability": {"wal_dir": str(tmp_path / "torch"),
                       "fsync": "never"}}, device="cpu")
    tj, tt = jd.WalTailer(str(tmp_path / "jax")), td.WalTailer(
        str(tmp_path / "torch"))
    first_j, first_t = list(tj.poll()), list(tt.poll())
    assert first_j and [_record_view(r) for r in first_t] == [
        _record_view(r) for r in first_j]
    hj.apply(ref_dur.workload())
    ht.apply(to_port(ref_dur.workload()))
    hj.settle()
    ht.settle()
    more_j, more_t = list(tj.poll()), list(tt.poll())
    assert more_j and [_record_view(r) for r in more_t] == [
        _record_view(r) for r in more_j]
