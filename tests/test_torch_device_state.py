"""The device-resident free state, the fused and incremental re-solves and
async dispatch: grove_tpu_torch's PlacementEngine vs the JAX package's.

A `Twin` holds the JAX engine and the port's (`device="cpu"`, the kernels'
plain versions) with the same knobs, on the same cluster and backlog
carried across with grove_tpu_torch.convert, and drives both through the
same calls. After every solve it requires, exactly: the packed top-k each
engine's device phase returned, placements, unplaced messages, codes and
funnels, the post-solve free matrix, the path stats, `_last_begin`'s path
and rows, `dispatch_counts()`, the whole `debug_summary()["device_state"]`
block (epoch, uploads, hits, incremental rows, reuse hits, ...), the host
mirror, the staged rows and the resident tensor read back.

The classes mirror the engine-only classes of tests/test_device_state.py
as port-vs-JAX cases; each sequence also runs the port's full re-encode
engine (`state_cache=False, fused=False, incremental=False`) and holds the
paths to it. JAX runs its default tier (no interpreted Pallas) except in
one kernel-tier sequence at `_tiny_problem` size.
"""

import dataclasses

import numpy as np
import pytest

import __graft_entry__
import bench
from grove_tpu.solver import PlacementEngine as JaxEngine

from grove_tpu_torch.convert import (
    GANG_FIELDS,
    SNAPSHOT_FIELDS,
    gang_from_arrays,
    snapshot_from_arrays,
)
from grove_tpu_torch.solver import PlacementEngine
from grove_tpu_torch.solver import programs
from test_solver import cluster, gang
from test_torch_engine import assert_same_result

FULL = {"state_cache": False, "fused": False, "incremental": False}
KERNEL_TIER = {"pallas_core": True, "device_commit": True}
PATH_STATS = ("dispatch_overlap", "incremental", "incremental_rows", "reused")


def port_snapshot(snap):
    return snapshot_from_arrays(**{f: getattr(snap, f) for f in SNAPSHOT_FIELDS})


def port_gang(g):
    return gang_from_arrays(**{f: getattr(g, f) for f in GANG_FIELDS})


def pair(g):
    """(the JAX gang, its port twin)."""
    return g, port_gang(g)


def mk(name, pods=2, cpu=2.0, **kw):
    return pair(gang(name, pods=pods, cpu=cpu, **kw))


def flip_schedulable(snap, rows):
    """A rebuild-shaped snapshot: same statics, `rows` toggled."""
    sched = snap.schedulable.copy()
    sched[list(rows)] = ~sched[list(rows)]
    return dataclasses.replace(snap, schedulable=sched)


def resident(eng, staged=False):
    """The resident free tensor read back, unpadded, as numpy (either
    package); `staged`: with the staged rows laid over it, the content the
    next launch scores against (the JAX engine's CPU buffer may alias its
    mirror, so only that view compares across the packages while rows are
    staged)."""
    dev = eng._state.dev
    n = eng.snapshot.num_nodes
    out = (dev[:n].numpy() if hasattr(dev, "numpy") else np.asarray(dev)[:n])
    out = out.copy()
    for i, row in (eng._staged or {}).items() if staged else ():
        out[i] = row
    return out


def _record_device_end(eng):
    """Keep the (top_val, top_dom) each device phase hands the repair."""
    orig = eng._device_end

    def device_end(token):
        out = orig(token)
        eng.last_packed = out
        return out

    eng._device_end = device_end
    eng.last_packed = None


class Twin:
    """The JAX engine and the port's with the same knobs (and the port's
    full re-encode engine as the reference of every path), driven through
    the same calls and held equal after each."""

    def __init__(self, snap, **knobs):
        self.jsnap, self.tsnap = snap, port_snapshot(snap)
        self.j = JaxEngine(snap, **knobs)
        self.t = PlacementEngine(self.tsnap, device="cpu", **knobs)
        self.ref = PlacementEngine(self.tsnap, device="cpu",
                                   **{**knobs, **FULL})
        for eng in (self.j, self.t):
            _record_device_end(eng)

    # -- driving both --------------------------------------------------------
    def note(self, rows):
        self.j.note_free_rows(rows)
        self.t.note_free_rows(rows)

    def sync(self, free, defer=False):
        e = self.j._sync_free(free.copy(), defer=defer)
        assert self.t._sync_free(free.copy(), defer=defer) == e
        self.check_state()
        return e

    def rebind(self, snap):
        ok = self.j.rebind(snap)
        tsnap = port_snapshot(snap)
        assert self.t.rebind(tsnap) == ok
        if ok:
            assert self.ref.rebind(tsnap)
        self.jsnap, self.tsnap = snap, tsnap
        return ok

    def invalidate(self):
        self.j.invalidate_device_state()
        self.t.invalidate_device_state()

    def dispatch(self, gangs, free, fairness=None):
        jd = self.j.dispatch([g for g, _ in gangs], free=free.copy(),
                             fairness=fairness)
        td = self.t.dispatch([g for _, g in gangs], free=free.copy(),
                             fairness=fairness)
        assert (td.path, td.rows) == (jd.path, jd.rows)
        assert (td.free0 is None) == (jd.free0 is None)
        assert td.state_epoch == jd.state_epoch
        self.check_state()
        return jd, td

    def solve(self, gangs, free=None, fairness=None, handles=(None, None),
              check_ref=True):
        """Solve on both engines (each on its own copy of `free`) and hold
        them equal; returns (port result, its post-solve free)."""
        free = self.jsnap.free.copy() if free is None else free
        jfree, tfree = free.copy(), free.copy()
        self.j.last_packed = self.t.last_packed = None
        jres = self.j.solve([g for g, _ in gangs], free=jfree,
                            fairness=fairness, dispatch=handles[0])
        tres = self.t.solve([g for _, g in gangs], free=tfree,
                            fairness=fairness, dispatch=handles[1])
        assert_same_result(jres, tres)
        np.testing.assert_array_equal(tfree, jfree)
        assert {k: tres.stats.get(k) for k in PATH_STATS} == {
            k: jres.stats.get(k) for k in PATH_STATS}
        for a, b in zip(self.t.last_packed or (), self.j.last_packed or ()):
            np.testing.assert_array_equal(a, b)
        assert (self.t.last_packed is None) == (self.j.last_packed is None)
        assert ({k: self.t._last_begin.get(k) for k in ("path", "rows")}
                == {k: self.j._last_begin.get(k) for k in ("path", "rows")})
        self.check_state()
        if check_ref:
            rfree = free.copy()
            ref = self.ref.solve([g for _, g in gangs], free=rfree,
                                 fairness=fairness)
            assert_same_result(ref, tres)
            np.testing.assert_array_equal(tfree, rfree)
        return tres, tfree

    def check_state(self):
        j, t = self.j, self.t
        assert t.dispatch_counts() == j.dispatch_counts()
        assert (t.debug_summary()["device_state"]
                == j.debug_summary()["device_state"])
        js, ts = j._state, t._state
        assert (ts.mirror is None) == (js.mirror is None)
        if js.mirror is not None:
            np.testing.assert_array_equal(ts.mirror, js.mirror)
        assert (ts.dev is None) == (js.dev is None)
        if js.dev is not None:
            np.testing.assert_array_equal(resident(t, staged=True),
                                          resident(j, staged=True))
        assert sorted(t._staged or {}) == sorted(j._staged or {})
        for i, row in (j._staged or {}).items():
            np.testing.assert_array_equal(t._staged[i], row)
        assert (t._inc is None) == (j._inc is None)


def gangs_of(n, cpu=2.0, prefix="g"):
    return [mk(f"{prefix}{i}", cpu=cpu) for i in range(n)]


class TestStateSync:
    def test_seeded_deltas_decode_bit_equal_to_full_encode(self):
        """After each of 40 seeded rounds of declared row churn,
        unknown-scope declarations, schedulable flips through rebind and
        pure hits, both engines hold the same epoch, mirror and resident
        tensor, which decodes bit-equal to a fresh full encode."""
        snap = cluster(blocks=2, racks=2, hosts=4, cpu=16.0)
        tw = Twin(snap)
        rng = np.random.default_rng(11)
        n = snap.num_nodes
        free = snap.free.copy()
        epochs = [tw.sync(free)]
        for _ in range(40):
            kind = rng.integers(4)
            if kind == 0:
                rows = rng.choice(n, size=int(rng.integers(1, 5)),
                                  replace=False)
                free[rows] *= rng.uniform(
                    0.3, 1.0, size=(rows.size, 1)).astype(np.float32)
                tw.note(rows.tolist())
            elif kind == 1:
                row = int(rng.integers(n))
                free[row] = snap.capacity[row]
                tw.note(None)
            elif kind == 2:
                assert tw.rebind(flip_schedulable(tw.jsnap,
                                                  rng.choice(n, 2, False)))
            epochs.append(tw.sync(free))
            np.testing.assert_array_equal(resident(tw.t),
                                          tw.t._masked_free(free))
        assert epochs == sorted(epochs)
        st = tw.t._state
        assert st.hits > 0 and st.delta_uploads > 0 and st.full_uploads >= 1

    def test_unchanged_content_is_a_hit_not_an_upload(self):
        snap = cluster()
        tw = Twin(snap)
        e0 = tw.sync(snap.free)
        assert tw.sync(snap.free.copy()) == e0
        assert (tw.t._state.hits, tw.t._state.full_uploads,
                tw.t._state.delta_uploads) == (1, 1, 0)

    def test_bulk_divergence_falls_back_to_full_upload(self):
        snap = cluster(blocks=4, racks=4, hosts=8, cpu=16.0)  # 128 nodes
        tw = Twin(snap)
        assert snap.num_nodes > tw.t._delta_rows_max == tw.j._delta_rows_max
        free = snap.free.copy()
        tw.sync(free)
        free *= 0.5
        tw.note(range(snap.num_nodes))
        tw.sync(free)
        assert (tw.t._state.full_uploads, tw.t._state.delta_uploads) == (2, 0)

    def test_undeclared_mutation_raises_under_verify(self):
        snap = cluster()
        tw = Twin(snap, state_verify=True)
        free = snap.free.copy()
        tw.sync(free)
        free[1] *= 0.5
        tw.note((1,))
        free[3] *= 0.5  # mutated, never declared
        for eng in (tw.j, tw.t):
            with pytest.raises(RuntimeError, match="not declared"):
                eng._sync_free(free)

    @pytest.mark.parametrize("declare", ["invalidate", "out_of_range"])
    def test_invalidate_and_out_of_range_declarations(self, declare):
        snap = cluster()
        tw = Twin(snap)
        e0 = tw.sync(snap.free)
        if declare == "invalidate":
            tw.invalidate()
            tw.check_state()
            assert tw.sync(snap.free) > e0
            assert tw.t._state.full_uploads == 2
        else:
            tw.note([-3, snap.num_nodes + 7])
            assert tw.sync(snap.free) == e0 == 1
            assert tw.t._state.hits == 1


class TestEpochGuard:
    def test_unchanged_dispatch_adopted_via_epoch(self):
        snap = cluster(blocks=2, racks=2, hosts=4, cpu=8.0)
        tw = Twin(snap)
        gangs = [mk("a", pods=2, cpu=2.0), mk("b", pods=4, cpu=6.0)]
        tw.solve(gangs)
        jd, td = tw.dispatch(gangs, snap.free)
        assert td.free0 is None
        res, _ = tw.solve(gangs, handles=(jd, td))
        assert res.stats.get("dispatch_overlap") == 1.0
        assert td.token is None  # adoption consumed the token

    @pytest.mark.parametrize("knobs", [{}, {"state_verify": True},
                                       {"state_cache": False}],
                             ids=["cache", "verify", "cache_off"])
    def test_mutation_rejects_dispatch(self, knobs):
        """A declared (or, cache off, any) free mutation between dispatch
        and solve refuses the dispatch on both engines; under verify the
        O(N*R) compare runs beside both decisions."""
        snap = cluster(blocks=2, racks=2, hosts=4, cpu=8.0)
        tw = Twin(snap, **knobs)
        gangs = [mk("a", pods=2, cpu=2.0)]
        jd, td = tw.dispatch(gangs, snap.free)
        res, _ = tw.solve(gangs, handles=(jd, td))
        assert res.stats.get("dispatch_overlap") == 1.0
        jd, td = tw.dispatch(gangs, snap.free)
        free = snap.free.copy()
        free[1] -= 2.0
        if knobs.get("state_cache", True):
            tw.note((1,))
        res, _ = tw.solve(gangs, free=free, handles=(jd, td))
        assert "dispatch_overlap" not in res.stats
        assert res.num_placed == 1

    @pytest.mark.parametrize("knobs", [{"state_cache": False},
                                       {"state_verify": True}],
                             ids=["cache_off", "verify"])
    def test_rebind_between_dispatch_and_solve_rejects_stale_mask(self, knobs):
        snap = cluster(blocks=2, racks=2, hosts=4, cpu=8.0)
        tw = Twin(snap, **knobs)
        gangs = [mk("a", pods=2, cpu=2.0)]
        handles = tw.dispatch(gangs, snap.free)
        snap2 = flip_schedulable(snap, [0])
        assert tw.rebind(snap2)
        res, _ = tw.solve(gangs, free=snap2.free.copy(), handles=handles)
        assert "dispatch_overlap" not in res.stats
        assert 0 not in np.concatenate(
            [p.node_indices for p in res.placed.values()])

    def test_cache_off_adopted_dispatch_pays_one_upload(self):
        snap = cluster(blocks=2, racks=2, hosts=4, cpu=8.0)
        tw = Twin(snap, state_cache=False)
        gangs = [mk("a", pods=2, cpu=2.0)]
        res, _ = tw.solve(gangs, handles=tw.dispatch(gangs, snap.free))
        assert res.stats.get("dispatch_overlap") == 1.0
        assert tw.t._state.full_uploads == 1

    def test_cancelled_dispatch_is_never_adopted(self):
        """cancel() drops the token (the port's scheduler must call it,
        reference fault R2); a cancelled handle is refused and the solve
        runs afresh, as the JAX engine's fresh solve."""
        snap = cluster(blocks=2, racks=2, hosts=4, cpu=8.0)
        tw = Twin(snap, incremental=False)
        gangs = [mk("a", pods=2, cpu=2.0)]
        jd, td = tw.dispatch(gangs, snap.free)
        td.cancel()
        assert td.token is None
        tw.j.solve([g for g, _ in gangs])  # JAX's cancel is a no-op: afresh
        res = tw.t.solve([g for _, g in gangs], dispatch=td)
        assert "dispatch_overlap" not in res.stats
        tw.check_state()


class TestRebind:
    def test_schedulable_flip_rides_the_delta_path(self):
        snap = cluster(blocks=2, racks=2, hosts=2, cpu=8.0)
        tw = Twin(snap, state_verify=True)
        tw.sync(snap.free)
        snap2 = flip_schedulable(snap, [0])
        assert tw.rebind(snap2)
        assert tw.t.snapshot is tw.tsnap
        tw.sync(snap2.free)
        assert (tw.t._state.full_uploads, tw.t._state.delta_uploads) == (1, 1)
        assert (resident(tw.t)[0] == 0.0).all()
        res, _ = tw.solve([mk(f"g{i}", pods=2, cpu=8.0) for i in range(4)],
                          free=snap2.free.copy())
        assert 0 not in np.concatenate(
            [p.node_indices for p in res.placed.values()])

    def test_rebind_rejects_static_encoding_change(self):
        tw = Twin(cluster(blocks=2, racks=2, hosts=2))
        assert not tw.rebind(cluster(blocks=2, racks=2, hosts=4))
        assert not tw.rebind(cluster(blocks=2, racks=2, hosts=2, cpu=16.0))


class TestFusedStaging:
    @pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
    def test_warm_solves_and_delta_launches(self, fused):
        """Fused: one launch a solve, the staged delta riding it (no
        scatter launch, nothing left staged, the resident tensor caught
        up). Split: the standalone scatter is its own launch."""
        snap = cluster(blocks=2, racks=2, hosts=4, cpu=8.0)
        tw = Twin(snap, state_verify=True, incremental=False, fused=fused)
        gangs = gangs_of(4)
        tw.solve(gangs)
        free = snap.free.copy()
        free[2] *= 0.5
        tw.note([2])
        res, _ = tw.solve(gangs, free=free)
        assert res.num_placed == 4
        assert tw.t._state.delta_uploads == 1 and tw.t._staged is None
        assert tw.t._dispatches == (
            {"fused": 2, "split": 0, "incremental": 0, "whatif": 0} if fused
            else {"fused": 0, "split": 3, "incremental": 0, "whatif": 0})
        np.testing.assert_array_equal(resident(tw.t), tw.t._masked_free(free))

    def test_staged_rows_merge_latest_and_full_upload_supersedes(self):
        snap = cluster(blocks=4, racks=4, hosts=8, cpu=16.0)  # 128 nodes
        tw = Twin(snap)
        free = snap.free.copy()
        tw.sync(free)
        for _ in range(2):  # re-staging a row keeps its latest values
            free[3] *= 0.5
            tw.note([3])
            tw.sync(free, defer=True)
        np.testing.assert_array_equal(tw.t._staged[3],
                                      tw.t._masked_free(free)[3])
        free *= 0.25
        tw.note(range(snap.num_nodes))
        tw.sync(free, defer=True)
        assert tw.t._staged is None
        np.testing.assert_array_equal(resident(tw.t), tw.t._masked_free(free))

    def test_verify_accounts_for_staged_rows(self):
        snap = cluster(blocks=2, racks=2, hosts=4, cpu=8.0)
        tw = Twin(snap, state_verify=True)
        free = snap.free.copy()
        tw.sync(free)
        free[1] *= 0.5
        tw.note([1])
        tw.sync(free, defer=True)  # staged; verify ran clean on both
        free[4] *= 0.5
        tw.note([2])  # a declaration that excludes the mutated row
        for eng in (tw.j, tw.t):
            with pytest.raises(RuntimeError, match="not declared"):
                eng._sync_free(free, defer=True)


class TestIncremental:
    """The dirty-row tiers against the JAX engine and the port's full
    reference: zero-launch reuse, the O(dirty) re-score, and the full
    fallback on any invalidation."""

    def _armed(self, n_gangs=6):
        snap = cluster(blocks=2, racks=2, hosts=4, cpu=8.0)
        tw = Twin(snap, state_verify=True)
        gangs = gangs_of(n_gangs)
        first, _ = tw.solve(gangs)
        assert first.num_placed == n_gangs
        return snap, tw, gangs

    def test_identical_retry_tick_reuses_without_dispatch(self):
        snap, tw, gangs = self._armed()
        before = dict(tw.t._dispatches)
        res, _ = tw.solve(gangs)
        assert res.stats.get("reused") == 1.0
        assert tw.t._dispatches == before and tw.t._inc_reuse_hits == 1

    @pytest.mark.parametrize("tick", ["dirty", "removed", "removed_full_bucket",
                                      "fairness", "mostly_dirty"])
    def test_ticks(self, tick):
        """removed_full_bucket: the cached backlog fills its bucket (8 of
        8 rows), so the cache's last row is a real gang's, and the
        re-solve's padding row must still come out -1e9 through the dummy
        index (the packed top-k's padding rows are compared too)."""
        snap, tw, gangs = self._armed(8 if tick == "removed_full_bucket" else 6)
        fairness = None
        if tick == "dirty":
            gangs[1] = mk("h1", cpu=3.0)
            gangs[4] = mk("h4", cpu=1.0)
            want = ("incremental", 2.0)
        elif tick.startswith("removed"):
            gangs = gangs[:3] + gangs[4:]
            want = ("incremental", 0.0)
        elif tick == "fairness":
            fairness = {"g2": 0.75}
            want = ("incremental", 1.0)
        else:
            gangs = gangs_of(6, prefix="x")
            want = (None, None)
        res, _ = tw.solve(gangs, fairness=fairness)
        assert (res.stats.get("incremental") and "incremental",
                res.stats.get("incremental_rows")) == want
        if want[0]:
            assert tw.t._dispatches["incremental"] == 1

    def test_epoch_divergence_falls_back_then_resumes(self):
        snap, tw, gangs = self._armed()
        free = snap.free.copy()
        free[2] *= 0.5
        tw.note([2])
        res, _ = tw.solve(gangs, free=free)
        assert "incremental" not in res.stats and "reused" not in res.stats
        gangs[0] = mk("h0")
        res2, _ = tw.solve(gangs, free=free)
        assert res2.stats.get("incremental") == 1.0

    def test_dispatch_adoption_of_incremental_scores(self):
        snap, tw, gangs = self._armed()
        gangs[2] = mk("h2", cpu=2.5)
        jd, td = tw.dispatch(gangs, snap.free)
        assert td.path == "incremental" and td.rows == 1
        res, _ = tw.solve(gangs, handles=(jd, td))
        assert res.stats.get("dispatch_overlap") == 1.0
        assert res.stats.get("incremental") == 1.0

    def test_invalidate_clears_the_value_cache(self):
        snap, tw, gangs = self._armed()
        tw.invalidate()
        assert tw.t._inc is None
        res, _ = tw.solve(gangs)
        assert "incremental" not in res.stats and "reused" not in res.stats


class TestIncrementalChaosFallback:
    def test_cordon_shaped_rebind_between_dirty_ticks(self):
        snap = cluster(blocks=2, racks=2, hosts=4, cpu=8.0)
        tw = Twin(snap, state_verify=True)
        gangs = gangs_of(6)
        tw.solve(gangs)
        gangs[0] = mk("h0")
        res, _ = tw.solve(gangs)
        assert res.stats.get("incremental") == 1.0
        snap2 = flip_schedulable(snap, [0])
        assert tw.rebind(snap2)
        assert tw.t._inc is None
        gangs[1] = mk("h1")
        res2, _ = tw.solve(gangs, free=snap2.free.copy())
        assert "incremental" not in res2.stats and "reused" not in res2.stats
        assert 0 not in np.concatenate(
            [p.node_indices for p in res2.placed.values()])
        snap3 = flip_schedulable(snap2, [0])
        assert tw.rebind(snap3)
        tw.solve(gangs, free=snap3.free.copy())
        gangs[2] = mk("h2")
        res3, _ = tw.solve(gangs, free=snap3.free.copy())
        assert res3.stats.get("incremental") == 1.0


def _masked_backlog():
    """A small cluster and a backlog with shared per-pod eligibility
    masks (one that no node satisfies) and three demand templates."""
    snap, gangs = __graft_entry__._tiny_problem(num_nodes=16, num_gangs=12)
    left = np.zeros(snap.num_nodes, bool)
    left[:8] = True
    nowhere = np.zeros(snap.num_nodes, bool)
    for i, g in enumerate(gangs):
        if i % 3 == 0:
            g.pod_elig = [left, None]
        g.demand = g.demand * np.float32(1 + i % 3)
    gangs[4].pod_elig = [nowhere, nowhere]
    return snap, gangs


def test_encode_fingerprints_equal_jax_byte_for_byte():
    snap, gangs = _masked_backlog()
    tw = Twin(snap)
    jenc = tw.j._encode_arrays(gangs)
    tenc = tw.t._encode_arrays([port_gang(g) for g in gangs])
    assert tenc.keys == jenc.keys and tenc.gang_sigs == jenc.gang_sigs
    assert tenc.fps == jenc.fps and len(set(tenc.fps)) > 3
    assert all(isinstance(fp, bytes) for fp in tenc.fps)
    assert tenc.g_pad == jenc.g_pad
    for a, b in zip(tenc.sig, jenc.sig):
        np.testing.assert_array_equal(a, b)
    # only the incremental planner reads fingerprints
    off = PlacementEngine(tw.tsnap, device="cpu", incremental=False)
    assert off._encode_arrays([port_gang(g) for g in gangs]).fps == []


def _sequence(tw, snap, gangs, make, seed=7):
    """bench.py --equivalence's scenarios on one Twin: warm and reused
    solves, a dispatch/adopt round and a dispatch staled by a declared
    mutation, seeded bind/unbind churn carrying committed capacity forward,
    fairness weights, dirty ticks of 1 and 3 gangs at an unchanged epoch,
    an incremental dispatch adopted, and a cordon-shaped rebind
    mid-stream. Returns the port's paths, in order."""
    rng = np.random.default_rng(seed)
    n = snap.num_nodes
    paths = []

    def solve(free, **kw):
        res, out = tw.solve(gangs, free=free, **kw)
        paths.append("adopted" if res.stats.get("dispatch_overlap")
                     else "incremental" if res.stats.get("incremental")
                     else "reused" if res.stats.get("reused") else "full")
        return out

    free = snap.free.copy()
    solve(free)
    solve(free)
    handles = tw.dispatch(gangs, free)
    solve(free, handles=handles)
    handles = tw.dispatch(gangs, free)
    stale = free.copy()
    row = int(rng.integers(n))
    stale[row] *= 0.5
    tw.note((row,))
    solve(stale, handles=handles)
    tw.note(None)  # the stale row reverts undeclared: unknown scope
    for _ in range(3):
        rows = rng.choice(n, size=min(16, n), replace=False)
        free[rows] = np.minimum(
            snap.capacity[rows],
            free[rows] * rng.uniform(0.4, 1.1, (rows.size, 1)),
        ).astype(np.float32)
        tw.note(rows.tolist())
        free = solve(free)
    fair = {g.name: round(float(rng.uniform(-0.5, 1.5)), 6) for g, _ in gangs}
    solve(free, fairness=fair)
    solve(free, fairness=fair)
    for k in (1, 3):
        for j in range(k):
            gangs[(3 * j + k) % len(gangs)] = make(f"fresh-{k}-{j}")
        solve(free)
    gangs[0] = make("fresh-adopt")
    handles = tw.dispatch(gangs, free)
    solve(free, handles=handles)
    flip = int(rng.integers(n))
    assert tw.rebind(flip_schedulable(tw.jsnap, [flip]))
    solve(free)
    gangs[1] = make("fresh-resume")
    solve(free)
    return paths


@pytest.mark.parametrize("knobs", [
    {"state_verify": True},
    {"state_verify": True, "incremental": False},
    {"state_verify": True, "fused": False, "incremental": False},
    FULL,
], ids=["inc", "fused", "delta", "full"])
def test_stress_sequence_matches_jax(knobs):
    """Every path along the equivalence sequence, at bench's stress shape
    cut to 512 nodes and 64 gangs: bit-equal to the JAX engine with the
    same knobs and to the port's full re-encode engine."""
    snap, jgangs = bench.make_cluster(512), bench.make_gangs(64)
    spare = bench.make_gangs(1)[0]

    def make(name):
        g = dataclasses.replace(spare, name=name)
        return pair(g)

    tw = Twin(snap, **knobs)
    paths = _sequence(tw, snap, [pair(g) for g in jgangs], make)
    if knobs is FULL or not knobs.get("incremental", True):
        assert "incremental" not in paths and "reused" not in paths
    else:
        assert paths.count("incremental") >= 2 and "reused" in paths
    assert paths.count("adopted") == 2


def test_kernel_tier_sequence_matches_jax():
    """The kernel tier (JAX's Pallas kernel interpreted, the port's
    kernels' plain versions) along the sequence at `_tiny_problem` size,
    with masked gangs of three demand templates: every path bit-equal."""
    snap, jgangs = _masked_backlog()
    spare = __graft_entry__._tiny_problem(num_nodes=16, num_gangs=1)[1][0]

    def make(name):
        return pair(dataclasses.replace(spare, name=name))

    tw = Twin(snap, state_verify=True, **KERNEL_TIER)
    paths = _sequence(tw, snap, [pair(g) for g in jgangs], make)
    assert "incremental" in paths and "reused" in paths
    ds = tw.t.debug_summary()["device_state"]
    assert ds["core_tier"] == "pallas-fp32" and ds["pallas_interpret"]
    assert ds["dispatches"]["pallas"] > 0 and ds["dispatches"]["device_commit"] > 0


class TestWhatIf:
    def _armed(self):
        snap = cluster(blocks=2, racks=2, hosts=4, cpu=8.0)
        tw = Twin(snap, state_verify=True)
        gangs = gangs_of(4)
        free = snap.free.copy()
        jfree, tfree = free.copy(), free.copy()
        tw.j.solve([g for g, _ in gangs], free=jfree)
        tw.t.solve([g for _, g in gangs], free=tfree)
        np.testing.assert_array_equal(tfree, jfree)
        return snap, tw, tfree

    @pytest.mark.parametrize("overlay", [False, True])
    def test_whatif_matches_jax_and_mutates_nothing(self, overlay):
        snap, tw, free = self._armed()
        probes = [mk("w0"), mk("w1", pods=4, cpu=4.0)]
        rows = None
        if overlay:
            rows = {3: snap.capacity[3], 5: snap.capacity[5] * 0.5}
        for step in range(2):
            # the first what-if stages the solve's repair commits (a real
            # content change); from then on nothing resident may move
            if step:
                before = (tw.t._state.epoch, tw.t._inc, dict(tw.t._staged or {}),
                          resident(tw.t), tw.t._state.mirror.copy(),
                          tw.t.dispatch_counts())
            jv, jd, jo = tw.j.whatif_scores([g for g, _ in probes],
                                            free=free.copy(), free_rows=rows)
            tv, td, to = tw.t.whatif_scores([g for _, g in probes],
                                            free=free.copy(), free_rows=rows)
            np.testing.assert_array_equal(tv, jv)
            np.testing.assert_array_equal(td, jd)
            assert [g.name for g in to] == [g.name for g in jo]
            tw.check_state()
        epoch, inc, staged, dev, mirror, counts = before
        assert tw.t._state.epoch == epoch and tw.t._inc is inc
        assert sorted(tw.t._staged or {}) == sorted(staged)
        np.testing.assert_array_equal(resident(tw.t), dev)
        np.testing.assert_array_equal(tw.t._state.mirror, mirror)
        counts["whatif"] += 1
        assert tw.t.dispatch_counts() == counts
        res, _ = tw.solve([mk(f"h{i}") for i in range(3)], free=free)
        assert res.num_placed == 3

    def test_overlay_changes_the_ranking(self):
        snap = cluster(blocks=1, racks=2, hosts=2, cpu=4.0)
        tw = Twin(snap)
        free = snap.free.copy()
        res, free = tw.solve([mk(f"f{i}", pods=1, cpu=4.0) for i in range(2)],
                             free=free)
        committed = sorted(i for p in res.placed.values()
                           for i in p.node_indices)
        probe = [port_gang(gang("w0", pods=1, cpu=4.0))]
        base = tw.t.whatif_scores(probe, free=free)[0]
        over = tw.t.whatif_scores(
            probe, free=free,
            free_rows={committed[0]: snap.capacity[committed[0]]})[0]
        assert over.max() > base.max()

    @pytest.mark.parametrize("knobs", [{"state_cache": False},
                                       {"fused": False}])
    def test_no_resident_whatif_returns_none(self, knobs):
        snap = cluster(blocks=2, racks=2, hosts=4, cpu=8.0)
        eng = PlacementEngine(port_snapshot(snap), device="cpu", **knobs)
        eng.solve([port_gang(gang("g0", pods=2, cpu=2.0))])
        assert eng.whatif_scores([port_gang(gang("w", pods=2))]) is None


@pytest.mark.parametrize("mode", ["warm", "delta", "full", "commit"])
def test_measure_device_split_keys(mode):
    """measure_device_split runs in all four modes on the CPU and reports
    the JAX engine's keys (times are not compared: a CPU run is no
    measurement of the card)."""
    snap = cluster(blocks=2, racks=2, hosts=4, cpu=8.0)
    gangs = [gang(f"g{i}", pods=2, cpu=2.0) for i in range(4)]
    ref = JaxEngine(snap).measure_device_split(gangs, free=snap.free.copy(),
                                               iters=3, mode=mode)
    eng = PlacementEngine(port_snapshot(snap), device="cpu")
    out = eng.measure_device_split([port_gang(g) for g in gangs],
                                   free=snap.free.copy(), iters=3, mode=mode)
    assert sorted(out) == sorted(ref)
    assert out["device_split_mode"] == mode
    assert out["device_core_tier"] == ref["device_core_tier"]
    assert all(out[k] >= 0.0 for k in out if k.endswith("_seconds"))
    if mode == "commit":
        for k in ("device_result_bytes_candidates",
                  "device_result_bytes_placements", "device_commit_active"):
            assert out[k] == ref[k]
        assert eng.device_commit is False  # the knob is restored


def test_defaults_and_normalisation():
    """The reference's defaults (state_cache, fused and incremental on),
    and incremental = incremental and fused and state_cache."""
    tsnap = port_snapshot(cluster())
    eng = PlacementEngine(tsnap, device="cpu")
    assert (eng.state_cache, eng.state_verify, eng.fused,
            eng.incremental) == (True, False, True, True)
    for knobs in ({"fused": False}, {"state_cache": False}):
        assert not PlacementEngine(tsnap, device="cpu", **knobs).incremental
        jax_eng = JaxEngine(cluster(), **knobs)
        assert jax_eng.incremental is False


def test_io_layout_round_trip():
    """One layout for the packer and the unpacker: what pack_gangs writes
    unpack_gangs reads back as the kernels' operands, and a delta block's
    padding rows name the absorbing row."""
    import torch

    snap, gangs = _masked_backlog()
    eng = PlacementEngine(port_snapshot(snap), device="cpu")
    enc = eng._encode_backlog([port_gang(g) for g in gangs])
    upd = eng._update_block({2: np.full(3, 1.5, np.float32),
                             0: np.zeros(3, np.float32)})
    io, lay = eng._build_io(enc, upd)
    g_pad, r = enc.total_demand.shape
    t_pad = lay.offsets["demand"][1]
    assert lay == programs.fused_layout(g_pad, r, enc.sig[3].shape[1],
                                        enc.sig[0].shape[0], t_pad, 16)
    assert io.shape == (lay.size,) and t_pad & (t_pad - 1) == 0
    p = programs.unpack_gangs(lay, torch.from_numpy(io))
    np.testing.assert_array_equal(p["td"].numpy(), enc.total_demand)
    np.testing.assert_array_equal(p["sig_idx"].numpy(), enc.sig[3])
    np.testing.assert_array_equal(p["valid"].numpy(), enc.valid)
    np.testing.assert_array_equal(p["required"].numpy(), enc.required_level)
    np.testing.assert_array_equal(
        p["demand"].numpy()[p["demand_idx"].numpy()], enc.total_demand)
    blk = lay.view(io, "upd")
    assert blk[:2, 0].tolist() == [0.0, 2.0]
    assert (blk[2:, 0] == snap.num_nodes).all() and (blk[2:, 1:] == 0).all()
    free = torch.zeros((snap.num_nodes + 1, 3))
    programs.scatter_rows(free, torch.from_numpy(blk.copy()))
    assert free[2].tolist() == [1.5] * 3 and free[snap.num_nodes].sum() == 0


def test_add_launches_counts_by_kernel_name():
    """A graph replay's launches are added by kernel name (the names
    launch_counts reports); an unknown name raises."""
    from grove_tpu_torch.solver import kernel_core as kc

    kc.reset_launches()
    captured = {"value_sig_kernel_bf16": 2, "value_kernel": 1,
                "commit_topk": 3, "commit_scan": 1}
    kc.add_launches(captured)
    kc.add_launches(captured)
    counts = kc.launch_counts()
    assert {k: counts[k] for k in captured} == {k: 2 * v for k, v in
                                                captured.items()}
    assert counts["value_sig_kernel"] == counts["value_kernel_bf16"] == 0
    kc.add_launches({k: -2 * v for k, v in captured.items()})
    assert set(kc.launch_counts().values()) == {0}
    with pytest.raises(KeyError, match="no kernel"):
        kc.add_launches({"scatter": 1})
    kc.reset_launches()
