"""The hierarchical two-level solve: grove_tpu_torch against the JAX package.

Mirrors tests/test_hierarchy.py on the port. Every problem is built once
with numpy (that file's `make_cluster`, `make_gang`, `seeded_problem` and
`spread_problem`) and carried across with grove_tpu_torch.convert, so both
packages solve the same inputs. The port runs on the CPU
(`device="cpu"`), the JAX package as its own tests run it (its default
CPU tier). Where both packages' hierarchical paths run the same inputs,
the port is held BIT-equal to the JAX package: placements (node per pod,
score), unplaced messages and codes, the post-solve free matrix, and every
non-timing stat (`hier_*`, `hierarchical`, `incremental`, ...). Against
the port's own flat engine the promise is the reference's: score-equal,
not bit-equal. The wave (auto width) equals width 0 bit for bit.

`TestShardedHierarchy` and the sharded wave case run on the port's mesh
engine in gloo ranks (tests/torch_mesh.py), against the JAX mesh engine.
`TestConfigAndScheduler`'s scheduler case runs through the lockstep
Harness (tests/test_torch_harness.py); its engine-only debug-summary
case is here.
"""

import dataclasses

import numpy as np
import pytest

import bench
from grove_tpu.solver import PlacementEngine as JaxEngine
from grove_tpu.solver.hierarchy import (
    coarse_admissible as jax_coarse_admissible,
    coarse_assign as jax_coarse_assign,
    subset_snapshot as jax_subset_snapshot,
)

from grove_tpu_torch import stress
from grove_tpu_torch.convert import (
    GANG_FIELDS,
    SNAPSHOT_FIELDS,
    gang_from_arrays,
    snapshot_from_arrays,
)
from grove_tpu_torch.observability.explain import UnsatCode
from grove_tpu_torch.solver import PlacementEngine, place_gang_in_domain
from grove_tpu_torch.solver.hierarchy import (
    coarse_admissible,
    coarse_assign,
    shift_level,
    subset_snapshot,
)
from test_hierarchy import make_cluster, make_gang, seeded_problem, spread_problem


def port_snapshot(snap):
    return snapshot_from_arrays(**{f: getattr(snap, f) for f in SNAPSHOT_FIELDS})


def port_gangs(gangs):
    """The port's twins of `gangs`; shared eligibility masks stay the same
    objects (the engines dedupe them by identity)."""
    return [gang_from_arrays(**{f: getattr(g, f) for f in GANG_FIELDS})
            for g in gangs]


def code_of(reason):
    code = getattr(reason, "code", None)
    return getattr(code, "value", code)


#: stats only the port reports: the candidate domains its repair tried,
#: the gangs its net turned away on the free aggregate and the diagnoses
#: its solve tail ran
PORT_STATS = ("repair_candidates", "repair_net_short", "diagnoses")


def plain_stats(res) -> dict:
    """A result's stats without the wall-clock ones and the port's own."""
    return {k: v for k, v in res.stats.items()
            if not k.endswith("seconds") and not k.startswith("hier_fine_wall")
            and k not in PORT_STATS}


def assert_bitwise(a, b, free_a, free_b, stats=True):
    """Bit-equal solves: placements (node per pod, node rows, score),
    unplaced messages and codes, post-solve free, and (`stats`) the
    non-timing stats."""
    assert sorted(a.placed) == sorted(b.placed)
    for name, pa in a.placed.items():
        pb = b.placed[name]
        assert pb.pod_to_node == pa.pod_to_node, name
        assert np.array_equal(pb.node_indices, pa.node_indices), name
        assert pb.placement_score == pa.placement_score, name
    assert {n: str(r) for n, r in a.unplaced.items()} == {
        n: str(r) for n, r in b.unplaced.items()}
    assert {n: code_of(r) for n, r in a.unplaced.items()} == {
        n: code_of(r) for n, r in b.unplaced.items()}
    assert np.array_equal(free_a, free_b)
    if stats:
        assert plain_stats(a) == plain_stats(b)


def assert_score_equal(rf, rh, free_f, free_h):
    """The hierarchical-vs-flat contract: the same placed set, per-gang
    scores and unplaced codes, and the same committed per-resource
    totals."""
    assert sorted(rf.placed) == sorted(rh.placed)
    for name, pf in rf.placed.items():
        assert rh.placed[name].placement_score == pf.placement_score
    for name, reason in rf.unplaced.items():
        assert code_of(rh.unplaced[name]) == code_of(reason)
    np.testing.assert_allclose(free_f.sum(axis=0), free_h.sum(axis=0),
                               rtol=1e-5, atol=1e-3)


class Twin:
    """The JAX engine and the port's with the same knobs on the same
    cluster, driven through the same calls and held bit-equal."""

    def __init__(self, snap, **knobs):
        self.jsnap, self.tsnap = snap, port_snapshot(snap)
        self.j = JaxEngine(snap, **knobs)
        self.t = PlacementEngine(self.tsnap, device="cpu", **knobs)
        self._port = {}

    def gangs(self, gangs):
        """The port twins of `gangs`, made once per JAX gang object, so a
        repeated backlog is the same objects on both sides (the domain
        reuse memo keys on identity)."""
        out = []
        for g in gangs:
            if id(g) not in self._port:
                self._port[id(g)] = (g, port_gangs([g])[0])
            out.append(self._port[id(g)][1])
        return out

    def solve(self, gangs, free, dispatch=(None, None)):
        fj, ft = free.copy(), free.copy()
        rj = self.j.solve(gangs, free=fj, dispatch=dispatch[0])
        rt = self.t.solve(self.gangs(gangs), free=ft, dispatch=dispatch[1])
        assert_bitwise(rj, rt, fj, ft)
        assert self.t.dispatch_counts() == self.j.dispatch_counts()
        return rt, ft

    def dispatch(self, gangs, free):
        return (self.j.dispatch(gangs, free=free.copy()),
                self.t.dispatch(self.gangs(gangs), free=free.copy()))

    def note(self, rows):
        self.j.note_free_rows(rows)
        self.t.note_free_rows(rows)

    def rebind(self, snap):
        assert self.j.rebind(snap)
        assert self.t.rebind(port_snapshot(snap))


class TestAdmissibility:
    """The domain-level aggregate must NEVER prune a domain the exact
    solve could place into, and the port's coarse pass equals the JAX
    package's."""

    @pytest.mark.parametrize("seed", range(12))
    def test_never_prunes_a_placeable_domain(self, seed):
        jsnap, free, jgangs = seeded_problem(seed)
        snap, gangs = port_snapshot(jsnap), port_gangs(jgangs)
        level = 0
        fm = np.where(snap.schedulable[:, None], free, 0.0).astype(np.float32)
        order = sorted(gangs, key=lambda g: g.name)
        admissible, dom_free, stats, cls = coarse_admissible(order, snap, fm,
                                                             level)
        j_out = jax_coarse_admissible(
            sorted(jgangs, key=lambda g: g.name), jsnap, fm, level)
        assert np.array_equal(admissible, j_out[0])
        assert np.array_equal(dom_free, j_out[1])
        assert stats == j_out[2]
        assert np.array_equal(cls, j_out[3])
        ids = snap.domain_ids[level]
        sched = np.flatnonzero(snap.schedulable)
        for i, g in enumerate(order):
            for d in range(int(snap.num_domains[level])):
                if admissible[i, d]:
                    continue
                node_idx = sched[ids[sched] == d]
                assert place_gang_in_domain(g, snap, free.copy(), node_idx,
                                            level) is None, (
                    f"seed {seed}: domain {d} cut for {g.name}, but the "
                    "exact placement succeeds there")
        assert stats["pruned"] > 0

    def test_assignment_covers_admissible_only(self):
        jsnap, free, jgangs = seeded_problem(3)
        snap, gangs = port_snapshot(jsnap), port_gangs(jgangs)
        fm = np.where(snap.schedulable[:, None], free, 0.0).astype(np.float32)
        order = sorted(gangs, key=lambda g: g.name)
        admissible, dom_free, _, cls = coarse_admissible(order, snap, fm, 0)
        cap_scale = np.maximum(snap.capacity.max(axis=0), 1e-9)
        choices = coarse_assign(order, admissible, dom_free, cap_scale,
                                class_ids=cls)
        assert choices == jax_coarse_assign(
            sorted(jgangs, key=lambda g: g.name), admissible, dom_free,
            cap_scale, class_ids=cls)
        for i, alts in enumerate(choices):
            assert len(alts) == len(set(alts))
            for d in alts:
                assert admissible[i, d]


class TestScoreEquality:
    """Hierarchical: bit-equal to the JAX package's, score-equal to the
    port's flat engine."""

    @pytest.mark.parametrize("seed", range(6))
    def test_seeded_score_equality(self, seed):
        snap, free, gangs = seeded_problem(seed, num_gangs=16)
        twin = Twin(snap, hierarchical=True)
        rh, free_h = twin.solve(gangs, free)
        assert rh.stats.get("hierarchical") == 1.0
        free_f = free.copy()
        rf = PlacementEngine(twin.tsnap, device="cpu").solve(
            twin.gangs(gangs), free=free_f)
        assert "hierarchical" not in rf.stats
        assert_score_equal(rf, rh, free_f, free_h)

    def test_unplaceable_gang_same_code(self):
        snap = make_cluster(128)
        gangs = [make_gang("ok", cpu=4.0), make_gang("huge", cpu=64.0)]
        twin = Twin(snap, hierarchical=True)
        rh, free_h = twin.solve(gangs, snap.free.copy())
        free_f = snap.free.copy()
        rf = PlacementEngine(twin.tsnap, device="cpu").solve(
            twin.gangs(gangs), free=free_f)
        assert "huge" in rf.unplaced and "huge" in rh.unplaced
        assert rh.unplaced["huge"].code == UnsatCode.CAPACITY
        assert rh.unplaced["huge"].code == rf.unplaced["huge"].code
        assert_score_equal(rf, rh, free_f, free_h)


class TestForcedFlatTriggers:
    def _solve(self, twin, gangs):
        return twin.solve(gangs, twin.jsnap.free.copy())[0]

    def test_unconfined_gang_forces_flat(self):
        twin = Twin(make_cluster(128), hierarchical=True)
        assert self._solve(twin, [make_gang("a"), make_gang("b")]).stats.get(
            "hierarchical")
        res = self._solve(twin, [make_gang("a"),
                                 make_gang("root", required=-1)])
        assert "hierarchical" not in res.stats
        assert res.num_placed == 2

    def test_min_nodes_forces_flat(self):
        twin = Twin(make_cluster(128), hierarchical=True, hier_min_nodes=1000)
        assert "hierarchical" not in self._solve(twin, [make_gang("a")]).stats

    def test_single_domain_forces_flat(self):
        snap = make_cluster(48)  # one block
        assert int(snap.num_domains[0]) == 1
        twin = Twin(snap, hierarchical=True)
        res = self._solve(twin, [make_gang("a", required=0)])
        assert "hierarchical" not in res.stats

    def test_knob_off_is_flat(self):
        twin = Twin(make_cluster(128))
        assert "hierarchical" not in self._solve(twin, [make_gang("a")]).stats

    def test_prune_level_clamped_to_confinement(self):
        snap = make_cluster(128)
        twin = Twin(snap, hierarchical=True, hier_prune_level=1)
        res = self._solve(twin, [make_gang("a", required=0)])
        assert res.stats["hier_level"] == 0.0
        twin2 = Twin(snap, hierarchical=True)
        res2 = self._solve(twin2, [make_gang("a", required=1)])
        assert res2.stats["hier_level"] == 1.0


class TestShardLocalIncrementality:
    def test_domain_reuse_and_dirty_tick(self):
        snap = make_cluster(256)
        gangs = [make_gang(f"g{i:02d}") for i in range(12)]
        twin = Twin(snap, hierarchical=True)
        r1, _ = twin.solve(gangs, snap.free.copy())
        assert r1.stats["hier_fine_solves"] >= 1
        # identical repeat: every domain rides the reuse memo
        r2, _ = twin.solve(gangs, snap.free.copy())
        assert r2.stats["hier_fine_solves"] == 0
        assert r2.stats["hier_domain_reuse"] >= 1
        # dirty tick: one replaced gang -> its domain re-solves
        # incrementally, the others keep the memo
        dirty = list(gangs)
        dirty[2] = make_gang("fresh-0")
        r3, _ = twin.solve(dirty, snap.free.copy())
        assert r3.stats.get("incremental") == 1.0
        assert r3.stats["hier_sub_incremental"] == 1
        assert r3.stats["incremental_rows"] <= 2.0
        ds = twin.t.debug_summary()["device_state"]
        assert ds["dispatches"]["incremental"] >= 1
        assert ds == twin.j.debug_summary()["device_state"]

    def test_incremental_off_disables_memo(self):
        snap = make_cluster(256)
        gangs = [make_gang(f"g{i:02d}") for i in range(8)]
        twin = Twin(snap, hierarchical=True, incremental=False)
        twin.solve(gangs, snap.free.copy())
        r2, _ = twin.solve(gangs, snap.free.copy())
        assert r2.stats["hier_domain_reuse"] == 0
        assert r2.stats["hier_fine_solves"] >= 1

    def test_counter_mirroring(self):
        """The sub-engines' launches by path kind are mirrored into the
        parent's (the JAX engine also feeds them to its metrics registry,
        which comes with item 6a)."""
        snap = make_cluster(256)
        twin = Twin(snap, hierarchical=True)
        gangs = [make_gang(f"g{i:02d}") for i in range(8)]
        twin.solve(gangs, snap.free.copy())
        dirty = list(gangs)
        dirty[0] = make_gang("fresh-0")
        twin.solve(dirty, snap.free.copy())
        counts = twin.t.dispatch_counts()
        assert counts["fused"] >= 1
        assert counts["incremental"] >= 1


class TestRebindAndInvalidate:
    def test_cordon_flip_rides_rebind(self):
        snap = make_cluster(128)
        gangs = [make_gang(f"g{i:02d}") for i in range(6)]
        twin = Twin(snap, hierarchical=True)
        flat = PlacementEngine(twin.tsnap, device="cpu")
        twin.solve(gangs, snap.free.copy())
        sched = snap.schedulable.copy()
        sched[5] = False
        snap2 = dataclasses.replace(snap, schedulable=sched)
        twin.rebind(snap2)
        assert flat.rebind(twin.t.snapshot)
        rh, free_h = twin.solve(gangs, snap.free.copy())
        free_f = snap.free.copy()
        rf = flat.solve(twin.gangs(gangs), free=free_f)
        assert_score_equal(rf, rh, free_f, free_h)
        for p in rh.placed.values():
            assert 5 not in p.node_indices.tolist()

    def test_invalidate_drops_hier_state(self):
        snap = make_cluster(128)
        twin = Twin(snap, hierarchical=True)
        gangs = [make_gang("a")]
        twin.solve(gangs, snap.free.copy())
        assert twin.t._hier is not None
        twin.j.invalidate_device_state()
        twin.t.invalidate_device_state()
        assert twin.t._hier is None
        res, _ = twin.solve(gangs, snap.free.copy())
        assert res.num_placed == 1


class TestWaveParallel:
    """Dispatch-all / collect-in-order across domains: bit-equal to the
    serial width-0 path and to the JAX package's wave."""

    def _pair(self, snap, workers=4):
        return (Twin(snap, hierarchical=True, hier_parallel_workers=0),
                Twin(snap, hierarchical=True, hier_parallel_workers=workers))

    def test_bit_equality_multi_domain_wave(self):
        snap, free, gangs = spread_problem()
        serial, wave = self._pair(snap)
        rs, fs = serial.solve(gangs, free)
        rw, fw = wave.solve(gangs, free)
        assert rw.stats["hier_wave_width"] >= 2
        assert rw.stats["hier_wave_workers"] >= 1
        assert rs.stats["hier_wave_workers"] == 0
        assert_bitwise(rs, rw, fs, fw, stats=False)

    def test_auto_width_equals_width_zero(self):
        snap, free, gangs = spread_problem()
        serial = Twin(snap, hierarchical=True, hier_parallel_workers=0)
        auto = Twin(snap, hierarchical=True)
        assert auto.t._wave_workers() >= 1
        rs, fs = serial.solve(gangs, free)
        ra, fa = auto.solve(gangs, free)
        assert ra.stats["hier_wave_width"] >= 2
        assert_bitwise(rs, ra, fs, fa, stats=False)

    def test_bit_equality_under_churn(self):
        snap, free, gangs = spread_problem()
        serial, wave = self._pair(snap)
        rng = np.random.default_rng(5)
        n = snap.num_nodes
        widths = 0
        for _ in range(4):
            rows = rng.choice(n, size=24, replace=False)
            scale = rng.uniform(0.4, 1.1, size=(rows.size, 1)).astype(
                np.float32)
            free[rows] = np.minimum(snap.capacity[rows],
                                    free[rows] * scale).astype(np.float32)
            serial.note(rows.tolist())
            wave.note(rows.tolist())
            subset = [gangs[i] for i in sorted(
                rng.choice(len(gangs), size=12, replace=False))]
            rs, fs = serial.solve(subset, free)
            rw, fw = wave.solve(subset, free)
            widths = max(widths, int(rw.stats["hier_wave_width"]))
            assert_bitwise(rs, rw, fs, fw, stats=False)
            free = fs
        assert widths >= 2

    def test_domain_reuse_and_dirty_tick_parity(self):
        snap, free, gangs = spread_problem()
        serial, wave = self._pair(snap)
        serial.solve(gangs, free)
        wave.solve(gangs, free)
        rs, fs = serial.solve(gangs, free)
        rw, fw = wave.solve(gangs, free)
        assert rw.stats["hier_domain_reuse"] >= 1
        assert rw.stats["hier_domain_reuse"] == rs.stats["hier_domain_reuse"]
        assert rw.stats["hier_fine_solves"] == rs.stats["hier_fine_solves"]
        assert_bitwise(rs, rw, fs, fw, stats=False)
        dirty = list(gangs)
        dirty[3] = make_gang("fresh-0", pods=4, cpu=4.0)
        rs, fs = serial.solve(dirty, free)
        rw, fw = wave.solve(dirty, free)
        assert rw.stats.get("incremental") == rs.stats.get("incremental")
        assert rw.stats["hier_domain_reuse"] >= 1
        assert_bitwise(rs, rw, fs, fw, stats=False)

    def test_fail_recover_rebind_mid_stream(self):
        snap, free, gangs = spread_problem()
        serial, wave = self._pair(snap)
        rs, fs = serial.solve(gangs, free)
        rw, fw = wave.solve(gangs, free)
        assert_bitwise(rs, rw, fs, fw, stats=False)
        failed = 7
        for up in (False, True):  # fail the node, then recover it
            sched = serial.jsnap.schedulable.copy()
            sched[failed] = up
            snap2 = dataclasses.replace(serial.jsnap, schedulable=sched)
            serial.rebind(snap2)
            wave.rebind(snap2)
            serial.jsnap = wave.jsnap = snap2
            rs, fs = serial.solve(gangs, free)
            rw, fw = wave.solve(gangs, free)
            assert_bitwise(rs, rw, fs, fw, stats=False)
            if not up:
                for p in rw.placed.values():
                    assert failed not in p.node_indices.tolist()

    def test_workers_zero_is_serial(self):
        snap, free, gangs = spread_problem()
        twin = Twin(snap, hierarchical=True, hier_parallel_workers=0)
        res, _ = twin.solve(gangs, free)
        assert res.stats["hier_wave_workers"] == 0.0
        assert res.stats["hier_waves"] >= 1
        assert twin.t._hier_pool is None  # the serial path builds no pool
        assert twin.t.debug_summary()["hierarchical"]["wave_workers"] == 0

    def test_auto_workers_resolution(self):
        twin = Twin(make_cluster(128), hierarchical=True)
        assert twin.t._wave_workers() == twin.j._wave_workers() >= 1
        assert (twin.t.debug_summary()["hierarchical"]["wave_workers"]
                == twin.t._wave_workers())

    def test_wave_stats(self):
        snap, free, gangs = spread_problem()
        twin = Twin(snap, hierarchical=True, hier_parallel_workers=2)
        res, _ = twin.solve(gangs, free)
        assert res.stats["hier_waves"] >= 1
        assert res.stats["hier_wave_width"] >= 2
        assert res.stats["hier_fine_seconds"] > 0.0
        assert "hier_net_seconds" in res.stats
        assert "hier_coarse_seconds" in res.stats
        walls = [res.stats["hier_fine_wall_min"],
                 res.stats["hier_fine_wall_med"],
                 res.stats["hier_fine_wall_max"]]
        assert walls == sorted(walls)

    def test_debug_summary_block(self):
        """tests/test_hierarchy.py TestConfigAndScheduler's engine-only
        case: the block, before and after a solve, equals the JAX
        engine's."""
        snap = make_cluster(128)
        twin = Twin(snap, hierarchical=True)
        block = twin.t.debug_summary()["hierarchical"]
        assert block == {
            "enabled": True,
            "wave_workers": twin.t._wave_workers(),
            "prune_level": None,
            "coarse_domains": None,
            "shards_built": 0,
            "last_pruned_pairs": 0,
            "last_admissible_pairs": 0,
        }
        twin.solve([make_gang("a")], snap.free.copy())
        block = twin.t.debug_summary()["hierarchical"]
        assert block == twin.j.debug_summary()["hierarchical"]
        assert block["prune_level"] == 0
        assert block["shards_built"] >= 1


class TestDispatchAdoption:
    def test_dispatch_carries_level_and_adopts(self):
        snap = make_cluster(128)
        gangs = [make_gang(f"g{i:02d}") for i in range(8)]
        twin = Twin(snap, hierarchical=True)
        handles = twin.dispatch(gangs, snap.free.copy())
        h = handles[1]
        assert h.path == "hierarchical" == handles[0].path
        assert h.level == 0 == handles[0].level
        assert h.rows == handles[0].rows
        res, free_c = twin.solve(gangs, snap.free.copy(), dispatch=handles)
        assert res.stats.get("dispatch_overlap") == 1.0
        assert res.stats.get("hierarchical") == 1.0
        fresh, free_f = twin.solve(gangs, snap.free.copy())
        assert sorted(res.placed) == sorted(fresh.placed)
        assert np.array_equal(free_c, free_f)

    def test_stale_dispatch_refused(self):
        snap = make_cluster(128)
        gangs = [make_gang(f"g{i:02d}") for i in range(8)]
        twin = Twin(snap, hierarchical=True)
        handles = twin.dispatch(gangs, snap.free.copy())
        stale = snap.free.copy()
        stale[3] *= 0.5
        twin.note((3,))
        res, _ = twin.solve(gangs, stale, dispatch=handles)
        assert not res.stats.get("dispatch_overlap")
        assert res.num_placed == len(gangs)

    def test_changed_order_refused(self):
        snap = make_cluster(128)
        gangs = [make_gang(f"g{i:02d}") for i in range(8)]
        twin = Twin(snap, hierarchical=True)
        handles = twin.dispatch(gangs, snap.free.copy())
        other = list(gangs[:-1]) + [make_gang("new")]
        res, _ = twin.solve(other, snap.free.copy(), dispatch=handles)
        assert not res.stats.get("dispatch_overlap")
        assert res.num_placed == len(other)
        handles[1].cancel()
        assert handles[1].token is None


def diagnosis_problem(seed: int):
    """seeded_problem over 8 blocks, plus one gang no rack can hold (17
    whole hosts under a rack requirement). The coarse pass crowds the
    backlog into one block, which hands back what it cannot hold; those
    gangs place in the blocks they walk to, the extra gang in none."""
    jsnap, free, jgangs = seeded_problem(seed, num_nodes=512, num_gangs=60)
    jgangs = jgangs + [make_gang(f"z{seed}", pods=17, cpu=32.0, required=1)]
    return port_snapshot(jsnap), free, port_gangs(jgangs)


class TestSubEnginesLeaveDiagnosesToTheParent:
    """A sub-engine hands the gangs its block could not hold back to the
    parent undiagnosed; the parent diagnoses what stays unplaced, and its
    results equal those of a solve whose sub-engines diagnose."""

    @staticmethod
    def solve(snap, free, gangs, shards_diagnose: bool):
        """The hierarchical solve with diagnose_unplaced counted (the
        snapshot each call was handed) and each fine solve's unplaced
        reasons and diagnoses kept; `shards_diagnose` turns every
        sub-engine's switch back on."""
        from grove_tpu_torch.observability.tracing import Tracer
        from grove_tpu_torch.solver import engine as engine_mod

        handed, backs, sub_diagnoses = [], [], []
        plain = engine_mod.diagnose_unplaced
        make = PlacementEngine._make_sub_engine

        def counted(gang, snapshot, free):
            handed.append(snapshot)
            return plain(gang, snapshot, free)

        def sub_engine(self, shard):
            sub = make(self, shard)
            if shards_diagnose:
                sub._shard_of_parent = False
            solve = sub.solve

            def kept(*a, **k):
                res = solve(*a, **k)
                backs.append(dict(res.unplaced))
                sub_diagnoses.append(res.stats["diagnoses"])
                return res

            sub.solve = kept
            return sub

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(engine_mod, "diagnose_unplaced", counted)
            mp.setattr(PlacementEngine, "_make_sub_engine", sub_engine)
            eng = PlacementEngine(snap, device="cpu", hierarchical=True,
                                  hier_parallel_workers=4, tracer=Tracer())
            f = free.copy()
            res = eng.solve(gangs, free=f)
        return eng, res, f, handed, backs, sub_diagnoses

    @pytest.mark.parametrize("seed", range(3))
    def test_fine_failures_go_back_undiagnosed(self, seed):
        from grove_tpu_torch.solver import engine as engine_mod

        snap, free, gangs = diagnosis_problem(seed)
        eng, res, f, handed, backs, sub_diag = self.solve(snap, free, gangs,
                                                          False)
        ctl, want, f_want, ctl_handed, _, ctl_sub_diag = self.solve(
            snap, free, gangs, True)
        # every diagnosis ran in the parent, one an unplaced gang; with
        # the switch back on the sub-engines diagnose too
        assert sorted(res.unplaced) == [f"z{seed}"]
        assert len(handed) == 1 and handed[0] is eng.snapshot
        assert res.stats["diagnoses"] == 1.0
        assert sub_diag and all(d == 0.0 for d in sub_diag)
        assert any(s is not ctl.snapshot for s in ctl_handed)
        assert sum(ctl_sub_diag) > 0.0
        # the fine failures, handed back with the one shared reason, are
        # what the waves count
        back = [(name, reason) for b in backs for name, reason in b.items()]
        assert all(reason is engine_mod._LEFT_TO_PARENT
                   for _name, reason in back)
        assert engine_mod._LEFT_TO_PARENT.code is UnsatCode.CONFLICT
        waves = [sp for sp in eng.tracer.finished
                 if sp.name == "engine.hier_wave"]
        assert len(back) == sum(sp.attrs["failures"] for sp in waves)
        # gangs a block handed back that the alternate walk placed
        walked = {name for name, _r in back} - set(res.unplaced)
        assert walked and walked <= set(res.placed)
        # the parent's results are the diagnosing solve's, bit for bit
        assert_bitwise(want, res, f_want, f)
        for name, reason in res.unplaced.items():
            assert reason.funnel == want.unplaced[name].funnel


class TestSubSnapshot:
    def test_subset_snapshot_shape(self):
        jsnap = make_cluster(128)
        snap = port_snapshot(jsnap)
        idx = np.flatnonzero(snap.domain_ids[0] == 1)
        sub = subset_snapshot(snap, idx, 0)
        assert sub.num_nodes == len(idx)
        assert sub.level_keys == snap.level_keys[1:]
        assert sub.num_levels == snap.num_levels - 1
        # rack ids re-densified 0..3, host ids 0..63
        assert int(sub.num_domains[0]) == 4
        assert sub.node_names == [snap.node_names[i] for i in idx]
        ref = jax_subset_snapshot(jsnap, idx, 0)
        for f in SNAPSHOT_FIELDS:
            a, b = getattr(sub, f), getattr(ref, f)
            if isinstance(a, np.ndarray):
                assert np.array_equal(a, b), f
            else:
                assert a == b, f

    def test_shift_level(self):
        assert shift_level(-1, 0) == -1
        assert shift_level(0, 0) == -1   # at the prune level: the sub-root
        assert shift_level(1, 0) == 0
        assert shift_level(2, 0) == 1
        assert shift_level(1, 1) == -1
        assert shift_level(2, 1) == 0


def test_tier_gangs_match_bench():
    """stress.make_tier_gangs builds bench.py's tier backlog, field for
    field."""
    ours, ref = stress.make_tier_gangs(5), bench.make_tier_gangs(5)
    for a, b in zip(ours, ref):
        for f in GANG_FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            if isinstance(x, np.ndarray):
                assert np.array_equal(x, y), f
            else:
                assert x == y, f


#: one pod of bench's tier gang: 8 of them fill a (32, 128, 8) host
TIER_POD = np.array([4.0, 16.0, 1.0], np.float32)


def tier_free(snap, kind, rng, blocks=2, hosts=8):
    """The free matrix of bench's tier cluster with `hosts` random hosts
    of each of `blocks` random blocks bound: one tier pod each ("pod")
    or whole ("host"); "none" binds nothing."""
    free = snap.free.copy()
    if kind == "none":
        return free
    blk = snap.domain_ids[1]
    picked = rng.choice(int(blk.max()) + 1, size=blocks, replace=False)
    rows = np.concatenate([rng.choice(np.flatnonzero(blk == b), size=hosts,
                                      replace=False) for b in picked])
    free[rows] = snap.capacity[rows] - TIER_POD if kind == "pod" else 0.0
    return free


def tier_witness(nodes, n_gangs, kind, ticks=0, seed=7, flat=True):
    """bench's tier backlog on its tier cluster through the JAX package's
    hierarchical engine and the port's (on the CPU, device commit on, as
    on the card), and their flat engines (`flat`): a cold solve, then
    `ticks` dirty ticks (8 gangs replaced, as bench.py's), each on a
    fresh `tier_free(kind)`. Holds the port bit-equal to the JAX package
    on each path and solve, and yields, per solve, the label, both
    hierarchical results, and each package's hierarchical-vs-flat score
    differences (gang -> (hier score, flat score); None without
    `flat`)."""
    rng = np.random.default_rng(seed)
    jsnap = bench.make_tier_cluster(nodes)
    paths = {"hier": dict(hierarchical=True, hier_parallel_workers=0)}
    if flat:
        paths["flat"] = {}
    twins = {p: Twin(jsnap, device_commit=True, **kw)
             for p, kw in paths.items()}
    backlog = bench.make_tier_gangs(n_gangs)
    for tick in range(ticks + 1):
        if tick:
            stride = len(backlog) // 8
            for j in range(8):
                pos = (j * stride + tick) % len(backlog)
                g = bench.make_tier_gangs(1)[0]
                g.name = backlog[pos].name.split(".")[0] + f".{tick}"
                backlog[pos] = g
        free = tier_free(jsnap, kind, rng)
        out = {}
        for p, twin in twins.items():
            twin.note(None)
            fj, ft = free.copy(), free.copy()
            rj = twin.j.solve(backlog, free=fj)
            rt = twin.t.solve(twin.gangs(backlog), free=ft)
            assert_bitwise(rj, rt, fj, ft, stats=p == "hier")
            out[p] = (rj, rt, fj, ft)
        diffs = None
        if flat:
            (jh, th, fjh, fth), (jf, tf, fjf, ftf) = out["hier"], out["flat"]
            diffs = []
            for rh, rf, fh, ff in ((jh, jf, fjh, fjf), (th, tf, fth, ftf)):
                # what R4 leaves standing of the contract: the placed set,
                # the unplaced codes and the committed totals
                assert sorted(rh.placed) == sorted(rf.placed)
                for name, reason in rf.unplaced.items():
                    assert code_of(rh.unplaced[name]) == code_of(reason)
                np.testing.assert_allclose(fh.sum(axis=0), ff.sum(axis=0),
                                           rtol=1e-5, atol=1e-3)
                diffs.append({g: (p.placement_score,
                                  rf.placed[g].placement_score)
                              for g, p in rh.placed.items()
                              if p.placement_score
                              != rf.placed[g].placement_score})
        yield ("cold" if tick == 0 else f"tick {tick}", out["hier"][0],
               out["hier"][1], diffs)


class TestReferenceFaultR4:
    """Reference fault R4 (ROADMAP §3): the coarse pass admits and assigns
    by a block's aggregate free capacity, blind to how it is split over
    hosts. With one tier pod bound on 8 hosts of a block, the aggregate
    still holds 255 whole-host gangs but only 248 whole hosts are free,
    so the pass may send 7 gangs too many there; the block's sub-engine
    spreads them over hosts (score 0.6-0.8) where the flat solve finds
    whole hosts elsewhere (1.0). The JAX package does it too: the port
    matches it bit for bit, divergence included."""

    def test_single_pod_binds_break_score_equality(self):
        (_, _, _, (jax_d, port_d)), = tier_witness(512, 260, "pod")
        assert jax_d, "the input no longer shows R4"
        assert port_d == jax_d
        assert all(h < f for h, f in jax_d.values())

    def test_whole_host_binds_keep_score_equality(self):
        """The same churn binding whole hosts, as a tier gang does, keeps
        hierarchical == flat score-equal: the aggregates see it."""
        (_, _, _, (jax_d, port_d)), = tier_witness(512, 260, "host")
        assert jax_d == port_d == {}

    def test_dirty_ticks_under_pod_churn_match_reference(self):
        """Two dirty ticks under single-pod churn: the port's hierarchical
        solve (placements, free, hier_* stats with hier_repair_fallbacks)
        stays bit-equal to the JAX package's, each tick."""
        steps = list(tier_witness(512, 260, "pod", ticks=2, flat=False))
        assert len(steps) == 3
        for _, rj, rt, _ in steps:
            assert (rt.stats["hier_repair_fallbacks"]
                    == rj.stats["hier_repair_fallbacks"])



#: bench.py --equivalence's hierarchical-vs-flat score differences in its
#: section 7b at its full shape: label -> {gang: (hier score, flat score)}
EQUIVALENCE_7B_DIFFS = {
    "churn[0]": {},
    "churn[1]": {"gang00694": (0.5, 1.0)},
    "churn[2]": {"gang00289": (0.5, 1.0)},
}


@pytest.fixture(scope="module")
def equivalence_7b():
    """bench.py --equivalence's sections 7a-7b at its full shape (5000
    nodes, 1000 gangs), with what sections 1-6 leave behind: the seed-7
    generator where section 7 takes it up, section 5's fairness stamps
    on the gangs, and the flat reference rebound to section 6's
    schedulable flip. Returns (JAX snapshot, JAX gangs, the flat
    reference's snapshot, the 7a input, [(label, subset indices, input
    free)] for 7b's rounds), the inputs carried by the port's flat
    reference as the gate carries them."""
    from grove_tpu_torch.bench.solve import churn_draw, equivalence_draws
    from grove_tpu_torch.solver.serial import stamp_fairness

    jsnap = bench.make_cluster(5000)
    gangs = bench.make_gangs(1000)
    n = jsnap.num_nodes
    rng, _, _, fair, flip = equivalence_draws(n, gangs)
    for g in gangs:
        g.fairness = fair[g.name]
    sched = jsnap.schedulable.copy()
    sched[flip] = ~sched[flip]
    fsnap = dataclasses.replace(jsnap, schedulable=sched)
    tgangs = port_gangs(gangs)
    stamp_fairness(tgangs, fair)
    flat = PlacementEngine(port_snapshot(fsnap), device="cpu",
                           state_cache=False, fused=False, incremental=False)
    drained = jsnap.free.copy()
    blocks = jsnap.domain_ids[0]
    drained[blocks == int(blocks.max())] *= 0.01
    free = drained.copy()
    flat.solve(tgangs, free=free)
    rounds = []
    for rnd in range(3):
        rows, scale, picks = churn_draw(rng, n, len(gangs))
        free[rows] = np.minimum(jsnap.capacity[rows],
                                free[rows] * scale).astype(np.float32)
        rounds.append((f"churn[{rnd}]", picks, free.copy()))
        flat.solve([tgangs[i] for i in picks], free=free)
    return jsnap, gangs, fsnap, drained, rounds


def score_diffs(rh, rf) -> dict:
    """gang -> (hier score, flat score) where they differ; the rest of
    the score-equal contract (placed set, unplaced codes, committed
    totals) asserted."""
    assert sorted(rh.placed) == sorted(rf.placed)
    for name, reason in rf.unplaced.items():
        assert code_of(rh.unplaced[name]) == code_of(reason)
    return {g: (p.placement_score, rf.placed[g].placement_score)
            for g, p in rh.placed.items()
            if p.placement_score != rf.placed[g].placement_score}


class TestReferenceFaultR4AtEquivalence:
    """R4 where bench.py --equivalence meets it at full size: section 7b's
    churn rounds give two gangs a hierarchical score of 0.5 against the
    flat 1.0 (EQUIVALENCE_7B_DIFFS), in both packages, on a new engine as
    on the gate's long-lived one. The coarse pass best-fits the backlog
    into the tightest blocks by aggregate free; the fine solve of such a
    block finds no rack left with room for the whole 8-pod gang and
    spreads it over two racks, where the flat solve finds a whole rack
    in another block."""

    def test_reference_scores_below_flat(self, equivalence_7b):
        jsnap, gangs, fsnap, _, rounds = equivalence_7b
        flat = JaxEngine(fsnap, state_cache=False, fused=False,
                         incremental=False)
        got = {}
        for label, picks, given in rounds:
            subset = [gangs[i] for i in picks]
            fh, ff = given.copy(), given.copy()
            rh = JaxEngine(jsnap, hierarchical=True, state_cache=True,
                           fused=True, incremental=True,
                           pallas_core=True).solve(subset, free=fh)
            got[label] = score_diffs(rh, flat.solve(subset, free=ff))
        assert got == EQUIVALENCE_7B_DIFFS

    @pytest.mark.parametrize("width", ["auto", "serial"])
    def test_port_matches_on_new_and_long_lived_engines(self, equivalence_7b,
                                                        width):
        """The port's hierarchical engine gives the same differences; a
        long-lived engine (state_verify on, each solve declared unknown
        scope as the gate declares it, 7a first) places bit-equal to a
        new engine on every round; the diverging gang lies on two racks
        of a block none of whose racks has room for it after the solve,
        and the flat solve puts it whole on one rack."""
        jsnap, gangs, fsnap, drained, rounds = equivalence_7b
        tsnap = port_snapshot(jsnap)
        tgangs = port_gangs(gangs)
        for g, jg in zip(tgangs, gangs):
            g.fairness = jg.fairness
        knobs = dict(hierarchical=True, state_cache=True, fused=True,
                     incremental=True, pallas_core=True, device="cpu")
        if width == "serial":
            knobs["hier_parallel_workers"] = 0
        flat = PlacementEngine(port_snapshot(fsnap), device="cpu",
                               state_cache=False, fused=False,
                               incremental=False)
        live = PlacementEngine(tsnap, state_verify=True, **knobs)
        live.note_free_rows(None)
        live.solve(tgangs, free=drained.copy())
        blocks, racks = jsnap.domain_ids[0], jsnap.domain_ids[1]
        got = {}
        for label, picks, given in rounds:
            subset = [tgangs[i] for i in picks]
            fl, fn, ff = given.copy(), given.copy(), given.copy()
            live.note_free_rows(None)
            rl = live.solve(subset, free=fl)
            rn = PlacementEngine(tsnap, **knobs).solve(subset, free=fn)
            assert_bitwise(rn, rl, fn, fl, stats=False)
            rf = flat.solve(subset, free=ff)
            got[label] = score_diffs(rn, rf)
            for name in got[label]:
                nodes, whole = rn.placed[name].node_indices, \
                    rf.placed[name].node_indices
                assert len(set(racks[whole].tolist())) == 1
                assert len(set(racks[nodes].tolist())) == 2
                (blk,) = set(blocks[nodes].tolist())
                pods = np.floor((fn / TIER_POD).min(axis=1))
                room = [pods[racks == r].sum()
                        for r in np.unique(racks[blocks == blk])]
                assert max(room) < len(nodes), (name, room)
        assert got == EQUIVALENCE_7B_DIFFS


# -- the domain-sharded hierarchy on the mesh engine ----------------------------
def _sharded_cases() -> dict:
    """name -> (JAX snapshot, JAX steps, knobs): test_hierarchy.py's
    sharded cases. Each step's free starts from the snapshot's (or the
    case's) matrix, as the reference passes a fresh copy to each solve."""
    snap = make_cluster(256)
    gangs = [make_gang(f"g{i:02d}") for i in range(16)]
    dirty = list(gangs)
    dirty[1] = make_gang("fresh-0")
    spread = [make_gang(f"g{i:02d}", pods=8, cpu=16.0) for i in range(24)]
    wsnap, wfree, wgangs = spread_problem()
    hier = {"hierarchical": True}
    return {
        "bitwise_matches_single": (snap, [{"gangs": gangs}], hier),
        "incremental_runs_shard_locally": (
            snap, [{"gangs": gangs, "free": snap.free},
                   {"gangs": dirty, "free": snap.free}], hier),
        "sub_engines_on_the_rank_device": (snap, [{"gangs": spread}], hier),
        "wave_serial": (wsnap, [{"gangs": wgangs, "free": wfree}],
                        {**hier, "hier_parallel_workers": 0}),
        "wave_auto": (wsnap, [{"gangs": wgangs, "free": wfree}], hier),
    }


SHARDED_CASES = _sharded_cases()

#: the wave's distinct sub-engine devices: the JAX package's one process
#: holds 8 virtual devices, a rank of the port one
_DEVICE_STATS = ("hier_wave_devices",)


class TestShardedHierarchy:
    """tests/test_hierarchy.py's TestShardedHierarchy and its sharded
    wave case, on the port's mesh engine in 4 gloo ranks (2 x 2) against
    the JAX mesh engine on the conftest's 8 devices (4 x 2) and the port's
    single-device hierarchical engine: every step bit-equal (placements,
    unplaced reasons, post-solve free, non-timing stats), on every rank.
    The domain-sharded hierarchy runs no collective: each rank solves
    every domain on its own device. The JAX package round-robins the
    domains over its process's 8 devices; a rank of the port has one, so
    every sub-engine is on it, and the wave's device count is left out."""

    @pytest.fixture(scope="class")
    def runs(self):
        from torch_mesh import run_ranks

        jobs = []
        for name, (snap, steps, knobs) in SHARDED_CASES.items():
            jobs.append((name, "solve", {
                "snap": port_snapshot(snap), "knobs": knobs,
                "steps": [{**s, "gangs": port_gangs(s["gangs"])}
                          for s in steps]}))
        return run_ranks(4, jobs)

    @pytest.fixture(scope="class")
    def jax_runs(self):
        from grove_tpu.parallel import ShardedPlacementEngine, make_solver_mesh

        from torch_mesh import solve_step

        mesh = make_solver_mesh()
        out = {}
        for name, (snap, steps, knobs) in SHARDED_CASES.items():
            eng = ShardedPlacementEngine(snap, mesh, **knobs)
            free = snap.free.copy()
            res = []
            for step in steps:
                r = solve_step(eng, step, free)
                r["free"] = free.copy()
                r["workers"] = eng._wave_workers()
                res.append(r)
            out[name] = res
        return out

    @staticmethod
    def port_flat(name):
        """The port's single-device hierarchical engine on a case."""
        from torch_mesh import solve_step

        snap, steps, knobs = SHARDED_CASES[name]
        eng = PlacementEngine(port_snapshot(snap), device="cpu", **knobs)
        free = snap.free.copy()
        res = []
        for step in steps:
            r = solve_step(eng, {**step, "gangs": port_gangs(step["gangs"])},
                           free)
            r["free"] = free.copy()
            res.append(r)
        return res

    @staticmethod
    def same(a: dict, b: dict, what: str, stats: bool = True) -> None:
        for key in ("placed", "unplaced", "codes", "fallbacks"):
            assert a[key] == b[key], f"{what}: {key}"
        assert np.array_equal(a["free"], b["free"]), f"{what}: free"
        if not stats:
            return
        sa = {k: v for k, v in a["stats"].items()
              if k not in _DEVICE_STATS and k not in PORT_STATS}
        sb = {k: v for k, v in b["stats"].items()
              if k not in _DEVICE_STATS and k not in PORT_STATS}
        assert sa == sb, f"{what}: stats"

    @pytest.mark.parametrize("case", sorted(SHARDED_CASES))
    def test_case_bit_equal_on_every_rank(self, runs, jax_runs, case):
        flat = self.port_flat(case)
        for r, rank in enumerate(runs):
            for i, step in enumerate(rank[case]["steps"]):
                self.same(step, jax_runs[case][i], f"rank {r} step {i} JAX")
                self.same(step, flat[i], f"rank {r} step {i} port flat")
                assert step["stats"].get("hierarchical") == 1.0

    def test_sharded_bitwise_matches_single(self, runs):
        steps = runs[0]["bitwise_matches_single"]["steps"]
        assert len(steps[0]["placed"]) == 16

    def test_sharded_incremental_runs_shard_locally(self, runs):
        """The flat mesh path keeps incremental off; the domain-sharded
        hierarchy runs it in its sub-engines."""
        for rank in runs:
            steps = rank["incremental_runs_shard_locally"]["steps"]
            eng = steps[-1]["engine"]
            assert eng["incremental"] is False
            assert eng["sub_incremental"] == [True]
            assert steps[-1]["stats"].get("incremental") == 1.0
            assert eng["dispatches"]["incremental"] >= 1

    def test_sub_engines_on_the_rank_device(self, runs):
        """The reference's round-robin over its 8 local devices, on a
        rank with one: several domains solved, every sub-engine on the
        rank's device."""
        for rank in runs:
            eng = rank["sub_engines_on_the_rank_device"]["steps"][0]["engine"]
            assert eng["shards"] >= 2
            assert eng["sub_devices"] == ["cpu"]

    def test_sharded_wave_bitwise_matches_serial(self, runs, jax_runs):
        """The wave (auto width) equals the serial fine solves bit for
        bit; the mesh's auto width covers its local devices; the wave ran
        two domains or more."""
        for rank in runs:
            serial = rank["wave_serial"]["steps"][0]
            wave = rank["wave_auto"]["steps"][0]
            self.same(wave, serial, "wave vs serial", stats=False)
            assert wave["stats"]["hier_wave_width"] >= 2
            workers = wave["engine"]["wave_workers"]
            assert workers >= 1 and workers == PlacementEngine(
                port_snapshot(SHARDED_CASES["wave_auto"][0]),
                device="cpu")._wave_workers()
        assert jax_runs["wave_auto"][0]["workers"] >= 8


if __name__ == "__main__":
    # bench's scale tier cut to --nodes, through both packages on the CPU:
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_hierarchy.py \
    #     --nodes 4096 --gangs 820 --churn pod --ticks 3
    import argparse

    ap = argparse.ArgumentParser(description=tier_witness.__doc__)
    ap.add_argument("--nodes", type=int, default=4096)
    ap.add_argument("--gangs", type=int, default=820)
    ap.add_argument("--churn", choices=("pod", "host", "none"),
                    default="pod")
    ap.add_argument("--ticks", type=int, default=3)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--no-flat", action="store_true")
    a = ap.parse_args()
    for label, rj, rt, diffs in tier_witness(a.nodes, a.gangs, a.churn,
                                             a.ticks, a.seed,
                                             not a.no_flat):
        line = (f"{label}: port == JAX bit for bit (hier"
                f"{'' if a.no_flat else ' and flat'}); placed "
                f"{rj.num_placed}/{a.gangs}; hier_repair_fallbacks JAX "
                f"{rj.stats['hier_repair_fallbacks']:.0f} port "
                f"{rt.stats['hier_repair_fallbacks']:.0f}; fallbacks "
                f"{rj.stats['fallbacks']:.0f}")
        if diffs is not None:
            pairs = sorted(set(diffs[0].values()))
            line += (f"; hier vs flat score diffs JAX {len(diffs[0])} port "
                     f"{len(diffs[1])} ((hier, flat) scores {pairs})")
        print(line, flush=True)
