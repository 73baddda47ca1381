"""Fault R6: the hierarchical engine's custody of changed free rows.

A hierarchical engine keeps one persistent sub-engine a coarse domain,
each with its own mirror of its slice of the free matrix. Every row of a
slice that can differ from what its sub-engine last read must be declared
to it (the `note_free_rows` superset contract), or the sub-engine scores
on stale rows and, with `state_verify` on, raises.

The sequence that broke it: a contended backlog whose fine failures take
the alternate walk, so one parent solve solves a domain twice. The second
sub-solve reads the domain's rows with the first one's commits and
consumes the sub-engine's own declaration of them. When the caller then
hands the engine a free matrix without those commits (the pre-solve free,
as a scheduler does when binds are undone), the parent's sync compares it
with its own mirror, which never held the commits, and used to hand the
shards only the rows it found changed: none. The port now hands the
shards every row its sync consumed (`PlacementEngine._fan_out`).

The JAX package keeps the fault (`grove_tpu/solver/engine.py` fans out
`_sync_changed`): `TestReferenceFaultR6` records that it still raises on
the same inputs. The port's cases check, on the same inputs, that nothing
raises with `state_verify=True`, that the first solve does solve a domain
twice, that every sub-engine's mirror rows that differ from the slice it
is handed are covered by its declarations, and that the long-lived engine
places as a new engine does on the same free.
"""

import collections

import numpy as np
import pytest

import bench
from grove_tpu.solver import PlacementEngine as JaxEngine

from grove_tpu_torch.solver import PlacementEngine
from test_torch_hierarchy import assert_bitwise, port_gangs, port_snapshot

#: the smallest stress shape that solves a domain twice in one parent solve
NODES, GANGS = 1000, 400
KNOBS = dict(hierarchical=True, state_cache=True, fused=True,
             incremental=True, pallas_core=True)
SEQUENCES = ("unknown-scope", "declared-rows", "flat-between", "dispatch")
WIDTHS = {"auto": None, "serial": 0}


@pytest.fixture(scope="module")
def problem():
    snap = bench.make_cluster(NODES)
    gangs = bench.make_gangs(GANGS)
    unconfined = bench.make_gangs(8)
    for j, g in enumerate(unconfined):
        g.name = f"unconfined{j}"
        g.required_level = -1
    return snap, gangs, unconfined


def run_sequence(eng, snap, gangs, unconfined, kind):
    """Drive one engine (either package's) through `kind` and return
    (the last result, its free matrix, the free it was given). The first
    solve solves a domain twice; every sequence then hands the engine
    free content without that solve's commits."""
    free0 = snap.free.copy()
    f1 = free0.copy()
    if kind == "dispatch":
        # a hierarchical dispatch runs the two-level solve on a copy; a
        # change after it refuses the adoption, so solve() runs afresh
        # on content that never had the dispatch's commits
        handle = eng.dispatch(gangs, free=free0.copy())
        given = free0.copy()
        given[-1] *= np.float32(0.5)
        eng.note_free_rows([snap.num_nodes - 1])
        out = given.copy()
        res = eng.solve(gangs, free=out, dispatch=handle)
        return res, out, given
    eng.solve(gangs, free=f1)
    placed_rows = np.flatnonzero((f1 != free0).any(axis=1)).tolist()
    given = free0.copy()
    if kind == "unknown-scope":
        eng.note_free_rows(None)
    else:
        # the caller undoes the solve's commits and declares the rows
        eng.note_free_rows(placed_rows)
    if kind == "flat-between":
        # an unconfined backlog takes the flat path: its sync consumes
        # the declaration, which the shards must still get
        assert not eng.solve(unconfined, free=given).stats.get(
            "hierarchical")
    out = given.copy()
    res = eng.solve(gangs, free=out)
    return res, out, given


def covered(sub, sub_free) -> bool:
    """Whether a sub-engine's declarations cover every row where its
    mirror differs from the slice it is about to be handed."""
    st = sub._state
    if st.mirror is None or sub._hints is None or sub._hints is False:
        return True  # a full upload or a full content diff follows
    masked = sub._masked_free(sub_free)
    bad = np.flatnonzero((st.mirror != masked).any(axis=1))
    return set(bad.tolist()) <= sub._hints


@pytest.fixture
def watch(monkeypatch):
    """Count the parent's fine solves by domain a solve (or dispatch)
    and check, at every domain prepare, the sub-engine's custody of its
    slice."""
    log = {"solves": [], "uncovered": []}
    prepare = PlacementEngine._domain_prepare

    def counting(method):
        def call(self, gangs, *a, **kw):
            if self.hierarchical:
                log["solves"].append(collections.Counter())
            return method(self, gangs, *a, **kw)
        return call

    def checked_prepare(self, hs, dom, members, free):
        log["solves"][-1][dom] += 1
        work = prepare(self, hs, dom, members, free)
        if not work.memo and not covered(work.shard.engine, work.sub_free):
            log["uncovered"].append(dom)
        return work

    for name in ("solve", "dispatch"):
        monkeypatch.setattr(PlacementEngine, name,
                            counting(getattr(PlacementEngine, name)))
    monkeypatch.setattr(PlacementEngine, "_domain_prepare", checked_prepare)
    return log


class TestCustodyRepaired:
    @pytest.mark.parametrize("width", sorted(WIDTHS))
    @pytest.mark.parametrize("kind", SEQUENCES)
    def test_no_raise_and_custody_holds(self, problem, watch, kind, width):
        """With state_verify on, the sequence runs through; the first
        solve solves a domain twice (else the case proves nothing); no
        sub-engine is handed a slice whose changed rows it was not told
        of."""
        snap, gangs, unconfined = problem
        eng = PlacementEngine(port_snapshot(snap), device="cpu",
                              state_verify=True,
                              hier_parallel_workers=WIDTHS[width], **KNOBS)
        res, _, _ = run_sequence(eng, snap, port_gangs(gangs),
                                 port_gangs(unconfined), kind)
        assert res.stats.get("hierarchical") == 1.0
        assert max(watch["solves"][0].values()) >= 2, (
            "no domain was solved twice in one parent solve")
        assert watch["uncovered"] == []

    @pytest.mark.parametrize("width", sorted(WIDTHS))
    @pytest.mark.parametrize("kind", SEQUENCES)
    def test_long_lived_engine_equals_fresh(self, problem, kind, width):
        """After the sequence, the long-lived engine (state_verify off,
        the default) places bit for bit as a new engine does on the same
        free."""
        snap, gangs, unconfined = problem
        tsnap = port_snapshot(snap)
        tgangs = port_gangs(gangs)
        eng = PlacementEngine(tsnap, device="cpu",
                              hier_parallel_workers=WIDTHS[width], **KNOBS)
        res, out, given = run_sequence(eng, snap, tgangs,
                                       port_gangs(unconfined), kind)
        fresh = PlacementEngine(tsnap, device="cpu",
                                hier_parallel_workers=WIDTHS[width], **KNOBS)
        fout = given.copy()
        fres = fresh.solve(tgangs, free=fout)
        assert len(res.placed) == GANGS
        assert_bitwise(fres, res, fout, out, stats=False)


class TestReferenceFaultR6:
    """Reference fault R6 (ROADMAP §3), recorded on the same inputs: the
    JAX package's hierarchical engine still raises on every sequence,
    at both widths."""

    @pytest.mark.parametrize("width", sorted(WIDTHS))
    @pytest.mark.parametrize("kind", SEQUENCES)
    def test_reference_still_raises(self, problem, kind, width):
        snap, gangs, unconfined = problem
        eng = JaxEngine(snap, state_verify=True,
                        hier_parallel_workers=WIDTHS[width], **KNOBS)
        with pytest.raises(RuntimeError,
                           match="device free-state mirror diverged"):
            run_sequence(eng, snap, gangs, unconfined, kind)


def test_verify_message_counts_rows():
    """_verify_state names the first eight diverged rows and the count."""
    snap = bench.make_cluster(64)
    eng = PlacementEngine(port_snapshot(snap), device="cpu",
                          state_cache=True, state_verify=True)
    free = snap.free.copy()
    eng._sync_free(free)
    free[:20] *= np.float32(0.5)
    with pytest.raises(RuntimeError, match=r"\(20 rows in all\)"):
        eng._verify_state(free)
