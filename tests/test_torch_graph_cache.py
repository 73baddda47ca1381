"""The graph cache's bound, the launch counters under threads, and the
incremental program's static inputs: what the CPU can check of the three
repairs the hierarchical wave needs.

- `GraphLru`, the bounded LRU of one engine's captured graphs, driven with
  fake entries: the bound, the eviction order, and the engine dropping an
  incremental cache that points into an evicted entry.
- `kernel_core.count_launch` hammered from 8 threads: the totals exact;
  `capture_counts` keeps one thread's capture apart from the others.
- K6 as its CUDA graph runs it, eagerly on the CPU: the cache copied into
  static inputs by `programs.load_cache` (skipped where they are the same
  memory), then `inc_score` on those inputs, bit-equal to `inc_score` on
  the cache itself.

`FusedGraphs` captures only on the card (chip_smoke.py's graph-cache
phase); `EagerGraphs` below keeps all of its logic (keys, LRU, static
inputs, eviction, launch accounting) and replaces each capture by an eager
run whose replays write the same output tensors in place, as a graph's
do, so an engine driven through it on the CPU exercises the cache whole.
"""

import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from grove_tpu_torch import stress
from grove_tpu_torch.solver import PlacementEngine, programs
from grove_tpu_torch.solver import kernel_core as kc
from grove_tpu_torch.solver.engine import IncrementalCache


class EagerGraphs(programs.FusedGraphs):
    """FusedGraphs on the CPU: a capture is one eager run of the program,
    and a replay runs it again and copies the results into the first
    run's output tensors."""

    def _load(self, dst, host, arr):
        if host is not None and np.array_equal(host, arr):
            return host
        dst.copy_(torch.from_numpy(arr))
        return arr.copy()

    def _capture(self, entry, free, statics, lay, **kw):
        def program():
            return self._program(entry, free, statics, lay, **kw)

        entry.outs = program()

        def replay():
            for out, new in zip(entry.outs, program()):
                out.copy_(new)

        entry.graph = SimpleNamespace(replay=replay)
        entry.launches = {}
        self.captures += 1


def eager_graph_engine(snap, monkeypatch, **knobs):
    """A CPU engine (the kernels' plain versions) whose fused and
    incremental programs run through EagerGraphs."""
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    eng = PlacementEngine(snap, device="cpu", pallas_core=True,
                          device_commit=True, **knobs)
    eng._graphs = EagerGraphs(eng.device, eng._graph_evicted)
    return eng


class CapturedEagerGraphs(EagerGraphs):
    """EagerGraphs whose program runs count as a capture's do on the card:
    the wrappers it calls (K7's `scatter_rows` among them) add nothing to
    the counters, and a replay adds what `FusedGraphs.run` counts."""

    def _program(self, *args, **kw):
        with kc.capture_counts():
            return super()._program(*args, **kw)


def fake_entry(rows=4, cols=3):
    """An entry shaped like a captured graph's: its (packed, value, td)
    outputs."""
    return SimpleNamespace(outs=(torch.zeros(rows, 2), torch.zeros(rows, cols),
                                 torch.zeros(rows, 3)))


class TestGraphLru:
    def test_bound_is_a_small_constant(self):
        assert 8 <= programs.GRAPH_KEYS <= 16
        with pytest.raises(ValueError):
            programs.GraphLru(0)

    def test_bound_and_eviction_order(self):
        evicted = []
        lru = programs.GraphLru(3, lambda k, e: evicted.append(k))
        for k in "abc":
            lru.put(k, fake_entry())
        assert len(lru) == 3 and evicted == []
        assert lru.get("a") is not None          # a is now the most recent
        lru.put("d", fake_entry())
        assert evicted == ["b"]
        assert lru.keys() == ["c", "a", "d"]
        lru.get("c")
        lru.put("e", fake_entry())
        lru.put("f", fake_entry())
        assert evicted == ["b", "a", "d"]
        assert lru.keys() == ["c", "e", "f"]
        assert lru.evictions == 3
        assert lru.get("b") is None and "b" not in lru

    @pytest.mark.parametrize("bound", [1, 2, 8, 12])
    def test_never_exceeds_bound(self, bound):
        """Against a list model of least-recently-used order."""
        rng = np.random.default_rng(bound)
        evicted = []
        lru = programs.GraphLru(bound, lambda k, e: evicted.append(k))
        model, want = [], []
        for _ in range(200):
            k = int(rng.integers(40))
            if k in model:
                model.remove(k)
            elif len(model) == bound:
                want.append(model.pop(0))
            model.append(k)
            if lru.get(k) is None:
                lru.put(k, fake_entry())
            assert len(lru) <= bound
        assert lru.keys() == model
        assert evicted == want and lru.evictions == len(want) > 0

    def test_evicting_drops_a_cache_that_points_into_the_entry(self):
        eng = PlacementEngine(stress.make_cluster(64), device="cpu")
        lru = programs.GraphLru(2, eng._graph_evicted)
        a, b = fake_entry(), fake_entry()
        lru.put("a", a)
        lru.put("b", b)
        # the cache points at entry a's outputs (a K6 cache is a row view)
        cache = IncrementalCache(1, {}, {}, a.outs[1][:3], a.outs[2][:3], 4, 3)
        eng._inc = cache
        token_cache = cache           # what a pending dispatch token holds
        lru.get("a")
        lru.put("c", fake_entry())    # evicts b: the cache survives
        assert eng._inc is cache and cache.value_dev is not None
        lru.put("d", fake_entry())    # evicts a: the cache is dropped
        assert eng._inc is None
        assert token_cache.value_dev is None and token_cache.td_dev is None
        assert eng._maybe_incremental(SimpleNamespace(keys=[("t", "x")])) is None

    def test_eviction_keeps_a_cache_elsewhere(self):
        eng = PlacementEngine(stress.make_cluster(64), device="cpu")
        lru = programs.GraphLru(1, eng._graph_evicted)
        lru.put("a", fake_entry())
        mine = fake_entry()
        eng._inc = IncrementalCache(1, {}, {}, mine.outs[1], mine.outs[2], 4, 4)
        lru.put("b", fake_entry())
        assert eng._inc is not None and eng._inc.value_dev is mine.outs[1]

    def test_debug_summary_reports_the_cache(self):
        eng = PlacementEngine(stress.make_cluster(64), device="cpu")
        fg = eng.debug_summary()["fused_graphs"]
        assert fg["bound"] == programs.GRAPH_KEYS
        assert fg["keys"] == fg["evictions"] == fg["inc_replays"] == 0


class TestLaunchCounters:
    THREADS, PER_THREAD = 8, 2000

    def test_threads_lose_no_count(self):
        kc.reset_launches()
        names = ("value_sig_kernel", "value_sig_kernel_bf16", "commit_topk",
                 "commit_scan", "value_kernel")
        barrier = threading.Barrier(self.THREADS)

        def hammer(t):
            barrier.wait()
            for i in range(self.PER_THREAD):
                kc.count_launch(names[(t + i) % len(names)])
            kc.add_launches({"commit_scan": 1, "commit_topk": 2})

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=hammer, args=(t,))
                       for t in range(self.THREADS)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
            assert not any(th.is_alive() for th in threads)
        finally:
            sys.setswitchinterval(old)
        counts = kc.launch_counts()
        total = self.THREADS * self.PER_THREAD
        assert sum(counts[n] for n in names) == total + 3 * self.THREADS
        per = total // len(names)
        assert counts["value_sig_kernel"] == per
        assert counts["commit_scan"] == per + self.THREADS
        assert counts["commit_topk"] == per + 2 * self.THREADS
        assert counts["value_kernel_bf16"] == 0
        kc.reset_launches()
        assert set(kc.launch_counts().values()) == {0}

    def test_capture_counts_are_per_thread(self):
        kc.reset_launches()
        inside = threading.Event()
        done = threading.Event()
        seen = {}

        def capturing():
            with kc.capture_counts() as counts:
                kc.count_launch("commit_topk", 3)
                inside.set()
                done.wait(timeout=30)
                kc.count_launch("commit_scan")
            seen.update(counts)

        th = threading.Thread(target=capturing)
        th.start()
        assert inside.wait(timeout=30)
        kc.count_launch("commit_topk")   # another thread, mid-capture
        done.set()
        th.join(timeout=30)
        assert not th.is_alive()
        assert seen == {"commit_topk": 3, "commit_scan": 1}
        counts = kc.launch_counts()
        assert counts["commit_topk"] == 1 and counts["commit_scan"] == 0
        with pytest.raises(KeyError):
            kc.count_launch("scatter")
        kc.reset_launches()

    def test_delta_scatter_counts_as_k7_outside_a_capture(self):
        """K7 (`programs.scatter_rows`) counts one launch in
        `replay_counts()` where it runs, none while a graph is captured
        (a K5 replay carrying a delta block counts it instead)."""
        free = torch.zeros(5, 2)
        upd = torch.tensor([[1.0, 3.0, 4.0], [4.0, 0.0, 0.0]])
        programs.reset_replays()
        programs.scatter_rows(free, upd)
        assert programs.replay_counts()["K7"] == 1
        assert free[1].tolist() == [3.0, 4.0]
        with kc.capture_counts():
            programs.scatter_rows(free, upd)
        assert programs.replay_counts()["K7"] == 1
        programs.reset_replays()
        assert programs.replay_counts()["K7"] == 0


def captured_inc_call(monkeypatch):
    """Run an incremental tick on a CPU engine (the kernels' plain
    versions) and return the arguments its `inc_score` call got."""
    calls = []
    orig = programs.inc_score

    def keep(*args, **kw):
        calls.append((args, kw))
        return orig(*args, **kw)

    monkeypatch.setattr(programs, "inc_score", keep)
    eng = PlacementEngine(stress.make_cluster(512), device="cpu",
                          pallas_core=True, device_commit=True)
    gangs = stress.make_gangs(40)
    eng.solve(gangs)
    fresh = stress.make_gangs(2)
    for j, g in enumerate(fresh):
        g.name = f"fresh{j}"
        gangs[5 + 7 * j] = g
    res = eng.solve(gangs)
    assert res.stats.get("incremental") == 1.0
    monkeypatch.setattr(programs, "inc_score", orig)
    assert len(calls) == 1
    return calls[0]


class TestStaticInputs:
    def test_static_wrapper_equals_inc_score(self, monkeypatch):
        (free, value_c, td_c, statics, masks, io, lay), kw = \
            captured_inc_call(monkeypatch)
        want = programs.inc_score(free, value_c, td_c, statics, masks, io,
                                  lay, **kw)
        value_in = torch.full_like(value_c, float("nan"))
        td_in = torch.full_like(td_c, float("nan"))
        assert programs.load_cache(value_in, td_in, (value_c, td_c)) == 2
        got = programs.inc_score(free, value_in, td_in, statics, masks, io,
                                 lay, **kw)
        for a, b in zip(want, got):
            assert torch.equal(a, b)
        assert torch.equal(value_in, value_c) and torch.equal(td_in, td_c)
        # the program never writes into the buffers it reads
        assert all(o.untyped_storage().data_ptr()
                   not in (value_in.data_ptr(), td_in.data_ptr())
                   for o in got)

    def test_copy_in_and_pointer_skip(self, monkeypatch):
        (free, value_c, td_c, statics, masks, io, lay), kw = \
            captured_inc_call(monkeypatch)
        value_in, td_in = torch.empty_like(value_c), torch.empty_like(td_c)
        assert programs.load_cache(value_in, td_in, (value_c, td_c)) == 2
        # the static inputs already ARE the cache: nothing to copy
        assert programs.load_cache(value_in, td_in, (value_in, td_in)) == 0
        want = programs.inc_score(free, value_c, td_c, statics, masks, io,
                                  lay, **kw)
        got = programs.inc_score(free, value_in, td_in, statics, masks, io,
                                 lay, **kw)
        for a, b in zip(want, got):
            assert torch.equal(a, b)


class TestEagerGraphCache:
    """The engine through the graph cache on the CPU: backlogs whose G
    buckets cross 8-256 with churn whose staged rows cross 1-60, and dirty
    ticks (the K6 keys); every solve bit-equal to the full re-encode
    engine, the graphs within the bound, evictions that drop the cache."""

    GANGS = (5, 12, 30, 60, 120, 250, 7, 100, 16, 200, 3, 40, 90, 9)
    ROWS = (1, 3, 16, 40, 60, 8, 25)

    def test_sequence_bounded_and_bit_equal(self, monkeypatch):
        snap = stress.make_cluster(512)
        eng = eager_graph_engine(snap, monkeypatch)
        ref = PlacementEngine(snap, device="cpu", pallas_core=True,
                              device_commit=True, state_cache=False,
                              fused=False, incremental=False)
        rng = np.random.default_rng(11)
        base = snap.free.copy()
        pod = np.array([4.0, 16.0, 1.0], np.float32)
        paths = []
        for p in range(2):
            for i, g in enumerate(self.GANGS):
                rows = rng.choice(snap.num_nodes,
                                  size=self.ROWS[i % len(self.ROWS)],
                                  replace=False)
                for k, r in enumerate(rows):
                    if k % 2 == 0 and (base[r] >= pod).all():
                        base[r] -= pod
                    else:
                        base[r] = np.minimum(snap.capacity[r], base[r] + pod)
                eng.note_free_rows(rows.tolist())
                gangs = stress.make_gangs(g)
                for tick in range(2):
                    if tick:   # a dirty tick at an unchanged epoch: K6
                        fresh = stress.make_gangs(1)[0]
                        fresh.name = f"fresh{p}-{i}"
                        gangs[len(gangs) // 2] = fresh
                    free, free_ref = base.copy(), base.copy()
                    res = eng.solve(gangs, free=free)
                    want = ref.solve(gangs, free=free_ref)
                    assert_same(res, want, free, free_ref)
                    assert len(eng._graphs) <= programs.GRAPH_KEYS
                    paths.append(eng._last_begin.get("path"))
        fg = eng.debug_summary()["fused_graphs"]
        assert fg["evictions"] > 0
        assert fg["inc_replays"] > 0
        assert fg["keys"] == len(eng._graphs) <= fg["bound"]
        assert fg["captured"] == fg["keys"] + fg["evictions"]
        assert {"fused", "incremental"} <= set(paths)


def assert_same(a, b, free_a, free_b):
    assert sorted(a.placed) == sorted(b.placed)
    for name, pa in a.placed.items():
        assert np.array_equal(pa.node_indices, b.placed[name].node_indices)
        assert pa.placement_score == b.placed[name].placement_score
    assert {n: str(r) for n, r in a.unplaced.items()} == {
        n: str(r) for n, r in b.unplaced.items()}
    assert np.array_equal(free_a, free_b)


def test_whatif_replay_with_rows_counts_its_k7(monkeypatch):
    """A what-if graph whose io carries overlay rows runs K7 on its
    scratch copy inside the graph: each replay counts one K7 launch, as a
    K5 replay with a delta block does, and the resident state is not
    written."""
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    snap = stress.make_cluster(512)
    eng = PlacementEngine(snap, device="cpu", pallas_core=True,
                          device_commit=True)
    eng._graphs = CapturedEagerGraphs(eng.device, eng._graph_evicted)
    free = snap.free.copy()
    eng.solve(stress.make_gangs(40), free=free)
    probe = stress.make_gangs(3)
    for j, g in enumerate(probe):
        g.name = f"w{j}"
    programs.reset_replays()
    for i in range(3):
        resident = eng._state.dev.clone()
        assert eng.whatif_scores(probe, free=free,
                                 free_rows={4: snap.capacity[4]}) is not None
        assert torch.equal(eng._state.dev, resident)
        counts = programs.replay_counts()
        assert counts["whatif"] == counts["K7"] == i + 1
