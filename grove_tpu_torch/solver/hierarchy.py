"""Hierarchical two-level solve: domain-level pruning + shard-local
fine solves.

The counterpart of grove_tpu/solver/hierarchy.py (host numpy there too),
kept as this package's own copy. The flat engine materializes a [G, D]
value tensor over EVERY topology domain and a [N, D] membership product
behind it -- at 100k nodes and 4 levels the membership matrix alone is
[100k, ~107k] f32, about 43 GB. This module restructures the solve as two
levels mirroring the topology tree the encoding already has:

  1. COARSE (domain level): domains at a prune level (racks / blocks /
     zones) become super-nodes with aggregated free capacity. Per gang,
     inadmissible domains are eliminated with the SAME cut predicates
     the explain funnel uses (observability/explain.py
     domain_level_aggregates / classify_domain_cuts -- diagnosis and
     pruning share one elimination computation so they can never
     disagree), then a chunked best-fit commit over residual aggregates
     assigns each gang its surviving domains in priority order.
     Admissible BY CONSTRUCTION: every cut is implied by a constraint
     the exact solve enforces (aggregate free < total demand; no
     schedulable node; per-resource max node free < a signature's
     demand), so aggregation may only OVER-admit -- it can never prune a
     domain the flat solve would place into.

  2. FINE (node level): exact solves run only inside surviving domains,
     each through a per-domain sub-engine (a full PlacementEngine over
     the domain's sub-snapshot, on the parent's device, fused graph and
     all). Sub-engines PERSIST across solves, so each domain keeps its
     own device-resident free state, IncrementalCache and CUDA graphs --
     incrementality becomes SHARD-LOCAL (the clean-row permutation never
     crosses a domain boundary).

Gangs whose exact solve fails in every surviving domain fall back to
the full serial scan (solver/serial._place_one), exactly like the flat
engine's repair net -- hard-feasibility semantics stay identical, and an
under-admission could cost speed but never a placement. Placements are
SCORE-equal to the flat solve's, not bit-equal: the coarse commit
resolves cross-domain ties differently than the flat scan's jitter, so a
gang may land in a different equal-scoring domain. Against the JAX
package's hierarchical solve on the same inputs they are bit-equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..observability.explain import (
    classify_domain_cuts,
    domain_level_aggregates,
)
from ..topology.encoding import TopologySnapshot
from .problem import SolverGang

_EPS = 1e-6


def shift_level(level: int, prune_level: int) -> int:
    """Full-snapshot topology level index -> sub-snapshot index. Levels
    at or broader than the prune level map to -1 (the sub-root IS the
    prune-level domain, so any constraint there is satisfied by
    confinement); narrower levels shift down past the dropped ones."""
    if level < 0:
        return level
    return level - prune_level - 1 if level > prune_level else -1


def subset_snapshot(
    snapshot: TopologySnapshot, node_idx: np.ndarray, prune_level: int
) -> TopologySnapshot:
    """A dense TopologySnapshot over `node_idx` (one prune-level
    domain's nodes) carrying only the levels NARROWER than the prune
    level, with per-level domain ids re-densified. Node names are
    preserved, so sub-solve pod_to_node maps are globally valid as-is;
    free content is per-solve input and the copied slice here is only a
    construction-time placeholder."""
    lo = prune_level + 1
    levels = snapshot.num_levels
    sub_ids = np.zeros((levels - lo, len(node_idx)), dtype=np.int32)
    num_domains = np.zeros((levels - lo,), dtype=np.int32)
    level_domains: list[list[tuple]] = []
    for out, level in enumerate(range(lo, levels)):
        ids = snapshot.domain_ids[level, node_idx]
        uniq, dense = np.unique(ids, return_inverse=True)
        sub_ids[out] = dense
        num_domains[out] = len(uniq)
        try:
            table = snapshot.level_domains[level]
            level_domains.append([table[u] for u in uniq])
        except (IndexError, TypeError):
            level_domains.append([])
    names = [snapshot.node_names[i] for i in node_idx]
    return TopologySnapshot(
        level_keys=list(snapshot.level_keys[lo:]),
        level_domains=level_domains,
        domain_ids=sub_ids,
        num_domains=num_domains,
        node_names=names,
        node_index={n: i for i, n in enumerate(names)},
        resource_names=snapshot.resource_names,
        capacity=np.ascontiguousarray(snapshot.capacity[node_idx]),
        free=np.ascontiguousarray(snapshot.free[node_idx]),
        schedulable=np.ascontiguousarray(snapshot.schedulable[node_idx]),
        node_labels=[snapshot.node_labels[i] for i in node_idx]
        if snapshot.node_labels else [],
        node_taints=[snapshot.node_taints[i] for i in node_idx]
        if snapshot.node_taints else [],
    )


class DomainShard:
    """One coarse domain's fine-solve state: the sub-snapshot, its
    (lazily built, persistent) sub-engine, sliced-eligibility-mask and
    gang-proxy caches, the pending changed-row declarations the parent
    sync feeds down, and the last solve's input/output rows for the
    domain-level reuse tier (an unchanged gang set against unchanged
    free rows replays the previous placements in O(1))."""

    __slots__ = (
        "dom", "idx", "snapshot", "engine", "mask_cache", "proxies",
        "pending_rows", "last_sig", "last_pre", "last_post",
        "last_placed", "disp_seen", "inc_rows_seen", "reuse_seen",
    )

    def __init__(self, dom: int, idx: np.ndarray,
                 snapshot: TopologySnapshot):
        self.dom = dom
        self.idx = idx
        self.snapshot = snapshot
        self.engine = None
        #: id(full mask) -> sliced [Nd] mask (shared across proxies and
        #: solves so the sub-engine's identity-based mask dedup works)
        self.mask_cache: dict[int, np.ndarray] = {}
        #: gang name -> (original gang ref, proxy) -- identity-checked
        self.proxies: dict[str, tuple] = {}
        #: local row indices declared changed since the last sub-solve
        #: (None = unknown scope; the sub-engine falls back to its full
        #: content diff per the note_free_rows contract)
        self.pending_rows: set | None = set()
        self.last_sig = None
        self.last_pre: np.ndarray | None = None
        self.last_post: np.ndarray | None = None
        self.last_placed: list | None = None
        #: sub-engine counter watermarks, mirrored into the parent's
        #: dispatch/incremental accounting after every sub-solve
        self.disp_seen = {
            "fused": 0, "split": 0, "incremental": 0, "whatif": 0,
        }
        self.inc_rows_seen = 0
        self.reuse_seen = 0

    def note_rows(self, rows) -> None:
        if self.pending_rows is None:
            return
        if rows is None:
            self.pending_rows = None
        else:
            self.pending_rows.update(rows)

    def proxy(self, gang: SolverGang, prune_level: int) -> SolverGang:
        """The gang re-expressed against the sub-snapshot: topology
        levels shifted past the dropped broader levels, eligibility
        masks sliced to the domain's nodes. Cached by gang identity --
        the scheduler rebuilds SolverGangs every round (cache miss,
        rebuilt), benches re-solve the same objects (hit); the volatile
        fairness stamp is re-synced on every hit."""
        cached = self.proxies.get(gang.name)
        if cached is not None and cached[0] is gang:
            cached[1].fairness = gang.fairness
            return cached[1]
        if len(self.proxies) > 4096:
            # bounded: long-churn workloads retire gang names forever
            # (serving scale-up/down cycles); a full rebuild round after
            # a clear is cheap next to leaking every name ever seen
            self.proxies.clear()
        pod_elig = None
        if gang.pod_elig is not None:
            pod_elig = []
            for m in gang.pod_elig:
                if m is None:
                    pod_elig.append(None)
                    continue
                sliced = self.mask_cache.get(id(m))
                if sliced is None:
                    sliced = self.mask_cache[id(m)] = np.ascontiguousarray(
                        m[self.idx]
                    )
                pod_elig.append(sliced)
        shift = lambda lvl: shift_level(int(lvl), prune_level)  # noqa: E731
        cgroups = []
        for members, req, pref in gang.constraint_groups:
            req2, pref2 = shift(req), shift(pref)
            if req2 >= 0 or pref2 >= 0:
                cgroups.append((members, req2, pref2))
        p = dataclasses.replace(
            gang,
            group_required_level=np.asarray(
                [shift(v) for v in gang.group_required_level], np.int32
            ),
            group_preferred_level=np.asarray(
                [shift(v) for v in gang.group_preferred_level], np.int32
            ),
            required_level=shift(gang.required_level),
            preferred_level=shift(gang.preferred_level),
            constraint_groups=cgroups,
            pod_elig=pod_elig,
        )
        object.__setattr__(p, "_total_demand", gang.total_demand())
        self.proxies[gang.name] = (gang, p)
        return p


class DomainWork:
    """One domain's in-flight fine solve within a wave -- the handle the
    engine's dispatch-all/collect-in-order loop threads between its
    three phases. `prepare` (main thread, deterministic domain order)
    fills the slice/memo/sig fields; `dispatch` (thread-pooled) fills
    the proxies and the sub-engine's SolveDispatch handle; `collect`
    (main thread, deterministic domain order again) consumes everything.
    A memo hit (`memo=True`) skips the dispatch half entirely -- the
    replay needs no device work."""

    __slots__ = ("dom", "members", "shard", "gangs", "sig", "sub_free",
                 "pre", "memo", "proxies", "handle", "fut",
                 "encode_seconds")

    def __init__(self, dom: int, members, shard: DomainShard, gangs,
                 sig, sub_free: np.ndarray):
        self.dom = dom
        self.members = members
        self.shard = shard
        self.gangs = gangs
        self.sig = sig
        self.sub_free = sub_free
        #: pre-solve copy of the domain's free rows (the reuse memo key)
        self.pre: np.ndarray | None = None
        #: domain-reuse memo hit: collect replays shard.last_placed /
        #: last_post without any dispatch
        self.memo = False
        #: sub-snapshot gang proxies, built in the dispatch half
        self.proxies: list | None = None
        #: the sub-engine's in-flight SolveDispatch (None when the
        #: sub-backlog had nothing to score -- collect solves plain)
        self.handle = None
        #: the dispatch half's Future when thread-pooled (None = inline)
        self.fut = None
        #: host wall of the dispatch half (encode + staged sync + launch)
        self.encode_seconds = 0.0


class HierarchyState:
    """Per-engine hierarchical solve state for ONE (snapshot, prune
    level): the global-node -> (coarse domain, local row) maps and the
    lazily built DomainShards. Dropped wholesale on engine rebuild or
    invalidate; rebind() swaps the snapshot in place (schedulable flips
    ride each shard's delta path)."""

    def __init__(self, snapshot: TopologySnapshot, level: int):
        self.snapshot = snapshot
        self.level = level
        self.dom_of = snapshot.domain_ids[level]
        self.nd = int(snapshot.num_domains[level])
        # local row index of each node within its coarse domain
        order = np.argsort(self.dom_of, kind="stable")
        local = np.empty(snapshot.num_nodes, dtype=np.int64)
        counts = np.bincount(self.dom_of, minlength=self.nd)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        local[order] = np.arange(snapshot.num_nodes) - np.repeat(
            starts, counts
        )
        self.local_of = local
        self.shards: dict[int, DomainShard] = {}
        #: coarse-pass accounting for stats/debug: domains eliminated by
        #: the admissibility cuts across the last solve's backlog
        self.last_pruned = 0
        self.last_admissible = 0

    def shard(self, dom: int) -> DomainShard:
        s = self.shards.get(dom)
        if s is None:
            idx = np.flatnonzero(self.dom_of == dom)
            s = self.shards[dom] = DomainShard(
                dom, idx, subset_snapshot(self.snapshot, idx, self.level)
            )
        return s

    def push_rows(self, rows) -> None:
        """Fan a parent-observed changed-row declaration out to the
        owning shards (rows=None -> unknown scope everywhere). Only
        shards that already exist need the hint -- a shard built later
        starts from a fresh sub-snapshot slice."""
        if rows is None:
            for s in self.shards.values():
                s.note_rows(None)
            return
        rows = np.asarray(rows, dtype=np.int64)
        if rows.size == 0:
            return
        doms = self.dom_of[rows]
        locs = self.local_of[rows]
        for dom in np.unique(doms):
            s = self.shards.get(int(dom))
            if s is not None:
                s.note_rows(locs[doms == dom].tolist())

    def rebind(self, snapshot: TopologySnapshot) -> None:
        """Adopt a statically-identical snapshot whose schedulable bits
        may have flipped: each existing shard re-slices and rebinds its
        sub-engine (flips ride the sub delta path; a sub-engine that
        predates its first solve just gets the new sub-snapshot)."""
        self.snapshot = snapshot
        for s in self.shards.values():
            sub = dataclasses.replace(
                s.snapshot,
                schedulable=np.ascontiguousarray(
                    snapshot.schedulable[s.idx]
                ),
            )
            if s.engine is not None and s.engine.rebind(sub):
                s.snapshot = sub
            else:
                s.snapshot = sub
                if s.engine is not None:
                    s.engine = None  # static change inside the shard
            # the domain-reuse tier keys on free content only; a
            # schedulable flip changes what a solve may use without
            # changing free rows, so the memo must drop
            s.last_sig = None
            s.last_placed = None
            # mask slices + proxies key on the OUTGOING snapshot's
            # shared eligibility-mask identities; the new snapshot
            # allocates fresh masks, so the old entries would only leak
            s.mask_cache.clear()
            s.proxies.clear()


def coarse_admissible(
    order: list[SolverGang],
    snapshot: TopologySnapshot,
    fm: np.ndarray,
    level: int,
) -> tuple[np.ndarray, np.ndarray, dict, np.ndarray]:
    """[G, nd] admissibility of every coarse domain for every gang, via
    the funnel's shared cut predicates plus the per-resource max-node-
    free fit bound. Every cut is implied by a constraint the exact
    solve enforces, so the set can only over-admit. Returns
    (admissible [G, nd] bool, dom_free [nd, R], stats,
    class_ids [G] -- the demand-equivalence class per gang, for
    coarse_assign's per-class ranking)."""
    sched = snapshot.schedulable
    ids = snapshot.domain_ids[level]
    nd = int(snapshot.num_domains[level])
    sched_cnt, dom_free = domain_level_aggregates(ids, nd, sched, fm)
    # per-resource max free on any schedulable node per domain: a
    # signature demanding more of resource r than ANY node offers has no
    # fitting node there -- a sound cut (fitting needs every resource on
    # one node); maxing across different nodes only over-admits.
    max_free = np.zeros_like(dom_free)
    srows = np.flatnonzero(sched)
    np.maximum.at(max_free, ids[srows], fm[srows].astype(np.float64))
    td_all = np.stack([g.total_demand() for g in order]).astype(np.float64)
    sig_max = np.stack(
        [g.sig_max_demand() for g in order]
    ).astype(np.float64)
    # admissibility depends only on the (total demand, max signature
    # demand) pair, and gangs come from few pod templates -- classify
    # the UNIQUE rows and gather, so the [G, nd] cut evaluation is
    # O(U * nd) instead of O(G * nd) (at the 100k tier: 1 unique row
    # for 20k gangs)
    keyed = np.concatenate([td_all, sig_max], axis=1)
    uniq, inverse = np.unique(keyed, axis=0, return_inverse=True)
    u_td = uniq[:, : td_all.shape[1]]
    u_sig = uniq[:, td_all.shape[1]:]
    cordoned, agg_cut, remaining = classify_domain_cuts(
        u_td[:, None, :], dom_free, sched_cnt
    )
    fit_ok = (max_free[None, :, :] + _EPS >= u_sig[:, None, :]).all(
        axis=-1
    )
    u_admissible = remaining & fit_ok
    admissible = u_admissible[inverse]
    agg_cut = agg_cut[inverse]
    remaining = remaining[inverse]
    fit_ok = fit_ok[inverse]
    g = len(order)
    adm_total = int(admissible.sum())
    stats = {
        "domains": nd,
        # (gang, domain) pair counts, mirroring the funnel's partition:
        # every pair is cut by exactly one stage or survives
        "cut_cordoned": g * int(cordoned.sum()),
        "cut_capacity": int(agg_cut.sum()),
        "cut_fit": int((remaining & ~fit_ok).sum()),
        "admissible": adm_total,
        "pruned": g * nd - adm_total,
    }
    return admissible, dom_free, stats, inverse.reshape(-1)


def cluster_level_aggregates(
    snapshots: list[TopologySnapshot],
) -> tuple[np.ndarray, np.ndarray, np.ndarray, list[str]]:
    """`domain_level_aggregates` lifted ONE level above the topology
    tree: each member cluster of a federation is a single super-domain
    (ids all zero, nd = 1 per snapshot), so the global router's cut
    predicates are literally the coarse phase's, evaluated over
    per-cluster aggregates. Returns (sched_cnt [C], free [C, R],
    max_free [C, R], resource_names) on the UNION resource axis --
    heterogeneous members contribute zero for resources they lack,
    which can only tighten their own cuts, never another cluster's.

    The over-admit contract carries up unchanged: every cut is implied
    by a constraint some member control plane would itself enforce
    (no schedulable node; aggregate free short of total demand; no
    single node fits the largest pod), so routing may only OVER-admit --
    a cluster the flat single-cluster solve would place into is never
    cut (the JAX package's tests/test_federation.py sweeps this
    against per-cluster exact solves)."""
    axis: list[str] = []
    for snap in snapshots:
        for r in snap.resource_names:
            if r not in axis:
                axis.append(r)
    c, nr = len(snapshots), len(axis)
    sched_cnt = np.zeros(c, dtype=np.float64)
    free = np.zeros((c, nr), dtype=np.float64)
    max_free = np.zeros((c, nr), dtype=np.float64)
    for i, snap in enumerate(snapshots):
        cols = [axis.index(r) for r in snap.resource_names]
        fm = np.where(snap.schedulable[:, None], snap.free, 0.0)
        cnt, agg = domain_level_aggregates(
            np.zeros(fm.shape[0], dtype=np.int64), 1,
            snap.schedulable, fm,
        )
        sched_cnt[i] = cnt[0]
        free[i, cols] = agg[0]
        srows = np.flatnonzero(snap.schedulable)
        if srows.size:
            max_free[i, cols] = fm[srows].max(axis=0)
    return sched_cnt, free, max_free, axis


def coarse_assign(
    order: list[SolverGang],
    admissible: np.ndarray,
    dom_free: np.ndarray,
    cap_scale: np.ndarray,
    top_kc: int = 4,
    chunk: int = 256,
    class_ids: np.ndarray | None = None,
) -> list[list[int]]:
    """Chunked best-fit commit over residual aggregates: gangs (already
    in priority order) pick their tightest admissible, residually
    feasible coarse domain `chunk` at a time, each gang recording up to
    `top_kc` ranked survivors (primary first; the fine phase walks the
    alternates when an exact solve fails). Mirrors the device commit
    scan's contract: within-chunk collisions may transiently overcommit
    a domain -- the exact fine solves resolve them. Returns one ranked
    domain-id list per gang ([] = inadmissible everywhere: the gang
    goes straight to the serial exactness net).

    `class_ids` (from coarse_admissible) asserts that equal ids imply
    equal (demand, admissible-row) pairs -- pass None whenever admissible
    rows were edited per gang after classification (the engine's retry
    rounds mask out already-tried domains), and the classes are
    recomputed here including the rows."""
    g = len(order)
    resid = dom_free.astype(np.float64).copy()
    scale = np.maximum(np.asarray(cap_scale, np.float64), _EPS)
    td_all = np.stack([gg.total_demand() for gg in order]).astype(
        np.float64
    )
    choices: list[list[int]] = [None] * g  # type: ignore[list-item]
    nd = resid.shape[0]
    eps_row = -_EPS / scale
    # gangs come from few pod templates: rank once per demand-
    # equivalence CLASS per chunk instead of per gang -- same demand
    # pair implies the same admissible row (coarse_admissible computes
    # it from exactly that pair) and hence the same ranking against the
    # same chunk residual. O(classes * nd) per chunk instead of
    # O(C * nd).
    if class_ids is not None:
        cls = np.asarray(class_ids)
    else:
        cls = np.unique(
            np.concatenate(
                [td_all, admissible.astype(np.float64)], axis=1
            ),
            axis=0, return_inverse=True,
        )[1].reshape(-1)
    for start in range(0, g, chunk):
        end = min(start + chunk, g)
        prim = np.full(end - start, -1, np.int64)
        for c in np.unique(cls[start:end]):
            members = np.flatnonzero(cls[start:end] == c)
            i0 = start + int(members[0])
            td = td_all[i0]                              # [R]
            leftover = (resid - td[None, :]) / scale     # [nd, R]
            feas = admissible[i0] & (leftover >= eps_row).all(axis=-1)
            slack = np.where(feas, leftover.max(axis=-1), np.inf)
            nf = int(feas.sum())
            k = int(min(top_kc, nf))
            # top-kc tightest via argpartition (a full argsort was the
            # assignment's hot spot at the 100k tier), sorted within
            # the kc slice so the walk order stays tightest-first.
            # Deterministic for fixed inputs; exact-tie order follows
            # the partition, not the domain index -- any admissible
            # choice is score-equal, which is what the gate pins.
            part = np.argpartition(slack, min(top_kc, nd - 1))[:top_kc]
            ranked = part[np.argsort(slack[part], kind="stable")]
            alts = ranked[:k].tolist()
            if nf > k:
                # DIVERSE tail: best-fit ranks every near-full domain
                # ahead of every empty one, so a gang whose tight
                # candidates all fail exact placement (fragmentation at
                # ~100% fill) would walk alternates that are just MORE
                # full domains and land in the serial net. The last
                # alternate is therefore the LOOSEST admissible domain
                # -- the place most likely to succeed if anywhere can.
                lo = int(np.where(feas, slack, -np.inf).argmax())
                if lo not in alts:
                    alts[-1] = lo
            for m in members:
                choices[start + int(m)] = alts
            prim[members] = alts[0] if alts else -1
        # commit every primary before the next chunk chooses
        has = prim >= 0
        if has.any():
            np.subtract.at(
                resid, prim[has], td_all[start:end][has]
            )
    return choices
