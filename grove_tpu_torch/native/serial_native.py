"""ctypes wrapper: SolverGangs -> flat arrays -> the C++ serial solve and
exact repair (serial_scorer.cpp).

The counterpart of grove_tpu/native/serial_native.py, with one difference
on purpose: the library is required. Where the reference returns None
when g++ or the ABI handshake fails (and its callers quietly run Python),
these functions raise (native/build.py). `PlacementEngine(...,
native_repair=False)` selects the Python repair explicitly.

Same problem encoding as the Python serial path; the caller pre-sorts
gangs by gang_sort_key, so both walk gangs in the identical order.
Per-pod node-eligibility masks ship once per unique row, each pod
carrying a row index. The C++ core implements the full fit.py constraint
model: gang/group required and preferred pack levels, constraint groups
and eligibility masks.
"""

from __future__ import annotations

import ctypes as ct
import time

import numpy as np

from ..observability.explain import diagnose_unplaced
from ..solver.problem import SolverGang, dedupe_pod_masks
from ..solver.result import GangPlacement, SolveResult
from ..solver.serial import gang_sort_key, stamp_fairness
from ..topology.encoding import TopologySnapshot
from .build import load_library


def _encode_elig(order: list[SolverGang], num_nodes: int):
    """(masks uint8 [M, N], pod_mask_idx int32 [P_total]) or (None, None)
    when no gang carries masks."""
    rows, idx = dedupe_pod_masks(order)
    if not rows:
        return None, None
    masks = np.ascontiguousarray(np.stack(rows).astype(np.uint8))
    if masks.shape[1] != num_nodes:  # guards C++ OOB; must survive python -O
        raise ValueError(
            f"eligibility masks are {masks.shape[1]}-wide, snapshot has "
            f"{num_nodes} nodes"
        )
    return masks, idx


def domain_node_index(domain_ids: np.ndarray, dom_offsets: np.ndarray,
                      num_domains: int) -> tuple[np.ndarray, np.ndarray]:
    """Every global domain's nodes as a CSR: (offsets int32 [D+1], nodes
    int32), a domain's nodes in ascending order. `domain_ids` [L, N] holds
    each node's local id per level, `dom_offsets` [L] each level's first
    global id (the engine's DomainSpace numbering: the root is 0 and owns
    no entry). The repair walks it instead of scanning every node."""
    levels, n = domain_ids.shape
    ends = np.append(np.asarray(dom_offsets[1:], np.int64), num_domains)
    gid = domain_ids.astype(np.int64) + np.asarray(dom_offsets, np.int64)[:, None]
    keep = (domain_ids >= 0) & (gid < ends[:, None])
    gid = gid[keep]
    # a stable sort of level-major, node-ascending ids keeps each domain's
    # nodes ascending
    nodes = np.broadcast_to(np.arange(n, dtype=np.int32), (levels, n))[keep]
    order = np.argsort(gid, kind="stable")
    offsets = np.zeros(num_domains + 1, np.int32)
    np.cumsum(np.bincount(gid, minlength=num_domains), out=offsets[1:])
    return offsets, np.ascontiguousarray(nodes[order])


def _build_placements(
    snapshot: TopologySnapshot,
    order: list[SolverGang],
    pod_offsets: np.ndarray,
    assign: np.ndarray,
    narrowest: np.ndarray,
) -> dict[str, GangPlacement]:
    """Flat C++ `assign` and each gang's narrowest shared level ->
    GangPlacement dict. Scores replicate fit.placement_score_for_nodes.
    A gang is placed iff its first pod is (all-or-nothing per gang)."""
    if (np.diff(pod_offsets) <= 0).any():  # encode invariant: >=1 pod a gang
        raise ValueError("empty gang in native placement build")
    offs = pod_offsets.tolist()
    nodes = assign.astype(np.int64)
    assigned = assign.tolist()
    names = list(map(snapshot.node_names.__getitem__, assigned))
    scale = snapshot.num_levels + 1
    placements: dict[str, GangPlacement] = {}
    for i, level in enumerate(narrowest.tolist()):
        s, e = offs[i], offs[i + 1]
        if assigned[s] < 0:
            continue
        gang = order[i]
        # positional, in field order: keyword arguments double the call's cost
        placements[gang.name] = GangPlacement(
            gang, dict(zip(gang.pod_names, names[s:e])), nodes[s:e],
            (level + 2) / scale)
    return placements


def _offsets(counts) -> np.ndarray:
    """[len + 1] int32 running sum of `counts`, from 0."""
    out = np.zeros(len(counts) + 1, np.int32)
    np.cumsum(counts, dtype=np.int32, out=out[1:])
    return out


def _encode_groups(order: list[SolverGang]):
    """Per-gang group preferred levels + flattened constraint groups
    (members are group indices relative to the gang). Returns
    (group_prefs [sum G_i], cg_offsets [G+1], cg_req [C], cg_pref [C],
    cg_member_offsets [C+1], cg_members [M])."""
    group_prefs = np.concatenate(
        [g.group_preferred_level for g in order]
    ).astype(np.int32) if order else np.zeros(0, np.int32)
    cg_offsets = _offsets([len(g.constraint_groups) for g in order])
    cgs = [cg for g in order for cg in g.constraint_groups]
    members = [m for mem, _req, _pref in cgs for m in mem]
    return (
        np.ascontiguousarray(group_prefs),
        cg_offsets,
        np.asarray([req for _mem, req, _pref in cgs], np.int32),
        np.asarray([pref for _mem, _req, pref in cgs], np.int32),
        _offsets([len(mem) for mem, _req, _pref in cgs]),
        np.asarray(members, np.int32),
    )


def _encode_problem(snapshot: TopologySnapshot, order: list[SolverGang],
                    free: np.ndarray):
    """The argument prefix both C entry points share, from
    (num_nodes, num_res, num_levels) through the constraint groups, plus
    pod_offsets for _build_placements, the float32 C-contiguous array the
    C++ commits into (`free` itself where it is one, else a copy the
    caller copies back) and the arrays the pointers refer to (kept alive
    by the caller)."""
    n, r = snapshot.num_nodes, len(snapshot.resource_names)
    demands = [g.demand for g in order]
    pod_offsets = _offsets(list(map(len, demands)))
    free_c = np.ascontiguousarray(free, np.float32)
    arrays = [
        np.ascontiguousarray(snapshot.capacity, np.float32),
        free_c,
        np.ascontiguousarray(snapshot.schedulable, np.uint8),
        np.ascontiguousarray(snapshot.domain_ids, np.int32),
        pod_offsets,
        np.ascontiguousarray(np.concatenate(demands), np.float32),
        np.fromiter((g.required_level for g in order), np.int32, len(order)),
        np.fromiter((g.preferred_level for g in order), np.int32, len(order)),
        np.ascontiguousarray(np.concatenate([g.group_ids for g in order]), np.int32),
        _offsets([len(g.group_names) for g in order]),
        np.ascontiguousarray(
            np.concatenate([g.group_required_level for g in order]), np.int32),
        *_encode_groups(order),
    ]
    ptrs = [_ptr(a) for a in arrays]
    # capacity, free, schedulable, domain_ids | num_gangs | the gang arrays
    args = [ct.c_int32(n), ct.c_int32(r), ct.c_int32(snapshot.num_levels),
            *ptrs[:4], ct.c_int32(len(order)), *ptrs[4:]]
    return args, pod_offsets, free_c, arrays


_CTYPE = {np.dtype(np.float32): ct.c_float, np.dtype(np.int32): ct.c_int32,
          np.dtype(np.uint8): ct.c_uint8}


def _ptr(a: np.ndarray | None):
    return None if a is None else a.ctypes.data_as(ct.POINTER(_CTYPE[a.dtype]))


def solve_serial_native(
    snapshot: TopologySnapshot,
    gangs: list[SolverGang],
    free: np.ndarray | None = None,
    fairness: dict[str, float] | None = None,
) -> SolveResult:
    """The serial solve in C++: the same result as solver.solve_serial.
    `fairness` ({gang name: tenant DRF weight}) refines the commit order
    within equal priority (gang_sort_key). Raises RuntimeError if the
    library cannot be built or loaded."""
    lib = load_library()
    stamp_fairness(gangs, fairness)
    t0 = time.perf_counter()
    result = SolveResult()
    solvable = []
    for g in gangs:
        if g.unschedulable_reason:
            # pre-declared unschedulable (unresolved required level): hold
            # with the reason, exactly like solve_serial -- the C++ core
            # would otherwise weaken the hard constraint to best-effort
            result.unplaced[g.name] = g.unschedulable_reason
        else:
            solvable.append(g)
    order = sorted(solvable, key=gang_sort_key)
    if free is None:
        free = snapshot.free.copy()
    if not order:
        result.wall_seconds = time.perf_counter() - t0
        return result
    args, pod_offsets, free_c, _keep = _encode_problem(snapshot, order, free)
    masks, mask_idx = _encode_elig(order, snapshot.num_nodes)
    assign = np.empty(int(pod_offsets[-1]), np.int32)
    narrowest = np.empty(len(order), np.int32)
    lib.solve_serial(*args, _ptr(masks), _ptr(mask_idx), _ptr(assign),
                     _ptr(narrowest))
    _commit_back(free, free_c)
    result.placed = _build_placements(
        snapshot, order, pod_offsets, assign, narrowest
    )
    for g in order:
        if g.name not in result.placed:
            # the structured diagnosis of the Python paths, against the
            # residual free matrix the C++ just committed into
            result.unplaced[g.name] = diagnose_unplaced(g, snapshot, free)
    result.wall_seconds = time.perf_counter() - t0
    return result


def _checked_index(dom_index, num_domains: int, num_nodes: int):
    """The (offsets, nodes) CSR as int32 C arrays the C++ walk may index
    without bounds checks; raises ValueError on a malformed one."""
    offsets, nodes = (np.ascontiguousarray(a, np.int32) for a in dom_index)
    if (offsets.shape != (num_domains + 1,) or offsets[0] != 0
            or offsets[-1] != nodes.size or (np.diff(offsets) < 0).any()
            or (nodes.size and (nodes.min() < 0 or nodes.max() >= num_nodes))):
        raise ValueError(
            f"domain->node index does not fit {num_domains} domains over "
            f"{num_nodes} nodes")
    return offsets, nodes


def _commit_back(free: np.ndarray, free_c: np.ndarray) -> None:
    """Where the C++ committed into a copy of `free`, copy it back."""
    if free_c is not free:
        free[...] = free_c


def repair_native(
    snapshot: TopologySnapshot,
    order: list[SolverGang],
    top_val: np.ndarray,
    top_dom: np.ndarray,
    dom_level: np.ndarray,
    dom_offsets: np.ndarray,
    free: np.ndarray,
    *,
    dom_index: tuple[np.ndarray, np.ndarray] | None = None,
    stats: dict | None = None,
) -> tuple[dict[str, GangPlacement], int]:
    """The engine's exact commit phase in C++: each gang (in `order`) tries
    its scored candidates (top_dom/top_val rows, best first; values <=
    -5e8 are invalid), then the full serial scan. Returns (placements,
    fallback count); MUTATES free in place like the Python repair loop.
    `dom_index` is domain_node_index(snapshot.domain_ids, dom_offsets,
    len(dom_level)), built here when not given. `stats`, when given, gets
    "repair_candidates": the candidate domains tried, and
    "repair_net_short": the fallbacks the net turned away because the
    schedulable nodes' free, summed, cannot hold the gang. Raises
    RuntimeError if the library cannot be built or loaded."""
    lib = load_library()
    g = len(order)
    if dom_index is None:
        dom_index = domain_node_index(snapshot.domain_ids, dom_offsets,
                                      len(dom_level))
    dom_index = _checked_index(dom_index, len(dom_level), snapshot.num_nodes)
    args, pod_offsets, free_c, _keep = _encode_problem(snapshot, order, free)
    top_dom_c = np.ascontiguousarray(top_dom[:g], np.int32)
    top_val_c = np.ascontiguousarray(top_val[:g], np.float32)
    dom_level_c = np.ascontiguousarray(dom_level, np.int32)
    masks, mask_idx = _encode_elig(order, snapshot.num_nodes)
    assign = np.empty(int(pod_offsets[-1]), np.int32)
    narrowest = np.empty(g, np.int32)
    fallbacks, candidates, net_short = (ct.c_int32(0) for _ in range(3))
    lib.repair_gangs(
        *args,
        _ptr(top_dom_c), _ptr(top_val_c), ct.c_int32(top_dom_c.shape[1]),
        _ptr(dom_level_c), *map(_ptr, dom_index),
        _ptr(masks), _ptr(mask_idx), _ptr(assign), _ptr(narrowest),
        ct.byref(fallbacks), ct.byref(candidates), ct.byref(net_short),
    )
    _commit_back(free, free_c)
    if stats is not None:
        stats["repair_candidates"] = float(candidates.value)
        stats["repair_net_short"] = float(net_short.value)
    placements = _build_placements(
        snapshot, order, pod_offsets, assign, narrowest
    )
    return placements, int(fallbacks.value)
