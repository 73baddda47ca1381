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


def _build_placements(
    snapshot: TopologySnapshot,
    order: list[SolverGang],
    pod_offsets: np.ndarray,
    assign: np.ndarray,
    demand: np.ndarray,
    free: np.ndarray,
) -> dict[str, GangPlacement]:
    """Flat C++ `assign` -> GangPlacement dict, with scores and the free
    update vectorised across all gangs. Scores replicate
    fit.placement_score_for_nodes: per gang, the narrowest level on which
    every pod shares one domain. MUTATES free."""
    node_names = snapshot.node_names
    levels = snapshot.num_levels
    placed_mask = assign >= 0
    starts = pod_offsets[:-1]
    counts = np.diff(pod_offsets)
    if (counts <= 0).any():  # encode invariant: every gang has >=1 pod
        raise ValueError("empty gang in native placement build")
    # a gang is placed iff its first pod is (all-or-nothing per gang)
    gang_placed = placed_mask[starts]
    safe_assign = np.where(placed_mask, assign, 0)
    # narrowest shared level per gang: per level, a reduceat-AND of "same
    # domain as the gang's first pod"; broader levels are checked first so
    # the last hit wins (= narrowest)
    narrowest = np.full(len(order), -1, np.int32)
    for level in range(levels):
        ids = snapshot.domain_ids[level, safe_assign]
        eq = ids == np.repeat(ids[starts], counts)
        all_same = np.bitwise_and.reduceat(eq, starts)
        narrowest[all_same] = level
    scores = (narrowest + 2) / (levels + 1)
    placements: dict[str, GangPlacement] = {}
    for i, gang in enumerate(order):
        if not gang_placed[i]:
            continue
        a = assign[starts[i]: pod_offsets[i + 1]].astype(np.int64)
        placements[gang.name] = GangPlacement(
            gang=gang,
            pod_to_node={gang.pod_names[j]: node_names[a[j]]
                         for j in range(len(a))},
            node_indices=a,
            placement_score=float(scores[i]),
        )
    np.subtract.at(free, assign[placed_mask], demand[placed_mask])
    return placements


def _encode_groups(order: list[SolverGang]):
    """Per-gang group preferred levels + flattened constraint groups
    (members are group indices relative to the gang). Returns
    (group_prefs [sum G_i], cg_offsets [G+1], cg_req [C], cg_pref [C],
    cg_member_offsets [C+1], cg_members [M])."""
    group_prefs = np.concatenate(
        [g.group_preferred_level for g in order]
    ).astype(np.int32) if order else np.zeros(0, np.int32)
    cg_offsets = np.zeros(len(order) + 1, np.int32)
    cg_req, cg_pref, member_counts, members = [], [], [], []
    for i, g in enumerate(order):
        cg_offsets[i + 1] = cg_offsets[i] + len(g.constraint_groups)
        for mem, req, pref in g.constraint_groups:
            cg_req.append(req)
            cg_pref.append(pref)
            member_counts.append(len(mem))
            members.extend(mem)
    cg_member_offsets = np.zeros(len(cg_req) + 1, np.int32)
    if member_counts:
        cg_member_offsets[1:] = np.cumsum(member_counts)
    return (
        np.ascontiguousarray(group_prefs),
        np.ascontiguousarray(cg_offsets),
        np.asarray(cg_req, np.int32),
        np.asarray(cg_pref, np.int32),
        np.ascontiguousarray(cg_member_offsets),
        np.asarray(members, np.int32),
    )


def _encode_problem(snapshot: TopologySnapshot, order: list[SolverGang],
                    free: np.ndarray):
    """The argument prefix both C entry points share, from
    (num_nodes, num_res, num_levels) through the constraint groups, plus
    (pod_offsets, demand) for _build_placements and the arrays the
    pointers refer to (kept alive by the caller)."""
    n, r = snapshot.num_nodes, len(snapshot.resource_names)
    pod_offsets = np.zeros(len(order) + 1, np.int32)
    group_offsets = np.zeros(len(order) + 1, np.int32)
    for i, g in enumerate(order):
        pod_offsets[i + 1] = pod_offsets[i] + g.num_pods
        group_offsets[i + 1] = group_offsets[i] + len(g.group_names)
    arrays = [
        np.ascontiguousarray(snapshot.capacity, np.float32),
        np.ascontiguousarray(free, np.float32),
        np.ascontiguousarray(snapshot.schedulable, np.uint8),
        np.ascontiguousarray(snapshot.domain_ids, np.int32),
        pod_offsets,
        np.ascontiguousarray(np.concatenate([g.demand for g in order]), np.float32),
        np.asarray([g.required_level for g in order], np.int32),
        np.asarray([g.preferred_level for g in order], np.int32),
        np.ascontiguousarray(np.concatenate([g.group_ids for g in order]), np.int32),
        group_offsets,
        np.ascontiguousarray(
            np.concatenate([g.group_required_level for g in order]), np.int32),
        *_encode_groups(order),
    ]
    ptrs = [_ptr(a) for a in arrays]
    # capacity, free, schedulable, domain_ids | num_gangs | the gang arrays
    args = [ct.c_int32(n), ct.c_int32(r), ct.c_int32(snapshot.num_levels),
            *ptrs[:4], ct.c_int32(len(order)), *ptrs[4:]]
    return args, pod_offsets, arrays[5], arrays


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
    args, pod_offsets, demand, _keep = _encode_problem(snapshot, order, free)
    masks, mask_idx = _encode_elig(order, snapshot.num_nodes)
    assign = np.full(int(pod_offsets[-1]), -1, np.int32)
    lib.solve_serial(*args, _ptr(masks), _ptr(mask_idx), _ptr(assign))
    result.placed = _build_placements(
        snapshot, order, pod_offsets, assign, demand, free
    )
    for g in order:
        if g.name not in result.placed:
            # the structured diagnosis of the Python paths, against the
            # residual free matrix _build_placements just committed into
            result.unplaced[g.name] = diagnose_unplaced(g, snapshot, free)
    result.wall_seconds = time.perf_counter() - t0
    return result


def repair_native(
    snapshot: TopologySnapshot,
    order: list[SolverGang],
    top_val: np.ndarray,
    top_dom: np.ndarray,
    dom_level: np.ndarray,
    dom_offsets: np.ndarray,
    free: np.ndarray,
) -> tuple[dict[str, GangPlacement], int]:
    """The engine's exact commit phase in C++: each gang (in `order`) tries
    its scored candidates (top_dom/top_val rows, best first; values <=
    -5e8 are invalid), then the full serial scan. Returns (placements,
    fallback count); MUTATES free in place like the Python repair loop.
    Raises RuntimeError if the library cannot be built or loaded."""
    lib = load_library()
    g = len(order)
    args, pod_offsets, demand, _keep = _encode_problem(snapshot, order, free)
    top_dom_c = np.ascontiguousarray(top_dom[:g], np.int32)
    top_val_c = np.ascontiguousarray(top_val[:g], np.float32)
    dom_level_c = np.ascontiguousarray(dom_level, np.int32)
    dom_offsets_c = np.ascontiguousarray(dom_offsets, np.int32)
    masks, mask_idx = _encode_elig(order, snapshot.num_nodes)
    assign = np.full(int(pod_offsets[-1]), -1, np.int32)
    fallbacks = ct.c_int32(0)
    lib.repair_gangs(
        *args,
        _ptr(top_dom_c), _ptr(top_val_c), ct.c_int32(top_dom_c.shape[1]),
        _ptr(dom_level_c), _ptr(dom_offsets_c),
        _ptr(masks), _ptr(mask_idx), _ptr(assign), ct.byref(fallbacks),
    )
    placements = _build_placements(
        snapshot, order, pod_offsets, assign, demand, free
    )
    return placements, int(fallbacks.value)
