"""Wire codec for the placement service: numpy-native, no pickle.

The service boundary (SURVEY §7 step 2: the operator feeds a standalone
placement service) ships dense solver structs, not API objects: demand
matrices and index arrays ride as raw npz arrays (zero-copy-ish,
dtype-checked), names and small structure as a JSON header. Eligibility
masks are deduplicated to unique rows exactly like the native-C++
encoding, so a selector-heavy backlog ships M rows, not P.

The counterpart of grove_tpu/service/codec.py, with one difference: the
topology ships its level domains (each level's domain path per id), so
the server's diagnoses name a domain as a local solve's do
(`t/rack=b0/r0`), where the reference decodes with none and falls back
to `key#id`.
"""

from __future__ import annotations

import io
import json

import numpy as np

from ..solver.problem import SolverGang, dedupe_pod_masks
from ..solver.result import SolveResult, GangPlacement
from ..topology.encoding import TopologySnapshot


#: gRPC message-size bounds shared by server and client — the wire-size
#: contract is single-sourced here next to the codec that produces the
#: payloads it bounds.
GRPC_MESSAGE_OPTIONS = [
    ("grpc.max_receive_message_length", 256 * 1024 * 1024),
    ("grpc.max_send_message_length", 256 * 1024 * 1024),
]


def _pack(header: dict, arrays: dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, __header__=np.frombuffer(
        json.dumps(header).encode(), dtype=np.uint8), **arrays)
    return buf.getvalue()


def _unpack(data: bytes) -> tuple[dict, dict]:
    npz = np.load(io.BytesIO(data), allow_pickle=False)
    header = json.loads(bytes(npz["__header__"]).decode())
    return header, npz


# -- topology ---------------------------------------------------------------

def encode_topology_snapshot(snapshot: TopologySnapshot) -> bytes:
    """The STATIC encoding the server needs to build its engine. Node
    labels/taints stay client-side: eligibility ships as per-gang masks.
    The level domains (names only) ride in the header, so the server's
    diagnoses name domains as the client's own would."""
    return _pack(
        {
            "level_keys": snapshot.level_keys,
            "level_domains": [[list(path) for path in level]
                              for level in snapshot.level_domains],
            "resource_names": snapshot.resource_names,
            "node_names": snapshot.node_names,
        },
        {
            "domain_ids": snapshot.domain_ids,
            "num_domains": snapshot.num_domains,
            "capacity": snapshot.capacity,
            "free": snapshot.free,
            "schedulable": snapshot.schedulable,
        },
    )


def decode_topology_snapshot(data: bytes) -> TopologySnapshot:
    header, npz = _unpack(data)
    return TopologySnapshot(
        level_keys=list(header["level_keys"]),
        level_domains=[[tuple(path) for path in level]
                       for level in header.get("level_domains", [])],
        domain_ids=np.asarray(npz["domain_ids"], np.int32),
        num_domains=np.asarray(npz["num_domains"], np.int32),
        node_names=list(header["node_names"]),
        node_index={n: i for i, n in enumerate(header["node_names"])},
        resource_names=list(header["resource_names"]),
        capacity=np.asarray(npz["capacity"], np.float32),
        free=np.asarray(npz["free"], np.float32),
        schedulable=np.asarray(npz["schedulable"], bool),
    )


# -- solve request ----------------------------------------------------------

def encode_solve_request(
    epoch: str, gangs: list[SolverGang], free: np.ndarray
) -> bytes:
    mask_rows, mask_idx = dedupe_pod_masks(gangs)
    metas = []
    demands, gids, greqs, gprefs = [], [], [], []
    pod_offsets = [0]
    group_offsets = [0]
    for g in gangs:
        metas.append({
            "name": g.name,
            "namespace": g.namespace,
            "pod_names": g.pod_names,
            "group_names": g.group_names,
            "required_level": g.required_level,
            "preferred_level": g.preferred_level,
            "priority": g.priority,
            # tenant DRF weight (tenancy/): a remote solve must
            # keep the client's fairness ordering or multi-tenant
            # contention resolves differently across the service boundary
            "fairness": getattr(g, "fairness", 0.0),
            "constraint_groups": [
                [list(members), req, pref]
                for members, req, pref in g.constraint_groups
            ],
            "unschedulable_reason": g.unschedulable_reason,
            # the structured half of an UnsatDiagnosis hold (json flattens
            # the str subclass to its message): the server re-hydrates so
            # its diagnoses keep the UnresolvedTopologyLevel code instead
            # of degrading to a legacy label across the wire
            "unschedulable_code": getattr(
                getattr(g.unschedulable_reason, "code", None), "value", None
            ),
            "has_elig": g.pod_elig is not None,
        })
        demands.append(g.demand)
        gids.append(g.group_ids)
        greqs.append(g.group_required_level)
        gprefs.append(g.group_preferred_level)
        pod_offsets.append(pod_offsets[-1] + g.num_pods)
        group_offsets.append(group_offsets[-1] + len(g.group_names))
    arrays = {
        "demand": (np.concatenate(demands).astype(np.float32)
                   if demands else np.zeros((0, free.shape[1]), np.float32)),
        "group_ids": (np.concatenate(gids).astype(np.int32)
                      if gids else np.zeros(0, np.int32)),
        "group_req": (np.concatenate(greqs).astype(np.int32)
                      if greqs else np.zeros(0, np.int32)),
        "group_pref": (np.concatenate(gprefs).astype(np.int32)
                       if gprefs else np.zeros(0, np.int32)),
        "pod_offsets": np.asarray(pod_offsets, np.int64),
        "group_offsets": np.asarray(group_offsets, np.int64),
        "mask_idx": np.asarray(mask_idx, np.int32),
        "masks": (np.stack(mask_rows).astype(bool)
                  if mask_rows else np.zeros((0, free.shape[0]), bool)),
        "free": np.asarray(free, np.float32),
    }
    return _pack({"epoch": epoch, "gangs": metas}, arrays)


def decode_solve_request(
    data: bytes,
) -> tuple[str, list[SolverGang], np.ndarray]:
    header, npz = _unpack(data)
    demand = np.asarray(npz["demand"], np.float32)
    group_ids = np.asarray(npz["group_ids"], np.int32)
    group_req = np.asarray(npz["group_req"], np.int32)
    group_pref = np.asarray(npz["group_pref"], np.int32)
    pod_offsets = np.asarray(npz["pod_offsets"], np.int64)
    group_offsets = np.asarray(npz["group_offsets"], np.int64)
    mask_idx = np.asarray(npz["mask_idx"], np.int32)
    masks = np.asarray(npz["masks"], bool)
    mask_cache = [masks[i] for i in range(masks.shape[0])]
    gangs = []
    for i, meta in enumerate(header["gangs"]):
        p0, p1 = int(pod_offsets[i]), int(pod_offsets[i + 1])
        g0, g1 = int(group_offsets[i]), int(group_offsets[i + 1])
        pod_elig = None
        if meta["has_elig"]:
            pod_elig = [
                mask_cache[mi] if mi >= 0 else None
                for mi in mask_idx[p0:p1]
            ]
        gangs.append(SolverGang(
            name=meta["name"],
            namespace=meta["namespace"],
            demand=demand[p0:p1],
            pod_names=list(meta["pod_names"]),
            group_ids=group_ids[p0:p1],
            group_names=list(meta["group_names"]),
            group_required_level=group_req[g0:g1],
            group_preferred_level=group_pref[g0:g1],
            required_level=int(meta["required_level"]),
            preferred_level=int(meta["preferred_level"]),
            priority=float(meta["priority"]),
            # absent on requests from older clients: no tenant ordering
            fairness=float(meta.get("fairness", 0.0)),
            constraint_groups=[
                (list(m), int(r), int(p))
                for m, r, p in meta["constraint_groups"]
            ],
            unschedulable_reason=_decode_hold(meta),
            pod_elig=pod_elig,
        ))
    return header["epoch"], gangs, np.asarray(npz["free"], np.float32)


def _decode_hold(meta: dict):
    """Re-hydrate a gang's unschedulable hold: message + structured code
    when the client shipped one (see encode_solve_request), the plain
    string otherwise (older clients / custom vocabularies)."""
    reason = meta["unschedulable_reason"]
    code = meta.get("unschedulable_code")
    if reason is None or code is None:
        return reason
    from ..observability.explain import UnsatCode, UnsatDiagnosis

    try:
        return UnsatDiagnosis(reason, code=UnsatCode(code))
    except ValueError:  # newer client vocabulary: keep the text
        return reason


# -- solve response ---------------------------------------------------------

def encode_solve_response(result: SolveResult) -> bytes:
    names, scores, assigns = [], [], []
    for name, placement in result.placed.items():
        names.append(name)
        scores.append(placement.placement_score)
        assigns.append(np.asarray(placement.node_indices, np.int64))
    # unplaced messages ship as plain strings (back-compat); the
    # structured halves of an UnsatDiagnosis (reason code + elimination
    # funnel, observability/explain.py) ride in a parallel map so the
    # client re-hydrates full diagnoses — preemption eligibility and
    # explain() must not degrade across the service boundary
    unsat = {
        name: {
            "code": reason.code.value,
            "funnel": reason.funnel,
        }
        for name, reason in result.unplaced.items()
        if getattr(reason, "code", None) is not None
    }
    return _pack(
        {
            "placed": names,
            "scores": scores,
            "unplaced": {k: str(v) for k, v in result.unplaced.items()},
            "unsat": unsat,
            "stats": {k: float(v) for k, v in result.stats.items()},
            "wall_seconds": result.wall_seconds,
            "lens": [len(a) for a in assigns],
        },
        {
            "assign": (np.concatenate(assigns)
                       if assigns else np.zeros(0, np.int64)),
        },
    )


def decode_solve_response(
    data: bytes, gangs_by_name: dict[str, SolverGang],
    node_names: list[str],
) -> SolveResult:
    header, npz = _unpack(data)
    assign = np.asarray(npz["assign"], np.int64)
    result = SolveResult()
    off = 0
    for name, score, length in zip(
        header["placed"], header["scores"], header["lens"]
    ):
        idx = assign[off:off + length]
        off += length
        gang = gangs_by_name[name]
        result.placed[name] = GangPlacement(
            gang=gang,
            pod_to_node={
                gang.pod_names[i]: node_names[idx[i]]
                for i in range(len(idx))
            },
            node_indices=idx,
            placement_score=float(score),
        )
    unsat = header.get("unsat", {})
    for name, message in header["unplaced"].items():
        meta = unsat.get(name)
        if meta is not None:
            from ..observability.explain import UnsatCode, UnsatDiagnosis

            try:
                code = UnsatCode(meta["code"])
            except ValueError:  # newer server vocabulary: keep the text
                result.unplaced[name] = message
                continue
            result.unplaced[name] = UnsatDiagnosis(
                message, code=code, funnel=meta.get("funnel")
            )
        else:
            result.unplaced[name] = message
    result.stats.update(header["stats"])
    result.wall_seconds = float(header["wall_seconds"])
    return result
