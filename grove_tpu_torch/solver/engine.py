"""The placement engine: batched gang x domain scoring on a CUDA device.

The counterpart of grove_tpu/solver/engine.py, trimmed to the flat
single-device fused solve. Where serial.py walks gangs and candidate
domains one at a time with exact checks, this engine evaluates EVERY
(gang, domain) pair at once on the device and only runs exact placement
(fit.py) on each gang's scored candidates:

  1. Host encode (numpy) of the priority-sorted backlog: gang demands,
     pack levels, fairness, and the deduped eligibility signatures.
  2. Device phase (torch): the one-hot membership matrix M (built once
     per engine), the domain aggregates dom_free = M^T free and the
     per-signature fit counts sig_cnt = node_fits M (plain fp32
     products), the value tensor straight from sig_cnt and each gang's
     signature rows (csrc/value_kernel.cu, fp32 or bf16, which takes the
     min over a gang's signatures itself),
     the chunked greedy commit scan with top-k alternates
     (csrc/commit_topk.cu), and the on-device greedy commit
     (csrc/commit_scan.cu).
  3. One packed device-to-host copy.
  4. Exact host repair: commit gangs in the same order against live
     node-level free capacity -- in C++ (native/serial_scorer.cpp) by
     default, or with the fit.py primitives (`native_repair=False`, the
     semantic reference) -- falling back to the full serial scan for any
     gang whose candidates all fail (counted in stats), so
     hard-feasibility semantics stay identical to the serial path.

Knobs keep the JAX package's names (`native_repair`, `pallas_core`,
`device_commit`, `pallas_precision`); see `resolve_kernel_tiers` for what
the kernel knobs mean here.
The device-resident free state, the incremental re-solve, async dispatch
and the hierarchical solve are not part of this engine yet (ROADMAP.md).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..native.serial_native import repair_native
from ..observability.explain import diagnose_unplaced
from ..topology.encoding import TopologySnapshot
from .fit import place_gang_in_domain, placement_score_for_nodes
from .kernel_core import (  # noqa: F401  (tie_jitter: re-exported)
    gather_min,
    kernel_commit_scan,
    kernel_commit_topk,
    kernel_value_sig,
    tie_jitter,
    value_plain,
)
from .problem import SolverGang
from .result import GangPlacement, SolveResult
from .serial import _place_one, gang_sort_key, stamp_fairness

_NEG = -1e9


def _bucket(n: int, minimum: int = 8) -> int:
    """Pad to the next power of two, as the JAX engine does (the padding
    rows change the commit scan's chunking and jitter, so the port keeps
    it to stay bit-equal)."""
    return max(minimum, 1 << max(0, math.ceil(math.log2(max(n, 1)))))


def check_anc_columns(anc_ids: np.ndarray, dom_level: np.ndarray) -> None:
    """Raise ValueError unless column j of the ancestor table holds only
    domains of level j - 1 (column 0 the root), ignoring the padding id
    num_domains. Both commit kernels rely on it: a domain then appears in
    one column only, so committing a chunk column by column keeps each
    domain's adds in row order (the row-major scatter's order), and a
    chain names each domain at most once."""
    num_domains = dom_level.shape[0]
    for j in range(anc_ids.shape[1]):
        ids = anc_ids[:, j]
        ids = ids[ids != num_domains]
        if ids.size and not np.all(dom_level[ids] == j - 1):
            bad = sorted(set(dom_level[ids].tolist()) - {j - 1})
            raise ValueError(
                f"anc_ids column {j} holds domains of levels {bad}, not only "
                f"level {j - 1}: the commit kernels need one level per column"
            )


def check_sig_idx(sig_idx: np.ndarray, num_sigs: int) -> None:
    """Raise ValueError unless every signature index lies in [0, U):
    checked on the host array before upload, since the value kernel reads
    sig_cnt rows by these indices."""
    if sig_idx.size and (sig_idx.min() < 0 or sig_idx.max() >= num_sigs):
        raise ValueError(
            f"sig_idx holds indices in [{sig_idx.min()}, {sig_idx.max()}], "
            f"outside the {num_sigs} signature rows"
        )


def demand_table(total_demand: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The distinct rows of a host [G, R] f32 demand array, by their bits
    (so -0.0 and 0.0 stay apart, and NaN rows merge only where their bits
    agree), and
    each row's index into them: (demand [T, R] f32, demand_idx [G] i32),
    with total_demand == demand[demand_idx] bit for bit."""
    rows = np.ascontiguousarray(total_demand, dtype=np.float32)
    if rows.shape[0] == 0:
        return rows, np.zeros((0,), np.int32)
    bits = rows.view(np.uint32)
    order = np.lexsort(bits.T)                  # equal rows end up adjacent
    sorted_bits = bits[order]
    first = np.ones(len(order), dtype=bool)
    first[1:] = (sorted_bits[1:] != sorted_bits[:-1]).any(axis=1)
    demand_idx = np.empty(len(order), dtype=np.int32)
    demand_idx[order] = np.cumsum(first) - 1
    return rows[order[first]], demand_idx


class DomainSpace:
    """Host-side index of all topology domains across levels, plus the
    virtual cluster root at global index 0 (for unconstrained gangs)."""

    def __init__(self, snapshot: TopologySnapshot):
        self.snapshot = snapshot
        levels = snapshot.num_levels
        offsets = [1]  # root occupies index 0
        for level in range(levels):
            offsets.append(offsets[-1] + snapshot.domains_at(level))
        self.num_domains = offsets[-1]
        self.offsets = offsets
        # gdom[l+1, n] = global domain id of node n at level l; row 0 = root.
        gdom = np.zeros((levels + 1, snapshot.num_nodes), dtype=np.int32)
        dom_level = np.full((self.num_domains,), -1, dtype=np.int32)
        for level in range(levels):
            gdom[level + 1] = snapshot.domain_ids[level] + offsets[level]
            dom_level[offsets[level] : offsets[level + 1]] = level
        self.gdom = gdom
        self.dom_level = dom_level
        # Ancestor table: anc_ids[d] = global ids of d's enclosing domains at
        # every broader level INCLUDING d itself, padded with the dummy index
        # num_domains (an absorbing row in the residual matrix) -- lets the
        # commit scans decrement the whole ancestor chain in one scatter.
        anc_ids = np.full((self.num_domains, levels + 1), self.num_domains,
                          dtype=np.int32)
        anc_ids[0, 0] = 0  # root's only ancestor is itself
        # a member node of each domain gives its full ancestor chain
        member = np.zeros(self.num_domains, dtype=np.int64)
        for l in range(levels + 1):
            member[gdom[l]] = np.arange(snapshot.num_nodes)
        for d in range(1, self.num_domains):
            level = dom_level[d]
            chain = gdom[: level + 2, member[d]]  # root .. own level
            anc_ids[d, : len(chain)] = chain
        check_anc_columns(anc_ids, dom_level)
        self.anc_ids = anc_ids

    def nodes_of(self, global_dom: int, sched_nodes: np.ndarray) -> tuple[np.ndarray, int]:
        """Schedulable node indices of a global domain id + its level."""
        level = int(self.dom_level[global_dom])
        if level < 0:
            return sched_nodes, -1
        local = global_dom - self.offsets[level]
        ids = self.snapshot.domain_ids[level, sched_nodes]
        return sched_nodes[ids == local], level


def membership_matrix(gdom: torch.Tensor, num_domains: int) -> torch.Tensor:
    """One-hot membership [N, D] f32 built by one index_add_ per level (no
    [L, N, D] temporary); each node carries one 1 per level + the root.
    Ids outside [0, num_domains) contribute nothing, as JAX's
    mode="drop" scatter does for padded nodes."""
    nlevels_p1, n = gdom.shape
    m = torch.zeros((n, num_domains), dtype=torch.float32, device=gdom.device)
    flat = m.view(-1)
    row_base = torch.arange(n, dtype=torch.int64, device=gdom.device) * num_domains
    for l in range(nlevels_p1):
        ids = gdom[l].to(torch.int64)
        keep = (ids >= 0) & (ids < num_domains)
        idx = (row_base + ids)[keep]
        flat.index_add_(0, idx, torch.ones(idx.shape, dtype=torch.float32,
                                           device=gdom.device))
    return m


#: the non-kernel tier's value tensor: one arithmetic with the value
#: kernel's plain twin, so the two tiers cannot drift apart
value_from_aggregates = value_plain


def commit_scan(value, dom_free, anc_ids, total_demand, top_k: int,
                chunk: int = 32):
    """Contention pass: virtual commit in priority order (= row order),
    CHUNKED. Gangs are processed `chunk` at a time: every gang in a chunk
    picks its best residually-feasible domain against the same residual
    state, then all chunk choices are committed (demand scattered up the
    ancestor chains) before the next chunk. The deterministic jitter
    spreads exactly-tied gangs across equally-good domains. Within-chunk
    collisions can transiently overcommit a domain; the exact host repair
    resolves them. Returns (top_val [G, K] f32, top_dom [G, K] i32).

    Jitter and scan are `kernel_commit_topk` (csrc/commit_topk.cu on the
    card, `tie_jitter` and the plain loop `commit_topk_plain` on the
    CPU)."""
    g_total = value.shape[0]
    chunk = max(1, min(chunk, g_total))
    while g_total % chunk:
        chunk -= 1  # g_total is a power-of-two bucket; chunk normally stays 32
    return kernel_commit_topk(value, dom_free, anc_ids, total_demand, top_k,
                              chunk)


def resolve_device(device) -> torch.device:
    """None means the card. Asking for CUDA where there is none raises:
    the engine never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: PlacementEngine runs on the card "
            "unless device='cpu' is passed"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def resolve_kernel_tiers(device_type: str, pallas_core, device_commit,
                         pallas_precision: str) -> tuple[bool, bool]:
    """(pallas_core, device_commit) for a device type, from the knobs.

    On CUDA the value tensor always comes from the kernel (None means
    True; False raises, since nothing on the card runs a plain version),
    and the device commit defaults on (False keeps the host candidate
    walk). On the CPU both default off, as in JAX; True selects the
    kernels' plain versions, the counterpart of JAX's interpret mode.
    `pallas_precision` ("fp32" or "bf16") is the value kernel's: it
    applies wherever the kernel tier does (always on CUDA; on the CPU
    only with pallas_core=True) and is ignored otherwise, as in JAX."""
    if pallas_precision not in ("fp32", "bf16"):
        raise ValueError(
            f"pallas_precision must be 'fp32' or 'bf16', got {pallas_precision!r}"
        )
    if device_type == "cuda":
        if pallas_core is False:
            raise ValueError(
                "pallas_core=False is not supported on CUDA: the value "
                "tensor comes from the kernel there"
            )
        return True, True if device_commit is None else bool(device_commit)
    return bool(pallas_core), bool(device_commit)


@dataclass
class EncodedBacklog:
    """Host-encoded device inputs for one sorted backlog: padded gang
    arrays plus the deduped signature tables (u_sig_demand [U, R],
    u_sig_mask [U], elig_masks [M, N], sig_idx [G, S])."""

    total_demand: np.ndarray     # f32 [G, R]
    required_level: np.ndarray   # i32 [G]
    preferred_level: np.ndarray  # i32 [G]
    valid: np.ndarray            # bool [G]
    fairness: np.ndarray         # f32 [G]
    sig: tuple


class PlacementEngine:
    """Batched placement solver bound to one topology snapshot, scoring
    on `device` (None = the CUDA card)."""

    def __init__(
        self,
        snapshot: TopologySnapshot,
        device=None,
        top_k: int = 8,
        commit_chunk: int = 32,
        bucket_min: int = 8,
        pallas_core: bool | None = None,
        device_commit: bool | None = None,
        pallas_precision: str = "fp32",
        native_repair: bool = True,
    ):
        self.device = resolve_device(device)
        self.pallas_core, self.device_commit = resolve_kernel_tiers(
            self.device.type, pallas_core, device_commit, pallas_precision
        )
        self.pallas_precision = pallas_precision
        #: exact repair in C++ (native/serial_scorer.cpp, built with g++ at
        #: the first solve; a failed build raises) or, when False, with
        #: the fit.py primitives
        self.native_repair = native_repair
        if self.device.type == "cuda":
            # dom_free = M^T free and sig_cnt = node_fits M must stay exact
            # integer sums; TF32 would round their operands to 10 mantissa
            # bits. PyTorch's default is off, but the flag is process-wide,
            # so the engine pins it.
            torch.backends.cuda.matmul.allow_tf32 = False
        self.snapshot = snapshot
        self.space = DomainSpace(snapshot)
        self.top_k = top_k
        self.commit_chunk = commit_chunk
        self.bucket_min = bucket_min
        self._sched_nodes = np.flatnonzero(snapshot.schedulable)
        self._cap_scale = np.maximum(
            snapshot.capacity.max(axis=0), 1e-9
        ).astype(np.float32)
        #: (dom_level, anc_ids, cap_scale, membership) on the device,
        #: built at the first solve so constructing an engine never
        #: touches the card
        self._statics = None

    def _masked_free(self, free: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(
            np.where(self.snapshot.schedulable[:, None], free, 0.0),
            dtype=np.float32,
        )

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _ensure_statics(self):
        if self._statics is None:
            gdom = self._to_device(self.space.gdom)
            self._statics = (
                self._to_device(self.space.dom_level),
                self._to_device(self.space.anc_ids),
                self._to_device(self._cap_scale),
                membership_matrix(gdom, self.space.num_domains),
            )
        return self._statics

    def _encode_arrays(self, order: list[SolverGang]) -> EncodedBacklog:
        """Device-phase inputs for an already-sorted backlog."""
        snapshot = self.snapshot
        g_pad = _bucket(len(order), minimum=self.bucket_min)
        r = len(snapshot.resource_names)
        total_demand = np.zeros((g_pad, r), dtype=np.float32)
        required_level = np.full((g_pad,), -1, dtype=np.int32)
        preferred_level = np.full((g_pad,), -1, dtype=np.int32)
        valid = np.zeros((g_pad,), dtype=bool)
        fairness = np.zeros((g_pad,), dtype=np.float32)
        for i, g in enumerate(order):
            total_demand[i] = g.total_demand()
            required_level[i] = g.required_level
            preferred_level[i] = g.preferred_level
            valid[i] = True
            fairness[i] = getattr(g, "fairness", 0.0)
        sig = self._gang_signatures(order, g_pad, snapshot.num_nodes, r)
        return EncodedBacklog(
            total_demand, required_level, preferred_level, valid, fairness,
            sig,
        )

    @staticmethod
    def _gang_signatures(
        order: list[SolverGang], g_pad: int, num_nodes: int, num_res: int
    ):
        """Collapse gangs to their eligibility SIGNATURES for the device fit
        proxy. A signature is a (max-pod demand row, node-eligibility mask)
        pair: pods of one gang are grouped by their eligibility mask
        (pod_elig entries; None = unconstrained), each group contributing
        the elementwise max demand of its pods. Signatures are deduped
        GLOBALLY, in first-seen order (masks keyed by identity), and every
        array is padded to a power-of-two bucket as in the JAX engine: the
        order fixes sig_idx and so cnt_fit.

        Returns (u_sig_demand [U, R], u_sig_mask [U] -> mask row,
        elig_masks [M, N] float32 with row 0 all-ones, sig_idx [G, S] each
        gang's signature rows, padded by repeating its first signature so
        the device-side min over S is unaffected). The JAX engine's
        per-signature content digests feed only its incremental re-solve,
        which this engine does not have yet."""
        mask_rows: list[np.ndarray] = [np.ones(num_nodes, np.float32)]
        mask_row_of: dict[int, int] = {}   # id(shared mask) -> row
        sig_of: dict[tuple, int] = {}      # (demand bytes, mask row) -> sig
        sig_demand: list[np.ndarray] = []
        sig_mask: list[int] = []
        gang_sigs: list[list[int]] = []
        for g in order:
            by_mask: dict[int, np.ndarray] = {}
            if g.pod_elig is None:
                by_mask[0] = g.max_pod_demand()
            else:
                for p in range(g.num_pods):
                    m = g.pod_elig[p]
                    if m is None:
                        row = 0
                    else:
                        row = mask_row_of.get(id(m))
                        if row is None:
                            row = len(mask_rows)
                            mask_row_of[id(m)] = row
                            mask_rows.append(m.astype(np.float32))
                    d = g.demand[p]
                    cur = by_mask.get(row)
                    by_mask[row] = d if cur is None else np.maximum(cur, d)
            sigs = []
            for row, dem in by_mask.items():
                dem = np.ascontiguousarray(dem, dtype=np.float32)
                key = (dem.tobytes(), row)
                sid = sig_of.get(key)
                if sid is None:
                    sid = len(sig_demand)
                    sig_of[key] = sid
                    sig_demand.append(dem)
                    sig_mask.append(row)
                sigs.append(sid)
            gang_sigs.append(sigs)
        s_pad = _bucket(max(len(s) for s in gang_sigs), minimum=1)
        sig_idx = np.zeros((g_pad, s_pad), np.int32)
        for i, sigs in enumerate(gang_sigs):
            sig_idx[i] = sigs + [sigs[0]] * (s_pad - len(sigs))
        u_pad = _bucket(len(sig_demand), minimum=4)
        u_sig_demand = np.zeros((u_pad, num_res), np.float32)
        u_sig_demand[: len(sig_demand)] = np.stack(sig_demand)
        u_sig_mask = np.zeros((u_pad,), np.int32)
        u_sig_mask[: len(sig_mask)] = sig_mask
        m_pad = _bucket(len(mask_rows), minimum=1)
        elig_masks = np.zeros((m_pad, num_nodes), np.float32)
        elig_masks[: len(mask_rows)] = np.stack(mask_rows)
        return u_sig_demand, u_sig_mask, elig_masks, sig_idx

    def _value_args(self, enc: EncodedBacklog, free: np.ndarray):
        """The value kernel's operands on the engine's device, from the
        masked free state: (dom_free [D, R], sig_cnt [U, D], sig_idx
        [G, S], dom_level, demand [T, R], demand_idx [G], required_level,
        preferred_level, valid, cap_scale, fairness), the demand rows
        deduped on the host (`demand_table`)."""
        dom_level, _anc_ids, cap_scale, m = self._ensure_statics()
        u_sig_demand, u_sig_mask, elig_masks, sig_idx = enc.sig
        check_sig_idx(sig_idx, u_sig_demand.shape[0])
        demand, demand_idx = demand_table(enc.total_demand)
        free_d = self._to_device(self._masked_free(free))
        dom_free = m.T @ free_d                                 # [D, R]
        # Node-granularity proxy: per signature (= unique max-pod demand x
        # node-eligibility mask pair), #nodes per domain that fit AND are
        # eligible; a gang's count is the MIN over its signatures, taken
        # by the value kernel (or by gather_min on the non-kernel tier).
        u_dem = self._to_device(u_sig_demand)
        masks = self._to_device(elig_masks)[self._to_device(u_sig_mask)]
        node_fits = (
            (free_d[None, :, :] + 1e-6 >= u_dem[:, None, :]).all(dim=-1)
            .to(torch.float32) * masks
        )                                                       # [U, N]
        return (
            dom_free, node_fits @ m, self._to_device(sig_idx), dom_level,
            self._to_device(demand), self._to_device(demand_idx),
            self._to_device(enc.required_level),
            self._to_device(enc.preferred_level),
            self._to_device(enc.valid), cap_scale,
            self._to_device(enc.fairness),
        )

    def _score_values(self, enc: EncodedBacklog, free: np.ndarray):
        """The value tensor from the masked free state. Returns (value
        [G, D] f32, dom_free [D, R] f32, total_demand [G, R] f32), all on
        the engine's device."""
        args = self._value_args(enc, free)
        total_demand = self._to_device(enc.total_demand)
        if self.pallas_core:
            value = kernel_value_sig(*args, precision=self.pallas_precision)
        else:
            dom_free, sig_cnt, sig_idx, dom_level, _, _, *rest = args
            value = value_from_aggregates(
                dom_free, gather_min(sig_cnt, sig_idx), dom_level,
                total_demand, *rest,
            )
        return value, args[0], total_demand

    def _score_core(self, enc: EncodedBacklog, free: np.ndarray):
        """Device scoring body: value tensor + chunked commit scan. Returns
        (top_val [G, K] f32, top_dom [G, K] i32, dom_free [D, R] f32,
        total_demand [G, R] f32), all on the engine's device."""
        value, dom_free, total_demand = self._score_values(enc, free)
        top_val, top_dom = commit_scan(
            value, dom_free, self._statics[1], total_demand,
            min(self.top_k, self.space.num_domains), self.commit_chunk,
        )
        return top_val, top_dom, dom_free, total_demand

    def _device_phase(self, enc: EncodedBacklog, free: np.ndarray):
        """Score on the device and fetch the result in one packed copy:
        ([G, K] values, [G, K] domains) on the host, K = 1 after the
        device commit."""
        top_val, top_dom, dom_free, total_demand = self._score_core(enc, free)
        if self.device_commit:
            top_val, top_dom = kernel_commit_scan(
                top_val, top_dom, dom_free, self._statics[1], total_demand
            )
        # domain ids < 2^24 are exact in f32
        packed = torch.cat(
            [top_val, top_dom.to(torch.float32)], dim=1
        ).cpu().numpy()
        k = packed.shape[1] // 2
        return packed[:, :k], packed[:, k:].astype(np.int32)

    def _encode_backlog(self, gangs: list[SolverGang]) -> EncodedBacklog:
        order = sorted(
            (g for g in gangs if not g.unschedulable_reason),
            key=gang_sort_key,
        )
        return self._encode_arrays(order)

    def value_inputs(self, gangs: list[SolverGang],
                     free: np.ndarray | None = None):
        """The value kernel's operands for this backlog, on the device:
        the arguments of `kernel_value_sig` (see `_value_args`)."""
        free = self.snapshot.free if free is None else free
        return self._value_args(self._encode_backlog(gangs), free)

    def score_values(self, gangs: list[SolverGang],
                     free: np.ndarray | None = None):
        """The device phase up to the value tensor, left on the device:
        (value, dom_free, anc_ids, total_demand), the inputs of the commit
        scan for this backlog."""
        free = self.snapshot.free if free is None else free
        value, dom_free, total_demand = self._score_values(
            self._encode_backlog(gangs), free
        )
        return value, dom_free, self._statics[1], total_demand

    def score_candidates(self, gangs: list[SolverGang],
                         free: np.ndarray | None = None):
        """The device phase up to the commit scan's packed top-k, left on
        the device: (top_val, top_dom, dom_free, anc_ids, total_demand),
        the inputs of the device commit for this backlog."""
        free = self.snapshot.free if free is None else free
        top_val, top_dom, dom_free, total_demand = self._score_core(
            self._encode_backlog(gangs), free
        )
        return top_val, top_dom, dom_free, self._statics[1], total_demand

    def solve(
        self,
        gangs: list[SolverGang],
        free: np.ndarray | None = None,
        fairness: dict[str, float] | None = None,
    ) -> SolveResult:
        """Place `gangs` against `free` (default: a copy of the snapshot's;
        a passed matrix is mutated in place as gangs commit)."""
        t0 = time.perf_counter()
        stamp_fairness(gangs, fairness)
        snapshot = self.snapshot
        if free is None:
            free = snapshot.free.copy()
        result = SolveResult()
        # Pre-declared unschedulable gangs never enter the solve: a hard
        # constraint that cannot be resolved must hold the gang.
        solvable = []
        for g in gangs:
            if g.unschedulable_reason:
                result.unplaced[g.name] = g.unschedulable_reason
            else:
                solvable.append(g)
        if not solvable:
            result.wall_seconds = time.perf_counter() - t0
            return result
        order = sorted(solvable, key=gang_sort_key)
        enc = self._encode_arrays(order)
        result.stats["encode_seconds"] = time.perf_counter() - t0
        t_dev = time.perf_counter()
        top_val, top_dom = self._device_phase(enc, free)
        result.stats["device_seconds"] = time.perf_counter() - t_dev
        t_rep = time.perf_counter()
        placed_map, fallbacks = self._repair(order, top_val, top_dom, free)
        result.stats["repair_seconds"] = time.perf_counter() - t_rep
        return self._finish_solve(result, order, placed_map, fallbacks, free,
                                  t0)

    def _finish_solve(self, result, order, placed_map, fallbacks, free, t0):
        """Attribute every gang placed or unplaced (with the structured
        diagnosis against the residual free matrix)."""
        for gang in order:
            if gang.name in placed_map:
                result.placed[gang.name] = placed_map[gang.name]
            else:
                result.unplaced[gang.name] = diagnose_unplaced(
                    gang, self.snapshot, free
                )
        result.stats["fallbacks"] = float(fallbacks)
        result.wall_seconds = time.perf_counter() - t0
        return result

    def _repair(self, order, top_val, top_dom, free):
        """Exact commit phase: each gang tries its candidates in order,
        then the serial exactness net. In C++ by default (repair_native,
        which raises if its library cannot be built); with the fit.py
        primitives, the semantic reference, when native_repair is off."""
        if self.native_repair:
            return repair_native(
                self.snapshot, order, top_val, top_dom, self.space.dom_level,
                np.asarray(self.space.offsets[:-1], np.int32), free,
            )
        snapshot = self.snapshot
        placed_map = {}
        fallbacks = 0
        for i, gang in enumerate(order):
            placed = None
            for k in range(top_dom.shape[1]):
                if top_val[i, k] <= _NEG / 2:
                    break
                node_idx, level = self.space.nodes_of(
                    int(top_dom[i, k]), self._sched_nodes
                )
                assign = place_gang_in_domain(gang, snapshot, free, node_idx, level)
                if assign is not None:
                    placed = self._mk_placement(gang, assign)
                    break
            if placed is None:
                # Exactness net: stale scores or all-candidates-conflicted.
                fallbacks += 1
                placed = _place_one(gang, snapshot, free, self._sched_nodes)
            if placed is not None:
                placed_map[gang.name] = placed
        return placed_map, fallbacks

    def _mk_placement(self, gang: SolverGang, assign: np.ndarray) -> GangPlacement:
        return GangPlacement(
            gang=gang,
            pod_to_node={
                gang.pod_names[i]: self.snapshot.node_names[assign[i]]
                for i in range(gang.num_pods)
            },
            node_indices=assign,
            placement_score=placement_score_for_nodes(self.snapshot, assign),
        )
