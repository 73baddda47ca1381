"""The placement engine: batched gang x domain scoring on a CUDA device.

The counterpart of grove_tpu/solver/engine.py, trimmed to the flat
single-device solve. Where serial.py walks gangs and candidate domains
one at a time with exact checks, this engine evaluates EVERY (gang,
domain) pair at once on the device and only runs exact placement (fit.py)
on each gang's scored candidates:

  1. Host encode (numpy) of the priority-sorted backlog: gang demands,
     pack levels, fairness, the deduped eligibility signatures, and per
     gang a content fingerprint (what its value row depends on).
  2. Device phase (solver/programs.py): the domain aggregates
     dom_free = M^T free and the per-signature fit counts
     sig_cnt = node_fits M (plain fp32 products against the one-hot
     membership matrix M, built once per engine), the value tensor
     (csrc/value_kernel.cu, fp32 or bf16, the min over a gang's
     signatures inside), the chunked greedy commit scan with top-k
     alternates (csrc/commit_topk.cu), and the on-device greedy commit
     (csrc/commit_scan.cu).
  3. One packed device-to-host copy.
  4. Exact host repair: commit gangs in the same order against live
     node-level free capacity -- in C++ (native/serial_scorer.cpp) by
     default, or with the fit.py primitives (`native_repair=False`, the
     semantic reference) -- falling back to the full serial scan for any
     gang whose candidates all fail (counted in stats), so
     hard-feasibility semantics stay identical to the serial path.

Transport and dispatch discipline, as in the JAX engine. The masked free
matrix is DEVICE-RESIDENT behind an epoch (`DeviceFreeState`): a solve
ships nothing when it is unchanged, stages the changed rows when few
(`_sync_free`), and pays a full upload only at the first solve, on bulk
divergence or after `invalidate_device_state`. On the FUSED path
(`fused=True`, the default) the staged rows and the gang inputs ride ONE
io buffer into one program (`programs.fused_score`), which on the card is
one CUDA graph per bucket shape: one H2D, one graph launch, one D2H into a
pinned buffer that the solve, or a later `solve(dispatch=...)`, waits for
by a CUDA event. The program's value tensor and demand stay resident, so
at an unchanged epoch a re-solve re-scores only the gangs whose
fingerprint changed (`programs.inc_score`, the INCREMENTAL tier), and a
bit-identical backlog reuses the last packed result with no launch at all
(the reuse tier). `fused=False` keeps the SPLIT discipline (a delta
scatter launch, then the score program); `state_cache=False` uploads the
whole matrix every solve and adopts a dispatch by a content compare.
Every path gives placements bit-equal to the full re-encode
(`state_cache=False, fused=False, incremental=False`).

Knobs keep the JAX package's names (`native_repair`, `pallas_core`,
`device_commit`, `pallas_precision`, `state_cache`, `state_verify`,
`fused`, `incremental`); see `resolve_kernel_tiers` for what the kernel
knobs mean here. Not ported: the JAX engine's capability-miss fallback
(`_guard_kernel`; a failed launch, capture or replay raises here, so
`grove_solver_pallas_fallbacks_total` has no counterpart).

Observability, as in the JAX engine: `metrics=` (a MetricsRegistry: the
solve outcome, uploads, bytes moved by payload kind, launches by path,
incremental rows, the hierarchical waves), `tracer=` (spans
engine.fused / engine.encode, engine.device, engine.repair,
engine.delta_apply, engine.whatif, engine.hierarchical, engine.hier_wave
and the engine.fine_solve points) and `decision_log=` (a DecisionLog; a
private one by default, `engine.decisions = None` turns it off). Every
span and counter is recorded on the host, on the calling thread, around
the launches and never inside a CUDA graph capture; sub-engines of the
hierarchical solve have none of the three, and their fine solves are
reported by the parent when it collects them, in domain order.

HIERARCHICAL solve (`hierarchical=True`, solver/hierarchy.py): a coarse
domain-level pass prunes and assigns, and exact solves run only inside
the surviving domains, each through a persistent sub-engine (a
PlacementEngine over the domain's sub-snapshot, on this engine's device,
with its own resident state, incremental tier, CUDA graphs and CUDA
stream). A wave of fine solves dispatches every domain through a thread
pool (`hier_parallel_workers`), then collects in domain order, so its
placements are bit-equal to solving the domains one at a time.
"""

from __future__ import annotations

import hashlib
import math
import os
import time
import weakref
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..native.serial_native import repair_native
from ..observability.causal import next_token
from ..observability.explain import DecisionLog, diagnose_unplaced
from ..observability.tracing import NOOP_TRACER
from ..topology.encoding import TopologySnapshot
from .fit import place_gang_in_domain, placement_score_for_nodes
from . import programs
from .hierarchy import (
    DomainWork,
    HierarchyState,
    coarse_admissible,
    coarse_assign,
)
from .kernel_core import tie_jitter  # noqa: F401  (re-exported)
from .programs import (  # noqa: F401  (re-exported)
    commit_scan,
    value_from_aggregates,
)
from .problem import SolverGang
from .result import GangPlacement, SolveResult
from .serial import _place_one, gang_sort_key, stamp_fairness

#: hierarchical solve: ceiling on the coarse pass's domain count -- the
#: [G, nd] admissibility and assignment matrices must stay small; the
#: prune level walks broader until under it
_MAX_COARSE_DOMAINS = 4096

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


def _weak_method(method):
    """`method` (bound) as a callable that does not keep its object alive:
    an engine and its graph cache then form no reference cycle, so a
    dropped engine's graphs are freed at once, where it is dropped, and
    never by a garbage collection that might run inside a capture."""
    ref = weakref.WeakMethod(method)

    def call(*args):
        bound = ref()
        if bound is not None:
            bound(*args)
    return call


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




class Statics(NamedTuple):
    """The engine's device-resident static topology arrays, uploaded at
    the first solve (constructing an engine never touches the card) and
    never reallocated: the captured graphs point at them."""

    dom_level: torch.Tensor    # i32 [D]
    anc_ids: torch.Tensor      # i32 [D, L+1]
    cap_scale: torch.Tensor    # f32 [R]
    membership: torch.Tensor   # f32 [N, D] one-hot M
    ones: torch.Tensor         # f32 [1, N] the default eligibility table


def record_solve_metrics(metrics, result: SolveResult, backlog: int) -> None:
    """Feed one solve's outcome into the registry: the one place the
    solver's end-to-end metrics are written (backlog size, bind wall,
    placed and unplaced gangs, repair fallbacks, the score distribution),
    as in the JAX engine."""
    m = metrics
    m.gauge("grove_solver_backlog_size",
            "gangs entering the last solve").set(float(backlog))
    m.histogram("grove_solver_backlog_bind_seconds",
                "wall time to bind one full backlog").observe(
        result.wall_seconds)
    m.counter("grove_solver_gangs_placed_total",
              "gangs placed across all solves").inc(result.num_placed)
    m.counter("grove_solver_gangs_unplaced_total",
              "gangs left unplaced across all solves").inc(
        len(result.unplaced))
    m.counter("grove_solver_repair_fallbacks_total",
              "exact-repair serial fallbacks").inc(
        result.stats.get("fallbacks", 0.0))
    score_h = m.histogram("grove_solver_placement_score",
                          "per-gang placement score (0,1]")
    for p in result.placed.values():
        score_h.observe(p.placement_score)


class DeviceFreeState:
    """Device-resident cluster free-capacity state of one engine.

    `mirror` is the host copy of exactly what lives on the device (the
    free matrix masked by the schedulable set); `epoch` increments on
    every content change and never otherwise, so within an engine's
    lifetime equal epochs imply bit-equal device state -- the O(1)
    staleness guard dispatch adoption relies on. `dev` is the engine's
    resident [N + 1, R] tensor while it holds the content, None after an
    invalidate (the storage itself stays with the engine)."""

    __slots__ = ("mirror", "dev", "epoch", "full_uploads", "delta_uploads",
                 "hits")

    def __init__(self):
        self.mirror: np.ndarray | None = None
        self.dev: torch.Tensor | None = None
        self.epoch = 0
        self.full_uploads = 0
        self.delta_uploads = 0
        self.hits = 0


@dataclass
class EncodedBacklog:
    """Host-encoded device inputs for one sorted backlog: the padded gang
    arrays, the deduped signature tables, and per-gang content
    FINGERPRINTS keyed by (namespace, name) -- what the incremental
    re-solve compares to decide which value rows are dirty."""

    total_demand: np.ndarray     # f32 [G, R]
    required_level: np.ndarray   # i32 [G]
    preferred_level: np.ndarray  # i32 [G]
    valid: np.ndarray            # bool [G]
    fairness: np.ndarray         # f32 [G]
    #: (u_sig_demand [U, R], u_sig_mask [U], elig_masks [M, N], sig_idx
    #: [G, S]) -- see _gang_signatures
    sig: tuple
    #: (namespace, name) per real gang, aligned with the sorted order
    keys: list
    #: per-gang content fingerprint bytes, aligned with `keys` (built only
    #: by incremental engines)
    fps: list
    #: per-gang signature-id lists: the incremental path slices its dirty
    #: sub-tables from these
    gang_sigs: list

    @property
    def g_pad(self) -> int:
        return self.total_demand.shape[0]


class IncrementalCache:
    """Device-resident outputs of the last fused/incremental device phase
    plus the host bookkeeping to reuse them: the value matrix and
    per-gang demand stay ON THE DEVICE (never downloaded), `pos`/`fps` map
    gang keys to their cached rows, and `packed_host` (attached when the
    results land on the host) lets a fully-unchanged backlog skip the
    device entirely. Valid only while the free-state epoch matches
    `epoch`. On the card a fused replay's cache points at its graph's
    outputs, which the next replay of that graph overwrites -- and that
    replay replaces the cache."""

    __slots__ = ("epoch", "pos", "fps", "value_dev", "td_dev", "g_pad",
                 "num_real", "packed_host")

    def __init__(self, epoch, pos, fps, value_dev, td_dev, g_pad,
                 num_real):
        self.epoch = epoch
        self.pos = pos          # (ns, name) -> cached row index
        self.fps = fps          # (ns, name) -> fingerprint bytes
        self.value_dev = value_dev
        self.td_dev = td_dev
        self.g_pad = g_pad
        self.num_real = num_real
        self.packed_host = None


class DeviceToken:
    """A begun device phase: its packed result in a host buffer the token
    owns -- pinned, and filled by a non-blocking copy queued right after
    the launch on the card; the result itself on the CPU or on the reuse
    tier -- with the CUDA event recorded after that copy (None where there
    is nothing to wait for), and the IncrementalCache the launch armed."""

    __slots__ = ("host", "event", "cache")

    def __init__(self, host, event=None, cache=None):
        self.host = host
        self.event = event
        self.cache = cache

    def release(self) -> None:
        self.host = None
        self.event = None
        self.cache = None


class SolveDispatch:
    """In-flight device phase begun by PlacementEngine.dispatch().

    Carries what solve() needs to adopt the result without re-encoding:
    the sorted gang order (identity-compared at consume time), the
    device-state epoch the scores were computed against (epoch-compared:
    stale capacity means stale scores), and the device token whose host
    copy is already in flight. `free0` is kept only when the state cache
    is off (content compare) or state_verify is on, MASKED by the
    dispatch-time schedulable set, so a compare stays sound across a
    rebind()."""

    __slots__ = ("engine", "order", "free0", "token", "encode_seconds",
                 "state_epoch", "path", "rows", "level")

    def __init__(self, engine, order, free0, token, encode_seconds,
                 state_epoch=0, path=None, rows=0, level=None):
        self.engine = engine
        self.order = order
        self.free0 = free0
        self.token = token
        self.encode_seconds = encode_seconds
        self.state_epoch = state_epoch
        #: which device path produced the token (fused | split |
        #: incremental | reused | hierarchical) and the dirty rows
        #: re-scored
        self.path = path
        self.rows = rows
        #: hierarchical dispatches only: the coarse pruning level the
        #: precomputed solve partitioned at (None on the flat paths)
        self.level = level

    def cancel(self) -> None:
        """Drop the token's pinned host buffer and event. The device work
        already queued runs to its end (its writes to the resident state
        are content the epoch already counts); a cancelled dispatch is
        never adopted. A hierarchical dispatch's token is its precomputed
        solve, which is simply dropped."""
        if isinstance(self.token, DeviceToken):
            self.token.release()
        self.token = None


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
        state_cache: bool = True,
        state_verify: bool = False,
        fused: bool = True,
        incremental: bool = True,
        hierarchical: bool = False,
        hier_prune_level: int | None = None,
        hier_min_nodes: int = 0,
        hier_parallel_workers: int | None = None,
        metrics=None,
        tracer=None,
        decision_log=None,
    ):
        self.device = resolve_device(device)
        #: observability.MetricsRegistry (None = no metrics)
        self.metrics = metrics
        #: observability.tracing.Tracer; NOOP_TRACER allocates nothing
        self.tracer = NOOP_TRACER if tracer is None else tracer
        #: causal token of the current hierarchical round: the
        #: engine.fine_solve points link it
        self._hier_token = None
        #: placement-decision ring (observability/explain.py): every solve
        #: records its placed decompositions and unplaced diagnoses, on
        #: the host after the repair. None = no recording.
        self.decisions = DecisionLog() if decision_log is None else decision_log
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
        #: Statics on the device, built at the first solve
        self._statics: Statics | None = None
        #: device-resident free state. Off: every solve uploads the whole
        #: masked free matrix and dispatch adoption compares content.
        self.state_cache = state_cache
        #: debug assert: re-run the O(N*R) content compare next to every
        #: epoch decision and raise on disagreement (a broken
        #: note_free_rows contract)
        self.state_verify = state_verify
        self._state = DeviceFreeState()
        #: the resident [N + 1, R] tensor, allocated once (graphs point at
        #: it); row N absorbs a delta block's padding index
        self._free_buf: torch.Tensor | None = None
        #: pending dirty-row declaration (note_free_rows) consumed by the
        #: next sync. False = nothing declared (full diff); None = a caller
        #: declared UNKNOWN changes (sticky until the sync).
        self._hints: set | None | bool = False
        #: more changed rows than this and a delta stops paying: the full
        #: matrix ships instead
        self._delta_rows_max = max(64, snapshot.num_nodes // 8)
        #: per-solve input reuse by content: (host array, device tensor)
        self._io_cache: tuple[np.ndarray, torch.Tensor] | None = None
        self._masks_cache: tuple[np.ndarray, torch.Tensor] | None = None
        #: unsat-diagnosis memo keyed by content fingerprints, cleared on
        #: rebind (schedulable flips); bounded
        self._diag_cache: dict[tuple, object] = {}
        #: single-launch fused path: the staged delta rides the io buffer
        #: into the one program, whose value/demand outputs stay resident
        #: for the incremental re-solve. Off = the split discipline.
        self.fused = fused
        #: incremental dirty-row re-solve: it needs the fused path (the
        #: resident value cache) AND the state cache (the epoch that proves
        #: the free content unchanged), so a partial configuration
        #: degrades to the full fused solve, never to an unsound re-score
        self.incremental = incremental and fused and state_cache
        #: staged delta rows awaiting the next fused launch: {row index ->
        #: new masked row}. Merged across syncs (the latest values win);
        #: superseded by any full upload; consumed by _device_begin.
        self._staged: dict[int, np.ndarray] | None = None
        #: IncrementalCache of the last fused/incremental device phase
        self._inc: IncrementalCache | None = None
        #: the in-flight _device_begin's context: {"path": fused | split |
        #: incremental | reused, "rows": dirty rows re-scored, ...}
        self._last_begin: dict = {}
        #: device program launches by path kind. The tier kinds
        #: ("pallas", "device_commit") appear at their first count: they
        #: attribute a launch already counted under its base kind.
        self._dispatches = {
            "fused": 0, "split": 0, "incremental": 0, "whatif": 0,
        }
        self._inc_rows_total = 0
        self._inc_reuse_hits = 0
        #: the fused and incremental programs' CUDA graphs, one per bucket
        #: key in a bounded LRU (on the card)
        self._graphs = (programs.FusedGraphs(self.device,
                                             _weak_method(self._graph_evicted))
                        if self.device.type == "cuda" else None)
        #: the CUDA stream this engine's device work runs on; None = the
        #: caller's current stream. A hierarchical parent gives each
        #: sub-engine its own, so a wave's domains run side by side.
        self._stream: torch.cuda.Stream | None = None
        #: hierarchical two-level solve (solver/hierarchy.py). Off, or any
        #: forced-flat trigger (an unconfined gang, a cluster below
        #: hier_min_nodes, < 2 coarse domains) = the flat path above.
        self.hierarchical = hierarchical
        self.hier_prune_level = hier_prune_level
        self.hier_min_nodes = hier_min_nodes
        #: wave parallelism of the fine phase: within one attempt wave,
        #: every surviving domain's dispatch half (host encode, staged
        #: delta, device launch on the sub-engine's stream) runs through a
        #: bounded thread pool, and collection commits in domain order, so
        #: placements are bit-equal to the serial path. None = auto
        #: (_auto_hier_workers); 0 = one domain at a time.
        self.hier_parallel_workers = hier_parallel_workers
        self._hier_pool: ThreadPoolExecutor | None = None
        self._hier_pool_size = 0
        #: what sub-engines inherit: the normalized incremental request and
        #: kernel tiers of this engine
        self._hier_incremental = self.incremental
        self._hier_pallas_core = self.pallas_core
        self._hier_device_commit = self.device_commit
        self._hier: HierarchyState | None = None

    # -- device-resident cluster state ---------------------------------------
    def note_free_rows(self, rows) -> None:
        """Declare the node rows that MAY have changed since the last
        device-state sync (superset contract; None = unknown). The sync
        then diffs just those rows instead of the whole matrix.
        Declarations accumulate (set union; None dominates and is sticky)
        until the next sync consumes them. Row VALUES are never trusted:
        the sync re-reads the declared rows from the free matrix."""
        if self._hints is None:
            return  # unknown-scope declaration stands until the next sync
        if rows is None:
            self._hints = None
        elif self._hints is False:
            self._hints = set(rows)
        else:
            self._hints.update(rows)

    def invalidate_device_state(self) -> None:
        """Drop the device-resident free state's content and mirror; the
        next solve pays a full upload (into the same storage, which the
        captured graphs point at). The epoch is NOT reset: it stays
        monotonic, so a dispatch begun before the invalidate can never
        alias the epoch of the re-uploaded state."""
        self._state.mirror = None
        self._state.dev = None
        self._hints = False
        self._staged = None
        self._inc = None
        # the hierarchy's shards (sub-engines, their device state, caches
        # and graphs, the domain-reuse memos) are rebuilt lazily: an
        # invalidate means "trust nothing resident"
        self._hier = None

    def release(self) -> None:
        """Free what the engine holds on the card now, not when the
        garbage collector gets to it: its CUDA graphs with their private
        pool, the resident free tensor, the device statics, the input
        caches, the hierarchy's sub-engines (each released) and the wave's
        thread pool. The scheduler calls it on the engine it replaces when
        a snapshot's static encoding changes. A later solve on a released
        engine uploads and captures anew, as a new engine would."""
        if self._hier is not None:
            for shard in self._hier.shards.values():
                if shard.engine is not None:
                    shard.engine.release()
                    shard.engine = None
        self.invalidate_device_state()
        self._statics = None
        self._free_buf = None
        self._io_cache = None
        self._masks_cache = None
        if self._hier_pool is not None:
            self._hier_pool.shutdown(wait=False)
            self._hier_pool = None
            self._hier_pool_size = 0
        if self._graphs is not None:
            self._graphs = type(self._graphs)(
                self.device, _weak_method(self._graph_evicted))
            # a dropped graph's private pool goes back to the driver only
            # when the allocator releases its cached blocks
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def _graph_evicted(self, _key, entry) -> None:
        """A captured graph is being dropped from the LRU: an incremental
        cache that points into its outputs must not outlive it, so drop
        that cache (the next solve runs full). The cache object is shared
        with the dispatch token that armed it, so a pending token sees the
        drop too."""
        inc = self._inc
        if inc is None or inc.value_dev is None:
            return
        outs = {t.untyped_storage().data_ptr() for t in entry.outs[1:]}
        if ({inc.value_dev.untyped_storage().data_ptr(),
             inc.td_dev.untyped_storage().data_ptr()} & outs):
            inc.value_dev = inc.td_dev = None
            self._inc = None

    def rebind(self, snapshot: TopologySnapshot) -> bool:
        """Adopt a freshly-encoded snapshot WITHOUT rebuilding the engine
        when the static encoding is unchanged (same nodes, domain tree and
        capacity): a cordon or Ready flip only moves `schedulable` bits,
        and the flipped rows ride the delta path. Returns False when the
        encodings differ: the caller builds a new engine (and with it new
        device statics and graphs)."""
        old = self.snapshot
        if snapshot is old:
            return True
        if (
            snapshot.resource_names != old.resource_names
            or snapshot.node_names != old.node_names
            or not np.array_equal(snapshot.domain_ids, old.domain_ids)
            or not np.array_equal(snapshot.capacity, old.capacity)
        ):
            return False
        changed = np.flatnonzero(snapshot.schedulable != old.schedulable)
        self.snapshot = snapshot
        self.space.snapshot = snapshot
        self._sched_nodes = np.flatnonzero(snapshot.schedulable)
        # the funnel memo keys on the outgoing snapshot's masks and
        # schedulable set; the cached value rows embed its mask: a rebind
        # always forces the next solve down the FULL path
        self._diag_cache.clear()
        self._inc = None
        if changed.size:
            self.note_free_rows(changed.tolist())
        if self._hier is not None:
            # shards re-slice their schedulable bits and rebind their
            # sub-engines (the flips ride each shard's delta path); the
            # domain-reuse memos drop: the usable node set moved
            self._hier.rebind(snapshot)
        return True

    def _masked_free(self, free: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(
            np.where(self.snapshot.schedulable[:, None], free, 0.0),
            dtype=np.float32,
        )

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _h2d(self, arr: np.ndarray) -> torch.Tensor:
        """One f32 host array on the device: on the card through a pinned
        buffer and one non-blocking copy (the caching host allocator keeps
        the pinned block until the copy has run)."""
        if self.device.type == "cpu":
            return torch.from_numpy(np.ascontiguousarray(arr))
        pinned = torch.empty(arr.shape, dtype=torch.float32, pin_memory=True)
        pinned.numpy()[...] = arr
        return pinned.to(self.device, non_blocking=True)

    def _ensure_statics(self) -> Statics:
        if self._statics is None:
            gdom = self._to_device(self.space.gdom)
            self._statics = Statics(
                self._to_device(self.space.dom_level),
                self._to_device(self.space.anc_ids),
                self._to_device(self._cap_scale),
                membership_matrix(gdom, self.space.num_domains),
                torch.ones((1, self.snapshot.num_nodes), dtype=torch.float32,
                           device=self.device),
            )
        return self._statics

    def _state_put(self, masked: np.ndarray) -> torch.Tensor:
        """Copy the masked free matrix [N, R] into the resident tensor
        [N + 1, R] and return it (override point: the mesh engine keeps
        its node block only)."""
        n, r = masked.shape
        if self._free_buf is None:
            self._free_buf = torch.zeros((n + 1, r), dtype=torch.float32,
                                         device=self.device)
        # into the one resident tensor, never a new one: graphs point at it
        self._free_buf[:n].copy_(torch.from_numpy(masked))
        return self._free_buf

    def _state_delta(self, upd: np.ndarray) -> None:
        """Scatter a delta block [K, 1+R] into the resident tensor in
        place, as its own launch (override point: the mesh engine routes
        each row to the shard that owns it)."""
        programs.scatter_rows(self._state.dev, self._h2d(upd))

    def _state_rows(self) -> tuple[int, int]:
        """The node rows [lo, hi) the resident tensor holds: all of them
        here; the mesh engine's node block there."""
        return 0, self.snapshot.num_nodes

    def _upload_full(self, free: np.ndarray, masked: np.ndarray | None) -> int:
        st = self._state
        if masked is None:
            masked = self._masked_free(free)
        with self.tracer.span("engine.delta_apply", kind="full",
                              rows=masked.shape[0], epoch=st.epoch + 1):
            st.dev = self._state_put(masked)
        st.mirror = masked if self.state_cache else None
        st.epoch += 1
        st.full_uploads += 1
        # staged rows are content the full matrix already carries
        self._staged = None
        self._count_upload("full", masked.nbytes)
        return st.epoch

    def _sync_free(self, free: np.ndarray, defer: bool = False) -> int:
        """Make the device-resident free state match `free` (masked by the
        schedulable set) and return the state epoch: nothing when the
        content is unchanged (hit), the changed rows when few (delta), a
        full upload otherwise or when nothing is resident. The epoch moves
        on every content change and never otherwise.

        `defer` (fused engines): a small delta is STAGED instead of
        launched; it rides the next fused launch's io buffer. The mirror
        and epoch commit now (they track content), the device tensor
        catches up at that launch (_verify_state accounts for it)."""
        st = self._state
        hints, self._hints = self._hints, False
        if not self.state_cache:
            return self._upload_full(free, None)
        n = self.snapshot.num_nodes
        if st.mirror is None or st.mirror.shape != free.shape:
            self._fan_out(None)
            epoch = self._upload_full(free, None)
            if self.state_verify:
                self._verify_state(free)
            return epoch
        if isinstance(hints, set):
            rows = np.asarray(
                sorted(i for i in hints if 0 <= i < n), dtype=np.int64
            )
            masked_rows = np.where(
                self.snapshot.schedulable[rows, None], free[rows], 0.0
            ).astype(np.float32)
            diff = (st.mirror[rows] != masked_rows).any(axis=1)
            changed, new_rows = rows[diff], masked_rows[diff]
            masked = None
        else:
            masked = self._masked_free(free)
            changed = np.flatnonzero((st.mirror != masked).any(axis=1))
            new_rows = masked[changed]
        # the shards get what this sync consumed, not what it found
        # changed: the parent's mirror holds the content of its last sync,
        # while a sub-engine may have read a domain's rows mid-solve
        # (after its own commits) and consumed its own declaration of
        # them. The declared set covers those rows (the solve declares
        # every row it placed into); a full diff follows no declaration,
        # so nothing was committed since and its changed rows suffice.
        self._fan_out(None if hints is None
                      else rows if isinstance(hints, set) else changed)
        if changed.size == 0:
            st.hits += 1
        elif changed.size > self._delta_rows_max:
            self._upload_full(free, masked)
        elif defer and self.fused:
            with self.tracer.span("engine.delta_apply", kind="delta",
                                  staged=True, rows=int(changed.size),
                                  epoch=st.epoch + 1):
                staged = self._staged
                if staged is None:
                    staged = self._staged = {}
                for i, row in zip(changed.tolist(), new_rows):
                    staged[i] = row
            st.mirror[changed] = new_rows
            st.epoch += 1
            st.delta_uploads += 1
            # the upload counted now; its bytes when the next fused launch
            # ships the staged block (a full upload may supersede it)
            self._count_upload("delta", 0)
        else:
            upd = self._update_block(dict(zip(changed.tolist(), new_rows)))
            with self.tracer.span("engine.delta_apply", kind="delta",
                                  rows=int(changed.size), epoch=st.epoch + 1):
                self._state_delta(upd)
            st.mirror[changed] = new_rows
            st.epoch += 1
            st.delta_uploads += 1
            # the standalone scatter is its own launch: one of the two the
            # fused path collapses into one
            self._count_dispatch_kind("split")
            self._count_upload("delta", upd.nbytes)
        if self.state_verify:
            self._verify_state(free)
        return st.epoch

    def _fan_out(self, rows) -> None:
        """Hand the rows a sync consumed (None = unknown scope) to the
        hierarchy's domain shards, whichever path the sync served (flat,
        hierarchical, what-if): each shard's sub-engine re-reads them at
        its next fine solve, so unchanged domains stay O(declared rows)."""
        if self._hier is not None:
            self._hier.push_rows(rows)

    def _take_staged(self) -> np.ndarray | None:
        """Consume the staged delta rows as a padded [K, 1+R] block for the
        fused program (None when nothing is staged), rows sorted; padding
        rows name the absorbing row N."""
        staged, self._staged = self._staged, None
        if not staged:
            return None
        return self._update_block(staged)

    def _update_block(self, rows: dict) -> np.ndarray:
        """{node row -> new masked row} as a [K, 1+R] delta block, rows
        sorted, K a power of two >= 16; padding rows name row N."""
        n = self.snapshot.num_nodes
        r = len(self.snapshot.resource_names)
        upd = np.zeros((_bucket(len(rows), minimum=16), 1 + r), np.float32)
        upd[:, 0] = float(n)
        for j, (i, row) in enumerate(sorted(rows.items())):
            upd[j, 0] = i
            upd[j, 1:] = row
        return upd

    def _verify_state(self, free: np.ndarray) -> None:
        """Debug assert behind state_verify: the O(N*R) content compare the
        epoch guard replaced, against the host mirror and the device
        tensor read back (with the staged rows laid over it). A divergence
        means a mutation bypassed note_free_rows' superset contract, or
        the scatter broke: fail loudly, never adopt silently."""
        st = self._state
        if st.mirror is None:
            return
        masked = self._masked_free(free)
        if not np.array_equal(st.mirror, masked):
            bad = np.flatnonzero((st.mirror != masked).any(axis=1))
            raise RuntimeError(
                f"device free-state mirror diverged on rows "
                f"{bad[:8].tolist()} ({bad.size} rows in all) at epoch "
                f"{st.epoch}: a free-matrix mutation was not declared to "
                "note_free_rows"
            )
        lo, hi = self._state_rows()
        dev_host = st.dev[: hi - lo].cpu().numpy()
        if self._staged:
            dev_host = dev_host.copy()
            for i, row in self._staged.items():
                if lo <= i < hi:
                    dev_host[i - lo] = row
        if not np.array_equal(dev_host, masked[lo:hi]):
            bad = lo + np.flatnonzero((dev_host != masked[lo:hi]).any(axis=1))
            raise RuntimeError(
                f"device free-state buffer diverged from host on rows "
                f"{bad[:8].tolist()} ({bad.size} rows in all) at epoch "
                f"{st.epoch}"
            )

    def _count_upload(self, kind: str, nbytes: int) -> None:
        if self.metrics is None:
            return
        self.metrics.counter(
            "grove_solver_state_uploads_total",
            "device free-state uploads by kind (full re-encode vs "
            "delta scatter)",
        ).inc(kind=kind)
        self._count_bytes("state_" + kind, nbytes)

    def _count_bytes(self, kind: str, nbytes: int) -> None:
        """Count host<->device bytes the engine really moved, by payload
        kind: state_full (the masked [N, R] rows copied into the resident
        tensor), state_delta (a delta block, staged or scattered), inputs
        (an io buffer, less a staged block counted as state_delta), masks
        (an eligibility table), whatif (a what-if's io buffer) and results
        (the packed top-k copied back)."""
        if self.metrics is None or not nbytes:
            return
        self.metrics.counter(
            "grove_solver_transport_bytes_total",
            "host<->device bytes moved by the engine, by payload kind",
        ).inc(float(nbytes), kind=kind)

    def _count_dispatch_kind(self, kind: str, n: int = 1) -> None:
        """Count `n` device program launches by path kind: `split` counts
        the score program and the standalone delta scatter, `fused` and
        `incremental` one launch a solve (on the card, one graph replay or
        one eager program)."""
        if n <= 0:
            return
        self._dispatches[kind] = self._dispatches.get(kind, 0) + n
        if self.metrics is not None:
            self.metrics.counter(
                "grove_solver_dispatches_total",
                "device program launches by solve path kind",
            ).inc(float(n), kind=kind)

    def _kernel_tier(self) -> str:
        """The scoring core's tier in the JAX engine's vocabulary: "xla"
        (the plain arithmetic, CPU only) or "pallas-<precision>" (the
        value kernel, or its twin on the CPU)."""
        if self.pallas_core:
            return "pallas-" + self.pallas_precision
        return "xla"

    def _count_kernel_tiers(self) -> None:
        """Attribute the launch just counted to its kernel tiers."""
        if self.pallas_core:
            self._count_dispatch_kind("pallas")
        if self.device_commit:
            self._count_dispatch_kind("device_commit")

    def _count_inc_rows(self, rows: int) -> None:
        self._inc_rows_total += rows
        if self.metrics is not None and rows:
            self.metrics.counter(
                "grove_solver_incremental_rows_total",
                "dirty cost-tensor rows re-scored by the incremental "
                "re-solve (clean rows ride the device-resident cache)",
            ).inc(float(rows))

    def _score_kw(self, device_commit: bool | None = None) -> dict:
        """The scoring programs' static arguments."""
        return {
            "top_k": min(self.top_k, self.space.num_domains),
            "chunk": self.commit_chunk,
            "tier": self.pallas_precision if self.pallas_core else None,
            "device_commit": (self.device_commit if device_commit is None
                              else device_commit),
        }

    def _encode_arrays(self, order: list[SolverGang]) -> EncodedBacklog:
        """Device-phase inputs for an already-sorted backlog (the free
        matrix is not encoded here: it lives on the device behind
        _sync_free), plus, on incremental engines, per-gang content
        fingerprints of exactly what the gang's value row depends on:
        total demand, pack levels, fairness and the signature contents.
        Anything else (priority, constraint groups, pod names) only
        reorders rows, which the incremental permutation handles, or only
        affects the exact host repair, which always runs fresh."""
        snapshot = self.snapshot
        g_pad = _bucket(len(order), minimum=self.bucket_min)
        r = len(snapshot.resource_names)
        total_demand = np.zeros((g_pad, r), dtype=np.float32)
        required_level = np.full((g_pad,), -1, dtype=np.int32)
        preferred_level = np.full((g_pad,), -1, dtype=np.int32)
        valid = np.zeros((g_pad,), dtype=bool)
        fairness = np.zeros((g_pad,), dtype=np.float32)
        keys: list[tuple[str, str]] = []
        for i, g in enumerate(order):
            total_demand[i] = g.total_demand()
            required_level[i] = g.required_level
            preferred_level[i] = g.preferred_level
            valid[i] = True
            fairness[i] = getattr(g, "fairness", 0.0)
            keys.append((g.namespace, g.name))
        sig, gang_sigs, sig_fps = self._gang_signatures(
            order, g_pad, snapshot.num_nodes, r
        )
        fps: list[bytes] = []
        if self.incremental:
            for i in range(len(order)):
                head = np.asarray(
                    [required_level[i], preferred_level[i], fairness[i]],
                    dtype=np.float32,
                )
                fps.append(
                    total_demand[i].tobytes() + head.tobytes()
                    + b"".join(sig_fps[s] for s in gang_sigs[i])
                )
        return EncodedBacklog(
            total_demand, required_level, preferred_level, valid, fairness,
            sig, keys, fps, gang_sigs,
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
        order fixes sig_idx and so the fit counts.

        Returns (sig, gang_sigs, sig_fps): sig = (u_sig_demand [U, R],
        u_sig_mask [U] -> mask row, elig_masks [M, N] float32 with row 0
        all-ones, sig_idx [G, S] each gang's signature rows, padded by
        repeating its first signature so the min over S is unaffected);
        gang_sigs each gang's unpadded signature ids; sig_fps each
        signature's CONTENT fingerprint (its demand bytes and an 8-byte
        blake2b digest of its mask row, 8 zero bytes for row 0), byte for
        byte the JAX engine's."""
        mask_rows: list[np.ndarray] = [np.ones(num_nodes, np.float32)]
        mask_fps: list[bytes] = [b"\x00" * 8]  # row 0: the all-ones mask
        mask_row_of: dict[int, int] = {}   # id(shared mask) -> row
        sig_of: dict[tuple, int] = {}      # (demand bytes, mask row) -> sig
        sig_demand: list[np.ndarray] = []
        sig_mask: list[int] = []
        sig_fps: list[bytes] = []
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
                            fm = m.astype(np.float32)
                            mask_rows.append(fm)
                            # a CONTENT digest, not id(): it must mean the
                            # same across re-encodes of one backlog and
                            # never alias a recycled object address
                            mask_fps.append(hashlib.blake2b(
                                fm.tobytes(), digest_size=8).digest())
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
                    sig_fps.append(dem.tobytes() + mask_fps[row])
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
        return (
            (u_sig_demand, u_sig_mask, elig_masks, sig_idx),
            gang_sigs,
            sig_fps,
        )

    # -- asynchronous dispatch -----------------------------------------------
    def dispatch(
        self, gangs: list[SolverGang], free: np.ndarray | None = None,
        fairness: dict[str, float] | None = None,
    ) -> SolveDispatch | None:
        """Begin the device phase asynchronously and return a handle that a
        later solve(..., dispatch=handle) can adopt, overlapping the device
        work and the result's copy with host work in between. Returns None
        when there is nothing to score.

        Contract: `gangs` must not be mutated between dispatch and the
        consuming solve -- solve() checks the gang list by identity and
        the free matrix by the device-state epoch (by content when the
        state cache is off), and solves afresh when either changed.
        `fairness` must be the vector the consuming solve passes. A handle
        that will not be consumed should be cancel()ed."""
        t0 = time.perf_counter()
        stamp_fairness(gangs, fairness)
        if free is None:
            free = self.snapshot.free.copy()
        solvable = [g for g in gangs if not g.unschedulable_reason]
        if not solvable:
            return None
        order = sorted(solvable, key=gang_sort_key)
        hier_level = self._hier_plan(order)
        if hier_level is not None:
            return self._hier_dispatch(order, free, hier_level, t0)
        # the encode of an overlapped solve happens here; the consuming
        # solve emits only the device and repair side
        with torch.cuda.stream(self._stream), self.tracer.span(
            "engine.fused" if self.fused else "engine.encode",
            gangs=len(order), dispatch=True,
        ) as dsp:
            epoch = self._sync_free(free, defer=self.fused)
            enc = self._encode_arrays(order)
            token = self._device_begin(enc)
            if self.fused:
                lb = self._last_begin
                dsp.set(
                    path=lb.get("path"), rows=lb.get("rows"),
                    kernel=lb.get("kernel", "xla"),
                    device_commit=bool(lb.get("commit")),
                    encode_seconds=round(time.perf_counter() - t0, 6),
                )
        keep_free = not self.state_cache or self.state_verify
        return SolveDispatch(
            engine=self,
            order=order,
            free0=self._masked_free(free) if keep_free else None,
            token=token,
            encode_seconds=time.perf_counter() - t0,
            state_epoch=epoch,
            path=self._last_begin.get("path"),
            rows=self._last_begin.get("rows", 0),
        )

    def _dispatch_current(self, dispatch, free, epoch: int) -> bool:
        """O(1) staleness guard for adoption: with the state cache on, an
        equal epoch proves the dispatched scores were computed against
        this exact content (under state_verify the O(N*R) compare runs
        beside it and raises if it adopted changed content); with the
        cache off, a compare of the MASKED matrices decides."""
        if not self.state_cache:
            return dispatch.free0 is not None and np.array_equal(
                dispatch.free0, self._masked_free(free)
            )
        fresh = dispatch.state_epoch == epoch
        if (
            self.state_verify
            and fresh
            and dispatch.free0 is not None
            and not np.array_equal(dispatch.free0, self._masked_free(free))
        ):
            # one-directional: adopting changed content is the unsafe way;
            # an epoch that moved over equal content is a conservative
            # rejection, not a breach
            raise RuntimeError(
                f"dispatch epoch guard adopted epoch {epoch} but the "
                "masked free content changed since dispatch: a free "
                "mutation slipped past note_free_rows"
            )
        return fresh

    def dispatch_counts(self) -> dict:
        """Cumulative device-launch counts by path kind plus the
        state-upload split."""
        st = self._state
        out = dict(self._dispatches)
        out["state_full_uploads"] = st.full_uploads
        out["state_delta_uploads"] = st.delta_uploads
        return out

    # -- defragmentation what-if ----------------------------------------------
    def whatif_scores(self, gangs: list[SolverGang],
                      free: np.ndarray | None = None,
                      free_rows: dict | None = None):
        """Rank candidate domains for `gangs` against the DEVICE-RESIDENT
        free state, the defragmenter's what-if: the value kernel and the
        commit top-k (never the device commit: the caller reads the whole
        top-k) on a copy of the resident state with the staged rows and the
        caller's hypothetical rows laid over it (`programs.fused_score` on
        the copy; on the card one CUDA graph per bucket key, in the cache
        that holds K5 and K6). The resident tensor, the mirror, the epoch,
        the staged rows and the incremental cache stay as they are, and
        the launch counts as "whatif".

        `free` (the current free matrix) is synced first through the
        staged delta path; `free_rows` ({node row -> hypothetical row
        values}) overlays a hypothetical delta. Returns (top_val [G, K],
        top_dom [G, K], order) with `order` the gangs in solve order, or
        None when the engine cannot serve a resident what-if (fused or
        state cache off, nothing synced yet)."""
        if not (self.fused and self.state_cache):
            return None
        if free is not None:
            self._sync_free(free, defer=True)
        st = self._state
        if st.dev is None or st.mirror is None:
            return None
        solvable = [g for g in gangs if not g.unschedulable_reason]
        if not solvable:
            return None
        order = sorted(solvable, key=gang_sort_key)
        with self.tracer.span("engine.whatif", gangs=len(order)) as sp:
            enc = self._encode_arrays(order)
            # the staged rows not shipped yet (peeked, not consumed) and
            # the caller's hypothetical rows
            overlay: dict[int, np.ndarray] = dict(self._staged or {})
            if free_rows:
                sched = self.snapshot.schedulable
                for i, row in free_rows.items():
                    i = int(i)
                    masked = np.asarray(row, np.float32)
                    if not sched[i]:
                        masked = np.zeros_like(masked)
                    overlay[i] = masked
            upd = self._update_block(overlay) if overlay else None
            io, lay = self._build_io(enc, upd)
            elig_masks = enc.sig[2]
            statics = self._ensure_statics()
            kw = self._score_kw(device_commit=False)
            if self._graphs is not None:
                masks_np = None if elig_masks.shape[0] == 1 else elig_masks
                key = ("whatif", lay, elig_masks.shape[0], kw["tier"], False)
                packed = self._graphs.run(key, st.dev, statics, io, masks_np,
                                          lay, whatif=True, **kw)[0]
            else:
                packed = programs.fused_score(
                    st.dev.clone(), statics,
                    self._masks_to_device(elig_masks), self._h2d(io), lay,
                    **kw)[0]
            self._count_dispatch_kind("whatif")
            if self.pallas_core:
                self._count_dispatch_kind("pallas")
            self._count_bytes("whatif", io.nbytes)
            packed = packed.cpu().numpy()
            self._count_bytes("results", packed.nbytes)
            k = packed.shape[1] // 2
            sp.set(overlay_rows=len(overlay))
            return packed[:, :k], packed[:, k:].astype(np.int32), order

    # -- hierarchical two-level solve (solver/hierarchy.py) ------------------
    def _hier_plan(self, order: list[SolverGang]) -> int | None:
        """The prune level this backlog solves hierarchically at, or None
        for the flat path. Forced-flat triggers: the knob is off; the
        cluster is below hier_min_nodes (the flat tensor is cheap there);
        the topology has no levels; any gang is UNCONFINED (required pack
        level broader than every prunable level: it may legally span
        coarse domains, which a partitioned solve could not contend); or
        the chosen level has fewer than two domains. A pure function of
        (order, knobs, static snapshot), so a dispatch and its consuming
        solve always agree."""
        if not self.hierarchical or not order:
            return None
        snap = self.snapshot
        if snap.num_nodes < self.hier_min_nodes or snap.num_levels == 0:
            return None
        req_min = min(g.required_level for g in order)
        if req_min < 0:
            return None
        level = req_min
        if self.hier_prune_level is not None:
            level = min(self.hier_prune_level, req_min)
        # the coarse pass materializes [G, nd]: walk broader while the
        # level is too fine-grained for that to stay small
        while level > 0 and int(snap.num_domains[level]) > _MAX_COARSE_DOMAINS:
            level -= 1
        if int(snap.num_domains[level]) < 2:
            return None
        return level

    def _sub_device(self, dom: int) -> torch.device:
        """The device a domain shard's sub-engine runs on: this engine's
        (parallel/sharded.py's mesh engine: its rank's device)."""
        return self.device

    def _make_sub_engine(self, shard) -> "PlacementEngine":
        eng = PlacementEngine(
            shard.snapshot,
            device=self._sub_device(shard.dom),
            top_k=self.top_k,
            commit_chunk=self.commit_chunk,
            bucket_min=self.bucket_min,
            pallas_core=self._hier_pallas_core,
            device_commit=self._hier_device_commit,
            pallas_precision=self.pallas_precision,
            native_repair=self.native_repair,
            state_cache=self.state_cache,
            state_verify=self.state_verify,
            fused=self.fused,
            incremental=self._hier_incremental,
        )
        if eng.device.type == "cuda":
            # its own stream: a wave's dispatches run side by side, and its
            # graphs replay one after another on it (their shared pool
            # relies on that). Past 32 sub-engines PyTorch's pool hands
            # the same stream to several, which only serializes their
            # work. Everything the sub-engine allocates on the card is
            # allocated on this stream, also when the main thread runs its
            # collect half (solve() runs under it), so no tensor is used
            # on one stream and freed on another: none needs record_stream.
            eng._stream = torch.cuda.Stream(eng.device)
        # the parent records placements and diagnoses at its level; a
        # sub-engine's ring would count each gang twice. Sub-engines have
        # no tracer and no metrics either: they run on the wave's threads.
        eng.decisions = None
        return eng

    def _domain_prepare(self, hs, dom: int, members,
                        free: np.ndarray) -> DomainWork:
        """Main-thread half of one domain's fine solve: shard resolution,
        the free-row slice, the domain-reuse memo probe (an identical gang
        set -- by object identity and fairness stamp -- against
        bit-identical free rows replays the previous placements), and the
        pending-row custody handoff. Runs serially in domain order, so
        shard construction and memo probes never race."""
        shard = hs.shard(dom)
        sub_free = np.ascontiguousarray(free[shard.idx])
        gangs = [g for _i, g in members]
        sig = (
            tuple(id(g) for g in gangs),
            tuple(g.fairness for g in gangs),
        )
        work = DomainWork(dom, members, shard, gangs, sig, sub_free)
        if (
            # the memo is an incrementality tier: configured off, every
            # repeat pays the full fine solve
            self._hier_incremental
            and shard.last_placed is not None
            and shard.last_sig == sig
            and shard.last_pre is not None
            and shard.last_pre.shape == sub_free.shape
            and np.array_equal(shard.last_pre, sub_free)
        ):
            work.memo = True
            return work
        if shard.engine is None:
            shard.engine = self._make_sub_engine(shard)
        pend, shard.pending_rows = shard.pending_rows, set()
        # the parent sync's custody chain scopes the sub diff: the consumed
        # pending rows (possibly none: the sub-engine declared its own
        # commits after its last repair), or None = unknown scope
        shard.engine.note_free_rows(None if pend is None else sorted(pend))
        work.pre = sub_free.copy()
        return work

    def _domain_dispatch(self, work: DomainWork, level: int) -> None:
        """Async half of one domain's fine solve: gang proxies, host
        encode, staged-delta sync and the device launch on the sub-engine's
        stream, through its own dispatch(). Thread-pool safe: it touches
        only shard-local state (the domain's proxies, mask slices,
        sub-engine, stream and graphs); the parent `free` is never read
        here (prepare sliced it), and domains partition node rows."""
        t0 = time.perf_counter()
        work.proxies = [work.shard.proxy(g, level) for g in work.gangs]
        work.handle = work.shard.engine.dispatch(work.proxies,
                                                 free=work.sub_free)
        work.encode_seconds = time.perf_counter() - t0

    def _domain_collect(self, work: DomainWork, free: np.ndarray,
                        sub_stats: dict):
        """Collect half of one domain's fine solve: adopt the in-flight
        device phase (wait for its event), run the exact host repair, and
        commit the domain's free rows, or replay the memo. Runs in domain
        order on the main thread: the `free` commits and the parent's
        counter mirroring are the wave's only shared writes. Returns
        ({name: global GangPlacement}, [failed (i, gang)])."""
        shard = work.shard
        idx = shard.idx
        if work.memo:
            free[idx] = shard.last_post
            sub_stats["hier_domain_reuse"] += 1
            return {p.gang.name: p for p in shard.last_placed}, []
        res = shard.engine.solve(work.proxies, free=work.sub_free,
                                 dispatch=work.handle)
        if self.tracer.enabled:
            # the fine solve's point on the PARENT tracer, emitted here on
            # the calling thread in domain order, with the sub-solve's
            # split, linked to the hierarchical round's causal token
            self.tracer.point(
                "engine.fine_solve",
                domain=work.dom, gangs=len(work.gangs),
                encode_seconds=round(res.stats.get("encode_seconds", 0.0), 6),
                device_seconds=round(res.stats.get("device_seconds", 0.0), 6),
                repair_seconds=round(res.stats.get("repair_seconds", 0.0), 6),
                **({"causal_link": self._hier_token}
                   if self._hier_token is not None else {}),
            )
        free[idx] = work.sub_free
        placed_here: dict[str, GangPlacement] = {}
        failed = []
        for i, g in work.members:
            subp = res.placed.get(g.name)
            if subp is None:
                failed.append((i, g))
                continue
            gidx = idx[subp.node_indices]
            placed_here[g.name] = GangPlacement(
                gang=g,
                pod_to_node=subp.pod_to_node,  # node names are global
                node_indices=gidx,
                placement_score=placement_score_for_nodes(self.snapshot,
                                                          gidx),
            )
        shard.last_sig = work.sig
        shard.last_pre = work.pre
        shard.last_post = work.sub_free.copy()
        # the memo replays only COMPLETE outcomes: a failed gang re-enters
        # the alternate walk, which a replay cannot reproduce
        shard.last_placed = list(placed_here.values()) if not failed else None
        # mirror the sub-engine's launch accounting into the parent's, so
        # the per-kind story shows the shard-local incremental tier
        sub_stats["hier_fine_solves"] += 1
        for kind, total in shard.engine._dispatches.items():
            self._count_dispatch_kind(kind,
                                      total - shard.disp_seen.get(kind, 0))
            shard.disp_seen[kind] = total
        rows_total = shard.engine._inc_rows_total
        if rows_total > shard.inc_rows_seen:
            self._count_inc_rows(rows_total - shard.inc_rows_seen)
            shard.inc_rows_seen = rows_total
        hits = shard.engine._inc_reuse_hits
        if hits > shard.reuse_seen:
            self._inc_reuse_hits += hits - shard.reuse_seen
            sub_stats["hier_sub_reused"] += hits - shard.reuse_seen
            shard.reuse_seen = hits
        if res.stats.get("incremental"):
            sub_stats["hier_sub_incremental"] += 1
            sub_stats["incremental_rows"] += res.stats.get(
                "incremental_rows", 0.0)
        sub_stats["hier_repair_fallbacks"] += res.stats.get("fallbacks", 0.0)
        return placed_here, failed

    def _solve_domain(self, hs, dom: int, members, free: np.ndarray,
                      sub_stats: dict):
        """Serial fine solve of one coarse domain (the workers = 0 path and
        single-domain waves): prepare, dispatch, collect back to back."""
        work = self._domain_prepare(hs, dom, members, free)
        if not work.memo:
            self._domain_dispatch(work, hs.level)
        return self._domain_collect(work, free, sub_stats)

    def _auto_hier_workers(self) -> int:
        """hier_parallel_workers=None: enough host threads to keep the
        encode pipeline ahead of the collect loop, bounded -- the dispatch
        half is host numpy and an async launch, so past the core count
        more workers only contend."""
        return min(8, os.cpu_count() or 1)

    def _wave_workers(self) -> int:
        """Resolved wave-parallelism width (0 = serial fine solves)."""
        w = self.hier_parallel_workers
        if w is None:
            return self._auto_hier_workers()
        return max(0, int(w))

    def _hier_pool_get(self, workers: int) -> ThreadPoolExecutor:
        """The engine's bounded dispatch pool, grown (never shrunk) to the
        resolved width; threads start lazily, so an engine whose waves
        never run in parallel creates none."""
        if self._hier_pool is None or self._hier_pool_size < workers:
            if self._hier_pool is not None:
                self._hier_pool.shutdown(wait=False)
            self._hier_pool = ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix="grove-hier-wave")
            self._hier_pool_size = workers
        return self._hier_pool

    def _run_wave(self, hs, groups: dict, free: np.ndarray, sub_stats: dict,
                  tried: dict, placed_map: dict, fine_walls: list) -> list:
        """One attempt wave of fine solves: DISPATCH-ALL (each domain's
        encode, staged-delta sync and launch on its sub-engine's stream,
        through the pool), then COLLECT-IN-ORDER (wait for each domain's
        event, exact repair, free-row commit) in sorted domain order. The
        dispatch halves touch disjoint free slices and shard-local state
        only, so placements are bit-equal to solving the domains one at a
        time (workers = 0). Returns the wave's failed (i, gang) pairs.
        The wave's span, histogram and gauge are recorded here, on the
        calling thread."""
        doms = sorted(groups)
        workers = min(self._wave_workers(), len(doms))
        parallel = workers >= 1 and len(doms) > 1
        wave_t0 = time.perf_counter()
        with self.tracer.span("engine.hier_wave", domains=len(doms),
                              workers=workers if parallel else 0) as wsp:
            failures, memo_hits = self._wave_body(
                hs, doms, groups, free, sub_stats, tried, placed_map,
                fine_walls, workers if parallel else 0)
            wave_wall = time.perf_counter() - wave_t0
            wsp.set(wall_seconds=round(wave_wall, 6), memo_hits=memo_hits,
                    failures=len(failures))
        sub_stats["hier_waves"] += 1
        sub_stats["hier_wave_width"] = max(sub_stats["hier_wave_width"],
                                           float(len(doms)))
        # max-merged like the width: a trailing single-domain retry wave
        # must not erase that earlier waves ran in parallel
        sub_stats["hier_wave_workers"] = max(
            sub_stats["hier_wave_workers"], float(workers if parallel else 0))
        if self.metrics is not None:
            self.metrics.histogram(
                "grove_solver_hier_wave_seconds",
                "wall seconds of one hierarchical fine-solve wave "
                "(dispatch-all + collect-in-order across domains)",
            ).observe(wave_wall)
            self.metrics.gauge(
                "grove_solver_hier_wave_width",
                "domains in the last hierarchical fine-solve wave",
            ).set(float(len(doms)))
        return failures

    def _wave_body(self, hs, doms, groups, free, sub_stats, tried,
                   placed_map, fine_walls, workers: int):
        """The wave's fine solves: through the pool when `workers` > 0,
        else one domain at a time. Returns (failed (i, gang) pairs, memo
        hits)."""
        failures: list = []
        memo_hits = 0
        if workers:
            works = [self._domain_prepare(hs, dom, groups[dom], free)
                     for dom in doms]
            pool = self._hier_pool_get(workers)
            for w in works:
                if w.memo:
                    memo_hits += 1
                else:
                    w.fut = pool.submit(self._domain_dispatch, w, hs.level)
            try:
                for w in works:
                    if w.fut is not None:
                        w.fut.result()  # re-raise dispatch errors
                    t0 = time.perf_counter()
                    placed_here, failed = self._domain_collect(w, free,
                                                               sub_stats)
                    fine_walls.append(time.perf_counter() - t0
                                      + w.encode_seconds)
                    for i, _g in w.members:
                        tried[i].add(w.dom)
                    placed_map.update(placed_here)
                    failures.extend(failed)
            except BaseException:
                # never unwind while sibling dispatch halves still run: a
                # caller retrying solve() would re-enter the same shards
                # concurrently with them. Cancel what never started, wait
                # out what did, then propagate.
                for w in works:
                    if w.fut is not None:
                        w.fut.cancel()
                for w in works:
                    if w.fut is not None and not w.fut.cancelled():
                        try:
                            w.fut.exception()
                        except BaseException:
                            pass  # the error surfacing below is the first
                raise
        else:
            for dom in doms:
                t0 = time.perf_counter()
                placed_here, failed = self._solve_domain(
                    hs, dom, groups[dom], free, sub_stats)
                fine_walls.append(time.perf_counter() - t0)
                for i, _g in groups[dom]:
                    tried[i].add(dom)
                placed_map.update(placed_here)
                failures.extend(failed)
        return failures, memo_hits

    def _hier_run(self, order: list[SolverGang], free: np.ndarray,
                  result: SolveResult, level: int):
        """The two-level solve body (solve() and dispatch() both drive it):
        coarse admissibility and assignment over aggregates, fine exact
        solves per surviving domain, the alternate walk for fine failures,
        and the serial full-scan exactness net. Mutates `free` exactly like
        the flat repair. Returns (placed_map, fallbacks)."""
        hs = self._hier
        if hs is None or hs.snapshot is not self.snapshot or hs.level != level:
            hs = self._hier = HierarchyState(self.snapshot, level)
        elif not self.state_cache:
            # no sync ran (nor fanned out): every shard re-reads its slice
            hs.push_rows(None)
        t_c = time.perf_counter()
        fm = self._masked_free(free)
        admissible, dom_free, cstats, cls_ids = coarse_admissible(
            order, self.snapshot, fm, level)
        choices = coarse_assign(order, admissible, dom_free, self._cap_scale,
                                top_kc=min(4, hs.nd), class_ids=cls_ids)
        hs.last_pruned = cstats["pruned"]
        hs.last_admissible = cstats["admissible"]
        result.stats["hier_coarse_seconds"] = time.perf_counter() - t_c
        sub_stats = {
            "hier_fine_solves": 0, "hier_domain_reuse": 0,
            "hier_sub_incremental": 0, "hier_sub_reused": 0,
            "incremental_rows": 0.0, "hier_repair_fallbacks": 0.0,
            "hier_waves": 0, "hier_wave_width": 0.0,
            "hier_wave_workers": 0.0, "hier_wave_devices": 0.0,
        }
        fine_walls: list[float] = []
        t_fine = time.perf_counter()
        placed_map: dict[str, GangPlacement] = {}
        pending = list(enumerate(order))
        tried: dict[int, set] = {i: set() for i, _g in pending}
        round_choices = dict(enumerate(choices))
        for rnd in range(3):
            if not pending:
                break
            if rnd > 0:
                # RE-AGGREGATE for the still-failing gangs against the live
                # residual free, excluding the domains each already failed
                # in (the flat repair's serial net gets the same live view)
                sub = [g for _i, g in pending]
                adm_r, dom_free_r, _, _cls = coarse_admissible(
                    sub, self.snapshot, self._masked_free(free), level)
                for row, (i, _g) in enumerate(pending):
                    if tried[i]:
                        adm_r[row, sorted(tried[i])] = False
                # no class_ids: the tried masks just edited the rows
                ch = coarse_assign(sub, adm_r, dom_free_r, self._cap_scale,
                                   top_kc=min(4, hs.nd))
                round_choices = {pending[row][0]: ch[row]
                                 for row in range(len(pending))}
            attempt = 0
            while pending:
                groups: dict[int, list] = {}
                leftover = []
                for i, g in pending:
                    alts = round_choices.get(i) or []
                    if attempt < len(alts):
                        groups.setdefault(alts[attempt], []).append((i, g))
                    else:
                        leftover.append((i, g))
                if not groups:
                    pending = leftover
                    break
                failures = self._run_wave(hs, groups, free, sub_stats, tried,
                                          placed_map, fine_walls)
                pending = sorted(leftover + failures)
                attempt += 1
        result.stats["hier_fine_seconds"] = time.perf_counter() - t_fine
        # exactness net: gangs inadmissible everywhere or failed in every
        # surviving domain take the flat repair's serial scan, restricted
        # to the gang's admissible domains' nodes when any exist (free only
        # decreases during a solve), else over the whole cluster, as flat
        t_net = time.perf_counter()
        fallbacks = 0
        for i, gang in pending:
            fallbacks += 1
            net_nodes = self._sched_nodes
            adm_row = admissible[i]
            if adm_row.any():
                net_nodes = net_nodes[adm_row[hs.dom_of[net_nodes]]]
            placed = _place_one(gang, self.snapshot, free, net_nodes)
            if placed is None and net_nodes is not self._sched_nodes:
                placed = _place_one(gang, self.snapshot, free,
                                    self._sched_nodes)
            if placed is not None:
                placed_map[gang.name] = placed
        result.stats["hier_net_seconds"] = time.perf_counter() - t_net
        if fine_walls:
            # per-domain fine walls (dispatch half + collect half; memo
            # replays near zero); in a parallel wave the sum exceeds the
            # fine phase's wall by the overlap won
            walls = sorted(fine_walls)
            result.stats["hier_fine_wall_min"] = walls[0]
            result.stats["hier_fine_wall_med"] = walls[len(walls) // 2]
            result.stats["hier_fine_wall_max"] = walls[-1]
        result.stats.update(sub_stats)
        result.stats["hierarchical"] = 1.0
        result.stats["hier_level"] = float(level)
        result.stats["hier_domains"] = float(hs.nd)
        result.stats["hier_pruned_pairs"] = float(hs.last_pruned)
        if sub_stats["hier_sub_incremental"]:
            result.stats["incremental"] = 1.0
        return placed_map, fallbacks

    def _hier_dispatch(self, order, free, level, t0) -> SolveDispatch:
        """Hierarchical dispatch: the two-level solve is mostly host work
        with many small sub-launches, so it runs now, against a copy of
        `free`, and the handle carries the placements and the free-row
        delta. Adoption (the same order by identity, the same free content
        by the epoch or content guard) replays the delta; any staleness
        solves afresh, as on the flat path."""
        if self.tracer.enabled:
            self._hier_token = next_token()
        with self.tracer.span(
            "engine.hierarchical", gangs=len(order), level=level,
            dispatch=True,
            **({"causal_emit": self._hier_token}
               if self._hier_token is not None else {}),
        ) as hsp:
            epoch = self._sync_free(free) if self.state_cache else 0
            free_h = free.copy()
            stub = SolveResult()
            placed_map, fallbacks = self._hier_run(order, free_h, stub, level)
            rows = np.flatnonzero((free_h != free).any(axis=1))
            # a domain solved twice in the run read its own commits on
            # the copy; `free` never had them unless this is adopted
            self._fan_out(rows)
            hsp.set(
                fine_solves=int(stub.stats.get("hier_fine_solves", 0)),
                domains=int(stub.stats.get("hier_domains", 0)),
                encode_seconds=round(time.perf_counter() - t0, 6),
            )
        keep_free = not self.state_cache or self.state_verify
        return SolveDispatch(
            engine=self,
            order=order,
            free0=self._masked_free(free) if keep_free else None,
            token=("hier", placed_map, fallbacks, rows, free_h[rows],
                   dict(stub.stats)),
            encode_seconds=time.perf_counter() - t0,
            state_epoch=epoch,
            path="hierarchical",
            rows=int(rows.size),
            level=level,
        )

    def _hier_middle(self, order, free, dispatch, result, level, span):
        """solve()'s middle phase on the hierarchical path: adopt a
        hierarchical dispatch (replay its recorded free-row delta: the
        epoch guard proved the content basis unchanged) or run the
        two-level solve. The parent's sync keeps its mirror and epoch
        current (the adoption guard and the shards' changed-row custody
        chain) and its own resident state warm for a later flat backlog.
        Returns (placed_map, fallbacks)."""
        epoch = self._sync_free(free) if self.state_cache else 0
        if (
            dispatch is not None
            and dispatch.engine is self
            and dispatch.path == "hierarchical"
            and dispatch.token is not None
            and len(dispatch.order) == len(order)
            and all(a is b for a, b in zip(dispatch.order, order))
            and self._dispatch_current(dispatch, free, epoch)
        ):
            _tag, placed_map, fallbacks, rows, vals, stats = dispatch.token
            dispatch.token = None
            free[rows] = vals
            result.stats.update(stats)
            result.stats["encode_seconds"] = dispatch.encode_seconds
            result.stats["dispatch_overlap"] = 1.0
            span.set(level=level, adopted=True,
                     fine_solves=stats.get("hier_fine_solves"))
            return placed_map, fallbacks
        placed_map, fallbacks = self._hier_run(order, free, result, level)
        span.set(
            level=level, adopted=False,
            domains=int(result.stats["hier_domains"]),
            pruned_pairs=int(result.stats["hier_pruned_pairs"]),
            fine_solves=int(result.stats["hier_fine_solves"]),
            domain_reuse=int(result.stats["hier_domain_reuse"]),
            fallbacks=fallbacks,
        )
        return placed_map, fallbacks

    # -- the solve -----------------------------------------------------------
    def solve(
        self,
        gangs: list[SolverGang],
        free: np.ndarray | None = None,
        dispatch: SolveDispatch | None = None,
        fairness: dict[str, float] | None = None,
    ) -> SolveResult:
        """Place `gangs` against `free` (default: a copy of the snapshot's;
        a passed matrix is mutated in place as gangs commit), adopting
        `dispatch` when it is current."""
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
            self._record(result, gangs)
            return result
        order = sorted(solvable, key=gang_sort_key)
        # Hierarchical two-level path (solver/hierarchy.py), then the same
        # shared tail as the flat path. _hier_plan is a pure function of
        # (order, knobs, static snapshot), so a dispatch and its consuming
        # solve always take the same path.
        hier_level = self._hier_plan(order)
        if hier_level is not None:
            if self.tracer.enabled:
                self._hier_token = next_token()
            with self.tracer.span(
                "engine.hierarchical", gangs=len(order), level=hier_level,
                **({"causal_emit": self._hier_token}
                   if self._hier_token is not None else {}),
            ) as hsp:
                placed_map, fallbacks = self._hier_middle(
                    order, free, dispatch, result, hier_level, hsp)
            return self._finish_solve(result, order, placed_map, fallbacks,
                                      free, gangs, t0)
        # span shape: a FUSED engine's encode, device and repair are not
        # separate dispatches, so they collapse into ONE engine.fused span
        # carrying the sub-phase walls and the path; split engines keep
        # the three child spans
        outer = (self.tracer.span("engine.fused", gangs=len(order))
                 if self.fused else NOOP_TRACER.span("engine.fused"))
        with torch.cuda.stream(self._stream), outer as fsp:
            placed_map, fallbacks, path = self._solve_flat(
                order, free, dispatch, result, t0,
                NOOP_TRACER if self.fused else self.tracer)
            if self.fused:
                fsp.set(
                    path=path,
                    kernel=self._kernel_tier(),
                    device_commit=self.device_commit,
                    encode_seconds=round(result.stats["encode_seconds"], 6),
                    device_seconds=round(result.stats["device_seconds"], 6),
                    repair_seconds=round(result.stats["repair_seconds"], 6),
                    fallbacks=fallbacks,
                    overlapped=bool(result.stats.get("dispatch_overlap")),
                )
        return self._finish_solve(result, order, placed_map, fallbacks, free,
                                  gangs, t0)

    def _solve_flat(self, order, free, dispatch, result, t0, inner):
        """The flat solve's middle: sync, adopt `dispatch` or run the
        device phase, repair, with the spans engine.encode, engine.device
        (closed once the packed result has landed) and engine.repair on
        `inner`. Returns (placed_map, fallbacks, the device phase's path)."""
        # cache on: sync BEFORE the adoption decision, so the O(1) epoch
        # compare equals a content compare and the fresh path reuses the
        # synced state. Cache off: the guard compares content, and the
        # full upload belongs to the fresh branch only.
        epoch = (self._sync_free(free, defer=self.fused) if self.state_cache
                 else 0)
        if (
            dispatch is not None
            and dispatch.engine is self
            and dispatch.path != "hierarchical"
            and dispatch.token is not None
            and len(dispatch.order) == len(order)
            and all(a is b for a, b in zip(dispatch.order, order))
            and self._dispatch_current(dispatch, free, epoch)
        ):
            # adopt: identical inputs, so the result is bitwise what a
            # fresh solve would compute; only the copy's wait is paid here
            result.stats["encode_seconds"] = dispatch.encode_seconds
            result.stats["dispatch_overlap"] = 1.0
            if dispatch.path == "incremental":
                result.stats["incremental"] = 1.0
                result.stats["incremental_rows"] = float(dispatch.rows)
            elif dispatch.path == "reused":
                result.stats["reused"] = 1.0
            t_dev = time.perf_counter()
            with inner.span("engine.device", gangs=len(order),
                            overlapped=True):
                top_val, top_dom = self._device_end(dispatch.token)
            dispatch.token = None
            result.stats["device_seconds"] = time.perf_counter() - t_dev
            path = "adopted:" + (dispatch.path or "split")
        else:
            if not self.state_cache:
                self._sync_free(free)
            with inner.span("engine.encode", gangs=len(order)):
                enc = self._encode_arrays(order)
            result.stats["encode_seconds"] = time.perf_counter() - t0
            t_dev = time.perf_counter()
            with inner.span("engine.device", gangs=len(order),
                            overlapped=False):
                top_val, top_dom = self._device_phase(enc)
            result.stats["device_seconds"] = time.perf_counter() - t_dev
            path = self._last_begin.get("path")
            if path == "incremental":
                result.stats["incremental"] = 1.0
                result.stats["incremental_rows"] = float(
                    self._last_begin.get("rows", 0))
            elif path == "reused":
                result.stats["reused"] = 1.0
        t_rep = time.perf_counter()
        with inner.span("engine.repair", gangs=len(order)) as rsp:
            placed_map, fallbacks = self._repair(order, top_val, top_dom,
                                                 free)
            rsp.set(fallbacks=fallbacks)
        result.stats["repair_seconds"] = time.perf_counter() - t_rep
        return placed_map, fallbacks, path

    def _record(self, result: SolveResult, gangs) -> None:
        """Feed a finished solve to the metrics and the decision ring."""
        if self.metrics is not None:
            record_solve_metrics(self.metrics, result, len(gangs))
        if self.decisions is not None:
            self.decisions.record_solve(result, self.snapshot, gangs)

    def _finish_solve(self, result, order, placed_map, fallbacks, free,
                      gangs, t0):
        """Shared solve tail of the flat and hierarchical paths: declare
        the rows the repair committed, attribute every gang placed or
        unplaced (with the memoized structured diagnosis against the
        residual free matrix), and feed the metrics and the decision
        ring."""
        if self.state_cache and placed_map:
            # the repair committed demand into `free` in place: the engine
            # declares its OWN mutations, so the next sync diffs only the
            # bound rows (note_free_rows superset contract)
            self.note_free_rows(np.unique(np.concatenate(
                [p.node_indices for p in placed_map.values()]
            )).tolist())
        free_fp = None
        for gang in order:
            if gang.name in placed_map:
                result.placed[gang.name] = placed_map[gang.name]
                continue
            # a retry tick re-solving an unchanged wedge pays one adler
            # pass, not the funnel's per-level sweeps
            if free_fp is None:
                free_fp = zlib.adler32(free.tobytes())
            key = (
                gang.name,
                gang.required_level,
                zlib.adler32(gang.demand.tobytes()),
                0 if gang.pod_elig is None else tuple(
                    0 if m is None else id(m) for m in gang.pod_elig
                ),
                free_fp,
            )
            diag = self._diag_cache.get(key)
            if diag is None:
                diag = diagnose_unplaced(gang, self.snapshot, free)
                if len(self._diag_cache) > 4096:
                    self._diag_cache.clear()
                self._diag_cache[key] = diag
            result.unplaced[gang.name] = diag
        result.stats["fallbacks"] = float(fallbacks)
        result.wall_seconds = time.perf_counter() - t0
        self._record(result, gangs)
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

    # -- the device phase ----------------------------------------------------
    def _device_phase(self, enc: EncodedBacklog):
        """Blocking device scoring: begin + end in one call."""
        return self._device_end(self._device_begin(enc))

    def _io_to_device(self, io: np.ndarray, discount: int = 0) -> torch.Tensor:
        """Ship (or reuse, when bit-identical) an io buffer; `discount`
        bytes of it (a staged delta block) are counted as state_delta, not
        as inputs."""
        cached = self._io_cache
        if (cached is not None and cached[0].shape == io.shape
                and np.array_equal(cached[0], io)):
            return cached[1]
        dev = self._h2d(io)
        self._io_cache = (io, dev)
        self._count_bytes("inputs", io.nbytes - discount)
        return dev

    def _masks_to_device(self, elig_masks: np.ndarray) -> torch.Tensor:
        if elig_masks.shape[0] == 1:
            # the default table (row 0 = all nodes) lives with the statics
            return self._ensure_statics().ones
        cached = self._masks_cache
        if (cached is not None and cached[0].shape == elig_masks.shape
                and np.array_equal(cached[0], elig_masks)):
            return cached[1]
        dev = self._h2d(elig_masks)
        self._masks_cache = (elig_masks, dev)
        self._count_bytes("masks", elig_masks.nbytes)
        return dev

    def _build_io(self, enc: EncodedBacklog, upd: np.ndarray | None = None):
        """The split and fused programs' io buffer (programs.fused_layout):
        the gang rows, the signature rows, the demand rows deduped by bits
        (`demand_table`, padded to a power of two) and each gang's row in
        them, and the optional staged delta block. Returns (io, layout).
        Raises ValueError on a sig_idx out of range, before upload."""
        u_sig_demand, u_sig_mask, _, sig_idx = enc.sig
        check_sig_idx(sig_idx, u_sig_demand.shape[0])
        demand, demand_idx = demand_table(enc.total_demand)
        g_pad, r = enc.total_demand.shape
        lay = programs.fused_layout(
            g_pad, r, sig_idx.shape[1], u_sig_demand.shape[0],
            _bucket(demand.shape[0], minimum=1),
            0 if upd is None else upd.shape[0],
        )
        io = np.zeros((lay.size,), np.float32)
        programs.pack_gangs(
            lay, io, enc.total_demand, enc.required_level,
            enc.preferred_level, enc.valid, enc.fairness, sig_idx,
            u_sig_demand, u_sig_mask, demand, demand_idx,
        )
        if upd is not None:
            lay.view(io, "upd")[...] = upd
        return io, lay

    def _maybe_incremental(self, enc: EncodedBacklog):
        """Decide whether the resident value/demand caches can serve this
        backlog: only when a cache exists at the current free-state EPOCH
        (equal epochs prove every cached row was computed against this
        exact content). A gang's row is CLEAN when its fingerprint matches
        the cached one; new and changed gangs are dirty. Returns
        ("reuse",) for a backlog bit-identical in content AND order (the
        last packed result answers it with no device work), ("inc", perm,
        dirty) for a dirty-row re-score, or None (the full solve; also for
        a mostly-dirty backlog)."""
        inc = self._inc
        if inc is None or inc.value_dev is None:
            return None
        if inc.epoch != self._state.epoch:
            return None
        g = len(enc.keys)
        if g == 0:
            return None
        perm = np.full(enc.g_pad, inc.g_pad, np.int32)
        dirty: list[int] = []
        identity = True
        for i, key in enumerate(enc.keys):
            p = inc.pos.get(key)
            if p is not None and inc.fps.get(key) == enc.fps[i]:
                perm[i] = p
                if p != i:
                    identity = False
            else:
                dirty.append(i)
                identity = False
        if 2 * len(dirty) > g:
            return None  # mostly dirty: the full solve is simpler
        if (
            not dirty
            and identity
            and g == inc.num_real
            and enc.g_pad == inc.g_pad
            and inc.packed_host is not None
        ):
            return ("reuse",)
        return ("inc", perm, dirty)

    def _count_graph_loads(self, discount: int) -> None:
        """Count the bytes the last graph run copied into its static
        inputs (an unchanged io buffer or mask table is not copied)."""
        loaded = self._graphs.last_loads
        if loaded["io"]:
            self._count_bytes("inputs", loaded["io"] - discount)
        self._count_bytes("masks", loaded["masks"])

    def _token(self, packed: torch.Tensor, cache=None) -> DeviceToken:
        """The packed result on its way to the host: on the card a pinned
        buffer of the token's own, filled by a non-blocking copy queued
        right after the launch, and the event recorded after it."""
        if packed.device.type == "cpu":
            return DeviceToken(packed, None, cache)
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return DeviceToken(host, event, cache)

    def _begin_fused(self, enc: EncodedBacklog) -> DeviceToken:
        """Single-launch fused dispatch: the staged delta and the gang
        inputs ride ONE io buffer into the fused program, which applies
        the delta to the resident tensor in place and scores; on the card
        that program is the bucket key's CUDA graph, replayed."""
        upd = self._take_staged()
        io, lay = self._build_io(enc, upd)
        discount = 0 if upd is None else upd.nbytes
        self._count_bytes("state_delta", discount)
        elig_masks = enc.sig[2]
        statics = self._ensure_statics()
        kw = self._score_kw()
        if self._graphs is not None:
            masks_np = None if elig_masks.shape[0] == 1 else elig_masks
            key = (lay, elig_masks.shape[0], kw["tier"], kw["device_commit"])
            packed, value, td = self._graphs.run(
                key, self._state.dev, statics, io, masks_np, lay, **kw)
            self._count_graph_loads(discount)
        else:
            packed, value, td = programs.fused_score(
                self._state.dev, statics, self._masks_to_device(elig_masks),
                self._io_to_device(io, discount), lay, **kw)
        self._count_dispatch_kind("fused")
        self._count_kernel_tiers()
        self._last_begin = {
            "path": "fused", "rows": len(enc.keys),
            "kernel": self._kernel_tier(), "commit": self.device_commit,
        }
        cache = None
        if self.incremental:
            cache = IncrementalCache(
                self._state.epoch,
                {k: i for i, k in enumerate(enc.keys)},
                dict(zip(enc.keys, enc.fps)),
                value, td, enc.g_pad, len(enc.keys),
            )
            self._inc = cache
        return self._token(packed, cache)

    def _begin_incremental(self, enc: EncodedBacklog, perm, dirty):
        """Dirty-row dispatch: clean gangs' value rows are GATHERED from
        the resident cache through `perm`; only the `dirty` rows are
        re-scored, their signature and mask sub-tables remapped to local
        ids and shipped with the permutation in one small buffer
        (programs.inc_layout); the commit kernels re-run over the merged
        matrix. Bit-equal to the full solve by the value tensor's
        row-independence."""
        inc = self._inc
        u_sig_demand, u_sig_mask, elig_masks, _ = enc.sig
        g_pad, r = enc.total_demand.shape
        sid_map: dict[int, int] = {}
        mrow_map: dict[int, int] = {0: 0}
        d_sig_rows: list[int] = []
        d_mask_rows: list[int] = [0]
        d_gang_sigs: list[list[int]] = []
        for i in dirty:
            sigs = []
            for s in enc.gang_sigs[i]:
                ds = sid_map.get(s)
                if ds is None:
                    ds = sid_map[s] = len(d_sig_rows)
                    d_sig_rows.append(s)
                    row = int(u_sig_mask[s])
                    if row not in mrow_map:
                        mrow_map[row] = len(d_mask_rows)
                        d_mask_rows.append(row)
                sigs.append(ds)
            d_gang_sigs.append(sigs)
        nd_pad = _bucket(len(dirty), minimum=4)
        s_padd = _bucket(max((len(s) for s in d_gang_sigs), default=1),
                         minimum=1)
        td_d = enc.total_demand[dirty]
        demand, demand_idx = demand_table(td_d)
        lay = programs.inc_layout(
            g_pad, nd_pad, r, s_padd, _bucket(len(d_sig_rows), minimum=4),
            _bucket(demand.shape[0], minimum=1),
        )
        io = np.zeros((lay.size,), np.float32)
        lay.view(io, "perm")[:, 0] = perm
        pos = lay.view(io, "dirty_pos")[:, 0]
        pos[:] = float(g_pad)  # padding rows land past the G real rows
        pos[: len(dirty)] = dirty
        programs.pack_gangs(
            lay, io, td_d, enc.required_level[dirty],
            enc.preferred_level[dirty], enc.valid[dirty], enc.fairness[dirty],
            np.asarray([sigs + [sigs[0]] * (s_padd - len(sigs))
                        for sigs in d_gang_sigs], np.int32).reshape(-1, s_padd),
            u_sig_demand[d_sig_rows],
            np.asarray([mrow_map[int(u_sig_mask[s])] for s in d_sig_rows],
                       np.int32),
            demand, demand_idx,
        )
        statics = self._ensure_statics()
        m_padd = _bucket(len(d_mask_rows), minimum=1)
        d_masks = None
        if m_padd > 1:
            d_masks = np.zeros((m_padd, self.snapshot.num_nodes), np.float32)
            d_masks[: len(d_mask_rows)] = elig_masks[d_mask_rows]
        kw = self._score_kw()
        if self._graphs is not None:
            # K6 as the graph of its bucket key: the io buffer and mask
            # table content-loaded, the cache copied into static inputs
            key = ("inc", lay, inc.g_pad, m_padd, kw["tier"],
                   kw["device_commit"])
            packed, value_new, td_new = self._graphs.run(
                key, self._state.dev, statics, io, d_masks, lay,
                cache=(inc.value_dev, inc.td_dev), **kw)
            self._count_graph_loads(0)
        else:
            masks = statics.ones if d_masks is None else self._h2d(d_masks)
            packed, value_new, td_new = programs.inc_score(
                self._state.dev, inc.value_dev, inc.td_dev, statics, masks,
                self._h2d(io), lay, **kw,
            )
            self._count_bytes("inputs", io.nbytes)
            if d_masks is not None:
                self._count_bytes("masks", d_masks.nbytes)
        self._count_dispatch_kind("incremental")
        self._count_kernel_tiers()
        self._count_inc_rows(len(dirty))
        self._last_begin = {
            "path": "incremental", "rows": len(dirty),
            "kernel": self._kernel_tier(), "commit": self.device_commit,
        }
        cache = IncrementalCache(
            self._state.epoch,
            {k: i for i, k in enumerate(enc.keys)},
            dict(zip(enc.keys, enc.fps)),
            value_new, td_new, g_pad, len(enc.keys),
        )
        self._inc = cache
        return self._token(packed, cache)

    def _device_begin(self, enc: EncodedBacklog,
                      allow_incremental: bool = True) -> DeviceToken:
        """Dispatch device scoring and return the in-flight token; the
        result's copy to the host is queued at once, so it overlaps any
        host work before _device_end waits for it. A bit-identical
        backlog at an unchanged epoch takes the reuse tier: no launch, no
        transfer."""
        if self._state.dev is None:
            raise RuntimeError(
                "device free state not synced: _device_begin requires a "
                "_sync_free call first (solve/dispatch do this)"
            )
        if not self.fused:
            return self._begin_split(enc)
        plan = (
            self._maybe_incremental(enc)
            if (allow_incremental and self.incremental
                and self._staged is None)
            else None
        )
        if plan is not None and plan[0] == "reuse":
            self._inc_reuse_hits += 1
            self._last_begin = {"path": "reused", "rows": 0}
            return DeviceToken(self._inc.packed_host)
        if plan is not None:
            return self._begin_incremental(enc, plan[1], plan[2])
        return self._begin_fused(enc)

    def _begin_split(self, enc: EncodedBacklog) -> DeviceToken:
        """SPLIT dispatch (fused=False): the score-only program; a free
        delta ran as its own scatter launch in _sync_free."""
        io, lay = self._build_io(enc)
        packed = programs.device_score(
            self._state.dev, self._ensure_statics(),
            self._masks_to_device(enc.sig[2]), self._io_to_device(io), lay,
            **self._score_kw(),
        )
        self._count_dispatch_kind("split")
        self._count_kernel_tiers()
        self._last_begin = {
            "path": "split", "rows": len(enc.keys),
            "kernel": self._kernel_tier(), "commit": self.device_commit,
        }
        return self._token(packed)

    def _device_end(self, token: DeviceToken):
        """Wait for a token's result (its event, nothing else) and split it
        into ([G, K] values, [G, K] domain ids); K = 1 after the device
        commit. Arms the reuse tier when the token's cache is current."""
        if token.event is not None:
            token.event.synchronize()
        packed = token.host
        if isinstance(packed, torch.Tensor):  # not the reuse tier's array
            packed = packed.numpy().copy()
            self._count_bytes("results", packed.nbytes)
        if token.cache is not None and token.cache is self._inc:
            token.cache.packed_host = packed
        token.release()
        k = packed.shape[1] // 2
        return packed[:, :k], packed[:, k:].astype(np.int32)

    # -- introspection -------------------------------------------------------
    def debug_summary(self) -> dict:
        """Public introspection: engine type, problem shape, whether the
        static arrays are on the device, the decision ring's occupancy,
        and the device free state's
        epoch/upload/hit accounting with the launches by path, in the JAX
        engine's keys and tier vocabulary; `fused_graphs` counts the fused
        and incremental programs' graphs (the keys held against the LRU's
        bound, captures, evictions), their replays (those that carried a
        delta block, and the incremental ones, apart) and the kernel
        launches the replays made (on the card); `hierarchical` the
        two-level solve's state."""
        st = self._state
        graphs = self._graphs
        hs = self._hier
        return {
            "type": type(self).__name__,
            "num_nodes": self.snapshot.num_nodes,
            "num_domains": self.space.num_domains,
            "device_statics_resident": self._statics is not None,
            "decisions": (
                {
                    "gangs_tracked": len(self.decisions),
                    "records_total": self.decisions.records_total,
                }
                if self.decisions is not None
                else None
            ),
            "device_state": {
                "cache_enabled": self.state_cache,
                "resident": st.dev is not None,
                "epoch": st.epoch,
                "full_uploads": st.full_uploads,
                "delta_uploads": st.delta_uploads,
                "hits": st.hits,
                "checksum": (
                    zlib.adler32(st.mirror.tobytes())
                    if st.mirror is not None
                    else None
                ),
                "fused": self.fused,
                "incremental": self.incremental,
                "core_tier": self._kernel_tier(),
                # the kernels' plain versions run on the CPU: the
                # counterpart of the JAX engine's interpret mode
                "pallas_interpret": bool(
                    self.pallas_core and self.device.type == "cpu"
                ),
                "device_commit": self.device_commit,
                # always 0: this engine has no capability-miss fallback;
                # a failed launch, capture or replay raises
                "pallas_fallbacks": 0,
                "dispatches": dict(self._dispatches),
                "incremental_rows": self._inc_rows_total,
                "reuse_hits": self._inc_reuse_hits,
                "value_cache_resident": (
                    self._inc is not None
                    and self._inc.value_dev is not None
                ),
            },
            "fused_graphs": {
                "bound": programs.GRAPH_KEYS,
                "keys": 0 if graphs is None else len(graphs),
                "captured": 0 if graphs is None else graphs.captures,
                "evictions": 0 if graphs is None else graphs.evictions,
                "replays": 0 if graphs is None else graphs.replays,
                "delta_replays": 0 if graphs is None else graphs.delta_replays,
                "inc_replays": 0 if graphs is None else graphs.inc_replays,
                "whatif_replays": (0 if graphs is None
                                   else graphs.whatif_replays),
                "launches": {} if graphs is None else dict(graphs.launches),
            },
            # the hierarchical solve: the coarse pass's pruning and the
            # shard population (the sub-engines' launches are mirrored
            # into the dispatches above)
            "hierarchical": {
                "enabled": self.hierarchical,
                "wave_workers": self._wave_workers(),
                "prune_level": None if hs is None else hs.level,
                "coarse_domains": None if hs is None else hs.nd,
                "shards_built": 0 if hs is None else len(hs.shards),
                "last_pruned_pairs": 0 if hs is None else hs.last_pruned,
                "last_admissible_pairs": (0 if hs is None
                                          else hs.last_admissible),
            },
        }

    def measure_device_split(
        self, gangs: list[SolverGang], free: np.ndarray | None = None,
        iters: int = 8, mode: str = "warm", delta_rows: int = 16,
        seed: int = 0,
    ) -> dict:
        """Separate the device phase into COMPUTE vs TRANSPORT. K launches
        back to back with ONE wait at the end give total = K*c + t (the
        launches pipeline; only the last result's copy is waited for),
        one launch and its wait give r = c + t; so c = (total - r) /
        (K - 1) and t = r - c. Host clocks around work that ends in a wait
        for the result.

        mode selects the state-cache regime under measurement:
          "warm"   -- resident free state unchanged between solves; the
                      timed rounds sync nothing.
          "delta"  -- `delta_rows` seeded rows mutated (and declared)
                      before every launch, outside the timed window; the
                      timed round pays the declared-row diff and the delta
                      (staged into the fused launch, or its own scatter on
                      a split engine).
          "full"   -- the state invalidated before every launch: each
                      pays the full upload, host mask and copy included.
          "commit" -- "warm" with the device commit forced on for the
                      probe's launches; also reports both payload sizes.
        The incremental tiers are bypassed (an identical backlog would be
        a zero-launch reuse). `free` is mutated in place in delta mode:
        pass a copy. Times are unrounded seconds."""
        if free is None:
            free = self.snapshot.free.copy()
        solvable = [g for g in gangs if not g.unschedulable_reason]
        order = sorted(solvable, key=gang_sort_key)
        enc = self._encode_arrays(order)
        rng = np.random.default_rng(seed)
        n = self.snapshot.num_nodes
        warm_like = mode in ("warm", "commit")
        saved_commit = self.device_commit
        if mode == "commit":
            self.device_commit = True

        def mutate():
            if mode == "full":
                self.invalidate_device_state()
            elif mode == "delta":
                rows = rng.choice(n, size=min(delta_rows, n), replace=False)
                scale = rng.uniform(0.5, 1.0, size=(rows.size, 1))
                free[rows] = (free[rows] * scale).astype(np.float32)
                self.note_free_rows(rows.tolist())

        def timed_round():
            if not warm_like:
                self._sync_free(free, defer=self.fused)
            return self._device_end(
                self._device_begin(enc, allow_incremental=False)
            )

        try:
            self._sync_free(free)
            timed_round()
            r_walls = []
            for _ in range(3):
                mutate()
                t0 = time.perf_counter()
                timed_round()
                r_walls.append(time.perf_counter() - t0)
            r = sorted(r_walls)[1]
            t0 = time.perf_counter()
            token = None
            for _ in range(iters):
                mutate()
                if not warm_like:
                    self._sync_free(free, defer=self.fused)
                token = self._device_begin(enc, allow_incremental=False)
            self._device_end(token)
            total = time.perf_counter() - t0
            active_commit = bool(self._last_begin.get("commit"))
        finally:
            self.device_commit = saved_commit
        compute = max(0.0, (total - r) / max(iters - 1, 1))
        out = {
            "device_roundtrip_seconds": r,
            "device_compute_seconds": compute,
            "device_transport_seconds": max(0.0, r - compute),
            "device_split_iters": iters,
            "device_split_mode": mode,
            "device_core_tier": self._kernel_tier(),
        }
        if mode == "commit":
            k_eff = min(self.top_k, self.space.num_domains)
            out["device_result_bytes_candidates"] = enc.g_pad * 2 * k_eff * 4
            out["device_result_bytes_placements"] = enc.g_pad * 2 * 4
            out["device_commit_active"] = active_commit
        return out

    # -- the device phase's stages, outside the resident state ---------------
    def _encode_backlog(self, gangs: list[SolverGang]) -> EncodedBacklog:
        order = sorted(
            (g for g in gangs if not g.unschedulable_reason),
            key=gang_sort_key,
        )
        return self._encode_arrays(order)

    def _value_args(self, enc: EncodedBacklog, free: np.ndarray):
        """The value kernel's operands against an explicit free matrix
        (uploaded on its own, the resident state untouched), and the
        unpacked gang rows: (programs.value_operands(...), parts)."""
        io, lay = self._build_io(enc)
        parts = programs.unpack_gangs(lay, self._to_device(io))
        ops = programs.value_operands(
            self._to_device(self._masked_free(free)), self._ensure_statics(),
            self._masks_to_device(enc.sig[2]), parts,
        )
        return ops, parts

    def _score_values(self, enc: EncodedBacklog, free: np.ndarray):
        """(value [G, D], dom_free [D, R], total_demand [G, R]) on the
        engine's device, against an explicit free matrix."""
        ops, parts = self._value_args(enc, free)
        tier = self.pallas_precision if self.pallas_core else None
        return programs.value_tensor(ops, parts, tier), ops[0], parts["td"]

    def value_inputs(self, gangs: list[SolverGang],
                     free: np.ndarray | None = None):
        """The value kernel's operands for this backlog, on the device:
        the arguments of `kernel_value_sig` (programs.value_operands)."""
        free = self.snapshot.free if free is None else free
        return self._value_args(self._encode_backlog(gangs), free)[0]

    def score_values(self, gangs: list[SolverGang],
                     free: np.ndarray | None = None):
        """The device phase up to the value tensor, left on the device:
        (value, dom_free, anc_ids, total_demand), the inputs of the commit
        scan for this backlog."""
        free = self.snapshot.free if free is None else free
        value, dom_free, total_demand = self._score_values(
            self._encode_backlog(gangs), free
        )
        return value, dom_free, self._statics.anc_ids, total_demand

    def score_candidates(self, gangs: list[SolverGang],
                         free: np.ndarray | None = None):
        """The device phase up to the commit scan's packed top-k, left on
        the device: (top_val, top_dom, dom_free, anc_ids, total_demand),
        the inputs of the device commit for this backlog."""
        value, dom_free, anc_ids, total_demand = self.score_values(gangs, free)
        top_val, top_dom = commit_scan(
            value, dom_free, anc_ids, total_demand,
            min(self.top_k, self.space.num_domains), self.commit_chunk,
        )
        return top_val, top_dom, dom_free, anc_ids, total_demand

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
