"""Device programs of the placement engine, as plain functions on tensors.

The counterparts of the jitted programs of grove_tpu/solver/engine.py:

- `device_score` -- `_device_score` (:358), the SPLIT program: score only;
  a free-state delta runs as its own `scatter_rows` launch.
- `fused_score` (K5) -- `_fused_score_impl` (:401): the staged delta block
  applied in place to the resident free state, then the same scoring, in
  one program. On the card the engine captures it once per bucket shape
  and replays it as one CUDA graph (`FusedGraphs`): one H2D of the io
  buffer, one graph launch, one D2H of the packed result.
- `inc_score` (K6) -- `_inc_score` (:463): clean gangs' value rows
  gathered from the resident cache, the value kernel run on the dirty rows
  only, then the commit kernels over the merged matrix. On the card it is
  a CUDA graph per incremental bucket key too, reading the cache from
  static inputs it is copied into before each replay (`load_cache`).
- `scatter_rows` (K7) -- `_scatter_rows_impl` (:549): the delta update.
- the what-if program -- the non-donated `_fused_score` launch of
  `whatif_scores` (:1441): `fused_score` on a copy of the resident free
  state (the overlay rows scattered into the copy), so the resident state
  is only read. On the card it is a CUDA graph per bucket key in the same
  cache as K5 and K6, copying into a static scratch tensor.

The resident free state is one [N + 1, R] f32 tensor: row N absorbs the
padding index N of a delta block (JAX's `mode="drop"`), and every product
reads the view `free[:N]`. A delta block's real rows are unique (the host
builds them from a dict, sorted); its padding rows all name row N and all
carry zeros, so the order in which `index_copy_` writes them cannot
matter.

Every scoring variant runs `score_core`, whose arithmetic is
row-independent: the signature counts are exact integer sums of 0/1
products (any summation order gives the same bits) and the value kernel
and its twin compute each gang's row from that gang's operands alone. That
is what lets the incremental program reuse cached rows bit for bit.

The per-solve inputs ship as ONE f32 buffer whose layout (`IoLayout`) the
host packer (`pack_gangs`) and the device unpacker (`unpack_gangs`) both
read:

  fused / split:  gang [G, R+4+S] | sig [U, R+1] | demand [T, R]
                  | demand_idx [G, 1] | upd [K, 1+R]   (K = 0: no delta)
  incremental:    perm [G, 1] | dirty_pos [Kd, 1] | gang [Kd, R+4+S]
                  | sig [U', R+1] | demand [T', R] | demand_idx [Kd, 1]

gang rows: total demand (R) | required level | preferred level | valid |
fairness | sig_idx (S). sig rows: the signature's max-pod demand (R) | its
eligibility-mask row. demand is the gangs' demand rows deduped by their
bits (`engine.demand_table`), padded with zero rows to a power of two
that no gang indexes; demand_idx is each gang's row in it. upd rows: node
row | new masked values (R), padding rows name row N. Integers ride as
f32: every index and level is below 2^24.
"""

from __future__ import annotations

import gc
import threading
from collections import OrderedDict

import numpy as np
import torch

from . import kernel_core as kc
from .kernel_core import (
    gather_min,
    kernel_commit_scan,
    kernel_commit_topk,
    value_plain,
)

_NEG = -1e9

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


class IoLayout:
    """Named sections of one flat f32 buffer, in order: (name, rows,
    cols). Equal layouts hash equal, so a layout is part of a captured
    graph's key."""

    __slots__ = ("sections", "offsets", "size")

    def __init__(self, *sections: tuple[str, int, int]):
        self.sections = tuple(sections)
        self.offsets = {}
        o = 0
        for name, rows, cols in self.sections:
            self.offsets[name] = (o, rows, cols)
            o += rows * cols
        self.size = o

    def __eq__(self, other):
        return isinstance(other, IoLayout) and self.sections == other.sections

    def __hash__(self):
        return hash(self.sections)

    def __repr__(self):
        return f"IoLayout{self.sections}"

    def view(self, buf, name: str):
        """Section `name` of `buf` (a numpy array or a tensor) as [rows,
        cols], a view."""
        o, rows, cols = self.offsets[name]
        return buf[o: o + rows * cols].reshape(rows, cols)


def fused_layout(g: int, r: int, s: int, u: int, t: int, k: int = 0) -> IoLayout:
    """The split and fused programs' buffer (k = 0: no delta block)."""
    return IoLayout(("gang", g, r + 4 + s), ("sig", u, r + 1),
                    ("demand", t, r), ("demand_idx", g, 1), ("upd", k, 1 + r))


def inc_layout(g: int, kd: int, r: int, s: int, u: int, t: int) -> IoLayout:
    """The incremental program's buffer: the permutation, the dirty rows'
    positions, and the dirty gangs' sections."""
    return IoLayout(("perm", g, 1), ("dirty_pos", kd, 1),
                    ("gang", kd, r + 4 + s), ("sig", u, r + 1),
                    ("demand", t, r), ("demand_idx", kd, 1))


def pack_gangs(lay: IoLayout, buf: np.ndarray, total_demand, required_level,
               preferred_level, valid, fairness, sig_idx, u_sig_demand,
               u_sig_mask, demand, demand_idx) -> None:
    """Write the gang, sig, demand and demand_idx sections of `buf`. Rows
    past the given arrays stay as the caller left them (zeros)."""
    n, r = total_demand.shape
    gp = lay.view(buf, "gang")
    gp[:n, :r] = total_demand
    gp[:n, r] = required_level
    gp[:n, r + 1] = preferred_level
    gp[:n, r + 2] = valid
    gp[:n, r + 3] = fairness
    gp[:n, r + 4:] = sig_idx
    up = lay.view(buf, "sig")
    up[: u_sig_demand.shape[0], :r] = u_sig_demand
    up[: u_sig_mask.shape[0], r] = u_sig_mask
    lay.view(buf, "demand")[: demand.shape[0]] = demand
    lay.view(buf, "demand_idx")[:n, 0] = demand_idx


def unpack_gangs(lay: IoLayout, io: torch.Tensor) -> dict:
    """The device-side unpacker of `pack_gangs`: the kernels' per-gang
    operands from the io buffer on the device, each a contiguous tensor of
    the kernels' type."""
    gp = lay.view(io, "gang")
    up = lay.view(io, "sig")
    r = up.shape[1] - 1
    i32 = torch.int32
    return {
        "td": gp[:, :r].contiguous(),
        "required": gp[:, r].to(i32),
        "preferred": gp[:, r + 1].to(i32),
        "valid": gp[:, r + 2] > 0.5,
        "fairness": gp[:, r + 3].contiguous(),
        "sig_idx": gp[:, r + 4:].to(i32),
        "u_dem": up[:, :r],
        "u_mask": up[:, r].to(torch.int64),
        "demand": lay.view(io, "demand").contiguous(),
        "demand_idx": lay.view(io, "demand_idx")[:, 0].to(i32),
    }


def scatter_rows(free: torch.Tensor, upd: torch.Tensor) -> None:
    """K7: write the delta block upd [K, 1+R] (node row | new masked
    values) into the resident free state [N + 1, R] in place. Padding rows
    name row N, the absorbing row no product reads. Counted as one K7
    launch (`replay_counts`) where it runs, and not while a graph is
    captured: a K5 or what-if replay that carries a delta block counts
    its K7."""
    free.index_copy_(0, upd[:, 0].to(torch.int64), upd[:, 1:])
    if not kc.capturing():
        count_eager("K7")


def value_operands(free, statics, masks, p: dict):
    """The value kernel's operands from the masked free state [N, R] and
    the unpacked gang rows: (dom_free [D, R], sig_cnt [U, D], sig_idx,
    dom_level, demand, demand_idx, required, preferred, valid, cap_scale,
    fairness) -- the arguments of `kernel_value_sig`."""
    dom_level, _anc_ids, cap_scale, m = statics[:4]
    dom_free = m.T @ free                                   # [D, R]
    # Node-granularity proxy: per signature (= unique max-pod demand x
    # node-eligibility mask pair), #nodes per domain that fit AND are
    # eligible; a gang's count is the MIN over its signatures, taken by
    # the value kernel (or by gather_min on the non-kernel tier).
    node_fits = (
        (free[None, :, :] + 1e-6 >= p["u_dem"][:, None, :]).all(dim=-1)
        .to(torch.float32) * masks[p["u_mask"]]
    )                                                       # [U, N]
    return (dom_free, node_fits @ m, p["sig_idx"], dom_level, p["demand"],
            p["demand_idx"], p["required"], p["preferred"], p["valid"],
            cap_scale, p["fairness"])


def value_tensor(ops, p: dict, tier: str | None):
    """value [G, D]: the value kernel in precision `tier`, or (tier None)
    the plain arithmetic on the gathered counts and per-gang demand."""
    if tier:
        return kc.kernel_value_sig(*ops, precision=tier)
    dom_free, sig_cnt, sig_idx, dom_level, _, _, *rest = ops
    return value_from_aggregates(dom_free, gather_min(sig_cnt, sig_idx),
                                 dom_level, p["td"], *rest)


def commit(value, dom_free, anc_ids, td, *, top_k: int, chunk: int,
           device_commit: bool) -> torch.Tensor:
    """K2, then K3 on the device-commit tier, packed into ONE [G, 2K] (or
    [G, 2]) f32 tensor for one copy to the host: values, then domain ids
    (exact in f32 below 2^24)."""
    top_val, top_dom = commit_scan(value, dom_free, anc_ids, td, top_k, chunk)
    if device_commit:
        top_val, top_dom = kernel_commit_scan(top_val, top_dom, dom_free,
                                              anc_ids, td)
    return torch.cat([top_val, top_dom.to(torch.float32)], dim=1)


def score_core(free, statics, masks, p: dict, *, top_k: int, chunk: int,
               tier: str | None, device_commit: bool):
    """Shared scoring body of the split, fused and what-if programs (the
    JAX engine's `_score_core`): value tensor, commit scan, device commit.
    Returns (packed, value [G, D], total_demand [G, R])."""
    ops = value_operands(free, statics, masks, p)
    value = value_tensor(ops, p, tier)
    packed = commit(value, ops[0], statics[1], p["td"], top_k=top_k,
                    chunk=chunk, device_commit=device_commit)
    return packed, value, p["td"]


def device_score(free, statics, masks, io, lay: IoLayout, **kw):
    """The SPLIT program (`fused=False`): score only, against the resident
    free state [N + 1, R] as it stands. Returns packed."""
    n = free.shape[0] - 1
    return score_core(free[:n], statics, masks, unpack_gangs(lay, io), **kw)[0]


def fused_score(free, statics, masks, io, lay: IoLayout, **kw):
    """K5, the FUSED program: the io buffer's delta block (if any) applied
    in place to the resident free state [N + 1, R], then `score_core`.
    Returns (packed, value, total_demand); value and total_demand stay on
    the device as the incremental re-solve's caches."""
    if lay.offsets["upd"][1]:
        scatter_rows(free, lay.view(io, "upd"))
    n = free.shape[0] - 1
    return score_core(free[:n], statics, masks, unpack_gangs(lay, io), **kw)


def inc_score(free, value_cache, td_cache, statics, masks, io,
              lay: IoLayout, **kw):
    """K6, the INCREMENTAL program, against the unchanged resident free
    state: the clean rows gathered from the cached value [Gc, D] and
    demand [Gc, R] through `perm` (the dummy index Gc gives a -1e9 value
    row and a zero demand row, what the full program computes for
    padding), the value tensor computed for the dirty rows only and
    written to `dirty_pos` (padding index G: an extra row, sliced off),
    then the commit kernels over the merged matrix. Writes fresh tensors,
    never into the caches it reads. Returns (packed, value [G, D],
    total_demand [G, R])."""
    n = free.shape[0] - 1
    f = free[:n]
    gc = value_cache.shape[0]
    perm = lay.view(io, "perm")[:, 0].to(torch.int64)
    g = perm.shape[0]
    rows = torch.cat([perm, perm.new_full((1,), gc)])      # [G + 1]
    src = rows.clamp(max=gc - 1)
    dummy = (rows == gc)[:, None]
    value = value_cache.index_select(0, src).masked_fill_(dummy, _NEG)
    td = td_cache.index_select(0, src).masked_fill_(dummy, 0.0)
    p = unpack_gangs(lay, io)
    ops = value_operands(f, statics, masks, p)
    dirty_pos = lay.view(io, "dirty_pos")[:, 0].to(torch.int64)
    value.index_copy_(0, dirty_pos, value_tensor(ops, p, kw["tier"]))
    td.index_copy_(0, dirty_pos, p["td"])
    value, td = value[:g], td[:g]
    packed = commit(value, ops[0], statics[1], td, top_k=kw["top_k"],
                    chunk=kw["chunk"], device_commit=kw["device_commit"])
    return packed, value, td


#: CUDA graphs one engine keeps captured, over both programs (fault P2):
#: past this many keys the least recently replayed graph is evicted
GRAPH_KEYS = 12

#: every capture in the process runs under this lock, on one capture
#: stream a device. PyTorch's `torch.cuda.graph` empties the caching
#: allocator when it starts, which must not happen while another thread
#: captures, so two captures never overlap. The captures themselves run in
#: "thread_local" mode: what OTHER threads do meanwhile (a wave's
#: dispatches launching on their engines' streams, the collect loop
#: waiting on events, allocations) neither fails the capture nor lands in
#: it. (The other choice, global mode with a lock that every dispatch of a
#: wave also takes, would serialise the wave's device work behind each
#: capture.) Nothing but a capture ever runs on the capture stream.
_CAPTURE_LOCK = threading.Lock()
_CAPTURE_STREAMS: dict = {}
#: PyTorch hands out its pooled streams round-robin, 32 to a priority, so
#: a wave of more sub-engines than that shares normal-priority streams; a
#: capture stream taken from that pool could be a sub-engine's, whose
#: launches from another thread would land in (and break) the capture. The
#: capture stream is taken from the high-priority pool, which nothing else
#: in this package draws from.
_CAPTURE_PRIORITY = -1


#: graph replays since the last reset, over every engine of the process,
#: by program ("K5" the fused, "K6" the incremental, "whatif" the
#: defragmenter's what-if), and the eager launches of the mesh program
#: ("K8", parallel/sharded.py, never captured): what a caller that does
#: not hold the engines (the scheduler builds and replaces its own)
#: reads, as kernel_core's launch counters are read; under one lock
_REPLAYS = {"K5": 0, "K6": 0, "K7": 0, "whatif": 0, "K8": 0}
#: graph captures since the last reset, by program, counted alike
_CAPTURES = {"K5": 0, "K6": 0, "whatif": 0}
_REPLAY_LOCK = threading.Lock()


def replay_counts() -> dict[str, int]:
    """Graph replays (and K7's and K8's eager launches) since the last
    reset, by program."""
    with _REPLAY_LOCK:
        return dict(_REPLAYS)


def count_eager(program: str) -> None:
    """One eager launch of a program that runs uncaptured (K7 as its own
    launch, K8)."""
    with _REPLAY_LOCK:
        _REPLAYS[program] += 1


def capture_counts() -> dict[str, int]:
    """Graph captures since the last reset, by program."""
    with _REPLAY_LOCK:
        return dict(_CAPTURES)


def reset_replays() -> None:
    """Set every program's replay and capture counts to 0."""
    with _REPLAY_LOCK:
        for counts in (_REPLAYS, _CAPTURES):
            counts.update(dict.fromkeys(counts, 0))


def load_cache(value_in: torch.Tensor, td_in: torch.Tensor, cache) -> int:
    """Copy the incremental cache (value [Gc, D], demand [Gc, R]) into
    K6's static inputs on the current stream, each copy skipped where the
    two already are the same memory. Returns the copies made."""
    copies = 0
    for dst, src in ((value_in, cache[0]), (td_in, cache[1])):
        if dst.data_ptr() != src.data_ptr():
            dst.copy_(src)
            copies += 1
    return copies


class GraphLru:
    """The bounded LRU of one engine's captured graphs: `get` marks a key
    used, `put` adds one and evicts the least recently used keys past
    `bound`, calling `on_evict(key, entry)` for each before it is dropped
    (the engine drops any incremental cache that points into the entry's
    outputs). Holds any entries: the CPU tests drive it with fakes."""

    def __init__(self, bound: int = GRAPH_KEYS, on_evict=None):
        if bound < 1:
            raise ValueError(f"a graph cache keeps at least one key, got {bound}")
        self.bound = bound
        self.on_evict = on_evict
        self.evictions = 0
        self._entries: OrderedDict = OrderedDict()

    def __len__(self):
        return len(self._entries)

    def __contains__(self, key):
        return key in self._entries

    def keys(self) -> list:
        """The keys, least recently used first."""
        return list(self._entries)

    def items(self):
        return list(self._entries.items())

    def get(self, key):
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
        return entry

    def put(self, key, entry) -> None:
        self._entries[key] = entry
        self._entries.move_to_end(key)
        while len(self._entries) > self.bound:
            old_key, old = self._entries.popitem(last=False)
            self.evictions += 1
            if self.on_evict is not None:
                self.on_evict(old_key, old)


class _Captured:
    """One captured program: its graph, its static inputs (and the host
    content each holds), its outputs, and the kernel launches one replay
    makes."""

    __slots__ = ("graph", "io", "io_host", "masks", "masks_host", "value_in",
                 "td_in", "scratch", "outs", "launches", "inc")

    @property
    def program(self) -> str:
        """The replay counters' name of the program: K5, K6 or whatif."""
        if self.inc:
            return "K6"
        return "K5" if self.scratch is None else "whatif"


class FusedGraphs:
    """The fused program K5, the incremental program K6 and the what-if
    program as one CUDA graph per bucket key, on the card, within one
    bounded LRU (GRAPH_KEYS) and one memory pool per engine.

    Keys: K5 (layout -- G, S, U, T and the delta block's K --, the
    eligibility-mask table's rows, precision tier, device commit); K6
    ("inc", layout -- G, the dirty rows, R, S, U, T --, the cache's rows
    Gc, the mask table's rows, tier, device commit); what-if ("whatif",
    then K5's key with device commit False): the counterparts of jit's
    one program per static shape. A what-if graph copies the resident
    free tensor into a static scratch tensor of its own and scores the
    copy (`fused_score`), so it never writes the resident state.

    The first solve of a key runs the program once eagerly, then captures
    it; every later solve copies its io buffer (and a changed mask table)
    into the graph's static inputs, K6 also the current cache into its
    static value and demand inputs (`load_cache`), and replays. K6 gathers
    from those inputs and writes fresh outputs, never into what it reads.
    A failed capture or replay raises: there is no eager fallback.

    The graphs point at the engine's resident free tensor and device
    statics, which the engine never reallocates, and write their outputs
    (packed, value, total_demand) in place on every replay: the caller
    copies packed out right after the replay, on the same stream.

    All of one engine's graphs allocate from ONE private pool
    (`torch.cuda.graph_pool_handle()`): sound only because one engine
    replays its graphs one after another on one stream, so a graph never
    runs while another of the pool's graphs uses the same scratch. Each
    engine has its own pool: the sub-engines of a hierarchical wave replay
    concurrently on their own streams, and must never share one.

    The launch counters of kernel_core count nothing while capturing (the
    capture's launches go to its own counts); a replay adds the captured
    counts, so they count launches on the card."""

    def __init__(self, device: torch.device, on_evict=None):
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self._lru = GraphLru(GRAPH_KEYS, on_evict)
        #: graphs captured, replays run, K5 replays that carried a delta
        #: block, K6 replays, what-if replays, and the kernel launches of
        #: the replays by kernel name
        self.captures = 0
        self.replays = 0
        self.delta_replays = 0
        self.inc_replays = 0
        self.whatif_replays = 0
        self.launches: dict[str, int] = {}
        #: bytes the last `run` copied into static inputs, by kind
        self.last_loads = {"io": 0, "masks": 0}

    def __len__(self):
        return len(self._lru)

    @property
    def evictions(self) -> int:
        return self._lru.evictions

    def entries(self) -> list:
        """(key, entry) pairs, least recently used first."""
        return self._lru.items()

    def _load(self, dst: torch.Tensor, host: np.ndarray | None,
              arr: np.ndarray) -> np.ndarray:
        """Copy `arr` into the static input `dst` unless `host` (what dst
        already holds) is the same content: one pinned buffer, one
        non-blocking H2D (the caching host allocator keeps the pinned
        block until the copy has run). Returns what dst holds now."""
        if host is not None and np.array_equal(host, arr):
            return host
        pinned = torch.empty(arr.shape, dtype=torch.float32, pin_memory=True)
        pinned.numpy()[...] = arr
        dst.copy_(pinned, non_blocking=True)
        return arr.copy()

    def _load_counted(self, dst, host, arr, kind: str) -> np.ndarray:
        """`_load`, adding the bytes it copied to `last_loads[kind]`."""
        held = self._load(dst, host, arr)
        if held is not host:
            self.last_loads[kind] += arr.nbytes
        return held

    def run(self, key: tuple, free, statics, io_np: np.ndarray,
            masks_np: np.ndarray | None, lay: IoLayout, cache=None,
            whatif: bool = False, **kw):
        """Replay (capturing first if new) the program of `key` on these
        inputs: K6 when `cache` (its value and demand tensors) is given,
        the what-if program when `whatif`, else K5; `masks_np` None means
        the statics' all-ones row. Returns the graph's (packed, value,
        total_demand)."""
        entry = self._lru.get(key)
        self.last_loads = {"io": 0, "masks": 0}
        if entry is None:
            entry = self._new_entry(free, statics, io_np, masks_np, lay,
                                    cache, whatif)
            self._capture(entry, free, statics, lay, **kw)
            with _REPLAY_LOCK:
                _CAPTURES[entry.program] += 1
            self._lru.put(key, entry)   # may evict the least recent key
        else:
            entry.io_host = self._load_counted(entry.io, entry.io_host,
                                               io_np, "io")
            if masks_np is not None:
                entry.masks_host = self._load_counted(
                    entry.masks, entry.masks_host, masks_np, "masks")
            if entry.inc:
                load_cache(entry.value_in, entry.td_in, cache)
            entry.graph.replay()
        kc.add_launches(entry.launches)
        self.replays += 1
        program = entry.program
        with _REPLAY_LOCK:
            _REPLAYS[program] += 1
        if program == "K6":
            self.inc_replays += 1
        else:
            # K5 and the what-if run fused_score: K7 on a delta block
            delta = bool(lay.offsets["upd"][1])
            if program == "whatif":
                self.whatif_replays += 1
            else:
                self.delta_replays += delta
            if delta:
                with _REPLAY_LOCK:
                    _REPLAYS["K7"] += 1
        for name, n in entry.launches.items():
            self.launches[name] = self.launches.get(name, 0) + n
        return entry.outs

    def _new_entry(self, free, statics, io_np, masks_np, lay, cache,
                   whatif: bool = False):
        """A key's static inputs (a what-if's scratch copy of the free
        state among them), allocated outside the pool (so no graph's
        scratch ever lands on them) and filled."""
        entry = _Captured()
        entry.inc = cache is not None
        entry.scratch = torch.empty_like(free) if whatif else None
        entry.io = torch.empty((lay.size,), dtype=torch.float32,
                               device=self.device)
        entry.io_host = self._load_counted(entry.io, None, io_np, "io")
        if masks_np is None:
            entry.masks, entry.masks_host = statics[4], None
        else:
            entry.masks = torch.empty(masks_np.shape, dtype=torch.float32,
                                      device=self.device)
            entry.masks_host = self._load_counted(entry.masks, None,
                                                  masks_np, "masks")
        entry.value_in = entry.td_in = None
        if entry.inc:
            entry.value_in = torch.empty_like(cache[0])
            entry.td_in = torch.empty_like(cache[1])
            load_cache(entry.value_in, entry.td_in, cache)
        return entry

    def _program(self, entry, free, statics, lay, **kw):
        if entry.inc:
            return inc_score(free, entry.value_in, entry.td_in, statics,
                             entry.masks, entry.io, lay, **kw)
        if entry.scratch is not None:
            # the what-if: score a copy, never the resident state
            free = entry.scratch.copy_(free)
        return fused_score(free, statics, entry.masks, entry.io, lay, **kw)

    def _capture(self, entry, free, statics, lay, **kw):
        """Warm up (one eager run: the kernels' attribute and occupancy
        calls, cuBLAS's workspace for the capture stream) and capture, both
        on the device's capture stream under the capture lock, then replay
        once on the caller's stream."""
        cur = torch.cuda.current_stream(self.device)
        entry.graph = torch.cuda.CUDAGraph()
        with _CAPTURE_LOCK:
            # no cyclic garbage collection while capturing (a collection
            # could free an unreachable engine's graphs or events here, a
            # CUDA call that invalidates the capture); toggled under the
            # lock, since the switch is process-wide
            collecting = gc.isenabled()
            gc.disable()
            try:
                cap = _CAPTURE_STREAMS.get(self.device)
                if cap is None:
                    cap = _CAPTURE_STREAMS[self.device] = torch.cuda.Stream(
                        self.device, priority=_CAPTURE_PRIORITY)
                cap.wait_stream(cur)
                with torch.cuda.stream(cap):
                    # its launches are real and count
                    self._program(entry, free, statics, lay, **kw)
                with kc.capture_counts() as counts, torch.cuda.graph(
                    entry.graph, pool=self.pool, stream=cap,
                    capture_error_mode="thread_local",
                ):
                    entry.outs = self._program(entry, free, statics, lay,
                                               **kw)
                cur.wait_stream(cap)
            finally:
                if collecting:
                    gc.enable()
        entry.launches = counts
        self.captures += 1
        entry.graph.replay()
