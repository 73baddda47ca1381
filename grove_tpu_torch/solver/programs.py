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
  only, then the commit kernels over the merged matrix.
- `scatter_rows` (K7) -- `_scatter_rows_impl` (:549): the delta update.

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
    name row N, the absorbing row no product reads."""
    free.index_copy_(0, upd[:, 0].to(torch.int64), upd[:, 1:])


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


class _Captured:
    """One captured fused program: its graph, its static input buffers
    (and the host content each holds), its outputs, and the kernel
    launches one replay makes."""

    __slots__ = ("graph", "io", "io_host", "masks", "masks_host", "outs",
                 "launches")


class FusedGraphs:
    """The fused program as one CUDA graph per bucket key, on the card.

    The key is (layout -- G, S, U, T and the delta block's K --, the
    eligibility-mask table's rows, precision tier, device commit), the
    counterpart of jit's one program per static shape. The first solve of
    a key runs the program once eagerly on a side stream (the kernels'
    one-time attribute and occupancy calls, cuBLAS's workspace), then
    captures it; every solve of the key then copies its io buffer (and a
    changed mask table) into the graph's static inputs and replays it. A
    failed capture or replay raises: there is no eager fallback.

    The graph points at the engine's resident free tensor and device
    statics, which the engine never reallocates, and writes its outputs
    (packed, value, total_demand) in place on every replay: the caller
    copies packed out right after the replay, on the same stream. The
    launch counters of kernel_core are Python integers that move once
    while capturing; a replay adds the captured counts, so they count
    launches on the card."""

    def __init__(self, device: torch.device):
        self.device = device
        self._entries: dict[tuple, _Captured] = {}
        #: graphs captured, replays run, replays that carried a delta
        #: block, and the kernel launches of the replays by kernel name
        self.captures = 0
        self.replays = 0
        self.delta_replays = 0
        self.launches: dict[str, int] = {}

    def __len__(self):
        return len(self._entries)

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

    def run(self, key: tuple, free, statics, io_np: np.ndarray,
            masks_np: np.ndarray | None, lay: IoLayout, **kw):
        """Replay (capturing first if new) the fused program of `key` on
        these inputs; `masks_np` None means the statics' all-ones row.
        Returns the graph's (packed, value, total_demand)."""
        entry = self._entries.get(key)
        if entry is None:
            entry = self._capture(key, free, statics, io_np, masks_np, lay,
                                  **kw)
        else:
            entry.io_host = self._load(entry.io, entry.io_host, io_np)
            if masks_np is not None:
                entry.masks_host = self._load(entry.masks, entry.masks_host,
                                              masks_np)
            entry.graph.replay()
        kc.add_launches(entry.launches)
        self.replays += 1
        self.delta_replays += bool(lay.offsets["upd"][1])
        for name, n in entry.launches.items():
            self.launches[name] = self.launches.get(name, 0) + n
        return entry.outs

    def _capture(self, key, free, statics, io_np, masks_np, lay, **kw):
        entry = _Captured()
        entry.io = torch.empty((lay.size,), dtype=torch.float32,
                               device=self.device)
        entry.io_host = self._load(entry.io, None, io_np)
        if masks_np is None:
            entry.masks, entry.masks_host = statics[4], None
        else:
            entry.masks = torch.empty(masks_np.shape, dtype=torch.float32,
                                      device=self.device)
            entry.masks_host = self._load(entry.masks, None, masks_np)
        # warm-up: one eager run on a side stream, as PyTorch's graph
        # rules ask (its launches are real and count)
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            fused_score(free, statics, entry.masks, entry.io, lay, **kw)
        cur.wait_stream(side)
        before = kc.launch_counts()
        entry.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(entry.graph):
            entry.outs = fused_score(free, statics, entry.masks, entry.io,
                                     lay, **kw)
        after = kc.launch_counts()
        # capturing launched nothing: take its counts back, and add them
        # per replay instead
        entry.launches = {k: after[k] - before[k] for k in after}
        kc.add_launches({k: -v for k, v in entry.launches.items()})
        self.captures += 1
        entry.graph.replay()
        self._entries[key] = entry
        return entry
