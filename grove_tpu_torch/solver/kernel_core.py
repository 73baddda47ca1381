"""Kernel tier of the scoring core, for Hopper.

The counterpart of grove_tpu/solver/pallas_core.py. Three hand-written
CUDA kernels (sources in grove_tpu_torch/csrc/, built by
grove_tpu_torch/build.py for sm_90a and called through ctypes), each
beside its plain PyTorch twin:

- `kernel_value_sig` (csrc/value_kernel.cu) replaces `_value_kernel` /
  `pallas_value` together with the gather and min that feed it: the
  [G, D] value tensor straight from the per-signature fit counts
  `sig_cnt` [U, D] and each gang's signature rows `sig_idx` [G, S],
  and the gangs' demand rows deduped into a table [T, R] with each gang's
  row `demand_idx` [G] -- the count test (min over S >= 1), hierarchy
  mask, per-level score, preference bonus, squashed best-fit slack and
  fairness offset in one pass, in either precision. Its plain twins
  `value_sig_plain` / `value_sig_plain_bf16` gather and take the min,
  then run `value_plain` / `value_plain_bf16`. `kernel_value` is the same
  kernel behind the interface of the earlier slices, the S = 1 case: it
  takes a [G, D] `cnt_fit` (as `sig_cnt`, with `sig_idx = arange(G)`)
  and a demand row a gang. fp32:
  `value_plain` keeps the arithmetic and operation order of
  `value_from_aggregates`, so kernel and twin are bit-equal (and
  bit-equal to the JAX package). bf16: `value_plain_bf16` is a chain of
  bf16 torch ops, each computed in fp32 and rounded to bf16; the kernel
  rounds at the same places and is bit-equal to it. Against JAX's bf16
  tier it is score-equal, not bit-equal (XLA rounds at other places).
- `kernel_commit_topk` (csrc/commit_topk.cu) replaces the chunked
  `commit_scan` (grove_tpu/solver/engine.py, a `lax.scan` over
  `lax.top_k`), the murmur tie jitter included: per chunk of gangs, each
  gang's top-k residually feasible domains, then the chunk's first
  choices committed down their ancestor chains in row order. Its plain
  twin is `commit_topk_plain` (`tie_jitter`, then the chunk loop).
- `kernel_commit_scan` (csrc/commit_scan.cu) replaces `device_commit_scan`:
  the greedy walk over each gang's packed top-k against a residual
  aggregate-capacity mirror, shipping one committed (value, domain) pair
  per gang. Its plain twin is `device_commit_scan_plain`.

A wrapper takes its plain version only for tensors that lie on the CPU --
the CPU tests, the counterpart of JAX's interpret mode. For a CUDA tensor
it launches the kernel or raises: a failed build, a refused launch or an
unsupported shape is an error, never a silent fallback. Each wrapper
counts the launches of its kernel, only where it launches it, by
`count_launch` into one dict keyed by kernel name under one lock, so the
threads of a hierarchical wave lose no count; `launch_counts()` reads it,
`reset_launches()` sets it to 0, and `add_launches()` adds the launches a
replayed CUDA graph made without calling the wrappers. A launch made
while the calling thread captures a graph (inside `capture_counts()`)
runs nothing: it goes to that capture's own counts instead, which the
graph's owner adds per replay.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

from ..build import load

_NEG = -1e9
_U32 = 0xFFFFFFFF

#: the device-commit kernel gives one lane of its walker warp to each
#: candidate (the feasibility test)
_WARP = 32

#: shared memory one block may use on Hopper (227 KB); both commit
#: kernels keep their residual there while it fits (`topk_layout`,
#: `scan_layout`)
_SMEM_BYTES = 232448

#: the commit top-k kernel keeps a sorted list of up to this many keys per
#: thread (the engine asks for 8)
_TOPK_MAX = 32

#: the commit top-k kernel's threads per block, and so its warp lists
_TOPK_WARPS = 512 // _WARP

#: the device-commit kernel's ring: slots of gangs staged ahead of the walker
_RING_SLOTS, _RING_TILE = 3, 64

_VALUE_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_COMMIT_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_TOPK_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]

#: value-kernel precisions and their C entry points
_VALUE_ENTRY = {"fp32": "grove_value_sig", "bf16": "grove_value_sig_bf16"}


def value_plain(
    dom_free,         # f32 [D, R] aggregate free per domain
    cnt_fit,          # f32 [G, D] #nodes per domain fitting the max pod
    dom_level,        # i32 [D]
    total_demand,     # f32 [G, R]
    required_level,   # i32 [G]
    preferred_level,  # i32 [G]
    valid,            # bool [G]
    cap_scale,        # f32 [R]
    fairness=None,    # f32 [G] per-gang tenant fairness weight (or None)
):
    """value[G, D], plain PyTorch: pack narrowness dominates (it IS the
    placement score), then a bonus for satisfying the preferred level,
    minus normalized slack so tight domains win ties (best-fit at domain
    granularity), plus the gang's fairness offset. Pairs that are
    statically infeasible or hierarchy-violating get -1e9. The operations
    and their order are those of grove_tpu's value_from_aggregates."""
    # Hierarchy mask: gangs may only use domains at least as narrow as their
    # required level; the root (-1) only when unconstrained.
    allowed = dom_level[None, :] >= required_level[:, None]
    # Per-level value gap is 2.5, strictly above the worst-case competing
    # swing (pref bonus 1.0 + squashed slack 1.0): pack narrowness stays
    # lexicographically dominant.
    level_score = 2.5 * (dom_level.to(torch.float32) + 2.0)
    pref_bonus = (dom_level[None, :] >= preferred_level[:, None]).to(torch.float32)
    slack = None
    for res in range(dom_free.shape[1]):
        # the divisor stays a tensor on the inputs' device: CUDA PyTorch
        # turns a division by a CPU scalar into a multiplication by its
        # reciprocal, which rounds differently from the kernel's division
        cur = (dom_free[:, res][None, :] - total_demand[:, res][:, None]) / cap_scale[res]
        slack = cur if slack is None else torch.maximum(slack, cur)
    slack = slack / (1.0 + torch.abs(slack))  # squash: ordering, not magnitude
    value = level_score[None, :] + 1.0 * pref_bonus - 0.5 * slack
    if fairness is not None:
        value = value + fairness[:, None]
    static_mask = (cnt_fit >= 1.0) & allowed & valid[:, None]
    return torch.where(static_mask, value, _NEG)


def value_plain_bf16(
    dom_free, cnt_fit, dom_level, total_demand, required_level,
    preferred_level, valid, cap_scale, fairness=None,
):
    """value[G, D], plain PyTorch, reduced precision: the operations and
    order of `value_plain` with the score chain in bf16, cast where JAX's
    bf16 kernel tier casts it (pallas_core.py `acc = jnp.bfloat16`):
    dom_level, the constants, dom_free, total_demand, cap_scale and
    fairness become bf16 first, and every op rounds its result to bf16
    (PyTorch computes a bf16 elementwise op in fp32 and rounds to nearest
    even). The mask stays fp32-exact and the output is f32."""
    bf16 = torch.bfloat16
    allowed = dom_level[None, :] >= required_level[:, None]
    level_score = 2.5 * (dom_level.to(bf16) + 2.0)
    pref_bonus = (dom_level[None, :] >= preferred_level[:, None]).to(bf16)
    slack = None
    for res in range(dom_free.shape[1]):
        # the divisor stays a device tensor, as in value_plain
        cur = (dom_free[:, res].to(bf16)[None, :]
               - total_demand[:, res].to(bf16)[:, None]) / cap_scale[res].to(bf16)
        slack = cur if slack is None else torch.maximum(slack, cur)
    slack = slack / (1.0 + torch.abs(slack))
    value = level_score[None, :] + 1.0 * pref_bonus - 0.5 * slack
    if fairness is not None:
        value = value + fairness.to(bf16)[:, None]
    static_mask = (cnt_fit >= 1.0) & allowed & valid[:, None]
    return torch.where(static_mask, value.to(torch.float32), _NEG)


#: the plain twin of the value kernel's S = 1 interface, by precision
VALUE_PLAIN = {"fp32": value_plain, "bf16": value_plain_bf16}


def gather_min(sig_cnt, sig_idx):
    """cnt_fit [G, D] = min over S of sig_cnt[sig_idx[g, s]]: each gang's
    per-domain count of nodes that fit, the least over its signatures."""
    return sig_cnt[sig_idx.long()].amin(dim=1)


def value_sig_plain(dom_free, sig_cnt, sig_idx, dom_level, demand, demand_idx,
                    required_level, preferred_level, valid, cap_scale,
                    fairness=None):
    """value[G, D] from the per-signature fit counts (sig_cnt f32 [U, D],
    sig_idx i32 [G, S]) and the demand table (demand f32 [T, R],
    demand_idx i32 [G]), plain PyTorch: the gathers and the min, then
    `value_plain`."""
    return value_plain(dom_free, gather_min(sig_cnt, sig_idx), dom_level,
                       demand[demand_idx.long()], required_level,
                       preferred_level, valid, cap_scale, fairness)


def value_sig_plain_bf16(dom_free, sig_cnt, sig_idx, dom_level, demand,
                         demand_idx, required_level, preferred_level, valid,
                         cap_scale, fairness=None):
    """`value_sig_plain` with the score chain of `value_plain_bf16`."""
    return value_plain_bf16(dom_free, gather_min(sig_cnt, sig_idx), dom_level,
                            demand[demand_idx.long()], required_level,
                            preferred_level, valid, cap_scale, fairness)


#: the plain twin of the fused value kernel, by precision
VALUE_SIG_PLAIN = {"fp32": value_sig_plain, "bf16": value_sig_plain_bf16}


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32): the constant is split
    into 16-bit halves so no partial product leaves int64 (torch has no
    uint32 arithmetic to wrap for us)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _U32


def tie_jitter(g: int, d: int, device) -> torch.Tensor:
    """[G, D] f32 deterministic tie-break jitter in [0, 1e-4), far below
    the value function's quanta: murmur-style uint32 hash mixing of
    (gang row, domain), computed in int64 masked to 32 bits. Bit-equal to
    the JAX engine's uint32 jitter (and to the commit top-k kernel's)."""
    gi = torch.arange(g, dtype=torch.int64, device=device)[:, None]
    di = torch.arange(d, dtype=torch.int64, device=device)[None, :]
    h = (_mul_u32(gi, 0x9E3779B1) + _mul_u32(di, 0x85EBCA77)) & _U32
    h = h ^ (h >> 13)
    h = _mul_u32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return 1e-4 * (h.to(torch.float32) / 2.0 ** 32)


def commit_topk_plain(value, dom_free, anc_ids, total_demand, top_k: int,
                      chunk: int):
    """The chunked commit scan, plain PyTorch: the tie jitter is added to
    every live value (> -5e8); then gangs `chunk` rows at a time (the last
    chunk may be shorter) each keep their top_k domains that are
    residually feasible against the chunk-start residual (`+ 1e-6`
    epsilon; infeasible domains score -1e9), ordered by value descending
    then index ascending as lax.top_k orders them; then every row's first
    choice (if its value > -5e8) subtracts the row's demand from the
    domain's ancestor chain, rows in order and chains in order (JAX's
    flattened [C, L+1] scatter). Returns (top_val [G, K] f32, top_dom
    [G, K] i32).

    On the CPU the scatter-add runs in that order. On CUDA, index_add_
    adds with atomics in no fixed order, so the card's result may differ
    in the last bit wherever demands are not dyadic: the card runs
    `kernel_commit_topk` instead."""
    g_total, d = value.shape
    jittered = torch.where(value > _NEG / 2,
                           value + tie_jitter(g_total, d, value.device), value)
    r = dom_free.shape[1]
    resid = torch.cat([dom_free, dom_free.new_zeros((1, r))], dim=0)
    l1 = anc_ids.shape[1]
    top_val = torch.empty((g_total, top_k), dtype=torch.float32,
                          device=jittered.device)
    top_dom = torch.empty((g_total, top_k), dtype=torch.int32,
                          device=jittered.device)
    for start in range(0, g_total, chunk):
        gs = slice(start, start + chunk)
        td = total_demand[gs]                                   # [C, R]
        fits = ((resid[:d] + 1e-6)[None, :, :] >= td[:, None, :]).all(dim=-1)
        rows = torch.where(fits, jittered[gs], _NEG)            # [C, D]
        # lax.top_k puts the lower index first among equal values, and
        # masked -1e9 entries tie by the thousand; torch.topk promises no
        # order among ties, a stable descending sort gives lax's
        vals, idx = torch.sort(rows, dim=1, descending=True, stable=True)
        best_val, best_dom = vals[:, :top_k], idx[:, :top_k]
        choice = best_dom[:, 0]
        ok = best_val[:, 0] > _NEG / 2
        chains = torch.where(ok[:, None], anc_ids[choice], d)   # [C, L+1]
        resid.index_add_(0, chains.reshape(-1),
                         (-td).repeat_interleave(l1, dim=0))
        top_val[gs] = best_val
        top_dom[gs] = best_dom.to(torch.int32)
    return top_val, top_dom


def device_commit_scan_plain(top_val, top_dom, dom_free, anc_ids, total_demand):
    """Greedy commit over the packed top-k, plain PyTorch, one gang at a
    time: gangs in priority order (= row order) each take the FIRST
    candidate that is still residually feasible at aggregate granularity
    (`+ 1e-6` epsilon, value > -5e8), committing demand up the ancestor
    chain. Rows with no feasible candidate carry -1e9 and their first
    candidate's domain. Returns ([G, 1] f32 value, [G, 1] i32 domain)."""
    g, _k = top_val.shape
    d, r = dom_free.shape
    resid = torch.cat([dom_free, dom_free.new_zeros((1, r))], dim=0)
    sink = torch.full((anc_ids.shape[1],), d, dtype=anc_ids.dtype,
                      device=anc_ids.device)
    out_val = torch.empty((g, 1), dtype=torch.float32, device=top_val.device)
    out_dom = torch.empty((g, 1), dtype=torch.int32, device=top_val.device)
    for i in range(g):
        vals, doms, td = top_val[i], top_dom[i], total_demand[i]
        fits = (resid[doms] + 1e-6 >= td[None, :]).all(dim=-1)
        fits = fits & (vals > _NEG / 2)
        # jnp.argmax on bool: the first True, or 0 when there is none
        k = int(torch.argmax(fits.to(torch.int32)))
        ok = bool(fits.any())
        choice = doms[k]
        chain = anc_ids[choice.long()] if ok else sink
        resid.index_add_(0, chain, (-td)[None, :].expand(chain.shape[0], r))
        out_val[i, 0] = vals[k] if ok else _NEG
        out_dom[i, 0] = choice
    return out_val, out_dom


def _launches_kernel(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (take the plain version); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(
            f"kernels run on CUDA devices (plain versions on the CPU); "
            f"got a tensor on {t.device}"
        )
    return True


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc}")


def _check_precision(precision: str) -> None:
    if precision not in VALUE_PLAIN:
        raise ValueError(
            f"precision must be 'fp32' or 'bf16', got {precision!r}"
        )


def _launch_value(dom_free, sig_cnt, sig_idx, dom_level, demand, demand_idx,
                  required_level, preferred_level, valid, cap_scale, fairness,
                  precision: str):
    """Check the operands of csrc/value_kernel.cu and launch it on CUDA
    tensors; returns the [G, D] f32 value tensor."""
    if sig_cnt.dim() != 2 or sig_idx.dim() != 2 or dom_free.dim() != 2 \
            or demand.dim() != 2:
        raise ValueError("value kernel: dom_free, sig_cnt, sig_idx and demand "
                         "must be 2-D")
    u, d = sig_cnt.shape
    g, s = sig_idx.shape
    t, r = demand.shape
    if r < 1 or u < 1 or s < 1 or t < 1:
        raise ValueError(
            f"value kernel needs at least one resource, signature, "
            f"signature per gang and demand row, got R={r}, U={u}, S={s}, "
            f"T={t}"
        )
    if max(g * s, u * d, g * d, d * r, t * r) >= 2**31:
        raise ValueError("value kernel: a dimension product is above 2**31")
    dev = sig_cnt.device
    f32, i32 = torch.float32, torch.int32
    _check("dom_free", dom_free, f32, (d, r), dev)
    _check("sig_cnt", sig_cnt, f32, (u, d), dev)
    _check("sig_idx", sig_idx, i32, (g, s), dev)
    _check("dom_level", dom_level, i32, (d,), dev)
    _check("demand", demand, f32, (t, r), dev)
    _check("demand_idx", demand_idx, i32, (g,), dev)
    _check("required_level", required_level, i32, (g,), dev)
    _check("preferred_level", preferred_level, i32, (g,), dev)
    _check("valid", valid, torch.bool, (g,), dev)
    _check("cap_scale", cap_scale, f32, (r,), dev)
    _check("fairness", fairness, f32, (g,), dev)
    out = torch.empty((g, d), dtype=f32, device=dev)
    fn = getattr(load("value_kernel"), _VALUE_ENTRY[precision])
    fn.argtypes, fn.restype = _VALUE_ARGTYPES, ctypes.c_int
    rc = fn(_ptr(dom_free), _ptr(sig_cnt), _ptr(sig_idx), _ptr(dom_level),
            _ptr(demand), _ptr(demand_idx), _ptr(required_level),
            _ptr(preferred_level), _ptr(valid), _ptr(cap_scale),
            _ptr(fairness), _ptr(out), g, d, r, u, s, t, _stream(dev))
    _raise_on(rc, f"value kernel ({precision})")
    return out


def kernel_value_sig(dom_free, sig_cnt, sig_idx, dom_level, demand,
                     demand_idx, required_level, preferred_level, valid,
                     cap_scale, fairness, *, precision: str = "fp32"):
    """value[G, D] via csrc/value_kernel.cu in `precision` ("fp32" or
    "bf16") from the per-signature fit counts, sig_cnt f32 [U, D] and
    sig_idx i32 [G, S], and the demand table, demand f32 [T, R] and
    demand_idx i32 [G] (gang g's demand is demand[demand_idx[g]]). The
    kernel computes a demand row's score chain once per domain where
    T <= 8, so pass the rows deduped (`engine.demand_table`). Every sig_idx
    entry must lie in [0, U) and every demand_idx entry in [0, T) (the
    caller checks: the kernel writes -1e9
    over a row with an index outside, where the plain version raises).
    The drop-in for `value_sig_plain` / `value_sig_plain_bf16`; fairness
    is required. Plain version for CPU tensors; for CUDA tensors, the
    kernel."""
    _check_precision(precision)
    if not _launches_kernel(sig_cnt):
        return VALUE_SIG_PLAIN[precision](dom_free, sig_cnt, sig_idx,
                                          dom_level, demand, demand_idx,
                                          required_level, preferred_level,
                                          valid, cap_scale, fairness)
    out = _launch_value(dom_free, sig_cnt, sig_idx, dom_level, demand,
                        demand_idx, required_level, preferred_level, valid,
                        cap_scale, fairness, precision)
    count_launch("value_sig_kernel" + _SUFFIX[precision])
    return out



def kernel_value(dom_free, cnt_fit, dom_level, total_demand, required_level,
                 preferred_level, valid, cap_scale, fairness, *,
                 precision: str = "fp32"):
    """value[G, D] via csrc/value_kernel.cu in `precision` ("fp32" or
    "bf16") from a gathered cnt_fit [G, D]: the drop-in for `value_plain`
    / `value_plain_bf16` (fairness is required), and the S = 1 case of
    `kernel_value_sig` (sig_cnt = cnt_fit, sig_idx = arange(G), a demand
    row a gang). Plain version for CPU tensors; for CUDA tensors, the
    kernel."""
    _check_precision(precision)
    if not _launches_kernel(cnt_fit):
        return VALUE_PLAIN[precision](dom_free, cnt_fit, dom_level,
                                      total_demand, required_level,
                                      preferred_level, valid, cap_scale,
                                      fairness)
    if cnt_fit.dim() != 2:
        raise ValueError("value kernel: cnt_fit must be 2-D")
    rows = torch.arange(cnt_fit.shape[0], dtype=torch.int32,
                        device=cnt_fit.device)
    out = _launch_value(dom_free, cnt_fit, rows[:, None], dom_level,
                        total_demand, rows, required_level, preferred_level,
                        valid, cap_scale, fairness, precision)
    count_launch("value_kernel" + _SUFFIX[precision])
    return out



#: bits of the commit kernels' `layout` argument: the residual (both
#: kernels) and the row (commit top-k) in shared memory; a clear bit puts
#: it in global memory
_RESID, _ROW = 1, 2


def _topk_smem(d: int, r: int, k: int, layout: int) -> int:
    """Shared memory the commit top-k kernel asks for: its warps' top-k
    lists, the residual and the row where `layout` keeps them there, and
    the gang's demand row."""
    return _TOPK_WARPS * k * 8 + ((d * r if layout & _RESID else 0)
                                  + (d if layout & _ROW else 0) + r) * 4


def _scan_smem(d: int, r: int, k: int, l1: int, layout: int) -> int:
    """Shared memory the device-commit kernel asks for: the residual where
    `layout` keeps it there, and the ring of staged gangs."""
    return ((d * r if layout & _RESID else 0)
            + _RING_SLOTS * _RING_TILE * (2 * k + r + k * l1)) * 4


def topk_layout(d: int, r: int, k: int, resid_shared=None,
                row_shared=None) -> int:
    """The commit top-k kernel's `layout` argument at D domains, R
    resources and K candidates. Each None keeps its working set in the
    227 KB of shared memory a block holds while it fits: the residual copy
    leaves first (D above ~14.4k at R = 3), the row second (D above
    ~57k). Every layout gives the same bits. Raises ValueError only when
    the caller asks for shared memory that does not fit. Pure: testable
    on the CPU."""
    if resid_shared is None:
        resid_shared = _topk_smem(d, r, k, _RESID | _ROW) <= _SMEM_BYTES
    if row_shared is None:
        row_shared = resid_shared or _topk_smem(d, r, k, _ROW) <= _SMEM_BYTES
    layout = _RESID * bool(resid_shared) | _ROW * bool(row_shared)
    smem = _topk_smem(d, r, k, layout)
    if smem > _SMEM_BYTES:
        raise ValueError(
            f"commit top-k kernel asked to keep {'the residual ' * resid_shared}"
            f"{'the row ' * row_shared}in shared memory at D={d}, R={r}: "
            f"{smem} bytes, above the {_SMEM_BYTES} a block holds"
        )
    return layout


def scan_layout(d: int, r: int, k: int, l1: int, resid_shared=None) -> int:
    """The device-commit kernel's `layout` argument at D domains, R
    resources, K candidates and L + 1 chain entries. None keeps the
    residual in shared memory while it fits beside the ring of staged
    gangs (D up to ~15.6k at L + 1 = 5). Both layouts give the same bits.
    Raises ValueError when the caller asks for shared memory that does not
    fit, or when the ring alone does not (R or L + 1 in the hundreds).
    Pure: testable on the CPU."""
    if resid_shared is None:
        resid_shared = _scan_smem(d, r, k, l1, _RESID) <= _SMEM_BYTES
    layout = _RESID * bool(resid_shared)
    smem = _scan_smem(d, r, k, l1, layout)
    if smem > _SMEM_BYTES:
        raise ValueError(
            f"commit kernel keeps {'the residual and ' * resid_shared}a ring "
            f"of {_RING_SLOTS} x {_RING_TILE} staged gangs ({r} resources, "
            f"{l1} chain entries) in shared memory: {smem} bytes, above the "
            f"{_SMEM_BYTES} a block holds"
        )
    return layout


def kernel_commit_topk(value, dom_free, anc_ids, total_demand,
                       top_k: int, chunk: int, *, resid_shared=None,
                       row_shared=None):
    """(top_val [G, K] f32, top_dom [G, K] i32) via csrc/commit_topk.cu
    (the drop-in for `commit_topk_plain`), from the UN-jittered value
    tensor: the kernel adds the tie jitter itself. Plain version for CPU
    tensors; for CUDA tensors, the kernel: one cooperative launch whose
    blocks (one per chunk row, all co-resident) select in parallel and
    commit each chunk, so the residual is the same on every run.

    `resid_shared` / `row_shared` (None: `topk_layout`'s choice) say
    whether the residual copies and the row live in shared memory; a
    residual in global memory gets a [blocks, D, R] scratch from
    `torch.empty` (inside a graph capture, from the graph's pool). Asking
    for shared memory that does not fit raises ValueError. Every layout
    gives the same bits; the tests pass them to compare.

    Precondition: column j of `anc_ids` holds only domains of level j - 1
    (as `DomainSpace` builds it, and checks). The kernel commits a chunk
    column by column, each column's domains in row order, which equals
    the row-major scatter only when no domain appears in two columns."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if not _launches_kernel(value):
        return commit_topk_plain(value, dom_free, anc_ids, total_demand,
                                 top_k, chunk)
    g, d = value.shape
    r = dom_free.shape[1]
    l1 = anc_ids.shape[1]
    if not (1 <= top_k <= min(_TOPK_MAX, d)):
        raise ValueError(
            f"commit top-k kernel keeps 1..min({_TOPK_MAX}, D={d}) candidates, "
            f"got {top_k}"
        )
    if r < 1:
        raise ValueError("commit top-k kernel needs at least one resource")
    layout = topk_layout(d, r, top_k, resid_shared, row_shared)
    dev = value.device
    f32, i32 = torch.float32, torch.int32
    _check("value", value, f32, (g, d), dev)
    _check("dom_free", dom_free, f32, (d, r), dev)
    _check("anc_ids", anc_ids, i32, (d, l1), dev)
    _check("total_demand", total_demand, f32, (g, r), dev)
    top_val = torch.empty((g, top_k), dtype=f32, device=dev)
    top_dom = torch.empty((g, top_k), dtype=i32, device=dev)
    scratch = None
    if not layout & _RESID:
        scratch = torch.empty((min(chunk, g), d, r), dtype=f32, device=dev)
    fn = load("commit_topk").grove_commit_topk
    fn.argtypes, fn.restype = _TOPK_ARGTYPES, ctypes.c_int
    rc = fn(_ptr(value), _ptr(dom_free), _ptr(anc_ids), _ptr(total_demand),
            _ptr(top_val), _ptr(top_dom),
            None if scratch is None else _ptr(scratch),
            g, d, r, l1, top_k, chunk, layout, _stream(dev))
    _raise_on(rc, "commit top-k kernel")
    add_launches({"commit_topk": 1,
                  "commit_topk_global": int(not layout & _RESID)})
    return top_val, top_dom



def kernel_commit_scan(top_val, top_dom, dom_free, anc_ids, total_demand,
                       *, resid_shared=None):
    """([G, 1] committed value, [G, 1] committed domain) via
    csrc/commit_scan.cu (the drop-in for `device_commit_scan_plain`).
    Plain version for CPU tensors; for CUDA tensors, the kernel: one block
    whose walker warp decrements a chain's cells all at once, which needs
    the chains to name each domain at most once (true of an `anc_ids`
    built by `DomainSpace`, which checks its columns).

    `resid_shared` (None: `scan_layout`'s choice) says whether the
    residual lives in shared memory or in a [D, R] scratch from
    `torch.empty`; the ring of staged gangs is always in shared memory.
    Both layouts give the same bits."""
    if not _launches_kernel(top_val):
        return device_commit_scan_plain(top_val, top_dom, dom_free, anc_ids,
                                        total_demand)
    g, k = top_val.shape
    d, r = dom_free.shape
    l1 = anc_ids.shape[1]
    if not (1 <= k <= _WARP and r >= 1):
        raise ValueError(
            f"commit kernel gives each candidate a lane: 1..{_WARP} "
            f"candidates and at least one resource, got {k} and {r}"
        )
    layout = scan_layout(d, r, k, l1, resid_shared)
    dev = top_val.device
    f32, i32 = torch.float32, torch.int32
    _check("top_val", top_val, f32, (g, k), dev)
    _check("top_dom", top_dom, i32, (g, k), dev)
    _check("dom_free", dom_free, f32, (d, r), dev)
    _check("anc_ids", anc_ids, i32, (d, l1), dev)
    _check("total_demand", total_demand, f32, (g, r), dev)
    out_val = torch.empty((g, 1), dtype=f32, device=dev)
    out_dom = torch.empty((g, 1), dtype=i32, device=dev)
    scratch = None
    if not layout:
        scratch = torch.empty((d, r), dtype=f32, device=dev)
    fn = load("commit_scan").grove_commit_scan
    fn.argtypes, fn.restype = _COMMIT_ARGTYPES, ctypes.c_int
    rc = fn(_ptr(top_val), _ptr(top_dom), _ptr(dom_free), _ptr(anc_ids),
            _ptr(total_demand), _ptr(out_val), _ptr(out_dom),
            None if scratch is None else _ptr(scratch),
            g, k, d, r, l1, layout, _stream(dev))
    _raise_on(rc, "commit-scan kernel")
    add_launches({"commit_scan": 1, "commit_scan_global": int(not layout)})
    return out_val, out_dom



#: launches since the last reset by kernel name, the counters' one lock,
#: and the counts of the capture (if any) that the calling thread runs
_NAMES = ("value_kernel", "value_kernel_bf16", "value_sig_kernel",
          "value_sig_kernel_bf16", "commit_topk", "commit_scan",
          "commit_topk_global", "commit_scan_global")
_COUNTS = dict.fromkeys(_NAMES, 0)
_COUNT_LOCK = threading.Lock()
_CAPTURING = threading.local()
_SUFFIX = {"fp32": "", "bf16": "_bf16"}


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel name. The value
    kernel has two entries, each counted where it launches: `value_kernel`
    (`_bf16`) through `kernel_value`, the S = 1 interface, and
    `value_sig_kernel` (`_bf16`) through `kernel_value_sig`, the one the
    engine calls. Each commit kernel's count takes every launch, and
    `commit_topk_global` / `commit_scan_global` those of them made with
    the residual in global memory (`topk_layout`, `scan_layout`)."""
    with _COUNT_LOCK:
        return dict(_COUNTS)


def count_launch(name: str, n: int = 1) -> None:
    """Add `n` launches of kernel `name` (as `launch_counts` names it).
    Inside `capture_counts()` on this thread they go to the capture's
    counts only: a capture launches nothing. Otherwise to the counters,
    under one lock (a read-modify-write that threads would lose)."""
    add_launches({name: n})


def capturing() -> bool:
    """Whether this thread is inside `capture_counts()` (a CUDA graph
    capture, which launches nothing)."""
    return getattr(_CAPTURING, "counts", None) is not None


@contextlib.contextmanager
def capture_counts():
    """Within the block, the wrappers' launches on THIS thread are counted
    into the yielded dict (kernel name -> launches) and not into the
    counters: the launches one CUDA graph capture recorded, kept apart
    from every other thread's."""
    outer = getattr(_CAPTURING, "counts", None)
    _CAPTURING.counts = counts = {}
    try:
        yield counts
    finally:
        _CAPTURING.counts = outer


def add_launches(counts: dict[str, int]) -> None:
    """Add `counts` (kernel name -> launches, as `launch_counts` names
    them) to the counters, or inside `capture_counts()` to the capture's.
    A CUDA graph's replay launches the kernels it captured without calling
    their wrappers, so whoever replays it adds the captured counts here
    (solver/programs.py `FusedGraphs`). An unknown name raises KeyError
    before anything is added."""
    for name in counts:
        if name not in _COUNTS:
            raise KeyError(f"no kernel named {name!r}")
    capture = getattr(_CAPTURING, "counts", None)
    if capture is not None:
        for name, n in counts.items():
            capture[name] = capture.get(name, 0) + n
        return
    with _COUNT_LOCK:
        for name, n in counts.items():
            _COUNTS[name] += n


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    with _COUNT_LOCK:
        _COUNTS.update(dict.fromkeys(_NAMES, 0))


__all__ = [
    "add_launches",
    "scan_layout",
    "topk_layout",
    "capture_counts",
    "count_launch",
    "commit_topk_plain",
    "device_commit_scan_plain",
    "kernel_commit_scan",
    "kernel_commit_topk",
    "gather_min",
    "kernel_value",
    "kernel_value_sig",
    "launch_counts",
    "reset_launches",
    "tie_jitter",
    "value_plain",
    "value_plain_bf16",
    "value_sig_plain",
    "value_sig_plain_bf16",
]
