"""grove_tpu_torch commit scans vs the JAX package's, on the CPU.

The port's chunked `commit_scan` (murmur jitter, then the commit top-k
kernel's plain twin `commit_topk_plain`: stable top-k, ancestor scatter)
and the plain version of the device-commit kernel
(`device_commit_scan_plain`) must be BIT-equal to JAX's `commit_scan` and
`device_commit_scan` -- packed top-k values and domain ids, committed
values and domains -- over seeds, ragged gang counts (which shrink the
chunk), chunk sizes that do not divide G and top_k in {1, 4, 8}. Demands
and free capacity are random non-dyadic floats, so the residual
scatter-adds must also accumulate in the same order. The commit top-k
wrapper also takes a chunk that does not divide G (a shorter last
chunk), held against a row-by-row numpy reference that applies the
murmur jitter itself. The commit top-k kernel commits a chunk column by
column of the ancestor chains; a numpy mirror of that order is held
bit-equal to JAX's row-major scatter, and every `anc_ids` column is held
to a single level (the precondition that makes the two orders agree) for
the port's and the JAX package's `DomainSpace` at 2, 3 and 4 tiers and at
the stress cluster. Tolerance: none (assert_array_equal). The CUDA
kernels are held against these plain versions on the card by
chip_smoke.py. Fault P3: `topk_layout` / `scan_layout` keep each
kernel's working set in shared memory while it fits and move it to a
global scratch past that (checked at D = 5334, 21335 and 100000, and at
the thresholds), an
explicit layout that does not fit raises, the wrappers on CPU tensors run
their plain versions whatever layout is asked for, and the C entry points
take the scratch pointer and the layout int the wrappers pass.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import grove_tpu.api.meta as jax_meta
import grove_tpu.api.types as jax_types
import grove_tpu.topology.encoding as jax_encoding
from grove_tpu.solver.engine import DomainSpace as JaxDomainSpace
from grove_tpu.solver.engine import commit_scan as _jax_commit_scan
from grove_tpu.solver.engine import membership_matrix as jax_membership
from grove_tpu.solver.engine import value_from_aggregates as jax_value
from grove_tpu.solver.pallas_core import device_commit_scan as jax_device_commit

import grove_tpu_torch.api.meta as port_meta
import grove_tpu_torch.api.types as port_types
import grove_tpu_torch.topology.encoding as port_encoding
from grove_tpu_torch import stress
from grove_tpu_torch.solver.engine import (
    DomainSpace,
    check_anc_columns,
    commit_scan,
    membership_matrix,
    tie_jitter,
)
from grove_tpu_torch.solver.kernel_core import (
    commit_topk_plain,
    device_commit_scan_plain,
    kernel_commit_scan,
    kernel_commit_topk,
    launch_counts,
)
from grove_tpu_torch.solver import kernel_core as kc


_jitted_commit_scan = jax.jit(_jax_commit_scan, static_argnames=("top_k", "chunk"))


def jax_commit_scan(value, dom_free, anc_ids, td, top_k, chunk=32):
    return _jitted_commit_scan(value, dom_free, anc_ids, td, top_k=top_k,
                               chunk=chunk)


@pytest.fixture(scope="module")
def spaces():
    """The JAX and port domain spaces of one 3-tier cluster (64 nodes:
    1 root + 1 block + 4 racks + 64 hosts)."""
    return JaxDomainSpace(bench.make_cluster(64)), DomainSpace(stress.make_cluster(64))


def _scan_inputs(space, seed, g, r=3):
    """A seeded scoring instance on a real ancestor table: random
    non-dyadic free/demand, a value tensor with masked cells and ties."""
    rng = np.random.default_rng(seed)
    d = space.num_domains
    dom_free = rng.uniform(0.0, 64.0, (d, r)).astype(np.float32)
    td = rng.uniform(0.0, 24.0, (g, r)).astype(np.float32)
    cnt_fit = rng.integers(0, 3, (g, d)).astype(np.float32)
    req = rng.integers(-1, 3, g).astype(np.int32)
    pref = rng.integers(-1, 3, g).astype(np.int32)
    valid = rng.random(g) > 0.1
    cap = np.full(r, 32.0, np.float32)
    fair = np.zeros(g, np.float32)  # equal rows tie exactly
    value = np.array(jax_value(dom_free, cnt_fit, space.dom_level, td, req,
                                 pref, valid, cap, fair))
    return value, dom_free, td


def test_domain_space_and_membership_match(spaces):
    jsp, tsp = spaces
    assert tsp.num_domains == jsp.num_domains
    assert tsp.offsets == jsp.offsets
    np.testing.assert_array_equal(tsp.gdom, jsp.gdom)
    np.testing.assert_array_equal(tsp.dom_level, jsp.dom_level)
    np.testing.assert_array_equal(tsp.anc_ids, jsp.anc_ids)
    # a padded node carrying the out-of-range id contributes nothing
    gdom = np.concatenate(
        [jsp.gdom, np.full((jsp.gdom.shape[0], 1), jsp.num_domains, np.int32)],
        axis=1,
    )
    np.testing.assert_array_equal(
        membership_matrix(torch.from_numpy(gdom), jsp.num_domains).numpy(),
        np.asarray(jax_membership(jnp.asarray(gdom), jsp.num_domains)),
    )


@pytest.mark.parametrize("g", [8, 40, 64])
@pytest.mark.parametrize("top_k", [1, 4, 8])
def test_commit_scan_bit_equal(spaces, g, top_k):
    jsp, _ = spaces
    for seed in (0, 1, 2):
        value, dom_free, td = _scan_inputs(jsp, seed, g)
        ref_val, ref_dom = jax_commit_scan(value, dom_free, jsp.anc_ids, td, top_k)
        out_val, out_dom = commit_scan(
            torch.from_numpy(value), torch.from_numpy(dom_free),
            torch.from_numpy(jsp.anc_ids), torch.from_numpy(td), top_k,
        )
        np.testing.assert_array_equal(out_val.numpy(), np.asarray(ref_val))
        np.testing.assert_array_equal(out_dom.numpy(), np.asarray(ref_dom))


@pytest.mark.parametrize("top_k", [1, 4, 8])
def test_device_commit_plain_bit_equal(spaces, top_k):
    jsp, _ = spaces
    for seed in (0, 1, 2):
        value, dom_free, td = _scan_inputs(jsp, seed, 64)
        top_val, top_dom = (
            np.array(a)
            for a in jax_commit_scan(value, dom_free, jsp.anc_ids, td, top_k)
        )
        ref_val, ref_dom = jax_device_commit(top_val, top_dom, dom_free,
                                             jsp.anc_ids, td)
        args = [torch.from_numpy(a)
                for a in (top_val, top_dom, dom_free, jsp.anc_ids, td)]
        out_val, out_dom = device_commit_scan_plain(*args)
        np.testing.assert_array_equal(out_val.numpy(), np.asarray(ref_val))
        np.testing.assert_array_equal(out_dom.numpy(), np.asarray(ref_dom))
        # the wrapper on CPU tensors is the plain version, with no launch
        before = launch_counts()["commit_scan"]
        w_val, w_dom = kernel_commit_scan(*args)
        assert launch_counts()["commit_scan"] == before
        np.testing.assert_array_equal(w_val.numpy(), out_val.numpy())
        np.testing.assert_array_equal(w_dom.numpy(), out_dom.numpy())


def test_device_commit_without_feasible_candidate():
    """No feasible candidate: value -1e9, domain = the first candidate,
    and nothing committed (the next gang still sees the full residual)."""
    top_val = np.array([[5.0, 4.0], [-1e9, -1e9], [5.0, 4.0]], np.float32)
    top_dom = np.array([[1, 2], [2, 1], [1, 2]], np.int32)
    dom_free = np.array([[0.0], [1.0], [10.0]], np.float32)
    anc = np.array([[0, 3], [0, 1], [0, 2]], np.int32)
    td = np.array([[2.0], [1.0], [2.0]], np.float32)
    ref = jax_device_commit(top_val, top_dom, dom_free, anc, td)
    out = device_commit_scan_plain(
        *(torch.from_numpy(a) for a in (top_val, top_dom, dom_free, anc, td))
    )
    for o, rf in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(rf))
    assert out[0][1, 0] == -1e9 and out[1][1, 0] == 2


def test_tie_jitter_bit_equal():
    """The murmur mixing is uint32 in JAX and masked int64 in the port:
    hash, float32 conversion and the 2**-32 scale must agree bitwise."""
    g, d = 1024, 1500
    gi = jnp.arange(g, dtype=jnp.uint32)[:, None]
    di = jnp.arange(d, dtype=jnp.uint32)[None, :]
    h = gi * jnp.uint32(0x9E3779B1) + di * jnp.uint32(0x85EBCA77)
    h = h ^ (h >> 13)
    h = h * jnp.uint32(0xC2B2AE35)
    h = h ^ (h >> 16)
    ref = jax.jit(lambda x: 1e-4 * (x.astype(jnp.float32) / jnp.float32(2**32)))(h)
    np.testing.assert_array_equal(
        tie_jitter(g, d, torch.device("cpu")).numpy(), np.asarray(ref)
    )


def test_top_k_ties_take_lower_index_first():
    """A row masked everywhere but one column: lax.top_k returns that
    column then the lowest-index masked ones; so must the port."""
    d, top_k = 40, 4
    value = np.full((1, d), -1e9, np.float32)
    value[0, 17] = 3.0
    dom_free = np.full((d, 1), 100.0, np.float32)
    anc = np.stack([np.arange(d), np.full(d, d)], axis=1).astype(np.int32)
    td = np.ones((1, 1), np.float32)
    ref_val, ref_dom = jax_commit_scan(value, dom_free, anc, td, top_k)
    out_val, out_dom = commit_scan(
        *(torch.from_numpy(a) for a in (value, dom_free, anc, td)), top_k
    )
    np.testing.assert_array_equal(out_dom.numpy(), np.asarray(ref_dom))
    np.testing.assert_array_equal(out_val.numpy(), np.asarray(ref_val))
    assert out_dom.numpy()[0].tolist() == [17, 0, 1, 2]


@pytest.mark.parametrize("g,chunk", [(40, 24), (64, 48), (8, 3)])
def test_commit_scan_chunk_not_dividing_g(spaces, g, chunk):
    """The engine's commit_scan shrinks a chunk that does not divide G
    to the largest divisor below it, as JAX's does."""
    jsp, _ = spaces
    value, dom_free, td = _scan_inputs(jsp, 5, g)
    ref_val, ref_dom = jax_commit_scan(value, dom_free, jsp.anc_ids, td, 4,
                                       chunk)
    out_val, out_dom = commit_scan(
        torch.from_numpy(value), torch.from_numpy(dom_free),
        torch.from_numpy(jsp.anc_ids), torch.from_numpy(td), 4, chunk,
    )
    np.testing.assert_array_equal(out_val.numpy(), np.asarray(ref_val))
    np.testing.assert_array_equal(out_dom.numpy(), np.asarray(ref_dom))


def _numpy_jitter(g, d):
    """The murmur tie jitter in numpy uint32 arithmetic (wrapping)."""
    gi = np.arange(g, dtype=np.uint32)[:, None]
    di = np.arange(d, dtype=np.uint32)[None, :]
    h = gi * np.uint32(0x9E3779B1) + di * np.uint32(0x85EBCA77)
    h ^= h >> np.uint32(13)
    h *= np.uint32(0xC2B2AE35)
    h ^= h >> np.uint32(16)
    return np.float32(1e-4) * (h.astype(np.float32) / np.float32(2 ** 32))


def _numpy_commit_topk(value, dom_free, anc_ids, td, top_k, chunk):
    """Row-by-row reference of the chunked commit scan, with a shorter
    last chunk: add the murmur jitter to live values, select against the
    chunk-start residual, then commit the chunk's first choices in row
    order, chain entry by chain entry."""
    g, d = value.shape
    jittered = np.where(value > np.float32(-5e8), value + _numpy_jitter(g, d),
                        value)
    resid = dom_free.copy()
    top_val = np.empty((g, top_k), np.float32)
    top_dom = np.empty((g, top_k), np.int32)
    for start in range(0, g, chunk):
        rows = range(start, min(start + chunk, g))
        for i in rows:
            fits = np.all(resid + np.float32(1e-6) >= td[i], axis=1)
            row = np.where(fits, jittered[i], np.float32(-1e9))
            order = np.argsort(-row, kind="stable")[:top_k]
            top_val[i], top_dom[i] = row[order], order
        for i in rows:
            if top_val[i, 0] > -5e8:
                for c in anc_ids[top_dom[i, 0]]:
                    if c < d:
                        resid[c] = resid[c] + (-td[i])
    return top_val, top_dom


@pytest.mark.parametrize("g,chunk", [(40, 32), (37, 5), (9, 16), (64, 32)])
@pytest.mark.parametrize("top_k", [1, 8])
def test_commit_topk_plain_ragged_chunk(spaces, g, chunk, top_k):
    jsp, _ = spaces
    value, dom_free, td = _scan_inputs(jsp, 9, g)
    ref_val, ref_dom = _numpy_commit_topk(value, dom_free, jsp.anc_ids, td,
                                          top_k, chunk)
    args = [torch.from_numpy(a) for a in (value, dom_free, jsp.anc_ids, td)]
    out_val, out_dom = commit_topk_plain(*args, top_k, chunk)
    np.testing.assert_array_equal(out_val.numpy(), ref_val)
    np.testing.assert_array_equal(out_dom.numpy(), ref_dom)
    # the wrapper on CPU tensors is the plain version, with no launch
    before = launch_counts()["commit_topk"]
    w_val, w_dom = kernel_commit_topk(*args, top_k, chunk)
    assert launch_counts()["commit_topk"] == before
    np.testing.assert_array_equal(w_val.numpy(), ref_val)
    np.testing.assert_array_equal(w_dom.numpy(), ref_dom)
    with pytest.raises(ValueError, match="chunk"):
        kernel_commit_topk(*args, top_k, 0)


def _commit_column_order(resid, chains, td):
    """numpy mirror of the commit top-k kernel's commit: for each chain
    column j and resource r, the chunk's rows are taken 32 at a time (a
    warp, lane i holding row i); every lane starts from its domain's
    residual and adds, in row order, the demands of the batch's rows that
    name the same domain; the first lane of each domain stores the sum.
    The absorbing id D names no domain. resid [D, R], chains [C, L+1]
    (padded with D), td [C, R]."""
    out = resid.copy()
    d = out.shape[0]
    for j in range(chains.shape[1]):
        for r in range(td.shape[1]):
            for i0 in range(0, chains.shape[0], 32):
                c = chains[i0:i0 + 32, j]
                t = td[i0:i0 + 32, r]
                sums = {}
                for lane in range(len(c)):
                    if c[lane] >= d or c[lane] in sums:
                        continue  # not a domain, or not its group's first lane
                    acc = out[c[lane], r]
                    for q in range(len(c)):
                        if c[q] == c[lane]:
                            acc = np.float32(acc + (-t[q]))
                    sums[c[lane]] = acc
                for dom, acc in sums.items():
                    out[dom, r] = acc
    return out


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("chunk", [5, 32, 64])
def test_column_order_commit_equals_row_major_scatter(spaces, seed, chunk):
    """The kernel's column-by-column commit of a chunk's chains is
    bit-equal to JAX's flattened [C, L+1] scatter (and to the plain
    twin's CPU index_add_) on non-dyadic demands, with repeated domains
    and rows that commit nothing."""
    jsp, _ = spaces
    rng = np.random.default_rng(100 + seed)
    d, l1 = jsp.num_domains, jsp.anc_ids.shape[1]
    resid = rng.uniform(0.0, 64.0, (d, 3)).astype(np.float32)
    td = (rng.uniform(0.0, 24.0, (chunk, 3)) * 0.3).astype(np.float32)
    # few distinct choices, so domains repeat across rows at every level
    choice = rng.choice(rng.integers(0, d, 6), chunk)
    ok = rng.random(chunk) > 0.2
    chains = np.where(ok[:, None], jsp.anc_ids[choice], d).astype(np.int32)
    resid_pad = np.concatenate([resid, np.zeros((1, 3), np.float32)])
    jax_out = np.asarray(jnp.asarray(resid_pad).at[chains.reshape(-1)].add(
        -jnp.repeat(jnp.asarray(td), l1, axis=0)))
    torch_out = torch.from_numpy(resid_pad.copy()).index_add_(
        0, torch.from_numpy(chains.reshape(-1)).long(),
        torch.from_numpy(-td).repeat_interleave(l1, dim=0)).numpy()
    mine = _commit_column_order(resid, chains, td)
    np.testing.assert_array_equal(mine, jax_out[:d])
    np.testing.assert_array_equal(mine, torch_out[:d])


#: (package modules, DomainSpace) of the JAX package and of the port
_PACKAGES = {
    "jax": (jax_meta, jax_types, jax_encoding, JaxDomainSpace),
    "port": (port_meta, port_types, port_encoding, DomainSpace),
}

#: topology label keys above the host level, broadest first
_TIERS = {
    2: ("t/block",),
    3: ("t/block", "t/rack"),
    4: ("t/zone", "t/block", "t/rack"),
}


def _tier_cluster(package: str, num_nodes: int, tiers: int):
    """A cluster built like stress.make_cluster (16 hosts a rack, 256 a
    block; 1024 a zone) with `tiers` levels including the host."""
    meta, types, encoding, _ = _PACKAGES[package]
    keys = _TIERS[tiers]
    nodes = []
    for i in range(num_nodes):
        z, b, r = i // 1024, i // 256, i // 16
        names = {"t/zone": f"z{z}", "t/block": f"z{z}b{b}",
                 "t/rack": f"z{z}b{b}r{r}"}
        nodes.append(types.Node(
            metadata=meta.ObjectMeta(name=f"n{i}",
                                     labels={k: names[k] for k in keys}),
            allocatable={"cpu": 32.0, "memory": 128.0, "tpu": 8.0},
        ))
    levels = [types.TopologyLevel(domain=k.split("/")[1], key=k) for k in keys]
    return encoding.encode_topology(
        encoding.default_cluster_topology(levels), nodes)


def _assert_single_level_columns(space):
    d = space.num_domains
    for j in range(space.anc_ids.shape[1]):
        ids = space.anc_ids[:, j]
        ids = ids[ids != d]
        assert ids.size > 0
        assert np.all(space.dom_level[ids] == j - 1), f"column {j}"


@pytest.mark.parametrize("package", ["jax", "port"])
@pytest.mark.parametrize("tiers,num_nodes", [(2, 600), (3, 600), (4, 2100),
                                             ("stress", 5000)])
def test_anc_columns_hold_one_level(package, tiers, num_nodes):
    """Column j of anc_ids holds only level j - 1 domains (column 0 the
    root) for both packages' DomainSpace, so no domain is in two columns;
    the port's check accepts every one of these tables."""
    if tiers == "stress":
        snap = (bench.make_cluster(num_nodes) if package == "jax"
                else stress.make_cluster(num_nodes))
        tiers = 3
    else:
        snap = _tier_cluster(package, num_nodes, tiers)
    space = _PACKAGES[package][3](snap)
    assert space.anc_ids.shape[1] == tiers + 1
    _assert_single_level_columns(space)
    check_anc_columns(space.anc_ids, space.dom_level)


@pytest.mark.parametrize("swap", [(1, 2), (0, 3)])
def test_anc_columns_check_raises(spaces, swap):
    """A table whose columns mix levels is refused where it is checked."""
    _, tsp = spaces
    anc = tsp.anc_ids.copy()
    row = np.flatnonzero(tsp.dom_level == 2)[0]  # a host: a full chain
    a, b = swap
    anc[row, [a, b]] = anc[row, [b, a]]
    with pytest.raises(ValueError, match="one level per column"):
        check_anc_columns(anc, tsp.dom_level)


def _numpy_keys(values, idx):
    """numpy mirror of the commit top-k kernel's 64-bit keys: the float's
    bits made order-preserving (sign set: all bits flipped; else the sign
    bit set) above the complemented index."""
    b = values.astype(np.float32).view(np.uint32)
    b = np.where(b & np.uint32(0x80000000), ~b, b | np.uint32(0x80000000))
    return (b.astype(np.uint64) << np.uint64(32)) | (
        np.uint64(0xFFFFFFFF) - idx.astype(np.uint64))


@pytest.mark.parametrize("seed", range(3))
def test_topk_keys_order_like_lax(seed):
    """Descending keys give lax.top_k's order (value desc, index asc) on a
    row with -1e9 ties by the hundred, repeated values, negatives and
    zero; the key decodes back to the value's bits and the index."""
    rng = np.random.default_rng(seed)
    d = 700
    row = rng.choice(np.float32([-1e9, -3.5, -0.25, 0.0, 1e-4, 2.5, 7.75]), d)
    row = np.where(rng.random(d) < 0.5, row,
                   rng.normal(0, 5, d).astype(np.float32)).astype(np.float32)
    keys = _numpy_keys(row, np.arange(d))
    order = np.argsort(-row, kind="stable")
    np.testing.assert_array_equal(np.argsort(keys)[::-1], order)
    top = jax.lax.top_k(jnp.asarray(row), 16)[1]
    np.testing.assert_array_equal(np.argsort(keys)[::-1][:16], np.asarray(top))
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    back = np.where(hi & np.uint32(0x80000000), hi & np.uint32(0x7FFFFFFF), ~hi)
    np.testing.assert_array_equal(back.view(np.float32), row)
    np.testing.assert_array_equal(
        np.uint64(0xFFFFFFFF) - (keys & np.uint64(0xFFFFFFFF)), np.arange(d))


@pytest.mark.parametrize("kernel", ["commit_topk", "commit_scan"])
def test_kernel_probe_patches_apply(kernel):
    """The card probe's clock stamps find their places in the current
    kernel sources (a source edit that moves them fails here, not on the
    card)."""
    from grove_tpu_torch import kernel_probe
    from grove_tpu_torch.build import PACKAGE_DIR, SOURCES

    src = (PACKAGE_DIR / SOURCES[kernel]).read_text()
    patch = (kernel_probe.probe_topk if kernel == "commit_topk"
             else kernel_probe.probe_scan)
    out = patch(src)
    assert out.count("g_probe[") >= 2 and out.count("PT(") >= 3


# -- fault P3: the commit kernels' layouts -------------------------------------

#: D -> (commit top-k layout, device-commit layout) at R = 3, K = 8,
#: L + 1 = 4, as the kernels' `layout` bits (1: the residual in shared
#: memory, 2: K2's row): the stress shape keeps every working set in shared
#: memory; the hier 20k tier's flat shape moves both residuals to global
#: memory; at 100k domains K2's row goes too
P3_SHAPES = {
    5334: (kc._RESID | kc._ROW, kc._RESID),
    21335: (kc._ROW, 0),
    100000: (0, 0),
}


@pytest.mark.parametrize("d", list(P3_SHAPES))
def test_commit_layout_by_domain_count(d):
    """The layout choice at the stress shape, the flat 20k shape and 100k
    domains, and the shared bytes it asks for within the 227 KB a block
    holds; the wrappers' layout resolution raises no ValueError there."""
    topk, scan = kc.topk_layout(d, 3, 8), kc.scan_layout(d, 3, 8, 4)
    assert (topk, scan) == P3_SHAPES[d]
    assert kc._topk_smem(d, 3, 8, topk) <= kc._SMEM_BYTES
    assert kc._scan_smem(d, 3, 8, 4, scan) <= kc._SMEM_BYTES
    # an explicit request for what the choice gives changes nothing
    assert kc.topk_layout(d, 3, 8, bool(topk & kc._RESID),
                          bool(topk & kc._ROW)) == topk
    assert kc.scan_layout(d, 3, 8, 4, bool(scan)) == scan
    # every smaller layout is asked for explicitly without error
    assert kc.topk_layout(d, 3, 8, False, False) == 0
    assert kc.scan_layout(d, 3, 8, 4, False) == 0


def test_commit_layout_thresholds():
    """The switch points: K2's residual leaves shared memory past ~14.4k
    domains at R = 3 and its row past ~57k; K3's residual past ~15.6k at
    L + 1 = 5 (fault P3's caps, now layout switches)."""
    def last_shared(pred):
        lo, hi = 1, 200_000
        while lo < hi:
            mid = (lo + hi + 1) // 2
            lo, hi = (mid, hi) if pred(mid) else (lo, mid - 1)
        return lo

    assert 14_000 < last_shared(
        lambda d: kc.topk_layout(d, 3, 8) & kc._RESID) < 14_600
    assert 57_000 < last_shared(
        lambda d: kc.topk_layout(d, 3, 8) & kc._ROW) < 58_000
    assert 15_000 < last_shared(lambda d: kc.scan_layout(d, 3, 8, 5)) < 16_000


def test_commit_layout_refuses_shared_memory_that_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        kc.topk_layout(21335, 3, 8, resid_shared=True)
    with pytest.raises(ValueError, match="shared memory"):
        kc.topk_layout(100000, 3, 8, row_shared=True)
    with pytest.raises(ValueError, match="shared memory"):
        kc.scan_layout(21335, 3, 8, 4, resid_shared=True)
    # the ring of staged gangs alone must fit
    with pytest.raises(ValueError, match="ring"):
        kc.scan_layout(10, 3, 32, 200)


@pytest.mark.parametrize("d", [5334, 21335])
def test_commit_wrappers_on_the_cpu_at_p3_shapes(d):
    """On CPU tensors both wrappers run their plain versions at any D,
    whatever layout is asked for (the layout is a kernel argument only)."""
    rng = np.random.default_rng(d)
    g, r, l1, k = 40, 3, 4, 8
    space_levels = np.repeat(np.arange(-1, l1 - 1), -(-d // l1))[:d]
    anc = np.full((d, l1), d, np.int32)
    for j in range(l1):
        rows = np.flatnonzero(space_levels == j - 1)
        anc[rows, j] = rows
    args = (torch.from_numpy(rng.uniform(-1.0, 9.0, (g, d)).astype(np.float32)),
            torch.from_numpy(rng.uniform(0.0, 8.0, (d, r)).astype(np.float32)),
            torch.from_numpy(anc),
            torch.from_numpy(rng.uniform(0.0, 2.0, (g, r)).astype(np.float32)))
    want = kc.commit_topk_plain(*args, k, 32)
    got = kc.kernel_commit_topk(*args, k, 32, resid_shared=False,
                                row_shared=False)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    scan = kc.kernel_commit_scan(*want, *args[1:], resid_shared=False)
    ref = kc.device_commit_scan_plain(*want, *args[1:])
    assert all(torch.equal(a, b) for a, b in zip(scan, ref))


@pytest.mark.parametrize("kernel,entry,argtypes", [
    ("commit_topk", "grove_commit_topk", kc._TOPK_ARGTYPES),
    ("commit_scan", "grove_commit_scan", kc._COMMIT_ARGTYPES),
])
def test_commit_entry_points_take_scratch_and_layout(kernel, entry, argtypes):
    """The C entry points' parameters (pointers, then ints, then the
    stream) match the ctypes argtypes the wrappers set, scratch pointer
    and layout int included."""
    import re
    from grove_tpu_torch.build import PACKAGE_DIR, SOURCES

    src = (PACKAGE_DIR / SOURCES[kernel]).read_text()
    params = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src)
    kinds = ["ptr" if "*" in p else "int" for p in params.group(1).split(",")]
    want = ["ptr" if t is ctypes.c_void_p else "int" for t in argtypes]
    assert kinds == want
    assert "int layout" in params.group(1) and "scratch" in params.group(1)
