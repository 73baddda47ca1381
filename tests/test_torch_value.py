"""grove_tpu_torch value tensor vs the JAX package's, on the CPU.

fp32: the port's plain version of the value kernel (`value_plain`, also
the engine's non-kernel tier `value_from_aggregates`) must be BIT-equal to
the JAX package's XLA chain (`value_from_aggregates`) and to its Pallas
kernel run in interpret mode, over the edge set of
tests/test_pallas_core.py (zero cnt_fit columns, invalid rows,
unsatisfiable required levels, negative fairness) at ragged shapes.
Tolerance: none (assert_array_equal).

bf16: the plain twin `value_plain_bf16` rounds every op to bf16 as
PyTorch does; JAX's bf16 Pallas tier (interpreted) rounds at other
places, so the two are score-equal, not bit-equal. Required: the -1e9
masks equal exactly; live cells within 0.0625 of JAX's bf16 (two bf16
quanta of a value in [4, 8), one in [8, 16)) and within the tolerance
tests/test_pallas_core.py grants JAX's bf16 against fp32 (rtol 0.02,
atol 0.05).

Fused entry (`kernel_value_sig`, the one the engine calls): the value
tensor straight from the per-signature fit counts sig_cnt = node_fits @ m
[U, D] and each gang's signature rows sig_idx [G, S]. Its fp32 twin must
be BIT-equal to JAX's value_from_aggregates on (node_fits @ m)[sig_idx]
.min(axis=1), and the engine's kernel tier on the CPU bit-equal to the
JAX engine's value tensor on a backlog with several eligibility
signatures. Tolerance: none.

The CUDA kernels themselves are held against the plain versions on the
card, bit for bit, by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grove_tpu.solver import PlacementEngine as JaxEngine
from grove_tpu.solver.engine import _score_core as jax_score_core
from grove_tpu.solver.engine import value_from_aggregates as jax_value
from grove_tpu.solver.pallas_core import pallas_value
from grove_tpu.solver.serial import gang_sort_key as jax_sort_key

from grove_tpu_torch import kernel_probe
from grove_tpu_torch.build import ptxas_lines
from grove_tpu_torch.solver.engine import (
    PlacementEngine,
    demand_table,
    resolve_kernel_tiers,
    value_from_aggregates,
)
from grove_tpu_torch.solver.kernel_core import (
    count_launch,
    kernel_commit_scan,
    kernel_commit_topk,
    kernel_value,
    kernel_value_sig,
    launch_counts,
    reset_launches,
    value_plain,
    value_plain_bf16,
    value_sig_plain,
    value_sig_plain_bf16,
)
from grove_tpu_torch.stress import make_cluster

import bench
from test_pallas_core import _rand_inputs
from test_torch_engine import CASES, _convert


def _torch(args):
    return [torch.from_numpy(np.asarray(a)) for a in args]


@pytest.mark.parametrize("g", [1, 7, 64, 129])
@pytest.mark.parametrize("d", [1, 130, 300])
def test_value_plain_bit_equal_to_jax(g, d):
    for seed in (0, 7):
        args = _rand_inputs(seed, g, d, 3)
        ref = np.asarray(jax_value(*args))
        out = value_plain(*_torch(args)).numpy()
        np.testing.assert_array_equal(out, ref)  # bitwise, no tolerance


@pytest.mark.parametrize("g,d", [(1, 1), (7, 130), (129, 300)])
def test_value_plain_bit_equal_to_pallas_interpret(g, d):
    args = _rand_inputs(3, g, d, 3)
    ref = np.asarray(pallas_value(*args, interpret=True))
    out = value_plain(*_torch(args)).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("r", [1, 2, 4, 8])
def test_resource_counts_bit_equal(r):
    args = _rand_inputs(11, 33, 77, r)
    np.testing.assert_array_equal(
        value_plain(*_torch(args)).numpy(), np.asarray(jax_value(*args))
    )


def test_without_fairness_bit_equal():
    args = _rand_inputs(5, 16, 90, 3)[:-1]
    np.testing.assert_array_equal(
        value_from_aggregates(*_torch(args)).numpy(),
        np.asarray(jax_value(*args)),
    )


def test_masked_rows_and_columns_get_neg():
    args = list(_rand_inputs(3, 12, 40, 3))
    args[1][:, 5] = 0.0       # cnt_fit: no node in domain 5 fits
    args[6][4] = False        # gang 4 invalid
    args[4][9] = 99           # gang 9: required level > every domain
    out = value_plain(*_torch(args)).numpy()
    np.testing.assert_array_equal(out, np.asarray(jax_value(*args)))
    assert np.all(out[:, 5] == -1e9)
    assert np.all(out[4] == -1e9)
    assert np.all(out[9] == -1e9)


@pytest.mark.parametrize("g,d,r", [(1, 1, 3), (32, 90, 3), (64, 300, 3),
                                   (128, 700, 4), (7, 130, 1), (129, 300, 8)])
def test_value_plain_bf16_score_equal_to_jax(g, d, r):
    for seed in (0, 11):
        args = _rand_inputs(seed, g, d, r)
        ref_bf16 = np.asarray(pallas_value(*args, precision="bf16",
                                           interpret=True))
        ref_fp32 = np.asarray(jax_value(*args))
        out = value_plain_bf16(*_torch(args)).numpy()
        assert out.dtype == np.float32
        np.testing.assert_array_equal(out == -1e9, ref_bf16 == -1e9)
        np.testing.assert_array_equal(out == -1e9, ref_fp32 == -1e9)
        live = ref_fp32 != -1e9
        assert np.abs(out[live] - ref_bf16[live]).max(initial=0.0) <= 0.0625
        np.testing.assert_allclose(out[live], ref_fp32[live],
                                   rtol=0.02, atol=0.05)
        # every live value is a bf16 number: the chain ends in bf16
        np.testing.assert_array_equal(
            torch.from_numpy(out[live]).to(torch.bfloat16).float().numpy(),
            out[live],
        )


def test_value_plain_bf16_rounds_every_op():
    """One cell by hand: each op of the chain rounds to bf16 (nearest
    even), which a single rounding at the end would not reproduce."""
    f32 = np.float32
    args = [np.array([[20.4]], f32), np.array([[1.0]], f32),
            np.array([1], np.int32), np.array([[4.3]], f32),
            np.array([-1], np.int32), np.array([0], np.int32),
            np.array([True]), np.array([3.6], f32), np.array([-1.0], f32)]

    def bf(x):
        return float(torch.tensor(x, dtype=torch.float32).to(torch.bfloat16))

    s = bf(bf(bf(20.4) - bf(4.3)) / bf(3.6))
    s = bf(s / bf(1.0 + abs(s)))
    want = bf(bf(bf(2.5 * bf(1.0 + 2.0)) + 1.0) - bf(0.5 * s))
    want = bf(want + bf(-1.0))
    out = value_plain_bf16(*_torch(args)).numpy()
    assert out[0, 0] == np.float32(want)
    assert out[0, 0] != np.float32(bf(value_plain(*_torch(args)).item()))


def test_wrapper_takes_plain_version_on_cpu():
    args = _torch(_rand_inputs(2, 9, 50, 3))
    before = launch_counts()
    out = kernel_value(*args)
    out_bf16 = kernel_value(*args, precision="bf16")
    assert launch_counts() == before  # nothing was launched
    np.testing.assert_array_equal(out.numpy(), value_plain(*args).numpy())
    np.testing.assert_array_equal(out_bf16.numpy(),
                                  value_plain_bf16(*args).numpy())
    with pytest.raises(ValueError, match="precision"):
        kernel_value(*args, precision="fp16")


def test_launch_counters_reset():
    before = launch_counts()
    count_launch("value_kernel_bf16", 3)
    count_launch("value_sig_kernel_bf16", 2)
    count_launch("value_sig_kernel")
    count_launch("commit_topk", 2)
    counts = launch_counts()
    # each entry counts its own launches only
    assert counts["value_kernel_bf16"] == before["value_kernel_bf16"] + 3
    assert counts["value_sig_kernel_bf16"] == before["value_sig_kernel_bf16"] + 2
    assert counts["value_sig_kernel"] == before["value_sig_kernel"] + 1
    assert counts["value_kernel"] == before["value_kernel"]
    assert counts["commit_topk"] == before["commit_topk"] + 2
    assert counts["commit_scan"] == before["commit_scan"]
    reset_launches()
    assert launch_counts() == {"value_kernel": 0, "value_kernel_bf16": 0,
                               "value_sig_kernel": 0,
                               "value_sig_kernel_bf16": 0,
                               "commit_topk": 0, "commit_scan": 0,
                               "commit_topk_global": 0,
                               "commit_scan_global": 0}


def _sig_inputs(seed, g, d, u, s, r=3, n=48, templates=None):
    """A seeded fused-kernel instance: the _rand_inputs edge set, with
    cnt_fit replaced by sig_cnt = node_fits @ m from 0/1 node fits [U, N]
    and a 0/1 membership [N, D] (some columns without members, so zero
    counts), sig_idx [G, S] holding 1..S distinct signatures per gang
    padded by repeating its first, as _gang_signatures pads, and the
    demand rows deduped by demand_table (`templates`: each gang's demand
    drawn from that many rows, so gangs share them). Returns (numpy args
    in kernel_value_sig's order, node_fits, m)."""
    rng = np.random.default_rng(seed)
    dom_free, _, dom_level, td, req, pref, valid, cap, fair = _rand_inputs(
        seed, g, d, r)
    if templates is not None:
        td = td[rng.integers(0, templates, g)]
    node_fits = (rng.random((u, n)) > 0.4).astype(np.float32)
    m = (rng.random((n, d)) > 0.85).astype(np.float32)
    sig_idx = np.zeros((g, s), np.int32)
    for i in range(g):
        own = rng.choice(u, size=int(rng.integers(1, min(s, u) + 1)),
                         replace=False)
        sig_idx[i] = list(own) + [own[0]] * (s - len(own))
    sig_cnt = node_fits @ m
    demand, demand_idx = demand_table(td)
    return ((dom_free, sig_cnt, sig_idx, dom_level, demand, demand_idx, req,
             pref, valid, cap, fair), node_fits, m)


def _gathered(args):
    """kernel_value's operands for a fused instance: the gathered cnt_fit
    and each gang's demand row."""
    dom_free, sig_cnt, sig_idx, dom_level, demand, demand_idx, *rest = args
    return (dom_free, sig_cnt[sig_idx].min(axis=1), dom_level,
            demand[demand_idx], *rest)


@pytest.mark.parametrize("s", [1, 3])
@pytest.mark.parametrize("u", [1, 4, 16])
@pytest.mark.parametrize("g,d", [(7, 130), (33, 77)])
def test_value_sig_plain_bit_equal_to_jax(g, d, u, s):
    args, node_fits, m = _sig_inputs(g * 31 + u * 7 + s, g, d, u, s,
                                     templates=3 if g > 10 else None)
    sig_idx = args[2]
    cnt_fit = (jnp.asarray(node_fits) @ jnp.asarray(m))[sig_idx].min(axis=1)
    gathered = _gathered(args)
    ref = np.asarray(jax_value(args[0], cnt_fit, *gathered[2:]))
    t = _torch(args)
    t[1] = torch.from_numpy(node_fits) @ torch.from_numpy(m)  # sig_cnt
    out = value_sig_plain(*t).numpy()
    np.testing.assert_array_equal(out, ref)  # bitwise, no tolerance
    # the masks cover every kind of cell
    assert (ref == -1e9).any() and (ref != -1e9).any()


@pytest.mark.parametrize("s", [1, 3])
@pytest.mark.parametrize("u", [1, 4, 16])
def test_value_sig_plain_bf16_bit_equal_to_gathered(u, s):
    args, _, _ = _sig_inputs(u * 5 + s, 17, 90, u, s, templates=4)
    ref = value_plain_bf16(*_torch(_gathered(args))).numpy()  # numpy gathers
    out = value_sig_plain_bf16(*_torch(args)).numpy()
    np.testing.assert_array_equal(out, ref)


def test_value_sig_wrapper_takes_plain_version_on_cpu():
    args = _torch(_sig_inputs(4, 9, 50, 4, 3)[0])
    before = launch_counts()
    out = kernel_value_sig(*args)
    out_bf16 = kernel_value_sig(*args, precision="bf16")
    assert launch_counts() == before  # nothing was launched
    np.testing.assert_array_equal(out.numpy(), value_sig_plain(*args).numpy())
    np.testing.assert_array_equal(out_bf16.numpy(),
                                  value_sig_plain_bf16(*args).numpy())
    with pytest.raises(ValueError, match="precision"):
        kernel_value_sig(*args, precision="fp16")


def _meta(args):
    return [torch.empty(a.shape, dtype=a.dtype, device="meta") for a in args]


@pytest.mark.parametrize("bad", [
    "sig_idx_dtype", "sig_cnt_dtype", "sig_cnt_width", "sig_idx_rows",
    "sig_idx_1d", "no_signature", "valid_dtype", "fairness_rows",
    "demand_idx_dtype", "demand_idx_rows", "demand_width",
    "demand_idx_missing",
])
def test_value_sig_wrapper_raises_on_bad_operands(bad, monkeypatch):
    """On a CUDA tensor the wrapper checks every operand before it loads
    the kernel. Here the meta device stands in for the card (no build, no
    launch): the checks must raise before either."""
    from grove_tpu_torch.solver import kernel_core

    monkeypatch.setattr(kernel_core, "_launches_kernel", lambda t: True)
    monkeypatch.setattr(kernel_core, "load", lambda name: pytest.fail(
        f"reached the kernel build with a bad operand ({bad})"))
    args = _meta(_torch(_sig_inputs(1, 6, 20, 4, 3)[0]))
    f32, i32 = torch.float32, torch.int32
    g, s = args[2].shape
    u, d = args[1].shape
    meta = {"device": "meta"}
    if bad == "sig_idx_dtype":
        args[2] = torch.empty((g, s), dtype=torch.int64, **meta)
    elif bad == "sig_cnt_dtype":
        args[1] = torch.empty((u, d), dtype=torch.float64, **meta)
    elif bad == "sig_cnt_width":
        args[1] = torch.empty((u, d + 1), dtype=f32, **meta)
    elif bad == "sig_idx_rows":
        args[2] = torch.empty((g + 1, s), dtype=i32, **meta)
    elif bad == "sig_idx_1d":
        args[2] = torch.empty((g,), dtype=i32, **meta)
    elif bad == "no_signature":
        args[2] = torch.empty((g, 0), dtype=i32, **meta)
    elif bad == "valid_dtype":
        args[8] = torch.empty((g,), dtype=torch.uint8, **meta)
    elif bad == "fairness_rows":
        args[10] = torch.empty((g + 2,), dtype=f32, **meta)
    elif bad == "demand_idx_dtype":
        args[5] = torch.empty((g,), dtype=torch.int64, **meta)
    elif bad == "demand_idx_rows":
        args[5] = torch.empty((g + 1,), dtype=i32, **meta)
    elif bad == "demand_width":
        args[4] = torch.empty((args[4].shape[0], 2), dtype=f32, **meta)
    elif bad == "demand_idx_missing":
        args[5] = None
    with pytest.raises((TypeError, ValueError)):
        kernel_value_sig(*args)
    with pytest.raises((TypeError, ValueError)):
        kernel_value_sig(*args, precision="bf16")


def _jax_engine_value(snap, gangs):
    """The JAX engine's value tensor for a backlog: its own encode and
    io packing, then its device scoring body with the Pallas kernel
    interpreted."""
    eng = JaxEngine(snap, incremental=False, pallas_core=True,
                    device_commit=True)
    order = sorted((g for g in gangs if not g.unschedulable_reason),
                   key=jax_sort_key)
    enc = eng._encode_arrays(order)
    _, _, elig_masks, sig_idx = enc.sig
    g_pad, r = enc.total_demand.shape
    gw = r + 4 + sig_idx.shape[1]
    io = eng._build_io(enc)
    gdom, dom_level, anc_ids, cap_scale, _ = eng._ensure_statics()
    score = jax.jit(jax_score_core, static_argnames=(
        "num_domains", "top_k", "chunk", "num_res", "pallas_tier",
        "pallas_interpret"))
    _, value, _ = score(
        eng._masked_free(snap.free), gdom, dom_level, anc_ids,
        io[: g_pad * gw].reshape(g_pad, gw),
        io[g_pad * gw:].reshape(-1, r + 1), elig_masks, cap_scale,
        num_domains=eng.space.num_domains, top_k=8, chunk=32, num_res=r,
        pallas_tier="fp32", pallas_interpret=True,
    )
    return np.asarray(value), enc


@pytest.mark.parametrize("case", ["masked_cordoned", "fair_priority"])
def test_engine_value_bit_equal_to_jax_engine(case):
    """engine.score_values on the CPU's kernel tier (the fused entry's
    twin) against the JAX engine's value tensor, on a backlog with
    several eligibility signatures (masked_cordoned: gangs of two
    signatures, one mask no node satisfies)."""
    snap, gangs = CASES[case]()
    tsnap, tgangs = _convert(snap, gangs)
    ref, jenc = _jax_engine_value(snap, gangs)
    eng = PlacementEngine(tsnap, device="cpu", pallas_core=True,
                          device_commit=True)
    value = eng.score_values(tgangs)[0].numpy()
    np.testing.assert_array_equal(value, ref)
    tenc = eng._encode_backlog(tgangs)
    np.testing.assert_array_equal(tenc.sig[3], jenc.sig[3])
    if case == "masked_cordoned":
        u_real = int((tenc.sig[0].any(axis=1)).sum())
        assert u_real >= 3 and tenc.sig[3].shape[1] >= 2
        assert (value == -1e9).any() and (value != -1e9).any()
    # the non-kernel tier gathers and takes the min itself: same tensor
    plain = PlacementEngine(tsnap, device="cpu").score_values(tgangs)[0]
    np.testing.assert_array_equal(plain.numpy(), ref)


def test_demand_table_dedupes_by_bits():
    """demand_table keeps one row per distinct bit pattern: -0.0 and 0.0
    stay apart (their chains can differ in the sign of a zero), equal NaN
    rows merge, and the table gathered by the index is the input."""
    nan = np.float32("nan")
    td = np.array([[1, 2], [0.0, 1], [1, 2], [-0.0, 1], [nan, 1], [nan, 1],
                   [1, 2]], np.float32)
    demand, idx = demand_table(td)
    assert demand.dtype == np.float32 and idx.dtype == np.int32
    np.testing.assert_array_equal(demand[idx].view(np.uint32),
                                  td.view(np.uint32))
    assert len(demand) == 4
    assert idx[0] == idx[2] == idx[6] and idx[4] == idx[5]
    assert idx[1] != idx[3]
    rows, none = demand_table(np.zeros((0, 3), np.float32))
    assert rows.shape == (0, 3) and none.shape == (0,)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("templates", [None, 1, 3, 6, 12])
def test_value_sig_demand_table_equals_per_gang_rows(templates, precision):
    """The fused entry on the deduped demand table == on one demand row a
    gang (demand_idx = arange(G)), and == kernel_value on the gathered
    operands: where the rows come from changes nothing."""
    args, _, _ = _sig_inputs(7 + (templates or 0), 40, 70, 4, 3,
                             templates=templates)
    t = _torch(args)
    if templates is not None:
        assert t[4].shape[0] <= templates < t[5].shape[0]
    per_gang = list(t)
    per_gang[4] = t[4][t[5].long()]
    per_gang[5] = torch.arange(per_gang[4].shape[0], dtype=torch.int32)
    out = kernel_value_sig(*t, precision=precision).numpy()
    np.testing.assert_array_equal(
        out, kernel_value_sig(*per_gang, precision=precision).numpy())
    np.testing.assert_array_equal(
        out, kernel_value(*_torch(_gathered(args)), precision=precision).numpy())


def test_engine_passes_the_deduped_demand_table():
    """The engine hands the kernel each distinct demand row once: gangs of
    three demand templates (and the zero rows of the padding) give a
    table of four rows, and the value tensor is the JAX engine's."""
    snap, gangs = bench.make_cluster(128), bench.make_gangs(30)
    for i, g in enumerate(gangs):
        g.demand = g.demand * np.float32(1 + i % 3)
    tsnap, tgangs = _convert(snap, gangs)
    eng = PlacementEngine(tsnap, device="cpu", pallas_core=True,
                          device_commit=True)
    args = eng.value_inputs(tgangs)
    demand, demand_idx = args[4], args[5]
    assert demand.shape[0] == 4 and demand_idx.shape == (32,)
    enc = eng._encode_backlog(tgangs)
    np.testing.assert_array_equal(demand[demand_idx.long()].numpy(),
                                  enc.total_demand)
    ref, _ = _jax_engine_value(snap, gangs)
    np.testing.assert_array_equal(eng.score_values(tgangs)[0].numpy(), ref)


@pytest.mark.parametrize("pallas_core", [True, False])
@pytest.mark.parametrize("bad", [-1, "U"])
def test_engine_raises_on_sig_idx_out_of_range(bad, pallas_core):
    snap, gangs = CASES["masked_cordoned"]()
    tsnap, tgangs = _convert(snap, gangs)
    eng = PlacementEngine(tsnap, device="cpu", pallas_core=pallas_core)
    enc = eng._encode_backlog(tgangs)
    u_sig_demand, u_sig_mask, elig_masks, sig_idx = enc.sig
    sig_idx = sig_idx.copy()
    sig_idx[3, 0] = u_sig_demand.shape[0] if bad == "U" else bad
    enc.sig = (u_sig_demand, u_sig_mask, elig_masks, sig_idx)
    with pytest.raises(ValueError, match="sig_idx"):
        eng._score_values(enc, tsnap.free)


def test_wrappers_raise_off_cpu_without_cuda():
    """A tensor on neither the CPU nor a CUDA device (here the meta
    device) never reaches a plain version: the wrappers raise."""
    meta = [torch.empty(a.shape, dtype=a.dtype, device="meta")
            for a in _torch(_rand_inputs(0, 4, 6, 3))]
    with pytest.raises(ValueError, match="CUDA"):
        kernel_value(*meta)
    with pytest.raises(ValueError, match="CUDA"):
        kernel_value(*meta, precision="bf16")
    sig = _meta(_torch(_sig_inputs(0, 4, 6, 4, 3)[0]))
    for precision in ("fp32", "bf16"):
        with pytest.raises(ValueError, match="CUDA"):
            kernel_value_sig(*sig, precision=precision)
    g, k, d, r = 4, 2, 6, 3
    with pytest.raises(ValueError, match="CUDA"):
        kernel_commit_topk(
            torch.empty((g, d), device="meta"),
            torch.empty((d, r), device="meta"),
            torch.empty((d, 2), dtype=torch.int32, device="meta"),
            torch.empty((g, r), device="meta"), k, 2,
        )
    with pytest.raises(ValueError, match="CUDA"):
        kernel_commit_scan(
            torch.empty((g, k), device="meta"),
            torch.empty((g, k), dtype=torch.int32, device="meta"),
            torch.empty((d, r), device="meta"),
            torch.empty((d, 2), dtype=torch.int32, device="meta"),
            torch.empty((g, r), device="meta"),
        )


@pytest.mark.parametrize(
    "device_type,pallas_core,device_commit,expect",
    [
        ("cuda", None, None, (True, True)),
        ("cuda", True, False, (True, False)),
        ("cpu", None, None, (False, False)),
        ("cpu", True, True, (True, True)),
        ("cpu", False, True, (False, True)),
    ],
)
def test_kernel_tier_knobs(device_type, pallas_core, device_commit, expect):
    assert resolve_kernel_tiers(
        device_type, pallas_core, device_commit, "fp32"
    ) == expect


def test_kernel_tier_knob_errors():
    with pytest.raises(ValueError, match="pallas_core=False"):
        resolve_kernel_tiers("cuda", False, None, "fp32")
    with pytest.raises(ValueError, match="pallas_core=False"):
        resolve_kernel_tiers("cuda", False, None, "bf16")
    # bf16 resolves like fp32: it is the value kernel's precision
    assert resolve_kernel_tiers("cuda", None, None, "bf16") == (True, True)
    assert resolve_kernel_tiers("cpu", True, True, "bf16") == (True, True)
    assert resolve_kernel_tiers("cpu", None, None, "bf16") == (False, False)
    for dev in ("cuda", "cpu"):
        with pytest.raises(ValueError, match="precision"):
            resolve_kernel_tiers(dev, None, None, "fp16")


def test_engine_defaults_to_the_card():
    snap = make_cluster(8)
    if torch.cuda.is_available():
        assert PlacementEngine(snap).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PlacementEngine(snap)
    eng = PlacementEngine(snap, device="cpu")
    assert (eng.pallas_core, eng.device_commit) == (False, False)
    assert eng.native_repair and eng.pallas_precision == "fp32"


@pytest.mark.parametrize("variant", sorted(kernel_probe.K1_VARIANTS))
def test_kernel_probe_value_variants_apply(variant):
    """The card probe's value-kernel variants find their patch points in
    the current source (each exactly once), and only the plain variant
    leaves it as it is."""
    src = (kernel_probe.PACKAGE_DIR / "csrc/value_kernel.cu").read_text()
    kw = kernel_probe.K1_VARIANTS[variant]
    out = kernel_probe.k1_variant(src, **kw)
    assert (out == src) == (not kw)


def test_ptxas_lines_name_each_kernel():
    log = (
        "ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__f313e465_"
        "15_value_kernel_cu_f566477a12value_kernelILb0ELi3ELb1EEEvPKfS2_' "
        "for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 56 registers, used 1 barriers, 2304 bytes smem\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118commit_"
        "scan_kernelEPKfPKi' for 'sm_90a'\n"
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 40 registers, used 1 barriers\n"
    )
    assert ptxas_lines(log) == [
        "value_kernel<0,3,1>: Used 56 registers, used 1 barriers, 2304 bytes "
        "smem; 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "commit_scan_kernel: Used 40 registers, used 1 barriers; 8 bytes "
        "stack frame, 4 bytes spill stores, 4 bytes spill loads",
    ]


def test_kernel_probe_value_stamps_apply():
    """The card probe's clock stamps find their places in the current
    value kernel (a source edit that moves them fails here, not on the
    card)."""
    src = (kernel_probe.PACKAGE_DIR / "csrc/value_kernel.cu").read_text()
    out = kernel_probe.probe_value(src)
    assert out.count("PT(p") == 5 and out.count("g_probe[") >= 6
