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

The CUDA kernels themselves are held against the plain versions on the
card, bit for bit, by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from grove_tpu.solver.engine import value_from_aggregates as jax_value
from grove_tpu.solver.pallas_core import pallas_value

from grove_tpu_torch.solver.engine import (
    PlacementEngine,
    resolve_kernel_tiers,
    value_from_aggregates,
)
from grove_tpu_torch.solver.kernel_core import (
    kernel_commit_scan,
    kernel_commit_topk,
    kernel_value,
    launch_counts,
    reset_launches,
    value_plain,
    value_plain_bf16,
)
from grove_tpu_torch.stress import make_cluster

from test_pallas_core import _rand_inputs


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
    kernel_value.launches["bf16"] += 3
    kernel_commit_topk.launches += 2
    assert launch_counts()["value_kernel_bf16"] >= 3
    reset_launches()
    assert launch_counts() == {"value_kernel": 0, "value_kernel_bf16": 0,
                               "commit_topk": 0, "commit_scan": 0}


def test_wrappers_raise_off_cpu_without_cuda():
    """A tensor on neither the CPU nor a CUDA device (here the meta
    device) never reaches a plain version: the wrappers raise."""
    meta = [torch.empty(a.shape, dtype=a.dtype, device="meta")
            for a in _torch(_rand_inputs(0, 4, 6, 3))]
    with pytest.raises(ValueError, match="CUDA"):
        kernel_value(*meta)
    with pytest.raises(ValueError, match="CUDA"):
        kernel_value(*meta, precision="bf16")
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
