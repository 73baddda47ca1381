"""grove_tpu_torch value tensor vs the JAX package's, on the CPU.

The port's plain version of the value kernel (`value_plain`, also the
engine's non-kernel tier `value_from_aggregates`) must be BIT-equal to the
JAX package's XLA chain (`value_from_aggregates`) and to its Pallas kernel
run in interpret mode, over the edge set of tests/test_pallas_core.py
(zero cnt_fit columns, invalid rows, unsatisfiable required levels,
negative fairness) at ragged shapes. Tolerance: none
(assert_array_equal). The CUDA kernel itself is held against
`value_plain` on the card by chip_smoke.py.
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
    kernel_value,
    value_plain,
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


def test_wrapper_takes_plain_version_on_cpu():
    args = _torch(_rand_inputs(2, 9, 50, 3))
    before = kernel_value.launches
    out = kernel_value(*args)
    assert kernel_value.launches == before  # nothing was launched
    np.testing.assert_array_equal(out.numpy(), value_plain(*args).numpy())


def test_wrappers_raise_off_cpu_without_cuda():
    """A tensor on neither the CPU nor a CUDA device (here the meta
    device) never reaches a plain version: the wrappers raise."""
    meta = [torch.empty(a.shape, dtype=a.dtype, device="meta")
            for a in _torch(_rand_inputs(0, 4, 6, 3))]
    with pytest.raises(ValueError, match="CUDA"):
        kernel_value(*meta)
    g, k, d, r = 4, 2, 6, 3
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
    for dev in ("cuda", "cpu"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            resolve_kernel_tiers(dev, None, None, "bf16")
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
