"""The kernels' bytes and operations, by role, against hand-worked values
at a small shape."""

import pytest

from benchmark import roofline

SH = roofline.Shape(g=4, d=10, r=3, u=1, s=1, t=1, k=2, l1=3)


def test_k1_counts():
    # read: dom_free 10x3, sig counts 1x10, demand rows 1x3, per gang
    # sig_idx 1 + 5 indices and levels; write 4x10; 4 bytes each
    nbytes, ops = roofline.k1(SH)
    assert nbytes == 4 * (30 + 10 + 3 + 4 * 6) + 4 * 40
    assert ops == 4 * 10 * (3 * 3 + 7)


def test_k2_counts():
    nbytes, ops = roofline.k2(SH)
    assert nbytes == 4 * (40 + 30 + 30 + 12) + 8 * 4 * 2
    assert ops == 4 * 10 * (3 + 11) + 4 * 3 * 3


def test_k3_counts():
    nbytes, ops = roofline.k3(SH)
    assert nbytes == 8 * 4 * 2 + 4 * (30 + 30 + 12) + 8 * 4
    assert ops == 4 * 2 * 3 + 4 * 3 * 3


def test_least_time_takes_the_larger_bound():
    nbytes, ops = roofline.k1(SH)
    want = max(nbytes / roofline.HBM_BYTES_PER_S, ops / roofline.FP32_FLOP_PER_S)
    assert roofline.least_seconds("k1", [SH, SH]) == pytest.approx(2 * want)


def test_stress_shape_is_byte_bound():
    sh = roofline.Shape(g=1000, d=5334, r=3, u=1, s=1, t=1, k=8, l1=4)
    nbytes, ops = roofline.k1(sh)
    assert nbytes / roofline.HBM_BYTES_PER_S > ops / roofline.FP32_FLOP_PER_S
    assert nbytes == pytest.approx(4 * 1000 * 5334, rel=0.01)


def test_kernel_roles_by_name():
    assert roofline.role_of("void value_kernel<0, 3, 1>(float const*)") == "k1"
    assert roofline.role_of("commit_topk_kernel(float const*, int)") == "k2"
    assert roofline.role_of("commit_scan_kernel<1>(float const*)") == "k3"
    assert roofline.role_of("Memcpy DtoH (Device -> Pinned)") is None
