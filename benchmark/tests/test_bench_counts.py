"""The frozen counts against hand counts at small shapes."""

import pytest

import counts


def test_k1_counts():
    # (2, 3): reads 6 floats, writes 8; 18 float64 operations
    assert counts.k1_bound_s(2, 3) == pytest.approx(
        max(56 / 3.35e12, 18 / 34e12))


def test_s1_counts():
    # (2, 5): forward reads 2*5*2 + 2, writes 3*2 + 2*5*2 floats
    fwd = 4 * (2 * 10 + 2 + 3 * 2 + 2 * 10)
    assert fwd == 4 * (4 * 10 + 4 * 2)
    assert counts.s1_forward_bound_s(2, 5) == pytest.approx(
        max(fwd / 3.35e12, 400 / 34e12))
    # adjoint reads delta, resid, m, P (4 * 10), s2 and 3 cotangents
    # (4 * 2), writes 2 * 10 + 2
    bwd = 4 * (4 * 10 + 4 * 2 + 2 * 10 + 2)
    assert bwd == 4 * (6 * 10 + 5 * 2)
    assert counts.s1_backward_bound_s(2, 5) == pytest.approx(
        max(bwd / 3.35e12, 500 / 34e12))


def test_s1_bytes_bound_at_the_cells_shape():
    # memory, not arithmetic, bounds S1 at (505, 999)
    b, n = 505, 999
    assert counts.s1_forward_bound_s(b, n) == pytest.approx(
        4 * (4 * b * n + 4 * b) / 3.35e12)


def test_call_ops_by_hand():
    # 2 assets, n 3, 1 step a stage, 4 paths of 5 steps
    fit = 2 * 3 * (30 + 15 + 102)
    paths = 2 * 4 * 5 * (10 + 4)
    assert counts.call_ops(2, 3, 5, 4, (1, 1, 1)) == fit + paths
    assert counts.call_ops(2, 3, 5, 4, (2, 0, 0)) == 2 * 3 * 60 + paths
