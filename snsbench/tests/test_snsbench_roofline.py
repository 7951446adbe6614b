"""The kernels' work as the benchmark counts it."""
import pytest

from snsbench import roofline


def test_a_cell_key_is_one_64_bit_word():
    assert roofline.KEY_BYTES == 8


def test_k7_bytes_read_each_cell_once_and_each_table_cell_twice():
    assert roofline.k7_bytes(cells=10, table_cells=100) == 10 * (8 + 4) + 100 * 8


def test_k8_bytes_read_each_key_and_table_cell_once():
    assert roofline.k8_bytes(queries=40_000, pool_cells=600_000) == \
        40_000 * (8 + 4) + 600_000 * 4


def test_the_bound_is_the_larger_of_bytes_and_operations():
    assert roofline.bound_s(3.35e12) == pytest.approx(1.0)
    assert roofline.bound_s(0.0, flops=67e12) == pytest.approx(1.0)
    assert roofline.bound_s(3.35e12, flops=2 * 67e12) == pytest.approx(2.0)
    assert roofline.share_pct(1e-3, 4e-3) == 25.0
