"""Traversal kernel (interpret mode) on LBVH tables: every scene x mode x
leaf size against the f64 oracle and the XLA stack engine."""
import pytest

from kernel_cases import LEAF_SIZES, MODES, SCENES, check_case


@pytest.mark.parametrize("leaf_size", LEAF_SIZES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", SCENES)
def test_kernel_lbvh(name, mode, leaf_size):
    check_case(name, mode, leaf_size, "lbvh")
