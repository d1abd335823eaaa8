"""Interpolation utilities: generic vs uniform-grid bracketing.

The inference hot path interpolates the learned model onto each
spectrum's rest wavelengths (process_qsos.m:65-71,138-143) over the
arange-built uniform rest grid; the uniform bracketing must be
BIT-identical to the generic searchsorted path there, including at
exact knots and outside the grid.
"""

import numpy as np
import pytest

from gp_dla_detection.ops.interp import (
    interp1,
    interp1_uniform,
    interp_columns,
    interp_columns_uniform,
)
from gp_dla_detection.params import NullModelParams


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_uniform_bracketing_bit_identical_on_model_grid(dtype):
    grid = NullModelParams().rest_wavelengths().astype(dtype)
    rng = np.random.default_rng(0)
    fp = rng.normal(size=grid.size).astype(dtype)
    cols = rng.normal(size=(grid.size, 5)).astype(dtype)
    x = np.concatenate(
        [
            rng.uniform(grid[0] - 2, grid[-1] + 2, 4000),
            grid[:: 17],                       # exact knots
            np.nextafter(grid[:: 31], np.inf),  # one ulp above knots
            np.nextafter(grid[:: 31], -np.inf),
            grid[[0, -1]],
        ]
    ).astype(dtype)

    ref1 = np.asarray(interp1(grid, fp, x))
    uni1 = np.asarray(interp1_uniform(grid, fp, x))
    np.testing.assert_array_equal(ref1, uni1)

    refc = np.asarray(interp_columns(grid, cols, x))
    unic = np.asarray(interp_columns_uniform(grid, cols, x))
    np.testing.assert_array_equal(refc, unic)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_stack_interp_bit_identical(dtype):
    """The fused one-gather stack interpolation must equal the per-array
    uniform variants bitwise (it is the inference hot path)."""
    from gp_dla_detection.ops.interp import interp_stack_uniform

    grid = NullModelParams().rest_wavelengths().astype(dtype)
    rng = np.random.default_rng(2)
    mu = rng.normal(size=grid.size).astype(dtype)
    lo = rng.normal(size=grid.size).astype(dtype)
    M = rng.normal(size=(grid.size, 7)).astype(dtype)
    x = np.concatenate(
        [rng.uniform(grid[0] - 1, grid[-1] + 1, 3000), grid[:: 13]]
    ).astype(dtype)

    mu_i, lo_i, M_i = interp_stack_uniform(grid, (mu, lo, M), x)
    np.testing.assert_array_equal(np.asarray(mu_i), np.asarray(interp1_uniform(grid, mu, x)))
    np.testing.assert_array_equal(np.asarray(lo_i), np.asarray(interp1_uniform(grid, lo, x)))
    np.testing.assert_array_equal(np.asarray(M_i), np.asarray(interp_columns_uniform(grid, M, x)))


def test_generic_bracketing_on_nonuniform_grid():
    """The generic path (used for per-spectrum wavelength grids, which
    are uniform in log lambda, not lambda) matches numpy.interp inside
    the data range."""
    rng = np.random.default_rng(1)
    xp = np.sort(rng.uniform(0, 10, 50))
    fp = rng.normal(size=50)
    x = rng.uniform(xp[0], xp[-1], 500)
    ours = np.asarray(interp1(xp, fp, x))
    np.testing.assert_allclose(ours, np.interp(x, xp, fp), rtol=1e-12, atol=1e-12)
