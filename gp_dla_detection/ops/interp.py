"""Linear interpolation utilities (MATLAB interp1 / griddedInterpolant
semantics, vectorized for padded spectra).

The reference interpolates the learned model onto each spectrum's rest
wavelengths with griddedInterpolants (process_qsos.m:65-71) and training
spectra onto the rest grid with interp1 (learn_qso_model.m:50-59, which
yields NaN outside the data range).  Both are 1-D linear interpolations;
the (rest_wavelength, 1:k) "2-D" interpolant for M is columnwise 1-D
because the second axis is the integer factor index.

All functions assume ``xp`` is strictly increasing.  ``interp_columns``
computes the bracketing indices once and reuses them for every column,
which is how the engine interpolates mu, M, and log_omega in one pass.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "interp1",
    "interp_columns",
    "interp1_uniform",
    "interp_columns_uniform",
    "interp_stack_uniform",
]


def _bracket(xp, x):
    """Indices/weights of the bracketing interval for each x (clamped)."""
    idx = jnp.clip(jnp.searchsorted(xp, x, side="right") - 1, 0, xp.shape[0] - 2)
    x0 = xp[idx]
    x1 = xp[idx + 1]
    t = (x - x0) / (x1 - x0)
    return idx, t


def _bracket_uniform(xp, x):
    """_bracket for a UNIFORMLY spaced xp: the interval index comes from
    arithmetic instead of an O(log n) binary search of gather/compare
    steps (each step a vector gather).

    One ±1 correction against the actual knots makes the result
    bit-identical to :func:`_bracket` even when xp's values carry
    rounding at the ulp level (e.g. a float32 arange-built grid), so the
    generic and uniform paths are interchangeable on such grids.  Grids
    that are not uniform to within one cell of the arithmetic guess are
    outside this function's contract — use :func:`_bracket`.
    """
    n = xp.shape[0]
    inv_dx = (n - 1) / (xp[-1] - xp[0])
    idx = jnp.clip(
        jnp.floor((x - xp[0]) * inv_dx).astype(jnp.int32), 0, n - 2
    )
    # searchsorted(side="right") semantics at the knots: x == xp[i]
    # brackets [i, i+1) with t = 0
    idx = jnp.where(x < xp[idx], idx - 1, idx)
    idx = jnp.clip(jnp.where(x >= xp[idx + 1], idx + 1, idx), 0, n - 2)
    x0 = xp[idx]
    x1 = xp[idx + 1]
    t = (x - x0) / (x1 - x0)
    return idx, t


def interp1(xp, fp, x):
    """Linear interpolation, edge-clamped (like griddedInterpolant inside
    the data range; queries outside are linearly extrapolated from the
    end interval — the engine never queries outside)."""
    idx, t = _bracket(xp, x)
    return fp[idx] * (1.0 - t) + fp[idx + 1] * t


def interp_columns(xp, columns, x):
    """Interpolate a stack of columns (n_grid, k) at points x (m,).

    Returns (m, k).  Shares the searchsorted/bracketing work across
    columns (the reference's M_interpolator, process_qsos.m:67-68).
    """
    idx, t = _bracket(xp, x)
    return columns[idx, :] * (1.0 - t)[:, None] + columns[idx + 1, :] * t[:, None]


def interp1_uniform(xp, fp, x):
    """:func:`interp1` for uniformly spaced xp (bit-identical on such
    grids, without the binary search — the inference hot path: the
    learned model's rest grid is arange-built, params.py)."""
    idx, t = _bracket_uniform(xp, x)
    return fp[idx] * (1.0 - t) + fp[idx + 1] * t


def interp_columns_uniform(xp, columns, x):
    """:func:`interp_columns` for uniformly spaced xp."""
    idx, t = _bracket_uniform(xp, x)
    return columns[idx, :] * (1.0 - t)[:, None] + columns[idx + 1, :] * t[:, None]


def interp_stack_uniform(xp, stack, x):
    """Interpolate several quantities over ONE shared uniform grid with
    one bracketing and one row gather.

    ``stack``: sequence of (n,) or (n, k) arrays on the grid ``xp``.
    Returns the interpolated arrays in the same shapes ((m,) or (m, k)).

    Rationale: row gathers dominate the model-interpolation step of
    inference prepare; fusing [values | next-values] of every quantity
    into a single (n-1, 2w) table turns 2 gathers per quantity into one
    gather total.  Each output element is still computed as
    fp[idx]*(1-t) + fp[idx+1]*t, so results are BIT-identical to
    :func:`interp1_uniform` / :func:`interp_columns_uniform` (and hence
    to the generic searchsorted path on uniform grids).
    """
    stack = [jnp.asarray(a) for a in stack]  # materialize: a generator
    # input would otherwise be exhausted here and yield [] below
    flat = [a.ndim == 1 for a in stack]
    arrs = [a if a.ndim == 2 else a[:, None] for a in stack]
    widths = [a.shape[1] for a in arrs]
    f = jnp.concatenate(arrs, axis=1)
    ff = jnp.concatenate([f[:-1], f[1:]], axis=1)       # (n-1, 2w)
    idx, t = _bracket_uniform(xp, x)
    rows = ff[idx, :]
    w = f.shape[1]
    out = rows[:, :w] * (1.0 - t)[:, None] + rows[:, w:] * t[:, None]
    pieces = []
    start = 0
    for was_flat, width in zip(flat, widths):
        piece = out[:, start : start + width]
        pieces.append(piece[:, 0] if was_flat else piece)
        start += width
    return pieces
