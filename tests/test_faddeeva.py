"""Faddeeva / Voigt-function accuracy vs the scipy (libcerf-grade) oracle."""

import numpy as np
import pytest
from scipy.special import voigt_profile, wofz

from gp_dla_detection.ops import lyman_series as lines
from gp_dla_detection.ops.faddeeva import voigt_function, wofz_real

SIGMA = lines.DOPPLER_SIGMA
SQRT2 = np.sqrt(2.0)

# y = gamma/(sigma*sqrt2) for the Lyman lines actually used (3 of 31)
LINE_YS = lines.LORENTZIAN_WIDTHS / (SIGMA * SQRT2)


def rel_err(approx, exact):
    exact = np.asarray(exact)
    return np.max(np.abs((approx - exact) / exact))


@pytest.mark.parametrize("y", [*LINE_YS[:3], LINE_YS[30], 0.01, 0.5, 3.0])
def test_wofz_real_accuracy(y):
    # wide sweep: through the Doppler core, the branch radius, and far wings
    x = np.concatenate(
        [
            np.linspace(0.0, 10.0, 20001),
            10 ** np.linspace(1.0, 4.2, 5001),
        ]
    )
    exact = wofz(x + 1j * y).real
    ours = np.asarray(wofz_real(x, np.full_like(x, y)))
    assert rel_err(ours, exact) < 5e-8


def test_wofz_real_even_in_x():
    x = np.linspace(-50.0, 50.0, 1001)
    y = LINE_YS[0]
    a = np.asarray(wofz_real(x, np.full_like(x, y)))
    b = np.asarray(wofz_real(-x, np.full_like(x, y)))
    np.testing.assert_array_equal(a, b)


def test_voigt_function_vs_scipy_voigt_profile():
    # scipy.special.voigt_profile(x, sigma, gamma) is the same normalized
    # Voigt profile that libcerf's voigt() computes (voigt.c:288).
    v = np.concatenate([np.linspace(0, 1e7, 2001), 10 ** np.linspace(7, 10, 501)])
    for j in range(3):
        gamma = lines.LORENTZIAN_WIDTHS[j]
        exact = voigt_profile(v, SIGMA, gamma)
        ours = np.asarray(voigt_function(v, SIGMA, gamma))
        assert rel_err(ours, exact) < 5e-8


def test_float32_mode_reasonable():
    # fast mode: float32 inputs stay float32 and are ~1e-4 accurate
    x = np.linspace(0.0, 100.0, 10001, dtype=np.float32)
    y = np.full_like(x, np.float32(LINE_YS[0]))
    ours = np.asarray(wofz_real(x, y))
    assert ours.dtype == np.float32
    exact = wofz(x.astype(np.float64) + 1j * float(LINE_YS[0])).real
    assert rel_err(ours.astype(np.float64), exact) < 5e-4


def test_wofz_real_fast_accuracy():
    """Fast path: <1.6e-5 relative at all Lyman-series y values (f64
    eval; measured 1.2e-5 worst-case at the production degree-12 G)."""
    from gp_dla_detection.ops.faddeeva import wofz_real_fast

    x = np.concatenate(
        [np.linspace(0.0, 10.0, 20001), 10 ** np.linspace(1.0, 4.2, 3001)]
    )
    for y in LINE_YS[[0, 1, 2, 30]]:
        exact = wofz(x + 1j * y).real
        ours = np.asarray(wofz_real_fast(x, np.full_like(x, y)))
        assert rel_err(ours, exact) < 1.6e-5


def test_voigt_absorption_fast_close_to_accurate():
    from gp_dla_detection.ops.voigt import voigt_absorption

    lam = 10 ** (np.log10(3500.0) + 1e-4 * np.arange(900))
    rng = np.random.default_rng(3)
    z = rng.uniform(1.9, 2.4, 6)
    nhi = 10 ** rng.uniform(20, 22.5, 6)
    acc = np.asarray(voigt_absorption(lam, z, nhi, fast=False))
    fastp = np.asarray(voigt_absorption(lam, z, nhi, fast=True))
    assert np.max(np.abs(acc - fastp)) < 2e-5


def test_g_function_vs_dawson_everywhere():
    """The global rational G(x) = 2xF(x)-1 against scipy's Dawson F:
    true relative accuracy in the wing (|x| >= 3.5, where the
    Lorentzian term dominates Re w), absolute-with-exp-slack nearer the
    core (where e^{-x^2} dominates) -- the exact contract the fit was
    weighted for."""
    from scipy.special import dawsn

    from gp_dla_detection.ops.faddeeva import g_function

    # 2x dawsn(x) - 1 cancels catastrophically in f64 beyond x ~ 1e4
    # (G ~ 1/(2x^2) sinks below the eps of the ~1 terms), so the oracle
    # switches to the asymptotic series G = sum (2m-1)!!/(2x^2)^m there
    # (truncation < 1e-13 relative at x >= 30).
    x = np.concatenate(
        [np.linspace(0.0, 12.0, 60001), 10 ** np.linspace(1.08, 6.0, 4001)]
    )
    u = 0.5 / x[x >= 30.0] ** 2
    series = np.zeros_like(u)
    for c in (2027025.0, 135135.0, 10395.0, 945.0, 105.0, 15.0, 3.0, 1.0):
        series = (series + c) * u
    exact = np.where(
        x >= 30.0,
        np.concatenate([np.zeros((x < 30.0).sum()), series]),
        2.0 * x * dawsn(x) - 1.0,
    )
    ours = np.asarray(g_function(x))
    y_max = LINE_YS.max()
    slack = (np.sqrt(np.pi) / (2 * y_max)) * np.exp(-np.minimum(x * x, 200.0))
    rel = np.abs(ours - exact) / np.maximum(np.abs(exact), slack)
    assert rel.max() < 1.1e-5
    # wing region: strict relative accuracy
    wing = x >= 3.5
    assert np.max(np.abs(ours[wing] - exact[wing]) / exact[wing]) < 1.1e-5


def test_wofz_real_fast_property():
    """Property-based spot checks across the (x, y) DLA domain."""
    from hypothesis import given, settings, strategies as st
    from scipy.special import wofz

    from gp_dla_detection.ops.faddeeva import wofz_real_fast

    @settings(max_examples=200, deadline=None)
    @given(
        st.floats(min_value=-5e4, max_value=5e4, allow_nan=False),
        st.floats(min_value=1e-7, max_value=5e-4),
    )
    def check(x, y):
        exact = wofz(x + 1j * y).real
        ours = float(np.asarray(wofz_real_fast(np.float64(x), np.float64(y))))
        assert abs(ours - exact) <= 1.6e-5 * abs(exact)

    check()
