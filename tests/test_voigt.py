"""Voigt absorption profiles vs an independent fp64 numpy/scipy oracle.

The oracle reimplements the documented semantics of the reference MEX
kernel (voigt.c:253-304) directly in numpy using scipy.special.wofz as
the libcerf stand-in; our JAX op must agree to ~1e-8 relative.
"""

import numpy as np
from scipy.special import wofz

from gp_dla_detection.ops import lyman_series as lines
from gp_dla_detection.ops.voigt import instrumental_broadening, voigt_absorption
from gp_dla_detection.params import InstrumentParams


def oracle_voigt(wavelengths, z, nhi, num_lines=3, width=3):
    """numpy/scipy transcription of voigt.c semantics (not its code)."""
    sigma = lines.DOPPLER_SIGMA
    c = lines.C_CGS
    total = np.zeros_like(wavelengths)
    for j in range(num_lines):
        mult = c / (lines.TRANSITION_WAVELENGTHS[j] * (1 + z)) / 1e8
        velocity = wavelengths * mult - c
        zz = (velocity + 1j * lines.LORENTZIAN_WIDTHS[j]) / (sigma * np.sqrt(2))
        voigt_val = wofz(zz).real / (sigma * np.sqrt(2 * np.pi))
        total += -lines.LEADING_CONSTANTS[j] * voigt_val
    raw = np.exp(nhi * total)

    taps = InstrumentParams(width=width).profile()
    n_out = len(wavelengths) - 2 * width
    out = np.zeros(n_out)
    for i in range(n_out):
        out[i] = np.dot(raw[i : i + 2 * width + 1], taps)
    return out


def make_wavelengths(n=700, z_qso=3.0):
    # log-spaced observed grid like BOSS (1e-4 dex pixels)
    lam_min = 911.75 * (1 + z_qso) * 0.98
    return 10 ** (np.log10(lam_min) + 1e-4 * np.arange(n))


def test_instrument_profile_matches_reference_taps():
    # voigt.c:242-251 hard-codes the 7 taps; we derive them from R=2000
    taps = InstrumentParams().profile()
    expected = np.array(
        [
            2.17460992138080811e-03,
            4.11623059580451742e-02,
            2.40309364651846963e-01,
            4.32707438937454059e-01,
            2.40309364651846963e-01,
            4.11623059580451742e-02,
            2.17460992138080811e-03,
        ]
    )
    np.testing.assert_allclose(taps, expected, rtol=1e-12)


def test_voigt_absorption_matches_oracle():
    lam = make_wavelengths()
    rng = np.random.default_rng(0)
    z_dlas = rng.uniform(2.0, 3.0, size=8)
    nhis = 10 ** rng.uniform(20.0, 22.5, size=8)

    ours = np.asarray(voigt_absorption(lam, z_dlas, nhis, num_lines=3))
    assert ours.shape == (8, len(lam) - 6)
    for s in range(8):
        exact = oracle_voigt(lam, z_dlas[s], nhis[s])
        # absorption in [0, 1]; compare absolutely (wings) and relatively
        np.testing.assert_allclose(ours[s], exact, rtol=2e-7, atol=1e-10)


def test_scalar_sample_shape():
    lam = make_wavelengths(100)
    prof = np.asarray(voigt_absorption(lam, 2.5, 1e20))
    assert prof.shape == (94,)
    assert np.all(prof >= 0) and np.all(prof <= 1 + 1e-12)


def test_saturated_core_goes_to_zero():
    lam = make_wavelengths(3000, z_qso=2.5)
    z_dla = lam[1500] / 1215.6701 - 1  # center a strong DLA mid-grid
    prof = np.asarray(voigt_absorption(lam, z_dla, 1e22))
    assert prof.min() < 1e-30
    assert prof.max() > 0.99


def test_num_lines_adds_higher_series():
    lam = make_wavelengths(2000, z_qso=3.5)
    z_dla = 3.4
    p1 = np.asarray(voigt_absorption(lam, z_dla, 1e21, num_lines=1))
    p3 = np.asarray(voigt_absorption(lam, z_dla, 1e21, num_lines=3))
    # Lyb/Lyg absorption only strengthens absorption where it applies
    assert np.all(p3 <= p1 + 1e-12)
    assert (p1 - p3).max() > 1e-3


def test_full_series_31_lines_matches_oracle():
    """The reference kernel defaults to ALL 31 Lyman lines
    (voigt.c:266); prove parity at the full series, with the grid
    reaching down to the Lyman limit where the high series crowds."""
    lam = 10 ** (np.log10(911.75 * 4.0 * 0.98) + 1e-4 * np.arange(3000))
    rng = np.random.default_rng(1)
    z_dlas = rng.uniform(2.8, 2.95, 4)
    nhis = 10 ** rng.uniform(20.0, 22.0, 4)
    ours = np.asarray(
        voigt_absorption(lam, z_dlas, nhis, num_lines=31, fast=False)
    )
    for s in range(4):
        exact = oracle_voigt(lam, z_dlas[s], nhis[s], num_lines=31)
        np.testing.assert_allclose(ours[s], exact, rtol=2e-7, atol=1e-10)


def test_windowed_matches_full_at_31_lines():
    """Each line gets its own dynamic window (the chunk's pixel spread is
    line-independent in log-wavelength), so the windowed fast path is
    exact for any num_lines.  Any pixel escaping its window would take
    the wing series inside the Doppler core and show up here."""
    from gp_dla_detection.ops.voigt import (
        WINDOW_MARGIN,
        voigt_absorption_windowed,
    )

    lam = (10 ** (np.log10(911.75 * 4.0 * 0.98) + 1e-4 * np.arange(3000))).astype(
        np.float32
    )
    rng = np.random.default_rng(2)
    z = np.sort(rng.uniform(2.80, 2.93, 64)).astype(np.float32)
    nhi = (10 ** rng.uniform(20, 22, 64)).astype(np.float32)
    spread_px = np.log10((1 + z.max()) / (1 + z.min())) / 1e-4
    window = -(-(int(np.ceil(spread_px)) + 2 * WINDOW_MARGIN) // 8) * 8
    full = np.asarray(voigt_absorption(lam, z, nhi, num_lines=31))
    win = np.asarray(
        voigt_absorption_windowed(lam, z, nhi, num_lines=31, window=window)
    )
    np.testing.assert_allclose(win, full, rtol=1e-5, atol=1e-6)


def test_broadening_conserves_unit_continuum():
    raw = np.ones((3, 50))
    out = np.asarray(instrumental_broadening(raw, InstrumentParams()))
    np.testing.assert_allclose(out, 1.0, rtol=1e-12)


def test_scalar_z_vector_nhi_broadcasts():
    """Regression (code review): a column-density sweep at fixed z used
    to key 'scalar sample' on z alone and silently return only the
    first nhi's profile."""
    lam = 10 ** (np.log10(3650.0) + 1e-4 * np.arange(200))
    both = np.asarray(voigt_absorption(lam, 2.0, np.array([1e20, 1e22])))
    assert both.shape == (2, 194)
    one = np.asarray(voigt_absorption(lam, 2.0, 1e22))
    np.testing.assert_array_equal(both[1], one)
    assert not np.allclose(both[0], both[1])
    # the symmetric case: vector z, scalar nhi
    zs = np.asarray(voigt_absorption(lam, np.array([2.0, 2.05]), 1e21))
    assert zs.shape == (2, 194)
    # scalar-scalar still returns a 1-D profile
    assert np.asarray(voigt_absorption(lam, 2.0, 1e21)).shape == (194,)


def test_windowed_rejects_float64():
    """voigt_absorption_windowed is the float32 fast path (~1.2e-5 rel);
    silently serving it to an f64 parity run would masquerade as a
    numerics regression — it must refuse loudly."""
    import pytest

    from gp_dla_detection.ops.voigt import voigt_absorption_windowed

    lam = 10 ** (np.log10(3650.0) + 1e-4 * np.arange(200))
    with pytest.raises(ValueError, match="float32 fast path"):
        voigt_absorption_windowed(
            lam, np.array([2.0, 2.01]), np.array([1e20, 1e20])
        )
