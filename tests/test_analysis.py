"""Analysis layer: Poisson-binomial machinery vs brute force, path
lengths vs scipy quadrature, and catalogue statistics on a synthetic
posterior with known ground truth."""

import itertools

import numpy as np
import pytest
from scipy.integrate import quad
from scipy.stats import poisson

from gp_dla_detection.analysis.cddf import DLACatalogue
from gp_dla_detection.analysis.cosmology import (
    AbsorptionPath,
    path_length_integrand,
    rho_crit,
)
from gp_dla_detection.analysis.pb import (
    combine_with_poisson,
    interval,
    pdf_confidence,
    poisson_binomial_pdf,
)


def brute_force_pb(p):
    """Exact Poisson-binomial PDF by enumeration (n <= 20)."""
    n = len(p)
    pdf = np.zeros(n + 1)
    for bits in itertools.product([0, 1], repeat=n):
        prob = 1.0
        for b, pi in zip(bits, p):
            prob *= pi if b else (1 - pi)
        pdf[sum(bits)] += prob
    return pdf


@pytest.mark.parametrize("n", [1, 2, 5, 12])
def test_poisson_binomial_vs_brute_force(n):
    rng = np.random.default_rng(n)
    p = rng.uniform(0.05, 0.95, n)
    ours = poisson_binomial_pdf(p)
    exact = brute_force_pb(p)
    np.testing.assert_allclose(ours, exact, atol=1e-12)


def test_poisson_binomial_accepts_list_of_arrays():
    pdf = poisson_binomial_pdf([np.array([0.5, 0.6]), np.array([0.7])])
    exact = brute_force_pb([0.5, 0.6, 0.7])
    np.testing.assert_allclose(pdf, exact, atol=1e-12)
    np.testing.assert_allclose(poisson_binomial_pdf([]), [1.0])


def test_poisson_binomial_storage_noise_clamped():
    """f32 sample-matrix round trips can hand the DFT a "probability"
    of 1 + O(1e-6) (a posterior concentrated on one sample; seen at
    survey scale).  The input must be
    clamped into [0, 1] — the naive path emits a negative pdf mass the
    output clip would turn into a normalization error — while a
    genuinely out-of-range value still fails loudly."""
    pdf = poisson_binomial_pdf([1.0000020352524501])
    np.testing.assert_allclose(pdf, [0.0, 1.0], atol=1e-12)
    pdf = poisson_binomial_pdf([-1e-7, 0.5])
    assert abs(pdf.sum() - 1.0) < 1e-12
    with pytest.raises(AssertionError):
        poisson_binomial_pdf([1.5])


def test_combine_with_poisson_matches_direct_convolution():
    p = [0.4, 0.8, 0.9]
    pdf_pb = poisson_binomial_pdf(p)
    lam = 2.5
    pdf_comb, offset = combine_with_poisson(pdf_pb, lam)
    # direct dense convolution
    N = 60
    direct = np.zeros(N)
    for i, pb in enumerate(pdf_pb):
        direct[i : i + 40] += pb * poisson(lam).pmf(np.arange(40))
    ours = np.zeros(N)
    ours[offset : offset + len(pdf_comb)] = pdf_comb
    np.testing.assert_allclose(ours, direct[:N], atol=2e-4)


def test_pdf_confidence_gaussian_like():
    x = np.arange(101)
    pdf = np.exp(-0.5 * ((x - 50) / 5.0) ** 2)
    pdf /= pdf.sum()
    maxlike, l68, l95 = pdf_confidence(pdf, offset=0)
    assert abs(maxlike - 50) <= 1
    assert 4 <= (l68[1] - l68[0]) / 2 <= 7       # ~1 sigma
    assert 8 <= (l95[1] - l95[0]) / 2 <= 12      # ~2 sigma


def test_interval_point_mass():
    assert interval(np.array([1.0]), 0.68, offset=3) == (3, 3)


def test_absorption_path_vs_quad():
    path = AbsorptionPath()
    for z1, z2 in [(2.0, 2.5), (0.1, 5.0), (3.3, 3.31)]:
        exact, _ = quad(path_length_integrand, z1, z2)
        assert abs(path(z1, z2) - exact) < 1e-8 * max(exact, 1.0)
    # vectorized total with clamping
    total = path.total_path([1.0, 2.0], [3.0, 4.0], 2.5, 3.5)
    e1, _ = quad(path_length_integrand, 2.5, 3.0)
    e2, _ = quad(path_length_integrand, 2.5, 3.5)
    assert abs(total - (e1 + e2)) < 1e-8


def test_rho_crit_value():
    # ~9.2e-30 g/cm^3 for h=0.7
    assert 9e-30 < rho_crit(0.7) < 9.5e-30


def make_synthetic_catalogue(
    n_certain=30, n_empty=200, n_weak=50, p_weak=0.1, S=400, seed=0
):
    """Spectra with posteriors concentrated at known (z, logN) samples.

    - n_certain spectra with p_dla = 1 and posterior mass on a single
      sample at logN = 20.85, z mid-range.
    - n_weak spectra with p_dla = p_weak (same sample).
    - n_empty spectra with p_dla ~ 0.
    Expected DLA count = n_certain + n_weak * p_weak.
    """
    rng = np.random.default_rng(seed)
    n = n_certain + n_empty + n_weak
    z_min = np.full(n, 2.0)
    z_max = np.full(n, 3.0)
    offsets = rng.uniform(size=S)
    lnhi = rng.uniform(20.0, 22.5, S)
    # target sample: force sample 0 to (offset 0.5 -> z=2.5, logN 20.8)
    offsets[0] = 0.55  # z = 2.55 (off bin edges)
    lnhi[0] = 20.85  # off CDDF bin edges

    # log likelihoods: concentrated on sample 0
    sll = np.full((n, S), -200.0)
    sll[:, 0] = 0.0
    # log evidence consistent with normalization: sum_s exp(sll - ll - logS) = 1
    ll_dla = np.log(np.sum(np.exp(sll - np.log(S)), axis=1))

    p_dla = np.concatenate(
        [
            np.ones(n_certain) * 0.999999,
            np.full(n_empty, 1e-8),
            np.full(n_weak, p_weak),
        ]
    )
    return DLACatalogue(
        p_dla, z_min, z_max, sll, ll_dla, offsets, lnhi, snrs=None
    )


def test_line_density_recovers_expected_count():
    cat = make_synthetic_catalogue()
    # all mass at z=2.55, logN=20.85 -> expected 30 + 50*0.1 = 35 DLAs
    z_cent, dNdX, dndx68, dndx95, _ = cat.line_density(z_min=2.0, z_max=3.0)
    # find the bin containing z=2.5
    path = AbsorptionPath()
    nbins = len(z_cent)
    z_bins = np.linspace(2.0, 3.0, nbins + 1)
    b = np.searchsorted(z_bins, 2.55) - 1
    dX_bin = 280 * path(max(z_bins[b], 2.0), min(z_bins[b + 1], 3.0))
    expected = 35.0 / dX_bin
    assert abs(dNdX[b] - expected) / expected < 0.1
    # other bins are empty
    for j in range(nbins):
        if j != b:
            assert dNdX[j] == 0.0
    # intervals bracket the estimate
    assert dndx95[b, 0] <= dNdX[b] <= dndx95[b, 1]


def test_cddf_mass_in_right_bin():
    cat = make_synthetic_catalogue()
    l_cent, cddf, cddf68, cddf95, _ = cat.column_density_function(
        z_min=2.0, z_max=3.0, lnhi_nbins=30, lnhi_min=20.0, lnhi_max=23.0
    )
    b = np.argmin(np.abs(l_cent - 20.85))
    assert cddf[b] > 0
    off_bins = np.flatnonzero(np.abs(l_cent - 20.85) > 0.2)
    assert np.all(cddf[off_bins] == 0)


def test_omega_estimators_agree():
    cat = make_synthetic_catalogue()
    z_c1, om_cddf, om68, om95, _ = cat.omega_dla_cddf(z_min=2.0, z_max=3.0)
    z_c2, om_direct, err, _ = cat.omega_dla(z_min=2.0, z_max=3.0)
    b = np.argmin(np.abs(z_c1 - 2.55))
    b2 = np.argmin(np.abs(z_c2 - 2.55))
    assert om_cddf[b] > 0 and om_direct[b2] > 0
    # the CDDF-summed and direct-moment estimates agree to ~bin effects
    assert abs(om_cddf[b] - om_direct[b2]) / om_direct[b2] < 0.2
    assert om95[b, 0] <= om_cddf[b] <= om95[b, 1]


def test_snr_filter_and_condition():
    cat = make_synthetic_catalogue()
    cat.snrs = np.full(cat.p_dla.size, 10.0)
    cat.snrs[:10] = 0.5  # kill 10 of the certain spectra
    cat.snr_thresh = 1.0
    z_cent, dNdX, _, _, _ = cat.line_density(z_min=2.0, z_max=3.0)
    b = np.argmax(dNdX)
    # expected count drops from 35 to 25
    path = AbsorptionPath()
    nbins = len(z_cent)
    z_bins = np.linspace(2.0, 3.0, nbins + 1)
    dX_bin = 270 * path(z_bins[b], z_bins[b + 1])  # 280 - 10 sightlines
    assert abs(dNdX[b] - 25.0 / dX_bin) / (25.0 / dX_bin) < 0.1


def test_bootstrap_runs():
    cat = make_synthetic_catalogue(n_certain=20, n_empty=100, n_weak=20)
    out = cat.get_sample_errors(z_min=2.0, z_max=3.0, nsample=3, seed=1)
    assert out["dndx_median"].shape == out["dndx_68"].shape[1:]
    assert np.all(out["omega_68"][0] <= out["omega_68"][1] + 1e-12)


def test_bootstrap_handles_empty_bins_and_wide_range():
    """Regression (code review): draws whose resampled spectra leave a
    z bin with zero path length return fewer bins than other draws —
    aggregation must align on the common grid (ragged np.array raises
    on numpy >= 1.24), with all-empty bins NaN."""
    cat = make_synthetic_catalogue(n_certain=20, n_empty=100, n_weak=20)
    # z_max far beyond the data: the top bins have zero path in EVERY
    # draw and must come back NaN on the common grid, not crash
    out = cat.get_sample_errors(z_min=2.0, z_max=6.0, nsample=3, seed=1)
    nbins = max(int((6.0 - 2.0) * cat.bins_per_z), 1)
    assert out["z_cent"].shape == (nbins,)
    assert out["dndx_median"].shape == (nbins,)
    assert np.isnan(out["dndx_median"][-1])  # empty top bin
    assert np.isfinite(out["dndx_median"]).any()


def test_resampled_accessors_match_view_semantics():
    """Regression (code review): per-spectrum accessors resolve the
    bootstrap index instead of fancy-indexing a full-array copy; the
    values must equal the old _view(arr)[spec] semantics."""
    cat = make_synthetic_catalogue(n_certain=10, n_empty=30)
    cat.resample(True, seed=7)
    r = cat._resample
    for spec in (0, 3, len(r) - 1):
        np.testing.assert_array_equal(
            cat._log_norm_like(spec), cat.log_norm_like[r[spec]]
        )
        assert cat.z_min(spec) == cat._z_min[r[spec]]
        assert cat.z_max(spec) == cat._z_max[r[spec]]
    # vector access still works
    np.testing.assert_array_equal(cat.z_min(), cat._z_min[r])
    cat.resample(False)
    np.testing.assert_array_equal(cat._log_norm_like(1), cat.log_norm_like[1])


def test_find_max_like_and_deltas():
    cat = make_synthetic_catalogue()
    lnhi, z = cat.find_max_like(0)
    assert abs(lnhi - 20.85) < 1e-12 and abs(z - 2.55) < 1e-12
    assert cat.find_delta_nhi(0) == 0.0
    assert cat.find_delta_z(0) == 0.0


def make_two_dla_catalogue(n_certain=20, n_empty=150, S=400, seed=2):
    """Spectra whose first DLA sits at (z=2.55, logN=20.85) and whose
    second DLA (p = 0.5 of exactly-two) sits at (z=2.15, logN=21.45)."""
    rng = np.random.default_rng(seed)
    n = n_certain + n_empty
    z_min = np.full(n, 2.0)
    z_max = np.full(n, 3.0)
    offsets = rng.uniform(size=S)
    lnhi = rng.uniform(20.0, 22.5, S)
    offsets[0] = 0.55
    lnhi[0] = 20.85
    offsets[5] = 0.15  # z = 2.15: the second DLA's parameters
    lnhi[5] = 21.45

    sll = np.full((n, S), -200.0)
    sll[:, 0] = 0.0
    ll_dla = np.log(np.sum(np.exp(sll - np.log(S)), axis=1))
    p_dla = np.concatenate(
        [np.full(n_certain, 0.999999), np.full(n_empty, 1e-8)]
    )

    # second-DLA posterior: all mass on first-DLA sample 0, whose
    # second absorber is sample index 5
    sll2 = np.full((n, S), -200.0)
    sll2[:, 0] = 0.0
    sll2[:, 7] = np.nan  # NaN samples (too-close pairs) must be ignored
    base = np.full((n, S), 3, dtype=np.int64)
    base[:, 0] = 5
    p_dla_2 = np.concatenate(
        [np.full(n_certain, 0.5), np.full(n_empty, 1e-9)]
    )
    return DLACatalogue(
        p_dla, z_min, z_max, sll, ll_dla, offsets, lnhi,
        sample_log_likelihoods_2=sll2, base_sample_inds=base,
        p_dla_2=p_dla_2,
    )


def test_second_dla_counts():
    cat = make_two_dla_catalogue()
    assert cat.second_dla
    # line density must now include both absorbers: 20 DLAs at z=2.55
    # plus 20 * 0.5 second DLAs at z=2.15
    z_cent, dNdX, _, _, _ = cat.line_density(z_min=2.0, z_max=3.0)
    path = AbsorptionPath()
    nbins = len(z_cent)
    z_bins = np.linspace(2.0, 3.0, nbins + 1)
    b1 = np.searchsorted(z_bins, 2.55) - 1
    b2 = np.searchsorted(z_bins, 2.15) - 1
    n_sightlines = 170
    dX1 = n_sightlines * path(z_bins[b1], z_bins[b1 + 1])
    dX2 = n_sightlines * path(z_bins[b2], z_bins[b2 + 1])
    assert abs(dNdX[b1] - 20.0 / dX1) / (20.0 / dX1) < 0.1
    assert abs(dNdX[b2] - 10.0 / dX2) / (10.0 / dX2) < 0.15

    # CDDF: mass in both logN bins
    l_cent, cddf, _, _, _ = cat.column_density_function(
        z_min=2.0, z_max=3.0, lnhi_nbins=30, lnhi_min=20.0, lnhi_max=23.0
    )
    assert cddf[np.argmin(np.abs(l_cent - 20.85))] > 0
    assert cddf[np.argmin(np.abs(l_cent - 21.45))] > 0

    # second-DLA MAP diagnostics
    lnhi_map, z_map = cat.find_max_like(0, second=True)
    assert abs(lnhi_map - 21.45) < 1e-12 and abs(z_map - 2.15) < 1e-12

    # bootstrap with the second-DLA posterior (the reference raises
    # here, calc_cddf.py:128): an identity resample must reproduce the
    # un-resampled statistics exactly, and a random draw must run
    base_dndx = cat.line_density(z_min=2.0, z_max=3.0)[1]
    cat.resample(True)
    cat._resample = np.arange(cat.p_dla.size)  # identity draw
    np.testing.assert_array_equal(
        cat.line_density(z_min=2.0, z_max=3.0)[1], base_dndx
    )
    cat.resample(True, seed=5)
    boot_dndx = cat.line_density(z_min=2.0, z_max=3.0)[1]
    assert np.all(np.isfinite(boot_dndx)) and boot_dndx.sum() > 0
    cat.resample(False)


def test_cddf_lnhi_max_forwarded():
    """Bins above the default 23.0 must still receive counts when a
    larger lnhi_max is requested (regression: the filter previously
    stayed at the default)."""
    cat = make_synthetic_catalogue()
    # move the posterior mass above the old hardcoded cap
    cat.lnhi_vals = cat.lnhi_vals.copy()
    cat.lnhi_vals[0] = 23.55
    l_cent, cddf, _, _, _ = cat.column_density_function(
        z_min=2.0, z_max=3.0, lnhi_nbins=40, lnhi_min=20.0, lnhi_max=24.0
    )
    b = np.argmin(np.abs(l_cent - 23.55))
    assert cddf[b] > 0


def test_omega_dla_empty_path_bins():
    cat = make_synthetic_catalogue()
    # z bins beyond every sightline's range have zero path
    z_cent, omega, err, _ = cat.omega_dla(z_min=2.0, z_max=5.0)
    assert np.all(np.isfinite(omega)) and np.all(np.isfinite(err))
    assert np.all(omega[z_cent > 3.1] == 0)


def test_noisy_pixel_excision():
    """Path length shrinks when noisy pixel stretches are excised."""
    cat = make_synthetic_catalogue(n_certain=5, n_empty=20, n_weak=5)
    n = cat.p_dla.size
    # pixel noise arrays spanning each spectrum's [z_min, z_max]
    pn = []
    for i in range(n):
        arr = np.full(100, 0.01)
        if i % 2 == 0:
            arr[40:60] = 1.0  # a noisy stretch above the 0.25 threshold
        pn.append(arr)
    cat.pixel_noise = pn
    cat.filter_noisy_pixels = True
    full = AbsorptionPath().total_path(cat._z_min, cat._z_max, 2.0, 3.0)
    excised = cat.path_length(2.0, 3.0)
    assert excised < full
    # ~20% of path removed on half the sightlines -> ~10% reduction
    assert 0.85 < excised / full < 0.95

    # sample filtering also drops samples landing on the noisy stretch
    probs, poissons = cat._split_distributions(
        np.array([2.0, 3.0]), 2.0, 3.0, lnhi_min=20.0, lnhi_max=23.0
    )
    total_noisy = sum(float(np.sum(np.concatenate(p))) if p else 0.0 for p in probs) + poissons.sum()
    cat.filter_noisy_pixels = False
    probs2, poissons2 = cat._split_distributions(
        np.array([2.0, 3.0]), 2.0, 3.0, lnhi_min=20.0, lnhi_max=23.0
    )
    total_all = sum(float(np.sum(np.concatenate(p))) if p else 0.0 for p in probs2) + poissons2.sum()
    assert total_noisy <= total_all


def test_compute_pixel_noise(synthetic_release):
    from gp_dla_detection.analysis import compute_pixel_noise
    from gp_dla_detection.catalog import build_catalog
    from gp_dla_detection.spectra import preload_qsos

    params = synthetic_release
    cat = build_catalog(params)
    spectra = preload_qsos(cat, params)
    good = np.flatnonzero(cat.filter_flags == 0)
    min_z = np.full(good.size, 2.0)
    max_z = cat.z_qsos[good] - 0.1
    pn = compute_pixel_noise(spectra, good, min_z, max_z)
    assert len(pn) == good.size
    assert all(np.all(np.isfinite(p)) and p.size > 0 for p in pn)
