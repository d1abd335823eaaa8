"""QMC prior-sample generation tests."""

import numpy as np
from scipy.integrate import quad

from gp_dla_detection.params import Parameters
from gp_dla_detection.samples import (
    DLASamples,
    generate_dla_samples,
    halton_rr2,
    matlab_ksdensity,
)


def test_halton_unscrambled_prefix():
    # classical van der Corput base 2 / base 3
    pts = halton_rr2(8, dims=2, scramble=False)
    np.testing.assert_allclose(
        pts[:, 0], [0, 1 / 2, 1 / 4, 3 / 4, 1 / 8, 5 / 8, 3 / 8, 7 / 8]
    )
    np.testing.assert_allclose(
        pts[:4, 1], [0, 1 / 3, 2 / 3, 1 / 9]
    )


def test_halton_rr2_is_permutation_of_unscrambled():
    # RR2 permutes digits; the point *set* at N = base^m is identical
    n = 81
    a = np.sort(halton_rr2(n, dims=2, scramble=True)[:, 1])
    b = np.sort(halton_rr2(n, dims=2, scramble=False)[:, 1])
    np.testing.assert_allclose(a, b, atol=1e-12)


def test_halton_uniformity():
    pts = halton_rr2(10000, dims=2)
    assert abs(pts[:, 0].mean() - 0.5) < 1e-3
    assert abs(pts[:, 1].mean() - 0.5) < 1e-3
    # QMC discrepancy should beat random sampling comfortably
    hist, _ = np.histogram(pts[:, 1], bins=50, range=(0, 1))
    assert np.abs(hist - 200).max() < 20


def test_ksdensity_matches_normal_reference():
    rng = np.random.default_rng(0)
    data = rng.normal(21.0, 0.4, size=2000)
    x = np.linspace(20, 22, 200)
    pdf = matlab_ksdensity(data, x)
    true = np.exp(-0.5 * ((x - 21.0) / 0.4) ** 2) / (0.4 * np.sqrt(2 * np.pi))
    assert np.max(np.abs(pdf - true)) < 0.08


def test_generate_dla_samples_marginals(tmp_path):
    rng = np.random.default_rng(1)
    observed = rng.normal(20.5, 0.5, size=500).clip(20.0, 22.3)
    params = Parameters()
    s = generate_dla_samples(observed, params)

    assert len(s) == 10000
    assert np.all((s.offset_samples >= 0) & (s.offset_samples < 1))
    assert np.all(s.log_nhi_samples >= params.dla_sampling.fit_min_log_nhi)
    assert np.all(s.log_nhi_samples <= 25.0)
    np.testing.assert_allclose(s.nhi_samples, 10**s.log_nhi_samples)

    # inverse transform correctness: the empirical CDF of log_nhi_samples
    # at a probe point must equal the analytic mixture CDF (QMC: ~1/N err)
    x = np.linspace(20.0, 22.0, 1000)
    kde = matlab_ksdensity(observed, x)
    coeffs = np.polyfit(x, np.log(kde), 2)
    Z, _ = quad(lambda t: np.exp(np.polyval(coeffs, t)), 20.0, 25.0)

    def mixture_pdf(t):
        uni = 1.0 / 3.0 if 20.0 <= t <= 23.0 else 0.0
        return 0.9 * np.exp(np.polyval(coeffs, t)) / Z + 0.1 * uni

    for probe in (20.5, 21.0, 22.0):
        analytic, _ = quad(mixture_pdf, 20.0, probe, limit=200)
        empirical = np.mean(s.log_nhi_samples <= probe)
        assert abs(empirical - analytic) < 2e-3

    # roundtrip
    s.save(tmp_path / "dla_samples.npz")
    s2 = DLASamples.load(tmp_path / "dla_samples.npz")
    np.testing.assert_array_equal(s.log_nhi_samples, s2.log_nhi_samples)
    assert s2.config.num_dla_samples == 10000
