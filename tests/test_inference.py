"""End-to-end single-spectrum inference vs an independent numpy oracle.

The oracle transcribes the reference's per-quasar math
(process_qsos.m:102-217) with explicit slicing, scipy dense MVN logpdfs,
and the scipy-wofz Voigt oracle — entirely independent of the JAX code
paths under test.
"""

import numpy as np
import pytest
from scipy.stats import multivariate_normal

from gp_dla_detection.inference import (
    PaddedSpectra,
    correct_prior_dla_flags,
    dla_rate_priors,
    finalize_posteriors,
    process_spectra,
)
from gp_dla_detection.models.qso_model import GPModel
from gp_dla_detection.params import (
    LYA_WAVELENGTH,
    LYMAN_LIMIT,
    Parameters,
)

from test_voigt import oracle_voigt


def make_model(rng, k=5):
    params = Parameters()
    grid = params.null_model.rest_wavelengths()
    R = grid.size
    mu = 1.0 + 0.1 * np.sin(grid / 50.0)
    M = rng.normal(size=(R, k)) * 0.05
    log_omega = np.log(0.2 + 0.05 * rng.uniform(size=R))
    return GPModel(
        rest_wavelengths=grid,
        mu=mu,
        M=M,
        log_omega=log_omega,
        log_c_0=np.log(0.1),
        log_tau_0=np.log(0.0023),
        log_beta=np.log(3.65),
    )


def make_spectrum(rng, z_qso=2.8, P=640, n_real=600):
    """Padded spectrum on an exactly uniform log10 grid with masked holes."""
    params = Parameters()
    lam0 = 911.9 * (1 + z_qso)  # rest ~911.9 Å at blue end
    log_lam = np.log10(lam0) + 1e-4 * np.arange(P)
    wavelengths = 10**log_lam
    flux = rng.normal(1.0, 0.3, size=P)
    noise = rng.uniform(0.05, 0.3, size=P)
    mask = np.zeros(P, bool)
    mask[:n_real] = True
    # punch some masked holes inside the modelling range
    holes = rng.choice(np.arange(50, n_real - 50), size=25, replace=False)
    mask[holes] = False
    return PaddedSpectra(
        wavelengths=wavelengths[None],
        flux=flux[None],
        noise_variance=noise[None],
        mask=mask[None],
        z_qso=np.array([z_qso]),
    )


def oracle_spectrum(model, spec, offsets, nhis, params, misaligned=False):
    """Reference-semantics per-spectrum computation in numpy/scipy.

    ``misaligned=True`` applies the reference's actual (buggy)
    absorption selection — the FIRST nnz values of the in-range profile
    (process_qsos.m:180) — instead of the intended aligned selection.
    """
    lam = spec.wavelengths[0]
    flux = spec.flux[0]
    noise = spec.noise_variance[0]
    mask = spec.mask[0]
    z_qso = spec.z_qso[0]

    rest = lam / (1 + z_qso)
    in_range = (rest >= params.null_model.min_lambda) & (
        rest <= params.null_model.max_lambda
    )
    unmasked_lam = lam[in_range]  # all in-range pixels (process_qsos.m:107-109)
    keep = in_range & mask
    lam_k, rest_k, flux_k, noise_k = lam[keep], rest[keep], flux[keep], noise[keep]

    # model interpolation
    mu = np.interp(rest_k, model.rest_wavelengths, model.mu)
    M = np.stack(
        [
            np.interp(rest_k, model.rest_wavelengths, model.M[:, j])
            for j in range(model.k)
        ],
        axis=1,
    )
    log_omega = np.interp(rest_k, model.rest_wavelengths, model.log_omega)
    lya_zs = (lam_k - LYA_WAVELENGTH) / LYA_WAVELENGTH
    scaling = 1 - np.exp(-model.tau_0 * (1 + lya_zs) ** model.beta) + model.c_0
    omega2 = np.exp(2 * log_omega) * scaling**2

    def dense_ll(y, mean, Mm, d):
        return multivariate_normal.logpdf(y, mean=mean, cov=Mm @ Mm.T + np.diag(d))

    null_ll = dense_ll(flux_k, mu, M, omega2 + noise_k)

    max_z = lam_k.max() / LYA_WAVELENGTH - 1 - params.max_z_cut
    min_z = max(
        lam_k.min() / LYA_WAVELENGTH - 1,
        LYMAN_LIMIT * (1 + z_qso) / LYA_WAVELENGTH - 1 + params.min_z_cut,
    )
    z_dlas = min_z + (max_z - min_z) * offsets

    # conv padding built by log-continuation of the in-range grid
    # (process_qsos.m:169-177)
    w = params.instrument.width
    dex = params.instrument.pixel_spacing
    left = 10 ** (np.log10(unmasked_lam.min()) - dex * np.arange(w, 0, -1))
    right = 10 ** (np.log10(unmasked_lam.max()) + dex * np.arange(1, w + 1))
    padded = np.concatenate([left, unmasked_lam, right])

    rel_mask = mask[in_range]  # intended alignment (see inference.py quirk note)
    sample_lls = np.empty(len(offsets))
    for s in range(len(offsets)):
        absorption = oracle_voigt(padded, z_dlas[s], nhis[s], params.num_lines)
        # aligned (intended) vs first-nnz (reference quirk) selection
        a = absorption[: rel_mask.sum()] if misaligned else absorption[rel_mask]
        sample_lls[s] = dense_ll(
            flux_k, mu * a, M * a[:, None], omega2 * a**2 + noise_k
        )
    return null_ll, sample_lls, min_z, max_z


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(7)
    params = Parameters()
    model = make_model(rng)
    spec = make_spectrum(rng)
    samples = rng.uniform(size=40)
    nhis = 10 ** rng.uniform(20.0, 22.0, size=40)
    return params, model, spec, samples, nhis


def test_single_spectrum_matches_oracle(setup):
    params, model, spec, offsets, nhis = setup
    null_ll, sample_lls, min_z, max_z = oracle_spectrum(
        model, spec, offsets, nhis, params
    )

    results = process_spectra(
        model,
        offsets,
        nhis,
        spec,
        prior_z_qsos=np.array([2.0, 2.5, 3.0, 3.5]),
        prior_dla_flags=np.array([True, False, True, False]),
        params=params,
        batch_size=1,
        sample_chunk=8,
    )

    assert abs(results.log_likelihoods_no_dla[0] - null_ll) < 1e-6 * abs(null_ll)
    np.testing.assert_allclose(
        results.sample_log_likelihoods_dla[0], sample_lls, rtol=1e-6
    )
    assert abs(results.min_z_dlas[0] - min_z) < 1e-10
    assert abs(results.max_z_dlas[0] - max_z) < 1e-10

    # posteriors follow the safe aggregation (process_qsos.m:200-232)
    max_ll = sample_lls.max()
    exp_dla_ll = max_ll + np.log(np.mean(np.exp(sample_lls - max_ll)))
    assert abs(results.log_likelihoods_dla[0] - exp_dla_ll) < 1e-8 * abs(exp_dla_ll)
    assert np.isclose(results.p_dlas[0] + results.p_no_dlas[0], 1.0)


def test_reference_misaligned_absorption_quirk(setup):
    """Opt-in reproduction of process_qsos.m:180 (the all-true ``ind``
    that selects the first nnz absorption pixels): must match the
    first-nnz oracle on a spectrum with masked in-range pixels, differ
    from the aligned default there, and be a no-op on a hole-free
    spectrum."""
    params, model, spec, offsets, nhis = setup
    prior_z = np.array([2.0, 2.5, 3.0, 3.5])
    prior_flags = np.array([True, False, True, False])
    run = lambda sp, quirk: process_spectra(
        model, offsets, nhis, sp, prior_z, prior_flags,
        params=params, batch_size=1, sample_chunk=8,
        reference_misaligned_absorption=quirk,
    )

    # spec has 25 masked holes inside the modelling range (make_spectrum)
    _, lls_misaligned, _, _ = oracle_spectrum(
        model, spec, offsets, nhis, params, misaligned=True
    )
    res_quirk = run(spec, True)
    np.testing.assert_allclose(
        res_quirk.sample_log_likelihoods_dla[0], lls_misaligned, rtol=1e-6
    )
    res_default = run(spec, False)
    assert not np.allclose(
        res_quirk.sample_log_likelihoods_dla[0],
        res_default.sample_log_likelihoods_dla[0],
        rtol=1e-6,
    )
    # null model is untouched by the quirk
    np.testing.assert_allclose(
        res_quirk.log_likelihoods_no_dla, res_default.log_likelihoods_no_dla
    )

    # no masked pixels in range -> the quirk selects the aligned pixels
    rng = np.random.default_rng(11)
    clean = make_spectrum(rng)
    clean.mask[:, :600] = True  # heal the holes (pad tail stays masked)
    np.testing.assert_allclose(
        run(clean, True).sample_log_likelihoods_dla,
        run(clean, False).sample_log_likelihoods_dla,
        rtol=1e-12,
    )


def test_dla_rate_priors_counting():
    params = Parameters()
    prior_z = np.array([2.0, 2.1, 2.2, 3.0, 3.1])
    flags = np.array([True, False, True, False, True])
    lp_dla, lp_no = dla_rate_priors(np.array([2.25]), prior_z, flags, params)
    # z < 2.25 + dz(30000 km/s ~ 0.1) = 2.35: prior quasars {2.0,2.1,2.2}, 2 DLAs
    assert np.isclose(lp_dla[0], np.log(2) - np.log(3))
    assert np.isclose(lp_no[0], np.log(1) - np.log(3))


def test_dla_rate_priors_degenerate_edges():
    """counts == 0 and num_dlas == 0 edges: documented limits, no NaN,
    no RuntimeWarnings (the reference NaNs here, process_qsos.m:122-132)."""
    import warnings

    params = Parameters()
    prior_z = np.array([3.0, 3.1, 3.2])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        # test z below every prior quasar -> counts == 0
        lp_dla, lp_no = dla_rate_priors(
            np.array([2.0]), prior_z, np.array([True, False, True]), params
        )
        assert lp_dla[0] == -np.inf and lp_no[0] == 0.0
        # counts > 0 but zero DLAs among them
        lp_dla, lp_no = dla_rate_priors(
            np.array([3.5]), prior_z, np.array([False, False, False]), params
        )
        assert lp_dla[0] == -np.inf and np.isclose(lp_no[0], 0.0)
        # all prior quasars host DLAs
        lp_dla, lp_no = dla_rate_priors(
            np.array([3.5]), prior_z, np.array([True, True, True]), params
        )
        assert np.isclose(lp_dla[0], 0.0) and lp_no[0] == -np.inf
    # degenerate prior still yields finite, normalized posteriors
    from gp_dla_detection.inference import finalize_posteriors

    post = finalize_posteriors(
        np.array([0.0]), np.array([-np.inf]), np.array([-10.0]),
        np.array([[-9.0, -11.0]]),
    )
    assert np.allclose(post["model_posteriors"], [[1.0, 0.0]])


def test_correct_prior_dla_flags():
    # DLA with Lyα below the QSO Lyman limit must be dropped
    z_qsos = np.array([4.0, 4.0])
    flags = np.array([True, True])
    z_dlas = [np.array([2.0]), np.array([3.5])]
    # (1+2.0)*1215.67 = 3647 < (1+4)*911.76 = 4558.8 -> dropped
    # (1+3.5)*1215.67 = 5470 > 4558.8 -> kept
    out = correct_prior_dla_flags(z_qsos, flags, z_dlas)
    assert list(out) == [False, True]

    # the documented "no DLA" markers (None / empty) must not crash and
    # must leave the flag untouched (matching the reference's behaviour
    # for an empty vectorized `if`)
    out = correct_prior_dla_flags(
        np.array([4.0, 4.0, 4.0]),
        np.array([True, True, True]),
        [None, np.array([]), np.array([2.0])],
    )
    assert list(out) == [True, True, False]


def test_batching_invariance(setup):
    """Batched/padded execution must match per-spectrum execution."""
    params, model, spec, offsets, nhis = setup
    rng = np.random.default_rng(11)
    specs = [make_spectrum(rng, z_qso=z) for z in (2.6, 2.9, 3.3)]
    batch = PaddedSpectra(
        *(
            np.concatenate([getattr(s, f) for s in specs])
            for f in ("wavelengths", "flux", "noise_variance", "mask", "z_qso")
        )
    )
    prior_z = np.array([2.0, 2.5, 3.0, 3.5])
    prior_f = np.array([True, False, True, False])

    r_batch = process_spectra(
        model, offsets, nhis, batch, prior_z, prior_f,
        params=params, batch_size=2, sample_chunk=40,
    )
    for i, s in enumerate(specs):
        r_one = process_spectra(
            model, offsets, nhis, s, prior_z, prior_f,
            params=params, batch_size=1, sample_chunk=40,
        )
        np.testing.assert_allclose(
            r_batch.sample_log_likelihoods_dla[i],
            r_one.sample_log_likelihoods_dla[0],
            rtol=1e-12,
        )
        np.testing.assert_allclose(
            r_batch.log_likelihoods_no_dla[i],
            r_one.log_likelihoods_no_dla[0],
            rtol=1e-12,
        )


def test_windowed_fast_path_matches(setup):
    """The z-sorted windowed Voigt fast path must agree with the plain
    f32 path to fp32 accumulation accuracy."""
    import jax.numpy as jnp
    from gp_dla_detection.inference import (
        batch_log_likelihoods,
        compute_sample_window,
    )

    params, model, spec, offsets, nhis = setup
    dtype = np.float32
    args = (
        jnp.asarray(spec.wavelengths, dtype),
        jnp.asarray(spec.flux, dtype),
        jnp.asarray(spec.noise_variance, dtype),
        jnp.asarray(spec.mask),
        jnp.asarray(spec.z_qso, dtype),
        jnp.asarray(model.rest_wavelengths, dtype),
        jnp.asarray(model.mu, dtype),
        jnp.asarray(model.M, dtype),
        jnp.asarray(model.log_omega, dtype),
        model.log_c_0,
        model.log_tau_0,
        model.log_beta,
        jnp.asarray(offsets, dtype),
        jnp.asarray(nhis, dtype),
    )
    plain = batch_log_likelihoods(
        *args, params=params, sample_chunk=8, sample_window=None
    )
    window = compute_sample_window(offsets, 8, spec.wavelengths.shape[1] + 6)
    assert window is not None
    windowed = batch_log_likelihoods(
        *args, params=params, sample_chunk=8, sample_window=window
    )
    a = np.asarray(plain["sample_log_likelihoods_dla"], np.float64)
    b = np.asarray(windowed["sample_log_likelihoods_dla"], np.float64)
    scale = np.maximum(np.abs(a), 1.0)
    assert np.max(np.abs(a - b) / scale) < 5e-5


def test_window_bound_covers_exact_chunk_spread():
    """Regression (code review): the linear bound spread*num_pixels
    understates a low-z chunk's pixel spread on the log-uniform grid —
    the exact spread is log10((1+z_hi)/(1+z_lo))/pixel_spacing, whose
    worst case over the z_DLA search range is log10(1+spread*R)/spacing
    with R = LYA/LY_LIMIT - 1.  The sized window minus both margins
    must cover that for every chunking."""
    from gp_dla_detection.inference import compute_sample_window
    from gp_dla_detection.ops.voigt import WINDOW_MARGIN
    from gp_dla_detection.params import LYA_WAVELENGTH, LYMAN_LIMIT

    spacing = 1e-4
    ratio = LYA_WAVELENGTH / LYMAN_LIMIT - 1.0
    offsets = np.linspace(0.0, 1.0, 10_000)
    for chunk in (128, 256, 1000, 2500, 3300, 5000):
        window = compute_sample_window(
            offsets, chunk, 1280, pixel_spacing=spacing
        )
        if window is None:
            continue
        spread = offsets[chunk - 1] - offsets[0]
        exact_px = np.log10(1.0 + spread * ratio) / spacing
        assert window - 2 * WINDOW_MARGIN >= exact_px, (
            chunk, window, exact_px
        )


def test_sample_window_independent_of_line_count():
    """A chunk's line-center spread in pixels is the same for every
    Lyman line, so the window size has no line-count input and the
    31-line series is windowed like the 3-line one."""
    import inspect

    from gp_dla_detection.inference import compute_sample_window

    assert "num_lines" not in inspect.signature(compute_sample_window).parameters
    offsets = np.linspace(0.0, 1.0, 10_000)
    window = compute_sample_window(offsets, 256, 1280)
    assert window is not None and window % 8 == 0 and window < 1280
    assert compute_sample_window(offsets, 10_000, 1280) is None


def test_windowed_columns_follow_sample_order(setup):
    """The windowed path z-sorts the samples inside the graph and
    un-sorts the result: permuting the input samples permutes the
    output columns exactly."""
    import jax.numpy as jnp
    from gp_dla_detection.inference import (
        batch_log_likelihoods,
        compute_sample_window,
    )

    params, model, spec, offsets, nhis = setup
    dtype = np.float32
    order = np.argsort(offsets, kind="stable")

    def run(off, nh, **kw):
        return np.asarray(
            batch_log_likelihoods(
                jnp.asarray(spec.wavelengths, dtype),
                jnp.asarray(spec.flux, dtype),
                jnp.asarray(spec.noise_variance, dtype),
                jnp.asarray(spec.mask),
                jnp.asarray(spec.z_qso, dtype),
                jnp.asarray(model.rest_wavelengths, dtype),
                jnp.asarray(model.mu, dtype),
                jnp.asarray(model.M, dtype),
                jnp.asarray(model.log_omega, dtype),
                model.log_c_0,
                model.log_tau_0,
                model.log_beta,
                jnp.asarray(off, dtype),
                jnp.asarray(nh, dtype),
                params=params, sample_chunk=8, **kw,
            )["sample_log_likelihoods_dla"]
        )

    window = compute_sample_window(offsets, 8, spec.wavelengths.shape[1] + 6)
    assert window is not None
    default = run(offsets, nhis, sample_window=window)
    permuted = run(offsets[order], nhis[order], sample_window=window)
    np.testing.assert_array_equal(permuted, default[:, order])


def test_windowed_large_window_coverage():
    """Regression (code review): with the old window//4 offset, windows
    above ~270 px failed to cover the highest-z samples of each chunk,
    silently corrupting their likelihoods.  Exercise a large window
    (big chunk -> wide spread) and demand agreement with the plain path."""
    import jax.numpy as jnp
    from gp_dla_detection.inference import (
        batch_log_likelihoods,
        compute_sample_window,
    )

    rng = np.random.default_rng(21)
    params = Parameters()
    model = make_model(rng, k=4)
    spec = make_spectrum(rng, z_qso=3.0, P=1280, n_real=1270)
    S = 800
    offsets = rng.uniform(size=S)
    nhis = 10 ** rng.uniform(20.0, 21.5, S)

    dtype = np.float32
    args = (
        jnp.asarray(spec.wavelengths, dtype),
        jnp.asarray(spec.flux, dtype),
        jnp.asarray(spec.noise_variance, dtype),
        jnp.asarray(spec.mask),
        jnp.asarray(spec.z_qso, dtype),
        jnp.asarray(model.rest_wavelengths, dtype),
        jnp.asarray(model.mu, dtype),
        jnp.asarray(model.M, dtype),
        jnp.asarray(model.log_omega, dtype),
        model.log_c_0,
        model.log_tau_0,
        model.log_beta,
        jnp.asarray(offsets, dtype),
        jnp.asarray(nhis, dtype),
    )
    chunk = 400  # half the samples per chunk -> window ~ 0.5*1286 + 80
    window = compute_sample_window(offsets, chunk, 1286)
    assert window is not None and window > 300, window

    plain = batch_log_likelihoods(
        *args, params=params, sample_chunk=chunk, sample_window=None
    )
    windowed = batch_log_likelihoods(
        *args, params=params, sample_chunk=chunk, sample_window=window
    )
    a = np.asarray(plain["sample_log_likelihoods_dla"], np.float64)
    b = np.asarray(windowed["sample_log_likelihoods_dla"], np.float64)
    scale = np.maximum(np.abs(a), 1.0)
    assert np.max(np.abs(a - b) / scale) < 5e-5


def test_gpmodel_interpolate_matches_engine_prep(setup):
    """The convenience GPModel.interpolate must agree with the engine's
    internal interpolation (same interp1/interp_columns kernels)."""
    params, model, spec, _, _ = setup
    rest = spec.wavelengths[0] / (1 + spec.z_qso[0])
    mu, M, log_omega = model.interpolate(rest)
    np.testing.assert_allclose(
        np.asarray(mu), np.interp(rest, model.rest_wavelengths, model.mu),
        rtol=1e-12,
    )
    for j in (0, model.k - 1):
        np.testing.assert_allclose(
            np.asarray(M)[:, j],
            np.interp(rest, model.rest_wavelengths, model.M[:, j]),
            rtol=1e-12,
        )


def test_gp_model_grid_validation_tolerates_f32_storage():
    """The uniform-spacing gate scales with the stored dtype's ulp: an
    arange-built grid round-tripped through float32 (spacing jitter
    ~2 ulp at 1216 Å) must be accepted; a genuinely non-uniform grid
    must still be rejected (ADVICE r2)."""
    import pytest as _pytest

    grid64 = np.arange(911.75, 1215.76, 0.25)
    n, k = grid64.size, 2

    def make(grid):
        return GPModel(
            rest_wavelengths=grid,
            mu=np.ones(n),
            M=np.zeros((n, k)),
            log_omega=np.zeros(n),
            log_c_0=0.0,
            log_tau_0=0.0,
            log_beta=0.0,
        )

    make(grid64)
    make(grid64.astype(np.float32))  # f32 rounding jitter is fine
    bad = grid64.copy()
    bad[100] += 0.1  # 40% of dx: a real non-uniformity
    with _pytest.raises(ValueError, match="uniformly spaced"):
        make(bad)


def test_search_range_policy_methods():
    """Parameters' z_DLA range policy (set_parameters.m:65-73) is the
    single definition used by the engine."""
    params = Parameters()
    lam = np.linspace(4000.0, 5000.0, 100)
    assert np.isclose(
        params.max_z_dla(lam, 3.0),
        5000.0 / LYA_WAVELENGTH - 1 - params.max_z_cut,
    )
    # Lyman-limit bound dominates for high z_qso
    z_qso = 4.5
    expected = (
        LYMAN_LIMIT * (1 + z_qso) / LYA_WAVELENGTH - 1 + params.min_z_cut
    )
    assert np.isclose(params.min_z_dla(lam, z_qso), expected)


def test_long_spectrum_runs_on_the_xla_path():
    """A 4096-pixel spectrum (past any fixed on-chip tile) runs through
    the one evidence path, finite and equal to the per-spectrum run."""
    from gp_dla_detection.params import NullModelParams

    rng = np.random.default_rng(5)
    params = Parameters(null_model=NullModelParams(k=3))
    grid = params.null_model.rest_wavelengths()
    model = GPModel(
        rest_wavelengths=grid,
        mu=1.0 + 0.1 * np.sin(grid / 40),
        M=rng.normal(size=(grid.size, 3)) * 0.05,
        log_omega=np.log(0.15 + 0 * grid),
        log_c_0=np.log(0.1),
        log_tau_0=np.log(0.0023),
        log_beta=np.log(3.65),
    )
    B, P = 2, 4096
    z = rng.uniform(2.8, 3.1, B)
    lam = np.stack(
        [10 ** (np.log10(911.9 * (1 + zz)) + 1e-4 * np.arange(P)) for zz in z]
    )
    spectra = PaddedSpectra(
        lam,
        rng.normal(1, 0.3, (B, P)),
        rng.uniform(0.05, 0.2, (B, P)),
        rng.uniform(size=(B, P)) > 0.05,
        z,
    )
    offsets = rng.uniform(size=24)
    nhis = 10 ** rng.uniform(20, 22, 24)
    prior_z = rng.uniform(2.0, 3.5, 100)
    flags = rng.uniform(size=100) < 0.3

    res = process_spectra(
        model, offsets, nhis, spectra, prior_z, flags,
        params=params, batch_size=B, sample_chunk=24, dtype=np.float32,
    )
    one = process_spectra(
        model, offsets, nhis, spectra.slice(slice(1, 2)), prior_z, flags,
        params=params, batch_size=1, sample_chunk=24, dtype=np.float32,
    )
    assert np.isfinite(res.sample_log_likelihoods_dla).all()
    np.testing.assert_allclose(
        res.sample_log_likelihoods_dla[1], one.sample_log_likelihoods_dla[0],
        rtol=1e-5,
    )


def _failing_evaluator(*args, **kwargs):
    from jax.errors import JaxRuntimeError

    raise JaxRuntimeError("RESOURCE_EXHAUSTED: out of memory")


@pytest.mark.parametrize(
    "driver",
    ["process_spectra", "process_spectra_multi", "sharded", "sharded_multi",
     "fused_lean"],
)
def test_drivers_raise_evaluator_failures(driver, monkeypatch):
    """Every driver dispatches its one evaluator: a compile, lowering or
    out-of-memory failure propagates — no driver retries on another
    configuration or backend, and nothing is printed as a warning."""
    import warnings

    from jax.errors import JaxRuntimeError

    from gp_dla_detection import inference, multi_dla
    from gp_dla_detection.parallel import (
        ShardedRunConfig,
        make_mesh,
        process_spectra_multi_sharded,
        process_spectra_sharded,
        sharded_inference,
        sharded_multi,
    )

    rng = np.random.default_rng(3)
    params = Parameters()
    model = make_model(rng, k=3)
    spec = make_spectrum(rng, z_qso=3.0, P=256, n_real=250)
    offsets = rng.uniform(size=16)
    nhis = 10 ** rng.uniform(20.0, 21.5, 16)
    prior_z = rng.uniform(2.0, 3.5, 50)
    prior_num = (rng.uniform(size=50) < 0.3).astype(int)
    failing = lambda *a, **k: _failing_evaluator

    if driver == "process_spectra":
        monkeypatch.setattr(inference, "batch_log_likelihoods", _failing_evaluator)
        run = lambda: inference.process_spectra(
            model, offsets, nhis, spec, prior_z, prior_num >= 1,
            params=params, batch_size=1, sample_chunk=8,
        )
    elif driver == "process_spectra_multi":
        monkeypatch.setattr(multi_dla, "make_batch_dla2_fn", failing)
        run = lambda: multi_dla.process_spectra_multi(
            model, offsets, nhis, spec, prior_z, prior_num,
            params=params, batch_size=1, sample_chunk=8,
        )
    else:
        config = ShardedRunConfig(
            per_device_batch=1, sample_chunk=8,
            store_sample_likelihoods=driver != "fused_lean",
        )
        mesh = make_mesh(1)
        if driver == "sharded":
            monkeypatch.setattr(sharded_inference, "single_evaluator", failing)
            run = lambda: process_spectra_sharded(
                model, offsets, nhis, spec, prior_z, prior_num >= 1,
                params=params, mesh=mesh, config=config,
            )
        else:
            monkeypatch.setattr(sharded_multi, "make_batch_dla2_fn", failing)
            run = lambda: process_spectra_multi_sharded(
                model, offsets, nhis, spec, prior_z, prior_num,
                params=params, mesh=mesh, config=config,
            )
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(JaxRuntimeError, match="RESOURCE_EXHAUSTED"):
            run()
