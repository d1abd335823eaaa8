"""Two-DLA model selection: injected 0/1/2-absorber spectra must be
classified correctly, and the outputs must feed the multi-DLA analysis
path."""

import numpy as np
import pytest

from gp_dla_detection.inference import PaddedSpectra
from gp_dla_detection.models.qso_model import GPModel
from gp_dla_detection.multi_dla import (
    make_base_sample_inds,
    multi_dla_rate_priors,
    process_spectra_multi,
)
from gp_dla_detection.ops.voigt import voigt_absorption
from gp_dla_detection.params import NullModelParams, Parameters


def test_base_sample_inds_resample_posterior():
    sll = np.full((2, 100), -50.0)
    sll[0, 7] = 0.0   # spectrum 0's posterior concentrates on sample 7
    sll[1, 42] = 0.0
    base = make_base_sample_inds(sll, seed=0)
    assert base.shape == (2, 100)
    assert (base[0] == 7).mean() > 0.95
    assert (base[1] == 42).mean() > 0.95
    # a flat posterior resamples ~uniformly
    flat = make_base_sample_inds(np.zeros((1, 100)), seed=1)
    assert len(np.unique(flat[0])) > 90


def test_base_sample_inds_nan_row_does_not_corrupt_neighbours():
    """Regression (code review): an all-NaN likelihood row (fully-masked
    spectrum) broke the flat searchsorted's sortedness and silently
    corrupted the base indices of every LATER row in the chunk."""
    rng = np.random.default_rng(5)
    sll = rng.normal(-10.0, 3.0, (4, 200))
    clean = make_base_sample_inds(sll, seed=0)
    poisoned = sll.copy()
    poisoned[1] = np.nan
    out = make_base_sample_inds(poisoned, seed=0)
    # rows after the NaN row must be identical to the clean run
    np.testing.assert_array_equal(out[2], clean[2])
    np.testing.assert_array_equal(out[3], clean[3])
    np.testing.assert_array_equal(out[0], clean[0])
    # the degenerate row falls back to ~uniform resampling
    assert len(np.unique(out[1])) > 150
    # all -inf behaves the same as all-NaN
    poisoned[1] = -np.inf
    out2 = make_base_sample_inds(poisoned, seed=0)
    np.testing.assert_array_equal(out2, out)


def test_prior_dla_multiplicity_none_marker():
    """None / empty absorber lists are the documented 'no redshifts'
    marker (same contract as correct_prior_dla_flags) and count as 1."""
    from gp_dla_detection.multi_dla import prior_dla_multiplicity

    num = prior_dla_multiplicity(
        np.array([4.0, 4.0, 4.0, 4.0]),
        np.array([True, True, True, False]),
        [None, np.array([]), np.array([3.5, 3.6]), None],
    )
    assert list(num) == [1, 1, 2, 0]


def test_multi_dla_rate_priors():
    params = Parameters()
    prior_z = np.array([2.0, 2.1, 2.2, 2.3])
    prior_num = np.array([0, 1, 2, 1])
    lp0, lp1, lp2 = multi_dla_rate_priors(
        np.array([2.5]), prior_z, prior_num, params
    )
    # all 4 below the cut: 3 with >=1, 1 with >=2
    assert np.isclose(lp2[0], np.log(1 / 4))
    assert np.isclose(lp1[0], np.log(2 / 4))
    assert np.isclose(lp0[0], np.log(1 / 4))


def test_multi_dla_rate_priors_degenerate():
    """counts == 0 -> documented limit (p_none=1), warning-free."""
    import warnings

    params = Parameters()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        lp0, lp1, lp2 = multi_dla_rate_priors(
            np.array([2.0]), np.array([3.0, 3.2]), np.array([1, 2]), params
        )
    assert lp0[0] == 0.0 and lp1[0] == -np.inf and lp2[0] == -np.inf


@pytest.fixture(scope="module")
def multi_problem():
    rng = np.random.default_rng(3)
    params = Parameters(null_model=NullModelParams(k=4))
    grid = params.null_model.rest_wavelengths()
    model = GPModel(
        rest_wavelengths=grid,
        mu=1.0 + 0.1 * np.sin(grid / 40),
        M=rng.normal(size=(grid.size, 4)) * 0.04,
        log_omega=np.log(0.1 + 0 * grid),
        log_c_0=np.log(0.1),
        log_tau_0=np.log(0.0023),
        log_beta=np.log(3.65),
    )
    P = 1280  # full Lyα coverage up to z ~ 3
    z_qso = np.array([3.0, 3.0, 3.0])
    lam = np.stack(
        [10 ** (np.log10(911.9 * (1 + z)) + 1e-4 * np.arange(P)) for z in z_qso]
    )
    noise_sd = 0.08
    flux = np.empty((3, P))
    for i in range(3):
        rest = lam[i] / (1 + z_qso[i])
        mu_i = np.interp(rest, grid, model.mu)
        flux[i] = mu_i + rng.normal(0, noise_sd, P)

    def absorb(i, z_dla, log_n):
        ext = np.concatenate(
            [
                lam[i, :1] * 10 ** (-1e-4 * np.arange(3, 0, -1)),
                lam[i],
                lam[i, -1:] * 10 ** (1e-4 * np.arange(1, 4)),
            ]
        )
        flux[i] *= np.asarray(
            voigt_absorption(ext, z_dla, 10.0**log_n, num_lines=3)
        )

    # spectrum 0: clean; spectrum 1: one DLA; spectrum 2: two DLAs
    absorb(1, 2.6, 20.8)
    absorb(2, 2.45, 20.7)
    absorb(2, 2.85, 20.9)

    spectra = PaddedSpectra(
        lam, flux, np.full((3, P), noise_sd**2), np.ones((3, P), bool), z_qso
    )
    S = 600
    offsets = rng.uniform(size=S)
    nhis = 10 ** rng.uniform(20.2, 21.3, S)
    prior_z = rng.uniform(2.2, 3.6, 400)
    prior_num = rng.choice([0, 0, 0, 0, 0, 0, 0, 1, 1, 2], 400)
    res = process_spectra_multi(
        model, offsets, nhis, spectra, prior_z, prior_num,
        params=params, batch_size=3, sample_chunk=100,
    )
    return params, model, spectra, offsets, nhis, prior_z, prior_num, res


def test_two_dla_classification(multi_problem):
    params, model, spectra, offsets, nhis, prior_z, prior_num, res = multi_problem

    picks = np.argmax(res.model_posteriors, axis=1)
    assert picks[0] == 0, res.model_posteriors[0]
    assert picks[1] == 1, res.model_posteriors[1]
    assert picks[2] == 2, res.model_posteriors[2]
    assert res.model_posteriors[2, 2] > 0.9

    # invalid (too-close) pairs are NaN, valid pairs finite
    lls2 = res.sample_log_likelihoods_dla2
    assert np.isnan(lls2).any()
    assert np.isfinite(lls2[2][~np.isnan(lls2[2])]).all()

    # the outputs feed the second-DLA analysis path
    from gp_dla_detection.analysis import DLACatalogue

    cat = DLACatalogue(
        res.single.p_dlas,
        res.single.min_z_dlas,
        res.single.max_z_dlas,
        res.single.sample_log_likelihoods_dla,
        res.single.log_likelihoods_dla,
        offsets,
        np.log10(nhis),
        sample_log_likelihoods_2=lls2,
        base_sample_inds=res.base_sample_inds,
        p_dla_2=res.model_posteriors[:, 2],
    )
    assert cat.second_dla
    z_cent, dndx, _, _, _ = cat.line_density(z_min=2.0, z_max=3.0)
    assert dndx.sum() > 0


def test_two_dla_float32(multi_problem):
    """The float32 two-DLA path must agree with the float64 one:
    identical close-pair NaN masks and base draws, matching posteriors,
    and per-pair log likelihoods within f32 end-to-end tolerance."""
    params, model, spectra, offsets, nhis, prior_z, prior_num, res = multi_problem
    rp = process_spectra_multi(
        model, offsets, nhis, spectra, prior_z, prior_num,
        params=params, batch_size=3, sample_chunk=100, dtype=np.float32,
    )
    assert np.array_equal(
        np.isnan(rp.sample_log_likelihoods_dla2),
        np.isnan(res.sample_log_likelihoods_dla2),
    )
    np.testing.assert_array_equal(rp.base_sample_inds, res.base_sample_inds)
    rel = np.abs(
        rp.sample_log_likelihoods_dla2 - res.sample_log_likelihoods_dla2
    ) / np.maximum(np.abs(res.sample_log_likelihoods_dla2), 1.0)
    assert np.nanmax(rel) < 1e-2
    np.testing.assert_allclose(
        rp.model_posteriors, res.model_posteriors, atol=2e-3
    )


def test_two_dla_checkpoint_resume(multi_problem, tmp_path):
    """Per-batch two-DLA checkpoints resume bit-identically and are
    invalidated when the run shape changes."""
    params, model, spectra, offsets, nhis, prior_z, prior_num, res = multi_problem
    ck = tmp_path / "ck"
    kw = dict(params=params, batch_size=2, sample_chunk=100, checkpoint_dir=ck)
    r1 = process_spectra_multi(
        model, offsets, nhis, spectra, prior_z, prior_num, **kw
    )
    assert (ck / "manifest.json").exists()
    assert len(list(ck.glob("batch_*.npz"))) == 2
    # resume: batches load from disk, results bit-identical
    r2 = process_spectra_multi(
        model, offsets, nhis, spectra, prior_z, prior_num, **kw
    )
    np.testing.assert_array_equal(
        r1.sample_log_likelihoods_dla2, r2.sample_log_likelihoods_dla2
    )
    # shape change invalidates the checkpoints with a warning
    with pytest.warns(UserWarning, match="incompatible two-DLA"):
        process_spectra_multi(
            model, offsets[:300], nhis[:300], spectra, prior_z, prior_num,
            params=params, batch_size=2, sample_chunk=100, checkpoint_dir=ck,
        )


def test_multi_results_roundtrip(multi_problem, tmp_path):
    params, model, spectra, offsets, nhis, prior_z, prior_num, res = multi_problem
    res.save(tmp_path / "multi.npz")
    with np.load(tmp_path / "multi.npz") as f:
        assert f["multi_model_posteriors"].shape == (3, 3)
        assert f["sample_log_likelihoods_dla2"].shape == (3, 600)
        assert f["base_sample_inds"].shape == (3, 600)
        assert "p_dlas" in f.files  # single-DLA fields included


def test_multi_matlab_roundtrip(multi_problem, tmp_path):
    """Multi-DLA export must load back through the 3-D-format importer
    into a second-DLA-capable catalogue."""
    from gp_dla_detection.io.matio import (
        load_catalogue_from_matlab,
        write_dla_samples_mat,
        write_multi_processed_mat,
    )

    params, model, spectra, offsets, nhis, prior_z, prior_num, res = multi_problem
    write_multi_processed_mat(res, np.ones(3), tmp_path / "multi.mat")

    class S:
        offset_samples = offsets
        log_nhi_samples = np.log10(nhis)
        nhi_samples = nhis

        class config:
            uniform_min_log_nhi = 20.0
            uniform_max_log_nhi = 23.0
            fit_min_log_nhi = 20.0
            fit_max_log_nhi = 22.0
            alpha = 0.9

    write_dla_samples_mat(S, tmp_path / "samples.mat")
    cat = load_catalogue_from_matlab(
        tmp_path / "multi.mat", tmp_path / "samples.mat"
    )
    assert cat.second_dla
    np.testing.assert_array_equal(cat.base_sample_inds, res.base_sample_inds)
    # the best PAIR for the two-absorber spectrum has its fresh-axis
    # absorber at one injected redshift and its base-axis (posterior
    # resampled) absorber at the other
    j = int(np.nanargmax(res.sample_log_likelihoods_dla2[2]))
    z_range = cat.z_max(2) - cat.z_min(2)
    z_fresh = cat.z_min(2) + z_range * offsets[j]
    z_base = cat.z_min(2) + z_range * offsets[res.base_sample_inds[2, j]]
    zs = sorted([z_fresh, z_base])
    # sample discreteness: the best joint pair must place its two
    # absorbers near the two injected redshifts (one per axis)
    assert abs(zs[0] - 2.45) < 0.12 and abs(zs[1] - 2.85) < 0.12, zs


def test_two_dla_full_lyman_series_float32(multi_problem):
    """Pair evaluator at num_lines=31 (the reference kernel's default,
    voigt.c:266): the optical depths of BOTH absorbers accumulate over
    all 31 lines; float32 must track the float64 oracle."""
    import dataclasses

    import jax.numpy as jnp

    from gp_dla_detection.multi_dla import make_batch_dla2_fn
    from gp_dla_detection.params import kms_to_z

    params, model, spectra, offsets, nhis, prior_z, prior_num, res = multi_problem
    params31 = dataclasses.replace(params, num_lines=31)
    S = 96
    off = 0.30 + 0.15 * offsets[:S]
    nh = nhis[:S]
    rng = np.random.default_rng(7)
    base = rng.integers(0, S, size=(len(spectra), S))
    off_b = off[base]
    nh_b = nh[base]
    fn = make_batch_dla2_fn(model, params31, S, 48, kms_to_z(3000.0))

    def run(dt):
        return np.asarray(
            fn(
                jnp.asarray(spectra.wavelengths, dt),
                jnp.asarray(spectra.flux, dt),
                jnp.asarray(spectra.noise_variance, dt),
                jnp.asarray(spectra.mask),
                jnp.asarray(spectra.z_qso, dt),
                jnp.asarray(model.rest_wavelengths, dt),
                jnp.asarray(model.mu, dt),
                jnp.asarray(model.M, dt),
                jnp.asarray(model.log_omega, dt),
                jnp.asarray(off, dt), jnp.asarray(nh, dt),
                jnp.asarray(off_b, dt), jnp.asarray(nh_b, dt),
            ),
            np.float64,
        )

    a, b = run(np.float64), run(np.float32)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    rel = np.abs(a - b) / np.maximum(np.abs(a), 1.0)
    # f32 roundoff accumulates over 31 lines x TWO absorbers' optical
    # depths (the single-absorber 31-line bound is 5e-5)
    assert np.nanmax(rel) < 5e-4


def test_base_sample_inds_chunking_bit_identical():
    """Row-chunked resampling (the ~80 GB -> ~4 GB peak-memory fix at
    survey scale) must be bit-identical to the unchunked form: rows are
    independent and the shuffled grid depends only on (seed, S)."""
    from gp_dla_detection.multi_dla import make_base_sample_inds

    rng = np.random.default_rng(3)
    sll = rng.normal(-500, 30, (257, 129)).astype(np.float32)
    sll[5, :] = -np.inf  # a row with no finite weight must not crash
    sll[5, 7] = -3.0
    full = make_base_sample_inds(sll, row_chunk=10**9)
    np.testing.assert_array_equal(
        make_base_sample_inds(sll, row_chunk=77), full
    )
