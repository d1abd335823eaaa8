"""The float32 evidence path against the float64 path, the windowed
Voigt option against the full grid, and masked non-finite inputs."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from gp_dla_detection.inference import PaddedSpectra, batch_log_likelihoods
from gp_dla_detection.models.qso_model import GPModel
from gp_dla_detection.params import NullModelParams, Parameters


def make_problem(B=2, P=384, S=160, k=5, seed=0):
    rng = np.random.default_rng(seed)
    params = Parameters(null_model=NullModelParams(k=k))
    grid = params.null_model.rest_wavelengths()
    model = GPModel(
        rest_wavelengths=grid,
        mu=1.0 + 0.1 * np.sin(grid / 40),
        M=rng.normal(size=(grid.size, k)) * 0.08,
        log_omega=np.log(0.2 + 0 * grid),
        log_c_0=np.log(0.1),
        log_tau_0=np.log(0.0023),
        log_beta=np.log(3.65),
    )
    z = rng.uniform(2.6, 3.2, B)
    lam = np.stack(
        [10 ** (np.log10(911.9 * (1 + zz)) + 1e-4 * np.arange(P)) for zz in z]
    )
    mask = rng.uniform(size=(B, P)) > 0.05
    spectra = PaddedSpectra(
        lam,
        rng.normal(1, 0.3, (B, P)),
        rng.uniform(0.05, 0.2, (B, P)),
        mask,
        z,
    )
    offsets = rng.uniform(size=S)
    nhis = 10 ** rng.uniform(20, 22, S)
    return params, model, spectra, offsets, nhis


def run(params, model, spectra, offsets, nhis, dtype=np.float32,
        sample_chunk=32, sample_window=None):
    args = (
        jnp.asarray(spectra.wavelengths, dtype),
        jnp.asarray(spectra.flux, dtype),
        jnp.asarray(spectra.noise_variance, dtype),
        jnp.asarray(spectra.mask),
        jnp.asarray(spectra.z_qso, dtype),
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
    return batch_log_likelihoods(
        *args, params=params, sample_chunk=sample_chunk,
        sample_window=sample_window,
    )


@pytest.mark.parametrize(
    "case",
    [
        dict(),
        # S=130 does not divide into sample_chunk=32 chunks: the padded
        # tail must not corrupt the real columns
        dict(S=130),
        # the reference kernel defaults to all 31 lines (voigt.c:266)
        dict(P=768, S=384, k=4, num_lines=31),
    ],
    ids=["default", "nondivisible_samples", "31_lines"],
)
def test_f32_matches_f64(case):
    """Both precisions of the one evidence path agree to float32
    accuracy: sample log likelihoods within 5e-5 of max(|ll|, 1), null
    evidences within 1e-5 (relative), search ranges to float32."""
    case = dict(case)
    num_lines = case.pop("num_lines", 3)
    params, model, spectra, offsets, nhis = make_problem(**case)
    params = dataclasses.replace(params, num_lines=num_lines)
    prob = (params, model, spectra, offsets, nhis)
    out64 = run(*prob, dtype=np.float64)
    out32 = run(*prob)

    a = np.asarray(out64["sample_log_likelihoods_dla"])
    b = np.asarray(out32["sample_log_likelihoods_dla"], np.float64)
    assert b.shape == a.shape == (len(spectra), len(offsets))
    scale = np.maximum(np.abs(a), 1.0)
    assert np.max(np.abs(a - b) / scale) < 5e-5
    np.testing.assert_allclose(
        np.asarray(out32["log_likelihood_no_dla"]),
        np.asarray(out64["log_likelihood_no_dla"]),
        rtol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(out32["min_z_dla"]), np.asarray(out64["min_z_dla"]),
        rtol=1e-6,
    )


@pytest.mark.parametrize(
    "case, chunk, bound",
    [
        # a REAL window at the chunk (on tiny grids compute_sample_window
        # returns None and the windowed path would go untested)
        (dict(B=2, P=1200, S=512, k=4), 128, 5e-5),
        # every line of the full series gets its own window
        (dict(P=768, S=384, k=4, num_lines=31), 128, 2e-4),
        # P6 = 1206 is no multiple of the window alignment: the highest-z
        # samples' cores at the red edge must still be corrected
        (dict(B=2, P=1200, S=256, k=4, seed=3), 128, 5e-4),
    ],
    ids=["3_lines", "31_lines", "unaligned_red_edge"],
)
def test_windowed_matches_full_grid(case, chunk, bound):
    from gp_dla_detection.inference import compute_sample_window

    case = dict(case)
    num_lines = case.pop("num_lines", 3)
    params, model, spectra, offsets, nhis = make_problem(**case)
    params = dataclasses.replace(params, num_lines=num_lines)
    prob = (params, model, spectra, offsets, nhis)
    window = compute_sample_window(
        offsets, chunk, spectra.wavelengths.shape[1] + 6
    )
    assert window is not None and window < spectra.wavelengths.shape[1]
    full = run(*prob, sample_chunk=chunk)
    win = run(*prob, sample_chunk=chunk, sample_window=window)
    a = np.asarray(full["sample_log_likelihoods_dla"], np.float64)
    b = np.asarray(win["sample_log_likelihoods_dla"], np.float64)
    assert np.isfinite(b).all()
    scale = np.maximum(np.abs(a), 1.0)
    assert np.max(np.abs(a - b) / scale) < bound


def test_masked_nonfinite_inputs_neutralized():
    """A non-finite omega2 at a MASKED pixel (float32 exp overflow of the
    extrapolated log_omega on a short spectrum's padded tail), and NaN
    flux / inf noise there, must not reach any sample's likelihood: the
    masked pixels get zero weight."""
    from gp_dla_detection.ops.low_rank_mvn import (
        batched_dla_log_likelihoods,
    )
    from gp_dla_detection.ops.voigt import voigt_absorption

    rng = np.random.default_rng(5)
    P, S, k = 384, 128, 4
    z = 2.8
    lam = 10 ** (np.log10(911.9 * (1 + z)) + 1e-4 * np.arange(P))
    ext = np.concatenate(
        [
            lam[:1] * 10 ** (-1e-4 * np.arange(3, 0, -1)),
            lam,
            lam[-1:] * 10 ** (1e-4 * np.arange(1, 4)),
        ]
    )
    flux = rng.normal(1, 0.3, P)
    noise = rng.uniform(0.05, 0.2, P)
    mask = np.ones(P, bool)
    mask[-8:] = False
    mu = 1.0 + 0.1 * np.sin(np.arange(P) / 40)
    M = rng.normal(size=(P, k)) * 0.08
    omega2 = np.full(P, 0.04)
    z_dlas = np.sort(rng.uniform(2.2, 2.75, S))
    nhis = 10 ** rng.uniform(20, 21.5, S)

    f32 = lambda a: jnp.asarray(a, jnp.float32)
    absorption = voigt_absorption(
        f32(ext), f32(z_dlas), f32(nhis), num_lines=3,
    )
    lls = lambda o2, fl, nv: np.asarray(
        batched_dla_log_likelihoods(
            f32(fl), f32(mu), f32(M), f32(o2), f32(nv), jnp.asarray(mask),
            absorption,
        )
    )
    clean = lls(omega2, flux, noise)
    bad_o2, bad_flux, bad_noise = omega2.copy(), flux.copy(), noise.copy()
    bad_o2[-4:] = np.inf
    bad_flux[-3:] = np.nan
    bad_noise[-2:] = np.inf
    dirty = lls(bad_o2, bad_flux, bad_noise)
    assert np.isfinite(dirty).all()
    np.testing.assert_array_equal(dirty, clean)
