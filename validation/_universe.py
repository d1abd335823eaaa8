"""Shared synthetic-universe construction.

validation/f32_decision_study.py (and tests/test_f32_decisions.py
through it), chip_smoke.py and tests/test_lean_cddf.py build spectra
from these helpers: a standard GP continuum model, per-sightline
continuum draws, Voigt DLA injection over the searchable z range, and
the standard QMC sample set.  The tricky numerics (injection-range
cuts, chunk padding, the log-continuation grid extension for the
instrumental convolution) live HERE once.

Each helper consumes the caller's ``numpy.random.Generator`` in a
documented draw order, so callers control reproducibility end-to-end.
"""

from __future__ import annotations

import numpy as np

LYA = 1215.6701
LYMAN_LIMIT = 911.7633


def standard_model(rng: np.random.Generator, params):
    """The standard synthetic GP model: a Lya emission bump + ripple
    mean, dense low-rank M (one ``rng.normal`` draw of (R, k)), flat
    omega, and the reference's absorption-noise constants
    (set_parameters.m tau_0/beta)."""
    from gp_dla_detection.models.qso_model import GPModel

    grid = params.null_model.rest_wavelengths()
    k = params.null_model.k
    return GPModel(
        rest_wavelengths=grid,
        mu=1.0 + 0.3 * np.exp(-0.5 * ((grid - 1215.67) / 25.0) ** 2)
        + 0.1 * np.sin(grid / 60.0),
        M=rng.normal(size=(grid.size, k)) * 0.04,
        log_omega=np.log(0.12 + 0 * grid),
        log_c_0=np.log(0.1),
        log_tau_0=np.log(0.0023),
        log_beta=np.log(3.65),
    )


def synth_continua(lam, z_qso, model, noise_sd, rng: np.random.Generator):
    """Per-sightline continuum realizations: mu + a fresh M-coefficient
    draw + pixel noise (draw order per sightline: coefficients, then
    noise).  ``noise_sd`` may be a scalar or per-sightline (n,) array."""
    lam = np.asarray(lam)
    n, P = lam.shape
    grid = np.asarray(model.rest_wavelengths)
    k = model.M.shape[1]
    sd = np.broadcast_to(np.asarray(noise_sd, float), (n,))
    flux = np.empty((n, P))
    for i in range(n):  # numpy-only: fast
        rest = lam[i] / (1 + z_qso[i])
        flux[i] = (
            np.interp(rest, grid, model.mu)
            + np.interp(rest, grid, model.M @ rng.normal(size=k))
            + rng.normal(0, sd[i], P)
        )
    return flux


def injection_bounds(lam_first, lam_last, z_qso, params):
    """Searchable (zmin, zmax) for injecting a DLA into one sightline —
    the same range the inference searches (process_qsos.m min/max z_dla
    policy: Lyman-limit + min_z_cut below, quasar - max_z_cut above).
    Empty when zmax <= zmin."""
    zmin = max(
        lam_first / LYA - 1,
        LYMAN_LIMIT * (1 + z_qso) / LYA - 1 + params.min_z_cut,
    )
    zmax = (
        min(lam_last, params.null_model.max_lambda * (1 + z_qso)) / LYA
        - 1
        - params.max_z_cut
    )
    return zmin, zmax


def inject_dlas(lam, flux, inj, params, num_lines: int = 3,
                chunk: int = 256) -> None:
    """Multiply ``flux`` rows in-place by Voigt absorption profiles.

    ``inj`` is a list of (row_index, z_dla, log_nhi).  Batched: one
    vmapped Voigt compile per chunk shape (a per-sightline jit call
    would pay one dispatch and one compile check each), with
    the final short chunk padded by replicating its last entry.  Each
    sightline's grid is extended by ``instrument.width`` log-spaced
    pixels on both sides, matching the convolution padding the
    inference applies (inference._prepare_spectrum).
    """
    import jax

    from gp_dla_detection.ops.voigt import voigt_absorption

    if not inj:
        return
    lam = np.asarray(lam)
    w = params.instrument.width
    dex = 10 ** (params.instrument.pixel_spacing * np.arange(1, w + 1))
    vvoigt = jax.jit(
        jax.vmap(
            lambda e, z, n: voigt_absorption(e, z, n, num_lines=num_lines)
        )
    )
    for c0 in range(0, len(inj), chunk):
        part = inj[c0 : c0 + chunk]
        pad = chunk - len(part)
        part = part + [part[-1]] * pad
        idx = np.array([i for i, _, _ in part])
        lam_c = lam[idx]
        ext = np.concatenate(
            [lam_c[:, :1] / dex[::-1], lam_c, lam_c[:, -1:] * dex], axis=1
        )
        absorb = np.asarray(
            vvoigt(
                ext,
                np.array([z for _, z, _ in part]),
                np.array([10.0**ln for _, _, ln in part]),
            )
        )
        keep = len(part) - pad
        # unbuffered in-place multiply: plain fancy-index *= collapses
        # duplicate row indices (two absorbers injected into the same
        # sightline within a chunk would silently apply only one)
        np.multiply.at(flux, idx[:keep], absorb[:keep])


def standard_samples(rng: np.random.Generator, params):
    """The standard QMC sample set seeded from a 400-draw synthetic
    N_HI catalog (one ``rng.normal`` draw)."""
    from gp_dla_detection.samples import generate_dla_samples

    return generate_dla_samples(
        rng.normal(20.7, 0.4, 400).clip(20.05, 22.4), params
    )
