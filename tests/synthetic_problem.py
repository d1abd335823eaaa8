"""Deterministic synthetic inference problem shared by the in-process
sharding tests (tests/test_parallel.py) and the two-process
jax.distributed workers (tests/distributed_worker.py): both sides must
build bit-identical inputs from the same seed."""

import numpy as np

from gp_dla_detection.inference import PaddedSpectra
from gp_dla_detection.models.qso_model import GPModel
from gp_dla_detection.params import NullModelParams, Parameters


def make_problem():
    rng = np.random.default_rng(3)
    params = Parameters(null_model=NullModelParams(k=4))
    grid = params.null_model.rest_wavelengths()
    model = GPModel(
        rest_wavelengths=grid,
        mu=1.0 + 0.1 * np.sin(grid / 40),
        M=rng.normal(size=(grid.size, 4)) * 0.08,
        log_omega=np.log(0.2 + 0 * grid),
        log_c_0=np.log(0.1),
        log_tau_0=np.log(0.0023),
        log_beta=np.log(3.65),
    )
    B, P, S = 11, 384, 64  # deliberately not divisible by 8
    z = rng.uniform(2.5, 3.4, B)
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
    prior_z = rng.uniform(2.2, 3.6, 200)
    prior_f = rng.uniform(size=200) < 0.1
    return params, model, spectra, offsets, nhis, prior_z, prior_f
