"""Minimal end-to-end DLA detection on synthetic spectra.

Builds a known GP quasar-emission model, draws three spectra from it
(one clean, one with an injected DLA, one with TWO), runs the Bayesian
model selection, and prints the posteriors and recovered absorber
parameters.  Runs on the CPU or a GPU as-is.

    python examples/quickstart.py
"""

import numpy as np

from gp_dla_detection.inference import PaddedSpectra
from gp_dla_detection.models.qso_model import GPModel
from gp_dla_detection.multi_dla import process_spectra_multi
from gp_dla_detection.ops.voigt import voigt_absorption
from gp_dla_detection.params import NullModelParams, Parameters
from gp_dla_detection.samples import generate_dla_samples

rng = np.random.default_rng(0)
params = Parameters(null_model=NullModelParams(k=6))
grid = params.null_model.rest_wavelengths()

# a "learned" emission model (in real runs: Pipeline.run_learn / GPModel.load)
model = GPModel(
    rest_wavelengths=grid,
    mu=1.0 + 0.3 * np.exp(-0.5 * ((grid - 1215.67) / 25.0) ** 2),
    M=rng.normal(size=(grid.size, 6)) * 0.04,
    log_omega=np.log(0.12 + 0 * grid),
    log_c_0=np.log(0.1),
    log_tau_0=np.log(0.0023),
    log_beta=np.log(3.65),
)

# three synthetic sightlines at z_QSO = 3
P, z_qso = 1280, np.full(3, 3.0)
lam = np.stack([10 ** (np.log10(911.9 * 4.0) + 1e-4 * np.arange(P))] * 3)
noise_sd = 0.1
flux = np.stack(
    [np.interp(lam[i] / 4.0, grid, model.mu) + rng.normal(0, noise_sd, P)
     for i in range(3)]
)


def inject(i, z_dla, log_nhi):
    ext = np.concatenate([  # conv padding: 3 extra log-spaced px per side
        lam[i, :1] * 10 ** (-1e-4 * np.arange(3, 0, -1)),
        lam[i],
        lam[i, -1:] * 10 ** (1e-4 * np.arange(1, 4)),
    ])
    flux[i] *= np.asarray(voigt_absorption(ext, z_dla, 10.0 ** log_nhi))


inject(1, 2.62, 20.8)                       # one DLA
inject(2, 2.45, 20.7); inject(2, 2.85, 21.0)  # two DLAs

spectra = PaddedSpectra(
    lam, flux, np.full((3, P), noise_sd**2), np.ones((3, P), bool), z_qso
)

# QMC prior samples from an "observed" concordance column-density set
samples = generate_dla_samples(rng.normal(20.7, 0.4, 300), params)

# a neutral counting-prior catalog (real runs use the DR9 concordance)
prior_z = rng.uniform(2.2, 3.6, 2000)
prior_num = np.minimum(rng.poisson(0.3, 2000), 2)

res = process_spectra_multi(
    model, samples.offset_samples, samples.nhi_samples, spectra,
    prior_z, prior_num, params=params, batch_size=3, sample_chunk=1000,
    dtype=np.float32,
)

names = ["clean", "one DLA (z=2.62)", "two DLAs (z=2.45, 2.85)"]
for i, name in enumerate(names):
    p0, p1, p2 = res.model_posteriors[i]
    print(f"{name:26s} p(0,1,2 DLAs) = {p0:.3f} {p1:.3f} {p2:.3f}")

# MAP absorber parameters
i = 1
j = int(np.argmax(res.single.sample_log_likelihoods_dla[i]))
zr = res.single.max_z_dlas[i] - res.single.min_z_dlas[i]
print(f"MAP single absorber: z = "
      f"{res.single.min_z_dlas[i] + zr * samples.offset_samples[j]:.3f}, "
      f"logN = {samples.log_nhi_samples[j]:.2f}  (injected 2.62, 20.8)")

i = 2
j = int(np.nanargmax(res.sample_log_likelihoods_dla2[i]))
zr = res.single.max_z_dlas[i] - res.single.min_z_dlas[i]
z_f = res.single.min_z_dlas[i] + zr * samples.offset_samples[j]
z_b = res.single.min_z_dlas[i] + zr * samples.offset_samples[
    res.base_sample_inds[i, j]
]
print(f"MAP pair: z = {min(z_f, z_b):.3f}, {max(z_f, z_b):.3f}  "
      f"(injected 2.45, 2.85)")
