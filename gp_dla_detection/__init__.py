"""gp_dla_detection: Gaussian-process DLA detection in JAX.

A from-scratch JAX/XLA rebuild of the Garnett, Ho, Bird &
Schneider (arXiv:1605.04460) Bayesian DLA-detection pipeline
(reference implementation: sbird/gp_dla_detection, MATLAB + C/MEX).

Layer map (mirrors SURVEY.md section 1):
  params         L0 typed configuration (set_parameters.m)
  catalog        L2 QSO/DLA catalog construction (build_catalogs.m)
  spectra        L3 spectrum loading/preprocessing (read_spec.m, preload_qsos.m)
  models         L4 low-rank GP null model + training (learn_qso_model.m)
  samples        L4 QMC DLA prior samples (generate_dla_samples.m)
  inference      L5 Bayesian model selection (process_qsos.m)
  multi_dla      L5 {0,1,2}-DLA model selection (beyond-reference)
  ascii_catalog  L6 ASCII catalog output (generate_ascii_catalog.m)
  analysis       L7 CDDF / dN/dX / Omega_DLA statistics (CDDF_analysis/)
  ops            numerics: Voigt/Faddeeva, Woodbury MVN, L-BFGS
  parallel       mesh sharding, multi-device inference, checkpoint/resume
  io             FITS + stage artifacts (native C++ fast path optional)
"""

from .params import (
    LYA_WAVELENGTH,
    LYB_WAVELENGTH,
    LYMAN_LIMIT,
    SPEED_OF_LIGHT,
    Parameters,
    emitted_wavelengths,
    kms_to_z,
    observed_wavelengths,
)

__version__ = "0.1.0"

__all__ = [
    "Parameters",
    "kms_to_z",
    "emitted_wavelengths",
    "observed_wavelengths",
    "LYA_WAVELENGTH",
    "LYB_WAVELENGTH",
    "LYMAN_LIMIT",
    "SPEED_OF_LIGHT",
    "__version__",
]
