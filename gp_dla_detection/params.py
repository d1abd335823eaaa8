"""Typed configuration for the GP DLA-detection pipeline.

Replacement for the reference's global-workspace config script
(reference: set_parameters.m:1-92).  Every hyperparameter keeps the
reference's name and default value; the reference's anonymous "policy"
functions (kms_to_z, emitted/observed_wavelengths, min/max_z_dla,
directory layout) become methods so downstream code never hard-codes
policy.

Unlike the reference there is no ``eval``'d free-variable magic: stages
receive a :class:`Parameters` instance explicitly, and run-specific
selections (train_ind / prior_ind / test_ind strings in the reference,
e.g. process_qsos.m:7-9) are plain boolean masks built by the typed
catalog API (see catalog.py).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

# physical constants (set_parameters.m:5-8)
LYA_WAVELENGTH = 1215.6701  # Lyman-alpha transition wavelength [Å]
LYB_WAVELENGTH = 1025.7223  # Lyman-beta transition wavelength [Å]
LYMAN_LIMIT = 911.7633      # Lyman limit wavelength [Å]
SPEED_OF_LIGHT = 299792458.0  # speed of light [m s^-1]


def kms_to_z(kms: float) -> float:
    """Relative velocity [km/s] -> redshift difference (set_parameters.m:11)."""
    return (kms * 1000.0) / SPEED_OF_LIGHT


def emitted_wavelengths(observed, z):
    """Observed-frame -> rest-frame wavelengths (set_parameters.m:14-15)."""
    return observed / (1.0 + z)


def observed_wavelengths(emitted, z):
    """Rest-frame -> observed-frame wavelengths (set_parameters.m:17-18)."""
    return emitted * (1.0 + z)


@dataclass(frozen=True)
class NullModelParams:
    """Rest-frame grid + low-rank GP shape (set_parameters.m:32-37)."""

    min_lambda: float = 911.75   # range of rest wavelengths to model [Å]
    max_lambda: float = 1215.75
    dlambda: float = 0.25        # separation of wavelength grid [Å]
    k: int = 20                  # rank of the non-diagonal covariance term
    max_noise_variance: float = 1.0  # max pixel noise allowed in training

    @property
    def num_rest_pixels(self) -> int:
        return int(round((self.max_lambda - self.min_lambda) / self.dlambda)) + 1

    def rest_wavelengths(self) -> np.ndarray:
        """The modelling grid 911.75:0.25:1215.75 (1217 px)."""
        return self.min_lambda + self.dlambda * np.arange(self.num_rest_pixels)


@dataclass(frozen=True)
class OptimizationParams:
    """L-BFGS budget + initial guesses (set_parameters.m:40-45)."""

    initial_c_0: float = 0.1
    initial_tau_0: float = 0.0023
    initial_beta: float = 3.65
    max_iterations: int = 2000   # minFunc MaxIter
    max_fun_evals: int = 4000    # minFunc MaxFunEvals


@dataclass(frozen=True)
class DLASamplingParams:
    """QMC prior-sample construction (set_parameters.m:48-53)."""

    num_dla_samples: int = 10000
    alpha: float = 0.9                 # weight of KDE component in mixture
    uniform_min_log_nhi: float = 20.0  # uniform component range [cm^-2]
    uniform_max_log_nhi: float = 23.0
    fit_min_log_nhi: float = 20.0      # KDE-fit component range [cm^-2]
    fit_max_log_nhi: float = 22.0


@dataclass(frozen=True)
class InstrumentParams:
    """BOSS spectrograph model (set_parameters.m:59-60, voigt.c:222-240)."""

    width: int = 3                 # half-width of Gaussian broadening [px]
    pixel_spacing: float = 1e-4    # pixel spacing [dex]
    resolving_power: float = 2000.0

    def profile(self) -> np.ndarray:
        """Normalized (2*width+1)-tap instrumental kernel (voigt.c:232-251)."""
        pixel_sigma = 1.0 / (
            self.resolving_power
            * 2.0
            * np.sqrt(2.0 * np.log(2.0))
            * (10.0 ** self.pixel_spacing - 1.0)
        )
        offsets = np.arange(-self.width, self.width + 1, dtype=np.float64)
        taps = np.exp(-0.5 * offsets**2 / pixel_sigma**2)
        return taps / taps.sum()


@dataclass(frozen=True)
class Parameters:
    """Full pipeline configuration (reference: set_parameters.m)."""

    # file loading parameters (set_parameters.m:21-22)
    loading_min_lambda: float = 910.0
    loading_max_lambda: float = 1217.0

    # preprocessing parameters (set_parameters.m:25-26)
    z_qso_cut: float = 2.15
    min_num_pixels: int = 200

    # normalization parameters (set_parameters.m:29-30)
    normalization_min_lambda: float = 1310.0
    normalization_max_lambda: float = 1325.0

    null_model: NullModelParams = field(default_factory=NullModelParams)
    optimization: OptimizationParams = field(default_factory=OptimizationParams)
    dla_sampling: DLASamplingParams = field(default_factory=DLASamplingParams)
    instrument: InstrumentParams = field(default_factory=InstrumentParams)

    # model prior parameters (set_parameters.m:56)
    prior_z_qso_increase: float = kms_to_z(30000.0)

    # DLA model parameters (set_parameters.m:62-63)
    num_lines: int = 3  # members of the Lyman series per Voigt profile

    # absorber search range policy (set_parameters.m:65-73)
    max_z_cut_kms: float = 3000.0
    min_z_cut_kms: float = 3000.0

    # execution parameters (no reference equivalent: padding policy
    # replacing the reference's ragged per-spectrum slicing).
    # 1274 keeps ~7 px of slack over the longest possible truncated
    # DR12Q spectrum (~1267 px: rest [910, 1217.75] Å at 1e-4 dex plus
    # the extra edge pixels); the convolution-extended grid is then
    # pixel_pad + 2*width = 1280 px.
    pixel_pad: int = 1274  # fixed padded width for observed-frame spectra

    # base directory for all data (set_parameters.m:76)
    base_directory: str = "data"

    # --- search-range policy (set_parameters.m:65-73) ---

    @property
    def max_z_cut(self) -> float:
        return kms_to_z(self.max_z_cut_kms)

    @property
    def min_z_cut(self) -> float:
        return kms_to_z(self.min_z_cut_kms)

    def max_z_dla_from_wmax(self, wmax):
        """Maximum z_DLA given the reddest usable wavelength: its Lyα
        redshift minus the 3000 km/s cut (set_parameters.m:66-68).
        Works on scalars, numpy, or traced jax values — this is the
        single policy definition the inference engine calls."""
        return (wmax / LYA_WAVELENGTH - 1.0) - self.max_z_cut

    def min_z_dla_from_wmin(self, wmin, z_qso):
        """Minimum z_DLA given the bluest usable wavelength: that pixel
        or the QSO's Lyman limit, whichever is redder, plus the
        3000 km/s cut (set_parameters.m:70-73).  jnp-compatible."""
        lyman_limit_bound = (
            observed_wavelengths(LYMAN_LIMIT, z_qso) / LYA_WAVELENGTH
            - 1.0
            + self.min_z_cut
        )
        blue_bound = wmin / LYA_WAVELENGTH - 1.0
        try:  # works for python/numpy scalars and jax tracers alike
            import jax.numpy as _jnp

            return _jnp.maximum(blue_bound, lyman_limit_bound)
        except ImportError:  # pragma: no cover
            return max(blue_bound, lyman_limit_bound)

    def max_z_dla(self, wavelengths, z_qso):
        """Array convenience wrapper (set_parameters.m:65-68)."""
        import numpy as _np

        return self.max_z_dla_from_wmax(_np.max(wavelengths))

    def min_z_dla(self, wavelengths, z_qso):
        """Array convenience wrapper (set_parameters.m:70-73)."""
        import numpy as _np

        return self.min_z_dla_from_wmin(_np.min(wavelengths), z_qso)

    # --- directory layout (set_parameters.m:78-89) ---

    def distfiles_directory(self, release: str) -> Path:
        return Path(self.base_directory) / release / "distfiles"

    def spectra_directory(self, release: str) -> Path:
        return Path(self.base_directory) / release / "spectra"

    def processed_directory(self, release: str) -> Path:
        return Path(self.base_directory) / release / "processed"

    def dla_catalog_directory(self, name: str) -> Path:
        return Path(self.base_directory) / "dla_catalogs" / name / "processed"

    # --- serialization (stage artifacts record their config) ---

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "Parameters":
        raw = json.loads(text)
        return cls(
            **{
                **{
                    k: v
                    for k, v in raw.items()
                    if k
                    not in ("null_model", "optimization", "dla_sampling", "instrument")
                },
                "null_model": NullModelParams(**raw["null_model"]),
                "optimization": OptimizationParams(**raw["optimization"]),
                "dla_sampling": DLASamplingParams(**raw["dla_sampling"]),
                "instrument": InstrumentParams(**raw["instrument"]),
            }
        )
