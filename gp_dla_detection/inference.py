"""Bayesian DLA model selection — the flagship inference engine.

Rebuild of process_qsos.m:1-249.  The reference runs a
sequential loop over quasars with a parfor over 10,000 QMC samples,
calling a C MEX Voigt kernel and a MATLAB Woodbury solve ~1.63e9 times
for the full DR12Q catalog.  Here the whole computation is a single
jitted function per *batch* of spectra:

  - spectra are fixed-width padded arrays with validity masks (replacing
    the reference's ragged per-spectrum slicing, process_qsos.m:102-116),
  - the 10k-sample axis is an array axis chunked with lax.map (bounding
    the (samples x pixels) working set in HBM),
  - the batch axis is vmapped and, in the sharded driver
    (parallel/sharded_inference.py), distributed over a device mesh.

Reference-quirk note (documented, intentionally NOT reproduced): at
process_qsos.m:180 the reference computes ``ind = ~this_pixel_mask(ind)``
*after* ``ind`` was already restricted to unmasked pixels, which yields
an all-true mask and therefore selects the *first* nnz(ind) pixels of
the absorption profile — misaligned whenever a masked pixel lies in the
modelling range.  We align the absorption profile with the pixels it was
computed for (the scientifically intended behaviour).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from .models.qso_model import GPModel
from .ops.low_rank_mvn import batched_dla_log_likelihoods, log_mvnpdf_low_rank
from .ops.voigt import voigt_absorption
from .params import LYA_WAVELENGTH, LYMAN_LIMIT, Parameters

__all__ = [
    "PaddedSpectra",
    "InferenceResults",
    "dla_rate_priors",
    "correct_prior_dla_flags",
    "spectrum_log_likelihoods",
    "batch_log_likelihoods",
    "process_spectra",
]


@dataclass
class PaddedSpectra:
    """A batch of spectra as fixed-width padded arrays.

    wavelengths must be strictly increasing along the pixel axis for
    every spectrum (real pixels continue in uniform log-lambda spacing
    into the padded tail; see spectra.py, which constructs this layout).
    """

    wavelengths: np.ndarray     # (B, P) observed-frame [Å]
    flux: np.ndarray            # (B, P) normalized flux
    noise_variance: np.ndarray  # (B, P) normalized noise variance
    mask: np.ndarray            # (B, P) bool; True = real, unmasked pixel
    z_qso: np.ndarray           # (B,)

    def __len__(self) -> int:
        return self.wavelengths.shape[0]

    def slice(self, sl) -> "PaddedSpectra":
        return PaddedSpectra(
            self.wavelengths[sl],
            self.flux[sl],
            self.noise_variance[sl],
            self.mask[sl],
            self.z_qso[sl],
        )

    def pad_to(self, size: int) -> "PaddedSpectra":
        """Pad the batch axis to ``size`` by repeating the final
        spectrum (results for padded rows are discarded by callers)."""
        pad = size - len(self)
        if pad <= 0:
            return self
        return PaddedSpectra(
            *(
                np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])
                for a in (
                    self.wavelengths,
                    self.flux,
                    self.noise_variance,
                    self.mask,
                    self.z_qso,
                )
            )
        )


# ---------------------------------------------------------------------------
# model prior (process_qsos.m:4-27, 122-132)
# ---------------------------------------------------------------------------


def correct_prior_dla_flags(prior_z_qsos, prior_dla_flags, prior_z_dlas):
    """Drop prior DLAs whose Lyα line falls below the QSO's Lyman limit.

    (process_qsos.m:15-27.)  ``prior_z_dlas`` is a list (per prior
    quasar) of absorber redshift arrays (empty/None when no DLA).  As in
    the reference's vectorized ``if``, the flag is cleared only when
    *all* of a quasar's DLAs fail the cut.
    """
    flags = np.array(prior_dla_flags, bool).copy()
    for i in np.flatnonzero(flags):
        entry = prior_z_dlas[i]
        if entry is None:
            # documented "no DLA" marker: np.atleast_1d(None) would be a
            # size-1 object array and crash in the arithmetic below
            continue
        z_dlas = np.atleast_1d(np.asarray(entry, dtype=float))
        if z_dlas.size and np.all(
            LYA_WAVELENGTH * (1 + z_dlas) < LYMAN_LIMIT * (1 + prior_z_qsos[i])
        ):
            flags[i] = False
    return flags


def dla_rate_priors(z_qsos, prior_z_qsos, prior_dla_flags, params: Parameters):
    """z-dependent counting prior (process_qsos.m:122-132), vectorized.

    For each test quasar: among prior quasars with z < z_qso + dz
    (dz = 30000 km/s), the fraction hosting a DLA.

    Returns (log_priors_dla, log_priors_no_dla), each (B,).
    """
    order = np.argsort(prior_z_qsos, kind="stable")
    z_sorted = np.asarray(prior_z_qsos)[order]
    dla_sorted = np.asarray(prior_dla_flags, dtype=np.int64)[order]
    cum_dlas = np.concatenate([[0], np.cumsum(dla_sorted)])

    counts = np.searchsorted(z_sorted, np.asarray(z_qsos) + params.prior_z_qso_increase, side="left")
    num_dlas = cum_dlas[counts]
    # Degenerate edge: counts == 0 (no prior quasar below the z cut).
    # The reference computes log(0) - log(0) = NaN here and lets it
    # propagate into the posteriors (process_qsos.m:122-132); we define
    # the documented limit instead: zero observed occurrences -> zero
    # prior weight on the DLA model (log p_dla = -inf, p_no_dla = 1).
    # num_dlas == 0 with counts > 0 already falls out naturally as
    # log p_dla = -inf, log p_no_dla = 0.
    safe_counts = np.maximum(counts, 1)
    with np.errstate(divide="ignore"):
        log_p_dla = np.log(num_dlas) - np.log(safe_counts)
        log_p_no_dla = np.log(counts - num_dlas) - np.log(safe_counts)
    log_p_dla = np.where(counts > 0, log_p_dla, -np.inf)
    log_p_no_dla = np.where(counts > 0, log_p_no_dla, 0.0)
    return log_p_dla, log_p_no_dla


# ---------------------------------------------------------------------------
# per-spectrum likelihoods (process_qsos.m:102-209)
# ---------------------------------------------------------------------------


def _extend_wavelengths(wavelengths, width: int, pixel_spacing: float):
    """Append `width` log-continuation pixels at each end
    (process_qsos.m:169-177: the ±width logspace padding for the
    instrumental convolution)."""
    dex = 10.0 ** (pixel_spacing * jnp.arange(1, width + 1, dtype=wavelengths.dtype))
    left = wavelengths[0] / dex[::-1]
    right = wavelengths[-1] * dex
    return jnp.concatenate([left, wavelengths, right])


def compute_sample_window(
    offset_samples, sample_chunk: int, num_pixels: int,
    pixel_spacing: float | None = None,
):
    """Static window size (pixels) for the windowed Voigt option
    (ops/voigt.voigt_absorption_windowed, ShardedRunConfig.windowed_voigt).

    A z-sorted chunk spanning offset fraction ``s`` covers exactly
    log10((1+z(f+s))/(1+z(f)))/pixel_spacing pixels of line centers
    (ops/voigt.py windowed contract), which is bounded by
    log10(1 + s*R)/pixel_spacing with R = (1+max_z)/(1+min_z) - 1 <=
    LYA_WAVELENGTH/LYMAN_LIMIT - 1 for EVERY spectrum (the z_DLA search
    range, set_parameters.m:65-73).  The naive linear bound
    s*num_pixels understates the low-z end of the log-uniform grid by
    up to ~13% (pixel density per unit offset is highest there), so the
    window is sized by the LARGER of the two bounds, plus WINDOW_MARGIN
    pixels of slack on each side (consumers offset the window start by
    exactly WINDOW_MARGIN).  Returns None when windowing would not help
    (window >= grid).
    """
    from .ops.voigt import WINDOW_MARGIN

    off = np.sort(np.asarray(offset_samples))
    m = min(sample_chunk, len(off))
    if m <= 1 or len(off) == 0:
        return None
    spread = float(np.max(off[m - 1 :] - off[: len(off) - m + 1]))
    if pixel_spacing is None:
        from .params import InstrumentParams

        pixel_spacing = InstrumentParams().pixel_spacing
    from .params import LYA_WAVELENGTH, LYMAN_LIMIT

    ratio = LYA_WAVELENGTH / LYMAN_LIMIT - 1.0
    exact = np.log10(1.0 + spread * ratio) / pixel_spacing
    window = int(np.ceil(max(spread * num_pixels, exact))) + 2 * WINDOW_MARGIN
    window = -(-window // 8) * 8
    return window if window < num_pixels else None


def _prepare_spectrum(
    wavelengths,
    flux,
    noise_variance,
    mask,
    z_qso,
    model_grid,
    model_mu,
    model_M,
    model_log_omega,
    log_c_0,
    log_tau_0,
    log_beta,
    params: Parameters,
):
    """Shared per-spectrum preparation: model interpolation, forest
    scaling, validity mask, null evidence, z_DLA search range, and the
    convolution-extended wavelength grid (process_qsos.m:102-177).
    Shared by the single- and two-DLA evaluators."""
    dtype = flux.dtype
    wavelengths = wavelengths.astype(dtype)

    rest = wavelengths / (1.0 + z_qso)
    nm = params.null_model
    in_range = (rest >= nm.min_lambda) & (rest <= nm.max_lambda)
    valid = mask & in_range

    # interpolate the learned model onto this spectrum (process_qsos.m:138-143);
    # the model rest grid is arange-built (params.NullModelParams
    # .rest_wavelengths, set_parameters.m:33-35), so the uniform-grid
    # bracketing applies, and mu/M/log_omega share one bracketing and
    # one fused row gather — bit-identical to the generic searchsorted
    # path, at ~half the cost of even the uniform per-array version
    # (the searchsorted original was ~19% of a B=1024 inference step)
    from .ops.interp import interp_stack_uniform

    grid = jnp.asarray(model_grid, dtype)
    mu, log_omega, M = interp_stack_uniform(
        grid,
        (
            jnp.asarray(model_mu, dtype),
            jnp.asarray(model_log_omega, dtype),
            jnp.asarray(model_M, dtype),
        ),
        rest,
    )

    # Lyα-forest scaling of omega^2 (process_qsos.m:145-147)
    c_0 = jnp.exp(jnp.asarray(log_c_0, dtype))
    tau_0 = jnp.exp(jnp.asarray(log_tau_0, dtype))
    beta = jnp.exp(jnp.asarray(log_beta, dtype))
    lya_zs = (wavelengths - LYA_WAVELENGTH) / LYA_WAVELENGTH
    scaling = 1.0 - jnp.exp(-tau_0 * (1.0 + lya_zs) ** beta) + c_0
    omega2 = jnp.exp(2.0 * log_omega) * scaling**2

    # null-model evidence (process_qsos.m:149-152)
    log_likelihood_no_dla = log_mvnpdf_low_rank(
        flux, mu, M, omega2 + noise_variance, mask=valid
    )

    # z_DLA search range over unmasked modelled pixels (process_qsos.m:160-165);
    # the range policy itself lives on Parameters (set_parameters.m:65-73)
    big = jnp.asarray(np.inf, dtype)
    wmin = jnp.min(jnp.where(valid, wavelengths, big))
    wmax = jnp.max(jnp.where(valid, wavelengths, -big))
    max_z_dla = params.max_z_dla_from_wmax(wmax)
    min_z_dla = params.min_z_dla_from_wmin(wmin, z_qso)

    return {
        "mu": mu,
        "M": M,
        "omega2": omega2,
        "valid": valid,
        "log_likelihood_no_dla": log_likelihood_no_dla,
        "min_z_dla": min_z_dla,
        "max_z_dla": max_z_dla,
        "padded_wavelengths": _extend_wavelengths(
            wavelengths, params.instrument.width, params.instrument.pixel_spacing
        ),
    }


def spectrum_log_likelihoods(
    wavelengths,
    flux,
    noise_variance,
    mask,
    z_qso,
    model_grid,
    model_mu,
    model_M,
    model_log_omega,
    log_c_0,
    log_tau_0,
    log_beta,
    offset_samples,
    nhi_samples,
    params: Parameters,
    sample_chunk: int = 1000,
    sample_window: int | None = None,
    reference_misaligned_absorption: bool = False,
):
    """Null + per-sample DLA log likelihoods for one padded spectrum.

    Pure jittable function of arrays; the sample axis is processed in
    lax.map chunks of ``sample_chunk`` to bound the (S, P) working set.

    ``reference_misaligned_absorption=True`` reproduces the reference's
    absorption-alignment quirk bit-structurally (process_qsos.m:180:
    ``ind = ~this_pixel_mask(ind)`` — after ``ind`` was already
    restricted to unmasked pixels this is all-true, so MATLAB's logical
    indexing takes the FIRST nnz values of the in-range absorption
    profile, shifting it whenever a masked pixel lies in the modelling
    range).  Off by default: the aligned profile is the scientifically
    intended behaviour (module docstring); the switch exists so a
    MATLAB-output comparison can hold on every spectrum, completing the
    quirk-switch family (training ``prior_in_value``, ascii
    ``reference_quirk_drop_name``).

    Returns dict with log_likelihood_no_dla, sample_log_likelihoods_dla
    (S,), min_z_dla, max_z_dla.
    """
    prep = _prepare_spectrum(
        wavelengths, flux, noise_variance, mask, z_qso,
        model_grid, model_mu, model_M, model_log_omega,
        log_c_0, log_tau_0, log_beta, params,
    )
    dtype = flux.dtype
    mu, M, omega2, valid = prep["mu"], prep["M"], prep["omega2"], prep["valid"]
    log_likelihood_no_dla = prep["log_likelihood_no_dla"]
    min_z_dla, max_z_dla = prep["min_z_dla"], prep["max_z_dla"]

    offsets = jnp.asarray(offset_samples, dtype)
    nhis = jnp.asarray(nhi_samples, dtype)
    windowed = sample_window is not None and dtype == jnp.float32
    if windowed:
        # z-sort the samples so each chunk spans a narrow pixel window
        # (undone after the chunked evaluation)
        order = jnp.argsort(offsets)
        offsets = offsets[order]
        nhis = nhis[order]
        unsort = jnp.argsort(order)
    z_dlas = min_z_dla + (max_z_dla - min_z_dla) * offsets
    padded_wavelengths = prep["padded_wavelengths"]

    misalign_idx = None
    if reference_misaligned_absorption:
        # The in-range window is a contiguous pixel interval, so the
        # reference's "first nnz" selection maps the j-th VALID pixel to
        # the absorption value at in-range pixel i0 + j (i0 = first
        # in-range pixel, j counting valid pixels only); on a uniform
        # log-lambda grid the profile value at that pixel equals the
        # reference's (computed on the in-range + log-pad grid).
        rest = wavelengths / (1.0 + z_qso)
        nm = params.null_model
        in_range = (rest >= nm.min_lambda) & (rest <= nm.max_lambda)
        i0 = jnp.argmax(in_range)  # first in-range pixel (0 if none)
        rank = jnp.cumsum(valid.astype(jnp.int32)) - 1
        misalign_idx = jnp.clip(i0 + rank, 0, wavelengths.shape[0] - 1)

    num_samples = offsets.shape[0]
    if num_samples == 0:
        # prep-only mode: skip the sample loop entirely
        return {
            "log_likelihood_no_dla": log_likelihood_no_dla,
            "sample_log_likelihoods_dla": jnp.zeros((0,), dtype),
            "min_z_dla": min_z_dla,
            "max_z_dla": max_z_dla,
        }
    # pad by replicating the LAST sample: in windowed mode samples are
    # z-ascending, so this keeps the final chunk sorted and its pad
    # columns' line cores inside the chunk window (first-sample padding
    # would put the lowest-z core outside the window, computing
    # wrong-but-discarded values in the pad columns)
    pad = (-num_samples) % sample_chunk
    z_pad = jnp.concatenate([z_dlas, jnp.full((pad,), z_dlas[-1], dtype)])
    n_pad = jnp.concatenate([nhis, jnp.full((pad,), nhis[-1], dtype)])
    z_chunks = z_pad.reshape(-1, sample_chunk)
    n_chunks = n_pad.reshape(-1, sample_chunk)

    def one_chunk(args):
        z_c, n_c = args
        if windowed:
            from .ops.voigt import voigt_absorption_windowed

            absorption = voigt_absorption_windowed(
                padded_wavelengths,
                z_c,
                n_c,
                num_lines=params.num_lines,
                instrument=params.instrument,
                window=sample_window,
            )
        else:
            absorption = voigt_absorption(
                padded_wavelengths,
                z_c,
                n_c,
                num_lines=params.num_lines,
                instrument=params.instrument,
            )
        if misalign_idx is not None:
            # reference quirk (see docstring): valid pixel j reads the
            # absorption computed for in-range pixel i0 + j
            absorption = absorption[:, misalign_idx]
        return batched_dla_log_likelihoods(
            flux, mu, M, omega2, noise_variance, valid, absorption
        )

    sample_lls = jax.lax.map(one_chunk, (z_chunks, n_chunks)).reshape(-1)[
        :num_samples
    ]
    if windowed:
        sample_lls = sample_lls[unsort]

    return {
        "log_likelihood_no_dla": log_likelihood_no_dla,
        "sample_log_likelihoods_dla": sample_lls,
        "min_z_dla": min_z_dla,
        "max_z_dla": max_z_dla,
    }


@partial(
    jax.jit,
    static_argnames=(
        "params",
        "sample_chunk",
        "sample_window",
        "reference_misaligned_absorption",
    ),
)
def batch_log_likelihoods(
    wavelengths,
    flux,
    noise_variance,
    mask,
    z_qso,
    model_grid,
    model_mu,
    model_M,
    model_log_omega,
    log_c_0,
    log_tau_0,
    log_beta,
    offset_samples,
    nhi_samples,
    *,
    params: Parameters,
    sample_chunk: int = 1000,
    sample_window: int | None = None,
    reference_misaligned_absorption: bool = False,
):
    """vmapped batch version of :func:`spectrum_log_likelihoods`: the
    sample axis runs in lax.map chunks of ``sample_chunk`` (any dtype,
    any device)."""
    fn = lambda w, f, n, m, z: spectrum_log_likelihoods(
        w,
        f,
        n,
        m,
        z,
        model_grid,
        model_mu,
        model_M,
        model_log_omega,
        log_c_0,
        log_tau_0,
        log_beta,
        offset_samples,
        nhi_samples,
        params,
        sample_chunk,
        sample_window,
        reference_misaligned_absorption,
    )
    return jax.vmap(fn)(wavelengths, flux, noise_variance, mask, z_qso)


# ---------------------------------------------------------------------------
# results container + host driver (process_qsos.m:73-86, 200-249)
# ---------------------------------------------------------------------------


@dataclass
class InferenceResults:
    """Everything processed_qsos_<set>.mat stores (process_qsos.m:235-243).

    Lean (catalog-only) runs — ShardedRunConfig(store_sample_likelihoods
    =False) — carry ``sample_log_likelihoods_dla=None`` and instead hold
    the device-reduced ``map_sample_inds``; everything a DLA *catalog*
    needs is present, while posterior-sample consumers (the two-DLA
    stage, the CDDF analysis) raise a clear error.
    """

    min_z_dlas: np.ndarray
    max_z_dlas: np.ndarray
    log_priors_no_dla: np.ndarray
    log_priors_dla: np.ndarray
    log_likelihoods_no_dla: np.ndarray
    log_likelihoods_dla: np.ndarray
    sample_log_likelihoods_dla: np.ndarray | None  # (N, num_dla_samples)
    log_posteriors_no_dla: np.ndarray
    log_posteriors_dla: np.ndarray
    model_posteriors: np.ndarray            # (N, 2): [no_dla, dla]
    p_no_dlas: np.ndarray
    p_dlas: np.ndarray
    # per-spectrum argmax over samples, device-reduced on lean runs
    # (None otherwise: the catalog writer argmaxes the matrix directly)
    map_sample_inds: np.ndarray | None = None

    def save(self, path: str | Path) -> None:
        from .utils.atomic_io import atomic_savez

        # atomic: a kill during this (large) write must leave either the
        # old artifact or the new one, never a torn npz.  Uncompressed:
        # the (N, S) log-likelihood matrix dominates the file and is
        # high-entropy (zlib gains ~2% for minutes of CPU at survey
        # scale — measured 41 MB compressed vs 40 MB raw per 1024-row
        # block).  None fields (lean runs / full runs' map inds) are
        # simply omitted; load() restores them as None.
        atomic_savez(
            path,
            compress=False,
            **{
                f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None
            },
        )

    # the ONLY fields save() may legitimately omit (lean runs omit the
    # matrix; full runs omit the device-reduced MAP) — any other
    # missing key is a corrupt/incompatible artifact and must fail
    # loudly, not default to None
    _OPTIONAL_FIELDS = ("sample_log_likelihoods_dla", "map_sample_inds")

    @classmethod
    def load(cls, path: str | Path) -> "InferenceResults":
        with np.load(Path(path)) as f:
            data = {k: f[k] for k in f.files}
        for name in cls._OPTIONAL_FIELDS:
            data.setdefault(name, None)
        missing = [
            fld.name
            for fld in dataclasses.fields(cls)
            if fld.name not in data
        ]
        if missing:
            raise ValueError(
                f"{path} is not a results artifact: missing {missing}"
            )
        return cls(**data)


def finalize_posteriors(
    log_priors_no_dla,
    log_priors_dla,
    log_likelihoods_no_dla,
    sample_log_likelihoods_dla,
):
    """Evidence aggregation + model posteriors (process_qsos.m:200-232).

    DLA evidence is the sample mean in a numerically safe form:
    max + log(mean(exp(ll - max))).
    """
    sample_lls = np.asarray(sample_log_likelihoods_dla)
    max_ll = np.max(sample_lls, axis=-1)
    log_likelihoods_dla = max_ll + np.log(
        np.mean(np.exp(sample_lls - max_ll[:, None]), axis=-1)
    )
    return posteriors_from_evidence(
        log_priors_no_dla,
        log_priors_dla,
        log_likelihoods_no_dla,
        log_likelihoods_dla,
    )


def posteriors_from_evidence(
    log_priors_no_dla,
    log_priors_dla,
    log_likelihoods_no_dla,
    log_likelihoods_dla,
):
    """Model posteriors from already-aggregated evidences — the second
    half of :func:`finalize_posteriors`, used directly by lean
    (catalog-only) runs whose evidence was reduced on device
    (parallel/streaming.pack_lean)."""
    log_likelihoods_dla = np.asarray(log_likelihoods_dla)
    log_posteriors_no_dla = log_priors_no_dla + log_likelihoods_no_dla
    log_posteriors_dla = log_priors_dla + log_likelihoods_dla

    both = np.stack([log_posteriors_no_dla, log_posteriors_dla], axis=-1)
    both_max = np.max(both, axis=-1, keepdims=True)
    model_posteriors = np.exp(both - both_max)
    model_posteriors /= model_posteriors.sum(axis=-1, keepdims=True)

    return {
        "log_likelihoods_dla": log_likelihoods_dla,
        "log_posteriors_no_dla": log_posteriors_no_dla,
        "log_posteriors_dla": log_posteriors_dla,
        "model_posteriors": model_posteriors,
        "p_no_dlas": model_posteriors[:, 0],
        "p_dlas": 1.0 - model_posteriors[:, 0],
    }


def resolve_dtype(dtype, caller: str = "process_spectra"):
    """float64 without jax_enable_x64 would be truncated silently by
    every jnp.asarray call — warn ONCE and downgrade explicitly."""
    if np.dtype(dtype) == np.float64 and not jax.config.jax_enable_x64:
        import warnings

        warnings.warn(
            f"{caller}(dtype=float64) requested but jax_enable_x64 is "
            "off — JAX would silently truncate to float32. Running in "
            "float32; enable x64 (jax.config.update('jax_enable_x64', "
            "True)) for the double-precision parity path.",
            stacklevel=3,
        )
        return np.float32
    return dtype


def process_spectra(
    model: GPModel,
    offset_samples,
    nhi_samples,
    spectra: PaddedSpectra,
    prior_z_qsos,
    prior_dla_flags,
    params: Parameters | None = None,
    batch_size: int = 16,
    sample_chunk: int = 1000,
    dtype=np.float64,
    progress: bool = False,
    reference_misaligned_absorption: bool = False,
) -> InferenceResults:
    """Single-host inference driver over a set of spectra.

    The multi-chip sharded driver lives in parallel/sharded_inference.py;
    this one runs fixed-size jitted batches sequentially on the default
    device (padding the final partial batch).

    ``reference_misaligned_absorption``: opt-in reproduction of the
    reference's absorption-alignment quirk (see
    :func:`spectrum_log_likelihoods`).
    """
    if params is None:
        params = Parameters()
    dtype = resolve_dtype(dtype)

    n = len(spectra)
    log_p_dla, log_p_no_dla = dla_rate_priors(
        spectra.z_qso, prior_z_qsos, prior_dla_flags, params
    )

    num_samples = len(np.asarray(offset_samples))
    out_null = np.empty(n)
    # the (N, S) sample matrix is the dominant host-memory term at
    # survey scale (162k x 10k f32 = 6.5 GB; f64 would double it for
    # values computed at the run dtype anyway) — store at that dtype
    out_samples = np.empty((n, num_samples), np.dtype(dtype))
    out_min_z = np.empty(n)
    out_max_z = np.empty(n)

    model_args = (
        jnp.asarray(model.rest_wavelengths, dtype),
        jnp.asarray(model.mu, dtype),
        jnp.asarray(model.M, dtype),
        jnp.asarray(model.log_omega, dtype),
        model.log_c_0,
        model.log_tau_0,
        model.log_beta,
        jnp.asarray(np.asarray(offset_samples, dtype)),
        jnp.asarray(np.asarray(nhi_samples, dtype)),
    )

    fetch = lambda o: {k: np.asarray(v) for k, v in o.items()}
    for start in range(0, n, batch_size):
        stop = min(start + batch_size, n)
        batch = spectra.slice(slice(start, stop)).pad_to(batch_size)
        args = (
            jnp.asarray(batch.wavelengths, dtype),
            jnp.asarray(batch.flux, dtype),
            jnp.asarray(batch.noise_variance, dtype),
            jnp.asarray(batch.mask),
            jnp.asarray(batch.z_qso, dtype),
        )
        out = fetch(
            batch_log_likelihoods(
                *args, *model_args,
                params=params,
                sample_chunk=sample_chunk,
                reference_misaligned_absorption=reference_misaligned_absorption,
            )
        )
        keep = stop - start
        out_null[start:stop] = out["log_likelihood_no_dla"][:keep]
        out_samples[start:stop] = out["sample_log_likelihoods_dla"][:keep]
        out_min_z[start:stop] = out["min_z_dla"][:keep]
        out_max_z[start:stop] = out["max_z_dla"][:keep]
        if progress:
            print(f"processed {stop}/{n} spectra", flush=True)

    post = finalize_posteriors(log_p_no_dla, log_p_dla, out_null, out_samples)
    from .utils import debug_print

    for i in range(n):  # fprintf_debug equivalents (process_qsos.m:134-217)
        debug_print(
            "quasar %d: log p(D|no DLA) = %0.2f, log p(D|DLA) = %0.2f, "
            "p(DLA|D) = %0.4f",
            i,
            out_null[i],
            post["log_likelihoods_dla"][i],
            post["p_dlas"][i],
        )
    return InferenceResults(
        min_z_dlas=out_min_z,
        max_z_dlas=out_max_z,
        log_priors_no_dla=log_p_no_dla,
        log_priors_dla=log_p_dla,
        log_likelihoods_no_dla=out_null,
        log_likelihoods_dla=post["log_likelihoods_dla"],
        sample_log_likelihoods_dla=out_samples,
        log_posteriors_no_dla=post["log_posteriors_no_dla"],
        log_posteriors_dla=post["log_posteriors_dla"],
        model_posteriors=post["model_posteriors"],
        p_no_dlas=post["p_no_dlas"],
        p_dlas=post["p_dlas"],
    )
