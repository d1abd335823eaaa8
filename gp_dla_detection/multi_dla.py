"""Two-DLA model selection (beyond-reference capability).

The reference repository models at most one DLA per sightline
(process_qsos.m); its Python analysis layer, however, already consumes
a multi-DLA output format produced by later versions of the pipeline
(calc_cddf.py:40,102-116: a second set of per-sample log likelihoods,
``base_sample_inds`` mapping each sample to its second absorber's
parameters, and P(exactly 2 DLAs) from a 3-column model posterior).

This module produces that format natively.  Design (documented choices,
format-compatible with calc_cddf's consumer):

  - The 2-DLA parameter space is sampled by pairing QMC sample j (one
    absorber at theta_j, identical to the 1-DLA model's sample) with a
    SPECTRUM-DEPENDENT second absorber at theta_{base_sample_inds[s, j]},
    drawn by deterministic inverse-CDF resampling of spectrum s's 1-DLA
    posterior — the fresh QMC axis covers one absorber while the
    resampled axis concentrates on wherever the first absorber already
    is, so joint coverage costs the same 10k evaluations ("spectrum
    dependent" base samples, calc_cddf.py:225-227).
  - Pairs whose absorbers are closer than ``min_separation_kms``
    (default 3000 km/s, the same velocity scale as the search-range
    cuts, set_parameters.m:62-73) are invalid: their log likelihood is
    NaN, exactly the convention the analysis layer expects
    (calc_cddf.py:66-68 "Mask out nan values ... DLAs are too close").
  - The two-DLA absorption is the product of the two RAW Voigt
    profiles (optical depths add), instrumentally broadened once —
    the instrument convolves the physical product, not each absorber.
  - The model prior extends the counting prior (process_qsos.m:122-132):
    p(>=2 DLAs | z_QSO) = (# prior sightlines with >= 2 DLAs below the
    z cut) / count, and p(exactly 1) = p(>=1) - p(>=2).

Model posteriors become [no DLA, exactly 1 DLA, 2 DLAs].
"""

from __future__ import annotations

import dataclasses
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from .inference import PaddedSpectra, _prepare_spectrum
from .models.qso_model import GPModel
from .ops.low_rank_mvn import batched_dla_log_likelihoods
from .ops.voigt import voigt_absorption
from .params import Parameters, kms_to_z

__all__ = [
    "REPLICATE_TILE",
    "MultiDLAResults",
    "base_sample_grid",
    "base_sample_perm",
    "device_base_sample_inds",
    "device_inverse_cdf_grid",
    "finalize_multi",
    "finalize_multi_from_evidence",
    "make_base_sample_inds",
    "make_batch_dla2_fn",
    "multi_dla_rate_priors",
    "pack_lean_pair",
    "packed_base_tables",
    "prior_dla_multiplicity",
    "process_spectra_multi",
    "replicate_draw_pattern",
]


def prior_dla_multiplicity(
    prior_z_qsos, prior_dla_flags, prior_z_dlas
) -> np.ndarray:
    """Per-prior-sightline DLA count for the extended counting prior.

    The multiplicity analogue of inference.correct_prior_dla_flags
    (process_qsos.m:15-27): a catalog DLA counts only if its Lyα line
    falls above the quasar's Lyman limit.  A flagged sightline whose
    catalog lacks absorber redshifts counts as 1 (same convention as
    the flag correction, which leaves such flags set).
    """
    from .params import LYA_WAVELENGTH, LYMAN_LIMIT

    flags = np.asarray(prior_dla_flags, bool)
    num = np.zeros(len(flags), np.int64)
    for i in np.flatnonzero(flags):
        entry = prior_z_dlas[i]
        if entry is None:
            # documented "no absorber redshifts" marker, same contract
            # as correct_prior_dla_flags (np.atleast_1d(None) would be
            # an object array and crash the arithmetic below)
            num[i] = 1
            continue
        z_dlas = np.atleast_1d(np.asarray(entry, dtype=float))
        if z_dlas.size == 0:
            num[i] = 1
        else:
            num[i] = int(
                np.sum(
                    LYA_WAVELENGTH * (1 + z_dlas)
                    >= LYMAN_LIMIT * (1 + prior_z_qsos[i])
                )
            )
    return num


def base_sample_perm(num_samples: int, seed: int = 0) -> np.ndarray:
    """The grid permutation underlying :func:`base_sample_grid`:
    u_j = (perm_j + 0.5) / S.  Exposed separately for
    :func:`device_inverse_cdf_grid`, whose search-free inverse CDF
    consumes the integer grid positions rather than the float points."""
    rng = np.random.default_rng(seed)
    return rng.permutation(num_samples)


def base_sample_grid(num_samples: int, seed: int = 0) -> np.ndarray:
    """The shuffled inverse-CDF grid points shared by the host
    (:func:`make_base_sample_inds`) and device
    (:func:`device_base_sample_inds`) resamplers: u_j = (perm(S)_j +
    0.5) / S.  Deterministic in (seed, S); the shuffle decorrelates the
    base draw from the fresh QMC axis (sample j would otherwise always
    pair with the j/S posterior quantile)."""
    return (base_sample_perm(num_samples, seed) + 0.5) / num_samples


def packed_base_tables(offset_samples, nhi_samples, dtype) -> np.ndarray:
    """(S, 2) packed (z_offset, N_HI) rows for the device base-value
    gather shared by both pair drivers (classic and fused lean): one
    row gather fetches both values per index in a single pass, instead
    of two (S,) table gathers."""
    return np.stack(
        [np.asarray(offset_samples), np.asarray(nhi_samples)], axis=1
    ).astype(dtype)


def _posterior_cdf(sample_log_likelihoods):
    """Per-row normalized posterior CDF of a (B, S) sample-likelihood
    matrix, with the host resampler's degenerate-row handling: NaN
    treated as -inf, rows with no finite mass (fully-masked spectrum)
    fall back to uniform weights — a zero-total CDF would divide to NaN
    and corrupt the downstream search."""
    sll = sample_log_likelihoods
    finite = jnp.where(jnp.isnan(sll), -jnp.inf, sll)
    rowmax = jnp.max(finite, axis=1, keepdims=True)
    rowmax = jnp.where(jnp.isfinite(rowmax), rowmax, 0.0)
    w = jnp.exp(finite - rowmax)
    w = jnp.where(jnp.sum(w, axis=1, keepdims=True) == 0.0, 1.0, w)
    cdf = jnp.cumsum(w, axis=1)
    return cdf / cdf[:, -1:]


@jax.jit
def device_base_sample_inds(sample_log_likelihoods, u):
    """On-device :func:`make_base_sample_inds`: per-spectrum inverse-CDF
    resampling of the 1-DLA posterior at the shuffled grid points ``u``
    (from :func:`base_sample_grid`), computed where the (B, S) sample
    matrix already lives so lean (catalog-only) runs never fetch it.

    Same semantics as the host resampler — NaN rows treated as -inf,
    degenerate (no finite mass) rows fall back to uniform weights,
    side='left' search — with two documented deviations: the CDF
    accumulates at the INPUT dtype (f32 on the production path; the
    host casts to f64) and XLA's cumsum associates differently than
    numpy's serial scan, so a draw landing within rounding error of a
    CDF step can resolve to a neighbouring sample.  Both paths are
    individually deterministic; the draws are identically distributed.

    The search co-sorts the CDF with the queries (searchsorted
    method='sort': exact, same results as the default binary scan,
    which costs 14 rounds of (B, S) dynamic gathers).  The
    fused lean driver uses :func:`device_inverse_cdf_grid`, which is
    faster still by exploiting the grid structure of ``u``.
    """
    s = sample_log_likelihoods.shape[1]
    cdf = _posterior_cdf(sample_log_likelihoods)
    inds = jax.vmap(
        lambda row: jnp.searchsorted(row, u.astype(row.dtype), method="sort")
    )(cdf)
    return jnp.clip(inds, 0, s - 1).astype(jnp.int32)


# Column-block width of the base-replicated draw layout.  It fixes which
# pair columns share a draw, so it is part of the numerics of an R > 1
# run and must not change while such checkpoints exist.
REPLICATE_TILE = 256


def replicate_draw_pattern(
    num_samples: int, tile: int, replicates: int
) -> tuple[np.ndarray, int]:
    """Draw-slot assignment for base-replicated pair sampling.

    With ``replicates`` R > 1, each block of ``tile`` pair columns
    shares tile/R unique base draws, laid out so column l and column
    l + tile/R carry the SAME draw.  Statistically the pair estimator stays
    an unbiased posterior-resampled Monte Carlo sum — the draw
    assignment is a FIXED pattern, independent of the sample values —
    with R-fold-coarser stratification of the base axis (n_draws grid
    quantiles instead of num_samples).

    Returns ``(draw_idx, n_draws)``: ``draw_idx[p]`` is the draw slot
    for pair column p, ``n_draws`` the number of distinct slots.
    """
    if replicates < 1 or tile % replicates:
        raise ValueError(
            f"replicates must divide the sample tile (got {replicates} "
            f"vs tile {tile})"
        )
    pos = np.arange(num_samples)
    width = tile // replicates
    draw_idx = (pos // tile) * width + (pos % tile) % width
    return draw_idx.astype(np.int64), int(draw_idx.max()) + 1


@functools.partial(jax.jit, static_argnames=("grid_size",))
def device_inverse_cdf_grid(sample_log_likelihoods, kvec, grid_size=None):
    """Search-free :func:`device_base_sample_inds` for GRID quantiles:
    per-row inverse-CDF of the 1-DLA posterior at u_j = (kvec_j + 0.5)/S
    — the structure :func:`base_sample_grid` guarantees (kvec = the
    grid permutation, possibly composed with further permutations).

    Equivalent to ``searchsorted(cdf, (kvec+0.5)/S, side='left')`` but
    with no search at all: each CDF step is bucketed into its uniform
    grid cell (m_i = #{k : u_k <= cdf_i}, one rounding + a two-step
    exact correction against the grid's own arithmetic), a scatter-add
    histograms the buckets, and a cumsum yields the counts
    g_k = #{i : cdf_i < u_k} — the searchsorted answer — read out at
    ``kvec``.

    Exactness: in f64 this is bit-identical to searchsorted on the
    stored grid (the correction recomputes (m±0.5)/S with the same
    single rounding numpy used to build it) — EXCEPT at an exact
    cdf == u tie, where XLA's simplifier may lower the correction's
    division as multiply-by-reciprocal in the comparison path and
    resolve the tie to the other side (a zero-posterior-mass flip; both
    sides are valid inverse-CDF draws).  Exact ties cannot occur on
    rows with finite mass (cdf values are sums of exp() terms, the grid
    is half-integer rationals); they need the degenerate-row uniform
    fallback (cdf = (i+1)/S) AND a grid_size whose half-grid meets it,
    impossible at grid_size == S and rare otherwise.  In f32 the stored
    grid is DOUBLE-rounded (f64 build, f32 cast), so a CDF step within
    one ulp of a cell boundary can resolve to the neighbouring sample —
    the same knife-edge class the f32 CDF accumulation already has.

    ``grid_size`` (static) sets the quantile grid size S separately
    from the sample count: base-replicated pair sampling draws at
    n_draws < num_samples grid quantiles (:func:`replicate_draw_
    pattern`), so ``kvec`` holds positions < grid_size while the
    returned indices still run over the full sample axis.  Default
    (None): grid size = sample count, the classic one-draw-per-column
    resample.
    """
    if grid_size is None:
        grid_size = sample_log_likelihoods.shape[1]
    cdf = _posterior_cdf(sample_log_likelihoods)
    return _grid_counts(cdf, grid_size)[:, kvec]


def _grid_counts(cdf, s: int):
    """The search half of :func:`device_inverse_cdf_grid`: per-row
    counts g_k = #{i : cdf_i < (k+0.5)/s} for every grid position k —
    the searchsorted answer at all s grid quantiles, with no search
    (bucket + scatter-add histogram + cumsum).  ``s`` is the GRID size
    (== the CDF's sample count except under base replication); counts
    are clipped to valid sample indices."""
    dt = cdf.dtype
    s_f = jnp.asarray(s, dt)
    m = jnp.clip(jnp.floor(cdf * s_f + 0.5).astype(jnp.int32), 0, s)
    for _ in range(2):  # |rounded - true| <= 1; two steps each way
        u_below = (m.astype(dt) - 0.5) / s_f
        m = jnp.where((m > 0) & (u_below > cdf), m - 1, m)
        u_at = (m.astype(dt) + 0.5) / s_f
        m = jnp.where((m < s) & (u_at <= cdf), m + 1, m)
    hist = jnp.zeros((cdf.shape[0], s + 1), jnp.int32)
    hist = hist.at[jnp.arange(cdf.shape[0])[:, None], m].add(1)
    g = jnp.cumsum(hist[:, :s], axis=1)
    # counts index SAMPLES (CDF steps), so clip to the sample axis —
    # distinct from the grid size when base replication coarsens the grid
    return jnp.clip(g, 0, cdf.shape[1] - 1).astype(jnp.int32)


@jax.jit
def pack_lean_pair(pair_lls, base_inds):
    """Device reduction of a (B, S) two-DLA pair matrix for lean runs:
    pair evidence + MAP pair index + the base sample index at the MAP.

    Evidence matches :func:`finalize_multi`'s host form — nanmax +
    log(nanmean(exp(x - nanmax))) over VALID pairs only (NaN = closer
    than min_separation; those carry no posterior mass) — evaluated at
    the run dtype from the exact device values.  Rows with NO valid
    pair return NaN evidence and -1 indices (the host np.nanmax of an
    all-NaN row is NaN too).

    Returns (evidence (B,), map_index (B,) f32, map_base_index (B,)
    f32) — indices as f32 so they ride the driver's stacked
    small-vector fetch; exact for any S < 2**24.
    """
    valid = jnp.isfinite(pair_lls)
    neg = jnp.where(valid, pair_lls, -jnp.inf)
    rowmax = jnp.max(neg, axis=1)
    safe_max = jnp.where(jnp.isfinite(rowmax), rowmax, 0.0)
    count = jnp.sum(valid, axis=1)
    total = jnp.sum(
        jnp.where(valid, jnp.exp(pair_lls - safe_max[:, None]), 0.0), axis=1
    )
    evidence = jnp.where(
        count > 0,
        safe_max + jnp.log(total / jnp.maximum(count, 1)),
        jnp.nan,
    )
    map_ind = jnp.argmax(neg, axis=1)
    map_base = jnp.take_along_axis(base_inds, map_ind[:, None], axis=1)[:, 0]
    map_ind = jnp.where(count > 0, map_ind, -1)
    map_base = jnp.where(count > 0, map_base, -1)
    return evidence, map_ind.astype(jnp.float32), map_base.astype(jnp.float32)


def make_base_sample_inds(
    sample_log_likelihoods, seed: int = 0, row_chunk: int = 8192
) -> np.ndarray:
    """Per-spectrum second-absorber sample indices, (N, S).

    For each spectrum, draws S indices from its normalized 1-DLA
    posterior by deterministic inverse-CDF resampling at shuffled
    uniform grid points (reproducible; no RNG state beyond the seed).

    Processed in row chunks: every row is independent and the shuffled
    grid depends only on (seed, S), so chunking is bit-identical — the
    unchunked form holds ~6 float64 (N, S) temporaries at once, which
    is ~80 GB at full DR12Q scale (162,861 x 10,000).
    """
    sll_all = np.asarray(sample_log_likelihoods)
    n, s = sll_all.shape
    u = base_sample_grid(s, seed)
    out = np.empty((n, s), np.int32)
    for c0 in range(0, n, row_chunk):
        sll = sll_all[c0 : c0 + row_chunk].astype(np.float64)
        m = sll.shape[0]
        # vectorized row-wise inverse CDF: offset each row's CDF (in
        # [0,1]) by 2*i so a single flat searchsorted handles all rows.
        # Degenerate rows (all-NaN likelihoods from a fully-masked
        # spectrum, or all -inf) get a UNIFORM weight fallback: a NaN
        # row would break the flat array's sortedness and silently
        # corrupt the indices of every later row in the chunk (binary
        # search treats NaN as >= any query).
        sll = np.where(np.isnan(sll), -np.inf, sll)
        rowmax = sll.max(axis=1, keepdims=True)
        rowmax = np.where(np.isfinite(rowmax), rowmax, 0.0)
        w = np.exp(sll - rowmax)
        w[w.sum(axis=1) == 0.0] = 1.0
        cdf = np.cumsum(w, axis=1)
        cdf /= cdf[:, -1:]
        offs = 2.0 * np.arange(m)[:, None]
        flat = np.searchsorted(
            (cdf + offs).ravel(), (u[None, :] + offs).ravel()
        )
        base = flat.reshape(m, s) - s * np.arange(m)[:, None]
        out[c0 : c0 + row_chunk] = np.clip(base, 0, s - 1)
    return out


def multi_dla_rate_priors(
    z_qsos, prior_z_qsos, prior_num_dlas, params: Parameters
):
    """Counting priors for >=1 and >=2 DLAs (extending
    process_qsos.m:122-132).

    prior_num_dlas: per prior-sightline DLA multiplicity (0, 1, 2, ...).
    Returns (log_p_no_dla, log_p_one_dla, log_p_two_dla), each (B,).
    """
    prior_num = np.asarray(prior_num_dlas)
    order = np.argsort(prior_z_qsos, kind="stable")
    z_sorted = np.asarray(prior_z_qsos)[order]
    ge1 = np.concatenate([[0], np.cumsum((prior_num[order] >= 1).astype(np.int64))])
    ge2 = np.concatenate([[0], np.cumsum((prior_num[order] >= 2).astype(np.int64))])

    counts = np.searchsorted(
        z_sorted, np.asarray(z_qsos) + params.prior_z_qso_increase, side="left"
    )
    n1 = ge1[counts]
    n2 = ge2[counts]
    # counts == 0 edge: documented limit (zero observed occurrences ->
    # zero prior weight on the DLA models), matching dla_rate_priors
    # rather than the reference's NaN (process_qsos.m:122-132).
    safe_counts = np.maximum(counts, 1)
    with np.errstate(divide="ignore"):
        log_p_two = np.log(n2) - np.log(safe_counts)
        log_p_one = np.log(n1 - n2) - np.log(safe_counts)
        log_p_none = np.log(counts - n1) - np.log(safe_counts)
    log_p_two = np.where(counts > 0, log_p_two, -np.inf)
    log_p_one = np.where(counts > 0, log_p_one, -np.inf)
    log_p_none = np.where(counts > 0, log_p_none, 0.0)
    return log_p_none, log_p_one, log_p_two


def _second_dla_chunk(
    padded_wavelengths,
    flux,
    mu,
    M,
    omega2,
    noise_variance,
    valid,
    z1,
    n1,
    z2,
    n2,
    params: Parameters,
    min_separation_z: float,
):
    """Per-chunk two-DLA log likelihoods.

    Optical depths add BEFORE instrumental broadening — the instrument
    sees the product of the raw profiles, so the convolution is applied
    once to a1*a2, not separately to each absorber.
    """
    from .ops.voigt import instrumental_broadening

    a1 = voigt_absorption(
        padded_wavelengths, z1, n1,
        num_lines=params.num_lines, instrument=params.instrument,
        broaden=False,
    )
    a2 = voigt_absorption(
        padded_wavelengths, z2, n2,
        num_lines=params.num_lines, instrument=params.instrument,
        broaden=False,
    )
    lls = batched_dla_log_likelihoods(
        flux, mu, M, omega2, noise_variance, valid,
        instrumental_broadening(a1 * a2, params.instrument),
    )
    too_close = jnp.abs(jnp.log1p(z1) - jnp.log1p(z2)) < jnp.log1p(
        min_separation_z
    )
    return jnp.where(too_close, jnp.nan, lls)


@dataclasses.dataclass
class MultiDLAResults:
    """Single + two-DLA model selection outputs (the later-pipeline
    format our analysis layer and matio exporter consume).

    Lean (catalog-only) two-stage runs carry None for both (N, S)
    matrices and instead hold the device-reduced MAP indices; the
    posterior-sample consumers (CDDF analysis, .mat export) raise a
    clear error on lean results.
    """

    single: "object"                     # InferenceResults (1-DLA fields)
    # (N, S), NaN = invalid pair; None on lean runs
    sample_log_likelihoods_dla2: np.ndarray | None
    # (N, S) per-spectrum base indices; None on lean runs
    base_sample_inds: np.ndarray | None
    log_likelihoods_dla2: np.ndarray          # (N,)
    log_priors_one_dla: np.ndarray
    log_priors_two_dla: np.ndarray
    model_posteriors: np.ndarray              # (N, 3)
    # device-reduced on lean runs (None otherwise: the catalog writer
    # argmaxes the matrices directly): per-spectrum argmax over valid
    # pairs, and the base sample index at that argmax — both in
    # ORIGINAL sample numbering; -1 = no valid pair
    map_sample_inds2: np.ndarray | None = None
    map_base_sample_inds: np.ndarray | None = None
    # device-reduced CDDF inputs (cddf_inputs.CDDFInputs) when the lean
    # fused driver ran with store_cddf_inputs=True: lets the L7 science
    # statistics (analysis/lean_catalogue.LeanDLACatalogue) run without
    # the (N, S) matrices
    cddf_inputs: "object | None" = None

    # the ONLY fields save() may legitimately omit (lean runs omit the
    # matrices; full runs omit the device-reduced MAPs) — any other
    # missing key is a corrupt/incompatible artifact and must fail
    # loudly, not default to None
    _OPTIONAL_KEYS = (
        "sample_log_likelihoods_dla2",
        "base_sample_inds",
        "map_sample_inds2",
        "map_base_sample_inds",
    )

    def save(self, path: str | Path) -> None:
        payload = {
            f.name: getattr(self.single, f.name)
            for f in dataclasses.fields(type(self.single))
            # None fields (a full run's map_sample_inds) have no npz
            # representation; load() restores them as None
            if getattr(self.single, f.name) is not None
        }
        payload.update(
            {
                key: getattr(self, attr)
                for key, attr in self._MULTI_KEYS.items()
                if getattr(self, attr) is not None
            }
        )
        if self.cddf_inputs is not None:
            payload.update(self.cddf_inputs.to_npz_dict())
        from .utils.atomic_io import atomic_savez

        # atomic + uncompressed: kill-safe, and the (N, S) pair matrix
        # is high-entropy (see InferenceResults.save)
        atomic_savez(path, compress=False, **payload)

    _MULTI_KEYS = {
        "sample_log_likelihoods_dla2": "sample_log_likelihoods_dla2",
        "base_sample_inds": "base_sample_inds",
        "log_likelihoods_dla2": "log_likelihoods_dla2",
        "log_priors_one_dla": "log_priors_one_dla",
        "log_priors_two_dla": "log_priors_two_dla",
        "multi_model_posteriors": "model_posteriors",
        "map_sample_inds2": "map_sample_inds2",
        "map_base_sample_inds": "map_base_sample_inds",
    }

    @classmethod
    def load(cls, path: str | Path) -> "MultiDLAResults":
        from .inference import InferenceResults

        with np.load(Path(path)) as f:
            single = InferenceResults(
                **{
                    k: f[k]
                    for k in f.files
                    if k not in cls._MULTI_KEYS
                    and not k.startswith("cddf_")
                },
                **{
                    name: None
                    for name in InferenceResults._OPTIONAL_FIELDS
                    if name not in f.files
                },
            )
            missing = [
                key
                for key in cls._MULTI_KEYS
                if key not in f.files and key not in cls._OPTIONAL_KEYS
            ]
            if missing:
                raise ValueError(
                    f"{path} is not a two-DLA results artifact: "
                    f"missing {missing}"
                )
            cddf = None
            from .cddf_inputs import CDDFInputs

            if CDDFInputs.npz_present(f.files):
                cddf = CDDFInputs.from_npz_dict(f)
            return cls(
                single=single,
                cddf_inputs=cddf,
                **{
                    attr: (f[key] if key in f.files else None)
                    for key, attr in cls._MULTI_KEYS.items()
                },
            )


def make_batch_dla2_fn(
    model: GPModel,
    params: Parameters,
    num_samples: int,
    sample_chunk: int,
    min_sep_z: float,
):
    """Build the jitted two-DLA batch evaluator shared by the
    single-host and sharded drivers.

    Signature of the returned fn:
      (wavelengths, flux, noise_variance, mask, z_qso,
       grid, mu, M, log_omega, offsets, nhis, base_offsets, base_nhis)
      -> (B, S) pair log likelihoods (NaN = closer than min_sep_z).
    """
    S = num_samples

    @jax.jit
    def batch_dla2(w, f, nv, m, zq, grid, mu_g, M_g, lo_g, off, nh, off_b, nh_b):
        # off/nh are shared (S,); off_b/nh_b are per-spectrum (B, S)
        def per_spectrum(w1, f1, nv1, m1, z1q, off_b1, nh_b1):
            prep = _prepare_spectrum(
                w1, f1, nv1, m1, z1q,
                grid, mu_g, M_g, lo_g,
                model.log_c_0, model.log_tau_0, model.log_beta, params,
            )
            z_all = prep["min_z_dla"] + (
                prep["max_z_dla"] - prep["min_z_dla"]
            ) * off
            z_b = prep["min_z_dla"] + (
                prep["max_z_dla"] - prep["min_z_dla"]
            ) * off_b1
            pad = (-S) % sample_chunk
            padded = lambda a: jnp.concatenate(
                [a, jnp.full((pad,), a[0], a.dtype)]
            ).reshape(-1, sample_chunk)

            def one_chunk(args):
                z1, n1_, z2, n2_ = args
                return _second_dla_chunk(
                    prep["padded_wavelengths"], f1, prep["mu"], prep["M"],
                    prep["omega2"], nv1, prep["valid"],
                    z1, n1_, z2, n2_, params, min_sep_z,
                )

            lls = jax.lax.map(
                one_chunk,
                (padded(z_all), padded(nh), padded(z_b), padded(nh_b1)),
            ).reshape(-1)[:S]
            return lls

        return jax.vmap(per_spectrum)(w, f, nv, m, zq, off_b, nh_b)

    return batch_dla2


def _multi_posteriors(single, ll2, z_qsos, prior_z_qsos, prior_num_dlas,
                      params: Parameters):
    """Extended counting priors + normalized 3-model posteriors
    [no DLA, exactly 1, 2 DLAs] from the aggregated evidences."""
    log_p0, log_p1, log_p2 = multi_dla_rate_priors(
        z_qsos, prior_z_qsos, prior_num_dlas, params
    )
    posts = np.stack(
        [
            log_p0 + single.log_likelihoods_no_dla,
            log_p1 + single.log_likelihoods_dla,
            log_p2 + ll2,
        ],
        axis=1,
    )
    pmax = np.max(posts, axis=1, keepdims=True)
    model_posteriors = np.exp(posts - pmax)
    model_posteriors /= model_posteriors.sum(axis=1, keepdims=True)
    return log_p1, log_p2, model_posteriors


def finalize_multi_from_evidence(
    single, ll2, z_qsos, prior_z_qsos, prior_num_dlas,
    params: Parameters,
    map_sample_inds2=None,
    map_base_sample_inds=None,
    cddf_inputs=None,
) -> MultiDLAResults:
    """3-model posteriors from ALREADY-aggregated pair evidences — the
    lean (catalog-only) analogue of :func:`finalize_multi`, used by the
    fused two-stage driver whose pair evidence and MAP indices were
    reduced on device (:func:`pack_lean_pair`); the (N, S) matrices
    never existed on the host, so the result carries None for them."""
    log_p1, log_p2, model_posteriors = _multi_posteriors(
        single, np.asarray(ll2, np.float64), z_qsos, prior_z_qsos,
        prior_num_dlas, params,
    )
    return MultiDLAResults(
        single=single,
        sample_log_likelihoods_dla2=None,
        base_sample_inds=None,
        log_likelihoods_dla2=np.asarray(ll2, np.float64),
        log_priors_one_dla=log_p1,
        log_priors_two_dla=log_p2,
        model_posteriors=model_posteriors,
        map_sample_inds2=map_sample_inds2,
        map_base_sample_inds=map_base_sample_inds,
        cddf_inputs=cddf_inputs,
    )


def finalize_multi(
    single, out2, base, z_qsos, prior_z_qsos, prior_num_dlas,
    params: Parameters,
) -> MultiDLAResults:
    """Pair-evidence aggregation + 3-model posteriors from the raw
    (N, S) two-DLA sample log likelihoods."""
    # evidence: mean over VALID pairs (NaN pairs carry no mass);
    # reduction in float64 regardless of the storage dtype
    with np.errstate(invalid="ignore"):
        max2 = np.nanmax(out2, axis=1).astype(np.float64)
        ll2 = max2 + np.log(
            np.nanmean(
                np.exp(out2 - max2[:, None], dtype=np.float64), axis=1
            )
        )

    log_p1, log_p2, model_posteriors = _multi_posteriors(
        single, ll2, z_qsos, prior_z_qsos, prior_num_dlas, params
    )
    return MultiDLAResults(
        single=single,
        sample_log_likelihoods_dla2=out2,
        base_sample_inds=base,
        log_likelihoods_dla2=ll2,
        log_priors_one_dla=log_p1,
        log_priors_two_dla=log_p2,
        model_posteriors=model_posteriors,
    )


def process_spectra_multi(
    model: GPModel,
    offset_samples,
    nhi_samples,
    spectra: PaddedSpectra,
    prior_z_qsos,
    prior_num_dlas,
    params: Parameters | None = None,
    batch_size: int = 16,
    sample_chunk: int = 1000,
    dtype=np.float64,
    min_separation_kms: float = 3000.0,
    base_seed: int = 0,
    single=None,
    checkpoint_dir=None,
) -> MultiDLAResults:
    """Model selection over {no DLA, 1 DLA, 2 DLAs}.

    Runs the standard single-DLA engine, then evaluates the paired
    two-DLA samples, and combines the three model evidences with the
    extended counting prior.

    ``single``: a precomputed InferenceResults for these exact spectra
    (e.g. from the sharded/checkpointed pipeline pass) — when given,
    the single-DLA stage is reused instead of recomputed.

    ``checkpoint_dir``: per-batch resume for the two-DLA pass (same
    shape-validated-manifest scheme as the sharded single-DLA driver).
    The single-DLA stage has its own checkpointing (pass ``single``
    from the sharded driver, or its internal process_spectra run is
    recomputed on resume).
    """
    from .inference import process_spectra

    if params is None:
        params = Parameters()
    from .inference import resolve_dtype

    dtype = resolve_dtype(dtype, "process_spectra_multi")
    offsets = np.asarray(offset_samples)
    nhis = np.asarray(nhi_samples)
    S = len(offsets)
    n = len(spectra)

    if single is None:
        single = process_spectra(
            model, offsets, nhis, spectra,
            prior_z_qsos, np.asarray(prior_num_dlas) >= 1,
            params=params, batch_size=batch_size, sample_chunk=sample_chunk,
            dtype=dtype,
        )
    elif single.sample_log_likelihoods_dla is None:
        raise ValueError(
            "two-stage {0,1,2}-DLA selection resamples the base absorber "
            "from the single-stage sample likelihoods, which a lean "
            "(catalog-only) run never stores — rerun the single stage "
            "with ShardedRunConfig(store_sample_likelihoods=True), or "
            "use the fused lean driver "
            "(parallel.process_spectra_multi_sharded with "
            "store_sample_likelihoods=False and no `single`)"
        )
    elif len(single.p_dlas) != n or single.sample_log_likelihoods_dla.shape[1] != S:
        raise ValueError(
            "precomputed single-DLA results do not match these spectra/"
            f"samples: {single.sample_log_likelihoods_dla.shape} vs ({n}, {S})"
        )

    base = make_base_sample_inds(
        single.sample_log_likelihoods_dla, seed=base_seed
    )
    min_sep_z = kms_to_z(min_separation_kms)

    model_args = (
        jnp.asarray(model.rest_wavelengths, dtype),
        jnp.asarray(model.mu, dtype),
        jnp.asarray(model.M, dtype),
        jnp.asarray(model.log_omega, dtype),
    )

    evaluate = make_batch_dla2_fn(model, params, S, sample_chunk, min_sep_z)

    # pair lls stored at the compute dtype: (N, S) is the dominant
    # host-memory term at survey scale (160k x 10k f32 = 6.4 GB)
    out2 = np.empty((n, S), np.dtype(dtype))
    off_j = jnp.asarray(offsets, dtype)
    nh_j = jnp.asarray(nhis, dtype)

    def base_slice(arr, start, stop):
        """Per-batch gather of the (B, S) pair-indexed base values —
        materializing offsets[base]/nhis[base] whole would stand ~13 GB
        each (f64) for the entire pass, when each batch needs only its
        rows."""
        return arr[base[start:stop]]

    ckpt_dir = Path(checkpoint_dir) if checkpoint_dir else None
    manifest_path = ckpt_dir / "manifest.json" if ckpt_dir else None
    # shape + numerics fingerprint, same scheme as the sharded drivers
    # (parallel.run_fingerprint): shape checks alone miss dtype /
    # separation-cut / model / sample changes, which must not
    # silently mix stale batches with fresh ones.  Imported lazily —
    # a module-level import would cycle through parallel.__init__.
    from .parallel.sharded_inference import run_fingerprint
    from types import SimpleNamespace

    fingerprint = run_fingerprint(
        dtype,
        SimpleNamespace(
            stream_dtype=None, windowed_voigt=False, sample_chunk=sample_chunk,
        ),
        params, model, offsets, nhis,
        extra=([min_sep_z], base, spectra.z_qso),
    )
    done: set = set()
    if manifest_path and manifest_path.exists():
        manifest = json.loads(manifest_path.read_text())
        if (
            manifest.get("num_spectra") == n
            and manifest.get("batch_size") == batch_size
            and manifest.get("num_samples") == S
            and manifest.get("base_seed") == base_seed
            and manifest.get("fingerprint") == fingerprint
        ):
            done = set(manifest["completed_batches"])
        else:
            import warnings

            warnings.warn(
                f"ignoring incompatible two-DLA checkpoints in {ckpt_dir} "
                "(run shape or numerics config changed)",
                stacklevel=2,
            )
    if ckpt_dir:
        ckpt_dir.mkdir(parents=True, exist_ok=True)

    for bi, start in enumerate(range(0, n, batch_size)):
        stop = min(start + batch_size, n)
        ckpt_file = ckpt_dir / f"batch_{bi:06d}.npz" if ckpt_dir else None
        if bi in done and ckpt_file and ckpt_file.exists():
            with np.load(ckpt_file) as f:
                out2[start:stop] = f["sample_log_likelihoods_dla2"]
            continue
        batch = spectra.slice(slice(start, stop)).pad_to(batch_size)
        pad_rows = batch_size - (stop - start)
        ob = base_slice(offsets, start, stop)
        nb = base_slice(nhis, start, stop)
        if pad_rows:
            ob = np.concatenate([ob, np.repeat(ob[-1:], pad_rows, axis=0)])
            nb = np.concatenate([nb, np.repeat(nb[-1:], pad_rows, axis=0)])
        fn_args = (
            jnp.asarray(batch.wavelengths, dtype),
            jnp.asarray(batch.flux, dtype),
            jnp.asarray(batch.noise_variance, dtype),
            jnp.asarray(batch.mask),
            jnp.asarray(batch.z_qso, dtype),
            *model_args,
            off_j, nh_j,
            jnp.asarray(ob, dtype), jnp.asarray(nb, dtype),
        )
        out2[start:stop] = np.asarray(evaluate(*fn_args))[: stop - start]
        if ckpt_file:
            # atomic + uncompressed, matching the sharded drivers: a
            # kill mid-write must leave old-or-new, never a torn npz/
            # manifest, and zlib on high-entropy lls buys ~nothing
            from .utils.atomic_io import atomic_savez, atomic_write_json

            atomic_savez(
                ckpt_file, compress=False,
                sample_log_likelihoods_dla2=out2[start:stop],
            )
            done.add(bi)
            atomic_write_json(
                manifest_path,
                {
                    "num_spectra": n,
                    "batch_size": batch_size,
                    "num_samples": S,
                    "base_seed": base_seed,
                    "fingerprint": fingerprint,
                    "completed_batches": sorted(done),
                },
            )

    return finalize_multi(
        single, out2, base, spectra.z_qso, prior_z_qsos, prior_num_dlas,
        params,
    )
