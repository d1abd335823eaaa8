"""MATLAB v7.3 (.mat = HDF5) interoperability.

The reference's stage ABI is .mat v7.3 files (SURVEY.md section 1), and
its Python analysis layer reads them with h5py using MATLAB's
column-major dataset orientation (calc_cddf.py:59-124: ``p_dlas[0]``,
``sample_log_likelihoods_dla[:, spec]``, ``offset_samples[:, 0]`` ...).

This module provides both directions of interop:

  - exporters that write our inference/sampler outputs in exactly that
    layout (including the 512-byte MATLAB userblock, so MATLAB itself
    can ``load`` them) — the reference's own CDDF_analysis code can
    consume results produced by this framework;
  - importers that read reference-produced processed_qsos / dla_samples
    / snrs .mat files into this framework's analysis layer
    (:func:`load_catalogue_from_matlab`).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

__all__ = [
    "write_mat",
    "read_mat",
    "write_processed_mat",
    "write_multi_processed_mat",
    "write_dla_samples_mat",
    "write_snrs_mat",
    "load_catalogue_from_matlab",
]

_USERBLOCK = 512


def _matlab_header() -> bytes:
    text = (
        "MATLAB 7.3 MAT-file, Platform: GLNXA64, "
        "Created by: gp_dla_detection"
    ).encode()
    header = text[:116].ljust(116, b" ")
    header += b"\x00" * 8        # subsystem data offset
    header += (0x0200).to_bytes(2, "little")   # version
    header += b"IM"              # endianness indicator
    return header.ljust(_USERBLOCK, b"\x00")


def write_mat(path: str | Path, arrays: dict) -> None:
    """Write arrays as a MATLAB-v7.3-compatible HDF5 file.

    Values are written transposed (MATLAB is column-major, h5py row
    major), matching how the reference's Python layer indexes them.
    """
    import h5py

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(path, "w", userblock_size=_USERBLOCK) as f:
        for name, value in arrays.items():
            value = np.asarray(value)
            is_bool = value.dtype == bool
            if is_bool:
                value = value.astype(np.uint8)  # MATLAB logicals are uint8
            if value.ndim == 0:
                value = value.reshape(1, 1)
            elif value.ndim == 1:
                value = value.reshape(1, -1)  # MATLAB row vector
            ds = f.create_dataset(name, data=value.T)
            ds.attrs["MATLAB_class"] = np.bytes_(
                "logical" if is_bool else "double"
            )
    with open(path, "r+b") as f:
        f.write(_matlab_header())


def read_mat(path: str | Path, keys=None) -> dict:
    """Read a v7.3 .mat (or plain HDF5) file; arrays in MATLAB
    orientation exactly as h5py exposes them (the reference's view).

    ``keys``: iterable of dataset names to materialize (missing names
    are skipped).  Default (None) loads every dataset — fine for the
    framework's own compact exports, but a reference-scale processed
    file carries multi-GB fields the analysis never touches
    (log_posteriors etc.), so the catalogue loader below passes the
    exact field list instead.
    """
    import h5py

    out = {}
    wanted = None if keys is None else set(keys)
    with h5py.File(Path(path), "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset) and (
                wanted is None or name in wanted
            ):
                out[name] = np.asarray(obj)
        f.visititems(visit)
    return out


def write_processed_mat(results, test_ind, path: str | Path) -> None:
    """Export InferenceResults as processed_qsos_*.mat
    (process_qsos.m:235-249 fields, in the orientation
    calc_cddf.py:59-99 reads: per-spectrum axis last)."""
    if results.sample_log_likelihoods_dla is None:
        raise ValueError(
            "the processed-qsos .mat format carries the full "
            "sample_log_likelihoods_dla matrix (process_qsos.m:240), "
            "which a lean (catalog-only) run never stores — rerun with "
            "store_sample_likelihoods=True to export for the reference "
            "analysis code"
        )
    S = results.sample_log_likelihoods_dla.shape[1]
    col = lambda a: np.asarray(a).reshape(-1, 1)  # MATLAB column vector:
    # process_qsos.m:74-86 allocates per-quasar results as (N, 1), which
    # h5py then exposes as (1, N) — the reference reads field[0]
    write_mat(
        path,
        {
            "min_z_dlas": col(results.min_z_dlas),
            "max_z_dlas": col(results.max_z_dlas),
            "log_priors_no_dla": col(results.log_priors_no_dla),
            "log_priors_dla": col(results.log_priors_dla),
            "log_likelihoods_no_dla": col(results.log_likelihoods_no_dla),
            "log_likelihoods_dla": col(results.log_likelihoods_dla),
            # stored (N, S); write_mat transposes -> h5py sees (S, N),
            # i.e. sample_log_likelihoods_dla[:, spec] per the reference
            "sample_log_likelihoods_dla": results.sample_log_likelihoods_dla,
            "log_posteriors_no_dla": col(results.log_posteriors_no_dla),
            "log_posteriors_dla": col(results.log_posteriors_dla),
            "model_posteriors": results.model_posteriors,
            "p_no_dlas": col(results.p_no_dlas),
            "p_dlas": col(results.p_dlas),
            "test_ind": col(np.asarray(test_ind, np.float64)),
            "num_dla_samples": np.float64(S),
        },
    )


def write_multi_processed_mat(
    results, test_ind, path: str | Path, samples=None
) -> None:
    """Export MultiDLAResults in the later-pipeline multi-DLA .mat
    format the reference's analysis reads (calc_cddf.py:85-116):
    sample_log_likelihoods_dla as (num_models, S, N) in the h5py view,
    1-based base_sample_inds, 3-row model_posteriors.

    ``samples`` (DLASamples, optional): when given, the export also
    carries ``lyb_alias_suspect`` — the Lyβ/Lyγ re-fit signature flag
    (alias_flag.py), a contract EXTENSION the reference's reader
    ignores (h5py access is by name)."""
    single = results.single
    if (
        single.sample_log_likelihoods_dla is None
        or results.sample_log_likelihoods_dla2 is None
    ):
        raise ValueError(
            "the multi-DLA .mat format carries the full per-sample "
            "matrices (calc_cddf.py:85-116), which a lean (catalog-only) "
            "fused two-stage run never stores — rerun with "
            "store_sample_likelihoods=True to export for the reference "
            "analysis code"
        )
    S = single.sample_log_likelihoods_dla.shape[1]
    col = lambda a: np.asarray(a).reshape(-1, 1)
    # h5py view must be (num_models, S, N); write_mat transposes the
    # stored (N, S, num_models)
    sll_stack = np.stack(
        [single.sample_log_likelihoods_dla, results.sample_log_likelihoods_dla2],
        axis=-1,
    )
    extra = {}
    if samples is not None:
        from ..alias_flag import lyb_alias_suspect

        extra["lyb_alias_suspect"] = col(
            lyb_alias_suspect(
                results, samples.offset_samples, samples.log_nhi_samples
            ).astype(np.float64)
        )
    write_mat(
        path,
        {
            **extra,
            "min_z_dlas": col(single.min_z_dlas),
            "max_z_dlas": col(single.max_z_dlas),
            "log_likelihoods_dla": col(single.log_likelihoods_dla),
            "sample_log_likelihoods_dla": sll_stack,
            "base_sample_inds": results.base_sample_inds + 1,  # 1-based
            "model_posteriors": results.model_posteriors,
            "p_dlas": col(single.p_dlas),
            "p_no_dlas": col(single.p_no_dlas),
            "test_ind": col(np.asarray(test_ind, np.float64)),
            "num_dla_samples": np.float64(S),
        },
    )


def write_dla_samples_mat(samples, path: str | Path) -> None:
    """Export DLASamples as dla_samples.mat (generate_dla_samples.m:56-63).

    The reference reads offset_samples[:, 0] (calc_cddf.py:119-123), so
    the sample axis must be first in the h5py view — these are MATLAB
    row vectors, which write_mat's transpose produces.
    """
    cfg = samples.config
    write_mat(
        path,
        {
            "offset_samples": samples.offset_samples,
            "log_nhi_samples": samples.log_nhi_samples,
            "nhi_samples": samples.nhi_samples,
            "uniform_min_log_nhi": np.float64(cfg.uniform_min_log_nhi),
            "uniform_max_log_nhi": np.float64(cfg.uniform_max_log_nhi),
            "fit_min_log_nhi": np.float64(cfg.fit_min_log_nhi),
            "fit_max_log_nhi": np.float64(cfg.fit_max_log_nhi),
            "alpha": np.float64(cfg.alpha),
        },
    )


def write_snrs_mat(snrs, path: str | Path) -> None:
    """Export the SNR table (calc_cddf.py compute_all_snrs format).

    Unlike the MATLAB-written stage files, the reference writes this one
    from Python as a plain 1-D h5py dataset (calc_cddf.py:966) — keep
    that exact shape so its broadcasting works.
    """
    import h5py

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(path, "w", userblock_size=_USERBLOCK) as f:
        f["snrs"] = np.asarray(snrs, np.float64)
    with open(path, "r+b") as f:
        f.write(_matlab_header())


def load_catalogue_from_matlab(
    processed_file: str | Path,
    sample_file: str | Path,
    snrs_file: str | Path | None = None,
    **kwargs,
):
    """Build a DLACatalogue from reference-produced .mat v7.3 files.

    Mirrors the reference's own h5py access pattern
    (calc_cddf.py:59-124), including the 3-D multi-DLA
    sample_log_likelihoods_dla format with base_sample_inds (the 1-based
    indices become 0-based, calc_cddf.py:225-227).
    """
    from ..analysis.cddf import DLACatalogue

    proc = read_mat(
        processed_file,
        keys=(
            "sample_log_likelihoods_dla", "base_sample_inds",
            "model_posteriors", "p_dlas", "min_z_dlas", "max_z_dlas",
            "log_likelihoods_dla",
        ),
    )
    samp = read_mat(sample_file, keys=("offset_samples", "log_nhi_samples"))

    sll = np.asarray(proc["sample_log_likelihoods_dla"])
    extra = {}
    if sll.ndim == 3:  # multi-DLA format: (num_models, S, N)
        sll2 = sll[1].T
        sll = sll[0]
        extra["sample_log_likelihoods_2"] = sll2
        extra["base_sample_inds"] = (
            np.asarray(proc["base_sample_inds"]).T.astype(np.int64) - 1
        )
        mp = np.asarray(proc["model_posteriors"])
        extra["p_dla_2"] = mp[2] if mp.shape[0] >= 3 else mp[-1]
    sll = sll.T  # -> (N, S)

    snrs = None
    if snrs_file is not None and Path(snrs_file).exists():
        snrs = np.asarray(read_mat(snrs_file)["snrs"]).ravel()

    return DLACatalogue(
        np.asarray(proc["p_dlas"]).ravel(),
        np.asarray(proc["min_z_dlas"]).ravel(),
        np.asarray(proc["max_z_dlas"]).ravel(),
        sll,
        np.asarray(proc["log_likelihoods_dla"]).ravel(),
        np.asarray(samp["offset_samples"]).ravel(),
        np.asarray(samp["log_nhi_samples"]).ravel(),
        snrs=snrs,
        **{**extra, **kwargs},
    )
