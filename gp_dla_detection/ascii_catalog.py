"""ASCII catalog output (L6: generate_ascii_catalog.m).

Writes the three text artifacts with the reference's exact column
formats (generate_ascii_catalog.m:9-83):

  <set>_dla_samples.dat  — the QMC prior samples
  <set>_spectra.dat      — per-quasar catalog row + 4 filter bits
  <set>_results.dat      — per-searched-quasar priors/likelihoods/
                           posteriors + MAP (z_DLA, log N_HI)

Reference-quirk note: generate_ascii_catalog.m:66 passes one argument
to the two-spec format '%09i %-18s ', so MATLAB stops mid-format and
the SDSS name never actually appears in <set>_results.dat.  We write
the (clearly intended) name; set ``reference_quirk_drop_name=True`` for
byte-compatible output with the reference.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

__all__ = ["write_ascii_catalog", "write_ascii_multi_results"]


def _three_digit_exponent(text: str) -> str:
    """'1.23456e+04' -> '1.23456e+004' (generate_ascii_catalog.m:64-68's
    regexprep; MATLAB on some platforms prints 3-digit exponents and the
    reference normalizes to that)."""
    return re.sub(r"e([+-])(\d\d)$", r"e\g<1>0\g<2>", text)


def write_ascii_catalog(
    output_dir: str | Path,
    test_set_name: str,
    catalog,
    samples,
    results,
    test_mask,
    reference_quirk_drop_name: bool = False,
) -> dict[str, Path]:
    """Write the three .dat files; returns their paths.

    Args:
      catalog: Catalog (all quasars).
      samples: DLASamples.
      results: InferenceResults for the quasars selected by test_mask.
      test_mask: boolean (N,) selection that produced `results`
        (the reference's test_ind).
    """
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    paths = {}

    # --- samples (generate_ascii_catalog.m:9-20)
    p = output_dir / f"{test_set_name}_dla_samples.dat"
    with open(p, "w") as fid:
        for off, lnhi in zip(samples.offset_samples, samples.log_nhi_samples):
            fid.write("%06f %09f\n" % (off, lnhi))
    paths["dla_samples"] = p

    # --- spectra (generate_ascii_catalog.m:22-46)
    p = output_dir / f"{test_set_name}_spectra.dat"
    with open(p, "w") as fid:
        for i in range(len(catalog)):
            name = catalog.sdss_names[i]
            if isinstance(name, bytes):
                name = name.decode()
            bits = [(int(catalog.filter_flags[i]) >> b) & 1 for b in range(4)]
            fid.write(
                "%09i %-18s %04i %05i %04i %011.7f %+011.7f %06.4f %08.4f "
                "%i%i%i%i\n"
                % (
                    catalog.thing_ids[i],
                    name.strip(),
                    catalog.plates[i],
                    catalog.mjds[i],
                    catalog.fiber_ids[i],
                    catalog.ras[i],
                    catalog.decs[i],
                    catalog.z_qsos[i],
                    catalog.snrs[i],
                    *bits,
                )
            )
    paths["spectra"] = p

    # --- results (generate_ascii_catalog.m:48-83)
    searched = np.flatnonzero(test_mask)
    p = output_dir / f"{test_set_name}_results.dat"
    with open(p, "w") as fid:
        for i, catalog_ind in enumerate(searched):
            name = catalog.sdss_names[catalog_ind]
            if isinstance(name, bytes):
                name = name.decode()
            if reference_quirk_drop_name:
                fid.write("%09i " % catalog.thing_ids[catalog_ind])
            else:
                fid.write(
                    "%09i %-18s " % (catalog.thing_ids[catalog_ind], name.strip())
                )
            fid.write(
                "%06.4f %06.4f %8.5f %8.5f %12.5e %12.5e %s %s "
                % (
                    results.min_z_dlas[i],
                    results.max_z_dlas[i],
                    results.log_priors_no_dla[i],
                    results.log_priors_dla[i],
                    results.log_likelihoods_no_dla[i],
                    results.log_likelihoods_dla[i],
                    _three_digit_exponent(
                        "%0.5e" % results.model_posteriors[i, 0]
                    ),
                    _three_digit_exponent(
                        "%0.5e" % results.model_posteriors[i, 1]
                    ),
                )
            )
            if results.sample_log_likelihoods_dla is None:
                # lean (catalog-only) run: the argmax was reduced on
                # device with the same NaN->-inf / all-NaN->0 semantics
                # (parallel/streaming.pack_lean)
                map_ind = int(results.map_sample_inds[i])
            else:
                sample_lls = results.sample_log_likelihoods_dla[i]
                # all-NaN rows (degenerate spectra) fall back to index
                # 0, like the reference's nanmax
                # (generate_ascii_catalog.m:74)
                finite = np.isfinite(sample_lls)
                map_ind = (
                    int(np.nanargmax(sample_lls)) if finite.any() else 0
                )
            map_z_dla = results.min_z_dlas[i] + (
                results.max_z_dlas[i] - results.min_z_dlas[i]
            ) * samples.offset_samples[map_ind]
            fid.write(
                "%06.4f %07.4f\n"
                % (map_z_dla, samples.log_nhi_samples[map_ind])
            )
    paths["results"] = p
    return paths


def write_ascii_multi_results(
    output_dir: str | Path,
    test_set_name: str,
    catalog,
    samples,
    multi,
    test_mask,
) -> Path:
    """Write ``<set>_multi_results.dat`` — the {0, 1, 2}-DLA extension
    of the reference's results contract (generate_ascii_catalog.m:48-83
    has no multi-DLA analogue; column set documented here).

    Columns: thing_id, sdss_name, P(no DLA), P(1 DLA), P(2 DLAs),
    MAP multiplicity, MAP pair (z_1, log N_HI 1, z_2, log N_HI 2; the
    single-DLA MAP repeated with NaN second component when no valid
    pair exists), and ``lyb_alias_suspect`` — the deterministic
    Lyβ/Lyγ re-fit signature flag (alias_flag.py).  Flagged calls stay
    in the catalog:
    the flag marks suspicion, not exclusion.
    """
    from .alias_flag import lyb_alias_suspect, map_pair_params

    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    searched = np.flatnonzero(test_mask)
    z1, l1, z2, l2 = map_pair_params(
        multi, samples.offset_samples, samples.log_nhi_samples
    )
    suspect = lyb_alias_suspect(
        multi, samples.offset_samples, samples.log_nhi_samples
    )
    mult = np.argmax(multi.model_posteriors, axis=1)
    p = output_dir / f"{test_set_name}_multi_results.dat"
    with open(p, "w") as fid:
        for i, catalog_ind in enumerate(searched):
            name = catalog.sdss_names[catalog_ind]
            if isinstance(name, bytes):
                name = name.decode()
            fid.write(
                "%09i %-18s %s %s %s %i "
                "%06.4f %07.4f %06.4f %07.4f %i\n"
                % (
                    catalog.thing_ids[catalog_ind],
                    name.strip(),
                    _three_digit_exponent(
                        "%0.5e" % multi.model_posteriors[i, 0]
                    ),
                    _three_digit_exponent(
                        "%0.5e" % multi.model_posteriors[i, 1]
                    ),
                    _three_digit_exponent(
                        "%0.5e" % multi.model_posteriors[i, 2]
                    ),
                    int(mult[i]),
                    z1[i], l1[i], z2[i], l2[i],
                    int(suspect[i]),
                )
            )
    return p
