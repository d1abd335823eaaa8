"""Stage orchestration: the end-to-end pipeline with stage-level resume.

The reference is driven manually — the README walks the user through
running each MATLAB script in order, each communicating through .mat
files (README.md:16-315).  This module is the equivalent runbook as
code: each stage checks for its artifact and is skipped when already
complete, giving the same stage-granularity checkpointing
(catalog -> preloaded -> model + samples -> processed -> ascii), with
intra-stage sharded checkpoints handled by parallel/sharded_inference.

CLI:  python -m gp_dla_detection.pipeline --workdir runs/dr12q \
        [--stage all|catalog|preload|learn|samples|process|ascii]
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .ascii_catalog import write_ascii_catalog
from .catalog import Catalog, build_catalog
from .inference import InferenceResults, correct_prior_dla_flags
from .models.qso_model import GPModel
from .models.training import learn_gp_model, prepare_training_data
from .params import Parameters
from .samples import DLASamples, generate_dla_samples
from .spectra import RaggedSpectra, preload_qsos

__all__ = ["Pipeline", "PipelineConfig"]


@dataclass
class PipelineConfig:
    workdir: str = "runs/default"
    release: str = "dr12q"
    training_set_name: str = "dr9q_minus_concordance"
    test_set_name: str = "dr12q"
    dla_catalog_name: str = "dr9q_concordance"
    per_device_batch: int = 64
    sample_chunk: int = 2500
    dtype: str = "float32"
    # also write .mat v7.3 copies of the stage artifacts so the
    # reference's own CDDF_analysis code can read them (io/matio.py)
    export_matlab: bool = False
    # additionally run {no DLA, 1, 2}-DLA model selection after the
    # single-DLA pass (multi_dla.py; later-pipeline output format)
    multi_dla: bool = False
    # persistent XLA compilation cache (utils/compile_cache.py): repeat
    # or resumed runs skip recompiling.  False = leave jax untouched
    compilation_cache: bool = True
    # False = lean catalog-only inference: per-spectrum evidence + MAP
    # are reduced on device and the (N, num_samples) matrix is never
    # fetched or stored (no .mat export, no multi-DLA stage, no CDDF —
    # see ShardedRunConfig.store_sample_likelihoods); the results npz
    # shrinks from ~6.5 GB to ~10 MB at DR12Q scale
    store_sample_likelihoods: bool = True
    # base-axis draw layout for the lean multi-DLA stage (see
    # ShardedRunConfig.base_replicates: R > 1 shares each posterior
    # base draw between R pair columns, fused lean driver only).  None
    # (default) = 1.  R is part of the checkpoint numerics fingerprint,
    # so a run resumes only with the R it started with.
    base_replicates: int | None = None
    # lean multi-DLA runs only: device-reduce the CDDF/dN_dX/Omega_DLA
    # inputs so the L7 statistics (analysis/cddf.py via
    # LeanDLACatalogue) run WITHOUT the (N, S) matrices — the complete
    # science deliverable from the lean production driver (see
    # cddf_inputs.py for the reduction and its quantization contract)
    cddf_inputs: bool = False

    def __post_init__(self):
        # fail at config time, not hours into the run
        if self.cddf_inputs and (
            self.store_sample_likelihoods or not self.multi_dla
        ):
            raise ValueError(
                "cddf_inputs=True requires the lean fused two-stage "
                "driver: set store_sample_likelihoods=False and "
                "multi_dla=True (classic full-matrix runs already carry "
                "what the CDDF statistics marginalize)"
            )
        if (
            self.base_replicates not in (None, 1)
            and self.store_sample_likelihoods
        ):
            raise ValueError(
                "base_replicates > 1 requires the lean fused multi-DLA "
                "driver (store_sample_likelihoods=False) — the classic "
                "pair stage resamples on the host"
            )
        if not self.store_sample_likelihoods and self.export_matlab:
            raise ValueError(
                "store_sample_likelihoods=False (lean catalog-only "
                "inference) cannot feed the .mat export — it needs the "
                "sample-likelihood matrix.  (The multi-DLA stage IS "
                "lean-compatible: run_multi switches to the fused "
                "two-stage driver.)"
            )


class Pipeline:
    """End-to-end driver.  All artifacts live under config.workdir."""

    def __init__(
        self,
        params: Parameters | None = None,
        config: PipelineConfig | None = None,
        file_loader=None,
        mesh=None,
    ):
        self.params = params or Parameters()
        self.config = config or PipelineConfig()
        self.file_loader = file_loader
        self.mesh = mesh
        self.workdir = Path(self.config.workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        if self.config.compilation_cache:
            from .utils import enable_compilation_cache

            enable_compilation_cache()

    # --- artifact paths (processed_directory layout, set_parameters.m:82-86)
    @property
    def catalog_path(self) -> Path:
        return self.workdir / "catalog.npz"

    @property
    def preloaded_path(self) -> Path:
        return self.workdir / "preloaded_qsos.npz"

    @property
    def model_path(self) -> Path:
        return self.workdir / f"learned_qso_model_{self.config.training_set_name}.npz"

    @property
    def samples_path(self) -> Path:
        return self.workdir / "dla_samples.npz"

    @property
    def results_path(self) -> Path:
        return self.workdir / f"processed_qsos_{self.config.test_set_name}.npz"

    @property
    def multi_results_path(self) -> Path:
        return (
            self.workdir
            / f"processed_qsos_multi_{self.config.test_set_name}.npz"
        )

    # --- stages ---

    def run_catalog(self, force: bool = False) -> Catalog:
        if self.catalog_path.exists() and not force:
            return Catalog.load(self.catalog_path)
        catalog = build_catalog(self.params)
        catalog.save(self.catalog_path)
        file_list = "\n".join(catalog.file_list()) + "\n"
        (self.workdir / "file_list").write_text(file_list)
        # rsync (download.download_spectra_command) reads it from the
        # release's spectra directory (download_spectra.sh:6-8)
        spectra_dir = self.params.spectra_directory(self.config.release)
        spectra_dir.mkdir(parents=True, exist_ok=True)
        (spectra_dir / "file_list").write_text(file_list)
        return catalog

    def run_preload(self, catalog: Catalog, force: bool = False) -> RaggedSpectra:
        if self.preloaded_path.exists() and not force:
            return RaggedSpectra.load(self.preloaded_path)
        spectra = preload_qsos(
            catalog, self.params, file_loader=self.file_loader,
            release=self.config.release,
        )
        spectra.save(self.preloaded_path)
        catalog.save(self.catalog_path)  # filter_flags amended in place
        return spectra

    def run_learn(
        self,
        catalog: Catalog,
        spectra: RaggedSpectra,
        train_mask=None,
        force: bool = False,
    ) -> GPModel:
        if self.model_path.exists() and not force:
            return GPModel.load(self.model_path)
        if force:
            # a forced retrain must not silently resume the previous
            # run's L-BFGS state (iterate + curvature history)
            (self.workdir / "training_ckpt.npz").unlink(missing_ok=True)
        if train_mask is None:
            train_mask = catalog.train_dr9_no_concordance_dlas()
        idx = np.flatnonzero(train_mask & (spectra.lengths() > 0))
        rows = [spectra.row(int(i)) for i in idx]
        data = prepare_training_data(
            [r[0] for r in rows],
            [r[1] for r in rows],
            [r[2] for r in rows],
            [r[3] for r in rows],
            catalog.z_qsos[idx],
            self.params,
        )
        model, result = learn_gp_model(
            data,
            self.params,
            mesh=self.mesh,
            checkpoint_path=self.workdir / "training_ckpt.npz",
        )
        model.save(self.model_path)
        return model

    def run_samples(self, catalog: Catalog, force: bool = False) -> DLASamples:
        if self.samples_path.exists() and not force:
            return DLASamples.load(self.samples_path)
        observed = catalog.dla_catalogs[
            self.config.dla_catalog_name
        ].all_log_nhis()
        samples = generate_dla_samples(observed, self.params)
        samples.save(self.samples_path)
        if self.config.export_matlab:
            from .io.matio import write_dla_samples_mat

            write_dla_samples_mat(samples, self.workdir / "dla_samples.mat")
        return samples

    def run_inference(
        self,
        catalog: Catalog,
        spectra: RaggedSpectra,
        model: GPModel,
        samples: DLASamples,
        test_mask=None,
        prior_mask=None,
        force: bool = False,
    ) -> InferenceResults:
        if test_mask is None:
            test_mask = self.default_test_mask(catalog, spectra)
        if prior_mask is None:
            prior_mask = catalog.prior_dr9_concordance()
        if self.results_path.exists() and not force:
            # a cached result is only valid for the SAME test selection:
            # returning it unconditionally would pair old result rows
            # with a new mask downstream (ascii/snrs/analysis)
            mask_path = self.workdir / "test_mask.npz"
            stale = False
            why = "test selection changed since the cached inference run"
            if mask_path.exists():
                with np.load(mask_path) as f:
                    stale = not np.array_equal(f["test_mask"], test_mask)
            if not stale:
                cached = InferenceResults.load(self.results_path)
                # a full artifact is a strict superset of a lean
                # request — serve it rather than destroying a
                # (potentially multi-GB, hours-of-compute) result to
                # recompute less.  Only the lean->full direction
                # genuinely lacks data and must recompute.
                if (
                    cached.sample_log_likelihoods_dla is not None
                    or not self.config.store_sample_likelihoods
                ):
                    return cached
                why = (
                    "cached inference artifact is lean (no sample "
                    "matrix) but this config requests the full form"
                )
            import warnings

            warnings.warn(
                f"{why}; recomputing (stale results + batch checkpoints "
                "dropped)",
                stacklevel=2,
            )
            force = True
        if force:
            # stale per-batch checkpoints must not survive a forced rerun
            import shutil

            shutil.rmtree(self.workdir / "inference_ckpt", ignore_errors=True)

        dc = catalog.dla_catalogs[self.config.dla_catalog_name]
        prior_idx = np.flatnonzero(prior_mask)
        prior_flags = correct_prior_dla_flags(
            catalog.z_qsos[prior_idx],
            dc.dla_ind[prior_idx],
            [dc.z_dlas[int(i)] for i in prior_idx],
        )

        test_idx = np.flatnonzero(test_mask)
        batch = spectra.to_padded(
            indices=test_idx,
            z_qsos=catalog.z_qsos[test_idx],
            pixel_pad=self.params.pixel_pad,
            pixel_spacing=self.params.instrument.pixel_spacing,
        )

        from .parallel import ShardedRunConfig, process_spectra_sharded

        results = process_spectra_sharded(
            model,
            samples.offset_samples,
            samples.nhi_samples,
            batch,
            catalog.z_qsos[prior_idx],
            prior_flags,
            params=self.params,
            mesh=self.mesh,
            config=ShardedRunConfig(
                per_device_batch=self.config.per_device_batch,
                sample_chunk=self.config.sample_chunk,
                dtype=self.config.dtype,
                checkpoint_dir=str(self.workdir / "inference_ckpt"),
                store_sample_likelihoods=(
                    self.config.store_sample_likelihoods
                ),
            ),
        )
        results.save(self.results_path)
        (self.workdir / "test_mask.npz").parent.mkdir(exist_ok=True)
        np.savez_compressed(self.workdir / "test_mask.npz", test_mask=test_mask)
        if self.config.export_matlab:
            from .io.matio import write_processed_mat

            write_processed_mat(
                results,
                test_mask,
                self.workdir
                / f"processed_qsos_{self.config.test_set_name}.mat",
            )
        return results

    def run_multi(
        self,
        catalog: Catalog,
        spectra: RaggedSpectra,
        model: GPModel,
        samples: DLASamples,
        results: InferenceResults,
        test_mask,
        prior_mask=None,
        force: bool = False,
    ):
        """{no DLA, 1, 2}-DLA model selection, reusing the single-DLA
        stage's evidences (multi_dla.process_spectra_multi)."""
        from .multi_dla import MultiDLAResults, prior_dla_multiplicity

        if self.multi_results_path.exists() and not force:
            return MultiDLAResults.load(self.multi_results_path)
        if force:
            import shutil

            shutil.rmtree(self.workdir / "multi_ckpt", ignore_errors=True)
        if prior_mask is None:
            prior_mask = catalog.prior_dr9_concordance()

        dc = catalog.dla_catalogs[self.config.dla_catalog_name]
        prior_idx = np.flatnonzero(prior_mask)
        prior_num = prior_dla_multiplicity(
            catalog.z_qsos[prior_idx],
            dc.dla_ind[prior_idx],
            [dc.z_dlas[int(i)] for i in prior_idx],
        )

        test_idx = np.flatnonzero(test_mask)
        batch = spectra.to_padded(
            indices=test_idx,
            z_qsos=catalog.z_qsos[test_idx],
            pixel_pad=self.params.pixel_pad,
            pixel_spacing=self.params.instrument.pixel_spacing,
        )
        from .parallel import ShardedRunConfig, process_spectra_multi_sharded

        multi = process_spectra_multi_sharded(
            model,
            samples.offset_samples,
            samples.nhi_samples,
            batch,
            catalog.z_qsos[prior_idx],
            prior_num,
            params=self.params,
            mesh=self.mesh,
            config=ShardedRunConfig(
                per_device_batch=self.config.per_device_batch,
                sample_chunk=self.config.sample_chunk,
                dtype=self.config.dtype,
                checkpoint_dir=str(self.workdir / "multi_ckpt"),
                store_sample_likelihoods=(
                    self.config.store_sample_likelihoods
                ),
                base_replicates=self.config.base_replicates,
                store_cddf_inputs=self.config.cddf_inputs,
            ),
            # lean mode runs the FUSED two-stage driver, which
            # recomputes the single stage on device per batch (the base
            # resampler needs the sample matrix a lean `results` never
            # stores); full mode reuses the stage artifact
            single=(
                results if self.config.store_sample_likelihoods else None
            ),
        )
        multi.save(self.multi_results_path)
        if self.config.export_matlab:
            from .io.matio import write_multi_processed_mat

            write_multi_processed_mat(
                multi,
                test_mask,
                self.workdir
                / f"processed_qsos_multi_{self.config.test_set_name}.mat",
                samples=samples,
            )
        return multi

    @staticmethod
    def default_test_mask(catalog: Catalog, spectra: RaggedSpectra) -> np.ndarray:
        """The default processing selection: unfiltered quasars with a
        loaded spectrum (the reference's standard test_ind)."""
        return catalog.unfiltered() & (spectra.lengths() > 0)

    def run_snrs(
        self, spectra: RaggedSpectra, results: InferenceResults, test_mask,
        force: bool = False,
    ) -> np.ndarray:
        """SNR per processed spectrum for the analysis layer's cuts
        (calc_cddf.py compute_all_snrs equivalent)."""
        path = self.workdir / "snrs.npz"
        idx = np.flatnonzero(test_mask)
        if path.exists() and not force:
            with np.load(path) as f:
                # only valid for the same test selection (the cache used
                # to be keyed on nothing and could silently misalign the
                # analysis layer's SNR cuts)
                if "test_idx" in f and np.array_equal(f["test_idx"], idx):
                    return f["snrs"]
        from .analysis.cddf import compute_all_snrs

        snrs = compute_all_snrs(
            spectra, idx, results.min_z_dlas, results.max_z_dlas
        )
        np.savez_compressed(path, snrs=snrs, test_idx=idx)
        if self.config.export_matlab:
            from .io.matio import write_snrs_mat

            write_snrs_mat(snrs, self.workdir / "snrs.mat")
        return snrs

    def run_ascii(self, catalog, samples, results, test_mask, multi=None) -> dict:
        paths = write_ascii_catalog(
            self.workdir,
            self.config.test_set_name,
            catalog,
            samples,
            results,
            test_mask,
        )
        if multi is not None:
            from .ascii_catalog import write_ascii_multi_results

            paths["multi_results"] = write_ascii_multi_results(
                self.workdir, self.config.test_set_name, catalog,
                samples, multi, test_mask,
            )
        return paths

    def run_analysis(self, force: bool = False, plots: bool = True) -> dict:
        """L7 science statistics stage (calc_cddf.py's deliverable):
        build the catalogue from the stage artifacts — auto-detecting
        lean device-reduced CDDF inputs (store_cddf_inputs=True) — and
        emit CDDF / dN_dX / Omega_DLA (both estimators) with their
        confidence intervals as ``analysis/statistics.json`` plus the
        reference figure/table set (analysis/plots.do_data_plots) under
        ``workdir/analysis/``."""
        from .analysis.cddf import DLACatalogue

        out_dir = self.workdir / "analysis"
        stats_path = out_dir / "statistics.json"
        if stats_path.exists() and not force:
            return json.loads(stats_path.read_text())
        out_dir.mkdir(parents=True, exist_ok=True)
        cat = DLACatalogue.from_run(
            self.workdir, self.config.test_set_name,
            multi=self.config.multi_dla,
        )
        z_lo, z_hi = 2.0, 5.0
        l_cent, cddf, c68, c95, _ = cat.column_density_function(
            z_min=1.0, z_max=6.0
        )
        zc_d, dndx, d68, d95, _ = cat.line_density(z_min=z_lo, z_max=z_hi)
        zc_o, om, om_err, _ = cat.omega_dla(z_min=z_lo, z_max=z_hi)
        zc_c, omc, o68, o95, _ = cat.omega_dla_cddf(z_min=z_lo, z_max=z_hi)
        tol = lambda a: np.asarray(a, np.float64).tolist()
        stats = {
            "lean_inputs": cat.__class__.__name__ != "DLACatalogue",
            "cddf": {"log_nhi": tol(l_cent), "f_N": tol(cddf),
                     "ci68": tol(c68), "ci95": tol(c95)},
            "line_density": {"z": tol(zc_d), "dN_dX": tol(dndx),
                             "ci68": tol(d68), "ci95": tol(d95)},
            "omega_dla_direct": {"z": tol(zc_o), "omega": tol(om),
                                 "err": tol(om_err)},
            "omega_dla_cddf": {"z": tol(zc_c), "omega": tol(omc),
                               "ci68": tol(o68), "ci95": tol(o95)},
        }
        stats_path.write_text(json.dumps(stats, indent=1))
        if plots:
            from .analysis.plots import do_2dla_plots, do_data_plots

            do_data_plots(cat, out_dir)
            if getattr(cat, "second_dla", False):
                do_2dla_plots(cat, out_dir)
        return stats

    def run_all(self) -> dict:
        catalog = self.run_catalog()
        spectra = self.run_preload(catalog)
        model = self.run_learn(catalog, spectra)
        samples = self.run_samples(catalog)
        test_mask = self.default_test_mask(catalog, spectra)
        results = self.run_inference(catalog, spectra, model, samples, test_mask)
        self.run_snrs(spectra, results, test_mask)
        multi = None
        if self.config.multi_dla:
            multi = self.run_multi(
                catalog, spectra, model, samples, results, test_mask
            )
        paths = self.run_ascii(catalog, samples, results, test_mask, multi)
        summary = {
            "num_quasars": int(len(catalog)),
            "num_processed": int(test_mask.sum()),
            "num_p_dla_gt_0.9": int((results.p_dlas > 0.9).sum()),
            "artifacts": {k: str(v) for k, v in paths.items()},
        }
        if multi is not None:
            from .alias_flag import lyb_alias_suspect

            summary["num_p_2dla_gt_0.9"] = int(
                (multi.model_posteriors[:, 2] > 0.9).sum()
            )
            summary["num_lyb_alias_suspect"] = int(
                (
                    (np.argmax(multi.model_posteriors, axis=1) == 2)
                    & lyb_alias_suspect(
                        multi, samples.offset_samples,
                        samples.log_nhi_samples,
                    )
                ).sum()
            )
            summary["artifacts"]["multi"] = str(self.multi_results_path)
        # the L7 statistics run whenever their inputs exist: classic
        # full-matrix runs always; lean runs with device-reduced CDDF
        # inputs (the one-command release path)
        if self.config.multi_dla and (
            self.config.store_sample_likelihoods or self.config.cddf_inputs
        ):
            self.run_analysis()
            summary["artifacts"]["analysis"] = str(
                self.workdir / "analysis" / "statistics.json"
            )
        (self.workdir / "summary.json").write_text(json.dumps(summary, indent=2))
        return summary


def main() -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workdir", default="runs/default")
    p.add_argument("--base-directory", default="data")
    p.add_argument(
        "--stage",
        default="all",
        choices=[
            "all", "catalog", "preload", "learn", "samples", "process",
            "multi", "ascii", "analysis",
        ],
    )
    p.add_argument(
        "--multi-dla", action="store_true",
        help="also run {0,1,2}-DLA model selection in --stage all",
    )
    p.add_argument(
        "--per-device-batch", type=int, default=64,
        help="spectra per device per super-batch",
    )
    p.add_argument(
        "--dtype", default="float32", choices=["float32", "float64"],
        help="compute dtype (float64 = XLA parity mode)",
    )
    p.add_argument(
        "--lean", action="store_true",
        help="catalog-only inference: device-reduced evidence + MAP, no "
        "(N, num_samples) matrices stored (no .mat export / CDDF); the "
        "multi stage runs the fused one-pass two-stage driver",
    )
    p.add_argument(
        "--base-replicates", type=int, default=None,
        help="--lean multi stage: share each posterior base draw between "
        "R pair columns (default 1; resume with the R a run started with)",
    )
    p.add_argument(
        "--cddf-inputs", action="store_true",
        help="--lean --multi-dla only: device-reduce the CDDF/dN_dX/"
        "Omega_DLA inputs so the science statistics run from the lean "
        "result (analysis layer auto-detects them)",
    )
    p.add_argument(
        "--export-matlab", action="store_true",
        help="also write .mat v7.3 stage artifacts for the reference's "
        "CDDF_analysis code",
    )
    args = p.parse_args()

    params = Parameters(base_directory=args.base_directory)
    pipe = Pipeline(
        params,
        PipelineConfig(
            workdir=args.workdir, multi_dla=args.multi_dla,
            per_device_batch=args.per_device_batch,
            dtype=args.dtype,
            store_sample_likelihoods=not args.lean,
            base_replicates=args.base_replicates,
            cddf_inputs=args.cddf_inputs,
            export_matlab=args.export_matlab,
        ),
    )
    if args.stage == "all":
        print(json.dumps(pipe.run_all(), indent=2))
        return
    catalog = pipe.run_catalog()
    if args.stage == "catalog":
        return
    spectra = pipe.run_preload(catalog)
    if args.stage == "preload":
        return
    if args.stage in ("learn",):
        pipe.run_learn(catalog, spectra)
        return
    if args.stage == "samples":
        pipe.run_samples(catalog)
        return
    model = pipe.run_learn(catalog, spectra)
    samples = pipe.run_samples(catalog)
    test_mask = pipe.default_test_mask(catalog, spectra)
    results = pipe.run_inference(catalog, spectra, model, samples, test_mask)
    if args.stage == "multi":
        pipe.run_multi(catalog, spectra, model, samples, results, test_mask)
    if args.stage == "ascii":
        pipe.run_ascii(catalog, samples, results, test_mask)
    if args.stage == "analysis":
        print(json.dumps(pipe.run_analysis(), indent=1)[:2000])


if __name__ == "__main__":
    main()
