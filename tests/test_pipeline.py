"""Full pipeline end-to-end on the synthetic release: FITS on disk ->
catalog -> preload -> train -> samples -> inference -> ASCII catalog,
with stage-level resume."""

import dataclasses
import json

import numpy as np


def test_enable_compilation_cache_checkout_dir(monkeypatch):
    """Without JAX_COMPILATION_CACHE_DIR the cache lives in the fixed
    <checkout>/.jax_cache; repeat calls are idempotent."""
    from pathlib import Path

    import jax

    from gp_dla_detection.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        d1 = compile_cache.enable_compilation_cache()
        d2 = compile_cache.enable_compilation_cache()
        checkout = Path(__file__).resolve().parent.parent
        assert d1 == d2 == str(checkout / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == d1
        assert Path(d1).is_dir()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_enable_compilation_cache_env_dir(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, that directory is the cache
    and nothing else is configured."""
    import jax

    from gp_dla_detection.utils import compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    before = jax.config.jax_compilation_cache_dir
    updates = []
    monkeypatch.setattr(
        jax.config, "update", lambda *a: updates.append(a)
    )
    assert compile_cache.enable_compilation_cache() == str(tmp_path / "env")
    assert updates == []
    assert jax.config.jax_compilation_cache_dir == before

from gp_dla_detection.params import (
    DLASamplingParams,
    NullModelParams,
    OptimizationParams,
)
from gp_dla_detection.pipeline import Pipeline, PipelineConfig


def small_params(base):
    return dataclasses.replace(
        base,
        null_model=NullModelParams(k=3),
        optimization=OptimizationParams(max_iterations=15, max_fun_evals=30),
        dla_sampling=DLASamplingParams(num_dla_samples=100),
    )


def test_pipeline_run_all(synthetic_release, tmp_path):
    params = small_params(synthetic_release)
    config = PipelineConfig(
        workdir=str(tmp_path / "run"),
        per_device_batch=1,
        sample_chunk=50,
        dtype="float64",
        multi_dla=True,
    )
    pipe = Pipeline(params, config)
    summary = pipe.run_all()

    assert summary["num_quasars"] == 12
    assert summary["num_processed"] == 8
    assert "num_p_2dla_gt_0.9" in summary

    # multi-DLA stage artifact: 3-column posteriors over the 8 processed
    # spectra, rows normalized wherever the counting prior is defined
    assert pipe.multi_results_path.exists()
    with np.load(pipe.multi_results_path) as f:
        mp = f["multi_model_posteriors"]
    assert mp.shape == (8, 3)
    ok = np.isfinite(mp).all(axis=1)
    assert ok.any()  # an all-NaN posterior must not pass vacuously
    np.testing.assert_allclose(mp[ok].sum(axis=1), 1.0, rtol=1e-12)

    # the analysis layer loads the multi artifact directly
    from gp_dla_detection.analysis import DLACatalogue

    cat = DLACatalogue.from_run(pipe.workdir, multi=True)
    assert cat.second_dla
    assert cat.p_dla_2.shape == (8,)

    # stage artifacts all exist
    for p in (
        pipe.catalog_path,
        pipe.preloaded_path,
        pipe.model_path,
        pipe.samples_path,
        pipe.results_path,
    ):
        assert p.exists(), p
    assert (pipe.workdir / "file_list").read_text().count("\n") == 11

    # ascii outputs parse back
    results_dat = (pipe.workdir / "dr12q_results.dat").read_text().strip().split("\n")
    assert len(results_dat) == 8
    first = results_dat[0].split()
    assert first[0] == "000000101"  # %09i thing_id
    assert len(first) == 12  # id, name, 8 numbers, map_z, map_nhi

    spectra_dat = (pipe.workdir / "dr12q_spectra.dat").read_text().strip().split("\n")
    assert len(spectra_dat) == 12
    assert spectra_dat[2].endswith("1000")  # z-cut bit for quasar index 2
    assert spectra_dat[3].endswith("0100")  # BAL bit
    assert spectra_dat[6].endswith("0010")  # normalization bit
    assert spectra_dat[7].endswith("0001")  # min-pixels bit

    samples_dat = (pipe.workdir / "dr12q_dla_samples.dat").read_text().strip().split("\n")
    assert len(samples_dat) == 100

    # posteriors are proper probabilities wherever the counting prior is
    # defined (test quasars whose z precedes every prior quasar get
    # log(0)-log(0) = NaN priors, exactly as the reference's MATLAB does)
    with np.load(pipe.results_path) as f:
        p_dlas = f["p_dlas"]
        lp = f["log_priors_dla"]
    defined = np.isfinite(lp)
    assert defined.sum() >= 5
    assert np.all((p_dlas[defined] >= 0) & (p_dlas[defined] <= 1))

    # resume: second run loads artifacts without recomputation (mtime check)
    mtimes = {
        p: p.stat().st_mtime_ns
        for p in (pipe.model_path, pipe.results_path, pipe.multi_results_path)
    }
    summary2 = Pipeline(params, config).run_all()
    assert summary2["num_processed"] == 8
    for p, t in mtimes.items():
        assert p.stat().st_mtime_ns == t, f"{p} recomputed on resume"


def test_pipeline_lean_multi_run_all(synthetic_release, tmp_path):
    """Lean (catalog-only) pipeline WITH the multi-DLA stage: run_multi
    switches to the fused two-stage driver; the multiplicity catalog
    must match the full-matrix pipeline's, with matrix-free artifacts."""
    params = small_params(synthetic_release)
    base = dict(per_device_batch=1, sample_chunk=50, dtype="float64",
                multi_dla=True)
    full = Pipeline(
        params, PipelineConfig(workdir=str(tmp_path / "full"), **base)
    )
    s_full = full.run_all()
    lean = Pipeline(
        params,
        PipelineConfig(
            workdir=str(tmp_path / "lean"),
            store_sample_likelihoods=False,
            **base,
        ),
    )
    s_lean = lean.run_all()

    assert s_lean["num_processed"] == s_full["num_processed"]
    assert s_lean["num_p_2dla_gt_0.9"] == s_full["num_p_2dla_gt_0.9"]
    with np.load(lean.multi_results_path) as f:
        assert "sample_log_likelihoods_dla2" not in f.files
        mp_lean = f["multi_model_posteriors"]
        assert "map_base_sample_inds" in f.files
    with np.load(full.multi_results_path) as f:
        mp_full = f["multi_model_posteriors"]
    # same f64 values up to reduction association (the base draws are
    # bit-matched at f64; see tests/test_lean_multi.py)
    np.testing.assert_allclose(mp_lean, mp_full, rtol=1e-9, atol=1e-12)

    # the ascii catalog writes from lean multi results too
    results_dat = (
        (lean.workdir / "dr12q_results.dat").read_text().strip().split("\n")
    )
    assert len(results_dat) == s_lean["num_processed"]


def test_pipeline_stale_caches_invalidate(synthetic_release, tmp_path):
    """Regression (code review): cached inference results / SNRs were
    returned for ANY mask, and a forced retrain silently resumed the old
    optimizer state."""
    import pytest

    params = small_params(synthetic_release)
    config = PipelineConfig(
        workdir=str(tmp_path / "run"), per_device_batch=1,
        sample_chunk=50, dtype="float64",
    )
    pipe = Pipeline(params, config)
    catalog = pipe.run_catalog()
    spectra = pipe.run_preload(catalog)
    model = pipe.run_learn(catalog, spectra)
    samples = pipe.run_samples(catalog)
    mask = pipe.default_test_mask(catalog, spectra)
    res = pipe.run_inference(catalog, spectra, model, samples, mask)
    snrs = pipe.run_snrs(spectra, res, mask)

    # identical mask: cache hit (no warning, same rows)
    again = pipe.run_inference(catalog, spectra, model, samples, mask)
    np.testing.assert_array_equal(again.p_dlas, res.p_dlas)

    # changed mask: must warn and recompute with matching row count
    mask2 = mask.copy()
    mask2[np.flatnonzero(mask)[0]] = False
    with pytest.warns(UserWarning, match="test selection changed"):
        res2 = pipe.run_inference(catalog, spectra, model, samples, mask2)
    assert len(res2.p_dlas) == mask2.sum()
    snrs2 = pipe.run_snrs(spectra, res2, mask2)
    assert len(snrs2) == mask2.sum() != len(snrs)

    # forced retrain must not resume a stale optimizer checkpoint: plant
    # one that would crash np.load if consulted — force must delete it
    ckpt = pipe.workdir / "training_ckpt.npz"
    ckpt.write_bytes(b"stale garbage, not an npz")
    model2 = pipe.run_learn(catalog, spectra, force=True)
    assert model2 is not None
    # the short fixture run converges before checkpoint_every, so the
    # stale file's absence proves the unlink (nothing rewrote it)
    assert not ckpt.exists()


def test_pipeline_matlab_export(synthetic_release, tmp_path):
    import h5py

    params = small_params(synthetic_release)
    config = PipelineConfig(
        workdir=str(tmp_path / "run"),
        per_device_batch=1,
        sample_chunk=50,
        dtype="float64",
        export_matlab=True,
    )
    Pipeline(params, config).run_all()
    wd = tmp_path / "run"
    for name in ("processed_qsos_dr12q.mat", "dla_samples.mat", "snrs.mat"):
        assert (wd / name).exists(), name
        assert open(wd / name, "rb").read(20).startswith(b"MATLAB 7.3 MAT-file")
    # reference access pattern works end to end
    with h5py.File(wd / "processed_qsos_dr12q.mat", "r") as f:
        assert f["p_dlas"][0].shape == (8,)
        assert f["sample_log_likelihoods_dla"].shape == (100, 8)
    # and our own matlab importer round-trips into the analysis layer
    from gp_dla_detection.io.matio import load_catalogue_from_matlab

    cat = load_catalogue_from_matlab(
        wd / "processed_qsos_dr12q.mat", wd / "dla_samples.mat",
        wd / "snrs.mat",
    )
    assert cat.p_dla.shape == (8,)


def test_cli_has_no_backend_choice(capsys):
    """The evidence path has one implementation per precision: the CLI
    offers no backend switch (and so no interpret mode)."""
    import sys

    import pytest

    from gp_dla_detection import pipeline

    argv = sys.argv
    sys.argv = ["pipeline", "--backend", "xla"]
    try:
        with pytest.raises(SystemExit) as exc:
            pipeline.main()
    finally:
        sys.argv = argv
    assert exc.value.code == 2
    assert "--backend" in capsys.readouterr().err
    assert not hasattr(PipelineConfig(), "backend")


def test_pipeline_compilation_cache_opt_out(tmp_path, monkeypatch):
    """compilation_cache=False leaves JAX's cache configuration alone."""
    import jax

    from gp_dla_detection.utils import compile_cache

    calls = []
    monkeypatch.setattr(
        compile_cache, "enable_compilation_cache", lambda: calls.append(1)
    )
    import gp_dla_detection.utils as utils

    monkeypatch.setattr(utils, "enable_compilation_cache",
                        compile_cache.enable_compilation_cache)
    Pipeline(config=PipelineConfig(workdir=str(tmp_path / "a"),
                                   compilation_cache=False))
    assert calls == []
    Pipeline(config=PipelineConfig(workdir=str(tmp_path / "b")))
    assert calls == [1]
