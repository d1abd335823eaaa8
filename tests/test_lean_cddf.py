"""Device-reduced CDDF inputs (cddf_inputs.py + LeanDLACatalogue):
lean-fed L7 statistics must match the classic full-matrix path.

In float64 on the XLA backend the device reduction performs the same
arithmetic as the classic host computation (same evidences, same base
draws — tests/test_lean_multi.py pins the bit-parity of the shared
chain), so the integer count statistics must match EXACTLY and the
continuous ones to libm precision (<= 1 ulp exp/log differences).
"""

import sys
from pathlib import Path

import numpy as np
import pytest

from gp_dla_detection.analysis.cddf import DLACatalogue
from gp_dla_detection.analysis.lean_catalogue import LeanDLACatalogue
from gp_dla_detection.cddf_inputs import CDDFInputs
from gp_dla_detection.parallel import ShardedRunConfig, make_mesh
from gp_dla_detection.parallel.sharded_multi import (
    process_spectra_multi_sharded,
)

from synthetic_problem import make_problem

sys.path.insert(
    0, str(Path(__file__).resolve().parent.parent / "validation")
)
from _universe import inject_dlas, injection_bounds  # noqa: E402


@pytest.fixture(scope="module")
def problem():
    """The shared synthetic problem with REAL absorbers injected: the
    CDDF statistics are vacuous unless some spectra clear the
    p_dla > 0.05 catalogue filter."""
    params, model, spectra, offsets, nhis, prior_z, _ = make_problem()
    rng = np.random.default_rng(42)
    inj = []
    for i in range(0, len(spectra), 2):  # absorbers in half the sky
        zmin, zmax = injection_bounds(
            spectra.wavelengths[i, 0], spectra.wavelengths[i, -1],
            spectra.z_qso[i], params,
        )
        if zmax <= zmin:
            continue
        inj.append(
            (i, rng.uniform(zmin, zmax), rng.uniform(20.6, 21.6))
        )
    inject_dlas(spectra.wavelengths, spectra.flux, inj, params, chunk=16)
    return params, model, spectra, offsets, nhis, prior_z, None


@pytest.fixture(scope="module")
def prior_num():
    rng = np.random.default_rng(7)
    return rng.choice([0, 0, 0, 0, 0, 1, 1, 2], 200)


def _run(problem, prior_num, lean, cddf=False, tmp=None, **overrides):
    params, model, spectra, offsets, nhis, prior_z, _ = problem
    cfg = dict(
        per_device_batch=1, sample_chunk=32, dtype="float64",
        store_sample_likelihoods=not lean,
        store_cddf_inputs=cddf,
        checkpoint_dir=str(tmp) if tmp else None,
    )
    cfg.update(overrides)
    return process_spectra_multi_sharded(
        model, offsets, nhis, spectra, prior_z, prior_num,
        params=params, mesh=make_mesh(),
        config=ShardedRunConfig(**cfg),
    )


@pytest.fixture(scope="module")
def classic(problem, prior_num):
    return _run(problem, prior_num, lean=False)


@pytest.fixture(scope="module")
def lean(problem, prior_num):
    return _run(problem, prior_num, lean=True, cddf=True)


@pytest.fixture(scope="module")
def catalogues(problem, prior_num, classic, lean):
    _, _, _, offsets, nhis, _, _ = problem
    lnhi = np.log10(nhis)
    single = classic.single
    cat = DLACatalogue(
        single.p_dlas,
        single.min_z_dlas,
        single.max_z_dlas,
        single.sample_log_likelihoods_dla,
        single.log_likelihoods_dla,
        offsets,
        lnhi,
        sample_log_likelihoods_2=classic.sample_log_likelihoods_dla2,
        base_sample_inds=classic.base_sample_inds,
        p_dla_2=classic.model_posteriors[:, 2],
    )
    lean_cat = LeanDLACatalogue.from_results(lean, offsets, lnhi)
    # a vacuous comparison (no spectrum above the 0.05 filter) would
    # pass trivially — require real posterior mass in the statistics
    assert cat.filter_dla_spectra().size >= 3
    return cat, lean_cat


def test_cddf_matches_classic(catalogues):
    cat, lean_cat = catalogues
    # z range (1, 6) and lnhi bins 0.1-wide from 20.0: the defaults
    a = cat.column_density_function(z_min=1.0, z_max=6.0)
    b = lean_cat.column_density_function(z_min=1.0, z_max=6.0)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y, x, rtol=1e-9, atol=0)


def test_line_density_matches_classic(catalogues):
    cat, lean_cat = catalogues
    a = cat.line_density(z_min=2.0, z_max=4.0)
    b = lean_cat.line_density(z_min=2.0, z_max=4.0)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y, x, rtol=1e-9, atol=0)


def test_omega_direct_matches_classic(catalogues):
    cat, lean_cat = catalogues
    a = cat.omega_dla(z_min=2.0, z_max=4.0)
    b = lean_cat.omega_dla(z_min=2.0, z_max=4.0)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y, x, rtol=1e-9, atol=0)


def test_omega_cddf_matches_classic(catalogues):
    cat, lean_cat = catalogues
    a = cat.omega_dla_cddf(z_min=2.0, z_max=4.0, lnhi_nbins=30)
    b = lean_cat.omega_dla_cddf(z_min=2.0, z_max=4.0, lnhi_nbins=30)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y, x, rtol=1e-9, atol=0)


def test_bootstrap_matches_classic(catalogues):
    """Resampling reads every per-spectrum array through the same view,
    so a bootstrap draw must agree draw-for-draw (same seeds)."""
    cat, lean_cat = catalogues
    cat.resample(True, seed=4)
    lean_cat.resample(True, seed=4)
    try:
        a = cat.line_density(z_min=2.0, z_max=4.0)
        b = lean_cat.line_density(z_min=2.0, z_max=4.0)
        for x, y in zip(a, b):
            np.testing.assert_allclose(y, x, rtol=1e-9, atol=0)
    finally:
        cat.resample(False)
        lean_cat.resample(False)


def test_unaligned_bins_raise(catalogues):
    _, lean_cat = catalogues
    with pytest.raises(ValueError, match="not aligned"):
        lean_cat.column_density_function(
            z_min=1.0, z_max=6.0, lnhi_min=20.05, lnhi_max=23.0,
            lnhi_nbins=10,
        )
    with pytest.raises(ValueError, match="not aligned"):
        lean_cat.line_density(z_min=2.05, z_max=4.0)


def test_continuous_cuts_raise(problem, prior_num, lean):
    _, _, _, offsets, nhis, _, _ = problem
    lean_cat = LeanDLACatalogue.from_results(
        lean, offsets, np.log10(nhis), lowzcut=True
    )
    with pytest.raises(NotImplementedError, match="lowzcut"):
        lean_cat.line_density(z_min=2.0, z_max=4.0)


def test_matrix_consumers_raise(catalogues):
    _, lean_cat = catalogues
    with pytest.raises(NotImplementedError, match="store_sample_likelihoods"):
        lean_cat.find_delta_nhi(0)


def test_find_max_like_matches_classic(catalogues):
    cat, lean_cat = catalogues
    for spec in cat.filter_dla_spectra()[:3]:
        a = cat.find_max_like(int(spec))
        b = lean_cat.find_max_like(int(spec))
        np.testing.assert_allclose(b, a, rtol=1e-12)


def test_save_load_and_from_run_dispatch(problem, prior_num, lean, tmp_path):
    """multi.save() round-trips the reductions; DLACatalogue.from_run
    auto-dispatches lean+cddf artifacts to LeanDLACatalogue."""
    _, _, _, offsets, nhis, _, _ = problem
    lean.save(tmp_path / "processed_qsos_multi_dr12q.npz")
    np.savez(
        tmp_path / "dla_samples.npz",
        offset_samples=offsets,
        log_nhi_samples=np.log10(nhis),
    )
    cat = DLACatalogue.from_run(tmp_path, multi=True)
    assert isinstance(cat, LeanDLACatalogue)
    direct = LeanDLACatalogue.from_results(lean, offsets, np.log10(nhis))
    a = cat.line_density(z_min=2.0, z_max=4.0)
    b = direct.line_density(z_min=2.0, z_max=4.0)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y, x, rtol=0, atol=0)


def test_checkpoint_resume_bit_identical(problem, prior_num, tmp_path):
    """A resumed cddf-reduction run must reproduce the reductions
    bit-for-bit from its checkpoints."""
    fresh = _run(problem, prior_num, lean=True, cddf=True, tmp=tmp_path)
    resumed = _run(problem, prior_num, lean=True, cddf=True, tmp=tmp_path)
    np.testing.assert_array_equal(
        resumed.cddf_inputs.hist, fresh.cddf_inputs.hist
    )
    np.testing.assert_array_equal(
        resumed.cddf_inputs.ex, fresh.cddf_inputs.ex
    )


def test_classic_rejects_cddf_flag(problem, prior_num):
    with pytest.raises(ValueError, match="lean-mode feature"):
        _run(problem, prior_num, lean=False, cddf=True)


def test_float32_reduction(problem, prior_num, catalogues):
    """The float32 chain (the production dtype) must reproduce the f64
    statistics at f32 tolerance; exact second-DLA entries must come back
    in original sample numbering."""
    cat, _ = catalogues
    fused = _run(problem, prior_num, lean=True, cddf=True, dtype="float32")
    _, _, _, offsets, nhis, _, _ = problem
    lean_cat = LeanDLACatalogue.from_results(fused, offsets, np.log10(nhis))
    S = len(offsets)
    ex2 = fused.cddf_inputs.ex2_idx
    assert ((ex2 >= 0) & (ex2 < S)).all()
    a = cat.line_density(z_min=2.0, z_max=4.0)
    b = lean_cat.line_density(z_min=2.0, z_max=4.0)
    # integer MAP counts at f32 kernel noise: allow one count of slack
    np.testing.assert_allclose(b[1], a[1], atol=1.01 / max(a[1].size, 1))
    am, _ = cat._get_z_nhi_hist(
        np.linspace(2.0, 4.0, 13), 2.0, 4.0, moment=True
    )
    bm, _ = lean_cat._get_z_nhi_hist(
        np.linspace(2.0, 4.0, 13), 2.0, 4.0, moment=True
    )
    np.testing.assert_allclose(bm, am, rtol=2e-3, atol=1e16)


def test_mass_accounting(lean, classic):
    """The all-sample mass channel + dump bin must integrate to ~1x the
    normalized weights scaled by p_dla (checked inside the catalogue
    too; here directly against the classic posteriors)."""
    from gp_dla_detection.cddf_inputs import CH_P

    inputs: CDDFInputs = lean.cddf_inputs
    mass = inputs.hist[:, CH_P].astype(np.float64).sum((1, 2))
    p_dla = classic.single.p_dlas
    keep = p_dla > 0.05
    assert keep.any()
    np.testing.assert_allclose(mass[keep], p_dla[keep], rtol=1e-6)


def test_pipeline_run_analysis_from_lean(problem, prior_num, lean, tmp_path):
    """One-command release path: the analysis stage computes the full
    L7 statistic set directly from a lean artifact with device-reduced
    CDDF inputs (auto-detected by DLACatalogue.from_run)."""
    from gp_dla_detection.pipeline import Pipeline, PipelineConfig

    _, _, _, offsets, nhis, _, _ = problem
    lean.save(tmp_path / "processed_qsos_multi_dr12q.npz")
    np.savez(
        tmp_path / "dla_samples.npz",
        offset_samples=offsets,
        log_nhi_samples=np.log10(nhis),
    )
    pipe = Pipeline(config=PipelineConfig(
        workdir=str(tmp_path), multi_dla=True,
        store_sample_likelihoods=False, cddf_inputs=True,
    ))
    stats = pipe.run_analysis(plots=False)
    assert stats["lean_inputs"] is True
    assert len(stats["cddf"]["f_N"]) == 30
    assert np.all(np.isfinite(stats["omega_dla_direct"]["omega"]))
    assert (tmp_path / "analysis" / "statistics.json").exists()
    assert pipe.run_analysis() == stats  # cached
