"""Lean (catalog-only) result streaming: the sharded driver reduces the
(B, S) sample-likelihood matrices to per-spectrum evidence + MAP index
ON DEVICE (parallel/streaming.pack_lean) and never fetches or stores
the matrix.  Everything a DLA catalog needs must survive exactly;
posterior-sample consumers must fail loudly."""

import dataclasses
import warnings

import numpy as np
import pytest

from gp_dla_detection.inference import InferenceResults, process_spectra
from gp_dla_detection.parallel import (
    ShardedRunConfig,
    make_mesh,
    process_spectra_sharded,
)

from synthetic_problem import make_problem


@pytest.fixture(scope="module")
def problem():
    return make_problem()


def _run(problem, tmp=None, mesh=None, **overrides):
    params, model, spectra, offsets, nhis, prior_z, prior_f = problem
    cfg = dict(
        per_device_batch=1, sample_chunk=32, dtype="float64",
        checkpoint_dir=str(tmp) if tmp else None,
    )
    cfg.update(overrides)
    return process_spectra_sharded(
        model, offsets, nhis, spectra, prior_z, prior_f,
        params=params, mesh=mesh or make_mesh(),
        config=ShardedRunConfig(**cfg),
    )


def test_lean_matches_full(problem):
    full = _run(problem, stream_dtype=None)
    lean = _run(problem, store_sample_likelihoods=False)

    assert lean.sample_log_likelihoods_dla is None
    assert full.map_sample_inds is None
    assert lean.map_sample_inds is not None

    # evidence: device logsumexp-mean vs host numpy on the same f64
    # values — identical up to summation-order roundoff
    np.testing.assert_allclose(
        lean.log_likelihoods_dla, full.log_likelihoods_dla, rtol=1e-12
    )
    np.testing.assert_allclose(lean.p_dlas, full.p_dlas, rtol=1e-12)
    np.testing.assert_array_equal(
        lean.log_likelihoods_no_dla, full.log_likelihoods_no_dla
    )
    np.testing.assert_array_equal(lean.min_z_dlas, full.min_z_dlas)

    # MAP index == the catalog writer's argmax over the full matrix
    expect = np.argmax(full.sample_log_likelihoods_dla, axis=1)
    np.testing.assert_array_equal(lean.map_sample_inds, expect)


def test_pack_lean_nan_semantics():
    """NaN rows: evidence propagates NaN like the host np.max/np.mean
    path; the MAP index treats NaN as -inf and flags no-finite rows as
    -1 (the driver resolves that to ORIGINAL index 0 after any sample-
    sort translation — ascii_catalog semantics)."""
    import jax.numpy as jnp

    from gp_dla_detection.parallel.streaming import pack_lean

    rows = np.array(
        [
            [1.0, 3.0, 2.0],
            [np.nan, -1.0, -2.0],   # partial NaN: argmax skips it
            [np.nan, np.nan, np.nan],  # all NaN: no finite entry
            [-np.inf, -np.inf, -np.inf],  # all -inf: no finite entry
        ]
    )
    evidence, map_f32 = pack_lean(jnp.asarray(rows))
    evidence, map_idx = np.asarray(evidence), np.asarray(map_f32).astype(int)

    max0 = 3.0
    np.testing.assert_allclose(
        evidence[0], max0 + np.log(np.mean(np.exp(rows[0] - max0)))
    )
    assert np.isnan(evidence[1]) and np.isnan(evidence[2])  # like np.max
    assert map_idx.tolist() == [1, 1, -1, -1]


def test_lean_checkpoint_resume(problem, tmp_path):
    lean = _run(problem, tmp=tmp_path, store_sample_likelihoods=False)
    resumed = _run(problem, tmp=tmp_path, store_sample_likelihoods=False)
    np.testing.assert_array_equal(
        resumed.log_likelihoods_dla, lean.log_likelihoods_dla
    )
    np.testing.assert_array_equal(
        resumed.map_sample_inds, lean.map_sample_inds
    )
    np.testing.assert_array_equal(resumed.p_dlas, lean.p_dlas)

    # lean checkpoints really are matrix-free
    ckpts = sorted(tmp_path.glob("batch_*.npz"))
    assert ckpts
    with np.load(ckpts[0]) as f:
        assert "log_likelihood_dla" in f and "map_sample_ind" in f
        assert "sample_ll_resid" not in f
        assert "sample_log_likelihoods_dla" not in f

    # a full-matrix run must NOT resume from lean checkpoints: the
    # fingerprint differs, the manifest is ignored (with a warning),
    # and the values still come out right
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        full = _run(problem, tmp=tmp_path, stream_dtype=None)
    assert any("ignoring incompatible" in str(x.message) for x in w)
    np.testing.assert_allclose(
        full.log_likelihoods_dla, lean.log_likelihoods_dla, rtol=1e-12
    )


def test_lean_sample_axis_sharding(problem):
    """Lean float32 on a (data x sample) mesh: the device MAP argmax over
    the sharded sample axis must come back in original sample
    numbering."""
    params, model, spectra, offsets, nhis, prior_z, prior_f = problem
    single = process_spectra(
        model, offsets, nhis, spectra, prior_z, prior_f,
        params=params, batch_size=4, sample_chunk=32, dtype=np.float32,
    )
    lean = _run(
        problem, mesh=make_mesh(sample_parallelism=2),
        dtype="float32", store_sample_likelihoods=False,
    )
    expect = np.argmax(single.sample_log_likelihoods_dla, axis=1)
    np.testing.assert_array_equal(lean.map_sample_inds, expect)
    np.testing.assert_allclose(
        lean.log_likelihoods_dla, single.log_likelihoods_dla, rtol=2e-4
    )


def test_lean_no_finite_row_falls_back_to_original_index_zero(problem):
    """A spectrum whose sample likelihoods have no finite entry must get
    MAP index 0 in ORIGINAL sample numbering, also on a sample-sharded
    mesh."""
    params, model, spectra, offsets, nhis, prior_z, prior_f = problem
    from gp_dla_detection.inference import PaddedSpectra

    # fully masked spectrum -> all-NaN likelihood row (known edge)
    mask = np.array(spectra.mask)
    mask[3] = False
    broken = PaddedSpectra(
        spectra.wavelengths, spectra.flux, spectra.noise_variance,
        mask, spectra.z_qso,
    )
    lean = process_spectra_sharded(
        model, offsets, nhis, broken, prior_z, prior_f,
        params=params, mesh=make_mesh(sample_parallelism=2),
        config=ShardedRunConfig(
            per_device_batch=1, sample_chunk=32, dtype="float32",
            store_sample_likelihoods=False,
        ),
    )
    assert not np.isfinite(lean.log_likelihoods_dla[3])
    assert lean.map_sample_inds[3] == 0
    assert (lean.map_sample_inds >= 0).all()


def test_lean_guard_in_sharded_pair_driver(problem):
    """A lean config no longer rejects the two-DLA driver (it runs the
    FUSED lean two-stage path, tests/test_lean_multi.py) — but mixing
    lean with a precomputed single stage is still rejected at config
    time, in both directions."""
    params, model, spectra, offsets, nhis, prior_z, prior_f = problem
    from gp_dla_detection.parallel.sharded_multi import (
        process_spectra_multi_sharded,
    )

    lean = _run(problem, store_sample_likelihoods=False)
    # lean config + ANY precomputed single: the fused driver recomputes
    # the single stage itself
    with pytest.raises(ValueError, match="fused lean"):
        process_spectra_multi_sharded(
            model, offsets, nhis, spectra, prior_z,
            prior_f.astype(int), params=params, single=lean,
            config=ShardedRunConfig(store_sample_likelihoods=False),
        )
    # classic config + a lean precomputed single: the host base
    # resampler needs the matrix the lean run never stored
    with pytest.raises(ValueError, match="lean"):
        process_spectra_multi_sharded(
            model, offsets, nhis, spectra, prior_z,
            prior_f.astype(int), params=params, single=lean,
            config=ShardedRunConfig(),
        )


def test_load_rejects_missing_required_fields(problem, tmp_path):
    """Only the two optional fields may be absent from a results npz;
    anything else missing is a corrupt artifact and must fail loudly."""
    lean = _run(problem, store_sample_likelihoods=False)
    path = tmp_path / "broken.npz"
    keep = {
        k: v
        for k, v in (
            (f.name, getattr(lean, f.name))
            for f in dataclasses.fields(InferenceResults)
        )
        if v is not None and k != "p_dlas"
    }
    np.savez(path, **keep)
    with pytest.raises(ValueError, match="p_dlas"):
        InferenceResults.load(path)


def test_lean_blocks_matrix_consumers(problem, tmp_path):
    params, model, spectra, offsets, nhis, prior_z, prior_f = problem
    lean = _run(problem, store_sample_likelihoods=False)

    from gp_dla_detection.multi_dla import process_spectra_multi

    with pytest.raises(ValueError, match="lean"):
        process_spectra_multi(
            model, offsets, nhis, spectra, prior_z,
            prior_f.astype(int), params=params, single=lean,
        )

    from gp_dla_detection.io.matio import write_processed_mat

    with pytest.raises(ValueError, match="lean"):
        write_processed_mat(
            lean, np.ones(len(spectra), bool), tmp_path / "x.mat"
        )


def test_lean_results_save_load_roundtrip(problem, tmp_path):
    lean = _run(problem, store_sample_likelihoods=False)
    path = tmp_path / "results.npz"
    lean.save(path)
    back = InferenceResults.load(path)
    assert back.sample_log_likelihoods_dla is None
    for f in dataclasses.fields(InferenceResults):
        a, b = getattr(lean, f.name), getattr(back, f.name)
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(a, b)


def test_pipeline_config_rejects_lean_with_matrix_stages():
    from gp_dla_detection.pipeline import PipelineConfig

    with pytest.raises(ValueError, match="lean"):
        PipelineConfig(store_sample_likelihoods=False, export_matlab=True)
    PipelineConfig(store_sample_likelihoods=False)  # catalog-only: fine
    # lean + multi is now legal: run_multi uses the fused two-stage
    # driver (tests/test_lean_multi.py)
    PipelineConfig(store_sample_likelihoods=False, multi_dla=True)
