"""Fused lean two-stage {0,1,2}-DLA driver: both stages per batch on
device, base absorber resampled on device (multi_dla.device_base_sample_
inds), only per-spectrum vectors fetched.  The catalog outputs (model
posteriors, evidences, MAPs) must match the classic two-pass flow;
posterior-sample consumers must fail loudly on the matrix-free results.
"""

import dataclasses
import warnings

import numpy as np
import pytest

from gp_dla_detection.multi_dla import (
    MultiDLAResults,
    base_sample_grid,
    base_sample_perm,
    device_base_sample_inds,
    device_inverse_cdf_grid,
    make_base_sample_inds,
    pack_lean_pair,
)
from gp_dla_detection.parallel import ShardedRunConfig, make_mesh
from gp_dla_detection.parallel.sharded_multi import (
    process_spectra_multi_sharded,
)

from synthetic_problem import make_problem


@pytest.fixture(scope="module")
def problem():
    return make_problem()


@pytest.fixture(scope="module")
def prior_num():
    rng = np.random.default_rng(7)
    return rng.choice([0, 0, 0, 0, 0, 1, 1, 2], 200)


def _run(problem, prior_num, lean, tmp=None, mesh=None, base_seed=0,
         **overrides):
    params, model, spectra, offsets, nhis, prior_z, _ = problem
    cfg = dict(
        per_device_batch=1, sample_chunk=32, dtype="float64",
        store_sample_likelihoods=not lean,
        checkpoint_dir=str(tmp) if tmp else None,
    )
    cfg.update(overrides)
    return process_spectra_multi_sharded(
        model, offsets, nhis, spectra, prior_z, prior_num,
        params=params, mesh=mesh or make_mesh(), base_seed=base_seed,
        config=ShardedRunConfig(**cfg),
    )


@pytest.fixture(scope="module")
def classic(problem, prior_num):
    return _run(problem, prior_num, lean=False)


@pytest.fixture(scope="module")
def fused(problem, prior_num):
    return _run(problem, prior_num, lean=True)


def test_device_base_sampler_matches_host(problem):
    """The on-device inverse-CDF resampler must reproduce the host
    resampler: exactly in f64 away from knife edges, including the
    NaN-row uniform fallback, and almost everywhere in f32."""
    rng = np.random.default_rng(11)
    sll = rng.normal(-20.0, 4.0, (6, 300))
    sll[2] = np.nan  # degenerate row: uniform fallback
    host = make_base_sample_inds(sll, seed=5)
    u = base_sample_grid(300, 5)
    dev64 = np.asarray(device_base_sample_inds(sll, u))
    frac64 = (host == dev64).mean()
    assert frac64 > 0.999, frac64
    # degenerate row resamples ~uniformly on both paths
    assert len(np.unique(dev64[2])) > 250

    sll32 = sll.astype(np.float32)
    host32 = make_base_sample_inds(sll32, seed=5)
    dev32 = np.asarray(device_base_sample_inds(sll32, u))
    frac32 = (host32 == dev32).mean()
    # f32 cumsum vs the host's f64 cumsum: only knife-edge draws flip
    assert frac32 > 0.99, frac32

    # well-separated posterior mass: bit-exact in any dtype
    peaked = np.full((2, 300), -80.0, np.float32)
    peaked[0, 17] = 0.0
    peaked[1, 230] = 0.0
    np.testing.assert_array_equal(
        np.asarray(device_base_sample_inds(peaked, u)),
        make_base_sample_inds(peaked, seed=5),
    )


def test_grid_inverse_cdf_matches_searchsorted():
    """The search-free grid inverse-CDF must reproduce the generic
    device resampler: bit-exact in f64 (the correction recomputes the
    grid with the same single rounding numpy built it with), knife-edge
    flips only in f32, and exact composition with a further static
    permutation (the fused driver folds the pair-column order in)."""
    rng = np.random.default_rng(3)
    S = 300
    sll = rng.normal(-20.0, 4.0, (7, S))
    sll[4] = np.nan  # degenerate row: uniform fallback
    perm = base_sample_perm(S, 9)
    u = base_sample_grid(S, 9)

    ref64 = np.asarray(device_base_sample_inds(sll, u))
    grid64 = np.asarray(device_inverse_cdf_grid(sll, perm))
    np.testing.assert_array_equal(grid64, ref64)

    sll32 = sll.astype(np.float32)
    ref32 = np.asarray(device_base_sample_inds(sll32, u.astype(np.float32)))
    grid32 = np.asarray(device_inverse_cdf_grid(sll32, perm))
    agree = (ref32 == grid32).mean()
    assert agree > 0.999, agree  # double- vs single-rounded boundaries

    # composed permutation == composition of results
    order = rng.permutation(S)
    np.testing.assert_array_equal(
        np.asarray(device_inverse_cdf_grid(sll, perm[order])),
        grid64[:, order],
    )

    # uniform fallback row covers the sample space on the grid path too
    assert len(np.unique(grid64[4])) > 250


def test_pack_lean_pair_semantics():
    """Pair reduction: evidence over VALID pairs only (NaN = too close),
    all-NaN rows -> NaN evidence and -1 MAP flags, MAP base index pulled
    from the pair's base column."""
    import jax.numpy as jnp

    rows = np.array(
        [
            [1.0, np.nan, 3.0, 2.0],
            [np.nan, np.nan, np.nan, np.nan],
            [-1.0, -2.0, -3.0, -4.0],
        ]
    )
    base = np.array([[5, 6, 7, 8], [1, 2, 3, 4], [9, 10, 11, 12]], np.int32)
    ev, mi, mb = pack_lean_pair(jnp.asarray(rows), jnp.asarray(base))
    ev = np.asarray(ev)
    mi = np.asarray(mi).astype(int)
    mb = np.asarray(mb).astype(int)
    with np.errstate(invalid="ignore"):
        m0 = np.nanmax(rows[0])
        expect0 = m0 + np.log(np.nanmean(np.exp(rows[0] - m0)))
    np.testing.assert_allclose(ev[0], expect0, rtol=1e-12)
    assert np.isnan(ev[1])
    assert mi.tolist() == [2, -1, 0]
    assert mb.tolist() == [7, -1, 9]


def test_fused_lean_matches_classic(problem, prior_num, classic, fused):
    """f64 XLA path: the fused driver's catalog outputs must match the
    classic two-pass flow.  The base draws are bit-matched here (f64
    CDF on both paths; the synthetic rows put no draw on a knife edge),
    so the pair evidence differs only by reduction association."""
    assert fused.sample_log_likelihoods_dla2 is None
    assert fused.base_sample_inds is None
    assert fused.single.sample_log_likelihoods_dla is None
    assert classic.map_sample_inds2 is None

    np.testing.assert_array_equal(
        fused.single.log_likelihoods_no_dla,
        classic.single.log_likelihoods_no_dla,
    )
    np.testing.assert_allclose(
        fused.single.log_likelihoods_dla,
        classic.single.log_likelihoods_dla,
        rtol=1e-12,
    )
    np.testing.assert_allclose(
        fused.log_likelihoods_dla2, classic.log_likelihoods_dla2,
        rtol=1e-9,
    )
    np.testing.assert_allclose(
        fused.model_posteriors, classic.model_posteriors, rtol=1e-9,
        atol=1e-12,
    )

    # MAP fields vs the classic matrices: same argmax pair, same base
    out2 = classic.sample_log_likelihoods_dla2
    finite_rows = np.isfinite(out2).any(axis=1)
    assert finite_rows.all()  # this fixture leaves every row some pairs
    expect_map2 = np.nanargmax(out2, axis=1)
    np.testing.assert_array_equal(fused.map_sample_inds2, expect_map2)
    np.testing.assert_array_equal(
        fused.map_base_sample_inds,
        classic.base_sample_inds[
            np.arange(len(expect_map2)), expect_map2
        ],
    )
    # single-stage MAP matches the full matrix argmax
    np.testing.assert_array_equal(
        fused.single.map_sample_inds,
        np.argmax(classic.single.sample_log_likelihoods_dla, axis=1),
    )


def test_fused_lean_float32(problem, prior_num, classic):
    """Fused lean in float32 (the production dtype) against the classic
    float64 flow: posteriors and evidences at float32 scale, and MAP
    indices in original sample numbering."""
    fused = _run(problem, prior_num, lean=True, dtype="float32")
    assert fused.sample_log_likelihoods_dla2 is None
    np.testing.assert_allclose(
        fused.model_posteriors, classic.model_posteriors, atol=2e-3
    )
    np.testing.assert_allclose(
        fused.single.log_likelihoods_dla,
        classic.single.log_likelihoods_dla,
        rtol=2e-4,
    )
    S = len(problem[3])
    assert ((fused.map_sample_inds2 >= 0) & (fused.map_sample_inds2 < S)).all()
    assert (
        (fused.map_base_sample_inds >= 0) & (fused.map_base_sample_inds < S)
    ).all()
    # the pair evidences agree with the classic f64 flow at f32 scale
    np.testing.assert_allclose(
        fused.log_likelihoods_dla2, classic.log_likelihoods_dla2,
        rtol=5e-4, atol=5e-3,
    )


def test_fused_lean_checkpoint_resume(problem, prior_num, tmp_path):
    r1 = _run(problem, prior_num, lean=True, tmp=tmp_path)
    ckpts = sorted((tmp_path / "fused").glob("batch_*.npz"))
    assert ckpts
    with np.load(ckpts[0]) as f:
        assert "log_likelihood_dla2" in f and "map_base_sample_ind" in f
        assert "sample_log_likelihoods_dla2" not in f
        # matrix-free: a lean batch checkpoint is a few KB
        assert sum(v.nbytes for v in f.values()) < 4096
    r2 = _run(problem, prior_num, lean=True, tmp=tmp_path)
    for attr in (
        "log_likelihoods_dla2", "model_posteriors",
        "map_sample_inds2", "map_base_sample_inds",
    ):
        np.testing.assert_array_equal(getattr(r1, attr), getattr(r2, attr))
    np.testing.assert_array_equal(
        r1.single.log_likelihoods_dla, r2.single.log_likelihoods_dla
    )
    # a different base seed is a different numerics fingerprint: the
    # stale checkpoints must be ignored (with a warning), not resumed
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        _run(problem, prior_num, lean=True, tmp=tmp_path, base_seed=1)
    assert any("ignoring incompatible" in str(x.message) for x in w)


def test_fused_lean_mesh_parity(problem, prior_num):
    """The 8-device data mesh and a single-device mesh must agree
    bit-for-bit when the super-batch geometry matches (same padded
    shapes, data sharding only re-tiles rows)."""
    import jax

    eight = _run(
        problem, prior_num, lean=True, per_device_batch=2,
        mesh=make_mesh(),  # 8 virtual CPU devices -> super_batch 16
    )
    one = _run(
        problem, prior_num, lean=True, per_device_batch=16,
        mesh=make_mesh(num_devices=1),
    )
    for attr in (
        "log_likelihoods_dla2", "model_posteriors",
        "map_sample_inds2", "map_base_sample_inds",
    ):
        np.testing.assert_array_equal(
            getattr(eight, attr), getattr(one, attr), err_msg=attr
        )


def test_fused_lean_sample_mesh_xla_matches_data_only(problem, prior_num):
    """On a (data x sample) mesh the partitioner shards the WHOLE fused
    chain (kernels, lean packs, inverse-CDF resampler's
    cumsum/scatter, value gathers) and must reproduce the data-only
    mesh catalog bit-for-bit."""
    ref = _run(problem, prior_num, lean=True, per_device_batch=2)
    out = _run(
        problem, prior_num, lean=True, per_device_batch=4,
        mesh=make_mesh(sample_parallelism=2),  # (data 4, sample 2)
    )
    for attr in (
        "log_likelihoods_dla2", "model_posteriors",
        "map_sample_inds2", "map_base_sample_inds",
    ):
        np.testing.assert_array_equal(
            getattr(out, attr), getattr(ref, attr), err_msg=attr
        )


def test_fused_lean_float32_sample_mesh(problem, prior_num):
    """The float32 fused chain on a (data x sample) mesh reproduces the
    data-only mesh's catalog decisions and evidences to float32
    reduction order."""
    ref = _run(problem, prior_num, lean=True, dtype="float32")
    out = _run(
        problem, prior_num, lean=True, dtype="float32", per_device_batch=4,
        mesh=make_mesh(sample_parallelism=2),
    )
    np.testing.assert_array_equal(
        np.argmax(out.model_posteriors, 1), np.argmax(ref.model_posteriors, 1)
    )
    np.testing.assert_allclose(
        out.single.log_likelihoods_dla, ref.single.log_likelihoods_dla,
        rtol=1e-5,
    )


def test_fused_lean_rejects_precomputed_single(problem, prior_num, classic):
    params, model, spectra, offsets, nhis, prior_z, _ = problem
    with pytest.raises(ValueError, match="fused lean"):
        process_spectra_multi_sharded(
            model, offsets, nhis, spectra, prior_z, prior_num,
            params=params, mesh=make_mesh(), single=classic.single,
            config=ShardedRunConfig(
                per_device_batch=1, sample_chunk=32, dtype="float64",
                store_sample_likelihoods=False,
            ),
        )


def test_lean_multi_save_load_roundtrip(fused, tmp_path):
    path = tmp_path / "multi.npz"
    fused.save(path)
    back = MultiDLAResults.load(path)
    assert back.sample_log_likelihoods_dla2 is None
    assert back.base_sample_inds is None
    assert back.single.sample_log_likelihoods_dla is None
    np.testing.assert_array_equal(
        back.map_sample_inds2, fused.map_sample_inds2
    )
    np.testing.assert_array_equal(
        back.map_base_sample_inds, fused.map_base_sample_inds
    )
    np.testing.assert_array_equal(
        back.model_posteriors, fused.model_posteriors
    )
    np.testing.assert_array_equal(
        back.single.map_sample_inds, fused.single.map_sample_inds
    )


def test_lean_multi_blocks_matrix_consumers(fused, problem, tmp_path):
    from gp_dla_detection.io.matio import write_multi_processed_mat

    n = len(fused.model_posteriors)
    with pytest.raises(ValueError, match="lean"):
        write_multi_processed_mat(
            fused, np.ones(n, bool), tmp_path / "multi.mat"
        )


def test_full_multi_results_have_no_map_fields(classic):
    """The classic flow leaves the device-reduced MAP fields None (the
    catalog writer argmaxes the matrices directly), and save() keeps
    omitting them without error."""
    assert classic.map_sample_inds2 is None
    assert classic.map_base_sample_inds is None
