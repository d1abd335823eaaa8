"""Base-replicated pair sampling (explicit base_replicates=R > 1).

The fused lean two-stage driver can share each posterior base draw
between R pair columns of every REPLICATE_TILE-column block
(multi_dla.replicate_draw_pattern), drawing on an R-coarser quantile
grid.  These tests pin the pattern layout, the coarse-grid inverse-CDF
draw, the driver wiring, and resume of an R > 1 run from its
checkpoints.
"""

import warnings

import numpy as np
import pytest

from gp_dla_detection.multi_dla import (
    _posterior_cdf,
    base_sample_perm,
    device_inverse_cdf_grid,
    replicate_draw_pattern,
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


def test_replicate_draw_pattern_layout():
    """Lane l and lane l + tile/2 of every tile share a draw slot;
    slots are distinct otherwise; the partial tail keeps counting."""
    di, n = replicate_draw_pattern(10000, 256, 2)
    assert di.shape == (10000,)
    # twin lanes within each full tile
    for t0 in (0, 256, 9728):
        np.testing.assert_array_equal(di[t0 : t0 + 128], di[t0 + 128 : t0 + 256])
        assert len(np.unique(di[t0 : t0 + 256])) == 128
    # consecutive tiles use fresh slots
    assert di[256] == di[0] + 128
    # partial tail (10000 = 39*256 + 16): 16 fresh slots
    assert di[9984] == 39 * 128
    assert n == 39 * 128 + 16 == di.max() + 1
    # R=1 degenerates to the identity
    di1, n1 = replicate_draw_pattern(500, 256, 1)
    np.testing.assert_array_equal(di1, np.arange(500))
    assert n1 == 500
    with pytest.raises(ValueError, match="divide"):
        replicate_draw_pattern(500, 256, 3)


def test_coarse_grid_draw_matches_searchsorted():
    """device_inverse_cdf_grid with grid_size < num_samples must equal
    searchsorted at the coarse grid's quantiles — bit-exact in f64,
    including degenerate rows."""
    rng = np.random.default_rng(2)
    S, G = 300, 137
    sll = rng.normal(-20.0, 4.0, (6, S))
    sll[3] = np.nan
    perm = base_sample_perm(G, 11)
    u = (perm + 0.5) / G
    cdf = np.asarray(_posterior_cdf(sll))
    want = np.stack(
        [np.searchsorted(row, u, side="left") for row in cdf]
    ).clip(0, S - 1)
    got = np.asarray(device_inverse_cdf_grid(sll, perm, grid_size=G))
    np.testing.assert_array_equal(got, want)
    # counts must clip to the SAMPLE axis even when grid > samples
    gbig = np.asarray(
        device_inverse_cdf_grid(sll, np.arange(2 * S), grid_size=2 * S)
    )
    assert gbig.max() <= S - 1


def test_coarse_grid_draw_randomized_sweep():
    """Randomized oracle sweep: any (S, grid_size) combination must
    reproduce searchsorted at the coarse quantiles bit-exactly in f64 —
    including grids coarser/finer than the sample count, single-sample
    grids, and rows with -inf/NaN mass.  The ONE permitted exception:
    an exact cdf == u tie (reachable only through the degenerate-row
    uniform fallback when the coarse half-grid meets (i+1)/S exactly),
    where XLA's reciprocal lowering of the correction's division may
    resolve the tie to the other side — a zero-mass flip (see the
    device_inverse_cdf_grid docstring; trial 12 here hits one at
    S=292, G=442, cdf=0.75)."""
    rng = np.random.default_rng(42)
    for trial in range(20):
        S = int(rng.integers(2, 400))
        G = int(rng.integers(1, 2 * S))
        B = int(rng.integers(1, 5))
        sll = rng.normal(-20.0, 6.0, (B, S))
        if trial % 3 == 0:
            sll[rng.integers(B), :] = np.nan
        if trial % 4 == 0:
            sll[:, rng.integers(S)] = -np.inf
        kvec = rng.integers(0, G, size=int(rng.integers(1, 3 * G)))
        u = (kvec + 0.5) / G
        cdf = np.asarray(_posterior_cdf(sll))
        want = np.stack(
            [np.searchsorted(row, u, side="left") for row in cdf]
        ).clip(0, S - 1)
        got = np.asarray(device_inverse_cdf_grid(sll, kvec, grid_size=G))
        bad = got != want
        if bad.any():
            rows, cols = np.nonzero(bad)
            for b, j in zip(rows, cols):
                lo = min(got[b, j], want[b, j])
                hi = max(got[b, j], want[b, j])
                # every CDF entry the flip crosses must sit EXACTLY on
                # the tying grid point: zero posterior mass between the
                # two resolutions
                span = cdf[b, lo:hi]
                assert (span == u[j]).all(), (
                    f"trial {trial}: non-tie mismatch at row {b} draw "
                    f"{j}: {got[b, j]} vs {want[b, j]}, cdf span {span}, "
                    f"u {u[j]!r}"
                )


def _run_lean(problem, prior_num, tmp=None, n_samples=None, **overrides):
    params, model, spectra, offsets, nhis, prior_z, _ = problem
    if n_samples is not None:
        # a sample axis wider than the pattern block, so R=2 genuinely
        # coarsens the draw grid (with S < block/2 the pattern is the
        # identity and R=2 degenerates to the R=1 draws)
        rng = np.random.default_rng(17)
        offsets = rng.uniform(size=n_samples)
        nhis = 10 ** rng.uniform(20, 22, n_samples)
    cfg = dict(
        per_device_batch=1, sample_chunk=32, dtype="float64",
        store_sample_likelihoods=False,
        checkpoint_dir=str(tmp) if tmp else None,
    )
    cfg.update(overrides)
    return process_spectra_multi_sharded(
        model, offsets, nhis, spectra, prior_z, prior_num,
        params=params, mesh=make_mesh(),
        config=ShardedRunConfig(**cfg),
    )


def test_driver_base_replicates_degenerate_bitmatch(problem, prior_num):
    """At S < REPLICATE_TILE/2 the draw pattern is the identity, so the
    R=2 run must reproduce the R=1 catalog BIT-exactly (float32, the
    production dtype)."""
    kw = dict(dtype="float32", n_samples=64)
    r1 = _run_lean(problem, prior_num, **kw)
    r2 = _run_lean(problem, prior_num, base_replicates=2, **kw)
    np.testing.assert_array_equal(
        r2.log_likelihoods_dla2, r1.log_likelihoods_dla2
    )
    np.testing.assert_array_equal(r2.map_sample_inds2, r1.map_sample_inds2)
    np.testing.assert_array_equal(
        r2.map_base_sample_inds, r1.map_base_sample_inds
    )
    np.testing.assert_array_equal(r2.model_posteriors, r1.model_posteriors)


def test_fused_lean_driver_base_replicates(problem, prior_num, tmp_path):
    """Driver wiring: R=2 shares stage 1 with R=1 exactly, draws the
    pair stage on the coarse grid deterministically, and never mixes
    checkpoints with R=1 runs."""
    S = 600  # wider than the 256-column block: n_draws = 344 < 600
    r1 = _run_lean(problem, prior_num, n_samples=S)
    r2a = _run_lean(problem, prior_num, base_replicates=2, n_samples=S,
                    tmp=tmp_path / "a")
    r2b = _run_lean(problem, prior_num, base_replicates=2, n_samples=S)

    # stage 1 is untouched by the base-draw change
    np.testing.assert_array_equal(
        r2a.single.log_likelihoods_no_dla, r1.single.log_likelihoods_no_dla
    )
    np.testing.assert_array_equal(
        r2a.single.log_likelihoods_dla, r1.single.log_likelihoods_dla
    )
    np.testing.assert_array_equal(
        r2a.single.map_sample_inds, r1.single.map_sample_inds
    )
    # the pair stage is a different (equally valid) Monte Carlo draw:
    # deterministic per config, finite where R=1 is finite
    np.testing.assert_array_equal(
        r2a.log_likelihoods_dla2, r2b.log_likelihoods_dla2
    )
    np.testing.assert_array_equal(r2a.map_sample_inds2, r2b.map_sample_inds2)
    assert (
        np.isfinite(r2a.log_likelihoods_dla2)
        == np.isfinite(r1.log_likelihoods_dla2)
    ).mean() > 0.8
    assert np.all(np.isfinite(r2a.model_posteriors))
    # ... and it IS a different draw (the coarse grid changed the base
    # assignment somewhere)
    both = np.isfinite(r2a.log_likelihoods_dla2) & np.isfinite(
        r1.log_likelihoods_dla2
    )
    assert not np.array_equal(
        r2a.log_likelihoods_dla2[both], r1.log_likelihoods_dla2[both]
    )
    # valid rows carry real draws in original sample numbering
    ok = r2a.map_base_sample_inds >= 0
    assert ok.any() and r2a.map_base_sample_inds[ok].max() < S

    # R=1 must refuse R=2 checkpoints (different draw grid)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(Warning, match="incompatible"):
            _run_lean(problem, prior_num, n_samples=S, tmp=tmp_path / "a")

    # the classic (matrix-storing) driver rejects the knob loudly
    with pytest.raises(ValueError, match="fused-lean"):
        _run_lean(
            problem, prior_num, store_sample_likelihoods=True,
            base_replicates=2,
        )

    with pytest.raises(ValueError, match="base_replicates"):
        _run_lean(problem, prior_num, base_replicates=3)


def test_base_replicates_default_is_one(problem, prior_num):
    """base_replicates=None resolves to R=1 — the classic
    one-draw-per-column resample — in both dtypes, without a warning."""
    for dtype in ("float32", "float64"):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            auto = _run_lean(problem, prior_num, dtype=dtype, n_samples=64)
        r1 = _run_lean(
            problem, prior_num, dtype=dtype, base_replicates=1, n_samples=64
        )
        np.testing.assert_array_equal(
            auto.log_likelihoods_dla2, r1.log_likelihoods_dla2
        )
        np.testing.assert_array_equal(
            auto.map_base_sample_inds, r1.map_base_sample_inds
        )
        np.testing.assert_array_equal(auto.model_posteriors, r1.model_posteriors)


def test_replicated_run_resumes_from_checkpoints(problem, prior_num, tmp_path):
    """An R=4 run interrupted after half its batches resumes from its
    checkpoints under the same fingerprint and reproduces the
    uninterrupted catalog exactly."""
    import json

    kw = dict(dtype="float32", n_samples=600, base_replicates=4)
    ck = tmp_path / "r4"
    whole = _run_lean(problem, prior_num, tmp=ck, **kw)

    man_path = ck / "fused" / "manifest.json"
    man = json.loads(man_path.read_text())
    done = sorted(man["completed_batches"])
    keep = done[: len(done) // 2]
    assert keep and len(keep) < len(done)
    for bi in done[len(done) // 2:]:
        (ck / "fused" / f"batch_{bi:06d}.npz").unlink()
    man["completed_batches"] = keep
    man_path.write_text(json.dumps(man))

    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no "incompatible checkpoints"
        resumed = _run_lean(problem, prior_num, tmp=ck, **kw)
    assert json.loads(man_path.read_text())["fingerprint"] == man["fingerprint"]
    for attr in (
        "log_likelihoods_dla2", "map_sample_inds2", "map_base_sample_inds",
        "model_posteriors",
    ):
        np.testing.assert_array_equal(
            getattr(resumed, attr), getattr(whole, attr), err_msg=attr
        )
