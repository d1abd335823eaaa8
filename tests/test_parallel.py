"""Sharded execution on the virtual 8-device CPU mesh: sharded results
must equal single-device results exactly, and checkpoint/resume must be
idempotent."""

import numpy as np
import jax
import pytest

from gp_dla_detection.inference import process_spectra
from gp_dla_detection.models.training import learn_gp_model
from gp_dla_detection.parallel import (
    ShardedRunConfig,
    make_mesh,
    process_spectra_sharded,
)
from gp_dla_detection.params import NullModelParams, OptimizationParams, Parameters


from synthetic_problem import make_problem


@pytest.fixture(scope="module")
def problem():
    return make_problem()


def test_eight_device_mesh_available():
    assert len(jax.devices()) == 8


def test_sharded_matches_single_device(problem):
    params, model, spectra, offsets, nhis, prior_z, prior_f = problem
    single = process_spectra(
        model, offsets, nhis, spectra, prior_z, prior_f,
        params=params, batch_size=4, sample_chunk=32, dtype=np.float64,
    )
    mesh = make_mesh()
    sharded = process_spectra_sharded(
        model, offsets, nhis, spectra, prior_z, prior_f,
        params=params, mesh=mesh,
        config=ShardedRunConfig(per_device_batch=1, sample_chunk=32, dtype="float64"),
    )
    np.testing.assert_allclose(
        sharded.log_likelihoods_no_dla, single.log_likelihoods_no_dla, rtol=1e-12
    )
    np.testing.assert_allclose(
        sharded.sample_log_likelihoods_dla,
        single.sample_log_likelihoods_dla,
        rtol=1e-10,
    )
    np.testing.assert_allclose(sharded.p_dlas, single.p_dlas, rtol=1e-9, atol=1e-12)


def test_sample_axis_sharding(problem):
    params, model, spectra, offsets, nhis, prior_z, prior_f = problem
    mesh = make_mesh(sample_parallelism=4)
    assert dict(zip(mesh.axis_names, mesh.devices.shape)) == {
        "data": 2,
        "sample": 4,
    }
    sharded = process_spectra_sharded(
        model, offsets, nhis, spectra, prior_z, prior_f,
        params=params, mesh=mesh,
        config=ShardedRunConfig(per_device_batch=2, sample_chunk=32, dtype="float64"),
    )
    single = process_spectra(
        model, offsets, nhis, spectra, prior_z, prior_f,
        params=params, batch_size=4, sample_chunk=32, dtype=np.float64,
    )
    np.testing.assert_allclose(
        sharded.sample_log_likelihoods_dla,
        single.sample_log_likelihoods_dla,
        rtol=1e-10,
    )


@pytest.mark.parametrize("sample_parallelism", [1, 2], ids=["data", "data_x_sample"])
def test_sharded_f32_matches_single_device(problem, sample_parallelism):
    """The float32 path on a multi-device mesh — data-parallel, or with
    the QMC sample axis split over a 'sample' mesh axis — must match the
    single-device engine in the original sample order; same for the
    two-DLA driver (fresh axis sharded, base columns riding along)."""
    from gp_dla_detection.multi_dla import process_spectra_multi
    from gp_dla_detection.parallel import process_spectra_multi_sharded

    params, model, spectra, offsets, nhis, prior_z, prior_f = problem
    mesh = make_mesh(sample_parallelism=sample_parallelism)
    assert dict(zip(mesh.axis_names, mesh.devices.shape)) == {
        "data": 8 // sample_parallelism,
        "sample": sample_parallelism,
    }
    config = ShardedRunConfig(
        per_device_batch=1, sample_chunk=32, dtype="float32",
        stream_dtype="float32",
    )
    single = process_spectra(
        model, offsets, nhis, spectra, prior_z, prior_f,
        params=params, batch_size=4, sample_chunk=32, dtype=np.float32,
    )
    sharded = process_spectra_sharded(
        model, offsets, nhis, spectra, prior_z, prior_f,
        params=params, mesh=mesh, config=config,
    )
    np.testing.assert_allclose(
        sharded.sample_log_likelihoods_dla,
        single.sample_log_likelihoods_dla,
        rtol=2e-4,
    )
    np.testing.assert_allclose(
        sharded.log_likelihoods_no_dla, single.log_likelihoods_no_dla,
        rtol=2e-4,
    )

    prior_num = prior_f.astype(int)
    m_single = process_spectra_multi(
        model, offsets, nhis, spectra, prior_z, prior_num,
        params=params, batch_size=4, sample_chunk=32, dtype=np.float32,
    )
    m_sharded = process_spectra_multi_sharded(
        model, offsets, nhis, spectra, prior_z, prior_num,
        params=params, mesh=mesh, config=config,
    )
    assert np.array_equal(
        np.isnan(m_sharded.sample_log_likelihoods_dla2),
        np.isnan(m_single.sample_log_likelihoods_dla2),
    )
    rel = np.abs(
        m_sharded.sample_log_likelihoods_dla2
        - m_single.sample_log_likelihoods_dla2
    ) / np.maximum(np.abs(m_single.sample_log_likelihoods_dla2), 1.0)
    assert np.nanmax(rel) < 2e-4


def test_checkpoint_resume(problem, tmp_path):
    params, model, spectra, offsets, nhis, prior_z, prior_f = problem
    mesh = make_mesh()
    cfg = ShardedRunConfig(
        per_device_batch=1, sample_chunk=32, dtype="float64",
        checkpoint_dir=str(tmp_path / "ckpt"),
    )
    full = process_spectra_sharded(
        model, offsets, nhis, spectra, prior_z, prior_f,
        params=params, mesh=mesh, config=cfg,
    )
    # corrupt the in-memory state by re-running: all batches should be
    # loaded from checkpoints (results identical, manifest complete)
    import json

    manifest = json.loads((tmp_path / "ckpt" / "manifest.json").read_text())
    assert len(manifest["completed_batches"]) == manifest["total_batches"]
    resumed = process_spectra_sharded(
        model, offsets, nhis, spectra, prior_z, prior_f,
        params=params, mesh=mesh, config=cfg,
    )
    np.testing.assert_array_equal(
        resumed.sample_log_likelihoods_dla, full.sample_log_likelihoods_dla
    )


def test_sharded_multi_dla_matches_single_device(problem, tmp_path):
    """Sharded two-DLA model selection == single-device, with working
    pair-stage checkpoints."""
    from gp_dla_detection.multi_dla import process_spectra_multi
    from gp_dla_detection.parallel import process_spectra_multi_sharded

    params, model, spectra, offsets, nhis, prior_z, prior_f = problem
    rng = np.random.default_rng(11)
    prior_num = prior_f.astype(int) + (rng.uniform(size=prior_f.size) < 0.05)

    single = process_spectra_multi(
        model, offsets, nhis, spectra, prior_z, prior_num,
        params=params, batch_size=4, sample_chunk=32, dtype=np.float64,
    )
    cfg = ShardedRunConfig(
        per_device_batch=1, sample_chunk=32, dtype="float64",
        checkpoint_dir=str(tmp_path / "mck"),
    )
    sharded = process_spectra_multi_sharded(
        model, offsets, nhis, spectra, prior_z, prior_num,
        params=params, mesh=make_mesh(), config=cfg,
    )
    np.testing.assert_array_equal(
        sharded.base_sample_inds, single.base_sample_inds
    )
    np.testing.assert_allclose(
        sharded.sample_log_likelihoods_dla2,
        single.sample_log_likelihoods_dla2,
        rtol=1e-10,
    )
    np.testing.assert_allclose(
        sharded.model_posteriors, single.model_posteriors,
        rtol=1e-9, atol=1e-12,
    )
    # both stages checkpointed; resume is bit-identical
    assert (tmp_path / "mck" / "single" / "manifest.json").exists()
    assert (tmp_path / "mck" / "pair" / "manifest.json").exists()
    resumed = process_spectra_multi_sharded(
        model, offsets, nhis, spectra, prior_z, prior_num,
        params=params, mesh=make_mesh(), config=cfg,
    )
    np.testing.assert_array_equal(
        resumed.sample_log_likelihoods_dla2,
        sharded.sample_log_likelihoods_dla2,
    )


def test_data_parallel_training(problem):
    """Sharded training objective equals single-device (same L-BFGS path)."""
    rng = np.random.default_rng(5)
    R, k, N = 32, 2, 40
    params = Parameters(
        null_model=NullModelParams(
            min_lambda=1000.0, max_lambda=1000.0 + 0.25 * (R - 1), k=k
        ),
        optimization=OptimizationParams(max_iterations=10, max_fun_evals=20),
    )
    from gp_dla_detection.models.training import TrainingData

    mask = rng.uniform(size=(N, R)) > 0.2
    data = TrainingData(
        centered_flux=np.where(mask, rng.normal(0, 0.4, (N, R)), 0.0),
        lya_1pzs=np.where(mask, 1 + rng.uniform(1.5, 3, (N, R)), 1.0),
        noise_variance=np.where(mask, rng.uniform(0.02, 0.3, (N, R)), 0.0),
        mask=mask,
        mu=np.zeros(R),
    )
    m_single, r_single = learn_gp_model(data, params)
    m_sharded, r_sharded = learn_gp_model(data, params, mesh=make_mesh())
    assert abs(r_single.f - r_sharded.f) < 1e-6 * abs(r_single.f)
    np.testing.assert_allclose(m_sharded.M, m_single.M, rtol=1e-5, atol=1e-7)


def test_fetch_rows_wire_format():
    """max+f16-residual streaming: NaN/-inf structure preserved, clamp
    flushes only weightless residuals, f64 is never narrowed."""
    import jax.numpy as jnp

    from gp_dla_detection.parallel.streaming import fetch_rows

    sll = np.array(
        [
            [-100.0, -100.5, -200.0],
            [np.nan, -5.0, np.nan],
            [-np.inf, -np.inf, -np.inf],
            [-1.0e5, -1.0, 0.0],
        ],
        np.float32,
    )
    exact = fetch_rows(jnp.asarray(sll), "float32")
    np.testing.assert_array_equal(exact, sll)
    out = fetch_rows(jnp.asarray(sll), "float16")
    assert np.array_equal(np.isnan(out), np.isnan(sll))
    assert np.all(out[2] == -np.inf)
    # residual below the f16 range flushes to -inf (posterior weight 0)
    assert out[3, 0] == -np.inf
    # everything else reproduced to f16 resolution of the residual
    with np.errstate(invalid="ignore"):
        resid = sll - np.nanmax(
            np.where(np.isnan(sll), -np.inf, sll), 1
        )[:, None]
        ok = np.isfinite(sll) & (resid > -6e4)
    assert np.all(
        np.abs(out[ok] - sll[ok]) <= 2e-3 * np.maximum(np.abs(resid[ok]), 1.0)
    )
    # f64 parity mode: passthrough regardless of the requested wire dtype
    sll64 = np.asarray(sll, np.float64)
    np.testing.assert_array_equal(
        fetch_rows(jnp.asarray(sll64), "float16"), sll64
    )


def _launch_two_workers(tmp_path, mode="single"):
    """Run tests/distributed_worker.py as two gloo-coupled OS processes
    (4 virtual CPU devices each, one global 8-device mesh) and assert
    both exit cleanly."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    # pick a free coordinator port
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    addr = f"127.0.0.1:{port}"

    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    worker = Path(__file__).parent / "distributed_worker.py"
    # worker output goes to FILES, not PIPEs: waiting on worker 0 while
    # worker 1 fills a ~64 KB pipe buffer would block worker 1 mid-write
    # inside a collective and deadlock both (they are gloo-coupled)
    logs = [tmp_path / f"worker_{i}.log" for i in range(2)]
    procs = []
    for i in range(2):
        with open(logs[i], "w") as fh:  # the child keeps its own fd
            procs.append(
                subprocess.Popen(
                    [sys.executable, str(worker), str(i), "2", addr,
                     str(tmp_path), mode],
                    env=env, stdout=fh, stderr=subprocess.STDOUT, text=True,
                )
            )
    try:
        for p in procs:
            p.wait(timeout=420)
    finally:
        for p in procs:  # no orphans on timeout/assert failure
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, (
            f"worker {p.args} failed:\n{log.read_text()[-3000:]}"
        )


def test_two_process_distributed_matches_single(problem, tmp_path):
    """Real jax.distributed bring-up: two OS processes, 4 virtual CPU
    devices each, one global 8-device mesh with gloo collectives between
    processes.  The sharded driver must produce the single-process
    result on every process, with checkpoints written once (process 0).
    Exercises parallel.mesh.initialize_distributed / fetch_global —
    SURVEY §5's distributed-comms subsystem end-to-end."""
    _launch_two_workers(tmp_path, "single")

    params, model, spectra, offsets, nhis, prior_z, prior_f = problem
    single = process_spectra(
        model, offsets, nhis, spectra, prior_z, prior_f,
        params=params, batch_size=4, sample_chunk=32, dtype=np.float64,
    )
    with np.load(tmp_path / "result.npz") as dist:
        np.testing.assert_allclose(
            dist["log_likelihoods_no_dla"],
            single.log_likelihoods_no_dla,
            rtol=1e-12,
        )
        np.testing.assert_allclose(
            dist["sample_log_likelihoods_dla"],
            single.sample_log_likelihoods_dla,
            rtol=1e-10,
        )
        np.testing.assert_allclose(
            dist["p_dlas"], single.p_dlas, rtol=1e-9, atol=1e-12
        )
        dist_sll = dist["sample_log_likelihoods_dla"]
    # every process gathered the identical full result
    with np.load(tmp_path / "result_p1.npz") as p1:
        np.testing.assert_array_equal(
            p1["sample_log_likelihoods_dla"], dist_sll
        )
    # single-writer checkpoints: manifest complete, written by process 0
    import json

    manifest = json.loads((tmp_path / "ckpt" / "manifest.json").read_text())
    assert len(manifest["completed_batches"]) == manifest["total_batches"]


def test_two_process_distributed_lean_multi_matches_single(problem, tmp_path):
    """The FUSED lean two-stage {0,1,2}-DLA driver under real
    jax.distributed: two controllers, one global 8-device mesh.  This is
    the production multi-controller path (serial dispatch forced so
    collective issuance order matches across processes; fetch_global
    all-gathers the stacked small vectors; process 0 owns the single
    fused checkpoint stream).  Every process must hold the identical
    full catalog, equal to the single-process fused run."""
    import json

    from gp_dla_detection.parallel.sharded_multi import (
        process_spectra_multi_sharded,
    )

    _launch_two_workers(tmp_path, "lean_multi")

    params, model, spectra, offsets, nhis, prior_z, prior_f = problem
    prior_num = np.random.default_rng(7).choice([0, 0, 0, 0, 0, 1, 1, 2], 200)
    single = process_spectra_multi_sharded(
        model, offsets, nhis, spectra, prior_z, prior_num,
        params=params, mesh=make_mesh(),
        config=ShardedRunConfig(
            per_device_batch=1, sample_chunk=32, dtype="float64",
            store_sample_likelihoods=False,
        ),
    )

    with np.load(tmp_path / "result.npz") as dist:
        np.testing.assert_allclose(
            dist["log_likelihoods_no_dla"],
            single.single.log_likelihoods_no_dla, rtol=1e-12,
        )
        np.testing.assert_allclose(
            dist["log_likelihoods_dla"],
            single.single.log_likelihoods_dla, rtol=1e-10,
        )
        np.testing.assert_allclose(
            dist["log_likelihoods_dla2"],
            single.log_likelihoods_dla2, rtol=1e-10,
        )
        np.testing.assert_allclose(
            dist["model_posteriors"], single.model_posteriors,
            rtol=1e-9, atol=1e-12,
        )
        # device-reduced MAP indices: exact in f64 (knife-edge-free)
        np.testing.assert_array_equal(
            dist["map_sample_inds"], single.single.map_sample_inds
        )
        np.testing.assert_array_equal(
            dist["map_sample_inds2"], single.map_sample_inds2
        )
        np.testing.assert_array_equal(
            dist["map_base_sample_inds"], single.map_base_sample_inds
        )
        dist_keys = {k: dist[k] for k in dist.files}
    # replicated-by-construction: both processes hold the same catalog
    for pid in range(2):
        with np.load(tmp_path / f"result_p{pid}.npz") as pp:
            for k, v in dist_keys.items():
                np.testing.assert_array_equal(pp[k], v)
    # one fused checkpoint stream, complete, written by the coordinator
    manifest = json.loads(
        (tmp_path / "ckpt" / "fused" / "manifest.json").read_text()
    )
    n, sb = manifest["num_spectra"], manifest["super_batch"]
    assert n == len(spectra.z_qso)
    assert len(manifest["completed_batches"]) == -(-n // sb)


def test_f16_streaming_preserves_posteriors(problem):
    """Default f16 wire format vs exact fetch on the same f32 run:
    posteriors agree to sample-probability tolerance."""
    params, model, spectra, offsets, nhis, prior_z, prior_f = problem
    mesh = make_mesh()

    def run(stream):
        return process_spectra_sharded(
            model, offsets, nhis, spectra, prior_z, prior_f,
            params=params, mesh=mesh,
            config=ShardedRunConfig(
                per_device_batch=1, sample_chunk=32, dtype="float32",
                stream_dtype=stream,
            ),
        )

    exact = run("float32")
    packed = run("float16")
    np.testing.assert_allclose(packed.p_dlas, exact.p_dlas, atol=2e-4)
    np.testing.assert_allclose(
        packed.log_likelihoods_dla, exact.log_likelihoods_dla,
        rtol=1e-4, atol=1e-3,
    )
    resid = exact.sample_log_likelihoods_dla - np.max(
        exact.sample_log_likelihoods_dla, axis=1, keepdims=True
    )
    err = np.abs(
        packed.sample_log_likelihoods_dla - exact.sample_log_likelihoods_dla
    )
    assert np.all(err <= 2e-3 * np.maximum(np.abs(resid), 1.0))


def test_sharded_windowed_xla_matches_plain(problem):
    """windowed_voigt=True must actually window and agree with the
    plain path to windowed-approximation accuracy (the window covers
    every chunk's line cores; outside them only the negligible-core
    Gaussian term differs)."""
    params, model, spectra, offsets, nhis, prior_z, prior_f = problem
    mesh = make_mesh()
    base = ShardedRunConfig(
        per_device_batch=1, sample_chunk=32, dtype="float32",
        stream_dtype="float32",
    )
    import dataclasses

    plain = process_spectra_sharded(
        model, offsets, nhis, spectra, prior_z, prior_f,
        params=params, mesh=mesh, config=base,
    )
    windowed = process_spectra_sharded(
        model, offsets, nhis, spectra, prior_z, prior_f,
        params=params, mesh=mesh,
        config=dataclasses.replace(base, windowed_voigt=True),
    )
    scale = np.maximum(np.abs(plain.sample_log_likelihoods_dla), 1.0)
    assert (
        np.max(
            np.abs(
                windowed.sample_log_likelihoods_dla
                - plain.sample_log_likelihoods_dla
            )
            / scale
        )
        < 5e-5
    )
    np.testing.assert_allclose(
        windowed.p_dlas, plain.p_dlas, rtol=1e-3, atol=1e-6
    )


def test_bfloat16_checkpoint_roundtrip(problem, tmp_path):
    """stream_dtype='bfloat16' checkpoints must survive the npz round
    trip: np.savez has no bfloat16 codec (it writes raw '|V2' voids), so
    the driver stores the uint16 bit pattern — resume must be
    bit-identical to the uninterrupted run."""
    import ml_dtypes

    params, model, spectra, offsets, nhis, prior_z, prior_f = problem
    mesh = make_mesh()
    cfg = ShardedRunConfig(
        per_device_batch=1, sample_chunk=32, dtype="float32",
        stream_dtype="bfloat16", checkpoint_dir=str(tmp_path / "bf16"),
    )
    full = process_spectra_sharded(
        model, offsets, nhis, spectra, prior_z, prior_f,
        params=params, mesh=mesh, config=cfg,
    )
    ckpts = sorted((tmp_path / "bf16").glob("batch_*.npz"))
    assert ckpts
    with np.load(ckpts[0]) as f:
        assert "sample_ll_resid_bf16" in f
        assert f["sample_ll_resid_bf16"].dtype == np.uint16
        row0 = f["sample_ll_resid_bf16"].view(ml_dtypes.bfloat16).astype(
            np.float32
        ) + f["sample_ll_row_max"][:, None]
    assert np.isfinite(row0).any()
    resumed = process_spectra_sharded(
        model, offsets, nhis, spectra, prior_z, prior_f,
        params=params, mesh=mesh, config=cfg,
    )
    np.testing.assert_array_equal(
        resumed.sample_log_likelihoods_dla, full.sample_log_likelihoods_dla
    )
    np.testing.assert_array_equal(resumed.p_dlas, full.p_dlas)


def test_data_only_mesh(problem, tmp_path):
    """A mesh with ONLY a data axis must work in both drivers — sample
    arrays replicate."""
    from jax.sharding import Mesh

    from gp_dla_detection.multi_dla import process_spectra_multi
    from gp_dla_detection.parallel import process_spectra_multi_sharded

    params, model, spectra, offsets, nhis, prior_z, prior_f = problem
    mesh = Mesh(np.asarray(jax.devices()), ("data",))
    single = process_spectra(
        model, offsets, nhis, spectra, prior_z, prior_f,
        params=params, batch_size=4, sample_chunk=32, dtype=np.float64,
    )
    sharded = process_spectra_sharded(
        model, offsets, nhis, spectra, prior_z, prior_f,
        params=params, mesh=mesh,
        config=ShardedRunConfig(
            per_device_batch=1, sample_chunk=32, dtype="float64"
        ),
    )
    np.testing.assert_allclose(
        sharded.sample_log_likelihoods_dla,
        single.sample_log_likelihoods_dla,
        rtol=1e-10,
    )

    prior_num = prior_f.astype(int)
    m_single = process_spectra_multi(
        model, offsets, nhis, spectra, prior_z, prior_num,
        params=params, batch_size=4, sample_chunk=32, dtype=np.float64,
    )
    m_sharded = process_spectra_multi_sharded(
        model, offsets, nhis, spectra, prior_z, prior_num,
        params=params, mesh=mesh,
        config=ShardedRunConfig(
            per_device_batch=1, sample_chunk=32, dtype="float64"
        ),
    )
    assert np.array_equal(
        np.isnan(m_sharded.sample_log_likelihoods_dla2),
        np.isnan(m_single.sample_log_likelihoods_dla2),
    )
    valid = ~np.isnan(m_single.sample_log_likelihoods_dla2)
    np.testing.assert_allclose(
        m_sharded.sample_log_likelihoods_dla2[valid],
        m_single.sample_log_likelihoods_dla2[valid],
        rtol=1e-10,
    )


def test_numerics_change_invalidates_checkpoints(problem, tmp_path):
    """The manifest fingerprints the numerics (dtype, wire format,
    model, samples): a config change that keeps every SHAPE identical
    must not silently resume stale likelihood values."""
    import dataclasses
    import warnings as _warnings

    params, model, spectra, offsets, nhis, prior_z, prior_f = problem
    mesh = make_mesh()
    cfg = ShardedRunConfig(
        per_device_batch=1, sample_chunk=32, dtype="float32",
        stream_dtype="float16", checkpoint_dir=str(tmp_path / "fp"),
    )
    process_spectra_sharded(
        model, offsets, nhis, spectra, prior_z, prior_f,
        params=params, mesh=mesh, config=cfg,
    )
    # same shapes, different wire numerics: must warn + recompute
    cfg_exact = dataclasses.replace(cfg, stream_dtype="float32")
    with pytest.warns(UserWarning, match="numerics config changed"):
        exact = process_spectra_sharded(
            model, offsets, nhis, spectra, prior_z, prior_f,
            params=params, mesh=mesh, config=cfg_exact,
        )
    fresh = process_spectra_sharded(
        model, offsets, nhis, spectra, prior_z, prior_f,
        params=params, mesh=mesh,
        config=dataclasses.replace(cfg_exact, checkpoint_dir=None),
    )
    np.testing.assert_array_equal(
        exact.sample_log_likelihoods_dla, fresh.sample_log_likelihoods_dla
    )
    # identical numerics: resume silently (no recompute warning)
    with _warnings.catch_warnings():
        _warnings.simplefilter("error")
        process_spectra_sharded(
            model, offsets, nhis, spectra, prior_z, prior_f,
            params=params, mesh=mesh, config=cfg_exact,
        )


def test_dispatch_thread_off_is_bit_identical(problem):
    """dispatch_thread only changes WHERE uploads run (a worker thread
    vs the calling thread) — results must be bit-identical, and the
    serial mode must remain available (it is forced on multi-controller
    runs, where collective issuance order must match across
    processes)."""
    params, model, spectra, offsets, nhis, prior_z, prior_f = problem
    mesh = make_mesh()
    outs = []
    for threaded in (True, False):
        cfg = ShardedRunConfig(
            per_device_batch=2, sample_chunk=32, dtype="float64",
            dispatch_thread=threaded, pipeline_depth=3,
        )
        outs.append(
            process_spectra_sharded(
                model, offsets, nhis, spectra, prior_z, prior_f,
                params=params, mesh=mesh, config=cfg,
            )
        )
    a, b = outs
    np.testing.assert_array_equal(
        a.sample_log_likelihoods_dla, b.sample_log_likelihoods_dla
    )
    np.testing.assert_array_equal(
        a.log_likelihoods_no_dla, b.log_likelihoods_no_dla
    )
    np.testing.assert_array_equal(a.p_dlas, b.p_dlas)


@pytest.mark.parametrize(
    "dtype, digest, earlier",
    [
        # float64: the digest earlier versions wrote — their checkpoints
        # resume
        ("float64", "26ab7329a921a0b0eac3428b401d1048", True),
        # float32: earlier versions' evidence implementation differs at
        # the 1e-5 level — their checkpoints must not resume
        ("float32", "fa8b948b35a4796429d705fed5027732", False),
    ],
)
def test_checkpoint_fingerprint_across_versions(dtype, digest, earlier):
    from gp_dla_detection.models.qso_model import GPModel
    from gp_dla_detection.parallel.sharded_inference import run_fingerprint

    grid = Parameters().null_model.rest_wavelengths()
    model = GPModel(
        rest_wavelengths=grid, mu=np.ones(grid.size),
        M=np.full((grid.size, 2), 0.1), log_omega=np.zeros(grid.size),
        log_c_0=-2.0, log_tau_0=-6.0, log_beta=1.3,
    )
    fp = run_fingerprint(
        np.dtype(dtype), ShardedRunConfig(dtype=dtype), Parameters(), model,
        np.linspace(0, 1, 5), np.full(5, 1e21), extra=(np.array([2.5, 3.0]),),
    )
    assert (fp == digest) is earlier
