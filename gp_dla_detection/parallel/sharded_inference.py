"""Multi-chip sharded inference with checkpoint/resume.

Replaces the reference's "run several MATLAB jobs with sliced test_ind
and save everything at the very end" workflow (process_qsos.m:51-54,
:234-249 — a crash loses the whole run) with:

  - spectra sharded across the mesh 'data' axis, QMC samples optionally
    across the 'sample' axis; XLA inserts the logsumexp all-reduce and
    the result gather,
  - fixed-size super-batches (per_device_batch * n_data_shards) jitted
    once and streamed,
  - per-super-batch result files + a JSON manifest, so an interrupted
    run resumes from the last completed batch (idempotent).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import jax
import numpy as np

from ..inference import (
    InferenceResults,
    PaddedSpectra,
    batch_log_likelihoods,
    compute_sample_window,
    dla_rate_priors,
    finalize_posteriors,
)
from ..models.qso_model import GPModel
from ..params import Parameters
from .mesh import (
    DATA_AXIS,
    data_sharding,
    fetch_global,
    is_coordinator,
    make_mesh,
    replicated,
    sample_sharding,
)
from .streaming import (
    checkpoint_payload,
    pack_lean,
    pack_rows,
    reconstruct_rows,
    rows_from_checkpoint,
)

__all__ = [
    "process_spectra_sharded",
    "ShardedRunConfig",
    "run_fingerprint",
    "single_evaluator",
]


def run_fingerprint(dtype, config, params, model, offsets, nhis, extra=()):
    """Hash of everything that determines the checkpointed VALUES.

    Stored in the batch manifest so a resume only trusts checkpoints
    whose numerics match: run dtype, wire format, the windowing/chunking
    config, the physical parameters, the learned model arrays, and the
    QMC sample set.  Shape checks alone miss all of these.  Mesh layout
    and pipeline depth are deliberately EXCLUDED: both are proven
    value-identical, so a run may resume on different parallelism.
    """
    import hashlib

    h = hashlib.md5()
    # float64 digests are those of earlier versions ("xla" included),
    # whose float64 values are the same; float32 values depend on the
    # evidence implementation at the 1e-5 level, so the float32 token
    # names the current one and earlier float32 checkpoints never mix in
    f32v = "|f32:xla-gpu" if np.dtype(dtype) == np.float32 else ""
    h.update(
        f"{np.dtype(dtype)}|{config.stream_dtype}|xla|"
        f"{config.windowed_voigt}|{config.sample_chunk}|"
        # getattr: pair-stage callers fingerprint with a minimal config
        # namespace (multi_dla.py) that always stores the matrix
        f"{getattr(config, 'store_sample_likelihoods', True)}{f32v}".encode()
    )
    h.update(params.to_json().encode())
    for a in (
        model.rest_wavelengths, model.mu, model.M, model.log_omega,
        [model.log_c_0, model.log_tau_0, model.log_beta],
        offsets, nhis, *extra,
    ):
        a = np.ascontiguousarray(np.asarray(a, np.float64))
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


@dataclass
class ShardedRunConfig:
    per_device_batch: int = 64
    sample_chunk: int = 2500
    dtype: str = "float32"
    checkpoint_dir: str | None = None
    # opt-in z-sorted windowed Voigt (see ops/voigt.voigt_absorption_windowed)
    windowed_voigt: bool = False
    # wire format for the (B, num_samples) result matrices (see
    # parallel/streaming.py): "float16" (default; halves the bytes
    # fetched and checkpointed, lossless where posterior weight
    # survives) | "bfloat16" | "float32" (exact opt-out).  f64 runs are
    # never narrowed.
    stream_dtype: str | None = "float16"
    # max super-batches in flight on the device (parallel/overlap.py):
    # 2 = double buffering (batch i+1 computes while batch i's results
    # drain through the fetch); 1 = serial
    pipeline_depth: int = 4
    # dispatch from a dedicated thread so host->device uploads overlap
    # with result fetches; False serializes them on the calling thread
    dispatch_thread: bool = True
    # False = "lean" catalog-only mode: the (B, num_samples) matrices
    # are reduced ON DEVICE to per-spectrum evidence + MAP sample index
    # (streaming.pack_lean) and never fetched or stored — results carry
    # sample_log_likelihoods_dla=None and checkpoints shrink from
    # ~20 MB/batch to a few KB.  Everything the reference's DLA catalog
    # output needs survives (process_qsos.m:235-243 consumers that
    # only read evidences/posteriors/MAP); the two-DLA stage and the
    # CDDF analysis need the matrix and raise a clear error on lean
    # results.
    store_sample_likelihoods: bool = True
    # base-axis draw layout for the FUSED LEAN two-stage driver
    # (store_sample_likelihoods=False): R > 1 = each posterior base draw
    # is shared by R pair columns of every 256-column block
    # (multi_dla.replicate_draw_pattern) — an R-coarser stratification
    # of the base axis, still an unbiased inverse-CDF posterior
    # resample.  None (default) = 1, the classic one-draw-per-column
    # resample.  Each R fingerprints its checkpoints separately, so a
    # run started with R > 1 must resume with the same R.  Ignored by
    # the single-DLA driver; the classic (matrix-storing) two-stage
    # driver rejects values != 1.
    base_replicates: int | None = None
    # lean runs only: additionally reduce the CDDF/dN_dX/Omega_DLA
    # inputs ON DEVICE (cddf_inputs.py) so the L7 science statistics
    # run from a lean result — binned small-probability masses, exact
    # top-k entries, and N_HI moment histograms (~12 KB/spectrum on the
    # wire vs the classic path's full f16 matrix).  Classic
    # (store_sample_likelihoods=True) runs reject the flag: they
    # already carry the matrices the statistics marginalize.
    store_cddf_inputs: bool = False


def single_evaluator(
    model: GPModel,
    params: Parameters,
    config: "ShardedRunConfig",
    dtype,
    offset_samples,
    num_pixels_ext: int,
):
    """The jitted single-DLA batch evaluator shared by
    :func:`process_spectra_sharded` and the fused lean two-stage driver
    (parallel/sharded_multi).  Signature: (wavelengths, flux,
    noise_variance, mask, z_qso, grid, mu, M, log_omega, offsets, nhis)
    -> batch_log_likelihoods dict.  XLA partitions it over any mesh from
    the arguments' shardings."""
    window = (
        compute_sample_window(
            offset_samples, config.sample_chunk, num_pixels_ext,
            pixel_spacing=params.instrument.pixel_spacing,
        )
        if config.windowed_voigt and dtype == np.float32
        else None
    )

    def call_batch(w, f, nv, mk, zq, grid, mu_g, M_g, lo_g, off, nh):
        return batch_log_likelihoods(
            w, f, nv, mk, zq, grid, mu_g, M_g, lo_g,
            model.log_c_0, model.log_tau_0, model.log_beta, off, nh,
            params=params, sample_chunk=config.sample_chunk,
            sample_window=window,
        )

    return call_batch


def process_spectra_sharded(
    model: GPModel,
    offset_samples,
    nhi_samples,
    spectra: PaddedSpectra,
    prior_z_qsos,
    prior_dla_flags,
    params: Parameters | None = None,
    mesh=None,
    config: ShardedRunConfig | None = None,
    progress: bool = False,
) -> InferenceResults:
    """Sharded equivalent of :func:`gp_dla_detection.inference.process_spectra`.

    Runs on whatever mesh is provided (defaults to all local devices,
    pure data parallelism).  Resumable via config.checkpoint_dir.
    """
    if params is None:
        params = Parameters()
    if config is None:
        config = ShardedRunConfig()
    if mesh is None:
        mesh = make_mesh()
    from ..inference import resolve_dtype

    dtype = np.dtype(resolve_dtype(config.dtype, "process_spectra_sharded"))
    if config.store_cddf_inputs:
        if config.store_sample_likelihoods:
            raise ValueError(
                "store_cddf_inputs is a lean-mode feature: classic "
                "(store_sample_likelihoods=True) runs already carry the "
                "full matrices the CDDF statistics marginalize"
            )
        raise NotImplementedError(
            "device-reduced CDDF inputs are produced by the fused "
            "two-stage lean driver (process_spectra_multi_sharded with "
            "store_sample_likelihoods=False) — the reference's published "
            "statistics consume the multi-DLA posterior format "
            "(calc_cddf.py:102-116), which needs the pair stage"
        )

    n_data = mesh.shape[DATA_AXIS]
    super_batch = config.per_device_batch * n_data
    n = len(spectra)
    num_samples = len(np.asarray(offset_samples))

    # priors are host-side and cheap: compute for all spectra up front
    log_p_dla, log_p_no_dla = dla_rate_priors(
        spectra.z_qso, prior_z_qsos, prior_dla_flags, params
    )

    data_spec = data_sharding(mesh)
    data_spec2 = data_sharding(mesh, 1)
    repl = replicated(mesh)
    sample_spec = sample_sharding(mesh)

    model_args = (
        jax.device_put(np.asarray(model.rest_wavelengths, dtype), repl),
        jax.device_put(np.asarray(model.mu, dtype), repl),
        jax.device_put(np.asarray(model.M, dtype), repl),
        jax.device_put(np.asarray(model.log_omega, dtype), repl),
        jax.device_put(np.asarray(offset_samples, dtype), sample_spec),
        jax.device_put(np.asarray(nhi_samples, dtype), sample_spec),
    )

    ckpt_dir = Path(config.checkpoint_dir) if config.checkpoint_dir else None
    manifest_path = ckpt_dir / "manifest.json" if ckpt_dir else None
    # only trust checkpoints from a run with the same shape AND the same
    # numerics: shapes alone miss config changes that alter the stored
    # values without altering any dimension (dtype, stream_dtype,
    # num_lines, the model/sample arrays themselves) — those must not
    # silently resume stale likelihoods either.  Checkpoints are
    # independent of the mesh layout, so a run may resume on a different
    # mesh.  z_qso stands in for the test selection: a different-but-
    # equal-sized set of sightlines (e.g. a changed test mask) must not
    # resume the old set's batches.
    fingerprint = run_fingerprint(
        dtype, config, params, model,
        np.asarray(offset_samples, dtype), np.asarray(nhi_samples, dtype),
        extra=(spectra.z_qso,),
    )
    done: set[int] = set()
    if manifest_path and manifest_path.exists():
        manifest = json.loads(manifest_path.read_text())
        if (
            manifest.get("num_spectra") == n
            and manifest.get("super_batch") == super_batch
            and manifest.get("num_samples") == num_samples
            and manifest.get("fingerprint") == fingerprint
        ):
            done = set(manifest["completed_batches"])
        else:
            import warnings

            warnings.warn(
                f"ignoring incompatible inference checkpoints in "
                f"{ckpt_dir} (run shape or numerics config changed)",
                stacklevel=2,
            )
    if ckpt_dir:
        ckpt_dir.mkdir(parents=True, exist_ok=True)

    lean = not config.store_sample_likelihoods
    if lean and num_samples >= 1 << 24:
        # the MAP index rides the stacked small-vector fetch as float32
        raise ValueError(
            f"lean mode supports < 2**24 samples (got {num_samples})"
        )
    out_null = np.empty(n)
    # the (N, S) sample matrix is the dominant host-memory term at
    # survey scale (162k x 10k f32 = 6.5 GB; f64 would double it for
    # values computed at the run dtype anyway) — store at that dtype.
    # Lean runs never materialize it at all.
    out_samples = (
        None if lean else np.empty((n, num_samples), np.dtype(dtype))
    )
    out_evidence = np.empty(n) if lean else None
    out_map = np.empty(n, np.int64) if lean else None
    out_min_z = np.empty(n)
    out_max_z = np.empty(n)

    from ..utils import ProgressMeter

    num_pixels_ext = spectra.wavelengths.shape[1] + 2 * params.instrument.width
    evaluate = jax.jit(
        single_evaluator(
            model, params, config, dtype, offset_samples, num_pixels_ext
        )
    )

    meter = ProgressMeter(n, unit="spectra") if progress else None
    batch_starts = list(range(0, n, super_batch))
    todo: list[tuple[int, int, int, Path | None]] = []
    for bi, start in enumerate(batch_starts):
        stop = min(start + super_batch, n)
        ckpt_file = ckpt_dir / f"batch_{bi:06d}.npz" if ckpt_dir else None
        if bi in done and ckpt_file and ckpt_file.exists():
            with np.load(ckpt_file) as f:
                out_null[start:stop] = f["log_likelihood_no_dla"]
                if lean:
                    # lean checkpoints store the device-reduced vectors
                    # (the matrix never existed on the host)
                    out_evidence[start:stop] = f["log_likelihood_dla"]
                    out_map[start:stop] = f["map_sample_ind"]
                else:
                    # wire-format checkpoints reconstruct exactly as the
                    # live fetch path does (bit-identical resume)
                    out_samples[start:stop] = rows_from_checkpoint(
                        f, "sample_ll_resid", "sample_ll_row_max",
                        "sample_log_likelihoods_dla",
                    )
                out_min_z[start:stop] = f["min_z_dla"]
                out_max_z[start:stop] = f["max_z_dla"]
            if meter is not None:
                meter.update(stop - start)
            continue
        todo.append((bi, start, stop, ckpt_file))

    # Compute/transfer overlap (see parallel/overlap.py): dispatch batch
    # i+1 before fetching batch i's results, and push checkpoint writes
    # to a background thread.  Replaces the reference's serial per-quasar
    # loop + end-only save (process_qsos.m:88-220, :234-249).
    from .overlap import (
        BackgroundWriter,
        atomic_savez,
        atomic_write_json,
        run_pipelined_split,
    )
    import jax.numpy as jnp

    def pack(out):
        # enqueue the f16 wire-format packing NOW, directly behind this
        # batch's main computation on the device queue — packing at
        # fetch time would run after the NEXT batch's compute and stall
        # the pipeline (single device stream).  The per-spectrum vectors
        # (null evidence, z range, wire row max) are stacked into ONE
        # device array, so each batch pays one small transfer instead of
        # four.  Mixed dtypes (f64 parity mode keeps evidences f64
        # while z ranges may be f32) promote for the stack and are cast
        # back exactly on the host — float widening round-trips bit-for-
        # bit, so checkpoints stay identical to the unstacked format.
        small = [
            out["log_likelihood_no_dla"],
            out["min_z_dla"],
            out["max_z_dla"],
        ]
        if lean:
            # catalog-only mode: reduce the matrix ON DEVICE to the
            # evidence + MAP index and drop it — nothing (B, S)-sized
            # ever crosses the wire or touches the host
            evidence, map_f32 = pack_lean(
                out["sample_log_likelihoods_dla"]
            )
            tag, wire = "lean", None
            small += [evidence, map_f32]
        else:
            rows = pack_rows(
                out["sample_log_likelihoods_dla"], config.stream_dtype
            )
            tag, wire = rows[0], rows[1]
            if tag == "packed":
                small.append(rows[2])  # f32 row max rides the stack
        dtypes = tuple(a.dtype for a in small)
        wide = jnp.result_type(*dtypes)
        stacked = jnp.stack([a.astype(wide) for a in small])
        return tag, wire, stacked, dtypes

    import time as _time

    from ..utils import env_flag

    timing = env_flag("GPDLA_DRIVER_TIMING")

    def upload(item):
        # host slice/pad + device_put ONLY — no collectives, safe on the
        # upload thread in multi-controller runs (overlap.py)
        bi, start, stop, ckpt_file = item
        t0 = _time.perf_counter()
        batch = spectra.slice(slice(start, stop)).pad_to(super_batch)
        t1 = _time.perf_counter()
        args = (
            jax.device_put(np.asarray(batch.wavelengths, dtype), data_spec2),
            jax.device_put(np.asarray(batch.flux, dtype), data_spec2),
            jax.device_put(np.asarray(batch.noise_variance, dtype), data_spec2),
            jax.device_put(np.asarray(batch.mask), data_spec2),
            jax.device_put(np.asarray(batch.z_qso, dtype), data_spec),
            *model_args,
        )
        if timing:
            print(
                f"[driver] batch {bi}: slice {t1 - t0:.3f}s "
                f"device_put {_time.perf_counter() - t1:.3f}s",
                flush=True,
            )
        return args

    def issue(item, args):
        bi = item[0]
        t0 = _time.perf_counter()
        out = pack(evaluate(*args))
        if timing:
            print(
                f"[driver] batch {bi}: dispatch "
                f"{_time.perf_counter() - t0:.3f}s",
                flush=True,
            )
        return out

    def fetch(packed):
        tag, wire, stacked, dtypes = packed
        smalls = fetch_global(stacked)
        small = [
            np.asarray(smalls[i], dtype=dt) for i, dt in enumerate(dtypes)
        ]
        if tag == "plain":
            rows_host = ("plain", fetch_global(wire))
        elif tag == "packed":
            rows_host = ("packed", fetch_global(wire), small[3])
        else:  # lean: no wire matrix; vectors rode the small stack
            rows_host = ("lean", small[3], small[4])
        return small[0], rows_host, small[1], small[2]

    def write_checkpoint(ckpt_file, bi, null_ll, rows_host, min_z, max_z):
        # multi-process runs: one writer (process 0); every process
        # holds the full gathered results, so resume only needs the
        # checkpoint files visible from each host (shared fs).
        # Checkpoints keep the f16 wire format (resid + row max) when
        # the run streamed one — half the bytes, no recompression of
        # high-entropy data — and skip zlib entirely (atomic_io note).
        # Lean checkpoints store just the device-reduced vectors.
        if rows_host[0] == "lean":
            payload = {
                "log_likelihood_dla": rows_host[1],
                "map_sample_ind": rows_host[2],
            }
        else:
            payload = checkpoint_payload(
                rows_host, "sample_ll_resid", "sample_ll_row_max",
                "sample_log_likelihoods_dla",
            )
        atomic_savez(
            ckpt_file,
            compress=False,
            log_likelihood_no_dla=null_ll,
            min_z_dla=min_z,
            max_z_dla=max_z,
            **payload,
        )
        done.add(bi)
        atomic_write_json(
            manifest_path,
            {
                "completed_batches": sorted(done),
                "total_batches": len(batch_starts),
                "num_spectra": n,
                "super_batch": super_batch,
                "num_samples": num_samples,
                "fingerprint": fingerprint,
            },
        )

    with BackgroundWriter() as writer:

        def finish_batch(bi, start, stop, ckpt_file, null_ll, rows_host,
                         min_z, max_z):
            """Runs on the writer thread: f16->f32 reconstruction, the
            40 MB result-array stores, and the checkpoint write.  Batch
            row ranges are disjoint, and finalize_posteriors runs only
            after writer.close(), so this is race-free — and it removes
            ~1 s/batch of host work from the dispatch/fetch critical
            path (measured via GPDLA_DRIVER_TIMING)."""
            keep = stop - start
            if rows_host[0] == "lean":
                # vectors, not a matrix: the evidence is column-order-
                # invariant; the MAP index was taken in z-sorted sample
                # space when the sample axis is sharded — translate it
                # back to the original sample numbering
                evidence = np.asarray(rows_host[1][:keep], np.float64)
                map_idx = np.asarray(rows_host[2][:keep]).astype(np.int64)
                # pack_lean flags a row with no finite sample as -1; the
                # catalog falls back to sample 0 (ascii_catalog semantics)
                map_idx[map_idx < 0] = 0
                rows_host = ("lean", evidence, map_idx)
            if rows_host[0] != "lean":
                rows_host = tuple(
                    a[:keep] if isinstance(a, np.ndarray) else a
                    for a in rows_host
                )
            null_ll = null_ll[:keep]
            min_z, max_z = min_z[:keep], max_z[:keep]
            out_null[start:stop] = null_ll
            if rows_host[0] == "lean":
                out_evidence[start:stop] = rows_host[1]
                out_map[start:stop] = rows_host[2]
            else:
                out_samples[start:stop] = reconstruct_rows(rows_host)
            out_min_z[start:stop] = min_z
            out_max_z[start:stop] = max_z
            if ckpt_file and is_coordinator():
                write_checkpoint(
                    ckpt_file, bi, null_ll, rows_host, min_z, max_z
                )

        def complete(item, state):
            bi, start, stop, ckpt_file = item
            t0 = _time.perf_counter()
            null_ll, rows_host, min_z, max_z = fetch(state)
            t_fetch = _time.perf_counter() - t0
            writer.submit(
                finish_batch,
                bi, start, stop, ckpt_file, null_ll, rows_host,
                min_z, max_z,
            )
            if timing:
                print(
                    f"[driver] batch {bi}: fetch {t_fetch:.3f}s "
                    f"submit {_time.perf_counter() - t0 - t_fetch:.3f}s",
                    flush=True,
                )
            if meter is not None:
                meter.update(stop - start)

        # uploads ride a side thread; compute issuance and the
        # collective-bearing fetches stay on the main thread in the
        # serial path's exact program order, so multi-controller runs
        # keep identical collective issuance order on every process
        # (run_pipelined_split) — threading is no longer forced off at
        # process_count > 1
        run_pipelined_split(
            todo, upload, issue, complete, depth=config.pipeline_depth,
            threaded=config.dispatch_thread,
        )

    if lean:
        from ..inference import posteriors_from_evidence

        post = posteriors_from_evidence(
            log_p_no_dla, log_p_dla, out_null, out_evidence
        )
    else:
        post = finalize_posteriors(
            log_p_no_dla, log_p_dla, out_null, out_samples
        )
    return InferenceResults(
        min_z_dlas=out_min_z,
        max_z_dlas=out_max_z,
        log_priors_no_dla=log_p_no_dla,
        log_priors_dla=log_p_dla,
        log_likelihoods_no_dla=out_null,
        log_likelihoods_dla=post["log_likelihoods_dla"],
        sample_log_likelihoods_dla=out_samples,
        map_sample_inds=out_map,
        log_posteriors_no_dla=post["log_posteriors_no_dla"],
        log_posteriors_dla=post["log_posteriors_dla"],
        model_posteriors=post["model_posteriors"],
        p_no_dlas=post["p_no_dlas"],
        p_dlas=post["p_dlas"],
    )
