"""Multi-chip sharded {0, 1, 2}-DLA model selection.

The sharded analogue of multi_dla.process_spectra_multi, mirroring
sharded_inference.process_spectra_sharded: spectra across the mesh
'data' axis, fixed-size super-batches jitted once, per-batch
checkpoints with shape-validated manifests.  The single-DLA stage runs
through process_spectra_sharded (checkpointed under <ckpt>/single),
the pair stage under <ckpt>/pair; both resume independently.
"""

from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from ..inference import resolve_dtype
from ..models.qso_model import GPModel
from ..multi_dla import (
    REPLICATE_TILE,
    MultiDLAResults,
    finalize_multi,
    make_base_sample_inds,
    make_batch_dla2_fn,
    packed_base_tables,
)
from ..params import Parameters, kms_to_z
from .mesh import (
    DATA_AXIS,
    data_sharding,
    fetch_global,
    is_coordinator,
    make_mesh,
    replicated,
    sample_sharding,
)
from .sharded_inference import (
    ShardedRunConfig,
    process_spectra_sharded,
    run_fingerprint,
)
from .streaming import checkpoint_payload, rows_from_checkpoint

__all__ = ["process_spectra_multi_sharded"]


def process_spectra_multi_sharded(
    model: GPModel,
    offset_samples,
    nhi_samples,
    spectra,
    prior_z_qsos,
    prior_num_dlas,
    params: Parameters | None = None,
    mesh=None,
    config: ShardedRunConfig | None = None,
    progress: bool = False,
    min_separation_kms: float = 3000.0,
    base_seed: int = 0,
    single=None,
) -> MultiDLAResults:
    """Sharded two-DLA model selection.

    ``single``: precomputed InferenceResults to reuse; otherwise the
    single-DLA stage runs sharded (checkpointed under
    config.checkpoint_dir/single when set).
    """
    if params is None:
        params = Parameters()
    if config is None:
        config = ShardedRunConfig()
    if mesh is None:
        mesh = make_mesh()
    dtype = np.dtype(resolve_dtype(config.dtype, "process_spectra_multi_sharded"))

    if not config.store_sample_likelihoods:
        # lean (catalog-only) two-stage: the FUSED driver evaluates both
        # stages per super-batch and resamples the base absorber on
        # device, so the (B, S) matrices never cross the wire
        if single is not None:
            raise ValueError(
                "the fused lean two-stage driver recomputes the single "
                "stage on device per batch (the base resampler needs the "
                "sample matrix, which lean results never store) — drop "
                "`single`, or use store_sample_likelihoods=True to reuse "
                "a precomputed full single-stage result"
            )
        return _process_multi_lean_fused(
            model, offset_samples, nhi_samples, spectra,
            prior_z_qsos, prior_num_dlas, params, mesh, config,
            progress, min_separation_kms, base_seed,
        )
    if config.base_replicates not in (None, 1):
        raise ValueError(
            "base_replicates > 1 is a fused-lean-driver feature "
            "(store_sample_likelihoods=False): the classic pair stage "
            "resamples on the host and stores the full (N, S) base "
            "index matrix"
        )
    if config.store_cddf_inputs:
        raise ValueError(
            "store_cddf_inputs is a lean-mode feature: classic "
            "(store_sample_likelihoods=True) runs already carry the "
            "full matrices the CDDF statistics marginalize"
        )
    # fail at config time, not after an hours-long single stage: the
    # CLASSIC pair stage resamples base absorbers from the single-stage
    # sample matrix on the host, which a lean precomputed result never
    # stores (same guard as the single-host process_spectra_multi)
    if single is not None and single.sample_log_likelihoods_dla is None:
        raise ValueError(
            "two-stage {0,1,2}-DLA selection resamples the base absorber "
            "from the single-stage sample likelihoods, which a lean "
            "(catalog-only) run never stores — pass a non-lean "
            "precomputed `single`, or drop both `single` and "
            "store_sample_likelihoods to run the fused lean driver"
        )

    offsets = np.asarray(offset_samples)
    nhis = np.asarray(nhi_samples)
    S = len(offsets)
    n = len(spectra)
    ckpt_root = Path(config.checkpoint_dir) if config.checkpoint_dir else None

    if single is None:
        import dataclasses

        single = process_spectra_sharded(
            model, offsets, nhis, spectra,
            prior_z_qsos, np.asarray(prior_num_dlas) >= 1,
            params=params, mesh=mesh,
            config=dataclasses.replace(
                config,
                checkpoint_dir=str(ckpt_root / "single") if ckpt_root else None,
            ),
            progress=progress,
        )
    elif len(single.p_dlas) != n or single.sample_log_likelihoods_dla.shape[1] != S:
        raise ValueError(
            "precomputed single-DLA results do not match these spectra/"
            f"samples: {single.sample_log_likelihoods_dla.shape} vs ({n}, {S})"
        )

    base = make_base_sample_inds(single.sample_log_likelihoods_dla, seed=base_seed)
    min_sep_z = kms_to_z(min_separation_kms)

    evaluate = make_batch_dla2_fn(
        model, params, S, config.sample_chunk, min_sep_z
    )

    n_data = mesh.shape[DATA_AXIS]
    super_batch = config.per_device_batch * n_data
    repl = replicated(mesh)
    data_spec = data_sharding(mesh)
    data_spec2 = data_sharding(mesh, 1)
    # the fresh sample axis rides the 'sample' mesh axis
    samp = sample_sharding(mesh)

    # per-batch base indices (the host draw is the bit-matched f64
    # resample; only the INDICES cross to the device — uint16 is a
    # quarter of two (B, S) f32 value arrays — and the values come from
    # one packed (S, 2)-row device gather, bit-identical to
    # host-gathered values)
    base_index_dtype = np.uint16 if S <= np.iinfo(np.uint16).max + 1 else np.int32

    def base_slice(start, stop):
        return base[start:stop].astype(base_index_dtype)

    model_args = (
        jax.device_put(np.asarray(model.rest_wavelengths, dtype), repl),
        jax.device_put(np.asarray(model.mu, dtype), repl),
        jax.device_put(np.asarray(model.M, dtype), repl),
        jax.device_put(np.asarray(model.log_omega, dtype), repl),
    )
    off_j = jax.device_put(np.asarray(offsets, dtype), samp)
    nh_j = jax.device_put(np.asarray(nhis, dtype), samp)
    base_tables = jax.device_put(packed_base_tables(offsets, nhis, dtype), repl)

    @jax.jit
    def base_values(cols):
        """Base (z, N_HI) values from uploaded indices via the shared
        packed-row gather (multi_dla.packed_base_tables)."""
        vals = base_tables[cols.astype(jnp.int32)]
        return vals[..., 0], vals[..., 1]

    ckpt_dir = ckpt_root / "pair" if ckpt_root else None
    manifest_path = ckpt_dir / "manifest.json" if ckpt_dir else None
    # shape + numerics fingerprint (see run_fingerprint): the pair stage
    # additionally depends on the separation cut and on the resampled
    # base indices (which encode base_seed AND the single-stage
    # likelihoods they were drawn from)
    fingerprint = run_fingerprint(
        dtype, config, params, model, offsets, nhis,
        extra=([min_sep_z], base, spectra.z_qso),
    )
    done: set = set()
    if manifest_path and manifest_path.exists():
        manifest = json.loads(manifest_path.read_text())
        if (
            manifest.get("num_spectra") == n
            and manifest.get("super_batch") == super_batch
            and manifest.get("num_samples") == S
            and manifest.get("base_seed") == base_seed
            and manifest.get("fingerprint") == fingerprint
        ):
            done = set(manifest["completed_batches"])
        else:
            import warnings

            warnings.warn(
                f"ignoring incompatible two-DLA checkpoints in {ckpt_dir} "
                "(run shape or numerics config changed)",
                stacklevel=2,
            )
    if ckpt_dir:
        ckpt_dir.mkdir(parents=True, exist_ok=True)

    from ..utils import ProgressMeter

    out2 = np.empty((n, S), dtype)
    meter = ProgressMeter(n, unit="spectra") if progress else None
    todo: list[tuple[int, int, int, Path | None]] = []
    for bi, start in enumerate(range(0, n, super_batch)):
        stop = min(start + super_batch, n)
        ckpt_file = ckpt_dir / f"batch_{bi:06d}.npz" if ckpt_dir else None
        if bi in done and ckpt_file and ckpt_file.exists():
            with np.load(ckpt_file) as f:
                out2[start:stop] = rows_from_checkpoint(
                    f, "dla2_resid", "dla2_row_max",
                    "sample_log_likelihoods_dla2",
                )
            if meter is not None:
                meter.update(stop - start)
            continue
        todo.append((bi, start, stop, ckpt_file))

    # compute/transfer overlap + background checkpoint writes, exactly
    # as in process_spectra_sharded (see parallel/overlap.py)
    from .overlap import (
        BackgroundWriter,
        atomic_savez,
        atomic_write_json,
        run_pipelined_split,
    )
    from .streaming import fetch_packed_host, pack_rows, reconstruct_rows

    def upload(item):
        # host slice/pad + device_put only (no collectives; overlap.py)
        bi, start, stop, ckpt_file = item
        batch = spectra.slice(slice(start, stop)).pad_to(super_batch)
        pad_rows = super_batch - (stop - start)
        cols = base_slice(start, stop)
        if pad_rows:
            cols = np.concatenate(
                [cols, np.repeat(cols[-1:], pad_rows, axis=0)]
            )
        cols_dev = jax.device_put(np.ascontiguousarray(cols), data_spec2)
        return cols_dev, (
            jax.device_put(np.asarray(batch.wavelengths, dtype), data_spec2),
            jax.device_put(np.asarray(batch.flux, dtype), data_spec2),
            jax.device_put(np.asarray(batch.noise_variance, dtype), data_spec2),
            jax.device_put(np.asarray(batch.mask), data_spec2),
            jax.device_put(np.asarray(batch.z_qso, dtype), data_spec),
        )

    def issue(item, uploaded):
        # base_values is a jit call over the mesh — main thread only
        cols_dev, batch_args = uploaded
        ob, nb = base_values(cols_dev)
        # pack the f16 wire format at dispatch time (device queue order;
        # see sharded_inference)
        raw = evaluate(*batch_args, *model_args, off_j, nh_j, ob, nb)
        return pack_rows(raw, config.stream_dtype)

    def write_checkpoint(ckpt_file, bi, rows_host):
        # f16 wire format when streamed; no zlib (see sharded_inference)
        payload = checkpoint_payload(
            rows_host, "dla2_resid", "dla2_row_max",
            "sample_log_likelihoods_dla2",
        )
        atomic_savez(ckpt_file, compress=False, **payload)
        done.add(bi)
        atomic_write_json(
            manifest_path,
            {
                "num_spectra": n,
                "super_batch": super_batch,
                "num_samples": S,
                "base_seed": base_seed,
                "fingerprint": fingerprint,
                "completed_batches": sorted(done),
            },
        )

    with BackgroundWriter() as writer:

        def finish_batch(bi, start, stop, ckpt_file, rows_host):
            """Writer-thread work (see sharded_inference.finish_batch):
            trim batch padding, reconstruct into the disjoint result
            rows, checkpoint."""
            keep = stop - start
            rows_host = tuple(
                a[:keep] if isinstance(a, np.ndarray) else a
                for a in rows_host
            )
            out2[start:stop] = reconstruct_rows(rows_host)
            if ckpt_file and is_coordinator():
                write_checkpoint(ckpt_file, bi, rows_host)

        def complete(item, state):
            bi, start, stop, ckpt_file = item
            rows_host = fetch_packed_host(state)
            writer.submit(finish_batch, bi, start, stop, ckpt_file, rows_host)
            if meter is not None:
                meter.update(stop - start)

        # uploads on a side thread; collective issuance (base_values,
        # evaluator call, fetch_global) stays in serial program order on
        # the main thread — multi-controller-safe (overlap.py)
        run_pipelined_split(
            todo, upload, issue, complete, depth=config.pipeline_depth,
            threaded=config.dispatch_thread,
        )

    return finalize_multi(
        single, out2, base, spectra.z_qso, prior_z_qsos, prior_num_dlas,
        params,
    )


def _process_multi_lean_fused(
    model: GPModel,
    offset_samples,
    nhi_samples,
    spectra,
    prior_z_qsos,
    prior_num_dlas,
    params: Parameters,
    mesh,
    config: ShardedRunConfig,
    progress: bool,
    min_separation_kms: float,
    base_seed: int,
) -> MultiDLAResults:
    """Fused lean two-stage {0,1,2}-DLA selection: ONE pass per
    super-batch.

    Per batch, entirely on device: single-DLA sample likelihoods ->
    (evidence, MAP) reductions AND inverse-CDF base-absorber resampling
    (multi_dla.device_base_sample_inds) -> base (z, N_HI) gather ->
    two-DLA pair likelihoods -> (pair evidence, MAP pair, MAP base)
    reductions.  Only eight per-spectrum vectors ever cross the wire
    (one stacked fetch), replacing the classic two-pass flow's
    per-batch (B, S) f16 matrix fetches AND its two (B, S) f32
    base-value uploads — the pair stage's dominant transfers.

    Trade-offs vs the classic path (store_sample_likelihoods=True):
      - no (N, S) matrices: CDDF analysis and .mat export raise
        (catalog consumers — evidences, posteriors, MAPs — all work);
      - the base draw runs at the compute dtype with XLA's cumsum
        association (see device_base_sample_inds) — identically
        distributed but not bit-matched to the host resampler;
      - one checkpoint stream (a few KB/batch) covers both stages.

    Replaces process_qsos.m:88-220's per-quasar loop for the
    multiplicity-catalog use case; format per calc_cddf.py:102-116.
    """
    from ..inference import (
        InferenceResults,
        dla_rate_priors,
        posteriors_from_evidence,
    )
    from ..multi_dla import (
        base_sample_perm,
        device_inverse_cdf_grid,
        finalize_multi_from_evidence,
        pack_lean_pair,
        replicate_draw_pattern,
    )
    from ..utils import ProgressMeter
    from .overlap import (
        BackgroundWriter,
        atomic_savez,
        atomic_write_json,
        run_pipelined_split,
    )
    from .sharded_inference import single_evaluator
    from .streaming import pack_lean

    dtype = np.dtype(resolve_dtype(config.dtype, "process_spectra_multi_sharded"))

    offsets = np.asarray(offset_samples)
    nhis = np.asarray(nhi_samples)
    S = len(offsets)
    if S >= 1 << 24:
        raise ValueError(
            f"lean mode supports < 2**24 samples (got {S}): MAP indices "
            "ride the stacked small-vector fetch as float32"
        )
    n = len(spectra)
    n_data = mesh.shape[DATA_AXIS]
    super_batch = config.per_device_batch * n_data
    min_sep_z = kms_to_z(min_separation_kms)
    num_pixels_ext = spectra.wavelengths.shape[1] + 2 * params.instrument.width

    # priors are host-side and cheap: both the 1-DLA counting prior and
    # the extended multiplicity prior come from the same prior catalog
    prior_num = np.asarray(prior_num_dlas)
    log_p_dla, log_p_no_dla = dla_rate_priors(
        spectra.z_qso, prior_z_qsos, prior_num >= 1, params
    )

    repl = replicated(mesh)
    data_spec = data_sharding(mesh)
    data_spec2 = data_sharding(mesh, 1)

    # ---- the two stage evaluators ----
    fn1 = single_evaluator(
        model, params, config, dtype, offsets, num_pixels_ext
    )
    fn2 = make_batch_dla2_fn(
        model, params, S, config.sample_chunk, min_sep_z
    )

    R = 1 if config.base_replicates is None else config.base_replicates
    if R not in (1, 2, 4, 8):
        raise ValueError(
            f"base_replicates must be 1, 2, 4, or 8 (got {R}): each base "
            f"draw is shared by R pair columns of every {REPLICATE_TILE}-"
            "column block (multi_dla.replicate_draw_pattern)"
        )

    # ---- device-resident sample tables ----
    model_args = (
        jax.device_put(np.asarray(model.rest_wavelengths, dtype), repl),
        jax.device_put(np.asarray(model.mu, dtype), repl),
        jax.device_put(np.asarray(model.M, dtype), repl),
        jax.device_put(np.asarray(model.log_omega, dtype), repl),
    )
    off_j = jax.device_put(np.asarray(offsets, dtype), repl)
    nh_j = jax.device_put(np.asarray(nhis, dtype), repl)
    # the base resample reads the search-free grid inverse-CDF at the
    # static grid permutation; index VALUES are original sample numbers
    if R == 1:
        base_cols_perm = base_sample_perm(S, base_seed)
        grid_size = S
    else:
        # base-replicated draws: pair column p takes draw slot
        # draw_idx[p], each slot a distinct grid quantile of the
        # n_draws-point shuffled grid
        draw_idx, grid_size = replicate_draw_pattern(S, REPLICATE_TILE, R)
        base_cols_perm = base_sample_perm(grid_size, base_seed)[draw_idx]
    cols_dev = jax.device_put(np.asarray(base_cols_perm, np.int32), repl)
    # base (z, N_HI) values come from the shared packed-row gather
    # (multi_dla.packed_base_tables: one (S, 2) gather, not two)
    base_tables = jax.device_put(packed_base_tables(offsets, nhis, dtype), repl)

    # ---- optional on-device CDDF-input reduction (cddf_inputs.py):
    # everything the L7 statistics marginalize from the (B, S) matrices,
    # reduced inside the same fused program ----
    store_cddf = config.store_cddf_inputs
    cddf_spec = cddf_reduce = cddf_consts = None
    n_fn1_args = 11  # (5 batch + 4 model + off + nh) = fn1's args
    if store_cddf:
        from ..cddf_inputs import CDDFReductionSpec, make_cddf_reducer
        from ..multi_dla import multi_dla_rate_priors

        cddf_spec = CDDFReductionSpec()
        # the reduction's lnhi tables come from log10 of the linear
        # N_HI samples — within 1 ulp of the stored log_nhi_samples the
        # host statistics rebind against (knife-edge-only difference)
        cddf_reduce, cddf_consts = make_cddf_reducer(
            cddf_spec, offsets, np.log10(nhis), dtype,
            replicated_sharding=repl,
        )
        log_p0m, log_p1m, log_p2m = multi_dla_rate_priors(
            spectra.z_qso, prior_z_qsos, prior_num, params
        )

    @jax.jit
    def fused(*args):
        """The per-batch device chain, compiled as ONE program:
        single-DLA likelihoods -> lean reductions AND base resample +
        packed value gather (index VALUES stay in original sample
        numbering) -> pair likelihoods -> pair reductions -> one
        stacked (8, B) small-vector array.  Index rows ride at the
        stacked dtype — exact for any S < 2**24 (guarded above).
        With store_cddf_inputs, the same program also reduces the CDDF
        inputs and returns (stacked, hist, ex); the per-batch prior
        vectors and the reduction's constant tables ride as extra
        ARGUMENTS (not closures — large closed-over arrays would be
        baked into the HLO payload, see models/training.py)."""
        args1 = args[:n_fn1_args]
        out1 = fn1(*args1)
        sll = out1["sample_log_likelihoods_dla"]
        ev1, map1 = pack_lean(sll)
        base_cols = device_inverse_cdf_grid(
            sll, cols_dev, grid_size=grid_size
        )
        vals = base_tables[base_cols]
        lls2 = fn2(*args1[:9], off_j, nh_j, vals[..., 0], vals[..., 1])
        ev2, map2, map_base = pack_lean_pair(lls2, base_cols)
        small = [
            out1["log_likelihood_no_dla"], out1["min_z_dla"],
            out1["max_z_dla"], ev1, map1, ev2, map2, map_base,
        ]
        wide = jnp.result_type(*(a.dtype for a in small))
        stacked = jnp.stack([a.astype(wide) for a in small])
        if not store_cddf:
            return stacked
        lpno, lpdla, lp0m, lp1m, lp2m, consts = args[n_fn1_args:]
        hist, ex = cddf_reduce(
            consts, sll, ev1, out1["log_likelihood_no_dla"],
            out1["min_z_dla"], out1["max_z_dla"],
            lpno, lpdla, lp0m, lp1m, lp2m, lls2, ev2, base_cols,
        )
        return stacked, hist, ex

    # ---- checkpoint manifest (one stream for the fused pass) ----
    ckpt_dir = (
        Path(config.checkpoint_dir) / "fused" if config.checkpoint_dir else None
    )
    manifest_path = ckpt_dir / "manifest.json" if ckpt_dir else None
    # the trailing token is the fused-chain numerics version: v2 was
    # the grid inverse-CDF base resampler (single-rounded boundaries
    # vs v1's double-rounded stored-u searchsorted); v3 compiles the
    # whole chain into one XLA program, whose cross-stage fusion may
    # reassociate f32 knife-edge draws — checkpoints from different
    # versions must not mix within one run
    fingerprint = run_fingerprint(
        dtype, config, params, model, offsets, nhis,
        # base-replicated runs (R > 1) draw on a different grid — a
        # distinct numerics config that must not mix with R=1
        # checkpoints; R=1 keeps the historical fingerprint.  CDDF-
        # reduction runs additionally fingerprint the reduction spec
        # (its grids determine the stored hist values; non-CDDF
        # checkpoints also lack the hist payload entirely)
        extra=(
            [min_sep_z, float(base_seed), 3.0]
            + ([float(R)] if R != 1 else []),
            spectra.z_qso,
        )
        + (
            (np.frombuffer(cddf_spec.token().encode(), np.uint8),)
            if store_cddf
            else ()
        ),
    )
    done: set = set()
    if manifest_path and manifest_path.exists():
        manifest = json.loads(manifest_path.read_text())
        if (
            manifest.get("num_spectra") == n
            and manifest.get("super_batch") == super_batch
            and manifest.get("num_samples") == S
            and manifest.get("fingerprint") == fingerprint
        ):
            done = set(manifest["completed_batches"])
        else:
            import warnings

            warnings.warn(
                f"ignoring incompatible fused two-stage checkpoints in "
                f"{ckpt_dir} (run shape or numerics config changed)",
                stacklevel=2,
            )
    if ckpt_dir:
        ckpt_dir.mkdir(parents=True, exist_ok=True)

    VEC_KEYS = (
        "log_likelihood_no_dla", "min_z_dla", "max_z_dla",
        "log_likelihood_dla", "map_sample_ind",
        "log_likelihood_dla2", "map_sample_ind2", "map_base_sample_ind",
    )
    host_vecs = {k: np.empty(n) for k in VEC_KEYS}
    host_hist = host_ex = None
    if store_cddf:
        from ..cddf_inputs import N_CHANNELS

        host_hist = np.empty(
            (n, N_CHANNELS, cddf_spec.n_z_window, cddf_spec.n_lnhi + 1),
            dtype,
        )
        host_ex = np.empty((n, 5 * cddf_spec.top_k + 4), dtype)

    meter = ProgressMeter(n, unit="spectra") if progress else None
    todo: list[tuple[int, int, int, Path | None]] = []
    for bi, start in enumerate(range(0, n, super_batch)):
        stop = min(start + super_batch, n)
        ckpt_file = ckpt_dir / f"batch_{bi:06d}.npz" if ckpt_dir else None
        if bi in done and ckpt_file and ckpt_file.exists():
            with np.load(ckpt_file) as f:
                for k in VEC_KEYS:
                    host_vecs[k][start:stop] = f[k]
                if store_cddf:
                    host_hist[start:stop] = f["cddf_hist"]
                    host_ex[start:stop] = f["cddf_ex"]
            if meter is not None:
                meter.update(stop - start)
            continue
        todo.append((bi, start, stop, ckpt_file))

    import time as _time

    from ..utils import env_flag

    timing = env_flag("GPDLA_DRIVER_TIMING")

    def upload(item):
        # host slice/pad + device_put only (no collectives; overlap.py)
        bi, start, stop, ckpt_file = item
        t0 = _time.perf_counter()
        batch = spectra.slice(slice(start, stop)).pad_to(super_batch)
        t1 = _time.perf_counter()
        # args1 = 5 batch arrays + 4 model arrays + (off, nh) original;
        # the fused program derives the pair evaluator's inputs on
        # device (see `fused` above) — ONE dispatch covers both stages
        args1 = (
            jax.device_put(np.asarray(batch.wavelengths, dtype), data_spec2),
            jax.device_put(np.asarray(batch.flux, dtype), data_spec2),
            jax.device_put(np.asarray(batch.noise_variance, dtype), data_spec2),
            jax.device_put(np.asarray(batch.mask), data_spec2),
            jax.device_put(np.asarray(batch.z_qso, dtype), data_spec),
            *model_args,
            off_j,
            nh_j,
        )
        if store_cddf:
            pad_rows = super_batch - (stop - start)

            def pad_vec(a):
                v = np.asarray(a[start:stop], dtype)
                if pad_rows:
                    v = np.concatenate([v, np.repeat(v[-1:], pad_rows)])
                return jax.device_put(v, data_spec)

            args1 = args1 + (
                pad_vec(log_p_no_dla), pad_vec(log_p_dla),
                pad_vec(log_p0m), pad_vec(log_p1m), pad_vec(log_p2m),
                cddf_consts,
            )
        if timing:
            print(
                f"[fused] batch {bi}: slice {t1 - t0:.3f}s "
                f"device_put {_time.perf_counter() - t1:.3f}s",
                flush=True,
            )
        return args1

    def issue(item, args1):
        bi = item[0]
        t0 = _time.perf_counter()
        out = fused(*args1)
        if timing:
            print(
                f"[fused] batch {bi}: dispatch "
                f"{_time.perf_counter() - t0:.3f}s",
                flush=True,
            )
        return out

    def write_checkpoint(ckpt_file, bi, vecs, cddf=None):
        extra = (
            {} if cddf is None else {"cddf_hist": cddf[0], "cddf_ex": cddf[1]}
        )
        atomic_savez(
            ckpt_file, compress=False,
            **{k: v for k, v in zip(VEC_KEYS, vecs)},
            **extra,
        )
        done.add(bi)
        atomic_write_json(
            manifest_path,
            {
                "num_spectra": n,
                "super_batch": super_batch,
                "num_samples": S,
                "base_seed": base_seed,
                "fingerprint": fingerprint,
                "completed_batches": sorted(done),
            },
        )

    with BackgroundWriter() as writer:

        def finish_batch(bi, start, stop, ckpt_file, vecs, cddf=None):
            keep = stop - start
            vecs = [np.asarray(v[:keep], np.float64) for v in vecs]
            # index translations (host side): -1 = no finite sample /
            # no valid pair.  The single-stage MAP follows the lean
            # single driver's catalog fallback (original index 0); the
            # pair MAPs keep -1 as the documented no-valid-pair flag.
            map1 = vecs[4].astype(np.int64)
            map1[map1 < 0] = 0
            vecs[4] = map1
            vecs[6] = vecs[6].astype(np.int64)
            vecs[7] = vecs[7].astype(np.int64)
            for k, v in zip(VEC_KEYS, vecs):
                host_vecs[k][start:stop] = v
            if cddf is not None:
                hist_h, ex_h = cddf[0][:keep], cddf[1][:keep]
                host_hist[start:stop] = hist_h
                host_ex[start:stop] = ex_h
                cddf = (hist_h, ex_h)
            if ckpt_file and is_coordinator():
                write_checkpoint(ckpt_file, bi, vecs, cddf)

        def complete(item, state):
            bi, start, stop, ckpt_file = item
            t0 = _time.perf_counter()
            if store_cddf:
                stacked, hist_d, ex_d = state
                cddf = (fetch_global(hist_d), fetch_global(ex_d))
            else:
                stacked, cddf = state, None
            smalls = fetch_global(stacked)
            if timing:
                print(
                    f"[fused] batch {bi}: fetch {_time.perf_counter() - t0:.3f}s",
                    flush=True,
                )
            vecs = [np.asarray(smalls[i]) for i in range(len(VEC_KEYS))]
            writer.submit(
                finish_batch, bi, start, stop, ckpt_file, vecs, cddf
            )
            if meter is not None:
                meter.update(stop - start)

        # uploads on a side thread; the fused-chain issuance and the
        # fetch collectives keep serial program order on the main
        # thread — multi-controller-safe (overlap.py)
        run_pipelined_split(
            todo, upload, issue, complete, depth=config.pipeline_depth,
            threaded=config.dispatch_thread,
        )

    post = posteriors_from_evidence(
        log_p_no_dla, log_p_dla,
        host_vecs["log_likelihood_no_dla"], host_vecs["log_likelihood_dla"],
    )
    single = InferenceResults(
        min_z_dlas=host_vecs["min_z_dla"],
        max_z_dlas=host_vecs["max_z_dla"],
        log_priors_no_dla=log_p_no_dla,
        log_priors_dla=log_p_dla,
        log_likelihoods_no_dla=host_vecs["log_likelihood_no_dla"],
        log_likelihoods_dla=post["log_likelihoods_dla"],
        sample_log_likelihoods_dla=None,
        map_sample_inds=host_vecs["map_sample_ind"].astype(np.int64),
        log_posteriors_no_dla=post["log_posteriors_no_dla"],
        log_posteriors_dla=post["log_posteriors_dla"],
        model_posteriors=post["model_posteriors"],
        p_no_dlas=post["p_no_dlas"],
        p_dlas=post["p_dlas"],
    )
    cddf_out = None
    if store_cddf:
        from ..cddf_inputs import CDDFInputs

        cddf_out = CDDFInputs(
            spec=cddf_spec, hist=host_hist, ex=host_ex, second=True
        )
        cddf_out.validate()
    # all-NaN pair rows (no valid pair) keep NaN evidence: the host
    # finalize_multi does the same via np.nanmax of an all-NaN row
    return finalize_multi_from_evidence(
        single, host_vecs["log_likelihood_dla2"], spectra.z_qso,
        prior_z_qsos, prior_num, params,
        map_sample_inds2=host_vecs["map_sample_ind2"].astype(np.int64),
        map_base_sample_inds=host_vecs["map_base_sample_ind"].astype(np.int64),
        cddf_inputs=cddf_out,
    )
