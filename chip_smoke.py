"""Bring-up check of the DLA evidence pipeline on one GPU.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the fused driver on a
                                       # 4-device data mesh vs one card

Phases, each of which raises (non-zero exit, no result line) on failure:

1. device   — JAX must see a GPU; prints the card's name and power limit.
2. compile  — compiles each step program at production widths (1274 px,
              k=20, 10,000 QMC samples, 3 Lyman lines, float32) and
              prints compile seconds and ``memory_analysis()``.
3. accuracy — the float32 production evaluator against the float64 XLA
              path on the same card, 64 spectra x 10,000 samples.
4. drivers  — process_spectra_sharded and the fused lean two-stage
              driver with CDDF inputs, both checkpointing; checks finite
              evidences, that the injected DLA is found and the clean
              sightline is not, and that a rerun resumes from the
              checkpoints.  Prints steady-state spectra/s and peak memory.
5. train    — a few float64 L-BFGS evaluations of learn_gp_model on the
              1217-px rest grid.
6. report   — the last line is ``{"ok": true, "device": {...}}``.

The spectra are synthetic, built from a seed by validation/_universe.py:
GP continua of a random rank-20 model, with Voigt DLAs injected into half
of the sightlines.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "validation"))

K = 20
NUM_SAMPLES = 10_000
PER_DEVICE_BATCH = 64
SAMPLE_CHUNK = 2500
NUM_SPECTRA = 8 * PER_DEVICE_BATCH
ACCURACY_SPECTRA = 64
TRAIN_SPECTRA = 4000
SEED = 7

# Phase-3 bounds, float32 production path vs the float64 path.
# Sample log likelihoods: max |d| over max(|ll|, 1) across the set, the
# bound two float32 paths are held to.  Null evidences: relative, per
# spectrum.  No float32 path gets them near 1e-6: rounding the inputs
# alone to float32 moves them by up to ~2e-5, and the k x k Woodbury
# solve in float32 adds ~2e-4 on high-SNR sightlines, at HIGH and
# HIGHEST matmul precision alike.  The catalog contract (docs/ACCURACY.md)
# is on decisions: no p > 0.9 flip outside a +-0.01 margin, and
# |dp| p99 below 1e-3.
SAMPLE_LL_BOUND = 5e-5
NULL_BOUND = 5e-4
DP_P99_BOUND = 1e-3
P_THRESHOLD, P_MARGIN = 0.9, 0.01


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    log(f"== {name}")
    yield
    log(f"== {name}: ok ({time.perf_counter() - t0:.1f} s)")


def build_universe(n: int, seed: int = SEED):
    """Synthetic survey slice at production widths: ``n`` sightlines of
    ``params.pixel_pad`` pixels, a DLA injected into every even row, row
    0 a strong high-SNR DLA and row 1 a clean high-SNR sightline."""
    from _universe import (
        inject_dlas,
        injection_bounds,
        standard_model,
        standard_samples,
        synth_continua,
    )

    from gp_dla_detection.inference import PaddedSpectra
    from gp_dla_detection.params import (
        DLASamplingParams,
        NullModelParams,
        Parameters,
    )

    rng = np.random.default_rng(seed)
    params = Parameters(
        null_model=NullModelParams(k=K),
        dla_sampling=DLASamplingParams(num_dla_samples=NUM_SAMPLES),
    )
    model = standard_model(rng, params)
    P = params.pixel_pad
    z_qso = rng.uniform(2.3, 4.0, n)
    lam = (911.9 * (1 + z_qso))[:, None] * 10 ** (1e-4 * np.arange(P))[None, :]
    noise_sd = 10 ** rng.uniform(-1.3, -0.5, n)
    noise_sd[:2] = 0.05
    flux = synth_continua(lam, z_qso, model, noise_sd, rng)
    inj = []
    for i in range(0, n, 2):
        zmin, zmax = injection_bounds(lam[i, 0], lam[i, -1], z_qso[i], params)
        if zmax > zmin:
            log_nhi = 21.3 if i == 0 else rng.uniform(20.3, 21.8)
            inj.append((i, rng.uniform(zmin, zmax), log_nhi))
    assert inj and inj[0][0] == 0, "row 0 must host the reference DLA"
    inject_dlas(lam, flux, inj, params)
    mask = rng.uniform(size=(n, P)) > 0.005
    spectra = PaddedSpectra(
        lam, flux, np.broadcast_to((noise_sd**2)[:, None], (n, P)).copy(),
        mask, z_qso,
    )
    samples = standard_samples(rng, params)
    prior_z = rng.uniform(2.0, 4.4, 5000)
    prior_num = rng.choice([0] * 17 + [1, 1, 2], 5000)
    return params, model, spectra, samples, prior_z, prior_num


def evaluator_args(params, model, spectra, samples, dtype):
    """Positional arguments of inference.batch_log_likelihoods."""
    import jax.numpy as jnp

    return (
        jnp.asarray(spectra.wavelengths, dtype),
        jnp.asarray(spectra.flux, dtype),
        jnp.asarray(spectra.noise_variance, dtype),
        jnp.asarray(spectra.mask),
        jnp.asarray(spectra.z_qso, dtype),
        jnp.asarray(model.rest_wavelengths, dtype),
        jnp.asarray(model.mu, dtype),
        jnp.asarray(model.M, dtype),
        jnp.asarray(model.log_omega, dtype),
        model.log_c_0,
        model.log_tau_0,
        model.log_beta,
        jnp.asarray(samples.offset_samples, dtype),
        jnp.asarray(samples.nhi_samples, dtype),
    )


def report_memory(name: str, compiled) -> None:
    m = compiled.memory_analysis()
    gb = lambda b: f"{b / 1e9:.3f} GB"
    log(
        f"  {name}: arguments {gb(m.argument_size_in_bytes)}, outputs "
        f"{gb(m.output_size_in_bytes)}, temporaries "
        f"{gb(m.temp_size_in_bytes)}, code {gb(m.generated_code_size_in_bytes)}"
    )


def compile_timed(name: str, fn, *args):
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    log(f"  {name}: compiled in {time.perf_counter() - t0:.1f} s")
    report_memory(name, compiled)
    return compiled


def compile_programs(params, model, spectra, samples):
    """Phase 2: the single- and two-DLA evaluators at one device batch."""
    import jax
    import jax.numpy as jnp

    from gp_dla_detection.inference import batch_log_likelihoods
    from gp_dla_detection.multi_dla import make_batch_dla2_fn
    from gp_dla_detection.params import kms_to_z

    B = PER_DEVICE_BATCH
    args = evaluator_args(params, model, spectra.slice(slice(0, B)), samples,
                          np.float32)
    log(
        f"  widths: {B} spectra x {spectra.wavelengths.shape[1]} px x "
        f"{NUM_SAMPLES} samples, k={K}, {params.num_lines} Lyman lines, "
        f"float32, sample_chunk={SAMPLE_CHUNK}"
    )
    single = compile_timed(
        "single-DLA evaluator",
        lambda *a: batch_log_likelihoods(
            *a, params=params, sample_chunk=SAMPLE_CHUNK
        ),
        *args,
    )
    base = jnp.asarray(
        np.broadcast_to(samples.offset_samples[::-1], (B, NUM_SAMPLES)),
        jnp.float32,
    )
    pair_args = (*args[:9], args[12], args[13], base, base * 0 + args[13])
    pair = compile_timed(
        "two-DLA evaluator",
        make_batch_dla2_fn(
            model, params, NUM_SAMPLES, SAMPLE_CHUNK, kms_to_z(3000.0)
        ),
        *pair_args,
    )
    for name, fn, a in (("single", single, args), ("pair", pair, pair_args)):
        out = fn(*a)
        out = out["sample_log_likelihoods_dla"] if name == "single" else out
        out.block_until_ready()
        t0 = time.perf_counter()
        for _ in range(3):
            out = fn(*a)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / 3
        log(f"  {name} evaluator: {dt * 1e3:.1f} ms per batch of {B} "
            f"({B / dt:.1f} spectra/s)")
    return single


def matmul_precision_report() -> None:
    """What each f32 matmul precision of the evidence path lowers to on
    this card, read off its error against a float64 product."""
    import jax
    import jax.numpy as jnp

    from gp_dla_detection.ops import low_rank_mvn

    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (4096, 1296)).astype(np.float32)
    b = rng.normal(size=(1296, 210)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    for prec in (jax.lax.Precision.HIGH, jax.lax.Precision.HIGHEST):
        out = np.asarray(
            jax.jit(lambda x, y: jnp.matmul(x, y, precision=prec))(a, b)
        )
        err = float(np.max(np.abs(out - ref)) / np.max(np.abs(ref)))
        kind = "TF32-class" if err > 1e-5 else "float32-class"
        used = []
        if prec == low_rank_mvn.F32_PRECISION:
            used.append("Woodbury Gram, projection and null-model matmuls")
        if prec == jax.lax.Precision.HIGHEST:
            used.append("CDDF-input histograms")
        log(f"  precision {prec.name}: max rel err {err:.2e} ({kind}); "
            f"used by: {', '.join(used) or 'nothing on this path'}")


def check_accuracy(params, model, spectra, samples, prior_z, prior_num,
                   single_f32):
    """Phase 3: f32 production evaluator vs the f64 path on the card."""
    import jax

    from gp_dla_detection.inference import (
        batch_log_likelihoods,
        dla_rate_priors,
        finalize_posteriors,
    )

    sub = spectra.slice(slice(0, ACCURACY_SPECTRA))
    B = PER_DEVICE_BATCH
    ll32, null32 = [], []
    for start in range(0, ACCURACY_SPECTRA, B):
        args = evaluator_args(params, model, sub.slice(slice(start, start + B)),
                              samples, np.float32)
        out = single_f32(*args)
        ll32.append(np.asarray(out["sample_log_likelihoods_dla"]))
        null32.append(np.asarray(out["log_likelihood_no_dla"]))
    ll32, null32 = np.concatenate(ll32), np.concatenate(null32)
    with jax.enable_x64(True):
        args = evaluator_args(params, model, sub, samples, np.float64)
        out = jax.jit(
            lambda *a: batch_log_likelihoods(*a, params=params, sample_chunk=1000)
        )(*args)
        ll64 = np.asarray(out["sample_log_likelihoods_dla"])
        null64 = np.asarray(out["log_likelihood_no_dla"])
    assert np.isfinite(ll32).all() and np.isfinite(ll64).all()
    d_ll = float(np.max(np.abs(ll32 - ll64)) / max(np.max(np.abs(ll64)), 1.0))
    d_null = float(
        np.max(np.abs(null32 - null64) / np.maximum(np.abs(null64), 1.0))
    )
    lp_dla, lp_no = dla_rate_priors(sub.z_qso, prior_z, prior_num >= 1, params)
    p32 = finalize_posteriors(lp_no, lp_dla, null32, ll32)["p_dlas"]
    p64 = finalize_posteriors(lp_no, lp_dla, null64, ll64)["p_dlas"]
    flips = (p32 > P_THRESHOLD) != (p64 > P_THRESHOLD)
    hard = flips & (np.abs(p64 - P_THRESHOLD) > P_MARGIN)
    log(f"  sample log likelihoods: max|d|/max(|ll|,1) = {d_ll:.3e} "
        f"(bound {SAMPLE_LL_BOUND:.0e})")
    log(f"  null evidences: max|d|/max(|null|,1) = {d_null:.3e} "
        f"(bound {NULL_BOUND:.0e})")
    dp = np.abs(p32 - p64)
    log(f"  p > {P_THRESHOLD} decisions: {int(flips.sum())} flips, "
        f"{int(hard.sum())} outside the +-{P_MARGIN} margin (bound 0); "
        f"|dp| p99 {float(np.quantile(dp, 0.99)):.2e} (bound "
        f"{DP_P99_BOUND:.0e}), max {float(dp.max()):.2e}; "
        f"{int((p64 > P_THRESHOLD).sum())}/{len(p64)} detected in float64")
    matmul_precision_report()
    assert d_ll <= SAMPLE_LL_BOUND, f"sample ll difference {d_ll:.3e}"
    assert d_null <= NULL_BOUND, f"null evidence difference {d_null:.3e}"
    assert not hard.any(), f"{int(hard.sum())} decision flips"
    assert np.quantile(dp, 0.99) <= DP_P99_BOUND


def timed_result(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    return time.perf_counter() - t0, out


def timed(fn, *args):
    return timed_result(fn, *args)[0]


def run_drivers(params, model, spectra, samples, prior_z, prior_num, card):
    """Phase 4: both production drivers with checkpoints, on one card."""
    import jax

    from gp_dla_detection.parallel import (
        ShardedRunConfig,
        make_mesh,
        process_spectra_multi_sharded,
        process_spectra_sharded,
    )

    mesh = make_mesh(devices=jax.devices()[:1])
    batch = PER_DEVICE_BATCH
    n = len(spectra)

    def single(sub, ckpt):
        return process_spectra_sharded(
            model, samples.offset_samples, samples.nhi_samples, sub,
            prior_z, prior_num >= 1, params=params, mesh=mesh,
            config=ShardedRunConfig(
                per_device_batch=batch, sample_chunk=SAMPLE_CHUNK,
                checkpoint_dir=ckpt,
            ),
        )

    def fused(sub, ckpt):
        return process_spectra_multi_sharded(
            model, samples.offset_samples, samples.nhi_samples, sub,
            prior_z, prior_num, params=params, mesh=mesh,
            config=ShardedRunConfig(
                per_device_batch=batch, sample_chunk=SAMPLE_CHUNK,
                checkpoint_dir=ckpt, store_sample_likelihoods=False,
                store_cddf_inputs=True,
            ),
        )

    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, run in (("process_spectra_sharded", single),
                          ("fused lean two-stage (CDDF inputs)", fused)):
            key = name.split()[0]
            t0 = time.perf_counter()
            run(spectra.slice(slice(0, batch)), None)
            log(f"  {name}: first batch incl. compile "
                f"{time.perf_counter() - t0:.1f} s")
            # one untimed full run pays every first-use cost (checkpoint
            # writer, manifest, host code paths) before the timed ones
            run(spectra, f"{tmp}/{key}-warm")
            t_one = min(
                timed(run, spectra.slice(slice(0, batch)), f"{tmp}/{key}-{i}")
                for i in range(2)
            )
            t_all, res = timed_result(run, spectra, f"{tmp}/{key}")
            peak = (jax.devices()[0].memory_stats() or {}).get(
                "peak_bytes_in_use"
            )
            marginal = (
                f"{(n - batch) / (t_all - t_one):.1f} spectra/s"
                if t_all > t_one else "not resolved"
            )
            log(f"  {name}: {n} spectra in {t_all:.3f} s ({n / t_all:.1f} "
                f"spectra/s), one batch of {batch} in {t_one:.3f} s; "
                f"steady state (marginal) {marginal}; peak_bytes_in_use "
                f"{peak} [{card}]")
            t0 = time.perf_counter()
            again = run(spectra, f"{tmp}/{key}")
            log(f"  {name}: rerun resumed from checkpoints in "
                f"{time.perf_counter() - t0:.2f} s")
            single_res = res if key == "process_spectra_sharded" else res.single
            single_again = (
                again if key == "process_spectra_sharded" else again.single
            )
            assert np.array_equal(
                single_res.log_likelihoods_dla, single_again.log_likelihoods_dla
            ), "resumed run differs from the checkpointed one"
            results[key] = res
    one = results["process_spectra_sharded"]
    multi = results["fused"]
    for label, ev in (
        ("null", one.log_likelihoods_no_dla),
        ("single-DLA", one.log_likelihoods_dla),
        ("fused single-DLA", multi.single.log_likelihoods_dla),
    ):
        bad = ~np.isfinite(ev)
        assert not bad.any(), f"{bad.sum()} non-finite {label} evidences"
    pair_ok = np.isfinite(multi.log_likelihoods_dla2)
    log(f"  two-DLA evidences finite for {int(pair_ok.sum())}/{n} sightlines "
        "(NaN = no pair clears the separation cut)")
    assert pair_ok.mean() > 0.9
    assert multi.cddf_inputs is not None
    injected = np.zeros(n, bool)
    injected[0::2] = True
    for label, p in (("process_spectra_sharded", one.p_dlas),
                     ("fused lean two-stage", multi.single.p_dlas)):
        log(f"  {label}: reference DLA p = {p[0]:.4f}, clean sightline "
            f"p = {p[1]:.4f}; p > {P_THRESHOLD} for "
            f"{int((p[injected] > P_THRESHOLD).sum())}/{int(injected.sum())} "
            f"injected and {int((p[~injected] > P_THRESHOLD).sum())}/"
            f"{int((~injected).sum())} clean sightlines")
        assert p[0] > P_THRESHOLD, "the injected DLA was not detected"
        assert p[1] <= P_THRESHOLD, "the clean sightline was flagged"


def train(card) -> None:
    """Phase 5: float64 L-BFGS evaluations of the GP null model."""
    import jax

    from _universe import standard_model, synth_continua

    from gp_dla_detection.models.training import (
        learn_gp_model,
        prepare_training_data,
    )
    from gp_dla_detection.params import (
        NullModelParams,
        OptimizationParams,
        Parameters,
    )

    params = Parameters(
        null_model=NullModelParams(k=K),
        optimization=OptimizationParams(max_iterations=3, max_fun_evals=6),
    )
    rng = np.random.default_rng(SEED + 1)
    truth = standard_model(rng, params)
    n = TRAIN_SPECTRA
    grid = params.null_model.rest_wavelengths()
    z = rng.uniform(2.2, 4.0, n)
    lam = grid[None, :] * (1 + z)[:, None]
    noise_sd = rng.uniform(0.05, 0.3, n)
    flux = synth_continua(lam, z, truth, noise_sd, rng)
    data = prepare_training_data(
        list(lam), list(flux),
        [np.full(grid.size, s * s) for s in noise_sd],
        [rng.uniform(size=grid.size) < 0.02 for _ in range(n)],
        z, params,
    )
    with jax.enable_x64(True):
        t0 = time.perf_counter()
        model, result = learn_gp_model(data, params, dtype=np.float64)
        elapsed = time.perf_counter() - t0
    log(f"  {n} spectra x {grid.size} px, k={K}, float64: "
        f"{result.fun_evals} objective evaluations, {result.iterations} "
        f"iterations in {elapsed:.1f} s incl. compile; final NLL "
        f"{result.f:.6e} ({result.message}) [{card}]")
    assert np.isfinite(result.f) and np.isfinite(model.M).all()
    assert result.fun_evals >= 2


def four_cards(card) -> None:
    """The fused lean two-stage driver over a 4-device data mesh, against
    the same spectra on one card."""
    import jax

    from gp_dla_detection.parallel import (
        ShardedRunConfig,
        make_mesh,
        process_spectra_multi_sharded,
    )

    assert len(jax.devices()) >= 4, f"need 4 GPUs, have {len(jax.devices())}"
    params, model, spectra, samples, prior_z, prior_num = build_universe(
        NUM_SPECTRA
    )
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for cards in (4, 1):
            mesh = make_mesh(devices=jax.devices()[:cards])
            run = lambda ckpt: process_spectra_multi_sharded(
                model, samples.offset_samples, samples.nhi_samples, spectra,
                prior_z, prior_num, params=params, mesh=mesh,
                config=ShardedRunConfig(
                    per_device_batch=PER_DEVICE_BATCH,
                    sample_chunk=SAMPLE_CHUNK, checkpoint_dir=ckpt,
                    store_sample_likelihoods=False, store_cddf_inputs=True,
                ),
            )
            t0 = time.perf_counter()
            run(None)
            t_first = time.perf_counter() - t0
            t0 = time.perf_counter()
            out[cards] = run(f"{tmp}/{cards}")
            dt = time.perf_counter() - t0
            log(f"  {cards} card(s): {len(spectra)} spectra in {dt:.2f} s "
                f"({len(spectra) / dt:.1f} spectra/s; first run incl. "
                f"compile {t_first:.1f} s) [{card}]")
    a, b = out[4], out[1]
    rel = lambda x, y: float(
        np.nanmax(np.abs(x - y) / np.maximum(np.abs(y), 1.0))
    )
    d_null = rel(a.single.log_likelihoods_no_dla,
                 b.single.log_likelihoods_no_dla)
    d1 = rel(a.single.log_likelihoods_dla, b.single.log_likelihoods_dla)
    d2 = rel(a.log_likelihoods_dla2, b.log_likelihoods_dla2)
    same = (
        np.array_equal(a.single.p_dlas > P_THRESHOLD,
                       b.single.p_dlas > P_THRESHOLD)
        and np.array_equal(np.argmax(a.model_posteriors, 1),
                           np.argmax(b.model_posteriors, 1))
        and np.array_equal(np.isnan(a.log_likelihoods_dla2),
                           np.isnan(b.log_likelihoods_dla2))
    )
    log(f"  4 vs 1 card: null rel {d_null:.3e}, single-DLA {d1:.3e}, "
        f"two-DLA {d2:.3e}; same catalog decisions: {same}")
    assert same, "catalog decisions differ between 4 cards and 1"
    assert max(d_null, d1, d2) <= SAMPLE_LL_BOUND


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the fused driver on a 4-device mesh "
                    "against one card")
    args = ap.parse_args(argv)

    from gp_dla_detection.utils import enable_compilation_cache
    from gp_dla_detection.utils.device import (
        card_name_and_power_limit,
        require_gpu,
    )

    with phase("device"):
        device = require_gpu()
        card = card_name_and_power_limit()
        log(card)
        log(f"  jax: {device['count']} x {device['kind']} "
            f"({device['platform']})")
        enable_compilation_cache()
    if args.four_cards:
        with phase("four cards"):
            four_cards(card.replace("\n", "; "))
    else:
        params, model, spectra, samples, prior_z, prior_num = build_universe(
            NUM_SPECTRA
        )
        with phase("compile"):
            single_f32 = compile_programs(params, model, spectra, samples)
        with phase("accuracy"):
            check_accuracy(params, model, spectra, samples, prior_z,
                           prior_num, single_f32)
        with phase("drivers"):
            run_drivers(params, model, spectra, samples, prior_z, prior_num,
                        card)
        with phase("train"):
            train(card)
    print(json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"],
    }}), flush=True)


if __name__ == "__main__":
    main()
