"""DLA-evidence throughput on one GPU (spectra/s).

Workload: the per-spectrum Bayesian model selection of process_qsos.m
at production widths — 10,000 QMC (z_DLA, log N_HI) samples x 1274-pixel
padded spectra x rank-20 GP, 3 Lyman-series lines, float32.

Two metrics, each printed as one JSON line that names the device:

  - evaluator: the jitted single-DLA batch evaluator alone
    (inference.batch_log_likelihoods), batches enqueued back to back;
  - driver (``--driver``): the production sharded driver end to end —
    upload, compute, fetch and checkpoints — as the marginal rate of a
    long run over a one-batch run.  ``--lean --two-stage`` selects the
    fused lean two-stage {0,1,2}-DLA driver.

Refuses to run, with a non-zero exit, when JAX finds no GPU.
"""

from __future__ import annotations

import json
import time

import numpy as np


def _problem(batch_size, num_samples, pixels, k, seed=0):
    from gp_dla_detection.utils.synthetic import synthetic_workload

    return synthetic_workload(batch_size, num_samples, pixels, k, seed=seed)


def _device_header() -> dict:
    from gp_dla_detection.utils import enable_compilation_cache
    from gp_dla_detection.utils.device import (
        card_name_and_power_limit,
        require_gpu,
    )

    device = require_gpu()
    device["card"] = card_name_and_power_limit()
    print(device["card"], flush=True)
    enable_compilation_cache()
    return device


def main(batch_size: int = 64, num_samples: int = 10000, pixels: int = 1274,
         k: int = 20, sample_chunk: int = 2500, iters: int = 5) -> None:
    device = _device_header()
    import jax

    from gp_dla_detection.inference import batch_log_likelihoods

    prob = _problem(batch_size, num_samples, pixels, k)
    params = prob["params"]
    args = [
        jax.numpy.asarray(prob[name])
        for name in (
            "wavelengths", "flux", "noise_variance", "mask", "z_qso", "grid",
            "mu", "M", "log_omega",
        )
    ]
    args += [
        prob["log_c_0"], prob["log_tau_0"], prob["log_beta"],
        jax.numpy.asarray(prob["offsets"]), jax.numpy.asarray(prob["nhis"]),
    ]

    @jax.jit
    def step(*a):
        out = batch_log_likelihoods(*a, params=params, sample_chunk=sample_chunk)
        return out["log_likelihood_no_dla"], out["sample_log_likelihoods_dla"]

    jax.block_until_ready(step(*args))  # compile
    t0 = time.perf_counter()
    outs = [step(*args) for _ in range(iters)]
    jax.block_until_ready(outs)
    elapsed = (time.perf_counter() - t0) / iters
    assert all(bool(np.isfinite(np.asarray(o)).all()) for o in outs[-1])
    print(
        json.dumps(
            {
                "metric": "evaluator spectra/s (single-DLA, "
                f"{num_samples} QMC samples, {pixels} px, k={k})",
                "value": batch_size / elapsed,
                "unit": "spectra/s",
                "batch_size": batch_size,
                "device": device,
            }
        ),
        flush=True,
    )


def main_driver(n_spectra: int = 4096, per_device_batch: int = 64,
                num_samples: int = 10000, pixels: int = 1274, k: int = 20,
                checkpoint: bool = True, pipeline_depth: int = 4,
                lean: bool = False, two_stage: bool = False) -> None:
    """Sustained end-to-end throughput through the production sharded
    driver: device_put + execute + result streaming + background
    checkpointing per super-batch."""
    import tempfile

    device = _device_header()
    from gp_dla_detection.inference import PaddedSpectra
    from gp_dla_detection.models.qso_model import GPModel
    from gp_dla_detection.parallel.sharded_inference import (
        ShardedRunConfig,
        process_spectra_sharded,
    )
    from gp_dla_detection.parallel.sharded_multi import (
        process_spectra_multi_sharded,
    )

    prob = _problem(n_spectra, num_samples, pixels, k)
    model = GPModel(
        rest_wavelengths=prob["grid"], mu=prob["mu"], M=prob["M"],
        log_omega=prob["log_omega"], log_c_0=prob["log_c_0"],
        log_tau_0=prob["log_tau_0"], log_beta=prob["log_beta"],
    )
    spectra = PaddedSpectra(
        prob["wavelengths"], prob["flux"], prob["noise_variance"],
        prob["mask"], prob["z_qso"],
    )
    rng = np.random.default_rng(1)
    prior_z = rng.uniform(2.0, 4.0, 4096)
    prior_flags = rng.uniform(size=4096) < 0.1
    prior_num = rng.choice([0, 0, 0, 0, 0, 0, 0, 0, 1, 2], 4096)

    def run(sl, ckpt_dir):
        cfg = ShardedRunConfig(
            per_device_batch=per_device_batch, dtype="float32",
            checkpoint_dir=ckpt_dir, pipeline_depth=pipeline_depth,
            store_sample_likelihoods=not lean,
        )
        if two_stage:
            return process_spectra_multi_sharded(
                model, prob["offsets"], prob["nhis"], spectra.slice(sl),
                prior_z, prior_num, config=cfg,
            ).single
        return process_spectra_sharded(
            model, prob["offsets"], prob["nhis"], spectra.slice(sl),
            prior_z, prior_flags, config=cfg,
        )

    import jax

    batch = per_device_batch * len(jax.devices())
    with tempfile.TemporaryDirectory() as tmp:
        # compile at the run shapes and pay the checkpoint path's
        # first-use costs outside the timed runs
        run(slice(0, 2 * batch), f"{tmp}/warm" if checkpoint else None)
        # marginal rate: a one-batch run and the full run in the same
        # process, so per-run fixed costs cancel
        t0 = time.perf_counter()
        run(slice(0, batch), f"{tmp}/w" if checkpoint else None)
        t_short = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = run(slice(0, n_spectra), f"{tmp}/ckpt" if checkpoint else None)
        t_long = time.perf_counter() - t0
    bad = ~np.isfinite(res.log_likelihoods_dla)
    assert not bad.any(), f"non-finite DLA evidences for {bad.sum()} spectra"
    value = (n_spectra - batch) / max(t_long - t_short, 1e-9)
    print(
        json.dumps(
            {
                "metric": "driver spectra/s (sustained end-to-end, "
                f"{num_samples} QMC samples, "
                + ("fused two-stage {0,1,2} catalog, " if two_stage else "")
                + ("lean device-reduced results" if lean else "f16 streaming")
                + (", checkpointing" if checkpoint else "")
                + ", marginal rate)",
                "value": value,
                "unit": "spectra/s",
                "first_batch_s": t_short,
                "device": device,
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--num-samples", type=int, default=10000)
    p.add_argument("--pixels", type=int, default=1274)
    p.add_argument("--k", type=int, default=20)
    p.add_argument("--sample-chunk", type=int, default=2500)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--driver", action="store_true",
                   help="sustained end-to-end driver benchmark instead of "
                   "the evaluator loop")
    p.add_argument("--n-spectra", type=int, default=4096,
                   help="--driver: total spectra for the sustained run")
    p.add_argument("--no-checkpoint", action="store_true",
                   help="--driver: disable per-batch checkpointing")
    p.add_argument("--pipeline-depth", type=int, default=4,
                   help="--driver: super-batches in flight (1 = serial)")
    p.add_argument("--lean", action="store_true",
                   help="--driver: catalog-only mode — evidence + MAP "
                        "reduced on device, no (B, S) matrix fetch")
    p.add_argument("--two-stage", action="store_true",
                   help="--driver --lean: the fused two-stage {0,1,2}-DLA "
                        "catalog chain")
    a = p.parse_args()
    if a.two_stage and not a.lean:
        p.error("--two-stage requires --lean (the fused chain is the "
                "lean catalog driver)")
    if a.driver:
        main_driver(a.n_spectra, a.batch_size, a.num_samples, a.pixels, a.k,
                    not a.no_checkpoint, a.pipeline_depth, lean=a.lean,
                    two_stage=a.two_stage)
    else:
        main(a.batch_size, a.num_samples, a.pixels, a.k, a.sample_chunk,
             a.iters)
