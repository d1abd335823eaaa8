"""Survey-scale demo: 1024 spectra x 10,000 QMC samples through the full
two-stage {0, 1, 2}-DLA model selection.

The sharded drivers (single-DLA pass, then posterior-resampled pair
pass), per-batch checkpoints, f16 result streaming, and the persistent
compilation cache, on synthetic spectra with injected DLAs.

Run:  python scripts/scale_demo.py [--n-spectra 1024]
Prints one JSON line per stage plus a total.
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np


def main(
    n_spectra: int = 1024,
    seed: int = 7,
    num_samples: int = 10000,
) -> None:
    from gp_dla_detection import Parameters
    from gp_dla_detection.inference import PaddedSpectra
    from gp_dla_detection.models.qso_model import GPModel
    from gp_dla_detection.ops.voigt import (
        extend_wavelengths,
        voigt_absorption,
    )
    from gp_dla_detection.parallel import (
        ShardedRunConfig,
        make_mesh,
        process_spectra_multi_sharded,
    )
    from gp_dla_detection.params import NullModelParams
    from gp_dla_detection.samples import generate_dla_samples
    from gp_dla_detection.utils import enable_compilation_cache

    import dataclasses

    enable_compilation_cache()
    rng = np.random.default_rng(seed)
    params = Parameters(null_model=NullModelParams(k=20))
    if num_samples != params.dla_sampling.num_dla_samples:
        params = dataclasses.replace(
            params,
            dla_sampling=dataclasses.replace(
                params.dla_sampling, num_dla_samples=num_samples
            ),
        )
    grid = params.null_model.rest_wavelengths()
    P = params.pixel_pad

    model = GPModel(
        rest_wavelengths=grid,
        mu=1.0
        + 0.3 * np.exp(-0.5 * ((grid - 1215.67) / 25.0) ** 2)
        + 0.1 * np.sin(grid / 60.0),
        M=rng.normal(size=(grid.size, 20)) * 0.04,
        log_omega=np.log(0.12 + 0 * grid),
        log_c_0=np.log(0.1),
        log_tau_0=np.log(0.0023),
        log_beta=np.log(3.65),
    )

    t_prep = time.time()
    z_qso = rng.uniform(2.4, 3.4, n_spectra)
    lam = (911.9 * (1 + z_qso))[:, None] * 10 ** (1e-4 * np.arange(P))[None, :]
    noise_sd = 0.1
    flux = np.empty((n_spectra, P))
    injected = np.zeros(n_spectra, np.int64)
    lya = 1215.6701
    for i in range(n_spectra):
        rest = lam[i] / (1 + z_qso[i])
        f = (
            np.interp(rest, grid, model.mu)
            + np.interp(rest, grid, model.M @ rng.normal(size=20))
            + rng.normal(0, noise_sd, P)
        )
        # ~35% of sightlines host 1 DLA, ~10% host 2
        n_dla = rng.choice([0, 1, 2], p=[0.55, 0.35, 0.10])
        zmin = lam[i, 0] / lya - 1 + 0.02
        # inject only inside the engine's searchable range (capped at
        # the last MODELLED pixel, rest <= max_lambda)
        lam_search_max = min(
            lam[i, -1], params.null_model.max_lambda * (1 + z_qso[i])
        )
        zmax = lam_search_max / lya - 1 - params.max_z_cut
        ext = extend_wavelengths(lam[i], params.instrument) if n_dla else None
        for z_dla in rng.uniform(zmin, zmax, n_dla):
            nhi = 10 ** rng.uniform(20.3, 21.8)
            f *= np.asarray(voigt_absorption(ext, z_dla, nhi, num_lines=3))
        injected[i] = n_dla
        flux[i] = f
    spectra = PaddedSpectra(
        lam, flux, np.full((n_spectra, P), noise_sd**2),
        np.ones((n_spectra, P), bool), z_qso,
    )

    observed_log_nhis = rng.normal(20.7, 0.4, 400).clip(20.05, 22.4)
    samples = generate_dla_samples(observed_log_nhis, params)
    prior_z = rng.uniform(2.2, 3.6, 5000)
    # per-prior-sightline DLA multiplicities (the real pipeline derives
    # these via multi_dla.prior_dla_multiplicity from catalog flags)
    prior_num = rng.choice([0, 0, 0, 0, 0, 0, 0, 1, 1, 2], 5000)
    print(json.dumps({"stage": "prepare", "seconds": round(time.time() - t_prep, 1)}))

    ckpt = Path(tempfile.mkdtemp(prefix="scale_demo_"))
    mesh = make_mesh()
    n_data = mesh.devices.size
    # size the super-batch to the workload: padding a small run up to
    # 64/device wastes compute (tests run this at n_spectra=6)
    pdb = max(1, min(64, -(-n_spectra // n_data)))
    try:
        t0 = time.time()
        res = process_spectra_multi_sharded(
            model, samples.offset_samples, samples.nhi_samples, spectra,
            prior_z, prior_num, params=params, mesh=mesh,
            config=ShardedRunConfig(
                per_device_batch=pdb,
                sample_chunk=min(2500, num_samples),
                dtype="float32", checkpoint_dir=str(ckpt),
            ),
        )
        total = time.time() - t0
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)

    picks = np.argmax(res.model_posteriors, axis=1)
    acc = float(np.mean(picks == np.minimum(injected, 2)))
    # np.mean over an empty selection is NaN (invalid JSON downstream)
    rate = lambda sel: float(np.mean(sel)) if sel.size else None
    detect = rate(picks[injected >= 1] >= 1)
    clean_fp = rate(picks[injected == 0] >= 1)
    print(
        json.dumps(
            {
                "stage": "two_stage_model_selection",
                "n_spectra": n_spectra,
                "num_samples": len(samples.offset_samples),
                "seconds": round(total, 1),
                "spectra_per_sec_end_to_end": round(n_spectra / total, 1),
                "exact_multiplicity_acc": round(acc, 3),
                "detection_rate": None if detect is None else round(detect, 3),
                "clean_false_positive_rate": (
                    None if clean_fp is None else round(clean_fp, 3)
                ),
            }
        )
    )


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--n-spectra", type=int, default=1024)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--num-samples", type=int, default=10000)
    a = p.parse_args()
    main(a.n_spectra, a.seed, a.num_samples)
