"""Decision-level accuracy of the production f32 path vs the f64 oracle.

The reference's single accuracy claim is exact catalog reproduction
(README.md:12-14, MATLAB f64 throughout).  The honest f32 analogue for
this framework is: *the fast path changes no catalog decisions*.  This
study quantifies it at survey-relevant scale: N spectra spanning the
(z_DLA, log N_HI) prior are processed twice —

  - production path: float32, f16 result streaming (exactly what a
    survey run executes: process_spectra_sharded with ShardedRunConfig
    defaults), and
  - oracle path: float64, no stream narrowing (the mode whose parity vs
    dense scipy is pinned at 1e-6 relative by tests/test_inference.py +
    the golden fixture)

and the |Δ log evidence|, |Δ p_DLA| distributions and classification
flips at the p = 0.9 catalog threshold are reported.  The CI-sized
version of this comparison is pinned in tests/test_f32_decisions.py.

Run: python validation/f32_decision_study.py [--n-spectra 4096]
Prints a markdown report; chip_smoke.py phase 3 is the same comparison
on one batch of the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from _universe import (  # noqa: E402
    inject_dlas,
    injection_bounds,
    standard_model,
    standard_samples,
    synth_continua,
)


def build_problem(n_spectra: int, num_samples: int = 10000, seed: int = 77):
    """Spectra spanning the prior: z_qso in [2.2, 4.2], ~55% hosting an
    injected DLA with log N_HI uniform in [20.0, 22.8] (the QMC prior's
    support), plus masked holes.  Construction shared with the scale
    rehearsal via validation/_universe.py."""
    from gp_dla_detection import Parameters
    from gp_dla_detection.inference import PaddedSpectra
    from gp_dla_detection.params import DLASamplingParams, NullModelParams

    rng = np.random.default_rng(seed)
    params = Parameters(
        null_model=NullModelParams(k=20),
        dla_sampling=DLASamplingParams(num_dla_samples=num_samples),
    )
    model = standard_model(rng, params)
    # per-spectrum SNR log-uniform over ~[0.8, 10]: at uniform SNR 10
    # every posterior saturates (p exactly 0.0/1.0 in f64) and the flip
    # test is vacuous — marginal-SNR spectra populate the mid-range and
    # the near-threshold band the decision claim is actually about
    noise_sd = 10 ** rng.uniform(-1.0, 0.1, n_spectra)
    P = params.pixel_pad
    z_qso = rng.uniform(2.2, 4.2, n_spectra)
    lam = (911.9 * (1 + z_qso))[:, None] * 10 ** (1e-4 * np.arange(P))[None, :]
    flux = np.empty((n_spectra, P))
    injected = np.zeros(n_spectra, bool)
    inj: list[tuple[int, float, float]] = []
    for i in range(n_spectra):
        # row-wise so the rng draw order (continuum coefficients, noise,
        # THEN this sightline's injection draws) keeps seed 77's
        # universe identical across versions of this study
        flux[i] = synth_continua(
            lam[i : i + 1], z_qso[i : i + 1], model, noise_sd[i], rng
        )[0]
        if rng.uniform() < 0.55:
            zmin, zmax = injection_bounds(
                lam[i, 0], lam[i, -1], z_qso[i], params
            )
            if zmax > zmin:
                inj.append(
                    (i, rng.uniform(zmin, zmax), rng.uniform(20.0, 22.8))
                )
                injected[i] = True
    inject_dlas(lam, flux, inj, params)
    mask = np.ones((n_spectra, P), bool)
    holes = rng.uniform(size=(n_spectra, P)) < 0.005
    mask &= ~holes
    spectra = PaddedSpectra(
        lam, flux, np.broadcast_to((noise_sd**2)[:, None], (n_spectra, P)).copy(),
        mask, z_qso
    )
    samples = standard_samples(rng, params)
    prior_z = rng.uniform(2.0, 4.4, 5000)
    prior_f = rng.uniform(size=5000) < 0.15
    return params, model, spectra, samples, prior_z, prior_f, injected


def compare(res32, res64, threshold: float = 0.9, margin: float = 0.01):
    """Decision-level deltas between the f32 production results and the
    f64 oracle results.

    Alongside |dp| (which is 0 wherever both posteriors saturate), the
    posterior LOG-ODDS delta |d(log posterior_dla - log posterior_null)|
    is reported: it stays finite and meaningful at saturation, and a
    catalog flip at p = ``threshold`` is arithmetically impossible for
    any spectrum whose oracle log-odds sits further than the observed
    max |dlog odds| from logit(threshold)."""
    d_null = np.abs(res32.log_likelihoods_no_dla - res64.log_likelihoods_no_dla)
    d_dla = np.abs(res32.log_likelihoods_dla - res64.log_likelihoods_dla)
    d_p = np.abs(res32.p_dlas - res64.p_dlas)
    lo32 = res32.log_posteriors_dla - res32.log_posteriors_no_dla
    lo64 = res64.log_posteriors_dla - res64.log_posteriors_no_dla
    d_lo = np.abs(lo32 - lo64)
    # equal infinite log-odds (e.g. a zero DLA prior in both paths)
    # would give inf - inf = NaN and poison every max below; the two
    # paths agree exactly there, so the delta is 0
    d_lo = np.where(np.isnan(d_lo) & (lo32 == lo64), 0.0, d_lo)
    logit_t = np.log(threshold / (1.0 - threshold))
    at_risk = np.abs(lo64 - logit_t) <= d_lo.max()
    flips = (res32.p_dlas > threshold) != (res64.p_dlas > threshold)
    hard_flips = flips & (np.abs(res64.p_dlas - threshold) > margin)
    q = lambda x: {
        "median": float(np.median(x)),
        "p99": float(np.quantile(x, 0.99)),
        "max": float(np.max(x)),
    }
    return {
        "abs_dlog_evidence_null": q(d_null),
        "abs_dlog_evidence_dla": q(d_dla),
        "abs_dp_dla": q(d_p),
        "abs_dlog_odds": q(d_lo),
        "flips_at_0.9": int(flips.sum()),
        "flips_outside_margin": int(hard_flips.sum()),
        "flips_outside_at_risk_band": int((flips & ~at_risk).sum()),
        "n_near_threshold": int((np.abs(res64.p_dlas - threshold) <= margin).sum()),
        "n_at_risk": int(at_risk.sum()),
        "n_unsaturated": int(
            ((res64.p_dlas > 0.01) & (res64.p_dlas < 0.99)).sum()
        ),
    }


def main(n_spectra: int = 4096, num_samples: int = 10000) -> None:
    from gp_dla_detection.parallel import (
        ShardedRunConfig,
        make_mesh,
        process_spectra_sharded,
    )
    from gp_dla_detection.utils import enable_compilation_cache

    enable_compilation_cache()
    import jax

    jax.config.update("jax_enable_x64", True)

    params, model, spectra, samples, prior_z, prior_f, injected = build_problem(
        n_spectra, num_samples
    )
    mesh = make_mesh()

    t0 = time.time()
    res32 = process_spectra_sharded(
        model, samples.offset_samples, samples.nhi_samples, spectra,
        prior_z, prior_f, params=params, mesh=mesh,
        config=ShardedRunConfig(
            dtype="float32", stream_dtype="float16",
        ),
    )
    t32 = time.time() - t0
    print(f"f32 + f16-stream pass: {t32:.1f} s", flush=True)

    t0 = time.time()
    res64 = process_spectra_sharded(
        model, samples.offset_samples, samples.nhi_samples, spectra,
        prior_z, prior_f, params=params, mesh=mesh,
        config=ShardedRunConfig(
            per_device_batch=min(32, n_spectra), dtype="float64",
            sample_chunk=500,
        ),
    )
    t64 = time.time() - t0
    print(f"f64 oracle pass: {t64:.1f} s", flush=True)

    stats = compare(res32, res64)
    detected64 = res64.p_dlas > 0.9

    lines = [
        "# f32 production path: decision-level accuracy vs the f64 oracle",
        "",
        f"- {n_spectra} synthetic spectra spanning the prior "
        f"(z_QSO in [2.2, 4.2], {int(injected.sum())} injected DLAs with "
        "log N_HI in [20.0, 22.8]), "
        f"{num_samples} QMC samples",
        "- production path: float32, f16 result streaming (sharded "
        f"driver defaults) — {t32:.1f} s",
        "- oracle path: float64 (pinned vs dense scipy at 1e-6 rel) — "
        f"{t64:.1f} s",
        f"- DLA detections at p > 0.9 (oracle): {int(detected64.sum())}",
        "",
        "| quantity | median | p99 | max |",
        "|---|---|---|---|",
    ]
    for key, label in [
        ("abs_dlog_evidence_null", "abs dlog evidence (null)"),
        ("abs_dlog_evidence_dla", "abs dlog evidence (DLA)"),
        ("abs_dp_dla", "abs dp_DLA"),
        ("abs_dlog_odds", "abs dlog posterior odds"),
    ]:
        s = stats[key]
        lines.append(
            f"| {label} | {s['median']:.3g} | {s['p99']:.3g} | {s['max']:.3g} |"
        )
    lines += [
        "",
        f"- unsaturated oracle posteriors (0.01 < p < 0.99): "
        f"{stats['n_unsaturated']}",
        f"- classification flips at p = 0.9: {stats['flips_at_0.9']} "
        f"(spectra with oracle p within 0.01 of the threshold: "
        f"{stats['n_near_threshold']})",
        f"- flips outside the +/-0.01 threshold margin: "
        f"{stats['flips_outside_margin']}",
        f"- spectra whose oracle log-odds sit within the observed max "
        f"|dlog odds| ({stats['abs_dlog_odds']['max']:.3g}) of "
        f"logit(0.9): {stats['n_at_risk']}; flips outside that band: "
        f"{stats['flips_outside_at_risk_band']}",
        "",
        "Interpretation: a flip is arithmetically impossible for any "
        "spectrum whose oracle log-odds lie further than the max "
        "|dlog odds| from logit(0.9); inside that band the f32 and f64 "
        "catalogs may legitimately disagree on posteriors that are "
        "themselves within numerical noise of the threshold.",
    ]
    report = "\n".join(lines) + "\n"
    print(report)
    print(json.dumps(stats))

    assert stats["flips_outside_margin"] == 0, (
        "f32 path flips a confident oracle decision"
    )
    assert stats["abs_dlog_odds"]["max"] < 0.5, (
        "posterior log-odds delta above budget"
    )
    assert stats["flips_outside_at_risk_band"] == 0, (
        "flip bookkeeping inconsistent with the log-odds bound"
    )
    print("F32 DECISION STUDY OK")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--n-spectra", type=int, default=4096)
    p.add_argument("--num-samples", type=int, default=10000)
    a = p.parse_args()
    main(a.n_spectra, a.num_samples)
