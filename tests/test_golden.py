"""Golden-value regression pinning.

The reference pins determinism with rng('default') so runs "exactly
reproduce the published catalog" (README.md:12-13).  Equivalent here: a
committed fixture of float64 log-evidences for a fixed synthetic
problem; any numerics change that shifts results beyond 1e-9 relative
must be deliberate (regenerate with
``python tests/test_golden.py regenerate``).
"""

from pathlib import Path

import numpy as np

FIXTURE = Path(__file__).parent / "fixtures" / "golden_evidences.npz"


def golden_problem():
    import jax.numpy as jnp

    from gp_dla_detection.inference import batch_log_likelihoods
    from gp_dla_detection.models.qso_model import GPModel
    from gp_dla_detection.params import NullModelParams, Parameters

    rng = np.random.default_rng(20160446)  # arXiv id of the paper
    params = Parameters(null_model=NullModelParams(k=6))
    grid = params.null_model.rest_wavelengths()
    model = GPModel(
        rest_wavelengths=grid,
        mu=1.0 + 0.2 * np.sin(grid / 35.0),
        M=rng.normal(size=(grid.size, 6)) * 0.07,
        log_omega=np.log(0.15 + 0.05 * np.cos(grid / 55.0)),
        log_c_0=np.log(0.1),
        log_tau_0=np.log(0.0023),
        log_beta=np.log(3.65),
    )
    B, P, S = 3, 700, 64
    z = np.array([2.71, 3.05, 3.42])
    lam = np.stack(
        [10 ** (np.log10(911.8 * (1 + zz)) + 1e-4 * np.arange(P)) for zz in z]
    )
    mask = rng.uniform(size=(B, P)) > 0.04
    args = (
        jnp.asarray(lam),
        jnp.asarray(rng.normal(1.0, 0.25, (B, P))),
        jnp.asarray(rng.uniform(0.05, 0.2, (B, P))),
        jnp.asarray(mask),
        jnp.asarray(z),
        jnp.asarray(model.rest_wavelengths),
        jnp.asarray(model.mu),
        jnp.asarray(model.M),
        jnp.asarray(model.log_omega),
        model.log_c_0,
        model.log_tau_0,
        model.log_beta,
        jnp.asarray(rng.uniform(size=S)),
        jnp.asarray(10 ** rng.uniform(20.0, 22.3, S)),
    )
    return batch_log_likelihoods(*args, params=params, sample_chunk=16)


def test_golden_log_evidences():
    out = golden_problem()
    assert FIXTURE.exists(), "fixture missing; run: python tests/test_golden.py regenerate"
    with np.load(FIXTURE) as f:
        np.testing.assert_allclose(
            np.asarray(out["log_likelihood_no_dla"]),
            f["log_likelihood_no_dla"],
            rtol=1e-9,
        )
        np.testing.assert_allclose(
            np.asarray(out["sample_log_likelihoods_dla"]),
            f["sample_log_likelihoods_dla"],
            rtol=1e-9,
        )
        np.testing.assert_allclose(
            np.asarray(out["min_z_dla"]), f["min_z_dla"], rtol=1e-12
        )


if __name__ == "__main__":
    import sys

    if len(sys.argv) > 1 and sys.argv[1] == "regenerate":
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        out = golden_problem()
        FIXTURE.parent.mkdir(exist_ok=True)
        np.savez_compressed(
            FIXTURE, **{k: np.asarray(v) for k, v in out.items()}
        )
        print(f"wrote {FIXTURE}")
