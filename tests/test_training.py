"""Training objective: autodiff gradients vs the reference's analytic
gradients (spectrum_loss.m:54-74) and finite differences; end-to-end
L-BFGS fit recovers a known model on synthetic data."""

import jax
import jax.numpy as jnp
import numpy as np
from jax import flatten_util

from gp_dla_detection.models.training import (
    BETA_MU,
    BETA_SIGMA,
    TAU_0_MU,
    TAU_0_SIGMA,
    TrainingData,
    initialize_model_params,
    learn_gp_model,
    objective,
    prepare_training_data,
)
from gp_dla_detection.ops.lbfgs import minimize_lbfgs
from gp_dla_detection.ops.pca import pairwise_pca
from gp_dla_detection.params import LYA_WAVELENGTH, NullModelParams, Parameters


def analytic_oracle(y, lya_1pz, noise, M, log_omega, log_c_0, log_tau_0, log_beta):
    """numpy transcription of spectrum_loss.m:14-74 (value + gradients)."""
    omega2 = np.exp(2 * log_omega)
    c_0, tau_0, beta = np.exp(log_c_0), np.exp(log_tau_0), np.exp(log_beta)
    n, k = M.shape

    lya_optical_depth = tau_0 * lya_1pz**beta
    lya_absorption = np.exp(-lya_optical_depth)
    scaling_factor = 1 - lya_absorption + c_0
    absorption_noise = omega2 * scaling_factor**2
    d = noise + absorption_noise

    d_inv = 1 / d
    D_inv_y = d_inv * y
    D_inv_M = d_inv[:, None] * M
    B = M.T @ D_inv_M + np.eye(k)
    L = np.linalg.cholesky(B)
    C = np.linalg.solve(B, D_inv_M.T)
    K_inv_y = D_inv_y - D_inv_M @ (C @ y)
    log_det_K = np.sum(np.log(d)) + 2 * np.sum(np.log(np.diag(L)))
    nlog_p = 0.5 * (y @ K_inv_y + log_det_K + n * np.log(2 * np.pi))

    K_inv_M = D_inv_M - D_inv_M @ (C @ M)
    dM = -(np.outer(K_inv_y, K_inv_y @ M) - K_inv_M)
    diag_K_inv = d_inv - np.sum(C * D_inv_M.T, axis=0)
    dlog_omega = -(absorption_noise * (K_inv_y**2 - diag_K_inv))
    da = c_0 * omega2 * scaling_factor
    dlog_c_0 = -(K_inv_y * da) @ K_inv_y + diag_K_inv @ da
    da = omega2 * scaling_factor * lya_optical_depth * lya_absorption
    dlog_tau_0 = -(K_inv_y * da) @ K_inv_y + diag_K_inv @ da
    da = da * np.log(lya_1pz) * beta
    dlog_beta = -(K_inv_y * da) @ K_inv_y + diag_K_inv @ da
    return nlog_p, dM, dlog_omega, dlog_c_0, dlog_tau_0, dlog_beta


def random_training_data(rng, N=6, R=40, k=3, mask_frac=0.25):
    mask = rng.uniform(size=(N, R)) > mask_frac
    flux = rng.normal(0, 0.5, size=(N, R))
    lya = 1.0 + rng.uniform(1.5, 3.0, size=(N, R))
    noise = rng.uniform(0.02, 0.6, size=(N, R))
    return TrainingData(
        centered_flux=np.where(mask, flux, 0.0),
        lya_1pzs=np.where(mask, lya, 1.0),
        noise_variance=np.where(mask, noise, 0.0),
        mask=mask,
        mu=np.zeros(R),
    )


def model_params_for(rng, R=40, k=3):
    return {
        "M": jnp.asarray(rng.normal(size=(R, k)) * 0.3),
        "log_omega": jnp.asarray(np.log(rng.uniform(0.1, 0.4, size=R))),
        "log_c_0": jnp.asarray(np.log(0.1)),
        "log_tau_0": jnp.asarray(np.log(0.0023)),
        "log_beta": jnp.asarray(np.log(3.65)),
    }


def test_objective_value_and_grad_match_reference_analytics():
    rng = np.random.default_rng(5)
    data = random_training_data(rng)
    mp = model_params_for(rng)

    args = (
        jnp.asarray(data.centered_flux),
        jnp.asarray(data.lya_1pzs),
        jnp.asarray(data.noise_variance),
        jnp.asarray(data.mask),
    )
    val, grads = jax.value_and_grad(
        lambda p: objective(p, *args, prior_in_value=False)
    )(mp)

    # oracle: accumulate spectrum_loss over spectra with slicing
    # (objective.m:41-57) + prior gradient terms (objective.m:59-71)
    N, R = data.centered_flux.shape
    k = mp["M"].shape[1]
    f = 0.0
    dM = np.zeros((R, k))
    dlo = np.zeros(R)
    dc = dt = db = 0.0
    for i in range(N):
        ind = data.mask[i]
        out = analytic_oracle(
            data.centered_flux[i, ind],
            data.lya_1pzs[i, ind],
            data.noise_variance[i, ind],
            np.asarray(mp["M"])[ind],
            np.asarray(mp["log_omega"])[ind],
            float(mp["log_c_0"]),
            float(mp["log_tau_0"]),
            float(mp["log_beta"]),
        )
        f += out[0]
        dM[ind] += out[1]
        dlo[ind] += out[2]
        dc += out[3]
        dt += out[4]
        db += out[5]

    assert abs(float(val) - f) < 1e-9 * abs(f)
    np.testing.assert_allclose(np.asarray(grads["M"]), dM, rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(
        np.asarray(grads["log_omega"]), dlo, rtol=1e-7, atol=1e-10
    )
    assert abs(float(grads["log_c_0"]) - dc) < 1e-7 * max(1, abs(dc))
    assert abs(float(grads["log_tau_0"]) - dt) < 1e-7 * max(1, abs(dt))
    assert abs(float(grads["log_beta"]) - db) < 1e-7 * max(1, abs(db))


def test_prior_terms_match_reference_gradient():
    """With prior_in_value=True the extra gradient wrt log_tau_0/log_beta
    equals objective.m:59-71's hand-added terms."""
    rng = np.random.default_rng(6)
    data = random_training_data(rng)
    mp = model_params_for(rng)
    args = (
        jnp.asarray(data.centered_flux),
        jnp.asarray(data.lya_1pzs),
        jnp.asarray(data.noise_variance),
        jnp.asarray(data.mask),
    )
    g_with = jax.grad(lambda p: objective(p, *args, prior_in_value=True))(mp)
    g_wo = jax.grad(lambda p: objective(p, *args, prior_in_value=False))(mp)
    tau_0 = float(np.exp(mp["log_tau_0"]))
    beta = float(np.exp(mp["log_beta"]))
    expected_dtau = tau_0 * (tau_0 - TAU_0_MU) / TAU_0_SIGMA**2
    expected_dbeta = beta * (beta - BETA_MU) / BETA_SIGMA**2
    assert np.isclose(
        float(g_with["log_tau_0"] - g_wo["log_tau_0"]), expected_dtau, rtol=1e-10
    )
    assert np.isclose(
        float(g_with["log_beta"] - g_wo["log_beta"]), expected_dbeta, rtol=1e-10
    )


def test_finite_difference_gradient():
    rng = np.random.default_rng(7)
    data = random_training_data(rng, N=3, R=15, k=2)
    mp = model_params_for(rng, R=15, k=2)
    args = (
        jnp.asarray(data.centered_flux),
        jnp.asarray(data.lya_1pzs),
        jnp.asarray(data.noise_variance),
        jnp.asarray(data.mask),
    )
    flat, unravel = flatten_util.ravel_pytree(mp)
    fn = lambda x: float(objective(unravel(x), *args))
    g = jax.grad(lambda x: objective(unravel(x), *args))(flat)
    eps = 1e-6
    idxs = rng.choice(flat.size, size=10, replace=False)
    for i in idxs:
        e = np.zeros(flat.size)
        e[i] = eps
        fd = (fn(flat + e) - fn(flat - e)) / (2 * eps)
        assert abs(fd - float(g[i])) < 1e-4 * max(1.0, abs(fd))


def test_pairwise_pca_complete_case_matches_svd():
    rng = np.random.default_rng(8)
    X = rng.normal(size=(50, 12))
    coeff, latent = pairwise_pca(X, 3)
    Xc = X - X.mean(0)
    _, s, vt = np.linalg.svd(Xc, full_matrices=False)
    expected_latent = s[:3] ** 2 / (X.shape[0] - 1)
    np.testing.assert_allclose(latent, expected_latent, rtol=1e-10)
    for j in range(3):
        v = vt[j] * np.sign(vt[j][np.argmax(np.abs(vt[j]))])
        np.testing.assert_allclose(np.abs(coeff[:, j] @ v), 1.0, rtol=1e-10)


def test_lbfgs_rosenbrock():
    def fg(x):
        a, b = 1.0, 100.0
        f = (a - x[0]) ** 2 + b * (x[1] - x[0] ** 2) ** 2
        g = np.array(
            [
                -2 * (a - x[0]) - 4 * b * x[0] * (x[1] - x[0] ** 2),
                2 * b * (x[1] - x[0] ** 2),
            ]
        )
        return f, g

    res = minimize_lbfgs(fg, np.array([-1.2, 1.0]), max_iterations=200)
    assert res.f < 1e-10
    np.testing.assert_allclose(res.x, [1.0, 1.0], atol=1e-4)


def test_end_to_end_fit_recovers_model():
    """Small synthetic problem: spectra drawn from a known low-rank GP;
    the fitted NLL must beat the NLL at a perturbed init and approach the
    generating model's NLL."""
    rng = np.random.default_rng(9)
    R, k, N = 64, 2, 400
    params = Parameters(
        null_model=NullModelParams(
            min_lambda=1000.0, max_lambda=1000.0 + 0.25 * (R - 1), k=k
        ),
        optimization=dataclassesreplace_opt(),
    )
    grid = params.null_model.rest_wavelengths()
    assert grid.size == R

    true_M = rng.normal(size=(R, k)) * 0.4
    true_omega = 0.15
    z_qso = 2.5

    wavelengths, flux, noise, masks = [], [], [], []
    for _ in range(N):
        lam = grid * (1 + z_qso)
        cov_noise = rng.uniform(0.01, 0.02, size=R)
        latent = true_M @ rng.normal(size=k)
        y = 1.0 + latent + rng.normal(size=R) * np.sqrt(
            true_omega**2 + cov_noise
        )
        wavelengths.append(lam)
        flux.append(y)
        noise.append(cov_noise)
        masks.append(np.zeros(R, bool))

    data = prepare_training_data(
        wavelengths, flux, noise, masks, np.full(N, z_qso), params
    )
    model, res = learn_gp_model(data, params)
    assert res.fun_evals <= params.optimization.max_fun_evals + 5

    # the *effective* absorption-noise std omega * (1 - exp(-tau_0
    # (1+z)^beta) + c_0) should be near the generating omega
    lya_1pz = np.median(data.lya_1pzs[data.mask])
    scaling = (
        1.0 - np.exp(-model.tau_0 * lya_1pz**model.beta) + model.c_0
    )
    fitted_effective = np.exp(np.median(model.log_omega)) * scaling
    assert abs(fitted_effective - true_omega) < 0.05

    # fitted factor subspace should align with the truth
    q_true, _ = np.linalg.qr(true_M)
    q_fit, _ = np.linalg.qr(model.M)
    principal = np.linalg.svd(q_true.T @ q_fit, compute_uv=False)
    assert principal.min() > 0.8


def dataclassesreplace_opt():
    from gp_dla_detection.params import OptimizationParams

    return OptimizationParams(max_iterations=150, max_fun_evals=300)


def test_lbfgs_checkpoint_resume(tmp_path):
    """A resumed run must continue from the checkpoint, not restart."""
    calls = {"n": 0}

    def fg(x):
        calls["n"] += 1
        a, b = 1.0, 100.0
        f = (a - x[0]) ** 2 + b * (x[1] - x[0] ** 2) ** 2
        g = np.array(
            [
                -2 * (a - x[0]) - 4 * b * x[0] * (x[1] - x[0] ** 2),
                2 * b * (x[1] - x[0] ** 2),
            ]
        )
        return f, g

    ckpt = tmp_path / "lbfgs.npz"
    full = minimize_lbfgs(fg, np.array([-1.2, 1.0]), max_iterations=200)

    # run with a tiny budget, checkpointing every iteration
    partial = minimize_lbfgs(
        fg, np.array([-1.2, 1.0]), max_iterations=10,
        checkpoint_path=ckpt, checkpoint_every=2,
    )
    assert ckpt.exists() and partial.f > full.f

    calls_before_resume = calls["n"]
    resumed = minimize_lbfgs(
        fg, np.array([-1.2, 1.0]), max_iterations=200,
        checkpoint_path=ckpt, checkpoint_every=50,
    )
    assert resumed.f < 1e-9
    # resume skipped the first ~8 checkpointed iterations of work
    assert calls["n"] - calls_before_resume < full.fun_evals


def test_lbfgs_nearly_linear_descent_no_crash():
    """Regression (code review): bracketing exhaustion on a nearly-linear
    objective used to crash unpacking a None bracket."""
    def fg(x):
        f = -x[0] + x[0] ** 2 / 1e9
        g = np.array([-1.0 + 2 * x[0] / 1e9])
        return f, g

    res = minimize_lbfgs(fg, np.zeros(1), max_iterations=50, max_fun_evals=200)
    assert np.isfinite(res.f)
    assert res.x[0] > 0  # made progress downhill


def test_lbfgs_line_search_failure_not_converged():
    """A line search that cannot move must not report convergence."""
    calls = {"n": 0}

    def fg(x):
        calls["n"] += 1
        # f decreases at x=0 (descent direction exists) but every trial
        # point the line search can visit violates Armijo: a sharp wall
        f = 1e6 * np.abs(x[0]) if x[0] != 0 else 0.0
        g = np.array([-1.0]) if x[0] == 0 else np.array([1e6 * np.sign(x[0])])
        return f, g

    res = minimize_lbfgs(fg, np.zeros(1), max_iterations=5, max_fun_evals=100)
    # the start point (f=0) is the only reachable return, so res.f is
    # always 0 here — the assertion must be on the convergence claim
    assert not res.converged
    assert res.f == 0.0 and res.x[0] == 0.0


def test_lbfgs_nan_gradient_terminates_with_status():
    """Regression (code review): a NaN value/gradient used to sail
    through every tolerance comparison and die in the line search's
    descent assertion — it must terminate with a clean status like the
    device optimizer does."""
    def fg(x):
        if x[0] > 0.4:  # blow up away from the start
            return np.nan, np.array([np.nan])
        return -x[0], np.array([-1.0])

    res = minimize_lbfgs(fg, np.zeros(1), max_iterations=50)
    assert res.message in ("NonFinite", "LineSearchFailed")
    assert not res.converged

    # NaN from the very first gradient
    res0 = minimize_lbfgs(
        lambda x: (np.nan, np.full(1, np.nan)), np.zeros(1),
        max_iterations=5,
    )
    assert res0.message == "NonFinite"


def test_lbfgs_restore_with_smaller_history(tmp_path):
    """Regression (code review): restoring a checkpoint written with a
    larger history must trim to the newest `history` pairs, not run the
    two-loop with more pairs than the configuration maintains."""
    def fg(x):
        a, b = 1.0, 100.0
        f = (a - x[0]) ** 2 + b * (x[1] - x[0] ** 2) ** 2
        g = np.array(
            [
                -2 * (a - x[0]) - 4 * b * x[0] * (x[1] - x[0] ** 2),
                2 * b * (x[1] - x[0] ** 2),
            ]
        )
        return f, g

    ckpt = tmp_path / "l.npz"
    minimize_lbfgs(
        fg, np.array([-1.2, 1.0]), max_iterations=30, history=10,
        checkpoint_path=ckpt, checkpoint_every=2,
    )
    with np.load(ckpt) as ck:
        assert int(ck["n_hist"]) > 3  # the premise: more pairs on disk
    res = minimize_lbfgs(
        fg, np.array([-1.2, 1.0]), max_iterations=200, history=3,
        checkpoint_path=ckpt, checkpoint_every=1000,
    )
    assert res.f < 1e-9  # still converges from the trimmed state


def test_interp_stack_accepts_generators():
    """Regression (code review): a generator `stack` was exhausted by the
    first pass and silently returned []."""
    import jax.numpy as jnp

    from gp_dla_detection.ops.interp import interp_stack_uniform

    xp = jnp.linspace(0.0, 1.0, 11)
    a = jnp.sin(xp)
    b = jnp.stack([xp, xp**2], axis=1)
    x = jnp.asarray([0.05, 0.55, 0.95])
    lists = interp_stack_uniform(xp, [a, b], x)
    gens = interp_stack_uniform(xp, (v for v in [a, b]), x)
    assert len(gens) == 2
    for got, want in zip(gens, lists):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_device_lbfgs_rosenbrock():
    import jax
    import jax.numpy as jnp

    from gp_dla_detection.ops.lbfgs_device import minimize_lbfgs_device

    vg = jax.value_and_grad(
        lambda x: (1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2
    )
    res = minimize_lbfgs_device(vg, jnp.array([-1.2, 1.0]), max_iterations=300)
    assert res.f < 1e-8
    np.testing.assert_allclose(res.x, [1.0, 1.0], atol=1e-4)


def _small_training_problem(N=300, seed=9):
    rng = np.random.default_rng(seed)
    R, k = 64, 2
    params = Parameters(
        null_model=NullModelParams(
            min_lambda=1000.0, max_lambda=1000.0 + 0.25 * (R - 1), k=k
        ),
        optimization=dataclassesreplace_opt(),
    )
    grid = params.null_model.rest_wavelengths()
    true_M = rng.normal(size=(R, k)) * 0.4
    wavelengths, flux, noise, masks = [], [], [], []
    for _ in range(N):
        cov_noise = rng.uniform(0.01, 0.02, size=R)
        y = 1.0 + true_M @ rng.normal(size=k) + rng.normal(size=R) * np.sqrt(
            0.15**2 + cov_noise
        )
        wavelengths.append(grid * 3.5)
        flux.append(y)
        noise.append(cov_noise)
        masks.append(np.zeros(R, bool))
    data = prepare_training_data(
        wavelengths, flux, noise, masks, np.full(N, 2.5), params
    )
    return data, params


def test_device_lbfgs_matches_host_on_gp_training():
    """The device-resident optimizer (one jitted lax.while_loop) must
    reach the host strong-Wolfe optimizer's NLL to progTol."""
    data, params = _small_training_problem()
    _, res_host = learn_gp_model(data, params, optimizer="host")
    _, res_dev = learn_gp_model(data, params, optimizer="device")
    assert res_dev.message in ("optTol", "progTol_step", "progTol_f", "MaxIter")
    assert abs(res_host.f - res_dev.f) < 1e-6 * abs(res_host.f)


def test_device_lbfgs_checkpoint_resume(tmp_path):
    """Interrupted device run + resume == uninterrupted run (the state
    file carries the full curvature history and counters)."""
    from gp_dla_detection.ops.lbfgs_device import minimize_lbfgs_device
    import jax
    import jax.numpy as jnp

    vg = jax.value_and_grad(
        lambda x: jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)
    )
    x0 = jnp.full(10, -1.0)
    ck = tmp_path / "lbfgs_state.npz"

    direct = minimize_lbfgs_device(vg, x0, max_iterations=120)
    partial_run = minimize_lbfgs_device(
        vg, x0, max_iterations=30, checkpoint_path=ck, checkpoint_every=10
    )
    assert partial_run.iterations == 30 and ck.exists()
    resumed = minimize_lbfgs_device(
        vg, x0, max_iterations=120, checkpoint_path=ck, checkpoint_every=10
    )
    assert resumed.iterations == direct.iterations
    assert abs(resumed.f - direct.f) <= 1e-12 * max(1.0, abs(direct.f))
    np.testing.assert_allclose(resumed.x, direct.x, rtol=1e-12)
