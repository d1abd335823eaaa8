"""Woodbury low-rank MVN logpdf vs dense scipy ground truth."""

import numpy as np
from scipy.stats import multivariate_normal

from gp_dla_detection.ops.low_rank_mvn import (
    batched_dla_log_likelihoods,
    log_mvnpdf_low_rank,
)


def random_problem(rng, n=300, k=7):
    y = rng.normal(size=n)
    mu = rng.normal(size=n)
    M = rng.normal(size=(n, k)) / np.sqrt(k)
    d = rng.uniform(0.1, 2.0, size=n)
    return y, mu, M, d


def dense_logpdf(y, mu, M, d):
    cov = M @ M.T + np.diag(d)
    return multivariate_normal.logpdf(y, mean=mu, cov=cov)


def test_log_mvnpdf_low_rank_matches_dense():
    rng = np.random.default_rng(1)
    for _ in range(5):
        y, mu, M, d = random_problem(rng)
        ours = float(log_mvnpdf_low_rank(y, mu, M, d))
        exact = dense_logpdf(y, mu, M, d)
        assert abs(ours - exact) < 1e-9 * abs(exact)


def test_masked_equals_sliced():
    rng = np.random.default_rng(2)
    y, mu, M, d = random_problem(rng, n=200, k=5)
    mask = rng.uniform(size=200) > 0.3

    ours = float(log_mvnpdf_low_rank(y, mu, M, d, mask=mask))
    exact = dense_logpdf(y[mask], mu[mask], M[mask], d[mask])
    assert abs(ours - exact) < 1e-9 * abs(exact)


def test_batched_dla_likelihoods_match_loop():
    """The batched sample-axis evidence must equal per-sample evaluation
    of log N(y; mu*a, (M a)(M a)' + diag(omega2 a^2 + noise)) — the
    quantity the reference computes per parfor iteration
    (process_qsos.m:186-197)."""
    rng = np.random.default_rng(3)
    n, k, S = 250, 6, 17
    y, mu, M, _ = random_problem(rng, n=n, k=k)
    omega2 = rng.uniform(0.01, 0.5, size=n)
    noise = rng.uniform(0.05, 1.0, size=n)
    mask = rng.uniform(size=n) > 0.2
    absorption = np.clip(rng.uniform(0.0, 1.0, size=(S, n)), 1e-8, 1.0)

    ours = np.asarray(
        batched_dla_log_likelihoods(y, mu, M, omega2, noise, mask, absorption)
    )
    assert ours.shape == (S,)

    for s in range(S):
        a = absorption[s][mask]
        exact = dense_logpdf(
            y[mask],
            mu[mask] * a,
            M[mask] * a[:, None],
            omega2[mask] * a**2 + noise[mask],
        )
        assert abs(ours[s] - exact) < 1e-8 * abs(exact)


def test_null_model_is_absorption_one():
    """With a == 1 the batched evidence reduces to the null-model
    log likelihood (process_qsos.m:149-152)."""
    rng = np.random.default_rng(4)
    n, k = 180, 5
    y, mu, M, _ = random_problem(rng, n=n, k=k)
    omega2 = rng.uniform(0.01, 0.5, size=n)
    noise = rng.uniform(0.05, 1.0, size=n)
    mask = np.ones(n, bool)

    batched = float(
        batched_dla_log_likelihoods(
            y, mu, M, omega2, noise, mask, np.ones((1, n))
        )[0]
    )
    direct = float(log_mvnpdf_low_rank(y, mu, M, omega2 + noise))
    assert abs(batched - direct) < 1e-10 * abs(direct)


def test_fuzz_masked_woodbury_vs_dense():
    """Property-based fuzz: random shapes/masks/conditioning, always
    matching the dense logpdf."""
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=25, deadline=None)
    @given(
        n=st.integers(10, 120),
        k=st.integers(1, 12),
        seed=st.integers(0, 2**31 - 1),
        mask_frac=st.floats(0.0, 0.6),
        scale=st.floats(1e-3, 1e3),
    )
    def run(n, k, seed, mask_frac, scale):
        rng = np.random.default_rng(seed)
        y = rng.normal(size=n) * scale
        mu = rng.normal(size=n) * scale
        M = rng.normal(size=(n, k)) * scale / np.sqrt(k)
        d = rng.uniform(0.1, 2.0, size=n) * scale**2
        mask = rng.uniform(size=n) > mask_frac
        if mask.sum() < k + 2:
            mask[: k + 2] = True
        ours = float(log_mvnpdf_low_rank(y, mu, M, d, mask=mask))
        exact = dense_logpdf(y[mask], mu[mask], M[mask], d[mask])
        assert abs(ours - exact) < 1e-8 * max(abs(exact), 1.0)

    run()


import pytest  # noqa: E402


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_matmul_precision_per_dtype(dtype, monkeypatch):
    """float32 matmuls run at low_rank_mvn.F32_PRECISION (one constant
    for the whole path); float64 always at HIGHEST."""
    import jax
    import jax.numpy as jnp

    from gp_dla_detection.ops import low_rank_mvn

    rng = np.random.default_rng(0)
    n, k, s = 40, 3, 5
    args = (
        jnp.asarray(rng.normal(size=n), dtype),
        jnp.asarray(np.ones(n), dtype),
        jnp.asarray(rng.normal(size=(n, k)) * 0.1, dtype),
        jnp.asarray(np.full(n, 0.04), dtype),
        jnp.asarray(np.full(n, 0.1), dtype),
        jnp.asarray(np.ones(n, bool)),
        jnp.asarray(rng.uniform(0.5, 1.0, (s, n)), dtype),
    )
    for prec in (jax.lax.Precision.DEFAULT, jax.lax.Precision.HIGHEST):
        monkeypatch.setattr(low_rank_mvn, "F32_PRECISION", prec)
        # a fresh function per setting: jit caches traces per function
        fn = low_rank_mvn.batched_dla_log_likelihoods.__wrapped__
        hlo = jax.jit(lambda *a: fn(*a)).lower(*args).as_text()
        want = prec if dtype == np.float32 else jax.lax.Precision.HIGHEST
        dots = [ln for ln in hlo.splitlines() if "dot_general" in ln]
        assert dots
        if want == jax.lax.Precision.HIGHEST:
            assert all("HIGHEST" in ln for ln in dots)
        else:
            assert not any("HIGHEST" in ln for ln in dots)
