"""Masked low-rank multivariate-normal log-density (Woodbury/Cholesky).

Rebuild of the reference's #1 hot kernel
(log_mvnpdf_low_rank.m:5-33), which computes

    log N(y; mu, M M' + diag(d))

via the Woodbury identity with a k x k Cholesky factorization
(B = I + M' D^-1 M).  The reference calls it 10,001 times per spectrum
(process_qsos.m:149-197); here the whole sample axis is batched into two
matmuls plus a batched k x k Cholesky:

 - the Gram matrices B_s = I + M' diag(w_s) M for all samples are one
   matmul of the per-sample weights (S, n) against the precomputed
   pair-product matrix P[:, (i,j)] = M[:, i] * M[:, j] (n, k(k+1)/2),
 - the projected residuals b_s = M' u_s are one (S, n) x (n, k) matmul,
 - scalar reductions (quadratic form, log det D) ride along, and
 - the S tiny k x k Cholesky factorizations/solves are batched XLA ops.

Masking replaces the reference's ragged per-spectrum index slicing
(objective.m:42-48, process_qsos.m:104-116): masked pixels get zero
weight in every sum, so all spectra share one static padded shape.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "log_mvnpdf_low_rank",
    "batched_dla_log_likelihoods",
    "pair_products",
    "woodbury_log_p",
]

LOG_2PI = 1.8378770664093454836  # log(2*pi)

# Matmul precision of the float32 path; float64 always uses HIGHEST.
F32_PRECISION = jax.lax.Precision.HIGH


def _precision(dtype):
    return F32_PRECISION if dtype == jnp.float32 else jax.lax.Precision.HIGHEST


def pair_products(M):
    """Upper-triangle pair products P[:, t] = M[:, i_t] * M[:, j_t].

    (n, k) -> (n, k*(k+1)/2).  Precomputable once per spectrum; turns the
    per-sample Gram accumulation into a single matmul.
    """
    k = M.shape[-1]
    iu, ju = np.triu_indices(k)
    return M[..., iu] * M[..., ju]


def _symmetrize_indices(k: int) -> np.ndarray:
    """Flat index map from packed upper triangle to full (k, k) matrix."""
    tri = np.zeros((k, k), dtype=np.int32)
    iu, ju = np.triu_indices(k)
    tri[iu, ju] = np.arange(iu.size)
    tri[ju, iu] = tri[iu, ju]
    return tri.reshape(-1)


def batched_spd_quad_logdet(B, b):
    """(b' B^-1 b, log det B) for batches of small SPD matrices.

    Unrolled rank-1-update Cholesky with fused forward substitution,
    vectorized over the batch instead of ``jnp.linalg.cholesky`` /
    ``solve_triangular`` on (N, k, k) batches.  Every index is static,
    so each of the k steps is a handful of batched elementwise ops.

    Stability: the Woodbury Gram matrix B = I + M'D^-1 M has all
    eigenvalues >= 1 and so do all its Schur complements — no pivoting
    needed and the sqrt/divide are always well-conditioned.
    """
    k = B.shape[-1]
    cols: list = []   # computed Cholesky columns, each (..., k)
    ys: list = []     # forward-substitution solution components
    quad = jnp.zeros(B.shape[:-2], B.dtype)
    logdet = jnp.zeros(B.shape[:-2], B.dtype)
    for j in range(k):
        # lazy column update: c_j = B[:, j] - sum_{m<j} L_m * L_m[j]
        # (reads prior columns instead of rewriting the whole matrix —
        # k x less HBM write traffic than the rank-1-update form)
        c = B[..., :, j]
        y_j = b[..., j]
        for m in range(j):
            c = c - cols[m] * cols[m][..., j, None]
            y_j = y_j - cols[m][..., j] * ys[m]
        djj = c[..., j]
        inv_sqrt = jax.lax.rsqrt(djj)
        cols.append(c * inv_sqrt[..., None])
        y_j = y_j * inv_sqrt
        ys.append(y_j)
        quad = quad + y_j * y_j
        logdet = logdet + jnp.log(djj)
    return quad, logdet


def woodbury_log_p(M, P, w, u, quad0, logdet_d, n_eff):
    """Batched Woodbury log-density core.

    Args:
      M: (n, k) low-rank factor (unscaled).
      P: (n, t) pair products of M (from :func:`pair_products`).
      w: (..., n) per-sample diagonal weights; for sample s the effective
         covariance is  (M a_s)(M a_s)' + D_s  with  w_s = a_s^2 / d_s
         (masked pixels: w = 0).
      u: (..., n) per-sample rhs vectors such that b_s = M' u_s; for the
         DLA model u_s = a_s * yc_s / d_s (masked pixels: 0).
      quad0: (...,) masked sum of yc^2 / d.
      logdet_d: (...,) masked sum of log d.
      n_eff: scalar or (...,) number of unmasked pixels.

    Returns:
      (...,) log N(y; mu_s, (M a_s)(M a_s)' + D_s).
    """
    k = M.shape[-1]
    dtype = M.dtype
    prec = _precision(dtype)

    b = jnp.matmul(u, M, precision=prec)          # (..., k)
    B_tri = jnp.matmul(w, P, precision=prec)      # (..., t)
    sym = _symmetrize_indices(k)
    B = B_tri[..., sym].reshape(*B_tri.shape[:-1], k, k)
    B = B + jnp.eye(k, dtype=dtype)

    bBb, logdet_B = batched_spd_quad_logdet(B, b)

    return -0.5 * (quad0 - bBb + logdet_d + logdet_B + n_eff * LOG_2PI)


def log_mvnpdf_low_rank(y, mu, M, d, mask=None):
    """log N(y; mu, M M' + diag(d)) with optional pixel mask.

    Direct equivalent of log_mvnpdf_low_rank.m:5-33.  ``mask`` is a
    boolean (n,) array; masked-out (False) pixels are excluded from the
    density exactly as the reference's index slicing excludes them.
    """
    y = jnp.asarray(y)
    dtype = y.dtype
    M = jnp.asarray(M, dtype)
    d = jnp.asarray(d, dtype)
    mu = jnp.asarray(mu, dtype)

    yc = y - mu
    if mask is None:
        valid = jnp.ones(y.shape, dtype=bool)
    else:
        valid = jnp.asarray(mask, bool)

    d_safe = jnp.where(valid, d, 1.0)
    inv_d = jnp.where(valid, 1.0 / d_safe, 0.0)
    yc = jnp.where(valid, yc, 0.0)

    u = yc * inv_d
    quad0 = jnp.sum(yc * u, axis=-1)
    logdet_d = jnp.sum(jnp.where(valid, jnp.log(d_safe), 0.0), axis=-1)
    n_eff = jnp.sum(valid, axis=-1).astype(dtype)

    # ONE weight vector per call: the Gram B = M' diag(w) M comes from a
    # direct (k, n) x (n, k) matmul.  The pair-product formulation
    # (woodbury_log_p) pays off only when many weight vectors share one
    # M (training: spectra axis; sampled evidence: QMC axis) — here it
    # would materialize an (n, k(k+1)/2) table per call for a single
    # (1, t) result row, pure HBM traffic on the inference null path.
    prec = _precision(dtype)
    k = M.shape[-1]
    B = jnp.matmul(
        jnp.swapaxes(M, -1, -2), M * inv_d[..., None], precision=prec
    ) + jnp.eye(k, dtype=dtype)
    b = jnp.matmul(u[..., None, :], M, precision=prec)[..., 0, :]
    bBb, logdet_B = batched_spd_quad_logdet(B, b)
    return -0.5 * (quad0 - bBb + logdet_d + logdet_B + n_eff * LOG_2PI)


@partial(jax.jit, static_argnames=())
def batched_dla_log_likelihoods(y, mu, M, omega2, noise_variance, mask, absorption):
    """Per-sample DLA-model log likelihoods for one spectrum.

    The batched equivalent of the reference's parfor body
    (process_qsos.m:184-198): for every QMC sample s with absorption
    profile a_s, evaluate

        log N(y; mu * a_s, (M a_s)(M a_s)' + diag(omega2 a_s^2 + sigma^2))

    without materializing the scaled mean/factor per sample — the
    absorption enters only through the per-sample weights w_s = a_s^2/d_s
    and rhs u_s = a_s (y - mu a_s) / d_s.

    Args:
      y, mu, omega2, noise_variance: (n,) padded spectrum arrays.
      M: (n, k) low-rank factor interpolated onto the spectrum's grid.
      mask: (n,) bool, True = valid pixel.
      absorption: (S, n) per-sample absorption profiles.

    Returns:
      (S,) log likelihoods.
    """
    dtype = y.dtype
    a = absorption.astype(dtype)
    valid = jnp.asarray(mask, bool)

    d = omega2 * a * a + noise_variance          # (S, n)
    d_safe = jnp.where(valid, d, 1.0)
    inv_d = jnp.where(valid, 1.0 / d_safe, 0.0)

    yc = jnp.where(valid, y - mu * a, 0.0)       # (S, n)
    w = a * a * inv_d
    u = a * yc * inv_d
    quad0 = jnp.sum(yc * yc * inv_d, axis=-1)
    logdet_d = jnp.sum(jnp.where(valid, jnp.log(d_safe), 0.0), axis=-1)
    n_eff = jnp.sum(valid, axis=-1).astype(dtype)

    P = pair_products(M)
    return woodbury_log_p(M, P, w, u, quad0, logdet_d, n_eff)
