"""Device-resident L-BFGS: the whole optimizer loop under one jit.

The host two-loop L-BFGS in :mod:`lbfgs` evaluates the jitted objective
once per line-search trial, which costs a full host<->device round trip
per evaluation.  This variant keeps the ENTIRE optimize loop
on device (replacing minFunc, learn_qso_model.m:100-101): two-loop
recursion over fixed circular history buffers, a backtracking-Armijo
line search, curvature-pair updates, and all termination tests run
inside a single ``lax.while_loop``; the host only fetches a handful of
scalars (and the iterate, for callbacks/checkpoints) once per segment
of iterations.

Design notes for XLA:
  - the objective graph is instantiated exactly once (inside the
    line-search body); the accepted trial's (f, g) seed the next
    iteration, so no extra gradient evaluation per step,
  - history buffers are fixed (m, n) arrays with a circular counter;
    unused slots carry rho = 0, which zeroes their two-loop
    contributions without masks,
  - the iteration budget is a *dynamic* carry bound, so segmented
    execution (for callbacks/checkpoints) reuses one compilation.

Differences from the host version (documented, deliberate): the line
search is backtracking-Armijo rather than strong Wolfe — the curvature
condition is not enforced, but curvature pairs are only stored when
y's > 1e-10, which preserves positive definiteness; in practice the
unit step is accepted almost always after warmup and both optimizers
reach the same NLL to progTol (tests/test_training.py).
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .lbfgs import LBFGSResult

__all__ = ["minimize_lbfgs_device", "make_lbfgs_runner"]

_RUNNING, _OPT_TOL, _PROG_STEP, _PROG_F, _LS_FAILED = 0, 1, 2, 3, 4
_MESSAGES = {
    _RUNNING: "MaxIter",
    _OPT_TOL: "optTol",
    _PROG_STEP: "progTol_step",
    _PROG_F: "progTol_f",
    _LS_FAILED: "LineSearchFailed",
}


def _two_loop(g, S, Y, rho, count):
    """H·(-g) via the two-loop recursion over circular buffers.

    Slots with rho == 0 (never filled, or cleared on reset) contribute
    exactly zero in both passes, so no validity masks are needed.
    """
    m = rho.shape[0]

    def bw(i, carry):
        q, alphas = carry
        idx = (count - 1 - i) % m
        a = rho[idx] * jnp.dot(S[idx], q)
        return q - a * Y[idx], alphas.at[i].set(a)

    q, alphas = lax.fori_loop(
        0, m, bw, (-g, jnp.zeros((m,), g.dtype))
    )
    last = (count - 1) % m
    ynorm2 = jnp.dot(Y[last], Y[last])
    gamma = jnp.where(
        count > 0,
        jnp.dot(S[last], Y[last]) / jnp.where(ynorm2 > 0.0, ynorm2, 1.0),
        1.0,
    )
    q = q * gamma

    def fw(j, q):
        i = m - 1 - j
        idx = (count - 1 - i) % m
        b = rho[idx] * jnp.dot(Y[idx], q)
        return q + (alphas[i] - b) * S[idx]

    return lax.fori_loop(0, m, fw, q)


def make_lbfgs_runner(
    value_and_grad_fn,
    history: int = 10,
    opt_tol: float = 1e-5,
    prog_tol: float = 1e-9,
    c1: float = 1e-4,
    max_ls: int = 25,
    max_fun_evals: int = 4000,
):
    """Build the jitted segment runner.

    value_and_grad_fn(x, *args) -> (f, g) must be jit-traceable; *args
    (the training matrices) are threaded through as jit ARGUMENTS —
    closures would bake them into the HLO as literals (CLAUDE.md).

    Returns (init, run): ``state = init(x0, *args)``;
    ``state = run(state, it_target, *args)`` advances the while_loop
    until a termination status or ``it >= it_target``.
    """
    m = history

    @jax.jit
    def init(x0, *args):
        f0, g0 = value_and_grad_fn(x0, *args)
        n = x0.shape[0]
        return {
            "x": x0,
            "f": f0,
            "g": g0,
            "S": jnp.zeros((m, n), x0.dtype),
            "Y": jnp.zeros((m, n), x0.dtype),
            "rho": jnp.zeros((m,), x0.dtype),
            "count": jnp.asarray(0, jnp.int32),
            "it": jnp.asarray(0, jnp.int32),
            "evals": jnp.asarray(1, jnp.int32),
            "status": jnp.asarray(_RUNNING, jnp.int32),
        }

    @jax.jit
    def run(state, it_target, *args):
        def fg(x):
            return value_and_grad_fn(x, *args)

        def cond(st):
            return (
                (st["status"] == _RUNNING)
                & (st["it"] < it_target)
                & (st["evals"] < max_fun_evals)
                & (jnp.max(jnp.abs(st["g"])) > opt_tol)
            )

        def body(st):
            x, f, g = st["x"], st["f"], st["g"]
            S, Y, rho, count = st["S"], st["Y"], st["rho"], st["count"]

            p = _two_loop(g, S, Y, rho, count)
            d0 = jnp.dot(g, p)
            # safeguard: non-descent direction -> steepest descent + reset
            bad = d0 >= 0.0
            p = jnp.where(bad, -g, p)
            d0 = jnp.where(bad, -jnp.dot(g, g), d0)
            rho = jnp.where(bad, jnp.zeros_like(rho), rho)
            count = jnp.where(bad, 0, count)

            t0 = jnp.where(
                count > 0,
                jnp.asarray(1.0, x.dtype),
                jnp.minimum(1.0, 1.0 / jnp.sum(jnp.abs(g))).astype(x.dtype),
            )

            def ls_cond(c):
                _, _, _, accepted, ls_evals = c
                # the eval budget binds per EVALUATION like the host
                # optimizer (lbfgs.py): without the second clause a
                # backtracking search entered at evals = budget-1 could
                # overshoot by up to max_ls-1 objective evaluations
                return (
                    (~accepted)
                    & (ls_evals < max_ls)
                    & (st["evals"] + ls_evals < max_fun_evals)
                )

            def ls_body(c):
                t, _, _, _, ls_evals = c
                f_t, g_t = fg(x + t * p)
                ok = jnp.isfinite(f_t) & (f_t <= f + c1 * t * d0)
                return (
                    jnp.where(ok, t, 0.5 * t),
                    f_t,
                    g_t,
                    ok,
                    ls_evals + 1,
                )

            t, f_t, g_t, accepted, ls_evals = lax.while_loop(
                ls_cond,
                ls_body,
                (t0, f, g, jnp.asarray(False), jnp.asarray(0, jnp.int32)),
            )

            step = t * p
            x_new = jnp.where(accepted, x + step, x)
            f_new = jnp.where(accepted, f_t, f)
            g_new = jnp.where(accepted, g_t, g)

            y_vec = g_t - g
            ys = jnp.dot(y_vec, step)
            store = accepted & (ys > 1e-10)
            idx = count % m
            ys_safe = jnp.where(store, ys, 1.0)
            S = S.at[idx].set(jnp.where(store, step, S[idx]))
            Y = Y.at[idx].set(jnp.where(store, y_vec, Y[idx]))
            rho = rho.at[idx].set(jnp.where(store, 1.0 / ys_safe, rho[idx]))
            count = count + store.astype(jnp.int32)

            # a search stopped by the eval budget is not a line-search
            # FAILURE: leave status _RUNNING so the outer loop/driver
            # terminates with the MaxFunEvals message instead
            budget_stop = (~accepted) & (
                st["evals"] + ls_evals >= max_fun_evals
            )
            status = jnp.where(
                budget_stop,
                _RUNNING,
                jnp.where(
                    ~accepted,
                    _LS_FAILED,
                    jnp.where(
                        jnp.max(jnp.abs(step)) <= prog_tol,
                        _PROG_STEP,
                        jnp.where(
                            jnp.abs(f - f_new) < prog_tol, _PROG_F, _RUNNING
                        ),
                    ),
                ),
            ).astype(jnp.int32)

            return {
                "x": x_new,
                "f": f_new,
                "g": g_new,
                "S": S,
                "Y": Y,
                "rho": rho,
                "count": count,
                "it": st["it"] + 1,
                "evals": st["evals"] + ls_evals,
                "status": status,
            }

        return lax.while_loop(cond, body, state)

    return init, run


def minimize_lbfgs_device(
    value_and_grad_fn,
    x0,
    *args,
    max_iterations: int = 2000,
    max_fun_evals: int = 4000,
    history: int = 10,
    opt_tol: float = 1e-5,
    prog_tol: float = 1e-9,
    c1: float = 1e-4,
    max_ls: int = 25,
    callback=None,
    checkpoint_path=None,
    checkpoint_every: int = 50,
    segment: int | None = None,
) -> LBFGSResult:
    """Drop-in device-resident counterpart of :func:`lbfgs.minimize_lbfgs`.

    value_and_grad_fn(x, *args) -> (f, g), jit-traceable; x0 and *args
    are placed on device once.  The loop runs in segments of
    ``segment`` iterations (default: checkpoint_every when
    checkpointing or a callback is set, else the full budget), fetching
    only scalars + the iterate between segments.
    """
    init, run = make_lbfgs_runner(
        value_and_grad_fn,
        history=history,
        opt_tol=opt_tol,
        prog_tol=prog_tol,
        c1=c1,
        max_ls=max_ls,
        max_fun_evals=max_fun_evals,
    )
    if segment is None:
        segment = (
            checkpoint_every
            if (checkpoint_path is not None or callback is not None)
            else max_iterations
        )

    x0 = jnp.asarray(x0)
    state = None
    if checkpoint_path is not None and Path(checkpoint_path).exists():
        with np.load(checkpoint_path) as ck:
            if "S" in ck and ck["x"].shape == x0.shape and ck["S"].shape[0] == history:
                state = {
                    k: jnp.asarray(ck[k])
                    for k in (
                        "x", "f", "g", "S", "Y", "rho",
                        "count", "it", "evals", "status",
                    )
                }
    if state is None:
        state = init(x0, *args)

    def save_checkpoint(st):
        if checkpoint_path is None:
            return
        tmp = str(checkpoint_path) + ".tmp.npz"
        np.savez(tmp, **{k: np.asarray(v) for k, v in st.items()})
        Path(tmp).replace(checkpoint_path)

    while True:
        it = int(state["it"])
        if (
            int(state["status"]) != _RUNNING
            or it >= max_iterations
            or int(state["evals"]) >= max_fun_evals
            or float(np.max(np.abs(np.asarray(state["g"])))) <= opt_tol
        ):
            break
        target = min(it + segment, max_iterations)
        state = run(state, jnp.asarray(target, jnp.int32), *args)
        if callback is not None:
            callback(
                int(state["it"]) - 1,
                np.asarray(state["x"]),
                float(state["f"]),
                np.asarray(state["g"]),
            )
        if checkpoint_path is not None:
            save_checkpoint(state)

    g = np.asarray(state["g"], np.float64)
    status = int(state["status"])
    if status != _RUNNING:
        message = _MESSAGES[status]
    elif np.max(np.abs(g)) <= opt_tol:
        message = "optTol"
    elif int(state["evals"]) >= max_fun_evals:
        message = "MaxFunEvals"
    else:
        message = "MaxIter"
    return LBFGSResult(
        x=np.asarray(state["x"], np.float64),
        f=float(state["f"]),
        g=g,
        iterations=int(state["it"]),
        fun_evals=int(state["evals"]),
        message=message,
    )
