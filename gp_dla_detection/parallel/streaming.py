"""Narrow-dtype result streaming.

At survey scale the dominant host<->device traffic is fetching the
(B, num_samples) per-sample log-likelihood matrices — 82 MB per 1024x10k
f32 batch pair — and checkpointing them.  The analysis layer only ever uses these matrices through
per-spectrum normalization (logsumexp evidences, posterior resampling
weights), so the wire format can be narrowed losslessly-where-it-matters:

    per-row finite max  (f32, B values)   +
    residual ll - max   (f16/bf16, B x S) — residuals are <= 0, and a
    residual below the f16 clamp (-65504) carries posterior weight
    e^-65504 = 0 in any dtype, so the clamp-to--inf is harmless.

Reconstruction (residual + max) returns f32 rows with relative error
~2^-11 on the dominant samples — far inside the documented sample-
probability tolerance.  f64 runs (parity mode) are never narrowed.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .mesh import fetch_global

__all__ = [
    "fetch_rows",
    "pack_rows",
    "pack_lean",
    "fetch_packed_rows",
    "fetch_packed_host",
    "reconstruct_rows",
    "checkpoint_payload",
    "rows_from_checkpoint",
]


@jax.jit
def pack_lean(sll):
    """Per-spectrum reduction of a (B, S) sample-likelihood matrix for
    catalog-only ("lean") runs: the DLA evidence and the MAP sample
    index, computed ON DEVICE so the matrix never crosses the wire.

    The evidence is the same max + log(mean(exp(ll - max))) form as
    :func:`gp_dla_detection.inference.finalize_posteriors`
    (process_qsos.m:200-232), evaluated at the run dtype from the exact
    device values (no f16 wire round trip — lean evidences are at least
    as accurate as full-mode ones).  NaN rows propagate to a NaN
    evidence exactly like the host np.max/np.mean path.  The MAP index
    treats NaN as -inf; rows with NO finite entry return -1, which the
    driver resolves to original index 0 AFTER any sample-sort
    translation — matching the catalog writer's np.nanargmax + guard
    (ascii_catalog.py, generate_ascii_catalog.m:74; a raw argmax of 0
    would otherwise be translated to the lowest-z sample on
    sample-sharded meshes).

    Returns (evidence (B,), map_index (B,) as float32 — exact for any
    S < 2**24; stacked with the other per-spectrum vectors into one
    fetch round trip by the sharded driver).
    """
    finite = jnp.where(jnp.isnan(sll), -jnp.inf, sll)
    best = jnp.max(finite, axis=1)
    map_ind = jnp.where(
        jnp.isfinite(best), jnp.argmax(finite, axis=1), -1
    )
    row_max = jnp.max(sll, axis=1)  # NaN propagates, like np.max
    evidence = row_max + jnp.log(
        jnp.mean(jnp.exp(sll - row_max[:, None]), axis=1)
    )
    return evidence, map_ind.astype(jnp.float32)


@partial(jax.jit, static_argnames=("wire_dtype",))
def _pack_rows(sll, wire_dtype):
    finite = jnp.where(jnp.isnan(sll), -jnp.inf, sll)
    row_max = jnp.max(finite, axis=1)
    # rows with no finite entry (e.g. every pair closer than min_sep_z)
    # keep offset 0 so NaN/-inf survive the round trip unchanged
    row_max = jnp.where(jnp.isfinite(row_max), row_max, 0.0)
    resid = (sll - row_max[:, None]).astype(wire_dtype)
    return resid, row_max.astype(jnp.float32)


def pack_rows(sll, stream_dtype: str | None):
    """ENQUEUE the narrow-dtype packing of a (B, S) device matrix and
    return the device-side packed representation (no host transfer).

    Split from :func:`fetch_rows` so pipelined drivers can put the pack
    computation on the device queue right behind the batch that
    produced it — packing at fetch time would execute AFTER the next
    batch's main computation (single device stream), stalling the fetch.
    """
    if (
        stream_dtype in (None, "float32", "native")
        or sll.dtype != jnp.float32
    ):
        return ("plain", sll)
    if stream_dtype not in ("float16", "bfloat16"):
        raise ValueError(
            f"unknown stream_dtype {stream_dtype!r} "
            "(float16|bfloat16|float32|None)"
        )
    resid, row_max = _pack_rows(sll, jnp.dtype(stream_dtype))
    return ("packed", resid, row_max)


def fetch_packed_host(packed):
    """Fetch a :func:`pack_rows` result to host WITHOUT reconstructing:
    ("plain", rows) or ("packed", resid_f16, row_max_f32).  Drivers keep
    this form for checkpoints (half the bytes of the reconstructed f32
    matrix) and reconstruct only for the in-memory result arrays."""
    if packed[0] == "plain":
        return ("plain", fetch_global(packed[1]))
    return ("packed", fetch_global(packed[1]), fetch_global(packed[2]))


def reconstruct_rows(host_packed) -> np.ndarray:
    """f32 rows from a :func:`fetch_packed_host` result (deterministic:
    resumed-from-checkpoint rows are bit-identical to freshly fetched)."""
    if host_packed[0] == "plain":
        return np.asarray(host_packed[1])
    _, resid, row_max = host_packed
    return resid.astype(np.float32) + row_max[:, None]


def fetch_packed_rows(packed) -> np.ndarray:
    """Host fetch + reconstruction of a :func:`pack_rows` result."""
    return reconstruct_rows(fetch_packed_host(packed))


def checkpoint_payload(rows_host, resid_key, row_max_key, plain_key) -> dict:
    """npz-safe dict for a :func:`fetch_packed_host` result.

    np.savez has no codec for ml_dtypes.bfloat16 — it silently writes a
    raw void ('|V2') array that cannot be .astype()'d back on resume —
    so bfloat16 residuals are stored as their uint16 bit pattern under
    ``<resid_key>_bf16``; float16 (the default wire format) and plain
    float32/float64 rows round-trip natively.
    """
    if rows_host[0] == "plain":
        return {plain_key: rows_host[1]}
    _, resid, row_max = rows_host
    if resid.dtype == np.float16:
        return {resid_key: resid, row_max_key: row_max}
    import ml_dtypes

    assert resid.dtype == ml_dtypes.bfloat16, resid.dtype
    return {resid_key + "_bf16": resid.view(np.uint16), row_max_key: row_max}


def rows_from_checkpoint(f, resid_key, row_max_key, plain_key) -> np.ndarray:
    """Reconstruct the (B, S) rows from a :func:`checkpoint_payload`
    npz — bit-identical to the live :func:`reconstruct_rows` path."""
    if resid_key in f:
        return f[resid_key].astype(np.float32) + f[row_max_key][:, None]
    if resid_key + "_bf16" in f:
        import ml_dtypes

        resid = f[resid_key + "_bf16"].view(ml_dtypes.bfloat16)
        return resid.astype(np.float32) + f[row_max_key][:, None]
    return f[plain_key]


def fetch_rows(sll, stream_dtype: str | None) -> np.ndarray:
    """Fetch a (B, S) device log-likelihood matrix to a host f32 array.

    stream_dtype: "float16" | "bfloat16" -> max+residual wire format
    (see module docstring); "float32" | None -> plain fetch.  Non-f32
    inputs (f64 parity mode) are always fetched as computed.
    """
    return fetch_packed_rows(pack_rows(sll, stream_dtype))
