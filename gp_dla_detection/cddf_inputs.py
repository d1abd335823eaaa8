"""Device-reduced CDDF inputs for lean (catalog-only) runs.

The reference's flagship science statistics — the column density
distribution function f(N), the line density dN/dX and Omega_DLA
(CDDF_analysis/calc_cddf.py:440-464, 490-507, 521-560) — marginalize
the per-spectrum normalized sample probabilities
(calc_cddf.py:87-99, 228-247).  The classic full-matrix driver ships
the whole (N, S) likelihood matrix to the host for that, 20 KB per
spectrum in float16.

This module reduces everything those statistics consume ON DEVICE,
inside the fused lean chain, into per-spectrum tensors that are tiny on
the wire (~12 KB/spectrum vs the 20 KB f16 matrix — and unlike the
matrix they are final, no host post-processing pass over (N, S)):

  - **binned small-probability masses** on fixed (z, log N_HI) grids
    chosen so the default statistics' bins are exact unions of grid
    cells (the Poisson tail of calc_cddf.py:724-780's per-bin split),
  - **exact entries** for every sample whose posterior probability
    reaches the Poisson-binomial "exact list" regime (p >= p_switch =
    0.25; at most 1/0.25 = 4 per spectrum since the normalized weights
    sum to p_dla <= ~1) — stored as sample INDICES so the host rebinds
    them to float64 (z, log N_HI) values exactly, with NO binning
    quantization on the statistically dominant entries,
  - **moment histograms** sum(p), sum(p * N_HI), sum(p (1-p)),
    sum(p (1-p) N_HI^2) feeding the direct Omega_DLA estimator
    (calc_cddf.py:829-870) — the N_HI weights are applied per sample
    on device, so within-bin moments are exact, not bin-center
    approximations.

Quantization relative to the classic path (documented contract; see
docs/ACCURACY.md and validation/lean_cddf_ab.py):

  1. small-p masses bin the sample redshift at the run dtype (f32 in
     production): a sample within ~1 ulp of a grid edge may land in
     the neighbouring bin.  Exact entries are immune (host f64 rebind).
  2. a sample exactly ON an interior bin edge belongs to NEITHER bin
     under the classic strict inequalities (calc_cddf.py:724-780) but
     to the right bin here (floor binning, = np.histogram semantics);
     measure-zero.
  3. per-sample thresholds (p > 1e-4, p >= 0.25) evaluate at the run
     dtype instead of host float64.
  4. statistics bins must be unions of the reduction grids' cells
     (every default configuration is); unaligned requests raise.
  5. ``lowzcut`` (per-spectrum proximity cut) and noisy-pixel excision
     cut samples at CONTINUOUS redshifts and are not representable in
     binned masses: LeanDLACatalogue refuses them (classic path only).

In float64 (XLA backend) the reduction is arithmetically identical to
the classic host computation except for <=1-ulp libm differences, and
the integer count statistics match exactly (tests/test_lean_cddf.py).
In float32 the classic path itself rides an f16 wire format
(parallel/streaming.py), so the lean reduction — computed from exact
device f32 values — is the MORE accurate of the two.
"""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "CDDFReductionSpec",
    "CDDFInputs",
    "make_cddf_reducer",
]

# channel layout of the (B, 8, n_z_window, n_lnhi+1) histogram tensor;
# the final lnhi column is the dump bin (samples outside the grid's
# open interval — the classic range cuts exclude them, but they must
# still be accounted for so sum(P_CHANNEL) == p_dla holds per spectrum)
CH_SMALL_A = 0      # sum p,         1e-4 < p < 0.25, grid A
CH_P = 1            # sum p,         all samples,     grid A
CH_P_NU = 2         # sum p*nu,      all samples,     grid A
CH_P_VAR = 3        # sum p*(1-p),   all samples,     grid A
CH_P_VAR_NU2 = 4    # sum p*(1-p)*nu^2, all,          grid A
CH_SMALL_B = 5      # sum p,         small,           grid B
CH_SMALL2_A = 6     # sum p2,        small, 2nd DLA,  grid A (by base z/N)
CH_SMALL2_B = 7     # sum p2,        small, 2nd DLA,  grid B
N_CHANNELS = 8


@dataclasses.dataclass(frozen=True)
class CDDFReductionSpec:
    """Static geometry of the device reduction.

    The two log-N_HI grids cover every binning the reference's
    statistics use by default: grid A (width 0.1 from 20.0) nests the
    CDDF's 30 bins over [20, 23] (calc_cddf.py:440-464) and the 20.3
    line-density cut; grid B (width 0.09 from 20.3) nests
    Omega_DLA(CDDF)'s 30 bins over [20.3, 23] and the 15-bin bootstrap
    variant (width 0.18).  The redshift grid at 1/6 per bin nests every
    ``bins_per_z = 6`` statistic with integer z endpoints
    (calc_cddf.py:49).
    """

    z_bins_per_unit: int = 6
    # per-spectrum z window, in fine z bins: must cover the widest DLA
    # search range (max_z - min_z <= ~1.2 for any z_QSO <= 7 given the
    # Lyb..Lya forest bounds, = ~8 bins); violations are counted on
    # device and raised loudly on the host
    n_z_window: int = 12
    lnhi_a_start: float = 20.0
    lnhi_a_width: float = 0.1
    lnhi_b_start: float = 20.3
    lnhi_b_width: float = 0.09
    n_lnhi: int = 30
    top_k: int = 8
    # thresholds mirror calc_cddf.py:42-56 (DLACatalogue)
    p_sample_min: float = 1e-4
    p_switch: float = 0.25
    # N_HI moment weights are stored as nu = 10^(lnhi - nu_log_offset)
    # so nu^2 sums stay in f32 range; the host multiplies the offset back
    nu_log_offset: float = 20.0

    def token(self) -> str:
        """Fingerprint component: any field change invalidates stored
        reductions."""
        return "cddf_inputs:v1:" + json.dumps(
            dataclasses.asdict(self), sort_keys=True
        )

    # ---- host-side grid helpers (shared with LeanDLACatalogue) ----

    def lnhi_bin_index(self, lnhi, grid: str) -> np.ndarray:
        """float64 bin index on grid 'a'|'b'; n_lnhi = the dump bin.

        Outer bounds are STRICT (samples at exactly the grid start/end
        are dumped), matching the classic open-interval range cuts."""
        start, width = (
            (self.lnhi_a_start, self.lnhi_a_width)
            if grid == "a"
            else (self.lnhi_b_start, self.lnhi_b_width)
        )
        lnhi = np.asarray(lnhi, np.float64)
        idx = np.floor((lnhi - start) / width).astype(np.int64)
        end = start + width * self.n_lnhi
        out = np.where(
            (lnhi > start) & (lnhi < end),
            np.clip(idx, 0, self.n_lnhi - 1),
            self.n_lnhi,
        )
        return out

    def match_lnhi_bins(self, q_bins) -> tuple[str, int] | None:
        """If ``q_bins`` is a contiguous run of one grid's edges,
        return (grid, first bin index); else None."""
        q = np.asarray(q_bins, np.float64)
        for grid, start, width in (
            ("a", self.lnhi_a_start, self.lnhi_a_width),
            ("b", self.lnhi_b_start, self.lnhi_b_width),
        ):
            j = (q - start) / width
            jr = np.round(j)
            if (
                np.all(np.abs(j - jr) < 1e-6)
                and np.all(np.diff(jr) >= 1)
                and jr[0] >= 0
                and jr[-1] <= self.n_lnhi
            ):
                return grid, jr.astype(np.int64)
        return None

    def match_z_edge(self, z: float) -> int:
        """Global fine z-bin index of an aligned z edge, or raise."""
        j = float(z) * self.z_bins_per_unit
        jr = round(j)
        if abs(j - jr) > 1e-6:
            raise ValueError(
                f"z edge {z} is not aligned with the lean reduction's "
                f"1/{self.z_bins_per_unit} redshift grid — lean-reduced "
                "CDDF inputs only support statistics whose bins are "
                "unions of the reduction grid cells (all defaults are); "
                "rerun with store_sample_likelihoods=True for arbitrary "
                "bins"
            )
        return int(jr)


# per-spectrum scalar row layout of CDDFInputs.ex beyond the 5 top-k
# blocks [ex1_p, ex1_idx, ex2_p, ex2_pair_idx, ex2_base_idx]
EX_W0 = 0          # window start (global fine z bin)
EX_NBIG1 = 1       # count of first-DLA p >= p_switch (must be <= top_k)
EX_NBIG2 = 2       # count of second-DLA p2 >= p_switch
EX_ZOVER = 3       # mass-carrying samples outside the z window (must be 0)
N_EX_SCALARS = 4


@dataclasses.dataclass
class CDDFInputs:
    """Host-side container for the fetched reductions.

    hist: (N, 8, n_z_window, n_lnhi+1) float32/float64 (run dtype).
    ex:   (N, 5*top_k + 4): [ex1_p | ex1_idx | ex2_p | ex2_pair_idx |
          ex2_base_idx | w0, nbig1, nbig2, zover].  Indices are exact
          (< 2**24 guard in the lean driver); pair indices are in
          ORIGINAL sample numbering (the driver translates sorted pair
          columns before storing).  second=False runs store -1/0 blocks.
    """

    spec: CDDFReductionSpec
    hist: np.ndarray
    ex: np.ndarray
    second: bool = True

    # ---- field accessors ----
    def _blk(self, i):
        k = self.spec.top_k
        return self.ex[:, i * k : (i + 1) * k]

    @property
    def ex1_p(self):
        return self._blk(0)

    @property
    def ex1_idx(self):
        return self._blk(1).astype(np.int64)

    @property
    def ex2_p(self):
        return self._blk(2)

    @property
    def ex2_idx(self):
        return self._blk(3).astype(np.int64)

    @property
    def ex2_base(self):
        return self._blk(4).astype(np.int64)

    def scalar(self, which: int):
        return self.ex[:, 5 * self.spec.top_k + which]

    def validate(self) -> None:
        """Loud integrity checks on the device counters."""
        zover = self.scalar(EX_ZOVER)
        if np.any(zover > 0):
            bad = int(np.flatnonzero(zover > 0)[0])
            raise ValueError(
                f"{int((zover > 0).sum())} spectra (first: row {bad}) "
                "have posterior mass outside the lean reduction's "
                f"{self.spec.n_z_window}-bin redshift window — increase "
                "CDDFReductionSpec.n_z_window (the DLA search range is "
                "wider than the spec assumed)"
            )
        for name, n in (("first", EX_NBIG1), ("second", EX_NBIG2)):
            nbig = self.scalar(n)
            if np.any(nbig > self.spec.top_k):
                raise ValueError(
                    f"a spectrum has {int(nbig.max())} {name}-DLA samples "
                    f"above p_switch but the reduction stored only "
                    f"top_k={self.spec.top_k} exact entries — increase "
                    "CDDFReductionSpec.top_k (normalized probabilities "
                    "bound this by 1/p_switch = 4, so this indicates "
                    "corrupt inputs)"
                )

    # ---- persistence (flat npz-compatible dict, "cddf_" prefix) ----
    def to_npz_dict(self, prefix: str = "cddf_") -> dict:
        return {
            prefix + "hist": self.hist,
            prefix + "ex": self.ex,
            prefix + "spec": np.frombuffer(
                json.dumps(dataclasses.asdict(self.spec)).encode(), np.uint8
            ),
            prefix + "second": np.asarray(self.second),
        }

    @classmethod
    def from_npz_dict(cls, d, prefix: str = "cddf_") -> "CDDFInputs":
        spec = CDDFReductionSpec(
            **json.loads(bytes(np.asarray(d[prefix + "spec"])).decode())
        )
        return cls(
            spec=spec,
            hist=np.asarray(d[prefix + "hist"]),
            ex=np.asarray(d[prefix + "ex"]),
            second=bool(np.asarray(d[prefix + "second"])),
        )

    @classmethod
    def npz_present(cls, files, prefix: str = "cddf_") -> bool:
        return prefix + "hist" in files


def make_cddf_reducer(
    spec: CDDFReductionSpec,
    offset_samples,
    log_nhi_samples,
    dtype,
    replicated_sharding=None,
):
    """Build the jittable device reduction.

    Args:
      offset_samples, log_nhi_samples: the (S,) QMC prior tables
        (ORIGINAL sample order).
      dtype: run dtype.
      replicated_sharding: optional jax sharding for the constant tables.

    Returns ``(reduce_fn, consts)``; call ``reduce_fn(consts, ...)``
    inside the fused chain.  ``reduce_fn(consts, sll, ev1, ll_null,
    min_z, max_z, lp_no, lp_dla, lp0m, lp1m, lp2m, ll2_pair, ev2,
    base_cols) -> (hist, ex)``; pass ``ll2_pair=None`` (with ev2/
    base_cols None) for single-stage (first-DLA-only) reductions.
    """
    offsets = np.asarray(offset_samples, np.float64)
    lnhis = np.asarray(log_nhi_samples, np.float64)
    S = len(offsets)
    nl = spec.n_lnhi
    W = spec.n_z_window
    K = spec.top_k

    def one_hot(grid):
        idx = spec.lnhi_bin_index(lnhis, grid)
        m = np.zeros((S, nl + 1), dtype)
        m[np.arange(S), idx] = 1.0
        return m

    nu = (10.0 ** (lnhis - spec.nu_log_offset)).astype(dtype)
    consts = {
        "off": np.asarray(offsets, dtype),
        "lh_a": one_hot("a"),
        "lh_b": one_hot("b"),
        "nu": nu,
        "nu2": (nu.astype(np.float64) ** 2).astype(dtype),
    }
    if replicated_sharding is not None:
        consts = {
            k: jax.device_put(v, replicated_sharding) for k, v in consts.items()
        }

    prec = jax.lax.Precision.HIGHEST

    def _z_binned(vals, masks, lh):
        """sum_j vals[b, c, j] * [zloc_j == z] * onehot_lnhi[j, l] via
        one masked matmul per z bin — no scatter.
        vals: (B, C, S); lh: (S, nl+1) one-hot; masks: W (B, S) {0,1}
        arrays.  Returns (B, C, W, nl+1)."""
        per_z = [
            jnp.einsum(
                "bcs,sl->bcl", vals * m[:, None, :], lh, precision=prec
            )
            for m in masks
        ]
        return jnp.stack(per_z, axis=2)

    def reduce_fn(
        c,
        sll,
        ev1,
        ll_null,
        min_z,
        max_z,
        lp_no,
        lp_dla,
        lp0m=None,
        lp1m=None,
        lp2m=None,
        ll2_pair=None,
        ev2=None,
        base_cols=None,
    ):
        dt = sll.dtype
        B = sll.shape[0]
        second = ll2_pair is not None

        # p_dla mirrors inference.posteriors_from_evidence exactly
        # (including the 1 - p0 form) so f64 runs reproduce the host
        # arithmetic to libm precision
        a = lp_no + ll_null
        b = lp_dla + ev1
        m2 = jnp.maximum(a, b)
        e0, e1 = jnp.exp(a - m2), jnp.exp(b - m2)
        p_dla = 1.0 - e0 / (e0 + e1)
        p_dla = jnp.where(jnp.isnan(p_dla), 0.0, p_dla)

        logw = sll - ev1[:, None] - jnp.log(jnp.asarray(S, dt))
        p = jnp.exp(logw) * p_dla[:, None]
        p = jnp.where(jnp.isnan(p), 0.0, p)

        bpz = jnp.asarray(spec.z_bins_per_unit, dt)
        zf = min_z[:, None] + (max_z - min_z)[:, None] * c["off"][None, :]
        w0 = jnp.floor(min_z * bpz)
        w0 = jnp.where(jnp.isfinite(w0), w0, 0.0).astype(jnp.int32)
        zloc_f = jnp.floor(zf * bpz)
        zloc = (
            jnp.where(jnp.isfinite(zloc_f), zloc_f, -1.0).astype(jnp.int32)
            - w0[:, None]
        )
        in_win = (zloc >= 0) & (zloc < W)
        masks = [(zloc == z).astype(dt) for z in range(W)]

        small1 = (p > spec.p_sample_min) & (p < spec.p_switch)
        ps = jnp.where(small1, p, 0.0)
        pvar = p * (1.0 - p)
        ch_a = jnp.stack(
            [ps, p, p * c["nu"], pvar, pvar * c["nu2"]], axis=1
        )  # (B, 5, S)
        ch_b = ps[:, None, :]
        z_over = jnp.sum((~in_win) & (p > 0), axis=1)

        ex1_p, ex1_i = jax.lax.top_k(p, K)
        nbig1 = jnp.sum(p >= spec.p_switch, axis=1)

        if second:
            # p(2 DLAs) mirrors multi_dla._multi_posteriors
            posts = jnp.stack(
                [lp0m + ll_null, lp1m + ev1, lp2m + ev2], axis=1
            )
            pmax = jnp.max(posts, axis=1, keepdims=True)
            e = jnp.exp(posts - pmax)
            p_dla2 = e[:, 2] / jnp.sum(e, axis=1)
            p_dla2 = jnp.where(jnp.isnan(p_dla2), 0.0, p_dla2)

            comb = ll2_pair + logw
            comb = jnp.where(jnp.isfinite(comb), comb, -jnp.inf)
            cmax = jnp.max(comb, axis=1)
            safe = jnp.where(jnp.isfinite(cmax), cmax, 0.0)
            lse = safe + jnp.log(
                jnp.sum(jnp.exp(comb - safe[:, None]), axis=1)
            )
            p2 = jnp.exp(comb - lse[:, None]) * p_dla2[:, None]
            p2 = jnp.where(jnp.isnan(p2), 0.0, p2)

            small2 = (p2 > spec.p_sample_min) & (p2 < spec.p_switch)
            p2s = jnp.where(small2, p2, 0.0)
            # bin by the SECOND component's (z, lnhi) = the base draw's:
            # group pair columns by base sample first (one scatter), then
            # the base sample's zloc/lnhi bins are the FIRST stage's own
            # tables — reuse the same masked matmuls
            acc = jnp.zeros((B, S), dt)
            acc = acc.at[jnp.arange(B)[:, None], base_cols].add(p2s)
            acc1 = acc[:, None, :]  # (B, 1, S)
            hist2 = jnp.concatenate(
                [
                    _z_binned(acc1, masks, c["lh_a"]),
                    _z_binned(acc1, masks, c["lh_b"]),
                ],
                axis=1,
            )

            ex2_p, ex2_i = jax.lax.top_k(p2, K)
            ex2_b = jnp.take_along_axis(base_cols, ex2_i, axis=1)
            nbig2 = jnp.sum(p2 >= spec.p_switch, axis=1)
        else:
            hist2 = jnp.zeros((B, 2, W, nl + 1), dt)
            ex2_p = jnp.zeros((B, K), dt)
            ex2_i = jnp.full((B, K), -1.0, dt)
            ex2_b = jnp.full((B, K), -1.0, dt)
            nbig2 = jnp.zeros((B,), jnp.int32)

        # channel axis: [smallA, p, p*nu, pvar, pvar*nu2,
        #                smallB, small2A, small2B]
        hist = jnp.concatenate(
            [
                _z_binned(ch_a, masks, c["lh_a"]),
                _z_binned(ch_b, masks, c["lh_b"]),
                hist2,
            ],
            axis=1,
        )

        idx_t = lambda x: x.astype(dt)
        ex = jnp.concatenate(
            [
                ex1_p,
                idx_t(ex1_i),
                ex2_p,
                idx_t(ex2_i),
                idx_t(ex2_b),
                idx_t(w0)[:, None],
                idx_t(nbig1)[:, None],
                idx_t(nbig2)[:, None],
                idx_t(z_over)[:, None],
            ],
            axis=1,
        )
        return hist, ex

    return reduce_fn, consts
