"""Lyβ-alias suspect flag (alias_flag.py): the deterministic re-fit
signature from the survey forensics, as a catalog flag."""

import numpy as np

from gp_dla_detection.alias_flag import (
    C_KMS,
    lyb_alias_suspect,
    map_pair_params,
)
from gp_dla_detection.inference import InferenceResults
from gp_dla_detection.multi_dla import MultiDLAResults
from gp_dla_detection.ops.lyman_series import TRANSITION_WAVELENGTHS

LYB_RATIO = TRANSITION_WAVELENGTHS[1] / TRANSITION_WAVELENGTHS[0]


def _single(n, min_z=2.0, max_z=3.0):
    z = np.zeros(n)
    return InferenceResults(
        min_z_dlas=np.full(n, min_z),
        max_z_dlas=np.full(n, max_z),
        log_priors_no_dla=z, log_priors_dla=z,
        log_likelihoods_no_dla=z, log_likelihoods_dla=z,
        sample_log_likelihoods_dla=None,
        map_sample_inds=np.zeros(n, np.int64),
        log_posteriors_no_dla=z, log_posteriors_dla=z,
        model_posteriors=np.tile([0.5, 0.5], (n, 1)),
        p_no_dlas=z + 0.5, p_dlas=z + 0.5,
    )


def _multi(i1, i2, n):
    return MultiDLAResults(
        single=_single(n),
        sample_log_likelihoods_dla2=None,
        base_sample_inds=None,
        log_likelihoods_dla2=np.zeros(n),
        log_priors_one_dla=np.zeros(n),
        log_priors_two_dla=np.zeros(n),
        model_posteriors=np.tile([0.0, 0.0, 1.0], (n, 1)),
        map_sample_inds2=np.asarray(i1, np.int64),
        map_base_sample_inds=np.asarray(i2, np.int64),
    )


def _tables():
    """Sample tables engineered so index -> (z, lnhi) is transparent.

    With min_z=2, max_z=3: z = 2 + offset.  Strong absorber at z=2.5
    (index 0).  Its Lyβ alias: 1+z_w = (λβ/λα)(1+z_s).
    """
    z_alias = LYB_RATIO * 3.5 - 1.0  # ~1.954 -> below min_z... use z_s high
    # place the strong absorber near the top so its alias is in range
    z_strong = 2.9
    z_alias = LYB_RATIO * (1 + z_strong) - 1.0  # ~2.29
    offsets = np.array([
        z_strong - 2.0,          # 0: the strong component
        z_alias - 2.0,           # 1: exact Lyβ alias
        z_alias - 2.0 + 0.02,    # 2: ~1700 km/s off the alias
        z_alias - 2.0,           # 3: alias again (pairs with high column)
    ])
    lnhis = np.array([21.5, 20.1, 20.1, 21.0])
    return offsets, lnhis


def test_flags_alias_refit_only():
    offsets, lnhis = _tables()
    # rows: (strong, alias weak) / (strong, off-velocity weak) /
    #        (strong, alias but HIGH column) / no valid pair
    multi = _multi([0, 0, 0, -1], [1, 2, 3, -1], 4)
    flags = lyb_alias_suspect(multi, offsets, lnhis)
    np.testing.assert_array_equal(flags, [True, False, False, False])


def test_order_invariance():
    """The weaker/stronger roles are by column, not argument order."""
    offsets, lnhis = _tables()
    multi = _multi([1], [0], 1)  # weak first, strong as base
    assert lyb_alias_suspect(multi, offsets, lnhis)[0]


def test_velocity_threshold():
    offsets, lnhis = _tables()
    multi = _multi([0, 0], [1, 2], 2)
    # row 1 sits ~0.02/(1+z) * c ~ 1800 km/s off: inside a loose cut
    flags = lyb_alias_suspect(multi, offsets, lnhis, dv_max_kms=3000.0)
    np.testing.assert_array_equal(flags, [True, True])
    flags = lyb_alias_suspect(multi, offsets, lnhis, dv_max_kms=100.0)
    np.testing.assert_array_equal(flags, [True, False])


def test_classic_matrix_path_matches_lean():
    """Full-matrix results (argmax on host) must flag identically to
    lean results carrying the device-reduced MAP indices."""
    offsets, lnhis = _tables()
    lean = _multi([0, 0, 0], [1, 2, 3], 3)
    n, S = 3, 4
    sll2 = np.full((n, S), -50.0)
    sll2[np.arange(n), [0, 0, 0]] = -1.0  # argmax at the fresh index
    base = np.tile(np.arange(S), (n, 1))
    base[0, 0] = 1
    base[1, 0] = 2
    base[2, 0] = 3
    classic = MultiDLAResults(
        single=_single(n),
        sample_log_likelihoods_dla2=sll2,
        base_sample_inds=base,
        log_likelihoods_dla2=np.zeros(n),
        log_priors_one_dla=np.zeros(n),
        log_priors_two_dla=np.zeros(n),
        model_posteriors=np.tile([0.0, 0.0, 1.0], (n, 1)),
    )
    np.testing.assert_array_equal(
        lyb_alias_suspect(classic, offsets, lnhis),
        lyb_alias_suspect(lean, offsets, lnhis),
    )
    for a, b in zip(
        map_pair_params(classic, offsets, lnhis),
        map_pair_params(lean, offsets, lnhis),
    ):
        np.testing.assert_allclose(a, b)


def test_ascii_multi_results(tmp_path):
    from gp_dla_detection.ascii_catalog import write_ascii_multi_results

    offsets, lnhis = _tables()
    multi = _multi([0, 0], [1, 2], 2)

    class Cat:
        thing_ids = np.array([11, 22])
        sdss_names = np.array([b"J0001", b"J0002"])

    class Samp:
        offset_samples = offsets
        log_nhi_samples = lnhis

    p = write_ascii_multi_results(
        tmp_path, "toy", Cat(), Samp(), multi, np.ones(2, bool)
    )
    lines = p.read_text().splitlines()
    assert len(lines) == 2
    assert lines[0].split()[-1] == "1"  # alias re-fit -> flagged
    assert lines[1].split()[-1] == "0"
    assert lines[0].split()[0] == "000000011"
