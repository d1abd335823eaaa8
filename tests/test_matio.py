"""MATLAB v7.3 interop: exported files must match the exact h5py access
pattern the reference's CDDF_analysis layer uses, and reference-style
files must import into our DLACatalogue."""

import numpy as np
import h5py

from gp_dla_detection.io.matio import (
    load_catalogue_from_matlab,
    read_mat,
    write_dla_samples_mat,
    write_mat,
    write_processed_mat,
    write_snrs_mat,
)

from test_analysis import make_synthetic_catalogue


def test_write_mat_orientation_and_userblock(tmp_path):
    p = tmp_path / "t.mat"
    write_mat(p, {"row": np.arange(5.0), "mat": np.arange(6.0).reshape(2, 3)})
    # MATLAB userblock magic
    head = open(p, "rb").read(116)
    assert head.startswith(b"MATLAB 7.3 MAT-file")
    with h5py.File(p, "r") as f:
        # 1-D arrays become MATLAB row vectors: h5py sees (N, 1)
        assert f["row"].shape == (5, 1)
        # 2-D arrays are transposed (column-major convention)
        assert f["mat"].shape == (3, 2)
        np.testing.assert_allclose(np.asarray(f["mat"]).T, np.arange(6.0).reshape(2, 3))


def test_processed_roundtrip_reference_access_pattern(tmp_path):
    """Write with our exporter, read back the way calc_cddf.py does."""
    rng = np.random.default_rng(0)
    cat = make_synthetic_catalogue(n_certain=5, n_empty=20, n_weak=5, S=50)

    class R:  # minimal InferenceResults stand-in from the catalogue
        min_z_dlas = cat._z_min
        max_z_dlas = cat._z_max
        log_priors_no_dla = np.full(30, -0.1)
        log_priors_dla = np.full(30, -2.0)
        log_likelihoods_no_dla = rng.normal(size=30)
        log_likelihoods_dla = rng.normal(size=30)
        sample_log_likelihoods_dla = (
            cat.log_norm_like + np.log(50)  # un-normalize arbitrarily
        )
        log_posteriors_no_dla = rng.normal(size=30)
        log_posteriors_dla = rng.normal(size=30)
        model_posteriors = rng.uniform(size=(30, 2))
        p_no_dlas = 1 - cat.p_dla
        p_dlas = cat.p_dla

    test_ind = np.ones(40)
    test_ind[30:] = 0
    write_processed_mat(R, test_ind, tmp_path / "processed_qsos_x.mat")

    with h5py.File(tmp_path / "processed_qsos_x.mat", "r") as f:
        # exactly the reference's reads (calc_cddf.py:59-99)
        z_min = f["min_z_dlas"][0]
        p_dla = f["p_dlas"][0]
        real_index = np.where(f["test_ind"][0] != 0)[0]
        log_norm_like = f["sample_log_likelihoods_dla"]
        assert z_min.shape == (30,)
        np.testing.assert_allclose(p_dla, cat.p_dla)
        assert real_index.size == 30
        assert log_norm_like.shape == (50, 30)  # (S, N) in the h5py view
        col = np.asarray(log_norm_like[:, 3])
        np.testing.assert_allclose(
            col, R.sample_log_likelihoods_dla[3], rtol=1e-12
        )


def test_samples_and_snrs_roundtrip(tmp_path):
    class S:
        offset_samples = np.linspace(0, 1, 50, endpoint=False)
        log_nhi_samples = np.linspace(20, 23, 50)
        nhi_samples = 10 ** np.linspace(20, 23, 50)

        class config:
            uniform_min_log_nhi = 20.0
            uniform_max_log_nhi = 23.0
            fit_min_log_nhi = 20.0
            fit_max_log_nhi = 22.0
            alpha = 0.9

    write_dla_samples_mat(S, tmp_path / "dla_samples.mat")
    with h5py.File(tmp_path / "dla_samples.mat", "r") as f:
        # calc_cddf.py:119-123 access pattern
        z_offsets = f["offset_samples"][:, 0]
        lnhi = f["log_nhi_samples"][:, 0]
        np.testing.assert_allclose(z_offsets, S.offset_samples)
        np.testing.assert_allclose(lnhi, S.log_nhi_samples)

    write_snrs_mat(np.arange(30.0), tmp_path / "snrs.mat")
    assert read_mat(tmp_path / "snrs.mat")["snrs"].size == 30


def test_import_reference_style_files(tmp_path):
    """Fabricate reference-layout .mat files and import them."""
    rng = np.random.default_rng(1)
    N, S = 25, 40
    sll = rng.normal(-5, 1, (S, N))
    lld = np.log(np.mean(np.exp(sll), axis=0))  # so probs normalize
    write_mat(
        tmp_path / "processed.mat",
        {
            "p_dlas": rng.uniform(size=N),
            "min_z_dlas": np.full(N, 2.0),
            "max_z_dlas": np.full(N, 3.0),
            "sample_log_likelihoods_dla": sll.T,  # stored (N,S)->h5py (S,N)
            "log_likelihoods_dla": lld,
        },
    )
    write_mat(
        tmp_path / "samples.mat",
        {
            "offset_samples": rng.uniform(size=S),
            "log_nhi_samples": rng.uniform(20, 23, S),
        },
    )
    cat = load_catalogue_from_matlab(
        tmp_path / "processed.mat", tmp_path / "samples.mat"
    )
    assert cat.p_dla.shape == (N,)
    assert cat.log_norm_like.shape == (N, S)
    # normalized per-sample probabilities sum to ~1 for retained spectra
    keep = cat.p_dla > cat.p_thresh_spec
    sums = np.exp(cat.log_norm_like[keep]).sum(axis=1)
    assert np.all((sums > 0.95) & (sums < 1.05))


def test_dla_samples_from_matlab(tmp_path):
    from gp_dla_detection.samples import DLASamples

    class S:
        offset_samples = np.linspace(0, 1, 30, endpoint=False)
        log_nhi_samples = np.linspace(20, 23, 30)
        nhi_samples = 10 ** np.linspace(20, 23, 30)

        class config:
            uniform_min_log_nhi = 20.0
            uniform_max_log_nhi = 23.0
            fit_min_log_nhi = 20.0
            fit_max_log_nhi = 22.0
            alpha = 0.9

    write_dla_samples_mat(S, tmp_path / "dla_samples.mat")
    imported = DLASamples.from_matlab(tmp_path / "dla_samples.mat")
    np.testing.assert_allclose(imported.offset_samples, S.offset_samples)
    np.testing.assert_allclose(imported.log_nhi_samples, S.log_nhi_samples)
    np.testing.assert_allclose(imported.nhi_samples, S.nhi_samples)
    assert imported.config.num_dla_samples == 30
    assert imported.config.alpha == 0.9

    # minimal file exercising the fallback branches: nhi derived from
    # log_nhi, config defaults from DLASamplingParams
    write_mat(
        tmp_path / "minimal.mat",
        {
            "offset_samples": S.offset_samples,
            "log_nhi_samples": S.log_nhi_samples,
        },
    )
    minimal = DLASamples.from_matlab(tmp_path / "minimal.mat")
    np.testing.assert_allclose(minimal.nhi_samples, 10.0**S.log_nhi_samples)
    from gp_dla_detection.params import DLASamplingParams

    defaults = DLASamplingParams()
    assert minimal.config.alpha == defaults.alpha
    assert minimal.config.fit_max_log_nhi == defaults.fit_max_log_nhi
