"""Plot/table drivers run end-to-end on the synthetic catalogue."""

import numpy as np

from gp_dla_detection.analysis.plots import (
    do_check_p_thresh,
    do_data_plots,
    do_qso_split,
    do_snr_check,
)
from gp_dla_detection.analysis.tables import (
    format_latex_num,
    format_latex_two_num,
    print_all_tables,
)

from test_analysis import make_synthetic_catalogue  # noqa: E402


def test_do_data_plots_writes_tables(tmp_path, capsys):
    cat = make_synthetic_catalogue(n_certain=15, n_empty=80, n_weak=20)
    do_data_plots(cat, tmp_path)

    for name in (
        "cddf_all.txt", "cddf_z225.txt", "cddf_z253.txt", "cddf_z34.txt",
        "cddf_z45.txt", "dndx_all.txt", "omega_dla_all.txt",
        "cddf_gp.pdf", "dndx_gp.pdf", "omega_gp.pdf", "cddf_zz_gp.pdf",
        "cddf_moment_gp.pdf",
    ):
        assert (tmp_path / name).exists(), name

    cddf = np.loadtxt(tmp_path / "cddf_all.txt")
    assert cddf.shape[0] == 6  # x, value, 68lo, 68hi, 95lo, 95hi
    dndx = np.loadtxt(tmp_path / "dndx_all.txt")
    assert np.all(dndx[4] <= dndx[2] + 1e-30)  # 95lo <= 68lo

    # LaTeX tables from the txt files
    text = print_all_tables(tmp_path)
    capsys.readouterr()
    assert "\\begin{table*}" in text
    assert "dN/dX" in text and "Omega" in text
    assert text.count("\\end{table*}") >= 3


def test_robustness_sweeps_run(tmp_path):
    from gp_dla_detection.analysis.plots import do_pixel_noise_check

    cat = make_synthetic_catalogue(n_certain=10, n_empty=60, n_weak=10)
    cat.snrs = np.full(cat.p_dla.size, 5.0)
    do_check_p_thresh(cat, tmp_path)
    do_snr_check(cat, tmp_path)
    do_qso_split(cat, tmp_path, splits=(2.5, 3.5))
    assert (tmp_path / "dndx_gp_pthresh.pdf").exists()
    assert (tmp_path / "omega_gp_snr.pdf").exists()
    assert (tmp_path / "dndx_gp_zqso.pdf").exists()

    # pixel-noise sweep (make_plots.py:96-119) needs pixel_noise arrays
    rng = np.random.default_rng(0)
    cat.pixel_noise = [
        np.where(rng.uniform(size=100) < 0.1, 1.0, 0.01)
        for _ in range(cat.p_dla.size)
    ]
    old = (cat.snr_thresh, cat.noise_thresh, cat.filter_noisy_pixels)
    do_pixel_noise_check(cat, tmp_path)
    assert (tmp_path / "omega_gp_pix_noise.pdf").exists()
    assert (tmp_path / "dndx_gp_pix_noise.pdf").exists()
    # sweep restores all toggles it touched
    assert old == (cat.snr_thresh, cat.noise_thresh, cat.filter_noisy_pixels)


def test_latex_formatting():
    assert format_latex_num(0.0) == "$0$"
    assert "10^{ 4 }" in format_latex_num(31000.0)
    assert format_latex_num(0.5, prec=2) == "$ 0.50 $"
    s = format_latex_two_num(1e-22, 3e-22)
    assert "10^{ -22 }" in s
    assert format_latex_two_num(1.0, 2.0, prec=1) == "$ 1.0 - 2.0 $"


def test_extended_plot_drivers(tmp_path):
    from test_analysis import make_two_dla_catalogue
    from gp_dla_detection.analysis.plots import (
        do_2dla_plots,
        do_compare_plots,
        do_sample_error_check,
    )

    cat = make_synthetic_catalogue(n_certain=10, n_empty=60, n_weak=10)
    cat_b = make_synthetic_catalogue(n_certain=8, n_empty=60, n_weak=10, seed=3)
    do_sample_error_check(cat, tmp_path, nsample=2)
    do_compare_plots(cat, cat_b, tmp_path, labels=("X", "Y"))
    cat2 = make_two_dla_catalogue()
    do_2dla_plots(cat2, tmp_path)
    for f in ("dndx_gp_resample.pdf", "omega_gp_resample.pdf",
              "cddf_compare.pdf", "dndx_compare.pdf", "omega_compare.pdf",
              "cddf_gp_2dla.pdf", "dndx_gp_2dla.pdf"):
        assert (tmp_path / f).exists(), f
