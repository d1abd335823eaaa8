"""Data-acquisition planning + DLA catalog extraction on fixture files."""

from pathlib import Path

import numpy as np

from gp_dla_detection.download import (
    CATALOG_URLS,
    download_plan,
    download_spectra_command,
    extract_dla_catalog,
)
from gp_dla_detection.params import Parameters


def test_download_plan_covers_all_sources(tmp_path):
    params = Parameters(base_directory=str(tmp_path))
    plan = download_plan(params)
    urls = [i.url for i in plan]
    assert CATALOG_URLS["dr12q"][1] in urls
    # the two Noterdaeme-derived catalogs share one source archive
    assert len([u for u in urls if "noterdae" in u]) == 1
    for item in plan:
        assert str(tmp_path) in str(item.destination)


def test_extract_concordance(tmp_path):
    # BOSSLyaDR9_cat.txt-like fixture: 16+ columns, 1 header line;
    # column 4 = thing_id, 15 = z_dla (>0 marks a DLA), 16 = log_nhi
    src = tmp_path / "BOSSLyaDR9_cat.txt"
    lines = ["# header line with column names"]
    for tid, z, lognhi in [(101, 2.5, 20.6), (102, -1.0, 0.0), (103, 3.0, 21.2)]:
        row = ["x"] * 16
        row[3] = str(tid)
        row[14] = str(z)
        row[15] = str(lognhi)
        lines.append(" ".join(row))
    src.write_text("\n".join(lines) + "\n")

    dla_path, los_path = extract_dla_catalog(
        "dr9q_concordance", src, tmp_path / "processed"
    )
    dla = np.loadtxt(dla_path, ndmin=2)
    assert dla.shape == (2, 3)
    np.testing.assert_allclose(dla[:, 0], [101, 103])
    np.testing.assert_allclose(dla[:, 2], [20.6, 21.2])
    los = np.loadtxt(los_path)
    np.testing.assert_allclose(los, [101, 102, 103])


def test_extract_noterdaeme_and_visual(tmp_path):
    # DLA_DR12_v2.dat: skip 2 rows; col1=thing_id, col10=z, col11=log_nhi
    dist = tmp_path / "distfiles"
    dist.mkdir()
    dla_dat = ["header1", "header2"]
    for tid, z, n in [(201, 2.2, 20.9), (202, 2.9, 21.4)]:
        row = ["0"] * 11
        row[0] = str(tid)
        row[9] = str(z)
        row[10] = str(n)
        dla_dat.append(" ".join(row))
    (dist / "DLA_DR12_v2.dat").write_text("\n".join(dla_dat) + "\n")

    # LOS_DR12_v2.dat: col1=thing_id, col5=z_qso, col6=visual DLA flag
    los_dat = ["header1", "header2"]
    for tid, zq, flag in [(201, 2.5, 1), (202, 3.0, 0), (203, 2.8, 2)]:
        row = ["0"] * 6
        row[0] = str(tid)
        row[4] = str(zq)
        row[5] = str(flag)
        los_dat.append(" ".join(row))
    (dist / "LOS_DR12_v2.dat").write_text("\n".join(los_dat) + "\n")

    dla_path, los_path = extract_dla_catalog(
        "dr12q_noterdaeme", dist, tmp_path / "p1"
    )
    dla = np.loadtxt(dla_path, ndmin=2)
    np.testing.assert_allclose(dla[:, 0], [201, 202])
    np.testing.assert_allclose(dla[:, 1], [2.2, 2.9])
    los = np.loadtxt(los_path)
    assert los.size == 3

    # visual survey: z filled with z_QSO, log_nhi with 20.3
    dla_path, _ = extract_dla_catalog("dr12q_visual", dist, tmp_path / "p2")
    dla = np.loadtxt(dla_path, ndmin=2)
    np.testing.assert_allclose(dla[:, 0], [201, 203])
    np.testing.assert_allclose(dla[:, 1], [2.5, 2.8])
    np.testing.assert_allclose(dla[:, 2], [20.3, 20.3])


def test_extract_skips_malformed_rows_like_gawk(tmp_path):
    """Regression (code review): short or non-numeric rows crashed the
    whole extraction with IndexError/ValueError; gawk coerces a missing
    field to 0 and lets the row's own predicate skip it."""
    src = tmp_path / "BOSSLyaDR9_cat.txt"
    good = ["x"] * 16
    good[3], good[14], good[15] = "101", "2.5", "20.6"
    lines = [
        "# header",
        " ".join(good),
        "short row only",              # truncated line
        " ".join(["x"] * 15),          # one field short of log_nhi
        " ".join(["y"] * 16),          # non-numeric z_dla column
    ]
    src.write_text("\n".join(lines) + "\n")
    dla_path, los_path = extract_dla_catalog(
        "dr9q_concordance", src, tmp_path / "p"
    )
    dla = np.loadtxt(dla_path, ndmin=2)
    assert dla.shape == (1, 3)  # only the good row survives
    np.testing.assert_allclose(dla[0], [101, 2.5, 20.6])

    dist = tmp_path / "distfiles"
    dist.mkdir()
    (dist / "DLA_DR12_v2.dat").write_text(
        "h1\nh2\n201 0 0 0 0 0 0 0 0 2.2 20.9\ntruncated 0 0\n"
    )
    (dist / "LOS_DR12_v2.dat").write_text("h1\nh2\n201 0 0 0 2.5 1\n202\n")
    dla_path, _ = extract_dla_catalog("dr12q_noterdaeme", dist, tmp_path / "n")
    assert np.loadtxt(dla_path, ndmin=2).shape == (1, 3)
    dla_path, _ = extract_dla_catalog("dr12q_visual", dist, tmp_path / "v")
    dla = np.loadtxt(dla_path, ndmin=2)
    assert dla.shape == (1, 3)  # the short LOS row has no flag -> skipped


def test_spectra_rsync_command(tmp_path):
    params = Parameters(base_directory=str(tmp_path))
    cmd = download_spectra_command(params)
    assert cmd[0] == "rsync"
    assert any("file_list" in c for c in cmd)
    assert any(c.startswith("rsync://data.sdss.org") for c in cmd)
