"""Native C++ FITS loader vs the pure-Python reader."""

import numpy as np
import pytest

from conftest import write_spec_file
from gp_dla_detection.io.native import (
    load_library,
    native_available,
    read_spec_batch,
)
from gp_dla_detection.spectra import read_spec


@pytest.fixture
def spec_files(tmp_path):
    rng = np.random.default_rng(0)
    paths = []
    for i in range(6):
        n = 200 + 50 * i
        loglam = 3.55 + 1e-4 * np.arange(n)
        flux = rng.normal(3.0, 1.0, n)
        ivar = rng.uniform(0.5, 4.0, n)
        ivar[rng.choice(n, 5, replace=False)] = 0.0
        and_mask = np.zeros(n, np.int64)
        and_mask[rng.choice(n, 4, replace=False)] = 1 << 23
        p = tmp_path / f"spec-{i}.fits"
        write_spec_file(p, loglam, flux, ivar, and_mask)
        paths.append(p)
    return paths


def test_native_builds():
    assert native_available(), "native library failed to build/load"
    lib = load_library()
    assert b"gpdla_io" in lib.gpdla_version()


def test_native_matches_python_reader(spec_files):
    w, f, nv, pm, lengths = read_spec_batch(spec_files, max_pixels=512)
    assert np.all(lengths > 0)
    for i, p in enumerate(spec_files):
        w_py, f_py, nv_py, pm_py = read_spec(p)
        n = lengths[i]
        assert n == len(w_py)
        np.testing.assert_allclose(w[i, :n], w_py, rtol=1e-12)
        np.testing.assert_allclose(f[i, :n], f_py, rtol=1e-12)
        finite = np.isfinite(nv_py)
        np.testing.assert_allclose(nv[i, :n][finite], nv_py[finite], rtol=1e-12)
        np.testing.assert_array_equal(np.isinf(nv[i, :n]), ~finite)
        np.testing.assert_array_equal(pm[i, :n], pm_py)


def test_native_missing_file(spec_files, tmp_path):
    paths = [spec_files[0], tmp_path / "nonexistent.fits", spec_files[1]]
    w, f, nv, pm, lengths = read_spec_batch(paths, max_pixels=512)
    assert lengths[0] > 0 and lengths[2] > 0
    assert lengths[1] < 0


def test_empty_bintable_matches_python(tmp_path):
    """A valid but EMPTY COADD table is data, not a parse failure: both
    readers return length 0 so the preloader filters the quasar
    gracefully instead of aborting the batch."""
    path = tmp_path / "empty.fits"
    z = np.zeros(0)
    write_spec_file(path, z, z, z, z.astype(np.int32))

    w, f, nv, pm = read_spec(path)
    assert len(w) == 0

    if native_available():
        *_, lengths = read_spec_batch([path])
        assert lengths[0] == 0


def test_bool_column_roundtrip(tmp_path):
    """bool columns must round-trip as bool (FITS logical 'L'), not
    uint8 0/1 — ~mask on a uint8 produces 254/255, not logical not."""
    from gp_dla_detection.io import read_bintable, write_bintable

    path = tmp_path / "flags.fits"
    flags = np.array([True, False, True, True])
    write_bintable(path, ["IN_DR9", "X"], [flags, np.arange(4.0)])
    table = read_bintable(path)
    got = table["IN_DR9"]
    assert got.dtype == bool
    np.testing.assert_array_equal(got, flags)


def test_quoted_header_values_and_overlong_cards(tmp_path):
    """FITS-escaped apostrophes in string cards survive a round trip;
    an overlong card raises instead of silently shifting the header
    grid."""
    from gp_dla_detection.io import read_bintable, write_bintable
    from gp_dla_detection.io.fits import _card

    path = tmp_path / "quote.fits"
    write_bintable(path, ["O'HARA"], [np.arange(3.0)])
    table = read_bintable(path)
    np.testing.assert_array_equal(table["O'HARA"], np.arange(3.0))

    with pytest.raises(ValueError, match="80-character"):
        _card("TTYPE1", "X" * 75)
