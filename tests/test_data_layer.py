"""Data layer: FITS roundtrip, catalog construction, spectrum preload —
on synthetic files fabricated with our own FITS writer."""

import numpy as np
import pytest

from gp_dla_detection.catalog import build_catalog
from gp_dla_detection.io.fits import read_bintable, write_bintable
from gp_dla_detection.params import Parameters
from conftest import write_spec_file
from gp_dla_detection.spectra import (
    FILTER_MIN_PIXELS,
    FILTER_NORMALIZATION,
    RaggedSpectra,
    preload_qsos,
    read_spec,
)


def test_fits_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    names = ["FLUX", "LOGLAM", "IVAR", "AND_MASK", "NAME"]
    cols = [
        rng.normal(size=20).astype(np.float32),
        np.linspace(3.55, 3.56, 20),
        rng.uniform(0, 2, 20).astype(np.float32),
        rng.integers(0, 2**25, 20).astype(np.int32),
        np.array([f"obj{i:02d}" for i in range(20)], dtype="S8"),
    ]
    write_bintable(tmp_path / "t.fits", names, cols)
    table = read_bintable(tmp_path / "t.fits")
    assert table.names == names
    np.testing.assert_array_equal(table["FLUX"], cols[0])
    np.testing.assert_allclose(table["LOGLAM"], cols[1])
    np.testing.assert_array_equal(table[3], cols[3])
    assert table["NAME"][3] == b"obj03"


def test_read_spec_semantics(tmp_path):
    n = 50
    loglam = 3.55 + 1e-4 * np.arange(n)
    flux = np.ones(n)
    ivar = np.full(n, 4.0)
    ivar[5] = 0.0
    and_mask = np.zeros(n, np.int64)
    and_mask[7] = 1 << 23  # BRIGHTSKY
    and_mask[9] = 1 << 3   # some other bit: NOT masked
    write_spec_file(tmp_path / "s.fits", loglam, flux, ivar, and_mask)

    w, f, nv, pm = read_spec(tmp_path / "s.fits")
    np.testing.assert_allclose(w, 10.0**loglam, rtol=1e-6)
    assert nv[0] == 0.25 and np.isinf(nv[5])
    assert pm[5] and pm[7] and not pm[9] and pm.sum() == 2


def test_build_catalog_and_preload(synthetic_release, tmp_path):
    params = synthetic_release
    cat = build_catalog(params)

    assert len(cat) == 12
    # filter bit 0: z < 2.15 (quasar index 2); bit 1: BAL (index 3)
    assert cat.filter_flags[2] == 1
    assert cat.filter_flags[3] == 2
    assert cat.unfiltered().sum() == 10
    np.testing.assert_array_equal(cat.in_dr9, np.arange(12) < 8)
    np.testing.assert_array_equal(cat.in_dr10, np.arange(12) < 10)

    # DLA cross-match: visual catalog has two DLAs on thing 101
    vis = cat.dla_catalogs["dr12q_visual"]
    assert vis.dla_ind[0] and len(vis.z_dlas[0]) == 2
    conc = cat.dla_catalogs["dr9q_concordance"]
    assert conc.los_ind[:8].all() and not conc.los_ind[8:].any()
    assert conc.dla_ind[0] and conc.dla_ind[3]

    # training selection: in_dr9 & los & ~dla & unfiltered
    train = cat.train_dr9_no_concordance_dlas()
    assert not train[0] and not train[3]  # concordance DLAs
    assert not train[2]                   # z cut

    # file list: v5_7_2 plate gets a duplicate entry
    fl = cat.file_list()
    assert sum("v5_7_2" in p for p in fl) == 1
    assert sum("v5_7_0" in p for p in fl) == 10

    # preload
    spectra = preload_qsos(cat, params)
    assert len(spectra) == 12
    lengths = spectra.lengths()
    assert lengths[2] == 0 and lengths[3] == 0  # pre-filtered
    assert cat.filter_flags[6] & (1 << FILTER_NORMALIZATION)
    assert cat.filter_flags[7] & (1 << FILTER_MIN_PIXELS)
    assert lengths[6] == 0 and lengths[7] == 0

    good = np.flatnonzero(cat.filter_flags == 0)
    assert len(good) == 8
    # truncation keeps rest range [910, 1217] plus one extra pixel each side
    for i in good:
        w, f, nv, pm = spectra.row(int(i))
        rest = w / (1 + cat.z_qsos[i])
        assert rest[1] >= 910.0 and rest[-2] <= 1217.0
        assert rest[0] < 910.0 and rest[-1] > 1217.0  # the extra pixels
        assert np.all(np.diff(w) > 0)
        # normalization: median flux ~5 -> normalized median ~1
        assert abs(np.nanmedian(f) - 1.0) < 0.1

    # roundtrip both artifacts
    cat.save(tmp_path / "catalog.npz")
    from gp_dla_detection.catalog import Catalog

    cat2 = Catalog.load(tmp_path / "catalog.npz")
    np.testing.assert_array_equal(cat2.filter_flags, cat.filter_flags)
    np.testing.assert_array_equal(
        cat2.dla_catalogs["dr12q_visual"].z_dlas[0], vis.z_dlas[0]
    )
    spectra.save(tmp_path / "preloaded.npz")
    sp2 = RaggedSpectra.load(tmp_path / "preloaded.npz")
    np.testing.assert_array_equal(sp2.flux, spectra.flux)

    # padded batch for the engine
    batch = sp2.to_padded(
        indices=good, z_qsos=cat.z_qsos[good], pixel_pad=1280
    )
    assert batch.wavelengths.shape == (8, 1280)
    assert np.all(np.diff(batch.wavelengths, axis=1) > 0)
    assert batch.mask.sum(1).min() > 200


def test_fits_header_comment_with_apostrophe(tmp_path):
    """Regression (code review): an apostrophe inside a numeric card's
    comment must not suppress comment stripping."""
    from gp_dla_detection.io.fits import read_bintable, write_bintable

    write_bintable(
        tmp_path / "t.fits", ["A"], [np.arange(4.0).astype(np.float32)]
    )
    raw = bytearray((tmp_path / "t.fits").read_bytes())
    # rewrite the extension's NAXIS2 card with an apostrophe-bearing comment
    idx = raw.find(b"NAXIS2 ")
    card = b"NAXIS2  =                    4 / table's row count".ljust(80)
    raw[idx : idx + len(card)] = card
    (tmp_path / "t2.fits").write_bytes(bytes(raw))
    table = read_bintable(tmp_path / "t2.fits")
    np.testing.assert_allclose(table["A"], np.arange(4.0))
