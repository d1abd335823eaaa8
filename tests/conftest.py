"""Test configuration: CPU backend, 8 virtual devices, float64 enabled.

Multi-device sharding tests run on a virtual 8-device CPU mesh (the
standard JAX stand-in for a multi-device machine); numerical parity
tests need
float64.  Must run before jax initializes, hence the env vars here.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# jax may already be imported by a pytest plugin (jaxtyping) before this
# conftest runs, so the env var alone is too late — set the config value
# directly (valid until the backend is first used).
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest

from gp_dla_detection.io.fits import write_bintable
from gp_dla_detection.params import Parameters


def write_spec_file(path, loglam, flux, ivar, and_mask):
    write_bintable(
        path,
        ["FLUX", "LOGLAM", "IVAR", "AND_MASK", "OR_MASK"],
        [
            flux.astype(np.float32),
            loglam.astype(np.float32),
            ivar.astype(np.float32),
            and_mask.astype(np.int32),
            np.zeros_like(and_mask, dtype=np.int32),
        ],
    )


@pytest.fixture
def synthetic_release(tmp_path):
    """A miniature DR12Q release on disk: QSO catalogs (FITS), DLA text
    catalogs, and speclite spectra — fabricated with our own FITS writer."""
    rng = np.random.default_rng(1)
    params = Parameters(base_directory=str(tmp_path / "data"))

    N = 12
    thing_ids = np.arange(101, 101 + N, dtype=np.int64)
    z_qsos = np.array(
        [2.8, 3.1, 1.9, 2.6, 3.4, 2.9, 2.5, 3.0, 2.7, 3.2, 2.4, 2.55]
    )
    bal = np.zeros(N, np.int32)
    bal[3] = 1  # one BAL quasar
    plates = np.full(N, 4055, np.int32)
    plates[-1] = 7339  # a v5_7_2 plate
    mjds = np.full(N, 55359, np.int32)
    fibers = np.arange(1, N + 1, dtype=np.int32)

    # DR12Q has >56 columns; only the positions the builder touches matter
    names, cols = [], []

    def add(name, col):
        names.append(name)
        cols.append(col)

    add("SDSS_NAME", np.array([f"J{i:017d}" for i in range(N)], dtype="S18"))
    add("RA", rng.uniform(0, 360, N))
    add("DEC", rng.uniform(-10, 70, N))
    add("THING_ID", thing_ids.astype(np.int32))
    add("PLATE", plates)
    add("MJD", mjds)
    add("FIBERID", fibers)
    add("Z_VI", z_qsos)
    for j in range(9, 33):
        add(f"PAD{j}", np.zeros(N, np.float32))
    add("SNR_SPEC", rng.uniform(1, 20, N))  # column 33
    for j in range(34, 56):
        add(f"PAD{j}", np.zeros(N, np.float32))
    add("BAL_FLAG_VI", bal)  # column 56

    d12 = params.distfiles_directory("dr12q")
    d12.mkdir(parents=True)
    write_bintable(d12 / "DR12Q.fits", names, cols)

    for rel, fname, members in [
        ("dr9q", "DR9Q.fits", thing_ids[:8]),
        ("dr10q", "DR10Q_v2.fits", thing_ids[:10]),
    ]:
        d = params.distfiles_directory(rel)
        d.mkdir(parents=True)
        write_bintable(
            d / fname,
            ["SDSS_NAME", "RA", "DEC", "THING_ID"],
            [
                np.array(["x"] * len(members), dtype="S18"),
                np.zeros(len(members)),
                np.zeros(len(members)),
                members.astype(np.int32),
            ],
        )

    for name, los, dla_rows in [
        ("dr9q_concordance", thing_ids[:8], [(101, 2.3, 20.5), (104, 2.1, 21.0)]),
        ("dr12q_noterdaeme", thing_ids, [(102, 2.9, 20.8)]),
        ("dr12q_visual", thing_ids, [(101, 2.8, 20.3), (101, 2.2, 20.3)]),
    ]:
        d = params.dla_catalog_directory(name)
        d.mkdir(parents=True)
        np.savetxt(d / "los_catalog", los, fmt="%d")
        np.savetxt(d / "dla_catalog", np.array(dla_rows))

    spec_dir = params.spectra_directory("dr12q")
    spec_dir.mkdir(parents=True)
    for i in range(N):
        z = z_qsos[i]
        lam0 = 890.0 * (1 + z)
        n_px = int(np.log10(1400.0 / 890.0) / 1e-4)
        loglam = np.log10(lam0) + 1e-4 * np.arange(n_px)
        flux = rng.normal(5.0, 0.5, n_px)
        ivar = np.full(n_px, 4.0)
        and_mask = np.zeros(n_px, np.int64)
        # quasar 7 (index 6): mask out the entire normalization range
        if i == 6:
            rest = 10.0**loglam / (1 + z)
            ivar[(rest >= 1310) & (rest <= 1325)] = 0.0
        # quasar 8 (index 7): too few usable pixels in the model range,
        # but the normalization range stays clean
        if i == 7:
            rest = 10.0**loglam / (1 + z)
            ivar[rest <= 1250.0] = 0.0
        plate_dir = spec_dir / str(plates[i])
        plate_dir.mkdir(exist_ok=True)
        write_spec_file(
            plate_dir / f"spec-{plates[i]}-{mjds[i]}-{fibers[i]:04d}.fits",
            loglam,
            flux,
            ivar,
            and_mask,
        )
    return params


@pytest.fixture
def gpu_env():
    """Environment for a child process on the GPU; skips the test where
    JAX finds none.  This process is pinned to the CPU above, so the
    check runs in a child, without the CPU pin."""
    import subprocess
    import sys

    env = {
        k: v for k, v in os.environ.items()
        if k not in ("JAX_PLATFORMS", "XLA_FLAGS")
    }
    probe = subprocess.run(
        [sys.executable, "-c", "import jax; print(jax.devices()[0].platform)"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    platform = probe.stdout.strip().splitlines()[-1:] or ["none"]
    if platform[0] != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX found {platform[0]}")
    return env
