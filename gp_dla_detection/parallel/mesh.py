"""Device mesh + sharding helpers.

The reference's only parallelism is a shared-memory parfor over QMC
samples (process_qsos.m:184); spectra are processed serially and
sharded manually across MATLAB jobs by slicing test_ind
(process_qsos.m:51-54).  This design scales along both
embarrassingly-parallel axes with a (data, sample) mesh:

  - 'data'   axis: spectra (sightlines) — the 162,861-wide axis
  - 'sample' axis: the 10,000 QMC (z_DLA, log N_HI) samples

Collectives are inserted by XLA from sharding propagation: the only
communication is the per-spectrum logsumexp reduction over the sample
axis (an all-reduce along 'sample') and the result gather along 'data'.
Multi-host execution initializes jax.distributed and uses the same code
path.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "make_mesh",
    "data_sharding",
    "sample_sharding",
    "replicated",
    "shard_batch",
    "initialize_distributed",
    "fetch_global",
    "is_coordinator",
    "DATA_AXIS",
    "SAMPLE_AXIS",
]

DATA_AXIS = "data"
SAMPLE_AXIS = "sample"


def make_mesh(
    num_devices: int | None = None,
    sample_parallelism: int = 1,
    devices=None,
) -> Mesh:
    """Build a (data, sample) mesh over the available devices.

    sample_parallelism divides the QMC-sample axis across that many
    devices; the rest go to the spectra axis.  Default is pure data
    parallelism (sample axis size 1).
    """
    if devices is None:
        devices = jax.devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    n = len(devices)
    if n % sample_parallelism:
        raise ValueError(
            f"{n} devices not divisible by sample_parallelism={sample_parallelism}"
        )
    grid = np.asarray(devices).reshape(n // sample_parallelism, sample_parallelism)
    return Mesh(grid, (DATA_AXIS, SAMPLE_AXIS))


def data_sharding(mesh: Mesh, *trailing_dims: int) -> NamedSharding:
    """Sharding for an array whose leading axis is the spectra axis."""
    return NamedSharding(mesh, P(DATA_AXIS, *([None] * len(trailing_dims))))


def sample_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for a 1-D per-sample array (offsets, N_HI).

    Replicated on meshes without a 'sample' axis (e.g. a plain
    Mesh(devices, ("data",))), so callers don't crash constructing a
    spec for an axis the mesh doesn't carry.
    """
    if SAMPLE_AXIS not in mesh.axis_names:
        return replicated(mesh)
    return NamedSharding(mesh, P(SAMPLE_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(mesh: Mesh, **arrays):
    """device_put each (B, ...) array sharded along the data axis."""
    out = {}
    for name, a in arrays.items():
        spec = P(DATA_AXIS, *([None] * (a.ndim - 1)))
        out[name] = jax.device_put(a, NamedSharding(mesh, spec))
    return out


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Multi-host bring-up (jax.distributed); no-op when single-process.

    Pass the coordinator address (``host:port``), the process count and
    this process's id; a GPU cluster does not announce them.
    """
    if num_processes is not None and num_processes > 1 or coordinator_address:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )


def fetch_global(x) -> np.ndarray:
    """Fetch a (possibly cross-process-sharded) array to a host ndarray.

    Single-process arrays (the common case) are a plain transfer; arrays
    sharded over a multi-process mesh are all-gathered first (every
    process gets the full result — the drivers' host-side bookkeeping is
    replicated-by-construction, mirroring how the reference replicates
    its catalog state across manually-sharded MATLAB jobs,
    process_qsos.m:51-54).
    """
    if isinstance(x, np.ndarray):
        return x
    if getattr(x, "is_fully_addressable", True):
        return np.asarray(x)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def is_coordinator() -> bool:
    """True on the process that owns checkpoint/manifest writes."""
    return jax.process_index() == 0
