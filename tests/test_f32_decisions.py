"""Decision-level f32 accuracy pins (CI-sized version of
validation/f32_decision_study.py).

The production path (float32, f16 result streaming) must agree with the
f64 oracle at the level that matters for the catalog: posterior p_DLA
within a tight
band, and NO classification flips at the p = 0.9 threshold away from
the threshold's immediate neighborhood.  The reference's corresponding
claim is exact (f64-to-f64) catalog reproduction; this is its honest
f32 analogue.
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "validation"))

from f32_decision_study import build_problem, compare  # noqa: E402

from gp_dla_detection.parallel import (  # noqa: E402
    ShardedRunConfig,
    make_mesh,
    process_spectra_sharded,
)


def test_f32_path_changes_no_decisions():
    n_spectra, num_samples = 24, 400
    params, model, spectra, samples, prior_z, prior_f, injected = (
        build_problem(n_spectra, num_samples)
    )
    mesh = make_mesh()

    res32 = process_spectra_sharded(
        model, samples.offset_samples, samples.nhi_samples, spectra,
        prior_z, prior_f, params=params, mesh=mesh,
        config=ShardedRunConfig(
            per_device_batch=3, dtype="float32", stream_dtype="float16",
            sample_chunk=200,
        ),
    )
    res64 = process_spectra_sharded(
        model, samples.offset_samples, samples.nhi_samples, spectra,
        prior_z, prior_f, params=params, mesh=mesh,
        config=ShardedRunConfig(
            per_device_batch=3, dtype="float64", sample_chunk=200,
        ),
    )
    stats = compare(res32, res64)

    # the problem must actually exercise both classes at the threshold
    detected = res64.p_dlas > 0.9
    assert detected.any() and not detected.all()

    # decision-level pins (VERDICT r2 #4): no confident-decision flips,
    # p_dla within 1e-3 at the 99th percentile
    assert stats["flips_outside_margin"] == 0
    assert stats["abs_dp_dla"]["p99"] < 1e-3
    assert stats["abs_dp_dla"]["max"] < 5e-3
