"""The user-facing entry points: bench.py and chip_smoke.py refuse to
report from anything but a GPU, chip_smoke.py's phases run end to end at
a toy size with the device check stubbed, and scripts/scale_demo.py and
the multi-device dry run work on the test backend."""

import json
import os
import runpy
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent


def _cpu_env():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return env


def test_bench_smoke(monkeypatch, capsys):
    """The evaluator benchmark refuses the CPU backend with a non-zero
    exit and prints no result."""
    monkeypatch.syspath_prepend(str(ROOT))
    import bench

    with pytest.raises(SystemExit) as exc:
        bench.main(batch_size=4, num_samples=64, pixels=250, k=4,
                   sample_chunk=32, iters=1)
    assert exc.value.code not in (0, None)
    assert "no GPU" in str(exc.value.code)
    assert "spectra/s" not in capsys.readouterr().out


def test_bench_driver_smoke(monkeypatch, capsys):
    """The sustained driver benchmark (bench.py --driver) refuses the
    CPU backend too."""
    monkeypatch.syspath_prepend(str(ROOT))
    import bench

    with pytest.raises(SystemExit) as exc:
        bench.main_driver(n_spectra=12, per_device_batch=4, num_samples=64,
                          pixels=250, k=4, lean=True, two_stage=True)
    assert exc.value.code not in (0, None)
    assert "spectra/s" not in capsys.readouterr().out


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_script_exits_nonzero_without_gpu(script):
    """Run as a user would, on the CPU: non-zero exit, no JSON result."""
    out = subprocess.run(
        [sys.executable, str(ROOT / script)], cwd=ROOT, env=_cpu_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert '"ok"' not in out.stdout and "spectra/s" not in out.stdout


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    """chip_smoke.py without the rest of the repository: non-zero exit,
    no result line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=_cpu_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_require_gpu_accepts_gpu_devices(monkeypatch):
    import jax

    from gp_dla_detection.utils import device

    class Fake:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    monkeypatch.setattr(jax, "devices", lambda *a: [Fake(), Fake()])
    assert device.require_gpu() == {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 2,
    }
    monkeypatch.setattr(jax, "devices", lambda *a: [])
    with pytest.raises(IndexError):
        device.require_gpu()


@pytest.fixture
def smoke(monkeypatch):
    """chip_smoke at a toy size, its device check stubbed to pass."""
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke

    from gp_dla_detection.utils import device

    monkeypatch.setattr(chip_smoke, "NUM_SAMPLES", 128)
    monkeypatch.setattr(chip_smoke, "PER_DEVICE_BATCH", 2)
    monkeypatch.setattr(chip_smoke, "SAMPLE_CHUNK", 64)
    monkeypatch.setattr(chip_smoke, "NUM_SPECTRA", 8)
    monkeypatch.setattr(chip_smoke, "ACCURACY_SPECTRA", 4)
    monkeypatch.setattr(chip_smoke, "TRAIN_SPECTRA", 64)
    monkeypatch.setattr(device, "card_name_and_power_limit", lambda: "stub")
    monkeypatch.setattr(
        device, "require_gpu",
        lambda: {"platform": "gpu", "kind": "stub", "count": 4},
    )
    return chip_smoke


def test_chip_smoke_universe(smoke):
    """The smoke universe: production pixel width, the configured sample
    count and rank, finite fluxes, and a prior catalog with DLAs."""
    params, model, spectra, samples, prior_z, prior_num = (
        smoke.build_universe(6)
    )
    assert spectra.wavelengths.shape == (6, params.pixel_pad)
    assert len(samples.offset_samples) == smoke.NUM_SAMPLES
    assert params.null_model.k == smoke.K
    assert np.isfinite(spectra.flux).all()
    assert (prior_num >= 0).all() and (prior_num >= 1).any()


def test_chip_smoke_phases_end_to_end(smoke, capsys):
    """Every one-card phase at a toy size; the last line is the result."""
    smoke.main([])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {
        "ok": True, "device": {"platform": "gpu", "kind": "stub", "count": 4},
    }
    text = "\n".join(lines)
    for phase in ("device", "compile", "accuracy", "drivers", "train"):
        assert f"== {phase}: ok" in text
    assert "stub" in lines[1]


def test_chip_smoke_four_cards(smoke, capsys):
    """The --four-cards path on four of the virtual CPU devices: the
    4-device mesh reproduces the one-device catalog."""
    smoke.main(["--four-cards"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1])["device"]["count"] == 4
    assert "same catalog decisions: True" in "\n".join(lines)
    assert "== compile" not in "\n".join(lines)


def test_dryrun_multichip_self_verifying(monkeypatch):
    """The multi-device dry run on the 8-virtual-device CPU mesh,
    including its internal sharded-vs-replicated equality and
    pair-validity-geometry assertions."""
    monkeypatch.syspath_prepend(str(ROOT))
    import __graft_entry__ as graft

    graft.dryrun_multichip(8)


def test_scale_demo_smoke(capsys, monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT / "scripts"))
    demo = runpy.run_path(str(ROOT / "scripts" / "scale_demo.py"))
    demo["main"](n_spectra=6, seed=3, num_samples=120)
    lines = [
        json.loads(ln)
        for ln in capsys.readouterr().out.strip().splitlines()
        if ln.startswith("{")
    ]
    final = lines[-1]
    assert final["stage"] == "two_stage_model_selection"
    assert final["n_spectra"] == 6
    assert np.isfinite(final["seconds"])


@pytest.fixture
def stub_gpu(monkeypatch):
    from gp_dla_detection.utils import device

    monkeypatch.setattr(device, "card_name_and_power_limit", lambda: "stub, 1 W")
    monkeypatch.setattr(
        device, "require_gpu",
        lambda: {"platform": "gpu", "kind": "stub", "count": 1},
    )
    monkeypatch.syspath_prepend(str(ROOT))
    import bench

    return bench


def test_bench_evaluator_names_its_device(stub_gpu, capsys):
    """With a GPU present the evaluator metric is a positive rate, and
    the result carries the device and the card's power limit."""
    stub_gpu.main(batch_size=2, num_samples=64, pixels=250, k=4,
                  sample_chunk=32, iters=1)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "stub, 1 W"
    out = json.loads(lines[-1])
    assert out["unit"] == "spectra/s" and out["value"] > 0
    assert out["device"] == {
        "platform": "gpu", "kind": "stub", "count": 1, "card": "stub, 1 W",
    }


def test_bench_driver_names_its_device(stub_gpu, capsys):
    stub_gpu.main_driver(n_spectra=16, per_device_batch=1, num_samples=64,
                         pixels=250, k=4, lean=True, two_stage=True)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "fused two-stage" in out["metric"]
    assert out["device"]["platform"] == "gpu"


@pytest.mark.parametrize("phase", ["accuracy", "drivers"])
def test_chip_smoke_failed_phase_prints_no_result(smoke, capsys, monkeypatch,
                                                  phase):
    """A phase whose check fails stops the run: the exception escapes
    (non-zero exit) and no result line is printed."""
    if phase == "accuracy":
        monkeypatch.setattr(smoke, "SAMPLE_LL_BOUND", 0.0)
    else:
        monkeypatch.setattr(smoke, "P_THRESHOLD", 1.0)
    with pytest.raises(AssertionError):
        smoke.main([])
    out = capsys.readouterr().out
    assert '"ok"' not in out
    assert f"== {phase}: ok" not in out


def test_card_name_and_power_limit_queries_nvidia_smi(monkeypatch):
    from gp_dla_detection.utils import device

    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(
            cmd, 0, stdout="NVIDIA H100 80GB HBM3, 700.00 W\n", stderr=""
        )

    monkeypatch.setattr(device.subprocess, "run", fake_run)
    assert device.card_name_and_power_limit() == (
        "NVIDIA H100 80GB HBM3, 700.00 W"
    )
    assert calls == [[
        "nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
    ]]


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu_env):
    """The one-card smoke run on a real GPU: exit 0 and the result line."""
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, env=gpu_env,
        capture_output=True, text=True, timeout=1200,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["ok"] is True and result["device"]["platform"] == "gpu"


def test_bench_cli_rejects_two_stage_without_lean():
    """--two-stage is the fused lean driver: the CLI refuses it without
    --lean before touching any device."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "bench.py"), "--driver", "--two-stage"],
        cwd=ROOT, env=_cpu_env(), capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 2
    assert "--two-stage requires --lean" in out.stderr
