"""Which accelerator a measurement ran on.

Every measurement entry point (``bench.py``, ``chip_smoke.py``) names
the device its numbers come from and refuses to report from anything
but a GPU: a rate taken on the CPU backend says nothing about the card.
"""

from __future__ import annotations

import subprocess

__all__ = ["require_gpu", "card_name_and_power_limit"]


def require_gpu() -> dict:
    """``{"platform", "kind", "count"}`` of JAX's devices; exits with a
    non-zero code when they are not GPUs."""
    import jax

    devices = jax.devices()
    info = {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }
    if info["platform"] != "gpu":
        raise SystemExit(
            f"no GPU: JAX found {info['count']} {info['platform']} "
            f"device(s) ({info['kind']}); this entry point measures a GPU only"
        )
    return info


def card_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit, one line per card.  Runs as
    a child process that does not import JAX."""
    out = subprocess.run(
        [
            "nvidia-smi", "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()
