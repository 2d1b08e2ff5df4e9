"""The device a measurement ran on, as JAX and `nvidia-smi` report it.

Every timing this repository prints names its device: JAX's platform,
device kind and device count, and the card's name and power limit (a
card set below its maximum power runs slower under load).
"""
from __future__ import annotations

import subprocess


def describe() -> dict:
    """{"platform", "kind", "count"} of JAX's default devices."""
    import jax

    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}


def require_gpu() -> dict:
    """`describe()`, or SystemExit when JAX found no GPU: speed and
    on-card behaviour are only measured on the card."""
    dev = describe()
    if dev["platform"] != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default device is {dev['platform']!r} "
            f"({dev['kind']}); this measurement runs only on the card")
    return dev


def card_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` (one line per card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
