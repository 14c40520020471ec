"""Accelerator detection and preset recommendation.

Counterpart of ``blackhole_simulation_tpu/utils/device.py``: the platform
and device kind come from ``torch.cuda`` in place of ``jax.devices()``.
A CUDA card is platform ``"gpu"`` (as JAX names a GPU backend), kind
``torch.cuda.get_device_name(0)``, tier ``"high"``; without one the
platform is ``"cpu"``, kind ``"cpu"``, tier ``"low"``.
``recommend_preset`` maps the tier to a preset as the JAX twin does.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DeviceInfo:
    platform: str          # "gpu" | "cpu"
    device_kind: str       # e.g. "NVIDIA H100 80GB HBM3"
    n_devices: int
    tier: str              # "high" | "medium" | "low"


def detect_device() -> DeviceInfo:
    if torch.cuda.is_available():
        return DeviceInfo("gpu", torch.cuda.get_device_name(0),
                          torch.cuda.device_count(), "high")
    return DeviceInfo("cpu", "cpu", 1, "low")


def recommend_preset(info: DeviceInfo | None = None) -> str:
    """Tier -> preset (the recommendation ladder without running the
    benchmark; BenchmarkController measures the real one)."""
    info = info or detect_device()
    return {"high": "cinematic", "medium": "balanced", "low": "minimal"}[info.tier]
