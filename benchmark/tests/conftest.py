"""Shared set-up of the benchmark's CPU tests: cells at a tiny size on the
CPU, with the device passed in (``run.py`` itself refuses without a
card)."""

from __future__ import annotations

import json
import sys
import time
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "benchmark"
sys.path.insert(0, str(ROOT))

TINY = {"width": 40, "height": 24}


def tiny_spec(cell: str, seed: int = 12345, seconds: float = 0.5,
              trace: int = 0, max_steps: int = 40, **traffic_over):
    """The cell's spec at ``TINY`` size on the CPU, with its limits."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["workloads"] if c["name"] == cell)
    config = json.loads((HERE / "configs" / f"{entry['config']}.json").read_text())
    config.update(TINY)
    config["march"] = dict(config["march"], max_steps=max_steps)
    traffic = json.loads((HERE / "traffic" / f"{entry['traffic']}.json").read_text())
    traffic.update({"poses": 4, "check_span": 4, "check_frames": 2, "band_rows": 4,
                    "steps_sample": 64, **traffic_over})
    limits = json.loads((HERE / "limits" / f"{cell}.json").read_text())
    return types.SimpleNamespace(
        cell=entry, config=config, traffic=traffic, limits=limits, seed=seed,
        seconds=seconds, trace=trace, device="cpu",
        t_start=time.perf_counter())


@pytest.fixture
def spec_of():
    return tiny_spec
