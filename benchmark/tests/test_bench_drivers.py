"""The traffic drivers and the metric readers on the CPU with the device
passed in, and the command's refusal without a card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import session
from benchmark.drivers import frames
from benchmark.run import HERE, ROOT, load_module
from benchmark.trace import DeviceOp, Trace


@pytest.mark.parametrize("cell", ["flagship_1080p.live_1spp",
                                  "flagship_1080p.ss16_orbit"])
def test_frames_session_on_the_cpu(spec_of, cell):
    spec = spec_of(cell, n_samples=2 if "ss16" in cell else 1)
    out = session.run(spec, frames.Frames(spec))
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    m = out["metrics"]
    assert m["frame_p95_ms"] > 0 and m["frame_ms"] > 0 and m["setup_s"] > 0
    assert out["checks"]["mean_abs_diff"]["value"] < 1e-6


def _trace():
    k = lambda name, s, e, launch=None: DeviceOp(name, s, e, launch, True)
    return Trace(ops=[k("void render_kernel<0, false, true>(float const*)",
                        0.0, 1.0e-3),
                      k("elementwise_kernel", 1.2e-3, 1.3e-3, launch=0.5e-3),
                      k("void march_kernel<0, true>(float const*)", 2e-3, 3e-3),
                      k("void march_grad_kernel<true, false>(float const*)",
                        3e-3, 5e-3),
                      DeviceOp("Memcpy HtoD", 5e-3, 5.5e-3, None, False)],
                 host=[(0.4e-3, 0.6e-3, "post")])


def test_metric_readers_on_a_known_trace():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    ctx = {"trace": _trace(), "window_s": 10e-3, "frames": 2,
           "latencies_s": [k * 1e-3 for k in range(1, 21)],
           "render_ops": 67e9, "render_bytes": 0.0, "post_bytes": 3.35e8}
    want = {"frame_p95_ms.frame": 19.05,
            "render_kernel_roofline.frame": 100.0,
            "render_kernel_ms.frame": 0.5,
            "post_roofline.frame": 100.0,
            "idle_share.frame": 100.0 * (1 - 4.6e-3 / 10e-3),
            "launches.frame": 2.0}
    for name in [m["name"] for m in bench["per_layer"]]:
        reader = load_module(HERE / "metrics" / f"{name}.py", "t_" + name)
        assert reader.read(ctx) == pytest.approx(want[name], rel=1e-9)
        empty = {"trace": Trace([], []), "window_s": 1.0}
        assert reader.read(empty) is None


def test_breakdown_names_the_host_in_gaps():
    b = _trace().breakdown()
    assert b["device_ops"][0][0].startswith("march_grad_kernel")
    assert all(v > 0 for _, v in b["idle_gaps"])


def test_command_refuses_without_a_card():
    import os

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "flagship_1080p.live_1spp", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode != 0 and r.stdout.strip() == ""
