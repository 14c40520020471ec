"""Drive the PyTorch/CUDA port's flagship render on one GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero without
printing a result line:

1. Build: compile every CUDA source of the render path with nvcc (one
   process per source, started together) and print the build seconds and
   ptxas's register and spill report.
2. Short-horizon parity: the render kernel against its plain PyTorch version
   (``ops/render.py::render_planes``) on the card, exact divides, 48 steps,
   a = 0.9, 250x141 (neither side a multiple of the kernel's block), for the
   spectral and the analytic disk: p99 |d| < 1e-4 and mean |d| < 1e-5.
3. Flagship-config parity at 480x270: 256 steps, approx_recip on in the
   kernel (the plain version always divides exactly): all finite,
   mean |d| < 1e-3, fewer than 1% of pixels with |d| > 1e-2 (the chaotic
   critical-band rays).
4. The main path: ``render()`` at 1920x1080 on the flagship scene (Kerr
   a = 0.999, spectral disk, 256 steps, the ``bench.py`` / ``cli render``
   MarchConfig). The launch counter is reset just before and read just
   after; CUDA-event median ms/frame over the timed frames and Mrays/s. The
   kernel alone and one frame of the plain version are timed on the same
   inputs, and the kernel is held against the plain version there too.

It prints the card's name and power limit (nvidia-smi), then a JSON line
describing each kernel, then the last line
``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from blackhole_simulation_tpu_torch.ops import build as kbuild  # noqa: E402
from blackhole_simulation_tpu_torch.ops.render import (  # noqa: E402
    render_planes,
    render_planes_kernel,
)
from blackhole_simulation_tpu_torch.render.camera import Camera  # noqa: E402
from blackhole_simulation_tpu_torch.render.march import MarchConfig  # noqa: E402
from blackhole_simulation_tpu_torch.render.pipeline import (  # noqa: E402
    Features,
    Scene,
    kernel_inputs,
    render,
)
from blackhole_simulation_tpu_torch.render.post import tonemap  # noqa: E402

SOURCES = ("render.cu",)
# Published float32 peak of one H100 SXM outside the tensor cores (FLOP/s)
# and its memory rate (bytes/s).
FP32_PEAK = 67e12
HBM_RATE = 3.35e12
# Operations of the kernel, counted by hand from csrc/render.cu with every
# add, multiply, divide, square root and compare as one: one march step with
# midpoint_iters = 1 (two Kerr-Schild right-hand sides of ~121 each, the
# adaptive step size, the updates, the crossing record and the sanity test,
# plus the renormalization spread over its 16 steps), and what every pixel
# does outside the march (ray birth, null projection, the 32-term Chebyshev
# precull). The composite (disk slots, starfield, glow) depends on each
# ray's crossings and fate and is not counted, so the bound is a lower one.
OPS_PER_STEP = 340
OPS_PER_PIXEL = 260
FLAGSHIP_CFG = MarchConfig(
    max_steps=256, use_pallas=True, fused=True, shadow_precull=True,
    step_rate=0.2, far_step_cap_rate=0.4, far_boost_radius=20.0,
    approx_recip=True, midpoint_iters=1,
)


def flagship_scene(width, height, spin=0.999, cfg=FLAGSHIP_CFG,
                   features=Features(spectral_lut=True)):
    cam = Camera.create(r=30.0, theta=math.pi / 2 - 0.25, fov=0.5,
                        width=width, height=height)
    return Scene.create(mass=1.0, spin=spin, camera=cam, march_cfg=cfg,
                        features=features)


def plain_twin(st):
    """The plain version's inputs: the same config with exact divides."""
    return dataclasses.replace(
        st, cfg=dataclasses.replace(st.cfg, approx_recip=False))


def diff_stats(a, b):
    d = (a - b).abs()
    return {
        "max_abs": float(d.max()),
        "mean_abs": float(d.mean()),
        "p99_abs": float(torch.quantile(d.flatten().double(), 0.99)),
        "frac_gt_1e-2": float((d.amax(dim=0) > 1e-2).float().mean()),
    }


def timed(fn, n):
    """ms of n calls, each bracketed by CUDA events: (median, min, max)."""
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), float(min(times)), float(max(times))


def phase_build():
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        libs = list(pool.map(kbuild.build, SOURCES))
    secs = time.perf_counter() - t0
    print(f"build: {len(libs)} kernel source(s) in {secs:.1f} s")
    for src in SOURCES:
        for line in kbuild.ptxas_report(src).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {src}: {line.strip()}")
    return secs


def phase_short_parity():
    cfg = dataclasses.replace(FLAGSHIP_CFG, max_steps=48, approx_recip=False)
    out = {}
    for name, feats in (("spectral", Features(spectral_lut=True)),
                        ("analytic", Features())):
        row, st = kernel_inputs(flagship_scene(250, 141, spin=0.9, cfg=cfg,
                                           features=feats), None, "cuda")
        k = render_planes_kernel(row, st)
        p = render_planes(row, st)
        torch.cuda.synchronize()
        s = diff_stats(k, p)
        print(f"short-horizon parity ({name}, 250x141, 48 steps): {s}")
        if not (s["p99_abs"] < 1e-4 and s["mean_abs"] < 1e-5):
            raise AssertionError(f"short-horizon parity failed ({name}): {s}")
        out[name] = s
    return out


def phase_flagship_parity():
    row, st = kernel_inputs(flagship_scene(480, 270), None, "cuda")
    k = render_planes_kernel(row, st)
    p = render_planes(row, plain_twin(st))
    torch.cuda.synchronize()
    s = diff_stats(k, p)
    print(f"flagship parity (480x270, 256 steps, approx_recip kernel): {s}")
    if not (torch.isfinite(k).all() and s["mean_abs"] < 1e-3
            and s["frac_gt_1e-2"] < 0.01):
        raise AssertionError(f"flagship parity failed: {s}")
    return s


def phase_main_path(frames=30, warmup=3):
    width, height = 1920, 1080
    scene = flagship_scene(width, height)
    for _ in range(warmup):
        render(scene)
    torch.cuda.synchronize()

    render_planes_kernel.launches = 0
    frame_ms, frame_min, frame_max = timed(lambda: render(scene), frames)
    launches = render_planes_kernel.launches
    img = render(scene)
    torch.cuda.synchronize()
    if launches < frames:
        raise AssertionError(f"render kernel launched {launches} times in "
                             f"{frames} frames")
    if img.shape != (height, width, 3) or not torch.isfinite(img).all():
        raise AssertionError("render() output is not a finite (H, W, 3) image")
    if not (0.0 <= float(img.min()) and float(img.max()) <= 1.0):
        raise AssertionError("tone-mapped image outside [0, 1]")

    # The kernel alone, then the plain version, on the same inputs.
    row, st = kernel_inputs(scene, None, "cuda")
    steps = torch.empty((height, width), dtype=torch.int32, device="cuda")
    k = render_planes_kernel(row, st, steps)
    kernel_ms, kernel_min, kernel_max = timed(
        lambda: render_planes_kernel(row, st), 10)
    t0 = time.perf_counter()
    p = render_planes(row, plain_twin(st))
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    s = diff_stats(k, p)
    print(f"1080p kernel vs plain: {s}")
    if not (s["mean_abs"] < 1e-3 and s["frac_gt_1e-2"] < 0.01):
        raise AssertionError(f"1080p kernel vs plain failed: {s}")

    # Where the frame's time goes besides the kernel.
    t0 = time.perf_counter()
    for _ in range(10):
        kernel_inputs(scene, None, "cuda")
    torch.cuda.synchronize()
    row_ms = (time.perf_counter() - t0) * 1e2
    planes = k.permute(1, 2, 0)
    tonemap_ms, _, _ = timed(lambda: tonemap(planes, scene.post), 10)

    total_steps = int(steps.long().sum())
    n_pix = width * height
    ops = OPS_PER_STEP * total_steps + OPS_PER_PIXEL * n_pix
    nbytes = 12 * n_pix + 4 * row.numel()
    ops_ms = ops / FP32_PEAK * 1e3
    bytes_ms = nbytes / HBM_RATE * 1e3
    print(f"main path: render() 1920x1080 flagship: {frame_ms:.3f} ms/frame "
          f"median of {frames}, {n_pix / frame_ms / 1e3:.1f} Mrays/s; kernel "
          f"{kernel_ms:.3f} ms; host row build + copy {row_ms:.3f} ms; "
          f"tonemap {tonemap_ms:.3f} ms; plain {plain_ms:.1f} ms; steps/ray "
          f"{total_steps / n_pix:.1f}; launches {launches}")
    return {
        "name": "render",
        "route": "cuda",
        "source": "blackhole_simulation_tpu_torch/csrc/render.cu",
        "replaces": "blackhole_simulation_tpu/ops/pallas_render.py:140",
        "launches": launches,
        "max_abs_err": s["max_abs"],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
        "p99_abs": s["p99_abs"],
        "mean_abs": s["mean_abs"],
        "frame_ms": frame_ms,
        "frame_ms_min_max": [frame_min, frame_max],
        "kernel_ms_min_max": [kernel_min, kernel_max],
        "mrays_per_s": n_pix / frame_ms / 1e3,
        "steps_per_ray": total_steps / n_pix,
        "host_row_ms": row_ms,
        "tonemap_ms": tonemap_ms,
        "frames": frames,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_build()
    phase_short_parity()
    phase_flagship_parity()
    kernel = phase_main_path()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s total")
    print(smi)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
