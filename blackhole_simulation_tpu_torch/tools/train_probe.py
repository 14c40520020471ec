"""Where the training step's, or the certified frame's, time goes on the
card.

    python -m blackhole_simulation_tpu_torch.tools.train_probe \
        [--width 1920] [--height 1080] [--certified]

The step is ``make_inverse_step`` in bench.py's configuration (the
flagship camera and MarchConfig with ``fused=False``, the analytic disk,
spin 0.9, zero target); counterpart of the repo's tools/probe_stages.py.
With ``--certified`` it is one ``render()`` frame of the certified
flagship scene instead (bench.py:188-217: the flagship with
``refine_band=0.6, refine_budget=16384``). It prints one JSON line,
``profile``: one call under ``torch.profiler``: its wall ms, the device
time summed over its kernels and grouped (render, march and gradient
kernels, everything else), the device's idle share, the kernel launches,
and the 20 operations with the most device time.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math

import torch

from blackhole_simulation_tpu_torch.parallel import (
    InverseParams,
    make_inverse_step,
)
from blackhole_simulation_tpu_torch.render.camera import Camera
from blackhole_simulation_tpu_torch.render.march import MarchConfig
from blackhole_simulation_tpu_torch.render.pipeline import (
    Features,
    Scene,
    render,
)

# bench.py's flagship MarchConfig, on the staged path.
TRAIN_CFG = MarchConfig(
    max_steps=256, use_pallas=True, fused=False, shadow_precull=True,
    step_rate=0.2, far_step_cap_rate=0.4, far_boost_radius=20.0,
    approx_recip=True, midpoint_iters=1, remat_every=0,
)


def _flagship(width, height, cfg, features):
    cam = Camera.create(r=30.0, theta=math.pi / 2 - 0.25, fov=0.5,
                        width=width, height=height)
    return Scene.create(mass=1.0, spin=0.999, camera=cam, march_cfg=cfg,
                        features=features)


def train_scene(width, height):
    """bench.py's training-step scene: the flagship camera (Kerr a = 0.999)
    and MarchConfig with fused=False, the analytic disk."""
    return _flagship(width, height, TRAIN_CFG, Features())


def flagship_scene(width, height):
    """bench.py's flagship render: the flagship camera (Kerr a = 0.999),
    MarchConfig with fused=True, the spectral disk."""
    return _flagship(width, height, dataclasses.replace(TRAIN_CFG, fused=True),
                     Features(spectral_lut=True))


def certified_scene(width, height):
    """bench.py's certified scene: the flagship render (spectral disk) with
    the critical-band refinement pass."""
    cfg = dataclasses.replace(TRAIN_CFG, fused=True, refine_band=0.6,
                              refine_budget=16384)
    return _flagship(width, height, cfg, Features(spectral_lut=True))


def _device_us(evt) -> float:
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile_once(fn):
    """One call of ``fn`` under ``torch.profiler``: (its result, the
    profile: wall ms by CUDA events, device time summed over its kernels
    and grouped (render, march and gradient kernels, everything else), the
    device's idle share, the kernel launches and the 20 operations with the
    most device time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
    wall_ms = start.elapsed_time(end)
    kernels = [e for e in prof.key_averages()
               if _device_us(e) > 0 and e.device_type.name == "CUDA"]
    groups = {"render": 0.0, "march": 0.0, "march_grad": 0.0, "other": 0.0}
    for e in kernels:
        key = ("march_grad" if "march_grad_kernel" in e.key else
               "march" if "march_kernel" in e.key else
               "render" if "render_kernel" in e.key else "other")
        groups[key] += _device_us(e) / 1e3
    busy = sum(groups.values())
    top = sorted(kernels, key=_device_us, reverse=True)[:20]
    return out, {
        "wall_ms": wall_ms, "device_busy_ms": busy,
        "idle_share": max(0.0, 1.0 - busy / wall_ms), "groups_ms": groups,
        "device_kernels": len(kernels),
        "launches": sum(e.count for e in kernels),
        "top": [(e.key[:80], e.count, _device_us(e) / 1e3) for e in top],
    }


def profile_call(fn):
    """``profile_once`` of ``fn`` after a warm-up call: the profile."""
    fn()
    return profile_once(fn)[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--certified", action="store_true",
                    help="profile a certified render() frame instead")
    args = ap.parse_args(argv)
    if args.certified:
        scene = certified_scene(args.width, args.height)
        prof = profile_call(lambda: render(scene))
    else:
        scene = train_scene(args.width, args.height)
        params = InverseParams.init(spin=0.9,
                                    theta_cam=float(scene.camera.theta),
                                    device="cuda")
        target = torch.zeros((args.height, args.width, 3), device="cuda")
        step = make_inverse_step(scene, device="cuda")
        prof = profile_call(lambda: step(params, target))
    print(json.dumps({"profile": prof}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
