"""Drive the PyTorch/CUDA port on one GPU and check it: the flagship render,
the staged render and the inverse-rendering (training) step.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero without
printing a result line:

1. Build: compile every CUDA source (``render.cu``, ``march.cu``,
   ``march_grad.cu``) with nvcc (one process per source, started together)
   and print the build seconds and ptxas's register and spill report.
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
5. The march kernel (``csrc/march.cu``) against its plain version
   (``ops/pallas_march.py::march_u_plain``) on camera rays at 250x141
   (not a multiple of a warp), 48 steps, exact divides, a = 0.9: identical
   hit, steps and crossing counts, |d| < 1e-4 on states and records. Then
   the staged render (the flagship config with ``fused=False``, through
   the march kernel; its launch counter reset before and read after)
   against the fused render at 480x270: p99 |d| < 1e-4 analytic and
   < 2e-2 spectral (tests/test_fused.py's bars); mean |d| < 5e-5 over all
   pixels, and < 1e-5 (that file's mean bar) over the pixels with
   |d| <= 1e-2. It prints the share of pixels above 1e-2.
6. The gradient kernel (``csrc/march_grad.cu``) on tests/test_grad_kernel.py's
   scene (48x32 rays, 48 steps, exact divides) and loss: d/d(spin) through
   ``march_rows_ad`` (both kernels) against autograd straight through the
   plain march on the card, rel < 5e-3 at a = 0.3 and 0.9; d/d(mass)
   rel < 2e-2; per-ray cotangents 95th-percentile rel < 1e-2; with
   ``cotangent_clip = 0.05`` rel < 2e-2 and unlike the unclipped gradient;
   all finite.
7. The training path at full width: ``make_inverse_step`` at 1920x1080 in
   bench.py's configuration (flagship camera and MarchConfig with
   ``fused=False``, analytic disk, spin 0.9, zero target). Both launch
   counters are reset just before the timed steps and read just after; the
   CUDA-event median ms/step and fwd+bwd Mrays/s; loss, parameters and
   Adam moments finite. On the arguments the kernels received in one real
   step (``march_u.record``, ``march_grad_kernel.record``), each kernel is
   timed alone and held against its plain version at exact divides: the
   march's integers equal and its floats within 1e-4 on all but 0.1% of
   rays; the gradient's initial-row cotangents p95 rel < 1e-2, each ray's
   worst row p99.9 rel < 2e-3 and above 1e-3 on under 0.2% of rays, and
   all four summed partials (m, a, r_h, r_ph) rel < 1e-3. Then
   ``ad_inverse_render`` at 256x256 (target at a = 0.85, start at 0.5,
   stages ((64, 8), (96, 4)), 36 steps): the final loss below 0.1x the
   first and |spin - 0.85| < 1e-2.

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
from blackhole_simulation_tpu_torch.ops.march_grad import (  # noqa: E402
    march_grad,
    march_grad_kernel,
)
from blackhole_simulation_tpu_torch.ops.pallas_march import (  # noqa: E402
    march_u,
    march_u_plain,
)
from blackhole_simulation_tpu_torch.ops.render import (  # noqa: E402
    render_planes,
    render_planes_kernel,
)
from blackhole_simulation_tpu_torch.parallel import (  # noqa: E402
    InverseParams,
    ad_inverse_render,
    make_inverse_step,
)
from blackhole_simulation_tpu_torch.render.camera import (  # noqa: E402
    Camera,
    camera_rays_u,
)
from blackhole_simulation_tpu_torch.render.march import (  # noqa: E402
    MarchConfig,
    MarchRows,
    _march_inputs,
    march_rows_ad,
)
from blackhole_simulation_tpu_torch.render.pipeline import (  # noqa: E402
    Features,
    Scene,
    kernel_inputs,
    render,
    render_radiance,
)
from blackhole_simulation_tpu_torch.render.post import tonemap  # noqa: E402

SOURCES = ("render.cu", "march.cu", "march_grad.cu")
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
# The gradient kernel's least work per live march step, in march steps: the
# checkpointing replay, the block's re-forward, and one reverse-mode VJP of
# the step at about three times the step's operations (a transposed
# multiply is two multiplies and an add). Its bytes: the checkpoint and
# stack traffic through the scratch buffer besides its inputs and outputs.
GRAD_STEPS_PER_STEP = 2 + 3
# The device of phases 5-7.
DEV = "cuda"
FLAGSHIP_CFG = MarchConfig(
    max_steps=256, use_pallas=True, fused=True, shadow_precull=True,
    step_rate=0.2, far_step_cap_rate=0.4, far_boost_radius=20.0,
    approx_recip=True, midpoint_iters=1,
)
# bench.py's training step: the flagship MarchConfig on the staged path.
TRAIN_CFG = dataclasses.replace(FLAGSHIP_CFG, fused=False, remat_every=0)
# Phase 5: the staged render against the fused one at 480x270: the mean
# |d| over all pixels, and over those with |d| <= 1e-2 (test_fused.py's).
STAGED_MEAN_BAR = 5e-5
STAGED_MEAN_REST_BAR = 1e-5
# Phase 7: the tail of the gradient kernel's per-ray relative difference
# from its plain version at 1080p (each ray's worst initial-row cotangent):
# its 99.9th percentile, and the share of rays above 1e-3.
GRAD_P999_BAR = 2e-3
GRAD_TAIL_BAR = 2e-3


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


def _rel(x, ref):
    return abs(x - ref) / max(abs(ref), 1e-9)


def _camera(width, height):
    return Camera.create(r=30.0, theta=math.pi / 2 - 0.25, fov=0.5,
                         width=width, height=height)


def _cuda_scalar(v, grad=False):
    return torch.tensor(v, dtype=torch.float32, device=DEV,
                        requires_grad=grad)


def march_compare(k, p):
    """Kernel vs plain march outputs: the share of rays whose hit, steps or
    crossing count differ, the share whose float outputs differ by more
    than 1e-4, and the largest |d| over the rays whose integers agree."""
    same = (k[1] == p[1]) & (k[2] == p[2]) & (k[6] == p[6])
    d = torch.zeros_like(k[7])
    for i in (0, 3, 4, 5):
        d = torch.maximum(d, (k[i] - p[i]).abs().amax(dim=0))
    d = torch.maximum(d, (k[7] - p[7]).abs())
    return {
        "frac_int_differ": float((~same).float().mean()),
        "frac_gt_1e-4": float((d > 1e-4).float().mean()),
        "max_abs": float(d[same].max()) if bool(same.any()) else math.inf,
    }


def phase_march_parity():
    cfg = dataclasses.replace(FLAGSHIP_CFG, max_steps=48, approx_recip=False,
                              fused=False)
    m, a = _cuda_scalar(1.0), _cuda_scalar(0.9)
    with torch.no_grad():
        args = _march_inputs(camera_rays_u(_camera(250, 141), m, a), m, a,
                             cfg, None)
        k = march_u(*args, cfg)
        p = march_u_plain(*args, cfg)
    torch.cuda.synchronize()
    s = march_compare(k, p)
    print(f"march kernel parity (250x141, 48 steps, a = 0.9): {s}")
    if not (s["frac_int_differ"] == 0.0 and s["max_abs"] < 1e-4):
        raise AssertionError(f"march kernel parity failed: {s}")

    out = {"short": s}
    for name, feats, p99_bar in (("analytic", Features(), 1e-4),
                                 ("spectral", Features(spectral_lut=True),
                                  2e-2)):
        fused = flagship_scene(480, 270, features=feats)
        staged = dataclasses.replace(fused, march_cfg=dataclasses.replace(
            FLAGSHIP_CFG, fused=False))
        march_u.launches = 0
        img = render_radiance(staged, device=DEV)
        torch.cuda.synchronize()
        launches = march_u.launches
        d = (img - render_radiance(fused, device=DEV)).abs()
        big = d.amax(dim=-1) > 1e-2
        st = {"p99_abs": float(torch.quantile(d.flatten().double(), 0.99)),
              "mean_abs": float(d.mean()),
              "frac_px_gt_1e-2": float(big.float().mean()),
              "mean_abs_rest": float(d[~big].mean()),
              "march_launches": launches}
        print(f"staged vs fused render ({name}, 480x270): {st}")
        if not (launches >= 1 and bool(torch.isfinite(img).all())
                and st["p99_abs"] < p99_bar
                and st["mean_abs"] < STAGED_MEAN_BAR
                and st["mean_abs_rest"] < STAGED_MEAN_REST_BAR):
            raise AssertionError(f"staged render failed ({name}): {st}")
        out[name] = st
    return out


# tests/test_grad_kernel.py's scene and march configuration.
GRAD_CFG = MarchConfig(max_steps=48, shadow_precull=False, remat_every=0)


def _grad_loss(rows):
    """tests/test_grad_kernel.py's loss over every differentiable output."""
    return (rows.state_u[1].mean() + 0.1 * rows.cross_r.mean()
            + 0.05 * rows.cross_phi.mean() + 0.02 * rows.cross_t.mean()
            + 0.01 * torch.exp(-rows.r_min_ph).mean())


def _march_rows(rays, m, a, cfg, kernel):
    """march_rows_ad (both kernels) or the plain march, by autograd."""
    if kernel:
        return march_rows_ad(rays, m, a, cfg)
    return MarchRows(*march_u_plain(*_march_inputs(rays, m, a, cfg, None),
                                    cfg))


def _param_grads(spin, kernel, mass=1.0, **over):
    cfg = dataclasses.replace(GRAD_CFG, **over)
    m, a = _cuda_scalar(mass, True), _cuda_scalar(spin, True)
    rows = _march_rows(camera_rays_u(_camera(48, 32), m, a), m, a, cfg, kernel)
    g_a, g_m = torch.autograd.grad(_grad_loss(rows), (a, m))
    return float(g_a), float(g_m)


def phase_grad_parity():
    out = {}
    for spin in (0.3, 0.9):
        g, ref = _param_grads(spin, True)[0], _param_grads(spin, False)[0]
        out[f"dspin_a{spin}"] = (g, ref, _rel(g, ref))
        if not (math.isfinite(g) and _rel(g, ref) < 5e-3):
            raise AssertionError(f"d/d(spin) at a = {spin}: {g} vs {ref}")
    g, ref = _param_grads(0.6, True)[1], _param_grads(0.6, False)[1]
    out["dmass_a0.6"] = (g, ref, _rel(g, ref))
    if not (math.isfinite(g) and _rel(g, ref) < 2e-2):
        raise AssertionError(f"d/d(mass): {g} vs {ref}")
    g, ref = (_param_grads(0.9, k, cotangent_clip=0.05)[0]
              for k in (True, False))
    out["dspin_clip0.05"] = (g, ref, _rel(g, ref))
    if not (math.isfinite(g) and _rel(g, ref) < 2e-2
            and abs(g - out["dspin_a0.9"][0]) > 1e-9):
        raise AssertionError(f"d/d(spin) with the clip: {g} vs {ref}")

    m, a = _cuda_scalar(1.0), _cuda_scalar(0.7)
    rays = camera_rays_u(_camera(48, 32), m, a)
    ct = []
    for kernel in (True, False):
        r = rays.clone().requires_grad_()
        rows = _march_rows(r, m, a, GRAD_CFG, kernel)
        loss = rows.state_u[1].mean() + 0.1 * rows.cross_r.mean()
        ct.append(torch.autograd.grad(loss, r)[0])
    d = (ct[0] - ct[1]).abs() / (ct[1].abs() + 1e-6)
    p95 = float(torch.quantile(d.flatten().double(), 0.95))
    out["ray_cotangent_p95_rel"] = p95
    print(f"gradient kernel vs autograd through the plain march: {out}")
    if not (bool(torch.isfinite(ct[0]).all()) and p95 < 1e-2):
        raise AssertionError(f"per-ray cotangents: p95 rel {p95}")
    return out


def grad_compare(k, p):
    """Gradient kernel vs plain: the 95th percentile of the relative
    difference of the initial-row cotangents; the tail of each ray's worst
    row (99.9th percentile, share above 1e-3, largest); their largest |d|;
    and the relative difference of each summed (m, a, r_h, r_ph) partial."""
    rows = [0, 1, 2, 3, 5, 6, 7]
    d = (k[0][rows] - p[0][rows]).abs()
    rel = d / (p[0][rows].abs() + 1e-6)
    ray_rel = rel.amax(dim=0).double()   # each ray's worst row
    return {
        "ray_p95_rel": float(torch.quantile(
            rel.flatten().double(), 0.95)),
        "ray_p999_rel": float(torch.quantile(ray_rel, 0.999)),
        "frac_rel_gt_1e-3": float((ray_rel > 1e-3).double().mean()),
        "max_rel": float(ray_rel.max()),
        "max_abs": float(d.max()),
        "finite": bool(torch.isfinite(k[0]).all())
        and all(math.isfinite(float(x)) for x in k[1:]),
        "partials": [float(x) for x in k[1:]],
        "partials_plain": [float(x) for x in p[1:]],
        "partials_rel": [_rel(float(x), float(y))
                         for x, y in zip(k[1:], p[1:])],
    }


def phase_train(steps=5, warmup=2, width=1920, height=1080):
    scene = flagship_scene(width, height, cfg=TRAIN_CFG, features=Features())
    cfg = scene.march_cfg
    params = InverseParams.init(spin=0.9, theta_cam=float(scene.camera.theta),
                                device=DEV)
    target = torch.zeros((height, width, 3), device=DEV)
    step = make_inverse_step(scene, device=DEV)
    for i in range(warmup):
        if i == warmup - 1:   # keep the kernels' arguments of one real step
            march_u.record, march_grad_kernel.record = [], []
        step(params, target)
    m_args, g_args = march_u.record[0], march_grad_kernel.record[0]
    march_u.record = march_grad_kernel.record = None
    torch.cuda.synchronize()

    results = []
    march_u.launches = 0
    march_grad_kernel.launches = 0
    step_ms, step_min, step_max = timed(
        lambda: results.append(step(params, target)), steps)
    launches = {"march": march_u.launches,
                "march_grad": march_grad_kernel.launches}
    (p1, (m1, v1, t1)), loss = results[-1]
    grads = [float(x) / 0.1 for x in m1.leaves()]   # m = (1 - b1) g
    if min(launches.values()) < steps:
        raise AssertionError(f"kernel launches in {steps} steps: {launches}")
    if not all(math.isfinite(x) for x in [float(loss), *grads,
                                          *map(float, p1.leaves())]):
        raise AssertionError(f"training step not finite: loss {loss}, "
                             f"clipped gradients {grads}")
    scratch = march_grad_kernel.scratch_bytes
    n_pix = width * height

    # Each kernel alone on the recorded step's own arguments, then against
    # its plain version there at exact divides.
    outs = march_u(*m_args)
    march_ms, _, _ = timed(lambda: march_u(*m_args), 5)
    grad_ms, _, _ = timed(lambda: march_grad_kernel(*g_args), 3)
    n_rays = int(outs[0].shape[1])
    total_steps = int(outs[2].long().sum())
    n_blocks = -(-cfg.max_steps // 32)

    cfg_x = dataclasses.replace(cfg, approx_recip=False)
    with torch.no_grad():
        k = march_u(*m_args[:6], cfg_x)
        t0 = time.perf_counter()
        p = march_u_plain(*m_args[:6], cfg_x)
        torch.cuda.synchronize()
        march_plain_ms = (time.perf_counter() - t0) * 1e3
    ms = march_compare(k, p)
    print(f"1080p march kernel vs plain (step inputs, exact divides): {ms}")
    if not (ms["frac_int_differ"] < 1e-3 and ms["frac_gt_1e-4"] < 1e-3):
        raise AssertionError(f"1080p march kernel vs plain failed: {ms}")
    # The step's cotangents, replayed from the exact-divide forward's r_min.
    g_x = (*g_args[:6], cfg_x, *g_args[7:12], k[7])
    gk = march_grad_kernel(*g_x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gp = march_grad(*g_x)
    torch.cuda.synchronize()
    grad_plain_ms = (time.perf_counter() - t0) * 1e3
    gs = grad_compare(gk, gp)
    print(f"1080p gradient kernel vs plain (step inputs, exact divides): {gs}")
    if not (gs["finite"] and gs["ray_p95_rel"] < 1e-2
            and gs["ray_p999_rel"] < GRAD_P999_BAR
            and gs["frac_rel_gt_1e-3"] < GRAD_TAIL_BAR
            and max(gs["partials_rel"]) < 1e-3):
        raise AssertionError(f"1080p gradient kernel vs plain failed: {gs}")

    k_slots = cfg.max_crossings
    march_ops = OPS_PER_STEP * total_steps
    march_bytes = 4 * n_rays * (9 + 8 + 3 + 3 * k_slots + 1)
    grad_ops = GRAD_STEPS_PER_STEP * OPS_PER_STEP * total_steps
    grad_bytes = 4 * (n_rays * (7 + 1 + 7 + 3 * k_slots + 2 + 7 + 4
                                + 8 * n_blocks) + 2 * 7 * total_steps)
    print(f"training step {width}x{height}: {step_ms:.3f} ms/step median of {steps} "
          f"(min {step_min:.3f}, max {step_max:.3f}), "
          f"{n_pix / step_ms / 1e3:.2f} Mrays/s fwd+bwd; launches {launches}; "
          f"march {march_ms:.3f} ms, gradient {grad_ms:.3f} ms; scratch "
          f"{scratch} bytes; loss {float(loss):.6e}; clipped gradients "
          f"{grads}; steps/ray {total_steps / n_rays:.2f}")

    curriculum = phase_ad_curriculum()
    common = dict(route="cuda", library_ms=None, steps_per_ray=(
        total_steps / n_rays), rays=n_rays)
    bound = lambda ops, nbytes: (max(ops / FP32_PEAK, nbytes / HBM_RATE) * 1e3,
                                 "operations" if ops / FP32_PEAK
                                 >= nbytes / HBM_RATE else "bytes")
    march_bound, march_by = bound(march_ops, march_bytes)
    grad_bound, grad_by = bound(grad_ops, grad_bytes)
    train = {
        "step_ms": step_ms, "step_ms_min_max": [step_min, step_max],
        "mrays_per_s": n_pix / step_ms / 1e3, "steps": steps,
        "loss": float(loss), "clipped_grads": grads, "scratch_bytes": scratch,
        "launches_per_step": {k: v / steps for k, v in launches.items()},
        "ad_curriculum": curriculum,
    }
    return train, [
        dict(name="march",
             source="blackhole_simulation_tpu_torch/csrc/march.cu",
             replaces="blackhole_simulation_tpu/ops/pallas_march.py:646",
             launches=launches["march"], max_abs_err=ms["max_abs"],
             ms=march_ms, plain_ms=march_plain_ms, bound_ms=march_bound,
             bound_by=march_by, frac_int_differ=ms["frac_int_differ"],
             **common),
        dict(name="march_grad",
             source="blackhole_simulation_tpu_torch/csrc/march_grad.cu",
             replaces="blackhole_simulation_tpu/ops/pallas_grad.py:149",
             launches=launches["march_grad"], max_abs_err=gs["max_abs"],
             ms=grad_ms, plain_ms=grad_plain_ms, bound_ms=grad_bound,
             bound_by=grad_by, ray_p95_rel=gs["ray_p95_rel"],
             ray_p999_rel=gs["ray_p999_rel"],
             frac_rel_gt_1e3=gs["frac_rel_gt_1e-3"], max_rel=gs["max_rel"],
             partials_rel=gs["partials_rel"], scratch_bytes=scratch,
             **common),
    ]


def phase_ad_curriculum():
    cam = _camera(256, 256)
    scene = Scene.create(
        mass=1.0, spin=0.85, camera=cam,
        march_cfg=MarchConfig(max_steps=256, step_rate=0.12,
                              far_step_cap_rate=0.4, far_boost_radius=20.0,
                              midpoint_iters=1, remat_every=32))
    target = render_radiance(scene, device=DEV)
    march_u.launches = 0
    march_grad_kernel.launches = 0
    t0 = time.perf_counter()
    params, losses = ad_inverse_render(
        scene, target, n_steps=36, stages=((64, 8), (96, 4)),
        init=InverseParams.init(spin=0.5, theta_cam=float(cam.theta)),
        device=DEV)
    secs = time.perf_counter() - t0
    spin = float(params.spin)
    out = {"seconds": secs, "first_loss": losses[0], "final_loss": losses[-1],
           "spin": spin, "launches": {"march": march_u.launches,
                                      "march_grad": march_grad_kernel.launches}}
    print(f"ad_inverse_render 256x256, 36 steps: {out}")
    if not (losses[-1] < 0.1 * losses[0] and abs(spin - 0.85) < 1e-2
            and march_grad_kernel.launches >= 36):
        raise AssertionError(f"AD curriculum did not converge: {out}")
    return out


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
    phase_march_parity()
    phase_grad_parity()
    train, kernels = phase_train()
    print(f"training: {json.dumps(train)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s total")
    print(smi)
    print(json.dumps({"kernels": [kernel, *kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
