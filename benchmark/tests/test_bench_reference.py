"""The reference against the port's CPU path (the kernels' plain versions)
at a tiny size, and the work counts' independence of the implementation."""

from __future__ import annotations

import math

import torch

from benchmark import counts, director
from benchmark.drivers import frames
from benchmark.reference import image


def _port_frame(spec, pose, n_samples):
    from blackhole_simulation_tpu_torch.render import render

    return render(frames.port_scene(spec.config, pose, "cpu"),
                  n_samples=n_samples, device="cpu")


def test_frame_band_equals_the_port_on_the_cpu(spec_of):
    """On the CPU both run exact divides, so the bands agree to rounding
    (the tone-mapped image, jittered samples, bloom margin and all)."""
    for cell, samples in (("flagship_1080p.live_1spp", 1),
                          ("flagship_1080p.ss16_orbit", 4)):
        spec = spec_of(cell, n_samples=samples)
        run = frames.Frames(spec)
        pose = run.pose_of(1)
        full = _port_frame(spec, run.poses[pose], samples)
        y0 = 9
        band = run.reference_band(pose, y0)
        assert band.shape == (run.rows, spec.config["width"], 3)
        assert float((full[y0:y0 + run.rows] - band).abs().max()) < 1e-6


def test_frame_count_does_not_depend_on_the_route(spec_of):
    """A frame's counted operations are the same whether the program takes
    the approximate reciprocal or exact divides: the count is the
    algorithm's, on the reference's steps."""
    spec = spec_of("flagship_1080p.live_1spp")
    ops = []
    for approx in (True, False):
        config = dict(spec.config, march=dict(spec.config["march"],
                                              approx_recip=approx))
        scene = image.Scene.of(config, torch.float32, "cpu", r=30.0,
                               theta=1.3, phi=0.0)
        ids = torch.arange(0, config["width"] * config["height"], 7)
        zero = torch.zeros(ids.numel())
        steps = image.mean_steps([scene], [(ids, zero, zero)])[0]
        pixels = config["width"] * config["height"]
        ops.append(counts.render_ops(steps * pixels, pixels))
    assert ops[0] == ops[1] and ops[0] > counts.OPS_PER_PIXEL * pixels


def test_director_track_covers_the_orbit():
    poses = director.track(64)
    radii = [r for r, _, _ in poses]
    assert len(poses) == 64 and max(radii) == 60.0 and min(radii) == 8.0
    assert all(abs(th - (math.pi / 2 - 0.25)) < 0.02 for _, th, _ in poses)
