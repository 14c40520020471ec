"""The render kernel on the card: against its plain PyTorch version, and
through the port's entry points.

Every test here is marked ``gpu`` and skips without a CUDA device. This file
imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch; there, skip tests/conftest.py (which configures JAX):

    python -m pytest --noconftest -q tests/test_torch_gpu.py
"""

import dataclasses as dc
import math

import pytest
import torch

from blackhole_simulation_tpu_torch.ops.render import (
    render_planes,
    render_planes_kernel,
)
from blackhole_simulation_tpu_torch.render.camera import Camera
from blackhole_simulation_tpu_torch.render.march import MarchConfig
from blackhole_simulation_tpu_torch.render.pipeline import (
    Features,
    Scene,
    kernel_inputs,
    render,
    render_radiance,
)

pytestmark = pytest.mark.gpu

# The flagship MarchConfig, cut to 48 steps.
CFG = MarchConfig(max_steps=48, use_pallas=True, fused=True,
                  shadow_precull=True, step_rate=0.2, far_step_cap_rate=0.4,
                  far_boost_radius=20.0, midpoint_iters=1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _scene(width=250, height=141, spin=0.9, features=Features(), **cfg):
    cam = Camera.create(r=30.0, theta=math.pi / 2 - 0.25, fov=0.5,
                        width=width, height=height)
    return Scene.create(mass=1.0, spin=spin, camera=cam,
                        march_cfg=dc.replace(CFG, **cfg), features=features)


@pytest.mark.parametrize("spectral", [False, True])
def test_kernel_matches_plain_version(cuda, spectral):
    row, st = kernel_inputs(_scene(features=Features(spectral_lut=spectral)),
                            None, cuda)
    before = render_planes_kernel.launches
    steps_k = torch.empty((st.height, st.width), dtype=torch.int32, device=cuda)
    steps_p = torch.empty_like(steps_k)
    k = render_planes_kernel(row, st, steps_k)
    p = render_planes(row, st, steps_p)
    torch.cuda.synchronize()
    assert render_planes_kernel.launches == before + 1
    d = (k - p).abs()
    assert float(torch.quantile(d.flatten(), 0.99)) < 1e-4
    assert float(d.mean()) < 1e-5
    assert float((steps_k != steps_p).float().mean()) < 1e-3


def test_approx_recip_stays_close(cuda):
    row, st = kernel_inputs(_scene(480, 270, spin=0.999, max_steps=256,
                                   approx_recip=True,
                                   features=Features(spectral_lut=True)),
                            None, cuda)
    k = render_planes_kernel(row, st)
    p = render_planes(row, dc.replace(st, cfg=dc.replace(st.cfg,
                                                         approx_recip=False)))
    d = (k - p).abs()
    assert bool(torch.isfinite(k).all())
    assert float(d.mean()) < 1e-3
    assert float((d.amax(dim=0) > 1e-2).float().mean()) < 0.01


def test_entry_points_launch_once_per_sample(cuda):
    scene = _scene(64, 32)
    before = render_planes_kernel.launches
    img = render(scene, n_samples=2)
    rad = render_radiance(scene)
    torch.cuda.synchronize()
    assert render_planes_kernel.launches == before + 3
    assert img.device.type == rad.device.type == "cuda"
    assert img.shape == rad.shape == (32, 64, 3)
    assert bool(torch.isfinite(img).all()) and float(img.max()) <= 1.0


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    row, st = kernel_inputs(_scene(16, 8), None, cuda)
    with pytest.raises(ValueError):
        render_planes_kernel(row.double(), st)
    with pytest.raises(NotImplementedError):
        render_planes_kernel(row, dc.replace(st, cfg=dc.replace(
            st.cfg, max_crossings=5)))
