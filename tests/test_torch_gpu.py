"""The CUDA kernels on the card: the render, march and gradient kernels
(with the band plane, the AB3 march, the jets, the start offset, the NRS far
field and the shadow overlay) and the FP32 peak probe against their plain
PyTorch versions, and through the port's entry points (render, the staged,
the certified and the full-featured render, the training step, NRS
training, the progressive tile renderer, TAA and the engine facade, each
against the same call on the CPU), and the app: the CLI's PNG against the
direct render, the live display program against the CPU.

Every test here is marked ``gpu`` and skips without a CUDA device. This file
imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch; there, skip tests/conftest.py (which configures JAX):

    python -m pytest --noconftest -q tests/test_torch_gpu.py
"""

import dataclasses as dc
import importlib
import math

import numpy as np
import pytest
import torch

from blackhole_simulation_tpu_torch.app import live
from blackhole_simulation_tpu_torch.app.cli import main as cli_main
from blackhole_simulation_tpu_torch.app.screenshot import encode_png
from blackhole_simulation_tpu_torch.configs import (
    SimulationParams,
    scene_from_params,
)
from blackhole_simulation_tpu_torch.engine import PhysicsEngine
from blackhole_simulation_tpu_torch.models.nrs import (
    generate_training_data,
    nrs_init,
    train_nrs,
)
from blackhole_simulation_tpu_torch.ops.ks_kernel import ks_renormalize_pr
from blackhole_simulation_tpu_torch.ops.march_adjoint import (
    march_step_vjp_at,
    renorm_discriminant,
    turning_point_states,
)
from blackhole_simulation_tpu_torch.ops import pallas_march
from blackhole_simulation_tpu_torch.ops.march import ab3_renorm_plan
from blackhole_simulation_tpu_torch.ops.march_grad import (
    grad_kernel_shape,
    march_grad,
    march_grad_kernel,
    minmax_check,
    renorm_vjp_check,
    step_vjp_check,
)
from blackhole_simulation_tpu_torch.ops.pallas_march import (
    march_kernel_shape,
    march_u,
    march_u_plain,
    ray_pool,
)
from blackhole_simulation_tpu_torch.ops.render import (
    render_kernel_shape,
    render_planes,
    render_planes_kernel,
)
from blackhole_simulation_tpu_torch.parallel import (
    InverseParams,
    make_inverse_step,
)
from blackhole_simulation_tpu_torch.render.accumulate import TemporalAccumulator
from blackhole_simulation_tpu_torch.render.camera import Camera, camera_rays_u
from blackhole_simulation_tpu_torch.render.march import (
    MarchConfig,
    _march_inputs,
)
from blackhole_simulation_tpu_torch.render.pipeline import (
    Features,
    Scene,
    kernel_inputs,
    render,
    render_radiance,
)
from blackhole_simulation_tpu_torch.render.precull import (
    critical_band_metric_u,
)
from blackhole_simulation_tpu_torch.render.shading import JetParams, disk_luts
from blackhole_simulation_tpu_torch.render.tiles import ProgressiveRenderer
from blackhole_simulation_tpu_torch.tools import vpu_peak

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
    """A float64 row, and a crossing count outside 1..KMAX_LIMIT (any
    count in between takes a build with enough slots, ops/build.py)."""
    from blackhole_simulation_tpu_torch.ops.build import KMAX_LIMIT

    row, st = kernel_inputs(_scene(16, 8), None, cuda)
    with pytest.raises(ValueError):
        render_planes_kernel(row.double(), st)
    for k in (0, KMAX_LIMIT + 1):
        with pytest.raises(ValueError):
            render_planes_kernel(row, dc.replace(st, cfg=dc.replace(
                st.cfg, max_crossings=k)))


def _march_args(cuda, cfg, width=250, height=141, spin=0.9):
    m = torch.tensor(1.0, device=cuda)
    a = torch.tensor(spin, device=cuda)
    cam = Camera.create(r=30.0, theta=math.pi / 2 - 0.25, fov=0.5,
                        width=width, height=height)
    with torch.no_grad():
        return _march_inputs(camera_rays_u(cam, m, a), m, a, cfg, None)


def test_march_kernel_matches_plain_version(cuda):
    cfg = dc.replace(CFG, fused=False)
    args = _march_args(cuda, cfg)
    before = march_u.launches
    with torch.no_grad():
        k = march_u(*args, cfg)
        p = march_u_plain(*args, cfg)
    assert march_u.launches == before + 1
    for i in (1, 2, 6):   # hit, steps, crossing count
        assert torch.equal(k[i], p[i]), i
    for i in (0, 3, 4, 5, 7):   # state, crossing records, r_min
        assert float((k[i] - p[i]).abs().max()) < 1e-4, i


def test_staged_render_matches_fused(cuda):
    fused = _scene(96, 54)
    staged = dc.replace(fused, march_cfg=dc.replace(CFG, fused=False))
    before = march_u.launches
    a = render_radiance(staged)
    torch.cuda.synchronize()
    assert march_u.launches == before + 1
    d = (a - render_radiance(fused)).abs()
    assert float(torch.quantile(d.flatten(), 0.99)) < 1e-4
    assert float(d.mean()) < 1e-5


def test_staged_spectral_render_on_the_lut_route(cuda):
    """A staged spectral scene from Scene.create carries no Chebyshev
    tables, so its disk shades from the LUTs: through the march kernel on
    the card, held against the same scene's plain render on the CPU at the
    analytic bars; a second frame finds its tables on the card."""
    scene = _scene(96, 54, features=Features(spectral_lut=True), fused=False)
    assert scene.spectral_coeffs is None
    before = march_u.launches
    img = render_radiance(scene)
    hits = disk_luts.cache_info().hits
    render_radiance(scene)
    torch.cuda.synchronize()
    assert march_u.launches == before + 2
    assert disk_luts.cache_info().hits > hits
    d = (img.cpu() - render_radiance(scene, device="cpu")).abs()
    assert bool(torch.isfinite(img).all())
    assert float(torch.quantile(d.flatten(), 0.99)) < 1e-4
    assert float(d.mean()) < 1e-5


def test_grad_kernel_matches_plain_version(cuda):
    cfg = MarchConfig(max_steps=48, shadow_precull=False, remat_every=0)
    args = _march_args(cuda, cfg, 48, 32)
    n, k_slots = args[0].shape[1], cfg.max_crossings
    with torch.no_grad():
        rmin = march_u(*args, cfg)[7]
    rng = np.random.default_rng(0)
    f = lambda *s: torch.from_numpy(
        rng.normal(size=s).astype(np.float32)).to(cuda)
    cts = (f(8, n), f(k_slots, n), f(k_slots, n), f(k_slots, n), f(n))
    before = march_grad_kernel.launches
    k = march_grad_kernel(*args, cfg, *cts, rmin)
    p = march_grad(*args, cfg, *cts, rmin)
    assert march_grad_kernel.launches == before + 1
    rows = [0, 1, 2, 3, 5, 6, 7]
    rel = (k[0][rows] - p[0][rows]).abs() / (p[0][rows].abs() + 1e-6)
    assert bool(torch.isfinite(k[0]).all())
    assert float(torch.quantile(rel.flatten(), 0.95)) < 1e-2
    for x, y in zip(k[1:], p[1:]):
        assert float(x) == pytest.approx(float(y), rel=5e-3)


@pytest.mark.parametrize("approx", [False, True])
def test_step_adjoint_matches_dual_pass(cuda, approx):
    """The gradient kernel's hand-written per-step adjoint against the
    forward-mode Dual<11> pass over the same step, on every live step of
    48 with unit cotangents (csrc/step_vjp_check.cu): the relative
    difference, floored at 1e-6, has p99 below 1e-4 and at most 0.1% above
    1e-3; no element differs by more than 1e-4 of the size of its
    derivative's terms."""
    cfg = dc.replace(CFG, fused=False, approx_recip=approx)
    args = _march_args(cuda, cfg, 96, 54)
    gen = torch.Generator(device=cuda).manual_seed(0)
    cts = torch.randn((10, args[0].shape[1]), generator=gen, device=cuda)
    chk = step_vjp_check(*args, cfg, cts, 48)
    live = chk["live"]
    adj, dual, size = (chk[k][:, live] for k in ("adjoint", "dual", "size"))
    assert bool(torch.isfinite(adj).all()) and bool(torch.isfinite(dual).all())
    diff = (adj - dual).abs()
    rel = diff / (dual.abs() + 1e-6)
    assert float(torch.quantile(rel.flatten(), 0.99)) < 1e-4
    assert float((rel > 1e-3).double().mean()) <= 1e-3
    assert float(torch.where(diff > 0, diff / size, 0.0).max()) <= 1e-4


def test_adjoint_mirror_matches_header(cuda):
    """ops/march_adjoint.py (the CPU mirror the CPU tests hold against
    autograd and JAX) equals csrc/march_adjoint.cuh's adjoint bit for bit at
    exact divides, on the states and cotangents of every live step of 48."""
    cfg = dc.replace(CFG, fused=False, approx_recip=False)
    args = _march_args(cuda, cfg, 96, 54)
    gen = torch.Generator(device=cuda).manual_seed(1)
    cts = torch.randn((10, args[0].shape[1]), generator=gen, device=cuda)
    chk = step_vjp_check(*args, cfg, cts, 48)
    live = chk["live"].cpu()
    got = chk["adjoint"].cpu()[:, live]
    want = march_step_vjp_at(chk, *args, cfg, cts)[:, live]
    assert torch.equal(got, want)


def test_renorm_adjoint_at_turning_points(cuda):
    """The renormalization's adjoint at planted radial turning points
    (among them discriminants of exactly 0) against ks_renormalize_pr on
    Dual<7>: each state's largest difference below 1e-5 of its largest
    cotangent; at the exact double root, against float64 autograd."""
    q = turning_point_states(device=cuda)
    assert int((renorm_discriminant(q) == 0).sum()) >= 1
    adj, dual = renorm_vjp_check(q)
    assert bool(torch.isfinite(adj).all()) and bool(torch.isfinite(dual).all())
    worst = (adj - dual).abs().amax(0) / dual.abs().amax(0).clamp_min(1e-30)
    assert float(worst.max()) <= 1e-5
    ins = [x.double().clone().requires_grad_() for x in q[:7, :1].cpu()]
    out = ks_renormalize_pr(ins[0], ins[1], ins[2], ins[3],
                            torch.full_like(ins[0], -1.0), ins[4], ins[5],
                            ins[6])
    ref = torch.autograd.grad(out, ins, q[7, :1].double().cpu(),
                              allow_unused=True)
    for x, r in zip(adj[:, 0].cpu(), ref):
        r = 0.0 if r is None else float(r)
        assert float(x) == pytest.approx(r, rel=1e-5, abs=1e-6)


def test_grad_kernel_shape(cuda):
    """The gradient kernel's stack fits the blocks its register cap
    allows: at least 12 resident warps per SM."""
    shape = grad_kernel_shape()
    assert shape["warps_per_sm"] >= 12, shape
    assert shape["smem_bytes"] == shape["ckpt"] * 7 * shape["threads"] * 4


def test_training_step_runs_both_kernels(cuda):
    scene = _scene(64, 32, spin=0.999, fused=False)
    params = InverseParams.init(spin=0.9, theta_cam=scene.camera.theta)
    before = (march_u.launches, march_grad_kernel.launches)
    (p1, _), loss = make_inverse_step(scene)(
        params, torch.zeros(32, 64, 3, device=cuda))
    torch.cuda.synchronize()
    assert (march_u.launches, march_grad_kernel.launches) == (
        before[0] + 1, before[1] + 1)
    assert p1.spin.device.type == "cuda"
    assert math.isfinite(float(loss))
    assert all(math.isfinite(float(v)) for v in p1.leaves())


@pytest.mark.parametrize("spectral", [False, True])
def test_ab3_render_kernel_matches_plain_version(cuda, spectral):
    row, st = kernel_inputs(_scene(features=Features(spectral_lut=spectral),
                                   multistep=True), None, cuda)
    before = render_planes_kernel.launches
    k = render_planes_kernel(row, st)
    p = render_planes(row, st)
    torch.cuda.synchronize()
    assert render_planes_kernel.launches == before + 1
    d = (k - p).abs()
    assert float(torch.quantile(d.flatten(), 0.99)) < 1e-4
    assert float(d.mean()) < 1e-5


@pytest.mark.parametrize("max_steps", [48, 60])
def test_ab3_march_kernel_matches_plain_version(cuda, max_steps):
    cfg = dc.replace(CFG, fused=False, multistep=True, max_steps=max_steps)
    args = _march_args(cuda, cfg)
    with torch.no_grad():
        k = march_u(*args, cfg)
        p = march_u_plain(*args, cfg)
    for i in (1, 2, 6):
        assert torch.equal(k[i], p[i]), i
    for i in (0, 3, 4, 5, 7):
        assert float((k[i] - p[i]).abs().max()) < 1e-4, i


@pytest.mark.parametrize("pole", [0.0, 0.05])
def test_band_plane_matches_plain_version(cuda, pole):
    scene = _scene(spin=0.999, refine_band=0.6, refine_pole_w=pole)
    row, st = kernel_inputs(scene, None, cuda)
    k = render_planes_kernel(row, st)
    p = render_planes(row, st)
    assert k.shape == p.shape == (4, 141, 250)
    assert float((k - p).abs().max()) < 1e-3
    if pole == 0.0:
        m = torch.tensor(1.0, device=cuda)
        a = torch.tensor(0.999, device=cuda)
        ref = critical_band_metric_u(m, a, camera_rays_u(scene.camera, m, a))
        assert float((k[3].reshape(-1) - ref).abs().max()) < 1e-3
        assert 0.0 < float((k[3] < 0.6).float().mean()) < 0.05


def test_certified_render_launches_render_and_march_once(cuda):
    scene = _scene(96, 54, spin=0.999, refine_band=0.6, refine_budget=512)
    before = (render_planes_kernel.launches, march_u.launches)
    img = render_radiance(scene)
    torch.cuda.synchronize()
    assert (render_planes_kernel.launches, march_u.launches) == (
        before[0] + 1, before[1] + 1)
    staged = render_radiance(dc.replace(scene, march_cfg=dc.replace(
        scene.march_cfg, use_pallas=False, fused=False)))
    assert bool(torch.isfinite(img).all())
    d = (img - staged).abs()
    assert float(torch.quantile(d.flatten(), 0.99)) < 1e-3


def test_probe_matches_plain_version(cuda):
    # The plain version rounds each step once, as __fmaf_rn does: the two
    # agree bit for bit. One step moves a chain by ~2e-7 relative, so the
    # 1e-6 bar catches a missing loop iteration (8 or 16 steps).
    x = vpu_peak.starts(16, 4096, cuda, seed=1)
    before = vpu_peak.fma_chains.launches
    k = vpu_peak.fma_chains(x, 64, 16)
    assert vpu_peak.fma_chains.launches == before + 1
    p = vpu_peak.fma_chains_plain(x, 64, 16)
    assert float(((k - p).abs() / p.abs()).max()) < 1e-6
    peak, out = vpu_peak.measure(iters=256, grid=264, reps=3)
    assert vpu_peak.fma_chains.launches == before + 5
    p = vpu_peak.fma_chains_plain(vpu_peak.starts(8, out.numel(), cuda), 256,
                                  8)
    assert float(((out - p).abs() / p.abs()).max()) < 1e-6
    assert peak["lane_fma_per_s"] > 0.0


# Each branch of the render kernel alone and all four together:
# (Features overrides, MarchConfig overrides, fov).
BRANCHES = {
    "jets": (dict(jets=True), {}, 0.5),
    "start_jitter": ({}, dict(start_jitter=0.5), 0.5),
    "nrs": (dict(nrs_far_field=True), {}, 1.0),
    "overlay": (dict(shadow_overlay=True), {}, 0.5),
    "all": (dict(jets=True, shadow_overlay=True, nrs_far_field=True),
            dict(start_jitter=0.5), 1.0),
}


def _branch_scene(name, width=250, height=141):
    feats, cfg, fov = BRANCHES[name]
    cam = Camera.create(r=30.0, theta=math.pi / 2 - 0.25, fov=fov,
                        width=width, height=height)
    scene = Scene.create(mass=1.0, spin=0.9, camera=cam,
                         march_cfg=dc.replace(CFG, **cfg),
                         features=Features(**feats))
    if feats.get("nrs_far_field"):
        scene = dc.replace(scene, nrs_params=nrs_init(0))
    return scene


@pytest.mark.parametrize("name", sorted(BRANCHES))
def test_render_kernel_branch_matches_plain_version(cuda, name):
    row, st = kernel_inputs(_branch_scene(name), None, cuda)
    before = render_planes_kernel.launches
    k = render_planes_kernel(row, st)
    p = render_planes(row, st)
    torch.cuda.synchronize()
    assert render_planes_kernel.launches == before + 1
    d = (k - p).abs()
    assert bool(torch.isfinite(k).all())
    assert float(torch.quantile(d.flatten(), 0.99)) < 1e-4
    assert float(d.mean()) < 1e-5


def test_jets_march_kernel_matches_plain_version(cuda):
    cfg = dc.replace(CFG, fused=False, shadow_precull=False)
    args = _march_args(cuda, cfg)
    before = march_u.launches
    with torch.no_grad():
        k = march_u(*args, cfg, JetParams())
        p = march_u_plain(*args, cfg, JetParams())
    assert march_u.launches == before + 1
    for i in (1, 2, 6):
        assert torch.equal(k[i], p[i]), i
    for i in (0, 3, 4, 5, 7):
        assert float((k[i] - p[i]).abs().max()) < 1e-4, i
    assert float(p[8].max()) > 1e-3
    rel = (k[8] - p[8]).abs() / (p[8].abs() + 1e-12)
    assert float(rel.max()) < 1e-5


def test_full_featured_render_runs_the_kernels(cuda):
    scene = scene_from_params(SimulationParams(enable_jets=True), 96, 54)
    assert scene.march_cfg.fused and scene.features.jets
    before = render_planes_kernel.launches
    img = render(scene)
    torch.cuda.synchronize()
    assert render_planes_kernel.launches == before + 1
    assert img.shape == (54, 96, 3) and bool(torch.isfinite(img).all())
    staged = dc.replace(_branch_scene("all", 96, 54), march_cfg=dc.replace(
        CFG, fused=False, start_jitter=0.5))
    before = march_u.launches
    img = render(staged)
    torch.cuda.synchronize()
    assert march_u.launches == before + 1
    assert bool(torch.isfinite(img).all())


# Small and ragged launches: one ray, fewer than a warp, fewer than the
# march kernel's resident lanes, a ragged frame; render variants (midpoint,
# AB3, every branch) and march variants (midpoint, AB3, jets).
POOL_FRAMES = [(1, 1), (31, 1), (128, 128), (250, 141)]
POOL_RAYS = [1, 31, 16384, 250 * 141]


def _bits(x):
    return x.view(torch.int32) if x.is_floating_point() else x


def _pool_scene(variant, width, height):
    if variant == "all":
        return _branch_scene("all", width, height)
    return _scene(width, height, multistep=variant == "ab3",
                  features=Features(spectral_lut=variant == "ab3"))


@pytest.mark.parametrize("size", POOL_FRAMES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("variant", ["midpoint", "ab3", "all"])
def test_render_kernel_pool_edges(cuda, variant, size):
    """Kernel vs plain version with identical step counts, and every
    element of the planes and steps written by one launch: two launches
    into buffers pre-filled with different sentinels agree bit for bit."""
    row, st = kernel_inputs(_pool_scene(variant, *size), None, cuda)
    sk = torch.empty((st.height, st.width), dtype=torch.int32, device=cuda)
    sp = torch.empty_like(sk)
    k = render_planes_kernel(row, st, sk)
    p = render_planes(row, st, sp)
    assert torch.equal(sk, sp)
    d = (k - p).abs()
    assert float(torch.quantile(d.flatten(), 0.99)) < 1e-4
    assert float(d.mean()) < 1e-5
    outs = []
    for fill, ifill in ((math.nan, -1), (7.0, 12345)):
        out = torch.full_like(k, fill)
        steps = torch.full_like(sk, ifill)
        render_planes_kernel(row, st, steps, out=out)
        outs.append((out, steps))
    assert torch.equal(_bits(outs[0][0]), _bits(outs[1][0]))
    assert torch.equal(outs[0][1], outs[1][1])
    assert torch.equal(_bits(outs[0][0]), _bits(k))


@pytest.mark.parametrize("n", POOL_RAYS)
@pytest.mark.parametrize("variant", ["midpoint", "ab3", "jets"])
def test_march_kernel_pool_edges(cuda, variant, n):
    cfg = dc.replace(CFG, fused=False, shadow_precull=False,
                     multistep=variant == "ab3")
    jets = JetParams() if variant == "jets" else None
    rays = _march_args(cuda, cfg)
    args = (rays[0][:, :n].contiguous(), rays[1][:n].contiguous(),
            *rays[2:6], cfg, jets)
    with torch.no_grad():
        k = march_u(*args)
        p = march_u_plain(*args)
        for i in (1, 2, 6):
            assert torch.equal(k[i], p[i]), i
        for i in (0, 3, 4, 5, 7):
            assert float((k[i] - p[i]).abs().max()) < 1e-4, i
        if jets is not None:
            rel = (k[8] - p[8]).abs() / (p[8].abs() + 1e-12)
            assert float(rel.max()) < 1e-5
        outs = []
        for fill, ifill in ((math.nan, -1), (7.0, 12345)):
            out = tuple(torch.full_like(x, ifill if x.dtype == torch.int32
                                        else fill) for x in k)
            march_u(*args, out=out)
            outs.append(out)
            assert not bool(ray_pool(cuda).any())
    for a, b, c in zip(*outs, k):
        assert torch.equal(_bits(a), _bits(b))
        assert torch.equal(_bits(a), _bits(c))


def test_kernel_shapes(cuda):
    """Resident warps per SM of every instantiation: at least 4, and the
    flagship ones at least 24."""
    row, st = kernel_inputs(_scene(16, 8, max_steps=256), None, cuda)
    assert render_kernel_shape(st)["warps_per_sm"] >= 24
    assert march_kernel_shape(CFG)["warps_per_sm"] >= 24
    for name in sorted(BRANCHES):
        _, st = kernel_inputs(_branch_scene(name, 16, 8), None, cuda)
        for multistep in (False, True):
            shape = render_kernel_shape(dc.replace(st, cfg=dc.replace(
                st.cfg, multistep=multistep)))
            assert shape["warps_per_sm"] >= 4 and shape["sms"] > 0, shape
    for cfg, jets in ((dc.replace(CFG, multistep=True), None),
                      (CFG, JetParams())):
        assert march_kernel_shape(cfg, jets)["warps_per_sm"] >= 4


# The approx_recip route (the step's reciprocals approximate, its
# multiply-adds contracted) against the plain version at exact divides,
# 480x270, 256 steps: all finite, mean |d| < 1e-3, under 1% of pixels with
# a channel above 1e-2 (chip_smoke.py phase 3).
def _approx_bars(k, p):
    d = (k - p).abs()
    assert bool(torch.isfinite(k).all())
    assert float(d.mean()) < 1e-3
    assert float((d.amax(dim=0) > 1e-2).float().mean()) < 0.01


def _approx_scene(name):
    kw = dict(max_steps=256, approx_recip=True)
    if name == "flagship":
        return _scene(480, 270, spin=0.999,
                      features=Features(spectral_lut=True), **kw)
    if name == "ab3":
        return _scene(480, 270, spin=0.999,
                      features=Features(spectral_lut=True), multistep=True,
                      **kw)
    scene = _branch_scene("jets" if name == "jets" else "all", 480, 270)
    return dc.replace(scene, march_cfg=dc.replace(scene.march_cfg, **kw))


@pytest.mark.parametrize("name", ["flagship", "ab3", "jets", "full"])
def test_approx_route_render_instantiations(cuda, name):
    row, st = kernel_inputs(_approx_scene(name), None, cuda)
    assert st.cfg.approx_recip
    k = render_planes_kernel(row, st)
    p = render_planes(row, dc.replace(st, cfg=dc.replace(
        st.cfg, approx_recip=False)))
    _approx_bars(k, p)


def _plain_march(yt0, thr, m, a, r_h, r_ph, cfg, jets=None, out=None):
    return march_u_plain(yt0, thr, m, a, r_h, r_ph, cfg, jets)


@pytest.mark.parametrize("multistep", [False, True])
def test_approx_route_march_instantiations(cuda, multistep, monkeypatch):
    """The staged render through the march kernel's approx_recip
    instantiation against the same render with the plain march."""
    scene = _scene(480, 270, spin=0.999, max_steps=256, approx_recip=True,
                   multistep=multistep, fused=False)
    before = march_u.launches
    k = render_radiance(scene)
    assert march_u.launches == before + 1
    monkeypatch.setattr(pallas_march, "march_u", _plain_march)
    p = render_radiance(scene)
    _approx_bars(k.permute(2, 0, 1), p.permute(2, 0, 1))


def test_approx_route_march_jets(cuda):
    cfg = dc.replace(CFG, max_steps=256, approx_recip=True, fused=False,
                     shadow_precull=False)
    args = _march_args(cuda, cfg, 480, 270)
    with torch.no_grad():
        k = march_u(*args, cfg, JetParams())[8]
        p = march_u_plain(*args, cfg, JetParams())[8]
    _approx_bars(k.reshape(3, 270, 480), p.reshape(3, 270, 480))


@pytest.mark.parametrize("approx", [False, True])
def test_gradient_replay_equals_forward(cuda, approx):
    """The gradient kernel's replay lands on the forward march's steps:
    every ray's hit, live steps and crossing count equal the march
    kernel's, on both routes."""
    cfg = dc.replace(CFG, max_steps=256, fused=False, approx_recip=approx)
    args = _march_args(cuda, cfg, 128, 96, spin=0.999)
    yt0, n = args[0], args[0].shape[1]
    gen = torch.Generator(device=cuda).manual_seed(3)
    k = cfg.max_crossings
    cts = [torch.randn(shape, generator=gen, device=cuda)
           for shape in ((8, n), (k, n), (k, n), (k, n), (n,))]
    replay = torch.full((3, n), -1, dtype=torch.int32, device=cuda)
    with torch.no_grad():
        fwd = march_u(*args, cfg)
        march_grad_kernel(*args, cfg, *cts, fwd[7], replay=replay)
    torch.cuda.synchronize()
    for row, i in ((0, 1), (1, 2), (2, 6)):
        assert torch.equal(replay[row], fwd[i]), row
    assert int(fwd[6].sum()) > 0 and int(fwd[2].max()) > 16


# Signed zeros, NaN of both signs, infinities, denormals, ordinary values.
MINMAX_VALUES = (0.0, -0.0, 1.0, -1.0, math.nan, -math.nan, math.inf,
                 -math.inf, 1e-40, -1e-40, 1e-6, 0.25)


def test_minmax_on_planted_pairs(cuda):
    """One FMNMX against the compare-compare-select form: the same bits, or
    both NaN, on every pair but the ties of opposite-sign zeros, where IEEE
    754's -0 < +0 holds (max(+0, -0) = +0, min(-0, +0) = -0)."""
    vals = torch.tensor(MINMAX_VALUES, dtype=torch.float32, device=cuda)
    a = vals.repeat_interleave(len(MINMAX_VALUES))
    b = vals.repeat(len(MINMAX_VALUES))
    got = minmax_check(a, b)
    bits, nan = got.view(torch.int32), torch.isnan(got)
    zero_tie = (a == 0) & (b == 0) & (torch.signbit(a) != torch.signbit(b))
    for new, old in ((0, 1), (2, 3)):
        same = (bits[new] == bits[old]) | (nan[new] & nan[old])
        assert bool(same[~zero_tie].all()), new
    assert bool(torch.isnan(got[:, torch.isnan(a) | torch.isnan(b)]).all())
    tie = zero_tie.nonzero().flatten()
    assert not bool(torch.signbit(got[0, tie]).any())
    assert bool(torch.signbit(got[2, tie]).all())


def _exact_route_bit_equal(row, st, cfg, cuda):
    """The render kernel's planes and steps and every output row of the
    march kernel bit-equal to their plain versions (exact divides): a
    renormalization one step early or late moves p_r by the null
    constraint's drift alone, which only bit equality sees."""
    assert not st.cfg.approx_recip and not cfg.approx_recip
    sk = torch.empty((st.height, st.width), dtype=torch.int32, device=cuda)
    sp = torch.empty_like(sk)
    k = render_planes_kernel(row, st, sk)
    p = render_planes(row, st, sp)
    assert torch.equal(sk, sp)
    assert torch.equal(_bits(k), _bits(p))
    args = _march_args(cuda, cfg)
    with torch.no_grad():
        k, p = march_u(*args, cfg), march_u_plain(*args, cfg)
    for i, (a, b) in enumerate(zip(k, p)):
        assert torch.equal(_bits(a), _bits(b)), i


@pytest.mark.parametrize("renorm", [1, 3, 16])
def test_renormalization_countdown_lands_on_the_same_steps(cuda, renorm):
    """The counted-down renormalization at renormalize_every = 1, 3, 16,
    exact divides: the render and march kernels equal their plain versions,
    whose cadence is (i + 1) % renormalize_every == 0."""
    row, st = kernel_inputs(_scene(renormalize_every=renorm), None, cuda)
    _exact_route_bit_equal(row, st, dc.replace(
        CFG, renormalize_every=renorm, fused=False), cuda)


# AB3's renormalization regimes (tests/test_torch_ab3.py): (max_steps,
# renormalize_every, exit_check_every).
AB3_REGIMES = {"default-16-8": (48, 16, 8), "steps-below-exit": (40, 20, 64),
               "no-renorm-12-8": (48, 12, 8), "tail-60-16-8": (60, 16, 8)}


@pytest.mark.parametrize("regime", sorted(AB3_REGIMES))
def test_ab3_renormalization_countdown_and_tail(cuda, regime):
    """AB3's countdown starts after its bootstrap (i >= 2) and its tail
    rule renormalizes once more after the march: both kernels equal their
    plain versions in every regime of ops/march.py::ab3_renorm_plan."""
    steps, renorm, exit_every = AB3_REGIMES[regime]
    kw = dict(max_steps=steps, renormalize_every=renorm,
              exit_check_every=exit_every, multistep=True)
    assert ab3_renorm_plan(dc.replace(CFG, **kw)) == {
        "default-16-8": (16, False), "steps-below-exit": (0, False),
        "no-renorm-12-8": (0, False), "tail-60-16-8": (16, True)}[regime]
    row, st = kernel_inputs(_scene(**kw), None, cuda)
    _exact_route_bit_equal(row, st, dc.replace(CFG, fused=False, **kw), cuda)


# --- NRS training, tiles, TAA and the engine on the card ------------------------

def test_nrs_labels_and_training_match_cpu(cuda):
    """Phase 16's bars at a small size: the labels on the card against the
    CPU's (flags identical, |d| < 1e-5), 100 training steps from the same
    weights (loss histories rel < 1e-3)."""
    x, y = generate_training_data(n=64, seed=1, device=cuda)
    xc, yc = generate_training_data(n=64, seed=1, device="cpu")
    assert x.device.type == "cuda" and torch.equal(x.cpu(), xc)
    assert torch.equal(y[:, 2].cpu(), yc[:, 2])
    assert float((y.cpu() - yc)[:, :2].abs().max()) < 1e-5
    start = nrs_init(0, "cpu")
    params, l_card = train_nrs(x, y, n_steps=100, lr=5e-3, params=start,
                               device=cuda)
    _, l_cpu = train_nrs(xc, yc, n_steps=100, lr=5e-3, params=start,
                         device="cpu")
    assert params[0][0].device.type == "cuda"
    np.testing.assert_allclose(l_card, l_cpu, rtol=1e-3)


def test_integrate_graphed_blocks_equal_eager(cuda, monkeypatch):
    """The integrator's trial blocks as CUDA graphs give the eager loop's
    labels bit for bit."""
    x, y = generate_training_data(n=32, seed=3, device=cuda)
    module = importlib.import_module(
        "blackhole_simulation_tpu_torch.geodesic.integrate")
    monkeypatch.setattr(module, "graphed_blocks",
                        lambda trials, carry, *rest: (carry, 0))
    x2, y2 = generate_training_data(n=32, seed=3, device=cuda)
    assert torch.equal(x, x2) and torch.equal(y, y2)


def test_trained_nrs_render_kernel_matches_plain_version(cuda):
    x, y = generate_training_data(n=128, seed=1, device=cuda)
    params, losses = train_nrs(x, y, n_steps=300, lr=5e-3, device=cuda)
    assert losses[-1] < losses[0]
    scene = dc.replace(_branch_scene("nrs"), nrs_params=params)
    row, st = kernel_inputs(scene, None, cuda)
    before = render_planes_kernel.launches
    d = (render_planes_kernel(row, st) - render_planes(row, st)).abs()
    assert render_planes_kernel.launches == before + 1
    assert float(torch.quantile(d.flatten(), 0.99)) < 1e-4
    assert float(d.mean()) < 1e-5


def test_progressive_renderer_launches_the_march_kernel(cuda):
    """One march launch per batch of tiles, every pixel covered, the image
    against the staged render_radiance (tests/test_tiles.py's bar)."""
    scene = _scene(128, 96, max_steps=64, fused=False)
    prog = ProgressiveRenderer(scene, tile=32, batch_tiles=4, device=cuda)
    before = march_u.launches
    img = prog.render_all()
    assert march_u.launches - before == -(-prog.grid.n_tiles // 4)
    assert img.device.type == "cuda" and prog.covered.all()
    ref = render_radiance(scene, device=cuda)
    diff = (img - ref).abs().amax(dim=-1)
    assert float((diff < 1e-3).float().mean()) > 0.998
    assert float(diff.max()) < 5e-2


@pytest.mark.parametrize("orbit", [False, True])
def test_taa_on_the_card_matches_cpu(cuda, orbit):
    rng = np.random.default_rng(3)
    frames = rng.random((6, 54, 96, 3)).astype(np.float32)
    acc_k, acc_c = TemporalAccumulator(), TemporalAccumulator()
    for k, f in enumerate(frames):
        cam = (30.0, 1.3, 0.01 * k, 0.5, 0.0) if orbit else None
        out_k = acc_k.resolve(torch.from_numpy(f).to(cuda), orbit, cam)
        out_c = acc_c.resolve(torch.from_numpy(f), orbit, cam)
        assert out_k.device.type == "cuda"
        assert float((out_k.cpu() - out_c).abs().max()) < 1e-5


def test_engine_on_the_card_matches_cpu(cuda):
    card = PhysicsEngine(1.0, 0.9, prefer_native=False, device=cuda)
    host = PhysicsEngine(1.0, 0.9, prefer_native=False, device="cpu")
    r = np.linspace(1.2, 20.0, 64)
    th = np.linspace(0.05, np.pi - 0.05, 33)
    for name in ("compute_horizon", "compute_isco", "compute_shadow_shift",
                 "compute_hawking_temperature"):
        np.testing.assert_allclose(getattr(card, name)(),
                                   getattr(host, name)(), rtol=1e-12)
    np.testing.assert_allclose(card.compute_g_factor(8.0, 2.0),
                               host.compute_g_factor(8.0, 2.0), rtol=1e-12)
    for name in ("compute_kretschmann_field", "compute_frame_drag_field",
                 "compute_light_cone_field"):
        np.testing.assert_allclose(getattr(card, name)(r, th)[2],
                                   getattr(host, name)(r, th)[2], rtol=1e-10)
    np.testing.assert_allclose(card.generate_embedding_mesh(),
                               host.generate_embedding_mesh(), rtol=1e-10)
    ray = [0.0, 20.0, math.pi / 2, 0.0, -1.0, -0.5, 0.0, 0.0]
    a = card.integrate_ray_relativistic(ray, max_steps=20_000)
    b = host.integrate_ray_relativistic(ray, max_steps=20_000)
    assert (a["termination"], a["steps_taken"]) == (b["termination"],
                                                    b["steps_taken"])


def test_cli_render_png_equals_direct_render(cuda, tmp_path):
    """``cli render`` (no --device: the card) writes the PNG of the direct
    fused render on the card, byte for byte, from one render launch."""
    path = str(tmp_path / "r.png")
    render_planes_kernel.launches = 0
    assert cli_main(["render", "--width", "320", "--height", "180", "--out",
                     path]) == 0
    assert render_planes_kernel.launches == 1
    scene = scene_from_params(SimulationParams(), 320, 180, device=cuda)
    assert scene.march_cfg.fused and scene.march_cfg.approx_recip
    img = render(scene, device=cuda).clamp(0.0, 1.0).cpu().numpy()
    with open(path, "rb") as f:
        assert f.read() == encode_png(img)


def test_live_display_program_matches_cpu(cuda):
    """The live display program (antialiased resize, reprojected TAA,
    uint8) on the card against the CPU on the same two card-rendered
    frames of the fused path, the second accumulated on the first."""
    cfg = live.live_march_config("medium", True)
    w, h = live.rung_size(640, 360, 1.0)
    cams = [live.live_camera(30.0, 1.3, 0.2, 0.9),
            live.live_camera(29.8, 1.31, 0.25, 0.9)]
    frames = [live.render_live_frame(c, 1.0, cfg, w, h, cuda) for c in cams]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        hist = prev = None
        for img, c in zip(frames, cams):
            cam_now = (*c[:3], 0.5, 0.0)
            disp, hist_new = live.display_program(
                img.to(dev), hist, prev, cam_now, hist is not None, 32, 60)
            hist, prev = hist_new, cam_now
        out[dev.type] = (disp.cpu(), hist.cpu())
    assert out["cuda"][1].shape == (32, 60, 3)
    assert float((out["cuda"][1] - out["cpu"][1]).abs().max()) <= 1e-5
    assert int((out["cuda"][0].int() - out["cpu"][0].int()).abs().max()) <= 1


# ---------------------------------------------------------------------------
# The differentiable render (chip_smoke.py phase 22)
# ---------------------------------------------------------------------------

JET_CAM = Camera.create(r=30.0, theta=0.9, fov=1.0, width=24, height=16)


def test_jets_gradient_kernel_matches_its_plain_version(cuda):
    """The gradient kernel's jets instantiation against march_grad with
    the jets, seeded positive cotangents of every output and of the jet
    radiance (a loss's, as the summed partials then add without
    cancelling): every ray's worst row within rel 1e-2 (on 384 rays the
    99.9th percentile is the worst ray), the summed partials within 1e-3."""
    from blackhole_simulation_tpu_torch.render.shading import JetParams

    cfg = MarchConfig(max_steps=64)
    jets = JetParams()
    m, a = torch.tensor(1.0, device=cuda), torch.tensor(0.9, device=cuda)
    yt0, thr, m, a, r_h, r_ph = _march_inputs(
        camera_rays_u(JET_CAM, m, a), m, a, cfg, None)
    outs = march_u(yt0, thr, m, a, r_h, r_ph, cfg, jets)
    assert int((outs[8].abs().sum(0) > 0).sum()) > 0
    n, k = yt0.shape[1], cfg.max_crossings
    g = torch.Generator(device="cpu").manual_seed(2)
    f = lambda *s: (0.5 + torch.rand(*s, generator=g)).to(cuda)
    ct_fin = f(8, n)
    ct_fin[4] = 0.0
    args = (yt0, thr, m, a, r_h, r_ph, cfg, ct_fin, f(k, n), f(k, n),
            f(k, n), f(n), outs[7], f(3, n), jets)
    before = march_grad_kernel.launches
    got = march_grad_kernel(*args)
    assert march_grad_kernel.launches == before + 1
    want = march_grad(*args)
    rows = [0, 1, 2, 3, 5, 6, 7]
    rel = ((got[0][rows] - want[0][rows]).abs()
           / (want[0][rows].abs() + 1e-6)).amax(dim=0)
    assert bool(torch.isfinite(got[0]).all())
    assert float(rel.max()) < 1e-2
    for x, y in zip(got[1:], want[1:]):
        assert float(x) == pytest.approx(float(y), rel=1e-3)


def test_differentiable_render_launches_both_kernels(cuda):
    """A CUDA scene under autograd marches on the march kernel and takes
    its gradient on the gradient kernel (its jets instantiation here), no
    CPU path; the same scene on the CPU gives the same gradient."""
    scene = _scene(24, 16, features=Features(jets=True), use_pallas=False,
                   fused=False, shadow_precull=False)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        a = torch.tensor(0.9, device=dev, requires_grad=True)
        sc = dc.replace(scene, bh=dc.replace(scene.bh, spin=a))
        before = (march_u.launches, march_grad_kernel.launches)
        (g,) = torch.autograd.grad(render_radiance(sc, device=dev).mean(), a)
        after = (march_u.launches, march_grad_kernel.launches)
        assert after == ((before[0] + 1, before[1] + 1) if dev.type == "cuda"
                         else before)
        grads.append(float(g))
    assert math.isfinite(grads[0])
    assert grads[0] == pytest.approx(grads[1], rel=5e-3)


def test_kernels_take_eight_crossings(cuda):
    """Each kernel's KMAX = 8 build against its plain version on rays of a
    near-critical pixel (tests/test_torch_ad_crossings.py's) that record up
    to 6 crossings."""
    from blackhole_simulation_tpu_torch.ops.build import kmax_for

    assert (kmax_for(4), kmax_for(5), kmax_for(8), kmax_for(9)) == (4, 8, 8,
                                                                   16)
    cfg = MarchConfig(max_steps=512, step_rate=0.05, max_crossings=8)
    cam = Camera.create(r=30.0, theta=math.pi / 2 - 0.25, fov=0.5, width=64,
                        height=64)
    m, a = torch.tensor(1.0, device=cuda), torch.tensor(0.9, device=cuda)
    crit = 0.490541473031044
    rays = torch.cat([camera_rays_u(cam, m, a, pix_ids=torch.tensor(
        [32 * 64 + 59], device=cuda), jitter=(crit + d, 0.0))
        for d in (-1e-4, -1e-6, -1e-8, 0.0, 3e-14, 1e-8, 1e-6, 1e-4)], 1)
    yt0, thr, m, a, r_h, r_ph = _march_inputs(rays, m, a, cfg, None)
    k_out = march_u(yt0, thr, m, a, r_h, r_ph, cfg)
    p_out = march_u_plain(yt0, thr, m, a, r_h, r_ph, cfg)
    for i in (1, 2, 6):
        assert torch.equal(k_out[i], p_out[i])
    for i in (0, 3, 4, 5, 7):
        assert float((k_out[i] - p_out[i]).abs().max()) < 1e-4
    assert int(k_out[6].max()) > 4
    n = yt0.shape[1]
    g = torch.Generator(device="cpu").manual_seed(3)
    f = lambda *s: torch.rand(*s, generator=g).to(cuda)
    args = (yt0, thr, m, a, r_h, r_ph, cfg, f(8, n), f(8, n), f(8, n),
            f(8, n), f(n), k_out[7])
    gk, gp = march_grad_kernel(*args), march_grad(*args)
    assert bool(torch.isfinite(gk[0]).all())
    for x, y in zip(gk[1:], gp[1:]):
        assert float(x) == pytest.approx(float(y), rel=1e-3)
    scene = Scene.create(mass=1.0, spin=0.9, camera=cam, march_cfg=dc.replace(
        cfg, use_pallas=True, fused=True))
    row, st = kernel_inputs(scene, np.asarray((crit, 0.0), np.float32), cuda)
    d = (render_planes_kernel(row, st) - render_planes(row, st)).abs()
    assert float(torch.quantile(d.flatten().double(), 0.99)) < 1e-4
    assert float(d.mean()) < 1e-5


# ---------------------------------------------------------------------------
# The float64 render (chip_smoke.py phase 23)
# ---------------------------------------------------------------------------

F64 = torch.float64
# The float64 AB3 march's resident warps per SM: 6 blocks of 128 threads at
# ptxas's own 80 registers (H100, PERF.md).
F64_AB3_WARPS = 24


@pytest.mark.parametrize("variant", ["midpoint", "ab3", "jets", "k8"])
def test_float64_march_kernel_matches_plain_version(cuda, variant):
    """Each float64 instantiation of the march kernel against its plain
    version on the card, exact route: the integers equal, the floats
    within 1e-12 (bit-equal on the card but for an ulp of CUDA's exp and
    pow in the jets' radiance); the AB3 march, which has no exp or pow,
    bit-equal."""
    cfg = MarchConfig(max_steps=96, step_rate=0.2, far_step_cap_rate=0.4,
                      far_boost_radius=20.0, midpoint_iters=1,
                      multistep=variant == "ab3",
                      max_crossings=8 if variant == "k8" else 4)
    jets = JetParams() if variant == "jets" else None
    m, a = (torch.tensor(1.0, dtype=F64, device=cuda),
            torch.tensor(0.999, dtype=F64, device=cuda))
    cam = Camera.create(r=30.0, theta=math.pi / 2 - 0.25, fov=0.5,
                        width=250, height=141)
    args = _march_inputs(camera_rays_u(cam, m, a, dtype=F64), m, a, cfg,
                         None)
    before = march_u.launches
    k = march_u(*args, cfg, jets)
    assert march_u.launches == before + 1
    p = march_u_plain(*args, cfg, jets)
    assert k[0].dtype == F64 and k[1].dtype == torch.int32
    for i in (1, 2, 6):
        assert torch.equal(k[i], p[i])
    for i in (0, 3, 4, 5, 7, 8):
        assert float((k[i] - p[i]).abs().max()) <= 1e-12
    if variant == "ab3":
        for x, y in zip(k, p):
            assert torch.equal(_bits64(x), _bits64(y))


def _bits64(x):
    return x.view(torch.int64) if x.dtype == F64 else x


def test_float64_ab3_march_kernel_shape(cuda):
    """The float64 AB3 march reaches its design's resident warps per SM
    with its history's ring in shared memory: 3 slots x 6 rows x threads
    doubles per block. The other float64 variants take no shared
    memory."""
    cfg = MarchConfig(multistep=True)
    s = march_kernel_shape(cfg, None, F64)
    assert s["warps_per_sm"] >= F64_AB3_WARPS, s
    assert s["smem_bytes"] == 3 * 6 * s["threads"] * 8, s
    for c, jets in ((MarchConfig(), None), (MarchConfig(), JetParams())):
        assert march_kernel_shape(c, jets, F64)["smem_bytes"] == 0


@pytest.mark.parametrize("n", POOL_RAYS)
def test_float64_ab3_march_pool_edges(cuda, n):
    """One ray, fewer than a warp, fewer than the resident lanes and a
    ragged count of float64 AB3 rays: bit-equal to the plain version, every
    output written by one launch (two launches into buffers filled with
    different sentinels agree bit for bit), the ray pool back at zero."""
    cfg = dc.replace(CFG, fused=False, shadow_precull=False, multistep=True,
                     approx_recip=False)
    m, a = (torch.tensor(1.0, dtype=F64, device=cuda),
            torch.tensor(0.9, dtype=F64, device=cuda))
    cam = Camera.create(r=30.0, theta=math.pi / 2 - 0.25, fov=0.5,
                        width=250, height=141)
    with torch.no_grad():
        rays = _march_inputs(camera_rays_u(cam, m, a, dtype=F64), m, a, cfg,
                             None)
        args = (rays[0][:, :n].contiguous(), rays[1][:n].contiguous(),
                *rays[2:6], cfg, None)
        k = march_u(*args)
        p = march_u_plain(*args)
        for x, y in zip(k, p):
            assert torch.equal(_bits64(x), _bits64(y))
        outs = []
        for fill, ifill in ((math.nan, -1), (7.0, 12345)):
            out = tuple(torch.full_like(x, ifill if x.dtype == torch.int32
                                        else fill) for x in k)
            march_u(*args, out=out)
            outs.append(out)
            torch.cuda.synchronize()
            assert not bool(ray_pool(cuda).any())
    for x, y, z in zip(*outs, k):
        assert torch.equal(_bits64(x), _bits64(y))
        assert torch.equal(_bits64(x), _bits64(z))


@pytest.mark.parametrize("jets", [False, True])
def test_float64_gradient_kernel_matches_plain_version(cuda, jets):
    """The gradient kernel's float64 instantiations (without and with the
    jets) against march_grad in float64, seeded positive cotangents:
    every ray's worst row within rel 1e-9 and the summed partials within
    1e-10 (float32's bars: 1e-2 and 1e-3)."""
    cfg = MarchConfig(max_steps=64)
    jp = JetParams() if jets else None
    m, a = (torch.tensor(1.0, dtype=F64, device=cuda),
            torch.tensor(0.9, dtype=F64, device=cuda))
    yt0, thr, m, a, r_h, r_ph = _march_inputs(
        camera_rays_u(JET_CAM, m, a, dtype=F64), m, a, cfg, None)
    outs = march_u(yt0, thr, m, a, r_h, r_ph, cfg, jp)
    n, k = yt0.shape[1], cfg.max_crossings
    g = torch.Generator(device="cpu").manual_seed(4)
    f = lambda *s: (0.5 + torch.rand(*s, generator=g, dtype=F64)).to(cuda)
    ct_fin = f(8, n)
    ct_fin[4] = 0.0
    args = (yt0, thr, m, a, r_h, r_ph, cfg, ct_fin, f(k, n), f(k, n),
            f(k, n), f(n), outs[7], f(3, n) if jets else None, jp)
    before = march_grad_kernel.launches
    got = march_grad_kernel(*args)
    assert march_grad_kernel.launches == before + 1
    want = march_grad(*args)
    assert got[0].dtype == F64
    rows = [0, 1, 2, 3, 5, 6, 7]
    rel = ((got[0][rows] - want[0][rows]).abs()
           / (want[0][rows].abs() + 1e-12)).amax(dim=0)
    assert float(rel.max()) < 1e-9
    for x, y in zip(got[1:], want[1:]):
        assert float(x) == pytest.approx(float(y), rel=1e-10)


def test_float64_render_runs_on_the_float64_kernels(cuda):
    """render_radiance(dtype=float64) under autograd on the card: a float64
    image, one march and one gradient launch, the gradient the CPU's; a
    float64 approx_recip march refused."""
    scene = _scene(24, 16, use_pallas=False, fused=False)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        a = torch.tensor(0.9, dtype=F64, device=dev, requires_grad=True)
        sc = dc.replace(scene, bh=dc.replace(scene.bh, spin=a))
        before = (march_u.launches, march_grad_kernel.launches)
        img = render_radiance(sc, device=dev, dtype=F64)
        (g,) = torch.autograd.grad(img.mean(), a)
        after = (march_u.launches, march_grad_kernel.launches)
        assert img.dtype == F64
        assert after == ((before[0] + 1, before[1] + 1) if dev.type == "cuda"
                         else before)
        grads.append(float(g))
    assert grads[0] == pytest.approx(grads[1], rel=1e-6)
    m = torch.tensor(1.0, dtype=F64, device=cuda)
    args = _march_inputs(camera_rays_u(JET_CAM, m, m * 0.9, dtype=F64), m,
                         m * 0.9, CFG, None)
    with pytest.raises(ValueError):
        march_u(*args, dc.replace(CFG, approx_recip=True))


# ---------------------------------------------------------------------------
# The float64 gradient kernel's redesign: the replay kernel, the reverse
# kernel's tape, persistent warps and lane refill
# ---------------------------------------------------------------------------


def _f64_grad_args(cuda, jets=False, max_steps=96, seed=4):
    """Float64 gradient-kernel arguments on the flagship physics at a =
    0.999 (250x141 rays), seeded cotangents of both signs."""
    from blackhole_simulation_tpu_torch.render.shading import JetParams

    cfg = MarchConfig(max_steps=max_steps, step_rate=0.2,
                      far_step_cap_rate=0.4, far_boost_radius=20.0,
                      midpoint_iters=1)
    jp = JetParams() if jets else None
    m = torch.tensor(1.0, dtype=F64, device=cuda)
    a = torch.tensor(0.999, dtype=F64, device=cuda)
    cam = Camera.create(r=30.0, theta=math.pi / 2 - 0.25, fov=0.5,
                        width=250, height=141)
    yt0, thr, m, a, r_h, r_ph = _march_inputs(
        camera_rays_u(cam, m, a, dtype=F64), m, a, cfg, None)
    outs = march_u(yt0, thr, m, a, r_h, r_ph, cfg, jp)
    n, k = yt0.shape[1], cfg.max_crossings
    g = torch.Generator(device="cpu").manual_seed(seed)
    f = lambda *s: (torch.rand(*s, generator=g, dtype=F64) - 0.4).to(cuda)
    ct_fin = f(8, n)
    ct_fin[4] = 0.0
    return (yt0, thr, m, a, r_h, r_ph, cfg, ct_fin, f(k, n), f(k, n),
            f(k, n), f(n), outs[7], f(3, n) if jets else None, jp), outs


def test_float64_grad_kernel_shape(cuda):
    """The float64 reverse kernel reaches its design's resident warps per
    SM (16 at 128 registers; the jets instantiation 12 at 168) with its
    tape in shared memory: per thread the block's CKPT + 1 states (6
    words), each step's dlam and midpoint input (5 words) and one int of
    the step's crossing count and decisions; the replay kernel at least
    16 warps."""
    from blackhole_simulation_tpu_torch.ops.march_grad import CKPT_F64

    for jets, warps in ((False, 16), (True, 12)):
        s = grad_kernel_shape(False, jets, F64)
        assert s["ckpt"] == CKPT_F64
        assert s["warps_per_sm"] >= warps, s
        words = 6 * (s["ckpt"] + 1) + 5 * s["ckpt"]
        assert s["smem_bytes"] == (words * s["threads"] * 8
                                   + s["ckpt"] * s["threads"] * 4), s
        assert s["replay"]["warps_per_sm"] >= 16, s


@pytest.mark.parametrize("jets", [False, True])
def test_float64_replay_counts_equal_the_march(cuda, jets):
    """The float64 replay kernel's hit, live steps and crossing counts are
    the float64 march kernel's, ray for ray."""
    args, outs = _f64_grad_args(cuda, jets=jets, max_steps=256)
    n = args[0].shape[1]
    replay = torch.full((3, n), -1, dtype=torch.int32, device=cuda)
    march_grad_kernel(*args, replay=replay)
    torch.cuda.synchronize()
    for row, i in ((0, 1), (1, 2), (2, 6)):
        assert torch.equal(replay[row], outs[i]), row
    assert int(outs[6].sum()) > 0 and int(outs[2].max()) > 16


@pytest.mark.parametrize("jets", [False, True])
def test_float64_gradient_launches_are_bit_identical(cuda, jets):
    """Two launches give the same bits, whichever lane ran which ray."""
    from blackhole_simulation_tpu_torch.ops.march_grad import march_grad_rows

    args, _ = _f64_grad_args(cuda, jets=jets)
    a = march_grad_rows(*args)
    b = march_grad_rows(*args)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.int64), y.view(torch.int64))


@pytest.mark.parametrize("n", [1, 17, 32, 1000, 35250 - 7])
def test_float64_gradient_lane_refill_edges(cuda, n):
    """One ray, fewer than a warp, one warp, a ragged count and more rays
    than the resident lanes take: every ray's outputs written and within
    rel 1e-9 of march_grad in float64, the same bits as the same rays in
    a launch of all 35,250, and the ray pool back at zero."""
    from blackhole_simulation_tpu_torch.ops.march_grad import march_grad_rows

    full_args, _ = _f64_grad_args(cuda)
    cut = lambda x: None if x is None else x[..., :n].contiguous()
    args = (*map(cut, full_args[:2]), *full_args[2:7],
            *map(cut, full_args[7:14]), full_args[14])
    before = march_grad_kernel.launches
    got = march_grad_kernel(*args)
    torch.cuda.synchronize()
    assert march_grad_kernel.launches == before + 1
    assert not bool(ray_pool(cuda).any())
    cty0, ctp = march_grad_rows(*args)
    f_cty0, f_ctp = march_grad_rows(*full_args)
    torch.cuda.synchronize()
    assert torch.equal(cty0.view(torch.int64),
                       f_cty0[:, :n].view(torch.int64))
    assert torch.equal(ctp.view(torch.int64), f_ctp[:, :n].view(torch.int64))
    if n <= 1000:
        want = march_grad(*args)
        rows = [0, 1, 2, 3, 5, 6, 7]
        rel = ((got[0][rows] - want[0][rows]).abs()
               / (want[0][rows].abs() + 1e-12)).amax(dim=0)
        assert bool(torch.isfinite(got[0]).all())
        assert float(rel.max()) < 1e-9
        for x, y in zip(got[1:], want[1:]):
            assert float(x) == pytest.approx(float(y), rel=1e-9, abs=1e-12)
