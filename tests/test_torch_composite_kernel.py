"""The composite kernel and its VJP kernel (``csrc/composite.cu``,
``ops/composite.py``) on the card, against the plain composite run there.

The forward bit for bit against ``render/pipeline.py::_composite`` per
ray, in float32 and float64, on rows the march kernel makes: the inverse
cell's scene (``benchmark/configs/inverse_1080p.json``: analytic disk,
starfield, glow, K = 4) at 1920x1080 and smaller, and a full-featured
staged scene (the Chebyshev spectral disk, jets, K = 8). The VJP against
``composite_vjp_plain`` and against autograd of the plain composite, both
on the card: per-ray cotangents within 1e-5 of each row's largest value,
the 0-d cotangents (sums over the rays in another order) within 1e-5.
Two backward calls give the same bits; one recorded inverse step counts
one launch of each kernel; what the kernels do not take raises on the
card, with no plain fallback. The CPU's side (the derivative chain against
autograd and JAX, the dispatch) is tests/test_torch_composite_vjp.py.

This file imports neither JAX nor the JAX package; its tests (marked
``gpu``) run on a machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_composite_kernel.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from blackhole_simulation_tpu_torch.configs.simulation import (
    SimulationParams,
    scene_from_params,
)
from blackhole_simulation_tpu_torch.geometry import metrics
from blackhole_simulation_tpu_torch.ops import composite as C
from blackhole_simulation_tpu_torch.parallel import train
from blackhole_simulation_tpu_torch.perf import spans
from blackhole_simulation_tpu_torch.render import render_radiance
from blackhole_simulation_tpu_torch.render.camera import camera_rays_u
from blackhole_simulation_tpu_torch.render.march import march_rows
from blackhole_simulation_tpu_torch.render.pipeline import (
    Features,
    _composite,
    _DUMMY_U,
    _mass_spin,
    conserved_lam,
    shade_march_rows,
)
from blackhole_simulation_tpu_torch.render.shading import (
    escape_direction_u_rows,
    spectral_kernel_tables,
)

DTYPES = [torch.float32, torch.float64]
ROWS = ("cross_r", "cross_phi", "cross_t", "state_u", "r_min_ph", "lam",
        "jet_rows")


@pytest.fixture(autouse=True)
def fresh():
    spans.reset()
    yield
    spans.reset()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def scene_of(name, width, height, device):
    """The inverse cell's scene, or the full-featured staged one."""
    scene = scene_from_params(SimulationParams(), width=width, height=height,
                              device=device)
    cfg = dataclasses.replace(scene.march_cfg, use_pallas=False)
    if name == "full":
        cfg = dataclasses.replace(cfg, max_crossings=8)
        scene = dataclasses.replace(
            scene, features=Features(jets=True, spectral_lut=True),
            spectral_coeffs=spectral_kernel_tables(
                float(scene.bh.mass), float(scene.bh.spin), scene.disk))
    return dataclasses.replace(scene, march_cfg=cfg)


def inputs(name, width, height, dtype, device):
    """The composite's inputs of the scene's rays, as the march kernel
    leaves them; the scales as a step passes them (0-d tensors)."""
    scene = scene_of(name, width, height, device)
    m, a = _mass_spin(scene, device, dtype)
    with torch.no_grad():
        rays = camera_rays_u(scene.camera, m, a, dtype=dtype)
        jets = scene.jet_params if scene.features.jets else None
        rows = march_rows(rays, m, a, scene.march_cfg, jets=jets)
    x = dict(m=m, a=a, r_in=metrics.isco_t(m, a),
             r_ph=metrics.photon_sphere_t(m, a), hit=rows.hit,
             cross_r=rows.cross_r, cross_phi=rows.cross_phi,
             cross_t=rows.cross_t, n_crossings=rows.n_crossings,
             r_min_ph=rows.r_min_ph, lam=conserved_lam(rays),
             state_u=rows.state_u, jet_rows=rows.jet_radiance,
             ds=torch.tensor(1.1, dtype=dtype, device=device),
             **{"is": torch.tensor(0.9, dtype=dtype, device=device)})
    return scene, rows, x


def plain(scene, x):
    """The plain composite of the inputs; the ISCO and photon sphere as
    inputs of their own."""
    saved = metrics.isco_t, metrics.photon_sphere_t
    metrics.isco_t = lambda m_, a_: x["r_in"]
    metrics.photon_sphere_t = lambda m_, a_: x["r_ph"]
    try:
        return _composite(
            scene, x["m"], x["a"], x["hit"],
            (x["cross_r"], x["cross_phi"], x["cross_t"]), x["n_crossings"],
            x["r_min_ph"], x["lam"], x["state_u"], escape_direction_u_rows,
            _DUMMY_U, x["jet_rows"], x["ds"], x["is"],
            scene.spectral_coeffs, None)
    finally:
        metrics.isco_t, metrics.photon_sphere_t = saved


def kernel_vjp(scene, x, g, wanted=None):
    return C.composite_vjp_kernel(
        C.CompositeStatic.of(scene), x["m"], x["a"], x["r_in"], x["r_ph"],
        x["hit"], x["cross_r"], x["cross_phi"], x["cross_t"],
        x["n_crossings"], x["r_min_ph"], x["lam"], x["state_u"],
        x["jet_rows"], g, x["ds"], x["is"], wanted=wanted)


def rel(got, want):
    d = (got - want).abs()
    if want.dim() < 2:
        return float(d.max() / want.abs().max().clamp(min=1e-30))
    return float((d.amax(-1) / want.abs().amax(-1).clamp(min=1e-30)).max())


SIZES = {"cell_1080p": ("cell", 1920, 1080), "cell": ("cell", 320, 180),
         "full": ("full", 320, 180)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("case", list(SIZES))
def test_forward_is_the_plain_composite(cuda, case, dtype):
    name, w, h = SIZES[case]
    scene, rows, x = inputs(name, w, h, dtype, cuda)
    got = shade_march_rows(rows, x["m"], x["a"], scene, x["lam"],
                           density_scale=x["ds"], intensity_scale=x["is"])
    with torch.no_grad():
        want = plain(scene, x)
    torch.cuda.synchronize()
    differ = sum(int((~((g == p) | (g.isnan() & p.isnan()))).sum())
                 for g, p in zip(got, want))
    assert differ == 0, f"{differ} values differ"
    assert rows.n_crossings.max() > 1 and (rows.hit == 2).any()


# float64 at 1080p left out: the float32 case and the smaller float64 ones
# cover it
VJP_CASES = [("cell_1080p", torch.float32), ("cell", torch.float32),
             ("cell", torch.float64), ("full", torch.float32),
             ("full", torch.float64)]


@pytest.mark.gpu
@pytest.mark.parametrize("case,dtype", VJP_CASES,
                         ids=[f"{c}-{str(d)[-7:]}" for c, d in VJP_CASES])
def test_vjp_agrees(cuda, case, dtype):
    name, w, h = SIZES[case]
    scene, rows, x = inputs(name, w, h, dtype, cuda)
    gen = np.random.default_rng(7)
    g = torch.tensor(gen.uniform(-1, 1, (3, x["lam"].shape[0])),
                     dtype=dtype, device=cuda)
    got = kernel_vjp(scene, x, g)
    twin = C.composite_vjp_plain(
        C.CompositeStatic.of(scene), x["m"], x["a"], x["r_in"], x["r_ph"],
        x["hit"], x["cross_r"], x["cross_phi"], x["cross_t"],
        x["n_crossings"], x["r_min_ph"], x["lam"], x["state_u"],
        x["jet_rows"], g, x["ds"], x["is"])
    names = (*ROWS, "m", "a", "r_in", "r_ph", "ds", "is")
    leaves = {k: x[k].detach().clone().requires_grad_(True) for k in names}
    out = plain(scene, {**x, **leaves})
    grads = torch.autograd.grad(sum((o * gg).sum() for o, gg in zip(out, g)),
                                [leaves[k] for k in names],
                                allow_unused=True)
    auto = {k: torch.zeros_like(x[k]) if v is None else v
            for k, v in zip(names, grads)}
    for key in names:
        assert torch.isfinite(got[key]).all(), key
        for ref, what in ((twin[key], "plain"), (auto[key], "autograd")):
            if float(ref.abs().max()) == 0.0:
                assert float(got[key].abs().max()) == 0.0, (key, what)
                continue
            assert rel(got[key], ref) <= 1e-5, (key, what, rel(got[key], ref))


@pytest.mark.gpu
def test_backward_is_bit_reproducible(cuda):
    scene, _, x = inputs("cell", 640, 360, torch.float32, cuda)
    g = torch.ones((3, x["lam"].shape[0]), device=cuda)
    first = kernel_vjp(scene, x, g)
    second = kernel_vjp(scene, x, g)
    for key, v in first.items():
        assert torch.equal(v, second[key]), key
    # outputs that are not wanted are not written
    part = kernel_vjp(scene, x, g, wanted={"lam", "a"})
    assert set(part) == {"lam", *C.SCALARS}
    assert torch.equal(part["lam"], first["lam"])
    assert torch.equal(part["a"], first["a"])


@pytest.mark.gpu
@pytest.mark.parametrize("make", ["ad", "raw"])
def test_a_step_launches_each_kernel_once(cuda, make):
    """One recorded inverse step of the cell's scene: one forward launch
    (in ``inverse_forward``) and one VJP launch (in ``inverse_backward``)."""
    scene = scene_from_params(SimulationParams(), width=256, height=128,
                              device=cuda)
    target = render_radiance(scene, device=cuda)
    step = (train.make_ad_inverse_step(scene, pool=2, march_steps=64,
                                       total_steps=4, device=cuda)
            if make == "ad" else
            train.make_inverse_step(scene, total_steps=4, device=cuda))
    state = train.InverseParams.init(device=cuda)
    state, _ = step(state, target)
    torch.cuda.synchronize()
    before = (C.composite_kernel.launches, C.composite_vjp_kernel.launches)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        step(state, target)
        torch.cuda.synchronize()
    assert (C.composite_kernel.launches - before[0],
            C.composite_vjp_kernel.launches - before[1]) == (1, 1)


@pytest.mark.gpu
def test_refusals_raise_on_the_card(cuda):
    """What the kernels do not take raises from ``shade_march_rows``; the
    plain composite is not taken in its place."""
    scene, rows, x = inputs("cell", 64, 32, torch.float32, cuda)
    with pytest.raises(ValueError, match="hit"):
        shade_march_rows(dataclasses.replace(rows, hit=rows.hit.long()),
                         x["m"], x["a"], scene, x["lam"])
    with pytest.raises(ValueError, match="density_scale"):
        shade_march_rows(rows, x["m"], x["a"], scene, x["lam"],
                         density_scale=x["ds"].double())
    with pytest.raises(ValueError, match="composite kernel"):
        shade_march_rows(rows, x["m"], x["a"], scene, x["lam"].double())
