"""The birth kernel and its VJP kernels (``csrc/birth.cu``,
``ops/birth.py``) on the card, against the plain chain run there.

The forward bit for bit against ``render/camera.py::camera_rays_u_plain``
(NaN as NaN): on the inverse cell's 1920x1080 frame (``benchmark/configs/
inverse_1080p.json``) at the parameters entering each stage of its fit,
with the step's row-major ids and with the pixel-block order's, and on the
shared grid of cases (tests/birth_cases.py) in float32 and float64. The
VJP against autograd of the plain chain on the card within 1e-5 of each
gradient (sums over the rays in another order and precision), and against
the plain twin (``birth_vjp_plain``), and in the cell for the cotangent
its rays receive (and, for a uniform one, against float64 autograd:
``test_vjp_agrees_in_the_cell`` says why); two backward calls give the same
bits; one step of ``make_ad_inverse_step`` and of ``make_inverse_step``
counts one launch of each, the central-difference step nine forwards; what
the kernels do not take raises on the card, with no plain fallback. The
CPU's side (the derivative chain against autograd and JAX, the dispatch)
is tests/test_torch_birth_vjp.py.

This file imports neither JAX nor the JAX package; its tests (marked
``gpu``) run on a machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_birth_kernel.py
"""

import numpy as np
import pytest
import torch

from birth_cases import CASES, DTYPES, leaves_of, rel, setup, twin_grads
from blackhole_simulation_tpu_torch.configs.simulation import (
    SimulationParams,
    scene_from_params,
)
from blackhole_simulation_tpu_torch.ops import birth as B
from blackhole_simulation_tpu_torch.ops.pallas_march import to_block_order
from blackhole_simulation_tpu_torch.parallel import train
from blackhole_simulation_tpu_torch.render import camera, render_radiance
from blackhole_simulation_tpu_torch.render.camera import (
    camera_rays_u,
    camera_rays_u_plain,
)

LRS = (3e-2, 1.2e-2, 6e-3)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def cuda():
    return _card()


def ray_cotangent(step, state, target):
    """The cotangent of the rays that one call of ``step`` gives its
    birth."""
    got, orig = [], camera.camera_rays_u

    def record(*args, **kw):
        rays = orig(*args, **kw)
        rays.register_hook(got.append)
        return rays

    camera.camera_rays_u = record
    try:
        step(state, target)
    finally:
        camera.camera_rays_u = orig
    return got[0]


@pytest.fixture(scope="module")
def cell():
    """The inverse cell's scene at 1920x1080, the parameters entering each
    of its three stages (the fit's first 40 steps on the card) and the
    cotangent of the rays in its first step."""
    dev = _card()
    scene = scene_from_params(SimulationParams(), width=1920, height=1080,
                              device=dev)
    target = render_radiance(scene, device=dev)
    state, starts, g = train.InverseParams.init(device=dev), [], None
    for (steps, pool), lr in zip(train._AD_STAGES, LRS):
        starts.append(state)
        if len(starts) == len(LRS):
            break
        step = train.make_ad_inverse_step(scene, None, lr, pool=pool,
                                          march_steps=steps, clip=0.03,
                                          total_steps=20, device=dev)
        st = (state, train.init_opt_state(state))
        if g is None:
            g = ray_cotangent(step, st, target)
        for _ in range(20):
            st, _ = step(st, target)
        state = st[0]
    return scene, starts, g


def same_bits(got, want):
    return int((~((got == want) | (got.isnan() & want.isnan()))).sum())


def cell_args(cell, stage, order):
    scene, starts, _ = cell
    dev = starts[stage].spin.device
    h, w = scene.camera.height, scene.camera.width
    ids = torch.arange(h * w, device=dev)
    if order == "block":
        ids = to_block_order(ids, h, w)
    p = starts[stage]
    return (scene.camera, torch.tensor(1.0, device=dev),
            p.spin.clone().requires_grad_(True),
            p.theta_cam.clone().requires_grad_(True), ids)


@pytest.mark.gpu
@pytest.mark.parametrize("order", ["row", "block"])
@pytest.mark.parametrize("stage", [0, 1, 2])
def test_forward_is_the_plain_chain_in_the_cell(cell, stage, order):
    cam, m, a, th, ids = cell_args(cell, stage, order)
    got = camera_rays_u(cam, m, a, pix_ids=ids, theta=th)
    with torch.no_grad():
        want = camera_rays_u_plain(cam, m, a, pix_ids=ids, theta=th)
    assert type(got.grad_fn).__name__ == "BirthFnBackward"
    assert same_bits(got, want) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("name", list(CASES))
def test_forward_is_the_plain_chain_on_the_grid(cuda, name, dtype):
    cam, m, a, th, pix, jitter = setup(name, dtype, cuda)
    before = B.birth_kernel.launches
    got = camera_rays_u(cam, m, a, pix_ids=pix, jitter=jitter, theta=th,
                        dtype=dtype)
    with torch.no_grad():
        want = camera_rays_u_plain(cam, m, a, pix_ids=pix, jitter=jitter,
                                   theta=th, dtype=dtype)
    assert B.birth_kernel.launches == before + 1
    assert same_bits(got, want) == 0


def vjp_against_autograd(cam, m, a, th, pix, jitter, dtype, g):
    """(kernel, autograd of the plain chain, plain twin) gradients of the
    leaves for the cotangent ``g``, all on the card."""
    leaves = leaves_of(cam, m, a, th)
    kw = dict(pix_ids=pix, jitter=jitter, theta=th, dtype=dtype)
    rows = camera_rays_u(cam, m, a, **kw)
    assert type(rows.grad_fn).__name__ == "BirthFnBackward"
    got = torch.autograd.grad((rows * g).sum(), list(leaves.values()))
    auto = torch.autograd.grad((camera_rays_u_plain(cam, m, a, **kw)
                                * g).sum(), list(leaves.values()))
    twin = twin_grads(cam, m, a, th, pix, jitter, dtype, g)
    return dict(zip(leaves, got)), dict(zip(leaves, auto)), twin


def uniform(n, dtype, device):
    return torch.tensor(np.random.default_rng(7).uniform(-1, 1, (8, n)),
                        dtype=dtype, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("name", list(CASES))
def test_vjp_agrees(cuda, name, dtype):
    cam, m, a, th, pix, jitter = setup(name, dtype, cuda)
    n = cam.width * cam.height if pix is None else pix.shape[0]
    got, auto, twin = vjp_against_autograd(cam, m, a, th, pix, jitter, dtype,
                                           uniform(n, dtype, cuda))
    for key, want in auto.items():
        assert torch.isfinite(got[key]), key
        assert rel(got[key], want) <= 1e-5, (key, float(got[key]),
                                             float(want))
        assert rel(got[key], twin[key]) <= 1e-5, (key, float(got[key]),
                                                  float(twin[key]))


@pytest.mark.gpu
@pytest.mark.parametrize("cotangent", ["step", "uniform"])
def test_vjp_agrees_in_the_cell(cell, cotangent):
    """The cell's first step at 1080p. For the cotangent its rays receive,
    within 1e-5 of autograd. For a uniform one in [-1, 1) the spin's
    gradient sums 2 M terms of either sign to ~1e-3 of their size, where
    float32 autograd's own sums are off by more than 1e-5: the kernel is
    held within 1e-5 of autograd run in float64 on the same inputs, or no
    further from it than float32 autograd is."""
    cam, m, a, th, ids = cell_args(cell, 0, "row")
    g = cell[2] if cotangent == "step" else uniform(ids.shape[0],
                                                    torch.float32, m.device)
    got, auto, twin = vjp_against_autograd(cam, m, a, th, ids, None,
                                           torch.float32, g)
    with torch.no_grad():
        leaves = [x.detach().double().requires_grad_(True) for x in (a, th)]
    with torch.enable_grad():
        rows = camera_rays_u_plain(cam, m.double(), leaves[0], pix_ids=ids,
                                   theta=leaves[1], dtype=torch.float64)
        exact = dict(zip(("a", "theta"), torch.autograd.grad(
            (rows * g.double()).sum(), leaves)))
    for key, want in auto.items():
        assert rel(got[key], twin[key]) <= 1e-6, key
        if cotangent == "step":
            assert rel(got[key], want) <= 1e-5, (key, float(got[key]),
                                                 float(want))
        else:
            bar = max(1e-5, rel(want, exact[key]))
            assert rel(got[key], exact[key]) <= bar, (
                key, float(got[key]), float(want), float(exact[key]))


@pytest.mark.gpu
def test_backward_is_bit_reproducible(cell):
    cam, m, a, th, ids = cell_args(cell, 0, "row")
    plan, inputs = B.plan_of(cam, m, a, ids, None, th)
    g = torch.ones((8, plan.n), device=m.device)
    first = B.birth_vjp_kernel(plan, inputs, g, (True,) * 8)
    second = B.birth_vjp_kernel(plan, inputs, g, (True,) * 8)
    for key, x, y in zip(B.GRADS, first, second):
        assert x is not None and torch.equal(x, y), key
    # what is not wanted is not made
    part = B.birth_vjp_kernel(plan, inputs, g, (False, True) + (False,) * 6)
    assert part[0] is None and torch.equal(part[1], first[1])


@pytest.mark.gpu
@pytest.mark.parametrize("make", ["ad", "raw", "fd"])
def test_a_step_launches_the_kernels(cuda, make):
    """One inverse step of the cell's scene: one forward launch and one
    VJP call (its two launches) an AD step; nine forwards and no VJP a
    central-difference step."""
    scene = scene_from_params(SimulationParams(), width=256, height=128,
                              device=cuda)
    target = render_radiance(scene, device=cuda)
    init = train.InverseParams.init(device=cuda)
    if make == "fd":
        step = train.make_fd_inverse_step(scene, total_steps=4, device=cuda)
        state = train.fd_state_init(init)
    else:
        step = (train.make_ad_inverse_step(scene, pool=2, march_steps=64,
                                           total_steps=4, device=cuda)
                if make == "ad" else
                train.make_inverse_step(scene, total_steps=4, device=cuda))
        state = init
    state, _ = step(state, target)
    torch.cuda.synchronize()
    before = (B.birth_kernel.launches, B.birth_vjp_kernel.launches)
    step(state, target)
    torch.cuda.synchronize()
    want = (9, 0) if make == "fd" else (1, 1)
    assert (B.birth_kernel.launches - before[0],
            B.birth_vjp_kernel.launches - before[1]) == want


@pytest.mark.gpu
def test_refusals_raise_on_the_card(cuda):
    """What the kernels do not take raises from ``camera_rays_u``; the
    plain chain is not taken in its place."""
    cam, m, a, th, pix, _ = setup("ids", torch.float32, cuda)
    cases = [dict(spin=a.detach().cpu()), dict(theta=1.3),
             dict(dtype=torch.float16), dict(pix_ids=pix.double())]
    for over in cases:
        kw = dict(spin=a, pix_ids=pix, theta=th, dtype=torch.float32)
        kw.update(over)
        spin = kw.pop("spin")
        with pytest.raises(ValueError, match="birth kernel"):
            camera_rays_u(cam, m, spin, **kw)
