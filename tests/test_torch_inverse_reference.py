"""The AD inverse step against the benchmark's plain differentiable
reference (``benchmark/reference/inverse.py``), on the CPU at 64x32: the
port's ``make_ad_inverse_step`` in each curriculum stage from the same
state gives the reference's loss, gradient (recovered from the new first
moment, as the cell's check recovers it) and parameters; the reference's
frozen precull is the port's ``capture_mask_u``; the four faults a step
can have fail the cell's check; and the cell's driver loop is
``ad_inverse_render``. On the card (``gpu``): the kernel route against
the reference at 256x128, within the cell's limits.

This file imports neither JAX nor the JAX package; its card test runs on
a machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_inverse_reference.py
"""

import json
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.drivers import fits
from benchmark.reference import inverse
from blackhole_simulation_tpu_torch.parallel import train
from blackhole_simulation_tpu_torch.render.camera import camera_rays_u
from blackhole_simulation_tpu_torch.render.precull import capture_mask_u

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CELL = "inverse_1080p.ad_curriculum"
LIMITS = json.loads((ROOT / "benchmark" / "limits" / f"{CELL}.json")
                    .read_text())
# The port's plain route (the CPU's) divides exactly, as the reference,
# and marches the same steps: what differs is the order in which sums
# round (the reference's blocks of rows, autograd's accumulation of the
# march's partials against the plain VJP's per-step adds, the loss's
# reduction). Measured on this file's states: loss <= 2.6e-7, gradient <=
# 1.1e-6, update <= 6.6e-6; on the checked steps of whole 64x32 fits up to
# 4e-7, 3e-6 and 2e-5 (Adam's update divides by each leaf's own moment, so
# a small leaf's rounding shows most there). Each bar is ten times the
# latter.
TOL = {"loss_rel": 4e-6, "grad_rel": 3e-5, "update_rel": 2e-4}


def _spec(width=64, height=32, device="cpu", seed=5, **traffic):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(c for c in bench["workloads"] if c["name"] == CELL)
    read = lambda *p: json.loads((ROOT / "benchmark").joinpath(*p)
                                 .read_text())
    config = dict(read("configs", f"{cell['config']}.json"), width=width,
                  height=height)
    return types.SimpleNamespace(
        cell=cell, config=config,
        traffic=dict(read("traffic", f"{cell['traffic']}.json"), **traffic),
        limits=LIMITS, seed=seed, seconds=0.0, trace=0, device=device,
        t_start=time.perf_counter())


@pytest.fixture(scope="module")
def small():
    """The cell's driver at 64x32 on the CPU, set up (the true scene, its
    target, the three stages' steps)."""
    run = fits.Fits(_spec())
    run.setup()
    return run


def _state(run, t: int):
    """An entering state: the initial parameters moved off, and after ``t``
    steps moments of plausible size (fresh ones at t = 0)."""
    p = [0.62, 1.31, float(np.log(0.66)), float(np.log(9300.0))]
    if t == 0:
        m = v = [0.0] * 4
    else:
        m = [-0.004, 0.002, 0.001, -0.0005]
        v = [2e-5, 1e-5, 3e-6, 1e-6]
    return p, m, v, t


def _port_step(run, stage: int, state):
    """The port's step of ``stage`` from ``state`` as a kept step."""
    p, m, v, t = state
    s = run.stages[stage]
    step = train.make_ad_inverse_step(
        run.scene, None, s["lr"], pool=s["pool"],
        march_steps=s["march_steps"], clip=s["clip"],
        total_steps=s["total_steps"], device="cpu")
    as_p = lambda xs: train.inverse_params_from_numpy(*xs)
    opt = (as_p(m), as_p(v), torch.tensor(t, dtype=torch.int32))
    (p2, (m2, _, _)), loss = step((as_p(p), opt), run.target)
    return fits.Kept(stage, t, list(p), list(m), list(v), float(loss),
                     fits._values(p2), fits._values(m2))


def _numbers(run, kept):
    return run.numbers([(run.port_result(k),
                         run.ref_result(run.reference(k), k)) for k in kept])


@pytest.mark.parametrize("stage, t", [(0, 0), (1, 7), (2, 13)])
def test_port_step_is_the_reference_step(small, stage, t):
    got = _numbers(small, [_port_step(small, stage, _state(small, t))])
    for key, bar in TOL.items():
        assert got[key] <= bar, (key, got)


@pytest.mark.parametrize("spin, theta", [(0.9, 1.3207963267948966),
                                         (0.5, 1.3), (-0.7, 0.4),
                                         (0.998, 2.6)])
def test_precull_copy_is_capture_mask_u(spin, theta):
    from blackhole_simulation_tpu_torch.render import Camera

    rng = np.random.default_rng(7)
    cam = Camera.create(r=30.0, theta=theta, fov=0.5, width=320,
                        height=180)
    ids = torch.as_tensor(rng.integers(320 * 180, size=4096))
    m, a = torch.tensor(1.0), torch.tensor(spin)
    rows = camera_rays_u(cam, m, a, pix_ids=ids)
    # Momenta moved off the camera's so that the test also reaches rays
    # outward-bound and at other impact parameters.
    rows[5:] = rows[5:] * torch.as_tensor(
        rng.uniform(0.6, 1.4, (3, 4096)), dtype=torch.float32)
    want = capture_mask_u(m, a, rows)
    got = inverse.capture_mask_u(m, a, rows)
    assert 0 < int(want.sum()) < 4096
    assert torch.equal(got, want)


def _sign_flipped_gradient(monkeypatch):
    real = train._grads_of
    monkeypatch.setattr(train, "_grads_of", lambda loss, leaves: tuple(
        -g for g in real(loss, leaves)))


def _theta_gradient_zeroed(monkeypatch):
    real = train._grads_of

    def zeroed(loss, leaves):
        g = list(real(loss, leaves))
        g[1] = torch.zeros_like(g[1])
        return tuple(g)
    monkeypatch.setattr(train, "_grads_of", zeroed)


def _step_built_with(monkeypatch, **over):
    """Every AD step built with ``over`` in place of its arguments (``lr``
    a factor on the one given)."""
    real = train.make_ad_inverse_step

    def built(scene, mesh=None, lr=2e-2, **kw):
        return real(scene, mesh, lr * over.get("lr", 1.0),
                    **dict(kw, **{k: v for k, v in over.items()
                                  if k != "lr"}))
    monkeypatch.setattr(train, "make_ad_inverse_step", built)


# The faults a step of the timed path can have, each planted in the port
# underneath the driver (``benchmark/drivers/fits.py`` builds its steps
# through ``train.make_ad_inverse_step``).
FAULTS = {
    "sign_flipped_gradient": _sign_flipped_gradient,
    "doubled_learning_rate": lambda mp: _step_built_with(mp, lr=2.0),
    "cotangent_clip_dropped": lambda mp: _step_built_with(mp, clip=0.0),
    "theta_gradient_zeroed": _theta_gradient_zeroed,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("stage, t", [(0, 0), (2, 13)])
def test_faults_fail_the_check(small, monkeypatch, fault, stage, t):
    FAULTS[fault](monkeypatch)
    got = _numbers(small, [_port_step(small, stage, _state(small, t))])
    assert any(got[k] > LIMITS[k] for k in got), got


def test_driver_loop_is_ad_inverse_render():
    """Two steps a stage (the cell's 20 cost minutes here): the driver's
    fit and ``ad_inverse_render`` give the same losses and parameters, bit
    for bit."""
    run = fits.Fits(_spec(steps=6))
    run.setup()
    run.kept = []
    losses, params = run.fit(keep=False)
    want_params, want = train.ad_inverse_render(
        run.scene, run.target, n_steps=6,
        init=train.InverseParams.init(**run.config["init"]), device="cpu")
    assert losses == want
    assert fits._values(params) == fits._values(want_params)


# ---- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernel_route_against_the_reference(cuda):
    """The port on the card (the march and gradient kernels, the
    approximate reciprocal) against the reference at 256x128, one step of
    each stage of a first fit, within the cell's limits."""
    spec = _spec(width=256, height=128, device="cuda", seed=11, steps=6)
    run = fits.Fits(spec)
    run.setup()
    run.kept = []
    run.fit(keep=True)
    assert len(run.kept) == 3
    got = run.checks()
    assert all(got[k] <= LIMITS[k] for k in got), got
