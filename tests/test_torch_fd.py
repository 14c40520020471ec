"""The port's central-difference inverse step against the JAX package's.

One ``make_fd_inverse_step`` on tests/test_parallel.py:84-103's scene
(32x16, a = 0.8, the default MarchConfig, zero target), unsharded, from the
same state on both sides: the nine losses (centre, +-h on each parameter)
rel < 1e-4 of JAX's ``_forward`` losses run op by op (``jax.disable_jit``;
XLA's whole-program rounding alone moves a jitted loss by ~2.5e-4 on these
scenes), but for a variant whose float32 photon-sphere radius differs from
JAX's by an ulp (``test_fd_step_matches_jax`` says why), and the state
after the step atol < 5e-4 of the jitted JAX step's (test_parallel.py's
own bar between its two steps). Also: the step is the
central difference and Adam update of those nine losses, ``inverse_render``
takes ``method="fd"``, and the driver's state helpers round-trip.
"""

import dataclasses as dc
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackhole_simulation_tpu.parallel import InverseParams as JInverseParams
from blackhole_simulation_tpu.parallel import make_fd_inverse_step as j_make_fd
from blackhole_simulation_tpu.parallel.train import _forward as j_forward
from blackhole_simulation_tpu.parallel.train import (
    _params_to_vec as j_params_to_vec,
)
from blackhole_simulation_tpu.parallel.train import (
    _vec_to_params as j_vec_to_params,
)
from blackhole_simulation_tpu.geometry.metrics import KS, Kerr as JKerr
from blackhole_simulation_tpu.render import Camera as JCamera
from blackhole_simulation_tpu.render import Scene as JScene
from blackhole_simulation_tpu_torch.geometry.metrics import photon_sphere_t
from blackhole_simulation_tpu_torch.parallel import (
    InverseParams,
    fd_state_init,
    fd_state_params,
    inverse_render,
    make_fd_inverse_step,
)
from blackhole_simulation_tpu_torch.parallel.train import (
    _FD_H,
    _forward,
    _vec_to_params,
)
from blackhole_simulation_tpu_torch.render.pipeline import scene_from_numpy

torch.set_num_threads(1)

THETA = float(jnp.pi / 2 - 0.25)
W, H = 32, 16


def _scenes(width=W, height=H, spin=0.8):
    jcam = JCamera.create(r=30.0, theta=jnp.pi / 2 - 0.25, fov=0.5,
                          width=width, height=height)
    js = JScene.create(mass=1.0, spin=spin, camera=jcam)
    ts = scene_from_numpy(
        mass=1.0, spin=spin,
        camera=dict(r=30.0, theta=THETA, phi=0.0, fov=0.5, roll=0.0,
                    width=width, height=height),
        march_cfg=dc.asdict(js.march_cfg), features=dc.asdict(js.features),
        disk=dc.asdict(js.disk), stars=dc.asdict(js.stars),
        post=dc.asdict(js.post),
    )
    return js, ts


def _offsets():
    h = np.asarray(_FD_H, np.float32)
    return np.concatenate([np.zeros((1, 4), np.float32), np.diag(h),
                           -np.diag(h)])


@pytest.fixture(scope="module")
def fd_case():
    js, ts = _scenes()
    jp = JInverseParams.init(spin=0.5, theta_cam=THETA)
    vec0 = np.array(j_params_to_vec(jp), np.float32)
    state0 = (jnp.asarray(vec0), (jnp.zeros(4, jnp.float32),
                                  jnp.zeros(4, jnp.float32),
                                  jnp.zeros((), jnp.int32)))
    (v1, _), _ = j_make_fd(js, None)(state0, jnp.zeros((H, W, 3),
                                                       jnp.float32))
    with jax.disable_jit():
        losses = []
        for v in vec0[None, :] + _offsets():
            rgb = j_forward(j_vec_to_params(jnp.asarray(v)), js,
                            jnp.arange(W * H), jnp.float32)
            losses.append(float(np.sum(np.asarray(rgb, np.float64) ** 2))
                          / (W * H))
    return ts, vec0, np.asarray(v1, np.float64), np.asarray(losses)


def _port_losses(ts, vec0):
    with torch.no_grad():
        return np.asarray([
            float(torch.sum(_forward(_vec_to_params(torch.from_numpy(v)), ts,
                                     torch.arange(W * H)) ** 2)) / (W * H)
            for v in vec0[None, :] + _offsets()])


def _same_photon_sphere(spin):
    """Whether the port's float32 photon-sphere radius at ``spin`` is the
    JAX package's (XLA's float32 arccos and cos are not correctly rounded;
    the port's are, and the radius sets every step size near it)."""
    bh = JKerr(mass=jnp.float32(1.0), spin=jnp.float32(spin), chart=KS)
    with jax.disable_jit():
        want = np.float32(bh.photon_sphere())
    got = photon_sphere_t(torch.tensor(1.0), torch.tensor(np.float32(spin)))
    return float(got) == float(want)


def test_fd_step_matches_jax(fd_case):
    """The nine losses rel < 1e-4 where the variant's float32 photon-sphere
    radius is JAX's; where it is one ulp off (XLA's float32 arccos / cos),
    the 256-step march's photon-ring pixels follow other step sizes, and
    that loss is held at rel < 1e-3 (one variant of nine here)."""
    ts, vec0, v1_ref, losses_ref = fd_case
    losses = _port_losses(ts, vec0)
    same = np.array([_same_photon_sphere(v[0])
                     for v in vec0[None, :] + _offsets()])
    assert same.sum() >= 7, same
    np.testing.assert_allclose(losses[same], losses_ref[same], rtol=1e-4)
    np.testing.assert_allclose(losses, losses_ref, rtol=1e-3)
    state = fd_state_init(_vec_to_params(torch.from_numpy(vec0)))
    (v1, (m, v, t)), loss = make_fd_inverse_step(ts, device="cpu")(
        state, torch.zeros(H, W, 3))
    assert v1.dtype == torch.float32 and m.dtype == torch.float32
    assert int(t) == 1
    assert float(loss) == pytest.approx(losses_ref[0], rel=1e-4)
    np.testing.assert_allclose(v1.numpy(), v1_ref, atol=5e-4)


def test_fd_step_is_adam_on_the_central_difference(fd_case):
    """The step's update from its own nine losses, recomputed in float64:
    Adam's first step moves each parameter by lr times the sign of its
    central difference (the cosine schedule's lr at step 1 of 10)."""
    ts, vec0, _, _ = fd_case
    losses = _port_losses(ts, vec0)
    g = (losses[1:5] - losses[5:9]) / (2.0 * np.asarray(_FD_H))
    step = make_fd_inverse_step(ts, lr=3e-2, total_steps=10, device="cpu")
    (v1, _), _ = step(fd_state_init(_vec_to_params(torch.from_numpy(vec0))),
                      torch.zeros(H, W, 3))
    lr_1 = 3e-2 * (0.1 + 0.45 * (1.0 + math.cos(math.pi * 0.1)))
    want = vec0 - lr_1 * np.sign(g)
    want[0] = np.clip(want[0], -0.998, 0.998)
    np.testing.assert_allclose(v1.numpy(), want, atol=1e-6)


def test_fd_state_round_trip():
    p = InverseParams.init(spin=0.3, theta_cam=1.1, density=0.5, t_peak=8e3)
    vec, (m, v, t) = fd_state_init(p)
    assert vec.dtype == torch.float32 and int(t) == 0
    back = fd_state_params((vec, (m, v, t)))
    for k in ("spin", "theta_cam", "log_density", "log_t_peak"):
        assert float(getattr(back, k)) == float(getattr(p, k))


def test_inverse_render_fd_runs():
    _, ts = _scenes(16, 8, 0.8)
    ts = dc.replace(ts, march_cfg=dc.replace(ts.march_cfg, max_steps=24))
    params, losses = inverse_render(
        ts, torch.zeros(8, 16, 3), n_steps=2, method="fd", device="cpu",
        init=InverseParams.init(spin=0.5, theta_cam=THETA))
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    assert params.spin.dtype == torch.float32
