"""The port's inverse-rendering steps against the JAX package's, on the CPU.

One ``make_inverse_step`` (``use_pallas=False``, 32x16, 48 steps, zero
target) and one ``make_ad_inverse_step`` (32x32, pool 4, 48 steps) from the
same parameters on both sides, to tests/test_parallel.py:132-143's bars:
the loss to rtol 1e-4 and the parameters after the step to atol 5e-5. The
step's parameters are held against the JAX step jitted; its loss, a forward
value, against the JAX loss run op by op (``jax.disable_jit``), since XLA's
whole-program rounding alone moves the jitted loss by ~2.5e-4 on these
scenes. Also: the port's version of test_parallel.py's
``test_ad_step_gradient_points_into_basin``, the block-ordered loss of the
kernel path (``use_pallas``), and what the port refuses.
"""

import dataclasses as dc
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackhole_simulation_tpu.parallel import InverseParams as JInverseParams
from blackhole_simulation_tpu.parallel.train import _forward as j_forward
from blackhole_simulation_tpu.parallel.train import (
    make_ad_inverse_step as j_make_ad_inverse_step,
)
from blackhole_simulation_tpu.parallel.train import (
    make_inverse_step as j_make_inverse_step,
)
from blackhole_simulation_tpu.render import Camera as JCamera
from blackhole_simulation_tpu.render import MarchConfig as JMarchConfig
from blackhole_simulation_tpu.render import Scene as JScene
from blackhole_simulation_tpu_torch.ops.pallas_march import to_block_order
from blackhole_simulation_tpu_torch.parallel import (
    InverseParams,
    inverse_params_from_numpy,
    inverse_render,
    make_ad_inverse_step,
    make_inverse_step,
)
from blackhole_simulation_tpu_torch.parallel.train import _forward
from blackhole_simulation_tpu_torch.render.pipeline import (
    render_radiance,
    scene_from_numpy,
)

torch.set_num_threads(1)

THETA = float(jnp.pi / 2 - 0.25)
FIELDS = ("spin", "theta_cam", "log_density", "log_t_peak")


def _scenes(width, height, spin, cfg):
    """The same scene for both packages; ``cfg`` a JAX MarchConfig."""
    jcam = JCamera.create(r=30.0, theta=jnp.pi / 2 - 0.25, fov=0.5,
                          width=width, height=height)
    js = JScene.create(mass=1.0, spin=spin, camera=jcam, march_cfg=cfg)
    ts = scene_from_numpy(
        mass=1.0, spin=spin,
        camera=dict(r=30.0, theta=THETA, phi=0.0, fov=0.5, roll=0.0,
                    width=width, height=height),
        march_cfg=dc.asdict(cfg), features=dc.asdict(js.features),
        disk=dc.asdict(js.disk), stars=dc.asdict(js.stars),
        post=dc.asdict(js.post),
    )
    return js, ts


def _params():
    j = JInverseParams.init(spin=0.5, dtype=jnp.float32)
    t = inverse_params_from_numpy(*[float(getattr(j, k)) for k in FIELDS])
    return j, t


def _j_step_ref(js, j_step, loss_of_rgb):
    """(params after the jitted JAX step, JAX loss run op by op)."""
    jp, _ = _params()
    h, w = js.camera.height, js.camera.width
    (p1, _), _ = jax.jit(j_step)(jp, jnp.zeros((h, w, 3), jnp.float32))
    with jax.disable_jit():
        rgb = j_forward(jp, js, jnp.arange(h * w), jnp.float32)
        loss = float(loss_of_rgb(np.asarray(rgb)))
    return {k: float(getattr(p1, k)) for k in FIELDS}, loss


@pytest.fixture(scope="module")
def inverse_case():
    js, ts = _scenes(32, 16, 0.8, JMarchConfig(max_steps=48))
    ref = _j_step_ref(js, j_make_inverse_step(js, None),
                      lambda rgb: np.sum(rgb.astype(np.float64) ** 2) / 512)
    return ts, ref


def _pool4(rgb):
    return rgb.reshape(8, 4, 8, 4, 3).mean(axis=(1, 3))


@pytest.fixture(scope="module")
def ad_case():
    js, ts = _scenes(32, 32, 0.8, JMarchConfig(max_steps=48, midpoint_iters=1))
    ref = _j_step_ref(
        js, j_make_ad_inverse_step(js, None, pool=4, march_steps=48),
        lambda rgb: np.sum(_pool4(rgb.reshape(32, 32, 3)) ** 2) / 64)
    return ts, ref


def _check_step(state, loss, ref):
    params_ref, loss_ref = ref
    (p1, (m, v, t)), loss = state, float(loss)
    assert loss == pytest.approx(loss_ref, rel=1e-4)
    for k in FIELDS:
        assert float(getattr(p1, k)) == pytest.approx(params_ref[k], abs=5e-5), k
    assert int(t) == 1
    assert all(math.isfinite(float(x)) for x in m.leaves() + v.leaves())


def test_inverse_step_matches_jax(inverse_case):
    ts, ref = inverse_case
    _, tp = _params()
    state, loss = make_inverse_step(ts, device="cpu")(
        tp, torch.zeros(16, 32, 3))
    _check_step(state, loss, ref)


def test_ad_inverse_step_matches_jax(ad_case):
    ts, ref = ad_case
    _, tp = _params()
    state, loss = make_ad_inverse_step(ts, pool=4, march_steps=48,
                                       device="cpu")(tp, torch.zeros(32, 32, 3))
    _check_step(state, loss, ref)


def test_ad_step_gradient_points_into_basin():
    """One curriculum-stage step moves spin toward the target's from both
    sides (tests/test_parallel.py:243-267, on the port's plain path)."""
    _, scene = _scenes(48, 48, 0.85, JMarchConfig(
        max_steps=96, step_rate=0.12, midpoint_iters=1, remat_every=32))
    target = render_radiance(scene, device="cpu")
    step = make_ad_inverse_step(scene, pool=8, march_steps=48, lr=2e-2,
                                device="cpu")
    for a0 in (0.7, 0.95):
        p0 = InverseParams.init(spin=a0, theta_cam=THETA)
        (p1, _), _ = step(p0, target)
        moved = float(p1.spin) - a0
        assert np.sign(moved) == np.sign(0.85 - a0), (a0, float(p1.spin))


def test_block_ordered_loss_of_the_kernel_path():
    """With use_pallas the step's pixels are the block-ordered, edge-padded
    ids, and the loss divides by their count (the JAX twin's n_eff)."""
    _, ts = _scenes(50, 21, 0.8, JMarchConfig(max_steps=24, use_pallas=True))
    _, tp = _params()
    target = torch.from_numpy(
        np.random.default_rng(0).uniform(size=(21, 50, 3)).astype(np.float32))
    _, loss = make_inverse_step(ts, device="cpu")(tp, target)
    ids = to_block_order(torch.arange(21 * 50), 21, 50)
    assert ids.shape[0] > 21 * 50
    with torch.no_grad():
        rgb = _forward(tp, ts, ids)
    want = torch.sum((rgb - target.reshape(-1, 3)[ids]) ** 2) / ids.shape[0]
    assert float(loss) == pytest.approx(float(want), rel=1e-6)


def test_inverse_render_ad_step_runs():
    _, ts = _scenes(16, 8, 0.8, JMarchConfig(max_steps=24))
    params, losses = inverse_render(ts, torch.zeros(8, 16, 3), n_steps=2,
                                    method="ad-step", device="cpu")
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    assert params.spin.device.type == "cpu"


def test_refuses_what_is_not_ported():
    """A mesh that is not the port's Mesh (parallel/mesh.py) is refused;
    without CUDA and without device="cpu" the steps raise."""
    _, ts = _scenes(16, 8, 0.8, JMarchConfig(max_steps=24))
    target = torch.zeros(8, 16, 3)
    with pytest.raises(TypeError, match="Mesh"):
        make_inverse_step(ts, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        make_ad_inverse_step(ts, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        inverse_render(ts, target, n_steps=1, method="fd", mesh=object(),
                       device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_inverse_step(ts)
