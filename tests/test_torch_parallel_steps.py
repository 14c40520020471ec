"""The port's sharded inverse steps on the CPU: one spawned world of 2 ranks
(gloo, file init) runs ``make_inverse_step``, ``make_fd_inverse_step``,
``make_ad_inverse_step`` and ``inverse_render`` on the mesh; the parent
runs them on a one-device mesh and without one.

Scenes and bars are tests/test_parallel.py's (:85-103, :132-143,
:269-288) and tests/test_torch_train.py's: the inverse step at 32x16 and
the AD curriculum step at 32x32 (pool 4), 48 march steps, spin 0.8, a zero
target, from InverseParams.init(spin=0.5). Against the port's
single-device step: the loss rtol 1e-4, every parameter atol 5e-5, the FD
state vector atol 5e-4 (the all-reduce sums in another order). Against
JAX's sharded step on the 8-device mesh (jitted): the parameters atol 5e-5
and the FD vector atol 5e-4; the loss against JAX's forward run op by op
(``jax.disable_jit``), since XLA's whole-program rounding alone moves the
jitted loss by ~2.5e-4 on these scenes. A mesh whose size the pixels (or
the pooled rows) do not divide is refused with the JAX twin's message.
"""

import math
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from blackhole_simulation_tpu_torch.parallel import (
    InverseParams,
    fd_state_init,
    inverse_render,
    make_ad_inverse_step,
    make_fd_inverse_step,
    make_inverse_step,
    make_mesh,
)
from blackhole_simulation_tpu_torch.parallel.mesh import Mesh
from blackhole_simulation_tpu_torch.render import Camera, MarchConfig
from blackhole_simulation_tpu_torch.render.pipeline import Scene
from test_torch_parallel import spawn_worlds

torch.set_num_threads(1)

THETA = math.pi / 2 - 0.25
FIELDS = ("spin", "theta_cam", "log_density", "log_t_peak")


def _scene(width, height, **cfg):
    cam = Camera.create(r=30.0, theta=THETA, fov=0.5, width=width,
                        height=height)
    return Scene.create(mass=1.0, spin=0.8, camera=cam,
                        march_cfg=MarchConfig(max_steps=48, **cfg))


INVERSE = _scene(32, 16)
AD = _scene(32, 32, midpoint_iters=1)
AD_STAGES = ((48, 4),)


def _params():
    return InverseParams.init(spin=0.5)


def _flat(params):
    return np.asarray([float(x) for x in params.leaves()])


def _steps(mesh, renders=True):
    """{name: value} of each step on ``mesh`` (None: one device), and of
    two-step ``inverse_render`` runs with ``renders``."""
    kw = dict(mesh=mesh, device="cpu")
    z16, z32 = torch.zeros(16, 32, 3), torch.zeros(32, 32, 3)
    (p, (m, v, t)), loss = make_inverse_step(INVERSE, **kw)(_params(), z16)
    out = {"inverse_loss": float(loss), "inverse_params": _flat(p),
           "inverse_m": _flat(m), "inverse_t": int(t)}
    (vec, _), loss = make_fd_inverse_step(INVERSE, **kw)(
        fd_state_init(_params()), z16)
    out.update(fd_loss=float(loss), fd_vec=vec.numpy())
    (p, _), loss = make_ad_inverse_step(AD, pool=4, march_steps=48, **kw)(
        _params(), z32)
    out.update(ad_loss=float(loss), ad_params=_flat(p))
    for method, scene, target, extra in () if not renders else (
            ("fd", INVERSE, z16, {}), ("ad-step", INVERSE, z16, {}),
            ("ad", AD, z32, {"ad_stages": AD_STAGES})):
        p, losses = inverse_render(scene, target, n_steps=2, method=method,
                                   **kw, **extra)
        out[f"render_{method}_params"] = _flat(p)
        out[f"render_{method}_losses"] = np.asarray(losses)
    return out


def _worker(rank, world, directory):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{directory}/init",
                            rank=rank, world_size=world)
    try:
        out = _steps(make_mesh(device="cpu"))
        np.savez(os.path.join(directory, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """{"single": no mesh, 1: a one-device mesh, 2: rank 0 of the world of
    2 (rank 1 checked equal)}."""
    d = tmp_path_factory.mktemp("steps2")
    spawn_worlds(_worker, {2: d})
    ranks = []
    for r in range(2):
        with np.load(d / f"rank{r}.npz") as f:
            ranks.append({k: f[k] for k in f.files})
    for k in ranks[0]:
        assert np.array_equal(ranks[0][k], ranks[1][k]), k
    return {"single": _steps(None),
            1: _steps(make_mesh(device="cpu"), renders=False), 2: ranks[0]}


@pytest.fixture(scope="module")
def jax_steps(steps):
    """JAX's sharded steps on the 8-device mesh (jitted) from the port's
    initial parameters, and JAX's losses at them run op by op."""
    import jax
    import jax.numpy as jnp

    from blackhole_simulation_tpu.parallel import InverseParams as JParams
    from blackhole_simulation_tpu.parallel import make_mesh as j_make_mesh
    from blackhole_simulation_tpu.parallel.train import _forward as j_forward
    from blackhole_simulation_tpu.parallel.train import _params_to_vec
    from blackhole_simulation_tpu.parallel.train import (
        make_ad_inverse_step as j_ad_step,
    )
    from blackhole_simulation_tpu.parallel.train import (
        make_fd_inverse_step as j_fd_step,
    )
    from blackhole_simulation_tpu.parallel.train import (
        make_inverse_step as j_inverse_step,
    )
    from blackhole_simulation_tpu.render import Camera as JCamera
    from blackhole_simulation_tpu.render import MarchConfig as JMarchConfig
    from blackhole_simulation_tpu.render import Scene as JScene

    def scene(width, height, **cfg):
        cam = JCamera.create(r=30.0, theta=jnp.pi / 2 - 0.25, fov=0.5,
                             width=width, height=height)
        return JScene.create(mass=1.0, spin=0.8, camera=cam,
                             march_cfg=JMarchConfig(max_steps=48, **cfg))

    inv, ad = scene(32, 16), scene(32, 32, midpoint_iters=1)
    p0 = JParams(*[jnp.float32(x) for x in _flat(_params())])
    mesh = j_make_mesh(8)
    z16, z32 = jnp.zeros((16, 32, 3), jnp.float32), jnp.zeros((32, 32, 3),
                                                              jnp.float32)
    flat = lambda p: np.asarray([float(getattr(p, k)) for k in FIELDS])
    (p, _), _ = j_inverse_step(inv, mesh)(p0, z16)
    out = {"inverse_params": flat(p)}
    vec0 = _params_to_vec(p0).astype(jnp.float32)
    (vec, _), _ = j_fd_step(inv, mesh)(
        (vec0, (jnp.zeros(4), jnp.zeros(4), jnp.zeros((), jnp.int32))), z16)
    out["fd_vec"] = np.asarray(vec)
    (p, _), _ = j_ad_step(ad, mesh, pool=4, march_steps=48)(p0, z32)
    out["ad_params"] = flat(p)
    with jax.disable_jit():
        rgb = np.asarray(j_forward(p0, inv, jnp.arange(512), jnp.float32))
        out["inverse_loss"] = float(np.sum(rgb.astype(np.float64) ** 2) / 512)
        rgb = np.asarray(j_forward(p0, ad, jnp.arange(1024), jnp.float32))
        pooled = rgb.reshape(8, 4, 8, 4, 3).mean(axis=(1, 3))
        out["ad_loss"] = float(np.sum(pooled.astype(np.float64) ** 2) / 64)
    return out


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("step", ["inverse", "ad"])
def test_sharded_step_matches_single_device(steps, step, world):
    got, ref = steps[world], steps["single"]
    assert got[f"{step}_loss"] == pytest.approx(ref[f"{step}_loss"],
                                                rel=1e-4)
    np.testing.assert_allclose(got[f"{step}_params"], ref[f"{step}_params"],
                               atol=5e-5)
    assert np.isfinite(got[f"{step}_params"]).all()


@pytest.mark.parametrize("world", [1, 2])
def test_fd_sharded_matches_single_device(steps, world):
    got, ref = steps[world], steps["single"]
    assert got["fd_loss"] == pytest.approx(ref["fd_loss"], rel=1e-4)
    np.testing.assert_allclose(got["fd_vec"], ref["fd_vec"], atol=5e-4)


def test_inverse_step_adam_state(steps):
    got = steps[2]
    assert int(got["inverse_t"]) == 1 and np.isfinite(got["inverse_m"]).all()
    assert got["inverse_m"][0] != 0


@pytest.mark.parametrize("method", ["fd", "ad-step", "ad"])
def test_inverse_render_on_the_mesh(steps, method):
    got, ref = steps[2], steps["single"]
    np.testing.assert_allclose(got[f"render_{method}_losses"],
                               ref[f"render_{method}_losses"], rtol=1e-4)
    np.testing.assert_allclose(got[f"render_{method}_params"],
                               ref[f"render_{method}_params"],
                               atol=5e-4 if method == "fd" else 5e-5)


@pytest.mark.parametrize("step", ["inverse", "ad"])
def test_sharded_step_matches_jax(steps, jax_steps, step):
    got = steps[2]
    assert got[f"{step}_loss"] == pytest.approx(jax_steps[f"{step}_loss"],
                                                rel=1e-4)
    np.testing.assert_allclose(got[f"{step}_params"],
                               jax_steps[f"{step}_params"], atol=5e-5)


def test_fd_sharded_matches_jax(steps, jax_steps):
    got = steps[2]
    assert got["fd_loss"] == pytest.approx(jax_steps["inverse_loss"],
                                           rel=1e-4)
    np.testing.assert_allclose(got["fd_vec"], jax_steps["fd_vec"], atol=5e-4)


def test_refuses_a_mesh_the_pixels_do_not_divide():
    """JAX's refusals (train.py:186, :296, :442) on a mesh of 3."""
    mesh = Mesh(None, ("devices",), (3,), 0, torch.device("cpu"), None)
    with pytest.raises(ValueError, match="pixel count 512 must divide"):
        make_inverse_step(INVERSE, mesh)
    with pytest.raises(ValueError, match="pixel count 512 must divide"):
        make_fd_inverse_step(INVERSE, mesh)
    with pytest.raises(ValueError, match="pooled blocks must divide"):
        make_ad_inverse_step(AD, mesh, pool=4)
    with pytest.raises(TypeError):
        make_inverse_step(INVERSE, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="not the mesh's"):
        make_inverse_step(INVERSE, make_mesh(device="cpu"), device="cuda")
