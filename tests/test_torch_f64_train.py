"""The float64 inverse steps against the JAX package's, on the CPU.

One ``make_inverse_step`` (AD, Adam) and one ``make_fd_inverse_step``
(central differences, Adam) with ``dtype`` float64 on both sides, from the
same parameters (``InverseParams.init(spin=0.5)`` in float64; the FD
state's float32 vector), on a 16x12 frame at 48 steps (``use_pallas``
off), zero target. Bars: the loss to rel 1e-9; the Adam first moment
after the step (the clipped gradient over the pixel count, times 1 - b1)
to rel 1e-7; the parameters after the step to 1e-9 absolute; every
tensor of the port's state float64. The FD step's loss to rel 1e-6 and its
moment to 1e-4: its parameters are the float32 state vector's, so its
density and temperature scales are float32 exp, whose last bit XLA and
PyTorch round apart (4.6e-8 on every variant's loss here), and its spin
and inclination enter JAX's float64 render through operations that JAX
promotes one at a time (up to 1.1e-7 on those variants' losses), so the
central difference parts at ~1.2e-5. With ``use_pallas`` the float64 AD
step raises TypeError in both (the JAX twin's Pallas march on float64
rays fails to trace).

The JAX references run jitted in a child process without fused
multiply-adds (tests/test_torch_render_ad.py's ``JaxChild``). About 60 s
on one worker (85 s under the suite's six), nearly all of it the child's
compiles.
"""

import dataclasses as dc
import json
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackhole_simulation_tpu.parallel import InverseParams as JInverseParams
from blackhole_simulation_tpu.parallel.train import (
    fd_state_init as j_fd_state_init,
)
from blackhole_simulation_tpu.parallel.train import init_opt_state
from blackhole_simulation_tpu.parallel.train import (
    make_fd_inverse_step as j_make_fd_inverse_step,
)
from blackhole_simulation_tpu.parallel.train import (
    make_inverse_step as j_make_inverse_step,
)
from blackhole_simulation_tpu.render import Camera as JCamera
from blackhole_simulation_tpu.render import MarchConfig as JMarchConfig
from blackhole_simulation_tpu.render import Scene as JScene
from blackhole_simulation_tpu_torch.parallel import (
    InverseParams,
    fd_state_init,
    inverse_params_from_numpy,
    make_fd_inverse_step,
    make_inverse_step,
)
from blackhole_simulation_tpu_torch.render.pipeline import scene_from_numpy
from test_torch_render_ad import JaxChild

torch.set_num_threads(1)

F64 = torch.float64
THETA = math.pi / 2 - 0.25
W, H = 16, 12
FIELDS = ("spin", "theta_cam", "log_density", "log_t_peak")
CFG = dict(max_steps=48, remat_every=0)


def scenes(**cfg):
    jcfg = JMarchConfig(**{**CFG, **cfg})
    jcam = JCamera.create(r=30.0, theta=jnp.pi / 2 - 0.25, fov=0.5,
                          width=W, height=H)
    js = JScene.create(mass=1.0, spin=0.7, camera=jcam, march_cfg=jcfg)
    ts = scene_from_numpy(
        mass=1.0, spin=0.7,
        camera=dict(r=30.0, theta=THETA, phi=0.0, fov=0.5, roll=0.0,
                    width=W, height=H),
        march_cfg=dc.asdict(jcfg), features=dc.asdict(js.features),
        disk=dc.asdict(js.disk), stars=dc.asdict(js.stars),
        post=dc.asdict(js.post), device="cpu")
    return js, ts


def _floats(x):
    return [float(v) for v in np.asarray(x, np.float64).reshape(-1)]


def child_main():
    js, _ = scenes()
    target = jnp.zeros((H, W, 3), jnp.float64)
    p = JInverseParams.init(spin=0.5, dtype=jnp.float64)
    step = j_make_inverse_step(js, None, 2e-2, jnp.float64)
    (p1, (m1, _, _)), loss = step((p, init_opt_state(p)), target)
    out = {"init": [float(getattr(p, k)) for k in FIELDS],
           "ad": {"loss": float(loss), "dtype": str(loss.dtype),
                  "params": [float(getattr(p1, k)) for k in FIELDS],
                  "m": [float(getattr(m1, k)) for k in FIELDS]}}
    fd = j_make_fd_inverse_step(js, None, 3e-2, jnp.float64)
    (vec, (m_t, _, _)), fd_loss = fd(j_fd_state_init(p), target)
    out["fd"] = {"loss": float(fd_loss), "dtype": str(fd_loss.dtype),
                 "vec": _floats(vec), "m": _floats(m_t)}
    jp, _ = scenes(use_pallas=True)
    try:
        j_make_inverse_step(jp, None, 2e-2, jnp.float64)(
            (p, init_opt_state(p)), target)
        out["use_pallas"] = "no error"
    except TypeError as e:
        out["use_pallas"] = f"TypeError: {str(e)[:80]}"
    return out


@pytest.fixture(scope="module")
def jax_refs():
    child = JaxChild(__file__)
    try:
        return child.result()
    finally:
        child.close()


def _rel_ok(got, want, rel):
    return all(abs(g - w) <= rel * abs(w) for g, w in zip(got, want))


def _params(jax_refs):
    return inverse_params_from_numpy(*jax_refs["init"], device="cpu",
                                     dtype=F64)


def test_ad_step_matches_jax_in_float64(jax_refs):
    _, ts = scenes()
    step = make_inverse_step(ts, device="cpu", dtype=F64)
    (p1, (m1, v1, _)), loss = step(_params(jax_refs),
                                   torch.zeros((H, W, 3), dtype=F64))
    ref = jax_refs["ad"]
    assert ref["dtype"] == "float64" and loss.dtype == F64
    assert all(x.dtype == F64 for x in p1.leaves() + m1.leaves()
               + v1.leaves())
    assert abs(float(loss) - ref["loss"]) <= 1e-9 * abs(ref["loss"])
    m = [float(x) for x in m1.leaves()]
    assert _rel_ok(m, ref["m"], 1e-7), (m, ref["m"])
    p = [float(x) for x in p1.leaves()]
    assert max(abs(a - b) for a, b in zip(p, ref["params"])) < 1e-9


def test_fd_step_matches_jax_in_float64(jax_refs):
    _, ts = scenes()
    step = make_fd_inverse_step(ts, device="cpu", dtype=F64)
    (vec, (m_t, _, _)), loss = step(fd_state_init(_params(jax_refs)),
                                    torch.zeros((H, W, 3), dtype=F64))
    ref = jax_refs["fd"]
    assert ref["dtype"] == "float64" and loss.dtype == F64
    assert vec.dtype == m_t.dtype == F64
    assert abs(float(loss) - ref["loss"]) <= 1e-6 * abs(ref["loss"])
    assert _rel_ok(m_t.tolist(), ref["m"], 1e-4), (m_t.tolist(), ref["m"])
    assert max(abs(a - b) for a, b in zip(vec.tolist(), ref["vec"])) < 1e-9


def test_use_pallas_raises_in_float64(jax_refs):
    assert jax_refs["use_pallas"].startswith("TypeError"), jax_refs[
        "use_pallas"]
    _, ts = scenes(use_pallas=True)
    step = make_inverse_step(ts, device="cpu", dtype=F64)
    with pytest.raises(TypeError):
        step(_params(jax_refs), torch.zeros((H, W, 3), dtype=F64))


def test_init_takes_dtype():
    p = InverseParams.init(dtype=F64)
    assert all(x.dtype == F64 for x in p.leaves())
    j = JInverseParams.init(dtype=jnp.float64)
    assert [float(x) for x in p.leaves()] == [float(getattr(j, k))
                                              for k in FIELDS]


if __name__ == "__main__":
    # The child process of the jax_refs fixture: one JSON line.
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    print(json.dumps(child_main()))
