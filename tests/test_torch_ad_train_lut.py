"""The AD inverse step on a staged spectral scene against the JAX
package's, on the CPU.

A staged spectral scene shades its disk from the Page-Thorne and
Planck/CIE tables. The JAX package builds them in its graph from the spin
it optimizes (render/shading.py:337-380), so its step's spin gradient has
the tables' term; the port builds them in the graph too
(``render/shading.py::build_disk_luts_t``) wherever autograd wants the
spin's derivative. One ``make_inverse_step`` from the same parameters on
both sides (32x16, 48 steps, zero target), to tests/test_torch_train.py's
bars: the loss to rtol 1e-4 against JAX run op by op, the parameters after
the step to atol 5e-5 against the jitted JAX step. About 60 s on one
worker.
"""

import dataclasses as dc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackhole_simulation_tpu.parallel.train import (
    make_inverse_step as j_make_inverse_step,
)
from blackhole_simulation_tpu.render import Camera as JCamera
from blackhole_simulation_tpu.render import MarchConfig as JMarchConfig
from blackhole_simulation_tpu.render import Scene as JScene
from blackhole_simulation_tpu.render.pipeline import Features as JFeatures
from blackhole_simulation_tpu_torch.parallel import make_inverse_step
from blackhole_simulation_tpu_torch.render.pipeline import scene_from_numpy
from test_torch_train import THETA, _check_step, _j_step_ref, _params

torch.set_num_threads(1)


def _spectral_scenes(width, height, spin):
    cfg = JMarchConfig(max_steps=48)
    feats = JFeatures(spectral_lut=True)
    jcam = JCamera.create(r=30.0, theta=jnp.pi / 2 - 0.25, fov=0.5,
                          width=width, height=height)
    js = JScene.create(mass=1.0, spin=spin, camera=jcam, march_cfg=cfg,
                       features=feats)
    ts = scene_from_numpy(
        mass=1.0, spin=spin,
        camera=dict(r=30.0, theta=THETA, phi=0.0, fov=0.5, roll=0.0,
                    width=width, height=height),
        march_cfg=dc.asdict(cfg), features=dc.asdict(feats),
        disk=dc.asdict(js.disk), stars=dc.asdict(js.stars),
        post=dc.asdict(js.post),
    )
    assert js.spectral_coeffs is None and ts.spectral_coeffs is None
    return js, ts


@pytest.fixture(scope="module")
def spectral_case():
    js, ts = _spectral_scenes(32, 16, 0.8)
    ref = _j_step_ref(js, j_make_inverse_step(js, None),
                      lambda rgb: np.sum(rgb.astype(np.float64) ** 2) / 512)
    return ts, ref


def test_inverse_step_on_the_lut_route_matches_jax(spectral_case):
    ts, ref = spectral_case
    _, tp = _params()
    state, loss = make_inverse_step(ts, device="cpu")(
        tp, torch.zeros(16, 32, 3))
    _check_step(state, loss, ref)
