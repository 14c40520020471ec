"""The port's simulation configuration (``configs/``) against the JAX
package's: the schema, presets, clamping and detection, and
``scene_from_params`` field for field for the default parameters, every
preset and the jets scene (``cli render --set enable_jets=1``), on the CPU,
where both leave the kernel path off."""

import dataclasses as dc
import math

import numpy as np
import pytest

from blackhole_simulation_tpu import configs as jconfigs
from blackhole_simulation_tpu_torch import configs as tconfigs


def test_schema_and_tables_match_jax():
    assert tconfigs.PARAMETER_SCHEMA.keys() == jconfigs.PARAMETER_SCHEMA.keys()
    for name, spec in tconfigs.PARAMETER_SCHEMA.items():
        assert dc.asdict(spec) == dc.asdict(jconfigs.PARAMETER_SCHEMA[name])
    assert tconfigs.QUALITY_RAY_STEPS == jconfigs.QUALITY_RAY_STEPS
    assert tconfigs.PRESETS == jconfigs.PRESETS
    assert tconfigs.MAX_RAY_STEPS == jconfigs.simulation.MAX_RAY_STEPS
    assert dc.asdict(tconfigs.SimulationParams()) == dc.asdict(
        jconfigs.SimulationParams())


def test_clamp_apply_and_detect_match_jax():
    bad = dict(mass=float("nan"), spin=3.0, fov=-1.0, exposure=math.inf,
               quality="insane", camera_distance=1e9)
    t = tconfigs.clamp_params(tconfigs.SimulationParams(**bad))
    j = jconfigs.clamp_params(jconfigs.SimulationParams(**bad))
    assert dc.asdict(t) == dc.asdict(j)
    for name in sorted(tconfigs.PRESETS):
        t = tconfigs.apply_preset(tconfigs.SimulationParams(), name)
        j = jconfigs.apply_preset(jconfigs.SimulationParams(), name)
        assert dc.asdict(t) == dc.asdict(j)
        assert tconfigs.detect_preset(t) == jconfigs.detect_preset(j) == name
    assert tconfigs.detect_preset(tconfigs.SimulationParams(
        quality="low")) is None
    with pytest.raises(KeyError):
        tconfigs.apply_preset(tconfigs.SimulationParams(), "nope")


def _jax_fields(scene):
    cam = scene.camera
    return dict(
        mass=float(scene.bh.mass), spin=float(scene.bh.spin),
        camera=(float(cam.r), float(cam.theta), float(cam.phi),
                float(cam.fov), float(cam.roll), cam.width, cam.height),
        disk=dc.asdict(scene.disk), features=dc.asdict(scene.features),
        march_cfg=dc.asdict(scene.march_cfg), post=dc.asdict(scene.post),
        jets=dc.asdict(scene.jet_params), stars=dc.asdict(scene.stars))


def _port_fields(scene):
    cam = scene.camera
    return dict(
        mass=scene.bh.mass, spin=scene.bh.spin,
        camera=(cam.r, cam.theta, cam.phi, cam.fov, cam.roll, cam.width,
                cam.height),
        disk=dc.asdict(scene.disk), features=dc.asdict(scene.features),
        march_cfg=dc.asdict(scene.march_cfg), post=dc.asdict(scene.post),
        jets=dc.asdict(scene.jet_params), stars=dc.asdict(scene.stars))


PARAMS = {
    "default": {},
    "jets": dict(enable_jets=True),
    "jets-without-disk": dict(enable_jets=True, enable_disk=False),
    **{f"preset-{name}": dict(preset=name) for name in jconfigs.PRESETS},
}


@pytest.mark.parametrize("case", sorted(PARAMS))
def test_scene_from_params_matches_jax(case):
    over = dict(PARAMS[case])
    preset = over.pop("preset", None)
    tp = tconfigs.SimulationParams(**over)
    jp = jconfigs.SimulationParams(**over)
    if preset:
        tp = tconfigs.apply_preset(tp, preset)
        jp = jconfigs.apply_preset(jp, preset)
    t = _port_fields(tconfigs.scene_from_params(tp, 96, 54, device="cpu"))
    j = _jax_fields(jconfigs.scene_from_params(jp, 96, 54))
    for key in t:
        if key in ("mass", "spin", "camera"):
            np.testing.assert_allclose(np.asarray(t[key], np.float64),
                                       np.asarray(j[key], np.float64),
                                       rtol=0, atol=0, err_msg=key)
        else:
            assert t[key] == j[key], key
    assert t["features"]["jets"] == (over.get("enable_jets", False)
                                     and over.get("enable_disk", True))


def test_scene_from_params_turns_the_kernel_path_on_for_cuda(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    scene = tconfigs.scene_from_params(
        tconfigs.SimulationParams(enable_jets=True), 1920, 1080)
    cfg = scene.march_cfg
    assert cfg.use_pallas and cfg.fused and cfg.approx_recip
    assert (scene.camera.width, scene.camera.height) == (1920, 1080)
    assert cfg.max_steps == 256 and scene.features.jets
    cpu = tconfigs.scene_from_params(tconfigs.SimulationParams(), 64, 32,
                                     device="cpu").march_cfg
    assert not (cpu.use_pallas or cpu.fused or cpu.approx_recip)
