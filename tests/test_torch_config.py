"""The port's static configuration equals the JAX package's, field by field.

Every dataclass a JAX Scene carries (MarchConfig, Features, Camera,
DiskParams, StarfieldParams, JetParams, PostParams) has a twin in
blackhole_simulation_tpu_torch with the same fields, in the same order,
with the same defaults, so ``scene_from_numpy`` can carry a scene across.
"""

import dataclasses
import inspect

import pytest
import torch

import importlib

# import_module: the render packages re-export functions named like their
# submodules (render.march is also a function), so attribute access would
# find the function.
jcam, jmarch, jpipe, jpost, jshade, tcam, tmarch, tpipe, tpost, tshade = (
    importlib.import_module(f"{pkg}.render.{mod}")
    for pkg in ("blackhole_simulation_tpu", "blackhole_simulation_tpu_torch")
    for mod in ("camera", "march", "pipeline", "post", "shading")
)

torch.set_num_threads(1)

PAIRS = {
    "MarchConfig": (jmarch.MarchConfig, tmarch.MarchConfig),
    "Features": (jpipe.Features, tpipe.Features),
    "Camera": (jcam.Camera, tcam.Camera),
    "DiskParams": (jshade.DiskParams, tshade.DiskParams),
    "StarfieldParams": (jshade.StarfieldParams, tshade.StarfieldParams),
    "JetParams": (jshade.JetParams, tshade.JetParams),
    "PostParams": (jpost.PostParams, tpost.PostParams),
}


def _spec(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_fields_and_defaults_match(name):
    jcls, tcls = PAIRS[name]
    assert _spec(tcls) == _spec(jcls)
    assert dataclasses.is_dataclass(tcls) and tcls.__dataclass_params__.frozen


def test_camera_create_defaults_match():
    jsig = inspect.signature(jcam.Camera.create).parameters
    tsig = inspect.signature(tcam.Camera.create).parameters
    assert list(jsig) == list(tsig)
    for k in jsig:
        assert float(tsig[k].default) == pytest.approx(float(jsig[k].default), abs=0)


def test_scene_fields_match():
    assert [f.name for f in dataclasses.fields(tpipe.Scene)] == [
        f.name for f in dataclasses.fields(jpipe.Scene)
    ]


def test_hit_codes_and_jets_need_disk():
    for code in ("HIT_NONE", "HIT_HORIZON", "HIT_ESCAPE"):
        assert getattr(tmarch, code) == getattr(jmarch, code)
    assert tpipe.Features(jets=True, disk=False).jets is False
    assert jpipe.Features(jets=True, disk=False).jets is False
