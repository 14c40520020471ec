"""Rendering: camera, static config, shading, post and the pipeline."""

from blackhole_simulation_tpu_torch.render.camera import Camera
from blackhole_simulation_tpu_torch.render.march import (
    HIT_ESCAPE,
    HIT_HORIZON,
    HIT_NONE,
    MarchConfig,
)
from blackhole_simulation_tpu_torch.render.pipeline import (
    Features,
    Scene,
    halton_jitters,
    render,
    render_radiance,
    scene_from_numpy,
)
from blackhole_simulation_tpu_torch.render.post import PostParams, tonemap
from blackhole_simulation_tpu_torch.render.shading import (
    DiskParams,
    JetParams,
    StarfieldParams,
)

__all__ = [
    "Camera", "HIT_ESCAPE", "HIT_HORIZON", "HIT_NONE", "MarchConfig",
    "Features", "Scene", "halton_jitters", "render", "render_radiance",
    "scene_from_numpy", "PostParams", "tonemap", "DiskParams", "JetParams",
    "StarfieldParams",
]
