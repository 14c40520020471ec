"""Rendering: camera and rays, the march, shading, post and the pipeline,
with the JAX package's ``render`` exports."""

from blackhole_simulation_tpu_torch.render.camera import (
    Camera,
    bl_to_ks_momentum,
    camera_rays,
    camera_rays_indexed,
    zamo_tetrad,
)
from blackhole_simulation_tpu_torch.render.march import (
    HIT_ESCAPE,
    HIT_HORIZON,
    HIT_NONE,
    MarchConfig,
    MarchResult,
    march,
)
from blackhole_simulation_tpu_torch.render.pipeline import (
    Features,
    Scene,
    halton_jitters,
    oracle_render,
    render,
    render_radiance,
    scene_from_numpy,
)
from blackhole_simulation_tpu_torch.render.post import (
    PostParams,
    aces,
    bloom,
    tonemap,
)
from blackhole_simulation_tpu_torch.render.shading import (
    DiskParams,
    JetParams,
    StarfieldParams,
    blackbody_ramp,
    disk_emission,
    escape_direction,
    fbm2,
    shade_disk_crossings,
    starfield,
)

__all__ = [
    "Camera", "bl_to_ks_momentum", "camera_rays", "camera_rays_indexed",
    "zamo_tetrad", "HIT_ESCAPE", "HIT_HORIZON", "HIT_NONE", "MarchConfig",
    "MarchResult", "march", "Features", "Scene", "halton_jitters",
    "oracle_render", "render", "render_radiance", "scene_from_numpy",
    "PostParams", "aces", "bloom", "tonemap", "DiskParams", "JetParams",
    "StarfieldParams", "blackbody_ramp", "disk_emission", "escape_direction",
    "fbm2", "shade_disk_crossings", "starfield",
]
