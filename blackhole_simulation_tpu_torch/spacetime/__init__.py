"""Spacetime-visualization fields: curvature, embeddings, frame drag, light
cones (counterpart of ``blackhole_simulation_tpu/spacetime``)."""

from blackhole_simulation_tpu_torch.spacetime.curvature import (
    curvature_field,
    kretschmann_kerr,
    kretschmann_schwarzschild,
)
from blackhole_simulation_tpu_torch.spacetime.embedding import (
    embedding_mesh,
    flamm_height,
    kerr_embedding_height,
    proper_distance,
)
from blackhole_simulation_tpu_torch.spacetime.frame_drag import (
    ergosphere_mesh,
    frame_drag_field,
    frame_dragging_omega,
)
from blackhole_simulation_tpu_torch.spacetime.lightcone import (
    light_cone_tilt,
    tilt_field,
)

__all__ = [
    "kretschmann_kerr",
    "kretschmann_schwarzschild",
    "curvature_field",
    "flamm_height",
    "kerr_embedding_height",
    "proper_distance",
    "embedding_mesh",
    "frame_dragging_omega",
    "frame_drag_field",
    "ergosphere_mesh",
    "light_cone_tilt",
    "tilt_field",
]
