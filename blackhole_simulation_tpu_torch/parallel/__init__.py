"""Multi-device execution and inverse rendering: the device mesh over
``torch.distributed`` (``mesh.py``), the sharded render (``render.py``),
the inverse steps on one device or sharded over the mesh (``train.py``) and
their checkpoints (``checkpoint.py``). The JAX package's fifteen
``parallel`` names, and the port's FD-state helpers."""

from blackhole_simulation_tpu_torch.parallel.mesh import (
    Mesh,
    initialize_multihost,
    local_device_count,
    make_host_chip_mesh,
    make_mesh,
)
from blackhole_simulation_tpu_torch.parallel.render import (
    gather_image,
    render_sharded,
    shard_rays_spec,
)
from blackhole_simulation_tpu_torch.parallel.train import (
    InverseParams,
    ad_inverse_render,
    fd_inverse_render,
    fd_state_init,
    fd_state_params,
    init_opt_state,
    inverse_params_from_numpy,
    inverse_render,
    make_ad_inverse_step,
    make_fd_inverse_step,
    make_inverse_step,
)

__all__ = ["Mesh", "make_host_chip_mesh", "make_mesh", "local_device_count",
           "initialize_multihost", "gather_image", "render_sharded",
           "shard_rays_spec", "InverseParams", "init_opt_state",
           "make_inverse_step", "make_fd_inverse_step",
           "make_ad_inverse_step", "fd_inverse_render", "ad_inverse_render",
           "inverse_render", "fd_state_init", "fd_state_params",
           "inverse_params_from_numpy"]
