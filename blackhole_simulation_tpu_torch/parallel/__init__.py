"""Inverse rendering on one device (``train.py``) and its checkpoints
(``checkpoint.py``)."""

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

__all__ = ["InverseParams", "ad_inverse_render", "fd_inverse_render",
           "fd_state_init", "fd_state_params", "init_opt_state",
           "inverse_params_from_numpy", "inverse_render",
           "make_ad_inverse_step", "make_fd_inverse_step",
           "make_inverse_step"]
