"""Static march configuration and ray termination codes.

Counterpart of ``blackhole_simulation_tpu/render/march.py:48-189``: the same
``MarchConfig`` fields and defaults (a test holds them equal), so a JAX
scene's config carries over field by field. The batched march itself lives
in ``ops/march.py`` (plain version) and ``csrc/render.cu`` (kernel).
"""

from __future__ import annotations

import dataclasses

HIT_NONE = 0
HIT_HORIZON = 1
HIT_ESCAPE = 2


@dataclasses.dataclass(frozen=True)
class MarchConfig:
    """Static march parameters. See the JAX twin for what each field does.

    This slice runs the fused path only (``use_pallas`` and ``fused`` on);
    ``approx_recip`` applies in the CUDA kernel and never in the plain
    version, as the JAX package applies it on the TPU and never in interpret
    mode. ``exit_check_every`` and ``remat_every`` have no effect here: the
    kernel exits per thread, and the port has no differentiable march yet.
    """

    max_steps: int = 256
    step_rate: float = 0.12
    min_step: float = 5e-3
    max_step: float = 4.0
    far_step_cap_rate: float = 0.0
    far_boost_radius: float = 30.0
    escape_radius: float = 120.0
    horizon_factor: float = 1.01
    renormalize_every: int = 16
    exit_check_every: int = 8
    remat_every: int = 32
    max_crossings: int = 4
    record_r_min: float = 1.0
    record_r_max: float = 30.0
    midpoint_iters: int = 2
    approx_recip: bool = False
    shadow_precull: bool = False
    precull_keep_disk: bool = True
    cotangent_clip: float = 0.0
    use_pallas: bool = False
    fused: bool = False
    multistep: bool = False
    start_jitter: float = 0.0
    refine_band: float = 0.0
    refine_budget: int = 16384
    refine_step_rate: float = 0.03
    refine_max_steps: int = 4096
    refine_max_step: float = 1.0
    refine_pole_w: float = 0.0
