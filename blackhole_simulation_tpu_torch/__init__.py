"""blackhole_simulation_tpu_torch: the Kerr geodesic renderer on PyTorch and
CUDA, a port of ``blackhole_simulation_tpu`` (JAX/Pallas), which stays
beside it as the reference.

What runs:

- the fused render:
  ``blackhole_simulation_tpu_torch.render.render(scene, n_samples, device)``
  and ``render_radiance(scene, device)`` build each pixel's ray, precull the
  shadow interior, march the Kerr-Schild geodesic and composite disk,
  starfield and photon-ring glow in one hand-written CUDA kernel
  (``csrc/render.cu``), then tone-map on the device; the jets, the start
  jitter, the NRS far field and the shadow overlay are branches of the same
  kernel, and ``configs.scene_from_params`` builds the CLI's scenes;
- the staged render (``MarchConfig.fused`` off): camera rays, the march
  kernel (``csrc/march.cu``) and the composite in PyTorch;
- inverse rendering (``parallel``): ``make_inverse_step``,
  ``make_ad_inverse_step``, ``ad_inverse_render`` and ``inverse_render``
  differentiate the staged render, with the march kernel forward and the
  gradient kernel (``csrc/march_grad.cu``) backward (``march_rows_ad``);
  ``make_fd_inverse_step`` / ``fd_inverse_render`` (``inverse_render``'s
  ``method="fd"``) take central differences of nine forward passes, each
  one march-kernel launch;
- the float64 oracle (``geodesic``): the adaptive RKF45 integrator in plain
  PyTorch on the inputs' device (``oracle_march``; on a GPU its trials run
  as captured CUDA graphs), ``render.pipeline.oracle_render`` and
  ``shade_sample`` in float64, the ground truth the fast paths are held
  against (``chip_smoke.py`` phase 14);
- NRS training (``models/nrs.py``: ``generate_training_data`` labels the
  equatorial ray family in one float64 batch of the integrator,
  ``train_nrs`` fits the surrogate), temporal accumulation
  (``render/accumulate.py``), the progressive tile renderer
  (``render/tiles.py``, one march-kernel launch per batch of tiles), and
  the analytics behind ``engine.PhysicsEngine`` (``physics``,
  ``spacetime``, the native seqlock bridge);
- multi-device (``parallel``): ``make_mesh`` over ``torch.distributed``
  (one process per device, NCCL on cards, gloo on the CPU),
  ``render_sharded`` (each rank marches its shard of the rays on the march
  kernel) and ``mesh=`` on the inverse steps; ``cli sweep`` runs on it.

The entry points run on ``cuda`` unless the caller passes
``device="cpu"``, which runs the kernels' plain PyTorch versions (the
temporal accumulator and the analytic functions run where their tensors
are). The package imports torch and numpy, never JAX.

Layout (each module names its JAX counterpart):

- ``geometry`` -- Kerr scalars: host float64, and differentiable radii;
                  the tensor metrics (both charts), tensor algebra,
                  Christoffel symbols and radii of the oracle layer.
- ``geodesic`` -- Hamilton's equations in closed form, the RKF45 / RK4 /
                  implicit-midpoint steppers and step controller, the
                  invariants, the batched driver ``integrate`` and the
                  oracle march.
- ``configs``  -- the simulation parameter schema, presets and
                  ``scene_from_params``.
- ``models``   -- the NRS far-field MLP and its training.
- ``physics``  -- Page-Thorne flux and temperature, Planck/CIE colour and
                  the LUTs, the Bardeen shadow curve (host float64);
                  redshift, Hawking temperature, matter fields (tensors).
- ``spacetime``-- curvature, embedding, frame-drag and light-cone fields.
- ``engine``   -- ``PhysicsEngine`` and the ctypes seqlock bridge.
- ``render``   -- camera and rays, config dataclasses, the differentiable
                  march, shading, precull, the shadow overlay, post, the
                  pipeline entry points, TAA and the tile renderer.
- ``ops``      -- the step math, the plain march and its gradient, the
                  kernels' wrappers and parameter rows, and the nvcc build.
- ``parallel`` -- the device mesh over ``torch.distributed`` (one process
                  per device), the sharded render, and inverse rendering on
                  one device or sharded over the mesh.
- ``constants``-- geometric units and SI constants.
- ``csrc``     -- CUDA sources.
"""

from blackhole_simulation_tpu_torch import constants  # noqa: F401

__version__ = "0.1.0"
