"""blackhole_simulation_tpu_torch: the Kerr geodesic renderer on PyTorch and
CUDA, a port of ``blackhole_simulation_tpu`` (JAX/Pallas), which stays
beside it as the reference.

This slice runs the flagship fused render:
``blackhole_simulation_tpu_torch.render.render(scene, n_samples, device)``
and ``render_radiance(scene, device)`` build each pixel's ray,
precull the shadow interior, march the Kerr-Schild geodesic and composite
disk, starfield and photon-ring glow in one hand-written CUDA kernel
(``csrc/render.cu``), then tone-map on the device. They run on ``cuda``
unless the caller passes ``device="cpu"``, which runs the kernel's plain
PyTorch version. The package imports torch and numpy, never JAX.

Layout (each module names its JAX counterpart):

- ``geometry`` -- Kerr scalars on the host (float64).
- ``physics``  -- Page-Thorne flux and Planck/CIE colour for the spectral
                  disk tables (host float64).
- ``render``   -- camera, config dataclasses, shading, precull, post, and
                  the pipeline entry points.
- ``ops``      -- the step math, the plain march, the render kernel's
                  parameter row, plain version and wrapper, and the nvcc
                  build.
- ``csrc``     -- CUDA sources.
"""

__version__ = "0.1.0"
