"""The work the cells' kernels do, counted from the algorithm, so that a
roofline share reads the same work whatever implements it.

Every add, multiply, divide, square root and compare counts as one
operation, uncontracted: a multiply-add is two, whether or not a kernel
fuses it. A float32 FMA is two operations at the card's published
67e12 FLOP/s, so ``ops / 67e12`` is the least time any instruction mix
can take for them. The counts are frozen from the hand counts in the
port's ``chip_smoke.py`` (its comments beside ``OPS_PER_STEP`` and
``OPS_PER_PIXEL``); the number of steps comes
from the benchmark's reference (``reference/geodesic.py``), never from the
program's own step counts.

- OPS_PER_STEP = 340, one midpoint march step (``midpoint_iters`` = 1):
  two Kerr-Schild right-hand sides of ~121 each (the explicit seed and one
  fixed-point round), the curvature-adaptive step size and its pole
  throttle, the six-row updates of both stages, the equator-crossing
  record and the sanity test, plus the null renormalization spread over
  its 16 steps.
- OPS_PER_PIXEL = 260, what the render kernel does per pixel outside the
  march: ray birth from the camera tetrad, the null projection, and the
  32-term Chebyshev shadow precull. The composite (disk slots, starfield,
  glow) depends on each ray's crossings and fate and is not counted, so
  the least time is a lower one.
- Bytes: each input read once and each output written once. The render
  kernel writes three float32 planes a pixel; the tone map reads the
  (H, W, 3) float32 image once and writes it once.
"""

from __future__ import annotations

OPS_PER_STEP = 340
OPS_PER_PIXEL = 260
RENDER_BYTES_PER_PIXEL = 12
IMAGE_BYTES_PER_PIXEL = 12


def render_ops(steps: float, pixels: int) -> float:
    """Operations of render-kernel launches that march ``steps`` steps in
    all over ``pixels`` pixels."""
    return OPS_PER_STEP * steps + OPS_PER_PIXEL * pixels


def render_bytes(pixels: int) -> float:
    return RENDER_BYTES_PER_PIXEL * pixels


def post_bytes(pixels: int) -> float:
    """The tone map's least traffic: the image read once, written once."""
    return 2 * IMAGE_BYTES_PER_PIXEL * pixels
