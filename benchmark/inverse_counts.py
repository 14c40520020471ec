"""The work of the inverse step's two kernels, counted from the algorithm
as ``counts.py`` counts the render kernel's, so that a roofline share
reads the same work whatever implements it. Frozen from the port's
``chip_smoke.py``: ``OPS_PER_STEP`` (340 a midpoint march step, every
add, multiply, divide, square root and compare one, uncontracted) and its
``grad_ops`` (the gradient kernel's least work a live step: the
checkpointing replay, the block's re-forward and one reverse-mode VJP at
about three times the step, 5 x 340). The steps come from the benchmark's
reference on seeded rays (``reference/inverse.py::mean_steps``), never
from the program's own counts.

Bytes: each input read once, each output written once. The march kernel
reads a ray's 8 rows and its termination radius and writes its 8 rows,
hit, steps, the crossings' radius, angle and time in each of its
``CROSSINGS`` slots, their count and r_min. The gradient kernel reads the
rows, the radius, the final rows' cotangent, the crossings' cotangents,
r_min and its cotangent, and writes the rows' cotangent and the four
scalar partials' per-ray terms; each live checkpoint block writes and
reads back its 7 words."""

from __future__ import annotations

from benchmark.counts import OPS_PER_STEP

GRAD_STEPS_PER_STEP = 5
CROSSINGS = 4          # MarchConfig.max_crossings of the configuration
CKPT = 8               # the gradient kernel's steps per checkpoint block
WORD = 4               # float32


def march_ops(steps: float) -> float:
    """Operations of march-kernel launches that march ``steps`` steps in
    all."""
    return OPS_PER_STEP * steps


def march_bytes(launches: int, rays: int) -> float:
    words = (8 + 1) + (8 + 1 + 1 + 3 * CROSSINGS + 1 + 1)
    return WORD * words * launches * rays


def grad_ops(steps: float) -> float:
    """Operations of gradient-kernel launches over ``steps`` live steps."""
    return GRAD_STEPS_PER_STEP * OPS_PER_STEP * steps


def grad_bytes(launches: int, rays: int, mean_steps: float) -> float:
    """Bytes of ``launches`` gradient-kernel launches over ``rays`` rays of
    ``mean_steps`` live steps."""
    blocks = mean_steps / CKPT + 1.0
    words = 7 + 1 + 7 + 3 * CROSSINGS + 2 + 7 + 4 + 2 * 7 * blocks
    return WORD * words * launches * rays
