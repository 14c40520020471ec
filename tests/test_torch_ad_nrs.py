"""The differentiable render with the NRS far field and the certified
render's refinement pass, against the JAX package's, on the CPU
(tests/test_torch_render_ad.py's scenes and bars; about 170 s on one
worker).

NRS: the far rays' background comes from the surrogate MLP on
``nrs_init(0)``'s weights (fov 1.2, so that a share of the frame is far);
its gradient reaches the weights (each array's summed gradient is held)
and, through the deflected directions, the camera. XLA's float32 tanh is
its own approximation in a jitted program, and the star spots turn its
last bits into the roll's gradient (3e-2 apart), so the reference runs op
by op. The refinement pass (``refine_band=0.6``, its march at 256 steps)
re-marches under autograd the pixels of a 16x12 frame that its band
selects (two); its reference is the child process's jitted gradient,
started ahead of the NRS scene's op-by-op reference, which it overlaps.
"""

import dataclasses as dc

import pytest
import torch

import test_torch_render_ad
from test_torch_render_ad import (
    JaxChild,
    check_leaves,
    jax_grads_opbyop,
    port_grads,
    scenes,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def refine_ref():
    """The refinement scene's jitted JAX gradient, its child started
    ahead of the NRS scene's op-by-op reference, which it overlaps."""
    child = JaxChild(test_torch_render_ad.__file__, "refine")
    yield child
    child.close()


def test_nrs_far_field_gradients_match_jax(refine_ref):
    got, img = port_grads("nrs")
    assert bool(torch.isfinite(img).all())
    assert len(got) == 7 + 8   # four layers: weights and biases
    check_leaves(got, jax_grads_opbyop("nrs"))
    assert max(abs(g) for g in got[7:]) > 1e-2


def test_refined_render_gradients_match_jax(refine_ref):
    got, img = port_grads("refine")
    assert bool(torch.isfinite(img).all())
    check_leaves(got, refine_ref.result()["refine"])
    # the refinement pass changed the image, and with it the gradient
    _, ts, _ = scenes("refine")
    base, coarse = port_grads("refine", dc.replace(ts, march_cfg=dc.replace(
        ts.march_cfg, refine_band=0.0)))
    assert not torch.equal(img, coarse) and got != base
