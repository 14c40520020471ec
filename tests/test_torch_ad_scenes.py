"""The differentiable render against the JAX package's on three scenes, on
the CPU: the analytic disk, the staged spectral disk on the LUT route (its
tables built in the graph) and the jets (their emission's adjoint in the
gradient kernel's plain version). tests/test_torch_render_ad.py's scenes,
bar and child-process references (three jitted JAX compiles in the child;
about 150 s on one worker).
"""

import pytest
import torch

from test_torch_render_ad import check_leaves, jax_grads_jitted, port_grads

torch.set_num_threads(1)

NAMES = ("analytic", "lut", "jets")


@pytest.fixture(scope="module")
def jax_refs():
    return jax_grads_jitted(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_render_radiance_gradients_match_jax(jax_refs, name):
    got, img = port_grads(name)
    assert bool(torch.isfinite(img).all())
    check_leaves(got, jax_refs[name])
    assert max(abs(g) for g in got) > 1e-3
