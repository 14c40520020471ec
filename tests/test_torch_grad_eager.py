"""The port's march gradient against JAX's derivative run op by op, where
the jitted reference is not close enough to hold the bar.

Jitted, XLA rounds the JAX march differently from its operations one at a
time, and on this scene that alone moves d(loss)/d(spin) at a = 0.3 and the
precull variant at a = 0.8 by 5e-3 to 7e-3. Run op by op
(``jax.disable_jit``), JAX rounds each operation once, as the port's plain
versions do, and the bar is tests/test_grad_kernel.py's rel < 5e-3. The
reference is the forward-mode derivative (``jax.jvp`` with a unit tangent
in spin): the same derivative as ``jax.grad`` for one scalar input, and a
few times cheaper op by op, since nothing is transposed or stored for a
reverse pass.
"""

import math

import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_grad import CFG, JMarchConfig, _j_loss, _rel, t_grads

torch.set_num_threads(1)

CASES = {"a0.3": (0.3, {}), "a0.8-precull": (0.8, {"shadow_precull": True})}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dspin_matches_jax_ad_op_by_op(case):
    spin, over = CASES[case]
    cfg = JMarchConfig(**{**CFG, **over})
    with jax.disable_jit():
        _, ref = jax.jvp(lambda s: _j_loss(s, cfg), (jnp.float32(spin),),
                         (jnp.float32(1.0),))
    ref = float(ref)
    _, g, _ = t_grads(spin, **over)
    assert math.isfinite(g)
    assert _rel(g, ref) < 5e-3, (g, ref)
