"""The differentiable render with the start offset, against the JAX
package's, on the CPU (tests/test_torch_render_ad.py's scene and bars).

``start_jitter`` advances each ray by a hashed fraction of its first step
before the march. The hash's floors have derivative 0, so its fracts have
derivative 1 and the offset's gradient carries the hash's own derivative
(thousands per unit of p_r), as ``jax.grad`` gives it. XLA's jitted
program rounds the hash differently from the op-by-op one (its rewrites
move the hashed fraction), which changes the offset of every ray, so the
reference here is ``jax.grad`` run op by op (``jax.disable_jit``), whose
operations each round once as the port's do. Also ``render_sample_scaled``
with ``start_jitter``, which the port refused before it differentiated the
offset: its radiance against JAX's op by op (tests/test_torch_oracle.py's
bars) and its gradients in the two scales. About 140 s on one worker.
"""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackhole_simulation_tpu.render.pipeline import (
    render_sample_scaled as j_render_sample_scaled,
)
from blackhole_simulation_tpu_torch.render.pipeline import render_sample_scaled
from test_torch_render_ad import (
    check_leaves,
    jax_grads_opbyop,
    port_grads,
    scenes,
)

torch.set_num_threads(1)


def test_start_jitter_gradients_match_jax():
    got, img = port_grads("start_jitter")
    assert bool(torch.isfinite(img).all())
    check_leaves(got, jax_grads_opbyop("start_jitter"))
    # the offset's hash dominates: far above the unjittered scene's
    base = port_grads("analytic")[0]
    assert max(map(abs, got)) > 100 * max(map(abs, base))


def test_render_sample_scaled_with_start_jitter_matches_jax():
    js, ts, _ = scenes("start_jitter")
    with jax.disable_jit():
        want = np.asarray(j_render_sample_scaled(
            js, density_scale=jnp.float32(0.6),
            intensity_scale=jnp.float32(1.7)))

        def j_loss(ds, its):
            return jnp.sum(j_render_sample_scaled(
                js, density_scale=ds, intensity_scale=its))

        g_want = jax.grad(j_loss, argnums=(0, 1))(jnp.float32(0.6),
                                                  jnp.float32(1.7))
    ds = torch.tensor(0.6, requires_grad=True)
    its = torch.tensor(1.7, requires_grad=True)
    out = render_sample_scaled(ts, density_scale=ds, intensity_scale=its,
                               device="cpu")
    d = np.abs(out.detach().numpy() - want)
    assert np.percentile(d, 99) < 1e-4 and d.mean() < 1e-5
    base = render_sample_scaled(dc.replace(ts, march_cfg=dc.replace(
        ts.march_cfg, start_jitter=0.0)), device="cpu")
    assert not torch.equal(base, out.detach())   # the offset applied
    got = torch.autograd.grad(out.sum(), (ds, its))
    for g, w in zip(got, g_want):
        assert float(g) == pytest.approx(float(w), rel=5e-3)
