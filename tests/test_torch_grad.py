"""The port's differentiable march against JAX's, on the CPU.

``march_rows_ad`` (the march kernel's plain version forward, the gradient
kernel's plain version ``ops/march_grad.march_grad`` backward) against
``jax.grad`` through the JAX package's jnp ``march_rows``, with
tests/test_grad_kernel.py's loss, scene and bars. The JAX gradients are
jitted here (XLA's whole-program rounding moves them by a few 1e-3 at most
on this scene); tests/test_torch_grad_eager.py holds the two cases where
that reaches the 5e-3 bar against JAX run op by op. Also: the plain
``march_grad`` against ``torch.autograd`` straight through the plain
``march_tile`` (rtol 1e-5: the checkpoint, replay and injection
bookkeeping).
"""

import dataclasses as dc
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackhole_simulation_tpu.geometry.metrics import KS, Kerr
from blackhole_simulation_tpu.render import Camera as JCamera
from blackhole_simulation_tpu.render import MarchConfig as JMarchConfig
from blackhole_simulation_tpu.render.camera import camera_rays_u as j_rays
from blackhole_simulation_tpu_torch.geometry.metrics import (
    event_horizon_t,
    photon_sphere_t,
)
from blackhole_simulation_tpu_torch.ops.march import march_tile
from blackhole_simulation_tpu_torch.ops.march_grad import (
    march_grad,
    march_grad_kernel,
)
from blackhole_simulation_tpu_torch.render.camera import Camera, camera_rays_u
from blackhole_simulation_tpu_torch.render.march import (
    MarchConfig,
    march_rows_ad,
    precull_threshold,
)

jmarch = importlib.import_module("blackhole_simulation_tpu.render.march")

torch.set_num_threads(1)

JCAM = JCamera.create(r=30.0, theta=jnp.pi / 2 - 0.25, fov=0.5, width=48,
                      height=32)
CAM = Camera.create(r=30.0, theta=math.pi / 2 - 0.25, fov=0.5, width=48,
                    height=32)
CFG = dict(max_steps=48, shadow_precull=False, remat_every=0)


def _j_loss(spin, cfg, mass=1.0):
    bh = Kerr(mass=jnp.asarray(mass, jnp.float32), spin=spin, chart=KS)
    rows = jmarch.march_rows(j_rays(JCAM, bh, dtype=jnp.float32), bh, cfg)
    return (jnp.mean(rows.state_u[1]) + 0.1 * jnp.mean(rows.cross_r)
            + 0.05 * jnp.mean(rows.cross_phi) + 0.02 * jnp.mean(rows.cross_t)
            + 0.01 * jnp.mean(jnp.exp(-rows.r_min_ph)))


def j_grad_fn(**cfg):
    """jax.grad of test_grad_kernel.py's loss in (spin, mass), jitted."""
    c = JMarchConfig(**{**CFG, **cfg})
    g = jax.jit(jax.grad(lambda s, mm: _j_loss(s, c, mm), argnums=(0, 1)))
    return lambda spin, mass=1.0: tuple(
        float(x) for x in g(jnp.float32(spin), jnp.float32(mass)))


@pytest.fixture(scope="module")
def j_param_grads():
    """The jitted JAX (d/d spin, d/d mass) at a = 0.9 and 0.6, one compile."""
    g = j_grad_fn()
    return {a: g(a) for a in (0.9, 0.6)}


def t_grads(spin, mass=1.0, **cfg):
    """(loss, d/d spin, d/d mass) of the same loss through march_rows_ad."""
    m = torch.tensor(mass, requires_grad=True)
    a = torch.tensor(np.float32(spin), requires_grad=True)
    rows = march_rows_ad(camera_rays_u(CAM, m, a), m, a,
                         MarchConfig(**{**CFG, **cfg}))
    loss = (rows.state_u[1].mean() + 0.1 * rows.cross_r.mean()
            + 0.05 * rows.cross_phi.mean() + 0.02 * rows.cross_t.mean()
            + 0.01 * torch.exp(-rows.r_min_ph).mean())
    loss.backward()
    return float(loss.detach()), float(a.grad), float(m.grad)


def _rel(x, ref):
    return abs(x - ref) / max(abs(ref), 1e-9)


def test_dspin_matches_jax_ad_a09(j_param_grads):
    _, g, _ = t_grads(0.9)
    ref = j_param_grads[0.9][0]
    assert math.isfinite(g)
    assert _rel(g, ref) < 5e-3, (g, ref)


def test_dmass_matches_jax_ad(j_param_grads):
    _, _, g = t_grads(0.6)
    ref = j_param_grads[0.6][1]
    assert math.isfinite(g)
    assert _rel(g, ref) < 2e-2, (g, ref)


def test_cotangent_clip_matches_jax():
    _, g, _ = t_grads(0.9, cotangent_clip=0.05)
    ref = j_grad_fn(cotangent_clip=0.05)(0.9)[0]
    assert math.isfinite(g)
    assert _rel(g, ref) < 2e-2, (g, ref)
    _, g_unclipped, _ = t_grads(0.9)
    assert abs(g - g_unclipped) > 1e-9


def test_dray_cotangents_match_jax():
    jbh = Kerr(mass=jnp.float32(1.0), spin=jnp.float32(0.7), chart=KS)
    m, a = torch.tensor(1.0), torch.tensor(np.float32(0.7))
    rays = camera_rays_u(CAM, m, a)

    def j_loss(r):
        rows = jmarch.march_rows(r, jbh, JMarchConfig(**CFG))
        return jnp.mean(rows.state_u[1]) + 0.1 * jnp.mean(rows.cross_r)

    ref = np.asarray(jax.jit(jax.grad(j_loss))(jnp.asarray(rays.numpy())))
    r = rays.clone().requires_grad_()
    rows = march_rows_ad(r, m, a, MarchConfig(**CFG))
    (rows.state_u[1].mean() + 0.1 * rows.cross_r.mean()).backward()
    ker = r.grad.numpy()
    assert np.isfinite(ker).all()
    d = np.abs(ref - ker)
    assert np.quantile(d / (np.abs(ref) + 1e-6), 0.95) < 1e-2


def _random_cotangents(n, k, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    ct_fin = f(8, n)
    ct_fin[4] = 0.0
    return ct_fin, f(k, n), f(k, n), f(k, n), f(n)


@pytest.mark.parametrize("clip", [0.0, 0.05])
@pytest.mark.parametrize("precull", [False, True])
def test_march_grad_matches_autograd_through_march_tile(precull, clip):
    cfg = MarchConfig(**{**CFG, "shadow_precull": precull,
                         "cotangent_clip": clip})
    m, a = torch.tensor(1.0), torch.tensor(np.float32(0.9))
    r_h, r_ph = event_horizon_t(m, a), photon_sphere_t(m, a)
    yt0 = camera_rays_u(CAM, m, a)
    thr = precull_threshold(yt0, m, a, cfg)
    n, k = yt0.shape[1], cfg.max_crossings
    ct_fin, ct_cr, ct_cp, ct_ct, ct_rmin = _random_cotangents(n, k, 3)

    # autograd straight through the plain march
    leaves = [x.clone().requires_grad_() for x in (yt0, m, a, r_h, r_ph)]
    y, mm, aa, rh, rph = leaves
    t, r, u, ph, pr, pu, hit, steps, cr, cp, ct, nc, rmin, _ = march_tile(
        mm, aa, rh, rph, thr, (y[0], y[1], y[2], y[3], y[5], y[6], y[7]), cfg)
    out = torch.stack([t, r, u, ph, y[4], pr, pu, y[7]])
    loss = ((out * ct_fin).sum() + (cr * ct_cr).sum() + (cp * ct_cp).sum()
            + (ct * ct_ct).sum() + (rmin * ct_rmin).sum())
    ref = torch.autograd.grad(loss, leaves)

    got = march_grad_kernel(yt0, thr, m, a, r_h, r_ph, cfg, ct_fin, ct_cr,
                            ct_cp, ct_ct, ct_rmin, rmin.detach())
    ref_y = ref[0].clone()
    ref_y[4] = 0.0   # the p_t row is a constant of the march
    np.testing.assert_allclose(got[0].numpy(), ref_y.numpy(), rtol=1e-5,
                               atol=1e-5 * float(ref_y.abs().max()))
    for g, rr in zip(got[1:], ref[1:]):
        assert float(g) == pytest.approx(float(rr), rel=1e-5)


def test_wrapper_takes_plain_version_only_for_cpu_tensors():
    cfg = MarchConfig(**CFG)
    m, a = torch.tensor(1.0), torch.tensor(np.float32(0.9))
    r_h, r_ph = event_horizon_t(m, a), photon_sphere_t(m, a)
    yt0 = camera_rays_u(CAM, m, a)[:, :64]
    thr = precull_threshold(yt0, m, a, cfg)
    cts = _random_cotangents(64, 4, 5)
    rmin = torch.rand(64)
    before = march_grad_kernel.launches
    a_out = march_grad_kernel(yt0, thr, m, a, r_h, r_ph, cfg, *cts, rmin)
    b_out = march_grad(yt0, thr, m, a, r_h, r_ph, cfg, *cts, rmin)
    assert march_grad_kernel.launches == before
    for x, y in zip(a_out, b_out):
        assert torch.equal(x, y)
    # float32 and float64 rays take the kernel (or its plain version);
    # any other dtype raises
    with pytest.raises(ValueError):
        march_grad_kernel(yt0.half(), thr, m, a, r_h, r_ph, cfg, *cts, rmin)


def test_wrappers_record_their_arguments():
    """With ``record`` lists set, one differentiable march leaves each
    wrapper's arguments there: the march's replay to the same rows, the
    gradient's the loss's own cotangents."""
    from blackhole_simulation_tpu_torch.ops.pallas_march import march_u

    m, a = torch.tensor(1.0), torch.tensor(np.float32(0.9), requires_grad=True)
    march_u.record, march_grad_kernel.record = [], []
    try:
        rows = march_rows_ad(camera_rays_u(CAM, m, a)[:, :64], m, a,
                             MarchConfig(**CFG))
        (rows.state_u[1].mean() + 0.1 * rows.cross_r.mean()).backward()
        m_rec, g_rec = march_u.record, march_grad_kernel.record
    finally:
        march_u.record = march_grad_kernel.record = None
    assert len(m_rec) == 1 and len(g_rec) == 1
    # march_u's arguments end with the jets (none here), the gradient
    # kernel's with the jet radiance's cotangent and the jets (none here)
    assert len(m_rec[0]) == 8 and m_rec[0][7] is None and len(g_rec[0]) == 15
    assert g_rec[0][13] is None and g_rec[0][14] is None
    with torch.no_grad():
        assert torch.equal(march_u(*m_rec[0])[0], rows.state_u)
    # the cotangents the loss sent into the march's outputs
    ct_fin, ct_cr = g_rec[0][7], g_rec[0][8]
    assert torch.allclose(ct_fin[1], torch.full((64,), 1 / 64))
    assert torch.allclose(ct_cr, torch.full((4, 64), 0.1 / (4 * 64)))
    assert torch.equal(g_rec[0][12], rows.r_min_ph.detach())
    assert march_u.record is None and march_grad_kernel.record is None
