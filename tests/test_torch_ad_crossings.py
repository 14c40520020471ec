"""More than four equator crossings per ray (``MarchConfig.max_crossings``
5 and 8), as the JAX kernels take any number, on the CPU.

Rays that record more than four crossings are near-critical: they wind
around the photon sphere before they fall in or escape. The rays here are
one pixel's, at sub-pixel offsets about its critical point (found by
bisecting the offset on the hit code at this configuration: 64x64, a =
0.9, 512 steps at step rate 0.05), and record 3 to 6 crossings. Against
the JAX package's jnp twins, at the reference's parity bars
(tests/test_pallas.py:81-98; test_fused.py's p99 < 1e-4, mean < 1e-5):

* the march (``march_u``'s plain version) against JAX's jnp
  ``march_rows`` run op by op: identical hit, steps and crossing counts,
  atol 1e-4 on the states and every slot (K = 5 is K = 8's first five
  slots, its count capped, as JAX's march records them);
* the fused render's plain version (``render_planes``) and the staged
  render, each against JAX's staged ``render_sample`` at that pixel's
  critical offset, jitted in a child process without fused multiply-adds
  (as tests/test_torch_render_ad.py's references);
* the march's gradient (``march_grad``, the gradient kernel's plain
  version, through ``march_rows`` under autograd) against ``jax.grad`` of
  JAX's jnp ``march_rows`` in the same child: rel 5e-3 on the spin's, and
  tests/test_torch_grad.py's bar on the rays' cotangents (95th percentile
  of |d| / (|ref| + 1e-6) < 1e-2); and against autograd straight through
  the plain march at every slot (rtol 1e-5).

The card holds each of the three kernels at K = 8 against its plain
version (tests/test_torch_gpu.py; chip_smoke.py phase 22(d)). About 90 s
on one worker.
"""

import dataclasses as dc
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackhole_simulation_tpu.geometry.metrics import KS, Kerr as JKerr
from blackhole_simulation_tpu.render import Camera as JCamera
from blackhole_simulation_tpu.render import MarchConfig as JMarchConfig
from blackhole_simulation_tpu.render import Scene as JScene
from blackhole_simulation_tpu.render.pipeline import Features as JFeatures
from blackhole_simulation_tpu.render.pipeline import (
    render_sample as j_render_sample,
)
from blackhole_simulation_tpu_torch.ops.march import march_tile
from blackhole_simulation_tpu_torch.ops.march_grad import march_grad
from blackhole_simulation_tpu_torch.ops.render import render_planes
from blackhole_simulation_tpu_torch.render.camera import Camera, camera_rays_u
from blackhole_simulation_tpu_torch.render.march import (
    MarchConfig,
    _march_inputs,
    march_rows,
)
from blackhole_simulation_tpu_torch.render.pipeline import (
    kernel_inputs,
    render_sample,
    scene_from_numpy,
)
from test_torch_render_ad import JaxChild

jmarch = importlib.import_module("blackhole_simulation_tpu.render.march")

torch.set_num_threads(1)

THETA = float(jnp.pi / 2 - 0.25)
SIZE, SPIN = 64, 0.9
PIX = 32 * SIZE + 59
# The pixel's critical sub-pixel offset along x at this configuration
# (the bisection's last interval is [J_CRIT, J_CRIT + 3e-14]), and offsets
# 1e-2 to 1e-8 to either side of it.
J_CRIT = 0.490541473031044
JITTERS = sorted({J_CRIT - 10.0 ** -k for k in range(2, 9)}
                 | {J_CRIT + 3e-14 + 10.0 ** -k for k in range(2, 9)}
                 | {J_CRIT, J_CRIT + 3e-14})
CFG = dict(max_steps=512, step_rate=0.05, remat_every=0)
CAM = Camera.create(r=30.0, theta=THETA, fov=0.5, width=SIZE, height=SIZE)


def _rays():
    m, a = torch.tensor(1.0), torch.tensor(np.float32(SPIN))
    return torch.cat([camera_rays_u(CAM, m, a, pix_ids=torch.tensor([PIX]),
                                    jitter=(j, 0.0)) for j in JITTERS], 1)


@pytest.fixture(scope="module")
def jax_march():
    jbh = JKerr(mass=jnp.float32(1.0), spin=jnp.float32(SPIN), chart=KS)
    with jax.disable_jit():
        ref = jmarch.march_rows(jnp.asarray(_rays().numpy()), jbh,
                                JMarchConfig(max_crossings=8, **CFG))
    return {k: np.asarray(getattr(ref, k)) for k in (
        "state_u", "hit", "steps", "cross_r", "cross_phi", "cross_t",
        "n_crossings", "r_min_ph")}


@pytest.mark.parametrize("k", [5, 8])
def test_march_records_k_crossings_as_jax(jax_child, jax_march, k):
    m, a = torch.tensor(1.0), torch.tensor(np.float32(SPIN))
    out = march_rows(_rays(), m, a, MarchConfig(max_crossings=k, **CFG))
    ref = dict(jax_march)
    ref["n_crossings"] = np.minimum(ref["n_crossings"], k)
    for name in ("cross_r", "cross_phi", "cross_t"):
        ref[name] = ref[name][:k]
    assert out.cross_r.shape == (k, len(JITTERS))
    for name in ("hit", "steps", "n_crossings"):
        np.testing.assert_array_equal(getattr(out, name).numpy(), ref[name],
                                      name)
    for name in ("state_u", "cross_r", "cross_phi", "cross_t", "r_min_ph"):
        np.testing.assert_allclose(getattr(out, name).numpy(), ref[name],
                                   atol=1e-4, err_msg=name)
    nc = out.n_crossings.numpy()
    assert nc.max() == min(k, 6) and (nc > 4).sum() >= 4
    assert (out.cross_r.numpy()[4][nc > 4] > 1.0).all()


def _scenes(k):
    cfg = JMarchConfig(max_crossings=k, **CFG)
    jcam = JCamera.create(r=30.0, theta=THETA, fov=0.5, width=SIZE,
                          height=SIZE)
    js = JScene.create(mass=1.0, spin=SPIN, camera=jcam, march_cfg=cfg,
                       features=JFeatures())
    ts = scene_from_numpy(
        mass=1.0, spin=SPIN,
        camera=dict(r=30.0, theta=THETA, phi=0.0, fov=0.5, roll=0.0,
                    width=SIZE, height=SIZE),
        march_cfg=dc.asdict(cfg), features=dc.asdict(js.features),
        disk=dc.asdict(js.disk), stars=dc.asdict(js.stars),
        post=dc.asdict(js.post))
    return js, ts


@pytest.fixture(scope="module")
def jax_child():
    """The child process's JAX references (``__main__`` below): the staged
    samples and the march gradients at K = 5 and 8. Started by the first
    test, so that the op-by-op march overlaps it."""
    child = JaxChild(__file__)
    result = {}

    def get():
        if not result:
            result.update(child.result())
        return result

    yield get
    child.close()


@pytest.mark.parametrize("k", [5, 8])
def test_render_takes_k_crossings_as_jax(jax_child, k):
    """The staged render and the fused render's plain version at the
    critical pixel's offset, against JAX's staged sample: the critical
    pixel's five or more crossings composited."""
    js, ts = _scenes(k)
    jitter = (J_CRIT, 0.0)
    ref = np.asarray(jax_child()["render"][str(k)], np.float32)
    staged = render_sample(ts, np.asarray(jitter, np.float32), "cpu")
    fused_scene = dc.replace(ts, march_cfg=dc.replace(
        ts.march_cfg, use_pallas=True, fused=True))
    row, st = kernel_inputs(fused_scene, np.asarray(jitter, np.float32),
                            "cpu")
    assert st.cfg.max_crossings == k
    fused = render_planes(row, st)
    for out in (staged, fused):
        got = out.permute(1, 2, 0).reshape(-1, 3).numpy()
        assert np.isfinite(got).all()
        d = np.abs(got - ref)
        assert np.percentile(d, 99) < 1e-4 and d.mean() < 1e-5
    # fewer slots composite fewer layers at the critical pixel
    if k == 8:
        _, ts4 = _scenes(4)
        four = render_sample(ts4, np.asarray(jitter, np.float32), "cpu")
        assert not torch.equal(four.reshape(3, -1)[:, PIX],
                               staged.reshape(3, -1)[:, PIX])


def _loss_weights(k, n):
    rng = np.random.default_rng(k)
    return [torch.from_numpy(rng.uniform(0.5, 1.5, s).astype(np.float32))
            for s in ((8, n), (k, n), (k, n), (k, n), (n,))]


def _port_loss(rows, w):
    return ((rows.state_u * w[0]).sum() + (rows.cross_r * w[1]).sum()
            + 1e-2 * (rows.cross_phi * w[2]).sum()
            + 1e-3 * (rows.cross_t * w[3]).sum() + (rows.r_min_ph * w[4]).sum())


@pytest.mark.parametrize("k", [5, 8])
def test_march_gradient_takes_k_crossings(k):
    """The plain gradient through march_rows at K slots against autograd
    straight through the plain march (rtol 1e-5)."""
    cfg = MarchConfig(max_crossings=k, **CFG)
    m, a = torch.tensor(1.0), torch.tensor(np.float32(SPIN))
    yt0, thr, m, a, r_h, r_ph = _march_inputs(_rays(), m, a, cfg, None)
    n = yt0.shape[1]
    w = _loss_weights(k, n)
    leaves = [x.clone().requires_grad_() for x in (yt0, m, a, r_h, r_ph)]
    y, mm, aa, rh, rph = leaves
    t, r, u, ph, pr, pu, hit, steps, cr, cp, ct, nc, rmin, _ = march_tile(
        mm, aa, rh, rph, thr, (y[0], y[1], y[2], y[3], y[5], y[6], y[7]), cfg)
    state = torch.stack([t, r, u, ph, y[4], pr, pu, y[7]])
    ct_fin = w[0].clone()
    ct_fin[4] = 0.0
    loss = ((state * ct_fin).sum() + (cr * w[1]).sum()
            + 1e-2 * (cp * w[2]).sum() + 1e-3 * (ct * w[3]).sum()
            + (rmin * w[4]).sum())
    ref = torch.autograd.grad(loss, leaves)
    got = march_grad(yt0, thr, m, a, r_h, r_ph, cfg, ct_fin, w[1],
                     1e-2 * w[2], 1e-3 * w[3], w[4], rmin.detach())
    ref_y = ref[0].clone()
    ref_y[4] = 0.0
    np.testing.assert_allclose(got[0].numpy(), ref_y.numpy(), rtol=1e-5,
                               atol=1e-5 * float(ref_y.abs().max()))
    for g, rr in zip(got[1:], ref[1:]):
        assert float(g) == pytest.approx(float(rr), rel=1e-5)
    assert int(nc.max()) > 4


@pytest.mark.parametrize("k", [5, 8])
def test_march_gradient_matches_jax(jax_child, k):
    cfg = MarchConfig(max_crossings=k, **CFG)
    m = torch.tensor(1.0)
    a = torch.tensor(np.float32(SPIN), requires_grad=True)
    rays = _rays().requires_grad_()
    rows = march_rows(rays, m, a, cfg)
    g_rays, g_a = torch.autograd.grad(
        _port_loss(rows, _loss_weights(k, rays.shape[1])), (rays, a))
    want = jax_child()["grad"][str(k)]
    assert float(g_a) == pytest.approx(want["spin"], rel=5e-3)
    ref = np.asarray(want["rays"])
    got = g_rays.numpy()
    assert np.isfinite(got).all() and np.abs(ref).max() > 1.0
    d = np.abs(ref - got)
    assert np.quantile(d / (np.abs(ref) + 1e-6), 0.95) < 1e-2


if __name__ == "__main__":
    # The child process of jax_child: one JSON line of the staged samples
    # at the critical offset and the march gradients, at K = 5 and 8.
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    rays = jnp.asarray(_rays().detach().numpy())
    jitter = jnp.asarray((J_CRIT, 0.0), jnp.float32)
    out = {"render": {}, "grad": {}}
    for k in (5, 8):
        js, _ = _scenes(k)
        out["render"][str(k)] = np.asarray(jax.jit(
            lambda s: j_render_sample(s, jitter, jnp.float32))(js),
            np.float64).tolist()
        w = [jnp.asarray(x.numpy()) for x in _loss_weights(k, rays.shape[1])]

        def loss(a, y, k=k, w=w):
            bh = JKerr(mass=jnp.float32(1.0), spin=a, chart=KS)
            rows = jmarch.march_rows(y, bh,
                                     JMarchConfig(max_crossings=k, **CFG))
            return (jnp.sum(rows.state_u * w[0])
                    + jnp.sum(rows.cross_r * w[1])
                    + 1e-2 * jnp.sum(rows.cross_phi * w[2])
                    + 1e-3 * jnp.sum(rows.cross_t * w[3])
                    + jnp.sum(rows.r_min_ph * w[4]))

        g_a, g_y = jax.jit(jax.grad(loss, argnums=(0, 1)))(
            jnp.float32(SPIN), rays)
        out["grad"][str(k)] = {"spin": float(g_a),
                               "rays": np.asarray(g_y, np.float64).tolist()}
    print(json.dumps(out))
