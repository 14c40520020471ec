"""The differentiable render against the JAX package's, on the CPU: the
scenes' helpers and the render's parts.

``torch.autograd.grad`` of the mean of ``render_radiance`` (or of
``render``) over a scene's data leaves, against ``jax.grad`` of the same
function over the same JAX ``Scene``: mass, spin, the camera's r, theta,
phi, fov and roll, and the NRS weights (each array's summed gradient).
Bar per leaf: |port - JAX| <= 5e-3 |JAX| + 1e-6 (tests/test_grad_kernel.py's
rel 5e-3 with an absolute floor of 1e-6). Scenes (``SCENES``) at 12x8
pixels, 48 steps, float32, spin 0.7, r = 30, theta = pi/2 - 0.25, fov 0.5;
their tests are tests/test_torch_ad_scenes.py (analytic, LUT, jets),
_ad_render.py (overlay, ``render(n_samples=2)``, the cotangent clip),
_ad_jitter.py and _ad_nrs.py (with the refinement pass); the files that
run JAX's gradients sort ahead of the others, so that the test workers
start them first.

The JAX references: ``jax.jit(jax.grad(...))`` run in a child process with
``XLA_FLAGS=--xla_cpu_max_isa=SSE4_2``, where XLA has no fused multiply-add
to contract into, so that the jitted gradient rounds as the op-by-op one
does and the port's plain versions do (on the default ISA XLA contracts
the march's multiply-adds, which moves the jitted gradients of chaotic
photon-ring pixels by up to 1e-2 on the small leaves). Where XLA's other
whole-program rewrites still move the value, the reference runs op by op
(``jax.disable_jit``, in process): the start offset's lattice hash, and the
NRS MLP's tanh; and the flagship's coarse steps (step rate 0.2 with the far
cap), where the jitted gradient departs from the op-by-op one wholesale,
are left to the card's oracle gates (chip_smoke.py phase 22(c)). This
file: the spectral tables' derivatives; the jets' plain VJP against
autograd through the plain march; the march under autograd; the refusals
of both packages; a scene of tensor leaves against the same scene of
numbers. The card's tests (tests/test_torch_gpu.py, without JAX) hold the
jets' gradient kernel and the K = 8 kernels against their plain versions.
About 30 s on one worker.
"""

import dataclasses as dc
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackhole_simulation_tpu.geometry.metrics import KS, Kerr as JKerr
from blackhole_simulation_tpu.models.nrs import nrs_init as j_nrs_init
from blackhole_simulation_tpu.render import Camera as JCamera
from blackhole_simulation_tpu.render import MarchConfig as JMarchConfig
from blackhole_simulation_tpu.render import Scene as JScene
from blackhole_simulation_tpu.render import render as j_render
from blackhole_simulation_tpu.render import render_radiance as j_render_radiance
from blackhole_simulation_tpu.render.pipeline import Features as JFeatures
from blackhole_simulation_tpu.render.post import PostParams as JPostParams
from blackhole_simulation_tpu.render.shading import (
    DiskParams as JDiskParams,
    build_disk_luts as j_build_disk_luts,
)
from blackhole_simulation_tpu_torch.ops.march import march_tile
from blackhole_simulation_tpu_torch.ops.march_grad import march_grad_kernel
from blackhole_simulation_tpu_torch.render.camera import Camera, camera_rays_u
from blackhole_simulation_tpu_torch.render.march import (
    MarchConfig,
    _march_inputs,
    march_rows,
)
from blackhole_simulation_tpu_torch.render.pipeline import (
    Scene,
    render,
    render_radiance,
    render_sample_scaled,
    scene_from_numpy,
)
from blackhole_simulation_tpu_torch.render.shading import (
    DiskParams,
    JetParams,
    build_disk_luts_t,
)

torch.set_num_threads(1)

THETA = float(jnp.pi / 2 - 0.25)
W, H, STEPS, SPIN = 12, 8, 48, 0.7
# name -> (MarchConfig overrides, Features, {fov, size, entry, n_samples,
# loss, nrs, post}); entry "render" is the tone-mapped render, loss "sum"
# the summed radiance (which lets the cotangent clip bind: the mean's
# cotangents stay below 1.0 on every ray).
SCENES = {
    "analytic": ({}, {}, {}),
    "lut": ({}, dict(spectral_lut=True), {}),
    "jets": ({}, dict(jets=True), {}),
    "start_jitter": (dict(start_jitter=0.5), {}, {}),
    "overlay": ({}, dict(shadow_overlay=True), dict(entry="render")),
    "nrs": ({}, dict(nrs_far_field=True), dict(fov=1.2, nrs=True)),
    # 16x12: the 12x8 frame's least band metric is 0.6002, so no pixel of
    # it is refined at refine_band 0.6; two of 16x12's are
    "refine": (dict(refine_band=0.6, refine_max_steps=256), {},
               dict(size=(16, 12))),
    "clip": (dict(cotangent_clip=1.0), {}, dict(loss="sum")),
    # bloom over every pixel: an exactly black pixel's tone map,
    # x^(1/2.2) at 0, has an infinite derivative (NaN gradients in both
    # packages); exposure 3 lifts the brightest pixels past the bloom
    # threshold, whose blur covers the 12x8 frame
    "samples": ({}, {}, dict(entry="render", n_samples=2,
                             post=dict(exposure=3.0))),
}
LEAVES = ("mass", "spin", "r", "theta", "phi", "fov", "roll")


def scenes(name, spin=SPIN, steps=STEPS):
    """The JAX scene and the port's, the same numbers; (cfg, feats, spec)
    from SCENES."""
    over, feats, spec = SCENES[name]
    fov = spec.get("fov", 0.5)
    w_, h_ = spec.get("size", (W, H))
    cfg = JMarchConfig(max_steps=steps, remat_every=0, **over)
    jfeats = JFeatures(**feats)
    nrs = j_nrs_init(0) if spec.get("nrs") else None
    post = JPostParams(**spec.get("post", {}))
    jcam = JCamera.create(r=30.0, theta=jnp.pi / 2 - 0.25, fov=fov,
                          width=w_, height=h_)
    js = JScene.create(mass=1.0, spin=spin, camera=jcam, march_cfg=cfg,
                       features=jfeats, nrs_params=nrs, post=post)
    ts = scene_from_numpy(
        mass=1.0, spin=spin,
        camera=dict(r=30.0, theta=THETA, phi=0.0, fov=fov, roll=0.0,
                    width=w_, height=h_),
        march_cfg=dc.asdict(cfg), features=dc.asdict(jfeats),
        disk=dc.asdict(js.disk), stars=dc.asdict(js.stars),
        post=dc.asdict(js.post), jet_params=dc.asdict(js.jet_params),
        nrs_params=None if nrs is None else [
            (np.asarray(w), np.asarray(b)) for w, b in nrs],
        device="cpu")
    return js, ts, spec


def _j_loss(spec):
    n = spec.get("n_samples", 1)
    red = jnp.sum if spec.get("loss") == "sum" else jnp.mean
    if spec.get("entry") == "render":
        return lambda s: red(j_render(s, n_samples=n))
    return lambda s: red(j_render_radiance(s))


def _j_leaves(g):
    out = [float(x) for x in (g.bh.mass, g.bh.spin, g.camera.r,
                              g.camera.theta, g.camera.phi, g.camera.fov,
                              g.camera.roll)]
    if g.nrs_params is not None:
        out += [float(jnp.sum(x)) for w_b in g.nrs_params for x in w_b]
    return out


def jax_grads_opbyop(name):
    """jax.grad of the scene's loss run op by op (in this process)."""
    js, _, spec = scenes(name)
    with jax.disable_jit():
        return _j_leaves(jax.grad(_j_loss(spec))(js))


class JaxChild:
    """A child process that runs ``script``'s ``__main__`` with ``args``
    under the references' XLA flags (no fused multiply-adds, see the module
    docstring) and prints one JSON line. It starts at once, so that the
    caller's own work overlaps it; ``result()`` waits for the line."""

    def __init__(self, script, *args):
        root = str(Path(__file__).resolve().parents[1])
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                            + " --xla_cpu_max_isa=SSE4_2").strip()
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [x for x in env.get("PYTHONPATH", "").split(os.pathsep)
                      if x])
        self.proc = subprocess.Popen(
            [sys.executable, str(Path(script).resolve()), *map(str, args)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, cwd=root)

    def result(self):
        out, err = self.proc.communicate(timeout=1200)
        assert self.proc.returncode == 0, err[-4000:]
        return json.loads(out.strip().splitlines()[-1])

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


def jax_grads_jitted(names):
    """{name: leaves' gradients} of jax.jit(jax.grad(loss)) for each scene,
    computed in a child process (``JaxChild`` of this file)."""
    child = JaxChild(__file__, *names)
    try:
        return child.result()
    finally:
        child.close()


def port_grads(name, scene=None):
    """The port's gradients of the scene's loss over its leaves (float64
    0-d tensors holding the scene's numbers) and the radiance."""
    _, ts, spec = scenes(name)
    ts = scene or ts
    t = lambda v: torch.tensor(float(v), dtype=torch.float64,
                               requires_grad=True)
    cam = ts.camera
    leaves = [t(ts.bh.mass), t(ts.bh.spin)] + [
        t(getattr(cam, k)) for k in LEAVES[2:]]
    sc = dc.replace(
        ts, bh=dc.replace(ts.bh, mass=leaves[0], spin=leaves[1]),
        camera=dc.replace(cam, **dict(zip(LEAVES[2:], leaves[2:]))))
    if ts.nrs_params is not None:
        nrs = tuple((w.clone().requires_grad_(), b.clone().requires_grad_())
                    for w, b in ts.nrs_params)
        leaves += [x for w_b in nrs for x in w_b]
        sc = dc.replace(sc, nrs_params=nrs)
    n = spec.get("n_samples", 1)
    img = (render(sc, n_samples=n, device="cpu")
           if spec.get("entry") == "render"
           else render_radiance(sc, device="cpu"))
    loss = img.sum() if spec.get("loss") == "sum" else img.mean()
    grads = torch.autograd.grad(loss, leaves)
    return [float(g.sum()) for g in grads], img.detach()


def check_leaves(got, want, skip=()):
    """Each leaf's gradient within 5e-3 relative, 1e-6 absolute."""
    assert len(got) == len(want)
    bad = []
    for i, (g, w) in enumerate(zip(got, want)):
        assert math.isfinite(g), (i, got)
        if i in skip:
            continue
        if not abs(g - w) <= 5e-3 * abs(w) + 1e-6:
            bad.append((LEAVES[i] if i < len(LEAVES) else f"nrs{i - 7}", g, w))
    assert not bad, bad


# ---------------------------------------------------------------------------
# The spectral disk's tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spin", [0.5, 0.9, 0.999])
def test_disk_luts_and_their_derivatives_match_jax(spin):
    """build_disk_luts_t's four tables in float64 against JAX's
    build_disk_luts, and the derivatives of the summed r_grid and t_shape
    in mass and spin against jax.grad (rel 1e-6): the tables' spin term
    that the AD inverse step needs."""
    disk = DiskParams()

    def j_tables(m, a):
        return j_build_disk_luts(JKerr(mass=m, spin=a, chart=KS),
                                 JDiskParams(), jnp.float64)

    m64 = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    a64 = torch.tensor(spin, dtype=torch.float64, requires_grad=True)
    got = build_disk_luts_t(m64, a64, disk, dtype=torch.float64)
    want = j_tables(jnp.float64(1.0), jnp.float64(spin))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-6, atol=1e-12)
    for k in (0, 1):
        jg = jax.grad(lambda m, a: jnp.sum(j_tables(m, a)[k]),
                      argnums=(0, 1))(jnp.float64(1.0), jnp.float64(spin))
        tg = torch.autograd.grad(got[k].sum(), (m64, a64), retain_graph=True)
        for t_, j_ in zip(tg, jg):
            assert float(t_) == pytest.approx(float(j_), rel=1e-6)
            assert abs(float(j_)) > 1.0


def test_spectral_tables_follow_the_spin_in_the_graph():
    """A staged spectral composite under autograd builds its tables from
    the spin it is differentiated in; without autograd it reads the cache
    (tensors without a graph)."""
    from blackhole_simulation_tpu_torch.render.shading import (
        disk_luts,
        disk_luts_for,
    )

    disk = DiskParams()
    a = torch.tensor(0.9, requires_grad=True)
    m = torch.tensor(1.0)
    luts = disk_luts_for(m, a, disk, "cpu")
    assert luts[0].requires_grad and luts[1].requires_grad
    with torch.no_grad():
        cached = disk_luts_for(m, a, disk, "cpu")
    assert cached is disk_luts(1.0, float(a.detach()), disk,
                               torch.device("cpu"))
    assert not any(x.requires_grad for x in cached)
    for x, y in zip(luts, cached):
        assert torch.equal(x.detach(), y)


# ---------------------------------------------------------------------------
# The jets' VJP, and the march under autograd
# ---------------------------------------------------------------------------

JET_CAM = Camera.create(r=30.0, theta=0.9, fov=1.0, width=24, height=16)


@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_jets_vjp_matches_autograd_through_the_plain_march(clip):
    """The gradient kernel's plain version with the jets (the jet
    radiance's cotangent entering every live step's VJP) against
    torch.autograd straight through the plain jets march (march_tile with
    jets), with every output's cotangent seeded: rtol 1e-5. A camera that
    looks down the jets' cone puts its emission on a third of the rays."""
    cfg = MarchConfig(max_steps=64, cotangent_clip=clip)
    jets = JetParams()
    m, a = torch.tensor(1.0), torch.tensor(np.float32(0.9))
    yt0, thr, m, a, r_h, r_ph = _march_inputs(camera_rays_u(JET_CAM, m, a),
                                               m, a, cfg, None)
    n, k = yt0.shape[1], cfg.max_crossings
    rng = np.random.default_rng(4)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    ct_fin, ct_cr, ct_cp, ct_ct, ct_rmin = f(8, n), f(k, n), f(k, n), f(k, n), f(n)
    ct_fin[4] = 0.0
    ct_jet = f(3, n) * 10.0

    leaves = [x.clone().requires_grad_() for x in (yt0, m, a, r_h, r_ph)]
    y, mm, aa, rh, rph = leaves
    t, r, u, ph, pr, pu, hit, steps, cr, cp, ct, nc, rmin, jet = march_tile(
        mm, aa, rh, rph, thr, (y[0], y[1], y[2], y[3], y[5], y[6], y[7]), cfg,
        jets=jets)
    assert int((jet.abs().sum(0) > 0).sum()) > n // 4
    out = torch.stack([t, r, u, ph, y[4], pr, pu, y[7]])
    loss = ((out * ct_fin).sum() + (cr * ct_cr).sum() + (cp * ct_cp).sum()
            + (ct * ct_ct).sum() + (rmin * ct_rmin).sum()
            + (jet * ct_jet).sum())
    ref = torch.autograd.grad(loss, leaves)

    got = march_grad_kernel(yt0, thr, m, a, r_h, r_ph, cfg, ct_fin, ct_cr,
                            ct_cp, ct_ct, ct_rmin, rmin.detach(), ct_jet,
                            jets)
    ref_y = ref[0].clone()
    ref_y[4] = 0.0
    assert bool(torch.isfinite(got[0]).all())
    np.testing.assert_allclose(got[0].numpy(), ref_y.numpy(), rtol=1e-5,
                               atol=1e-5 * float(ref_y.abs().max()))
    for g, rr in zip(got[1:], ref[1:]):
        assert float(g) == pytest.approx(float(rr), rel=1e-5)
    # the jets' term is there: without it the rays' cotangents differ
    plain = march_grad_kernel(yt0, thr, m, a, r_h, r_ph, cfg, ct_fin, ct_cr,
                              ct_cp, ct_ct, ct_rmin, rmin.detach())
    assert not torch.allclose(plain[0], got[0], rtol=1e-3)


def test_march_rows_under_autograd_takes_the_jets_and_the_offset():
    """march_rows differentiable: the rays' cotangents finite on every ray
    (dead rays add nothing from the jets' term), the jet radiance carries a
    gradient, and the start offset moves it."""
    m, a = torch.tensor(1.0), torch.tensor(0.9, requires_grad=True)
    rays = camera_rays_u(JET_CAM, m, a)
    for jitter in (0.0, 0.5):
        cfg = MarchConfig(max_steps=64, start_jitter=jitter)
        r = rays.detach().clone().requires_grad_()
        rows = march_rows(r, m, a, cfg, jets=JetParams())
        loss = rows.jet_radiance.sum() + rows.state_u[1].mean()
        g_r, g_a = torch.autograd.grad(loss, (r, a))
        assert bool(torch.isfinite(g_r).all()) and math.isfinite(float(g_a))
        dead = (rows.steps == 0) & (rows.hit != 0)
        assert bool((g_r[:, dead] == 0).all())


# ---------------------------------------------------------------------------
# What both packages refuse, and tensor leaves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["staged", "fused"])
def test_kernel_scenes_under_grad_raise_in_both(kind):
    """A use_pallas scene without jets (staged) and a fused one: jax.grad
    raises (the Pallas kernels have no VJP) and so does the port, naming
    the JAX behaviour; without grad both render."""
    over = dict(use_pallas=True, fused=kind == "fused")
    js, ts, _ = scenes("analytic", steps=8)
    js = dc.replace(js, march_cfg=dc.replace(js.march_cfg, **over))
    ts = dc.replace(ts, march_cfg=dc.replace(ts.march_cfg, **over))
    with pytest.raises(Exception):
        jax.grad(lambda s: jnp.mean(j_render_radiance(s)))(js)
    a = torch.tensor(SPIN, requires_grad=True)
    sc = dc.replace(ts, bh=dc.replace(ts.bh, spin=a))
    with pytest.raises(NotImplementedError, match="jax.grad raises"):
        render_radiance(sc, device="cpu")
    with pytest.raises(NotImplementedError, match="jax.grad raises"):
        render(sc, device="cpu")
    with torch.no_grad():
        assert bool(torch.isfinite(render_radiance(sc, device="cpu")).all())
    if kind == "staged":
        with pytest.raises(NotImplementedError, match="no VJP"):
            render_sample_scaled(sc, device="cpu")


def test_tensor_leaves_render_bit_equal_to_numbers():
    """Every data leaf a float64 0-d tensor holding the scene's number: the
    same image bit for bit, on the staged, fused and overlay paths, with
    and without grad."""
    _, ts, _ = scenes("lut", steps=24)
    t = lambda v, g: torch.tensor(float(v), dtype=torch.float64,
                                  requires_grad=g)
    for over, feats in (({}, {}), (dict(use_pallas=True, fused=True), {}),
                        ({}, dict(shadow_overlay=True, spectral_lut=True))):
        base = dc.replace(ts, march_cfg=dc.replace(ts.march_cfg, **over),
                          features=dc.replace(ts.features, **feats))
        want = render(base, device="cpu")
        for grad in (False, over == {}):
            cam = base.camera
            sc = dc.replace(
                base, bh=dc.replace(base.bh, mass=t(1.0, grad),
                                    spin=t(SPIN, grad)),
                camera=dc.replace(cam, **{k: t(getattr(cam, k), grad)
                                          for k in LEAVES[2:]}))
            got = render(sc, device="cpu")
            assert torch.equal(got.detach(), want), (over, feats, grad)


def test_scene_leaves_and_create():
    """Scene.create and Camera.create keep tensor leaves; the host camera
    holds numbers."""
    a = torch.tensor(0.5, requires_grad=True)
    cam = Camera.create(r=torch.tensor(40.0), width=8, height=4)
    sc = Scene.create(mass=1.0, spin=a, camera=cam)
    assert sc.bh.spin is a and sc.camera.r is cam.r
    assert sc.leaves()[:3] == [1.0, a, cam.r]
    host = cam.host()
    assert host.r == 40.0 and isinstance(host.r, float)
    assert Camera.create(width=8, height=4).host() == Camera.create(
        width=8, height=4)


if __name__ == "__main__":
    # The child process of jax_grads_jitted: one JSON line of each named
    # scene's jitted gradients.
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    out = {}
    for name in sys.argv[1:]:
        js, _, spec = scenes(name)
        out[name] = _j_leaves(jax.jit(jax.grad(_j_loss(spec)))(js))
    print(json.dumps(out))
