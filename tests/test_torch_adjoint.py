"""The hand-written reverse adjoint of one march step, on the CPU.

``ops/march_adjoint.py`` mirrors ``csrc/march_adjoint.cuh`` (the gradient
kernel's per-step VJP) function for function. Here it is held against two
references on the same seeded inputs:

- ``torch.autograd.grad`` through ``ops/march.py::march_step_rows`` (the
  plain step), in float64 to rel 1e-10 and in float32 to rel 1e-5;
- ``jax.vjp`` of the JAX package's ``pallas_grad.make_composite`` (the
  step the Pallas gradient kernel differentiates), run op by op under
  ``jax.disable_jit``, in float32 to rel 1e-5.

Each tolerance is per element, with an absolute floor of the same size
times the largest |reference| of that input row (float32 rounding of two
association orders of the same sums). The cases: states of a short seeded
march, a tie of each of jmax, jmin and jclip (split half and half), a
renormalization step with and without a real root, crossing steps, a
clipped carry, and the renormalization alone at a double root of its
quadratic. The sanity-freeze step with a zero cotangent is where the
kernel's rule (a zero cotangent contributes nothing) and reverse-mode
autograd part: the adjoint passes the carry through, both references give
NaN (0 times an infinite partial).
"""

import dataclasses as dc
import functools
import math
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackhole_simulation_tpu.ops.pallas_grad import make_composite
from blackhole_simulation_tpu.render import MarchConfig as JMarchConfig
from blackhole_simulation_tpu_torch.ops.ks_kernel import ks_renormalize_pr
from blackhole_simulation_tpu_torch.ops.march import march_step_rows
from blackhole_simulation_tpu_torch.ops.march_adjoint import (
    clip_carry,
    march_step_vjp,
    renormalize_pr_vjp,
)
from blackhole_simulation_tpu_torch.render.camera import Camera, camera_rays_u
from blackhole_simulation_tpu_torch.render.march import (
    HIT_NONE,
    MarchConfig,
    _march_inputs,
    clip_rows,
)

torch.set_num_threads(1)

# The training step's MarchConfig (the flagship's), cut to 40 steps, and the
# JAX package's defaults (two midpoint rounds, no far-field cap).
CFGS = {
    "flagship": dict(max_steps=40, step_rate=0.2, far_step_cap_rate=0.4,
                     far_boost_radius=20.0, midpoint_iters=1),
    "default": dict(max_steps=40),
}
TOL = {torch.float64: 1e-10, torch.float32: 1e-5}


@functools.cache
def _march(cfg_name):
    """Pre-step states of a seeded float64 march of 16x8 camera rays:
    {step: (rows (11, N) float64 numpy of the live rays, their crossing
    counts, their crossed flags)}."""
    cfg = MarchConfig(**CFGS[cfg_name])
    cam = Camera.create(r=30.0, theta=math.pi / 2 - 0.25, fov=0.5, width=16,
                        height=8)
    m, a = torch.tensor(1.0), torch.tensor(np.float32(0.9))
    yt, thr, m, a, r_h, r_ph = _march_inputs(camera_rays_u(cam, m, a), m, a,
                                             cfg, None)
    yt, thr = yt.detach().double(), thr.double()
    m, a, r_h, r_ph = (x.double() for x in (m, a, r_h, r_ph))
    n = yt.shape[1]
    y6, pph = tuple(yt[j] for j in (0, 1, 2, 3, 5, 6)), yt[7]
    hit = torch.zeros(n, dtype=torch.int32)
    nc = torch.zeros_like(hit)
    out = {}
    for i in range(cfg.max_steps):
        live = hit == HIT_NONE
        (y6n, *_), (hit2, nc2, crossed, _) = march_step_rows(
            m, a, r_h, r_ph, thr, cfg, i, y6, pph, hit, nc)
        rows = torch.stack([*y6, pph] + [x.expand(n) for x in
                                         (m, a, r_h, r_ph)])
        out[i] = (rows[:, live].numpy(), nc[live].numpy(),
                  crossed[live].numpy(), float(thr[0]))
        y6, hit, nc = y6n, hit2, nc2
    return out


def _case(name):
    """(config name, inputs (11, N) float64, thr, step, nc, cotangents
    (10, N), clip) of one case."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    cfg = "flagship"
    if name.startswith("march"):
        cfg, i = name.split("_")[1], int(name.split("_")[2])
        x, nc, _, thr = _march(cfg)[i]
    elif name == "crossing":
        states = _march(cfg)
        i = max(states, key=lambda k: states[k][2].sum())
        x, nc, crossed, thr = states[i]
        x, nc = x[:, crossed], nc[crossed]
    else:
        i = 15 if name.startswith("renorm") else 7
        x, nc, _, thr = _march(cfg)[i]
        x, nc = x[:, :4].copy(), nc[:4]
        if name == "tie_jmax":       # far = max(r / 20, 1) at r = 20
            x[1] = 20.0
        elif name == "tie_jmin":     # prox = min(max(q, 0.25), 1) at q = 1
            x[1], x[10] = 4.0, 2.0
        elif name == "tie_jclip":    # prox's clip at its lower bound 0.25
            x[1], x[10] = 2.5, 2.0
        elif name == "renorm_invalid":   # no real root for p_r
            x[5] = 8.0 * x[5] + 3.0
    cto = rng.normal(size=(10, x.shape[1]))
    clip = 0.0
    if name == "clipped_carry":
        cto[:6] *= 1e3
        clip = 0.05
    return cfg, x, thr, i, nc, cto, clip


CASES = ["march_flagship_3", "march_flagship_15", "march_flagship_30",
         "march_default_4", "march_default_15", "tie_jmax", "tie_jmin",
         "tie_jclip", "renorm_valid", "renorm_invalid", "crossing",
         "clipped_carry"]


def _inputs(name, dtype):
    cfg, x, thr, i, nc, cto, clip = _case(name)
    t = lambda v: torch.tensor(v, dtype=dtype)
    xs = [t(v) for v in x]
    ct = [t(v) for v in cto]
    if clip > 0.0:
        ct_ref = list(clip_rows(torch.stack(ct[:6]), clip)) + ct[6:]
        ct = clip_carry(ct[:6], clip) + ct[6:]
    else:
        ct_ref = ct
    thr = torch.full_like(xs[0], thr)
    return (MarchConfig(**CFGS[cfg]), xs, thr, i,
            torch.tensor(nc, dtype=torch.int32), ct, ct_ref)


def _autograd(cfg, xs, thr, i, nc, ct):
    ins = [v.clone().requires_grad_() for v in xs]
    hit = torch.zeros_like(nc)
    (y6, r_c, phi_c, t_c, dmin, _), _ = march_step_rows(
        ins[7], ins[8], ins[9], ins[10], thr, cfg, i, tuple(ins[:6]), ins[6],
        hit, nc)
    return torch.autograd.grad([*y6, r_c, phi_c, t_c, dmin], ins, ct)


def _jax(cfg, xs, thr, i, nc, ct):
    """jax.vjp of make_composite, op by op, float32, exact divides."""
    jcfg = JMarchConfig(**dc.asdict(cfg))
    comp = make_composite(jcfg, False, cfg.max_crossings)
    f = lambda v: jnp.asarray(v.numpy(), jnp.float32)
    xj = [f(v) for v in xs]
    hit = jnp.zeros(xj[0].shape, jnp.int32)
    with jax.disable_jit():
        _, vjp, _ = jax.vjp(
            lambda y6, pph, m, a, rh, rph: comp(
                y6, pph, m, a, rh, rph, f(thr), hit, jnp.int32(i),
                jnp.asarray(nc.numpy(), jnp.int32)),
            tuple(xj[:6]), *xj[6:], has_aux=True)
        ctj = [f(v) for v in ct]
        g6, *rest = vjp((tuple(ctj[:6]), *ctj[6:]))
    return [torch.from_numpy(np.array(v)) for v in (*g6, *rest)]


def _assert_close(got, ref, tol):
    for k, (g, r) in enumerate(zip(got, ref)):
        r = r.to(g.dtype)
        assert bool(torch.isfinite(g).all()), k
        np.testing.assert_allclose(
            g.numpy(), r.numpy(), rtol=tol,
            atol=tol * float(r.abs().max()), err_msg=f"input {k}")


@pytest.mark.parametrize("ref", ["autograd64", "autograd32", "jax32"])
@pytest.mark.parametrize("name", CASES)
def test_adjoint_matches_references(name, ref):
    dtype = torch.float64 if ref == "autograd64" else torch.float32
    cfg, xs, thr, i, nc, ct, ct_ref = _inputs(name, dtype)
    got, fw = march_step_vjp(cfg, xs, thr, i, nc, ct)
    # each case is the case it claims
    if name.startswith("tie"):
        r, r_ph = xs[1], xs[10]
        assert {"tie_jmax": bool((r / cfg.far_boost_radius == 1.0).all()),
                "tie_jmin": bool((torch.abs(r - r_ph) / r_ph == 1.0).all()),
                "tie_jclip": bool((torch.abs(r - r_ph) / r_ph == 0.25).all()),
                }[name]
    if name.startswith("renorm"):
        assert bool(fw["renorm"].all())
        same = fw["s"][4] == fw["y"][4]   # no root: p_r left as it was
        assert bool(same.all() if name == "renorm_invalid" else (~same).all())
    if name == "crossing":
        assert bool(fw["crossed"].all()) and fw["crossed"].numel() > 0
    assert bool(fw["advance"].all())
    want = (_autograd(cfg, xs, thr, i, nc, ct_ref) if ref.startswith("auto")
            else _jax(cfg, xs, thr, i, nc, ct_ref))
    _assert_close(got, want, TOL[dtype])


def test_sanity_freeze_with_zero_cotangent_passes_the_carry():
    """A step whose stepped momenta overflow is frozen (no advance). With
    zero crossing and r_min cotangents, the adjoint (as the dual pass did)
    passes the carry through untouched; reverse-mode autograd and jax.vjp
    give NaN, 0 times the step's infinite partials."""
    cfg, xs, thr, i, nc, ct, _ = _inputs("march_flagship_3", torch.float32)
    xs = [v[:4].clone() for v in xs]
    xs[5] = torch.full_like(xs[5], torch.finfo(torch.float32).max / 4)
    thr, nc = thr[:4], nc[:4]
    ct = [v[:4] for v in ct[:6]] + [torch.zeros(4)] * 4
    got, fw = march_step_vjp(cfg, xs, thr, i, nc, ct)
    assert not bool(fw["advance"].any())
    assert not bool(torch.isfinite(fw["y"][4]).all())
    for k in range(6):
        assert torch.equal(got[k], ct[k])
    for g in got[6:]:
        assert torch.equal(g, torch.zeros(4))
    for ref in (_autograd(cfg, xs, thr, i, nc, ct),
                _jax(cfg, xs, thr, i, nc, ct)):
        assert not all(bool(torch.isfinite(g).all()) for g in ref)


def test_frozen_step_reverses_only_a_crossing_cotangent():
    """On a frozen step with a nonzero crossing cotangent the step's values
    are reversed for the crossing record alone; the carry still passes
    through. Against autograd on a freeze with finite stepped values (the
    momentum bound |p| < 1e7)."""
    cfg, xs, thr, i, nc, ct, _ = _inputs("march_flagship_3", torch.float64)
    xs = [v[:4].clone() for v in xs]
    xs[5] = torch.full_like(xs[5], 2e7)
    thr, nc = thr[:4], nc[:4]
    ct = [v[:4] for v in ct[:9]] + [torch.zeros(4, dtype=torch.float64)]
    got, fw = march_step_vjp(cfg, xs, thr, i, nc, ct)
    assert not bool(fw["advance"].any())
    assert bool(torch.isfinite(fw["y"][5]).all())
    want = _autograd(cfg, xs, thr, i, nc, ct)
    _assert_close(got, want, TOL[torch.float64])
    alone = march_step_vjp(cfg, xs, thr, i, nc, ct[:6] + [torch.zeros(4)] * 4)
    for k in range(6):
        assert torch.equal(alone[0][k], ct[k])


def _double_root_state(dtype):
    """(m, a, r, u, pu, pph) at which the renormalization's quadratic has a
    double root, exactly in binary floating point: m = 1, a = 0, r = 4,
    u = 0 give S = 16, h = A = 1/2, B = -1 and, with pu = pph = 4, C = 1/2,
    so disc = B^2 - 4 A C = 0 (a radial turning point)."""
    return tuple(torch.tensor(v, dtype=dtype)
                 for v in (1.0, 0.0, 4.0, 0.0, 4.0, 4.0))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_renormalize_at_a_double_root(dtype):
    """At disc < 1e-30 the square root reads its floor, a constant: the
    discriminant gets no cotangent (a tie rule applied to the floored value
    would send it half of 0.5 / sqrt(1e-30))."""
    m, a, r, u, pu, pph = _double_root_state(dtype)
    pr = torch.tensor(0.3, dtype=dtype)
    S, h = r * r + a * a * u * u, 2.0 * m * r / (r * r + a * a * u * u)
    A, B = (r * r - 2.0 * m * r + a * a) / S, 2.0 * (-h + a * pph / S)
    C = -(1.0 + h) + pu * pu / S + pph * pph / S
    assert float(B * B - 4.0 * A * C) == 0.0
    g = torch.tensor(0.7, dtype=dtype)
    got = renormalize_pr_vjp(m, a, r, u, pr, pu, pph, g)
    ins = [v.clone().requires_grad_() for v in (m, a, r, u, pr, pu, pph)]
    out = ks_renormalize_pr(ins[0], ins[1], ins[2], ins[3],
                            torch.tensor(-1.0, dtype=dtype), ins[4], ins[5],
                            ins[6])
    want = torch.autograd.grad(out, ins, g, allow_unused=True)
    want = [torch.zeros((), dtype=dtype) if w is None else w for w in want]
    _assert_close([v.reshape(1) for v in got], [v.reshape(1) for v in want],
                  TOL[dtype])
