"""One step of the AD inverse curriculum (the port's
``parallel/train.py::make_ad_inverse_step`` as ``ad_inverse_render`` runs
it), in plain PyTorch under autograd: the pooled radiance loss of the
parameterized scene against a target, its gradient in the four parameters
(spin, camera inclination, log density, log peak temperature), and the
Adam update. For the configuration ``inverse_1080p``: the analytic disk,
starfield and glow, the shadow precull, one midpoint iteration.

Built on ``camera.py``, ``geodesic.py`` and ``shading.py`` as they are,
with what the inverse step adds, each frozen from the port:

- the precull (``render/precull.py::capture_mask_u`` and the threshold
  ``render/march.py::precull_threshold`` makes from it), on the rows as
  born, before their null projection, as the port's march takes it;
- the per-step cotangent clip (``render/march.py::_ClipCotangent``):
  identity forward, each ray's cotangent of the six evolving rows scaled
  to norm <= ``clip`` backward, after every step, and once for the steps
  a stopped ray no longer takes;
- the analytic disk slot (``render/shading.py::disk_emission_rows``) with
  the density and intensity scales of the parameters;
- the pooled loss and ``_adam_update``'s formula: the global-norm clip of
  10, the cosine schedule, the spin clamp.

Departures from the port, none of which changes the mathematics: divides
are exact (the port's kernels take an approximate reciprocal and
contracted multiply-adds on ``approx_recip``); the gradient is autograd's
of the whole march, where the port's gradient kernel replays the march
from checkpoints and differentiates each step by a hand-written adjoint;
powers are ``**`` where the port chains square roots and products; the
frame is marched in blocks of whole pooled rows whose losses and
gradients are summed, so the sums round in another order; the spin enters
the camera, the radii and the shading in the rows' dtype.

Everything is computed in the dtype of the state it is given: float32, or
bfloat16 for the control of ``correct``; a step turns TF32 off. Imports
neither JAX nor the port."""

from __future__ import annotations

import dataclasses
import math

import torch

from benchmark.reference import camera, geodesic, shading
from benchmark.reference.numerics import (
    clip,
    const,
    cos,
    div_c,
    event_horizon,
    isco,
    maximum,
    photon_sphere,
    sqrt,
)

FIELDS = ("spin", "theta_cam", "log_density", "log_t_peak")
ADAM = dict(b1=0.9, b2=0.999, eps=1e-8, grad_norm=10.0, spin_max=0.998)
BLOCK_RAYS = 1 << 19


# ---------------------------------------------------------------------------
# The precull, frozen from the port's render/precull.py
# ---------------------------------------------------------------------------

CHEB_K = 32
CHEB_ERR = 0.03
MARGIN = 0.04


def _acos(x):
    return torch.arccos(x.double()).to(x.dtype)


def eta_crit_fit(m, a):
    """The Chebyshev fit of the critical curve eta_c(lambda) in float32 on
    the host from 0-d tensors: (coeffs (K,), mid, half, lam_lo, lam_hi)."""
    m = m.detach().float().cpu()
    a = a.detach().float().cpu()
    x = torch.clamp(a / m, -1.0, 1.0)
    s_pro = 2.0 * m * (1.0 + cos(2.0 / 3.0 * _acos(-x)))
    s_retro = 2.0 * m * (1.0 + cos(2.0 / 3.0 * _acos(x)))

    def lam_c(s):
        return (s * s * (3.0 * m - s) - a * a * (m + s)) / (a * (s - m))

    def eta_c(s):
        sm = s - m
        return s ** 3 * (4.0 * a * a * m - s * (s - 3.0 * m) ** 2) / (
            a * a * sm * sm)

    lam_hi = lam_c(s_pro)
    lam_lo = lam_c(s_retro)
    mid = 0.5 * (lam_hi + lam_lo)
    half = 0.5 * (lam_hi - lam_lo)
    k = torch.arange(CHEB_K, dtype=torch.float32)
    xk = cos(div_c(math.pi * (k + 0.5), float(CHEB_K)))
    lam_k = mid + half * xk
    lo = s_pro.expand(CHEB_K).clone()
    hi = s_retro.expand(CHEB_K).clone()
    for _ in range(40):
        s_mid = 0.5 * (lo + hi)
        go_right = lam_c(s_mid) > lam_k
        lo = torch.where(go_right, s_mid, lo)
        hi = torch.where(go_right, hi, s_mid)
    eta_k = eta_c(0.5 * (lo + hi))
    dct = cos(div_c(math.pi * k[:, None] * (k[None, :] + 0.5), float(CHEB_K)))
    coeffs = (2.0 / CHEB_K) * (eta_k[None, :] * dct).sum(dim=1)
    coeffs[0] = coeffs[0] * 0.5
    return coeffs, mid, half, lam_lo, lam_hi


def _cheb_eval(coeffs, mid, half, lam):
    t = torch.clamp((lam - mid) / half, -1.0, 1.0)
    b1 = torch.zeros_like(t)
    b2 = torch.zeros_like(t)
    for j in range(CHEB_K - 1, 0, -1):
        b1, b2 = 2.0 * t * b1 - b2 + coeffs[j], b1
    return t * b1 - b2 + coeffs[0]


@torch.no_grad()
def capture_mask_u(m, a, rows, margin: float = MARGIN):
    """(N,) bool: the rays of the (8, N) u-chart rows inside the critical
    curve (with ``margin``) and moving inwards, provably captured. ``m``,
    ``a``: 0-d tensors (the signed spin; the fit takes |a| clamped to
    [1e-3, 0.999] M)."""
    dt = rows.dtype
    m = m.detach().to(dt)
    a_signed = a.detach().to(dt)
    flip = torch.where(a_signed < 0.0, -1.0, 1.0).to(dt)
    a_c = torch.minimum(torch.maximum(torch.abs(a_signed), 1e-3 * m),
                        0.999 * m)
    r0, u, pt, pr, pu, pph = (rows[i] for i in (1, 2, 4, 5, 6, 7))
    e = -pt
    inv_e = 1.0 / torch.where(torch.abs(e) < 1e-12, 1.0, e)
    lam = flip * pph * inv_e
    w = 1.0 - u * u
    s2 = torch.clamp(w, min=1e-12)
    c2 = u * u
    q = pu * pu * w + c2 * (pph * pph / s2 - a_signed * a_signed * pt * pt)
    eta = q * inv_e * inv_e
    coeffs, c_mid, c_half, lam_lo, lam_hi = (
        x.to(rows.device) for x in eta_crit_fit(m, a_c))
    in_range = (lam > lam_lo) & (lam < lam_hi)
    eta_crit = _cheb_eval(coeffs, c_mid, c_half, lam) - CHEB_ERR * m * m
    inside = eta < eta_crit * (1.0 - margin) - margin * m * m
    ssq = r0 * r0 + a_signed * a_signed * c2
    delta = r0 * r0 - 2.0 * m * r0 + a_signed * a_signed
    dr_dlam = (2.0 * m * r0 * pt + delta * pr + a_signed * pph) / ssq
    return in_range & inside & (eta >= 0.0) & (dr_dlam < 0.0)


# ---------------------------------------------------------------------------
# Rays, the clipped march, the analytic composite
# ---------------------------------------------------------------------------

def born(m, a, theta, cam: dict, pix_ids):
    """(8, N) u-chart rows of the row-major pixel ids as born: p_t = -1,
    p_r not yet projected onto the null shell (``camera.rays`` less its
    projection); ``theta`` a 0-d tensor of the rows' dtype."""
    w, h = cam["width"], cam["height"]
    c0, c_r, c_th, c_ph, k1, k2, _, _ = camera.camera_scalars(
        m, a, theta, cam["r"], cam["fov"], w, h)
    dt = m.dtype
    ix = (pix_ids % w).to(dt)
    iy = (pix_ids // w).to(dt)
    nx = div_c(ix + 0.5, float(w)) * 2.0 - 1.0
    ny = 1.0 - div_c(iy + 0.5, float(h)) * 2.0
    cx, cy = nx * k1, ny * k2
    inv_norm = 1.0 / sqrt(1.0 + cx * cx + cy * cy)
    n_r, n_th, n_ph = -inv_norm, -cy * inv_norm, -cx * inv_norm
    p = [c0[j] + n_r * c_r[j] + n_th * c_th[j] + n_ph * c_ph[j]
         for j in range(4)]
    inv = 1.0 / (-p[0])
    ct = cos(theta)
    s0 = sqrt(torch.clamp(1.0 - ct * ct, min=1e-12))
    zero = torch.zeros_like(nx)
    return torch.stack([zero, zero + const(nx, cam["r"]), zero + ct,
                        zero + const(nx, cam.get("phi", 0.0)), zero - 1.0,
                        p[1] * inv, -(p[2] * inv) / s0, p[3] * inv])


class _Clip(torch.autograd.Function):
    """Identity forward; backward, each column of the (6, N) cotangent
    scaled to norm <= ``limit``."""

    @staticmethod
    def forward(ctx, x, limit):
        ctx.limit = limit
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        norm = torch.sqrt(torch.sum(g * g, dim=0, keepdim=True))
        scale = torch.clamp(torch.full_like(norm, ctx.limit)
                            / torch.clamp(norm, min=1e-30), max=1.0)
        return g * scale, None


def _clipped(y6, limit):
    if limit <= 0.0:
        return y6
    return tuple(_Clip.apply(torch.stack(y6), limit))


def march(m, a, r_h, r_ph, thr, stop_r, rows0, cfg, limit):
    """``geodesic.march`` with the cotangent clip after every step, and once
    more for the steps left when every ray has stopped."""
    pph = rows0[6]
    c = geodesic.start(rows0, thr, r_ph, cfg)
    for i in range(cfg.max_steps):
        if not bool((c.hit == geodesic.NONE).any()):
            c.y6 = _clipped(c.y6, limit)
            break
        c = geodesic.step(m, a, r_h, r_ph, thr, stop_r, cfg, i, pph, c)
        c.y6 = _clipped(c.y6, limit)
    c.hit = torch.where(c.hit == geodesic.NONE, geodesic.HORIZON,
                        c.hit).to(torch.int32)
    return c


def _nt_shape(r, r_in):
    """The Novikov-Thorne temperature shape, peak 1."""
    xp = 49.0 / 36.0
    peak = (1.0 - (1.0 / xp) ** 0.5) ** 0.25 * xp ** -0.75
    x = maximum(r / r_in, 1.0 + 1e-6)
    return div_c((1.0 - sqrt(1.0 / x)) ** 0.25 * x ** -0.75, peak)


def analytic_slot(disk: shading.Disk, m, a, r_in, r_c, phi_c, t_c, lam,
                  octaves, density_scale, intensity_scale):
    """One crossing on the analytic disk: ((r, g, b), alpha, valid)."""
    valid, r_c, g, turb, edge = shading._geometry(
        disk, m, a, r_in, r_c, phi_c, t_c, lam, octaves)
    t_shape = _nt_shape(torch.maximum(r_c, r_in * (1 + 1e-4)), r_in)
    color = shading.blackbody_ramp(clip(g * t_shape * disk.t_peak,
                                        1000.0, 40000.0))
    outer = (torch.maximum(r_in, r_c) / r_in) ** (-disk.outer_falloff * 0.5)
    alpha = clip(disk.density * density_scale * edge * turb, 0.0, 1.0)
    alpha = torch.where(valid, alpha, 0.0)
    intensity = (g ** disk.beaming_exponent * shading._pow4(t_shape) * outer
                 * intensity_scale)
    masked = torch.where(valid, intensity, 0.0)
    return tuple(c * masked for c in color), alpha, valid


def composite(c, pph, lam, m, a, r_in, r_ph, disk, stars, density_scale,
              intensity_scale):
    """(r, g, b) rows of a finished march: the analytic disk's crossings
    front to back, the starfield behind escaped rays, the photon-ring
    glow (``shading.composite`` with the analytic slot)."""
    escaped = c.hit == geodesic.ESCAPE
    zero = torch.zeros_like(lam)
    rgb, trans = (zero, zero, zero), zero + 1.0
    for k in range(len(c.cr)):
        c_rgb, alpha, valid = analytic_slot(
            disk, m, a, r_in, c.cr[k], c.cp[k], c.ct[k], lam,
            3 if k == 0 else 1, density_scale, intensity_scale)
        on = (k < c.nc) & valid
        w = torch.where(on, trans * alpha, 0.0)
        rgb = tuple(acc + w * x for acc, x in zip(rgb, c_rgb))
        trans = torch.where(on, trans * (1.0 - alpha), trans)
    t, r, u, ph, pr, pu = c.y6
    fin = (t, r, u, ph, zero - 1.0, pr, pu, pph)
    srows = tuple(torch.where(escaped, fin[i], shading._DUMMY[i])
                  for i in range(8))
    bg = shading.starfield(*shading.escape_direction(srows, m, a), stars)
    w_bg = torch.where(escaped, trans, 0.0)
    rgb = tuple(x + w_bg * b for x, b in zip(rgb, bg))
    near = torch.exp(-14.0 * c.rmin / maximum(r_ph, 1e-3))
    glow = torch.where(escaped, 0.6 * near, 0.0)
    order = div_c(torch.clamp(c.nc, 0, 3).to(lam.dtype), 3.0)
    return tuple(x + glow * (w + order * (k - w)) for x, w, k in
                 zip(rgb, (1.0, 0.82, 0.55), (0.82, 0.88, 1.0)))


# ---------------------------------------------------------------------------
# The scene, the pooled loss, the step
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Fit:
    """The configuration's scene in the reference's terms."""

    mass: float
    cam: dict
    cfg: geodesic.March
    disk: shading.Disk
    stars: shading.Stars

    @classmethod
    def of(cls, config: dict) -> "Fit":
        cam = dict(config["camera"], width=config["width"],
                   height=config["height"])
        return cls(mass=config["mass"], cam=cam,
                   cfg=geodesic.March.of(config["march"]),
                   disk=shading.Disk(**config.get("disk", {})),
                   stars=shading.Stars(**config.get("stars", {})))


def _marched(fit: Fit, params, pix_ids, max_steps: int, limit: float):
    """The clipped march of ``max_steps`` of the pixel ids' rays for the
    four parameters (0-d tensors of one dtype, which may carry gradients):
    (carry, rows as born, m, r_in, r_ph)."""
    spin, theta = params[0], params[1]
    m = torch.tensor(fit.mass, dtype=spin.dtype, device=spin.device)
    cfg = dataclasses.replace(fit.cfg, max_steps=max_steps)
    r_h, r_ph = event_horizon(m, spin), photon_sphere(m, spin)
    rows = born(m, spin, theta, fit.cam, pix_ids)
    with torch.no_grad():
        horizon = cfg.horizon_factor * r_h.detach()
        stop = torch.maximum(torch.clamp(isco(m, spin).detach(),
                                         min=cfg.record_r_min), horizon)
        thr = torch.where(capture_mask_u(m, spin, rows), stop, horizon)
    _, r, u, _, pt, pr, pu, pph = rows
    pr = geodesic.renormalize_pr(m, spin, r, u, pt, pr, pu, pph)
    c = march(m, spin, r_h, r_ph, thr, stop,
              (rows[0], r, u, rows[3], pr, pu, pph), cfg, limit)
    return c, rows, m, isco(m, spin), r_ph


def radiance(fit: Fit, params, pix_ids, max_steps: int, limit: float):
    """(N, 3) radiance of the pixel ids for the four parameters: birth,
    precull, the clipped march, the composite with the density and
    intensity scales."""
    c, rows, m, r_in, r_ph = _marched(fit, params, pix_ids, max_steps, limit)
    log_density, log_t_peak = params[2], params[3]
    density_scale = div_c(torch.exp(log_density), fit.disk.density)
    intensity_scale = torch.exp(log_t_peak - math.log(fit.disk.t_peak))
    rgb = composite(c, rows[7], camera.conserved_lam(rows), m, params[0],
                    r_in, r_ph, fit.disk, fit.stars, density_scale,
                    intensity_scale)
    return torch.stack(rgb, dim=-1)


def _pooled(x, rows: int, width: int, pool: int):
    return x.reshape(rows // pool, pool, width // pool, pool, 3).mean(
        dim=(1, 3))


def loss_and_grads(fit: Fit, params, target, max_steps: int, pool: int,
                   limit: float):
    """The pooled loss sum of the frame and its gradient in the four
    parameters: blocks of whole pooled rows, each marched and
    differentiated alone, their sums and gradients added."""
    h, w = fit.cam["height"], fit.cam["width"]
    dt, dev = params[0].dtype, params[0].device
    leaves = [p.detach().clone().requires_grad_() for p in params]
    target = torch.as_tensor(target, device=dev).to(dt).reshape(h, w, 3)
    rows_per = max(pool, (BLOCK_RAYS // (w * pool)) * pool)
    loss = torch.zeros((), dtype=dt, device=dev)
    grads = [torch.zeros((), dtype=dt, device=dev) for _ in leaves]
    for y0 in range(0, h, rows_per):
        n = min(rows_per, h - y0)
        ids = torch.arange(y0 * w, (y0 + n) * w, device=dev)
        rgb = radiance(fit, leaves, ids, max_steps, limit)
        part = torch.sum((_pooled(rgb, n, w, pool)
                          - _pooled(target[y0:y0 + n].reshape(-1, 3), n, w,
                                    pool)) ** 2)
        got = torch.autograd.grad(part, leaves)
        loss = loss + part.detach()
        grads = [g + x for g, x in zip(grads, got)]
    return loss, grads


def adam(params, m, v, t, grads, n_pool: int, lr: float, total_steps: int):
    """``_adam_update``'s formula from the moments (m, v) after t steps:
    (params', g), g the clipped gradient that entered the moments."""
    b1, b2, eps = ADAM["b1"], ADAM["b2"], ADAM["eps"]
    g = [x / n_pool for x in grads]
    gnorm = torch.sqrt(sum(x * x for x in g))
    scale = torch.clamp(const(gnorm, ADAM["grad_norm"])
                        / torch.clamp(gnorm, min=1e-12), max=1.0)
    g = [x * scale for x in g]
    t = t + 1
    tf = torch.tensor(float(t), dtype=torch.float32, device=gnorm.device)
    frac = torch.clamp(tf / total_steps, max=1.0)
    lr_t = (lr * (0.1 + 0.45 * (1.0 + torch.cos(math.pi * frac)))).to(
        gnorm.dtype)
    m = [b1 * mm + (1 - b1) * gg for mm, gg in zip(m, g)]
    v = [b2 * vv + (1 - b2) * gg * gg for vv, gg in zip(v, g)]
    mhat = [mm / (1 - b1 ** float(t)) for mm in m]
    vhat = [vv / (1 - b2 ** float(t)) for vv in v]
    new = [p - lr_t * mm / (torch.sqrt(vv) + eps)
           for p, mm, vv in zip(params, mhat, vhat)]
    new[0] = torch.clamp(new[0], -ADAM["spin_max"], ADAM["spin_max"])
    return new, g


def step(fit: Fit, stage: dict, state, target, dtype=torch.float32) -> dict:
    """One curriculum step from ``state`` = (params, m, v, t): params, m
    and v each four numbers or 0-d tensors (FIELDS' order), t the steps
    this stage has taken. ``stage``: march_steps, pool, lr, total_steps,
    clip. Everything is computed in ``dtype`` on the target's device.
    Returns loss (the pooled mean), grad (the clipped gradient that
    entered the moments) and params (the updated parameters)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params, m, v, t = state
    dev = torch.as_tensor(target).device
    as_t = lambda xs: [torch.as_tensor(x, device=dev).to(dtype).reshape(())
                       for x in xs]
    params, m, v = as_t(params), as_t(m), as_t(v)
    h, w = fit.cam["height"], fit.cam["width"]
    pool = stage["pool"]
    n_pool = (h // pool) * (w // pool)
    with torch.enable_grad():
        loss, grads = loss_and_grads(fit, params, target,
                                     stage["march_steps"], pool,
                                     stage["clip"])
    new, g = adam(params, m, v, int(t), grads, n_pool, stage["lr"],
                  stage["total_steps"])
    return {"loss": loss / n_pool, "grad": g, "params": new}


@torch.no_grad()
def mean_steps(fit: Fit, params, pix_ids, max_steps: int) -> float:
    """The mean live steps per ray of the march on ``pix_ids`` for the four
    parameters (0-d tensors on the ids' device; the precull's rays stop at
    its radius, as the port's march)."""
    c = _marched(fit, params, pix_ids, max_steps, 0.0)[0]
    return float(c.steps.double().mean())
