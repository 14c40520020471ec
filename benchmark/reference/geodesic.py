"""The midpoint Kerr-Schild march (frozen from the port's plain march:
``ops/ks_kernel.py``'s row functions, ``ops/march.py::march_tile`` and
``render/march.py::adaptive_dlam``), in the dtype of its rows, with exact
divides. All rays advance together under masks; the loop ends once every
ray has stopped, which gives each ray the result of its own loop.

Rows are u-chart: (t, r, u = cos theta, phi, p_t = -1, p_r, p_u, p_phi).
Besides the march's outputs it counts each ray's steps, and for a captured
ray only the steps taken outside ``stop_r`` (the precull's stop radius):
the least steps any march of this step rule must take, whatever skips the
inside of the shadow.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference.numerics import clip, const, div_c, maximum, sqrt

NONE, HORIZON, ESCAPE = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class March:
    """The march's parameters, as a configuration's ``march`` block names
    them (the kernel switches there select no arithmetic here)."""

    max_steps: int = 256
    step_rate: float = 0.12
    min_step: float = 5e-3
    max_step: float = 4.0
    far_step_cap_rate: float = 0.0
    far_boost_radius: float = 30.0
    escape_radius: float = 120.0
    horizon_factor: float = 1.01
    renormalize_every: int = 16
    max_crossings: int = 4
    record_r_min: float = 1.0
    record_r_max: float = 30.0
    midpoint_iters: int = 2

    @classmethod
    def of(cls, block: dict) -> "March":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in block.items() if k in names})


def w_floor(dtype) -> float:
    return 1e-12 if torch.finfo(dtype).bits >= 64 else 1e-6


def _geom(m, a, r, u):
    w = maximum(1.0 - u * u, w_floor(u.dtype))
    s = r * r + a * a * u * u
    d = r * r - 2.0 * m * r + a * a
    inv_s = 1.0 / s
    return w, s, d, inv_s, 2.0 * m * r * inv_s


def rhs(m, a, r, u, pt, pr, pu, pph):
    """dy/dlambda of the Kerr-Schild Hamiltonian flow: (dt, dr, du, dph,
    dpr, dpu)."""
    w, s, d, inv_s, h = _geom(m, a, r, u)
    inv_s2 = inv_s * inv_s
    inv_w = 1.0 / w
    dt = -(1.0 + h) * pt + h * pr
    dr = h * pt + d * inv_s * pr + a * inv_s * pph
    du = w * inv_s * pu
    dph = a * inv_s * pr + pph * inv_s * inv_w
    s_r = 2.0 * r
    d_r = 2.0 * r - 2.0 * m
    h_r = 2.0 * m * (s - 2.0 * r * r) * inv_s2
    ds_r = (d_r * s - d * s_r) * inv_s2
    invs_r = -s_r * inv_s2
    ws_r = -w * s_r * inv_s2
    invsw_r = -s_r * inv_s2 * inv_w
    dh_dr = 0.5 * (-h_r * pt * pt + 2.0 * h_r * pt * pr + ds_r * pr * pr
                   + 2.0 * a * invs_r * pr * pph + ws_r * pu * pu
                   + invsw_r * pph * pph)
    s_u = 2.0 * a * a * u
    w_u = -2.0 * u
    h_u = -2.0 * m * r * s_u * inv_s2
    ds_u = -d * s_u * inv_s2
    invs_u = -s_u * inv_s2
    ws_u = (w_u * s - w * s_u) * inv_s2
    invsw_u = -(s_u * w + s * w_u) * inv_s2 * inv_w * inv_w
    dh_du = 0.5 * (-h_u * pt * pt + 2.0 * h_u * pt * pr + ds_u * pr * pr
                   + 2.0 * a * invs_u * pr * pph + ws_u * pu * pu
                   + invsw_u * pph * pph)
    return dt, dr, du, dph, -dh_dr, -dh_du


def midpoint_step(m, a, rows, dlam, iterations):
    """Implicit midpoint from an explicit-Euler seed, ``iterations``
    fixed-point rounds: the six evolving rows (t, r, u, ph, pr, pu)."""
    t, r, u, ph, pt, pr, pu, pph = rows
    d = rhs(m, a, r, u, pt, pr, pu, pph)
    y = (t, r, u, ph, pr, pu)
    ny = tuple(x + dlam * dx for x, dx in zip(y, d))
    for _ in range(iterations):
        nt, nr, nu, nph, npr, npu = ny
        d = rhs(m, a, 0.5 * (r + nr), 0.5 * (u + nu), pt, 0.5 * (pr + npr),
                0.5 * (pu + npu), pph)
        ny = tuple(x + dlam * dx for x, dx in zip(y, d))
    return ny


def renormalize_pr(m, a, r, u, pt, pr, pu, pph):
    """p_r projected onto the null shell: the root of A p^2 + B p + C
    nearest p_r (unchanged without a real root)."""
    w, s, d, inv_s, h = _geom(m, a, r, u)
    qa = d * inv_s
    qb = 2.0 * (h * pt + a * inv_s * pph)
    qc = -(1.0 + h) * pt * pt + w * inv_s * pu * pu + pph * pph * inv_s / w
    disc = qb * qb - 4.0 * qa * qc
    valid = (disc >= 0.0) & (torch.abs(qa) > 1e-12)
    sqrt_d = sqrt(torch.where(valid, maximum(disc, 1e-30), 1.0))
    denom = torch.where(valid, 2.0 * qa, 1.0)
    sol1 = (-qb + sqrt_d) / denom
    sol2 = (-qb - sqrt_d) / denom
    nearest = torch.where(torch.abs(sol1 - pr) < torch.abs(sol2 - pr),
                          sol1, sol2)
    return torch.where(valid, nearest, pr)


def adaptive_dlam(r, r_h, r_ph, cfg: March):
    inv_rph = 1.0 / maximum(r_ph, 1e-3)
    base = (r - r_h) * cfg.step_rate
    far = maximum(div_c(r, cfg.far_boost_radius), 1.0)
    prox = clip(torch.abs(r - r_ph) * inv_rph, 0.25, 1.0)
    cap = (maximum(cfg.far_step_cap_rate * r, cfg.max_step)
           if cfg.far_step_cap_rate > 0.0 else cfg.max_step)
    return clip(base * far * prox, cfg.min_step, cap)


def step_size(a, r_h, r_ph, cfg, r, u, pu):
    dlam = adaptive_dlam(r, r_h, r_ph, cfg)
    w = maximum(1.0 - u * u, w_floor(r.dtype))
    sig = r * r + a * a * u * u
    du_rate = torch.abs(w * pu / sig) + 1e-12
    margin = 1.0 - torch.abs(u) + 1e-6
    return torch.minimum(dlam, maximum(0.5 * margin / du_rate, cfg.min_step))


# The state a stopped ray steps instead of its own: its outputs are thrown
# away, but a frozen state can overflow, and a zero cotangent times an
# infinite partial is NaN under autograd.
_SAFE = (0.0, 10.0, 0.0, 0.0, 0.0, 0.0)


@dataclasses.dataclass
class Carry:
    """The march's state between steps."""

    y6: tuple
    hit: torch.Tensor
    nc: torch.Tensor
    cr: list
    cp: list
    ct: list
    rmin: torch.Tensor
    steps: torch.Tensor
    steps_out: torch.Tensor


def step(m, a, r_h, r_ph, thr, stop_r, cfg: March, i: int, pph,
         c: Carry) -> Carry:
    """One masked march step of every ray (step index ``i``)."""
    t, r, u, ph, pr, pu = c.y6
    active = c.hit == NONE
    rows_in = tuple(torch.where(active, x, v) for x, v in zip(c.y6, _SAFE))
    it, ir, iu, iph, ipr, ipu = rows_in
    pt = const(ir, -1.0)
    dlam = step_size(a, r_h, r_ph, cfg, ir, iu, ipu)
    nt, nr, nu, nph, npr, npu = midpoint_step(
        m, a, (it, ir, iu, iph, pt, ipr, ipu, pph), dlam, cfg.midpoint_iters)
    nu = clip(nu, -1.0 + 1e-7, 1.0 - 1e-7)
    frac = clip(iu / torch.where(torch.abs(iu - nu) < 1e-12, 1e-12, iu - nu),
                0.0, 1.0)
    r_c = ir + frac * (nr - ir)
    phi_c = iph + frac * (nph - iph)
    t_c = it + frac * (nt - it)
    crossed = (active & ((u * nu) < 0.0) & (c.nc < cfg.max_crossings)
               & (r_c > cfg.record_r_min) & (r_c < cfg.record_r_max))
    sane = (torch.isfinite(nr) & torch.isfinite(nph) & torch.isfinite(npr)
            & torch.isfinite(npu) & (torch.abs(npr) < 1e7)
            & (torch.abs(npu) < 1e7) & (nr < 8.0 * cfg.escape_radius))
    advance = active & sane
    y6 = tuple(torch.where(advance, n, o)
               for n, o in zip((nt, nr, nu, nph, npr, npu), c.y6))
    r2 = y6[1]
    hit = torch.where(active & ~sane, HORIZON, c.hit)
    hit = torch.where(active & (r2 < thr), HORIZON, hit)
    hit = torch.where(active & (r2 > cfg.escape_radius), ESCAPE, hit)
    hit = hit.to(torch.int32)
    if (i + 1) % cfg.renormalize_every == 0:
        live = hit == NONE
        rr, ru, rpr, rpu = (torch.where(live, x, v) for x, v in
                            ((r2, 10.0), (y6[2], 0.0), (y6[4], 0.0),
                             (y6[5], 0.0)))
        y6 = y6[:4] + (torch.where(
            live, renormalize_pr(m, a, rr, ru, const(rr, -1.0), rpr, rpu, pph),
            y6[4]),) + y6[5:]
    cr, cp, ct = list(c.cr), list(c.cp), list(c.ct)
    for k in range(cfg.max_crossings):
        mask = crossed & (c.nc == k)
        cr[k] = torch.where(mask, r_c, cr[k])
        cp[k] = torch.where(mask, phi_c, cp[k])
        ct[k] = torch.where(mask, t_c, ct[k])
    dmin = torch.abs(y6[1] - r_ph)
    return Carry(
        y6=y6, hit=hit, nc=c.nc + crossed.to(torch.int32), cr=cr, cp=cp,
        ct=ct, rmin=torch.where(advance, torch.minimum(c.rmin, dmin), c.rmin),
        steps=c.steps + advance.to(torch.int32),
        steps_out=c.steps_out + (advance & (r >= stop_r)).to(torch.int32))


def start(rows0, thr, r_ph, cfg: March) -> Carry:
    t, r, u, ph, pr, pu, _ = rows0
    hit = torch.where(r < thr, HORIZON, NONE).to(torch.int32)
    zero = torch.zeros_like(r)
    k = cfg.max_crossings
    return Carry(y6=(t, r, u, ph, pr, pu), hit=hit,
                 nc=torch.zeros_like(hit), cr=[zero] * k, cp=[zero] * k,
                 ct=[zero] * k, rmin=torch.abs(r - r_ph),
                 steps=torch.zeros_like(hit), steps_out=torch.zeros_like(hit))


def _live(c: Carry) -> bool:
    return bool((c.hit == NONE).any())


def march(m, a, r_h, r_ph, thr, stop_r, rows0, cfg: March) -> Carry:
    """March ``rows0`` = (t, r, u, ph, pr, pu, pph) rows to the horizon
    (``thr``) or escape."""
    pph = rows0[6]
    c = start(rows0, thr, r_ph, cfg)
    for i in range(cfg.max_steps):
        if not _live(c):
            break
        c = step(m, a, r_h, r_ph, thr, stop_r, cfg, i, pph, c)
    c.hit = torch.where(c.hit == NONE, HORIZON, c.hit).to(torch.int32)
    return c
