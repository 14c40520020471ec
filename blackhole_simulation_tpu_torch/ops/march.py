"""The plain batched march: the per-ray loop of the render kernel, written
as masked row updates in PyTorch.

Counterpart of ``blackhole_simulation_tpu/ops/pallas_march.py``
(``diff_step_values`` :148, ``start_offset_rows`` :202, ``march_tile``
:237 with its jets, ``march_tile_ab3`` :428) and
``blackhole_simulation_tpu/ops/pallas_grad.py`` (``make_composite`` :71).
The CUDA kernel (``csrc/render.cu``) runs one thread per ray with a
``while (i < max_steps && hit == NONE)`` loop; here all rays advance
together under masks and the loop stops once every ray has terminated,
which gives the same result ray by ray. The periodic null renormalization
runs after step i when (i + 1) % renormalize_every == 0 on rays still live,
the cadence the Pallas kernel's block-boundary hoist implements.

The step of every ray is ``march_step_rows``, the counterpart of the
gradient kernel's per-step composite: the same function runs the forward
march here and the replay and per-step VJP of the plain gradient
(``ops/march_grad.py``).

The plain version always divides exactly, as the JAX package's interpret
mode does; ``make_div_recip``'s approximate reciprocal (``approx_recip``)
exists only in the kernels.
"""

from __future__ import annotations

import torch

from blackhole_simulation_tpu_torch._elementwise import (
    clip,
    const,
    maximum,
    sqrt,
)
from blackhole_simulation_tpu_torch.ops.ks_kernel import (
    ks_renormalize_pr,
    ks_symplectic_step_rows,
    w_floor,
)
from blackhole_simulation_tpu_torch.render.march import (
    HIT_ESCAPE,
    HIT_HORIZON,
    HIT_NONE,
    adaptive_dlam,
)


def step_size(a, r_h, r_ph, cfg, r, u, pu):
    """The curvature-adaptive, pole-throttled step size dlam."""
    dlam = adaptive_dlam(r, r_h, r_ph, cfg)
    w = maximum(1.0 - u * u, w_floor(r.dtype))
    sig = r * r + a * a * u * u
    du_rate = torch.abs(w * pu / sig) + 1e-12
    margin = 1.0 - torch.abs(u) + 1e-6
    return torch.minimum(
        dlam, maximum(0.5 * margin / du_rate, cfg.min_step)
    )


def crossing_values(t, r, u, ph, nt, nr, nu, nph):
    """The clipped stepped u and the equator-crossing record interpolated
    between the two states: (nu, r_c, phi_c, t_c)."""
    nu = clip(nu, -1.0 + 1e-7, 1.0 - 1e-7)
    frac = clip(
        u / torch.where(torch.abs(u - nu) < 1e-12, 1e-12, u - nu),
        0.0, 1.0,
    )
    r_c = r + frac * (nr - r)
    phi_c = ph + frac * (nph - ph)
    t_c = t + frac * (nt - t)
    return nu, r_c, phi_c, t_c


def diff_step_values(m, a, r_h, r_ph, cfg, rows):
    """One march step's values: the step size, the implicit-midpoint step,
    and the interpolated equator-crossing record. ``rows`` = (t, r, u, ph,
    pr, pu, pph) with p_t = -1 implicit. Returns (nt, nr, nu, nph, npr,
    npu, r_c, phi_c, t_c, dlam)."""
    t, r, u, ph, pr, pu, pph = rows
    pt_ = const(r, -1.0)
    dlam = step_size(a, r_h, r_ph, cfg, r, u, pu)
    nt, nr, nu, nph, npr, npu = ks_symplectic_step_rows(
        m, a, (t, r, u, ph, pt_, pr, pu, pph), dlam, cfg.midpoint_iters,
    )
    nu, r_c, phi_c, t_c = crossing_values(t, r, u, ph, nt, nr, nu, nph)
    return nt, nr, nu, nph, npr, npu, r_c, phi_c, t_c, dlam


def start_offset_rows(m, a, r_h, r_ph, cfg, rows):
    """The start-jittered rays: each advances by xi * start_jitter * dlam0
    before the march, xi in [0, 1) hashed from its conserved momenta, by one
    implicit-midpoint step of that size on its geodesic, u clipped as the
    march clips it. ``rows`` = (t, r, u, ph, pr, pu, pph); returns the
    offset rows in the same order."""
    from blackhole_simulation_tpu_torch.render.shading import hash21

    t, r, u, ph, pr, pu, pph = rows
    xi = hash21(pph * 977.0, pr * 991.0) * cfg.start_jitter
    dlam = step_size(a, r_h, r_ph, cfg, r, u, pu)
    ot, orr, ou, oph, opr, opu = ks_symplectic_step_rows(
        m, a, (t, r, u, ph, const(r, -1.0), pr, pu, pph), dlam * xi,
        cfg.midpoint_iters,
    )
    ou = clip(ou, -1.0 + 1e-7, 1.0 - 1e-7)
    return ot, orr, ou, oph, opr, opu, pph


def jet_step_rows(jets, active, rows, ny, dlam):
    """One step's jet emission on the live rays (zero elsewhere), from the
    pre-step state ``rows`` = (t, r, u, ph, ...), the stepped (nr, nu, nph)
    ``ny`` and the step size: ``march_tile``'s jet term (pallas_march.py:
    304-325), added even on a step that the sanity test then rejects."""
    from blackhole_simulation_tpu_torch.render.shading import (
        jet_emission_step,
    )

    _, r, u, ph = rows[:4]
    nr, nu, nph = ny
    inv = 1.0 / dlam
    st = sqrt(maximum(1.0 - u * u, w_floor(r.dtype)))
    rgb = jet_emission_step(
        jets, r, st, u, ph, (nr - r) * inv, -(nu - u) * inv / st,
        (nph - ph) * inv, dlam,
    )
    return torch.stack([torch.where(active, c, 0.0) for c in rgb])


# Benign far-field state that a stopped ray's lanes step instead of their
# own (the "double-where" rule of render/march.py:514-520 and
# ops/pallas_grad.py:82-91): the step's outputs there are discarded, but a
# frozen state can overflow, and a zero cotangent times an infinite partial
# is NaN under reverse-mode differentiation.
_SAFE = (0.0, 10.0, 0.0, 0.0, 0.0, 0.0)


def march_step_rows(m, a, r_h, r_ph, thr, cfg, i: int, y6, pph, hit, nc,
                    jets=None):
    """One masked march step of every ray: ``pallas_grad.make_composite``
    (:75-144), the step the march kernel, its replay and its VJP share.

    ``y6`` = (t, r, u, ph, pr, pu); ``hit``, ``nc``: the pre-step codes and
    crossing counts; ``i``: the step index. Stopped rays (and every ray once
    i >= max_steps) pass through unchanged. Returns
    ((y6', r_c, phi_c, t_c, dmin, jet), (hit', nc', crossed, advance)) with
    dmin = |r' - r_ph| and ``jet`` the step's (3, N) jet emission
    (``jet_step_rows``), or None without ``jets`` (a ``JetParams``).
    """
    t, r, u, ph, pr, pu = y6
    active = hit == HIT_NONE
    if i >= cfg.max_steps:
        active = torch.zeros_like(active)
    rows_in = tuple(torch.where(active, x, v) for x, v in zip(y6, _SAFE))
    nt, nr, nu, nph, npr, npu, r_c, phi_c, t_c, dlam = diff_step_values(
        m, a, r_h, r_ph, cfg, rows_in + (pph,)
    )
    jet = None
    if jets is not None:
        jet = jet_step_rows(jets, active, rows_in, (nr, nu, nph), dlam)
    (t2, r2, u2, ph2, pr2, pu2), hit2, nc2, crossed, advance = finish_rows(
        cfg, thr, active, y6, (nt, nr, nu, nph, npr, npu), r_c, hit, nc)
    if (i + 1) % cfg.renormalize_every == 0:
        pr2 = renormalize_live(m, a, hit2, r2, u2, pr2, pu2, pph)
    dmin = torch.abs(r2 - r_ph)
    return ((t2, r2, u2, ph2, pr2, pu2), r_c, phi_c, t_c, dmin, jet), (
        hit2, nc2, crossed, advance)


def finish_rows(cfg, thr, active, y6, ny6, r_c, hit, nc):
    """The step's epilogue on the active rays: the crossing test against the
    pre-step count ``nc``, the sanity freeze, the advance and the
    termination tests. Returns (y6', hit', nc', crossed, advance)."""
    t, r, u, ph, pr, pu = y6
    nt, nr, nu, nph, npr, npu = ny6
    crossed = (
        active & ((u * nu) < 0.0) & (nc < cfg.max_crossings)
        & (r_c > cfg.record_r_min) & (r_c < cfg.record_r_max)
    )
    nc2 = nc + crossed.to(torch.int32)
    sane = (
        torch.isfinite(nr) & torch.isfinite(nph)
        & torch.isfinite(npr) & torch.isfinite(npu)
        & (torch.abs(npr) < 1e7) & (torch.abs(npu) < 1e7)
        & (nr < 8.0 * cfg.escape_radius)
    )
    advance = active & sane
    y6 = tuple(torch.where(advance, n, o) for n, o in zip(ny6, y6))
    r2 = y6[1]
    hit2 = torch.where(active & ~sane, HIT_HORIZON, hit)
    hit2 = torch.where(active & (r2 < thr), HIT_HORIZON, hit2)
    hit2 = torch.where(active & (r2 > cfg.escape_radius), HIT_ESCAPE, hit2)
    return y6, hit2.to(torch.int32), nc2, crossed, advance


def renormalize_live(m, a, hit, r, u, pr, pu, pph):
    """Post-advance null renormalization of p_r on the rays still live,
    with a benign state stepped on the others."""
    live = hit == HIT_NONE
    pt_ = const(r, -1.0)
    rr, ru, rpr, rpu = (torch.where(live, x, v) for x, v in
                        ((r, 10.0), (u, 0.0), (pr, 0.0), (pu, 0.0)))
    return torch.where(
        live, ks_renormalize_pr(m, a, rr, ru, pt_, rpr, rpu, pph), pr
    )


def march_tile(m, a, r_h, r_ph, thr, rows0, cfg, jets=None):
    """March a batch of rays to horizon or escape, recording up to
    ``cfg.max_crossings`` equator crossings per ray.

    ``rows0``: 7 rows (t, r, u, ph, p_r, p_u, p_phi) of one shape, p_t = -1
    implicit; ``thr``: per-ray termination radius; ``jets``: a
    ``JetParams`` to accumulate the jets' emission per step, or None.
    Returns (t, r, u, ph, pr, pu, hit, steps, cr, cp, ct, nc, rmin, jet)
    with cr/cp/ct of shape (K,) + row shape and ``jet`` the (3,) + row
    shape jet radiance, or None without jets. Differentiable by autograd,
    as the JAX package's jnp march is by jax.grad: with
    ``cfg.cotangent_clip`` > 0 the carry's cotangent is clipped once per
    step (``clip_cotangent``).
    """
    from blackhole_simulation_tpu_torch.render.march import clip_cotangent

    t, r, u, ph, pr, pu, pph = rows0
    y6 = (t, r, u, ph, pr, pu)
    k_slots = cfg.max_crossings
    hit = torch.where(r < thr, HIT_HORIZON, HIT_NONE).to(torch.int32)
    steps = torch.zeros_like(hit)
    nc = torch.zeros_like(hit)
    cr = [torch.zeros_like(r) for _ in range(k_slots)]
    cp = [torch.zeros_like(r) for _ in range(k_slots)]
    ct = [torch.zeros_like(r) for _ in range(k_slots)]
    rmin = torch.abs(r - r_ph)
    jet = None if jets is None else torch.zeros((3,) + r.shape,
                                                dtype=r.dtype, device=r.device)

    for i in range(cfg.max_steps):
        if not bool((hit == HIT_NONE).any()):
            # The remaining steps are the identity; their clips, one.
            if cfg.cotangent_clip > 0.0:
                y6 = tuple(clip_cotangent(torch.stack(y6), cfg.cotangent_clip))
            break
        (y6, r_c, phi_c, t_c, dmin, dj), (hit2, nc2, crossed, advance) = (
            march_step_rows(m, a, r_h, r_ph, thr, cfg, i, y6, pph, hit, nc,
                            jets))
        if jets is not None:
            jet = jet + dj
        for k in range(k_slots):
            mask = crossed & (nc == k)
            cr[k] = torch.where(mask, r_c, cr[k])
            cp[k] = torch.where(mask, phi_c, cp[k])
            ct[k] = torch.where(mask, t_c, ct[k])
        steps = steps + advance.to(torch.int32)
        rmin = torch.where(advance, torch.minimum(rmin, dmin), rmin)
        hit, nc = hit2, nc2
        if cfg.cotangent_clip > 0.0:
            y6 = tuple(clip_cotangent(torch.stack(y6), cfg.cotangent_clip))
    hit = torch.where(hit == HIT_NONE, HIT_HORIZON, hit).to(torch.int32)
    t, r, u, ph, pr, pu = y6
    return (t, r, u, ph, pr, pu, hit, steps, torch.stack(cr),
            torch.stack(cp), torch.stack(ct), nc, rmin, jet)


def ab3_renorm_plan(cfg):
    """When the AB3 march renormalizes, per ray: (every, tail).

    The JAX package's ``march_tile_ab3`` renormalizes at tile-exit block
    boundaries only (pallas_march.py:474-475, 616-628): the multiples B > 2
    of exit_every = min(exit_check_every, max_steps) that its loop reaches,
    when renormalize_every is a multiple of exit_every (else never), and
    there when B is a multiple of renormalize_every, on the rays still live.
    The loop reaches a boundary while the previous one lies below
    max_steps, so the last can lie past the last step. Per ray: after step
    i >= 2 when ``every`` > 0 and (i + 1) % every == 0, and once more after
    the march when ``tail``.
    """
    exit_every = min(cfg.exit_check_every, cfg.max_steps)
    every = cfg.renormalize_every
    if every % exit_every != 0:
        return 0, False
    last = -(-cfg.max_steps // exit_every) * exit_every
    return every, cfg.max_steps > 2 and last > cfg.max_steps and last % every == 0


def march_tile_ab3(m, a, r_h, r_ph, thr, rows0, cfg):
    """The variable-step Adams-Bashforth-3 march (``march_tile``'s inputs
    and outputs, plain, exact divides): one right-hand side per step,

        y_{n+1} = y_n + c0 f_n + c1 f_{n-1} + c2 f_{n-2},

    with the variable-step Lagrange-integral coefficients of the step
    history (h = dlam_n, h1 = dlam_{n-1}, h2 = dlam_{n-2}), the step growth
    bounded by dlam <= 2 h1, two midpoint bootstrap steps that seed the
    history, the history shifted only on rays that advance, and the
    renormalization cadence of ``ab3_renorm_plan``. Forward only, without
    jets (the last output is None, as ``march_tile``'s without jets).
    """
    from blackhole_simulation_tpu_torch.ops.ks_kernel import ks_rhs_rows

    t, r, u, ph, pr, pu, pph = rows0
    y6 = (t, r, u, ph, pr, pu)
    pt_ = const(r, -1.0)
    k_slots = cfg.max_crossings
    hit = torch.where(r < thr, HIT_HORIZON, HIT_NONE).to(torch.int32)
    steps = torch.zeros_like(hit)
    nc = torch.zeros_like(hit)
    cr = [torch.zeros_like(r) for _ in range(k_slots)]
    cp = [torch.zeros_like(r) for _ in range(k_slots)]
    ct = [torch.zeros_like(r) for _ in range(k_slots)]
    rmin = torch.abs(r - r_ph)
    f1 = f2 = (torch.zeros_like(r),) * 6
    h1 = h2 = torch.full_like(r, cfg.min_step)
    every, tail = ab3_renorm_plan(cfg)
    third = 1.0 / 3.0

    for i in range(cfg.max_steps):
        active = hit == HIT_NONE
        if not bool(active.any()):
            break
        t, r, u, ph, pr, pu = y6
        f0 = ks_rhs_rows(m, a, r, u, pt_, pr, pu, pph)
        if i < 2:
            nt, nr, nu, nph, npr, npu, r_c, phi_c, t_c, dlam = (
                diff_step_values(m, a, r_h, r_ph, cfg, y6 + (pph,)))
        else:
            dlam = torch.minimum(step_size(a, r_h, r_ph, cfg, r, u, pu),
                                 2.0 * h1)
            h12 = h1 + h2
            hh2 = dlam * dlam
            hh3 = hh2 * dlam
            c0 = ((hh3 * third + (2.0 * h1 + h2) * hh2 * 0.5
                   + h1 * h12 * dlam) / (h1 * h12))
            c1 = -((hh3 * third + h12 * hh2 * 0.5) / (h1 * h2))
            c2 = (hh3 * third + h1 * hh2 * 0.5) / (h2 * h12)
            nt, nr, nu, nph, npr, npu = (
                y + c0 * a0 + c1 * a1 + c2 * a2
                for y, a0, a1, a2 in zip(y6, f0, f1, f2))
            nu, r_c, phi_c, t_c = crossing_values(t, r, u, ph, nt, nr, nu,
                                                  nph)
        y6, hit2, nc2, crossed, advance = finish_rows(
            cfg, thr, active, y6, (nt, nr, nu, nph, npr, npu), r_c, hit, nc)
        for k in range(k_slots):
            mask = crossed & (nc == k)
            cr[k] = torch.where(mask, r_c, cr[k])
            cp[k] = torch.where(mask, phi_c, cp[k])
            ct[k] = torch.where(mask, t_c, ct[k])
        steps = steps + advance.to(torch.int32)
        rmin = torch.where(advance, torch.minimum(rmin, torch.abs(y6[1] - r_ph)),
                           rmin)
        hit, nc = hit2, nc2
        f2 = tuple(torch.where(advance, x, o) for x, o in zip(f1, f2))
        f1 = tuple(torch.where(advance, x, o) for x, o in zip(f0, f1))
        h2 = torch.where(advance, h1, h2)
        h1 = torch.where(advance, dlam, h1)
        if i >= 2 and every and (i + 1) % every == 0:
            y6 = y6[:4] + (renormalize_live(m, a, hit, y6[1], y6[2], y6[4],
                                            y6[5], pph), y6[5])
    if tail:
        y6 = y6[:4] + (renormalize_live(m, a, hit, y6[1], y6[2], y6[4],
                                        y6[5], pph), y6[5])
    hit = torch.where(hit == HIT_NONE, HIT_HORIZON, hit).to(torch.int32)
    t, r, u, ph, pr, pu = y6
    return (t, r, u, ph, pr, pu, hit, steps, torch.stack(cr),
            torch.stack(cp), torch.stack(ct), nc, rmin, None)
