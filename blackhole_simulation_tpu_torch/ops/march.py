"""The plain batched march: the per-ray loop of the render kernel, written
as masked row updates in PyTorch.

Counterpart of ``blackhole_simulation_tpu/ops/pallas_march.py``
(``diff_step_values`` :148, ``march_tile`` :237).
The CUDA kernel (``csrc/render.cu``) runs one thread per ray with a
``while (i < max_steps && hit == NONE)`` loop; here all rays advance
together under masks and the loop stops once every ray has terminated,
which gives the same result ray by ray. The periodic null renormalization
runs after step i when (i + 1) % renormalize_every == 0 on rays still live,
the cadence the Pallas kernel's block-boundary hoist implements.

The plain version always divides exactly, as the JAX package's interpret
mode does; ``make_div_recip``'s approximate reciprocal (``approx_recip``)
exists only in the kernel.
"""

from __future__ import annotations

import torch

from blackhole_simulation_tpu_torch._elementwise import (
    clip,
    const,
    div_c,
    maximum,
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
)


def diff_step_values(m, a, r_h, r_ph, cfg, rows):
    """One march step's values: the curvature-adaptive, pole-throttled step
    size, the implicit-midpoint step, and the interpolated equator-crossing
    record. ``rows`` = (t, r, u, ph, pr, pu, pph) with p_t = -1 implicit.
    Returns (nt, nr, nu, nph, npr, npu, r_c, phi_c, t_c, dlam)."""
    t, r, u, ph, pr, pu, pph = rows
    pt_ = const(r, -1.0)
    inv_rph = 1.0 / maximum(r_ph, 1e-3)

    base = (r - r_h) * cfg.step_rate
    far = maximum(div_c(r, cfg.far_boost_radius), 1.0)
    prox = clip(torch.abs(r - r_ph) * inv_rph, 0.25, 1.0)
    if cfg.far_step_cap_rate > 0.0:
        cap = maximum(cfg.far_step_cap_rate * r, cfg.max_step)
    else:
        cap = cfg.max_step
    dlam = clip(base * far * prox, cfg.min_step, cap)

    w = maximum(1.0 - u * u, w_floor(r.dtype))
    sig = r * r + a * a * u * u
    du_rate = torch.abs(w * pu / sig) + 1e-12
    margin = 1.0 - torch.abs(u) + 1e-6
    dlam = torch.minimum(
        dlam, maximum(0.5 * margin / du_rate, cfg.min_step)
    )

    nt, nr, nu, nph, npr, npu = ks_symplectic_step_rows(
        m, a, (t, r, u, ph, pt_, pr, pu, pph), dlam, cfg.midpoint_iters,
    )
    nu = clip(nu, -1.0 + 1e-7, 1.0 - 1e-7)

    frac = clip(
        u / torch.where(torch.abs(u - nu) < 1e-12, 1e-12, u - nu),
        0.0, 1.0,
    )
    r_c = r + frac * (nr - r)
    phi_c = ph + frac * (nph - ph)
    t_c = t + frac * (nt - t)
    return nt, nr, nu, nph, npr, npu, r_c, phi_c, t_c, dlam


def march_tile(m, a, r_h, r_ph, thr, rows0, cfg):
    """March a batch of rays to horizon or escape, recording up to
    ``cfg.max_crossings`` equator crossings per ray.

    ``rows0``: 7 rows (t, r, u, ph, p_r, p_u, p_phi) of one shape, p_t = -1
    implicit; ``thr``: per-ray termination radius. Returns
    (t, r, u, ph, pr, pu, hit, steps, cr, cp, ct, nc, rmin) with cr/cp/ct
    of shape (K,) + row shape.
    """
    t, r, u, ph, pr, pu, pph = rows0
    k_slots = cfg.max_crossings
    pt_ = const(r, -1.0)
    hit = torch.where(r < thr, HIT_HORIZON, HIT_NONE).to(torch.int32)
    steps = torch.zeros_like(hit)
    nc = torch.zeros_like(hit)
    cr = r.new_zeros((k_slots,) + r.shape)
    cp = torch.zeros_like(cr)
    ct = torch.zeros_like(cr)
    rmin = torch.abs(r - r_ph)

    for i in range(cfg.max_steps):
        active = hit == HIT_NONE
        if not bool(active.any()):
            break
        nt, nr, nu, nph, npr, npu, r_c, phi_c, t_c, _ = diff_step_values(
            m, a, r_h, r_ph, cfg, (t, r, u, ph, pr, pu, pph)
        )
        crossed = (
            active & ((u * nu) < 0.0) & (nc < k_slots)
            & (r_c > cfg.record_r_min) & (r_c < cfg.record_r_max)
        )
        for k in range(k_slots):
            mask = crossed & (nc == k)
            cr[k] = torch.where(mask, r_c, cr[k])
            cp[k] = torch.where(mask, phi_c, cp[k])
            ct[k] = torch.where(mask, t_c, ct[k])
        nc = nc + crossed.to(torch.int32)

        sane = (
            torch.isfinite(nr) & torch.isfinite(nph)
            & torch.isfinite(npr) & torch.isfinite(npu)
            & (torch.abs(npr) < 1e7) & (torch.abs(npu) < 1e7)
            & (nr < 8.0 * cfg.escape_radius)
        )
        advance = active & sane
        t = torch.where(advance, nt, t)
        r = torch.where(advance, nr, r)
        u = torch.where(advance, nu, u)
        ph = torch.where(advance, nph, ph)
        pr = torch.where(advance, npr, pr)
        pu = torch.where(advance, npu, pu)
        steps = steps + advance.to(torch.int32)
        rmin = torch.where(
            advance, torch.minimum(rmin, torch.abs(r - r_ph)), rmin
        )
        hit = torch.where(active & ~sane, HIT_HORIZON, hit)
        hit = torch.where(active & (r < thr), HIT_HORIZON, hit)
        hit = torch.where(active & (r > cfg.escape_radius), HIT_ESCAPE, hit)
        hit = hit.to(torch.int32)
        if (i + 1) % cfg.renormalize_every == 0:
            pr = torch.where(
                hit == HIT_NONE,
                ks_renormalize_pr(m, a, r, u, pt_, pr, pu, pph),
                pr,
            )
    hit = torch.where(hit == HIT_NONE, HIT_HORIZON, hit).to(torch.int32)
    return t, r, u, ph, pr, pu, hit, steps, cr, cp, ct, nc, rmin
