"""The CPU mirror of ``csrc/march_adjoint.cuh``: the hand-written reverse
adjoint (VJP) of one march step, in plain PyTorch, with exact divides.

Each function follows its namesake in the header line for line, on rows of
rays instead of one ray; a branch the header takes per ray is a
``torch.where`` here, and sums accumulate in the header's order, so at
exact divides the two agree bit for bit. Only the tests and
``chip_smoke.py`` use this module: the CPU tests hold it against
``torch.autograd`` through ``ops/march.py::march_step_rows`` and against
``jax.vjp`` of the JAX package's ``pallas_grad.make_composite``; on the
card, ``march_step_vjp_at`` runs it on the states the per-step check
(``csrc/step_vjp_check.cu``) recorded, to hold it against the header bit
for bit, and the check holds the header against the forward-mode
``Dual<N>`` step. ``turning_point_states`` plants the renormalization
states that check needs. The step's VJP is the header's two halves,
``step_tape`` (the forward, keeping what the reverse reads) and
``march_step_vjp_tape`` (the reverse from it); ``tape_rows`` and
``tape_state`` are the words the float64 gradient kernel stores of a step
and the next step's input it rebuilds from them.

The derivative rules are the dual step's and JAX's: ties of max, min and
clip split the cotangent half and half; d|x| uses sign(0) = 0; a branch
chosen by value (the renormalization's ``valid`` and ``nearest``, the
crossing record's 1e-12 guard) passes no cotangent to the side not taken.
One rule is the kernel's own: a zero cotangent contributes nothing, even
where a discarded partial is not finite. So a branch whose incoming
cotangent is exactly 0 is not reversed, and on a step that does not
advance (the sanity freeze) the carry passes straight through and only a
nonzero crossing cotangent reverses the step's values. Autograd through
the plain step differs there: 0 times an infinite partial is NaN.
"""

from __future__ import annotations

import numpy as np
import torch

from blackhole_simulation_tpu_torch._elementwise import (
    clip,
    const,
    maximum,
    sqrt,
)
from blackhole_simulation_tpu_torch.ops.ks_kernel import (
    ks_renormalize_pr,
    ks_rhs_rows,
    w_floor,
)
from blackhole_simulation_tpu_torch.ops.march import (
    crossing_values,
    finish_rows,
    step_size,
)
from blackhole_simulation_tpu_torch.render.march import HIT_NONE

U_CLIP = (-1.0 + 1e-7, 1.0 - 1e-7)


def max_vjp(x, y, g):
    """(gx, gy) of jnp.maximum(x, y): a tie splits g half and half, NaN in
    x selects x."""
    tie = x == y
    pick_x = (x > y) | torch.isnan(x)
    half = 0.5 * g
    return (torch.where(tie, half, torch.where(pick_x, g, 0.0)),
            torch.where(tie, half, torch.where(pick_x, 0.0, g)))


def min_vjp(x, y, g):
    """(gx, gy) of jnp.minimum(x, y), with max_vjp's tie rule."""
    tie = x == y
    pick_x = (x < y) | torch.isnan(x)
    half = 0.5 * g
    return (torch.where(tie, half, torch.where(pick_x, g, 0.0)),
            torch.where(tie, half, torch.where(pick_x, 0.0, g)))


def clip_vjp(x, lo, hi, g):
    """gx of jnp.clip(x, lo, hi) = minimum(maximum(x, lo), hi), constant
    bounds."""
    gmx = min_vjp(maximum(x, lo), hi, g)[0]
    return max_vjp(x, lo, gmx)[0]


def recip_vjp(x, y, g):
    """gx of y = 1 / x (the dual's -(y dx) / x)."""
    return -(y * g) / x


def ks_rhs_vjp(m, a, r, u, pr, pu, pph, g):
    """VJP of ``ks_rhs`` (p_t = -1) at (m, a, r, u, pr, pu, pph) with the
    cotangents ``g`` of its six derivatives. The forward is recomputed here
    (its second derivatives of H are the Jacobian's entries); no tape is
    kept. Returns (d, (gm, ga, gr, gu, gpr, gpu, gpph)), d the primal."""
    g0, g1, g2, g3, g4, g5 = g
    pt = -1.0
    one_uu = 1.0 - u * u
    w = maximum(one_uu, w_floor(u.dtype))
    S = r * r + a * a * u * u
    D = r * r - 2.0 * m * r + a * a
    inv_S = 1.0 / S
    h = 2.0 * m * r * inv_S
    inv_S2 = inv_S * inv_S
    inv_w = 1.0 / w

    S_r = 2.0 * r
    D_r = 2.0 * r - 2.0 * m
    h_r = 2.0 * m * (S - 2.0 * r * r) * inv_S2
    DS_r = (D_r * S - D * S_r) * inv_S2
    invS_r = -S_r * inv_S2
    wS_r = -w * S_r * inv_S2
    invSw_r = -S_r * inv_S2 * inv_w
    S_u = 2.0 * a * a * u
    w_u = -2.0 * u
    h_u = -2.0 * m * r * S_u * inv_S2
    DS_u = -D * S_u * inv_S2
    invS_u = -S_u * inv_S2
    wS_u = (w_u * S - w * S_u) * inv_S2
    iw2 = inv_w * inv_w
    R = S_u * w + S * w_u
    invSw_u = -R * inv_S2 * iw2

    d = (
        -(1.0 + h) * pt + h * pr,
        h * pt + D * inv_S * pr + a * inv_S * pph,
        w * inv_S * pu,
        a * inv_S * pr + pph * inv_S * inv_w,
        -0.5 * (-h_r * pt * pt + 2.0 * h_r * pt * pr + DS_r * pr * pr
                + 2.0 * a * invS_r * pr * pph + wS_r * pu * pu
                + invSw_r * pph * pph),
        -0.5 * (-h_u * pt * pt + 2.0 * h_u * pt * pr + DS_u * pr * pr
                + 2.0 * a * invS_u * pr * pph + wS_u * pu * pu
                + invSw_u * pph * pph),
    )

    # dH/dr and dH/du: d4 = -dH_dr, d5 = -dH_du
    e = -0.5 * g4
    f = -0.5 * g5
    g_hr = e * (2.0 * pt * pr - pt * pt)
    g_DSr = e * pr * pr
    g_invSr = e * 2.0 * a * pr * pph
    g_wSr = e * pu * pu
    g_invSwr = e * pph * pph
    g_hu = f * (2.0 * pt * pr - pt * pt)
    g_DSu = f * pr * pr
    g_invSu = f * 2.0 * a * pr * pph
    g_wSu = f * pu * pu
    g_invSwu = f * pph * pph
    gpr = (e * (2.0 * h_r * pt + 2.0 * DS_r * pr + 2.0 * a * invS_r * pph)
           + f * (2.0 * h_u * pt + 2.0 * DS_u * pr + 2.0 * a * invS_u * pph))
    gpph = (e * (2.0 * a * invS_r * pr + 2.0 * invSw_r * pph)
            + f * (2.0 * a * invS_u * pr + 2.0 * invSw_u * pph))
    gpu = e * 2.0 * wS_r * pu + f * 2.0 * wS_u * pu
    ga = e * 2.0 * invS_r * pr * pph + f * 2.0 * invS_u * pr * pph

    # the first-order terms d0 .. d3
    g_h = g0 * (pr - pt) + g1 * pt
    gpr = gpr + g0 * h + g1 * D * inv_S + g3 * a * inv_S
    g_D = g1 * inv_S * pr
    g_invS = g1 * (D * pr + a * pph) + g2 * w * pu + g3 * (a * pr + pph * inv_w)
    ga = ga + g1 * inv_S * pph + g3 * inv_S * pr
    gpph = gpph + g1 * a * inv_S + g3 * inv_S * inv_w
    g_w = g2 * inv_S * pu
    gpu = gpu + g2 * w * inv_S
    g_invw = g3 * pph * inv_S

    # the r-derivative terms
    g_Sr = (-g_DSr * D * inv_S2 - g_invSr * inv_S2 - g_wSr * w * inv_S2
            - g_invSwr * inv_S2 * inv_w)
    g_Dr = g_DSr * S * inv_S2
    g_S = g_hr * 2.0 * m * inv_S2 + g_DSr * D_r * inv_S2
    g_D = g_D - g_DSr * S_r * inv_S2
    g_invS2 = (g_hr * 2.0 * m * (S - 2.0 * r * r) + g_DSr * (D_r * S - D * S_r)
               - g_invSr * S_r - g_wSr * w * S_r - g_invSwr * S_r * inv_w)
    gm = g_hr * 2.0 * (S - 2.0 * r * r) * inv_S2
    gr = -g_hr * 8.0 * m * r * inv_S2
    g_w = g_w - g_wSr * S_r * inv_S2
    g_invw = g_invw - g_invSwr * S_r * inv_S2

    # the u-derivative terms
    g_Su = (-g_hu * 2.0 * m * r * inv_S2 - g_DSu * D * inv_S2
            - g_invSu * inv_S2 - g_wSu * w * inv_S2
            - g_invSwu * w * inv_S2 * iw2)
    g_wu = g_wSu * S * inv_S2 - g_invSwu * S * inv_S2 * iw2
    gm = gm - g_hu * 2.0 * r * S_u * inv_S2
    gr = gr - g_hu * 2.0 * m * S_u * inv_S2
    g_D = g_D - g_DSu * S_u * inv_S2
    g_S = g_S + g_wSu * w_u * inv_S2 - g_invSwu * w_u * inv_S2 * iw2
    g_w = g_w - g_wSu * S_u * inv_S2 - g_invSwu * S_u * inv_S2 * iw2
    g_invS2 = (g_invS2 - g_hu * 2.0 * m * r * S_u - g_DSu * D * S_u
               - g_invSu * S_u + g_wSu * (w_u * S - w * S_u)
               - g_invSwu * R * iw2)
    g_invw = g_invw - g_invSwu * R * inv_S2 * 2.0 * inv_w

    # S_u = 2 a^2 u, w_u = -2 u, S_r = 2 r, D_r = 2 r - 2 m
    ga = ga + g_Su * 4.0 * a * u
    gu = g_Su * 2.0 * a * a - 2.0 * g_wu
    gr = gr + 2.0 * g_Sr + 2.0 * g_Dr
    gm = gm - 2.0 * g_Dr

    # inv_S2, h, the reciprocals, D, S, w
    g_invS = g_invS + 2.0 * inv_S * g_invS2
    gm = gm + 2.0 * r * inv_S * g_h
    gr = gr + 2.0 * m * inv_S * g_h
    g_invS = g_invS + 2.0 * m * r * g_h
    g_w = g_w + recip_vjp(w, inv_w, g_invw)
    g_S = g_S + recip_vjp(S, inv_S, g_invS)
    gr = gr + (2.0 * r - 2.0 * m) * g_D + 2.0 * r * g_S
    gm = gm - 2.0 * r * g_D
    ga = ga + 2.0 * a * g_D + 2.0 * a * u * u * g_S
    gu = gu + 2.0 * a * a * u * g_S
    gu = gu - 2.0 * u * max_vjp(one_uu, w_floor(u.dtype), g_w)[0]
    return d, (gm, ga, gr, gu, gpr, gpu, gpph)


def _midpoint_input(m, a, dlam, x6, pph, e):
    """(r, u, pr, pu) at which the midpoint step evaluates its right-hand
    side the e-th time (0: the start state), recomputed from the start."""
    _, r, u, _, pr, pu = x6
    mid = (r, u, pr, pu)
    for _ in range(e):
        d = ks_rhs_rows(m, a, mid[0], mid[1], const(r, -1.0), mid[2], mid[3],
                        pph)
        mid = (0.5 * (r + (r + dlam * d[1])), 0.5 * (u + (u + dlam * d[2])),
               0.5 * (pr + (pr + dlam * d[4])), 0.5 * (pu + (pu + dlam * d[5])))
    return mid


def midpoint_step_vjp(m, a, dlam, x6, pph, iters, nu_raw, mid_last, gy,
                      gm, ga, gpph):
    """VJP of ``midpoint_step`` (``iters`` fixed-point rounds, then u
    clipped) with the cotangents ``gy`` of the stepped six rows. ``nu_raw``
    is the unclipped stepped u, ``mid_last`` the last evaluation's input
    (the forward keeps both); earlier inputs are recomputed. ``gm``, ``ga``,
    ``gpph`` are added to, in the header's order. Returns (gx6, g_dlam, gm,
    ga, gpph)."""
    gy = list(gy)
    gy[2] = clip_vjp(nu_raw, *U_CLIP, gy[2])
    gx = [torch.zeros_like(g) for g in gy]
    g_dlam = torch.zeros_like(gy[0])
    for e in reversed(range(iters + 1)):
        mid = mid_last if e == iters else _midpoint_input(m, a, dlam, x6,
                                                          pph, e)
        d, (gm_e, ga_e, gr_e, gu_e, gpr_e, gpu_e, gpph_e) = ks_rhs_vjp(
            m, a, *mid, pph, [dlam * g for g in gy])
        for k in range(6):
            g_dlam = g_dlam + gy[k] * d[k]
            gx[k] = gx[k] + gy[k]
        gm, ga, gpph = gm + gm_e, ga + ga_e, gpph + gpph_e
        # evaluation e > 0 reads 0.5 (x + n_{e-1}); evaluation 0 reads x
        s = 0.5 if e > 0 else 1.0
        gx[1] = gx[1] + s * gr_e
        gx[2] = gx[2] + s * gu_e
        gx[4] = gx[4] + s * gpr_e
        gx[5] = gx[5] + s * gpu_e
        zero = torch.zeros_like(gr_e)
        gy = [zero, s * gr_e, s * gu_e, zero, s * gpr_e, s * gpu_e]
    return gx, g_dlam, gm, ga, gpph


def step_size_vjp(cfg, a, r_h, r_ph, r, u, pu, g, ga, grh, grph, gr, gu,
                  gpu):
    """VJP of ``step_size`` with the cotangent ``g`` of dlam, added to
    (ga, grh, grph, gr, gu, gpu) in the header's order; returns them."""
    rp = maximum(r_ph, 1e-3)
    inv_rph = 1.0 / rp
    base = (r - r_h) * cfg.step_rate
    rf = r / const(r, cfg.far_boost_radius)
    far = maximum(rf, 1.0)
    dr = r - r_ph
    q = torch.abs(dr) * inv_rph
    qm = maximum(q, 0.25)
    prox = torch.minimum(qm, const(q, 1.0))
    if cfg.far_step_cap_rate > 0.0:
        rr = cfg.far_step_cap_rate * r
        cap = maximum(rr, cfg.max_step)
    else:
        cap = const(r, cfg.max_step)
    bf = base * far
    v = bf * prox
    vm = maximum(v, cfg.min_step)
    dl1 = torch.minimum(vm, cap)
    one_uu = 1.0 - u * u
    w = maximum(one_uu, w_floor(u.dtype))
    sig = r * r + a * a * u * u
    wpu = w * pu
    q2 = wpu / sig
    du_rate = torch.abs(q2) + 1e-12
    num = 0.5 * (1.0 - torch.abs(u) + 1e-6)
    q3 = num / du_rate
    lim = maximum(q3, cfg.min_step)

    g_dl1, g_lim = min_vjp(dl1, lim, g)
    g_q3 = max_vjp(q3, cfg.min_step, g_lim)[0]
    g_num = g_q3 / du_rate
    g_du = -(q3 * g_q3) / du_rate
    gu = gu - torch.sign(u) * 0.5 * g_num
    g_q2 = torch.sign(q2) * g_du
    g_wpu = g_q2 / sig
    g_sig = -(q2 * g_q2) / sig
    g_w = g_wpu * pu
    gpu = gpu + g_wpu * w
    gr = gr + 2.0 * r * g_sig
    ga = ga + 2.0 * a * u * u * g_sig
    gu = gu + 2.0 * a * a * u * g_sig
    gu = gu - 2.0 * u * max_vjp(one_uu, w_floor(u.dtype), g_w)[0]

    g_vm, g_cap = min_vjp(vm, cap, g_dl1)
    g_v = max_vjp(v, cfg.min_step, g_vm)[0]
    if cfg.far_step_cap_rate > 0.0:
        gr = gr + cfg.far_step_cap_rate * max_vjp(rr, cfg.max_step, g_cap)[0]
    g_bf = g_v * prox
    g_prox = g_v * bf
    g_base = g_bf * far
    g_far = g_bf * base
    gr = gr + cfg.step_rate * g_base
    grh = grh - cfg.step_rate * g_base
    gr = gr + max_vjp(rf, 1.0, g_far)[0] / const(r, cfg.far_boost_radius)
    g_qm = min_vjp(qm, 1.0, g_prox)[0]
    g_q = max_vjp(q, 0.25, g_qm)[0]
    g_abs = g_q * inv_rph
    g_inv = g_q * torch.abs(dr)
    sg = torch.sign(dr)
    gr = gr + sg * g_abs
    grph = grph - sg * g_abs
    grph = grph + max_vjp(r_ph, 1e-3, recip_vjp(rp, inv_rph, g_inv))[0]
    return ga, grh, grph, gr, gu, gpu


def crossing_record_vjp(t, r, u, ph, y, g_rc, g_pc, g_tc):
    """VJP of ``crossing_record`` (the equator crossing interpolated between
    (t, r, u, ph) and the stepped, clipped y). The 1e-12 guard is a
    constant. Returns ((gt, gr, gu, gph), (gy0, gy1, gy2, gy3))."""
    du = u - y[2]
    guard = torch.abs(du) < 1e-12
    den = torch.where(guard, const(u, 1e-12), du)
    x = u / den
    xm = maximum(x, 0.0)
    frac = torch.minimum(xm, const(x, 1.0))
    g_frac = g_rc * (y[1] - r) + g_pc * (y[3] - ph) + g_tc * (y[0] - t)
    gt = g_tc - g_tc * frac
    gr = g_rc - g_rc * frac
    gph = g_pc - g_pc * frac
    gy0, gy1, gy3 = g_tc * frac, g_rc * frac, g_pc * frac
    g_x = max_vjp(x, 0.0, min_vjp(xm, 1.0, g_frac)[0])[0]
    gu = g_x / den
    g_den = torch.where(guard, 0.0, -(x * g_x) / den)
    gu = gu + g_den
    gy2 = -g_den
    return (gt, gr, gu, gph), (gy0, gy1, gy2, gy3)


def renormalize_pr_vjp(m, a, r, u, pr, pu, pph, g):
    """VJP of ``ks_renormalize_pr`` (the null projection of p_r, exact
    divides) with the cotangent ``g`` of the projected p_r. Where there is
    no real root the projection is the identity on pr; elsewhere pr only
    picks the nearest root and gets none. Returns (gm, ga, gr, gu, gpr,
    gpu, gpph)."""
    pt = -1.0
    one_uu = 1.0 - u * u
    w = maximum(one_uu, w_floor(u.dtype))
    S = r * r + a * a * u * u
    D = r * r - 2.0 * m * r + a * a
    inv_S = 1.0 / S
    h = 2.0 * m * r * inv_S
    A = D * inv_S
    B = 2.0 * (h * pt + a * inv_S * pph)
    C3 = pph * pph * inv_S / w
    C = -(1.0 + h) * pt * pt + w * inv_S * pu * pu + C3
    disc = B * B - 4.0 * A * C
    valid = (disc >= 0.0) & (torch.abs(A) > 1e-12)
    dv = torch.where(valid, disc, 1.0)
    sq = sqrt(maximum(dv, 1e-30))
    denom = torch.where(valid, 2.0 * A, 1.0)
    sol1 = (-B + sq) / denom
    sol2 = (-B - sq) / denom
    first = torch.abs(sol1 - pr) < torch.abs(sol2 - pr)
    sol = torch.where(first, sol1, sol2)
    pm = torch.where(first, 1.0, -1.0)

    gv = torch.where(valid, g, 0.0)
    g_num = gv / denom
    g_A = 2.0 * (-(sol * gv) / denom)
    g_B = -g_num
    g_sq = pm * g_num
    g_disc = max_vjp(dv, 1e-30, g_sq * 0.5 / sq)[0]
    g_B = g_B + 2.0 * B * g_disc
    g_A = g_A - 4.0 * C * g_disc
    g_C = -4.0 * A * g_disc
    g_h = -pt * pt * g_C + 2.0 * pt * g_B
    g_w = inv_S * pu * pu * g_C - (C3 / w) * g_C
    g_invS = w * pu * pu * g_C + pph * pph / w * g_C
    gpu = 2.0 * w * inv_S * pu * g_C
    gpph = 2.0 * pph * inv_S / w * g_C + 2.0 * a * inv_S * g_B
    ga = 2.0 * inv_S * pph * g_B
    g_invS = g_invS + 2.0 * a * pph * g_B + D * g_A
    g_D = inv_S * g_A
    gm = 2.0 * r * inv_S * g_h
    gr = 2.0 * m * inv_S * g_h
    g_invS = g_invS + 2.0 * m * r * g_h
    g_S = recip_vjp(S, inv_S, g_invS)
    gr = gr + (2.0 * r - 2.0 * m) * g_D + 2.0 * r * g_S
    gm = gm - 2.0 * r * g_D
    ga = ga + 2.0 * a * g_D + 2.0 * a * u * u * g_S
    gu = 2.0 * a * a * u * g_S - 2.0 * u * max_vjp(one_uu, w_floor(u.dtype),
                                                    g_w)[0]
    gpr = torch.where(valid, 0.0, g)
    return gm, ga, gr, gu, gpr, gpu, gpph


def clip_carry(c6, limit):
    """The kernel's per-step cotangent clip of the six carry rows (each
    ray's norm scaled to at most ``limit``)."""
    norm = sqrt(sum(c * c for c in c6))
    scale = torch.minimum(const(norm, 1.0),
                          limit / maximum(norm, 1e-30))
    return [c * scale for c in c6]


def step_tape(cfg, x, thr, i, nc):
    """The header's ``step_tape`` on live rays: the forward of one step at
    ``x`` = (t, r, u, ph, pr, pu, ...) with the pre-step crossing count
    ``nc`` at step index ``i``, in the march step's order (its values equal
    ``march_step_rows``'). Returns the tape, a dict of what the reverse
    reads: ``dlam``, ``mid`` (the last midpoint evaluation's input), ``y``
    (the stepped rows, u clipped), ``nu_raw`` (the unclipped u),
    ``crossed``, ``advance``, ``renorm`` (the renormalization due after the
    step); beside it ``s``, the post-step state before the renormalization,
    ``hit`` and the crossing record ``r_c``, ``phi_c``, ``t_c``."""
    t, r, u, ph, pr, pu = x[:6]
    pph, m, a, r_h, r_ph = x[6:11]
    pt = const(r, -1.0)
    dlam = step_size(a, r_h, r_ph, cfg, r, u, pu)
    d = ks_rhs_rows(m, a, r, u, pt, pr, pu, pph)
    n = [v + dlam * dv for v, dv in zip((t, r, u, ph, pr, pu), d)]
    mid = (r, u, pr, pu)
    for _ in range(cfg.midpoint_iters):
        mid = (0.5 * (r + n[1]), 0.5 * (u + n[2]), 0.5 * (pr + n[4]),
               0.5 * (pu + n[5]))
        d = ks_rhs_rows(m, a, mid[0], mid[1], pt, mid[2], mid[3], pph)
        n = [v + dlam * dv for v, dv in zip((t, r, u, ph, pr, pu), d)]
    nu, r_c, phi_c, t_c = crossing_values(t, r, u, ph, n[0], n[1], n[2], n[3])
    y = (n[0], n[1], nu, n[3], n[4], n[5])
    hit = torch.full_like(nc, HIT_NONE)
    s, hit2, _, crossed, advance = finish_rows(
        cfg, thr, torch.ones(nc.shape, dtype=torch.bool, device=nc.device),
        (t, r, u, ph, pr, pu), y, r_c, hit, nc)
    renorm = torch.zeros_like(advance)
    if (i + 1) % cfg.renormalize_every == 0:
        renorm = hit2 == HIT_NONE
    return dict(dlam=dlam, mid=mid, y=y, nu_raw=n[2], crossed=crossed,
                advance=advance, renorm=renorm, s=s, hit=hit2, r_c=r_c,
                phi_c=phi_c, t_c=t_c)


def renormalized(tape, m, a, pph):
    """The post-step state of a tape's step: ``s`` with p_r renormalized
    where ``renorm`` is due (the state the next step starts from)."""
    s = tape["s"]
    pr = torch.where(tape["renorm"], ks_renormalize_pr(
        m, a, s[1], s[2], const(s[1], -1.0), s[4], s[5], pph), s[4])
    return s[:4] + (pr, s[5])


def step_dmin(tape, r, r_ph):
    """The header's ``step_dmin``: |r' - r_ph|, r' the stepped radius, or
    r where the step froze."""
    return torch.abs(torch.where(tape["advance"], tape["y"][1], r) - r_ph)


def march_step_forward(cfg, x, thr, i, nc):
    """The step's forward on live rays, keeping what the reverse reads:
    ``step_tape``'s dict, with ``s`` renormalized where that is due,
    ``mid_last`` (the tape's ``mid``) and ``dmin``. ``x`` = (t, r, u, ph,
    pr, pu, pph, m, a, r_h, r_ph)."""
    fw = step_tape(cfg, x, thr, i, nc)
    fw["s"] = renormalized(fw, x[7], x[8], x[6])
    fw["mid_last"] = fw["mid"]
    fw["dmin"] = step_dmin(fw, x[1], x[10])
    return fw


def march_step_vjp_tape(cfg, x, tape, cto):
    """The header's ``march_step_vjp_tape``: J^T cto of one live step from
    its tape (``step_tape``'s keys ``dlam``, ``mid``, ``y``, ``nu_raw``,
    ``advance``, ``renorm``) at the step's inputs ``x`` = (t, r, u, ph, pr,
    pu, pph, m, a, r_h, r_ph), with the 10 output cotangents ``cto``.
    Nothing of the step's forward is recomputed. Returns the 11 input
    cotangents."""
    t, r, u, ph, pr, pu, pph, m, a, r_h, r_ph = x
    zero = torch.zeros_like(r)
    y, adv = tape["y"], tape["advance"]
    c = list(cto[:6])
    g = dict(pph=zero, m=zero, a=zero, rh=zero, rph=zero)

    # dmin = |s'[1] - r_ph|
    nz = cto[9] != 0
    sg = torch.sign(torch.where(adv, y[1], r) - r_ph)
    c[1] = c[1] + torch.where(nz, cto[9] * sg, 0.0)
    g["rph"] = torch.where(nz, -cto[9] * sg, 0.0)

    # the renormalization of p_r, after the advance (renorm implies it: the
    # post-step state is y)
    rn = tape["renorm"] & (c[4] != 0)
    gm, ga, gr, gu, gpr, gpu, gpph = renormalize_pr_vjp(
        m, a, y[1], y[2], y[4], y[5], pph, c[4])
    c[1] = c[1] + torch.where(rn, gr, 0.0)
    c[2] = c[2] + torch.where(rn, gu, 0.0)
    c[5] = c[5] + torch.where(rn, gpu, 0.0)
    c[4] = torch.where(rn, gpr, c[4])
    g["m"] = torch.where(rn, gm, 0.0)
    g["a"] = torch.where(rn, ga, 0.0)
    g["pph"] = torch.where(rn, gpph, 0.0)

    # the advance / freeze select: a frozen step is the identity
    cy = [torch.where(adv, ck, 0.0) for ck in c]
    cx = [torch.where(adv, 0.0, ck) for ck in c]

    # the crossing record, where its cotangent is not 0
    xc = (cto[6] != 0) | (cto[7] != 0) | (cto[8] != 0)
    (gt, gr, gu, gph), gy = crossing_record_vjp(t, r, u, ph, y, cto[6],
                                                cto[7], cto[8])
    for k, gk in zip(range(4), (gt, gr, gu, gph)):
        cx[k] = cx[k] + torch.where(xc, gk, 0.0)
        cy[k] = cy[k] + torch.where(xc, gy[k], 0.0)

    # the midpoint step and its size, where the step's values got any
    rev = adv | xc
    x6 = (t, r, u, ph, pr, pu)
    gx6, g_dlam, gm, ga, gpph = midpoint_step_vjp(
        m, a, tape["dlam"], x6, pph, cfg.midpoint_iters, tape["nu_raw"],
        tape["mid"], cy, g["m"], g["a"], g["pph"])
    ga, grh, grph, gx6[1], gx6[2], gx6[5] = step_size_vjp(
        cfg, a, r_h, r_ph, r, u, pu, g_dlam, ga, zero, g["rph"], gx6[1],
        gx6[2], gx6[5])
    for k in range(6):
        cx[k] = cx[k] + torch.where(rev, gx6[k], 0.0)
    g["m"] = torch.where(rev, gm, g["m"])
    g["a"] = torch.where(rev, ga, g["a"])
    g["pph"] = torch.where(rev, gpph, g["pph"])
    g["rh"] = torch.where(rev, grh, 0.0)
    g["rph"] = torch.where(rev, grph, g["rph"])
    return cx + [g["pph"], g["m"], g["a"], g["rh"], g["rph"]]


def march_step_vjp(cfg, x, thr, i, nc, cotangents):
    """J^T cto of one live march step (``march_step_rows`` at step ``i``
    with crossing count ``nc``) at the inputs ``x`` = (t, r, u, ph, pr, pu,
    pph, m, a, r_h, r_ph), as the header's: the forward (``step_tape``),
    the output cotangents, then the reverse from the tape
    (``march_step_vjp_tape``). ``cotangents`` is the 10 output cotangents
    (six state rows, r_c, phi_c, t_c, dmin) or a function of (crossed,
    advance, dmin) that returns them, as the kernel injects its crossing
    and r_min cotangents. Returns (the 11 input cotangents, the forward's
    dict, ``march_step_forward``'s)."""
    fw = march_step_forward(cfg, x, thr, i, nc)
    cto = (cotangents(fw["crossed"], fw["advance"], fw["dmin"])
           if callable(cotangents) else cotangents)
    return march_step_vjp_tape(cfg, x, fw, cto), fw


def tape_rows(tape):
    """The six words the float64 gradient kernel stores of a step's
    stepped rows (``csrc/march_grad.cu``): ``y`` with the unclipped u in
    place of the clipped one."""
    y = tape["y"]
    return (y[0], y[1], tape["nu_raw"], y[3], y[4], y[5])


def tape_state(rows, renorm, m, a, pph):
    """The step input the float64 gradient kernel rebuilds from the previous
    step's stored ``rows`` (``tape_rows``): u clipped, and p_r renormalized
    where the previous step's ``renorm`` was due."""
    t, r, nu, ph, pr, pu = rows
    u = clip(nu, *U_CLIP)
    pr = torch.where(renorm, ks_renormalize_pr(
        m, a, r, u, const(r, -1.0), pr, pu, pph), pr)
    return (t, r, u, ph, pr, pu)


def march_step_vjp_at(check, yt0, thr, m, a, r_h, r_ph, cfg, cts):
    """The mirror's J^T cto at every live step of a per-step check
    (``ops/march_grad.py::step_vjp_check``'s dict, run on ``yt0``, ``thr``,
    ``cts`` with ``cfg``), on the CPU in float32 with the check's recorded
    pre-step states and crossing counts and its cotangent injection.
    Returns (11, steps, N) float32, 0 where the step did not run."""
    state, live = check["state"].cpu(), check["live"].cpu()
    steps, n = live.shape
    out = torch.zeros((11, steps, n), dtype=torch.float32)
    pph, thr, cts = yt0[7].cpu().float(), thr.cpu().float(), cts.cpu().float()
    scalars = [torch.as_tensor(v).detach().cpu().float()
               for v in (m, a, r_h, r_ph)]
    for i in range(steps):
        sel = live[i]
        if not bool(sel.any()):
            continue
        st, ct = state[:, i, sel], cts[:, sel]
        x = (*st[:6], pph[sel], *(v.expand(st.shape[1]) for v in scalars))

        def inject(crossed, advance, dmin, ct=ct):
            return [*ct[:6], *(torch.where(crossed, c, 0.0) for c in ct[6:9]),
                    torch.where(advance, ct[9], 0.0)]

        cin, _ = march_step_vjp(cfg, x, thr[sel], i, st[6].to(torch.int32),
                                inject)
        out[:, i, sel] = torch.stack(cin)
    return out


def turning_point_states(n_per=64, device="cpu"):
    """Planted states for the renormalization's VJP, which a sample of real
    rays rarely holds at a renormalization step: rows m, a, r, u, pr, pu,
    pph and the cotangent g of the projected p_r, (8, N) float32. First the
    exact double root of ``renormalize_pr_vjp``'s quadratic (m = 1, a = 0,
    r = 4, u = 0, pu = pph = 4: the discriminant is 0 in binary floating
    point); then radial turning points at spins 0, 0.9 and 0.999: for
    seeded (r, u, pu), the p_phi at which the discriminant vanishes (solved
    in float64), rounded to float32 and moved by -4 .. 4 ulps, with p_r
    near the double root."""
    rng = np.random.default_rng(7)
    rows = [[1.0, 0.0, 4.0, 0.0, 0.3, 4.0, 4.0, 0.7]]
    for a in (0.0, 0.9, 0.999):
        r = rng.uniform(2.5, 20.0, n_per)
        u = rng.uniform(-0.9, 0.9, n_per)
        pu = rng.normal(0.0, 2.0, n_per)
        w, S = 1.0 - u * u, r * r + a * a * u * u
        h, A = 2.0 * r / S, (r * r - 2.0 * r + a * a) / S
        # disc / 4 as a quadratic in p_phi: qa p^2 + qb p + qc = 0
        qa = a * a / (S * S) - A / (S * w)
        qb = -2.0 * h * a / S
        qc = h * h + A * (1.0 + h) - A * w * pu * pu / S
        dq = qb * qb - 4.0 * qa * qc
        keep = dq >= 0.0
        pph = ((-qb + np.sqrt(np.where(keep, dq, 0.0))) / (2.0 * qa))[keep]
        r, u, pu, S, A, h = (x[keep] for x in (r, u, pu, S, A, h))
        pr_root = -(-h + a * pph / S) / A
        p32 = pph.astype(np.float32)
        for k in range(-4, 5):
            pk = p32.copy()
            for _ in range(abs(k)):
                pk = np.nextafter(pk, np.float32(np.sign(k) * np.inf))
            pr = pr_root + rng.normal(0.0, 1e-3, len(pk))
            g = rng.normal(0.0, 1.0, len(pk))
            rows += np.stack([np.ones_like(r), np.full_like(r, a), r, u, pr,
                              pu, pk.astype(np.float64), g], 1).tolist()
    return torch.tensor(np.ascontiguousarray(np.array(rows, np.float32).T),
                        device=device)


def renorm_discriminant(q):
    """The discriminant of ``ks_renormalize_pr``'s quadratic at the states
    ``q`` (``turning_point_states``' rows), in float32 as the kernels form
    it."""
    m, a, r, u, pr, pu, pph = q[:7]
    pt = -1.0
    w = maximum(1.0 - u * u, w_floor(u.dtype))
    S = r * r + a * a * u * u
    inv_S = 1.0 / S
    h = 2.0 * m * r * inv_S
    A = (r * r - 2.0 * m * r + a * a) * inv_S
    B = 2.0 * (h * pt + a * inv_S * pph)
    C = -(1.0 + h) * pt * pt + w * inv_S * pu * pu + pph * pph * inv_S / w
    return B * B - 4.0 * A * C
