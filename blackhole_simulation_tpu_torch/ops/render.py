"""The fused render kernel's host side: the parameter row, the plain
PyTorch version of the kernel, and the wrapper that launches the kernel.

Counterpart of ``blackhole_simulation_tpu/ops/pallas_render.py``: the
``_P_*`` parameter-row layout (:62-110), the row builder (the prologue of
``pallas_render_sample``, :516-633, with the overlay and NRS blocks
:576-613) and ``_render_kernel`` (:140) with every branch: the critical-band
plane (:143-145, :209-241), the start offset (:194-206), the NRS skip
(:255-262), the AB3 march (:266), the jets in the march (:266-278,
:322-325), the NRS background (:338-395) and the shadow overlay
(:397-444). The kernel itself is ``csrc/render.cu``; ``render_planes`` here
is its plain version, written with the same expressions in the same order.
The wrapper, ``render_planes_kernel``, launches the kernel for a CUDA
parameter row and runs the plain version for a CPU one; nothing else picks
between them.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from blackhole_simulation_tpu_torch._elementwise import (
    clip,
    const,
    cos,
    div_c,
    exp,
    host,
    maximum,
    sin,
    sqrt,
    tanh,
)
from blackhole_simulation_tpu_torch.ops.build import KMAX_DEFAULT, kmax_for
from blackhole_simulation_tpu_torch.ops.ks_kernel import ks_renormalize_pr
from blackhole_simulation_tpu_torch.ops.march import (
    ab3_renorm_plan,
    march_tile,
    march_tile_ab3,
    start_offset_rows,
)
from blackhole_simulation_tpu_torch.ops.pallas_march import (
    _CJetParams,
    c_jet_params,
)
from blackhole_simulation_tpu_torch.ops.shade import (
    DiskArgs32,
    StarArgs32,
    shade_args,
)
from blackhole_simulation_tpu_torch.render.march import HIT_ESCAPE, MarchConfig
from blackhole_simulation_tpu_torch.render.precull import (
    _CHEB_ERR,
    _CHEB_K,
    band_metric_values,
    fold_pole_metric,
    pole_w_min_values,
)
from blackhole_simulation_tpu_torch.render.shading import (
    SPECTRAL_CHEB_K,
    DiskParams,
    JetParams,
    StarfieldParams,
    cheb_clenshaw,
    disk_emission_rows,
    escape_direction_u_rows,
    spectral_slot_core,
    starfield_rows,
)

# Parameter-row layout (float32 scalars, coefficient blocks appended): the
# JAX package's _P_* offsets, so a row from either side reads the same.
_P_M = 0          # mass
_P_A = 1          # signed spin
_P_RH = 2         # event horizon r+
_P_RPH = 3        # prograde photon sphere
_P_ISCO = 4       # prograde ISCO (disk inner edge)
_P_STOPR = 5      # precull stop radius
_P_HORTHR = 6     # horizon_factor * r_h termination radius
_P_R0 = 7         # camera r
_P_U0 = 8         # camera u = cos(theta)
_P_S0 = 9         # camera sin(theta)
_P_PH0 = 10       # camera phi
_P_K1 = 11        # tan(fov/2) * aspect
_P_K2 = 12        # tan(fov/2)
_P_ROLLC = 13
_P_ROLLS = 14
_P_JX = 15        # sub-pixel jitter
_P_JY = 16
_P_C0 = 17        # 4 KS-lowered tetrad coefficient 4-vectors: 17..32
_P_CR = 21
_P_CTH = 25
_P_CPH = 29
_P_CHEB_MID = 33  # precull critical-curve Chebyshev domain
_P_CHEB_HALF = 34
_P_LAM_LO = 35
_P_LAM_HI = 36
_P_FLIP = 37      # sign(a) isometry flip for the precull lam
_P_ACHEB = 38     # |a| clamped to the Chebyshev fit's validated range
_P_INV_LOGR = 39  # 1 / log(r_out / r_in) (spectral t-shape domain)
_P_ETA = 40                            # precull eta_c coeffs, _CHEB_K wide
_P_TSHAPE = _P_ETA + _CHEB_K           # spectral t-shape coeffs
_P_RGB = _P_TSHAPE + SPECTRAL_CHEB_K   # 3 x SPECTRAL_CHEB_K rgb coeffs
_OVERLAY_N = 32                        # shadow-overlay block: width, then
                                       # the 2N-point polyline (alpha, beta,
                                       # valid)
_P_OVW = _P_RGB + 3 * SPECTRAL_CHEB_K
_P_OAL = _P_OVW + 1
_P_OBE = _P_OAL + 2 * _OVERLAY_N
_P_OVA = _P_OBE + 2 * _OVERLAY_N
_P_NRS_BMIN = _P_OVA + 2 * _OVERLAY_N  # NRS far-field block: b_min,
                                       # theta_obs / pi, the flat weights
_P_NRS_TH = _P_NRS_BMIN + 1
_P_NRS_W = _P_NRS_TH + 1
_NRS_FLAT = (3 * 16 + 16) + 2 * (16 * 16 + 16) + (16 * 3 + 3)  # 659
_P_TOTAL = _P_NRS_W + _NRS_FLAT
_P_PAD = -(-_P_TOTAL // 128) * 128


@functools.lru_cache(maxsize=64)
def _row_camera(cam, m: float, a: float, dtype=torch.float32):
    """The row's camera scalars (``camera_scalars`` of ``dtype`` mass and
    spin, in ``dtype``) as tuples of floats, cached: a scene's row is built
    every sample, and these scalar torch operations would cost the host
    more than the rest of the row."""
    from blackhole_simulation_tpu_torch.render.camera import camera_scalars

    t = lambda v: torch.tensor(v, dtype=dtype)
    return tuple(tuple(x.double().reshape(-1).tolist())
                 for x in camera_scalars(cam, t(m), t(a), dtype=dtype))


def build_param_row(scene, jitter=None, dtype=torch.float32) -> np.ndarray:
    """The kernel's (_P_PAD,) float32 parameter row for one sample.

    Built in float64 and cast once. With ``dtype`` float32 (the default)
    mass and spin are first rounded to float32, as the JAX package casts
    them before it builds its row, and the radii and the camera tetrad
    (``camera_scalars``, the staged path's) come from them in float32
    arithmetic, as the JAX package's do; with float64 (the JAX package's
    fused route at ``dtype=float64``) mass and spin stay unrounded and
    the radii, the tetrad, the stop radius and the overlay's width are
    float64 arithmetic, until the one cast. The camera's own values stay
    float64 until the cast. Tensor leaves
    enter by value (the row is host data: the fused kernel has no
    gradient path, as the JAX package's has none).
    ``scene.march_cfg`` must already carry render_sample's precull
    adjustments. The overlay block
    holds the line width (float32 arithmetic, as the JAX package forms it)
    and ``bardeen_shadow``'s 64-point curve; the NRS block, when the scene
    has weights and the feature on, b_min, theta / pi and the flat weights.
    """
    from blackhole_simulation_tpu_torch.render.precull import (
        _eta_crit_cheb_coeffs,
    )
    from blackhole_simulation_tpu_torch.render.shading import (
        spectral_kernel_tables,
    )

    cam = scene.camera.host()
    cfg = scene.march_cfg
    f64 = dtype == torch.float64
    rnd = float if f64 else (lambda v: float(np.float32(v)))
    m = rnd(host(scene.bh.mass))
    a = rnd(host(scene.bh.spin))
    (c0, c_r, c_th, c_ph, (k1,), (k2,), (roll_c,),
     (roll_s,)) = _row_camera(cam, m, a, dtype)
    u0 = math.cos(cam.theta)
    s0 = math.sqrt(max(1.0 - math.cos(cam.theta) ** 2, 1e-12))
    jx, jy = (0.0, 0.0) if jitter is None else (float(jitter[0]), float(jitter[1]))

    r_h, r_ph, isco, hor_thr = _radii(m, a, cfg.horizon_factor, dtype)
    if cfg.precull_keep_disk:
        stop_r = max(isco, rnd(cfg.record_r_min), hor_thr)
    else:
        stop_r = 1e9
    flip = -1.0 if a < 0.0 else 1.0
    a_cheb = min(max(abs(a), 1e-3 * m), 0.999 * m)
    eta_coeffs, cheb_mid, cheb_half, lam_lo, lam_hi = _eta_crit_cheb_coeffs(
        m, a_cheb
    )

    if scene.features.spectral_lut and scene.features.disk:
        tables = scene.spectral_coeffs
        if tables is None:
            tables = spectral_kernel_tables(
                host(scene.bh.mass), host(scene.bh.spin), scene.disk
            )
        tc, rc, il = tables
        t_coeffs = np.asarray(tc, np.float64)
        rgb_coeffs = np.asarray(rc, np.float64).reshape(-1)
        inv_logr = float(il)
    else:
        t_coeffs = np.zeros(SPECTRAL_CHEB_K)
        rgb_coeffs = np.zeros(3 * SPECTRAL_CHEB_K)
        inv_logr = 1.0

    head = np.array([
        m, a, r_h, r_ph, isco, stop_r, hor_thr,
        cam.r, u0, s0, cam.phi, k1, k2, roll_c, roll_s, jx, jy,
        *c0, *c_r, *c_th, *c_ph,
        cheb_mid, cheb_half, lam_lo, lam_hi, flip, a_cheb, inv_logr,
    ], np.float64)
    row = np.zeros(_P_PAD, np.float64)
    row[:_P_ETA] = head
    row[_P_ETA:_P_TSHAPE] = eta_coeffs
    row[_P_TSHAPE:_P_RGB] = t_coeffs
    row[_P_RGB:_P_OVW] = rgb_coeffs
    if scene.features.shadow_overlay:
        from blackhole_simulation_tpu_torch.physics.shadow import (
            bardeen_shadow,
        )

        o_al, o_be, o_va = bardeen_shadow(m, a, cam.theta, n=_OVERLAY_N)
        fl = np.float64 if f64 else np.float32
        pix_b = fl(cam.fov / cam.height * cam.r)
        row[_P_OVW] = max(fl(0.06) * fl(m), fl(1.5) * pix_b)
        row[_P_OAL:_P_OBE] = o_al
        row[_P_OBE:_P_OVA] = o_be
        row[_P_OVA:_P_NRS_BMIN] = o_va
    if nrs_active(scene):
        from blackhole_simulation_tpu_torch.models.nrs import nrs_flat_weights

        row[_P_NRS_BMIN] = nrs_b_min(scene)
        row[_P_NRS_TH] = cam.theta / math.pi
        row[_P_NRS_W:_P_TOTAL] = nrs_flat_weights(scene.nrs_params)
    return row.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _radii(m: float, a: float, horizon_factor: float, dtype=torch.float32):
    """(r+, r_ph, ISCO, horizon_factor * r+) in ``dtype`` arithmetic from
    ``dtype`` mass and spin, as the JAX package forms them for its row and
    the staged path's event_horizon_t / photon_sphere_t / isco_t do: in
    float32 the float64 values differ in the last bit, which moves every
    step size."""
    from blackhole_simulation_tpu_torch.geometry.metrics import (
        event_horizon_t,
        isco_t,
        photon_sphere_t,
    )

    mt, at = torch.tensor(m, dtype=dtype), torch.tensor(a, dtype=dtype)
    r_h = event_horizon_t(mt, at)
    return (float(r_h), float(photon_sphere_t(mt, at)), float(isco_t(mt, at)),
            float(horizon_factor * r_h))


def nrs_active(scene) -> bool:
    """The NRS far field runs when the feature is on and the scene has
    weights; without weights it is off, as in the JAX package."""
    return scene.features.nrs_far_field and scene.nrs_params is not None


def nrs_b_min(scene) -> float:
    """The far-field threshold on the impact parameter: beyond any visible
    disk crossing (pallas_render.py:597-600, pipeline.py:480-483)."""
    return max(12.0, scene.disk.outer_radius * 1.2
               if scene.features.disk else 12.0)


@dataclasses.dataclass(frozen=True)
class RenderStatic:
    """What the kernel takes by value besides the row: the frame size and
    the static configuration that selects its branches (``cfg.multistep``:
    the AB3 march, unless ``jets``; ``cfg.refine_band`` > 0: the band
    plane, with the pole criterion when ``cfg.refine_pole_w`` > 0;
    ``cfg.start_jitter`` > 0: the start offset; ``jets``: the jets'
    emission in the march, configured by ``jet_params``; ``overlay``: the
    shadow overlay; ``nrs_on``: the NRS skip and background, whose weights
    are in the row)."""

    cfg: MarchConfig
    disk_on: bool
    spectral: bool
    starfield: bool
    glow: bool
    disk: DiskParams
    stars: StarfieldParams
    width: int
    height: int
    jets: bool = False
    jet_params: JetParams = JetParams()
    overlay: bool = False
    nrs_on: bool = False


def render_planes(row: torch.Tensor, st: RenderStatic,
                  steps: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the render kernel: (3, H, W) float32 linear
    radiance from one parameter row, and a fourth plane, the critical-band
    metric, when ``cfg.refine_band`` > 0. Every pixel is one ray, in row
    order. ``steps``, if given, is an int32 (H, W) tensor that receives each
    ray's march step count.

    Follows ``_render_kernel``: ray birth from the camera scalars, null
    projection, the start offset, Chebyshev shadow precull, band metric and
    NRS skip, the march (AB3 with ``cfg.multistep`` and no jets; the jets'
    emission accumulated in it), and the composite of up to K disk-crossing
    slots, the starfield, the jets, the photon-ring glow, the NRS
    background and the shadow overlay, in that order.
    """
    cfg = st.cfg
    dev = row.device
    sp = lambda i: row[i]
    m = sp(_P_M)
    a = sp(_P_A)
    r_h = sp(_P_RH)
    r_ph = sp(_P_RPH)
    r_in = sp(_P_ISCO)

    h, w = st.height, st.width
    iy = torch.arange(h, device=dev, dtype=torch.float32).repeat_interleave(w)
    ix = torch.arange(w, device=dev, dtype=torch.float32).repeat(h)

    # --- camera ray ---
    nx = div_c(ix + 0.5 + sp(_P_JX), float(w)) * 2.0 - 1.0
    ny = 1.0 - div_c(iy + 0.5 + sp(_P_JY), float(h)) * 2.0
    cx = nx * sp(_P_K1)
    cy = ny * sp(_P_K2)
    cx, cy = (cx * sp(_P_ROLLC) - cy * sp(_P_ROLLS),
              cx * sp(_P_ROLLS) + cy * sp(_P_ROLLC))
    inv_norm = 1.0 / sqrt(1.0 + cx * cx + cy * cy)
    n_r = -inv_norm
    n_th = -cy * inv_norm
    n_ph = -cx * inv_norm
    p = [sp(_P_C0 + j) + n_r * sp(_P_CR + j) + n_th * sp(_P_CTH + j)
         + n_ph * sp(_P_CPH + j) for j in range(4)]
    inv = 1.0 / (-p[0])
    pr = p[1] * inv
    pu = -(p[2] * inv) / sp(_P_S0)
    pph = p[3] * inv

    zero = torch.zeros_like(ix)
    r_row = zero + sp(_P_R0)
    u_row = zero + sp(_P_U0)
    ph_row = zero + sp(_P_PH0)
    pt_ = const(ix, -1.0)
    pr = ks_renormalize_pr(m, a, r_row, u_row, pt_, pr, pu, pph)

    # --- start offset ---
    t_row = zero
    if cfg.start_jitter > 0.0:
        t_row, r_row, u_row, ph_row, pr, pu, _ = start_offset_rows(
            m, a, r_h, r_ph, cfg, (zero, r_row, u_row, ph_row, pr, pu, pph))

    # --- shadow precull, the critical-band metric and the NRS skip ---
    hor_thr = sp(_P_HORTHR)
    band_on = cfg.refine_band > 0.0
    band = None
    if cfg.shadow_precull or band_on or st.nrs_on:
        lam = sp(_P_FLIP) * pph
        w0 = 1.0 - u_row * u_row
        s2 = maximum(w0, 1e-12)
        c2 = u_row * u_row
        eta = pu * pu * w0 + c2 * (pph * pph / s2 - a * a)
        t_dom = clip((lam - sp(_P_CHEB_MID)) / sp(_P_CHEB_HALF), -1.0, 1.0)
        coeffs = [row[_P_ETA + j] for j in range(_CHEB_K)]
        cheb_raw = cheb_clenshaw(coeffs, t_dom)
    if band_on:
        band = band_metric_values(m, eta, cheb_raw, lam, sp(_P_LAM_LO),
                                  sp(_P_LAM_HI))
        if cfg.refine_pole_w > 0.0:
            band = fold_pole_metric(band, pole_w_min_values(m, a, lam, eta),
                                    cfg.refine_band, cfg.refine_pole_w)
    if cfg.shadow_precull:
        eta_crit = cheb_raw - const(ix, _CHEB_ERR) * m * m
        margin = const(ix, 0.04)
        inside = eta < eta_crit * (1.0 - margin) - margin * m * m
        in_range = (lam > sp(_P_LAM_LO)) & (lam < sp(_P_LAM_HI))
        ssq = r_row * r_row + a * a * c2
        delta = r_row * r_row - 2.0 * m * r_row + a * a
        dr_dlam = (2.0 * m * r_row * pt_ + delta * pr + a * pph) / ssq
        dead = in_range & inside & (eta >= 0.0) & (dr_dlam < 0.0)
        thr = torch.where(dead, sp(_P_STOPR), hor_thr)
    else:
        thr = zero + hor_thr
    if st.nrs_on:
        b_tot = sqrt(maximum(eta + lam * lam, 1e-12))
        far = b_tot > sp(_P_NRS_BMIN)
        thr = torch.where(far, 1e9, thr)

    # --- march ---
    rows0 = (t_row, r_row, u_row, ph_row, pr, pu, pph)
    if st.jets:
        out = march_tile(m, a, r_h, r_ph, thr, rows0, cfg, jets=st.jet_params)
    elif cfg.multistep:
        out = march_tile_ab3(m, a, r_h, r_ph, thr, rows0, cfg)
    else:
        out = march_tile(m, a, r_h, r_ph, thr, rows0, cfg)
    t, r, u, ph, pr_f, pu_f, hit, n_steps, cr, cp, ct, nc, rmin, jet = out
    if steps is not None:
        steps.copy_(n_steps.reshape(h, w))

    # --- composite ---
    escaped = hit == HIT_ESCAPE
    rgb = (zero, zero, zero)
    trans = zero + 1.0
    if st.disk_on:
        if st.spectral:
            t_coeffs = [row[_P_TSHAPE + j] for j in range(SPECTRAL_CHEB_K)]
            rgb_coeffs = [
                [row[_P_RGB + c * SPECTRAL_CHEB_K + j]
                 for j in range(SPECTRAL_CHEB_K)]
                for c in range(3)
            ]
        for k in range(cfg.max_crossings):
            filled = k < nc
            octaves = 3 if k == 0 else 1
            if st.spectral:
                c_rgb, c_alpha, valid = spectral_slot_core(
                    st.disk, m, a, r_in, sp(_P_INV_LOGR), t_coeffs,
                    rgb_coeffs, cr[k], cp[k], ct[k], pph, octaves,
                )
            else:
                c_rgb, c_alpha, valid = disk_emission_rows(
                    st.disk, m, a, r_in, cr[k], cp[k], ct[k], pph, octaves,
                )
            on = filled & valid
            wgt = torch.where(on, trans * c_alpha, 0.0)
            rgb = tuple(acc + wgt * c for acc, c in zip(rgb, c_rgb))
            trans = torch.where(on, trans * (1.0 - c_alpha), trans)

    if st.starfield:
        dummy = (0.0, 100.0, 0.0, 0.0, -1.0, -1.0, 0.0, 0.0)
        fin = (t, r, u, ph, zero + pt_, pr_f, pu_f, pph)
        srows = tuple(torch.where(escaped, fin[i], dummy[i]) for i in range(8))
        bg = starfield_rows(*escape_direction_u_rows(srows, m, a), params=st.stars)
        w_bg = torch.where(escaped, trans, 0.0)
        rgb = tuple(c + w_bg * b for c, b in zip(rgb, bg))

    if jet is not None:
        rgb = tuple(c + j for c, j in zip(rgb, jet))

    if st.glow:
        near = torch.exp(-14.0 * rmin / maximum(r_ph, 1e-3))
        glow = torch.where(escaped, 0.6 * near, 0.0)
        order = div_c(torch.clamp(nc, 0, 3).to(torch.float32), 3.0)
        warm = (1.0, 0.82, 0.55)
        cool = (0.82, 0.88, 1.0)
        rgb = tuple(
            c + glow * (const(ix, wv) + order * const(ix, kv - wv))
            for c, wv, kv in zip(rgb, warm, cool)
        )

    if st.nrs_on and st.starfield:
        birth = (zero, zero + sp(_P_R0), u_row, ph_row, zero + pt_, pr, pu,
                 pph)
        bg_far = starfield_rows(*_nrs_directions(row, birth, b_tot, m, a),
                                params=st.stars)
        rgb = tuple(torch.where(far, b_, c) for c, b_ in zip(rgb, bg_far))

    if st.overlay:
        line = _overlay_weight(row, u_row, pu, pph, a)
        rgb = tuple(c + line * col for c, col in zip(rgb, (0.15, 1.0, 0.35)))

    if band is not None:
        rgb = (*rgb, band)
    return torch.stack(rgb).reshape(len(rgb), h, w)


def _nrs_directions(row, birth, b_tot, m, a):
    """The NRS background's directions (pallas_render.py:338-395): the
    birth ray's escape direction, Rodrigues-rotated by the MLP's deflection
    at (b / 40, theta_obs / pi, a) about the orbital plane's normal. The
    MLP is the kernel's: weights read from the row, its summation order,
    tanh through float64."""
    sp = lambda i: row[i]
    zero = torch.zeros_like(b_tot)
    _, _, u_row, ph_row = birth[:4]
    vx, vy, vz = escape_direction_u_rows(birth, m, a)
    r0s, s0r, u0r = sp(_P_R0), sp(_P_S0), sp(_P_U0)
    px = r0s * s0r * cos(ph_row)
    py = r0s * s0r * sin(ph_row)
    pz = zero + r0s * u0r

    wref = lambda i: row[_P_NRS_W + i]
    bn = b_tot * const(b_tot, 1.0 / 40.0)
    thn = sp(_P_NRS_TH)
    hid = [tanh(bn * wref(j) + (thn * wref(16 + j) + a * wref(32 + j)
                                + wref(48 + j))) for j in range(16)]
    off = 64
    for _ in range(2):
        nxt = []
        for j in range(16):
            acc = zero + wref(off + 256 + j)
            for i in range(16):
                acc = acc + hid[i] * wref(off + i * 16 + j)
            nxt.append(tanh(acc))
        hid = nxt
        off += 272
    alpha_d = zero + wref(off + 48)
    for i in range(16):
        alpha_d = alpha_d + hid[i] * wref(off + i * 3)

    nxr = py * vz - pz * vy
    nyr = pz * vx - px * vz
    nzr = px * vy - py * vx
    inv_n = 1.0 / sqrt(maximum(nxr * nxr + nyr * nyr + nzr * nzr, 1e-20))
    nxr, nyr, nzr = nxr * inv_n, nyr * inv_n, nzr * inv_n
    ca = cos(alpha_d)
    sa = sin(alpha_d)
    cxr = nyr * vz - nzr * vy
    cyr = nzr * vx - nxr * vz
    czr = nxr * vy - nyr * vx
    return vx * ca + cxr * sa, vy * ca + cyr * sa, vz * ca + czr * sa


def _overlay_weight(row, u_row, pu, pph, a):
    """The overlay line's weight per ray (pallas_render.py:397-444): the
    birth rows' conserved (lambda, eta) as celestial (alpha, beta), the
    squared distance to the row's polyline plus the beta^2 deficit, and a
    Gaussian of the row's width."""
    sp = lambda i: row[i]
    s0o = sp(_P_S0)
    u0c = sp(_P_U0)
    w0o = 1.0 - u_row * u_row
    s2o = maximum(w0o, 1e-12)
    etao = pu * pu * w0o + u_row * u_row * (pph * pph / s2o - a * a)
    alpha_p = -pph / s0o
    cot0 = u0c / s0o
    beta_sq = etao + a * a * u0c * u0c - pph * pph * cot0 * cot0
    beta_p = torch.sign(pu) * sqrt(maximum(beta_sq, 0.0))
    deficit = maximum(-beta_sq, 0.0)

    n2 = 2 * _OVERLAY_N
    dmin = torch.full_like(u_row, 1e30)
    for i in range(n2):
        j = 0 if i + 1 == n2 else i + 1
        ax, ay = sp(_P_OAL + i), sp(_P_OBE + i)
        bx, by = sp(_P_OAL + j), sp(_P_OBE + j)
        ok = (sp(_P_OVA + i) > 0.5) & (sp(_P_OVA + j) > 0.5)
        dx, dy = bx - ax, by - ay
        len_sq = dx * dx + dy * dy
        t = clip(((alpha_p - ax) * dx + (beta_p - ay) * dy)
                 / maximum(len_sq, 1e-20), 0.0, 1.0)
        ex = alpha_p - (ax + t * dx)
        ey = beta_p - (ay + t * dy)
        dmin = torch.minimum(dmin, torch.where(ok, ex * ex + ey * ey, 1e30))
    dmin = dmin + deficit
    wdt = sp(_P_OVW)
    return 1.2 * exp(-dmin / maximum(wdt * wdt, 1e-12))


class _CRenderStatic(ctypes.Structure):
    """``RenderStatic`` as ``csrc/render.cu`` declares it: 4-byte fields,
    constants already rounded to float32 the way the JAX package rounds
    them (the jets', and the disk's and the stars' of
    ``ops/shade.py::shade_args``)."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "width", "height", "max_steps", "renormalize_every", "max_crossings",
        "midpoint_iters", "approx_recip", "precull", "disk_on", "spectral",
        "starfield", "glow", "far_cap_on", "multistep", "ab3_renorm_every",
        "ab3_tail_renorm", "jets", "nrs_on", "overlay",
    )] + [(name, ctypes.c_float) for name in (
        "step_rate", "min_step", "max_step", "far_step_cap_rate",
        "far_boost_radius", "escape_radius", "escape_sanity_r",
        "record_r_min", "record_r_max", "refine_band", "refine_pole_w",
        "pole_scale", "start_jitter",
    )] + [("jet", _CJetParams), ("disk", DiskArgs32), ("stars", StarArgs32)]


def _c_static(st: RenderStatic) -> _CRenderStatic:
    cfg = st.cfg
    ab3_every, ab3_tail = ab3_renorm_plan(cfg)
    disk, stars = shade_args(st.disk, st.stars, torch.float32,
                             types=(DiskArgs32, StarArgs32))
    return _CRenderStatic(
        width=st.width, height=st.height, max_steps=cfg.max_steps,
        renormalize_every=cfg.renormalize_every,
        max_crossings=cfg.max_crossings, midpoint_iters=cfg.midpoint_iters,
        approx_recip=int(cfg.approx_recip), precull=int(cfg.shadow_precull),
        disk_on=int(st.disk_on), spectral=int(st.spectral),
        starfield=int(st.starfield), glow=int(st.glow),
        far_cap_on=int(cfg.far_step_cap_rate > 0.0),
        multistep=int(cfg.multistep), ab3_renorm_every=ab3_every,
        ab3_tail_renorm=int(ab3_tail), jets=int(st.jets),
        nrs_on=int(st.nrs_on), overlay=int(st.overlay),
        start_jitter=cfg.start_jitter,
        jet=c_jet_params(st.jet_params if st.jets else None),
        refine_band=cfg.refine_band,
        refine_pole_w=cfg.refine_pole_w,
        # fold_pole_metric's scale, in float64 then rounded once, as JAX
        # rounds the Python float.
        pole_scale=(cfg.refine_band / cfg.refine_pole_w
                    if cfg.refine_pole_w > 0.0 else 0.0),
        step_rate=cfg.step_rate, min_step=cfg.min_step,
        max_step=cfg.max_step, far_step_cap_rate=cfg.far_step_cap_rate,
        far_boost_radius=cfg.far_boost_radius,
        escape_radius=cfg.escape_radius,
        escape_sanity_r=8.0 * cfg.escape_radius,
        record_r_min=cfg.record_r_min, record_r_max=cfg.record_r_max,
        disk=disk, stars=stars,
    )


def render_planes_kernel(row: torch.Tensor, st: RenderStatic,
                         steps: torch.Tensor | None = None,
                         out: torch.Tensor | None = None) -> torch.Tensor:
    """(3, H, W) float32 radiance from one parameter row, plus the band
    plane as a fourth when ``st.cfg.refine_band`` > 0 (every branch of
    ``RenderStatic``); ``steps``, if given,
    is an int32 (H, W) tensor on the row's device that receives each ray's
    march step count.

    A CUDA row launches the render kernel (``csrc/render.cu``) on the
    current stream and counts the launch in ``render_planes_kernel.launches``;
    a CPU row runs ``render_planes``. No other case is accepted. ``out``, a
    CUDA call's contiguous float32 (planes, H, W) tensor, receives the
    planes in place of a new one.
    """
    if row.dtype != torch.float32 or row.shape != (_P_PAD,):
        raise ValueError(f"parameter row must be float32 ({_P_PAD},), got "
                         f"{row.dtype} {tuple(row.shape)}")
    if steps is not None and (steps.dtype != torch.int32
                              or steps.shape != (st.height, st.width)
                              or steps.device != row.device
                              or not steps.is_contiguous()):
        raise ValueError("steps must be a contiguous int32 (H, W) tensor on "
                         "the row's device")
    if row.device.type == "cpu":
        return render_planes(row, st, steps)
    if row.device.type != "cuda":
        raise ValueError(f"no render path for device {row.device}")
    lib = _render_library(kmax_for(st.cfg.max_crossings))
    row = row.contiguous()
    n_planes = 4 if st.cfg.refine_band > 0.0 else 3
    shape = (n_planes, st.height, st.width)
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=row.device)
    elif (out.shape != shape or out.dtype != torch.float32
          or out.device != row.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous float32 {shape} tensor "
                         "on the row's device")
    c_st = _c_static(st)
    with torch.cuda.device(row.device):
        stream = torch.cuda.current_stream(row.device).cuda_stream
        err = lib.bh_render_launch(
            ctypes.c_void_p(row.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(0 if steps is None else steps.data_ptr()),
            ctypes.byref(c_st), ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(
            f"render kernel launch failed: {lib.bh_error_string(err).decode()}"
        )
    render_planes_kernel.launches += 1
    return out


render_planes_kernel.launches = 0

# The render kernel's pixel blocks (csrc/render.cu): a block of 4 warps
# covers 16 x 8 pixels, each warp an 8 x 4 patch.
_PATCH_W, _PATCH_H = 8, 4
_BLOCK_W, _BLOCK_H = 16, 8
_THREADS = 128


def launch_pixel_order(width: int, height: int,
                       device=None) -> torch.Tensor:
    """The render kernel's threads in launch order: for each, the row-major
    id of its pixel, or -1 where the frame's 16 x 8 blocks run past its
    edge. Thread p is lane p % 32 of warp (p // 32) % 4 of block p // 128,
    blocks row-major over the frame, so each run of 32 is one warp: an
    8 x 4 pixel patch."""
    gx = -(-width // _BLOCK_W)
    gy = -(-height // _BLOCK_H)
    p = torch.arange(gx * gy * _THREADS, device=device)
    block, q = p // _THREADS, p % _THREADS
    warp, lane = q // 32, q % 32
    x = (block % gx) * _BLOCK_W + (warp % 2) * _PATCH_W + lane % _PATCH_W
    y = (block // gx) * _BLOCK_H + (warp // 2) * _PATCH_H + lane // _PATCH_W
    return torch.where((x < width) & (y < height), y * width + x, -1)


def launch_steps(steps: torch.Tensor) -> torch.Tensor:
    """An (H, W) plane of per-pixel step counts in the render kernel's
    launch order (``launch_pixel_order``), 0 for the threads past the
    frame's edge."""
    order = launch_pixel_order(steps.shape[1], steps.shape[0], steps.device)
    flat = steps.reshape(-1)
    return torch.where(order >= 0, flat[order.clamp(min=0)], 0)


@functools.cache
def _render_library(kmax: int = KMAX_DEFAULT) -> ctypes.CDLL:
    """Build (at first use) and load csrc/render.cu with ``kmax`` crossing
    slots (``ops/build.kmax_for``)."""
    from blackhole_simulation_tpu_torch.ops.build import build

    lib = ctypes.CDLL(str(build("render.cu", kmax)))
    lib.bh_render_launch.argtypes = [ctypes.c_void_p] * 5
    lib.bh_render_launch.restype = ctypes.c_int
    lib.bh_render_shape.argtypes = [ctypes.c_void_p] * 2
    lib.bh_render_shape.restype = ctypes.c_int
    lib.bh_error_string.argtypes = [ctypes.c_int]
    lib.bh_error_string.restype = ctypes.c_char_p
    lib.bh_render_static_size.restype = ctypes.c_int
    if lib.bh_render_static_size() != ctypes.sizeof(_CRenderStatic):
        raise RuntimeError("RenderStatic differs between csrc/render.cu and "
                           "ops/render.py")
    return lib


def render_kernel_shape(st: RenderStatic) -> dict:
    """The launch shape of the render kernel's instantiation for ``st``,
    from the built library on the current device: threads per block,
    resident blocks and warps per SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and the SM count."""
    lib = _render_library(kmax_for(st.cfg.max_crossings))
    out = (ctypes.c_int * 3)()
    c_st = _c_static(st)
    err = lib.bh_render_shape(ctypes.byref(c_st), out)
    if err != 0:
        raise RuntimeError("render kernel shape query failed: "
                           f"{lib.bh_error_string(err).decode()}")
    threads, blocks, sms = out
    return {"threads": threads, "blocks_per_sm": blocks,
            "warps_per_sm": blocks * threads // 32, "sms": sms}
