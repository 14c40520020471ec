"""Shadow-interior precull and the critical-band metric: the critical curve
as a Chebyshev series.

Counterpart of ``blackhole_simulation_tpu/render/precull.py:49-116``,
``_cheb_eval`` (:109), ``capture_mask`` (:119, the packed theta form),
``capture_mask_u`` (:157), ``band_metric_values``
(:180), ``pole_w_min_values`` (:199), ``fold_pole_metric`` (:216),
``critical_band_metric_u`` (:227) and ``_capture_core`` (:261).

A ray whose conserved (lambda, eta) lies inside the Bardeen critical curve
is provably captured; one close to it is in the chaotic capture/escape band
that the refinement pass (``render/pipeline.py::refine_critical_band``)
re-marches. The render kernel tests that per pixel against a
``_CHEB_K``-term Chebyshev fit of eta_c(lambda), built once per frame on the
host in float64 (``_eta_crit_cheb_coeffs``). The staged and training paths
test it on their (8, N) rays with ``capture_mask_u``, whose fit is built in
float32 as the JAX package builds it from float32 mass and spin
(``_eta_crit_cheb_coeffs_f32``, on the host: 32 scalars per call).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from blackhole_simulation_tpu_torch._elementwise import (
    const,
    cos,
    div_c,
    sin,
    sqrt,
)
from blackhole_simulation_tpu_torch.perf import spans

# Chebyshev fit of the critical curve eta_c(lam): terms, and the bound on
# |fit - exact| over a in [0.1, 0.999] that the cull subtracts so it can only
# be more conservative than the exact test.
_CHEB_K = 32
_CHEB_ERR = 0.03


def _lam_c(m, a, s):
    """Critical lambda of the spherical photon orbit at radius s."""
    return (s * s * (3.0 * m - s) - a * a * (m + s)) / (a * (s - m))


def _eta_c(m, a, s):
    """Critical eta of the spherical photon orbit at radius s."""
    sm = s - m
    return s**3 * (4.0 * a * a * m - s * (s - 3.0 * m) ** 2) / (a * a * sm * sm)


def photon_orbit_radii(m, a):
    """Pro/retrograde equatorial circular photon radii
    r = 2M {1 + cos[(2/3) arccos(-+ a/M)]}."""
    x = np.clip(a / m, -1.0, 1.0)
    s_pro = 2.0 * m * (1.0 + np.cos(2.0 / 3.0 * np.arccos(-x)))
    s_retro = 2.0 * m * (1.0 + np.cos(2.0 / 3.0 * np.arccos(x)))
    return s_pro, s_retro


def _eta_crit_cheb_coeffs(m, a):
    """Chebyshev interpolation of eta_c(lam) along the critical curve, float64.

    Bisects s*(lam) at the K Chebyshev nodes of [lam_lo, lam_hi], then
    projects eta_c(s*) by a DCT. Returns (coeffs (K,), mid, half, lam_lo,
    lam_hi) where the series variable is t = (lam - mid) / half.
    """
    m = np.float64(m)
    a = np.float64(a)
    s_pro, s_retro = photon_orbit_radii(m, a)
    lam_hi = _lam_c(m, a, s_pro)
    lam_lo = _lam_c(m, a, s_retro)
    mid = 0.5 * (lam_hi + lam_lo)
    half = 0.5 * (lam_hi - lam_lo)
    k = np.arange(_CHEB_K, dtype=np.float64)
    x = np.cos(np.pi * (k + 0.5) / _CHEB_K)
    lam_k = mid + half * x
    lo = np.full(lam_k.shape, s_pro)
    hi = np.full(lam_k.shape, s_retro)
    for _ in range(40):
        s_mid = 0.5 * (lo + hi)
        go_right = _lam_c(m, a, s_mid) > lam_k
        lo = np.where(go_right, s_mid, lo)
        hi = np.where(go_right, hi, s_mid)
    eta_k = _eta_c(m, a, 0.5 * (lo + hi))
    dct = np.cos(np.pi * k[:, None] * (k[None, :] + 0.5) / _CHEB_K)
    coeffs = (2.0 / _CHEB_K) * (eta_k[None, :] * dct).sum(axis=1)
    coeffs[0] *= 0.5
    return coeffs, mid, half, lam_lo, lam_hi


def _acos_f32(x: torch.Tensor) -> torch.Tensor:
    return torch.arccos(x.double()).to(x.dtype)


def _eta_crit_cheb_coeffs_f32(m: torch.Tensor, a: torch.Tensor):
    """``_eta_crit_cheb_coeffs`` in float32 on the host from 0-d float32
    tensors, operation by operation as the JAX twin runs on float32 inputs
    (transcendentals correctly rounded). Returns (coeffs (K,), mid, half,
    lam_lo, lam_hi) as float32 CPU tensors."""
    m = m.detach().float().cpu()
    a = a.detach().float().cpu()
    x = torch.clamp(a / m, -1.0, 1.0)
    s_pro = 2.0 * m * (1.0 + cos(2.0 / 3.0 * _acos_f32(-x)))
    s_retro = 2.0 * m * (1.0 + cos(2.0 / 3.0 * _acos_f32(x)))

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
    k = torch.arange(_CHEB_K, dtype=torch.float32)
    xk = cos(div_c(math.pi * (k + 0.5), float(_CHEB_K)))
    lam_k = mid + half * xk
    lo = s_pro.expand(_CHEB_K).clone()
    hi = s_retro.expand(_CHEB_K).clone()
    for _ in range(40):
        s_mid = 0.5 * (lo + hi)
        go_right = lam_c(s_mid) > lam_k
        lo = torch.where(go_right, s_mid, lo)
        hi = torch.where(go_right, hi, s_mid)
    eta_k = eta_c(0.5 * (lo + hi))
    dct = cos(div_c(math.pi * k[:, None] * (k[None, :] + 0.5), float(_CHEB_K)))
    coeffs = (2.0 / _CHEB_K) * (eta_k[None, :] * dct).sum(dim=1)
    coeffs[0] = coeffs[0] * 0.5
    return coeffs, mid, half, lam_lo, lam_hi


def _fit_on(m: torch.Tensor, a: torch.Tensor, device):
    """``_eta_crit_cheb_coeffs_f32`` of ``m`` and ``a``, its five tensors on
    ``device``. With CUDA tensors each copy (mass and spin read back, the
    five tensors copied up) waits for the stream: in a request that
    ``perf/spans.py`` records, each counts one ``stream_syncs``."""
    fit = tuple(x.to(device) for x in _eta_crit_cheb_coeffs_f32(m, a))
    if spans.on:
        n = (int(m.is_cuda) + int(a.is_cuda)
             + len(fit) * (torch.device(device).type == "cuda"))
        if n:
            spans.count("stream_syncs", n)
    return fit


def _cheb_eval(coeffs, mid, half, lam):
    """Clenshaw evaluation of the Chebyshev series at lam (rows)."""
    t = torch.clamp((lam - mid) / half, -1.0, 1.0)
    b1 = torch.zeros_like(t)
    b2 = torch.zeros_like(t)
    for j in range(_CHEB_K - 1, 0, -1):
        b1, b2 = 2.0 * t * b1 - b2 + coeffs[j], b1
    return t * b1 - b2 + coeffs[0]


@torch.no_grad()
def capture_mask(m, a, y0: torch.Tensor, margin: float = 0.04):
    """(N,) bool: True where the ray of the (N, 8) theta-form states
    (t, r, theta, phi, p_t, p_r, p_theta, p_phi) is provably captured (with
    margin). ``m``, ``a``: numbers or 0-d tensors (the signed spin; the fit
    uses |a| clamped to [1e-3, 0.999] M)."""
    dtype = y0.dtype
    m = torch.as_tensor(m).detach().to(y0.device, dtype)
    a_signed = torch.as_tensor(a).detach().to(y0.device, dtype)
    flip = torch.where(a_signed < 0.0, -1.0, 1.0).to(dtype)
    a_c = torch.minimum(torch.maximum(torch.abs(a_signed), 1e-3 * m), 0.999 * m)
    y0t = y0.T
    th = y0t[2]
    pt, pth, pph = y0t[4], y0t[6], y0t[7]
    e = -pt
    inv_e = 1.0 / torch.where(torch.abs(e) < 1e-12, 1.0, e)
    lam = flip * pph * inv_e
    s = sin(th)
    c = cos(th)
    s2 = torch.clamp(s * s, min=1e-12)
    c2 = c * c
    return _capture_core(m, a_c, a_signed, y0t[1], s2, c2, pt, y0t[5],
                         pth * pth, pph, lam, inv_e, margin)


def capture_mask_u(m, a, yt_u: torch.Tensor, margin: float = 0.04):
    """(N,) bool: True where the ray of the (8, N) u-chart rows is provably
    captured (with margin). ``m``, ``a``: 0-d float32 tensors (the signed
    spin; the fit uses |a| clamped to [1e-3, 0.999] M)."""
    m = m.detach().to(yt_u.dtype)
    a_signed = a.detach().to(yt_u.dtype)
    flip = torch.where(a_signed < 0.0, -1.0, 1.0).to(yt_u.dtype)
    a_c = torch.minimum(torch.maximum(torch.abs(a_signed), 1e-3 * m), 0.999 * m)
    u = yt_u[2]
    pt, pu, pph = yt_u[4], yt_u[6], yt_u[7]
    e = -pt
    inv_e = 1.0 / torch.where(torch.abs(e) < 1e-12, 1.0, e)
    lam = flip * pph * inv_e
    w = 1.0 - u * u
    s2 = torch.clamp(w, min=1e-12)
    c2 = u * u
    return _capture_core(m, a_c, a_signed, yt_u[1], s2, c2, pt, yt_u[5],
                         pu * pu * w, pph, lam, inv_e, margin)


def band_metric_values(m, eta, eta_crit_raw, lam, lam_lo, lam_hi):
    """Distance of (lam, eta) to the critical curve in M^2 units: |eta -
    eta_c(lam)| / M^2, plus a steep penalty for lam outside [lam_lo,
    lam_hi]. ``eta_crit_raw`` is the Chebyshev curve without the cull's
    _CHEB_ERR shift. Small values mark the chaotic capture/escape band.
    Shared by ``critical_band_metric_u`` and the render kernel's band
    plane (``ops/render.py::render_planes``)."""
    m2 = m * m
    d_eta = torch.abs(eta - eta_crit_raw) / m2
    excess = torch.maximum(lam - lam_hi, lam_lo - lam)
    d_lam = torch.clamp(excess, min=0.0) * (const(m, 4.0) / m)
    return d_eta + d_lam


def pole_w_min_values(m, a, lam, eta):
    """The least w = sin^2(theta) a ray of conserved (lam, eta) reaches, in
    closed form from the zero of the theta potential (E = 1)."""
    a2 = torch.clamp(a * a, min=1e-12)
    b2 = a2 - eta - lam * lam
    disc = sqrt(torch.clamp(b2 * b2 + 4.0 * a2 * eta, min=0.0))
    umax2 = torch.clamp((b2 + disc) / (2.0 * a2), 0.0, 1.0)
    return 1.0 - umax2


def fold_pole_metric(d_band, w_min, refine_band: float, refine_pole_w: float):
    """Fold the pole criterion into the band metric so that one threshold
    (``refine_band``) selects both families: w_min < refine_pole_w maps
    below it."""
    if refine_pole_w <= 0.0:
        return d_band
    scale = refine_band / refine_pole_w
    return torch.minimum(d_band, w_min * scale)


@torch.no_grad()
def critical_band_metric_u(m, a, yt_u: torch.Tensor, refine_band: float = 0.0,
                           refine_pole_w: float = 0.0) -> torch.Tensor:
    """(N,) band metric of the (8, N) u-chart rows (``band_metric_values``),
    with the pole criterion folded in when ``refine_pole_w`` > 0. The same
    conserved quantities as ``capture_mask_u``: q with the signed spin and
    eta = q / E^2 (the render kernel's plane takes eta = q, E = 1)."""
    m = m.detach().to(yt_u.dtype)
    a_signed = a.detach().to(yt_u.dtype)
    flip = torch.where(a_signed < 0.0, -1.0, 1.0).to(yt_u.dtype)
    a_c = torch.minimum(torch.maximum(torch.abs(a_signed), 1e-3 * m), 0.999 * m)
    u = yt_u[2]
    pt, pu, pph = yt_u[4], yt_u[6], yt_u[7]
    e = -pt
    inv_e = 1.0 / torch.where(torch.abs(e) < 1e-12, 1.0, e)
    lam = flip * pph * inv_e
    w = 1.0 - u * u
    s2 = torch.clamp(w, min=1e-12)
    c2 = u * u
    q = pu * pu * w + c2 * (pph * pph / s2 - a_signed * a_signed * pt * pt)
    eta = q * inv_e * inv_e
    coeffs, c_mid, c_half, lam_lo, lam_hi = _fit_on(m, a_c, yt_u.device)
    eta_crit_raw = _cheb_eval(coeffs, c_mid, c_half, lam)
    d = band_metric_values(m, eta, eta_crit_raw, lam, lam_lo, lam_hi)
    if refine_pole_w > 0.0:
        d = fold_pole_metric(d, pole_w_min_values(m, a_c, lam, eta),
                             refine_band, refine_pole_w)
    return d


def _capture_core(m, a, a_signed, r0, s2, c2, pt, pr, pth2, pph, lam, inv_e,
                  margin):
    q = pth2 + c2 * (pph * pph / s2 - a_signed * a_signed * pt * pt)
    eta = q * inv_e * inv_e
    coeffs, c_mid, c_half, lam_lo, lam_hi = _fit_on(m, a, r0.device)
    in_range = (lam > lam_lo) & (lam < lam_hi)
    eta_crit = _cheb_eval(coeffs, c_mid, c_half, lam) - _CHEB_ERR * m * m
    inside = eta < eta_crit * (1.0 - margin) - margin * m * m
    ssq = r0 * r0 + a_signed * a_signed * c2
    delta = r0 * r0 - 2.0 * m * r0 + a_signed * a_signed
    dr_dlam = (2.0 * m * r0 * pt + delta * pr + a_signed * pph) / ssq
    return in_range & inside & (eta >= 0.0) & (dr_dlam < 0.0)
