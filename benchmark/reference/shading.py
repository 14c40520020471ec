"""The composite (frozen from the port's ``render/shading.py``,
``render/pipeline.py::_composite`` and ``ops/render.py::render_planes``'
composite): the thin disk's recorded crossings front to back (the
spectral branch, on Chebyshev tables of the Page-Thorne shape and the
Planck/CIE colour), the starfield
behind escaped rays and the photon-ring glow; and the spectral tables
themselves, built from the physics (``physics/disk.py``,
``physics/spectrum.py``) in float64."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from benchmark.reference.geodesic import ESCAPE
from benchmark.reference.numerics import (
    clip,
    const,
    cos,
    div_c,
    interp,
    maximum,
    sin,
    sqrt,
)

TWO_PI = 2.0 * math.pi
CHEB_K = 16
T_LO, T_HI = 900.0, 4e4


@dataclasses.dataclass(frozen=True)
class Disk:
    outer_radius: float = 18.0
    density: float = 0.7
    t_peak: float = 9000.0
    beaming_exponent: float = 4.0
    turbulence: float = 0.6
    inner_edge_softness: float = 0.35
    outer_falloff: float = 4.0


@dataclasses.dataclass(frozen=True)
class Stars:
    density: float = 0.0015
    brightness: float = 1.4
    nebula: float = 0.12
    cells: float = 160.0


def _fract(x):
    return x - torch.floor(x)


def hash21(x, y):
    """The float32 lattice hash, whatever the inputs' dtype."""
    x = x.float() + 0.5
    y = y.float() + 0.5
    px = _fract(x * 0.1031)
    py = _fract(y * 0.1030)
    pz = _fract((x + y) * 0.0973)
    d = px * (py + 33.33) + py * (pz + 33.33) + pz * (px + 33.33)
    return _fract((px + py + 2.0 * d) * (pz + d))


def _smooth(t):
    return t * t * (3.0 - 2.0 * t)


def atan2_approx(y, x):
    ax, ay = torch.abs(x), torch.abs(y)
    z = torch.minimum(ax, ay) / maximum(torch.maximum(ax, ay), 1e-30)
    z2 = z * z
    p = -0.0117212 * z2 + 0.0526477
    p = p * z2 + -0.1172626
    p = p * z2 + 0.1936999
    p = p * z2 + -0.3326231
    p = p * z2 + 0.9999798
    t = p * z
    t = torch.where(ay > ax, math.pi / 2 - t, t)
    t = torch.where(x < 0.0, math.pi - t, t)
    return torch.where(y < 0.0, -t, t)


def _pow4(x):
    x2 = x * x
    return x2 * x2


def value_noise2(x, y):
    xf, yf = torch.floor(x), torch.floor(y)
    tx, ty = _smooth(x - xf), _smooth(y - yf)
    c00 = hash21(xf, yf)
    c10 = hash21(xf + 1, yf)
    c01 = hash21(xf, yf + 1)
    c11 = hash21(xf + 1, yf + 1)
    return (c00 * (1 - tx) * (1 - ty) + c10 * tx * (1 - ty)
            + c01 * (1 - tx) * ty + c11 * tx * ty)


def fbm2(x, y, octaves: int = 4):
    total = torch.zeros_like(x)
    amp, freq = 0.5, 1.0
    for _ in range(octaves):
        total = total + amp * value_noise2(x * freq, y * freq)
        amp *= 0.5
        freq *= 2.0
    return total


def blackbody_ramp(t_kelvin):
    """Tanner-Helland-style T -> linear (r, g, b) chromaticity."""
    t = div_c(clip(t_kelvin, 1000.0, 40000.0), 100.0)
    red = torch.where(t <= 66.0, 255.0,
                      329.698727446 * maximum(t - 60.0, 1e-6) ** -0.1332047592)
    g_lo = 99.4708025861 * torch.log(maximum(t, 1e-6)) - 161.1195681661
    g_hi = 288.1221695283 * maximum(t - 60.0, 1e-6) ** -0.0755148492
    green = torch.where(t <= 66.0, g_lo, g_hi)
    b_lo = 138.5177312231 * torch.log(maximum(t - 10.0, 1e-6)) - 305.0447927307
    blue = torch.where(t >= 66.0, 255.0, torch.where(t <= 19.0, 0.0, b_lo))
    out = []
    for c in (red, green, blue):
        c = clip(div_c(c, 255.0), 0.0, 1.0)
        out.append(c * c)
    return tuple(out)


def g_factor(m, a, r, lam):
    """Cunningham g of a prograde Keplerian emitter at equatorial r."""
    r = maximum(r, 1.05)
    two_mr = 2.0 * m * r
    sig = r * r
    g_tt = -(1.0 - two_mr / sig)
    g_tph = -two_mr * a / sig
    g_phph = r * r + a * a + two_mr * a * a / sig
    sqrt_m = sqrt(m)
    omega = sqrt_m / (r * sqrt(r) + a * sqrt_m)
    ut_inv_sq = -(g_tt + 2.0 * omega * g_tph + omega * omega * g_phph)
    u_t = 1.0 / sqrt(maximum(ut_inv_sq, 1e-6))
    doppler = 1.0 - lam * omega
    doppler = torch.where(torch.abs(doppler) < 1e-4, 1e-4, doppler)
    return 1.0 / (u_t * doppler)


def _geometry(disk: Disk, m, a, r_in, r_c, phi_c, t_c, lam, octaves):
    valid = (r_c > r_in) & (r_c < disk.outer_radius)
    r_c = torch.where(valid, r_c, r_in * 2.0)
    phi_c = torch.where(valid, phi_c, 0.0)
    t_c = torch.where(valid, t_c, 0.0)
    g = clip(g_factor(m, a, torch.maximum(r_c, r_in), lam), 0.05, 5.0)
    rk = torch.maximum(r_c, r_in)
    omega_k = sqrt(m) / (rk * sqrt(rk) + a * sqrt(m))
    phase = torch.remainder(phi_c - omega_k * t_c, const(phi_c, TWO_PI))
    noise = fbm2(r_c * 1.7, phase * 3.0, octaves=octaves)
    turb = 1.0 - disk.turbulence + disk.turbulence * (0.4 + 1.2 * noise)
    inner = clip((r_c - r_in) / (disk.inner_edge_softness * r_in + 1e-6),
                 0.0, 1.0)
    edge = _smooth(inner) * clip(
        div_c(disk.outer_radius - r_c, 0.15 * disk.outer_radius), 0.0, 1.0)
    return valid, r_c, g, turb, edge


def cheb(coeffs, t):
    """Clenshaw's recurrence for a Chebyshev series at t in [-1, 1]."""
    b1 = torch.zeros_like(t)
    b2 = torch.zeros_like(t)
    for j in range(len(coeffs) - 1, 0, -1):
        b1, b2 = 2.0 * t * b1 - b2 + coeffs[j], b1
    return t * b1 - b2 + coeffs[0]


def spectral_slot(disk: Disk, m, a, r_in, tables, r_c, phi_c, t_c, lam,
                  octaves):
    """One crossing, spectral branch on the Chebyshev ``tables``
    (t_coeffs, rgb_coeffs, inv_logr) in the rows' dtype."""
    t_coeffs, rgb_coeffs, inv_logr = tables
    valid, r_c, g, turb, edge = _geometry(disk, m, a, r_in, r_c, phi_c, t_c,
                                          lam, octaves)
    x01 = torch.log(maximum(r_c / r_in, 1e-6)) * inv_logr
    tx = clip(2.0 * sqrt(clip(x01, 0.0, 1.0)) - 1.0, -1.0, 1.0)
    t_shape = clip(cheb(t_coeffs, tx), 0.0, 1.0)
    t_obs = clip(g * t_shape * disk.t_peak, T_LO, T_HI)
    ty = clip(2.0 * div_c(t_obs - T_LO, T_HI - T_LO) ** 0.4 - 1.0, -1.0, 1.0)
    color = tuple(maximum(cheb(rgb_coeffs[c], ty), 0.0) for c in range(3))
    alpha = torch.where(valid, clip(disk.density * edge * turb, 0.0, 1.0), 0.0)
    masked = torch.where(valid, _pow4(g) * _pow4(t_shape), 0.0)
    return tuple(c * masked for c in color), alpha, valid


def escape_direction(rows, m, a):
    """Unit direction (dx, dy, dz) of escaped u-chart rows."""
    _, r, u, ph, pt, pr, pu, pph = rows
    u = clip(u, -1.0, 1.0)
    w = maximum(1.0 - u * u, 1e-12)
    s = sqrt(w)
    sig = r * r + a * a * u * u
    delta = r * r - 2.0 * m * r + a * a
    inv_sig = 1.0 / sig
    h = 2.0 * m * r * inv_sig
    v_r = h * pt + delta * inv_sig * pr + a * inv_sig * pph
    v_th = -r * pu * s * inv_sig
    v_ph = r * s * (a * inv_sig * pr + pph * inv_sig / w)
    sp, cp = sin(ph), cos(ph)
    dx = v_r * s * cp + v_th * u * cp - v_ph * sp
    dy = v_r * s * sp + v_th * u * sp + v_ph * cp
    dz = v_r * u - v_th * s
    inv_n = 1.0 / sqrt(maximum(dx * dx + dy * dy + dz * dz, 1e-30))
    return dx * inv_n, dy * inv_n, dz * inv_n


def starfield(dx, dy, dz, params: Stars):
    u = atan2_approx(dy, dx)
    v = clip(dz, -1.0, 1.0)
    out = [torch.zeros_like(u) for _ in range(3)]
    for freq, scale in ((params.cells, 1.0), (params.cells * 0.35, 2.2)):
        cu = torch.floor(u * freq)
        cv = torch.floor(v * freq)
        star = (hash21(cu, cv) < params.density * scale * 300.0).to(u.dtype)
        fu = u * freq - cu - 0.5
        fv = v * freq - cv - 0.5
        spot = torch.exp(-(fu * fu + fv * fv) * 40.0)
        color = blackbody_ramp(3000.0 + 12000.0 * hash21(cu + 7, cv + 13))
        h_mag = hash21(cu + 31, cv + 5)
        w = star * spot * (h_mag * h_mag * h_mag)
        out = [acc + w * c for acc, c in zip(out, color)]
    nebula = fbm2(u * 3.0, v * 3.0, octaves=4)
    neb2 = nebula * nebula
    neb = (0.35 * neb2, 0.2 * neb2, 0.5 * nebula * sqrt(nebula))
    return tuple(params.brightness * acc + params.nebula * n
                 for acc, n in zip(out, neb))


_DUMMY = (0.0, 100.0, 0.0, 0.0, -1.0, -1.0, 0.0, 0.0)


def composite(carry, pph, lam, m, a, r_in, r_ph, disk: Disk, stars: Stars,
              features: dict, tables):
    """(r, g, b) rows of a finished march ``carry``: the disk slots (on the
    Chebyshev ``tables``), the starfield behind escaped rays, the
    photon-ring glow."""
    escaped = carry.hit == ESCAPE
    zero = torch.zeros_like(lam)
    rgb, trans = (zero, zero, zero), zero + 1.0
    if features.get("disk", True):
        for k in range(len(carry.cr)):
            octaves = 3 if k == 0 else 1
            c_rgb, alpha, valid = spectral_slot(
                disk, m, a, r_in, tables, carry.cr[k], carry.cp[k],
                carry.ct[k], lam, octaves)
            on = (k < carry.nc) & valid
            w = torch.where(on, trans * alpha, 0.0)
            rgb = tuple(acc + w * c for acc, c in zip(rgb, c_rgb))
            trans = torch.where(on, trans * (1.0 - alpha), trans)
    if features.get("starfield", True):
        t, r, u, ph, pr, pu = carry.y6
        fin = (t, r, u, ph, zero - 1.0, pr, pu, pph)
        srows = tuple(torch.where(escaped, fin[i], _DUMMY[i]) for i in range(8))
        bg = starfield(*escape_direction(srows, m, a), stars)
        w_bg = torch.where(escaped, trans, 0.0)
        rgb = tuple(c + w_bg * b for c, b in zip(rgb, bg))
    if features.get("photon_ring_glow", True):
        near = torch.exp(-14.0 * carry.rmin / maximum(r_ph, 1e-3))
        glow = torch.where(escaped, 0.6 * near, 0.0)
        order = div_c(torch.clamp(carry.nc, 0, 3).to(lam.dtype), 3.0)
        rgb = tuple(c + glow * (w + order * (k - w)) for c, w, k in
                    zip(rgb, (1.0, 0.82, 0.55), (0.82, 0.88, 1.0)))
    return rgb


# ---------------------------------------------------------------------------
# The spectral disk's tables, from the physics, in float64
# ---------------------------------------------------------------------------

_C, _H, _KB = 299_792_458.0, 6.626_070_15e-34, 1.380_649e-23
_XYZ_TO_RGB = np.array([[3.2406, -1.5372, -0.4986],
                        [-0.9689, 1.8758, 0.0415],
                        [0.0557, -0.2040, 1.0570]])


def _gauss(x, mu, s1, s2):
    t = (x - mu) / np.where(x < mu, s1, s2)
    return np.exp(-0.5 * t * t)


def blackbody_rgb(t_kelvin):
    """Chromaticity-normalized linear sRGB of a blackbody: Planck against
    the CIE fits over 380-780 nm."""
    t = np.maximum(np.asarray(t_kelvin, np.float64), 1e-6)
    lam_nm = np.linspace(380.0, 780.0, 81)
    lam_m = lam_nm * 1e-9
    x = np.minimum(_H * _C / (lam_m * _KB * t[..., None]), 700.0)
    b = (2.0 * _H * _C * _C / lam_m ** 5) / np.expm1(x)
    bars = np.stack([
        1.056 * _gauss(lam_nm, 599.8, 37.9, 31.0)
        + 0.362 * _gauss(lam_nm, 442.0, 16.0, 26.7)
        - 0.065 * _gauss(lam_nm, 501.1, 20.4, 26.2),
        0.821 * _gauss(lam_nm, 568.8, 46.9, 40.5)
        + 0.286 * _gauss(lam_nm, 530.9, 16.3, 31.1),
        1.217 * _gauss(lam_nm, 437.0, 11.8, 36.0)
        + 0.681 * _gauss(lam_nm, 459.0, 26.0, 13.8)])
    xyz = np.trapezoid(b[..., None, :] * bars, lam_nm, axis=-1)
    xyz = xyz / np.maximum(xyz[..., 1:2], 1e-30)
    return np.clip(np.einsum("ij,...j->...i", _XYZ_TO_RGB, xyz), 0.0, None)


def _orbit(m, a, r):
    """(E, L_z, Omega) of prograde circular equatorial orbits."""
    x = torch.sqrt(m / r)
    den = torch.sqrt(torch.clamp(1.0 - 3.0 * x * x + 2.0 * a * x ** 3 / m,
                                 min=1e-12))
    e = (1.0 - 2.0 * x * x + a * x ** 3 / m) / den
    lz = r * x * (1.0 - 2.0 * a * x ** 3 / m + (a / r) ** 2) / den
    om = math.sqrt(m) / (r ** 1.5 + a * math.sqrt(m))
    return e, lz, om


def _d_dr(fn, r):
    with torch.enable_grad():
        rr = r.detach().clone().requires_grad_(True)
        (g,) = torch.autograd.grad(fn(rr).sum(), rr)
    return g.detach()


def _isco64(m: float, a: float) -> float:
    s = abs(max(min(a / m, 1.0), -1.0))
    z1 = 1.0 + (1.0 - s * s) ** (1 / 3) * ((1.0 + s) ** (1 / 3)
                                            + (1.0 - s) ** (1 / 3))
    z2 = math.sqrt(3.0 * s * s + z1 * z1)
    return m * (3.0 + z2 - math.sqrt(max((3.0 - z1) * (3.0 + z1 + 2.0 * z2),
                                         0.0)))


def page_thorne_flux(r, m: float, a: float, n_grid: int):
    """Page-Thorne flux on float64 tensors r (cumulative trapezoid from the
    ISCO on a log grid, interpolated)."""
    r_isco = torch.tensor(_isco64(m, a), dtype=torch.float64)
    r_max = torch.maximum(torch.amax(r), r_isco * 2.0) * 1.001
    ts = torch.linspace(0.0, 1.0, n_grid, dtype=torch.float64)
    grid = r_isco * (r_max / r_isco) ** ts
    e_g, l_g, om_g = _orbit(m, a, grid)
    vals = (e_g - om_g * l_g) * _d_dr(lambda x: _orbit(m, a, x)[1], grid)
    panels = 0.5 * (vals[1:] + vals[:-1]) * torch.diff(grid)
    cum = torch.cat([torch.zeros(1, dtype=torch.float64),
                     torch.cumsum(panels, 0)])
    integral = interp(r, grid, cum)
    e, lz, om = _orbit(m, a, r)
    dom = _d_dr(lambda x: _orbit(m, a, x)[2], r)
    flux = (-(1.0 / (4.0 * math.pi * r)) * dom
            / torch.clamp((e - om * lz) ** 2, min=1e-30) * integral)
    return torch.where(r > r_isco, torch.clamp(flux, min=0.0), 0.0)


def spectral_tables(m: float, a: float, disk: Disk, n_r: int = 256,
                    n_t: int = 128):
    """Chebyshev coefficients (t_coeffs (K,), rgb_coeffs (3, K)) and
    1 / log(r_out / r_in), as float32 numpy arrays, from the float64 tables
    of the Page-Thorne shape (log-r grid from the ISCO to the disk edge) and
    the blackbody colour (T^2.5-warped axis)."""
    r_in = torch.tensor(_isco64(m, a), dtype=torch.float64)
    ts = torch.as_tensor(np.linspace(0.0, 1.0, n_r))
    r_grid = r_in * (disk.outer_radius / r_in) ** ts
    t_raw = torch.clamp(page_thorne_flux(r_grid, m, a, n_r), min=0.0) ** 0.25
    t_shape = t_raw / torch.clamp(torch.amax(t_raw), min=1e-30)
    t_axis = 900.0 + (4e4 - 900.0) * np.linspace(0.0, 1.0, n_t) ** 2.5
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    r_grid, t_shape = f32(r_grid.numpy()), f32(t_shape.numpy())
    t_axis, rgb_table = f32(t_axis), f32(blackbody_rgb(t_axis))
    k = torch.arange(CHEB_K, dtype=torch.float32)
    nodes = cos(div_c(math.pi * (k + 0.5), CHEB_K))
    x01 = 0.5 * (nodes + 1.0)
    r_nodes = r_grid[0] * (r_grid[-1] / r_grid[0]) ** (x01 * x01)
    t_vals = interp(r_nodes, r_grid, t_shape)
    t_nodes = T_LO + (T_HI - T_LO) * x01 ** 2.5
    rgb_vals = torch.stack([interp(t_nodes, t_axis,
                                   rgb_table[:, c].contiguous())
                            for c in range(3)])
    dct = cos(div_c(math.pi * k[:, None] * (k[None, :] + 0.5), CHEB_K))

    def proj(v):
        c = (2.0 / CHEB_K) * (v[None, :] * dct).sum(dim=1)
        c[0] = c[0] * 0.5
        return c

    inv_logr = 1.0 / torch.log(r_grid[-1] / r_grid[0])
    return (proj(t_vals).numpy(),
            torch.stack([proj(rgb_vals[c]) for c in range(3)]).numpy(),
            np.asarray(inv_logr.numpy(), np.float32))


def tables_on(tables, dtype, device):
    """Chebyshev tables as (lists of) 0-d tensors of ``dtype``."""
    tc, rc, il = (torch.as_tensor(np.asarray(x), device=device).to(dtype)
                  for x in tables)
    return ([tc[j] for j in range(CHEB_K)],
            [[rc[c, j] for j in range(CHEB_K)] for c in range(3)], il)
