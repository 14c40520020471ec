"""Shading: thin-disk emission with GR redshift, blackbody colour, starfield.

Counterpart of ``blackhole_simulation_tpu/render/shading.py``. These are the
plain PyTorch versions of what the render kernel (``csrc/render.cu``)
computes per pixel, and the staged path's composite (``shade_crossings_rows``
:702, ``disk_emission_cheb_rows`` :562), and the march's per-step jet
emission (``jet_emission_step`` :782), written expression for expression
like the JAX twins so
that rounding matches: the same operation order, float32 throughout, scalar
inputs (mass, spin, ISCO radius) as 0-dim float32 tensors, and constants
rounded to float32 where the JAX code rounds them.

The host-side float64 tables (``build_disk_luts``, ``spectral_cheb_coeffs``,
``spectral_kernel_tables``) feed the spectral disk: 65 Chebyshev scalars per
scene that the kernel reads from its parameter row. A staged scene without
them shades its spectral disk from the tables themselves
(``disk_emission_lut_rows`` :472, the reference's LUT route).

The oracle shades in float64 (``render/pipeline.py::shade_sample``): every
function here computes in its rows' dtype, and only the lattice hash rounds
through float32, as the JAX twin's does. ``shade_disk_crossings`` (:664),
``escape_direction_rows`` (:827) and ``escape_direction`` (:888) shade the
oracle's theta-form ``MarchResult``. ``hash31`` (:62) is the 3-D lattice
hash; ``blackbody_ramp`` (:190), ``disk_emission`` (:324),
``disk_emission_lut`` (:654) and ``starfield`` (:931) stack the row
functions' channels on a last axis, as the JAX twin's wrappers do.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from blackhole_simulation_tpu_torch._elementwise import (
    attach,
    clip,
    const,
    cos,
    div_c,
    exp,
    grad_wanted,
    host,
    interp,
    leaf,
    maximum,
    pow_,
    sin,
    sqrt,
)

TWO_PI = 2.0 * math.pi
# Analytic peak of the Novikov-Thorne shape, at r / r_in = 49/36.
_XP = 49.0 / 36.0
NT_PEAK = (1.0 - (1.0 / _XP) ** 0.5) ** 0.25 * _XP ** -0.75


# ---------------------------------------------------------------------------
# Static configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DiskParams:
    """Static disk configuration."""

    outer_radius: float = 18.0
    density: float = 0.7
    t_peak: float = 9000.0
    beaming_exponent: float = 4.0
    turbulence: float = 0.6
    inner_edge_softness: float = 0.35
    outer_falloff: float = 4.0
    artistic_rgb: tuple | None = None


@dataclasses.dataclass(frozen=True)
class JetParams:
    """Relativistic jet cones along the spin axis: optically thin emission
    that the march accumulates per step (``jet_emission_step``)."""

    beta: float = 0.92
    beaming_exponent: float = 3.5
    core_radius: float = 0.6
    opening_slope: float = 0.22
    z_min: float = 1.2
    z_max: float = 24.0
    density: float = 0.012
    turbulence: float = 0.5

    @property
    def gamma(self) -> float:
        """The bulk Lorentz factor, in float64 (the JAX twin forms it from
        Python floats and rounds it to float32 where it meets a row)."""
        return 1.0 / math.sqrt(1.0 - self.beta * self.beta)


@dataclasses.dataclass(frozen=True)
class StarfieldParams:
    density: float = 0.0015
    brightness: float = 1.4
    nebula: float = 0.12
    cells: float = 160.0


# ---------------------------------------------------------------------------
# Lattice hash noise
# ---------------------------------------------------------------------------

def _fract(x):
    return x - torch.floor(x)


def hash21(x, y):
    """2-D lattice hash -> float32 in [0, 1) (fractional-arithmetic hash),
    of float32 inputs whatever their dtype, as the JAX twin casts them.
    A hash turns any rounding difference into a different value: every
    operation here rounds on its own, in this order, in the kernel too."""
    x = x.float() + 0.5
    y = y.float() + 0.5
    px = _fract(x * 0.1031)
    py = _fract(y * 0.1030)
    pz = _fract((x + y) * 0.0973)
    d = px * (py + 33.33) + py * (pz + 33.33) + pz * (px + 33.33)
    return _fract((px + py + 2.0 * d) * (pz + d))


def hash31(x, y, z):
    """3-D lattice hash -> float32 in [0, 1), of float32 inputs whatever
    their dtype."""
    x = torch.as_tensor(x).float() + 0.5
    y = torch.as_tensor(y).float() + 0.5
    z = torch.as_tensor(z).float() + 0.5
    px = _fract(x * 0.1031)
    py = _fract(y * 0.1030)
    pz = _fract(z * 0.0973)
    d = px * (py + 33.33) + py * (pz + 33.33) + pz * (px + 33.33)
    return _fract((px + py + 2.0 * d) * (pz + d))


def _smooth(t):
    return t * t * (3.0 - 2.0 * t)


def atan2_approx(y, x):
    """Polynomial atan2 (max error ~2e-7 rad), the JAX package's own form so
    that star positions agree exactly."""
    ax = torch.abs(x)
    ay = torch.abs(y)
    hi = torch.maximum(ax, ay)
    lo = torch.minimum(ax, ay)
    z = lo / maximum(hi, 1e-30)
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


def _powi_plan(p: float):
    """How _powi evaluates x**p: (k, n, negative) for p * 2**k = +-n, an
    integer of at most 16 (k square roots, then n by binary powers), or None
    for a plain pow. The render kernel takes the same plan from the host."""
    for k in range(3):
        pk = p * (1 << k)
        if float(pk).is_integer() and abs(pk) <= 16:
            return k, int(abs(pk)), p < 0
    return None


def _powi(x, p: float):
    """x**p by square roots and products when p is a multiple of 0.25 (the
    JAX twin's exact chain), else a plain pow. Requires x >= 0."""
    plan = _powi_plan(p)
    if plan is None:
        return x**p
    k, n, negative = plan
    base = x
    for _ in range(k):
        base = sqrt(base)
    acc, bit = None, base
    while n:
        if n & 1:
            acc = bit if acc is None else acc * bit
        bit = bit * bit
        n >>= 1
    if acc is None:
        acc = torch.ones_like(x)
    return 1.0 / acc if negative else acc


def _pow4(x):
    """x**4 as jax.lax.integer_pow computes it: (x*x)*(x*x)."""
    x2 = x * x
    return x2 * x2


def value_noise2(x, y):
    """Smoothed 2-D value noise in [0, 1)."""
    xf, yf = torch.floor(x), torch.floor(y)
    tx, ty = _smooth(x - xf), _smooth(y - yf)
    c00 = hash21(xf, yf)
    c10 = hash21(xf + 1, yf)
    c01 = hash21(xf, yf + 1)
    c11 = hash21(xf + 1, yf + 1)
    return (
        c00 * (1 - tx) * (1 - ty)
        + c10 * tx * (1 - ty)
        + c01 * (1 - tx) * ty
        + c11 * tx * ty
    )


def fbm2(x, y, octaves: int = 4):
    """Fractal value noise: ``octaves`` octaves of value_noise2."""
    total = torch.zeros_like(x)
    amp, freq = 0.5, 1.0
    for _ in range(octaves):
        total = total + amp * value_noise2(x * freq, y * freq)
        amp *= 0.5
        freq *= 2.0
    return total


# ---------------------------------------------------------------------------
# Blackbody colour ramp (analytic disk)
# ---------------------------------------------------------------------------

def blackbody_ramp_rows(t_kelvin):
    """Analytic blackbody T -> linear RGB (r, g, b) rows (Tanner-Helland-style
    fit on 1000-40000 K); chromaticity only."""
    t = div_c(clip(t_kelvin, 1000.0, 40000.0), 100.0)
    red = torch.where(
        t <= 66.0, 255.0,
        329.698727446 * maximum(t - 60.0, 1e-6) ** -0.1332047592,
    )
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


def blackbody_ramp(t_kelvin):
    """(..., 3) stack of blackbody_ramp_rows."""
    return torch.stack(blackbody_ramp_rows(t_kelvin), dim=-1)


# ---------------------------------------------------------------------------
# Thin accretion disk
# ---------------------------------------------------------------------------

def nt_temperature_profile(r, r_in):
    """Zero-torque Novikov-Thorne temperature shape
    (1 - sqrt(r_in/r))^{1/4} (r_in/r)^{3/4}, normalized to peak 1."""
    x = maximum(r / r_in, 1.0 + 1e-6)
    shape = _powi(1.0 - sqrt(1.0 / x), 0.25) * _powi(x, -0.75)
    return div_c(shape, NT_PEAK)


def equatorial_g_factor(m, a, r, lam):
    """Cunningham g-factor for a prograde Keplerian emitter at equatorial r
    seen by a photon with conserved lam = L_z/E."""
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


def _disk_geometry(disk, m, a, r_in, r_c, phi_c, t_c, lam, octaves):
    """The parts shared by both disk branches: sanitized crossing record,
    clipped g-factor, noise turbulence and soft radial edges."""
    valid = (r_c > r_in) & (r_c < disk.outer_radius)
    r_c = torch.where(valid, r_c, r_in * 2.0)
    phi_c = torch.where(valid, phi_c, 0.0)
    t_c = torch.where(valid, t_c, 0.0)
    g = equatorial_g_factor(m, a, torch.maximum(r_c, r_in), lam)
    g = clip(g, 0.05, 5.0)
    rk = torch.maximum(r_c, r_in)
    omega_k = sqrt(m) / (rk * sqrt(rk) + a * sqrt(m))
    phase = phi_c - omega_k * t_c
    phase = torch.remainder(phase, const(phase, TWO_PI))
    noise = fbm2(r_c * 1.7, phase * 3.0, octaves=octaves)
    turb = 1.0 - disk.turbulence + disk.turbulence * (0.4 + 1.2 * noise)
    inner = clip(
        (r_c - r_in) / (disk.inner_edge_softness * r_in + 1e-6), 0.0, 1.0
    )
    edge = _smooth(inner) * clip(
        div_c(disk.outer_radius - r_c, 0.15 * disk.outer_radius), 0.0, 1.0
    )
    return valid, r_c, g, turb, edge


def disk_emission_rows(disk: DiskParams, m, a, r_in, r_c, phi_c, t_c, lam,
                       octaves: int = 3, density_scale=1.0,
                       intensity_scale=1.0):
    """Shade one recorded disk crossing, analytic branch:
    ((r, g, b) rows, alpha, valid). Novikov-Thorne temperature shape and the
    Tanner-Helland ramp; g^beaming intensity. ``m``, ``a``, ``r_in`` are 0-dim
    tensors (the JAX twin takes a Kerr and an optional r_in).
    ``density_scale`` / ``intensity_scale`` (0-dim tensors in training)
    multiply the opacity and the intensity where the JAX twin does; at 1.0
    they change nothing."""
    valid, r_c, g, turb, edge = _disk_geometry(
        disk, m, a, r_in, r_c, phi_c, t_c, lam, octaves
    )
    t_shape = nt_temperature_profile(
        torch.maximum(r_c, r_in * (1 + 1e-4)), r_in
    )
    if disk.artistic_rgb is not None:
        color = tuple(torch.full_like(r_c, c) for c in disk.artistic_rgb)
    else:
        t_obs = clip(g * t_shape * disk.t_peak, 1000.0, 40000.0)
        color = blackbody_ramp_rows(t_obs)
    outer = _powi(torch.maximum(r_in, r_c) / r_in, -disk.outer_falloff * 0.5)
    alpha = clip(disk.density * density_scale * edge * turb, 0.0, 1.0)
    alpha = torch.where(valid, alpha, 0.0)
    intensity = (_powi(g, disk.beaming_exponent) * _pow4(t_shape) * outer
                 * intensity_scale)
    masked = torch.where(valid, intensity, 0.0)
    return tuple(c * masked for c in color), alpha, valid


def disk_emission(disk: DiskParams, m, a, r_c, phi_c, t_c, lam,
                  density_scale=1.0, intensity_scale=1.0, octaves: int = 3,
                  r_in=None):
    """disk_emission_rows with the rgb rows stacked: ((..., 3) rgb, alpha,
    valid). ``r_in`` defaults to the prograde ISCO of (m, a)."""
    from blackhole_simulation_tpu_torch.geometry.metrics import isco_t

    r_in = isco_t(m, a).to(r_c.dtype) if r_in is None else r_in
    rgb, alpha, valid = disk_emission_rows(
        disk, m, a, r_in, r_c, phi_c, t_c, lam, octaves, density_scale,
        intensity_scale)
    return torch.stack(rgb, dim=-1), alpha, valid


SPECTRAL_CHEB_K = 16
SPECTRAL_T_LO = 900.0
SPECTRAL_T_HI = 4e4


def cheb_clenshaw(coeffs, t):
    """Chebyshev series at t in [-1, 1] by Clenshaw's recurrence;
    ``coeffs`` is a sequence of 0-dim tensors (or numbers)."""
    b1 = torch.zeros_like(t)
    b2 = torch.zeros_like(t)
    for j in range(len(coeffs) - 1, 0, -1):
        b1, b2 = 2.0 * t * b1 - b2 + coeffs[j], b1
    return t * b1 - b2 + coeffs[0]


def spectral_slot_core(disk: DiskParams, m, a, r_in, inv_logr, t_coeffs,
                       rgb_coeffs, r_c, phi_c, t_c, lam, octaves: int,
                       density_scale=1.0, intensity_scale=1.0):
    """Shade one recorded crossing, spectral branch: Page-Thorne temperature
    shape and Planck/CIE chromaticity as Chebyshev series (``t_coeffs``: K
    scalars; ``rgb_coeffs``: 3 lists of K scalars); exact g^4 intensity.
    A scale of exactly 1.0 (a Python float) adds no operation."""
    valid, r_c, g, turb, edge = _disk_geometry(
        disk, m, a, r_in, r_c, phi_c, t_c, lam, octaves
    )
    x01 = torch.log(maximum(r_c / r_in, 1e-6)) * inv_logr
    xs = sqrt(clip(x01, 0.0, 1.0))
    tx = clip(2.0 * xs - 1.0, -1.0, 1.0)
    t_shape = clip(cheb_clenshaw(t_coeffs, tx), 0.0, 1.0)
    t_obs = clip(g * t_shape * disk.t_peak, SPECTRAL_T_LO, SPECTRAL_T_HI)
    y01 = div_c(t_obs - SPECTRAL_T_LO, SPECTRAL_T_HI - SPECTRAL_T_LO) ** 0.4
    ty = clip(2.0 * y01 - 1.0, -1.0, 1.0)
    color = tuple(
        maximum(cheb_clenshaw(rgb_coeffs[c], ty), 0.0) for c in range(3)
    )
    dens = disk.density
    if not (isinstance(density_scale, float) and density_scale == 1.0):
        dens = dens * density_scale
    alpha = clip(dens * edge * turb, 0.0, 1.0)
    alpha = torch.where(valid, alpha, 0.0)
    intensity = _pow4(g) * _pow4(t_shape)
    if not (isinstance(intensity_scale, float) and intensity_scale == 1.0):
        intensity = intensity * intensity_scale
    masked = torch.where(valid, intensity, 0.0)
    return tuple(c * masked for c in color), alpha, valid


def disk_emission_cheb_rows(disk: DiskParams, m, a, r_in, spectral_coeffs,
                            r_c, phi_c, t_c, lam, density_scale=1.0,
                            intensity_scale=1.0, octaves: int = 3):
    """Spectral slot shading from the host Chebyshev tables
    (t_coeffs (K,), rgb_coeffs (3, K), inv_logr), the staged path's twin of
    the render kernel's spectral slot."""
    tc, rc_tab, il = spectral_coeffs
    tc = torch.as_tensor(np.asarray(tc, np.float32), device=r_c.device)
    rc_tab = torch.as_tensor(np.asarray(rc_tab, np.float32), device=r_c.device)
    inv_logr = torch.as_tensor(np.asarray(il, np.float32), device=r_c.device)
    t_coeffs = [tc[j] for j in range(SPECTRAL_CHEB_K)]
    rgb_coeffs = [[rc_tab[c, j] for j in range(SPECTRAL_CHEB_K)]
                  for c in range(3)]
    return spectral_slot_core(disk, m, a, r_in, inv_logr, t_coeffs,
                              rgb_coeffs, r_c, phi_c, t_c, lam, octaves,
                              density_scale, intensity_scale)


def disk_emission_lut_rows(disk: DiskParams, m, a, r_in, luts, r_c, phi_c,
                           t_c, lam, density_scale=1.0, intensity_scale=1.0,
                           octaves: int = 3):
    """Shade one recorded disk crossing, spectral branch, from the tables
    themselves: the Page-Thorne shape by linear interpolation in r (the
    ``jnp.interp`` arithmetic) and the Planck/CIE chromaticity by linear
    interpolation in observed temperature; exact g^4 intensity. ``luts``:
    ``disk_luts`` on the rows' device. Geometry, turbulence and opacity are
    the analytic branch's. Differentiable by autograd through ``r_c``,
    ``lam`` and the scales; the tables are constants."""
    r_grid, t_shape_tab, t_axis, rgb_table = luts
    valid, r_c, g, turb, edge = _disk_geometry(
        disk, m, a, r_in, r_c, phi_c, t_c, lam, octaves
    )
    t_shape = interp(r_c, r_grid, t_shape_tab)
    t_obs = clip(g * t_shape * disk.t_peak, t_axis[0], t_axis[-1])
    idx = torch.searchsorted(t_axis, t_obs.detach(), right=True) - 1
    idx = torch.clamp(idx, 0, t_axis.shape[0] - 2)
    t0 = t_axis[idx]
    t1 = t_axis[idx + 1]
    w1 = clip((t_obs - t0) / maximum(t1 - t0, 1e-3), 0.0, 1.0)
    tab = rgb_table.T
    color = tuple(tab[c][idx] * (1.0 - w1) + tab[c][idx + 1] * w1
                  for c in range(3))
    alpha = clip(disk.density * density_scale * edge * turb, 0.0, 1.0)
    alpha = torch.where(valid, alpha, 0.0)
    intensity = _powi(g, 4.0) * _pow4(t_shape) * intensity_scale
    masked = torch.where(valid, intensity, 0.0)
    return tuple(c * masked for c in color), alpha, valid


def disk_emission_lut(disk: DiskParams, m, a, luts, r_c, phi_c, t_c, lam,
                      density_scale=1.0, intensity_scale=1.0,
                      octaves: int = 3):
    """disk_emission_lut_rows at the prograde ISCO of (m, a) with the rgb
    rows stacked: ((..., 3) rgb, alpha, valid)."""
    from blackhole_simulation_tpu_torch.geometry.metrics import isco_t

    rgb, alpha, valid = disk_emission_lut_rows(
        disk, m, a, isco_t(m, a).to(r_c.dtype), luts, r_c, phi_c, t_c, lam,
        density_scale, intensity_scale, octaves)
    return torch.stack(rgb, dim=-1), alpha, valid


def shade_crossings_rows(m, a, r_in, disk: DiskParams, cross_r, cross_phi,
                         cross_t, n_crossings, lam, density_scale=1.0,
                         intensity_scale=1.0, spectral: bool = False,
                         spectral_coeffs=None, luts=None):
    """Composite the K recorded crossings front to back:
    ((r, g, b) rows, transmittance). ``cross_*``: (K, N) rows; ``m``, ``a``,
    ``r_in``: 0-dim tensors. The spectral disk shades from
    ``spectral_coeffs`` when given (the fused kernel's Chebyshev fit), else
    from the tables ``luts`` (``disk_luts`` on the rows' device: the JAX
    twin's LUT branch). Without ``luts`` they are built for ``m`` and ``a``
    as they are: in the graph (``build_disk_luts_t``) where autograd wants
    a derivative of m or a, as the JAX twin builds them in its graph,
    else looked up in the cache (``disk_luts``), which reads both back to
    the host."""
    k_slots, n = cross_r.shape
    if not spectral or spectral_coeffs is not None:
        luts = None
    elif luts is None:
        luts = disk_luts_for(m, a, disk, cross_r.device, cross_r.dtype)
    zero = torch.zeros(n, dtype=cross_r.dtype, device=cross_r.device)
    rgb = (zero, zero, zero)
    trans = zero + 1.0
    for k in range(k_slots):
        filled = k < n_crossings
        octaves = 3 if k == 0 else 1
        if luts is not None:
            c_rgb, c_alpha, valid = disk_emission_lut_rows(
                disk, m, a, r_in, luts, cross_r[k], cross_phi[k], cross_t[k],
                lam, density_scale, intensity_scale, octaves)
        elif spectral:
            c_rgb, c_alpha, valid = disk_emission_cheb_rows(
                disk, m, a, r_in, spectral_coeffs, cross_r[k], cross_phi[k],
                cross_t[k], lam, density_scale, intensity_scale, octaves)
        else:
            c_rgb, c_alpha, valid = disk_emission_rows(
                disk, m, a, r_in, cross_r[k], cross_phi[k], cross_t[k], lam,
                octaves, density_scale, intensity_scale)
        on = filled & valid
        w = torch.where(on, trans * c_alpha, 0.0)
        rgb = tuple(acc + w * c for acc, c in zip(rgb, c_rgb))
        trans = torch.where(on, trans * (1.0 - c_alpha), trans)
    return rgb, trans


def shade_disk_crossings(m, a, r_in, disk: DiskParams, result, y0,
                         density_scale=1.0, intensity_scale=1.0,
                         spectral: bool = False):
    """``shade_crossings_rows`` on a packed ``MarchResult`` (crossings
    (N, K)), with lambda = -p_phi / p_t from the (N, 8) initial states
    ``y0``. A spectral disk shades from the LUTs, as the JAX twin's does
    (it passes no Chebyshev tables)."""
    lam = -y0[:, 7] / torch.where(torch.abs(y0[:, 4]) < 1e-12, -1.0, y0[:, 4])
    return shade_crossings_rows(
        m, a, r_in, disk, result.cross_r.T, result.cross_phi.T,
        result.cross_t.T, result.n_crossings, lam, density_scale,
        intensity_scale, spectral=spectral)


# ---------------------------------------------------------------------------
# Jets
# ---------------------------------------------------------------------------

def jet_emission_step(jets: JetParams, r, st, ct, ph, dr, dth, dph, dlam):
    """One march step's optically thin jet sample, (r, g, b) rows: cone
    test, Gaussian radial profile, one noise octave and Doppler beaming
    against the ray's direction (dr, dth, dph per unit affine parameter).
    ``st``, ``ct``: sin and cos of theta. The JAX twin's expressions in its
    order; exp and the beaming power go through float64 (as in the
    kernels), ``jnp.mod`` is a floor-mod and ``jnp.sign`` is 0 at 0."""
    z = r * ct
    rho = torch.abs(r * st)
    az = torch.abs(z)
    cone_r = jets.core_radius + jets.opening_slope * az
    in_cone = (az > jets.z_min) & (az < jets.z_max) & (rho < 2.5 * cone_r)
    q = rho / maximum(cone_r, 1e-3)
    profile = exp(-(q * q))

    v_z = dr * ct - r * st * dth
    v_rho = dr * st + r * ct * dth
    v_ph = r * st * dph
    v_mag = sqrt(v_z * v_z + v_rho * v_rho + v_ph * v_ph + 1e-12)
    cos_psi = -torch.sign(z) * v_z / v_mag
    # the Lorentz factor meets the rows in their dtype: rounded to float32
    # on float32 rows, as the JAX twin's weakly typed value is
    gamma = (jets.gamma if r.dtype == torch.float64
             else float(np.float32(jets.gamma)))
    delta = 1.0 / (gamma * (1.0 - jets.beta * clip(cos_psi, -1.0, 1.0)))
    beam = pow_(delta, jets.beaming_exponent)

    noise = value_noise2(
        az * 0.8, torch.remainder(ph, const(ph, TWO_PI)) * 2.0 + az)
    turb = (1.0 - jets.turbulence) + jets.turbulence * (0.5 + noise)
    mag = torch.where(in_cone, jets.density * dlam * profile * turb * beam,
                      0.0)
    return 0.62 * mag, 0.74 * mag, mag


# ---------------------------------------------------------------------------
# Background starfield
# ---------------------------------------------------------------------------

def escape_direction_u_rows(rows_u, m, a):
    """Unit Cartesian direction (dx, dy, dz) of an escaped ray from its
    u-chart rows (t, r, u, ph, p_t, p_r, p_u, p_phi)."""
    _, r, u, ph, pt, pr, pu, pph = rows_u
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
    st, ct = s, u
    sp, cp = sin(ph), cos(ph)
    dx = v_r * st * cp + v_th * ct * cp - v_ph * sp
    dy = v_r * st * sp + v_th * ct * sp + v_ph * cp
    dz = v_r * ct - v_th * st
    inv_n = 1.0 / sqrt(maximum(dx * dx + dy * dy + dz * dz, 1e-30))
    return dx * inv_n, dy * inv_n, dz * inv_n


def escape_direction_rows(rows, m, a):
    """Unit Cartesian direction (dx, dy, dz) of an escaped ray from its
    theta-chart rows (t, r, theta, ph, p_t, p_r, p_theta, p_phi): the
    sparse Kerr-Schild contravariant momentum, nearly flat at the escape
    radius, rotated by the position angles."""
    _, r, th, ph, pt, pr, pth, pph = rows
    s = sin(th)
    ct = cos(th)
    s2 = maximum(s * s, 1e-12)
    sig = r * r + a * a * ct * ct
    delta = r * r - 2.0 * m * r + a * a
    inv_sig = 1.0 / sig
    h = 2.0 * m * r * inv_sig
    v_r = h * pt + delta * inv_sig * pr + a * inv_sig * pph
    v_th = r * (pth * inv_sig)
    v_ph = r * s * (a * inv_sig * pr + pph * inv_sig / s2)
    sp, cp = sin(ph), cos(ph)
    dx = v_r * s * cp + v_th * ct * cp - v_ph * sp
    dy = v_r * s * sp + v_th * ct * sp + v_ph * cp
    dz = v_r * ct - v_th * s
    inv_n = 1.0 / sqrt(maximum(dx * dx + dy * dy + dz * dz, 1e-30))
    return dx * inv_n, dy * inv_n, dz * inv_n


def escape_direction(y, m, a):
    """(..., 3) escape directions of (..., 8) theta-chart states."""
    return torch.stack(
        escape_direction_rows(tuple(y[..., i] for i in range(8)), m, a),
        dim=-1)


def starfield_rows(dx, dy, dz, params: StarfieldParams = StarfieldParams()):
    """Two-scale hashed starfield plus fbm nebula: direction rows in,
    (r, g, b) rows out."""
    u = atan2_approx(dy, dx)
    v = clip(dz, -1.0, 1.0)
    out = [torch.zeros_like(u) for _ in range(3)]
    for freq, scale in ((params.cells, 1.0), (params.cells * 0.35, 2.2)):
        cu = torch.floor(u * freq)
        cv = torch.floor(v * freq)
        h = hash21(cu, cv)
        star = (h < params.density * scale * 300.0).to(u.dtype)
        fu = u * freq - cu - 0.5
        fv = v * freq - cv - 0.5
        spot = torch.exp(-(fu * fu + fv * fv) * 40.0)
        temp = 3000.0 + 12000.0 * hash21(cu + 7, cv + 13)
        color = blackbody_ramp_rows(temp)
        h_mag = hash21(cu + 31, cv + 5)
        w = star * spot * (h_mag * h_mag * h_mag)
        out = [acc + w * c for acc, c in zip(out, color)]
    nebula = fbm2(u * 3.0, v * 3.0, octaves=4)
    neb2 = nebula * nebula
    neb_rows = (0.35 * neb2, 0.2 * neb2, 0.5 * nebula * sqrt(nebula))
    return tuple(
        params.brightness * acc + params.nebula * nc
        for acc, nc in zip(out, neb_rows)
    )


def starfield(direction, params: StarfieldParams = StarfieldParams()):
    """(..., 3) starfield of (..., 3) unit directions (starfield_rows
    stacked)."""
    return torch.stack(starfield_rows(direction[..., 0], direction[..., 1],
                                      direction[..., 2], params), dim=-1)


# ---------------------------------------------------------------------------
# Host-side spectral tables (float64 build, float32 Chebyshev projection)
# ---------------------------------------------------------------------------

def build_disk_luts_t(mass, spin, disk: DiskParams, n_r: int = 256,
                      n_t: int = 128, dtype=torch.float32):
    """The Page-Thorne temperature-shape LUT on a log-r grid from the ISCO
    to the disk edge and the Planck/CIE chromaticity LUT over observed
    temperature (^2.5-warped axis), built in float64 and returned as
    ``dtype`` tensors (r_grid, t_shape, t_axis, rgb_table (n_t, 3)) on the
    device of ``mass``: the JAX twin's ``build_disk_luts`` (:337-380).
    ``mass`` and ``spin`` are numbers or 0-d tensors; the grid and the
    shape are differentiable in them (``physics/disk.page_thorne_flux_t``),
    so that the tables' spin and mass terms reach a render's gradient, as
    the JAX twin builds them in its graph. The chromaticity table depends
    on neither."""
    from blackhole_simulation_tpu_torch.geometry.metrics import Kerr, isco_t
    from blackhole_simulation_tpu_torch.physics.disk import page_thorne_flux_t
    from blackhole_simulation_tpu_torch.physics.spectrum import blackbody_rgb

    dev = mass.device if isinstance(mass, torch.Tensor) else None
    m64 = leaf(mass, torch.float64, dev)
    a64 = leaf(spin, torch.float64, dev)
    r_in = attach(
        torch.tensor(Kerr(mass=host(mass), spin=host(spin)).isco(),
                     dtype=torch.float64, device=dev),
        isco_t(m64, a64))
    ts = torch.as_tensor(np.linspace(0.0, 1.0, n_r), device=dev)
    r_grid = r_in * (disk.outer_radius / r_in) ** ts
    flux = page_thorne_flux_t(r_grid, m64, a64, n_grid=n_r)
    t_raw = maximum(flux, 0.0) ** 0.25
    t_shape = t_raw / maximum(torch.amax(t_raw), 1e-30)
    t_axis = 900.0 + (4e4 - 900.0) * np.linspace(0.0, 1.0, n_t) ** 2.5
    rgb_table = blackbody_rgb(t_axis)
    const_t = lambda x: torch.as_tensor(np.asarray(x, np.float64),
                                        device=dev).to(dtype)
    return (r_grid.to(dtype), t_shape.to(dtype), const_t(t_axis),
            const_t(rgb_table))


def build_disk_luts(mass: float, spin: float, disk: DiskParams,
                    n_r: int = 256, n_t: int = 128, dtype=np.float32):
    """``build_disk_luts_t`` of host values as ``dtype`` numpy arrays
    (r_grid, t_shape, t_axis, rgb_table (n_t, 3))."""
    with torch.no_grad():
        luts = build_disk_luts_t(host(mass), host(spin), disk, n_r, n_t,
                                 torch.float64)
    return tuple(np.asarray(x.numpy(), dtype) for x in luts)


@functools.lru_cache(maxsize=64)
def disk_luts(mass: float, spin: float, disk: DiskParams,
              device: torch.device | str = "cpu", dtype=torch.float32):
    """``build_disk_luts`` cached on (mass, spin, disk, device, dtype): the
    staged spectral composite's tables (float32; float64 for the oracle) as
    tensors on ``device``, so a frame builds and copies none of them.
    Constants: shared between callers, never written; keyed by numbers
    only, and holding no graph (a differentiable render builds its tables
    with ``build_disk_luts_t`` instead)."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    return tuple(torch.as_tensor(x, device=device)
                 for x in build_disk_luts(mass, spin, disk, dtype=np_dtype))


def disk_luts_for(m, a, disk: DiskParams, device, dtype=torch.float32):
    """The spectral composite's tables for mass ``m`` and spin ``a``
    (numbers or 0-d tensors): built in the graph where autograd wants a
    derivative of either (``build_disk_luts_t``), else the cached
    constants of their values (``disk_luts``)."""
    if grad_wanted(m, a):
        return build_disk_luts_t(leaf(m, torch.float64, device),
                                 leaf(a, torch.float64, device), disk,
                                 dtype=dtype)
    # float32 by default: the cache's key is its arguments as given
    kw = {} if dtype == torch.float32 else {"dtype": dtype}
    return disk_luts(host(m), host(a), disk, torch.device(device), **kw)


def spectral_cheb_coeffs(luts):
    """Chebyshev projections of the two spectral LUTs, in float32 as the JAX
    twin computes them: t_shape on x' = sqrt(log(r/r_in)/log(r_out/r_in))
    and rgb on y = ((T - 900)/(4e4 - 900))^(1/2.5). Returns float32 tensors
    (t_coeffs (K,), rgb_coeffs (3, K))."""
    r_grid, t_shape_tab, t_axis, rgb_table = (
        torch.as_tensor(np.asarray(x, np.float32)) for x in luts
    )
    K = SPECTRAL_CHEB_K
    k = torch.arange(K, dtype=torch.float32)
    nodes = cos(div_c(math.pi * (k + 0.5), K))
    x01 = 0.5 * (nodes + 1.0)
    r_in, r_out = r_grid[0], r_grid[-1]
    r_nodes = r_in * (r_out / r_in) ** (x01 * x01)
    t_vals = interp(r_nodes, r_grid, t_shape_tab)
    t_nodes = SPECTRAL_T_LO + (SPECTRAL_T_HI - SPECTRAL_T_LO) * x01**2.5
    rgb_vals = torch.stack(
        [interp(t_nodes, t_axis, rgb_table[:, c].contiguous()) for c in range(3)]
    )
    dct = cos(div_c(math.pi * k[:, None] * (k[None, :] + 0.5), K))

    def proj(v):
        c = (2.0 / K) * (v[None, :] * dct).sum(dim=1)
        c[0] = c[0] * 0.5
        return c

    return proj(t_vals), torch.stack([proj(rgb_vals[c]) for c in range(3)])


@functools.lru_cache(maxsize=64)
def spectral_kernel_tables(mass: float, spin: float, disk: DiskParams):
    """Host spectral Chebyshev tables for the render kernel: (t_coeffs (K,),
    rgb_coeffs (3, K), inv_logr ()) as float32 numpy arrays. Cached on
    (mass, spin, disk); the 65 scalars ship in the kernel's parameter row."""
    luts = build_disk_luts(mass, spin, disk)
    t_coeffs, rgb_coeffs = spectral_cheb_coeffs(luts)
    r_grid = torch.as_tensor(luts[0])
    inv_logr = 1.0 / torch.log(r_grid[-1] / r_grid[0])
    return (t_coeffs.numpy(), rgb_coeffs.numpy(),
            np.asarray(inv_logr.numpy(), np.float32))
