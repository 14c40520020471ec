"""The staged composite as one CUDA kernel and its VJP as another:
``csrc/composite.cu`` (with the leaf math of ``csrc/shade.cuh``) built and
bound with ctypes, and the ``torch.autograd.Function`` that
``render/pipeline.py::shade_march_rows`` takes for CUDA rows.

The forward kernel computes ``render/pipeline.py::_composite`` of u-chart
``MarchRows`` (the disk's crossings front to back, analytic or Chebyshev
spectral, the starfield behind escaped rays, the jets' rows, the
photon-ring glow), bit for bit as that plain version computes it on the
card, one thread a ray. The VJP kernel recomputes each ray's forward in
registers, walks the slots back to front and writes the cotangents of the
per-ray rows, with fixed-order partial sums for the 0-d inputs (mass,
spin, ISCO, photon sphere, the two scales) that a second pass reduces: no
float atomics, so a backward is bit-reproducible. Nothing per ray is
saved beyond the Function's inputs, where autograd of the plain composite
keeps a graph over every ray. The kernels replace no TPU kernel: the JAX
package's staged composite is plain ``jnp``, and on the card its
thousands of elementwise launches, forward and back, were the inverse
step's time.

The derivative chain: each stage of a ray is differentiated forward along
the few inputs it reads (``Dual``), and the stages are chained in
reverse: a disk slot along (r, phi, t, lam, m, a, r_in, density scale,
intensity scale), the starfield along its direction, the escape direction
along the state rows and (m, a), the glow along (r_min_ph, r_ph).
Autograd's conventions decide every tie: ``maximum``/``minimum`` (and so
``clip``) split it evenly, ``where`` routes the derivative, ``floor`` and
the lattice hashes give none, ``remainder`` passes it whole, ``abs`` has
none at 0. A zero tangent stays zero through a factor that is infinite,
as autograd's routed zeros never meet it. A quotient's tangents multiply
by one reciprocal, sqrt's by 0.5 / sqrt(x) formed in float64: within an
ulp of autograd's own quotients.

``composite_vjp_plain`` is that chain in plain PyTorch, operation for
operation: the twin that the CPU tests hold to autograd and the card tests
hold the kernel to.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from blackhole_simulation_tpu_torch._elementwise import const
from blackhole_simulation_tpu_torch.ops.shade import (
    DiskArgs,
    StarArgs,
    shade_args,
)
from blackhole_simulation_tpu_torch.render.march import HIT_ESCAPE
from blackhole_simulation_tpu_torch.render.pipeline import _DUMMY_U
from blackhole_simulation_tpu_torch.render.shading import (
    NT_PEAK,
    SPECTRAL_CHEB_K,
    SPECTRAL_T_HI,
    SPECTRAL_T_LO,
    TWO_PI,
    _powi_plan,
    blackbody_ramp_rows,
    hash21,
)

# The 0-d cotangents, in the order of the kernel's partial sums
# (csrc/composite.cu).
SCALARS = ("m", "a", "r_in", "r_ph", "ds", "is")

# ---------------------------------------------------------------------------
# Forward-mode numbers: a value and its tangents, with autograd's local
# derivatives. ``csrc/shade.cuh``'s ``Dual`` is the same, per thread.
# ---------------------------------------------------------------------------


def _val(x):
    return x.v if isinstance(x, Dual) else x


def _tan(x):
    return x.d if isinstance(x, Dual) else None


def _tadd(p, q):
    if p is None:
        return q
    return p if q is None else p + q


def _tmul(d, f):
    """A tangent times a finite factor."""
    return None if d is None else d * f


def _tmulz(d, f):
    """A tangent times a factor that may be infinite: a zero stays zero."""
    return None if d is None else torch.where(d == 0, 0.0, d * f)


def _tneg(d):
    return None if d is None else -d


class Dual:
    """``v``: the value, a tensor of the rows (or 0-d); ``d``: its tangents,
    a (D, N) or (D, 1) tensor, or None where the value is a constant. The
    value arithmetic is the plain composite's, operation for operation."""

    __slots__ = ("v", "d")

    def __init__(self, v, d=None):
        self.v, self.d = v, d

    def __add__(self, o):
        return Dual(self.v + _val(o), _tadd(self.d, _tan(o)))

    def __radd__(self, o):
        return Dual(o + self.v, self.d)

    def __sub__(self, o):
        return Dual(self.v - _val(o), _tadd(self.d, _tneg(_tan(o))))

    def __rsub__(self, o):
        return Dual(o - self.v, _tneg(self.d))

    def __mul__(self, o):
        ov = _val(o)
        return Dual(self.v * ov, _tadd(_tmul(self.d, ov),
                                       _tmul(_tan(o), self.v)))

    def __rmul__(self, o):
        return Dual(o * self.v, _tmul(self.d, o))

    def __truediv__(self, o):
        if not isinstance(o, (Dual, torch.Tensor)):
            raise TypeError("divide by a number with div_c")
        ov = _val(o)
        q = self.v / ov
        ry = torch.reciprocal(ov)
        return Dual(q, _tadd(_tmulz(self.d, ry),
                             _tneg(_tmulz(_tan(o), q * ry))))

    def __rtruediv__(self, o):
        if isinstance(o, torch.Tensor):
            q = o / self.v
            return Dual(q, _tneg(_tmulz(self.d, q * torch.reciprocal(self.v))))
        # PyTorch's ``number / tensor``: reciprocal(x) * number
        r = torch.reciprocal(self.v)
        return Dual(r * o, _tmul(_tneg(_tmulz(self.d, r * r)), o))

    def __neg__(self):
        return Dual(-self.v, _tneg(self.d))


def _const_like(x, c):
    return c if isinstance(c, torch.Tensor) else const(x, c)


def _pick(mask, a, b):
    """where(mask, a, b) of tangents, None for zero."""
    if a is None and b is None:
        return None
    if a is None:
        a = torch.zeros_like(b)
    if b is None:
        b = torch.zeros_like(a)
    return torch.where(mask, a, b)


def _minmax(x, y, take_x, take_y):
    """Tangent of maximum/minimum: half each at a tie, the taken side's
    elsewhere, both where neither is taken (NaN)."""
    xv, yv = _val(x), _val(y)
    dx, dy = _tan(x), _tan(y)
    if dx is None and dy is None:
        return None
    eq = xv == yv
    zx = dx if dx is not None else torch.zeros_like(dy)
    zy = dy if dy is not None else torch.zeros_like(dx)
    both = zx + zy
    d = torch.where(take_x, zx, torch.where(take_y, zy, both))
    return torch.where(eq, 0.5 * zx + 0.5 * zy, d)


def maximum(x, y):
    """torch.maximum (NaN propagates); y a Dual, tensor or number."""
    xv = _val(x)
    yv = _const_like(xv, _val(y))
    return Dual(torch.maximum(xv, yv),
                _minmax(x, y if isinstance(y, Dual) else yv, xv > yv,
                        xv < yv))


def minimum(x, y):
    xv = _val(x)
    yv = _const_like(xv, _val(y))
    return Dual(torch.minimum(xv, yv),
                _minmax(x, y if isinstance(y, Dual) else yv, xv < yv,
                        xv > yv))


def clip(x, lo, hi):
    return minimum(maximum(x, lo), hi)


def where(mask, a, b):
    av, bv = _val(a), _val(b)
    ref = av if isinstance(av, torch.Tensor) else bv
    av, bv = _const_like(ref, av), _const_like(ref, bv)
    return Dual(torch.where(mask, av, bv), _pick(mask, _tan(a), _tan(b)))


def sqrt(x):
    """``_elementwise.sqrt`` (by way of float64); the tangent is dx times
    0.5 / sqrt(x), formed in float64 and rounded once to the row's dtype."""
    xv = _val(x)
    sd = torch.sqrt(xv.double())
    f = (const(sd, 0.5) / sd).to(xv.dtype)
    return Dual(sd.to(xv.dtype), _tmulz(_tan(x), f))


def sin(x):
    xv = _val(x)
    xd = xv.double()
    return Dual(torch.sin(xd).to(xv.dtype),
                _tmul(_tan(x), torch.cos(xd).to(xv.dtype)))


def cos(x):
    xv = _val(x)
    xd = xv.double()
    return Dual(torch.cos(xd).to(xv.dtype),
                _tmul(_tan(x), (-torch.sin(xd)).to(xv.dtype)))


def exp(x):
    """torch.exp in the rows' dtype."""
    v = torch.exp(_val(x))
    return Dual(v, _tmulz(_tan(x), v))


def log(x):
    xv = _val(x)
    return Dual(torch.log(xv), _tmulz(_tan(x), torch.reciprocal(xv)))


def pow_(x, p: float):
    """torch.pow(x, p) of a Python number p, and its derivative
    ``p * x ** (p - 1)`` as autograd forms it."""
    xv = _val(x)
    d = _tan(x)
    if d is not None:
        d = _tmulz(d, (xv ** (p - 1)) * p)
    return Dual(xv ** p, d)


def abs_(x):
    xv = _val(x)
    return Dual(torch.abs(xv), _tmul(_tan(x), torch.sign(xv)))


def floor(x):
    return torch.floor(_val(x))


def remainder(x, c: float):
    xv = _val(x)
    return Dual(torch.remainder(xv, const(xv, c)), _tan(x))


def div_c(x, c: float):
    """x / c with c rounded to x's dtype, divided exactly."""
    xv = _val(x)
    return Dual(xv / const(xv, c), _tmul(_tan(x), const(xv, 1.0 / c)))


def _ones(x):
    return Dual(torch.ones_like(_val(x)))


# ---------------------------------------------------------------------------
# The composite's leaf math on Duals: ``render/shading.py``'s expressions
# in its order (``csrc/shade.cuh`` line for line).
# ---------------------------------------------------------------------------

def _smooth(t):
    return t * t * (3.0 - 2.0 * t)


def _value_noise2(x, y):
    xf, yf = floor(x), floor(y)
    tx, ty = _smooth(x - xf), _smooth(y - yf)
    c00 = hash21(xf, yf)
    c10 = hash21(xf + 1, yf)
    c01 = hash21(xf, yf + 1)
    c11 = hash21(xf + 1, yf + 1)
    return (c00 * (1 - tx) * (1 - ty) + c10 * tx * (1 - ty)
            + c01 * (1 - tx) * ty + c11 * tx * ty)


def _fbm2(x, y, octaves: int):
    total = Dual(torch.zeros_like(_val(x)))
    amp, freq = 0.5, 1.0
    for _ in range(octaves):
        total = total + amp * _value_noise2(x * freq, y * freq)
        amp *= 0.5
        freq *= 2.0
    return total


def _atan2_approx(y, x):
    ax, ay = abs_(x), abs_(y)
    hi, lo = maximum(ax, ay), minimum(ax, ay)
    z = lo / maximum(hi, 1e-30)
    z2 = z * z
    p = -0.0117212 * z2 + 0.0526477
    p = p * z2 + -0.1172626
    p = p * z2 + 0.1936999
    p = p * z2 + -0.3326231
    p = p * z2 + 0.9999798
    t = p * z
    t = where(_val(ay) > _val(ax), math.pi / 2 - t, t)
    t = where(_val(x) < 0.0, math.pi - t, t)
    return where(_val(y) < 0.0, -t, t)


def _powi(x, p: float, plan):
    """``shading._powi`` with its plan (None: a plain pow)."""
    if plan is None:
        return pow_(x, p)
    k, n, negative = plan
    base = x
    for _ in range(k):
        base = sqrt(base)
    acc, bit = None, base
    while n:
        if n & 1:
            acc = bit if acc is None else acc * bit
        n >>= 1
        if n:
            bit = bit * bit
    if acc is None:
        acc = _ones(x)
    return 1.0 / acc if negative else acc


def _pow4(x):
    x2 = x * x
    return x2 * x2


def _blackbody_ramp(t_kelvin):
    t = div_c(clip(t_kelvin, 1000.0, 40000.0), 100.0)
    tv = _val(t)
    red = where(tv <= 66.0, 255.0,
                329.698727446 * pow_(maximum(t - 60.0, 1e-6), -0.1332047592))
    g_lo = 99.4708025861 * log(maximum(t, 1e-6)) - 161.1195681661
    g_hi = 288.1221695283 * pow_(maximum(t - 60.0, 1e-6), -0.0755148492)
    green = where(tv <= 66.0, g_lo, g_hi)
    b_lo = 138.5177312231 * log(maximum(t - 10.0, 1e-6)) - 305.0447927307
    blue = where(tv >= 66.0, 255.0, where(tv <= 19.0, 0.0, b_lo))
    out = []
    for c in (red, green, blue):
        c = clip(div_c(c, 255.0), 0.0, 1.0)
        out.append(c * c)
    return tuple(out)


def _g_factor(m, a, r, lam):
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
    doppler = where(torch.abs(_val(doppler)) < 1e-4, 1e-4, doppler)
    return 1.0 / (u_t * doppler)


def _disk_geometry(disk, m, a, r_in, r_c, phi_c, t_c, lam, octaves):
    rv = _val(r_c)
    valid = (rv > _val(r_in)) & (rv < disk.outer_radius)
    r_c = where(valid, r_c, r_in * 2.0)
    phi_c = where(valid, phi_c, 0.0)
    t_c = where(valid, t_c, 0.0)
    g = _g_factor(m, a, maximum(r_c, r_in), lam)
    g = clip(g, 0.05, 5.0)
    rk = maximum(r_c, r_in)
    omega_k = sqrt(m) / (rk * sqrt(rk) + a * sqrt(m))
    phase = phi_c - omega_k * t_c
    phase = remainder(phase, TWO_PI)
    noise = _fbm2(r_c * 1.7, phase * 3.0, octaves)
    turb = 1.0 - disk.turbulence + disk.turbulence * (0.4 + 1.2 * noise)
    inner = clip((r_c - r_in) / (disk.inner_edge_softness * r_in + 1e-6),
                 0.0, 1.0)
    edge = _smooth(inner) * clip(
        div_c(disk.outer_radius - r_c, 0.15 * disk.outer_radius), 0.0, 1.0)
    return valid, r_c, g, turb, edge


def _nt_profile(r, r_in):
    x = maximum(r / r_in, 1.0 + 1e-6)
    shape = (_powi(1.0 - sqrt(1.0 / x), 0.25, _powi_plan(0.25))
             * _powi(x, -0.75, _powi_plan(-0.75)))
    return div_c(shape, NT_PEAK)


def _clenshaw(coeffs, t):
    b1 = Dual(torch.zeros_like(_val(t)))
    b2 = Dual(torch.zeros_like(_val(t)))
    for j in range(len(coeffs) - 1, 0, -1):
        b1, b2 = 2.0 * t * b1 - b2 + coeffs[j], b1
    return t * b1 - b2 + coeffs[0]


def _slot(c, m, a, r_in, r_c, phi_c, t_c, lam, octaves, dens_ds, int_scale):
    """One crossing: the Chebyshev spectral branch where ``c.cheb`` is set,
    else the analytic one (``csrc/shade.cuh::disk_slot``)."""
    disk = c.disk
    valid, r_c, g, turb, edge = _disk_geometry(disk, m, a, r_in, r_c, phi_c,
                                               t_c, lam, octaves)
    if c.cheb is not None:
        dev = _val(r_c).device
        tc, rc_tab, il = (torch.as_tensor(np.asarray(x, np.float32),
                                          device=dev) for x in c.cheb)
        t_coeffs = [tc[j] for j in range(SPECTRAL_CHEB_K)]
        rgb_coeffs = [[rc_tab[ch, j] for j in range(SPECTRAL_CHEB_K)]
                      for ch in range(3)]
        x01 = log(maximum(r_c / r_in, 1e-6)) * il
        xs = sqrt(clip(x01, 0.0, 1.0))
        tx = clip(2.0 * xs - 1.0, -1.0, 1.0)
        t_shape = clip(_clenshaw(t_coeffs, tx), 0.0, 1.0)
        t_obs = clip(g * t_shape * disk.t_peak, SPECTRAL_T_LO, SPECTRAL_T_HI)
        y01 = pow_(div_c(t_obs - SPECTRAL_T_LO,
                         SPECTRAL_T_HI - SPECTRAL_T_LO), 0.4)
        ty = clip(2.0 * y01 - 1.0, -1.0, 1.0)
        color = tuple(maximum(_clenshaw(rgb_coeffs[ch], ty), 0.0)
                      for ch in range(3))
        intensity = _pow4(g) * _pow4(t_shape) * int_scale
    else:
        t_shape = _nt_profile(maximum(r_c, r_in * (1 + 1e-4)), r_in)
        if disk.artistic_rgb is not None:
            color = tuple(Dual(torch.full_like(_val(r_c), v))
                          for v in disk.artistic_rgb)
        else:
            t_obs = clip(g * t_shape * disk.t_peak, 1000.0, 40000.0)
            color = _blackbody_ramp(t_obs)
        p_out = -disk.outer_falloff * 0.5
        outer = _powi(maximum(r_in, r_c) / r_in, p_out, _powi_plan(p_out))
        intensity = (_powi(g, disk.beaming_exponent,
                           _powi_plan(disk.beaming_exponent))
                     * _pow4(t_shape) * outer * int_scale)
    alpha = where(valid, clip(dens_ds * edge * turb, 0.0, 1.0), 0.0)
    masked = where(valid, intensity, 0.0)
    return tuple(col * masked for col in color), alpha, valid


def _escape_direction_u(rows, m, a):
    r, u, ph, pt, pr, pu, pph = rows
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


def _starfield(dx, dy, dz, c):
    params = c.stars
    u = _atan2_approx(dy, dx)
    v = clip(dz, -1.0, 1.0)
    uv = _val(u)
    out = [Dual(torch.zeros_like(uv)) for _ in range(3)]
    for freq, scale in ((params.cells, 1.0), (params.cells * 0.35, 2.2)):
        cu = floor(u * freq)
        cv = floor(v * freq)
        h = hash21(cu, cv)
        star = (h < params.density * scale * 300.0).to(uv.dtype)
        fu = u * freq - cu - 0.5
        fv = v * freq - cv - 0.5
        spot = exp(-(fu * fu + fv * fv) * 40.0)
        temp = 3000.0 + 12000.0 * hash21(cu + 7, cv + 13)
        color = blackbody_ramp_rows(temp)
        h_mag = hash21(cu + 31, cv + 5)
        w = star * spot * (h_mag * h_mag * h_mag)
        out = [acc + w * col for acc, col in zip(out, color)]
    nebula = _fbm2(u * 3.0, v * 3.0, 4)
    neb2 = nebula * nebula
    neb_rows = (0.35 * neb2, 0.2 * neb2, 0.5 * nebula * sqrt(nebula))
    return tuple(params.brightness * acc + params.nebula * nc
                 for acc, nc in zip(out, neb_rows))


_WARM = (1.0, 0.82, 0.55)
_COOL = (0.82, 0.88, 1.0)


def _glow(r_min_ph, r_ph, escaped):
    near = exp(-14.0 * r_min_ph / maximum(r_ph, 1e-3))
    return where(escaped, 0.6 * near, 0.0)


# ---------------------------------------------------------------------------
# The static configuration the kernels take
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CompositeStatic:
    """What selects the kernel's instantiation and its constants: the disk
    (None without one), the Chebyshev tables (tuples of float32 values, or
    None for the analytic disk), the stars (None without the starfield),
    the glow and the jets."""

    disk: object = None
    cheb: tuple | None = None
    stars: object = None
    glow: bool = False
    jets: bool = False

    @classmethod
    def of(cls, scene) -> "CompositeStatic":
        """The composite of ``scene``'s features: the Chebyshev disk where
        it is spectral with tables, else the analytic one. A spectral
        scene without tables shades from the LUTs, which the kernel does
        not take: ValueError."""
        feats = scene.features
        cheb = None
        if feats.disk and feats.spectral_lut:
            if scene.spectral_coeffs is None:
                raise ValueError("composite kernel: the spectral disk's LUT "
                                 "branch stays on the plain composite")
            tc, rc, il = scene.spectral_coeffs
            cheb = (tuple(float(v) for v in np.asarray(tc, np.float32)),
                    tuple(tuple(float(v) for v in row)
                          for row in np.asarray(rc, np.float32)),
                    float(np.asarray(il, np.float32)))
        return cls(disk=scene.disk if feats.disk else None, cheb=cheb,
                   stars=scene.stars if feats.starfield else None,
                   glow=bool(feats.photon_ring_glow), jets=bool(feats.jets))


def _seed(x, i: int, dirs: int):
    """``x`` as a Dual along direction ``i`` of ``dirs``."""
    shape = (dirs, 1) if x.dim() == 0 else (dirs,) + tuple(x.shape)
    d = torch.zeros(shape, dtype=x.dtype, device=x.device)
    d[i] = 1.0
    return Dual(x, d)


def _scale_arg(s, i, dirs):
    return _seed(s, i, dirs) if isinstance(s, torch.Tensor) else s


def composite_forward_plain(c: CompositeStatic, m, a, r_in, r_ph, hit,
                            cross_r, cross_phi, cross_t, n_crossings,
                            r_min_ph, lam, state_u, jet_rows,
                            density_scale=1.0, intensity_scale=1.0):
    """The composite as the kernel computes it: the plain
    ``_composite``'s values, through this module's leaf math. (r, g, b)
    rows."""
    with torch.no_grad():
        escaped = hit == HIT_ESCAPE
        rgb = [Dual(torch.zeros_like(lam)) for _ in range(3)]
        trans = Dual(torch.zeros_like(lam) + 1.0)
        if c.disk is not None:
            dens_ds = c.disk.density * _val(density_scale)
            for k in range(cross_r.shape[0]):
                c_rgb, alpha, valid = _slot(
                    c, m, a, r_in, cross_r[k], cross_phi[k], cross_t[k], lam,
                    3 if k == 0 else 1, dens_ds, intensity_scale)
                on = (k < n_crossings) & valid
                w = where(on, trans * alpha, 0.0)
                rgb = [acc + w * col for acc, col in zip(rgb, c_rgb)]
                trans = where(on, trans * (1.0 - alpha), trans)
        if c.stars is not None:
            srows = tuple(torch.where(escaped, state_u[i], _DUMMY_U[i])
                          for i in range(1, 8))
            bg = _starfield(*_escape_direction_u(srows, m, a), c)
            w_bg = where(escaped, trans, 0.0)
            rgb = [acc + w_bg * b for acc, b in zip(rgb, bg)]
        if c.jets:
            rgb = [acc + j for acc, j in zip(rgb, jet_rows)]
        if c.glow:
            glow = _glow(r_min_ph, r_ph, escaped)
            order = div_c(torch.clamp(n_crossings, 0, 3).to(lam.dtype), 3.0)
            rgb = [acc + glow * (w + order * (k - w))
                   for acc, w, k in zip(rgb, _WARM, _COOL)]
        return tuple(_val(x) for x in rgb)


def _contract(g_out, outs):
    """sum_j g_out[j] * outs[j].d: the (D, N) cotangents of a stage's
    inputs from its outputs' cotangents."""
    acc = None
    for g, o in zip(g_out, outs):
        if o.d is not None:
            acc = _tadd(acc, g * o.d)
    return acc


def composite_vjp_plain(c: CompositeStatic, m, a, r_in, r_ph, hit, cross_r,
                        cross_phi, cross_t, n_crossings, r_min_ph, lam,
                        state_u, jet_rows, g_rgb, density_scale=1.0,
                        intensity_scale=1.0) -> dict:
    """The VJP kernel's derivative chain in plain PyTorch: the cotangents
    of the composite's inputs for the (3, N) output cotangent ``g_rgb``,
    as a dict: per-ray ``cross_r``, ``cross_phi``, ``cross_t`` (K, N),
    ``state_u`` (8, N; the time row 0), ``r_min_ph``, ``lam`` (N,),
    ``jet_rows`` (3, N) and, for the 0-d inputs, ``m``, ``a``, ``r_in``,
    ``r_ph``, ``ds``, ``is`` (summed over the rays in float64, in the
    inputs' dtype; 0 where the input is a number or unused)."""
    with torch.no_grad():
        dtype = lam.dtype
        n = lam.shape[0]
        k_slots = cross_r.shape[0]
        escaped = hit == HIT_ESCAPE
        g_rgb = tuple(g_rgb[i] for i in range(3))
        zeros = lambda *s: torch.zeros(s, dtype=dtype, device=lam.device)
        per_ray = {s: zeros(n) for s in SCALARS}
        out = {"cross_r": zeros(k_slots, n), "cross_phi": zeros(k_slots, n),
               "cross_t": zeros(k_slots, n), "state_u": zeros(8, n),
               "r_min_ph": zeros(n), "lam": zeros(n),
               "jet_rows": torch.stack(g_rgb) if c.jets else zeros(3, n)}

        # The forward's values: each slot's alpha, the transmittance before
        # it, and whether it composites.
        trans = torch.ones(n, dtype=dtype, device=lam.device)
        alphas, trans_k, on_k = [], [], []
        if c.disk is not None:
            dens_ds = c.disk.density * _val(density_scale)
            for k in range(k_slots):
                _, alpha, valid = _slot(
                    c, m, a, r_in, cross_r[k], cross_phi[k], cross_t[k], lam,
                    3 if k == 0 else 1, dens_ds, intensity_scale)
                on = (k < n_crossings) & valid
                alphas.append(alpha.v)
                trans_k.append(trans)
                on_k.append(on)
                trans = torch.where(on, trans * (1.0 - alpha.v), trans)

        # The glow, along (r_min_ph, r_ph).
        if c.glow:
            glow = _glow(_seed(r_min_ph, 0, 2), _seed(r_ph, 1, 2), escaped)
            order = div_c(torch.clamp(n_crossings, 0, 3).to(dtype), 3.0).v
            g_glow = None
            for g, w, k in zip(g_rgb, _WARM, _COOL):
                g_glow = _tadd(g_glow, g * (w + order * (k - w)))
            d = g_glow * glow.d
            out["r_min_ph"] = d[0]
            per_ray["r_ph"] = d[1]

        # The starfield behind the escaped rays: along its direction, then
        # the direction along the state rows and (m, a).
        g_trans = torch.zeros(n, dtype=dtype, device=lam.device)
        if c.stars is not None:
            srows = tuple(torch.where(escaped, state_u[i], _DUMMY_U[i])
                          for i in range(1, 8))
            dirs = _escape_direction_u(srows, m, a)
            bg = _starfield(*(_seed(x.v, i, 3) for i, x in enumerate(dirs)),
                            c)
            w_bg = torch.where(escaped, trans, 0.0)
            g_bg = tuple(g * w_bg for g in g_rgb)
            g_w_bg = g_rgb[0] * bg[0].v + g_rgb[1] * bg[1].v + g_rgb[2] * bg[2].v
            g_trans = torch.where(escaped, g_w_bg, 0.0)
            g_dir = _contract(g_bg, bg)
            seeded = tuple(_seed(x, i, 9) for i, x in enumerate(srows))
            dirs = _escape_direction_u(seeded, _seed(m, 7, 9),
                                       _seed(a, 8, 9))
            d = _contract(tuple(g_dir), dirs)
            d = torch.where(escaped, d, 0.0)
            out["state_u"][1:] = d[:7]
            per_ray["m"] = per_ray["m"] + d[7]
            per_ray["a"] = per_ray["a"] + d[8]

        # The slots back to front.
        if c.disk is not None:
            ds = _scale_arg(density_scale, 7, 9)
            dens_ds = c.disk.density * ds
            int_scale = _scale_arg(intensity_scale, 8, 9)
            m9, a9, r_in9 = _seed(m, 4, 9), _seed(a, 5, 9), _seed(r_in, 6, 9)
            for k in range(k_slots - 1, -1, -1):
                on, tr, al = on_k[k], trans_k[k], alphas[k]
                c_rgb, alpha, _ = _slot(
                    c, m9, a9, r_in9, _seed(cross_r[k], 0, 9),
                    _seed(cross_phi[k], 1, 9), _seed(cross_t[k], 2, 9),
                    _seed(lam, 3, 9), 3 if k == 0 else 1, dens_ds, int_scale)
                w = tr * al
                g_w = (g_rgb[0] * c_rgb[0].v + g_rgb[1] * c_rgb[1].v
                       + g_rgb[2] * c_rgb[2].v)
                g_c = tuple(g * w for g in g_rgb)
                g_alpha = g_w * tr - g_trans * tr
                d = _contract(g_c + (g_alpha,), c_rgb + (alpha,))
                d = torch.where(on, d, 0.0)
                g_trans = torch.where(on, g_w * al + g_trans * (1.0 - al),
                                      g_trans)
                out["cross_r"][k] = d[0]
                out["cross_phi"][k] = d[1]
                out["cross_t"][k] = d[2]
                out["lam"] = out["lam"] + d[3]
                for s, i in (("m", 4), ("a", 5), ("r_in", 6), ("ds", 7),
                             ("is", 8)):
                    per_ray[s] = per_ray[s] + d[i]
        for s in SCALARS:
            out[s] = per_ray[s].double().sum().to(dtype)
        return out


# ---------------------------------------------------------------------------
# The kernels' wrapper
# ---------------------------------------------------------------------------

class _CArgs(ctypes.Structure):
    """``csrc/composite.cu::CompositeArgs``."""
    _fields_ = [
        ("n", ctypes.c_longlong), ("k", ctypes.c_int), ("jets", ctypes.c_int),
        ("ds_tensor", ctypes.c_int), ("is_tensor", ctypes.c_int),
        ("int_scale", ctypes.c_double), ("disk", DiskArgs),
        ("stars", StarArgs),
        ("t_coeffs", ctypes.c_float * SPECTRAL_CHEB_K),
        ("rgb_coeffs", ctypes.c_float * (3 * SPECTRAL_CHEB_K)),
        ("inv_logr", ctypes.c_float),
    ]


def _c_args(c: CompositeStatic, n: int, k: int, dtype, density_scale,
            intensity_scale) -> _CArgs:
    """The kernels' numbers for one launch: the disk's and the stars'
    (``ops/shade.py::shade_args``, the density times a number scale), the
    intensity scale where it is a number, the Chebyshev tables."""
    args = _CArgs()
    args.n, args.k, args.jets = n, k, int(c.jets)
    args.ds_tensor = int(isinstance(density_scale, torch.Tensor))
    args.is_tensor = int(isinstance(intensity_scale, torch.Tensor))
    args.int_scale = 1.0 if args.is_tensor else float(intensity_scale)
    args.disk, args.stars = shade_args(
        c.disk, c.stars, dtype, 1.0 if args.ds_tensor else density_scale)
    if c.cheb is not None:
        tc, rc, il = c.cheb
        args.t_coeffs[:] = tc
        args.rgb_coeffs[:] = [v for row in rc for v in row]
        args.inv_logr = il
    return args


def variant(c: CompositeStatic, dtype) -> tuple[str, ...]:
    """The -D flags of the build that computes ``c`` in ``dtype``: the
    instantiation's dtype, disk branch (0 none, 1 analytic, 2 Chebyshev),
    starfield and glow."""
    disk = 0 if c.disk is None else (2 if c.cheb is not None else 1)
    return (f"-DBH_F64={int(dtype == torch.float64)}", f"-DBH_DISK={disk}",
            f"-DBH_STAR={int(c.stars is not None)}",
            f"-DBH_GLOW={int(c.glow)}")


@functools.cache
def _library(flags: tuple[str, ...], kmax: int) -> ctypes.CDLL:
    """Build (at first use) and load the instantiation of
    csrc/composite.cu that ``flags`` select."""
    from blackhole_simulation_tpu_torch.ops.build import build

    lib = ctypes.CDLL(str(build("composite.cu", kmax, flags)))
    p = ctypes.c_void_p
    lib.bh_composite_forward.argtypes = [p] * 15 + [p, p]
    lib.bh_composite_forward.restype = ctypes.c_int
    lib.bh_composite_vjp.argtypes = [p] * 22 + [p, p]
    lib.bh_composite_vjp.restype = ctypes.c_int
    lib.bh_composite_blocks.argtypes = [ctypes.c_longlong]
    lib.bh_composite_blocks.restype = ctypes.c_longlong
    lib.bh_error_string.argtypes = [ctypes.c_int]
    lib.bh_error_string.restype = ctypes.c_char_p
    if lib.bh_composite_args_size() != ctypes.sizeof(_CArgs):
        raise RuntimeError("CompositeArgs differs between csrc/composite.cu "
                           "and ops/composite.py")
    return lib


def _ptr(x):
    return ctypes.c_void_p(None if x is None else x.data_ptr())


def refusal(c: CompositeStatic, m, a, r_in, r_ph, hit, cross_r, cross_phi,
            cross_t, n_crossings, r_min_ph, lam, state_u, jet_rows,
            density_scale, intensity_scale) -> str | None:
    """Why the kernels refuse these inputs, or None."""
    from blackhole_simulation_tpu_torch.ops.build import KMAX_LIMIT

    dtype = lam.dtype
    if dtype not in (torch.float32, torch.float64):
        return f"the kernel takes float32 or float64, not {dtype}"
    if lam.device.type != "cuda":
        return f"the kernel runs on CUDA, not {lam.device}"
    n = lam.shape[0]
    k = cross_r.shape[0] if cross_r.dim() == 2 else -1
    shapes = {"lam": (lam, (n,)), "r_min_ph": (r_min_ph, (n,)),
              "cross_r": (cross_r, (k, n)), "cross_phi": (cross_phi, (k, n)),
              "cross_t": (cross_t, (k, n)), "state_u": (state_u, (8, n))}
    if c.jets:
        shapes["jet_rows"] = (jet_rows, (3, n))
    for name, (x, shape) in shapes.items():
        if x.dtype != dtype or tuple(x.shape) != shape:
            return (f"{name}: {tuple(x.shape)} {x.dtype}, not {shape} "
                    f"{dtype}")
        if x.device != lam.device:
            return f"{name} on {x.device}, the rows on {lam.device}"
    for name, x in (("hit", hit), ("n_crossings", n_crossings)):
        if x.dtype != torch.int32 or tuple(x.shape) != (n,):
            return f"{name}: {tuple(x.shape)} {x.dtype}, not ({n},) int32"
        if x.device != lam.device:
            return f"{name} on {x.device}, the rows on {lam.device}"
    if not 1 <= k <= KMAX_LIMIT:
        return f"the kernel takes 1..{KMAX_LIMIT} crossing slots, not {k}"
    scalars = {"m": m, "a": a, "r_in": r_in, "r_ph": r_ph}
    for name, s in (("density_scale", density_scale),
                    ("intensity_scale", intensity_scale)):
        if isinstance(s, torch.Tensor):
            scalars[name] = s
        elif not isinstance(s, (int, float)):
            return f"{name}: a number or a 0-d tensor, not {type(s)}"
    for name, s in scalars.items():
        if s is None:
            continue
        if (not isinstance(s, torch.Tensor) or s.dim() != 0
                or s.dtype != dtype or s.device != lam.device):
            return f"{name}: a 0-d {dtype} tensor on {lam.device}"
    return None


def _check(err, lib, what):
    if err != 0:
        raise RuntimeError(f"composite {what} kernel launch failed: "
                           f"{lib.bh_error_string(err).decode()}")


def _tensor(s):
    """A scale's tensor, or None for a number."""
    return s if isinstance(s, torch.Tensor) else None


def composite_kernel(c: CompositeStatic, m, a, r_in, r_ph, hit, cross_r,
                     cross_phi, cross_t, n_crossings, r_min_ph, lam, state_u,
                     jet_rows, density_scale=1.0,
                     intensity_scale=1.0) -> torch.Tensor:
    """The composite by the forward kernel: a new (3, N) tensor of the
    rows' dtype, on the current stream, with no synchronisation. One
    launch; none for no rays. Raises ValueError where ``refusal`` finds a
    reason, RuntimeError if the launch fails. Counts each launch in
    ``composite_kernel.launches``."""
    from blackhole_simulation_tpu_torch.ops.build import kmax_for

    reason = refusal(c, m, a, r_in, r_ph, hit, cross_r, cross_phi, cross_t,
                     n_crossings, r_min_ph, lam, state_u, jet_rows,
                     density_scale, intensity_scale)
    if reason is not None:
        raise ValueError(f"composite kernel: {reason}")
    n, k = lam.shape[0], cross_r.shape[0]
    out = torch.empty((3, n), dtype=lam.dtype, device=lam.device)
    if n == 0:
        return out
    kmax = kmax_for(k)
    lib = _library(variant(c, lam.dtype), kmax)
    args = _c_args(c, n, k, lam.dtype, density_scale, intensity_scale)
    with torch.cuda.device(lam.device):
        stream = torch.cuda.current_stream(lam.device).cuda_stream
        err = lib.bh_composite_forward(
            ctypes.byref(args), _ptr(m), _ptr(a), _ptr(r_in), _ptr(r_ph),
            _ptr(_tensor(density_scale)), _ptr(_tensor(intensity_scale)),
            _ptr(hit), _ptr(cross_r.contiguous()),
            _ptr(cross_phi.contiguous()), _ptr(cross_t.contiguous()),
            _ptr(n_crossings), _ptr(r_min_ph), _ptr(lam),
            _ptr(state_u.contiguous()),
            _ptr(jet_rows.contiguous() if c.jets else None), _ptr(out),
            ctypes.c_void_p(stream))
    _check(err, lib, "forward")
    composite_kernel.launches += 1
    return out


composite_kernel.launches = 0


def composite_vjp_kernel(c: CompositeStatic, m, a, r_in, r_ph, hit, cross_r,
                         cross_phi, cross_t, n_crossings, r_min_ph, lam,
                         state_u, jet_rows, g_rgb, density_scale=1.0,
                         intensity_scale=1.0, wanted=None) -> dict:
    """``composite_vjp_plain`` by the VJP kernel and its reduction, on the
    current stream: a dict of the same cotangents, those of ``wanted``
    (every one when None); the 0-d ones are 0-d tensors of the rows'
    dtype. Two launches; none for no rays. Counts each call that launches
    in ``composite_vjp_kernel.launches``."""
    from blackhole_simulation_tpu_torch.ops.build import kmax_for

    reason = refusal(c, m, a, r_in, r_ph, hit, cross_r, cross_phi, cross_t,
                     n_crossings, r_min_ph, lam, state_u, jet_rows,
                     density_scale, intensity_scale)
    if reason is not None:
        raise ValueError(f"composite VJP kernel: {reason}")
    if tuple(g_rgb.shape) != (3, lam.shape[0]) or g_rgb.dtype != lam.dtype:
        raise ValueError("composite VJP kernel: the cotangent is a (3, N) "
                         f"tensor of {lam.dtype}, not {tuple(g_rgb.shape)} "
                         f"{g_rgb.dtype}")
    n, k = lam.shape[0], cross_r.shape[0]
    want = lambda name: wanted is None or name in wanted
    new = lambda *s: torch.empty(s, dtype=lam.dtype, device=lam.device)
    out = {}
    for name, shape in (("cross_r", (k, n)), ("cross_phi", (k, n)),
                        ("cross_t", (k, n)), ("state_u", (8, n)),
                        ("r_min_ph", (n,)), ("lam", (n,))):
        if want(name):
            out[name] = new(*shape)
    if want("jet_rows"):
        out["jet_rows"] = g_rgb if c.jets else torch.zeros_like(g_rgb)
    scalars = torch.zeros(len(SCALARS), dtype=lam.dtype, device=lam.device)
    if n > 0:
        kmax = kmax_for(k)
        lib = _library(variant(c, lam.dtype), kmax)
        args = _c_args(c, n, k, lam.dtype, density_scale, intensity_scale)
        partials = torch.empty((lib.bh_composite_blocks(n), len(SCALARS)),
                               dtype=torch.float64, device=lam.device)
        with torch.cuda.device(lam.device):
            stream = torch.cuda.current_stream(lam.device).cuda_stream
            err = lib.bh_composite_vjp(
                ctypes.byref(args), _ptr(m), _ptr(a), _ptr(r_in), _ptr(r_ph),
                _ptr(_tensor(density_scale)), _ptr(_tensor(intensity_scale)),
                _ptr(hit), _ptr(cross_r.contiguous()),
                _ptr(cross_phi.contiguous()), _ptr(cross_t.contiguous()),
                _ptr(n_crossings), _ptr(r_min_ph), _ptr(lam),
                _ptr(state_u.contiguous()), _ptr(g_rgb.contiguous()),
                _ptr(out.get("cross_r")), _ptr(out.get("cross_phi")),
                _ptr(out.get("cross_t")), _ptr(out.get("state_u")),
                _ptr(out.get("r_min_ph")), _ptr(out.get("lam")),
                _ptr(partials), _ptr(scalars), ctypes.c_void_p(stream))
        _check(err, lib, "VJP")
        composite_vjp_kernel.launches += 1
    for i, s in enumerate(SCALARS):
        out[s] = scalars[i]
    return out


composite_vjp_kernel.launches = 0

# The Function's tensor inputs, in order after the static configuration.
_INPUTS = ("m", "a", "r_in", "r_ph", "density_scale", "intensity_scale",
           "cross_r", "cross_phi", "cross_t", "state_u", "r_min_ph", "lam",
           "jet_rows")
_GRAD_OF = {"density_scale": "ds", "intensity_scale": "is"}


class CompositeFn(torch.autograd.Function):
    """The composite kernel forward, the VJP kernel backward. ``apply(c,
    hit, n_crossings, *inputs)`` with the inputs of ``_INPUTS`` (the two
    scales numbers or 0-d tensors, ``r_in``/``r_ph``/``jet_rows`` None
    where unused); returns the (3, N) radiance rows."""

    @staticmethod
    def forward(ctx, c, hit, n_crossings, *inputs):
        kw = dict(zip(_INPUTS, inputs))
        ctx.c = c
        ctx.scales = (kw["density_scale"], kw["intensity_scale"])
        ctx.save_for_backward(hit, n_crossings,
                              *(x if isinstance(x, torch.Tensor) else None
                                for x in inputs))
        return composite_kernel(c, kw["m"], kw["a"], kw["r_in"], kw["r_ph"],
                                hit, kw["cross_r"], kw["cross_phi"],
                                kw["cross_t"], n_crossings, kw["r_min_ph"],
                                kw["lam"], kw["state_u"], kw["jet_rows"],
                                kw["density_scale"], kw["intensity_scale"])

    @staticmethod
    def backward(ctx, g_rgb):
        hit, n_crossings, *saved = ctx.saved_tensors
        kw = dict(zip(_INPUTS, saved))
        kw["density_scale"], kw["intensity_scale"] = ctx.scales
        needs = ctx.needs_input_grad[3:]
        wanted = {_GRAD_OF.get(name, name)
                  for name, need in zip(_INPUTS, needs) if need}
        out = composite_vjp_kernel(
            ctx.c, kw["m"], kw["a"], kw["r_in"], kw["r_ph"], hit,
            kw["cross_r"], kw["cross_phi"], kw["cross_t"], n_crossings,
            kw["r_min_ph"], kw["lam"], kw["state_u"], kw["jet_rows"],
            g_rgb.contiguous(), kw["density_scale"], kw["intensity_scale"],
            wanted=wanted)
        grads = tuple(out[_GRAD_OF.get(name, name)] if need else None
                      for name, need in zip(_INPUTS, needs))
        return (None, None, None) + grads


def composite_rows(c: CompositeStatic, m, a, hit, cross_r, cross_phi,
                   cross_t, n_crossings, r_min_ph, lam, state_u, jet_rows,
                   density_scale=1.0, intensity_scale=1.0):
    """The composite of CUDA rows on the kernels, differentiable: (r, g, b)
    rows. The ISCO and the photon sphere are computed here from ``m`` and
    ``a``, so that autograd chains them."""
    from blackhole_simulation_tpu_torch.geometry.metrics import (
        isco_t,
        photon_sphere_t,
    )

    r_in = isco_t(m, a) if c.disk is not None else None
    r_ph = photon_sphere_t(m, a) if c.glow else None
    out = CompositeFn.apply(c, hit, n_crossings, m, a, r_in, r_ph,
                            density_scale, intensity_scale, cross_r,
                            cross_phi, cross_t, state_u, r_min_ph, lam,
                            jet_rows if c.jets else None)
    return tuple(out.unbind(0))
