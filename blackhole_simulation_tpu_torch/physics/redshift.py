"""Redshift g-factors: gravitational, special-relativistic, full Kerr.

Counterpart of ``blackhole_simulation_tpu/physics/redshift.py``: the static
gravitational factor, the SR Doppler factor, the Cunningham (1975) Kerr
g-factor of a circular equatorial emitter, their legacy product and the
Liouville intensity scaling. Tensors in, tensors out, on the inputs'
device (numbers and arrays become float64 tensors); everything broadcasts.
"""

from __future__ import annotations

import math

import torch

from blackhole_simulation_tpu_torch._elementwise import f64_args


def gravitational_factor(r, m=1.0):
    """Static gravitational redshift g = sqrt(1 - 2M/r), clipped at 0 inside
    the horizon."""
    r, m = f64_args(r, m)
    return torch.sqrt(torch.clamp(1.0 - 2.0 * m / r, min=0.0))


def doppler_factor(beta, cos_theta):
    """Special-relativistic Doppler delta = 1 / (gamma (1 - beta cos theta))."""
    beta, cos_theta = f64_args(beta, cos_theta)
    gamma = 1.0 / torch.sqrt(torch.clamp(1.0 - beta * beta, min=1e-12))
    return 1.0 / (gamma * (1.0 - beta * cos_theta))


def kerr_g_factor(r, m=1.0, a=0.0, lam=0.0):
    """Cunningham g = 1 / (u^t (1 - lam Omega)) of a prograde Keplerian
    emitter at equatorial r seen by a photon of impact parameter
    lam = L_z / E, from the equatorial Kerr metric components."""
    r, m, a, lam = f64_args(r, m, a, lam)
    c = math.cos(math.pi / 2)
    sig = r * r + a * a * c * c
    two_mr = 2.0 * m * r
    g_tt = -(1.0 - two_mr / sig)
    g_tph = -two_mr * a / sig
    g_phph = r * r + a * a + two_mr * a * a / sig
    sqm = torch.sqrt(m)
    omega = sqm / (r ** 1.5 + a * sqm)
    ut_inv_sq = -(g_tt + 2.0 * omega * g_tph + omega * omega * g_phph)
    u_t = 1.0 / torch.sqrt(torch.clamp(ut_inv_sq, min=1e-12))
    return 1.0 / (u_t * (1.0 - lam * omega))


def combined_redshift(r, m=1.0, beta=0.0, cos_theta=0.0):
    """The legacy SR x gravitational approximation."""
    return gravitational_factor(r, m) * doppler_factor(beta, cos_theta)


def intensity_scaling(g, optically_thick: bool = True):
    """Liouville: I_obs = g^4 I_emit (optically thick surface) or g^3
    (optically thin emissivity)."""
    (g,) = f64_args(g)
    return torch.pow(g, 4.0 if optically_thick else 3.0)
