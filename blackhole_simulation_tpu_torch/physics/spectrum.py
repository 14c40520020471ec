"""Blackbody spectra -> CIE XYZ -> linear sRGB, host float64 numpy.

Counterpart of ``blackhole_simulation_tpu/physics/spectrum.py``: the
Gaussian-sum CIE 1931 colour matching fits, the Planck law with its overflow
guard, the trapezoid over 380-780 nm, the XYZ -> linear sRGB matrix
(:24-100) and the 2-D blackbody LUT ``generate_blackbody_lut`` (:102-117).
Runs once per scene, to build the spectral disk tables, and behind the
engine facade.
"""

from __future__ import annotations

import numpy as np

from blackhole_simulation_tpu_torch.constants import C_SI, H_PLANCK, K_B


def _gauss(x, mu, s1, s2):
    s = np.where(x < mu, s1, s2)
    t = (x - mu) / s
    return np.exp(-0.5 * t * t)


def cie_xbar(lam_nm):
    return (
        1.056 * _gauss(lam_nm, 599.8, 37.9, 31.0)
        + 0.362 * _gauss(lam_nm, 442.0, 16.0, 26.7)
        - 0.065 * _gauss(lam_nm, 501.1, 20.4, 26.2)
    )


def cie_ybar(lam_nm):
    return 0.821 * _gauss(lam_nm, 568.8, 46.9, 40.5) + 0.286 * _gauss(
        lam_nm, 530.9, 16.3, 31.1
    )


def cie_zbar(lam_nm):
    return 1.217 * _gauss(lam_nm, 437.0, 11.8, 36.0) + 0.681 * _gauss(
        lam_nm, 459.0, 26.0, 13.8
    )


def planck_law(lam_m, t_kelvin):
    """Spectral radiance B(lambda, T) [W sr^-1 m^-3], overflow-guarded.
    ``lam_m`` in metres; broadcasts with ``t_kelvin``."""
    t = np.maximum(np.asarray(t_kelvin, np.float64), 1e-6)
    x = H_PLANCK * C_SI / (lam_m * K_B * t)
    x = np.minimum(x, 700.0)
    return (2.0 * H_PLANCK * C_SI * C_SI / lam_m**5) / np.expm1(x)


def integrate_planck_xyz(t_kelvin):
    """Integrate B(lambda, T) against the CIE fits over 380-780 nm:
    XYZ of shape t_kelvin.shape + (3,)."""
    t = np.asarray(t_kelvin, np.float64)
    lam_nm = np.linspace(380.0, 780.0, 81)
    b = planck_law(lam_nm * 1e-9, t[..., None])                  # (..., 81)
    bars = np.stack([cie_xbar(lam_nm), cie_ybar(lam_nm), cie_zbar(lam_nm)])
    return np.trapezoid(b[..., None, :] * bars, lam_nm, axis=-1)


_XYZ_TO_RGB = np.array(
    [
        [3.2406, -1.5372, -0.4986],
        [-0.9689, 1.8758, 0.0415],
        [0.0557, -0.2040, 1.0570],
    ]
)


def xyz_to_linear_rgb(xyz):
    """CIE XYZ -> linear sRGB (unclamped). ``xyz``: (..., 3)."""
    return np.einsum("ij,...j->...i", _XYZ_TO_RGB, xyz)


def blackbody_rgb(t_kelvin, normalize: bool = True):
    """Chromaticity-normalized linear-sRGB colour of a blackbody at T."""
    xyz = integrate_planck_xyz(t_kelvin)
    if normalize:
        xyz = xyz / np.maximum(xyz[..., 1:2], 1e-30)
    return np.clip(xyz_to_linear_rgb(xyz), 0.0, None)


def generate_blackbody_lut(width: int = 256, height: int = 64, t_max=4e4,
                           g_min=0.05, g_max=5.0):
    """2-D blackbody LUT, RGBA float32 of shape (height, width, 4): rows are
    the g-factor in [g_min, g_max], columns the temperature on a ^2.5-warped
    axis up to ``t_max``. RGB is the chromaticity of the blackbody at g T;
    alpha its bolometric intensity (g T / (g_max t_max))^4."""
    ts = t_max * np.linspace(0.0, 1.0, width) ** 2.5
    gs = g_min + (g_max - g_min) * np.linspace(0.0, 1.0, height)
    t_obs = gs[:, None] * np.maximum(ts[None, :], 1.0)
    rgb = blackbody_rgb(t_obs)
    intensity = (t_obs / (g_max * t_max)) ** 4
    return np.concatenate([rgb, intensity[..., None]], axis=-1).astype(
        np.float32)
