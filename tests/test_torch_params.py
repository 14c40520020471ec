"""The render kernel's parameter row against one built from the JAX
package's own functions.

The reference row follows ``pallas_render_sample``'s prologue
(ops/pallas_render.py:516-633) with JAX's ``camera_scalars``, ``Kerr``
radii, ``_eta_crit_cheb_coeffs`` and ``spectral_kernel_tables``, evaluated in
float64 from the float32-rounded mass and spin and cast once, as the port
builds its row. Head scalars and the 65 spectral scalars agree to a relative
1e-6 (of each value, or of its group's largest magnitude for the entries
that are zero up to rounding, such as the ZAMO's p_phi).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackhole_simulation_tpu.geometry.metrics import KS, Kerr
from blackhole_simulation_tpu.render.camera import Camera as JCamera
from blackhole_simulation_tpu.render.camera import camera_scalars
from blackhole_simulation_tpu.render.precull import _eta_crit_cheb_coeffs
from blackhole_simulation_tpu.render.shading import (
    DiskParams as JDiskParams,
    spectral_kernel_tables as j_tables,
)
from blackhole_simulation_tpu_torch.ops import render as R
from blackhole_simulation_tpu_torch.render.pipeline import (
    kernel_inputs,
    scene_from_numpy,
)
from blackhole_simulation_tpu_torch.render.shading import (
    DiskParams as TDiskParams,
    spectral_kernel_tables as t_tables,
)

torch.set_num_threads(1)

CFG = dict(max_steps=256, use_pallas=True, fused=True, shadow_precull=True,
           step_rate=0.2, far_step_cap_rate=0.4, far_boost_radius=20.0,
           approx_recip=True, midpoint_iters=1)
THETAS = {"flagship": math.pi / 2 - 0.25, "polar": 1e-4}


def _jax_row(theta, spin, jitter):
    m = float(np.float32(1.0))
    a = float(np.float32(spin))
    cam = JCamera.create(r=30.0, theta=theta, fov=0.5, width=1920, height=1080)
    bh = Kerr(mass=jnp.float64(m), spin=jnp.float64(a), chart=KS)
    c0, c_r, c_th, c_ph, k1, k2, rc, rs = camera_scalars(cam, bh, jnp.float64)
    r_h = float(bh.event_horizon())
    hor = 1.01 * r_h
    isco = float(bh.isco())
    a_cheb = min(max(abs(a), 1e-3 * m), 0.999 * m)
    eta, mid, half, lo, hi = _eta_crit_cheb_coeffs(
        jnp.float64(m), jnp.float64(a_cheb)
    )
    tc, rgb, il = j_tables(1.0, spin, JDiskParams())
    head = [m, a, r_h, float(bh.photon_sphere()), isco,
            max(isco, 1.0, hor), hor, 30.0, math.cos(theta),
            math.sqrt(max(1.0 - math.cos(theta) ** 2, 1e-12)), 0.0,
            float(k1), float(k2), float(rc), float(rs), jitter[0], jitter[1],
            *map(float, c0), *map(float, c_r), *map(float, c_th),
            *map(float, c_ph), float(mid), float(half), float(lo), float(hi),
            1.0, a_cheb, float(il)]
    return (np.asarray(head, np.float32), np.asarray(eta, np.float32),
            np.asarray(tc, np.float32), np.asarray(rgb, np.float32).ravel())


def _port_row(theta, spin, jitter):
    scene = scene_from_numpy(
        mass=1.0, spin=spin,
        camera=dict(r=30.0, theta=theta, phi=0.0, fov=0.5, roll=0.0,
                    width=1920, height=1080),
        march_cfg=CFG, features=dict(spectral_lut=True),
    )
    row, _ = kernel_inputs(scene, jitter, "cpu")
    return row.numpy()


# Head entries grouped by the vector they belong to, for the scale of the
# entries that vanish up to rounding.
_GROUPS = [range(0, 17), range(17, 21), range(21, 25), range(25, 29),
           range(29, 33), range(33, 40)]


@pytest.mark.parametrize("spin", [0.999, 0.9])
@pytest.mark.parametrize("where", sorted(THETAS))
def test_parameter_row_matches_jax(where, spin):
    jitter = (0.25, -0.125)
    head, eta, tc, rgb = _jax_row(THETAS[where], spin, jitter)
    row = _port_row(THETAS[where], spin, jitter)
    assert row.shape == (R._P_PAD,) and row.dtype == np.float32
    for g in _GROUPS:
        idx = list(g)
        scale = np.abs(head[idx]).max()
        np.testing.assert_allclose(row[idx], head[idx], rtol=1e-6,
                                   atol=1e-6 * scale, err_msg=str(idx))
    np.testing.assert_allclose(row[R._P_ETA:R._P_TSHAPE], eta, rtol=1e-6,
                               atol=1e-6 * np.abs(eta).max())
    np.testing.assert_allclose(row[R._P_TSHAPE:R._P_RGB], tc, rtol=1e-6,
                               atol=1e-6 * np.abs(tc).max())
    np.testing.assert_allclose(row[R._P_RGB:R._P_OVW], rgb, rtol=1e-6,
                               atol=1e-6 * np.abs(rgb).max())
    # the overlay and NRS blocks (later slices) stay zero
    assert not row[R._P_OVW:].any()


def test_layout_matches_jax():
    import importlib

    jr = importlib.import_module("blackhole_simulation_tpu.ops.pallas_render")
    names = [n for n in dir(jr) if n.startswith("_P_")] + ["_NRS_FLAT", "_OVERLAY_N"]
    assert names
    for n in names:
        assert getattr(R, n) == getattr(jr, n), n
    assert R._P_PAD == 1024


@pytest.mark.parametrize("spin", [0.999, 0.5])
def test_spectral_tables_match_jax(spin):
    disk = JDiskParams()
    jt = j_tables(1.0, spin, disk)
    pt = t_tables(1.0, spin, TDiskParams())
    for j, p in zip(jt, pt):
        j = np.asarray(j, np.float32)
        assert p.shape == j.shape and p.dtype == np.float32
        np.testing.assert_allclose(p, j, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(j).max()))


def test_jax_row_is_the_float32_row_up_to_its_rounding():
    """The JAX package builds its own row partly in float32; the float64
    build differs from it only at float32 rounding (relative 1e-5)."""
    dtype = jnp.float32
    cam = JCamera.create(r=30.0, theta=THETAS["flagship"], fov=0.5,
                         width=1920, height=1080)
    bh = Kerr(mass=jnp.float32(1.0), spin=jnp.float32(0.999), chart=KS)
    with jax.default_device(jax.devices("cpu")[0]):
        c0, *_ = camera_scalars(cam, bh, dtype)
        r_h = float(bh.event_horizon())
    row = _port_row(THETAS["flagship"], 0.999, (0.0, 0.0))
    assert row[R._P_RH] == pytest.approx(r_h, rel=1e-5)
    np.testing.assert_allclose(row[R._P_C0:R._P_C0 + 3], np.asarray(c0)[:3],
                               rtol=1e-5)
