"""The port's analytics against the JAX package's, on the CPU.

Every ported function of ``physics/`` (disk, spectrum, redshift, Hawking,
matter) and ``spacetime/`` (curvature, embedding, frame drag, light cones)
on the same float64 inputs as its JAX twin: one case each, at rel 1e-10
(measured: the largest relative difference of any case is 2.2e-15, the
Page-Thorne flux's cumulative trapezoid; the float32 outputs, the LUTs and
meshes, are equal). The Page-Thorne flux with a positional ``mdot`` (the
facade's and ``disk_temperature``'s call) is held at rel 1e-12 at mdot 1
and 2.5 (measured 2.0e-15 and 2.2e-15): the port's had no ``mdot``, and a
positional 2.5 landed in ``n_grid``. The shading wrappers (``hash31``,
``blackbody_ramp``, ``disk_emission``, ``disk_emission_lut``,
``starfield``) are float32 and held to JAX run op by op at atol 1e-6
(measured: at most 4.2e-7, the ramp's float32 log and pow).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blackhole_simulation_tpu.physics as jphys
import blackhole_simulation_tpu.physics.matter as jmatter
import blackhole_simulation_tpu.render.shading as jshading
import blackhole_simulation_tpu.spacetime as jspace
import blackhole_simulation_tpu_torch.physics as tphys
import blackhole_simulation_tpu_torch.physics.hawking as thawking
import blackhole_simulation_tpu_torch.physics.matter as tmatter
import blackhole_simulation_tpu_torch.render.shading as tshading
import blackhole_simulation_tpu_torch.spacetime as tspace
from blackhole_simulation_tpu.geometry.metrics import BL as JBL
from blackhole_simulation_tpu.geometry.metrics import KS as JKS
from blackhole_simulation_tpu.geometry.metrics import Kerr as JKerr
from blackhole_simulation_tpu.physics.hawking import surface_gravity
from blackhole_simulation_tpu_torch.geometry.metrics import BL, KS, KerrMetric

torch.set_num_threads(1)

M, A = 1.0, 0.7
RNG = np.random.default_rng(9)
R = np.sort(RNG.uniform(1.2, 40.0, 65))
TH = RNG.uniform(0.05, math.pi - 0.05, 65)
RG = np.linspace(1.2, 20.0, 17)
TG = np.linspace(0.05, math.pi - 0.05, 9)
BETA = RNG.uniform(0.0, 0.95, 65)
COS = RNG.uniform(-1.0, 1.0, 65)
LAM = RNG.uniform(-6.0, 6.0, 65)
U_CON = RNG.normal(size=(65, 4))
G_COV = RNG.normal(size=(65, 4, 4))


def _t(x):
    """numpy arrays as float64 tensors; everything else as it is."""
    return torch.from_numpy(x) if isinstance(x, np.ndarray) else x


def _j(x):
    return jnp.asarray(x) if isinstance(x, np.ndarray) else x


def _flat(out):
    """Every array of a (nested) result as one float64 numpy vector."""
    if isinstance(out, (tuple, list)):
        return np.concatenate([_flat(o) for o in out])
    if isinstance(out, torch.Tensor):
        out = out.numpy()
    return np.asarray(out, np.float64).ravel()


def _metrics(chart_j, chart_t):
    return (JKerr(mass=jnp.asarray(M), spin=jnp.asarray(A), chart=chart_j),
            KerrMetric.create(M, A, chart=chart_t, device="cpu"))


# name: (JAX callable, port callable, args). Arrays go to each side as its
# own array type; numbers stay numbers.
CASES = {
    "circular_orbit_energy": (jphys.circular_orbit_energy,
                              tphys.circular_orbit_energy, (M, A, R)),
    "circular_orbit_angular_momentum": (
        jphys.circular_orbit_angular_momentum,
        tphys.circular_orbit_angular_momentum, (M, A, R)),
    "circular_orbit_omega": (jphys.circular_orbit_omega,
                             tphys.circular_orbit_omega, (M, A, R)),
    "page_thorne_flux_mdot_2.5": (jphys.page_thorne_flux,
                                  tphys.page_thorne_flux, (R, M, A, 2.5)),
    "disk_temperature": (jphys.disk_temperature, tphys.disk_temperature,
                         (R, M, A, 2.5)),
    "generate_temperature_lut": (
        lambda *a: jphys.generate_temperature_lut(*a, width=64),
        lambda *a: tphys.generate_temperature_lut(*a, width=64),
        (M, A, 2.5)),
    "temperature_profile": (jphys.temperature_profile,
                            tphys.temperature_profile, (M, A, 2.5, 64)),
    "generate_blackbody_lut": (
        lambda: jphys.generate_blackbody_lut(32, 8),
        lambda: tphys.generate_blackbody_lut(32, 8), ()),
    "gravitational_factor": (jphys.gravitational_factor,
                             tphys.gravitational_factor, (R, M)),
    "doppler_factor": (jphys.doppler_factor, tphys.doppler_factor,
                       (BETA, COS)),
    "kerr_g_factor": (jphys.kerr_g_factor, tphys.kerr_g_factor,
                      (R, M, A, LAM)),
    "combined_redshift": (jphys.combined_redshift, tphys.combined_redshift,
                          (R, M, BETA, COS)),
    "intensity_scaling_thick": (jphys.intensity_scaling,
                                tphys.intensity_scaling, (BETA + 0.5,)),
    "intensity_scaling_thin": (
        lambda g: jphys.intensity_scaling(g, False),
        lambda g: tphys.intensity_scaling(g, False), (BETA + 0.5,)),
    "surface_gravity": (surface_gravity, thawking.surface_gravity, (M, A)),
    "hawking_temperature": (jphys.hawking_temperature,
                            tphys.hawking_temperature, (10.0, A)),
    "disk_density": (jmatter.AccretionDisk().density,
                     tmatter.AccretionDisk().density, (M, A, R, TH)),
    "disk_four_velocity": (jmatter.AccretionDisk().four_velocity,
                           tmatter.AccretionDisk().four_velocity,
                           (M, A, R, TH)),
    "disk_surface_density": (jmatter.AccretionDisk().surface_density,
                             tmatter.AccretionDisk().surface_density,
                             (M, A, R)),
    "jet_density": (jmatter.RelativisticJet().density,
                    tmatter.RelativisticJet().density, (M, A, R, TH)),
    "jet_four_velocity": (jmatter.RelativisticJet().four_velocity,
                          tmatter.RelativisticJet().four_velocity,
                          (M, A, R, TH)),
    "jet_doppler": (jmatter.RelativisticJet().doppler,
                    tmatter.RelativisticJet().doppler, (COS,)),
    "blandford_znajek_power": (
        jmatter.RelativisticJet().blandford_znajek_power,
        tmatter.RelativisticJet().blandford_znajek_power, (M, A, 2.0)),
    "stress_energy_dust": (jmatter.stress_energy_dust,
                           tmatter.stress_energy_dust, (R, U_CON, G_COV)),
    "kretschmann_kerr": (jspace.kretschmann_kerr, tspace.kretschmann_kerr,
                         (M, A, R, TH)),
    "kretschmann_schwarzschild": (jspace.kretschmann_schwarzschild,
                                  tspace.kretschmann_schwarzschild, (M, R)),
    "curvature_field": (jspace.curvature_field, tspace.curvature_field,
                        (M, A, RG, TG)),
    "flamm_height": (jspace.flamm_height, tspace.flamm_height, (R, M)),
    "kerr_embedding_height": (jspace.kerr_embedding_height,
                              tspace.kerr_embedding_height, (R, M, A)),
    "proper_distance": (jspace.proper_distance, tspace.proper_distance,
                        (3.0, 25.0, M, A)),
    "embedding_mesh": (jspace.embedding_mesh, tspace.embedding_mesh,
                       (M, A, 16, 12)),
    "frame_dragging_omega": (jspace.frame_dragging_omega,
                             tspace.frame_dragging_omega, (M, A, R, TH)),
    "frame_drag_field": (jspace.frame_drag_field, tspace.frame_drag_field,
                         (M, A, RG, TG)),
    "ergosphere_mesh": (jspace.ergosphere_mesh, tspace.ergosphere_mesh,
                        (M, A, 12, 10)),
}
for _chart, (_cj, _ct) in {"bl": (JBL, BL), "ks": (JKS, KS)}.items():
    _jm, _tm = _metrics(_cj, _ct)
    CASES[f"light_cone_tilt_{_chart}"] = (
        lambda r, th, m=_jm: jspace.light_cone_tilt(m, r, th),
        lambda r, th, m=_tm: tspace.light_cone_tilt(m, r, th), (R, TH))
    CASES[f"tilt_field_{_chart}"] = (
        lambda r, th, m=_jm: jspace.tilt_field(m, r, th),
        lambda r, th, m=_tm: tspace.tilt_field(m, r, th), (RG, TG))


@pytest.mark.parametrize("name", sorted(CASES))
def test_analytics_match_jax(name):
    jfn, tfn, args = CASES[name]
    ref = _flat(jfn(*[_j(a) for a in args]))
    out = _flat(tfn(*[_t(a) for a in args]))
    assert out.shape == ref.shape
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(out, ref, rtol=1e-10, atol=0.0)


@pytest.mark.parametrize("mdot", [1.0, 2.5])
def test_page_thorne_flux_takes_mdot_at_jax_position(mdot):
    """Repair: ``mdot`` is the fourth positional argument, as in JAX."""
    ref = np.asarray(jphys.page_thorne_flux(jnp.asarray(R), M, A, mdot))
    out = tphys.page_thorne_flux(R, M, A, mdot)
    assert (ref > 0).sum() > 50
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=0.0)
    scalar = tphys.page_thorne_flux(8.0, M, A, mdot)
    np.testing.assert_allclose(
        scalar, float(jphys.page_thorne_flux(jnp.asarray(8.0), M, A, mdot)),
        rtol=1e-12)


# --- shading wrappers (float32, JAX op by op) -------------------------------

N_SH = 257
XYZ = RNG.uniform(-40.0, 40.0, (3, N_SH)).astype(np.float32)
T_K = RNG.uniform(500.0, 45000.0, N_SH).astype(np.float32)
DIRS = RNG.normal(size=(N_SH, 3))
DIRS = (DIRS / np.linalg.norm(DIRS, axis=1, keepdims=True)).astype(np.float32)
R_C = RNG.uniform(1.0, 20.0, N_SH).astype(np.float32)
PHI_C = RNG.uniform(-7.0, 7.0, N_SH).astype(np.float32)
T_C = RNG.uniform(0.0, 80.0, N_SH).astype(np.float32)
LAM32 = RNG.uniform(-6.0, 6.0, N_SH).astype(np.float32)


def _jbh():
    return JKerr(mass=jnp.float32(1.0), spin=jnp.float32(0.9), chart=JKS)


def _shading_case(name):
    """(JAX result, port result) of one wrapper."""
    m, a = torch.tensor(1.0), torch.tensor(np.float32(0.9))
    disk = tshading.DiskParams()
    crossing = [torch.from_numpy(x) for x in (R_C, PHI_C, T_C, LAM32)]
    jcrossing = [jnp.asarray(x) for x in (R_C, PHI_C, T_C, LAM32)]
    if name == "hash31":
        return (jshading.hash31(*[jnp.asarray(v) for v in XYZ]),
                tshading.hash31(*[torch.from_numpy(v) for v in XYZ]))
    if name == "blackbody_ramp":
        return (jshading.blackbody_ramp(jnp.asarray(T_K)),
                tshading.blackbody_ramp(torch.from_numpy(T_K)))
    if name == "starfield":
        return (jshading.starfield(jnp.asarray(DIRS)),
                tshading.starfield(torch.from_numpy(DIRS)))
    if name == "disk_emission":
        # The ISCO in float64 rounded once, on both sides.
        jbh = JKerr(mass=jnp.asarray(1.0), spin=jnp.asarray(float(a)),
                    chart=JKS)
        r_in = torch.tensor(np.float32(jbh.isco()))
        return (jshading.disk_emission(jshading.DiskParams(), jbh,
                                       *jcrossing),
                tshading.disk_emission(disk, m, a, *crossing, r_in=r_in))
    luts = tshading.disk_luts(1.0, float(np.float32(0.9)), disk)
    jluts = tuple(jnp.asarray(t.numpy()) for t in luts)
    return (jshading.disk_emission_lut(jshading.DiskParams(), _jbh(), jluts,
                                       *jcrossing),
            tshading.disk_emission_lut(disk, m, a, luts, *crossing))


@pytest.mark.parametrize("name", ["hash31", "blackbody_ramp", "starfield",
                                  "disk_emission", "disk_emission_lut"])
def test_shading_wrappers_match_jax(name):
    with jax.disable_jit():
        ref, out = _shading_case(name)
    ref, out = _flat(ref), _flat(out)
    assert out.shape == ref.shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0.0, atol=1e-6)
    assert np.abs(ref).max() > 0.0
