"""Astrophysical observables: disk thermodynamics, redshift, shadow,
spectra, Hawking temperature, matter fields (counterpart of
``blackhole_simulation_tpu/physics``). The disk, spectrum and shadow
modules compute on the host in float64 numpy; redshift, Hawking and matter
in torch on their inputs' device."""

from blackhole_simulation_tpu_torch.physics.disk import (
    circular_orbit_angular_momentum,
    circular_orbit_energy,
    circular_orbit_omega,
    disk_temperature,
    generate_temperature_lut,
    page_thorne_flux,
    temperature_profile,
)
from blackhole_simulation_tpu_torch.physics.hawking import hawking_temperature
from blackhole_simulation_tpu_torch.physics.redshift import (
    combined_redshift,
    doppler_factor,
    gravitational_factor,
    intensity_scaling,
    kerr_g_factor,
)
from blackhole_simulation_tpu_torch.physics.shadow import (
    bardeen_shadow,
    einstein_angle,
    magnification,
    magnification_point_lens,
    schwarzschild_shadow_radius,
    shadow_critical_params,
)
from blackhole_simulation_tpu_torch.physics.spectrum import (
    blackbody_rgb,
    generate_blackbody_lut,
    integrate_planck_xyz,
    planck_law,
    xyz_to_linear_rgb,
)

__all__ = [
    "circular_orbit_energy",
    "circular_orbit_angular_momentum",
    "circular_orbit_omega",
    "page_thorne_flux",
    "disk_temperature",
    "generate_temperature_lut",
    "temperature_profile",
    "gravitational_factor",
    "doppler_factor",
    "kerr_g_factor",
    "combined_redshift",
    "intensity_scaling",
    "bardeen_shadow",
    "schwarzschild_shadow_radius",
    "shadow_critical_params",
    "magnification",
    "magnification_point_lens",
    "einstein_angle",
    "planck_law",
    "integrate_planck_xyz",
    "xyz_to_linear_rgb",
    "blackbody_rgb",
    "generate_blackbody_lut",
    "hawking_temperature",
]
