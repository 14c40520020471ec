"""Physical constants: geometric units (G = c = 1) and SI values (CODATA
2018), with the solar-mass conversions.

The port's own copy of ``blackhole_simulation_tpu.constants``: the port
imports nothing of the JAX package.
"""

# Geometric units: G = c = 1. Masses, lengths and times are in units of M.
G_GEOM = 1.0
C_GEOM = 1.0

# SI constants (CODATA 2018)
C_SI = 299_792_458.0                 # speed of light, m/s
G_SI = 6.674_30e-11                  # gravitational constant, m^3 kg^-1 s^-2
SIGMA_SB = 5.670_374_419e-8          # Stefan-Boltzmann, W m^-2 K^-4
K_B = 1.380_649e-23                  # Boltzmann, J/K
H_PLANCK = 6.626_070_15e-34          # Planck, J s
HBAR = 1.054_571_817e-34             # reduced Planck, J s
M_SUN = 1.988_47e30                  # solar mass, kg
PLANCK_LENGTH = 1.616_255e-35        # m
WIEN_B = 2.897_771_955e-3            # Wien displacement, m K


def geometric_mass_m(mass_kg: float) -> float:
    """Mass in kg -> geometric length GM/c^2 in metres."""
    return G_SI * mass_kg / (C_SI * C_SI)


def solar_mass_m(n_suns: float) -> float:
    """Mass in solar masses -> geometric length GM/c^2 in metres."""
    return geometric_mass_m(n_suns * M_SUN)
