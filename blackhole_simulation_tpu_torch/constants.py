"""Physical constants the port needs (CODATA 2018, SI).

The port's own copy of the values in ``blackhole_simulation_tpu.constants``:
the port imports nothing of the JAX package.
"""

C_SI = 299_792_458.0                 # speed of light, m/s
G_SI = 6.674_30e-11                  # gravitational constant, m^3 kg^-1 s^-2
K_B = 1.380_649e-23                  # Boltzmann, J/K
H_PLANCK = 6.626_070_15e-34          # Planck, J s
HBAR = 1.054_571_817e-34             # reduced Planck, J s
M_SUN = 1.988_47e30                  # solar mass, kg
