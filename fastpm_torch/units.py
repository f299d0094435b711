"""Physical constants and unit conventions.

The framework works in FastPM's internal unit system (see the reference
implementation libfastpm/cosmology.c:12-19 for the constant values):

- length: comoving Mpc/h
- velocity (internal): a**2 dx/dt / H0, in Mpc/h
- velocity (snapshots): peculiar km/s (multiply internal by 100/a)
- mass: 1e10 Msun/h
- density: critical density today is RHO_CRIT = 27.7455 (1e10 Msun/h)/(Mpc/h)^3
"""

# Stefan-Boltzmann radiation constant in h * (1e10 Msun/h) * s^-3 * K^-4
STEF_BOLT = 2.85087e-48
# critical density today, (1e10 Msun/h) / (Mpc/h)^3
RHO_CRIT = 27.7455
# speed of light in h * (Mpc/h) * s^-1
LIGHT = 9.715614e-15
# Boltzmann constant in eV/K
K_BOLTZ = 8.617333262145e-5

# Hubble distance c/H0 in Mpc/h
HUBBLE_DISTANCE = 2997.92458
# Hubble constant in (km/s) / (Mpc/h)
HUBBLE_CONSTANT = 100.0
