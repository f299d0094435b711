-- FastPM's tests/ncdm.lua (github.com/fastpm/fastpm): three massive
-- neutrinos as particles, the physics keys as the repository's copy,
-- tests/fixtures/ncdm.lua, has them, at the scale one H100 holds:
-- nc = 512 on a 1536 Mpc/h box, the 3 Mpc/h spacing of upstream's
-- tests/standard.lua. The snapshot is not written; OUTDIR is replaced
-- by the run's output directory where an entry writes files.
nc = 512
boxsize = 1536.0

n_steps_log = 2
n_steps_lin = 3
z_i = 99
z_m = 19
a_i = 1. / (1. + z_i)
a_m = 1. / (1. + z_m)
a_f = 1
time_step = loglinspace(a_i, a_m, a_f, n_steps_log, n_steps_lin)

output_redshifts = {0}

Omega_m = 0.3175
h       = 0.6711
T_cmb   = 2.7255
N_eff   = 3.046
N_nu    = 3
m_ncdm  = {0.12, 0.06, 0.02}
n_shell = 4
ncdm_sphere_scheme = "fibonacci"
n_side  = 2
every_ncdm = 4
lvk = true
ncdm_freestreaming = false
ncdm_matterlike = false

read_powerspectrum = "Pcb.txt"
read_powerspectrum_ncdm = "Pncdm.txt"
read_linear_growth_rate = "fcb.txt"
read_linear_growth_rate_ncdm = "fncdm.txt"
linear_density_redshift = z_i
linear_density_redshift_ncdm = z_i

random_seed = 100
particle_fraction = 1.0

force_mode = "fastpm"
growth_mode = "ODE"
pm_nc_factor = 2
np_alloc_factor = 4.0

write_powerspectrum = "OUTDIR/powerspec"
