-- FastPM's tests/standard.lua (github.com/fastpm/fastpm) at the scale
-- one H100 holds: nc = 512 on a 1536 Mpc/h box keeps the source's
-- 3 Mpc/h particle spacing (128^3 in 384 Mpc/h); the other keys are as
-- the repository's copy, tests/fixtures/standard.lua, has them. The
-- snapshots are not written; OUTDIR is replaced by the run's output
-- directory where an entry writes files.
nc = 512
boxsize = 1536.0
time_step = linspace(0.1, 1, 10)
output_redshifts = {1.0, 0.0}
Omega_m = 0.307494
h = 0.6774
pm_nc_factor = 2
force_mode = "fastpm"
growth_mode = "LCDM"
np_alloc_factor = 2.0
read_powerspectrum = "powerspec.txt"
random_seed = 100
write_powerspectrum = "OUTDIR/powerspec"
write_fof = "OUTDIR/fof"
fof_linkinglength = 0.2
fof_nmin = 20
