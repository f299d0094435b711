"""The port's CLI against the JAX package's on one small Lua file: the
nbodykit.lua physics at nc=32 (the same 3 Mpc/h mean separation), run
through fastpm_torch.cli.main on the CPU and through
fastpm_tpu.cli.run_fastpm. The JAX package's bigfile reader opens the
port's files; positions and velocities agree by id (the solver test's
bounds), the power spectrum rows agree, and the FOF catalogs have equal
Length arrays."""

import os

import numpy as np
import pytest

from fastpm_tpu.io.bigfile import BigFile

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
NC, BOX = 32, 96.0

LUA = """
nc = %(nc)d
boxsize = %(box)r
time_step = linspace(0.1, 1, 3)
output_redshifts = {0.0, 0.5}
Omega_m = 0.307494
h       = 0.6774
read_powerspectrum = "%(ps)s"
linear_density_redshift = 0.0
random_seed = 100
force_mode = "fastpm"
kernel_type = "1_4"
growth_mode = "LCDM"
pm_nc_factor = 2
lpt_nc_factor = 1
np_alloc_factor = 4.0
write_snapshot = "%(out)s/fastpm"
write_powerspectrum = "%(out)s/powerspec"
write_fof = "%(out)s/fastpm"
"""


def _write_lua(tmp_path, out):
    conf = tmp_path / ("%s.lua" % os.path.basename(out))
    conf.write_text(LUA % dict(nc=NC, box=BOX, out=out,
                               ps=os.path.join(FIXTURES, "powerspec.txt")))
    return str(conf)


def _particles(path):
    bf = BigFile(path)
    ids = bf.open_block("1/ID").read_all().reshape(-1)
    o = np.argsort(ids)
    return (ids[o], bf.open_block("1/Position").read_all().reshape(-1, 3)[o],
            bf.open_block("1/Velocity").read_all().reshape(-1, 3)[o])


def _powerspec(path):
    return np.loadtxt(path, comments="#")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    out_jax, out_torch = str(tmp / "jax"), str(tmp / "torch")

    from fastpm_tpu.config.params import load_params
    from fastpm_tpu.cli import run_fastpm
    from fastpm_tpu.diagnostics import Log
    run_fastpm(load_params(_write_lua(tmp, out_jax)), Log(echo=False))

    from fastpm_torch import cli
    assert cli.main([_write_lua(tmp, out_torch)], device="cpu") == 0
    return out_jax, out_torch


@pytest.mark.parametrize("a", ["0.6667", "1.0000"])
def test_snapshots_agree_by_id(runs, a):
    out_jax, out_torch = runs
    jid, jx, jv = _particles(os.path.join(out_jax, "fastpm_" + a))
    tid, tx, tv = _particles(os.path.join(out_torch, "fastpm_" + a))
    np.testing.assert_array_equal(tid, np.arange(NC ** 3))
    np.testing.assert_array_equal(tid, jid)
    dx = tx - jx
    dx -= np.round(dx / BOX) * BOX
    assert np.abs(dx).max() < 1e-4 * BOX / NC
    assert np.abs(tv - jv).max() < 1e-4 * jv.std()
    hdr = BigFile(os.path.join(out_torch, "fastpm_" + a)).open_block(
        "Header").attrs.asdict()
    assert float(np.ravel(hdr["ScalingFactor"])[0]) == pytest.approx(
        float(a), abs=1e-4)


def test_powerspectrum_rows_agree(runs):
    out_jax, out_torch = runs
    names = sorted(f for f in os.listdir(out_jax)
                   if f.startswith("powerspec_"))
    assert len(names) == 3
    assert names == sorted(f for f in os.listdir(out_torch)
                           if f.startswith("powerspec_"))
    for name in names:
        want = _powerspec(os.path.join(out_jax, name))
        got = _powerspec(os.path.join(out_torch, name))
        np.testing.assert_array_equal(got[:, 2], want[:, 2])   # Nmodes
        # %g text (6 digits) of float32-binned vs float64-binned sums
        np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=2e-5)


@pytest.mark.parametrize("a", ["0.6667", "1.0000"])
def test_fof_lengths_equal(runs, a):
    out_jax, out_torch = runs
    lengths = [BigFile(os.path.join(out, "fastpm_" + a)).open_block(
        "LL-0.200/Length").read_all() for out in runs]
    assert len(lengths[0]) > 0
    np.testing.assert_array_equal(lengths[1], lengths[0])


# the Lua schema's force modes are fastpm, pm, cola and zola, as the
# reference's (lua-runtime-fastpm.lua); za and 2lpt are SolverConfig
# modes, and za = true drops dx2
SERVED = ('force_mode = "cola"', 'force_mode = "zola"\nza = true',
          "pgdc = true", 'f_nl_type = "local"\nf_nl = 10.0\n'
          "scalar_amp = 2.1e-9\nscalar_pivot = 0.05\n"
          "scalar_spectral_index = 0.96",
          "constraints = {{48.0, 48.0, 48.0, 3.0}}",
          "m_ncdm = {0.2}\nn_shell = 0\nncdm_freestreaming = true\n"
          "ncdm_linearresponse = true")


@pytest.mark.parametrize("extra", SERVED)
def test_newly_served_parameters(tmp_path, extra):
    """Every force mode, PGD, fNL, constraints and the linear response
    pass check_served, whatever the number of ranks (PGD and the linear
    response run on ranks in tests/test_torch_ranks_physics.py), and a
    run of each can restart."""
    from fastpm_torch import cli
    from fastpm_torch.config.params import load_params
    conf = tmp_path / "p.lua"
    conf.write_text(LUA % dict(nc=NC, box=BOX, out=str(tmp_path),
                               ps=os.path.join(FIXTURES, "powerspec.txt"))
                    + extra + "\n")
    p = load_params(str(conf))
    cli.check_served(p)
    cli._check_restart(p)
