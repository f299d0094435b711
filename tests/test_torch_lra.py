"""The neutrino linear response through the port against the JAX package.

- special_J and fslength equal to the JAX functions (the port's
  neutrinos_lra.py is a copy); a sequence of update_from_power calls on
  one DeltaTotTable of each package gives equal prefactors, ratios and
  histories.
- transfers.apply_fk_interp against the JAX function on a 32^3 mesh,
  with a table that ends inside the mesh's |k| range at both ends (the
  clamps) and the DC mode kept (rtol 1e-6), and the cached bins reused
  for a second table on the same k; named by logk's host bytes too.
- A Solver with ncdm_linearresponse but no setup_linear_response stops
  at its first force.
- tests/test_lra.py's LRA_RUN (16^3, 5 steps, m_ncdm 0.2, z_transfer 4)
  through both CLIs (module scope): the snapshots at a = 0.6 and 1 by id
  (positions within 1e-4 of a cell, velocities within 1e-4 of their
  rms), their Neutrino blocks (scalefact equal, Deltas and DeltaNuInit
  within rtol 1e-5, kvalue equal).
- The port's restart from its own a = 0.6 snapshot and from the JAX
  package's: the history resumed (not re-seeded), and the final
  snapshot equal by id to the straight run at tests/test_lra.py's
  tolerances (x atol 2e-3, v atol 2e-1, the history rtol 0.03).
"""

import math
import os

import numpy as np
import pytest
import torch

from fastpm_torch.cosmology import Cosmology
from fastpm_torch.neutrinos_lra import DeltaTotTable, special_J, fslength

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
COSMO = dict(h=0.6774, Omega_m=0.307494, T_cmb=2.725, N_eff=3.046, N_nu=3,
             m_ncdm=(0.3,), ncdm_matterlike=False, ncdm_freestreaming=True,
             ncdm_linearresponse=True, growth_mode="ode")


def test_special_j_and_fslength_match_jax():
    from fastpm_tpu.cosmology import Cosmology as JCosmology
    from fastpm_tpu.neutrinos_lra import (special_J as jJ,
                                          fslength as jfsl)
    x = np.linspace(-1, 60, 301)
    np.testing.assert_array_equal(special_J(x), jJ(x))
    c, jc = Cosmology(**COSMO), JCosmology(**COSMO)
    for la1, la2 in ((math.log(0.05), math.log(0.2)),
                     (math.log(0.2), math.log(1.0)), (0.0, -1.0)):
        assert fslength(c, la1, la2) == jfsl(jc, la1, la2)


def test_update_from_power_matches_jax():
    from fastpm_tpu.cosmology import Cosmology as JCosmology
    from fastpm_tpu.neutrinos_lra import DeltaTotTable as JTable
    k = np.logspace(-2, 1, 32)
    delta = 1.0 / (1 + (k / 0.1) ** 1.5)
    tab = DeltaTotTable(cosmology=Cosmology(**COSMO), time_transfer=0.05)
    jtab = JTable(cosmology=JCosmology(**COSMO), time_transfer=0.05)
    # the first call initialises at its own time; steps closer than
    # 0.009 in a are provisional and dropped
    for a in (0.1, 0.2, 0.205, 0.5, 1.0):
        D = a / 0.05
        pre, ratio = tab.update_from_power(k, delta * D, a)
        jpre, jratio = jtab.update_from_power(k, delta * D, a)
        assert pre == jpre
        np.testing.assert_array_equal(ratio, jratio)
    np.testing.assert_array_equal(np.asarray(tab.scalefact),
                                  np.asarray(jtab.scalefact))
    np.testing.assert_array_equal(np.asarray(tab.delta_tot),
                                  np.asarray(jtab.delta_tot))


def test_apply_fk_interp_matches_jax():
    import jax.numpy as jnp
    from fastpm_tpu.mesh import PM as JPM
    from fastpm_tpu.transfers import apply_fk_interp as japply
    from fastpm_torch.mesh import PM
    from fastpm_torch.transfers import apply_fk_interp
    nm, box = 32, 64.0
    rng = np.random.RandomState(6)
    dk = (rng.normal(size=(nm, nm, nm // 2 + 1))
          + 1j * rng.normal(size=(nm, nm, nm // 2 + 1))).astype(np.complex64)
    # |k| spans 0.098 ... 2.72 on this mesh: the table starts above the
    # smallest and ends below the largest
    logk = np.log(np.linspace(0.15, 2.0, 12)).astype(np.float32)
    pm = PM(nm, box)
    for seed in (1, 2):
        vals = np.random.RandomState(seed).uniform(-0.3, 0.1, 12).astype(
            np.float32)
        want = np.asarray(japply(JPM(nm, box), jnp.asarray(dk),
                                 jnp.asarray(logk), jnp.asarray(vals)))
        got = apply_fk_interp(pm, torch.from_numpy(dk),
                              torch.from_numpy(logk), torch.from_numpy(vals))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
        # named by the host bytes of logk, as the solver calls it
        keyed = apply_fk_interp(pm, torch.from_numpy(dk),
                                torch.from_numpy(logk),
                                torch.from_numpy(vals), logk.tobytes())
        assert torch.equal(keyed, got)
        # the DC mode keeps its value
        assert got[0, 0, 0] == torch.from_numpy(dk)[0, 0, 0]
        # the clamps were reached at both ends
        fac = (got / torch.from_numpy(dk)).real.numpy()
        assert np.isclose(fac[1, 0, 0], 1 + vals[0])
        assert np.isclose(fac[nm // 2, nm // 2, nm // 2], 1 + vals[-1])


def test_solver_refuses_lra_without_setup():
    """A cosmology with ncdm_linearresponse needs the response's state:
    a Solver whose setup_linear_response was not called stops at its
    first force instead of running without the response."""
    from fastpm_torch.solver import Solver, SolverConfig
    cosmo = Cosmology(h=0.6774, Omega_m=0.307494, ncdm_linearresponse=True)
    s = Solver(SolverConfig(nc=8, boxsize=32.0, time_step=[0.2, 0.3]),
               cosmo, device="cpu")
    s.setup_lpt(torch.zeros(s.lptpm.kshape, dtype=torch.complex64), 0.2)
    with pytest.raises(RuntimeError, match="setup_linear_response"):
        s.evolve()


LRA_RUN = """
nc = 16
boxsize = 64.0
time_step = linspace(0.2, 1, 5)
aout = {0.6, 1.0}
Omega_m = 0.307494
h = 0.6774
T_cmb = 2.725
N_eff = 3.046
N_nu = 3
m_ncdm = {0.2}
n_shell = 0
ncdm_freestreaming = true
ncdm_matterlike = false
ncdm_linearresponse = true
ncdm_transfer_redshift = 4.0
read_powerspectrum = "%(ps)s"
random_seed = 100
force_mode = "fastpm"
growth_mode = "ODE"
pm_nc_factor = 1
np_alloc_factor = 2.0
write_snapshot = "%(out)s/fastpm"
"""


def _params(out, pkg):
    text = LRA_RUN % dict(out=out, ps=os.path.join(FIXTURES,
                                                   "powerspec.txt"))
    if pkg == "jax":
        from fastpm_tpu.config.params import load_params_from_string
    else:
        from fastpm_torch.config.params import load_params_from_string
    return load_params_from_string(text)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The straight run through each CLI, and the port restarted at
    a = 0.6 from each one's snapshot."""
    from fastpm_tpu.cli import run_fastpm as jrun
    from fastpm_tpu.diagnostics import Log as JLog
    from fastpm_torch.cli import run_fastpm
    from fastpm_torch.diagnostics import Log
    tmp = tmp_path_factory.mktemp("lra")
    out = {k: str(tmp / k) for k in ("jax", "torch", "own", "from_jax")}
    jrun(_params(out["jax"], "jax"), JLog(echo=False))
    solvers = {"torch": run_fastpm(_params(out["torch"], "torch"),
                                   Log(echo=False), device="cpu")}
    for name, src in (("own", "torch"), ("from_jax", "jax")):
        log = Log(echo=False)
        solvers[name] = run_fastpm(
            _params(out[name], "torch"), log, device="cpu",
            restart=os.path.join(out[src], "fastpm_0.6000"))
        assert log.contains("Restored neutrino linear-response state "
                            "(3 history entries)")
    return out, solvers


def _read(path):
    from fastpm_torch.io.snapshots import read_species
    d = read_species(path)
    o = np.argsort(d["id"])
    return d["id"][o], d["x"][o], d["v"][o]


@pytest.mark.parametrize("a", ["0.6000", "1.0000"])
def test_lra_run_matches_jax(runs, a):
    from fastpm_torch.io.bigfile import BigFile
    out, _ = runs
    jpath = os.path.join(out["jax"], "fastpm_" + a)
    tpath = os.path.join(out["torch"], "fastpm_" + a)
    jid, jx, jv = _read(jpath)
    tid, tx, tv = _read(tpath)
    np.testing.assert_array_equal(tid, jid)
    dx = tx - jx
    dx -= np.round(dx / 64.0) * 64.0
    assert np.abs(dx).max() < 1e-4 * 64.0 / 16
    assert np.abs(tv - jv).max() < 1e-4 * jv.std()
    jb, tb = BigFile(jpath), BigFile(tpath)
    ja = jb.open_block("Neutrino").attrs.asdict()
    ta = tb.open_block("Neutrino").attrs.asdict()
    assert int(ta["Nscale"]) == int(ja["Nscale"]) == (3 if a == "0.6000"
                                                      else 5)
    np.testing.assert_array_equal(ta["scalefact"], ja["scalefact"])
    np.testing.assert_array_equal(tb.open_block("Neutrino/kvalue").read_all(),
                                  jb.open_block("Neutrino/kvalue").read_all())
    for blk in ("Neutrino/Deltas", "Neutrino/DeltaNuInit"):
        np.testing.assert_allclose(tb.open_block(blk).read_all(),
                                   jb.open_block(blk).read_all(), rtol=1e-5)


@pytest.mark.parametrize("source", ["own", "from_jax"])
def test_lra_restart_equivalence(runs, source):
    out, solvers = runs
    s1, s2 = solvers["torch"], solvers[source]
    assert len(s2.lra.scalefact) == len(s1.lra.scalefact) == 5
    np.testing.assert_allclose(np.asarray(s2.lra.scalefact),
                               np.asarray(s1.lra.scalefact), atol=1e-12)
    np.testing.assert_allclose(np.asarray(s2.lra.delta_tot),
                               np.asarray(s1.lra.delta_tot), rtol=0.03)
    aid, ax, av = _read(os.path.join(out["torch"], "fastpm_1.0000"))
    bid, bx, bv = _read(os.path.join(out[source], "fastpm_1.0000"))
    np.testing.assert_array_equal(aid, bid)
    np.testing.assert_allclose(ax, bx, atol=2e-3)
    np.testing.assert_allclose(av, bv, atol=2e-1)
    # the restart does not rewrite the a = 0.6 snapshot
    assert not os.path.exists(os.path.join(out[source], "fastpm_0.6000"))
