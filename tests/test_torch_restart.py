"""Restart from a snapshot (-r) through the port: tests/test_restart.py's
equivalence at 16^3, and the refusals the JAX package keeps.

- _prepare_time_step truncates as the JAX function.
- A run stopped at a = 0.6 and restarted from its snapshot ends as the
  straight run, by id (x atol 2e-3, v atol 2e-1: the km/s <-> internal
  velocity round trip in float32), does not rewrite the a = 0.6
  snapshot, and restores int64 ids; through cli.main with -r as well.
- A restart with particle_fraction < 1 or with the lightcone stops
  with SystemExit; on several ranks (tests/test_torch_ranks_physics.py
  restarts on 2) a rank keeps the rows of its own lattice sites, and a
  snapshot without every id once stops it.
"""

import os

import numpy as np
import pytest

from fastpm_torch.cli import _prepare_time_step, main, run_fastpm, check_served
from fastpm_torch.config.params import load_params_from_string
from fastpm_torch.diagnostics import Log

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")

# tests/test_restart.py's BASE: aout = 0.6 is a time step
BASE = """
nc = 16
boxsize = 64.0
time_step = linspace(0.2, 1, 5)
aout = {0.6, 1.0}
Omega_m = 0.307494
h = 0.6774
read_powerspectrum = "%(ps)s"
random_seed = 100
force_mode = "%(mode)s"
growth_mode = "LCDM"
pm_nc_factor = 1
np_alloc_factor = 2.0
write_snapshot = "%(out)s/fastpm"
"""


def _text(out, mode="fastpm"):
    return BASE % dict(out=out, mode=mode,
                       ps=os.path.join(FIXTURES, "powerspec.txt"))


def test_prepare_time_step():
    from fastpm_tpu.cli import _prepare_time_step as jprep
    ts = [0.1, 0.4, 0.7, 1.0]
    assert _prepare_time_step(ts, 0.4) == [0.4, 0.7, 1.0]
    assert _prepare_time_step(ts, 0.5) == [0.5, 0.7, 1.0]
    assert _prepare_time_step(ts, 0.1) == [0.1, 0.4, 0.7, 1.0]
    for a0 in (0.1, 0.25, 0.4, 0.4 + 5e-8, 0.99, 1.0):
        assert _prepare_time_step(ts, a0) == jprep(ts, a0)


def _read(path):
    from fastpm_torch.io.snapshots import read_species
    d = read_species(path)
    assert d["id"].dtype == np.int64
    return d["id"], d["x"], d["v"]


@pytest.mark.parametrize("mode", ["fastpm", "cola"])
def test_restart_equivalence(tmp_path, mode):
    out1, out2 = str(tmp_path / "straight"), str(tmp_path / "restarted")
    run_fastpm(load_params_from_string(_text(out1, mode)), Log(echo=False),
               device="cpu")
    conf = tmp_path / "restart.lua"
    conf.write_text(_text(out2, mode))
    assert main(["-r", os.path.join(out1, "fastpm_0.6000"), str(conf)],
                device="cpu") == 0
    a, b = (_read(os.path.join(o, "fastpm_1.0000")) for o in (out1, out2))
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_allclose(a[1], b[1], atol=2e-3)
    np.testing.assert_allclose(a[2], b[2], atol=2e-1)
    assert not os.path.exists(os.path.join(out2, "fastpm_0.6000"))


def test_restart_refusals(tmp_path):
    snap = str(tmp_path / "snapshot")
    for extra, match in (("particle_fraction = 0.5\n", "subsampling"),
                         ('lc_write_usmesh = "lc"\n', "lightcone")):
        p = load_params_from_string(_text(str(tmp_path), "fastpm") + extra)
        with pytest.raises(SystemExit, match=match):
            run_fastpm(p, Log(echo=False), device="cpu", restart=snap)
    # restart is served on ranks too (tests/test_torch_ranks_physics.py
    # restarts on 2): only subsampling and the lightcone stop it
    from fastpm_torch import cli
    cli._check_restart(load_params_from_string(
        _text(str(tmp_path), "fastpm")))
    check_served(load_params_from_string(_text(str(tmp_path), "cola")))


def test_lattice_rows_need_every_id():
    """The rows a rank keeps of a file are those at its lattice rows'
    ids; a file missing an id (a subsampled snapshot) or holding one
    twice stops the run, as read_runpbic on ranks does."""
    import torch
    from fastpm_torch import cli
    from fastpm_torch.solver import Solver, SolverConfig
    s = Solver(SolverConfig(nc=4, boxsize=16.0), device="cpu")
    # this rank's lattice rows: every other site, in reverse
    s.species["cdm"] = s.species["cdm"].replace(
        id=torch.arange(62, -1, -2, dtype=torch.int64))
    ids = np.random.RandomState(3).permutation(64)
    keep = cli._lattice_rows(s, ids, "restart")
    np.testing.assert_array_equal(ids[keep], np.arange(62, -1, -2))
    for bad in (ids[1:], np.concatenate([ids[:-1], ids[:1]])):
        with pytest.raises(SystemExit, match="restart on several ranks"):
            cli._lattice_rows(s, bad, "restart")
