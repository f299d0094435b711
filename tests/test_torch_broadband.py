"""The main path's broadband goldens through the port: the LCDM and ODE
series of tests/test_solver.py (the reference's
tests/run-test-lightcone.check and run-test-lightcone-ODE.check). 64^3
particles on a 64^3 force mesh, 8 steps from a = 0.1,
tests/fixtures/powerspec.txt, seed 100 with the cosmic variance
removed; every per-step broadband line of the log must match the
reference's at its printed precision, and the ODE run's white-noise
variance must print as 0.99999619.

On the CPU the force runs the plain versions of K1 and K2. chip_smoke.py
runs the same two series on the card, through K1 and K2, from
run_series and GOLDENS below.
"""

import os

import numpy as np
import pytest

from fastpm_torch import events, ic
from fastpm_torch.cosmology import Cosmology
from fastpm_torch.diagnostics import Log, attach_standard_handlers
from fastpm_torch.powerspectrum import FuncK
from fastpm_torch.solver import Solver, SolverConfig

POWERSPEC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "fixtures", "powerspec.txt")

# "17110 " keeps its trailing space: %g printed 17110, not 17110.x
GOLDENS = {
    "lcdm": [
        "D^2(0.1, 1.0) P(k<0.0490625) = 17305.5",
        "D^2(0.228571, 1.0) P(k<0.0490625) = 17200.9",
        "D^2(0.357143, 1.0) P(k<0.0490625) = 17110 ",
        "D^2(0.485714, 1.0) P(k<0.0490625) = 17064.7",
        "D^2(0.614286, 1.0) P(k<0.0490625) = 17043.4",
        "D^2(0.742857, 1.0) P(k<0.0490625) = 17028.1",
        "D^2(0.871429, 1.0) P(k<0.0490625) = 17014.2",
        "D^2(1, 1.0) P(k<0.0490625) = 17002.2",
    ],
    "ode": [
        "D^2(0.1, 1.0) P(k<0.0490625) = 17305.5",
        "D^2(0.228571, 1.0) P(k<0.0490625) = 17201.1",
        "D^2(0.357143, 1.0) P(k<0.0490625) = 17110.2",
        "D^2(0.485714, 1.0) P(k<0.0490625) = 17064.9",
        "D^2(0.614286, 1.0) P(k<0.0490625) = 17043.7",
        "D^2(0.742857, 1.0) P(k<0.0490625) = 17028.4",
        "D^2(0.871429, 1.0) P(k<0.0490625) = 17014.5",
        "D^2(1, 1.0) P(k<0.0490625) = 17002.5",
    ],
}
ODE_VARIANCE = "0.99999619"


def run_series(growth_mode, device, on_force=None):
    """Run one series on `device`; returns (the Log, the white-noise
    variance). on_force(event), when given, is called after each force
    step, after the standard handlers."""
    cosmo = Cosmology(h=0.6774, Omega_m=0.307494, T_cmb=0.0,
                      growth_mode=growth_mode)
    cfg = SolverConfig(nc=64, boxsize=512.0,
                       time_step=list(np.linspace(0.1, 1, 8)),
                       force_mode="fastpm", pm_nc_factor=1,
                       lpt_nc_factor=1)
    s = Solver(cfg, cosmo, device=device)
    log = attach_standard_handlers(s, Log(echo=False))
    if on_force is not None:
        s.event_handlers.on(events.EVENT_FORCE, events.STAGE_AFTER,
                            on_force)
    dk, var = ic.linear_field(s.lptpm, cosmo, FuncK.from_file(POWERSPEC),
                              seed=100, aout=1.0,
                              remove_cosmic_variance=True)
    s.setup_lpt(dk, cfg.time_step[0])
    s.evolve()
    return log, var


@pytest.mark.parametrize("growth_mode", ["lcdm", "ode"])
def test_broadband_goldens(growth_mode):
    log, var = run_series(growth_mode, "cpu")
    if growth_mode == "ode":
        assert "%.8f" % var == ODE_VARIANCE
    for line in GOLDENS[growth_mode]:
        assert log.contains(line), line
