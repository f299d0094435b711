"""fNL-local and constrained initial conditions through the port against
the JAX package.

- PNGaussian.induce_correlation at 32^3 from one white noise: delta_k
  within a relative max |difference| of 1e-5 (the float32 mean of the
  squared potential is summed in another order: a relative 1e-7).
- apply_constraints at 32^3 with two peaks: delta_k within 1e-5, and
  the log lines (the measured sigma, each constraint's overdensity and
  peak-sigma after it) equal to 5 significant digits.
- cli.prepare_deltak with f_nl_type = "local" and with constraints
  through both CLIs at 32^3: the same log lines, delta_k within 1e-5.
"""

import os
import re

import numpy as np
import pytest
import torch

from fastpm_torch.convert import field_from_numpy
from fastpm_torch.mesh import PM
from fastpm_torch.powerspectrum import FuncK

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
POWERSPEC = os.path.join(FIXTURES, "powerspec.txt")
NM, BOX = 32, 128.0
PEAKS = [[64.0, 64.0, 64.0, 3.0], [20.0, 100.0, 40.0, -2.0]]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _white_noise():
    from fastpm_tpu.mesh import PM as JPM
    from fastpm_tpu import ic as jic
    jpm = JPM(NM, BOX)
    return jpm, jic.gaussian_white_noise(jpm, seed=9)


def _png(pkg):
    mod = __import__(pkg + ".png", fromlist=["PNGaussian"])
    fk = __import__(pkg + ".powerspectrum", fromlist=["FuncK"]).FuncK
    return mod.PNGaussian(fNL=100.0, kmax_primordial=NM / 2 * 2 * np.pi
                          / BOX * 0.666, pk=fk.from_file(POWERSPEC),
                          h=0.6774, scalar_amp=2.1e-9, scalar_pivot=0.05,
                          scalar_spectral_index=0.9667)


def test_induce_correlation_matches_jax():
    jpm, wn = _white_noise()
    want = np.asarray(_png("fastpm_tpu").induce_correlation(jpm, wn))
    got = _png("fastpm_torch").induce_correlation(
        PM(NM, BOX), field_from_numpy(np.asarray(wn), "cpu"))
    assert got.dtype == torch.complex64
    assert _rel(got.numpy(), want) <= 1e-5


class _Log:
    def __init__(self):
        self.lines = []

    def info(self, fmt, *args):
        self.lines.append(fmt % args)


def _numbers(lines):
    return [float("%.5g" % float(v)) for line in lines
            for v in re.findall(r"[-+]?\d+\.?\d*(?:e[-+]?\d+)?", line)]


def test_apply_constraints_matches_jax():
    from fastpm_tpu import ic as jic
    from fastpm_tpu.constrained import apply_constraints as japply
    from fastpm_tpu.powerspectrum import FuncK as JFuncK
    from fastpm_torch.constrained import apply_constraints
    jpm, wn = _white_noise()
    dk = jic.induce_correlation(jpm, wn, JFuncK.from_file(POWERSPEC))
    jlog, log = _Log(), _Log()
    want = np.asarray(japply(jpm, dk, PEAKS, JFuncK.from_file(POWERSPEC),
                             jlog))
    got = apply_constraints(PM(NM, BOX), field_from_numpy(np.asarray(dk),
                                                          "cpu"),
                            PEAKS, FuncK.from_file(POWERSPEC), log)
    assert _rel(got.numpy(), want) <= 1e-5
    assert len(log.lines) == len(jlog.lines) == 3
    assert _numbers(log.lines) == _numbers(jlog.lines)


LUA = """
nc = %(nc)d
boxsize = %(box)r
time_step = {0.1, 1.0}
Omega_m = 0.307494
h = 0.6774
read_powerspectrum = "%(ps)s"
random_seed = 42
pm_nc_factor = 1
np_alloc_factor = 2.0
"""
EXTRA = {
    "png": ('f_nl_type = "local"\nf_nl = 100.0\nscalar_amp = 2.1e-9\n'
            "scalar_pivot = 0.05\nscalar_spectral_index = 0.9667\n"),
    "constraints": "constraints = {{64.0, 64.0, 64.0, 3.0}, "
                   "{20.0, 100.0, 40.0, -2.0}}\n",
}


@pytest.mark.parametrize("case", list(EXTRA))
def test_prepare_deltak_matches_jax(case):
    from fastpm_tpu import cli as jcli
    from fastpm_tpu.config.params import load_params_from_string as jload
    from fastpm_tpu.solver import Solver as JSolver
    from fastpm_torch import cli
    from fastpm_torch.config.params import load_params_from_string
    from fastpm_torch.solver import Solver
    text = LUA % dict(nc=NM, box=BOX, ps=POWERSPEC) + EXTRA[case]
    jp, p = jload(text), load_params_from_string(text)
    cli.check_served(p)
    jlog, log = _Log(), _Log()
    js = JSolver(jcli.build_config(jp), jcli.build_cosmology(jp))
    want, _ = jcli.prepare_deltak(js, jp, jlog)
    s = Solver(cli.build_config(p), cli.build_cosmology(p), device="cpu")
    got, _ = cli.prepare_deltak(s, p, log)
    assert _rel(got.numpy(), np.asarray(want)) <= 1e-5
    # the same lines, their numbers to 5 significant digits
    assert [re.sub(r"[-+]?\d[\d.e+-]*", "#", l) for l in log.lines] == [
        re.sub(r"[-+]?\d[\d.e+-]*", "#", l) for l in jlog.lines]
    assert _numbers(log.lines) == _numbers(jlog.lines)
    key = ("Inducing non gaussian" if case == "png"
           else "After constraints")
    assert any(l.startswith(key) for l in log.lines)
