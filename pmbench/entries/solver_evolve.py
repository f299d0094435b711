"""The solver_evolve entry: the Solver API's time stepping, as a library
user runs it, in a closed loop.

Its only input is drawn from --seed: a Gaussian white-noise field of the
configuration's nc^3 cells, drawn on the device with a torch Generator
and transformed with the unitary r2c, so that every mode has unit
variance. The program and the reference are given the same field; the
program reaches it where it would draw its own white noise
(fastpm_torch.ic.gaussian_white_noise, replaced for the set-up only).

Set-up runs the program's initial conditions once (cli.prepare_deltak,
and cli.prepare_ncdm where the configuration has massive neutrinos) and
keeps delta_k and the neutrino rows as they were made. Each pass then
builds a Solver, runs setup_lpt on delta_k, puts the neutrino rows back,
and runs Solver.evolve over the configuration's time steps. A pass
counts its rows of every species times its force actions as
`particle_steps`.

The comparison (pmbench/compare.py): every species' rows at the end of
the last pass against pmbench/reference/fastpm.py run from the same
white noise, matched by id. The control is that reference with its
meshes in bfloat16.
"""

from __future__ import annotations

import math
import time
import weakref
from contextlib import contextmanager

import torch
from torch.profiler import record_function

from fastpm_torch import cli, ic
from fastpm_torch.config.params import Params
from fastpm_torch.diagnostics import Log
from fastpm_torch.solver import Solver, NCDM, CDM

from pmbench import compare
from pmbench.reference import fastpm as reference

__all__ = ["COMPARED", "Mix", "control", "white_noise"]

COMPARED = compare.NAMES


def white_noise(seed: int, nc: int, device) -> torch.Tensor:
    """Unit-variance Hermitian white noise (nc, nc, nc // 2 + 1),
    complex64, from seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    g = torch.randn((nc, nc, nc), generator=gen, device=device,
                    dtype=torch.float32)
    return (torch.fft.rfftn(g) / math.sqrt(float(nc) ** 3)).to(
        torch.complex64)


@contextmanager
def _given_noise(wn):
    """The program's white noise replaced by wn while the body runs."""
    draw = ic.gaussian_white_noise

    def given(pm, seed, scheme="gadget"):
        if tuple(pm.Nmesh) != (wn.shape[0],) * 3:
            raise ValueError(f"white noise {tuple(wn.shape)} does not fit "
                             f"{pm}")
        return wn.clone()

    ic.gaussian_white_noise = given
    try:
        yield
    finally:
        ic.gaussian_white_noise = draw


def _clone(store):
    return store.replace(**{c: t.clone() for c, t in store.columns()})


def _traced_force(solver):
    """Solver.do_force inside the benchmark's `pmbench.force` region. The
    wrapper holds the solver weakly: a bound method kept on the instance
    would make a cycle, and a solver in a cycle outlives its pass until
    the collector runs, beside the next pass's."""
    ref = weakref.ref(solver)
    body = type(solver).do_force

    def do_force(*args):
        with record_function("pmbench.force"):
            return body(ref(), *args)
    return do_force


class Mix:
    """Set-up in the constructor, a pass in run_pass()."""

    def __init__(self, params: Params, ref_params: dict, seed: int, device,
                 traced: bool = False, traffic: dict = None):
        self.p = params
        self.ref_params = ref_params
        self.device = torch.device(device)
        self.traced = traced
        self.phases = {}
        t = time.perf_counter()
        self.wn = white_noise(seed, int(params.nc), self.device)
        self._sync()
        self.phases["noise_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.cfg = cli.build_config(params)
        self.cosmology = cli.build_cosmology(params)
        self.a0 = float(params.time_step[0])
        log = Log(echo=False)
        solver = Solver(self.cfg, self.cosmology, device=self.device)
        self.phases["solver_s"] = time.perf_counter() - t
        t = time.perf_counter()
        with _given_noise(self.wn):
            self.dk, _ = cli.prepare_deltak(solver, params, log)
            self._sync()
            self.phases["deltak_s"] = time.perf_counter() - t
            t = time.perf_counter()
            cli.prepare_ncdm(solver, params, self.a0, log)
        self.ncdm = (_clone(solver.peek(NCDM))
                     if NCDM in solver.iter_species() else None)
        del solver
        self._sync()
        self.phases["ncdm_s"] = time.perf_counter() - t
        mesh = int(round(self.cfg.nc * self.cfg.vpm_table[0][1]))
        rows = {CDM: int(self.cfg.nc) ** 3}
        if self.ncdm is not None:
            rows[NCDM] = int(self.ncdm.np_local)
        self._shapes = dict(rows=rows, mass_column={CDM: False, NCDM: True},
                            mesh=(mesh,) * 3,
                            steps=len(self.cfg.time_step) - 1)
        self.last = None
        self.out = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _solver(self):
        s = Solver(self.cfg, self.cosmology, device=self.device)
        if self.traced:
            s.do_force = _traced_force(s)
        return s

    def run_pass(self) -> dict:
        """One pass; keeps its solver until the next pass or drop().
        Returns the pass's work."""
        self.last = None
        s = self._solver()
        with record_function("pmbench.setup_lpt"):
            s.setup_lpt(self.dk, self.a0)
            if self.ncdm is not None:
                s.add_species(NCDM, _clone(self.ncdm))
        with record_function("pmbench.evolve"):
            s.evolve(self.cfg.time_step)
        rows = sum(s.peek(n).np_local for n in s.iter_species())
        self.last = s
        return dict(particle_steps=rows * sum(s.force_paths.values()))

    def drop(self):
        self.last = None

    def finish(self):
        """Keep the last pass's rows of every species by id, and free the
        program's state."""
        out = {}
        for name in self.last.iter_species():
            st = self.last.peek(name)
            order = torch.argsort(st.id)
            out[name] = (st.id[order], st.x[order], st.v[order])
        self.last = self.dk = self.ncdm = None
        self.out = out

    def compare(self) -> dict:
        """The compared numbers of the kept rows against the reference."""
        ref = reference.simulate(self.ref_params, self.wn)
        values = compare.gaps(self.out, ref, self.ref_params)
        self.out = None
        return values

    def shapes(self) -> dict:
        """What the per-layer readers need to count a force's work."""
        return self._shapes


def control(ref_params: dict, seed: int, device) -> dict:
    """The control's compared numbers: the reference with its meshes in
    bfloat16 against the float32 reference, from seed's white noise."""
    wn = white_noise(seed, int(ref_params["nc"]), torch.device(device))
    ref = reference.simulate(ref_params, wn)
    low = reference.simulate(ref_params, wn, mesh_dtype=torch.bfloat16)
    return compare.gaps(low, ref, ref_params)
