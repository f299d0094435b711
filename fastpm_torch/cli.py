"""The port's command-line driver (reference: src/fastpm.c), run as
`python -m fastpm_torch.cli <file.lua>` on one GPU, or as
`torchrun --nproc-per-node P -m fastpm_torch.cli <file.lua>` on P.

Port of fastpm_tpu/cli.py: Lua parameter file -> IC pipeline -> 2LPT
(CDM, and the Fermi-Dirac split ncdm species when m_ncdm is set) ->
evolution with event handlers for the per-step power spectrum,
interpolated bigfile snapshots and host FOF catalogs. A parameter this
slice does not serve stops the run with SystemExit naming it (see
ROADMAP.md).

Under torchrun (WORLD_SIZE > 1) main starts the process group, as the
JAX CLI builds its device mesh (cli.py:817-846): NCCL with one GPU per
rank (cuda:LOCAL_RANK), or gloo when the caller asks for the CPU. The
ranks split the particles in x-slabs (solver.py); every rank builds the
whole linear field and the 2LPT displacements of its own rows, rank 0
gathers the rows for the snapshots and runs FOF on them, and writes the
files a one-rank run writes.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .config.params import load_params, Params
from .cosmology import Cosmology
from .device import resolve_device
from .solver import Solver, SolverConfig, NCDM
from .store import lattice_store
from .ncdm import NcdmInitData, split_ncdm
from .powerspectrum import FuncK, sigma_tophat
from .diagnostics import attach_standard_handlers, Log
from . import ic, events as ev, transfers
from .io.snapshots import write_snapshot, write_halo_catalog
from .fof import find_halos

__all__ = ["main", "run_fastpm", "build_cosmology", "build_config",
           "prepare_deltak", "prepare_ncdm", "SnapshotChecker"]

# parameters whose feature is a later slice: each must be unset/false
_LATER_PARAMS = (
    "read_lineark", "read_lineark_ncdm", "read_whitenoisek",
    "read_runpbic", "read_grafic", "write_whitenoisek", "write_lineark",
    "write_linearr", "write_runpbic", "write_nonlineark",
    "write_runpb_snapshot", "write_rfof", "lc_write_usmesh",
    "constraints", "ncdm_linearresponse", "pgdc",
    "compute_potential", "compute_tidal")


def check_served(p: Params) -> None:
    """SystemExit naming the first parameter this slice does not serve."""
    bad = [name for name in _LATER_PARAMS if p.get(name, None)]
    if p.f_nl_type != "none":
        bad.append("f_nl_type")
    if p.force_mode == "cola":
        bad.append("force_mode")
    if p.particle_fraction < 1:
        bad.append("particle_fraction")
    if bad:
        raise SystemExit(f"fastpm_torch: parameter {bad[0]!r} is not "
                         "served by this slice of the port (see ROADMAP.md)")


def build_cosmology(p: Params) -> Cosmology:
    return Cosmology(
        h=p.h, Omega_m=p.Omega_m, Omega_k=p.Omega_k, T_cmb=p.T_cmb,
        w0=p.w0, wa=p.wa, N_eff=p.N_eff, N_nu=p.N_nu,
        m_ncdm=tuple(p.m_ncdm or ()),
        ncdm_matterlike=p.ncdm_matterlike,
        ncdm_freestreaming=p.ncdm_freestreaming,
        ncdm_linearresponse=p.ncdm_linearresponse,
        growth_mode=p.growth_mode.lower(),
    )


def build_config(p: Params) -> SolverConfig:
    pmf = p.pm_nc_factor
    if isinstance(pmf, list) and pmf and isinstance(pmf[0], list):
        pm_nc_factor = [(row[0], row[1]) for row in pmf]
    elif isinstance(pmf, list):
        pm_nc_factor = pmf[0]
    else:
        pm_nc_factor = pmf
    return SolverConfig(
        nc=p.nc, boxsize=p.boxsize, time_step=list(p.time_step),
        force_mode=p.force_mode, kernel_type=p.kernel_type,
        softening_type=p.force_softening_type,
        painter_type=p.painter_type, painter_support=p.painter_support,
        pm_nc_factor=pm_nc_factor, lpt_nc_factor=p.lpt_nc_factor,
        use_shift=p.shift, za=p.za,
        # the reference's pm_check_values runs on every CLI run
        # (gravity.c:350-383)
        check_values=True,
    )


def prepare_deltak(solver: Solver, p: Params, log: Log):
    """The IC pipeline (src/fastpm.c:prepare_deltak) from the power
    spectrum file and the gadget white noise: delta_k normalized at z=0
    on the lptpm mesh, and the (sigma8-corrected) input P(k)."""
    pm = solver.lptpm
    c = solver.cosmology
    if not p.read_powerspectrum:
        raise SystemExit("Need a power spectrum to start the simulation.")

    log.info("Powerspecectrum file: %s", p.read_powerspectrum)
    pk = FuncK.from_file(p.read_powerspectrum)
    log.info("Found %d pairs of values in input spectrum table", pk.size)
    sigma8_input = sigma_tophat(pk, 8.0)
    log.info("Input power spectrum sigma8 %f", sigma8_input)
    if p.sigma8 > 0:
        log.info("Expected power spectrum sigma8 %g; correction applied.",
                 p.sigma8)
        pk = FuncK(pk.k, pk.f * (p.sigma8 / sigma8_input) ** 2)

    dk = ic.gaussian_white_noise(pm, p.random_seed)
    if p.remove_cosmic_variance:
        log.info("Remove Cosmic variance from initial condition.")
        dk = ic.remove_variance(dk)
    if p.set_mode:
        method = "add" if p.set_mode_method == "add" else "override"
        log.info("SetMode is %s", method)
        for i, m in enumerate(p.set_mode):
            dk = transfers.set_mode(pm, dk, m[:4], m[4], method)
            got = transfers.get_mode(pm, dk, m[:4])
            log.info("SetMode %d : %d %d %d %d value = %g, to = %g",
                     i, int(m[0]), int(m[1]), int(m[2]), int(m[3]),
                     m[4], got)
    if p.inverted_ic:
        dk = -dk

    variance = pm.compute_variance(dk)
    log.info("Variance of input white noise is %0.8f, expectation is %0.8f",
             variance, 1.0 - 1.0 / pm.Norm)
    log.info("Inducing correlation to the white noise.")
    dk = ic.induce_correlation(pm, dk, pk)
    dk = ic.rescale_linear(pm, dk, c, 1.0, p.linear_density_redshift)
    # set the mean to 1.0 (src/fastpm.c:561-565)
    dk = transfers.set_mode(pm, dk, (0, 0, 0, 0), 1.0, "override")
    return dk, pk


def prepare_ncdm(solver: Solver, p: Params, a0: float, log: Log):
    """Massive-neutrino particle species setup
    (prepare_ncdm, src/fastpm.c:716-847): staggered coarse lattice,
    Fermi-Dirac split, own linear field, own 2LPT."""
    if not p.m_ncdm or p.n_shell == 0:
        return
    every = int(p.every_ncdm)
    nc_ncdm = p.nc // every
    if p.nc % every != 0:
        raise SystemExit("nc must be divisible by every_ncdm")

    z_ref = 1.0 / p.time_step[0] - 1
    log.info("ncdm reference redshift = %g", z_ref)
    nid = NcdmInitData(boxsize=p.boxsize, cosmology=solver.cosmology,
                       z=z_ref, n_shells=int(p.n_shell),
                       n_side=int(p.n_side), lvk=p.lvk,
                       sphere_scheme=p.ncdm_sphere_scheme)

    shift0 = p.boxsize / nc_ncdm * 0.5 if p.shift else 0.0
    sites = lattice_store(solver.lptpm, Nc=nc_ncdm, shift=shift0,
                          columns=("v", "acc", "id"), name="ncdm")
    # stagger wrt the cdm grid by half a cdm cell (src/fastpm.c:785-792)
    stag = float(np.float32(p.boxsize / p.nc * 0.5))
    sites = sites.replace(x=sites.x + stag,
                          q_shift=tuple(s + stag for s in sites.q_shift))

    ncdm = split_ncdm(nid, sites).wrap(p.boxsize)
    log.info("average mass of a ncdm particle is %g",
             float(ncdm.mass.double().mean()) / max(1, len(p.m_ncdm)))
    solver.add_species(NCDM, ncdm)

    # own linear field (fall back to cdm's inputs with a warning)
    if not p.read_powerspectrum_ncdm:
        log.info("WARNING: No ncdm powerspectrum input; using cdm's "
                 "instead.")
        dk, _ = prepare_deltak(solver, p, log)
    else:
        ns = dict(p.asdict())
        ns["read_powerspectrum"] = p.read_powerspectrum_ncdm
        ns["linear_density_redshift"] = p.linear_density_redshift_ncdm
        dk, _ = prepare_deltak(
            solver, Params(ns, source=p.source, filename=p.filename), log)

    growth_rate_func_k = None
    if p.read_linear_growth_rate_ncdm:
        growth_rate_func_k = FuncK.from_file(p.read_linear_growth_rate_ncdm)
        log.info("Reading ncdm linear growth rate from file: %s",
                 p.read_linear_growth_rate_ncdm)
    solver.setup_lpt(dk, a0, species=NCDM,
                     growth_rate_func_k=growth_rate_func_k)


class SnapshotChecker:
    """Interpolation-event handler writing snapshots and FOF catalogs at
    each aout (check_snapshots, src/fastpm.c:1144-1209). The particle
    columns are copied to the host on the caller's thread; the file
    writes run on a background thread while evolve() keeps stepping, and
    flush() joins them and re-raises their failures."""

    def __init__(self, solver: Solver, p: Params, log: Log,
                 n_writers: int = 0):
        self.solver = solver
        self.p = p
        self.log = log
        self.aout = sorted(p.aout or [])
        self.iout = 0
        self.n_writers = n_writers  # CLI -W: concurrent writer threads
        self._io_pool = None
        self._io_futures = []

    def _submit_io(self, fn):
        if self._io_pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._io_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="snapshot-io")
        self._check_io()
        self._io_futures.append(self._io_pool.submit(fn))

    def _check_io(self):
        done = [f for f in self._io_futures if f.done()]
        for f in done:
            self._io_futures.remove(f)
            f.result()  # re-raise background write failures

    def flush(self):
        """Join all in-flight snapshot writes (end of run)."""
        try:
            for f in list(self._io_futures):
                f.result()
        finally:
            self._io_futures = []
            if self._io_pool is not None:
                self._io_pool.shutdown(wait=True)
                self._io_pool = None

    def __call__(self, event):
        self.log.info("Checking Snapshots (%0.4f %0.4f)", event.a1, event.a2)
        # mirror src/fastpm.c:1165-1205: scan pending aouts; ranges are
        # semi-closed (a1, a2] except the zero-length initial/final events
        for iout in range(self.iout, len(self.aout)):
            aout = self.aout[iout]
            if event.a1 == event.a2:
                if event.a1 != aout:
                    continue
            else:
                if event.a1 >= aout or event.a2 < aout:
                    continue
            self.write_one(aout, event)
            self.iout = iout + 1

    def write_one(self, aout, event):
        p, log, s = self.p, self.log, self.solver
        gi = s.cosmology.growth_info(aout)
        # on several ranks, rank 0 gathers every rank's rows and writes
        species = {name: s.set_snapshot(s.species[name], event.drift,
                                        event.kick, aout).gather(s.ring)
                   for name in s.iter_species()}
        if s.ring.rank != 0:
            return
        cdm = species["cdm"]
        log.info("Snapshot a_x = %6.4f, a_v = %6.4f", cdm.a_x, cdm.a_v)
        log.info("Growth factor of snapshot %6.4f (a=%0.4f)", gi.D1, aout)
        log.info("Growth rate of snapshot %6.4f (a=%0.4f)", gi.f1, aout)

        if p.write_snapshot:
            path = "%s_%0.04f" % (p.write_snapshot, aout)
            log.info("Writing a snapshot header to %s", path)
            snapshot = {name: sp.replace(
                **{c: t.cpu() for c, t in sp.columns()})
                for name, sp in species.items()}

            def do_write(path=path, snapshot=snapshot):
                rsd = write_snapshot(path, s.cosmology, snapshot,
                                     p.nc, p.boxsize, param_text=p.source,
                                     sort_by_id=p.sort_snapshot,
                                     n_writers=self.n_writers)
                log.info("RSD factor %e", rsd)
                log.info("Writing %d objects.", snapshot["cdm"].np_local)

            self._submit_io(do_write)
        if p.write_fof:
            ll = p.fof_linkinglength * p.boxsize / p.nc
            cat, _ = find_halos(cdm, ll, p.boxsize, nmin=int(p.fof_nmin))
            dataset = "LL-%05.3f" % p.fof_linkinglength
            path = "%s_%0.04f" % (p.write_fof, aout)
            log.info("Writing a catalog to %s [%s]", path, dataset)
            write_halo_catalog(path, dataset, cat, s.cosmology,
                               aout, p.nc, p.boxsize, M0=cdm.M0)
            log.info("Writing %d objects.", cat.nhalo)


def run_fastpm(p: Params, log=None, n_writers: int = 0,
               device=None, group=None) -> Solver:
    """The full run (src/fastpm.c:run_fastpm) on `device` (default: the
    first CUDA device; raises when there is none), over the ranks of
    the process group `group` when one is given."""
    device = resolve_device(device)
    check_served(p)
    if log is None:
        log = Log()
    solver = Solver(build_config(p), build_cosmology(p), device=device,
                    group=group)
    attach_standard_handlers(solver, log,
                             write_powerspectrum=p.write_powerspectrum,
                             enforce_broadband_kmax=p.enforce_broadband_kmax)

    def print_transition(event):
        t = event.transition
        log.info("==== -> [%03d %03d %03d] a_i = %6.4f a_f = %6.4f "
                 "a_r = %6.4f Action = %s ====",
                 t.i_i, t.i_f, t.i_r,
                 t.a_i, t.a_f, t.a_r, t.action.upper())

    solver.event_handlers.on(ev.EVENT_TRANSITION, ev.STAGE_BEFORE,
                             print_transition)
    checker = SnapshotChecker(solver, p, log, n_writers=n_writers)
    solver.event_handlers.on(ev.EVENT_INTERPOLATION, ev.STAGE_BEFORE, checker)

    try:
        dk, _pk = prepare_deltak(solver, p, log)
        solver.setup_lpt(dk, p.time_step[0])
        del dk
        prepare_ncdm(solver, p, p.time_step[0], log)
        solver.evolve(solver.config.time_step)
    finally:
        # join in-flight background snapshot writes even when evolve
        # raises, so a failed write is reported, not lost
        checker.flush()
    return solver


def start_ranks(device=None):
    """(device, process group) of this process. Under torchrun
    (WORLD_SIZE > 1 in the environment, with RANK, LOCAL_RANK,
    MASTER_ADDR and MASTER_PORT) this starts the default process group:
    NCCL on cuda:LOCAL_RANK, or gloo when device is "cpu". Otherwise
    (device, None): one rank."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return resolve_device(device), None
    import torch
    import torch.distributed as dist
    if device is not None and torch.device(device).type == "cpu":
        backend, device = "gloo", torch.device("cpu")
    else:
        resolve_device(device)          # raises when there is no GPU
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
        backend = "nccl"
    dist.init_process_group(backend)
    return device, dist.group.WORLD


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(
        prog="python -m fastpm_torch.cli",
        description="FastPM cosmological N-body solver on one GPU, or on "
                    "several under torchrun (PyTorch/CUDA port)")
    ap.add_argument("-W", type=int, default=0, help="number of IO writers")
    ap.add_argument("-r", dest="restart", default=None,
                    help="restart from snapshot path (not in this slice)")
    ap.add_argument("-y", dest="nprocy", type=int, default=1,
                    help="ranks along y of a 2D (pencil) decomposition "
                    "(not in this slice: only 1)")
    ap.add_argument("params", help="Lua parameter file")
    ap.add_argument("args", nargs="*", help="extra arguments exposed as "
                    "`args` in the parameter file")
    ns = ap.parse_args(argv)
    if ns.restart:
        raise SystemExit("fastpm_torch: restart (-r) is not served by this "
                         "slice of the port (see ROADMAP.md)")
    if ns.nprocy > 1:
        raise SystemExit("fastpm_torch: -y NprocY > 1 (the pencil "
                         "decomposition) is not served by this slice of "
                         "the port (see ROADMAP.md)")
    p = load_params(ns.params, ns.args)
    device, group = start_ranks(device)
    if group is None:
        run_fastpm(p, n_writers=ns.W, device=device)
        return 0
    import torch.distributed as dist
    try:
        run_fastpm(p, log=Log(echo=dist.get_rank() == 0), n_writers=ns.W,
                   device=device, group=group)
        # the ranks end together: rank 0 is done writing when any exits
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
