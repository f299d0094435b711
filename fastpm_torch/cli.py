"""The port's command-line driver (reference: src/fastpm.c), run as
`python -m fastpm_torch.cli <file.lua>` on one GPU, or as
`torchrun --nproc-per-node P -m fastpm_torch.cli <file.lua>` on P.

Port of fastpm_tpu/cli.py: Lua parameter file -> IC pipeline (gadget
white noise or a white-noise file, fNL-local non-Gaussianity, peak
constraints, or a linear density file) -> 2LPT (CDM, and the
Fermi-Dirac split ncdm species when m_ncdm is set), or a RunPB initial
condition, or a restart from a snapshot (-r) -> evolution in any force
mode, with PGD and the neutrino linear response where asked, and event
handlers for the per-step power spectrum and memory report,
interpolated bigfile snapshots (with the potential and tidal tensor,
subsampled, and with the linear response's history, where asked),
RunPB snapshots, the nonlinear density field, FOF and RFOF catalogs,
and the particle lightcone (prepare_lc: usmesh slices, HEALPix shell
maps and lightcone halos). The IC pipeline writes the
white noise and the linear field (k and real space) where asked. A
parameter the port does not serve stops the run with SystemExit naming
it (see ROADMAP.md). main_lua is the fastpm-lua counterpart.

Under torchrun (WORLD_SIZE > 1) main starts the process group, as the
JAX CLI builds its device mesh (cli.py:817-846): NCCL with one GPU per
rank (cuda:LOCAL_RANK), or gloo when the caller asks for the CPU. -y
NprocY (0, the default: a near-square 2D grid on 4 ranks or more, else
1) makes it a px x py process grid (parallel.comm.Grid); the ranks
split the particles in x-slabs on a grid of py = 1 (or -f) and in
pencils otherwise (solver.py); every rank builds the whole linear field
and the 2LPT displacements of its own rows, or reads a restart snapshot
and keeps the rows of its own lattice sites; rank 0 gathers the rows for
the snapshots and runs FOF and RFOF on them, gathers the rows each rank
finds crossing the lightcone and writes what a one-rank run writes.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

import numpy as np
import torch

from .config.params import load_params, Params
from .cosmology import Cosmology
from .device import resolve_device
from .solver import Solver, SolverConfig, NCDM
from .store import Store, lattice_store
from .ncdm import NcdmInitData, split_ncdm
from .powerspectrum import FuncK, sigma_tophat
from .diagnostics import attach_standard_handlers, Log
from . import ic, events as ev, transfers
from .io.snapshots import (write_snapshot, write_halo_catalog,
                           write_snapshot_header, read_snapshot_header,
                           read_species)
from .io.bigfile import BigFile
from .io.fields import write_complex, read_complex, write_real
from .fof import find_halos, rfof_find_halos
from .memory import MemoryMonitor
from . import prof

__all__ = ["main", "main_lua", "run_fastpm", "build_cosmology",
           "build_config", "prepare_deltak", "prepare_ncdm", "prepare_lc",
           "prepare_runpbic", "SnapshotChecker", "restore_species"]

# parameters the port refuses, each must be unset / false: the schema
# takes them, but the JAX package's CLI never reads them (a run with
# read_grafic set there starts from the seed), so the port stops the run
# until it serves them for real (ROADMAP.md queue 3)
_LATER_PARAMS = ("read_grafic", "write_runpbic")


def check_served(p: Params) -> None:
    """SystemExit naming the first parameter the port does not serve."""
    bad = [name for name in _LATER_PARAMS if p.get(name, None)]
    if bad:
        raise SystemExit(f"fastpm_torch: parameter {bad[0]!r} is not "
                         "served by the port (see ROADMAP.md)")


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
        compute_potential=bool(p.compute_potential),
        compute_tidal=bool(p.get("compute_tidal", False)),
        rand_ntask=int(p.get("rand_ntask", 1)),
        # rand is read by subsampled snapshots and lightcone subsampling
        # only (src/fastpm.c:1025-1046, 1453)
        need_rand=bool(p.particle_fraction < 1 or p.lc_write_usmesh),
        pgdc=bool(p.pgdc), pgdc_alpha0=p.pgdc_alpha0, pgdc_A=p.pgdc_A,
        pgdc_B=p.pgdc_B, pgdc_kl=p.pgdc_kl, pgdc_ks=p.pgdc_ks,
        # the reference's pm_check_values runs on every CLI run
        # (gravity.c:350-383)
        check_values=True,
    )


def prepare_deltak(solver: Solver, p: Params, log: Log):
    """The IC pipeline (src/fastpm.c:prepare_deltak): delta_k normalized
    at z=0 on the lptpm mesh, and the (sigma8-corrected) input P(k)
    (None for a linear density file). From read_lineark (no other
    shaping, the sign flip of inverted_ic, then the rescale from
    linear_density_redshift), or from the power spectrum file and the
    gadget white noise (or read_whitenoisek), with fNL-local
    non-Gaussianity (f_nl_type) and peak constraints (constraints) where
    asked. Writes write_whitenoisek, write_lineark (the field before the
    constraints, as UnconstrainedLinearDensityK, when there are any) and
    write_linearr where asked, from rank 0: every rank builds the whole
    field."""
    pm = solver.lptpm
    c = solver.cosmology
    writer = solver.ring.rank == 0

    def read_field(path, block):
        return torch.from_numpy(read_complex(pm, path, block)).to(pm.device)

    if p.read_lineark:
        log.info("Reading Fourier space linear overdensity from %s",
                 p.read_lineark)
        dk = read_field(p.read_lineark, "LinearDensityK")
        if p.inverted_ic:
            dk = -dk
        return ic.rescale_linear(pm, dk, c, 1.0,
                                 p.linear_density_redshift), None

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

    if p.read_whitenoisek:
        log.info("Reading Fourier white noise file from '%s'.",
                 p.read_whitenoisek)
        dk = read_field(p.read_whitenoisek, "WhiteNoiseK")
    else:
        dk = ic.gaussian_white_noise(pm, p.random_seed)
    # (x, y, z) order whatever the noise's source: every field made from
    # dk keeps its layout, and the FFT plans take that one (ops/fft.py)
    dk = dk.contiguous()
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
    if p.write_whitenoisek:
        log.info("Writing Fourier white noise to file '%s'.",
                 p.write_whitenoisek)
        if writer:
            write_complex(pm, dk, p.write_whitenoisek, "WhiteNoiseK")
    if p.f_nl_type != "none":
        from .png import PNGaussian
        kmax = (p.nc / 2.0 * 2.0 * np.pi / p.boxsize
                * p.kmax_primordial_over_knyquist)
        log.info("Will set Phi_Gaussian(k)=0 for k>=%f.", kmax)
        log.info("Inducing non gaussian correlation to the white noise.")
        png = PNGaussian(fNL=p.f_nl, kmax_primordial=kmax, pk=pk,
                         h=p.h, scalar_amp=p.scalar_amp,
                         scalar_pivot=p.scalar_pivot,
                         scalar_spectral_index=p.scalar_spectral_index,
                         type=p.f_nl_type)
        dk = png.induce_correlation(pm, dk)
    else:
        log.info("Inducing correlation to the white noise.")
        dk = ic.induce_correlation(pm, dk, pk)
    dk = ic.rescale_linear(pm, dk, c, 1.0, p.linear_density_redshift)
    # set the mean to 1.0 (src/fastpm.c:561-565)
    dk = transfers.set_mode(pm, dk, (0, 0, 0, 0), 1.0, "override")
    if p.constraints:
        from .constrained import apply_constraints
        log.info("Applying %d constraints.", len(p.constraints))
        for i, cns in enumerate(p.constraints):
            log.info("Constraint %d : %g %g %g peak-sigma = %g", i,
                     cns[0], cns[1], cns[2], cns[3])
        if p.write_lineark:
            log.info("Writing fourier space linear field before "
                     "constraints to %s", p.write_lineark)
            if writer:
                write_complex(pm, dk, p.write_lineark,
                              "UnconstrainedLinearDensityK")
        dk = apply_constraints(pm, dk, p.constraints, pk, log)
    elif p.write_lineark:
        log.info("Writing fourier space linear field to %s", p.write_lineark)
        if writer:
            write_complex(pm, dk, p.write_lineark, "LinearDensityK")
    if p.write_linearr:
        # real-space linear field (src/fastpm.c:685-689)
        log.info("Writing real space linear field to %s", p.write_linearr)
        if writer:
            write_real(pm, pm.c2r(dk), p.write_linearr, "LinearDensityR")
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
    # the sites' rand column (the reference's rank-0 stream) subsamples
    # the ncdm rows of a snapshot under particle_fraction < 1
    sites = lattice_store(solver.lptpm, Nc=nc_ncdm, shift=shift0,
                          columns=("v", "acc", "id") + (
                              ("rand",) if solver.config.need_rand else ()),
                          name="ncdm")
    # stagger wrt the cdm grid by half a cdm cell (src/fastpm.c:785-792)
    stag = float(np.float32(p.boxsize / p.nc * 0.5))
    sites = sites.replace(x=sites.x + stag,
                          q_shift=tuple(s + stag for s in sites.q_shift))

    ncdm = split_ncdm(nid, sites).wrap(p.boxsize)
    log.info("average mass of a ncdm particle is %g",
             float(ncdm.mass.double().mean()) / max(1, len(p.m_ncdm)))
    solver.add_species(NCDM, ncdm)

    # own linear field (fall back to cdm's inputs with a warning)
    if not p.read_lineark_ncdm and not p.read_powerspectrum_ncdm:
        log.info("WARNING: No ncdm powerspectrum input; using cdm's "
                 "instead.")
        dk, _ = prepare_deltak(solver, p, log)
    else:
        ns = dict(p.asdict())
        ns["read_lineark"] = p.read_lineark_ncdm
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

        if p.write_runpb_snapshot:
            # RunPB only has CDM (src/fastpm.c:1533-1545)
            from .io.legacy import write_runpb_snapshot
            path = "%s_%0.04f.bin" % (p.write_runpb_snapshot, aout)
            v_internal = cdm.v.cpu().numpy() * aout / 100.0
            write_runpb_snapshot(path, cdm.x.cpu().numpy(), v_internal,
                                 cdm.id.cpu().numpy().reshape(-1), aout,
                                 s.cosmology.E(aout), p.boxsize)
            log.info("runpb snapshot %s written z = %6.4f a = %6.4f",
                     path, 1.0 / aout - 1, aout)
        if p.write_snapshot:
            path = "%s_%0.04f" % (p.write_snapshot, aout)
            log.info("Writing a snapshot header to %s", path)
            if s.lra is not None and s.lra.init_done:
                # the linear response's history goes with every snapshot,
                # so that a restart resumes it (ncdm_lr_save_neutrinos,
                # io.c:591-596); written now, as the history grows while
                # the particle columns are written in the background
                s.lra.save(BigFile(path, create=True))
                log.info("Saved neutrino linear-response state "
                         "(%d history entries)", len(s.lra.scalefact))
            snapshot = {name: sp.replace(
                **{c: t.cpu() for c, t in sp.columns()})
                for name, sp in species.items()}

            def do_write(path=path, snapshot=snapshot):
                rsd = write_snapshot(path, s.cosmology, snapshot,
                                     p.nc, p.boxsize, param_text=p.source,
                                     sort_by_id=p.sort_snapshot,
                                     n_writers=self.n_writers,
                                     particle_fraction=p.particle_fraction)
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
        if p.write_rfof:
            sep = p.boxsize / p.nc
            cat, _ = rfof_find_halos(
                cdm, p.boxsize, 1.0 / aout - 1.0, s.cosmology,
                nmin=int(p.rfof_nmin),
                linkinglength=p.rfof_linkinglength * sep,
                l1=p.rfof_l1 * sep, l6=p.rfof_l6 * sep,
                A1=p.rfof_a1 * sep, A2=p.rfof_a2 * sep,
                B1=p.rfof_b1, B2=p.rfof_b2)
            path = "%s_%0.04f" % (p.write_rfof, aout)
            log.info("Writing a catalog to %s [RFOF]", path)
            write_halo_catalog(path, "RFOF", cat, s.cosmology,
                               aout, p.nc, p.boxsize, M0=cdm.M0)
            log.info("Writing %d objects.", cat.nhalo)
        if p.write_nonlineark:
            # the CDM painted with the run's painter (through K3 and the
            # cell order on the card)
            from .gravity import paint_delta_k
            from .painter import Painter
            pm = s.basepm
            painter = Painter(pm, s.config.painter_type,
                              s.config.painter_support)
            dk = paint_delta_k(pm, painter, [cdm.wrap(pm.BoxSize)])
            path = "%s_%0.04f" % (p.write_nonlineark, aout)
            log.info("Writing nonlinear density K to %s", path)
            write_complex(pm, dk, path, "DensityK")


def prepare_lc(solver: Solver, p: Params, log: Log):
    """Set up the particle lightcone (prepare_lc, src/fastpm.c:860-975)
    and its ready handler (usmesh_ready_handler, src/fastpm.c:982-1140)
    on the solver's device; None when the run writes no lightcone.

    Each ready event drains the crossings (on the device), paints the
    HEALPix shell maps from them, runs the lightcone FOF and RFOF with
    their tails carried to the next batch, subsamples (ell-limited or
    uniform, in host float64 as the reference), sorts by aemit and
    appends the slice to the usmesh file. Only what is written, the
    small host-exact columns and a few scalars cross to the host.

    Over ranks each rank intersects its own rows, the flush threshold is
    taken on the count over every rank (so that a slice flushes at the a
    of a one-rank run), and each ready event gathers every rank's
    crossings on rank 0, which paints the maps from them (the sum of the
    ranks' maps), runs the FOF and RFOF with their tails and writes the
    files alone."""
    import torch
    from .lightcone import LightCone, USMesh, volume_density_from_ell
    from .healpix import paint_hpmap_nest_device, nside2npix

    if not p.lc_write_usmesh:
        return None

    octants = [False] * 8
    for o in (p.lc_octants or []):
        octants[int(o) % 8] = True
        log.info("Using Octant %d", int(o))

    lc = LightCone(cosmology=solver.cosmology,
                   glmatrix=np.asarray(p.lc_glmatrix, dtype=np.float64),
                   fov=p.lc_fov, octants=tuple(octants),
                   dh_factor=p.dh_factor)

    lc_amin = p.lc_amin if p.lc_amin else p.time_step[0]
    lc_amax = p.lc_amax if p.lc_amax else p.time_step[-1]
    log.info("Unstructured Lightcone amin= %g amax=%g", lc_amin, lc_amax)

    tiles = np.asarray(p.lc_usmesh_tiles, dtype=np.float64) * p.boxsize
    # capacity = lc_usmesh_alloc * (CDM np_upper = nc^3 *
    # np_alloc_factor); sets the ready-flush threshold
    # (lightcone-usmesh.c:584 checks np > 0.5 np_upper)
    nupper = int(p.lc_usmesh_alloc_factor * p.np_alloc_factor * p.nc ** 3)
    # a rehomed store's dead rows cross nothing
    mesh = USMesh(lc, lambda: solver.species["cdm"].compact(), tiles,
                  amin=lc_amin, amax=lc_amax,
                  target_volume=p.lc_usmesh_alloc_factor * p.boxsize ** 3,
                  np_upper=nupper, ring=solver.ring)

    nslices = int(p.lc_usmesh_nslices)
    log.info("Generating an AemitIndex with %d layers for usmesh. ",
             nslices)
    edges = np.linspace(0.0, 1.0, nslices + 1)
    counts = {k: np.zeros(nslices + 2, dtype=np.int64)
              for k in ("usmesh", "fof", "rfof", "healpix")}
    state = {"first": True, "tail_fof": None, "tail_rfof": None,
             "first_fof": True, "first_rfof": True}
    filebase = p.lc_write_usmesh
    density = (p.nc / p.boxsize) ** 3
    dev = solver.device

    def index_attrs(block, kind, aemit):
        """Add rows of aemit to the kind's aemitIndex and set the
        block's attributes (io.c:1001-1050)."""
        idx = np.searchsorted(edges, aemit, side="right")
        counts[kind] += np.bincount(idx, minlength=nslices + 2)
        block.attrs.set("aemitIndex.edges", edges, "f8")
        block.attrs.set("aemitIndex.size", counts[kind][:nslices + 2], "i8")
        block.attrs.set("aemitIndex.offset",
                        np.concatenate([[0], np.cumsum(counts[kind])]), "i8")

    def write_blocks(bf, dataset, blocks, first):
        for name, arr in blocks:
            if first:
                bf.create_block(f"{dataset}/{name}", arr)
            else:
                bf.open_block(f"{dataset}/{name}").append(arr)

    def lightcone_fof(rec_d, af, kind):
        """usmesh FOF with tail carry-over (run_usmesh_fof,
        src/fastpm.c:1334-1400, _halos_ready:1211-1260); kind "rfof" runs
        the relaxed finder. Each finder keeps its own tail (the
        reference shares one between the two, which matters only when
        both are on). The batch and the tail stay on the device: only
        the halo catalog, the rows at risk on the tail cut (host float64
        patch) and a few scalars cross to the host."""
        cols = ("x", "v", "id", "aemit")
        parts = [rec_d] if rec_d is not None else []
        if state["tail_" + kind] is not None:
            parts.append(state["tail_" + kind])
        if not parts:
            return
        comb = {k: torch.cat([b[k] for b in parts]) for k in cols}
        if comb["aemit"].shape[0] == 0:
            return
        st = Store(x=comb["x"], v=comb["v"], id=comb["id"],
                   aemit=comb["aemit"])
        if kind == "rfof":
            # "Use the average redshift -- this is bad if the slices
            # are large!" (src/fastpm.c:1319): the mean aemit of the
            # batch, the reference's meta.a_x of the usmesh store
            a_avg = float(np.mean(comb["aemit"].cpu().numpy()))
            sep = p.boxsize / p.nc
            cat, ihalo = rfof_find_halos(
                st, p.boxsize, 1.0 / a_avg - 1.0, solver.cosmology,
                nmin=int(p.rfof_nmin),
                linkinglength=p.rfof_linkinglength * sep,
                l1=p.rfof_l1 * sep, l6=p.rfof_l6 * sep,
                A1=p.rfof_a1 * sep, A2=p.rfof_a2 * sep,
                B1=p.rfof_b1, B2=p.rfof_b2, periodic=False)
        else:
            ll = p.fof_linkinglength * p.boxsize / p.nc
            cat, ihalo = find_halos(st, ll, p.boxsize,
                                    nmin=int(p.fof_nmin), periodic=False)
        padding = p.lc_usmesh_fof_padding
        rmin = float(lc.horizon.distance(af))
        established = lc.distance_of(cat.x) > rmin + 0.5 * padding

        # the tail cut on the device radius, with the rows within an
        # error margin of the threshold decided in host float64 (the
        # float32 |x| can put a row on the other side)
        thresh = rmin + padding
        x = comb["x"]
        r_p = (x[:, 2] if lc.fov <= 0
               else torch.sqrt(torch.sum(x * x, dim=-1)))
        near_tail = r_p <= float(np.float32(thresh))
        eps = float(np.float32(max(4e-7 * abs(thresh), 1e-4)))
        ridx = torch.nonzero(torch.abs(r_p - float(np.float32(thresh)))
                             < eps).reshape(-1)
        if ridx.shape[0]:
            xr = x[ridx].cpu().numpy().astype(np.float64)
            near_tail[ridx] = torch.from_numpy(
                lc.distance_of(xr) <= thresh).to(x.device)
        ih = torch.as_tensor(ihalo, device=x.device)
        in_est = torch.zeros_like(near_tail)
        if len(established):
            est = torch.from_numpy(established).to(x.device)
            in_est = (ih >= 0) & est[ih.clamp(min=0)]
        tidx = torch.nonzero(near_tail & ~in_est).reshape(-1)
        state["tail_" + kind] = {k: v[tidx] for k, v in comb.items()}
        log.info("%d particles will be reused in next batch for "
                 "usmesh FOF", int(tidx.shape[0]))

        rows = np.flatnonzero(established)
        order = rows[np.argsort(cat.aemit[rows], kind="stable")] \
            if cat.aemit is not None else rows
        dataset = "RFOF" if kind == "rfof" \
            else "LL-%05.3f" % p.fof_linkinglength
        bf = BigFile(filebase, create=True)
        write_blocks(bf, dataset, (
            ("Length", cat.length[order].astype(np.int32)),
            ("Position", cat.x[order].astype(np.float32)),
            ("Velocity", cat.v[order].astype(np.float32)),
            ("MinID", cat.minid[order].astype(np.int64)),
            ("Aemit", (cat.aemit[order] if cat.aemit is not None
                       else np.zeros(len(order))).astype(np.float32))),
            state["first_" + kind])
        state["first_" + kind] = False
        index_attrs(bf.open_block(dataset), kind,
                    cat.aemit[order] if cat.aemit is not None
                    else np.zeros(0))
        log.info("Writing a catalog to %s [%s]", filebase, dataset)
        log.info("Writing %d objects.", len(order))

    def slice_sort_compact(rec_d, keep):
        """The kept rows sorted by aemit (stable), on the device; the
        written columns fetched to the host."""
        idx = torch.nonzero(torch.from_numpy(keep).to(dev)).reshape(-1)
        order = idx[torch.sort(rec_d["aemit"][idx], stable=True)[1]]
        return {k: rec_d[k][order].cpu().numpy()
                for k in ("x", "v", "id", "aemit", "rand") if k in rec_d}

    def gathered(rec_d):
        """Every rank's crossings on rank 0 (None elsewhere, and when no
        rank has any): the columns of a rank without crossings are
        empty."""
        p = solver.species["cdm"]
        shapes = dict(x=((3,), torch.float32), v=((3,), torch.float32),
                      aemit=((), torch.float32))
        for name in ("id", "rand"):
            col = getattr(p, name)
            if col is not None:
                shapes[name] = (tuple(col.shape[1:]), col.dtype)
        cols = {k: (rec_d[k] if rec_d is not None
                    else torch.zeros((0,) + shape, dtype=dt, device=dev))
                for k, (shape, dt) in shapes.items()}
        cols = {k: solver.ring.gather_rows(t) for k, t in cols.items()}
        if solver.ring.rank != 0 or cols["aemit"].shape[0] == 0:
            return None
        cols["n"] = int(cols["aemit"].shape[0])
        return cols

    def ready(event):
        rec_d = event.mesh.drain_device()
        totals = None
        if solver.sharded:
            # the header's counts are over every rank
            totals = {name: solver.global_count(name)
                      for name in solver.iter_species()}
            rec_d = gathered(rec_d)
            if solver.ring.rank != 0:
                return
        n = 0 if rec_d is None else rec_d["n"]
        log.info("Unstructured LightCone ready : ai = %g af = %g, n = %d",
                 event.ai, event.af, n)
        # host copies of the small columns the subsample reads (float64
        # fractions as the reference's doubles); x and v stay on the
        # device for the FOF tail and the HEALPix maps
        rec = {k: (rec_d[k].cpu().numpy() if rec_d is not None
                   else np.zeros(0, np.float32)) for k in ("aemit", "rand")}

        # HEALPix shell maps from the crossings before the subsample
        # (src/fastpm.c:1009-1012; io.c:1105-1227): NEST pixels, mass and
        # radial momentum per (slice, pixel)
        nside = int(p.lc_usmesh_healpix_nside)
        if nside > 0 and n > 0:
            ids, mass_map, rmom_map, amid = paint_hpmap_nest_device(
                rec_d["x"], rec_d["aemit"], rec_d["v"],
                solver.species["cdm"].M0, nside, nslices)
            bf = BigFile(filebase, create=True)
            write_blocks(bf, "HEALPIX", (
                ("ID", ids.astype(np.int64)),
                ("Aemit", amid.astype(np.float32)),
                ("Mass", mass_map.astype(np.float32)),
                ("Rmom", rmom_map.astype(np.float32))),
                not bf.has_block("HEALPIX/ID"))
            mroot = bf.open_block("HEALPIX")
            mroot.attrs.set("healpix.nside", np.int64(nside), "i8")
            mroot.attrs.set("healpix.npix", np.int64(nside2npix(nside)),
                            "i8")
            mroot.attrs.set("healpix.nslices", np.int64(nslices), "i8")
            mroot.attrs.set("healpix.scheme", "NEST")
            index_attrs(mroot, "healpix", amid)
            log.info("Writing a catalog to %s [HEALPIX]", filebase)
            log.info("Writing %d objects.", len(ids))

        for kind, want in (("fof", p.write_fof), ("rfof", p.write_rfof)):
            tail = state["tail_" + kind]
            flush = (event.whence == ev.TIMESTEP_END and tail is not None
                     and tail["aemit"].shape[0])
            if want and (n > 0 or flush):
                lightcone_fof(rec_d, event.af, kind)

        # subsample (ell-limited or uniform; src/fastpm.c:1025-1046): the
        # keep mask in host float64, as the reference's per-particle
        # doubles; the reference keeps on rand <= fraction (store.c:993)
        if p.lc_usmesh_ell_limit > 0:
            # volume_density_from_ell vectorized, op for op the scalar
            # formula (horizon.c:150-158) so the float64 rounding matches
            m = np.maximum(rec["aemit"].astype(np.float64), 1e-3)
            z = 1.0 / m - 1.0
            r = lc.horizon.distance(1.0 / (1 + z))
            s_lim = r * (np.pi / p.lc_usmesh_ell_limit)
            with np.errstate(divide="ignore"):
                dens = (1.0 / s_lim) ** 3
            frac = np.minimum(1.0, dens / density)
            if len(frac):
                log.info("Subsampling to density %g (a = %06.4f) ~ %g "
                         "(a = %06.4f), ",
                         min(1.0, volume_density_from_ell(
                             p.lc_usmesh_ell_limit,
                             1 / max(event.ai, 1e-3) - 1,
                             lc.horizon) / density),
                         event.ai,
                         min(1.0, volume_density_from_ell(
                             p.lc_usmesh_ell_limit,
                             1 / max(event.af, 1e-3) - 1,
                             lc.horizon) / density),
                         event.af)
            keep = rec["rand"] <= frac
        elif p.particle_fraction < 1:
            keep = rec["rand"] <= p.particle_fraction
        else:
            keep = np.ones(n, dtype=bool)

        if rec_d is not None:
            out = slice_sort_compact(rec_d, keep)
        else:
            out = dict(x=np.zeros((0, 3), np.float32),
                       v=np.zeros((0, 3), np.float32),
                       id=np.zeros(0, np.int64),
                       aemit=np.zeros(0, np.float32),
                       rand=np.zeros(0, np.float32))
        bf = BigFile(filebase, create=True)
        if state["first"]:
            log.info("Creating usmesh catalog in %s", filebase)
            write_snapshot_header(bf, solver.cosmology, p.time_step[-1],
                                  p.nc, p.boxsize, solver.species,
                                  counts=totals)
            bf.open_block("Header").attrs.set("ParamFile", p.source)
        else:
            log.info("Appending usmesh catalog to %s", filebase)
        write_blocks(bf, "1", (
            ("Position", out["x"].astype("f4")),
            ("Velocity", out["v"].astype("f4")),
            ("ID", out["id"].astype("i8")),
            ("Aemit", out["aemit"].astype("f4")),
            ("Rand", out.get("rand", np.zeros(0, np.float32)).astype("f4"))),
            state["first"])
        state["first"] = False
        root = (bf.open_block("1") if bf.has_block("1")
                else bf.create_block("1"))
        index_attrs(root, "usmesh", out["aemit"])
        log.info("Writing %d objects.", len(out["aemit"]))

    mesh.event_handlers.on(ev.EVENT_LIGHTCONE_READY, ev.STAGE_AFTER, ready)

    def check_lightcone(event):
        mesh.intersect(event.drift, event.kick, event.a1, event.a2,
                       event.whence)

    solver.event_handlers.on(ev.EVENT_INTERPOLATION, ev.STAGE_BEFORE,
                             check_lightcone)
    return mesh


def _prepare_time_step(all_steps, a0):
    """Truncate the timestep list for a restart at a0
    (prepare_time_step, src/fastpm.c:593-613)."""
    i = -1
    for j, a in enumerate(all_steps):
        if a > a0 + 1e-7:
            break
        i = j
    return [a0] + [a for a in all_steps[i + 1:] if a > a0 + 1e-7]


def prepare_runpbic(solver: Solver, path: str, a0: float, log: Log):
    """Initialize the CDM from a RunPB TPM IC set (read_runpb_ic,
    src/runpb.c:150-299): recover the ZA/2LPT displacements from the
    file's (position, velocity) pair using the fitting growth rates
    f1 = Omega^(4/7), f2 = Omega^(6/11) (in host float64), reset the
    particles to the half-cell-shifted lattice of their ids, then evolve
    with 2LPT to a0 on the solver's device. On several ranks every rank
    reads the file and keeps, sorted by id, the rows of its own lattice
    sites: its slab, or its pencil (the ids of its lattice rows)."""
    from .io.legacy import read_runpb_snapshot

    data = read_runpb_snapshot(path)
    aa = float(data["aa"])
    log.info("RunPB IC at a = %g from %s", aa, path)
    c = solver.cosmology
    nc = solver.config.nc
    boxsize = solver.config.boxsize
    D = c.growth_info(aa).D1
    omega = c.Omega_cdm_a(aa)
    f1 = omega ** (4.0 / 7)
    f2 = omega ** (6.0 / 11)

    ids = data["id"].astype(np.int64)
    x = data["x"].astype(np.float64)          # box units [0,1)
    v = data["v"].astype(np.float64)          # RunPB RSD units
    p = solver.species["cdm"]
    if solver.ring.nproc > 1:
        keep = _lattice_rows(solver, ids, "read_runpbic")
        ids, x, v = ids[keep], x[keep], v[keep]
    strides = np.array([nc * nc, nc, 1], dtype=np.int64)
    lattice = np.stack([(ids // strides[d]) % nc for d in range(3)],
                       axis=-1)
    opos = lattice * (1.0 / nc) + 0.5 / nc
    disp = x - opos
    disp = np.where(disp < -0.5, disp + 1.0, disp)
    disp = np.where(disp > 0.5, disp - 1.0, disp)
    dx1 = (v - disp * 2 * f2) / (f1 - 2 * f2) / D * boxsize
    dx2 = (v - disp * f1) / (2 * f2 - f1) / (D * D) * boxsize
    q = np.remainder(opos * boxsize, boxsize)
    log.info("dx1 disp: %g %g %g", *np.sqrt((dx1 ** 2).mean(axis=0)))
    log.info("dx2 disp: %g %g %g", *np.sqrt((dx2 ** 2).mean(axis=0)))

    def column(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(
            solver.device)

    cell = boxsize / nc
    solver.species["cdm"] = p.replace(
        x=column(q, np.float32), v=torch.zeros_like(p.v),
        id=column(ids, np.int64), dx1=column(dx1, np.float32),
        dx2=column(dx2, np.float32), q_shift=(0.5 * cell,) * 3,
        q_scale=(cell,) * 3, q_nc=(nc, nc, nc))
    solver.setup_lpt(None, a0)


def _lattice_rows(solver: Solver, ids: np.ndarray, what: str):
    """The rows of a file (with these ids) that this rank holds in a
    straight run: the file's rows sorted by id are the lattice in id
    order, and the rank keeps those at the ids of its own lattice rows
    (its slab, or its pencil), in their order. SystemExit unless the ids
    are an nc^3 lattice's, each once."""
    order = np.argsort(ids, kind="stable")
    if not np.array_equal(ids[order], np.arange(solver.config.nc ** 3)):
        raise SystemExit(f"{what} on several ranks needs the ids of an "
                         "nc^3 lattice, each once")
    return order[solver.species["cdm"].id.cpu().numpy()]


def restore_species(solver: Solver, path: str, dataset: str, log: Log):
    """Read the CDM species back from a snapshot on the solver's device,
    inverting the unit conversion (prepare_cdm's restart path,
    src/fastpm.c:616-648); returns (store, a0). The snapshot's velocity
    is peculiar km/s, the internal one v * a / 100; ids come back as
    int64 from either package's snapshots. The LPT displacements are
    restored where the snapshot has them (force modes cola, za, 2lpt).
    On several ranks each rank keeps the rows of its own lattice sites,
    as in a straight run (_lattice_rows), so that the restarted run
    picks the same halo and force."""
    import torch
    data = read_species(path, dataset)
    attrs = data["_attrs"]
    a_x = float(np.ravel(attrs["a.x"])[0])
    a_v = float(np.ravel(attrs["a.v"])[0])
    if abs(a_x - a_v) > 1e-12:
        raise SystemExit("restart snapshot must be synced (a_x == a_v)")
    dev = solver.device
    ids = data["id"].reshape(-1)
    keep = (_lattice_rows(solver, ids.astype(np.int64), "restart")
            if solver.ring.nproc > 1 else slice(None))

    def column(a):
        return torch.from_numpy(np.ascontiguousarray(a[keep])).to(dev)

    updates = dict(
        x=column(data["x"].astype(np.float32)),
        v=column((data["v"] * a_x / 100.0).astype(np.float32)),
        id=column(ids))
    for name in ("dx1", "dx2"):
        if solver._keep_lpt and name in data:
            updates[name] = column(data[name].astype(np.float32))
    p = solver.species["cdm"]
    n = updates["x"].shape[0]
    for name in ("acc", "pgdc"):
        if getattr(p, name) is not None:
            updates[name] = torch.zeros((n, 3), dtype=torch.float32,
                                        device=dev)
    store = p.replace(a_x=a_x, a_v=a_v,
                      M0=float(np.ravel(attrs["M0"])[0]),
                      q_scale=tuple(np.ravel(attrs["q.scale"])),
                      q_shift=tuple(np.ravel(attrs["q.shift"])), **updates)
    log.info("Restarted species %s at a = %0.4f with %d particles",
             dataset, a_x, store.np_local)
    return store, a_x


def _check_restart(p: Params) -> None:
    """SystemExit when a restart cannot be served: with subsampling or
    with the lightcone (the JAX package's two refusals, cli.py:856-858,
    898-902)."""
    if p.particle_fraction != 1:
        raise SystemExit("Cannot restart because subsampling of "
                         "particles is enabled.")
    if p.lc_write_usmesh:
        raise SystemExit("FIXME: Restarting and lightcone are "
                         "currently incompatible.")


def run_fastpm(p: Params, log=None, n_writers: int = 0,
               device=None, group=None, restart: str = None,
               memory_bound_mb: int = 0, grid=None,
               profile: bool = False) -> Solver:
    """The full run (src/fastpm.c:run_fastpm) on `device` (default: the
    first CUDA device; raises when there is none), over the ranks of
    the process group `group` when one is given (in x-slabs), or of the
    process grid `grid` (a parallel.comm.Grid; pencils where py > 1);
    from the snapshot at `restart` when one is given. Each transition
    logs its
    banner and the memory report, and MemoryBoundExceeded stops the run
    when memory_bound_mb is set and exceeded; the teardown logs the
    memory report and the clocks' table (prof). On a CUDA device, and
    under a profiler trace (profile), the clocks time the card and are
    spans of the trace (prof.enable_sync) for the run, and are off
    after it."""
    device = resolve_device(device)
    if grid is not None and group is None:
        group = grid.group
    ranks = 1
    if group is not None:
        import torch.distributed as dist
        ranks = dist.get_world_size(group)
    check_served(p)
    if log is None:
        log = Log()
    cfg = build_config(p)
    if restart:
        _check_restart(p)
        a0 = float(np.ravel(read_snapshot_header(restart)["ScalingFactor"])[0])
        cfg.time_step = _prepare_time_step(list(p.time_step), a0)
        log.info("Restarting from %s at a = %0.4f", restart, a0)
    if grid is not None and ranks > 1:
        log.info("Using a %s device mesh over %d devices", grid.shape,
                 ranks)
    prof.reset()
    prof.enable_sync(device.type == "cuda" or profile)
    solver = Solver(cfg, build_cosmology(p), device=device, group=group,
                    grid=grid)
    if p.ncdm_linearresponse:
        z_t = (p.ncdm_transfer_redshift
               if p.ncdm_transfer_redshift is not None
               else 1.0 / p.time_step[0] - 1)
        solver.setup_linear_response(z_t, p.ncdm_transfer_nu_file)
        log.info("Neutrino linear response enabled at z_transfer = %g",
                 z_t)
    attach_standard_handlers(solver, log,
                             write_powerspectrum=p.write_powerspectrum,
                             enforce_broadband_kmax=p.enforce_broadband_kmax)

    # per-transition banner + memory report (print_transition,
    # src/fastpm.c:1576-1601; report_memory:1604-1646)
    monitor = MemoryMonitor(bound_bytes=(int(memory_bound_mb) << 20)
                            if memory_bound_mb else None, device=device)

    def print_transition(event):
        t = event.transition
        log.info("==== -> [%03d %03d %03d] a_i = %6.4f a_f = %6.4f "
                 "a_r = %6.4f Action = %s ====",
                 t.i_i, t.i_f, t.i_r,
                 t.a_i, t.a_f, t.a_r, t.action.upper())
        monitor.report(log)

    solver.event_handlers.on(ev.EVENT_TRANSITION, ev.STAGE_BEFORE,
                             print_transition)
    checker = SnapshotChecker(solver, p, log, n_writers=n_writers)
    solver.event_handlers.on(ev.EVENT_INTERPOLATION, ev.STAGE_BEFORE, checker)
    prepare_lc(solver, p, log)

    try:
        if restart:
            solver.species["cdm"], a0 = restore_species(solver, restart, "1",
                                                        log)
            # do not rewrite snapshots at or before the restart time
            checker.iout = sum(1 for a in checker.aout if a <= a0 + 1e-7)
            if solver.lra is not None:
                # resume the linear response's history: re-seeding
                # delta_nu from the transfer input is wrong past
                # z_transfer (io.c:591-596; neutrinos_lra.c:329-473)
                bf = BigFile(restart)
                if bf.has_block("Neutrino"):
                    solver.lra.load(bf)
                    log.info("Restored neutrino linear-response state "
                             "(%d history entries)",
                             len(solver.lra.scalefact))
                else:
                    log.info("WARNING: LRA restart without a Neutrino "
                             "block; delta_nu history re-seeds from the "
                             "transfer input")
        elif p.read_runpbic:
            prepare_runpbic(solver, p.read_runpbic, p.time_step[0], log)
        else:
            dk, _pk = prepare_deltak(solver, p, log)
            solver.setup_lpt(dk, p.time_step[0])
            del dk
            prepare_ncdm(solver, p, p.time_step[0], log)
        solver.evolve(solver.config.time_step)
    finally:
        prof.enable_sync(False)
        # join in-flight background snapshot writes even when evolve
        # raises, so a failed write is reported, not lost
        checker.flush()
    # teardown report (run_fastpm end, src/fastpm.c:388-396)
    monitor.report(log, force=True)
    prof.report(printer=lambda line: log.info("%s", line))
    return solver


def grid_rows(n: int, nprocy: int = 0) -> int:
    """The ranks along y of the process grid over n ranks (make_device_mesh,
    fastpm_tpu/cli.py:817-843): nprocy = 0 picks a near-square 2D grid
    for n >= 4 (int(sqrt(n)), backed off to a divisor), else 1; a given
    nprocy must divide n (SystemExit otherwise)."""
    if nprocy == 0:
        ny = 1
        if n >= 4:
            ny = int(np.sqrt(n))
            while n % ny:
                ny -= 1
        return ny
    if n % nprocy:
        raise SystemExit(f"-y {nprocy} does not divide {n} devices")
    return int(nprocy)


def start_ranks(device=None, nprocy: int = 0):
    """(device, process group, process grid) of this process. Under
    torchrun (WORLD_SIZE > 1 in the environment, with RANK, LOCAL_RANK,
    MASTER_ADDR and MASTER_PORT) this starts the default process group,
    NCCL on cuda:LOCAL_RANK, or gloo when device is "cpu", and the
    px x py Grid over it of grid_rows(nprocy) rows along y. Otherwise
    (device, None, None): one rank."""
    n = int(os.environ.get("WORLD_SIZE", "1"))
    if n <= 1:
        return resolve_device(device), None, None
    ny = grid_rows(n, nprocy)
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
    from .parallel.comm import Grid
    return device, dist.group.WORLD, Grid(dist.group.WORLD, n // ny, ny)


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(
        prog="python -m fastpm_torch.cli",
        description="FastPM cosmological N-body solver on one GPU, or on "
                    "several under torchrun (PyTorch/CUDA port)")
    ap.add_argument("-T", type=int, default=0,
                    help="ignored (threads: the card's kernels own them)")
    ap.add_argument("-W", type=int, default=0, help="number of IO writers")
    ap.add_argument("-f", dest="fftw", action="store_true",
                    help="force the 1D slab decomposition (the FFTW-MPI "
                         "analog; same as -y 1)")
    ap.add_argument("-y", dest="nprocy", type=int, default=0,
                    help="ranks along y of the process grid (NprocY): "
                         "0 = auto (a 1D slab over every rank; a near-"
                         "square 2D pencil grid on 4 ranks or more)")
    ap.add_argument("-m", dest="memory_bound_mb", type=int, default=0,
                    help="abort cleanly (MemoryBoundExceeded) when memory "
                         "usage exceeds this many MB (0 = unbounded)")
    ap.add_argument("-r", dest="restart", default=None,
                    help="restart from snapshot path")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace (Chrome JSON) of "
                         "the run, with the program's spans, to DIR; the "
                         "clocks' table prints regardless")
    ap.add_argument("params", help="Lua parameter file")
    ap.add_argument("args", nargs="*", help="extra arguments exposed as "
                    "`args` in the parameter file")
    ns = ap.parse_args(argv)
    import faulthandler
    faulthandler.enable()  # crash backtraces (src/stacktrace.c)
    p = load_params(ns.params, ns.args)
    device, group, grid = start_ranks(device, 1 if ns.fftw else ns.nprocy)
    kw = dict(n_writers=ns.W, device=device, restart=ns.restart,
              memory_bound_mb=ns.memory_bound_mb, profile=bool(ns.profile))
    try:
        with _profiled(ns.profile, device, group):
            if group is None:
                run_fastpm(p, **kw)
            else:
                import torch.distributed as dist
                run_fastpm(p, log=Log(echo=dist.get_rank() == 0),
                           group=group, grid=grid, **kw)
                # the ranks end together: rank 0 is done writing when
                # any exits
                dist.barrier()
    finally:
        if group is not None:
            import torch.distributed as dist
            dist.destroy_process_group()
    return 0


@contextlib.contextmanager
def _profiled(directory, device, group):
    """A torch.profiler trace of the CPU and, on the card, of its kernels
    around the body, written as Chrome JSON to directory/trace.json
    (trace.rank<r>.json on several ranks); nothing without a
    directory."""
    if not directory:
        yield
        return
    from torch.profiler import profile, ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as trace:
        yield
    os.makedirs(directory, exist_ok=True)
    name = "trace.json"
    if group is not None:
        import torch.distributed as dist
        name = "trace.rank%d.json" % dist.get_rank(group)
    trace.export_chrome_trace(os.path.join(directory, name))


def main_lua(argv=None):
    """fastpm-lua equivalent (src/fastpm-lua.c): compile a parameter
    file -- executing its `main` function if one is defined -- and
    print the bound parameters; -H dumps the schema instead. Host
    only."""
    from .config.schema import SCHEMA, SchemaError

    ap = argparse.ArgumentParser(
        prog="python -m fastpm_torch.tools lua",
        description="compile a fastpm Lua parameter file and print "
                    "the resolved parameters")
    ap.add_argument("-H", dest="dump_schema", action="store_true",
                    help="print the supported parameters and exit")
    ap.add_argument("params", nargs="?", help="Lua parameter file")
    ap.add_argument("args", nargs="*", help="extra arguments exposed "
                    "as `args` in the parameter file")
    ns = ap.parse_args(argv)

    if ns.dump_schema:
        print("Supported Parameters are: ")
        for name, ent in sorted(SCHEMA.items()):
            req = "required" if ent.required else \
                "default=%r" % (ent.default,)
            print("  %-32s %-8s %s" % (name, ent.type, req))
        return 0
    if not ns.params:
        ap.error("parameterfile is required")
    try:
        p = load_params(ns.params, ns.args, runmain=True)
    except (OSError, SchemaError) as e:
        print("fastpm_torch lua: %s" % e, file=sys.stderr)
        return 1
    print("Compiled parameters are: ")
    for k, v in sorted(p.asdict().items()):
        print("%s = %r" % (k, v))
    return 0


if __name__ == "__main__":
    sys.exit(main())
