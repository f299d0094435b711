"""The FastPM solver: species, time evolution, events
(reference: libfastpm/solver.c, vpm.c).

Port of fastpm_tpu/solver.py: the baryon, CDM and ncdm species, every
force mode (fastpm, pm, cola, za, 2lpt; zola is fastpm), the PGD
correction, the neutrino linear response, the variable-resolution force
mesh (VPM) table, and the reference's event architecture (events fire
between the kick / drift / force actions), on one device, or over the
ranks of a torch.distributed process group in the slab decomposition or,
on a 2D process grid (parallel.comm.Grid), the pencil decomposition.
The species are walked in SPECIES_ORDER (baryon, CDM, ncdm) by every
force, kick, drift and snapshot.

Without a process group the force step is gravity.compute_force_carry
for one scalar-mass species and gravity.compute_force (every species
into one canvas) otherwise, or when the potential or the tidal tensor
is asked for (SolverConfig.compute_potential / compute_tidal), or when
SolverConfig.order_free is off. With stale_every = N > 1, N - 1 of every
N carry forces are stale (gravity.compute_force_stale: the carried
order, no sort; solver.py:548-572). Over a group (of one rank too, so
that one card drives the ranks' path; the JAX package runs a one-device
mesh on its global path), each rank holds a contiguous block of every
species' rows (Store.shard) and the force is a homed force of
parallel/psolver.py (solver.py:589-876): on a grid of py > 1 (or the
1 x 1 grid of one rank) whose species are all pencil-blocked, the
pencil force; for species all in x-major order, the slab force over
every rank; the order-free carry for one scalar-mass species with the
CIC painter, neither the potential nor the tidal tensor and order_free
on, the multi-species body otherwise; and the v1 full-canvas force when
no halo width fits or the species' orders are mixed (ncdm rows beside a
pencil-blocked lattice). The
halo width is measured, kept while it holds, and measured again when a
force finds a particle beyond it; that force is then run again, so no
result with a particle beyond the halo is ever used (solver.py:
1332-1368). The pencil's k shard loses its kz pad before anything
downstream but PGD sees delta_k (solver.py:872-875).

With order_free off (solver.py:80-91, 530-546) every force keeps the
rows where they are: x (wrapped), acc and, where the columns are
allocated, the potential and the tidal tensor come from the force, and
every other column is the store's own. Stale stepping and rehoming,
which permute the rows, are then not taken.

With rehome (opt-in, slab carry only) the store takes the rehomed
layout (store.py; solver.py:335-380) and each force migrates the rows
that crossed a slab edge to their owner (psolver's rehome body), so the
halo stays at the support plus one step's drift. A force whose halo,
bucket or capacity overflows is discarded, the store converted anew and
the force run again; where no migration-legal halo fits, the store goes
back to dense (solver.py:605-672).

The force modes cola, za and 2lpt keep the LPT columns dx1 and dx2 in
the store, which every row permutation carries. With the neutrino linear
response on, each force measures P(k) of the softened delta_k (one small
fetch of its bins to the host, summed over the ranks, so that every rank
updates the same history), updates the response history
(neutrinos_lra.DeltaTotTable) and multiplies delta_k by the transfer
before the potential kernel (the forces' transfer hook; over ranks the
rank's k shard, after the overflow count: a replayed force updates the
history once). PGD reads the force's softened (and transferred) delta_k
and fills the pgdc column of CDM, which the next drift consumes; over
ranks through the force's own readout (psolver.reader).

The prof clocks, spans of a torch.profiler trace while prof.enable_sync
is on: `init` (the constructor: meshes, lattice), `lpt` (setup_lpt),
`kick`, `drift` and `force` (evolve's actions); inside `force`,
`force.wait` (the host's fetch of the last force's finite-ness flag),
`force.wrap` (the periodic wrap), `force.check` (the finite-ness scan)
and the force's phases (gravity.py; over ranks the k-space stage's).
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple
import weakref

import numpy as np
import torch

from .cosmology import Cosmology, FIDUCIAL
from .device import resolve_device
from .kdk import KickFactor, DriftFactor
from .timemachine import (StateTable, ACTION_FORCE, ACTION_KICK,
                          ACTION_DRIFT)
from .mesh import PM
from .painter import Painter
from .store import Store, lattice_store
from .gravity import (compute_force, compute_force_carry,
                      compute_force_stale, carry_eligible)
from .lpt import lpt_solve, lpt_evolve
from .parallel.comm import Ring
from .parallel.pfft import SlabPM, PencilPM
from .parallel import psolver
from . import transfers, events as ev, prof
from .units import RHO_CRIT, HUBBLE_CONSTANT, HUBBLE_DISTANCE

__all__ = ["SolverConfig", "Solver", "CDM", "BARYON", "NCDM",
           "SPECIES_ORDER"]

BARYON = "baryon"
CDM = "cdm"
NCDM = "ncdm"
SPECIES_ORDER = (BARYON, CDM, NCDM)


def _f32(a: float) -> float:
    """A coefficient rounded to float32, as the reference's float
    arithmetic sees it."""
    return float(np.float32(a))


@dataclass
class SolverConfig:
    """Mirror of FastPMConfig (api/fastpm/solver.h) with lua-schema
    defaults (src/lua-runtime-fastpm.lua).

    order_free: let the carry force return the store in cell order
    (the default); False keeps every row in place through every force
    (no environment default, unlike the JAX package's
    FASTPM_TPU_ORDER_FREE), and stale_every and rehome are then
    ignored. stale_every: with N > 1, on one device, N - 1 of every N
    carry forces reuse the carried order of the one before (no
    environment default, unlike the JAX package's FASTPM_TPU_STALE); the
    sharded and multi-species forces ignore it. rehome: over a process
    group, the slab carry with end-of-step migration (no environment
    default, unlike the JAX package's FASTPM_TPU_REHOME); other forces
    ignore it."""

    nc: int
    boxsize: float
    time_step: Sequence[float] = (1.0,)
    force_mode: str = "fastpm"        # fastpm | pm | cola | za | 2lpt
    #                                   (zola = fastpm)
    kernel_type: str = "1_4"
    softening_type: str = "none"      # dealiasing_type in lua
    painter_type: str = "cic"
    painter_support: int = 2
    pm_nc_factor: object = 2          # scalar or [(a_start, factor), ...]
    lpt_nc_factor: float = 1.0
    use_shift: bool = False
    za: bool = False                  # ZA-only ICs (drop dx2)
    use_dx1_only: bool = False
    nLPT: float = -2.5
    # finite-ness scan of delta_k and acc after every force step
    # (pm_check_values, gravity.c:350-383), fetched one force later
    check_values: bool = False
    order_free: bool = True
    stale_every: int = 0
    # the potential and tidal tensor at the particles, scaled to the
    # reference's units in snapshots (solver.py:1582-1588); either one
    # routes the force through compute_force
    compute_potential: bool = False
    compute_tidal: bool = False
    # the rand column (subsampled snapshots, lightcone subsampling),
    # emulating the reference's streams of rand_ntask ranks
    need_rand: bool = False
    rand_ntask: int = 1
    rehome: bool = False
    # PGD correction (pgdcorrection.c)
    pgdc: bool = False
    pgdc_alpha0: float = 0.8
    pgdc_A: float = 4.0
    pgdc_B: float = 8.0
    pgdc_kl: float = 2.0
    pgdc_ks: float = 10.0

    def __post_init__(self):
        if self.force_mode == "zola":
            # lua maps zola to FASTPM_FORCE_FASTPM (lua-runtime-fastpm.lua:
            # force_mode.choices); the za flag is independent
            self.force_mode = "fastpm"
        if self.za:
            self.use_dx1_only = True
        if self.force_mode not in ("fastpm", "pm", "cola", "za", "2lpt"):
            raise ValueError(f"unknown force_mode {self.force_mode!r}")

    @property
    def vpm_table(self) -> List[Tuple[float, float]]:
        t = self.pm_nc_factor
        if np.isscalar(t):
            return [(0.0, float(t))]
        return [(float(a), float(f)) for a, f in t]


class Solver:
    """Holds the species stores, the PM hierarchy, cosmology, and events
    (FastPMSolver, solver.c:24-152) on one device: `device` when given,
    else the first CUDA device (raises when there is none).

    group: a torch.distributed process group over which the particles
    and the force are decomposed in x-slabs (one rank per device); None
    runs on one device alone. grid: a parallel.comm.Grid over the
    group instead; with py > 1, or on the 1 x 1 grid of one rank, the
    lattice is pencil-blocked for it and the force takes the pencil
    decomposition (solver.py:183-195). Every rank builds the same
    Solver."""

    @prof.clock("init")
    def __init__(self, config: SolverConfig,
                 cosmology: Optional[Cosmology] = None, device=None,
                 group=None, grid=None):
        self.device = resolve_device(device)
        if grid is not None and group is not None and group is not grid.group:
            raise ValueError("grid is over another group than `group`")
        self.ring = grid.flat if grid is not None else Ring(group)
        # what the force decomposes over: a grid with py > 1 or of one
        # rank (pencils), else the ring of every rank (x-slabs)
        self.comm = (grid if grid is not None
                     and (grid.py > 1 or grid.nproc == 1) else self.ring)
        self.config = config
        self.cosmology = cosmology if cosmology is not None else FIDUCIAL
        self.event_handlers = ev.EventHandlers()

        nc = config.nc
        box = config.boxsize
        dev = self.device
        self.basepm = PM(nc, box, device=dev)
        self.lptpm = PM(int(nc * config.lpt_nc_factor), box, device=dev)
        # variable-resolution force meshes (vpm.c:22-58)
        self.vpm_list = [(a_start, PM(int(nc * f), box, device=dev))
                         for a_start, f in config.vpm_table]

        # cola drifts and kicks with dx1 and dx2, za and 2lpt drift with
        # them (solver.py:173-174)
        self._keep_lpt = config.force_mode in ("cola", "za", "2lpt")
        shift = 0.5 * box / nc if config.use_shift else 0.0
        columns = (("v", "acc", "id")
                   + (("rand",) if config.need_rand else ())
                   + (("potential",) if config.compute_potential else ())
                   + (("tidal",) if config.compute_tidal else ()))
        # on a 2D grid the lattice is pencil-blocked, so that a rank's
        # rows are its pencil's particles
        blocks = None
        if self.comm is grid and nc % grid.px == 0 and nc % grid.py == 0:
            blocks = (grid.px, grid.py)
        # the columns the solver made and nobody outside has seen, by
        # (species, column), as weak references: a kick or a drift writes
        # such a column in place (see species)
        self._fresh = {}
        self._species: Dict[str, Store] = {CDM: lattice_store(
            self.basepm, Nc=nc, shift=shift, columns=columns, name="cdm",
            rand_ntask=config.rand_ntask, blocks=blocks).shard(self.ring)}
        # the neutrino linear-response state (setup_linear_response)
        self.lra = None
        self.pgd = None
        if config.pgdc:
            from .pgd import PGDCorrection
            self.pgd = PGDCorrection(
                alpha0=config.pgdc_alpha0, A=config.pgdc_A, B=config.pgdc_B,
                kl=config.pgdc_kl, ks=config.pgdc_ks,
                painter_type=config.painter_type,
                painter_support=config.painter_support)
            p = self._species[CDM]
            self._species[CDM] = p.replace(pgdc=torch.zeros_like(p.x))
        # deferred check_values flag of the last force (_settle_cv)
        self._cv_pending = None
        # the force engines (by mesh and decomposition) and measured halo
        # widths, per force mesh
        self._engines = {}
        self._halo = {}
        # force steps by the path they took
        self.force_paths = Counter()
        # the kicks and drifts of a species written in place
        self.in_place = Counter()
        # stale stepping: per force mesh, the stale forces since the last
        # carry force
        self._stale_since = {}

    @property
    def sharded(self) -> bool:
        """Whether the force runs over a process group (of one rank too)."""
        return self.ring.group is not None

    @property
    def species(self) -> Dict[str, Store]:
        """The species' stores by name. Whoever reads the table may keep
        a store, so reading it ends the solver's claim on every column:
        the next kick and drift of each species write new columns."""
        self._fresh.clear()
        return self._species

    def peek(self, name: str) -> Store:
        """The store of a species, for a read that keeps no reference to
        it or to its columns past the call (a summary); the solver goes
        on writing the columns it made in place."""
        return self._species[name]

    def _owns(self, name: str, column: str) -> bool:
        """Whether the solver made the current column of a species, and
        nobody outside has seen it since."""
        ref = self._fresh.get((name, column))
        return ref is not None and ref() is getattr(self._species[name],
                                                    column)

    def add_species(self, name: str, store: Store) -> None:
        """Add a species (one of SPECIES_ORDER) from every rank's full
        store; a rank keeps its block of the rows. On a grid the pencil
        force needs every species pencil-blocked for it (lattice_store's
        blocks), else the force takes the v1 body. Unlike the JAX
        package, which keeps a species of another name and leaves it out
        of every force, such a name raises ValueError."""
        if name not in SPECIES_ORDER:
            raise ValueError(f"unknown species {name!r}: the species are "
                             f"{', '.join(SPECIES_ORDER)}")
        self._species[name] = store.shard(self.ring)
        self._stale_since.clear()

    def global_count(self, name: str) -> int:
        """The number of particles of a species over every rank."""
        return int(self.ring.psum(self._species[name].count()))

    def iter_species(self):
        for name in SPECIES_ORDER:
            if name in self._species:
                yield name

    # ---- PM selection (vpm.c:9-20) ----

    def find_pm(self, a: float) -> PM:
        best = self.vpm_list[0][1]
        for a_start, pm in self.vpm_list:
            if a_start <= a:
                best = pm
        return best

    # ---- LPT setup (solver.c:154-233) ----

    @prof.clock("lpt")
    def setup_lpt(self, delta_k_ic, a0: float, species: str = CDM,
                  growth_rate_func_k=None) -> None:
        """2LPT initialization of a species from the z=0-normalized
        linear delta_k (complex64 on the lptpm mesh). Only CDM takes its
        M0 from Omega_cdm; with growth_rate_func_k (a FuncK of f(k)) the
        velocities come from the dv1 readouts (ncdm)."""
        cfg = self.config
        p = self._species[species]
        if species == CDM:
            p = p.replace(M0=self.cosmology.Omega_cdm * RHO_CRIT
                          * (cfg.boxsize / cfg.nc) ** 3)

        self.event_handlers.emit(ev.EVENT_LPT, ev.STAGE_BEFORE,
                                 solver=self, pm=self.lptpm,
                                 delta_k=delta_k_ic, store=p)
        if delta_k_ic is not None:
            # readout at the de-shifted particle positions (pm2lpt.c:27-34;
            # the de-shift uses the CDM-grid config shift)
            shift0 = 0.5 * cfg.boxsize / cfg.nc if cfg.use_shift else 0.0
            res = lpt_solve(self.lptpm, delta_k_ic.to(self.device),
                            p.x - _f32(shift0), cfg.kernel_type,
                            growth_rate_func_k)
            p = p.replace(**dict(zip(("dx1", "dx2", "dv1"), res)))
        if cfg.use_dx1_only and p.dx2 is not None:
            p = p.replace(dx2=torch.zeros_like(p.dx2))
        p = lpt_evolve(self.cosmology, a0, p, za_only=False)
        if not self._keep_lpt:
            p = p.replace(dx1=None, dx2=None, dv1=None)
        self._species[species] = p
        # new particles: no carried order to reuse (solver.py:299-302)
        self._stale_since.clear()
        self.event_handlers.emit(ev.EVENT_LPT, ev.STAGE_AFTER,
                                 solver=self, pm=self.lptpm,
                                 delta_k=delta_k_ic,
                                 store=self._species[species])

    # ---- factors (cached per step endpoints) ----

    def _kick_factor(self, ai, ac, af) -> KickFactor:
        return _cached_kick(self.cosmology, self.config.force_mode,
                            float(ai), float(ac), float(af), self.config.nLPT)

    def _drift_factor(self, ai, ac, af) -> DriftFactor:
        return _cached_drift(self.cosmology, self.config.force_mode,
                             float(ai), float(ac), float(af),
                             self.config.nLPT)

    # ---- actions ----

    def do_force(self, trans, states: StateTable, iend: int) -> None:
        pm = self.find_pm(trans.a_f)
        N = sum(self.global_count(n) for n in self.iter_species())
        a_n = states.find_next_force_time(iend)
        self.event_handlers.emit(
            ev.EVENT_FORCE, ev.STAGE_BEFORE, solver=self, pm=pm,
            a_f=trans.a_f, a_n=a_n, N=N, delta_k=None)
        # settle the PREVIOUS force's deferred finite-ness flag: the
        # host waits for the card there
        with prof.clock("force.wait"):
            self._settle_cv()
        delta_k, kpm = self.force(pm, trans.a_f)

        # compensate the CIC window so the event sees a de-aliased
        # spectrum (solver.c:466-471); skipped when nobody listens. On
        # several ranks the event sees the rank's k shard and its PM
        delta_k_decic = None
        if self.event_handlers.has(ev.EVENT_FORCE, ev.STAGE_AFTER):
            delta_k_decic = transfers.apply_decic(kpm, delta_k)
        del delta_k
        self.event_handlers.emit(
            ev.EVENT_FORCE, ev.STAGE_AFTER, solver=self, pm=kpm,
            a_f=trans.a_f, a_n=a_n, N=N, delta_k=delta_k_decic)

    def force(self, pm: PM, a_f: float):
        """The force on every species at a_f on the force mesh pm, with
        the neutrino linear response and PGD where they are on; the
        stores are replaced. Returns (the softened, transferred delta_k,
        its PM): over ranks the rank's k shard without the kz pad, and
        its KShard."""
        cfg = self.config
        painter = Painter(pm, cfg.painter_type, cfg.painter_support)
        # decompose analog: the periodic wrap (solver.c:571-592). The
        # solver lets go of the old stores so the cell sort's permuted
        # copy is the only one alive. A force starts with no claim on a
        # column: only the carry's sort makes them anew
        self._fresh.clear()
        names = list(self.iter_species())
        with prof.clock("force.wrap"):
            stores = [self._species.pop(n).wrap(pm.BoxSize) for n in names]
        lra = None
        if self.cosmology.ncdm_linearresponse:
            if self.lra is None:
                raise RuntimeError(
                    "the cosmology sets ncdm_linearresponse: call "
                    "Solver.setup_linear_response before the first force")

            # the linear response between the softening and the potential
            # kernel (gravity.c:431-455, 494-522): P(k) measured on kpm
            # (without the pencil's kz pad), the transfer applied on the
            # k shard of kfull
            def lra(kpm, kfull):
                def transfer(dk):
                    logk, vals, key = self._lra_table(
                        kpm, dk[:, :, :kpm.kshape[2]], a_f)
                    return transfers.apply_fk_interp(kfull, dk, logk, vals,
                                                     key)
                return transfer
        read = None
        if self.sharded:
            stores, delta_k, eng, H = self._sharded_force(pm, painter,
                                                          stores, lra)
            kpm = eng.kpm_out
            read = psolver.reader(eng, H, painter)
        else:
            kpm = pm
            transfer = lra(pm, pm) if lra is not None else None
            if cfg.order_free and carry_eligible(
                    painter, stores, cfg.compute_potential,
                    cfg.compute_tidal):
                stores, delta_k = self._carry_force(pm, painter, names[0],
                                                    stores.pop(), transfer)
            else:
                stores, delta_k = compute_force(pm, painter, stores,
                                                cfg.kernel_type,
                                                cfg.softening_type,
                                                cfg.compute_potential,
                                                cfg.compute_tidal, transfer)
                self.force_paths["multi"] += 1
        self._species.update(zip(names, stores))
        if cfg.check_values:
            # stays on the device until the next force or snapshot
            with prof.clock("force.check"):
                ok = torch.isfinite(torch.view_as_real(delta_k)).all()
                for p in stores:
                    ok = ok & torch.isfinite(p.acc).all()
                self._cv_pending = (self.ring.psum((~ok).to(torch.int32)),
                                    a_f)

        # the PGD correction from the softened, pre-decic delta_k
        # (solver.c:458-464), at the store's rows in their order after
        # the force; over ranks from the k shard with its pad, read out
        # as the force reads
        if self.pgd is not None:
            p = self._species[CDM]
            alpha = self.pgd.alpha(a_f)
            if read is None:
                pgdc = self.pgd.compute_with_alpha(pm, p.x, delta_k, alpha)
            else:
                pgdc = self.pgd.compute_local(eng, read, p.x, delta_k, alpha)
                if p.alive is not None:
                    # a dead row's position is stale
                    pgdc = pgdc * p.alive[:, None]
            self._species[CDM] = p.replace(pgdc=pgdc)
        return delta_k[:, :, :kpm.kshape[2]], kpm

    # ---- the neutrino linear response (gravity.c:457-529) ----

    def setup_linear_response(self, transfer_redshift: float,
                              transfer_file=None) -> None:
        """Enable the grid-based neutrino linear response: its transfer
        inputs are given at z = transfer_redshift, the neutrino to CDM
        transfer ratio read from transfer_file when one is given. Over
        ranks every rank keeps the same history."""
        from .neutrinos_lra import DeltaTotTable
        from .powerspectrum import FuncK
        t_init = FuncK.from_file(transfer_file) if transfer_file else None
        self.lra = DeltaTotTable(
            cosmology=self.cosmology,
            time_transfer=1.0 / (1 + transfer_redshift), t_init=t_init)

    def _lra_table(self, pm: PM, delta_k, a_f: float):
        """P_cdm of the softened delta_k (one small fetch of its bins;
        over ranks pm is the rank's k shard and the bins are summed over
        the ranks), the response history updated at a_f, and the step's
        transfer table (logk, vals) as float32 tensors on the device,
        with the host bytes of logk that name it (apply_fk_interp's
        key)."""
        from .powerspectrum import measure_power
        ps = measure_power(pm, delta_k,
                           ring=self.ring if self.sharded else None)
        delta_cdm = np.sqrt(np.maximum(ps.p, 0.0))
        good = ps.Nmodes > 0
        k = ps.k[good]
        nu_prefac, ratio = self.lra.update_from_power(k, delta_cdm[good],
                                                      a_f)
        logk = np.log(np.where(k > 0, k, 1e-10)).astype(np.float32)
        vals = np.asarray(nu_prefac) * np.asarray(ratio)
        dev = delta_k.device
        return (torch.from_numpy(logk).to(dev),
                torch.from_numpy(vals.astype(np.float32)).to(dev),
                logk.tobytes())

    def _carry_force(self, pm: PM, painter: Painter, name: str,
                     store: Store, transfer=None):
        """The order-free force of one species on one device: fresh (with
        the sort), or stale when stale_every allows it for this force
        mesh. The sort makes every column anew, so the solver claims x
        and v for the kick and drift to write in place. Returns ([store],
        delta_k)."""
        cfg = self.config
        since = self._stale_since.get(pm.Nmesh)
        if since is not None and since < cfg.stale_every - 1:
            p, delta_k = compute_force_stale(pm, painter, store,
                                             cfg.kernel_type,
                                             cfg.softening_type, transfer)
            self._stale_since[pm.Nmesh] = since + 1
            self.force_paths["stale"] += 1
        else:
            # force() let go of the store: it is sorted in itself
            p, delta_k = compute_force_carry(pm, painter, store,
                                             cfg.kernel_type,
                                             cfg.softening_type, transfer,
                                             donate=True)
            for c in ("x", "v"):
                self._fresh[name, c] = weakref.ref(getattr(p, c))
            if cfg.stale_every > 1:
                self._stale_since[pm.Nmesh] = 0
            self.force_paths["carry"] += 1
        return [p], delta_k

    # ---- the force over the ranks (parallel/psolver.py) ----

    def _engine(self, pm: PM, pencil: bool):
        """The distributed FFT engine of a force mesh: PencilPM over the
        grid, or SlabPM over every rank (pfft.py:55-65 picks by the
        mesh's axes)."""
        key = (pm.Nmesh, pencil)
        eng = self._engines.get(key)
        if eng is None:
            eng = self._engines[key] = (PencilPM(pm, self.comm) if pencil
                                        else SlabPM(pm, self.ring))
        return eng

    def _halo_key(self, pm: PM, stores):
        """The key of a force mesh's halo width: the rehomed layout's is
        kept apart from the dense one's."""
        return (("rehome", pm.Nmesh) if stores[0].alive is not None
                else pm.Nmesh)

    def _pick_halo(self, pm: PM, painter: Painter, stores):
        """The homed force's halo for this force mesh (None: the v1
        force, or for a rehomed store the dense one; ("pencil", Hx, Hy):
        the pencil force; an int: the slab force): measured once, with
        one plane of slack (psolver.pick_halo, pick_halo_rehomed), and
        kept until a force overflows it. The homed paint is CIC only."""
        key = self._halo_key(pm, stores)
        if key not in self._halo:
            if stores[0].alive is not None:
                H = psolver.pick_halo_rehomed(pm, self.ring, stores[0])
            elif painter.type == "cic" and painter.diffdir < 0:
                H = psolver.pick_halo(pm, self.comm, [p.x for p in stores],
                                      [p.home_blocks for p in stores])
            else:
                H = None
            self._halo[key] = H
        return self._halo[key]

    def _rehome_ok(self, pm: PM, painter: Painter, stores, lra) -> bool:
        """Whether the rehome body serves this force (solver.py:613-625):
        rehome asked for, the slab carry's case (one scalar-mass species
        with velocities on x-major rows, the CIC painter, neither the
        potential nor the tidal tensor), order_free on, no linear
        response (whose force the JAX package never rehomes), and slabs
        of at least 4 planes."""
        cfg = self.config
        P = self.ring.nproc
        n0, n1, _ = pm.Nmesh
        return bool(cfg.rehome and cfg.order_free and lra is None
                    and self.comm is self.ring
                    and carry_eligible(painter, stores, cfg.compute_potential,
                                       cfg.compute_tidal)
                    and stores[0].v is not None
                    and stores[0].home_blocks is None
                    and n0 % P == 0 and n1 % P == 0 and n0 // P >= 4)

    def _to_rehomed(self, p: Store, pm: PM) -> Store:
        """The rehomed layout of a dense store (solver.py:335-379): each
        rank keeps R = cap + 2B rows, first the particles whose position
        lies in its x-slab (alive), then dead rows of zeros. The rows go
        to their owners in one all_to_all (every column in its dtype);
        cap and B follow the fullest rank's count n (B = max(2048, n /
        32) and cap = 1.1 n + B, each rounded up to 256 rows), so that
        every rank has the same R."""
        ring = self.ring
        n0 = pm.Nmesh[0]
        nloc = n0 // ring.nproc
        b = torch.remainder(torch.floor(
            p.x[:, 0] * float(np.float32(pm.InvCellSize[0]))).to(
                torch.int64), n0)
        owner = b // nloc
        counts = torch.bincount(owner, minlength=ring.nproc).tolist()
        p = p.take(torch.sort(owner, stable=True).indices)
        cols = {c: ring.exchange_rows(t, counts) for c, t in p.columns()}
        n = cols["x"].shape[0]
        per = int(ring.pmax(torch.tensor([n], device=p.x.device)))
        B = int(np.ceil(max(2048, per / 32) / 256.0) * 256)
        cap = int(np.ceil((per * 1.10 + B) / 256.0) * 256)
        R = cap + 2 * B

        def padded(t):
            out = t.new_zeros((R,) + tuple(t.shape[1:]))
            out[:n] = t
            return out

        alive = torch.zeros(R, dtype=torch.uint8, device=p.x.device)
        alive[:n] = 1
        return p.replace(alive=alive, rehome_bucket=B,
                         **{c: padded(t) for c, t in cols.items()})

    def _sharded_force(self, pm: PM, painter: Painter, stores, lra=None):
        """The force over the ranks; returns (stores with acc, and the
        potential and tidal tensor where asked, filled; this rank's
        delta_k shard, the pencil's kz pad kept; the engine; the halo
        the force took). lra(kpm, kfull), when given, makes the linear
        response's transfer hook for an engine's k shard. A homed force
        that finds a particle beyond its halo is discarded: the halo is
        measured again from the same positions and the force run again;
        a rehomed store whose force overflowed is converted anew."""
        cfg = self.config
        pot, tid = cfg.compute_potential, cfg.compute_tidal
        rehome = self._rehome_ok(pm, painter, stores, lra)
        if rehome and stores[0].alive is None:
            stores = [self._to_rehomed(stores[0], pm)]
        elif not rehome and stores[0].alive is not None:
            stores = [stores[0].compact()]

        def filled(outs):
            # a species without the column allocated keeps it None
            return [p.replace(**{k: v for k, v in o.items()
                                 if k == "acc" or getattr(p, k) is not None})
                    for p, o in zip(stores, outs)]

        while True:
            H = self._pick_halo(pm, painter, stores)
            rehomed = stores[0].alive is not None
            if rehomed and H is None:
                # no migration-legal halo: the dense store
                stores = [stores[0].compact()]
                continue
            pencil = isinstance(H, tuple)
            xs = [p.x for p in stores]
            masses = [p.mass if p.mass is not None
                      else float(np.float32(p.M0)) for p in stores]
            if H is None:
                eng = self._engine(pm, self.comm is not self.ring)
                outs, delta_k = psolver._force_local_multi(
                    eng, painter, xs, masses, cfg.kernel_type,
                    cfg.softening_type, pot, tid,
                    transfer=lra(eng.kpm_out, eng.kpm) if lra else None)
                out, path, bad = filled(outs), "v1", 0
            elif rehomed:
                eng = self._engine(pm, False)
                p, bad, delta_k = psolver._force_local_homed_rehome(
                    eng, stores[0], cfg.kernel_type, H, cfg.softening_type)
                out, path = [p], "homed-rehome"
            else:
                eng = self._engine(pm, pencil)
                transfer = lra(eng.kpm_out, eng.kpm) if lra else None
                if pencil:
                    carry = psolver._force_local_homed_pencil_carry
                    multi = psolver._force_local_homed_pencil_multi
                    halo = H[1:]
                else:
                    carry = psolver._force_local_homed_carry
                    multi = psolver._force_local_homed_multi
                    halo = (H,)
                if cfg.order_free and carry_eligible(painter, stores,
                                                     pot, tid):
                    p, bad, delta_k = carry(eng, stores[0], cfg.kernel_type,
                                            *halo, cfg.softening_type,
                                            transfer=transfer)
                    out, path = [p], "carry"
                else:
                    outs, bad, delta_k = multi(
                        eng, xs, masses, cfg.kernel_type, *halo,
                        cfg.softening_type, compute_potential=pot,
                        compute_tidal=tid, transfer=transfer)
                    out, path = (filled(outs) if outs is not None
                                 else None), "multi"
                path = ("pencil-" if pencil else "homed-") + path
            if int(bad) == 0:
                self.force_paths[path] += 1
                return out, delta_k, eng, H
            # the overflow contract (store.c:507-509): measure again; a
            # rehomed store may have overflowed its halo, a bucket or its
            # capacity, and a conversion sizes all three anew
            self.force_paths["overflow"] += 1
            del self._halo[self._halo_key(pm, stores)]
            if rehomed:
                stores = [self._to_rehomed(stores[0].compact(), pm)]

    def kick_one(self, p: Store, kick: KickFactor, af: float,
                 donate: bool = False) -> Store:
        """Apply a kick to a store (fastpm_kick_store, factors.c:147-197):
        cola adds the LPT terms. Each product and sum rounds once, in the
        JAX package's order, with float32 coefficients. donate: the
        caller gives p's velocity up, and the new one is written into it;
        otherwise into a copy. The same bits either way."""
        dda, Dv1, Dv2 = (_f32(c) for c in kick.coefficients(p.a_v, af))
        v = p.v if donate else p.v.clone()
        if kick.force_mode == "cola":
            # a sum's operands commute bit for bit, so t += acc is
            # acc + t; one temporary column besides the products
            t = p.dx1 * _f32(kick.q1)
            t.add_(p.acc).add_(p.dx2 * _f32(kick.q2)).mul_(dda)
            v.add_(t).add_(p.dx1 * Dv1).add_(p.dx2 * Dv2)
            del t
        else:
            v.add_(p.acc * dda)
        if donate:
            self.in_place["kick"] += 1
        return p.replace(v=v, a_v=float(af))

    def drift_one(self, p: Store, drift: DriftFactor, af: float,
                  donate: bool = False) -> Store:
        """Apply a drift to a store (fastpm_drift_one, factors.c:72-115):
        za and 2lpt move by the LPT displacements, cola by both, and the
        PGD displacement rides the drift of fastpm, pm and cola over a
        nonzero interval (factors.c:108-113). donate: as kick_one's, for
        the position."""
        dyyy, da1, da2 = drift.coefficients(p.a_x, af)
        mode = drift.force_mode
        pgd = p.pgdc is not None and drift.ai != drift.af
        fac = _f32(0.5 * dyyy / drift.dyyy[-1]) if pgd else 0.0
        dyyy, da1, da2 = _f32(dyyy), _f32(da1), _f32(da2)
        x = p.x if donate else p.x.clone()
        if mode in ("2lpt", "za"):
            x.add_(p.dx1 * da1)
            if mode == "2lpt":
                x.add_(p.dx2 * da2)
        else:
            if mode == "cola":
                # x + (v - dx1 Dv1 - dx2 Dv2) dyyy + dx1 da1 + dx2 da2
                w = p.dx1 * _f32(drift.Dv1)
                torch.sub(p.v, w, out=w)
                w.sub_(p.dx2 * _f32(drift.Dv2)).mul_(dyyy)
                x.add_(w).add_(p.dx1 * da1).add_(p.dx2 * da2)
                del w
            else:
                x.add_(p.v * dyyy)
            if pgd:
                x.add_(p.pgdc * fac)
        if donate:
            self.in_place["drift"] += 1
        return p.replace(x=x, a_x=float(af))

    def do_kick(self, trans, states: StateTable, iend: int) -> None:
        kick = self._kick_factor(trans.a_i, trans.a_r, trans.a_f)
        end = states.table[iend]
        if end[1] == end[2]:  # x and v synced after this kick
            dual = states.find_dual(iend - 1, ACTION_KICK)
            if dual is None:
                raise RuntimeError("dual transition not found")
            drift = self._drift_factor(dual.a_i, dual.a_r, dual.a_f)
            self._do_interpolation(drift, kick, trans.a_i, trans.a_f,
                                   ev.TIMESTEP_CUR)
        for name in self.iter_species():
            p = self._species[name]
            if abs(kick.ai - p.a_v) > 1e-12 or abs(kick.ac - p.a_x) > 1e-12:
                raise RuntimeError("kick is inconsistent with state")
            self._species[name] = self.kick_one(
                p, kick, trans.a_f, donate=self._owns(name, "v"))

    def do_drift(self, trans, states: StateTable, iend: int) -> None:
        drift = self._drift_factor(trans.a_i, trans.a_r, trans.a_f)
        end = states.table[iend]
        if end[1] == end[2]:
            dual = states.find_dual(iend - 1, ACTION_DRIFT)
            if dual is None:
                raise RuntimeError("dual transition not found")
            kick = self._kick_factor(dual.a_i, dual.a_r, dual.a_f)
            self._do_interpolation(drift, kick, trans.a_i, trans.a_f,
                                   ev.TIMESTEP_CUR)
        for name in self.iter_species():
            p = self._species[name]
            if abs(drift.ai - p.a_x) > 1e-12 or abs(drift.ac - p.a_v) > 1e-12:
                raise RuntimeError("drift is inconsistent with state")
            self._species[name] = self.drift_one(
                p, drift, trans.a_f, donate=self._owns(name, "x"))

    def _settle_cv(self) -> None:
        """Deferred check_values fetch; raises like fastpm_raise
        (logging.c:24-35) if the force went non-finite."""
        pending = self._cv_pending
        if pending is None:
            return
        self._cv_pending = None
        flag, a_f = pending
        if bool(flag):
            raise FloatingPointError(
                "force produced non-finite values (delta_k or acc) "
                f"at a_f={a_f}")

    def _do_interpolation(self, drift, kick, a1, a2, whence):
        # snapshots must never consume an unverified force result
        self._settle_cv()
        self.event_handlers.emit(
            ev.EVENT_INTERPOLATION, ev.STAGE_BEFORE, solver=self,
            drift=drift, kick=kick, a1=a1, a2=a2, whence=whence)

    # ---- evolution (solver.c:282-356) ----

    def evolve(self, time_step: Optional[Sequence[float]] = None) -> None:
        cfg = self.config
        ts = list(time_step if time_step is not None else cfg.time_step)

        # warmup: zero acc (solver.c:380-394)
        for name in self.iter_species():
            p = self._species[name]
            if p.acc is not None:
                self._species[name] = p.replace(acc=torch.zeros_like(p.acc))

        states = StateTable(ts)
        for i in range(1, len(states.table)):
            trans = states.transition(i - 1, i)
            self.event_handlers.emit(ev.EVENT_TRANSITION, ev.STAGE_BEFORE,
                                     solver=self, transition=trans)
            if trans.action == ACTION_KICK:
                with prof.clock("kick"):
                    self.do_kick(trans, states, i)
            elif trans.action == ACTION_DRIFT:
                with prof.clock("drift"):
                    self.do_drift(trans, states, i)
            elif trans.action == ACTION_FORCE:
                with prof.clock("force"):
                    self.do_force(trans, states, i)
            self.event_handlers.emit(ev.EVENT_TRANSITION, ev.STAGE_AFTER,
                                     solver=self, transition=trans)
            if i == 1:
                # initial interpolation event (solver.c:334-345)
                a0 = ts[0]
                self._do_interpolation(self._drift_factor(a0, a0, a0),
                                       self._kick_factor(a0, a0, a0),
                                       a0, a0, ev.TIMESTEP_START)
        a1 = ts[-1]
        self._do_interpolation(self._drift_factor(a1, a1, a1),
                               self._kick_factor(a1, a1, a1),
                               a1, a1, ev.TIMESTEP_END)

    # ---- snapshots (solver.c:594-759) ----

    def set_snapshot(self, p: Store, drift: DriftFactor, kick: KickFactor,
                     aout: float) -> Store:
        """Interpolate a species to aout and convert units: internal
        velocity -> peculiar km/s, potential and tidal tensor ->
        dimensionless (fastpm_set_species_snapshot)."""
        po = p.compact()
        if drift is not None:
            po = self.drift_one(po, drift, aout)   # uses the OLD velocity
        if kick is not None:
            po = self.kick_one(po, kick, aout)
        potfactor = _f32(1.5 * self.cosmology.Omega_source(1.0)
                         / HUBBLE_DISTANCE ** 2 / aout)
        updates = dict(v=po.v * _f32(HUBBLE_CONSTANT / aout))
        for name in ("potential", "tidal"):
            if getattr(po, name) is not None:
                updates[name] = getattr(po, name) * potfactor
        return po.replace(**updates).wrap(self.basepm.BoxSize)


@lru_cache(maxsize=4096)
def _cached_kick(c, mode, ai, ac, af, nLPT):
    return KickFactor(c, mode, ai, ac, af, nLPT)


@lru_cache(maxsize=4096)
def _cached_drift(c, mode, ai, ac, af, nLPT):
    return DriftFactor(c, mode, ai, ac, af, nLPT)

