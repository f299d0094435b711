"""The FastPM solver: species, time evolution, events
(reference: libfastpm/solver.c, vpm.c).

Port of fastpm_tpu/solver.py: the CDM and ncdm species, force modes
fastpm and pm, the variable-resolution force mesh (VPM) table, and the
reference's event architecture (events fire between the kick / drift /
force actions), on one device or on the slab decomposition over the
ranks of a torch.distributed process group.

On one rank the force step is gravity.compute_force_carry for one
scalar-mass species and gravity.compute_force (every species into one
canvas) otherwise. With stale_every = N > 1, N - 1 of every N carry
forces are stale (gravity.compute_force_stale: the carried order, no
sort; solver.py:548-572). On several, each rank holds a contiguous block of
every species' rows (Store.shard) and the force is the homed slab force
of parallel/psolver.py: the order-free carry for one scalar-mass species
with the CIC painter, the multi-species body otherwise, and the v1
full-canvas force when no halo width fits (solver.py:589-876). The halo
width is measured, kept while it holds, and measured again when a force
finds a particle beyond it; that force is then run again, so no result
with a particle beyond the halo is ever used (solver.py:1332-1368).

Not in this slice (NotImplementedError; see ROADMAP.md): force modes
cola, za and 2lpt, rehome, PGD, the neutrino linear response, baryons,
and the pencil (2D) decomposition.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

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
from .parallel.pfft import SlabPM
from .parallel import psolver
from . import transfers, events as ev
from .units import RHO_CRIT, HUBBLE_CONSTANT

__all__ = ["SolverConfig", "Solver", "CDM", "BARYON", "NCDM",
           "SPECIES_ORDER"]

BARYON = "baryon"
CDM = "cdm"
NCDM = "ncdm"
SPECIES_ORDER = (BARYON, CDM, NCDM)

_LATER = "is not in this slice of the port (see ROADMAP.md)"


def _f32(a: float) -> float:
    """A coefficient rounded to float32, as the reference's float
    arithmetic sees it."""
    return float(np.float32(a))


@dataclass
class SolverConfig:
    """Mirror of FastPMConfig (api/fastpm/solver.h) with lua-schema
    defaults (src/lua-runtime-fastpm.lua), restricted to what this
    slice serves. rehome and pgdc keep the JAX package's names so that
    asking for them fails loudly.

    stale_every: with N > 1, on one device, N - 1 of every N carry forces
    reuse the carried order of the one before (no environment default,
    unlike the JAX package's FASTPM_TPU_STALE); the sharded and
    multi-species forces ignore it."""

    nc: int
    boxsize: float
    time_step: Sequence[float] = (1.0,)
    force_mode: str = "fastpm"        # fastpm | pm (zola = fastpm)
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
    stale_every: int = 0
    rehome: bool = False
    pgdc: bool = False

    def __post_init__(self):
        if self.force_mode == "zola":
            # lua maps zola to FASTPM_FORCE_FASTPM (lua-runtime-fastpm.lua:
            # force_mode.choices); the za flag is independent
            self.force_mode = "fastpm"
        if self.za:
            self.use_dx1_only = True
        if self.force_mode not in ("fastpm", "pm"):
            raise NotImplementedError(
                f"force_mode {self.force_mode!r} {_LATER}")
        for name, on in (("rehome", self.rehome), ("PGD", self.pgdc)):
            if on:
                raise NotImplementedError(f"{name} {_LATER}")

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
    runs on one device alone. Every rank builds the same Solver."""

    def __init__(self, config: SolverConfig,
                 cosmology: Optional[Cosmology] = None, device=None,
                 group=None):
        self.device = resolve_device(device)
        self.ring = Ring(group)
        self.config = config
        self.cosmology = cosmology if cosmology is not None else FIDUCIAL
        if self.cosmology.ncdm_linearresponse:
            raise NotImplementedError(f"the neutrino linear response {_LATER}")
        self.event_handlers = ev.EventHandlers()

        nc = config.nc
        box = config.boxsize
        dev = self.device
        self.basepm = PM(nc, box, device=dev)
        self.lptpm = PM(int(nc * config.lpt_nc_factor), box, device=dev)
        # variable-resolution force meshes (vpm.c:22-58)
        self.vpm_list = [(a_start, PM(int(nc * f), box, device=dev))
                         for a_start, f in config.vpm_table]

        shift = 0.5 * box / nc if config.use_shift else 0.0
        self.species: Dict[str, Store] = {CDM: lattice_store(
            self.basepm, Nc=nc, shift=shift, columns=("v", "acc", "id"),
            name="cdm").shard(self.ring)}
        # deferred check_values flag of the last force (_settle_cv)
        self._cv_pending = None
        # the slab engines and measured halo widths, per force mesh
        self._slab_pms = {}
        self._halo = {}
        # force steps by the path they took
        self.force_paths = Counter()
        # stale stepping: per force mesh, the stale forces since the last
        # carry force
        self._stale_since = {}

    @property
    def sharded(self) -> bool:
        return self.ring.nproc > 1

    def add_species(self, name: str, store: Store) -> None:
        """Add a species from every rank's full store; a rank keeps its
        block of the rows."""
        if name not in (CDM, NCDM):
            raise NotImplementedError(f"species {name!r} {_LATER}")
        self.species[name] = store.shard(self.ring)
        self._stale_since.clear()

    def global_count(self, name: str) -> int:
        """The number of particles of a species over every rank."""
        return int(self.ring.psum(self.species[name].np_local))

    def iter_species(self):
        for name in SPECIES_ORDER:
            if name in self.species:
                yield name

    # ---- PM selection (vpm.c:9-20) ----

    def find_pm(self, a: float) -> PM:
        best = self.vpm_list[0][1]
        for a_start, pm in self.vpm_list:
            if a_start <= a:
                best = pm
        return best

    # ---- LPT setup (solver.c:154-233) ----

    def setup_lpt(self, delta_k_ic, a0: float, species: str = CDM,
                  growth_rate_func_k=None) -> None:
        """2LPT initialization of a species from the z=0-normalized
        linear delta_k (complex64 on the lptpm mesh). Only CDM takes its
        M0 from Omega_cdm; with growth_rate_func_k (a FuncK of f(k)) the
        velocities come from the dv1 readouts (ncdm)."""
        cfg = self.config
        p = self.species[species]
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
        self.species[species] = p.replace(dx1=None, dx2=None, dv1=None)
        # new particles: no carried order to reuse (solver.py:299-302)
        self._stale_since.clear()
        self.event_handlers.emit(ev.EVENT_LPT, ev.STAGE_AFTER,
                                 solver=self, pm=self.lptpm,
                                 delta_k=delta_k_ic,
                                 store=self.species[species])

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
        cfg = self.config
        pm = self.find_pm(trans.a_f)
        painter = Painter(pm, cfg.painter_type, cfg.painter_support)
        N = sum(self.global_count(n) for n in self.iter_species())
        a_n = states.find_next_force_time(iend)
        self.event_handlers.emit(
            ev.EVENT_FORCE, ev.STAGE_BEFORE, solver=self, pm=pm,
            a_f=trans.a_f, a_n=a_n, N=N, delta_k=None)
        # settle the PREVIOUS force's deferred finite-ness flag
        self._settle_cv()

        # decompose analog: the periodic wrap (solver.c:571-592). The
        # solver lets go of the old stores so the cell sort's permuted
        # copy is the only one alive
        names = list(self.iter_species())
        stores = [self.species.pop(n).wrap(pm.BoxSize) for n in names]
        kpm = pm
        if self.sharded:
            stores, delta_k = self._sharded_force(pm, painter, stores)
            kpm = self._slab_pm(pm).kpm
        elif carry_eligible(painter, stores):
            stores, delta_k = self._carry_force(pm, painter, stores.pop())
        else:
            stores, delta_k = compute_force(pm, painter, stores,
                                            cfg.kernel_type,
                                            cfg.softening_type)
            self.force_paths["multi"] += 1
        self.species.update(zip(names, stores))
        if cfg.check_values:
            # stays on the device until the next force or snapshot
            ok = torch.isfinite(torch.view_as_real(delta_k)).all()
            for p in stores:
                ok = ok & torch.isfinite(p.acc).all()
            self._cv_pending = (self.ring.psum((~ok).to(torch.int32)),
                                trans.a_f)

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

    def _carry_force(self, pm: PM, painter: Painter, store: Store):
        """The order-free force of one species on one device: fresh (with
        the sort), or stale when stale_every allows it for this force
        mesh. Returns ([store], delta_k)."""
        cfg = self.config
        since = self._stale_since.get(pm.Nmesh)
        if since is not None and since < cfg.stale_every - 1:
            p, delta_k = compute_force_stale(pm, painter, store,
                                             cfg.kernel_type,
                                             cfg.softening_type)
            self._stale_since[pm.Nmesh] = since + 1
            self.force_paths["stale"] += 1
        else:
            p, delta_k = compute_force_carry(pm, painter, store,
                                             cfg.kernel_type,
                                             cfg.softening_type)
            if cfg.stale_every > 1:
                self._stale_since[pm.Nmesh] = 0
            self.force_paths["carry"] += 1
        return [p], delta_k

    # ---- the slab force over the ranks (parallel/psolver.py) ----

    def _slab_pm(self, pm: PM) -> SlabPM:
        spm = self._slab_pms.get(pm.Nmesh)
        if spm is None:
            spm = self._slab_pms[pm.Nmesh] = SlabPM(pm, self.ring)
        return spm

    def _pick_halo(self, pm: PM, painter: Painter, stores):
        """The homed force's halo width for this force mesh (None: the v1
        force): measured once, with one plane of slack
        (psolver.pick_halo), and kept until a force overflows it. The
        homed paint is CIC only."""
        if pm.Nmesh not in self._halo:
            self._halo[pm.Nmesh] = (
                psolver.pick_halo(pm, self.ring, [p.x for p in stores])
                if painter.type == "cic" and painter.diffdir < 0 else None)
        return self._halo[pm.Nmesh]

    def _sharded_force(self, pm: PM, painter: Painter, stores):
        """The force over the ranks; returns (stores with acc filled,
        this rank's delta_k shard). A homed force that finds a particle
        beyond its halo is discarded: the halo is measured again from
        the same positions and the force run again."""
        cfg = self.config
        spm = self._slab_pm(pm)
        xs = [p.x for p in stores]
        masses = [p.mass if p.mass is not None else float(np.float32(p.M0))
                  for p in stores]
        while True:
            H = self._pick_halo(pm, painter, stores)
            if H is None:
                accs, delta_k = psolver._force_local_multi(
                    spm, painter, xs, masses, cfg.kernel_type,
                    cfg.softening_type)
                self.force_paths["v1"] += 1
                return ([p.replace(acc=a) for p, a in zip(stores, accs)],
                        delta_k)
            if carry_eligible(painter, stores):
                p, bad, delta_k = psolver._force_local_homed_carry(
                    spm, stores[0], cfg.kernel_type, H, cfg.softening_type)
                out, path = [p], "homed-carry"
            else:
                accs, bad, delta_k = psolver._force_local_homed_multi(
                    spm, xs, masses, cfg.kernel_type, H,
                    cfg.softening_type)
                out = [p.replace(acc=a) for p, a in zip(stores, accs)]
                path = "homed-multi"
            if int(bad) == 0:
                self.force_paths[path] += 1
                return out, delta_k
            # the overflow contract (store.c:507-509): measure again
            self.force_paths["overflow"] += 1
            del self._halo[pm.Nmesh]

    def kick_one(self, p: Store, kick: KickFactor, af: float) -> Store:
        """Apply a kick to a store (fastpm_kick_store, factors.c:147-197)."""
        dda, _Dv1, _Dv2 = kick.coefficients(p.a_v, af)
        return p.replace(v=p.v + p.acc * _f32(dda), a_v=float(af))

    def drift_one(self, p: Store, drift: DriftFactor, af: float) -> Store:
        """Apply a drift to a store (fastpm_drift_one, factors.c:72-115)."""
        dyyy, _da1, _da2 = drift.coefficients(p.a_x, af)
        return p.replace(x=p.x + p.v * _f32(dyyy), a_x=float(af))

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
            p = self.species[name]
            if abs(kick.ai - p.a_v) > 1e-12 or abs(kick.ac - p.a_x) > 1e-12:
                raise RuntimeError("kick is inconsistent with state")
            self.species[name] = self.kick_one(p, kick, trans.a_f)

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
            p = self.species[name]
            if abs(drift.ai - p.a_x) > 1e-12 or abs(drift.ac - p.a_v) > 1e-12:
                raise RuntimeError("drift is inconsistent with state")
            self.species[name] = self.drift_one(p, drift, trans.a_f)

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
            p = self.species[name]
            if p.acc is not None:
                self.species[name] = p.replace(acc=torch.zeros_like(p.acc))

        states = StateTable(ts)
        for i in range(1, len(states.table)):
            trans = states.transition(i - 1, i)
            self.event_handlers.emit(ev.EVENT_TRANSITION, ev.STAGE_BEFORE,
                                     solver=self, transition=trans)
            if trans.action == ACTION_KICK:
                self.do_kick(trans, states, i)
            elif trans.action == ACTION_DRIFT:
                self.do_drift(trans, states, i)
            elif trans.action == ACTION_FORCE:
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
        """Interpolate a species to aout and convert the internal velocity
        to peculiar km/s (fastpm_set_species_snapshot)."""
        po = p.compact()
        if drift is not None:
            po = self.drift_one(po, drift, aout)   # uses the OLD velocity
        if kick is not None:
            po = self.kick_one(po, kick, aout)
        po = po.replace(v=po.v * _f32(HUBBLE_CONSTANT / aout))
        return po.wrap(self.basepm.BoxSize)


@lru_cache(maxsize=4096)
def _cached_kick(c, mode, ai, ac, af, nLPT):
    return KickFactor(c, mode, ai, ac, af, nLPT)


@lru_cache(maxsize=4096)
def _cached_drift(c, mode, ai, ac, af, nLPT):
    return DriftFactor(c, mode, ai, ac, af, nLPT)
