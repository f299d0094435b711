"""Particle lightcone ("unstructured mesh", reference:
libfastpm/lightcone-usmesh.c, horizon.c, spherebox.h).

Port of fastpm_tpu/lightcone.py. During every drift interval [a1, a2]
the crossing |glmatrix (x(a) + tileshift)| = xi(a) is solved per
(particle, tile) on the rows' device: both ends of the interval are
evaluated for every row, the rows with a root in [a1, a2) are compacted,
and only those run a 30-step bisection. Crossing particles are recorded
with their position in observer coordinates, their peculiar velocity
(km/s) kicked to a_emit, aemit, id and rand; box tiling provides the
periodic replicas, and shells are culled against each tile's bounding
box.

The slice counts that the reference's goldens pin depend on float32
rounding at the interval ends (which side of a boundary a tangent
crossing's f lands on). Every step below is one PyTorch operation that
rounds once, in the JAX package's order: nothing is fused into an
addcmul or lerp, and the interval width dai comes from host float64.
x @ M.T runs in full float32 (torch.backends.cuda.matmul.allow_tf32
stays False, its default); for the identity glmatrix of the fixtures it
is exact.

Every force mode: fastpm and pm drift with v, za and 2lpt with the LPT
displacements, cola with both; the PGD displacement rides the drift
when the store has it (lightcone.py:213-256 of the JAX package).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from .cosmology import Cosmology
from .kdk import DriftFactor, KickFactor, NSAMPLES
from .store import Store
from .units import HUBBLE_DISTANCE, HUBBLE_CONSTANT
from . import events as ev

__all__ = ["Horizon", "LightCone", "USMesh", "volume_density_from_ell"]

_MODES = ("fastpm", "pm", "cola", "za", "2lpt")
_OCTANT_SIGNS = [(1, 1, 1), (1, 1, -1), (1, -1, 1), (1, -1, -1),
                 (-1, 1, 1), (-1, 1, -1), (-1, -1, 1), (-1, -1, -1)]


def _f32(a: float) -> float:
    """A host float rounded to float32 (the JAX package's jnp.float32
    scalars); torch applies it to float32 tensors without more rounding."""
    return float(np.float32(a))


class Horizon:
    """8192-entry lookup table of comoving distance xi(a) * dh_factor
    (horizon.c:10-26), with linear interpolation. The reference's D1(a)
    table has no reader in the port, so it is not built."""

    SIZE = 8192

    def __init__(self, cosmology: Cosmology, dh_factor: float = 1.0):
        self.cosmology = cosmology
        self.dh_factor = dh_factor
        a = np.linspace(0.0, 1.0, self.SIZE)
        # cumulative integral chi(a) = int_a^1 da'/(a'^2 E) by
        # per-interval Gauss-Legendre (interior nodes avoid the a=0
        # singularity)
        xg, wg = np.polynomial.legendre.leggauss(8)
        mid = 0.5 * (a[1:] + a[:-1])
        half = 0.5 * np.diff(a)
        nodes = mid[:, None] + half[:, None] * xg[None, :]
        E = np.array([cosmology.E(float(v)) for v in nodes.ravel()])
        integ = (1.0 / (nodes.ravel() ** 2 * E)).reshape(nodes.shape)
        seg = (integ * wg[None, :]).sum(axis=1) * half
        chi = np.concatenate([[0.0], np.cumsum(seg[::-1])])[::-1]
        self.xi_a = dh_factor * HUBBLE_DISTANCE * chi
        self._xi_dev = {}

    def distance(self, a):
        """xi at a (vectorized, host float64)."""
        x = np.asarray(a, dtype=np.float64) * (self.SIZE - 1)
        l = np.clip(np.floor(x).astype(int), 0, self.SIZE - 2)
        return self.xi_a[l] * (l + 1 - x) + self.xi_a[l + 1] * (x - l)

    def distance_device(self, a: torch.Tensor) -> torch.Tensor:
        """xi at a float32 tensor a, in float32 on its device
        (distance_jax: the float32 table, one rounding per step)."""
        xi = self._xi_dev.get(a.device)
        if xi is None:
            xi = self._xi_dev[a.device] = torch.from_numpy(
                self.xi_a.astype(np.float32)).to(a.device)
        x = a * (self.SIZE - 1)
        l = torch.clamp(torch.floor(x).to(torch.int64), 0, self.SIZE - 2)
        u = (l + 1).to(a.dtype) - x
        return xi[l] * u + xi[l + 1] * (1.0 - u)


def volume_density_from_ell(ell_lim: float, z: float,
                            horizon: Horizon) -> float:
    """Particle number density [1/(Mpc/h)^3] resolving multipole ell
    (horizon.c:150-158)."""
    theta_lim = math.pi / ell_lim
    r = float(horizon.distance(1.0 / (1 + z)))
    s_lim = r * theta_lim
    if s_lim == 0.0:
        # z = 0: the C reference computes pow(1/0., 3) = inf (the
        # subsample fraction then clamps to 1: keep everything)
        return math.inf
    return (1.0 / s_lim) ** 3


@dataclass
class LightCone:
    """Observer geometry (api/fastpm/lightcone.h)."""
    cosmology: Cosmology
    glmatrix: np.ndarray = field(default_factory=lambda: np.eye(4))
    fov: float = 0.0            # degrees; 0 flat-sky (z), >=360 full sky
    octants: Sequence[bool] = (True,) * 8
    tol: float = 2.0 / 3        # octant tolerance, units of the norm
    dh_factor: float = 1.0

    def __post_init__(self):
        self.glmatrix = np.asarray(self.glmatrix, dtype=np.float64)
        self.horizon = Horizon(self.cosmology, self.dh_factor)

    def transform(self, x):
        """Apply the gl matrix to positions (N,3) (fastpm_gldot)."""
        x = np.asarray(x, dtype=np.float64)
        return x @ self.glmatrix[:3, :3].T + self.glmatrix[:3, 3]

    def distance_of(self, xo):
        if self.fov <= 0:
            return xo[..., 2]
        return np.sqrt((xo ** 2).sum(axis=-1))


def _interp_table(samples, ai, a, dai):
    """Linear interpolation in a 32-sample factor table (factors.c:41-70)
    at the float32 tensor a, in the JAX package's op order (one rounding
    each). ai and dai are float32-exact host floats; dai = af - ai
    taken in host float64 (keeps a crossing on the side of a slice
    boundary where the host evaluation puts it)."""
    if dai == 0:
        return samples[-1].expand(a.shape)
    ind = ((a - ai) / dai) * (NSAMPLES - 1)
    l = torch.clamp(torch.floor(ind).to(torch.int64), 0, NSAMPLES - 2)
    u = (l + 1).to(a.dtype) - ind
    return samples[l] * u + samples[l + 1] * (1.0 - u)


def _check_mode(mode: str):
    if mode not in _MODES:
        raise ValueError(f"unknown force mode {mode!r}")


def _table(a, device):
    return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(device)


def _drift_args(drift: DriftFactor, a_x: float, device):
    """A DriftFactor's tables (float32 tensors on device), scalars
    (float32-exact host floats) and force mode for
    _drift_position_args."""
    _check_mode(drift.force_mode)
    off = drift.lookup(a_x)
    return dict(mode=drift.force_mode, dyyy=_table(drift.dyyy, device),
                da1=_table(drift.da1, device), da2=_table(drift.da2, device),
                ai=_f32(drift.ai), dai=_f32(float(drift.af) - float(drift.ai)),
                o0=_f32(off[0]), o1=_f32(off[1]), o2=_f32(off[2]),
                Dv1=_f32(drift.Dv1), Dv2=_f32(drift.Dv2),
                dyyy_end=_f32(drift.dyyy[-1]))


def _kick_args(kick: KickFactor, a_v: float, device):
    _check_mode(kick.force_mode)
    off = kick.lookup(a_v)
    return dict(mode=kick.force_mode, dda=_table(kick.dda, device),
                Dv1=_table(kick.Dv1, device), Dv2=_table(kick.Dv2, device),
                ai=_f32(kick.ai), dai=_f32(float(kick.af) - float(kick.ai)),
                o0=_f32(off[0]), o1=_f32(off[1]), o2=_f32(off[2]),
                q1=_f32(kick.q1), q2=_f32(kick.q2))


def _drift_position_args(d, p: Store, a):
    """x(a) for every particle (fastpm_drift_one, the PGD term included);
    d = _drift_args(...). a is a float32 tensor of the rows' length, or
    of length 1 for every row at one time."""
    mode = d["mode"]
    dyyy = _interp_table(d["dyyy"], d["ai"], a, d["dai"]) - d["o0"]
    if mode in ("fastpm", "pm"):
        x = p.x + p.v * dyyy[:, None]
    else:
        da1 = _interp_table(d["da1"], d["ai"], a, d["dai"]) - d["o1"]
        da2 = _interp_table(d["da2"], d["ai"], a, d["dai"]) - d["o2"]
        if mode == "za":
            x = p.x + p.dx1 * da1[:, None]
        elif mode == "2lpt":
            x = (p.x + p.dx1 * da1[:, None]) + p.dx2 * da2[:, None]
        else:   # cola
            v = p.v - (p.dx1 * d["Dv1"] + p.dx2 * d["Dv2"])
            x = p.x + v * dyyy[:, None]
            x = (x + p.dx1 * da1[:, None]) + p.dx2 * da2[:, None]
    if p.pgdc is not None and d["dai"] != 0:
        x = x + (0.5 * (dyyy / d["dyyy_end"]))[:, None] * p.pgdc
    return x


def _kick_velocity_args(k, p: Store, a):
    """v(a) for every particle (fastpm_kick_one)."""
    dda = _interp_table(k["dda"], k["ai"], a, k["dai"]) - k["o0"]
    if k["mode"] == "cola":
        Dv1 = _interp_table(k["Dv1"], k["ai"], a, k["dai"]) - k["o1"]
        Dv2 = _interp_table(k["Dv2"], k["ai"], a, k["dai"]) - k["o2"]
        acc = (p.acc + p.dx1 * k["q1"]) + p.dx2 * k["q2"]
        return (((p.v + acc * dda[:, None]) + p.dx1 * Dv1[:, None])
                + p.dx2 * Dv2[:, None])
    return p.v + p.acc * dda[:, None]


# the columns a lightcone step reads (its drift and kick in every mode)
_SOLVE_COLUMNS = ("x", "v", "acc", "dx1", "dx2", "pgdc")


class USMesh:
    """Unstructured-mesh (particle) lightcone buffer
    (fastpm_usmesh_init/intersect). With a ring (parallel.comm.Ring) the
    source is this rank's rows, np_upper the capacity over every rank,
    and the ready event flushes when the rows buffered over every rank
    pass half of it."""

    def __init__(self, lc: LightCone, source_getter, tileshifts,
                 amin: float = 0.0, amax: float = 1.0,
                 target_volume: float = 0.0, np_upper: int = 1 << 62,
                 name: str = "1", ring=None):
        self.lc = lc
        self.source_getter = source_getter  # () -> Store (current state)
        self.tileshifts = np.asarray(tileshifts, dtype=np.float64)
        if self.tileshifts.ndim == 1:
            self.tileshifts = self.tileshifts[None, :]
        self.amin = amin
        self.amax = amax
        self.target_volume = target_volume
        self.np_upper = np_upper
        self.name = name
        self.ring = ring
        self.event_handlers = ev.EventHandlers()
        self.buffer: List[dict] = []
        self.np_buffered = 0
        self.np_before = 0
        self.ai = amin
        self.af = amin

    # ---- the crossing solve, on the rows' device ----

    def _inside_device(self, xo):
        """fov / octant acceptance (lightcone-usmesh.c:218-247) of
        observer-frame float32 positions (N, 3)."""
        lc = self.lc
        ok = torch.ones(xo.shape[0], dtype=torch.bool, device=xo.device)
        if lc.fov <= 0:
            return ok
        if lc.fov < 360:
            dxy = torch.sqrt(xo[:, 0] ** 2 + xo[:, 1] ** 2)
            zang = torch.rad2deg(torch.atan2(dxy, xo[:, 2]))
            zang = torch.where(zang < 0, zang + 360, zang)
            ok &= zang <= lc.fov * 0.5
        if all(lc.octants):
            return ok
        norm = torch.sqrt(torch.sum(xo * xo, dim=-1))
        tol = _f32(lc.tol) * norm
        any_oct = torch.zeros_like(ok)
        for i, s in enumerate(_OCTANT_SIGNS):
            if lc.octants[i]:
                m = torch.ones_like(ok)
                for d in range(3):
                    m &= xo[:, d] * s[d] >= -tol
                any_oct |= m
        return ok & any_oct

    def _geometry(self, device):
        lc = self.lc
        M = torch.from_numpy(lc.glmatrix[:3, :3].astype(np.float32)).to(device)
        T = torch.from_numpy(lc.glmatrix[:3, 3].astype(np.float32)).to(device)
        return M, T

    def _f_of(self, d, p, a, shift, M, T):
        """f(a) = |observer-frame x(a)| - xi(a) per row (the flat sky
        takes the z coordinate)."""
        xo = (_drift_position_args(d, p, a) + shift) @ M.T + T
        if self.lc.fov <= 0:
            dist = xo[:, 2]
        else:
            dist = torch.sqrt(torch.sum(xo * xo, dim=-1))
        return dist - self.lc.horizon.distance_device(a)

    def _solve_tile(self, p: Store, drift: DriftFactor, kick: KickFactor,
                    tileshift, a1: float, a2: float) -> Optional[dict]:
        """The crossings of one tile in [a1, a2]: a record dict {x, v,
        aemit[, id, rand], n} of device tensors of the crossing rows, or
        None when no row of this tile crosses.

        Both interval ends are evaluated for every row, at one float32
        time each (the same rounding as a per-row time column, one value
        broadcast); the rows with a root are compacted and bisected 30
        times. Half-open root booking: consecutive intervals share an
        end and both evaluate f there; when f(end) == 0.0 exactly the
        root belongs to the interval whose LEFT end it is."""
        dev = p.x.device
        d = _drift_args(drift, p.a_x, dev)
        M, T = self._geometry(dev)
        shift = torch.from_numpy(
            np.asarray(tileshift, dtype=np.float32)).to(dev)
        ta1 = torch.full((1,), _f32(a1), device=dev)
        ta2 = torch.full((1,), _f32(a2), device=dev)
        flo = self._f_of(d, p, ta1, shift, M, T)
        fhi = self._f_of(d, p, ta2, shift, M, T)
        has_root = (flo * fhi <= 0) & ((fhi != 0) | (flo == 0))
        del fhi
        idx = torch.nonzero(has_root).reshape(-1)
        del has_root
        if idx.shape[0] == 0:
            return None
        sub = Store(**{c: getattr(p, c)[idx] for c in _SOLVE_COLUMNS
                       if getattr(p, c) is not None},
                    a_x=p.a_x, a_v=p.a_v)
        flo = flo[idx]
        lo = ta1.expand(idx.shape[0]).clone()
        hi = ta2.expand(idx.shape[0]).clone()
        for _ in range(30):
            mid = 0.5 * (lo + hi)
            fmid = self._f_of(d, sub, mid, shift, M, T)
            goes_lo = flo * fmid <= 0
            lo = torch.where(goes_lo, lo, mid)
            hi = torch.where(goes_lo, mid, hi)
            flo = torch.where(goes_lo, flo, fmid)
        aemit = 0.5 * (lo + hi)

        xo = (_drift_position_args(d, sub, aemit) + shift) @ M.T + T
        k = _kick_args(kick, p.a_v, dev)
        vo = (_kick_velocity_args(k, sub, aemit) @ M.T) * (
            HUBBLE_CONSTANT / aemit)[:, None]
        accept = ((aemit <= _f32(self.amax)) & (aemit >= _f32(self.amin))
                  & self._inside_device(xo))
        keep = torch.nonzero(accept).reshape(-1)
        if keep.shape[0] == 0:
            return None
        rows = idx[keep]
        rec = dict(x=xo[keep], v=vo[keep], aemit=aemit[keep],
                   n=int(keep.shape[0]))
        if p.id is not None:
            rec["id"] = p.id[rows]
        if p.rand is not None:
            rec["rand"] = p.rand[rows]
        return rec

    # ---- the intersect loop (fastpm_usmesh_intersect) ----

    def intersect(self, drift, kick, a1: float, a2: float, whence: str):
        a1, a2 = min(a1, a2), max(a1, a2)
        if whence == ev.TIMESTEP_START:
            self.ai = self.af = a1
            self.np_before = 0
            self.emit(whence)
            return
        if whence == ev.TIMESTEP_END:
            self.af = a2
            self.emit(whence)
            return

        if (a1 > self.amax or a1 < self.amin) and \
           (a2 > self.amax or a2 < self.amin):
            # both ends outside still allows a range overlap; mirror the
            # per-tile early exit (lightcone-usmesh.c:370-375)
            if not (a1 < self.amin and a2 > self.amin):
                return

        p = self.source_getter()
        hz = self.lc.horizon
        r1 = float(hz.distance(a1))
        r2 = float(hz.distance(a2))
        volume = 4 * math.pi / 3 * abs(r1 ** 3 - r2 ** 3)
        steps = max(1, int(volume / self.target_volume + 0.5)) \
            if self.target_volume > 0 else 1
        da = (a2 - a1) / steps

        # the source's bounding box over [a1, a2] for the shell cull: a
        # reduction on the device, six scalars to the host
        if self.lc.fov > 0:
            d = _drift_args(drift, p.a_x, p.x.device)
            ends = [_drift_position_args(
                d, p, torch.full((1,), _f32(a), device=p.x.device))
                for a in (a1, a2)]
            lo_d = torch.minimum(ends[0].min(0).values, ends[1].min(0).values)
            hi_d = torch.maximum(ends[0].max(0).values, ends[1].max(0).values)
            del ends
            pad = 0.5
            xmin = lo_d.cpu().numpy() - pad
            xmax = hi_d.cpu().numpy() + pad

        for i in range(steps):
            ai = a1 + da * i
            af = a2 if i + 1 == steps else a1 + da * (i + 1)
            ri = float(hz.distance(ai))
            rf = float(hz.distance(af))
            for t in range(len(self.tileshifts)):
                shift = self.tileshifts[t]
                if self.lc.fov > 0 and not self._shell_hits_bbox(
                        xmin, xmax, shift, rf, ri):
                    continue
                rec = self._solve_tile(p, drift, kick, shift, ai, af)
                if rec is not None:
                    self.buffer.append(rec)
                    self.np_buffered += rec["n"]
            self.af = af
            buffered = (self.np_buffered if self.ring is None
                        else self.ring.psum(self.np_buffered))
            if buffered > 0.5 * self.np_upper:
                self.emit(ev.TIMESTEP_CUR)

    def _shell_hits_bbox(self, xmin, xmax, shift, r1, r2):
        """Conservative shell / box cull (spherebox.h semantics): reject
        only when the transformed box is entirely inside the inner sphere
        or entirely outside the outer sphere."""
        corners = np.array([[xmin[0] if i & 4 else xmax[0],
                             xmin[1] if i & 2 else xmax[1],
                             xmin[2] if i & 1 else xmax[2]]
                            for i in range(8)])
        xo = self.lc.transform(corners) + shift
        r = np.sqrt((xo ** 2).sum(axis=1))
        if r.max() < min(r1, r2):     # fully inside inner shell
            return False
        lo, hi = xo.min(0), xo.max(0)
        nearest = np.clip(0, lo, hi)
        dmin = np.sqrt(((nearest) ** 2).sum()) if not (
            (lo <= 0).all() and (hi >= 0).all()) else 0.0
        if dmin > max(r1, r2):
            return False
        return True

    def drain_device(self) -> Optional[dict]:
        """Concatenate and clear the buffer, keeping it on the device:
        {x, v, aemit[, id, rand], n}. The ready handler subsamples,
        sorts and runs FOF on the device and fetches only what it
        writes."""
        if not self.buffer:
            return None
        n = self.np_buffered
        cols = [k for k in self.buffer[0] if k != "n"]
        out = {k: torch.cat([b[k] for b in self.buffer]) for k in cols}
        out["n"] = n
        self.buffer = []
        self.np_before += n
        self.np_buffered = 0
        return out

    def emit(self, whence: str):
        self.event_handlers.emit(
            ev.EVENT_LIGHTCONE_READY, ev.STAGE_AFTER,
            mesh=self, ai=self.ai, af=self.af, whence=whence,
            a_mid=0.5 * (self.ai + self.af))
        self.ai = self.af
