"""Massive-neutrino (ncdm) particle initialization
(reference: libfastpm/thermalvelocity.c).

Port of fastpm_tpu/ncdm.py. Each ncdm lattice site is split into
n_shells Fermi-Dirac momentum shells times a set of sphere directions
(Fibonacci spiral or HEALPix pixel centers rotated to break grid
alignment), with per-split masses from the FD integrals. Thermal
velocity replaces the site velocity; the LPT velocity is added
afterwards by setup_lpt (pm_2lpt_evolve adds to v).

The tables are numpy/scipy on the host; split_ncdm builds its tensors on
the device of the source store.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field

import numpy as np
import torch
from scipy import integrate as _sint

from .cosmology import Cosmology
from .store import Store
from .units import RHO_CRIT, HUBBLE_CONSTANT

__all__ = ["NcdmInitData", "split_ncdm", "divide_fd",
           "divide_sphere_fibonacci", "divide_sphere_healpix"]

LENGTH_FD_TABLE = 4000
MAX_FERMI_DIRAC = 20.0

# kT_nu today in velocity units: 50.3 (eV/c^2 km/s)
KTC = 50.3


def _fd_vol(x, masses):
    """Multi-species FD kernel without the x^2 phase-space factor
    (thermalvelocity.c:90-110)."""
    r = np.asarray(masses) / masses[0]
    out = 0.0
    for ri in r:
        out = out + ri ** 4 / (np.exp(np.minimum(x * ri, 700.0)) + 1)
    return out


def divide_fd(n_shells: int, masses, lvk: bool = True):
    """Split the FD distribution into equal-CDF shells; returns
    (rms velocity per shell in units of p/T, mass fraction per shell)
    (thermalvelocity.c:129-216). The 4000-point CDF table takes seconds,
    so the result is cached per (n_shells, masses, lvk); callers get
    their own copies."""
    vel, mass = _divide_fd(int(n_shells), tuple(float(m) for m in masses),
                           bool(lvk))
    return vel.copy(), mass.copy()


@functools.lru_cache(maxsize=8)
def _divide_fd(n_shells: int, masses: tuple, lvk: bool):
    masses = [m for m in masses if m > 0] or [1.0]

    def kern_F(x):
        if lvk:
            return x * _fd_vol(x, masses)
        return x * x * _fd_vol(x, masses)

    def kern_G(x):
        return x * x * _fd_vol(x, masses)

    def kern_H(x):
        return x ** 4 * _fd_vol(x, masses)

    xs = np.linspace(0, MAX_FERMI_DIRAC, LENGTH_FD_TABLE)
    cdf = np.array([_sint.quad(kern_F, 0, x, epsabs=0, epsrel=1e-7,
                               limit=1000)[0] if x > 0 else 0.0
                    for x in xs])
    cdf /= cdf[-1]

    edges = np.interp((np.arange(n_shells) + 1) / n_shells, cdf, xs)

    total_mass = _sint.quad(kern_G, 0, MAX_FERMI_DIRAC, epsabs=0,
                            epsrel=1e-7, limit=1000)[0]
    vel = np.empty(n_shells)
    mass = np.empty(n_shells)
    lo = 0.0
    for i in range(n_shells):
        hi = edges[i]
        disp = _sint.quad(kern_H, lo, hi, epsabs=0, epsrel=1e-7,
                          limit=1000)[0]
        m = _sint.quad(kern_G, lo, hi, epsabs=0, epsrel=1e-7,
                       limit=1000)[0]
        vel[i] = math.sqrt(disp / m)
        mass[i] = m / total_mass
        lo = hi
    return vel, mass


def _rotate_break_grid(v):
    """The fixed rotation applied to HEALPix vectors
    (thermalvelocity.c:76-81)."""
    R = np.array([[0.5, -0.5, 0.70710678],
                  [0.85355339, 0.14644661, -0.5],
                  [0.14644661, 0.85355339, 0.5]])
    return v @ R.T


def divide_sphere_fibonacci(n_side: int) -> np.ndarray:
    """2*n_side+1 Fibonacci-spiral directions
    (thermalvelocity.c:243-257)."""
    i = np.arange(-n_side, n_side + 1)
    lat = np.arcsin(2.0 * i / (2 * n_side + 1))
    lon = 2 * np.pi * i * 2.0 / (1 + math.sqrt(5.0))
    return np.stack([np.cos(lat) * np.cos(lon),
                     np.cos(lat) * np.sin(lon),
                     np.sin(lat)], axis=-1)


def _pix2vec_ring(pix, n_side):
    """HEALPix RING pixel centers (standard pixelization math,
    thermalvelocity.c:32-82)."""
    ncap = n_side * (n_side - 1) * 2
    npix = 12 * n_side * n_side
    fact2 = 4.0 / npix
    out = np.empty((len(pix), 3))
    for n, p in enumerate(pix):
        if p < ncap:
            iring = int(0.5 * (1 + math.isqrt(1 + 2 * p)))
            iphi = (p + 1) - 2 * iring * (iring - 1)
            z = 1.0 - iring * iring * fact2
            phi = (iphi - 0.5) * 0.5 * math.pi / iring
        elif p < npix - ncap:
            fact1 = (n_side << 1) * fact2
            ip = p - ncap
            iring = ip // (4 * n_side) + n_side
            iphi = ip % (4 * n_side) + 1
            fodd = 1.0 if (iring + n_side) & 1 else 0.5
            z = (2 * n_side - iring) * fact1
            phi = (iphi - fodd) * math.pi / (2 * n_side)
        else:
            ip = npix - p
            iring = int(0.5 * (1 + math.isqrt(2 * ip - 1)))
            iphi = 4 * iring + 1 - (ip - 2 * iring * (iring - 1))
            z = -1.0 + iring * iring * fact2
            phi = (iphi - 0.5) * 0.5 * math.pi / iring
        st = math.sin(math.acos(z))
        out[n] = (st * math.cos(phi), st * math.sin(phi), z)
    return out


def divide_sphere_healpix(n_side: int) -> np.ndarray:
    npix = 12 * n_side * n_side
    v = _pix2vec_ring(np.arange(npix), n_side)
    v = _rotate_break_grid(v)
    # isotropize per-axis dispersion to 1/3 each (thermalvelocity.c:219-241)
    vsq = (v ** 2).mean(axis=0) * 3.0
    return v / np.sqrt(vsq)


@dataclass
class NcdmInitData:
    """Velocity/mass split table (fastpm_ncdm_init_create)."""
    boxsize: float
    cosmology: Cosmology
    z: float
    n_shells: int
    n_side: int
    lvk: bool = True
    sphere_scheme: str = "fibonacci"
    vel: np.ndarray = field(init=False)     # (n_split, 3) internal units
    mass: np.ndarray = field(init=False)    # (n_split,), sums to 1

    def __post_init__(self):
        c = self.cosmology
        masses = list(c.m_ncdm)
        vel_shell, mass_shell = divide_fd(self.n_shells, masses, self.lvk)
        if self.sphere_scheme == "healpix":
            vec = divide_sphere_healpix(self.n_side)
        elif self.sphere_scheme == "fibonacci":
            vec = divide_sphere_fibonacci(self.n_side)
        else:
            raise ValueError(self.sphere_scheme)
        n_sphere = len(vec)
        # conjugate momentum a^2 xdot in Mpc/h: kTc / m0 / H0
        conv = KTC / masses[0] / HUBBLE_CONSTANT
        # order: sphere-major, shell-minor (thermalvelocity.c:373-385)
        self.vel = (vec[:, None, :] * vel_shell[None, :, None]
                    * conv).reshape(-1, 3)
        self.mass = np.tile(mass_shell / n_sphere, n_sphere)

    @property
    def n_split(self) -> int:
        return len(self.mass)


def split_ncdm(nid: NcdmInitData, src: Store, name: str = "ncdm") -> Store:
    """Split each source site into n_split thermal-velocity particles
    (fastpm_split_ncdm). Call BEFORE setup_lpt for ncdm: the split sets
    v = v_thermal; LPT velocities are added on top. Split ids are
    s_idx * q_size + site id (store.c:669), int64; a rand column, where
    the sites have one, is repeated for every split of a site."""
    n = src.np_local
    nsplit = nid.n_split
    c = nid.cosmology
    dev = src.x.device

    M0 = (c.Omega_ncdm * RHO_CRIT * nid.boxsize ** 3) / n

    # displacement factor so expanded spheres almost touch
    # (thermalvelocity.c:416-424)
    vthm_max = float(np.sqrt((nid.vel[-1] ** 2).sum()))
    n_ncdm = max(1, c.N_ncdm)
    disp = (0.5 * nid.boxsize / n_ncdm / vthm_max
            * (nid.n_shells - 1) / nid.n_shells) if vthm_max > 0 else 0.0

    vel = torch.from_numpy(nid.vel.astype(np.float32)).to(dev)
    mass = torch.from_numpy(nid.mass.astype(np.float32)).to(dev)

    vthm = vel.repeat(n, 1)
    x = (src.x.repeat_interleave(nsplit, dim=0)
         + vthm * float(np.float32(disp)))
    ids = None
    if src.id is not None:
        qsize = int(np.prod(src.q_nc))
        s_idx = torch.arange(nsplit, dtype=torch.int64,
                             device=dev).repeat(n)
        ids = s_idx * qsize + src.id.to(torch.int64).repeat_interleave(
            nsplit)
    return Store(
        x=x, v=vthm,
        acc=torch.zeros_like(x) if src.acc is not None else None,
        id=ids, mass=mass.repeat(n) * float(np.float32(M0)),
        rand=(None if src.rand is None
              else src.rand.repeat_interleave(nsplit)),
        a_x=src.a_x, a_v=src.a_v, M0=0.0,
        q_shift=src.q_shift, q_scale=src.q_scale, q_nc=src.q_nc,
        name=name)
