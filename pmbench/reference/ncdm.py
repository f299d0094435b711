"""The massive-neutrino particles of a FastPM run in plain NumPy and
PyTorch (Banerjee, Powell, Abel et al.'s shell split as FastPM's
libfastpm/thermalvelocity.c sets it up).

Each site of a coarse lattice (every_ncdm CDM cells apart, staggered by
half a CDM cell) splits into n_shell Fermi-Dirac momentum shells times
2 n_side + 1 Fibonacci-spiral directions. Shell edges cut the momentum
distribution (weighted by p with lvk, else p^2) into equal parts: its
cumulative integral is tabulated on 4000 points of p / T in [0, 20] and
inverted by linear interpolation. A shell's speed is the rms p / T over
it, its mass the share of the number density in it. Every split sits at
its site moved along its thermal velocity so that the spheres of the
largest shell almost touch.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy import integrate

__all__ = ["split_table", "split_sites"]

# kT_nu today over c, in eV km/s, and FastPM's H0 in km/s/(Mpc/h)
KTC = 50.3
H0 = 100.0
X_MAX = 20.0
N_TABLE = 4000


def _occupation(x, masses):
    r = np.asarray(masses) / masses[0]
    return sum(ri ** 4 / (np.exp(np.minimum(x * ri, 700.0)) + 1) for ri in r)


def _shells(n_shell: int, masses, lvk: bool):
    """(rms p / T of each shell, share of the number in each shell)."""
    fine = np.linspace(0.0, X_MAX, 64 * (N_TABLE - 1) + 1)
    occ = _occupation(fine, masses)
    weight = fine * occ if lvk else fine * fine * occ
    cum = integrate.cumulative_trapezoid(weight, x=fine, initial=0.0)
    table_x = fine[::64]
    cdf = cum[::64] / cum[-1]
    edges = np.concatenate([[0.0], np.interp(
        (np.arange(n_shell) + 1) / n_shell, cdf, table_x)])
    number = fine * fine * occ
    total = integrate.simpson(number, x=fine)
    vel, frac = [], []
    for lo, hi in zip(edges[:-1], edges[1:]):
        x = np.linspace(lo, hi, 20001)
        o = _occupation(x, masses)
        n = integrate.simpson(x * x * o, x=x)
        m4 = integrate.simpson(x ** 4 * o, x=x)
        vel.append(math.sqrt(m4 / n))
        frac.append(n / total)
    return np.array(vel), np.array(frac)


def _fibonacci(n_side: int):
    i = np.arange(-n_side, n_side + 1)
    lat = np.arcsin(2.0 * i / (2 * n_side + 1))
    lon = 2 * np.pi * i * 2.0 / (1 + math.sqrt(5.0))
    return np.stack([np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon),
                     np.sin(lat)], axis=-1)


def split_table(p: dict):
    """(thermal velocity (n_split, 3) in FastPM's internal units, mass
    share (n_split,)), direction-major, shell-minor."""
    masses = [m for m in p["m_ncdm"] if m > 0]
    if p.get("ncdm_sphere_scheme", "fibonacci") != "fibonacci":
        raise NotImplementedError("only the Fibonacci sphere is served")
    vel, frac = _shells(int(p["n_shell"]), masses, bool(p.get("lvk", True)))
    vec = _fibonacci(int(p["n_side"]))
    conv = KTC / masses[0] / H0
    v = (vec[:, None, :] * vel[None, :, None] * conv).reshape(-1, 3)
    return v, np.tile(frac / len(vec), len(vec))


def split_sites(p: dict, omega_ncdm: float, rho_crit: float, device):
    """The split rows before their 2LPT: (id int64, x, v, mass) with x
    wrapped into the box, in site-major, split-minor order."""
    nc, box = int(p["nc"]), float(p["boxsize"])
    every = int(p["every_ncdm"])
    n = nc // every
    vel, frac = split_table(p)
    nsplit = len(frac)
    i = torch.arange(n ** 3, dtype=torch.int64, device=device)
    idx = torch.stack([i // (n * n), (i // n) % n, i % n], -1)
    x = idx.to(torch.float32) * torch.tensor([box / n] * 3,
                                             dtype=torch.float32,
                                             device=device)
    x = x + float(np.float32(box / nc * 0.5))
    m0 = omega_ncdm * rho_crit * box ** 3 / n ** 3
    vmax = float(np.sqrt((vel[-1] ** 2).sum()))
    disp = 0.5 * box / len(p["m_ncdm"]) / vmax * (int(p["n_shell"]) - 1) \
        / int(p["n_shell"])
    vt = torch.from_numpy(vel.astype(np.float32)).to(device).repeat(n ** 3, 1)
    x = x.repeat_interleave(nsplit, 0) + vt * float(np.float32(disp))
    L = torch.tensor([box] * 3, dtype=torch.float32, device=device)
    x = x - torch.floor(x / L) * L
    s = torch.arange(nsplit, dtype=torch.int64, device=device).repeat(n ** 3)
    ids = s * n ** 3 + i.repeat_interleave(nsplit)
    mass = (torch.from_numpy(frac.astype(np.float32)).to(device)
            .repeat(n ** 3) * float(np.float32(m0)))
    return ids, x, vt, mass
