"""A FastPM run in plain PyTorch: the benchmark's reference for what the
port's Solver produces (Feng et al. 2016; the conventions of libfastpm).

From a white-noise field and the configuration's parameters it works out
again everything the run derives:

- the linear density: white noise times sqrt(P(k) / V), P interpolated
  log-log in the configuration's table, scaled from the table's redshift
  to z = 0 by the linear growth;
- 2LPT on the particle lattice: dx1 = i k / k^2 delta, the second-order
  source sum_{i<j} (phi_ii phi_jj - phi_ij^2) with phi_ij = -k_i k_j /
  k^2 delta, dx2 = 3/7 i k / k^2 source, all read out with cloud-in-cell
  weights; x = q + D1 dx1 + D2 dx2, v = a^2 E (D1 f1 dx1 + D2 f2 dx2)
  (for massive neutrinos the first-order velocity is read from f(k)
  times dx1's field);
- the kick-drift-kick steps of FastPM with its modified factors, each
  force a cloud-in-cell paint of every species' mass onto the force
  mesh, the potential -delta / k^2 and its gradient with the 4-point
  finite difference (8 sin w - sin 2w) / 6 (kernel "1_4"; modes whose
  coordinates are all 0 or Nyquist zeroed), read back at the particles.

The FFT pair is the unitary one (forward divided by the cell count).
Fields are float32; with mesh_dtype=torch.bfloat16 every mesh and the
values read from it are rounded to bfloat16 (the control that a
comparison must fail). Paint and readout run in blocks of rows so that
a 1024^3 mesh and 2e8 rows fit beside each other.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from .cosmology import Cosmology, RHO_CRIT
from . import ncdm as ncdm_ref

__all__ = ["simulate", "Mesh", "funck"]

BLOCK = 1 << 23


def funck(path: str):
    """f(k) from a two-column table, interpolated log-log (linearly where
    a value is not positive), extrapolated along the end intervals, with
    f(0) = 1. Returns a function of a float64 tensor."""
    tab = np.loadtxt(path, comments="#", usecols=(0, 1))
    kt, ft = (np.ascontiguousarray(tab[:, i]) for i in (0, 1))

    def f(k: torch.Tensor) -> torch.Tensor:
        K = torch.as_tensor(kt, dtype=torch.float64, device=k.device)
        F = torch.as_tensor(ft, dtype=torch.float64, device=k.device)
        lo = torch.clamp(torch.searchsorted(K, k.contiguous(), right=True)
                         - 1, 0, len(kt) - 2)
        k1, k2, f1, f2 = K[lo], K[lo + 1], F[lo], F[lo + 1]
        one = torch.ones_like(k)
        pos = (f1 > 0) & (f2 > 0) & (k > 0)
        lg = lambda t: torch.log(torch.where(t > 0, t, one))
        vlog = torch.exp((lg(f1) * (lg(k2) - lg(k))
                          + lg(f2) * (lg(k) - lg(k1))) / (lg(k2) - lg(k1)))
        vlin = (f1 * (k2 - k) + f2 * (k - k1)) / (k2 - k1)
        return torch.where(k == 0, one, torch.where(pos, vlog, vlin))
    return f


class Mesh:
    """An n^3 periodic mesh of side box: its k tables (float32, each
    axis rounded apart) and the unitary FFT pair."""

    def __init__(self, n: int, box: float, device, dtype=torch.float32):
        self.n, self.box, self.device, self.dtype = n, box, device, dtype
        self.cell = box / n
        self.norm = float(n) ** 3
        i = np.arange(n)
        kd = np.where(i >= n // 2, i - n, i) * (2 * np.pi / box)
        w = kd * self.cell
        fin = (8 * np.sin(w) - np.sin(2 * w)) / 6 / self.cell
        self_conj = (i == 0) | (2 * i == n)
        self.k2, self.kfin, self.sc = [], [], []
        for d in range(3):
            m = n // 2 + 1 if d == 2 else n
            shape = [1, 1, 1]
            shape[d] = m
            t = lambda a: torch.as_tensor(a[:m].astype(np.float32).reshape(
                shape), device=device)
            self.k2.append(t(kd * kd))
            self.kfin.append(t(fin))
            self.sc.append(torch.as_tensor(self_conj[:m].reshape(shape),
                                           device=device))

    def kk(self):
        return self.k2[0] + self.k2[1] + self.k2[2]

    def inv_kk(self):
        kk = self.kk()
        return torch.where(kk > 0, 1.0 / torch.where(kk > 0, kk, 1.0), 0.0)

    def not_self_conj(self):
        return ~(self.sc[0] & self.sc[1] & self.sc[2])

    def grad(self, fk: torch.Tensor, d: int) -> torch.Tensor:
        """i k_d fk with the finite-difference k, self-conjugate modes
        zeroed."""
        g = fk * torch.complex(torch.zeros_like(self.kfin[d]), self.kfin[d])
        return g * self.not_self_conj()

    def r2c(self, f: torch.Tensor) -> torch.Tensor:
        return torch.fft.rfftn(f.float()) / self.norm

    def c2r(self, fk: torch.Tensor) -> torch.Tensor:
        out = torch.fft.irfftn(fk * self.norm, s=(self.n,) * 3)
        return out.to(self.dtype)

    def _corners(self, x):
        g = x * float(np.float32(1.0 / self.cell))
        b = torch.floor(g)
        f = g - b
        i0 = torch.remainder(b.to(torch.int64), self.n)
        i1 = torch.remainder(i0 + 1, self.n)
        t = 1.0 - f
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    w = ((f if dx else t)[:, 0] * (f if dy else t)[:, 1]
                         * (f if dz else t)[:, 2])
                    ix = (i1 if dx else i0)[:, 0]
                    iy = (i1 if dy else i0)[:, 1]
                    iz = (i1 if dz else i0)[:, 2]
                    yield (ix * self.n + iy) * self.n + iz, w

    def paint(self, canvas, x, mass):
        """Add each row's mass (scalar or per row) to the 8 cells around
        it, in place."""
        flat = canvas.view(-1)
        for s in range(0, x.shape[0], BLOCK):
            xs = x[s:s + BLOCK]
            m = mass if not torch.is_tensor(mass) else mass[s:s + BLOCK]
            for idx, w in self._corners(xs):
                flat.index_add_(0, idx, w * m)
        return canvas

    def readout(self, field, x):
        """The field's cloud-in-cell value at every row, in the mesh's
        dtype, as float32."""
        flat = field.reshape(-1)
        out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
        for s in range(0, x.shape[0], BLOCK):
            acc = torch.zeros(min(BLOCK, x.shape[0] - s), dtype=self.dtype,
                              device=x.device)
            for idx, w in self._corners(x[s:s + BLOCK]):
                acc += w.to(self.dtype) * flat[idx]
            out[s:s + BLOCK] = acc.float()
        return out


def _wrap(x, box):
    return x - torch.floor(x / box) * box


def linear_delta(mesh: Mesh, wn, table: str, a_in: float,
                 cosmo: Cosmology):
    """The z = 0 linear density from white noise and a P(k) table given
    at a_in."""
    k = torch.sqrt(mesh.kk()).double()
    amp = torch.sqrt(funck(table)(k) / mesh.box ** 3).float()
    scale = float(np.float32(cosmo.growth(1.0)[0] / cosmo.growth(a_in)[0]))
    dk = wn * amp * scale
    dk[0, 0, 0] = 1.0
    return dk


def lpt(mesh: Mesh, dk, x, f_table=None):
    """(dx1, dx2, dv1 or None) at rows x."""
    inv = mesh.inv_kk()
    pot = dk * inv
    fk = (None if f_table is None
          else f_table(torch.sqrt(mesh.kk()).double()).float())
    cols1, colsv = [], []
    for d in range(3):
        g = mesh.grad(pot, d)
        cols1.append(mesh.readout(mesh.c2r(g), x))
        if fk is not None:
            colsv.append(mesh.readout(mesh.c2r(g * fk), x))
    pairs = ((1, 2), (2, 0), (0, 1))
    phi = [mesh.c2r(mesh.grad(mesh.grad(pot, d), d)) for d in range(3)]
    src = sum(phi[i].float() * phi[j].float() for i, j in pairs)
    del phi
    for i, j in pairs:
        pij = mesh.c2r(mesh.grad(mesh.grad(pot, i), j)).float()
        src = src - pij * pij
    sk = mesh.r2c(src) * inv
    del src
    cols2 = [mesh.readout(mesh.c2r(mesh.grad(sk, d)) * (3.0 / 7), x)
             for d in range(3)]
    dv1 = torch.stack(colsv, -1) if colsv else None
    return torch.stack(cols1, -1), torch.stack(cols2, -1), dv1


def force(mesh: Mesh, species):
    """The acceleration of every species' rows from all of them."""
    canvas = torch.zeros((mesh.n,) * 3, dtype=torch.float32,
                         device=mesh.device)
    total = 0.0
    for sp in species:
        m = sp["mass"]
        total += (float(m.double().sum()) if torch.is_tensor(m)
                  else sp["m0"] * sp["x"].shape[0])
        mesh.paint(canvas, sp["x"], m)
    dk = mesh.r2c(canvas.div_(total / mesh.norm).to(mesh.dtype))
    del canvas
    pot = -(dk * mesh.inv_kk())
    del dk
    accs = [torch.empty_like(sp["x"]) for sp in species]
    for d in range(3):
        field = mesh.c2r(mesh.grad(pot, d))
        for sp, acc in zip(species, accs):
            acc[:, d] = mesh.readout(field, sp["x"])
        del field
    return accs


def _factors(c: Cosmology, steps):
    """The kick-drift-kick schedule: for each step (a_i, a_{i+1}) with a
    half step at the geometric mean, the (kick, drift, drift, kick)
    factors and the force's a."""
    out = []
    for ai, af in zip(steps[:-1], steps[1:]):
        ah = math.exp(0.5 * (math.log(ai) + math.log(af)))
        out.append((c.kick(ai, ai, ah), c.drift(ai, ah, ah),
                    c.drift(ah, ah, af), c.kick(ah, af, af)))
    return out


def simulate(p: dict, wn: torch.Tensor,
             mesh_dtype=torch.float32) -> Dict[str, Tuple]:
    """Every species' (id, x, v) at the last time step, rows in id order
    for CDM and in site-major split order for ncdm."""
    dev = wn.device
    c = Cosmology(p)
    nc, box = int(p["nc"]), float(p["boxsize"])
    steps = [float(a) for a in p["time_step"]]
    a0 = steps[0]
    pmf = p["pm_nc_factor"]
    pmf = float(pmf[0] if isinstance(pmf, (list, tuple)) else pmf)
    for key, want in (("kernel_type", "1_4"), ("force_mode", "fastpm"),
                      ("force_softening_type", "none"),
                      ("painter_type", "cic"), ("lpt_nc_factor", 1.0),
                      ("shift", False), ("sigma8", 0.0)):
        if p.get(key, want) != want:
            raise NotImplementedError(f"{key} = {p[key]!r} is not served")
    lmesh = Mesh(nc, box, dev, mesh_dtype)
    d1, d2, dv1c, dv2c, dvpre = (float(np.float32(v)) for v in c.lpt(a0))
    f32 = lambda v: float(np.float32(v))

    i = torch.arange(nc ** 3, dtype=torch.int64, device=dev)
    q = torch.stack([i // (nc * nc), (i // nc) % nc, i % nc], -1).float() \
        * torch.tensor([box / nc] * 3, dtype=torch.float32, device=dev)
    ldr = float(p.get("linear_density_redshift", 0.0))
    dk = linear_delta(lmesh, wn, p["read_powerspectrum"], 1 / (1 + ldr), c)
    dx1, dx2, _ = lpt(lmesh, dk, q)
    del dk
    cdm = dict(id=i, x=q + d1 * dx1 + d2 * dx2,
               v=dv2c * dx2 + dv1c * dx1,
               m0=c.Ocdm * RHO_CRIT * (box / nc) ** 3)
    cdm["mass"] = f32(cdm["m0"])
    del dx1, dx2, q
    species = {"cdm": cdm}
    if p.get("m_ncdm") and int(p.get("n_shell", 0)):
        ids, x, vt, mass = ncdm_ref.split_sites(p, c.Oncdm, RHO_CRIT, dev)
        ldr = float(p.get("linear_density_redshift_ncdm", 0.0))
        dkn = linear_delta(lmesh, wn, p["read_powerspectrum_ncdm"],
                           1 / (1 + ldr), c)
        ft = funck(p["read_linear_growth_rate_ncdm"])
        dx1, dx2, dv1 = lpt(lmesh, dkn, x, ft)
        del dkn
        species["ncdm"] = dict(id=ids, x=x + d1 * dx1 + d2 * dx2,
                               v=vt + dv2c * dx2 + dvpre * dv1, mass=mass,
                               m0=0.0)
        del dx1, dx2, dv1
    del lmesh
    fmesh = Mesh(int(nc * pmf), box, dev, mesh_dtype)
    rows = list(species.values())

    def do_force():
        for sp in rows:
            sp["x"] = _wrap(sp["x"], box)
        return force(fmesh, rows)

    acc = do_force()
    for k1, dr1, dr2, k2 in _factors(c, steps):
        for sp, a in zip(rows, acc):
            sp["v"] = sp["v"] + a * f32(k1)
            sp["x"] = sp["x"] + sp["v"] * f32(dr1)
            sp["x"] = sp["x"] + sp["v"] * f32(dr2)
        acc = do_force()
        for sp, a in zip(rows, acc):
            sp["v"] = sp["v"] + a * f32(k2)
    return {name: (sp["id"], sp["x"], sp["v"])
            for name, sp in species.items()}

