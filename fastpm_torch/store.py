"""Particle store: a structure-of-arrays dataclass of torch tensors
(reference: libfastpm/store.c, api/fastpm/store.h).

Port of fastpm_tpu/store.py. Column semantics follow the reference:
- x   (N,3) f32  position in Mpc/h, timestamp a_x
- v   (N,3) f32  internal velocity a^2 dx/dt / H0 (Mpc/h), timestamp a_v
- acc (N,3) f32  acceleration from the last force step
- dx1/dx2 (N,3) f32  LPT displacements
- dv1 (N,3) f32  LPT velocity from a growth-rate table (ncdm)
- id  (N,) i64  raveled Lagrangian lattice index; q is recomputable
  from it via the q_* metadata (store.c:664-692)
- alive (N,) u8  liveness of padded rows (None = every row is a particle)
- mass (N,) f32  per-particle mass (ncdm); None = every particle has M0

Row order carries no meaning: the force step returns the store in
cell-sorted order, and writers sort by id.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .mesh import PM

__all__ = ["Store", "lattice_store"]

# the per-particle tensor columns, in declaration order
COLUMNS = ("x", "v", "acc", "dx1", "dx2", "dv1", "id", "alive", "mass")


@dataclass
class Store:
    """Particle columns as tensors (None = column not allocated) plus
    the store metadata."""

    x: torch.Tensor
    v: Optional[torch.Tensor] = None
    acc: Optional[torch.Tensor] = None
    dx1: Optional[torch.Tensor] = None
    dx2: Optional[torch.Tensor] = None
    dv1: Optional[torch.Tensor] = None
    id: Optional[torch.Tensor] = None
    alive: Optional[torch.Tensor] = None
    mass: Optional[torch.Tensor] = None

    a_x: float = 0.0
    a_v: float = 0.0
    M0: float = 1.0
    q_shift: tuple = (0.0, 0.0, 0.0)
    q_scale: tuple = (1.0, 1.0, 1.0)
    q_nc: tuple = (0, 0, 0)
    name: str = "1"

    @property
    def np_local(self) -> int:
        return self.x.shape[0]

    def columns(self):
        """(name, tensor) of every allocated per-particle column."""
        return [(c, getattr(self, c)) for c in COLUMNS
                if getattr(self, c) is not None]

    def q_from_id(self, id=None):
        """Recompute the Lagrangian position q from the particle id
        (store.c:664-681)."""
        if id is None:
            id = self.id
        n0, n1, n2 = self.q_nc
        id = id.to(torch.int64) % (n0 * n1 * n2)
        i0 = id // (n1 * n2)
        i1 = (id - i0 * (n1 * n2)) // n2
        i2 = id - i0 * (n1 * n2) - i1 * n2
        q = torch.stack([i0, i1, i2], dim=-1).to(torch.float32)
        scale = torch.tensor(self.q_scale, dtype=torch.float32,
                             device=q.device)
        shift = torch.tensor(self.q_shift, dtype=torch.float32,
                             device=q.device)
        return q * scale + shift

    def wrap(self, boxsize) -> "Store":
        """Periodic wrap of positions into [0, L) (store.c:447-475)."""
        L = torch.tensor(boxsize if not np.isscalar(boxsize)
                         else (boxsize,) * 3, dtype=self.x.dtype,
                         device=self.x.device)
        return self.replace(x=self.x - torch.floor(self.x / L) * L)

    def replace(self, **kwargs) -> "Store":
        return dataclasses.replace(self, **kwargs)

    def take(self, index: torch.Tensor) -> "Store":
        """Every per-particle column permuted (or selected) by index."""
        return self.replace(**{c: t[index] for c, t in self.columns()})

    def compact(self) -> "Store":
        """Drop the dead rows (alive == 0). A store without an alive
        column returns itself."""
        if self.alive is None:
            return self
        keep = torch.nonzero(self.alive > 0).reshape(-1)
        return self.take(keep).replace(alive=None)

    def summary(self, column: str, ring=None):
        """Per-component (min, std, mean, max) as float64 numpy arrays
        (fastpm_store_summary, store.c:808+). Reduced on the store's
        device in float64; only the 4 x ncomp results are fetched. With
        a ring (parallel.comm.Ring) the store is this rank's rows and
        the summary is over every rank's."""
        a = getattr(self, column).double()
        if a.ndim == 1:
            a = a[:, None]
        if self.alive is not None:
            a = a[self.alive > 0]
        sums = torch.cat([a.sum(dim=0), (a * a).sum(dim=0),
                          a.new_full((1,), a.shape[0])])
        lo, hi = a.min(dim=0).values, a.max(dim=0).values
        if ring is not None:
            sums = ring.psum(sums)
            lo, hi = -ring.pmax(-lo), ring.pmax(hi)
        k = a.shape[1]
        mean = sums[:k] / sums[-1]
        std = torch.sqrt(sums[k:2 * k] / sums[-1] - mean * mean)
        out = torch.stack([lo, std, mean, hi]).cpu().numpy()
        return out[0], out[1], out[2], out[3]

    def shard(self, ring) -> "Store":
        """This rank's contiguous block of the rows (rank r of P keeps
        rows [N r / P, N (r + 1) / P)). A lattice store is filled in
        x-major id order, so rank r keeps the particles of x-slab r
        (solver.py:_shard_store)."""
        if ring.nproc == 1:
            return self
        n = self.np_local
        lo, hi = n * ring.rank // ring.nproc, n * (ring.rank + 1) // ring.nproc
        return self.replace(**{c: t[lo:hi].clone() for c, t in self.columns()})

    def gather(self, ring) -> Optional["Store"]:
        """Every rank's rows, in rank order, on rank 0 (None elsewhere)."""
        if ring.nproc == 1:
            return self
        cols = {c: ring.gather_rows(t) for c, t in self.columns()}
        return self.replace(**cols) if ring.rank == 0 else None


def lattice_store(pm: PM, Nc=None, shift=0.0, columns=("v", "acc", "id"),
                  M0: float = 1.0, name: str = "1") -> Store:
    """Uniform Lagrangian lattice of Nc^3 particles on pm.device
    (fastpm_store_fill, store.c:723-805): id = raveled lattice index,
    x = q = index * scale + shift."""
    if Nc is None:
        Nc = pm.Nmesh
    if np.isscalar(Nc):
        Nc = (int(Nc),) * 3
    if np.isscalar(shift):
        shift = (float(shift),) * 3
    n = int(np.prod(Nc))
    scale = tuple(pm.BoxSize[d] / Nc[d] for d in range(3))
    dev = pm.device

    i = torch.arange(n, dtype=torch.int64, device=dev)
    s01 = Nc[1] * Nc[2]
    i0 = i // s01
    r = i - i0 * s01
    i1 = r // Nc[2]
    i2 = r - i1 * Nc[2]
    idx = torch.stack([i0, i1, i2], dim=-1).to(torch.float32)
    x = (idx * torch.tensor(scale, dtype=torch.float32, device=dev)
         + torch.tensor(shift, dtype=torch.float32, device=dev))

    kw = dict(x=x, a_x=0.0, a_v=0.0, M0=M0, q_shift=tuple(shift),
              q_scale=scale, q_nc=tuple(Nc), name=name)
    if "v" in columns:
        kw["v"] = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    if "acc" in columns:
        kw["acc"] = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    if "id" in columns:
        kw["id"] = i
    return Store(**kw)
