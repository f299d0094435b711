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
- alive (N,) u8  liveness of the rows of a rehomed store (None = every
  row is a particle)
- mass (N,) f32  per-particle mass (ncdm); None = every particle has M0
- rand (N,) f32  per-particle uniform for subsampling (store.c:695-720)
- aemit (N,) f32  emission scale factor (lightcone rows)
- potential (N,) f32, tidal (N,6) f32  the force's potential and tidal
  tensor at each particle (compute_potential / compute_tidal)
- pgdc (N,3) f32  the PGD displacement of the last force step, consumed
  by the drift (pgdcorrection.c)

Row order carries no meaning: the force step returns the store in
cell-sorted order, and writers sort by id. What the order of a fresh
store means for its sharding is its home_blocks: None for the x-major
lattice order, (px, py) for pencil-blocked rows (lattice_store).

A rehomed store (SolverConfig.rehome; solver.py:335-380 of the JAX
package) holds R = cap + 2B rows on each rank, the particles whose
position lies in the rank's x-slab among them, marked by alive;
rehome_bucket is B, the rows each end-of-step hop carries at most.
compact() turns it back into a dense store.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .mesh import PM
from . import native

__all__ = ["Store", "lattice_store"]

# the per-particle tensor columns, in declaration order
COLUMNS = ("x", "v", "acc", "dx1", "dx2", "dv1", "id", "alive", "mass",
           "rand", "aemit", "potential", "tidal", "pgdc")


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
    rand: Optional[torch.Tensor] = None
    aemit: Optional[torch.Tensor] = None
    potential: Optional[torch.Tensor] = None
    tidal: Optional[torch.Tensor] = None
    pgdc: Optional[torch.Tensor] = None

    a_x: float = 0.0
    a_v: float = 0.0
    M0: float = 1.0
    q_shift: tuple = (0.0, 0.0, 0.0)
    q_scale: tuple = (1.0, 1.0, 1.0)
    q_nc: tuple = (0, 0, 0)
    name: str = "1"
    # (px, py): the rows are pencil-blocked for a px x py grid
    # (lattice_store(blocks=...)), so a Grid's shard of them is the
    # rank's pencil; None: x-major
    home_blocks: Optional[tuple] = None
    # B of a rehomed store (the module docstring); None for a dense one
    rehome_bucket: Optional[int] = None

    @property
    def np_local(self) -> int:
        return self.x.shape[0]

    def count(self):
        """The particles of these rows: np_local, or for a rehomed store
        its alive rows (an int64 tensor on its device, not fetched)."""
        if self.alive is None:
            return self.np_local
        return self.alive.sum(dtype=torch.int64)

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

    def subsample_mask(self, fraction: float) -> torch.Tensor:
        """Boolean keep-mask from the rand column
        (store.c:fill_subsample): the reference keeps on rand <=
        fraction (store.c:977)."""
        if fraction >= 1.0:
            return torch.ones(self.np_local, dtype=torch.bool,
                              device=self.x.device)
        return self.rand <= fraction

    def wrap(self, boxsize) -> "Store":
        """Periodic wrap of positions into [0, L) (store.c:447-475)."""
        L = torch.tensor(boxsize if not np.isscalar(boxsize)
                         else (boxsize,) * 3, dtype=self.x.dtype,
                         device=self.x.device)
        return self.replace(x=self.x - torch.floor(self.x / L) * L)

    def replace(self, **kwargs) -> "Store":
        return dataclasses.replace(self, **kwargs)

    def take(self, index: torch.Tensor, donate: bool = False) -> "Store":
        """Every per-particle column permuted (or selected) by index.
        donate: the caller gives this store up: its columns are replaced
        in it one at a time, each old column let go as its successor is
        made, so that where nothing else holds them the transient is one
        column, not the whole store; the store itself is returned."""
        if not donate:
            return self.replace(**{c: t[index] for c, t in self.columns()})
        for c in COLUMNS:
            if getattr(self, c) is not None:
                setattr(self, c, getattr(self, c)[index])
        return self

    def compact(self) -> "Store":
        """Drop the dead rows (alive == 0). A store without an alive
        column returns itself."""
        if self.alive is None:
            return self
        keep = torch.nonzero(self.alive > 0).reshape(-1)
        return self.take(keep).replace(alive=None, rehome_bucket=None)

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
        rows [N r / P, N (r + 1) / P)) on a Ring or a Grid (rank r = cx
        py + cy). A lattice store is filled in x-major id order, so rank
        r keeps the particles of x-slab r (solver.py:_shard_store); one
        filled pencil-blocked for the grid, those of its pencil."""
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


def _pencil_procmesh(ntask: int):
    """The reference's near-square 2D process mesh factorization
    (pm_init, pmpfft.c:118-134): smallest Ny with Ny^2 >= NTask, backed
    off to a divisor."""
    ny = 1
    while ny * ny < ntask:
        ny += 1
    while ny >= 1:
        if ntask % ny == 0:
            break
        ny -= 1
    return ntask // ny, ny


def _rank_emulated_rand(Nc, seed: int, ntask: int) -> np.ndarray:
    """The reference's rand column, _fastpm_store_fill_rand
    (store.c:693-718): rank 0 seeds ranlxd1 with `seed` directly; rank
    k draws 8k uniforms from a seed-seeded generator and re-seeds with
    0x7fffffff * (the last draw). Each rank fills its (x, y) PENCIL of
    the lattice (the default PFFT 2D decomposition, rank = cx*Ny + cy)
    in row-major (ix, iy, iz) order, so emulating ntask ranks
    reproduces the rand values of an ntask-process reference run
    exactly. ntask=1 is the plain stream. Returns the values (float64)
    in global x-major lattice order."""
    n = int(np.prod(Nc))
    if ntask <= 1:
        return native.ranlxd_uniform(seed, n)
    nx_p, ny_p = _pencil_procmesh(ntask)
    n0, n1, n2 = Nc
    out = np.empty(n, dtype=np.float64)
    view = out.reshape(n0, n1, n2)
    for r in range(ntask):
        if r == 0:
            seed_r = seed
        else:
            u = native.ranlxd_uniform(seed, 8 * r)
            seed_r = int(0x7fffffff * u[-1])
        cx, cy = r // ny_p, r % ny_p
        x0, x1 = cx * n0 // nx_p, (cx + 1) * n0 // nx_p
        y0, y1 = cy * n1 // ny_p, (cy + 1) * n1 // ny_p
        nr = (x1 - x0) * (y1 - y0) * n2
        view[x0:x1, y0:y1, :] = native.ranlxd_uniform(
            seed_r, nr).reshape(x1 - x0, y1 - y0, n2)
    return out


def lattice_store(pm: PM, Nc=None, shift=0.0, columns=("v", "acc", "id"),
                  M0: float = 1.0, name: str = "1",
                  rand_seed: int = 1231584, rand_ntask: int = 1,
                  blocks=None) -> Store:
    """Uniform Lagrangian lattice of Nc^3 particles on pm.device
    (fastpm_store_fill, store.c:723-805): id = raveled lattice index,
    x = q = index * scale + shift. columns may also name "rand" (the
    reference's rank-emulated ranlxd stream of rand_ntask ranks, built
    on the host and copied over), "potential" and "tidal" (zeros).

    blocks=(px, py): the rows in pencil-blocked order (store.py:270-347
    of the JAX package): row block b = i py + j holds the sites with ix
    in x-block i (Nc0 / px wide) and iy in y-block j (Nc1 / py wide),
    x-major within the block, so that a px x py Grid's shard of the rows
    is the rank's pencil. Ids stay the global raveled lattice index."""
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
    if blocks is None:
        s01 = Nc[1] * Nc[2]
        i0 = i // s01
        r = i - i0 * s01
        i1 = r // Nc[2]
        i2 = r - i1 * Nc[2]
    else:
        px, py = int(blocks[0]), int(blocks[1])
        if Nc[0] % px or Nc[1] % py:
            raise ValueError(f"Nc {tuple(Nc)} must divide blocks {blocks}")
        bx, by = Nc[0] // px, Nc[1] // py
        bsz = bx * by * Nc[2]
        b, w = i // bsz, i % bsz
        l0 = w // (by * Nc[2])
        rr = w - l0 * (by * Nc[2])
        i1 = (b % py) * by + rr // Nc[2]
        i2 = rr % Nc[2]
        i0 = (b // py) * bx + l0
        i = (i0 * Nc[1] + i1) * Nc[2] + i2
    idx = torch.stack([i0, i1, i2], dim=-1).to(torch.float32)
    x = (idx * torch.tensor(scale, dtype=torch.float32, device=dev)
         + torch.tensor(shift, dtype=torch.float32, device=dev))

    kw = dict(x=x, a_x=0.0, a_v=0.0, M0=M0, q_shift=tuple(shift),
              q_scale=scale, q_nc=tuple(Nc), name=name,
              home_blocks=None if blocks is None
              else (int(blocks[0]), int(blocks[1])))
    if "v" in columns:
        kw["v"] = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    if "acc" in columns:
        kw["acc"] = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    if "id" in columns:
        kw["id"] = i
    if "rand" in columns:
        # the stream is in x-major lattice order: each row takes its own
        # site's value (its id)
        rand = torch.from_numpy(_rank_emulated_rand(
            Nc, rand_seed, rand_ntask).astype(np.float32)).to(dev)
        kw["rand"] = rand if blocks is None else rand[i]
    if "potential" in columns:
        kw["potential"] = torch.zeros(n, dtype=torch.float32, device=dev)
    if "tidal" in columns:
        kw["tidal"] = torch.zeros((n, 6), dtype=torch.float32, device=dev)
    return Store(**kw)
