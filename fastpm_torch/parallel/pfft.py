"""Distributed 3D real FFT over the ranks: the slab decomposition over a
ring, and the pencil (2D) decomposition over a grid.

Port of fastpm_tpu/parallel/pfft.py (SlabPM, pfft.py:67-342; PencilPM,
:344-598): per-axis batched FFTs (torch.fft: cuFFT on the card) and
all_to_all transposes (parallel.comm). The Solver picks the engine, as
make_engine (:55-65) does by the mesh's axes.

Slab layouts (P = number of ranks):
- real space: global (Nx, Ny, Nz), one x-slab (Nx/P, Ny, Nz) per rank;
- k space: global (Nx, Ny, Nz/2+1), one y shard (Nx, Ny/P, Nz/2+1) per
  rank, the transposed-out layout of the reference (pmpfft.c:198-202)
  that keeps every kx on every rank.

Pencil layouts (a Px x Py grid):
- real space: one pencil (Nx/Px, Ny/Py, Nz) per rank;
- k space: one shard (Nx, Ny/Px, Nzp/Py) per rank, Nzp being Nz/2+1
  padded up to a multiple of Py; the modes of the pad are zero and ride
  along through the transfers (their tables are zero there).

The transfers of a k shard are the single-device ones (transfers.py,
kernels.py, the force's k-space stage gravity.acc_fields) applied with
the rank's KShard (engine.kpm), whose 1D tables along y (and z) are the
rank's slice. The TPU package's fused matmul-DFT three-gradient inverse
is a TPU mechanism: the force's three gradients take three c2r_local
calls.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mesh import PM
from .comm import Ring, Grid

__all__ = ["SlabPM", "PencilPM", "KShard"]


class KShard(PM):
    """The k-space geometry of one rank's shard (Nx, ny, nz): a PM whose
    k tables, masks and integer |k|^2 along y are the rows [y0, y0 + ny)
    and along z the columns [z0, z0 + nz). Columns at or past Nz/2+1
    (the pencil's kz pad) have zero tables and hermitian weight 0, so
    their modes stay zero through the transfers and enter no P(k) bin
    (pfft.py:530-545). Its r2c and c2r are not the shard's: SlabPM and
    PencilPM have those."""

    def __init__(self, pm: PM, y0: int, ny: int, z0: int = 0,
                 nz: int = None):
        super().__init__(pm.Nmesh, pm.BoxSize, device=pm.device)
        self.y0, self.z0 = y0, z0
        nzh = pm.Nmesh[2] // 2 + 1
        self.kshape = (pm.Nmesh[0], ny, nzh - z0 if nz is None else nz)

    def k_index(self, d: int) -> np.ndarray:
        if d == 0:
            return super().k_index(0)
        lo = self.y0 if d == 1 else self.z0
        return np.arange(lo, lo + self.kshape[d])

    def table(self, name: str, d: int) -> np.ndarray:
        if d != 2:
            return super().table(name, d)
        nzh = self.Nmesh[2] // 2 + 1
        i = self.k_index(2)
        t = self._tables[name][2][np.minimum(i, nzh - 1)]
        return np.where(i < nzh, t, 0.0)

    def trimmed(self) -> "KShard":
        """This shard without its kz pad: the columns below Nz/2+1."""
        nzh = self.Nmesh[2] // 2 + 1
        return KShard(self, self.y0, self.kshape[1], self.z0,
                      max(0, min(self.kshape[2], nzh - self.z0)))


class SlabPM:
    """PM engine over the slab decomposition of a ring of ranks: a host
    PM (geometry), the k shard's geometry (kpm) and shard-local FFTs."""

    def __init__(self, pm: PM, ring: Ring):
        self.pm = pm
        self.ring = ring
        self.nproc = ring.nproc
        n0, n1, n2 = pm.Nmesh
        if n0 % self.nproc or n1 % self.nproc:
            raise ValueError("Nmesh must divide the number of ranks "
                             "(pm_unbalanced, solver.c:113-121)")
        self.rshard = (n0 // self.nproc, n1, n2)
        self.kpm = KShard(pm, ring.rank * (n1 // self.nproc),
                          n1 // self.nproc)
        self.kshard = self.kpm.kshape
        # the shard as the force hands delta_k on (no pad to drop)
        self.kpm_out = self.kpm

    @property
    def r0(self) -> int:
        """The first x plane of this rank's slab."""
        return self.ring.rank * self.rshard[0]

    # ---- shard-local FFTs ----

    def r2c_local(self, x_slab: torch.Tensor) -> torch.Tensor:
        """x-slab (Nx/P, Ny, Nz) -> y shard of k (Nx, Ny/P, Nz/2+1),
        normalized by 1/Norm like pm_r2c."""
        k = torch.fft.rfftn(x_slab, dim=(1, 2))
        k = self.ring.all_to_all(k, split_dim=1, concat_dim=0)
        return (torch.fft.fft(k, dim=0) / self.pm.Norm).to(self.pm.cdtype)

    def c2r_local(self, k_shard: torch.Tensor) -> torch.Tensor:
        """Inverse of r2c_local."""
        pm = self.pm
        k = torch.fft.ifft(k_shard * pm.Norm, dim=0)
        k = self.ring.all_to_all(k, split_dim=0, concat_dim=1)
        x = torch.fft.irfftn(k, s=(pm.Nmesh[1], pm.Nmesh[2]), dim=(1, 2))
        return x.to(pm.dtype)

    # ---- canvas collectives (paint reduce / readout gather) ----

    def reduce_canvas(self, canvas_full: torch.Tensor) -> torch.Tensor:
        """Full local canvas -> this rank's summed x-slab (ghost reduce)."""
        return self.ring.psum_scatter(canvas_full)

    def gather_canvas(self, local: torch.Tensor) -> torch.Tensor:
        """x-slab -> the full field on every rank (readout gather)."""
        return self.ring.all_gather(local)


class PencilPM:
    """PM engine over the pencil decomposition of a px x py Grid (the
    reference's default PFFT 2D decomposition, pmpfft.c:108-260): a host
    PM (geometry), the k shard's geometry (kpm) and shard-local FFTs.

    r2c: rfft(z) -> pad z -> all_to_all over the y-ring (z <-> y) ->
    fft(y) -> all_to_all over the x-ring (y <-> x) -> fft(x)
    (pfft.py:393-429); c2r is its inverse."""

    def __init__(self, pm: PM, grid: Grid):
        self.pm = pm
        self.grid = grid
        self.ring = grid.flat
        self.px, self.py = grid.px, grid.py
        n0, n1, n2 = pm.Nmesh
        self.nzh = n2 // 2 + 1
        self.nzp = -(-self.nzh // self.py) * self.py
        if n0 % self.px or n1 % self.py or n1 % self.px:
            raise ValueError("Nmesh must divide the 2D process grid "
                             "(pm_unbalanced, solver.c:113-121)")
        self.rshard = (n0 // self.px, n1 // self.py, n2)
        nyk, nzk = n1 // self.px, self.nzp // self.py
        self.kpm = KShard(pm, grid.cx * nyk, nyk, grid.cy * nzk, nzk)
        self.kshard = self.kpm.kshape
        # the shard as the force hands delta_k on: without the kz pad
        # (solver.py:872-875)
        self.kpm_out = self.kpm.trimmed()

    @property
    def r0(self):
        """The first x plane and y row of this rank's pencil."""
        return self.grid.cx * self.rshard[0], self.grid.cy * self.rshard[1]

    # ---- shard-local FFTs ----

    def r2c_local(self, x_pencil: torch.Tensor) -> torch.Tensor:
        """Pencil (Nx/Px, Ny/Py, Nz) -> k shard (Nx, Ny/Px, Nzp/Py),
        normalized by 1/Norm like pm_r2c; the pad's modes are zero."""
        h = torch.fft.rfft(x_pencil, dim=2)
        if self.nzp != self.nzh:
            h = torch.nn.functional.pad(h, (0, self.nzp - self.nzh))
        h = self.grid.yring.all_to_all(h, split_dim=2, concat_dim=1)
        h = torch.fft.fft(h, dim=1)
        h = self.grid.xring.all_to_all(h, split_dim=1, concat_dim=0)
        return (torch.fft.fft(h, dim=0) / self.pm.Norm).to(self.pm.cdtype)

    def c2r_local(self, k_shard: torch.Tensor) -> torch.Tensor:
        """Inverse of r2c_local; the pad is dropped before the z
        inverse."""
        pm = self.pm
        k = torch.fft.ifft(k_shard * pm.Norm, dim=0)
        k = self.grid.xring.all_to_all(k, split_dim=0, concat_dim=1)
        k = torch.fft.ifft(k, dim=1)
        k = self.grid.yring.all_to_all(k, split_dim=1, concat_dim=2)
        x = torch.fft.irfft(k[:, :, :self.nzh], n=pm.Nmesh[2], dim=2)
        return x.to(pm.dtype)

    # ---- canvas collectives (paint reduce / readout gather) ----

    def reduce_canvas(self, canvas_full: torch.Tensor) -> torch.Tensor:
        """Full local canvas -> this rank's summed pencil (ghost
        reduce): over the x-ring along x, then the y-ring along y."""
        c = self.grid.xring.psum_scatter(canvas_full)
        c = self.grid.yring.psum_scatter(c.transpose(0, 1))
        return c.transpose(0, 1).contiguous()

    def gather_canvas(self, local: torch.Tensor) -> torch.Tensor:
        """Pencil -> the full field on every rank (readout gather): the
        x-ring along x first, then the y-ring along y."""
        c = self.grid.xring.all_gather(local)
        c = self.grid.yring.all_gather(c.transpose(0, 1))
        return c.transpose(0, 1).contiguous()
