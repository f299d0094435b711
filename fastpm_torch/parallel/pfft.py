"""Distributed 3D real FFT over a ring of ranks (slab decomposition).

Port of the slab engine of fastpm_tpu/parallel/pfft.py (SlabPM,
pfft.py:67-342): per-axis batched FFTs (torch.fft: cuFFT on the card)
and one all_to_all transpose (parallel.comm.Ring).

Layouts (P = number of ranks):
- real space: global (Nx, Ny, Nz), one x-slab (Nx/P, Ny, Nz) per rank;
- k space: global (Nx, Ny, Nz/2+1), one y shard (Nx, Ny/P, Nz/2+1) per
  rank, the transposed-out layout of the reference (pmpfft.c:198-202)
  that keeps every kx on every rank.

The transfers of a k shard are the single-device ones (transfers.py,
kernels.py) applied with the rank's KShard, whose 1D tables along y are
the rank's slice. The TPU package's fused matmul-DFT three-gradient
inverse is a TPU mechanism: c2r_grad3_local is three c2r_local calls.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mesh import PM
from .. import kernels, transfers
from .comm import Ring

__all__ = ["SlabPM", "KShard"]


class KShard(PM):
    """The k-space geometry of one rank's shard (Nx, Ny/P, Nz/2+1): a PM
    whose k tables, masks and integer |k|^2 along y are the rank's rows.
    Its r2c and c2r are not the shard's: SlabPM has those."""

    def __init__(self, pm: PM, ring: Ring):
        super().__init__(pm.Nmesh, pm.BoxSize, device=pm.device)
        ny = pm.Nmesh[1] // ring.nproc
        self.y0 = ring.rank * ny
        self.kshape = (pm.Nmesh[0], ny, pm.Nmesh[2] // 2 + 1)

    def k_index(self, d: int) -> np.ndarray:
        i = super().k_index(d)
        return i[self.y0:self.y0 + self.kshape[1]] if d == 1 else i


class SlabPM:
    """PM engine over the slab decomposition of a ring of ranks: a host
    PM (geometry) plus shard-local FFTs and transfers."""

    def __init__(self, pm: PM, ring: Ring):
        self.pm = pm
        self.ring = ring
        self.nproc = ring.nproc
        n0, n1, n2 = pm.Nmesh
        if n0 % self.nproc or n1 % self.nproc:
            raise ValueError("Nmesh must divide the number of ranks "
                             "(pm_unbalanced, solver.c:113-121)")
        self.rshard = (n0 // self.nproc, n1, n2)
        self.kpm = KShard(pm, ring)
        self.kshard = self.kpm.kshape

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

    def c2r_grad3_local(self, pot_k: torch.Tensor, gradorder: int):
        """The force step's three gradient inverses: c2r_local(i k_d
        pot_k) for d in x, y, z, one field at a time."""
        return tuple(self.c2r_local(self.apply_grad(pot_k, d, gradorder))
                     for d in range(3))

    # ---- shard-local transfers (transfers.py on the k shard) ----

    def apply_pot(self, dk, order: int):
        return transfers.apply_pot(self.kpm, dk, order)

    def apply_grad(self, dk, dir: int, order: int):
        return transfers.apply_grad(self.kpm, dk, dir, order)

    def apply_decic(self, dk):
        return transfers.apply_decic(self.kpm, dk)

    def apply_softening(self, dk, softening_type: str):
        return kernels.apply_softening(self.kpm, dk, softening_type)

    # ---- canvas collectives (paint reduce / readout gather) ----

    def reduce_canvas(self, canvas_full: torch.Tensor) -> torch.Tensor:
        """Full local canvas -> this rank's summed x-slab (ghost reduce)."""
        return self.ring.psum_scatter(canvas_full)

    def gather_canvas(self, local: torch.Tensor) -> torch.Tensor:
        """x-slab -> the full field on every rank (readout gather)."""
        return self.ring.all_gather(local)
