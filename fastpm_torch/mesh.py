"""The particle-mesh object: geometry, k tables, FFT conventions.

Port of fastpm_tpu/mesh.py. A `PM` holds static metadata (mesh shape,
box size, 1D Fourier tables) and the device its fields live on; fields
are plain torch tensors:

- real space: (Nx, Ny, Nz) float32
- k space:    (Nx, Ny, Nz//2 + 1) complex64 (the rfftn layout; the last
  axis is the halved hermitian axis, pmpfft.c:198-202)

FFT normalization mirrors pm_r2c (pmpfft.c:370-399): r2c multiplies by
1/Norm so the r2c . c2r round trip is unitary. The FFT is torch.fft
(cuFFT on the card, pocketfft on the CPU).

All Fourier-space kernels are products/sums of per-dimension 1D tables
(pm_create_k_factors, pmapi.c:224-275), which broadcast naturally.
"""

from __future__ import annotations

from functools import cached_property

import numpy as np
import torch

__all__ = ["PM"]


def _sinc(x: np.ndarray) -> np.ndarray:
    """sin(x)/x with the reference's small-x series (pmapi.c:213-220)."""
    x = np.asarray(x, dtype=np.float64)
    small = np.abs(x) < 1e-5
    xs = np.where(small, 1.0, x)
    return np.where(small, 1.0 - x * x / 6.0 + x ** 4 / 120.0,
                    np.sin(xs) / xs)


def _diff_kernel(w: np.ndarray) -> np.ndarray:
    """Order-1 super-Lanczos finite difference kernel in Fourier space,
    same as GADGET (pmapi.c:222-232)."""
    return 1.0 / 6.0 * (8 * np.sin(w) - np.sin(2 * w))


class PM:
    """Mesh geometry + Fourier tables (no field storage)."""

    def __init__(self, Nmesh, BoxSize, device="cpu"):
        if np.isscalar(Nmesh):
            Nmesh = (int(Nmesh),) * 3
        if np.isscalar(BoxSize):
            BoxSize = (float(BoxSize),) * 3
        self.Nmesh = tuple(int(n) for n in Nmesh)
        self.BoxSize = tuple(float(b) for b in BoxSize)
        for n in self.Nmesh:
            if n % 2 != 0:
                # pmpfft.c:143-145
                raise ValueError("Nmesh must be even")
        self.device = torch.device(device)
        self.dtype = torch.float32
        self.cdtype = torch.complex64

        self.Norm = float(np.prod(np.array(self.Nmesh, dtype=np.float64)))
        self.Volume = float(np.prod(self.BoxSize))
        self.CellSize = tuple(b / n for b, n in zip(self.BoxSize, self.Nmesh))
        self.InvCellSize = tuple(1.0 / c for c in self.CellSize)

        self.kshape = (self.Nmesh[0], self.Nmesh[1], self.Nmesh[2] // 2 + 1)
        self.rshape = self.Nmesh
        self._dev_cache = {}

    # ---- k tables (host, float64) ----

    @cached_property
    def _tables(self):
        """Per-dimension 1D tables over the FULL mesh length; axis 2 is
        sliced to the hermitian half when broadcast."""
        k, k_finite, kk, kk_finite, kk_finite2 = [], [], [], [], []
        for d in range(3):
            n = self.Nmesh[d]
            cell = self.CellSize[d]
            i = np.arange(n)
            ii = np.where(i >= n // 2, i - n, i)
            kd = ii * (2 * np.pi / self.BoxSize[d])
            w = kd * cell
            ff1 = _sinc(0.5 * w)
            ff2 = _sinc(w)
            # the reference stores the tables at float32 precision
            # (pmapi.c uses float arrays); kernels are computed from them
            k.append(kd.astype(np.float32).astype(np.float64))
            k_finite.append((_diff_kernel(w) / cell).astype(np.float32)
                            .astype(np.float64))
            kk.append((kd * kd).astype(np.float32).astype(np.float64))
            kk_finite.append((kd * kd * ff1 * ff1).astype(np.float32)
                             .astype(np.float64))
            kk_finite2.append((kd * kd * (4 / 3.0 * ff1 * ff1
                                          - 1 / 3.0 * ff2 * ff2))
                              .astype(np.float32).astype(np.float64))
        return dict(k=k, k_finite=k_finite, kk=kk,
                    kk_finite=kk_finite, kk_finite2=kk_finite2)

    def k_index(self, d: int) -> np.ndarray:
        """The indices along dimension d of the k grid that this PM's
        k-space arrays hold: every plane in x and y, the hermitian half
        in z. A rank's k shard holds a slice in y
        (parallel.pfft.KShard)."""
        n = self.Nmesh[d]
        return np.arange(n // 2 + 1 if d == 2 else n)

    def table(self, name: str, d: int) -> np.ndarray:
        """1D table `name` along dimension d at the k grid's indices
        (axis 2 is the hermitian half-length)."""
        return self._tables[name][d][self.k_index(d)]

    def _const(self, key, make):
        """Device copy of a small host constant, made once per PM."""
        t = self._dev_cache.get(key)
        if t is None:
            t = make()
            self._dev_cache[key] = t
        return t

    def broadcast(self, values: np.ndarray, d: int) -> torch.Tensor:
        """A 1D host array along axis d as a float32 device tensor shaped
        for broadcasting over k-space."""
        shape = [1, 1, 1]
        shape[d] = len(values)
        return torch.as_tensor(np.asarray(values).reshape(shape),
                               dtype=self.dtype, device=self.device)

    def broadcast_table(self, name: str, d: int) -> torch.Tensor:
        """Table as a float32 tensor shaped for broadcasting over
        k-space."""
        return self._const(("table", name, d),
                           lambda: self.broadcast(self.table(name, d), d))

    @cached_property
    def nyquist_masks_1d(self):
        """The three 1D factors of the self-conjugate mask (numpy bool):
        every coordinate is 0 or Nyquist (gravity.c:48-56); the 3D mask
        is their outer product."""
        out = []
        for d in range(3):
            n = self.Nmesh[d]
            i = self.k_index(d)
            out.append(i == (n - i) % n)
        return tuple(out)

    def not_self_conjugate(self) -> torch.Tensor:
        """Float (kshape-broadcastable) factor 1 - m0 m1 m2 that zeroes
        the self-conjugate modes."""
        def make():
            m0, m1, m2 = (self.broadcast(m.astype(np.float32), d)
                          for d, m in enumerate(self.nyquist_masks_1d))
            return 1.0 - m0 * m1 * m2
        return self._const("not_self_conjugate", make)

    def hermitian_weights(self) -> torch.Tensor:
        """Float (1,1,Nz/2+1) weights: 2 for modes whose conjugate lives
        outside the compressed array, 1 on the kz=0 and kz=Nyquist planes
        (powerspectrum.c:92-94, pm_compute_variance pmapi.c:290-308)."""
        def make():
            nz = self.Nmesh[2]
            iz = np.arange(nz // 2 + 1)
            w = np.where((iz == 0) | (iz == nz // 2), 1.0, 2.0)
            return self.broadcast(w, 2)
        return self._const("hermitian_weights", make)

    def integer_kk(self) -> torch.Tensor:
        """Integer |ik|^2 on the k grid (int64, full kshape), for shell
        binning."""
        out = 0
        for d in range(3):
            n = self.Nmesh[d]
            i = self.k_index(d)
            ii = np.where(i > n // 2, i - n, i).astype(np.int64)
            shape = [1, 1, 1]
            shape[d] = len(i)
            out = out + torch.as_tensor((ii * ii).reshape(shape),
                                        device=self.device)
        return out

    def kk(self, name: str = "kk") -> torch.Tensor:
        """Sum of the three broadcast float32 tables `name` (|k|^2 on the
        k grid, full kshape)."""
        return (self.broadcast_table(name, 0) + self.broadcast_table(name, 1)
                + self.broadcast_table(name, 2))

    # ---- FFTs (pmpfft.c:370-399) ----

    def r2c(self, x: torch.Tensor) -> torch.Tensor:
        """Real -> complex with 1/Norm so the round trip is unitary."""
        return (torch.fft.rfftn(x) / self.Norm).to(self.cdtype)

    def c2r(self, k: torch.Tensor) -> torch.Tensor:
        """Complex -> real, inverse of r2c."""
        return torch.fft.irfftn(k * self.Norm, s=self.Nmesh).to(self.dtype)

    def c2r_grad3(self, fk: torch.Tensor, gradorder: int):
        """The force step's three gradient returns:
        (c2r(i k_d * fk) for d in x, y, z), with the diff table order
        per kernel (0 = k, 1 = k_finite super-Lanczos) and apply_diff's
        self-conjugate-mode zeroing (gravity.c:34-64). Three plain c2r
        calls, one field at a time."""
        from . import transfers
        return tuple(self.c2r(transfers.apply_grad(self, fk, d, gradorder))
                     for d in range(3))

    # ---- diagnostics ----

    def compute_variance(self, delta_k: torch.Tensor) -> float:
        """sum of w |delta_k|^2 / Norm (pm_compute_variance,
        pmapi.c:290-308), accumulated in float64."""
        w = self.hermitian_weights().double()
        y = (delta_k.real.double() ** 2 + delta_k.imag.double() ** 2) * w
        return float(y.sum()) / self.Norm

    def __repr__(self):
        return f"PM(Nmesh={self.Nmesh}, BoxSize={self.BoxSize})"
