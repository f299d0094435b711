"""Carry state across from the JAX package: its arrays, fetched to numpy
by the caller, become port tensors on a given device, so that both
solvers can start from the same state.

- field_from_numpy: a real field (float32) or k-space field such as the
  IC delta_k (complex64, the same (Nx, Ny, Nz//2+1) layout);
- store_from_numpy: particle columns x, v, dv1 (N, 3), id (N,) and the
  per-particle mass (N,) with their a_x / a_v stamps and store metadata.
"""

from __future__ import annotations

import numpy as np
import torch

from .store import Store

__all__ = ["field_from_numpy", "store_from_numpy"]


def field_from_numpy(a, device) -> torch.Tensor:
    """A numpy field as a float32 (real) or complex64 (complex) tensor on
    device."""
    a = np.asarray(a)
    dtype = np.complex64 if np.iscomplexobj(a) else np.float32
    return torch.from_numpy(np.array(a, dtype=dtype)).to(device)


def store_from_numpy(x, v=None, id=None, a_x: float = 0.0,
                     a_v: float = 0.0, device="cpu", mass=None, dv1=None,
                     **meta) -> Store:
    """Particle columns as a port Store on device: positions, velocities,
    dv1 and masses float32, ids int64. A column given as None stays
    unallocated. meta sets Store metadata (M0, q_shift, q_scale, q_nc,
    name)."""
    def f32(a):
        if a is None:
            return None
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    return Store(
        x=f32(x), v=f32(v), dv1=f32(dv1),
        mass=None if mass is None else f32(mass).reshape(-1),
        id=None if id is None else torch.from_numpy(
            np.array(id, dtype=np.int64).reshape(-1)).to(device),
        a_x=float(a_x), a_v=float(a_v), **meta)
