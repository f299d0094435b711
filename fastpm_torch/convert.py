"""Carry state across from the JAX package: its arrays, fetched to numpy
by the caller, become port tensors on a given device, so that both
solvers can start from the same state.

- field_from_numpy: a real field (float32) or k-space field such as the
  IC delta_k (complex64, the same (Nx, Ny, Nz//2+1) layout);
- store_from_numpy: particle columns x, v, dx1, dx2, dv1, pgdc (N, 3),
  id (N,), the per-particle mass, rand and aemit (N,), potential (N,)
  and tidal (N, 6) with their a_x / a_v stamps and store metadata.
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
                     rand=None, aemit=None, potential=None, tidal=None,
                     dx1=None, dx2=None, pgdc=None, **meta) -> Store:
    """Particle columns as a port Store on device: every float column
    float32, ids int64. A column given as None stays unallocated. meta
    sets Store metadata (M0, q_shift, q_scale, q_nc, name)."""
    def f32(a):
        if a is None:
            return None
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    def f32_rows(a):
        return None if a is None else f32(a).reshape(-1)

    return Store(
        x=f32(x), v=f32(v), dx1=f32(dx1), dx2=f32(dx2), dv1=f32(dv1),
        pgdc=f32(pgdc), mass=f32_rows(mass),
        rand=f32_rows(rand), aemit=f32_rows(aemit),
        potential=f32_rows(potential), tidal=f32(tidal),
        id=None if id is None else torch.from_numpy(
            np.array(id, dtype=np.int64).reshape(-1)).to(device),
        a_x=float(a_x), a_v=float(a_v), **meta)
