"""Angular source grids for lightcones (reference:
libfastpmio/io.c:827-953 read_angular_grid).

Port of fastpm_tpu/io/angular.py. A bigfile with 1D "RA" and "DEC"
blocks (degrees) defines sky directions; the grid store is the outer
product of those directions (strided by sampling_factor) with radial
shells r[j], each shell stamped with aemit[j]. DEC follows the
reference's convention: colatitude theta = pi/2 - dec. The directions
are computed on the host in float64; the store's columns are float32
tensors on the caller's device."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .bigfile import BigFile
from ..device import resolve_device
from ..store import Store

__all__ = ["read_angular_grid", "angular_grid_size"]


def _directions(path: str, sampling_factor: int):
    bf = BigFile(path)
    ra = np.asarray(bf.open_block("RA").read_all(), dtype=np.float64)
    dec = np.asarray(bf.open_block("DEC").read_all(), dtype=np.float64)
    if len(ra) != len(dec):
        raise ValueError("RA and DEC blocks differ in length")
    ra = np.deg2rad(ra[::sampling_factor])
    theta = np.pi / 2 - np.deg2rad(dec[::sampling_factor])
    x = np.sin(theta) * np.cos(ra)
    y = np.sin(theta) * np.sin(ra)
    z = np.cos(theta)
    return np.stack([x, y, z], axis=-1)


def angular_grid_size(path: str, Nr: int, sampling_factor: int = 1) -> int:
    """Number of grid points read_angular_grid would generate (the
    store==NULL branch of io.c:864-870)."""
    n = len(BigFile(path).open_block("RA").read_all())
    return ((n + sampling_factor - 1) // sampling_factor) * Nr


def read_angular_grid(path: str, r, aemit, sampling_factor: int = 1,
                      store: Optional[Store] = None,
                      device=None) -> Store:
    """Build (or append to) a store of lightcone source-grid points:
    one point per (direction, shell) at x = dir * r[j], aemit =
    aemit[j] (io.c:931-945). Positions are in the lightcone observer
    frame (not box-wrapped), matching the reference. A new store lives
    on `device` (default: the first CUDA device; raises when there is
    none); an appended one on the store's device."""
    r = np.asarray(r, dtype=np.float64)
    aemit = np.asarray(aemit, dtype=np.float64)
    if len(r) != len(aemit):
        raise ValueError("r and aemit must have the same length")
    dirs = _directions(path, sampling_factor)
    # outer product: shell-major like the reference's j-outer loop
    x = (dirs[None, :, :] * r[:, None, None]).reshape(-1, 3)
    a = np.repeat(aemit, len(dirs))
    dev = store.x.device if store is not None else resolve_device(device)
    xs = torch.from_numpy(x.astype(np.float32)).to(dev)
    aa = torch.from_numpy(a.astype(np.float32)).to(dev)
    if store is not None:
        return store.replace(x=torch.cat([store.x, xs]),
                             aemit=torch.cat([store.aemit, aa]))
    return Store(x=xs, aemit=aa, M0=1.0)
