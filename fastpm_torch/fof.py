"""Friends-of-friends halo finding and catalogs
(reference: libfastpm/fof.c).

Port of the host path of fastpm_tpu/fof.py: halo finding runs on the
host over the gathered snapshot (exact grid-hash union-find in native
code, csrc/fof.c). The device label-propagation FOF and RFOF are later
slices of the port.

Halo attributes mirror fof.c:820-975: CM position with periodic-safe
averaging, mean velocity, r/v/rv dispersion tensors, length, minid, and
the Lagrangian q average.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import numpy as np

from . import native
from .store import Store

__all__ = ["fof_labels", "HaloCatalog", "find_halos"]


def _fof_lib():
    lib = native.get_lib()
    if not hasattr(lib, "fof_label"):
        raise RuntimeError("native library missing fof_label")
    lib.fof_label.restype = ctypes.c_int
    lib.fof_label.argtypes = [
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_double, ctypes.c_double,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")]
    return lib


def fof_labels(pos: np.ndarray, linking_length: float,
               boxsize: float) -> np.ndarray:
    """Exact periodic FOF labels: each particle gets the minimum particle
    index of its group."""
    pos = np.ascontiguousarray(pos, dtype=np.float32)
    n = len(pos)
    if n == 0:
        return np.empty(0, dtype=np.int64)
    labels = np.empty(n, dtype=np.int64)
    _fof_lib().fof_label(pos, n, float(linking_length), float(boxsize),
                         labels)
    return labels


def _periodic_mean(x: np.ndarray, labels: np.ndarray, nh: int,
                   counts: np.ndarray, L: float) -> np.ndarray:
    """Per-halo periodic-safe mean of positions (fof.c:periodic_add):
    average offsets relative to a reference member, wrapped to [-L/2,L/2)."""
    # reference position: first (minimum-index) member of each halo
    first = np.full(nh, -1, dtype=np.int64)
    # labels are min particle index -> the reference member IS the label
    # after relabeling; build mapping halo -> a member index
    order = np.argsort(labels, kind="stable")
    starts = np.searchsorted(labels[order], np.arange(nh))
    ref_idx = order[starts]
    ref = x[ref_idx]                       # (nh, d)
    rel = x - ref[labels]
    rel -= np.round(rel / L) * L
    sums = np.zeros((nh, x.shape[1]))
    np.add.at(sums, labels, rel)
    mean = ref + sums / counts[:, None]
    mean -= np.floor(mean / L) * L
    return mean


@dataclass
class HaloCatalog:
    """Halo catalog columns (the LL-%05.3f dataset layout, io.c map)."""
    length: np.ndarray        # i4 (nh,)
    x: np.ndarray             # f8 (nh,3) CM position
    v: np.ndarray             # f4 (nh,3) mean velocity
    minid: np.ndarray         # i8
    q: Optional[np.ndarray]   # f4 (nh,3) mean Lagrangian position
    rdisp: np.ndarray         # f4 (nh,6) xx yy zz xy yz zx
    vdisp: np.ndarray         # f4 (nh,6)
    rvdisp: np.ndarray        # f4 (nh,9)

    @property
    def nhalo(self) -> int:
        return len(self.length)


def find_halos(p: Store, linking_length: float, boxsize: float,
               nmin: int = 20):
    """Run FOF on the host and build the halo catalog.

    Returns (catalog, ihalo) where ihalo maps each particle to its halo
    row (-1 if not in a kept halo), matching fastpm_fof_execute's return.
    linking_length is in simulation distance units (the caller converts
    from the fraction of mean separation, src/fastpm.c:1280)."""
    x = p.x.detach().cpu().numpy().astype(np.float32, copy=False)
    n = len(x)
    labels = fof_labels(x, linking_length, boxsize)

    # compact labels
    uniq, compact = np.unique(labels, return_inverse=True)
    counts = np.bincount(compact)
    keep = counts >= nmin
    nh_all = len(uniq)

    # relabel kept halos to consecutive rows, ordered by min particle
    # index (the reference's minid ordering before any sorting)
    keep_rows = np.flatnonzero(keep)
    row_of = np.full(nh_all, -1, dtype=np.int64)
    row_of[keep_rows] = np.arange(len(keep_rows))
    ihalo = row_of[compact]

    sel = ihalo >= 0
    hl = compact[sel]
    hrow = ihalo[sel]
    nh = len(keep_rows)
    if nh == 0:
        empty = lambda *s: np.zeros(s)
        cat = HaloCatalog(length=np.zeros(0, np.int32), x=empty(0, 3),
                          v=empty(0, 3), minid=np.zeros(0, np.int64),
                          q=None, rdisp=empty(0, 6), vdisp=empty(0, 6),
                          rvdisp=empty(0, 9))
        return cat, ihalo

    counts_k = counts[keep_rows].astype(np.float64)
    xs = x[sel].astype(np.float64)
    L = float(boxsize)

    cm = _periodic_mean(xs, hrow, nh, counts_k, L)

    v = (p.v.detach().cpu().numpy().astype(np.float64)[sel]
         if p.v is not None else None)
    vm = np.zeros((nh, 3))
    if v is not None:
        np.add.at(vm, hrow, v)
        vm /= counts_k[:, None]

    # relative coordinates (periodic-wrapped)
    rrel = xs - cm[hrow]
    rrel -= np.round(rrel / L) * L
    vrel = (v - vm[hrow]) if v is not None else np.zeros_like(rrel)

    def disp6(a):
        out = np.zeros((nh, 6))
        comp = np.stack([a[:, 0] * a[:, 0], a[:, 1] * a[:, 1],
                         a[:, 2] * a[:, 2], a[:, 0] * a[:, 1],
                         a[:, 1] * a[:, 2], a[:, 2] * a[:, 0]], axis=-1)
        np.add.at(out, hrow, comp)
        return out / counts_k[:, None]

    rv = np.zeros((nh, 9))
    comp9 = np.stack([rrel[:, d] * vrel[:, (d + k) % 3]
                      for k in range(3) for d in range(3)], axis=-1)
    np.add.at(rv, hrow, comp9)
    rv /= counts_k[:, None]

    minid = np.zeros(nh, dtype=np.int64)
    if p.id is not None:
        ids = p.id.detach().cpu().numpy().astype(np.int64)[sel]
        minid = np.full(nh, np.iinfo(np.int64).max)
        np.minimum.at(minid, hrow, ids)
    q = None
    if p.id is not None and p.q_nc[0] > 0:
        qs = p.q_from_id(p.id).cpu().numpy().astype(np.float64)[sel]
        q = _periodic_mean(qs, hrow, nh, counts_k, L)

    cat = HaloCatalog(
        length=counts[keep_rows].astype(np.int32),
        x=cm, v=vm.astype(np.float32), minid=minid, q=q,
        rdisp=disp6(rrel).astype(np.float32),
        vdisp=disp6(vrel).astype(np.float32),
        rvdisp=rv.astype(np.float32))
    return cat, ihalo
