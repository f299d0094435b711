"""Friends-of-friends halo finding and catalogs
(reference: libfastpm/fof.c, rfof.c).

Port of fastpm_tpu/fof.py. find_halos takes one of two paths:
- the device path (find_halos_device, for rows on the card): the cell
  table and one union-find sweep of csrc/fof_link.cu, and segment-sum
  aggregates (ops/fof_device.py); only the nh-row catalog
  crosses to the host, the per-particle halo rows stay on the card;
- the host path (for rows on the CPU, the test oracle): the rows are
  gathered and labelled by the exact grid-hash union-find in native code
  (csrc/fof.c).
Both run periodic (snapshots) or open (lightcone slices, embedded in a
box wide enough that no wrap links). rfof_find_halos is the relaxed FOF
of rfof.c over either path. On ranks the CLI gathers the rows to rank 0
and runs find_halos there (the lightcone's halos too); the sharded FOF
over a ring of ranks, which nothing in the CLI calls (as in the JAX
package), is parallel/pfof.py.

Halo attributes mirror fof.c:820-975: CM position with periodic-safe
averaging, mean velocity, r/v/rv dispersion tensors, length, minid, and
the Lagrangian q average.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import native
from .store import Store

__all__ = ["fof_labels", "HaloCatalog", "find_halos", "find_halos_device",
           "rfof_find_halos"]


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
               boxsize: float, periodic: bool = True) -> np.ndarray:
    """Exact FOF labels: each particle gets the minimum particle index
    of its group. Non-periodic mode (lightcone slices) embeds the points
    in a large enough box that wraps never link."""
    pos = np.ascontiguousarray(pos, dtype=np.float32)
    n = len(pos)
    if n == 0:
        return np.empty(0, dtype=np.int64)
    if not periodic:
        lo = pos.min(axis=0)
        span = float((pos - lo).max())
        boxsize = span + 4.0 * linking_length
        pos = np.ascontiguousarray(pos - lo + linking_length,
                                   dtype=np.float32)
    labels = np.empty(n, dtype=np.int64)
    _fof_lib().fof_label(pos, n, float(linking_length), float(boxsize),
                         labels)
    return labels


def _periodic_mean(x: np.ndarray, labels: np.ndarray, nh: int,
                   counts: np.ndarray, L: float) -> np.ndarray:
    """Per-halo periodic-safe mean of positions (fof.c:periodic_add):
    average offsets relative to a reference member, wrapped to [-L/2,L/2)."""
    # reference position: first (minimum-index) member of each halo;
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
    aemit: Optional[np.ndarray] = None   # f8 (nh,) mean emission a

    @property
    def nhalo(self) -> int:
        return len(self.length)


def _empty_catalog() -> HaloCatalog:
    return HaloCatalog(length=np.zeros(0, np.int32), x=np.zeros((0, 3)),
                       v=np.zeros((0, 3), np.float32),
                       minid=np.zeros(0, np.int64), q=None,
                       rdisp=np.zeros((0, 6), np.float32),
                       vdisp=np.zeros((0, 6), np.float32),
                       rvdisp=np.zeros((0, 9), np.float32))


def find_halos_device(p: Store, linking_length: float, boxsize: float,
                      nmin: int = 20, periodic: bool = True):
    """FOF and the halo catalog on the rows' device: the labels
    (ops/fof_device.fof_labels_device_auto; on the card one launch of
    csrc/fof_link.cu, the label rounds on the CPU) and segment-sum
    aggregates. Only the compacted nh-row catalog crosses to the host
    (reference contract: libfastpm/fof.c:289-420 iterative merge,
    :573-757 MINID-rendezvous attributes).

    Returns (HaloCatalog with numpy columns, ihalo): ihalo (int64, -1
    outside kept halos) stays on the rows' device."""
    from .ops.fof_device import (fof_labels_device_auto, halo_attrs_device,
                                 halo_catalog_device)
    if p.np_local == 0:
        return _empty_catalog(), torch.zeros(0, dtype=torch.int64,
                                             device=p.x.device)
    x = p.x
    L = float(boxsize)
    if not periodic:
        # embed in a box wide enough that wraps never link (the host
        # fof_labels construction)
        lo = x.min(dim=0).values
        L = float((x - lo).max()) + 4.0 * linking_length
        x = x - lo + float(np.float32(linking_length))

    lab = fof_labels_device_auto(x, linking_length, L)
    q = p.q_from_id(p.id) if (p.id is not None and p.q_nc[0] > 0) else None
    v = p.v if p.v is not None else torch.zeros_like(p.x)
    attrs = halo_attrs_device(x, v, p.id, lab, L, int(nmin), q=q,
                              aemit=p.aemit, periodic=periodic)
    del x, v, q
    cat_d, ihalo, nh = halo_catalog_device(attrs, lab)
    del attrs, lab

    def fetch(k, dtype):
        return cat_d[k].cpu().numpy().astype(dtype)

    cmx = fetch("cm", np.float64)
    if not periodic:
        # un-embed the CM back to input coordinates
        cmx = cmx - float(linking_length) + lo.cpu().numpy().astype(
            np.float64)
    cat = HaloCatalog(
        length=fetch("counts", np.int32), x=cmx,
        v=fetch("vm", np.float32),
        minid=(fetch("minid", np.int64) if "minid" in cat_d
               else np.zeros(nh, np.int64)),
        q=fetch("qm", np.float64) if "qm" in cat_d else None,
        rdisp=fetch("rdisp", np.float32), vdisp=fetch("vdisp", np.float32),
        rvdisp=fetch("rvdisp", np.float32),
        aemit=fetch("am", np.float64) if "am" in cat_d else None)
    return cat, ihalo


def find_halos(p: Store, linking_length: float, boxsize: float,
               nmin: int = 20, periodic: bool = True,
               labels: Optional[np.ndarray] = None,
               backend: str = "auto"):
    """Run FOF and build the halo catalog.

    Returns (catalog, ihalo) where ihalo maps each particle to its halo
    row (-1 if not in a kept halo), matching fastpm_fof_execute's return.
    linking_length is in simulation distance units (the caller converts
    from the fraction of mean separation, src/fastpm.c:1280).

    backend: "device" runs find_halos_device on the rows' device (ihalo
    a tensor there); "host" gathers the rows and runs the native
    union-find (ihalo a numpy array; the test oracle); "auto" takes the
    device path for rows on the card and the host path otherwise. Given
    labels, the host path builds the catalog from them."""
    if backend == "auto":
        backend = "device" if p.x.is_cuda else "host"
    if backend not in ("device", "host"):
        raise ValueError(f"unknown FOF backend {backend!r}")
    if backend == "device" and labels is None:
        return find_halos_device(p, linking_length, boxsize, nmin=nmin,
                                 periodic=periodic)
    x = p.x.detach().cpu().numpy().astype(np.float32, copy=False)
    if labels is None:
        labels = fof_labels(x, linking_length, boxsize, periodic=periodic)
    labels = np.asarray(labels)

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
    hrow = ihalo[sel]
    nh = len(keep_rows)
    if nh == 0:
        return _empty_catalog(), ihalo

    counts_k = counts[keep_rows].astype(np.float64)
    xs = x[sel].astype(np.float64)
    L = float(boxsize)

    def mean(a):
        if periodic:
            return _periodic_mean(a, hrow, nh, counts_k, L)
        out = np.zeros((nh, 3))
        np.add.at(out, hrow, a)
        return out / counts_k[:, None]

    cm = mean(xs)

    v = (p.v.detach().cpu().numpy().astype(np.float64)[sel]
         if p.v is not None else None)
    vm = np.zeros((nh, 3))
    if v is not None:
        np.add.at(vm, hrow, v)
        vm /= counts_k[:, None]

    # relative coordinates (periodic-wrapped)
    rrel = xs - cm[hrow]
    if periodic:
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
        q = mean(qs)

    aemit = None
    if p.aemit is not None:
        aemit = np.zeros(nh)
        np.add.at(aemit, hrow,
                  p.aemit.detach().cpu().numpy().astype(np.float64)[sel])
        aemit /= counts_k

    cat = HaloCatalog(
        length=counts[keep_rows].astype(np.int32),
        x=cm, v=vm.astype(np.float32), minid=minid, q=q,
        rdisp=disp6(rrel).astype(np.float32),
        vdisp=disp6(vrel).astype(np.float32),
        rvdisp=rv.astype(np.float32), aemit=aemit)
    return cat, ihalo


# mass bins of the RFOF acceptance, in particle counts (rfof.c:44-50)
_RFOF_NP = [0, 20, 40, 80, 160, 320, 1 << 30]


def _rfof_linking_length(i, z, l1, l6, A1, A2, base_ll):
    """Per-bin linking length in Mpc/h (rfof.c:61-75)."""
    if i == 1:
        return l1 - A1 / (1 + z)
    if i == 6:
        return max(l6 - A2 / (1 + z), base_ll)
    return ((6 - i) * _rfof_linking_length(1, z, l1, l6, A1, A2, base_ll)
            + (i - 1) * _rfof_linking_length(6, z, l1, l6, A1, A2, base_ll)
            ) / 5.0


def _std_vdisp(M, Ez):
    """Fitted halo velocity dispersion in km/s (rfof.c:83-88)."""
    return (Ez * M / 1e15) ** (1.0 / 3) * 1100.0


def rfof_find_halos(p: Store, boxsize: float, z: float, cosmology,
                    nmin: int = 8, linkinglength: float = 0.0,
                    l1: float = 0.0, l6: float = 0.0,
                    A1: float = 0.0, A2: float = 0.0,
                    B1: float = 7.02, B2: float = 6.025,
                    periodic: bool = True):
    """Relaxed FOF (reference: libfastpm/rfof.c:90-186): 6 rounds of FOF
    with mass-bin-dependent linking lengths l(i, z) and the
    velocity-dispersion rejection vdisp < r0 * sigma_std(M, E(z));
    accepted halos' particles are removed from subsequent rounds, as are
    particles not attached to any candidate halo.

    All lengths (linkinglength, l1, l6, A1, A2) are in Mpc/h; the caller
    multiplies the lua parameters by the mean separation
    (src/fastpm.c:1295-1304). p must be in snapshot units (km/s
    velocity). Each round runs find_halos on the active rows (the device
    path for rows on the card). The active set and ihalo stay on the
    rows' device; only each round's candidate catalog and the active
    count cross to the host. Returns (catalog, ihalo tensor)."""
    Ez = cosmology.E(1.0 / (z + 1))
    r0 = B1 - B2 * np.log(1 + z)
    dev = p.x.device
    n = p.np_local
    active = torch.ones(n, dtype=torch.bool, device=dev)
    ihalo = torch.full((n,), -1, dtype=torch.int64, device=dev)
    parts = []
    nsaved = 0

    for i in range(1, 7):
        ll = _rfof_linking_length(i, z, l1, l6, A1, A2, linkinglength)
        idx = torch.nonzero(active).reshape(-1)
        if idx.shape[0] < nmin:
            break
        sub = Store(x=p.x[idx],
                    v=p.v[idx] if p.v is not None else None,
                    id=p.id[idx] if p.id is not None else None,
                    aemit=p.aemit[idx] if p.aemit is not None else None,
                    q_shift=p.q_shift, q_scale=p.q_scale, q_nc=p.q_nc,
                    a_x=p.a_x, a_v=p.a_v, M0=p.M0)
        cat, icand = find_halos(sub, ll, boxsize, nmin=nmin,
                                periodic=periodic)
        icand = torch.as_tensor(icand, device=dev).to(torch.int64)
        del sub

        # acceptance (rfof.c:137-151): host math on the small catalog
        if cat.nhalo:
            vdisp = np.sqrt(cat.vdisp[:, 0] + cat.vdisp[:, 1]
                            + cat.vdisp[:, 2])
            M = p.M0 * 1e10 * cat.length.astype(np.float64)
            save = ((cat.length < _RFOF_NP[i])
                    & (vdisp < r0 * _std_vdisp(M, Ez)))
        else:
            save = np.zeros(0, dtype=bool)

        # saved halos: record ihalo, deactivate members; particles not
        # in any candidate halo leave the active set (rfof.c:152-173)
        save_rows = np.flatnonzero(save)
        row_map = np.full(max(cat.nhalo, 1), -1, dtype=np.int64)
        row_map[save_rows] = nsaved + np.arange(len(save_rows))
        mapped = torch.where(
            icand >= 0,
            torch.from_numpy(row_map).to(dev)[icand.clamp(min=0)], -1)
        in_saved = mapped >= 0
        ihalo[idx] = torch.where(in_saved, mapped, ihalo[idx])
        active[idx] = ~((icand < 0) | in_saved)

        if len(save_rows):
            parts.append((cat, save_rows))
            nsaved += len(save_rows)

    if not parts:
        return _empty_catalog(), ihalo

    def cc(field):
        arrs = [getattr(c, field)[rows] for c, rows in parts
                if getattr(c, field) is not None]
        return np.concatenate(arrs) if arrs else None

    cat = HaloCatalog(length=cc("length"), x=cc("x"), v=cc("v"),
                      minid=cc("minid"), q=cc("q"), rdisp=cc("rdisp"),
                      vdisp=cc("vdisp"), rvdisp=cc("rvdisp"),
                      aemit=cc("aemit"))
    return cat, ihalo
