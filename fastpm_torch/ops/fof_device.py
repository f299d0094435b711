"""Friends-of-friends labels and halo aggregates on the device, by
iterated label propagation (port of fastpm_tpu/ops/fof_device.py).

1. hash the particles to linking-length cells and sort them by cell id
   (int64 ids: no wrap at any cell count);
2. per round: every particle takes the least label over its linked
   neighbours in the 27 cells around it (neighbor_min: the CUDA kernel
   of csrc/fof_link.cu on the card), then a scatter-min hook and four
   pointer-doubling compress steps (Shiloach-Vishkin);
3. rounds run until the labels are a fixed point (or max_rounds).

Labels are the least ORIGINAL particle index of each group. Two rows
link by the host union-find's rule (csrc/fof.c): the float32 difference
of each coordinate, widened to double and wrapped once by the box, with
r2 in double below ll^2. So the labels equal the host's bit for bit at
any size; the JAX package's float32 rule (d^2 <= float32(ll^2)) agrees
with it on the small cases of its tests but not on a 16.8 M-row z = 0
state. The aggregates (halo_attrs_device)
are segment sums keyed by the label (index_add_), compacted to the kept
halos in label order (halo_catalog_device).

The JAX version sizes its programs with power-of-two capacity ladders for
XLA's compile cache; here every array has its exact length.
"""

from __future__ import annotations

import numpy as np
import torch

from .cudalib import launch as _launch

__all__ = ["max_cell_occupancy", "neighbor_min", "neighbor_min_plain",
           "fof_labels_device", "fof_labels_device_auto",
           "halo_attrs_device", "halo_catalog_device"]

_OFFSETS = [(ox, oy, oz) for ox in (-1, 0, 1) for oy in (-1, 0, 1)
            for oz in (-1, 0, 1)]


def _grid(linking_length, boxsize):
    """(ncell, cell size) of the linking grid: cells no smaller than
    the linking length."""
    ncell = max(1, int(float(boxsize) / float(linking_length)))
    return ncell, float(boxsize) / ncell


def _cell_ids(x: torch.Tensor, ncell: int, cs: float) -> torch.Tensor:
    """Flat int64 linking-cell id of every row."""
    ci = torch.remainder(torch.floor(x / cs).to(torch.int64), ncell)
    return (ci[:, 0] * ncell + ci[:, 1]) * ncell + ci[:, 2]


def max_cell_occupancy(x: torch.Tensor, linking_length, boxsize) -> int:
    """Largest number of particles in one linking cell (the plain
    neighbour sweep's candidate bound rmax)."""
    if x.shape[0] == 0:
        return 0
    ncell, cs = _grid(linking_length, boxsize)
    _, counts = torch.unique(_cell_ids(x, ncell, cs), return_counts=True)
    return int(counts.max())


def neighbor_min_plain(lab: torch.Tensor, x_s: torch.Tensor,
                       cid_s: torch.Tensor, ncell: int, boxsize,
                       ll2: float, rmax: int) -> torch.Tensor:
    """The neighbour sweep as the JAX package writes it
    (fof_device.py:103-116): for each of the 27 neighbour cells, the
    first rmax rows of its segment in the sorted ids. rmax must be at
    least the largest cell occupancy (max_cell_occupancy), or links are
    lost. The link rule is the host union-find's (module docstring;
    ll2 = ll * ll in double), r2 summed as (dx dx + dy dy) + dz dz."""
    n = lab.shape[0]
    L = float(boxsize)
    Lh = 0.5 * L
    cz = cid_s % ncell
    cy = (cid_s // ncell) % ncell
    cx = cid_s // (ncell * ncell)
    big = torch.tensor(n, dtype=lab.dtype, device=lab.device)
    best = lab.clone()
    for ox, oy, oz in _OFFSETS:
        ncid = ((torch.remainder(cx + ox, ncell) * ncell
                 + torch.remainder(cy + oy, ncell)) * ncell
                + torch.remainder(cz + oz, ncell))
        start = torch.searchsorted(cid_s, ncid)
        for r in range(rmax):
            j = start + r
            jc = torch.clamp(j, max=n - 1)
            valid = (j < n) & (cid_s[jc] == ncid)
            d = (x_s - x_s[jc]).double()
            d = torch.where(d > Lh, d - L, d)
            d = torch.where(d < -Lh, d + L, d)
            r2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
            link = valid & (r2 < ll2)
            best = torch.minimum(best, torch.where(link, lab[jc], big))
    return best


def neighbor_min(lab: torch.Tensor, x_s: torch.Tensor, cid_s: torch.Tensor,
                 ncell: int, boxsize, ll2: float,
                 rmax: int | None = None) -> torch.Tensor:
    """The least label over every row linked to each row (its own
    included): lab (n,) int32, x_s (n, 3) float32 and cid_s (n,) int64
    sorted by cell id; ll2 the squared linking length. On CUDA this launches csrc/fof_link.cu, which
    walks each neighbour cell to its end (rmax is not used); on the CPU
    it is neighbor_min_plain with rmax (measured from cid_s when
    None)."""
    n = lab.shape[0]
    if not (lab.dtype == torch.int32 and x_s.dtype == torch.float32
            and cid_s.dtype == torch.int64 and x_s.shape == (n, 3)
            and cid_s.shape == (n,)):
        raise ValueError("neighbor_min takes int32 labels, (n, 3) float32 "
                         "positions and (n,) int64 sorted cell ids")
    if not (lab.device == x_s.device == cid_s.device):
        raise ValueError("neighbor_min: inputs on different devices")
    if lab.device.type == "cpu":
        if rmax is None:
            rmax = (int(torch.unique_consecutive(
                cid_s, return_counts=True)[1].max()) if n else 0)
        return neighbor_min_plain(lab, x_s, cid_s, ncell, boxsize, ll2,
                                  rmax)
    x_s, cid_s, lab = x_s.contiguous(), cid_s.contiguous(), lab.contiguous()
    out = torch.empty_like(lab)
    _launch("fastpm_fof_neighbor_min", x_s.data_ptr(), cid_s.data_ptr(),
            lab.data_ptr(), n, ncell, float(boxsize), float(ll2),
            out.data_ptr(), device=lab.device)
    neighbor_min.launches += 1
    return out


neighbor_min.launches = 0


def fof_labels_device(x: torch.Tensor, linking_length, boxsize,
                      rmax: int | None = None,
                      max_rounds: int = 64) -> torch.Tensor:
    """FOF labels (int64: the least original row index of each group)
    of the periodic positions x (N, 3) float32 in [0, boxsize). rmax
    bounds the plain sweep's per-cell candidates on the CPU (None:
    measured); the kernel has no bound. fof_labels_device.rounds holds
    the rounds the last call took."""
    ll = float(linking_length)
    L = float(boxsize)
    n = x.shape[0]
    if n >= 2 ** 31:
        raise ValueError("fof_labels_device: int32 labels need N < 2^31")
    ncell, cs = _grid(ll, L)
    ll2 = ll * ll
    cid = _cell_ids(x, ncell, cs)
    cid_s, order = torch.sort(cid, stable=True)
    del cid
    x_s = x[order].contiguous()

    lab = torch.arange(n, dtype=torch.int32, device=x.device)
    rounds = 0
    while rounds < max_rounds:
        m = neighbor_min(lab, x_s, cid_s, ncell, L, ll2, rmax)
        # hook: the current representative takes the new minimum
        lab2 = lab.clone().scatter_reduce_(0, lab.long(), m, "amin")
        lab2 = torch.minimum(lab2, m)
        del m
        # compress: pointer doubling
        for _ in range(4):
            lab2 = torch.minimum(lab2, torch.index_select(lab2, 0, lab2))
        rounds += 1
        changed = bool((lab2 != lab).any())
        lab = lab2
        if not changed:
            break
    fof_labels_device.rounds = rounds

    # sorted-space representatives -> least ORIGINAL index per group,
    # back in the original row order
    lab = lab.long()
    min_orig = torch.full((n,), n, dtype=torch.int64, device=x.device)
    min_orig.scatter_reduce_(0, lab, order, "amin")
    out = torch.empty(n, dtype=torch.int64, device=x.device)
    out[order] = min_orig[lab]
    return out


fof_labels_device.rounds = 0


def fof_labels_device_auto(x: torch.Tensor, linking_length, boxsize,
                           max_rounds: int = 64) -> torch.Tensor:
    """fof_labels_device with the occupancy sizing pass the plain sweep
    needs (on the CPU); on the card the kernel needs none."""
    rmax = (max_cell_occupancy(x, linking_length, boxsize)
            if x.device.type == "cpu" else None)
    return fof_labels_device(x, linking_length, boxsize, rmax=rmax,
                             max_rounds=max_rounds)


def halo_attrs_device(x, v, ids, lab, boxsize, nmin, q=None, aemit=None,
                      periodic=True):
    """Per-LABEL halo aggregates (the device map-reduce of
    libfastpm/fof.c:573-757): segment sums keyed by the FOF label (the
    least original row index), float32 index_add_. Returns (N,)-row
    tensors defined at label rows plus the keep mask (label rows of
    groups with at least nmin members)."""
    n = x.shape[0]
    L = float(boxsize)
    lab = lab.long()

    def wrap(d):
        if not periodic:
            return d
        return d - torch.round(d / L) * L

    def seg_sum(a):
        return torch.zeros((n,) + a.shape[1:], dtype=a.dtype,
                           device=a.device).index_add_(0, lab, a)

    counts = seg_sum(torch.ones(n, dtype=torch.float32, device=x.device))
    cnt = torch.clamp(counts, min=1.0)[:, None]

    # periodic-safe CM: offsets relative to the label's own particle
    # (the reference member IS the least-index member, fof.c
    # periodic_add)
    ref = x[lab]
    cm = ref + seg_sum(wrap(x - ref)) / cnt
    del ref
    if periodic:
        cm = cm - torch.floor(cm / L) * L
    vm = seg_sum(v) / cnt

    rrel = wrap(x - cm[lab])
    vrel = v - vm[lab]

    def disp6(a):
        comp = torch.stack([a[:, 0] * a[:, 0], a[:, 1] * a[:, 1],
                            a[:, 2] * a[:, 2], a[:, 0] * a[:, 1],
                            a[:, 1] * a[:, 2], a[:, 2] * a[:, 0]], dim=-1)
        return seg_sum(comp) / cnt

    comp9 = torch.stack([rrel[:, d] * vrel[:, (d + k) % 3]
                         for k in range(3) for d in range(3)], dim=-1)
    out = dict(counts=counts, cm=cm, vm=vm, rdisp=disp6(rrel),
               vdisp=disp6(vrel), rvdisp=seg_sum(comp9) / cnt)
    del comp9, rrel, vrel
    if ids is not None:
        big = torch.iinfo(torch.int64).max
        out["minid"] = torch.full((n,), big, dtype=torch.int64,
                                  device=x.device).scatter_reduce_(
            0, lab, ids.to(torch.int64), "amin")
    if q is not None:
        qref = q[lab]
        qm = qref + seg_sum(wrap(q - qref)) / cnt
        if periodic:
            qm = qm - torch.floor(qm / L) * L
        out["qm"] = qm
    if aemit is not None:
        out["am"] = seg_sum(aemit) / cnt[:, 0]
    is_head = lab == torch.arange(n, device=x.device)
    out["keep"] = is_head & (counts >= float(nmin))
    return out


def halo_catalog_device(attrs, lab):
    """Compact the label-row aggregates to the kept halos, ordered by
    ascending least particle index (the host find_halos order). Returns
    (catalog dict of device tensors, ihalo: each particle's halo row,
    -1 outside kept halos, int64, nh)."""
    keep = attrs["keep"]
    rows = torch.cumsum(keep.to(torch.int64), 0) - 1
    idx = torch.nonzero(keep).reshape(-1)
    cat = {k: v[idx] for k, v in attrs.items() if k != "keep"}
    lab = lab.long()
    ihalo = torch.where(keep[lab], rows[lab], -1)
    return cat, ihalo, int(idx.shape[0])
