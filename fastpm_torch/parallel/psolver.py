"""The slab-decomposed force over a ring of ranks (the multi-rank hot
loop).

Port of the slab part of fastpm_tpu/parallel/psolver.py. Each rank holds
a contiguous block of the particle rows. Two force designs:

v1 (any displacement, _force_local_multi, psolver.py:122-165): every
rank paints its particles into a full-size canvas, one psum_scatter sums
and cuts it into x-slabs, the slab FFT runs (pfft.SlabPM), and each
force component is all-gathered back to a full field for the readout.
O(Nmesh^3) memory per rank: the fallback when no halo width fits.

homed (psolver.py:1-39, 461-664): the Lagrangian lattice is filled in
x-major id order, so rank r's block of rows holds the particles whose
lattice site lies in x-slab r. Displacements are bounded, so they stay
within H planes of the slab. Each rank paints into its slab widened by
H planes on the left and H + 1 on the right (nloc + 2H + 1 planes,
O(Nmesh^3 / P) memory), sends the halo blocks to the neighbours that
own them, which add them into their slabs (_halo_reduce, the ghost
reduce of pmghosts.c:247-307); the readout fetches the halo planes back
(_halo_gather). A particle beyond the halo deposits nothing and is
counted: the caller must not use a force whose global count `bad` is
not 0 (the alloc_factor abort of store.c:507-509; the solver measures
the displacements again and replays the force).

The paint and readout of the homed force are the homed kernels
(_homed_trio): homed_kernel="from8" takes homed K1 and K2 (one pass of 8
corners), "from4" K5 and K6 (two passes of 4 corners). Their plain
versions, the counterparts of _cic_rel, _paint_homed and _readout_homed
(psolver.py:178-259), are in ops/cic.py (slab_cell,
cic_paint_homed_plain, cic_readout_plain with a Slab).

Not in this slice (see ROADMAP.md): the potential and tidal outputs,
the pencil (2D) force, rehoming and the split force of the neutrino
linear response.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..kernels import kernel_orders, apply_kernel_transfer
from ..ops import cic
from ..ops.cic import Slab
from ..store import Store
from .comm import Ring
from .pfft import SlabPM

__all__ = ["required_halo_planes", "halo_ladder", "pick_halo"]


def _total_mass(x, mass):
    """A species' mass as a float64 tensor on its device."""
    if torch.is_tensor(mass):
        return mass.sum(dtype=torch.float64)
    return torch.tensor(float(mass) * x.shape[0], dtype=torch.float64,
                        device=x.device)


def _normalize(spm: SlabPM, canvas, total_mass, softening_type):
    """The local slab of mass per cell -> the softened overdensity
    transform's y shard (the canvas enters r2c as 1 + delta)."""
    ntotal = spm.ring.psum(total_mass)
    delta_k = spm.r2c_local(canvas / (ntotal / spm.pm.Norm))
    return spm.apply_softening(delta_k, softening_type)


def _force_local_multi(spm: SlabPM, painter, xs, masses,
                       kernel_type: str, softening_type: str = "none"):
    """Multi-species v1 force (full-canvas exchange). xs: every species'
    local positions; masses: a scalar M0 or a local (N,) mass column per
    species. Returns ([acc (N, 3) per species], delta_k shard)."""
    canvas = None
    total = 0.0
    for x, mass in zip(xs, masses):
        canvas = painter.paint(x, mass, canvas)
        total = total + _total_mass(x, mass)
    delta_k = _normalize(spm, spm.reduce_canvas(canvas), total,
                         softening_type)
    del canvas
    fulls = [spm.gather_canvas(spm.c2r_local(apply_kernel_transfer(
        spm.kpm, delta_k, kernel_type, "acc", d))) for d in range(3)]
    return [painter.readout3(*fulls, x) for x in xs], delta_k


# ---- homed slab force: halo-exchange paint and readout -----------------


def _halo_reduce(canvas_ext, ring: Ring, nloc: int, H: int):
    """Ghost reduce: add each rank's halo blocks into the neighbours'
    slabs (in place on canvas_ext) and return the complete local slab
    (nloc planes).

    When H spans more than one slab (H >= nloc) the ghost block is cut
    into pieces sent m hops along the ring (pmghosts.c:31-131 reaches
    non-adjacent ranks too); on one rank every hop wraps to itself."""
    c = canvas_ext
    R = max(1, -(-H // nloc)) if H else 0
    Rr = max(1, -(-(H + 1) // nloc))
    for m in range(1, R + 1):
        # my ghost planes of the m-th left neighbour: globals
        # [r0 - min(H, m nloc), r0 - (m-1) nloc)
        a = H - min(H, m * nloc)
        b = H - (m - 1) * nloc
        if b <= a:
            continue
        blk = ring.ppermute(c[a:b], -m)
        # lands on the receiver's slab tail
        c[H + max(0, m * nloc - H):H + nloc] += blk
    for m in range(1, Rr + 1):
        # my ghost planes of the m-th right neighbour: globals
        # [r0 + m nloc, r0 + min(nloc + H + 1, (m+1) nloc))
        a = m * nloc + H
        b = min(nloc + H + 1, (m + 1) * nloc) + H
        if b <= a:
            continue
        blk = ring.ppermute(c[a:b], m)
        # lands on the receiver's slab head
        c[H:H + (b - a)] += blk
    return c[H:H + nloc]


def _halo_gather(field_slab, ring: Ring, nloc: int, H: int):
    """Readout mirror of _halo_reduce: the local slab widened with H
    planes from the left and H + 1 from the right, fetched from as many
    neighbours as the halo spans."""
    R = max(1, -(-H // nloc)) if H else 0
    Rr = max(1, -(-(H + 1) // nloc))
    parts = []
    for m in range(R, 0, -1):
        # planes [H - min(H, m nloc), H - (m-1) nloc) are the m-th left
        # neighbour's slab tail [max(0, m nloc - H), nloc)
        if H - (m - 1) * nloc <= H - min(H, m * nloc):
            continue
        parts.append(ring.ppermute(field_slab[max(0, m * nloc - H):nloc],
                                   m))
    parts.append(field_slab)
    for m in range(1, Rr + 1):
        # planes [m nloc, min(nloc + H + 1, (m+1) nloc)) past the slab
        # start are the m-th right neighbour's slab head
        n = min(nloc + H + 1, (m + 1) * nloc) - m * nloc
        if n <= 0:
            continue
        parts.append(ring.ppermute(field_slab[:n], -m))
    return torch.cat(parts)


# homed_kernel -> (paint(canvas, x, inv_cell, slab, mass) -> bad,
#                  readout3([f0, f1, f2], x, inv_cell, slab) -> (N, 3))
_HOMED_TRIOS = {
    "from8": (cic.cic_paint_homed, cic.cic_readout_homed),
    "from4": (lambda c, x, inv, slab, m: cic.cic_paint4(c, x, inv, m, slab),
              lambda fs, x, inv, slab: cic.cic_readout4(*fs, x, inv,
                                                        slab)),
}


def _homed_trio(homed_kernel: str = "from8"):
    """(paint, readout3) of the homed force (psolver.py:366-396; the
    TPU package's third member, the prepare, is the cell sort of the
    carry here). from8: homed K1 and K2; from4: K5 and K6."""
    try:
        return _HOMED_TRIOS[homed_kernel]
    except KeyError:
        raise ValueError(f"unknown homed kernel {homed_kernel!r} "
                         "(from8 or from4)") from None


def _slab(spm: SlabPM, H: int):
    """(Slab, extended canvas shape) of this rank for halo width H."""
    n0, n1, n2 = spm.pm.Nmesh
    return Slab(n0, spm.r0, H), (spm.rshard[0] + 2 * H + 1, n1, n2)


def _grad3_fields_homed(spm: SlabPM, delta_k, kernel_type: str, gather):
    """Shared tail of the homed force bodies: the potential transfer,
    the three gradient inverses, and the halo gather of each.
    gather(field) -> extended field."""
    potorder, gradorder, _d, deconv = kernel_orders(kernel_type)
    out = delta_k
    for _ in range(deconv):
        out = spm.apply_decic(out)
    pot_k = spm.apply_pot(out, potorder)
    return [gather(g) for g in spm.c2r_grad3_local(pot_k, gradorder)]


def _force_local_homed_multi(spm: SlabPM, xs, masses, kernel_type: str,
                             H: int, softening_type: str = "none",
                             homed_kernel: str = "from8"):
    """Multi-species homed force (halo-exchange paint and readout), rows
    in the caller's order. xs and masses as _force_local_multi. Returns
    ([acc (N, 3) per species], bad, delta_k shard); bad is the global
    count of particles beyond the halo (an int32 tensor; must be 0)."""
    paint, readout3 = _homed_trio(homed_kernel)
    nloc = spm.rshard[0]
    slab, ext = _slab(spm, H)
    inv = spm.pm.InvCellSize
    canvas = torch.zeros(ext, dtype=torch.float32, device=xs[0].device)
    bad = torch.zeros((), dtype=torch.int32, device=xs[0].device)
    total = 0.0
    for x, mass in zip(xs, masses):
        bad = bad + paint(canvas, x, inv, slab, mass)
        total = total + _total_mass(x, mass)
    delta_k = _normalize(spm, _halo_reduce(canvas, spm.ring, nloc, H),
                         total, softening_type)
    del canvas
    fields = _grad3_fields_homed(
        spm, delta_k, kernel_type,
        lambda g: _halo_gather(g, spm.ring, nloc, H))
    return ([readout3(fields, x, inv, slab) for x in xs],
            spm.ring.psum(bad), delta_k)


def _force_local_homed_carry(spm: SlabPM, store: Store, kernel_type: str,
                             H: int, softening_type: str = "none",
                             homed_kernel: str = "from8"):
    """Order-free homed force of one species with a scalar mass (the
    rank-local analog of gravity.compute_force_carry): every column of
    the store rides the sort by extended-slab cell, the paint and
    readout see cell-sorted rows, and the values come out aligned with
    the sorted rows. The caller wraps the positions first.

    Returns (store sorted with acc filled, bad, delta_k shard)."""
    paint, readout3 = _homed_trio(homed_kernel)
    nloc = spm.rshard[0]
    slab, ext = _slab(spm, H)
    inv = spm.pm.InvCellSize
    if (ext[0] + 1) * ext[1] * ext[2] >= 2 ** 31:
        raise ValueError(f"extended slab {ext} overflows the int32 cell key")
    base, _f, valid = cic.slab_cell(store.x, ext, inv, slab)
    # rows beyond the slab sort after every cell, as the TPU package's
    # key (relx = nloc + 2H + 1) sorts them
    relx = torch.where(valid, base[:, 0], ext[0])
    key = ((relx * ext[1] + base[:, 1]) * ext[2] + base[:, 2]).to(torch.int32)
    store = store.replace(acc=None).take(
        torch.sort(key, stable=True).indices)
    canvas = torch.zeros(ext, dtype=torch.float32, device=store.x.device)
    bad = paint(canvas, store.x, inv, slab, 1.0)
    delta_k = _normalize(spm, _halo_reduce(canvas, spm.ring, nloc, H),
                         _total_mass(store.x, 1.0), softening_type)
    del canvas
    fields = _grad3_fields_homed(
        spm, delta_k, kernel_type,
        lambda g: _halo_gather(g, spm.ring, nloc, H))
    acc = readout3(fields, store.x, inv, slab)
    return store.replace(acc=acc), spm.ring.psum(bad), delta_k


def halo_ladder(nloc: int, n0: int = None):
    """Candidate halo widths: powers of two up to the memory cap
    ext = nloc + 2H + 1 <= n0 (beyond it the v1 full-canvas force is
    cheaper). The multi-hop exchange lifts the old nloc - 1 bound."""
    cap = nloc - 1 if n0 is None else (n0 - nloc - 1) // 2
    out = []
    h = 2
    while h < cap:
        out.append(h)
        h *= 2
    if cap >= 1:
        out.append(cap)
    return out


def required_halo_planes(pm, ring: Ring, x: torch.Tensor) -> int:
    """The measured halo requirement: the largest distance (in mesh
    planes) by which any rank's particle strays outside its rank's
    x-slab (psolver.py:1447-1472). Positions must be wrapped. Every
    rank gets the same number."""
    n0 = pm.Nmesh[0]
    nloc = n0 // ring.nproc
    r0 = ring.rank * nloc
    bx = torch.remainder(torch.floor(
        x[:, 0] * float(np.float32(pm.InvCellSize[0]))).to(torch.int64), n0)
    rel = torch.remainder(bx - r0, n0)
    # planes beyond the right edge, or beyond the left one
    d = torch.minimum(rel - (nloc - 1), n0 - rel)
    d = torch.where(rel < nloc, 0, d)
    local = d.max() if d.numel() else torch.zeros((), dtype=torch.int64,
                                                  device=x.device)
    return int(ring.pmax(local.reshape(1)))


def pick_halo(pm, ring: Ring, xs: Sequence[torch.Tensor]):
    """The homed halo width for these species' wrapped positions: the
    first rung of the ladder with one plane of slack over the
    measurement (at least 1), or None when none fits (the v1 force)."""
    nloc = pm.Nmesh[0] // ring.nproc
    hreq = 1
    for x in xs:
        hreq = max(hreq, required_halo_planes(pm, ring, x))
    return next((h for h in halo_ladder(nloc, pm.Nmesh[0])
                 if h >= hreq + 1), None)
