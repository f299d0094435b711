"""The force over the ranks, slab- or pencil-decomposed (the multi-rank
hot loop).

Port of the slab and pencil parts of fastpm_tpu/parallel/psolver.py.
Each rank holds a contiguous block of the particle rows. Two force
designs:

v1 (any displacement, _force_local_multi, psolver.py:122-165): every
rank paints its particles into a full-size canvas, which is summed and
cut into this rank's x-slab (pfft.SlabPM) or pencil (pfft.PencilPM), the
distributed FFT runs, and each force component is all-gathered back to
a full field for the readout. O(Nmesh^3) memory per rank: the fallback
when no halo width fits.

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

The pencil-homed force (psolver.py:1158-1425) is the 2D analog on a
px x py Grid: the lattice is filled in pencil-blocked row order
(store.lattice_store(blocks=(px, py))), so rank (cx, cy) holds the
particles of its pencil; it paints into the pencil widened by Hx planes
and Hy rows (a Pencil: the open-y mode of the homed kernels, whose
plain versions take the Pencil too, the counterparts of _cic_rel2,
_paint_homed2 and _readout_homed2), reduces the halo blocks along x over
the x-ring and then along y over the y-ring (corners ride both hops),
and gathers the fields back y first, then x.

Every body takes its fields from the one-card force's k-space stage
(gravity.acc_fields, gravity.potential_tidal for the potential and the
tidal tensor when asked, read through the homed readout, K2's kernel),
on the rank's KShard, the inverse being c2r_local and the halo gather
(homed) or the full gather (v1).
Each body takes the neutrino linear response as a transfer hook on the
rank's softened k shard (the JAX package's pre / post split,
psolver.py:943-1116, as one call): a homed body sums its overflow count
over the ranks first and, when a particle lies beyond the halo, returns
before the hook runs, so that a force the solver replays never updates
the response's history twice.

Rehoming (_force_local_homed_rehome, psolver.py:723-940) is the slab
carry of a rehomed store (store.py) followed by the end-of-step
migration of the rows that crossed into a neighbour's slab, two bucket
hops along the ring, every column in its own dtype.

On one rank the whole mesh is the rank's slab (or pencil): nothing
strays beyond it, so pick_halo takes H = 2 there (the support's plane
and one of slack) and every halo hop folds onto the rank itself.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..gravity import acc_fields, potential_tidal
from ..kernels import apply_softening
from ..ops import cic
from ..ops.cic import Slab, Pencil
from ..painter import Painter
from ..store import Store
from .comm import Ring, Grid
from .pfft import SlabPM, PencilPM

__all__ = ["required_halo_planes", "required_halo_planes_pencil",
           "halo_ladder", "pick_halo", "pick_halo_rehomed", "reader",
           "sharded_force_fn", "make_sharded_step"]


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
    return apply_softening(spm.kpm, delta_k, softening_type)


def _inverse(engine, gather):
    """c2r(k) -> field for the force stage (gravity.acc_fields): the
    shard's inverse, gathered as the readout needs it (gather(field) ->
    the extended or full field)."""
    return lambda k: gather(engine.c2r_local(k))


def _multi_fields(engine, delta_k, kernel_type: str, c2r, readout3, read,
                  xs, compute_potential: bool, compute_tidal: bool):
    """The multi-species bodies' readouts of the rank's k shard: the
    acceleration by readout3(fields, x) -> (N, 3) at every species'
    rows, then the potential and tidal tensor by read(fields, x) -> (N,
    k) (gravity.potential_tidal). Returns [dict(acc[, potential,
    tidal]) per species]."""
    fields = acc_fields(engine.kpm, delta_k, kernel_type, c2r)
    outs = [dict(acc=readout3(fields, x)) for x in xs]
    del fields
    for out, e in zip(outs, potential_tidal(
            engine.kpm, delta_k, kernel_type, c2r,
            lambda fs, name: [read(fs, x) for x in xs],
            compute_potential, compute_tidal)):
        out.update(e)
    return outs


def _force_local_multi(spm, painter, xs, masses, kernel_type: str,
                       softening_type: str = "none",
                       compute_potential: bool = False,
                       compute_tidal: bool = False, transfer=None):
    """Multi-species v1 force (full-canvas exchange) over a SlabPM or a
    PencilPM. xs: every species' local positions; masses: a scalar M0 or
    a local (N,) mass column per species; transfer(delta_k) -> delta_k,
    when given, maps the softened k shard before the potential kernel.
    Returns ([dict(acc (N, 3)[, potential (N,), tidal (N, 6)]) per
    species], delta_k shard)."""
    canvas = None
    total = 0.0
    for x, mass in zip(xs, masses):
        canvas = painter.paint(x, mass, canvas)
        total = total + _total_mass(x, mass)
    delta_k = _normalize(spm, spm.reduce_canvas(canvas), total,
                         softening_type)
    del canvas
    if transfer is not None:
        delta_k = transfer(delta_k)
    outs = _multi_fields(spm, delta_k, kernel_type,
                         _inverse(spm, spm.gather_canvas),
                         lambda fs, x: painter.readout3(*fs, x),
                         painter.readout_fields, xs, compute_potential,
                         compute_tidal)
    return outs, delta_k


def sharded_force_fn(pm, ring: Ring, kernel_type: str = "1_4",
                     painter_type: str = "cic", painter_support: int = 2):
    """force(x) -> acc: the v1 force of the rank's positions (N, 3) over
    the ring's SlabPM, one species of unit mass (the JAX package's
    sharded_force_fn and _force_local, psolver.py:104-119, 1489-1502).
    Every rank calls it with its own rows; acc (N, 3) is in their
    order."""
    spm = SlabPM(pm, ring)
    painter = Painter(pm, painter_type, painter_support)

    def force(x):
        (out,), _dk = _force_local_multi(spm, painter, (x,), (1.0,),
                                         kernel_type)
        return out["acc"]

    return force


def make_sharded_step(pm, ring: Ring, kernel_type: str = "1_4",
                      painter_type: str = "cic", painter_support: int = 2):
    """step(x, v, coeffs) -> (x, v, acc): sharded_force_fn's force, then
    the kick v += acc * coeffs[0], the drift x += v * coeffs[1] and the
    periodic wrap x - floor(x / L) L (the JAX package's
    make_sharded_step, psolver.py:1505-1528; coeffs the step's kick and
    drift factors, computed on the host). The JAX package donates x and
    v to the step; here they are updated in place and returned."""
    force = sharded_force_fn(pm, ring, kernel_type, painter_type,
                             painter_support)
    box = torch.tensor(pm.BoxSize, dtype=torch.float32)

    def step(x, v, coeffs):
        dda, dyyy = (float(c) for c in torch.as_tensor(
            coeffs, dtype=torch.float32).cpu())
        L = box.to(x.device)
        acc = force(x)
        v += acc * dda
        x += v * dyyy
        x -= torch.floor(x / L) * L
        return x, v, acc

    return step


# ---- homed forces: halo-exchange paint and readout --------------------


def _sl(dim: int, a: int, b: int):
    """The index of [a, b) along dimension dim."""
    return (slice(None),) * dim + (slice(a, b),)


def _halo_reduce(canvas_ext, ring: Ring, nloc: int, H: int, dim: int = 0):
    """Ghost reduce along dimension dim (0: the slab's and the pencil's
    x exchange, 1: the pencil's y exchange): add each rank's halo blocks
    into its ring neighbours' interiors (in place on canvas_ext) and
    return the complete interior (nloc along dim).

    When H spans more than one block (H >= nloc) the ghost block is cut
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
        blk = ring.ppermute(c[_sl(dim, a, b)], -m)
        # lands on the receiver's interior tail
        c[_sl(dim, H + max(0, m * nloc - H), H + nloc)] += blk
    for m in range(1, Rr + 1):
        # my ghost planes of the m-th right neighbour: globals
        # [r0 + m nloc, r0 + min(nloc + H + 1, (m+1) nloc))
        a = m * nloc + H
        b = min(nloc + H + 1, (m + 1) * nloc) + H
        if b <= a:
            continue
        blk = ring.ppermute(c[_sl(dim, a, b)], m)
        # lands on the receiver's interior head
        c[_sl(dim, H, H + (b - a))] += blk
    return c[_sl(dim, H, H + nloc)]


def _halo_gather(field, ring: Ring, nloc: int, H: int, dim: int = 0):
    """Readout mirror of _halo_reduce along dimension dim: the local
    interior widened with H planes from the left and H + 1 from the
    right, fetched from as many ring neighbours as the halo spans."""
    R = max(1, -(-H // nloc)) if H else 0
    Rr = max(1, -(-(H + 1) // nloc))
    parts = []
    for m in range(R, 0, -1):
        # planes [H - min(H, m nloc), H - (m-1) nloc) are the m-th left
        # neighbour's interior tail [max(0, m nloc - H), nloc)
        if H - (m - 1) * nloc <= H - min(H, m * nloc):
            continue
        parts.append(ring.ppermute(
            field[_sl(dim, max(0, m * nloc - H), nloc)], m))
    parts.append(field)
    for m in range(1, Rr + 1):
        # planes [m nloc, min(nloc + H + 1, (m+1) nloc)) past the
        # interior's start are the m-th right neighbour's head
        n = min(nloc + H + 1, (m + 1) * nloc) - m * nloc
        if n <= 0:
            continue
        parts.append(ring.ppermute(field[_sl(dim, 0, n)], -m))
    return torch.cat(parts, dim=dim)


# homed_kernel -> (paint(canvas, x, inv_cell, slab, mass) -> bad,
#                  readout3([f0, f1, f2], x, inv_cell, slab) -> (N, 3));
# slab is a Slab or, for the pencil force, a Pencil
_HOMED_TRIOS = {
    "from8": (cic.cic_paint_homed, cic.cic_readout_homed),
    "from4": (lambda c, x, inv, slab, m: cic.cic_paint4(c, x, inv, m, slab),
              lambda fs, x, inv, slab: cic.cic_readout4(*fs, x, inv,
                                                        slab)),
}


def _homed_trio(homed_kernel: str = "from8"):
    """(paint, readout3) of the homed forces (psolver.py:366-396; the
    TPU package's third member, the prepare, is the cell sort of the
    carry here). from8: homed K1 and K2; from4: K5 and K6."""
    try:
        return _HOMED_TRIOS[homed_kernel]
    except KeyError:
        raise ValueError(f"unknown homed kernel {homed_kernel!r} "
                         "(from8 or from4)") from None


class _Homing(NamedTuple):
    """One rank's homed geometry: the Slab or Pencil of the kernels, the
    extended canvas's shape, and the halo exchange: reduce(canvas) ->
    the complete interior, gather(field) -> the extended field."""

    geom: object
    ext: tuple
    reduce: object
    gather: object


def _slab(spm: SlabPM, H: int) -> _Homing:
    """The homing of this rank's x-slab for halo width H."""
    n0, n1, n2 = spm.pm.Nmesh
    nloc = spm.rshard[0]
    return _Homing(Slab(n0, spm.r0, H), (nloc + 2 * H + 1, n1, n2),
                   lambda c: _halo_reduce(c, spm.ring, nloc, H),
                   lambda f: _halo_gather(f, spm.ring, nloc, H))


def _pencil(ppm: PencilPM, Hx: int, Hy: int) -> _Homing:
    """The homing of this rank's pencil for halo widths (Hx, Hy): the
    exchange reduces along x, then y, and gathers along y, then x
    (psolver.py:1325-1331, 1362-1366)."""
    n0, n1, n2 = ppm.pm.Nmesh
    nlx, nly = ppm.rshard[:2]
    g = ppm.grid

    def reduce(c):
        return _halo_reduce(_halo_reduce(c, g.xring, nlx, Hx, 0),
                            g.yring, nly, Hy, 1)

    def gather(f):
        return _halo_gather(_halo_gather(f, g.yring, nly, Hy, 1),
                            g.xring, nlx, Hx, 0)

    return _Homing(Pencil(n0, ppm.r0[0], Hx, n1, ppm.r0[1], Hy),
                   (nlx + 2 * Hx + 1, nly + 2 * Hy + 1, n2), reduce, gather)


def _transferred(engine, delta_k, bad, transfer):
    """(delta_k through the transfer hook, the global overflow count),
    or (None, count) when a particle lies beyond the halo: the count is
    summed before the hook, which then does not run."""
    bad = engine.ring.psum(bad)
    if transfer is None:
        return delta_k, bad
    if int(bad):
        return None, bad
    return transfer(delta_k), bad


def _homed_multi(engine, hom: _Homing, xs, masses, kernel_type: str,
                 softening_type: str, homed_kernel: str,
                 compute_potential: bool, compute_tidal: bool,
                 transfer=None):
    """The multi-species body of both homed forces: paint every species
    into the extended canvas, reduce the halo, the distributed FFT, the
    transfer hook, the gathered force fields read out at every species
    (and the potential and tidal tensor through the homed readout). With
    a hook and a particle beyond the halo it returns (None, bad, None)
    before the hook."""
    paint, readout3 = _homed_trio(homed_kernel)
    inv = engine.pm.InvCellSize
    canvas = torch.zeros(hom.ext, dtype=torch.float32, device=xs[0].device)
    bad = torch.zeros((), dtype=torch.int32, device=xs[0].device)
    total = 0.0
    for x, mass in zip(xs, masses):
        bad = bad + paint(canvas, x, inv, hom.geom, mass)
        total = total + _total_mass(x, mass)
    delta_k = _normalize(engine, hom.reduce(canvas), total, softening_type)
    del canvas
    delta_k, bad = _transferred(engine, delta_k, bad, transfer)
    if delta_k is None:
        return None, bad, None
    outs = _multi_fields(
        engine, delta_k, kernel_type, _inverse(engine, hom.gather),
        lambda fs, x: readout3(fs, x, inv, hom.geom),
        lambda fs, x: cic.cic_readout_homed(fs, x, inv, hom.geom), xs,
        compute_potential, compute_tidal)
    return outs, bad, delta_k


def _homed_carry(engine, hom: _Homing, store: Store, kernel_type: str,
                 softening_type: str, homed_kernel: str, transfer=None):
    """The order-free body of both homed forces: one scalar-mass species
    whose every column rides the sort by extended cell. With a transfer
    hook and a particle beyond the halo it returns (None, bad, None)
    before the hook."""
    paint, readout3 = _homed_trio(homed_kernel)
    ext = hom.ext
    inv = engine.pm.InvCellSize
    if (ext[0] + 1) * ext[1] * ext[2] >= 2 ** 31:
        raise ValueError(f"extended canvas {ext} overflows the int32 cell "
                         "key")
    base, _f, valid = cic.slab_cell(store.x, ext, inv, hom.geom)
    # rows beyond the slab or pencil sort after every cell, as the TPU
    # package's key (relx = nx_l + 1) sorts them
    relx = torch.where(valid, base[:, 0], ext[0])
    key = ((relx * ext[1] + base[:, 1]) * ext[2] + base[:, 2]).to(torch.int32)
    store = store.replace(acc=None).take(
        torch.sort(key, stable=True).indices)
    canvas = torch.zeros(ext, dtype=torch.float32, device=store.x.device)
    bad = paint(canvas, store.x, inv, hom.geom, 1.0)
    delta_k = _normalize(engine, hom.reduce(canvas),
                         _total_mass(store.x, 1.0), softening_type)
    del canvas
    delta_k, bad = _transferred(engine, delta_k, bad, transfer)
    if delta_k is None:
        return None, bad, None
    fields = acc_fields(engine.kpm, delta_k, kernel_type,
                        _inverse(engine, hom.gather))
    acc = readout3(fields, store.x, inv, hom.geom)
    return store.replace(acc=acc), bad, delta_k


def _force_local_homed_multi(spm: SlabPM, xs, masses, kernel_type: str,
                             H: int, softening_type: str = "none",
                             homed_kernel: str = "from8",
                             compute_potential: bool = False,
                             compute_tidal: bool = False, transfer=None):
    """Multi-species homed slab force (halo-exchange paint and readout;
    psolver.py:461-575), rows in the caller's order. xs, masses and
    transfer as _force_local_multi. Returns ([dict(acc[, potential,
    tidal]) per species], bad, delta_k shard); bad is the global count of
    particles beyond the halo (an int32 tensor; must be 0)."""
    return _homed_multi(spm, _slab(spm, H), xs, masses, kernel_type,
                        softening_type, homed_kernel, compute_potential,
                        compute_tidal, transfer)


def _force_local_homed_carry(spm: SlabPM, store: Store, kernel_type: str,
                             H: int, softening_type: str = "none",
                             homed_kernel: str = "from8", transfer=None):
    """Order-free homed slab force of one species with a scalar mass (the
    rank-local analog of gravity.compute_force_carry; psolver.py:
    599-664): every column of the store rides the sort by extended-slab
    cell, the paint and readout see cell-sorted rows, and the values
    come out aligned with the sorted rows. The caller wraps the
    positions first.

    Returns (store sorted with acc filled, bad, delta_k shard); transfer
    as _force_local_multi."""
    return _homed_carry(spm, _slab(spm, H), store, kernel_type,
                        softening_type, homed_kernel, transfer)


def _force_local_homed_pencil_multi(ppm: PencilPM, xs, masses,
                                    kernel_type: str, Hx: int, Hy: int,
                                    softening_type: str = "none",
                                    homed_kernel: str = "from8",
                                    compute_potential: bool = False,
                                    compute_tidal: bool = False,
                                    transfer=None):
    """Multi-species pencil-homed force (psolver.py:1258-1388): the
    homed kernels in their open-y mode on the extended pencil, the halo
    reduced along x then y, the PencilPM FFT, the fields gathered along
    y then x. Rows must be pencil-blocked; a scalar mass or a mass
    column per species. Returns as _force_local_homed_multi."""
    return _homed_multi(ppm, _pencil(ppm, Hx, Hy), xs, masses, kernel_type,
                        softening_type, homed_kernel, compute_potential,
                        compute_tidal, transfer)


def _force_local_homed_pencil_carry(ppm: PencilPM, store: Store,
                                    kernel_type: str, Hx: int, Hy: int,
                                    softening_type: str = "none",
                                    homed_kernel: str = "from8",
                                    transfer=None):
    """Order-free pencil-homed force of one scalar-mass species
    (psolver.py:667-722): rows sorted by the extended 2D cell, every
    column riding the sort. Returns as _force_local_homed_carry."""
    return _homed_carry(ppm, _pencil(ppm, Hx, Hy), store, kernel_type,
                        softening_type, homed_kernel, transfer)


def reader(engine, H, painter=None):
    """read(fields, x) -> (N, k): the rank's 1-3 local fields (as the
    engine's c2r_local gives them) at the rows x, for the force of halo
    H (pick_halo's pick): through the homed readout on the extended slab
    or pencil, or for v1 (H None) on the gathered full fields with the
    painter's readout. PGD reads its fields through it."""
    if H is None:
        return lambda fields, x: painter.readout_fields(
            [engine.gather_canvas(f) for f in fields], x)
    hom = (_pencil(engine, *H[1:]) if isinstance(H, tuple)
           else _slab(engine, H))
    inv = engine.pm.InvCellSize
    return lambda fields, x: cic.cic_readout_homed(
        [hom.gather(f) for f in fields], x, inv, hom.geom)


# ---- rehoming: the slab carry with end-of-step migration ---------------


def _rows(lo: int, n: int, size: int, nrows: int, device):
    """(index of rows [lo, lo + n) padded to size rows, and which of the
    size rows are among them)."""
    i = torch.arange(size, device=device)
    return torch.clamp(lo + i, max=max(nrows - 1, 0)), i < n


def _hop(store: Store, ring: Ring, hop: int) -> Store:
    """A bucket of rows sent hop places along the ring (the store of the
    rows received from the rank hop places back). Each column keeps its
    dtype: the columns of one dtype travel as one (B, k) matrix, so the
    int64 ids and the uint8 alive flags cross exactly."""
    cols = store.columns()
    groups = {}
    for name, t in cols:
        groups.setdefault(t.dtype, []).append((name, t))
    out = {}
    for members in groups.values():
        got = ring.ppermute(torch.cat([t.reshape(t.shape[0], -1)
                                       for _, t in members], 1), hop)
        j = 0
        for name, t in members:
            w = t[0].numel() if t.ndim > 1 else 1
            out[name] = got[:, j:j + w].reshape(t.shape)
            j += w
    return store.replace(**out)


def _force_local_homed_rehome(spm: SlabPM, store: Store, kernel_type: str,
                              H: int, softening_type: str = "none",
                              homed_kernel: str = "from8"):
    """The order-free homed slab force of a rehomed store with the
    end-of-step migration (psolver.py:723-940): R = cap + 2B rows a rank
    (Store.alive, rehome_bucket B). The rows sort by extended-slab cell,
    the dead rows and those beyond the slab last; the force paints and
    reads out the alive rows inside it. On the sorted rows the alive
    ones whose base plane lies in the left halo (relx < H) are a prefix
    and those in the right halo (relx >= H + nloc) a suffix: the prefix
    goes one hop left and the suffix one hop right, B rows each. The
    result holds the stayers (at most cap, padded with dead rows), then
    the rows from the left and from the right. The caller wraps the
    positions first; H <= nloc, so a mover belongs to the next rank.

    Returns (the migrated store with acc, bad, delta_k shard). bad is the
    global count of alive rows beyond the halo and of rows past a bucket
    or the capacity; when it is not 0 the force is not run and (None,
    bad, None) comes back (the caller converts the store anew)."""
    nloc = spm.rshard[0]
    if H > nloc:
        raise ValueError("rehoming needs H <= nloc")
    hom = _slab(spm, H)
    ext = hom.ext
    inv = spm.pm.InvCellSize
    if (ext[0] + 1) * ext[1] * ext[2] >= 2 ** 31:
        raise ValueError(f"extended canvas {ext} overflows the int32 cell "
                         "key")
    B = int(store.rehome_bucket)
    R = store.np_local
    cap = R - 2 * B
    dev = store.x.device
    base, _f, valid = cic.slab_cell(store.x, ext, inv, hom.geom)
    alive = store.alive > 0
    ok = alive & valid
    relx = torch.where(ok, base[:, 0], ext[0])
    key = ((relx * ext[1] + base[:, 1]) * ext[2] + base[:, 2]).to(
        torch.int32)
    counts = torch.stack([(ok & (relx < H)).sum(),
                          (ok & (relx < H + nloc)).sum(), ok.sum(),
                          (alive & ~valid).sum()])
    n_l, n_r0, E, beyond = (int(c) for c in counts.tolist())
    n_stay, n_right = n_r0 - n_l, E - n_r0
    over = (beyond + max(0, n_l - B) + max(0, n_right - B)
            + max(0, n_stay - cap))
    bad = spm.ring.psum(torch.tensor(over, dtype=torch.int32, device=dev))
    if int(bad):
        return None, bad, None
    store = store.replace(acc=None).take(
        torch.sort(key, stable=True).indices)

    paint, readout3 = _homed_trio(homed_kernel)
    x = store.x[:E]
    canvas = torch.zeros(ext, dtype=torch.float32, device=dev)
    paint(canvas, x, inv, hom.geom, 1.0)
    delta_k = _normalize(spm, hom.reduce(canvas), _total_mass(x, 1.0),
                         softening_type)
    del canvas
    fields = acc_fields(spm.kpm, delta_k, kernel_type,
                        _inverse(spm, hom.gather))
    acc = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    acc[:E] = readout3(fields, x, inv, hom.geom)
    del fields
    store = store.replace(acc=acc)

    # the migration: the left bucket one hop left, the right one right
    parts = []
    for lo, n, size in ((n_l, n_stay, cap), (0, n_l, B), (n_r0, n_right, B)):
        idx, live = _rows(lo, n, size, R, dev)
        parts.append(store.take(idx).replace(alive=live.to(torch.uint8)))
    keep, left, right = parts
    from_left = _hop(right, spm.ring, 1)
    from_right = _hop(left, spm.ring, -1)
    out = {name: torch.cat([t, getattr(from_left, name),
                            getattr(from_right, name)])
           for name, t in keep.columns()}
    return store.replace(**out), bad, delta_k


def _ladder(nloc: int, n0: int, nproc: int):
    """halo_ladder over nproc ranks; on one rank (the whole axis its
    own) the rung over the support's plane alone: nothing strays."""
    return [2] if nproc == 1 else halo_ladder(nloc, n0)


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


def _stray(col, inv: float, r0: int, nloc: int, n: int):
    """The largest distance (in planes) by which a coordinate column's
    base cells lie outside [r0, r0 + nloc) on a periodic axis of n."""
    b = torch.remainder(torch.floor(
        col * float(np.float32(inv))).to(torch.int64), n)
    rel = torch.remainder(b - r0, n)
    # planes beyond the right edge, or beyond the left one
    d = torch.minimum(rel - (nloc - 1), n - rel)
    d = torch.where(rel < nloc, 0, d)
    return d.max() if d.numel() else torch.zeros((), dtype=torch.int64,
                                                 device=col.device)


def required_halo_planes(pm, ring: Ring, x: torch.Tensor,
                         alive=None) -> int:
    """The measured halo requirement: the largest distance (in mesh
    planes) by which any rank's particle strays outside its rank's
    x-slab (psolver.py:1447-1472); with alive (a rehomed store's), that
    of the alive rows (solver.py:381-402). Positions must be wrapped.
    Every rank gets the same number."""
    nloc = pm.Nmesh[0] // ring.nproc
    x0 = x[:, 0] if alive is None else x[alive > 0, 0]
    local = _stray(x0, pm.InvCellSize[0], ring.rank * nloc, nloc,
                   pm.Nmesh[0])
    return int(ring.pmax(local.reshape(1)))


def required_halo_planes_pencil(pm, grid: Grid, x: torch.Tensor):
    """The measured 2D halo requirement of pencil-blocked rows (hx, hy):
    the largest distance (in planes) by which any rank's particle strays
    outside its pencil's x window and its y window (psolver.py:
    1391-1425). Positions must be wrapped. Every rank gets the same
    pair."""
    n0, n1, _ = pm.Nmesh
    nlx, nly = n0 // grid.px, n1 // grid.py
    local = torch.stack([
        _stray(x[:, 0], pm.InvCellSize[0], grid.cx * nlx, nlx, n0),
        _stray(x[:, 1], pm.InvCellSize[1], grid.cy * nly, nly, n1)])
    hx, hy = grid.pmax(local).tolist()
    return int(hx), int(hy)


def pick_halo(pm, comm, xs: Sequence[torch.Tensor], homes=None):
    """The homed halo for these species' wrapped positions on a Ring or
    a Grid, by the rule of solver.py:425-463: on a grid with py > 1 (or
    the 1 x 1 grid of one rank) and rows pencil-blocked as the grid
    ((px, py) in every entry of homes, the stores' home_blocks),
    ("pencil", Hx, Hy), the first rungs of the ladders with one plane of
    slack over the measurement (at least 1); otherwise, for rows in
    x-major order (no home_blocks), the slab width H over every rank;
    None when none fits (the v1 force)."""
    homes = list(homes) if homes is not None else [None] * len(xs)
    n0, n1, _ = pm.Nmesh
    ring = comm
    if isinstance(comm, Grid):
        ring = comm.flat
        px, py = comm.px, comm.py
        if py > 1 or comm.nproc == 1:
            if (all(h == (px, py) for h in homes) and n0 % px == 0
                    and n1 % py == 0 and n1 % px == 0):
                hx = hy = 1
                for x in xs:
                    rx, ry = required_halo_planes_pencil(pm, comm, x)
                    hx, hy = max(hx, rx), max(hy, ry)
                Hx = next((h for h in _ladder(n0 // px, n0, comm.nproc)
                           if h >= hx + 1), None)
                Hy = next((h for h in _ladder(n1 // py, n1, comm.nproc)
                           if h >= hy + 1), None)
                if Hx is not None and Hy is not None:
                    return ("pencil", Hx, Hy)
    if any(h is not None for h in homes):
        return None        # blocked rows are not x-major: no slab
    nloc = n0 // ring.nproc
    hreq = 1
    for x in xs:
        hreq = max(hreq, required_halo_planes(pm, ring, x))
    return next((h for h in _ladder(nloc, n0, ring.nproc)
                 if h >= hreq + 1), None)


def pick_halo_rehomed(pm, ring: Ring, store: Store):
    """The rehome body's halo for a rehomed store (solver.py:413-424):
    the first rung with one plane of slack over its alive rows'
    requirement that a migration allows (H <= nloc); None when none
    does (the solver then falls back to the dense store)."""
    nloc = pm.Nmesh[0] // ring.nproc
    hreq = max(1, required_halo_planes(pm, ring, store.x, store.alive))
    return next((h for h in _ladder(nloc, pm.Nmesh[0], ring.nproc)
                 if hreq + 1 <= h <= nloc), None)
