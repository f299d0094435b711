"""Friends-of-friends over a ring of ranks (port of
fastpm_tpu/parallel/pfof.py).

The counterpart of the reference's distributed FOF merge loop
(libfastpm/fof.c:289-420): every rank labels its rows locally, sends the
labels of its boundary rows to its neighbours as ghosts, takes minima,
and repeats until no rank changes. As in the JAX package:

- the rows are x-major over a 1D ring, each rank a block of the same
  size, so rank d holds the x-slab [d sw, (d + 1) sw) up to a bounded
  displacement (the homing-by-construction of parallel/psolver.py);
- a rank's boundary rows are those whose linking-length ball touches
  the slab of a neighbour (pm_ghosts_create's window probe,
  pmghosts.c:31-131); they go to that neighbour in a buffer of
  ghost_cap rows;
- each outer round runs the local pass over the owned rows and the valid
  ghosts, with labels in global row space, sends the ghosts' new labels
  back to their owners, who fold them in with a minimum
  (pm_ghosts_reduce, pmghosts.c:247-307), and follows labels that point
  at a local row (three pointer jumps);
- the loop ends when the sum over the ranks of the changed flags is 0.

Ghost capacity follows the alloc_factor contract (store.c:507-509): the
boundary population is measured (boundary_capacity), rounded up to a
power of two, and rows that do not fit, or whose ball reaches beyond the
neighbouring slabs, are counted as overflow, which the caller must not
ignore (fof_labels_sharded_auto raises).

Where the JAX package takes the global rows and a Mesh, these functions
take the rank's own rows and a comm.Ring. The local pass runs the port's
FOF link (ops/fof_device.fof_link: the kernel of csrc/fof_link.cu on the
card, its plain version on the CPU), so rows link by the host
union-find's rule. The ghosts' positions and counts do not change
between rounds: they cross once, and only the labels cross each round.
Every raise and the end of the loop are decided on values that every
rank holds after a collective, so no rank is left waiting in one.
Labels are the least global row of each group, the host union-find's
labels of the rows concatenated in rank order.

Nothing in the port calls this module: as in the JAX package, the CLI
runs FOF on rank 0 over the gathered rows.
"""

from __future__ import annotations

import torch

from ..ops.fof_device import (fof_link, max_cell_occupancy, _table_grid,
                              _table_ids, _table_order)
from .comm import Ring

__all__ = ["fof_labels_sharded", "fof_labels_sharded_auto",
           "boundary_capacity"]


def _local_label_pass(x, lab, valid, ll, boxsize, rmax=None,
                      max_rounds=None):
    """Labels over one rank's rows (owned and ghosts): x (M, 3) float32
    in [0, boxsize]; lab (M,) int64 global labels; valid (M,) bool (rows
    that are not valid never link and keep their label). Returns, for
    every valid row, the least label of its linked group, the fixed
    point of the JAX package's label propagation (pfof.py:45-126).

    The components come from fof_link over the valid rows (the table
    grid of _table_grid, sorted by _table_order), then a segment minimum
    of the labels over each root. The JAX package's rmax (candidates a
    cell) and max_rounds (propagation rounds) bound nothing here: they
    stay in the signature for parity."""
    del rmax, max_rounds
    out = lab.clone()
    rows = torch.nonzero(valid).reshape(-1)
    n = rows.shape[0]
    if n == 0:
        return out
    L = float(boxsize)
    xv = x[rows].contiguous()
    ncol = _table_grid(ll, L, n)
    cid = _table_ids(xv, ncol, L)
    order = _table_order(xv, cid)
    root = fof_link(xv[order].contiguous(), cid[order], ncol, L,
                    ll).long()
    seeded = lab[rows[order]]
    least = torch.full((n,), torch.iinfo(torch.int64).max,
                       dtype=torch.int64, device=lab.device)
    least.scatter_reduce_(0, root, seeded, "amin")
    out[rows[order]] = least[root]
    return out


def _reach(x0, nproc: int, boxsize: float, ll: float):
    """(lo, k, hi) of every row: its linking-length ball touches the k
    slabs from slab lo to slab hi (x0 the rows' x, any real value;
    pfof.py:146-151 and :215-219, in float32 as there)."""
    L = float(boxsize)
    sw = L / nproc
    xw = x0 - torch.floor(x0 / L) * L
    lo = torch.remainder(torch.floor((xw - ll) / sw).long(), nproc)
    hi = torch.remainder(torch.floor((xw + ll) / sw).long(), nproc)
    return lo, torch.remainder(hi - lo, nproc) + 1, hi


def _contains(t, lo, k, nproc: int):
    """Whether slab t (a number or one per row) is among each row's k
    slabs from lo."""
    return torch.remainder(t - lo, nproc) < k


def _face_rows(x, me: int, nproc: int, boxsize, ll) -> int:
    """The larger of the counts of rank me's rows x whose linking-length
    ball touches slab me - 1, or slab me + 1."""
    lo, k, _ = _reach(x[:, 0], nproc, boxsize, ll)
    return max(int(_contains(me + s, lo, k, nproc).sum()) for s in (-1, 1))


def boundary_capacity(x, ring_or_nproc, boxsize, ll) -> int:
    """The measured boundary population: the largest, over the ranks and
    the two faces, number of a rank's rows whose linking-length ball
    touches the neighbouring slab (pfof.py:129-164, the ghost buffer's
    sizing pass). Given a Ring, x is this rank's rows and the maximum is
    taken over the ranks (every rank gets it); given a number of ranks,
    x is the global rows in rank order, as the JAX package takes them."""
    ll = float(ll)
    if isinstance(ring_or_nproc, Ring):
        ring = ring_or_nproc
        occ = _face_rows(x, ring.rank, ring.nproc, boxsize, ll)
        return int(ring.pmax(torch.tensor([occ], device=ring.device))[0])
    nproc = int(ring_or_nproc)
    x = torch.as_tensor(x)
    pper = x.shape[0] // nproc
    # rows past nproc * pper belong to no rank (segment_sum drops them)
    return max(_face_rows(x[d * pper:(d + 1) * pper], d, nproc, boxsize, ll)
               for d in range(nproc))


def _pack(mask, cap: int):
    """The indices of the first cap rows of mask, and the count of the
    rows beyond. The JAX package pads its index buffer with row nl - 1
    and masks the padding; here the padding is never read: the count
    crosses with it."""
    idx = torch.nonzero(mask).reshape(-1)
    return idx[:cap], max(idx.shape[0] - cap, 0)


def _padded(t: torch.Tensor, cap: int) -> torch.Tensor:
    """t's rows in a buffer of cap rows (every rank sends the same
    shape); the rows past len(t) are zeros that the receiver drops."""
    out = torch.zeros((cap,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    out[:t.shape[0]] = t
    return out


def _hop(ring: Ring, t: torch.Tensor, hop: int) -> torch.Tensor:
    """ring.ppermute(t, hop), t staged through the ring's transport
    device when that is not t's (gloo ranks whose rows are on a card)."""
    if ring.nproc == 1 or t.device == ring.device:
        return ring.ppermute(t, hop)
    return ring.ppermute(t.to(ring.device), hop).to(t.device)


def fof_labels_sharded(x, linking_length, boxsize, ring: Ring,
                       rmax: int = 32, ghost_cap: int = None,
                       max_outer: int = 8, max_rounds: int = 64):
    """FOF labels of x-major rows over a ring of ranks (pfof.py:167-294).
    x: this rank's rows (nl, 3) float32, every rank the same nl. Returns
    (labels (nl,) int64 on x's device: the least global row, rank * nl
    + local row, of each row's group; overflow: the number of rows over
    all ranks that did not fit a ghost buffer or reach beyond the
    neighbouring slabs, the same on every rank). overflow > 0 means that
    links may be missing: the caller must re-size (ghost_cap) or use the
    single-device path.

    rmax and max_rounds are the JAX package's bounds of its local pass,
    which bound nothing here (_local_label_pass). ghost_cap None:
    boundary_capacity rounded up to a power of two, at least 256. On one
    rank every row is a ghost of itself on both sides (the JAX package's
    contract): the local pass runs over 3 nl rows and the labels are
    those of one pass.

    fof_labels_sharded.rounds, .ghost_cap and .rows hold the last call's
    outer rounds, ghost capacity and rows of its last local pass."""
    ll = float(linking_length)
    L = float(boxsize)
    nproc, me = ring.nproc, ring.rank
    nl = x.shape[0]
    dev = x.device
    span = ring.pmax(torch.tensor([nl, -nl], dtype=torch.int64,
                                  device=ring.device))
    if int(span[0]) != -int(span[1]):
        raise ValueError("every rank must hold the same number of rows "
                         "(the particle count must divide the device "
                         "ring)")
    sw = L / nproc
    if sw <= 2 * ll:
        raise ValueError("slab width must exceed 2 linking lengths")
    if ghost_cap is None:
        occ = boundary_capacity(x, ring, L, ll)
        ghost_cap = 256
        while ghost_cap < occ:
            ghost_cap *= 2
    base = me * nl

    xw = x - torch.floor(x / L) * L
    lo, k, hi = _reach(x[:, 0], nproc, L, ll)
    # a row whose ball reaches beyond slabs me - 1 .. me + 1 would link
    # to a rank no ghost reaches: it counts as overflow
    lo_rel = torch.remainder(lo - (me - 1), nproc)
    hi_rel = torch.remainder(hi - (me - 1), nproc)
    reach_ok = (k <= 3) & (lo_rel <= 2) & (hi_rel <= 2)
    ilo, ov1 = _pack(_contains(me - 1, lo, k, nproc), ghost_cap)
    ihi, ov2 = _pack(_contains(me + 1, lo, k, nproc), ghost_cap)
    nlo, nhi = ilo.shape[0], ihi.shape[0]
    overflow = int((~reach_ok).sum()) + ov1 + ov2
    del lo, k, hi, lo_rel, hi_rel, reach_ok

    def send(t, hop, n):
        """The first n rows of the block that the rank hop places back
        sent with t (every rank sends ghost_cap rows)."""
        return _hop(ring, _padded(t, ghost_cap), hop)[:n]

    # the ghosts' counts and positions, once: from the right neighbour
    # its rows near my slab (they travel left), from the left its rows
    # near mine (they travel right)
    glo_n = int(_hop(ring, torch.tensor([nlo], device=dev), -1)[0])
    ghi_n = int(_hop(ring, torch.tensor([nhi], device=dev), 1)[0])
    allx = torch.cat([xw, send(xw[ilo], -1, glo_n), send(xw[ihi], 1, ghi_n)])
    valid = torch.ones(allx.shape[0], dtype=torch.bool, device=dev)

    lab = base + torch.arange(nl, dtype=torch.int64, device=dev)
    rounds = 0
    for rounds in range(1, max_outer + 1):
        alll = torch.cat([lab, send(lab[ilo], -1, glo_n),
                          send(lab[ihi], 1, ghi_n)])
        newl = _local_label_pass(allx, alll, valid, ll, L, rmax, max_rounds)
        # the ghosts' labels travel back to their owners and fold in
        # with a minimum
        lab2 = newl[:nl].clone()
        lab2.scatter_reduce_(0, ilo, send(newl[nl:nl + glo_n], 1, nlo),
                             "amin")
        lab2.scatter_reduce_(0, ihi, send(newl[nl + glo_n:], -1, nhi),
                             "amin")
        del newl, alll
        # head relabel (fof.c _merge): a label that names a local row
        # takes that row's label; labels of other ranks' rows resolve
        # over the outer rounds
        for _ in range(3):
            local = (lab2 >= base) & (lab2 < base + nl)
            lrow = torch.clamp(lab2 - base, 0, nl - 1)
            lab2 = torch.minimum(lab2, torch.where(local, lab2[lrow], lab2))
        changed = int((lab2 != lab).any())
        lab = lab2
        if not ring.psum(changed):
            break
    fof_labels_sharded.rounds = rounds
    fof_labels_sharded.ghost_cap = ghost_cap
    fof_labels_sharded.rows = int(allx.shape[0])
    return lab, int(ring.psum(overflow))


fof_labels_sharded.rounds = 0
fof_labels_sharded.ghost_cap = 0
fof_labels_sharded.rows = 0


def fof_labels_sharded_auto(x, linking_length, boxsize, ring: Ring,
                            max_outer: int = 16):
    """fof_labels_sharded with the JAX package's sizing passes
    (pfof.py:297-318): rmax from the largest linking-cell occupancy over
    the ranks, rounded up to a power of two (the port's local pass needs
    none, but the sizing stays), and ghost_cap from the measured boundary
    population. Raises RuntimeError on every rank when rows overflow
    (the alloc_factor contract, store.c:507-509)."""
    occ = int(ring.pmax(torch.tensor(
        [max_cell_occupancy(x, linking_length, boxsize)],
        device=ring.device))[0])
    rmax = 4
    while rmax < occ:
        rmax *= 2
    lab, overflow = fof_labels_sharded(x, linking_length, boxsize, ring,
                                       rmax=rmax, max_outer=max_outer)
    if overflow:
        raise RuntimeError(
            f"sharded FOF ghost overflow: {overflow} rows reach beyond "
            "the +-1 neighbor slabs (re-home or use the single-device "
            "path)")
    return lab
