"""Friends-of-friends labels and halo aggregates on the device (port of
fastpm_tpu/ops/fof_device.py).

On the card (fof_labels_table):
1. hash the rows to the (x, y) columns of a table grid (_table_grid:
   columns wider than the linking length, at most one a row) and sort
   them by column, then z;
2. fof_link: the kernel of csrc/fof_link.cu builds the column table once
   and links every pair within the linking length in one union-find
   sweep, reading each neighbour column only over a z window; each row
   gets the least sorted row of its group.

On the CPU (the JAX package's shape, which the tests hold against it):
1. hash the rows to linking-length cells (_grid) and sort them;
2. per round: every row takes the least label over its linked neighbours
   in the 27 cells around it (neighbor_min_plain), then a scatter-min
   hook and four pointer-doubling compress steps (Shiloach-Vishkin);
3. rounds run until the labels are a fixed point (or max_rounds).

Labels are the least ORIGINAL row index of each group. Two rows link by
the host union-find's rule (csrc/fof.c): the float32 difference of each
coordinate, widened to double and wrapped once by the box, with r2 in
double below ll^2. So the labels equal the host's bit for bit at any
size; the JAX package's float32 rule (d^2 <= float32(ll^2)) agrees with
it on the small cases of its tests but not on a 16.8 M-row z = 0 state.
The aggregates (halo_attrs_device) are segment sums keyed by the label
(index_add_), compacted to the kept halos in label order
(halo_catalog_device).

The JAX version sizes its programs with power-of-two capacity ladders for
XLA's compile cache; here every array has its exact length.
"""

from __future__ import annotations

import numpy as np
import torch

from .cudalib import launch as _launch

__all__ = ["max_cell_occupancy", "neighbor_min", "neighbor_min_plain",
           "cell_table_plain", "fof_link", "fof_link_plain",
           "fof_labels_table", "fof_labels_device", "fof_labels_device_auto",
           "halo_attrs_device", "halo_catalog_device"]

_OFFSETS = [(ox, oy, oz) for ox in (-1, 0, 1) for oy in (-1, 0, 1)
            for oz in (-1, 0, 1)]
# candidate pairs the plain fof_link tests at once
_PAIR_CHUNK = 2 ** 22


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
    """One round's sweep of the CPU labels: the least label over every
    row linked to each row (its own included), lab (n,) int32, x_s
    (n, 3) float32 and cid_s (n,) int64 sorted by linking cell; ll2 the
    squared linking length. It is neighbor_min_plain with rmax (measured
    from cid_s when None). The card links by fof_link instead, in one
    sweep, and this raises on a CUDA tensor."""
    n = lab.shape[0]
    if not (lab.dtype == torch.int32 and x_s.dtype == torch.float32
            and cid_s.dtype == torch.int64 and x_s.shape == (n, 3)
            and cid_s.shape == (n,)):
        raise ValueError("neighbor_min takes int32 labels, (n, 3) float32 "
                         "positions and (n,) int64 sorted cell ids")
    if not (lab.device == x_s.device == cid_s.device):
        raise ValueError("neighbor_min: inputs on different devices")
    if lab.device.type != "cpu":
        raise ValueError("neighbor_min is the CPU rounds' sweep; on the "
                         "card fof_link links the rows")
    if rmax is None:
        rmax = (int(torch.unique_consecutive(
            cid_s, return_counts=True)[1].max()) if n else 0)
    return neighbor_min_plain(lab, x_s, cid_s, ncell, boxsize, ll2, rmax)


def _margin(linking_length, boxsize) -> float:
    """A bound, with room to spare, on how far float32 rounding moves a
    row across a column face or a separation from its real value (each
    is below L 2^-22 for rows in [0, L))."""
    return float(boxsize) * 2.0 ** -21 + float(linking_length) * 2.0 ** -20


def _table_grid(linking_length, boxsize, n: int) -> int:
    """Columns a side of the table grid: at most one column a row
    (ncol^2 <= n, so the table has at most n + 1 entries), and columns
    wider than the linking length by twice _margin, so that two rows
    within it sit in neighbouring columns whatever the rounding."""
    L, ll = float(boxsize), float(linking_length)
    fit = int(L / (ll + 2.0 * _margin(ll, L)))
    return max(1, min(fit, int(np.sqrt(n))))


def _inv(ncol: int, boxsize) -> float:
    """float32(ncol / L): the column of x is floor(x * inv) on x and y."""
    return float(np.float32(ncol / float(boxsize)))


def _table_ids(x: torch.Tensor, ncol: int, boxsize) -> torch.Tensor:
    """int32 column of every row: cx * ncol + cy, each axis floor(x *
    inv) in float32, wrapped into [0, ncol) (the kernel computes a row's
    column the same way)."""
    inv = torch.tensor(_inv(ncol, boxsize), dtype=torch.float32,
                       device=x.device)
    ci = torch.remainder(torch.floor(x[:, :2] * inv).to(torch.int32), ncol)
    return ci[:, 0] * ncol + ci[:, 1]


def _table_order(x: torch.Tensor, cid: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts the rows by column, then by z: one sort
    of an int64 key, the column above z's float32 bits made monotone
    (negative z included)."""
    bits = (x[:, 2] + 0.0).contiguous().view(torch.int32)
    zkey = (bits ^ ((bits >> 31) & 0x7fffffff)).long() + 2 ** 31
    return torch.sort((cid.long() << 32) | zkey).indices


def cell_table_plain(cid_s: torch.Tensor, ncells: int) -> torch.Tensor:
    """The table: (ncells + 1,) int32, entry c the first sorted row of
    column c (the number of rows with a smaller id), the last n."""
    cells = torch.arange(ncells + 1, dtype=cid_s.dtype, device=cid_s.device)
    return torch.searchsorted(cid_s, cells).to(torch.int32)


def _components(n: int, a: torch.Tensor, b: torch.Tensor, device):
    """The least row of each row's connected component over the edges
    (a, b): min-label propagation with pointer jumping."""
    lab = torch.arange(n, dtype=torch.int64, device=device)
    while True:
        m = lab.clone()
        m.scatter_reduce_(0, a, lab[b], "amin")
        m.scatter_reduce_(0, b, lab[a], "amin")
        while True:
            jumped = m[m]
            if torch.equal(jumped, m):
                break
            m = jumped
        if torch.equal(m, lab):
            return lab
        lab = m


def fof_link_plain(x_s: torch.Tensor, cid_s: torch.Tensor, ncol: int,
                   boxsize, linking_length) -> torch.Tensor:
    """Plain fof_link: every pair of rows in neighbouring columns (the
    table, each distinct neighbour column, every z) tested by the host
    union-find's rule, and the connected components of the links.
    Returns (n,) int32: each row's least sorted row of its group."""
    n = x_s.shape[0]
    dev = x_s.device
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    L = float(boxsize)
    Lh = 0.5 * L
    ll = float(linking_length)
    ll2 = ll * ll
    start = cell_table_plain(cid_s, ncol * ncol).long()
    c = cid_s.long()
    cx, cy = c // ncol, c % ncol
    # the distinct neighbour offsets of an axis (1 or 2 columns alias)
    offs = sorted({o % ncol for o in (-1, 0, 1)})
    rows = torch.arange(n, device=dev)
    src, dst = [], []
    for ox in offs:
        for oy in offs:
            nid = (torch.remainder(cx + ox, ncol) * ncol
                   + torch.remainder(cy + oy, ncol))
            # each pair once, from its lower row
            a = torch.maximum(start[nid], rows + 1)
            cnt = torch.clamp(start[nid + 1] - a, min=0)
            ends = torch.cumsum(cnt, 0)
            r0 = 0
            while r0 < n and int(ends[-1]):
                # rows [r0, r1) hold at most _PAIR_CHUNK pairs (or one
                # row's)
                done = int(ends[r0 - 1]) if r0 else 0
                r1 = int(torch.searchsorted(ends, done + _PAIR_CHUNK,
                                            right=True))
                r1 = max(r1, r0 + 1)
                k = cnt[r0:r1]
                i = torch.repeat_interleave(rows[r0:r1], k)
                first = torch.cumsum(k, 0) - k
                j = (a[r0:r1].repeat_interleave(k)
                     + torch.arange(int(k.sum()), device=dev)
                     - first.repeat_interleave(k))
                d = (x_s[i] - x_s[j]).double()
                d = torch.where(d > Lh, d - L, d)
                d = torch.where(d < -Lh, d + L, d)
                r2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
                link = r2 < ll2
                src.append(i[link])
                dst.append(j[link])
                r0 = r1
    if src:
        a, b = torch.cat(src), torch.cat(dst)
    else:
        a = b = torch.zeros(0, dtype=torch.int64, device=dev)
    return _components(n, a, b, dev).to(torch.int32)


def fof_link(x_s: torch.Tensor, cid_s: torch.Tensor, ncol: int, boxsize,
             linking_length) -> torch.Tensor:
    """FOF roots of rows sorted by column, then z (_table_ids and
    _table_order on a grid of ncol^2 columns wider than the linking
    length): x_s (n, 3) float32, cid_s (n,) int32 ascending. Returns
    (n,) int32, each row's least sorted row of its group. On CUDA this
    launches csrc/fof_link.cu (the column table, one union-find sweep,
    the roots); on the CPU it is fof_link_plain."""
    n = x_s.shape[0]
    if not (x_s.dtype == torch.float32 and cid_s.dtype == torch.int32
            and x_s.shape == (n, 3) and cid_s.shape == (n,)):
        raise ValueError("fof_link takes (n, 3) float32 positions and (n,) "
                         "int32 sorted column ids")
    if x_s.device != cid_s.device:
        raise ValueError("fof_link: inputs on different devices")
    if ncol * ncol >= 2 ** 31 - 1:
        raise ValueError("fof_link: the table needs ncol^2 < 2^31 - 1")
    if x_s.device.type == "cpu":
        return fof_link_plain(x_s, cid_s, ncol, boxsize, linking_length)
    L, ll = float(boxsize), float(linking_length)
    x_s, cid_s = x_s.contiguous(), cid_s.contiguous()
    # a z outside [0, L] breaks the windows' wrap: read whole columns
    z = x_s[:, 2]
    outside = ((z < 0) | (z > L)).any()
    table = torch.empty(ncol * ncol + 1, dtype=torch.int32,
                        device=x_s.device)
    out = torch.empty(n, dtype=torch.int32, device=x_s.device)
    _launch("fastpm_fof_link", x_s.data_ptr(), cid_s.data_ptr(), n, ncol,
            _inv(ncol, L), L, ll * ll, ll + _margin(ll, L),
            outside.data_ptr(), table.data_ptr(), out.data_ptr(),
            device=x_s.device)
    fof_link.launches += 1
    return out


fof_link.launches = 0


def _canonical(lab: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Sorted-space representatives -> the least ORIGINAL index of each
    group, back in the original row order (int64)."""
    n = lab.shape[0]
    lab = lab.long()
    min_orig = torch.full((n,), n, dtype=torch.int64, device=lab.device)
    min_orig.scatter_reduce_(0, lab, order, "amin")
    out = torch.empty(n, dtype=torch.int64, device=lab.device)
    out[order] = min_orig[lab]
    return out


def fof_labels_table(x: torch.Tensor, linking_length,
                     boxsize) -> torch.Tensor:
    """FOF labels (int64: the least original row index of each group) of
    the periodic positions x (N, 3) float32 in [0, boxsize), by the
    column table and one union-find sweep (fof_link: the kernel on the card,
    its plain version on the CPU)."""
    n = x.shape[0]
    if n >= 2 ** 31:
        raise ValueError("fof_labels_table: int32 rows need N < 2^31")
    ncol = _table_grid(linking_length, boxsize, n)
    cid = _table_ids(x, ncol, boxsize)
    order = _table_order(x, cid)
    x_s = x[order].contiguous()
    return _canonical(fof_link(x_s, cid[order], ncol, boxsize,
                               linking_length), order)


def fof_labels_device(x: torch.Tensor, linking_length, boxsize,
                      rmax: int | None = None,
                      max_rounds: int = 64) -> torch.Tensor:
    """FOF labels (int64: the least original row index of each group)
    of the periodic positions x (N, 3) float32 in [0, boxsize). On the
    card: fof_labels_table, one sweep. On the CPU: the JAX package's
    label rounds, with rmax bounding the plain sweep's per-cell
    candidates (None: measured). fof_labels_device.rounds holds the
    sweeps (card) or rounds (CPU) the last call took."""
    ll = float(linking_length)
    L = float(boxsize)
    n = x.shape[0]
    if n >= 2 ** 31:
        raise ValueError("fof_labels_device: int32 labels need N < 2^31")
    if x.device.type != "cpu":
        fof_labels_device.rounds = 1
        return fof_labels_table(x, ll, L)
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
    return _canonical(lab, order)


fof_labels_device.rounds = 0


def fof_labels_device_auto(x: torch.Tensor, linking_length, boxsize,
                           max_rounds: int = 64) -> torch.Tensor:
    """fof_labels_device with the occupancy sizing pass the plain sweep
    needs (on the CPU); on the card the table path needs none."""
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
