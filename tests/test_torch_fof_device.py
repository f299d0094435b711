"""The port's device FOF (fastpm_torch/ops/fof_device.py, fof.py) against
the JAX package's and the host union-find.

On the CPU the neighbour sweep is its plain version (neighbor_min_plain);
labels are the least original index per group, so they must equal the
host union-find exactly (the port links by its rule) and the JAX labels
(whose float32 rule agrees with the host's on these cases). The JAX
sweep unrolls 27 x rmax steps and compiles them on every call, seconds
alone and minutes on a loaded machine, so the JAX labels are computed
here for the cases with few rows a cell (the periodic chain, the
filament, the catalogs' data); on the two clustered cases (11 and 10
rows a cell) tests/test_fof_device.py already holds the JAX labels
equal to the host union-find on the same inputs. Catalogs: lengths, minid and
ihalo exact, the float columns within atol 1e-4 (float32 segment sums in
another order; the JAX package's own tolerance, tests/test_fof_device.py).
The card's path (fof_labels_table: a column table and one union-find sweep,
fof_link) runs here through its plain version (fof_link_plain): its table
against a brute-force count, and its labels against the host union-find
on CASES (whose JAX labels test_labels_match_jax_and_host holds equal to
the host's), a crowded cell, rows on all six faces of the box and an open
box embedded as find_halos_device embeds it. The CUDA cases hold the
kernel (csrc/fof_link.cu) against its plain version on the card, bit for
bit, and skip without one; they need no JAX, so on a GPU machine the file
runs as `python -m pytest --noconftest tests/test_torch_fof_device.py -m
cuda`.
"""

import numpy as np
import pytest
import torch

from fastpm_torch.ops import fof_device as tfd
from fastpm_torch import fof as tfof
from fastpm_torch.convert import store_from_numpy


def clustered_points(n, box, seed=0, nclump=24, frac=0.6):
    """Uniform background + tight clumps, some straddling the periodic
    boundary (tests/test_fof_device.py)."""
    rng = np.random.RandomState(seed)
    nin = int(n * frac)
    pts = [rng.uniform(0, box, size=(n - nin, 3))]
    centers = rng.uniform(0, box, size=(nclump, 3))
    per = nin // nclump
    for c in centers:
        pts.append(c + rng.standard_normal((per, 3)) * 0.02 * box)
    x = np.concatenate(pts)
    if len(x) < n:
        x = np.concatenate([x, rng.uniform(0, box, (n - len(x), 3))])
    return (x[:n] % box).astype(np.float32)


def clumps(n, box, seed, nclump, spread):
    """A third of the rows uniform, the rest in nclump gaussian clumps of
    width spread * box, wrapped into the box."""
    rng = np.random.RandomState(seed)
    pts = [rng.uniform(0, box, (n // 3, 3))]
    per = (n - n // 3) // nclump
    for c in rng.uniform(0, box, (nclump, 3)):
        pts.append(c + rng.standard_normal((per, 3)) * spread * box)
    return (np.concatenate(pts) % box).astype(np.float32)


def _filament():
    x = np.zeros((200, 3), dtype=np.float32)
    x[:, 0] = 1.0 + np.arange(200) * 0.45
    x[:, 1] = x[:, 2] = 64.0
    return x, 0.5, 128.0


def _chain():
    x = np.array([[15.7, 8.0, 8.0], [15.95, 8.0, 8.0], [0.15, 8.0, 8.0],
                  [0.4, 8.0, 8.0], [8.0, 8.0, 8.0]], dtype=np.float32)
    return x, 0.3, 16.0


# the cases whose JAX labels are computed here
JAX_CASES = ("periodic_chain", "filament")

CASES = {
    "clustered1": lambda: (clustered_points(4000, 32.0, seed=1), 0.65, 32.0),
    "clustered2": lambda: (clustered_points(4000, 32.0, seed=2), 0.65, 32.0),
    "periodic_chain": _chain,
    "filament": _filament,
}


def _crowded():
    """3000 rows inside one linking cell (a cube of half the linking
    length), far above the table grid's mean occupancy, in a uniform
    background of 2000."""
    rng = np.random.RandomState(11)
    box, ll = 32.0, 0.65
    # linking cell 30 of 49 on each axis spans [19.59, 20.24)
    x = np.concatenate([19.7 + rng.uniform(0, 0.5 * ll, (3000, 3)),
                        rng.uniform(0, box, (2000, 3))])
    return x.astype(np.float32), ll, box


def _faces():
    """Rows on all six faces of the box: on x, y or z = 0, just below
    the box size and at it (a float32 wrap gives it), jittered by a
    fraction of the linking length, so that groups link across each
    periodic face; and a uniform background."""
    rng = np.random.RandomState(12)
    box, ll = 16.0, 0.4
    below = np.nextafter(np.float32(box), np.float32(0))
    parts = [rng.uniform(0, box, (1500, 3)).astype(np.float32)]
    for axis in range(3):
        for at in (0.0, below, box):
            p = rng.uniform(0, box, (120, 3)).astype(np.float32)
            p[:, axis] = at
            p[:60, axis] += (rng.uniform(-0.3, 0.3, 60) * ll).astype(
                np.float32)
            parts.append(p)
    x = np.concatenate(parts)
    x = np.where(x < 0, x + np.float32(box), x)
    return np.where(x > box, x - np.float32(box), x).astype(np.float32), ll, box


# the card path's cases: CASES, a crowded cell, rows on the six faces
TABLE_CASES = dict(CASES, crowded=_crowded, faces=_faces)


@pytest.mark.parametrize("case", sorted(CASES))
def test_labels_match_jax_and_host(case):
    import jax.numpy as jnp
    from fastpm_tpu.fof import fof_labels
    from fastpm_tpu.ops.fof_device import (fof_labels_device,
                                           max_cell_occupancy)
    x, ll, box = CASES[case]()
    host = fof_labels(x, ll, box)
    occ = max_cell_occupancy(jnp.asarray(x), ll, box)
    xt = torch.from_numpy(x)
    assert tfd.max_cell_occupancy(xt, ll, box) == occ
    got = tfd.fof_labels_device(xt, ll, box, rmax=occ).numpy()
    np.testing.assert_array_equal(got, host)
    if case in JAX_CASES:
        np.testing.assert_array_equal(got, np.asarray(fof_labels_device(
            jnp.asarray(x), ll, box, rmax=occ)))
    # the auto entry sizes rmax itself
    np.testing.assert_array_equal(
        tfd.fof_labels_device_auto(xt, ll, box).numpy(), host)
    if case == "filament":
        assert (host == 0).all()
        assert tfd.fof_labels_device.rounds > 1


def test_neighbor_min_plain_matches_brute_force():
    """One sweep from a scrambled labelling: the plain version against a
    brute force over all pairs with the host union-find's link rule
    (float32 differences, double r2 < ll^2)."""
    x, ll, box = CASES["clustered1"]()
    ncell, cs = tfd._grid(ll, box)
    xt = torch.from_numpy(x)
    cid_s, order = torch.sort(tfd._cell_ids(xt, ncell, cs), stable=True)
    x_s = xt[order]
    rng = np.random.RandomState(4)
    lab = torch.from_numpy(rng.permutation(len(x)).astype(np.int32))
    got = tfd.neighbor_min(lab, x_s, cid_s, ncell, box, ll * ll)
    xs = x_s.numpy()
    d = (xs[:, None, :] - xs[None, :, :]).astype(np.float64)
    d = np.where(d > box / 2, d - box, d)
    d = np.where(d < -box / 2, d + box, d)
    r2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    link = r2 < ll * ll
    want = np.where(link, lab.numpy()[None, :], len(x)).min(axis=1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cell_table_plain_matches_brute_force():
    """The plain table: entry c the number of rows with a smaller column
    id, the last one n; empty columns, a crowded one and the last one
    included."""
    rng = np.random.RandomState(6)
    ncells = 343
    ids = np.concatenate([rng.randint(0, ncells, 500), np.full(60, 17),
                          [ncells - 1, 0]])
    cid_s = torch.from_numpy(np.sort(ids).astype(np.int32))
    got = tfd.cell_table_plain(cid_s, ncells).numpy()
    want = np.array([(ids < c).sum() for c in range(ncells + 1)])
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and got[-1] == len(ids)
    assert tfd.cell_table_plain(cid_s[:0], 8).tolist() == [0] * 9


@pytest.mark.parametrize("case", sorted(TABLE_CASES))
def test_table_labels_match_host(case):
    """The card's path through its plain version (fof_labels_table on
    the CPU: the column grid, the sort by column and z, fof_link_plain)
    against the host union-find, and fof_link's roots the least sorted
    row of each group."""
    from fastpm_tpu.fof import fof_labels
    x, ll, box = TABLE_CASES[case]()
    host = fof_labels(x, ll, box)
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(
        tfd.fof_labels_table(xt, ll, box).numpy(), host)
    ncol = tfd._table_grid(ll, box, len(x))
    assert ncol ** 2 <= len(x)
    cid = tfd._table_ids(xt, ncol, box)
    order = tfd._table_order(xt, cid)
    # rows by column, then z
    key = cid[order].double() * 4 * box + xt[order, 2].double()
    assert bool((key[1:] >= key[:-1]).all())
    root = tfd.fof_link(xt[order], cid[order], ncol, box, ll).numpy()
    # each root is the least sorted row of its group
    assert (root <= np.arange(len(x))).all()
    assert (root[root] == root).all()
    if case == "crowded":
        assert len(np.unique(host[:3000])) == 1
        assert tfd.max_cell_occupancy(xt, ll, box) >= 3000
    if case == "faces":
        # groups that link across a periodic face
        wrapped = [np.ptp(x[host == g], axis=0).max() > box / 2
                   for g in np.unique(host)]
        assert any(wrapped)


def test_table_labels_open_box():
    """An open box (a lightcone slice: clumps spread far outside any
    box) embedded as find_halos_device embeds it: the table path's
    labels equal the host union-find's with periodic=False."""
    from fastpm_tpu.fof import fof_labels
    rng = np.random.RandomState(8)
    ll = 0.6
    centers = rng.uniform(-50, 90, size=(8, 3))
    x = np.concatenate([c + rng.standard_normal((150, 3)) * 0.8
                        for c in centers]).astype(np.float32)
    host = fof_labels(x, ll, 1.0, periodic=False)
    xt = torch.from_numpy(x)
    lo = xt.min(dim=0).values
    L = float((xt - lo).max()) + 4.0 * ll
    got = tfd.fof_labels_table(xt - lo + float(np.float32(ll)), ll, L)
    np.testing.assert_array_equal(got.numpy(), host)
    assert len(np.unique(host)) < len(x) // 2


def _catalogs_equal(got, want, ih_got, ih_want, atol=1e-4):
    assert got.nhalo == want.nhalo
    np.testing.assert_array_equal(got.length, want.length)
    np.testing.assert_array_equal(got.minid, want.minid)
    np.testing.assert_array_equal(np.asarray(ih_got), np.asarray(ih_want))
    for k in ("x", "v", "rdisp", "vdisp", "rvdisp", "q", "aemit"):
        a, b = getattr(got, k), getattr(want, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_allclose(a, b, atol=atol, err_msg=k)


@pytest.mark.parametrize("periodic", [True, False])
def test_find_halos_device_matches_jax(periodic):
    import jax.numpy as jnp
    from fastpm_tpu.fof import find_halos_device as jfind
    from fastpm_tpu.store import Store as JStore
    rng = np.random.RandomState(7)
    # at most 4 rows a linking cell (the JAX sizing pass's smallest
    # rmax): the JAX sweep unrolls 27 x rmax steps and compiles them for
    # every call
    if periodic:
        box, ll = 32.0, 0.65
        x = clumps(4000, box, seed=5, nclump=24, spread=0.04)
    else:
        # clumps spread far outside any box (a lightcone slice)
        box, ll = 1.0, 0.6
        centers = rng.uniform(-50, 90, size=(8, 3))
        x = np.concatenate([c + rng.standard_normal((100, 3))
                            for c in centers]).astype(np.float32)
    n = len(x)
    v = rng.standard_normal((n, 3)).astype(np.float32)
    ids = np.arange(n, dtype=np.uint32)
    rng.shuffle(ids)
    aemit = rng.uniform(0.5, 1.0, n).astype(np.float32)
    cat_j, ih_j = jfind(JStore(x=jnp.asarray(x), v=jnp.asarray(v),
                               id=jnp.asarray(ids), aemit=jnp.asarray(aemit),
                               M0=1.0), ll, box, nmin=20, periodic=periodic)
    p = store_from_numpy(x, v, ids, aemit=aemit, M0=1.0)
    cat_t, ih_t = tfof.find_halos_device(p, ll, box, nmin=20,
                                         periodic=periodic)
    assert cat_t.nhalo > 3
    _catalogs_equal(cat_t, cat_j, ih_t.numpy(), ih_j)
    # the host path of the port: same rows, exact where the device is
    cat_h, ih_h = tfof.find_halos(p, ll, box, nmin=20, periodic=periodic,
                                  backend="host")
    _catalogs_equal(cat_t, cat_h, ih_t.numpy(), ih_h)


def test_rfof_matches_jax():
    """RFOF on a clustered store in snapshot units (km/s velocities):
    the same catalog rows as the JAX package's."""
    import jax.numpy as jnp
    from fastpm_tpu.cosmology import Cosmology as JCosmology
    from fastpm_tpu.fof import rfof_find_halos as jrfof
    from fastpm_tpu.store import Store as JStore
    from fastpm_torch.cosmology import Cosmology
    box, n = 64.0, 6000
    x = clumps(n, box, seed=9, nclump=40, spread=0.005)
    rng = np.random.RandomState(3)
    v = (rng.standard_normal((n, 3)) * 300).astype(np.float32)
    ids = np.arange(n, dtype=np.int64)
    sep = 1.0
    kw = dict(nmin=8, linkinglength=0.2 * sep, l1=0.35 * sep,
              l6=0.3 * sep, A1=0.012 * sep, A2=0.06 * sep)
    cj = JCosmology(h=0.6774, Omega_m=0.307494)
    ct = Cosmology(h=0.6774, Omega_m=0.307494)
    cat_j, ih_j = jrfof(JStore(x=jnp.asarray(x), v=jnp.asarray(v),
                               id=jnp.asarray(ids.astype(np.uint32)),
                               M0=0.5), box, 0.0, cj, **kw)
    cat_t, ih_t = tfof.rfof_find_halos(
        store_from_numpy(x, v, ids, M0=0.5), box, 0.0, ct, **kw)
    assert cat_t.nhalo > 5
    _catalogs_equal(cat_t, cat_j, ih_t.numpy(), np.asarray(ih_j))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(TABLE_CASES))
def test_fof_link_kernel_matches_plain(cuda_device, case):
    """The kernel (the column table, one union-find sweep, the roots)
    against its plain version, bit for bit, and the labels on the card
    against the CPU's label rounds and the host union-find."""
    from fastpm_torch.fof import fof_labels
    x, ll, box = TABLE_CASES[case]()
    xt = torch.from_numpy(x).to(cuda_device)
    ncol = tfd._table_grid(ll, box, len(x))
    cid = tfd._table_ids(xt, ncol, box)
    order = tfd._table_order(xt, cid)
    x_s, cid_s = xt[order].contiguous(), cid[order]
    before = tfd.fof_link.launches
    got = tfd.fof_link(x_s, cid_s, ncol, box, ll)
    torch.cuda.synchronize()
    assert tfd.fof_link.launches == before + 1
    want = tfd.fof_link_plain(x_s, cid_s, ncol, box, ll)
    assert torch.equal(got, want)
    lab = tfd.fof_labels_device(xt, ll, box).cpu().numpy()
    assert tfd.fof_labels_device.rounds == 1
    np.testing.assert_array_equal(
        lab, tfd.fof_labels_device_auto(xt.cpu(), ll, box).numpy())
    np.testing.assert_array_equal(lab, fof_labels(x, ll, box))


@pytest.mark.cuda
@pytest.mark.parametrize("periodic", [True, False])
def test_find_halos_on_cuda_matches_host(cuda_device, periodic):
    """find_halos on the card (the table path) against the host path:
    lengths, minid and ihalo exact, the float columns within atol
    1e-4; periodic, and an open box of clumps far outside any box."""
    rng = np.random.RandomState(7)
    if periodic:
        box, ll = 32.0, 0.65
        x = clumps(4000, box, seed=5, nclump=24, spread=0.04)
    else:
        box, ll = 1.0, 0.6
        centers = rng.uniform(-50, 90, size=(8, 3))
        x = np.concatenate([c + rng.standard_normal((100, 3))
                            for c in centers]).astype(np.float32)
    n = len(x)
    v = rng.standard_normal((n, 3)).astype(np.float32)
    ids = np.arange(n, dtype=np.uint32)
    rng.shuffle(ids)
    p = store_from_numpy(x, v, ids, M0=1.0)
    cat_h, ih_h = tfof.find_halos(p, ll, box, nmin=20, periodic=periodic,
                                  backend="host")
    before = tfd.fof_link.launches
    cat_d, ih_d = tfof.find_halos(
        store_from_numpy(x, v, ids, device=cuda_device, M0=1.0), ll, box,
        nmin=20, periodic=periodic, backend="device")
    assert tfd.fof_link.launches == before + 1
    assert cat_h.nhalo > 3
    _catalogs_equal(cat_d, cat_h, ih_d.cpu().numpy(), ih_h)
