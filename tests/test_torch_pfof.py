"""The port's sharded FOF (fastpm_torch/parallel/pfof.py) on gloo ranks
against the JAX package's host union-find and its pfof helpers.

The JAX package's fof_labels_sharded compiles its label rounds for long
(27 rmax unrolled gathers inside two while loops), so, as
tests/test_pfof.py does for the JAX function itself, the labels are held
against the host union-find (fastpm_tpu.fof.fof_labels) on the same
cases, exactly; the cheap parts (boundary_capacity, one local pass) are
held against the JAX package directly. One spawn of 8 gloo ranks
(tests/torch_rank_workers.py, the "pfof" job, no JAX there) runs every
case: the labels of test_pfof.py's three cases, its overflow case (the
count, by the JAX package's rule, and the raise of
fof_labels_sharded_auto on every rank), boundary_capacity over the ring,
and unequal row counts (ValueError on every rank). In-process: the local
pass, one rank without a group, boundary_capacity over 8 ranks.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fastpm_tpu.fof import fof_labels as host_fof_labels
from fastpm_tpu.parallel import pfof as jpfof

from test_torch_parallel import spawn
from fastpm_torch.parallel import pfof
from fastpm_torch.parallel.comm import Ring

NPROC, BOX = 8, 64.0
# name -> (rows a rank, seed, jitter, ll, kinds): test_pfof.py's cases
CASES = {
    "s3": (1500, 3, 0.0, 0.45, "sharded"),
    "s7": (1200, 7, 2.0, 0.45, "sharded"),     # strays, ghost-ghost links
    "s11": (1000, 11, 0.0, 0.6, "auto"),
    "s5": (512, 5, 0.0, 0.45, "sharded auto"),  # one row teleported
    "s9": (800, 9, 0.0, 0.45, "capacity unequal"),
}


def xmajor_points(n_per_slab, nproc, box, seed, jitter=0.0):
    """Clustered points in x-major slab-homed row order: device d's
    rows live in x-slab d (up to `jitter` in box units); copied from
    tests/test_pfof.py."""
    rng = np.random.RandomState(seed)
    sw = box / nproc
    rows = []
    for d in range(nproc):
        # a few cluster centers inside slab d, some near the faces so
        # halos straddle the boundary
        ncl = 4
        cx = d * sw + np.array([0.02, 0.35, 0.7, 0.98]) * sw
        cy = rng.uniform(0, box, ncl)
        cz = rng.uniform(0, box, ncl)
        per = n_per_slab // ncl
        pts = []
        for c in range(ncl):
            p = (np.stack([np.full(per, cx[c]), np.full(per, cy[c]),
                           np.full(per, cz[c])], -1)
                 + rng.standard_normal((per, 3)) * 0.35)
            pts.append(p)
        extra = n_per_slab - per * ncl
        pts.append(rng.uniform(0, box, (extra, 3))
                   + np.array([d * sw, 0, 0]) * 0)  # background
        p = np.concatenate(pts)
        if jitter:
            p[:, 0] += rng.uniform(-jitter, jitter, len(p))
        rows.append(p)
    x = np.concatenate(rows).astype(np.float32) % box
    return jnp.asarray(x)


def case_points(name):
    n, seed, jitter, _ll, _kinds = CASES[name]
    x = np.array(xmajor_points(n, NPROC, BOX, seed, jitter))
    if name == "s5":
        # one of rank 0's rows teleported into slab 3 (2+ slabs away)
        x[0, 0] = 3.5 * (BOX / NPROC)
    return x


def overflow_by_jax_rule(x, ll, ghost_cap):
    """ov0 + ov1 + ov2 of pfof.py:215-241 over the ranks, in numpy
    (float32 as there): rows whose ball reaches beyond the neighbouring
    slabs, and boundary rows past ghost_cap on either face."""
    L, sw = np.float32(BOX), np.float32(BOX / NPROC)
    total = 0
    for me, xb in enumerate(np.split(x, NPROC)):
        xw = xb[:, 0] - np.floor(xb[:, 0] / L) * L
        lo = np.mod(np.floor((xw - np.float32(ll)) / sw).astype(np.int64),
                    NPROC)
        hi = np.mod(np.floor((xw + np.float32(ll)) / sw).astype(np.int64),
                    NPROC)
        k = np.mod(hi - lo, NPROC) + 1
        reach = ((k <= 3) & (np.mod(lo - (me - 1), NPROC) <= 2)
                 & (np.mod(hi - (me - 1), NPROC) <= 2))
        total += int((~reach).sum())
        for t in (me - 1, me + 1):
            cnt = int((np.mod(t - lo, NPROC) < k).sum())
            total += max(cnt - ghost_cap, 0)
    return total


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(the inputs, each rank's results) of one spawn of 8 gloo ranks."""
    tmp = tmp_path_factory.mktemp("pfof")
    data = dict(cases=" ".join(CASES), timeout=60.0)
    for name, (_n, _seed, _jit, ll, kinds) in CASES.items():
        data.update({name + "_x": case_points(name), name + "_ll": ll,
                     name + "_box": BOX, name + "_kinds": kinds})
    inp = str(tmp / "inputs.npz")
    np.savez(inp, **data)
    spawn(NPROC, "pfof", inp, str(tmp))
    return data, [dict(np.load(str(tmp / ("rank%d.npz" % r))))
                  for r in range(NPROC)]


def _labels(res, key):
    return np.concatenate([r[key + "_labels"] for r in res])


@pytest.mark.parametrize("name,kind", [("s3", "sharded"), ("s7", "sharded"),
                                       ("s11", "auto")])
def test_labels_match_host_union_find(ranks, name, kind):
    data, res = ranks
    key = "%s_%s" % (name, kind)
    x, ll = data[name + "_x"], float(data[name + "_ll"])
    want = host_fof_labels(x, ll, BOX, periodic=True)
    # clusters straddle the faces: the groups cross ranks
    assert len(np.unique(want)) < len(want) // 4
    for r in res:
        assert key + "_error" not in r, str(r[key + "_error"])
        if kind == "sharded":
            assert int(r[key + "_overflow"]) == 0
        assert int(r[key + "_launches"]) == 0     # the CPU's plain link
        assert 1 <= int(r[key + "_rounds"]) <= (8 if kind == "sharded"
                                                else 16)
    np.testing.assert_array_equal(_labels(res, key), want)


def test_overflow_counted_and_auto_raises(ranks):
    data, res = ranks
    x, ll = data["s5_x"], float(data["s5_ll"])
    cap = 256
    while cap < jpfof.boundary_capacity(jnp.asarray(x), NPROC, BOX, ll):
        cap *= 2
    want = overflow_by_jax_rule(x, ll, cap)
    assert want >= 1
    for r in res:
        assert int(r["s5_sharded_ghost_cap"]) == cap
        assert int(r["s5_sharded_overflow"]) == want
        assert "ghost overflow" in str(r["s5_auto_error"])
        assert "s5_auto_labels" not in r


def test_boundary_capacity_over_the_ring(ranks):
    data, res = ranks
    x, ll = data["s9_x"], float(data["s9_ll"])
    want = jpfof.boundary_capacity(jnp.asarray(x), NPROC, BOX, ll)
    assert 0 < want <= 800
    for r in res:
        assert int(r["s9_capacity_capacity"]) == want


def test_unequal_row_counts_raise_on_every_rank(ranks):
    _data, res = ranks
    for r in res:
        assert "same number of rows" in str(r["s9_unequal_error"])


@pytest.mark.parametrize("name", ["s3", "s9"])
def test_boundary_capacity_global_rows(name):
    """The number-of-ranks form on the global rows, as the JAX package
    takes them."""
    x, ll = case_points(name), CASES[name][3]
    assert pfof.boundary_capacity(torch.from_numpy(x), NPROC, BOX, ll) \
        == jpfof.boundary_capacity(jnp.asarray(x), NPROC, BOX, ll)


def test_local_pass_matches_jax():
    """One local pass (owned rows and ghosts, labels seeded and shuffled,
    padding rows not valid) against the JAX package's at rmax 8, on rows
    with at most 8 in a linking cell (the JAX sweep's bound)."""
    rng = np.random.RandomState(21)
    box, ll = 16.0, 0.5
    centers = rng.uniform(0, box, (150, 3))
    x = np.concatenate([rng.uniform(0, box, (1200, 3)),
                        np.repeat(centers, 5, axis=0)
                        + rng.standard_normal((750, 3)) * 0.2])
    x = (x % box).astype(np.float32)
    m = len(x)
    valid = np.ones(m, bool)
    valid[-60:] = False             # the padding of a ghost buffer
    x[-60:] = x[-61]
    lab = (rng.permutation(m) + 1000).astype(np.int32)
    cells = np.floor(x[valid] / (box / int(box / ll))).astype(np.int64)
    assert np.unique(cells, axis=0, return_counts=True)[1].max() <= 8
    want = np.asarray(jpfof._local_label_pass(
        jnp.asarray(x), jnp.asarray(lab), jnp.asarray(valid), ll, box,
        rmax=8, max_rounds=64))
    got = pfof._local_label_pass(torch.from_numpy(x),
                                 torch.from_numpy(lab.astype(np.int64)),
                                 torch.from_numpy(valid), ll, box).numpy()
    # groups of several rows, the least label of each taken by all
    assert len(np.unique(want[valid])) < valid.sum() - 100
    np.testing.assert_array_equal(got, want)


def test_one_rank_without_a_group():
    """Ring(None): every row a ghost of itself on both sides (the local
    pass over 3N rows), the labels the host union-find's."""
    x = case_points("s3")[:3000]
    lab, overflow = pfof.fof_labels_sharded(torch.from_numpy(x), 0.45, BOX,
                                            Ring())
    assert overflow == 0
    assert pfof.fof_labels_sharded.rows == 3 * len(x)
    assert pfof.fof_labels_sharded.rounds == 2
    np.testing.assert_array_equal(
        lab.numpy(), host_fof_labels(x, 0.45, BOX, periodic=True))
    np.testing.assert_array_equal(
        pfof.fof_labels_sharded_auto(torch.from_numpy(x), 0.45, BOX,
                                     Ring()).numpy(), lab.numpy())
