"""The port's CIC paint (K1) and readout (K2) against the JAX package.

On the CPU the port's wrappers take their plain versions; these are held
against the Pallas from8 kernels in interpret mode (fed a
make_prepare_fn(base_only=True) bundle, as the JAX force feeds them) and
against the JAX scatter/gather Painter (K3 and K4's plain versions are
held against their Pallas kernels in tests/test_torch_ncdm.py, the
homed kernels' and K5 / K6's in tests/test_torch_parallel.py, the
readouts' edge cases in tests/test_torch_readout_edges.py, K3 and K4
given a cell order in tests/test_torch_paint_order.py). The CUDA cases
hold K1-K6 against their plain versions on the card (the readouts bit
for bit, the paints K1, homed K1, K3 and K5 within the paints'
tolerance, on the edge cases of fastpm_torch/ops/readout_cases.py) and
skip without one; they need no
JAX, so on a GPU machine without it the file runs as `python -m pytest
--noconftest tests/test_torch_cic.py -m cuda`.
"""

import numpy as np
import pytest
import torch

from fastpm_torch.ops import cic

NC, BOX, N = 32, 64.0, 5000


def _positions(kind):
    rng = np.random.default_rng({"uniform": 1, "clustered": 2,
                                 "boundary": 3}[kind])
    if kind == "uniform":
        pos = rng.uniform(0, BOX, (N, 3))
    elif kind == "clustered":
        # most particles in a couple of cells: many per cell
        pos = np.concatenate([10 + 0.4 * rng.random((4000, 3)),
                              rng.uniform(0, BOX, (N - 4000, 3))])
    else:
        # box edges, the origin, exact cell boundaries, and positions
        # equal to the box size (a float32 wrap can produce them)
        g = np.stack(np.meshgrid(*[np.arange(4) * 16.0] * 3,
                                 indexing="ij"), axis=-1).reshape(-1, 3)
        pos = np.concatenate([
            g, np.full((4, 3), BOX - 1e-3), np.full((4, 3), 0.0005),
            np.full((4, 3), BOX), [[BOX, 0.0, 31.0], [0.0, BOX, BOX]],
            rng.uniform(0, BOX, (N - len(g) - 14, 3))])
    return pos.astype(np.float32)


@pytest.fixture(scope="module")
def pallas_from8():
    """The from8 paint and readout, jitted with their prepare so each
    compiles once for the module's single (mesh, N) shape."""
    import jax
    from fastpm_tpu.mesh import PM as JPM
    from fastpm_tpu.ops.paint_pallas import (make_prepare_fn,
                                             make_paint_from8_fn)
    from fastpm_tpu.ops.readout_pallas import make_readout3_from8_fn
    jpm = JPM(NC, BOX)
    prepare = make_prepare_fn(jpm, C=1024, base_only=True)
    paint = make_paint_from8_fn(jpm, K=128, C=1024, interpret=True)
    # gather_mode="highest": f32 dots, exact to f32 rounding
    read = make_readout3_from8_fn(jpm, K=128, C=1024, interpret=True,
                                  gather_mode="highest")
    return (jpm, jax.jit(lambda pos: paint(prepare(pos))),
            jax.jit(lambda pos, a, b, c: read(prepare(pos), a, b, c)))


@pytest.mark.parametrize("kind", ["uniform", "clustered", "boundary"])
def test_paint_plain_matches_jax(pallas_from8, kind):
    import jax.numpy as jnp
    from fastpm_tpu.painter import Painter as JPainter
    jpm, paint8, _ = pallas_from8
    pos = _positions(kind)
    got = cic.cic_paint(torch.from_numpy(pos), jpm.Nmesh,
                        jpm.InvCellSize).numpy()
    painter = np.asarray(JPainter(jpm, "cic", backend="never").paint(
        jnp.asarray(pos)))
    # plain scatter vs scatter: f32 summation order only
    np.testing.assert_allclose(got, painter, rtol=1e-5, atol=2e-6)
    # the Pallas kernel deposits bf16 hi+lo split weights
    # (paint_pallas.py:1153-1160), good to ~2^-17 of a weight, so it
    # is held at the atol its own test uses (test_pallas_paint.py:370)
    np.testing.assert_allclose(got, np.asarray(paint8(jnp.asarray(pos))),
                               rtol=1e-5, atol=2e-5)
    assert got.sum() == pytest.approx(N, rel=1e-6)


@pytest.mark.parametrize("kind", ["uniform", "clustered", "boundary"])
def test_readout_plain_matches_jax(pallas_from8, kind):
    import jax.numpy as jnp
    from fastpm_tpu.painter import Painter as JPainter
    jpm, _, read8 = pallas_from8
    pos = _positions(kind)
    rng = np.random.default_rng(7)
    cs = [rng.standard_normal((NC,) * 3).astype(np.float32)
          for _ in range(3)]
    got = cic.cic_readout([torch.from_numpy(c) for c in cs],
                          torch.from_numpy(pos), jpm.InvCellSize).numpy()
    want = np.asarray(read8(jnp.asarray(pos), *map(jnp.asarray, cs)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-6)
    painter = JPainter(jpm, "cic", backend="never")
    want = np.stack([np.asarray(painter.readout(jnp.asarray(c),
                                                jnp.asarray(pos)))
                     for c in cs], axis=-1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-6)


def test_cell_sort_orders_by_padded_key():
    """sort_by_cell orders particles as the JAX padded cell key does
    (base_cell_frac), including the wrap of positions at the box size."""
    import jax.numpy as jnp
    from fastpm_tpu.mesh import PM as JPM
    from fastpm_tpu.ops.paint_pallas import base_cell_frac
    jpm = JPM(NC, BOX)
    pos = _positions("boundary")
    perm = cic.sort_by_cell(torch.from_numpy(pos), jpm.Nmesh,
                            jpm.InvCellSize).numpy()
    cell, _ = base_cell_frac(jnp.asarray(pos),
                             np.asarray(jpm.InvCellSize, np.float32),
                             NC, NC, NC, NC + 1, NC + 1)
    cell = np.asarray(cell)
    np.testing.assert_array_equal(perm, np.argsort(cell, kind="stable"))


@pytest.mark.cuda
def test_kernels_match_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    nmesh = (NC,) * 3
    inv = (NC / BOX,) * 3
    for kind in ("uniform", "clustered", "boundary"):
        # K3 and K4 take particles in store order, K1 and K2 sorted
        unsorted = torch.from_numpy(_positions(kind)).to(dev)
        unsorted = unsorted[torch.randperm(N, device=dev)]
        x = unsorted[cic.sort_by_cell(unsorted, nmesh, inv)]
        # f32 atomics in run-dependent order vs index_add_
        torch.testing.assert_close(cic.cic_paint(x, nmesh, inv, 2.0),
                                   cic.cic_paint_plain(x, nmesh, inv, 2.0),
                                   rtol=1e-5, atol=2e-6)
        masses = torch.rand(N, device=dev) + 0.5
        got = torch.ones(nmesh, device=dev)
        want = got.clone()
        for mass in (2.0, masses):
            cic.cic_paint_into(got, unsorted, inv, mass)
            cic.cic_paint_into_plain(want, unsorted, inv, mass)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-6)
        fields = [torch.randn(nmesh, device=dev) for _ in range(3)]
        for k in (1, 3):
            torch.testing.assert_close(
                cic.cic_readout(fields[:k], x, inv),
                cic.cic_readout_plain(fields[:k], x, inv),
                rtol=1e-5, atol=2e-6)
        torch.testing.assert_close(
            cic.cic_readout3(*fields, unsorted, inv),
            cic.cic_readout_plain(fields, unsorted, inv),
            rtol=1e-5, atol=2e-6)
        # the homed kernels on rank 1 of 4 with H = 2 (most particles
        # are beyond the slab and counted), and K5 periodic
        slab = cic.Slab(NC, NC // 4, 2)
        ext = (NC // 4 + 5, NC, NC)
        efields = [torch.randn(ext, device=dev) for _ in range(3)]
        for mass in (2.0, masses):
            for shape, s in ((ext, slab), (nmesh, None)):
                got, want = (torch.zeros(shape, device=dev)
                             for _ in range(2))
                if s is not None:
                    bad = cic.cic_paint_homed(got, x, inv, s, mass)
                    assert int(bad) == int(cic.cic_paint_homed_plain(
                        want, x, inv, s, mass)) > 0
                    torch.testing.assert_close(got, want, rtol=1e-5,
                                               atol=2e-6)
                    got.zero_()
                    want.zero_()
                bad = cic.cic_paint4(got, x, inv, mass, s)
                assert int(bad) == int(cic.cic_paint4_plain(want, x, inv,
                                                            mass, s))
                torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-6)
        torch.testing.assert_close(
            cic.cic_readout_homed(efields, x, inv, slab),
            cic.cic_readout_plain(efields, x, inv, slab),
            rtol=1e-5, atol=2e-6)
        for fs, s in ((efields, slab), (fields, None)):
            torch.testing.assert_close(
                cic.cic_readout4(*fs, unsorted, inv, s),
                cic.cic_readout4_plain(*fs, unsorted, inv, s),
                rtol=1e-5, atol=2e-6)


@pytest.mark.cuda
def test_readout_edges_on_cuda():
    """K2 and homed K2 (k = 1, 2, 3), K4 and K6 equal to their plain
    versions bit for bit on the edge cases of
    fastpm_torch/ops/readout_cases.py at a 64^3 mesh (the kernel rounds
    as they do, in their order), and so do a sorted array and the same
    rows shuffled; unaligned positions (the kernel's scalar copies)
    change nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fastpm_torch.ops import readout_cases as cases
    dev = torch.device("cuda")
    n, box = 64, 128.0
    count = n ** 3 // 2 + 99          # a ragged last block
    nmesh, inv = cases.mesh(n, box)
    slab, ext = cases.slab_of(n, 16, 2, 1)
    fields = [torch.randn(nmesh, device=dev) for _ in range(3)]
    efields = [torch.randn(ext, device=dev) for _ in range(3)]
    runs = [(kind, cases.periodic_case(kind, n, box, count), None)
            for kind in cases.PERIODIC]
    runs += [(kind, cases.slab_case(kind, n, box, count, slab, ext), slab)
             for kind in cases.SLAB]
    for kind, pos, s in runs:
        x = torch.from_numpy(pos).to(dev)
        fs = fields if s is None else efields

        def k2(fs, x):
            return (cic.cic_readout(fs, x, inv) if s is None
                    else cic.cic_readout_homed(fs, x, inv, s))
        plain = cic.cic_readout_plain(fs, x, inv, s)
        for k in (1, 2, 3):
            assert torch.equal(k2(fs[:k], x), plain[:, :k]), (kind, k)
        if s is None:
            assert torch.equal(cic.cic_readout3(*fs, x, inv), plain)
        assert torch.equal(cic.cic_readout4(*fs, x, inv, s),
                           cic.cic_readout4_plain(*fs, x, inv, s)), kind
        perm = torch.randperm(count, device=dev)
        shuffled = torch.empty_like(plain)
        shuffled[perm] = k2(fs, x[perm])
        assert torch.equal(shuffled, plain), kind
    x = torch.from_numpy(cases.periodic_case("sorted", n, box, count)).to(dev)
    xs = torch.cat([x[:1], x]).contiguous()[1:]
    assert xs.data_ptr() % 16 != 0
    assert torch.equal(cic.cic_readout(fields, xs, inv),
                       cic.cic_readout(fields, x, inv))


@pytest.mark.cuda
def test_paint_edges_on_cuda():
    """K1, homed K1, K3 (with and without a cell order) and K3's cell
    order (csrc/cic_bin.cu, equal to its plain version) against their
    plain versions on the edge cases of fastpm_torch/ops/readout_cases.py
    at a 64^3 mesh: in cell order (the tile path), in random order (the
    direct path), across the x face (a block's rows straddle two planes
    and take the whole y range), wrapping in y and z, drifted from their
    sort, and on one rank's extended slab with rows beyond it; the homed
    overflow count equals the plain version's, and the mass is
    conserved."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fastpm_torch.ops import readout_cases as cases
    dev = torch.device("cuda")
    n, box = 64, 128.0
    count = n ** 3 // 2 + 99          # a ragged last block
    nmesh, inv = cases.mesh(n, box)
    slab, ext = cases.slab_of(n, 16, 2, 1)
    masses = torch.rand(count, device=dev) + 0.5
    for kind in cases.PERIODIC:
        x = torch.from_numpy(cases.periodic_case(kind, n, box, count)).to(dev)
        got = cic.cic_paint(x, nmesh, inv, 2.0)
        torch.testing.assert_close(got, cic.cic_paint_plain(x, nmesh, inv,
                                                            2.0),
                                   rtol=1e-5, atol=2e-6)
        assert float(got.double().sum()) == pytest.approx(2.0 * count,
                                                          rel=1e-6), kind
        # K3's cell order, the stable radix sort by line, equal to its
        # plain version (the stable sort) bit for bit
        perm = torch.randperm(count, device=dev)
        for xx in (x, x[perm]):
            assert torch.equal(cic.cell_order(xx, nmesh, inv).index,
                               cic.cell_order_plain(xx, nmesh, inv).index), kind
        # K3 on the rows, shuffled (it orders them itself), and shuffled
        # with their cell order given
        for mass in (2.0, masses):
            want = cic.cic_paint_into_plain(torch.ones(nmesh, device=dev),
                                            x, inv, mass)
            mp = mass[perm] if torch.is_tensor(mass) else mass
            for xx, m, o in ((x, mass, None), (x[perm], mp, None),
                             (x[perm], mp, cic.cell_order(x[perm], nmesh,
                                                          inv))):
                got = cic.cic_paint_into(torch.ones(nmesh, device=dev), xx,
                                         inv, m, o)
                torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-6)
    for kind in cases.SLAB:
        x = torch.from_numpy(cases.slab_case(kind, n, box, count, slab,
                                             ext)).to(dev)
        for mass in (1.5, masses):
            got, want = (torch.zeros(ext, device=dev) for _ in range(2))
            bad = cic.cic_paint_homed(got, x, inv, slab, mass)
            bad_plain = cic.cic_paint_homed_plain(want, x, inv, slab, mass)
            assert int(bad) == int(bad_plain) > 0, kind
            torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-6)
            _, _, valid = cic.slab_cell(x, ext, inv, slab)
            total = (float(mass[valid].double().sum())
                     if torch.is_tensor(mass) else mass * int(valid.sum()))
            assert float(got.double().sum()) == pytest.approx(total,
                                                              rel=1e-6)


@pytest.mark.cuda
def test_cell_order_on_cuda_matches_plain():
    """The radix sort (csrc/cic_bin.cu) equal to its plain version bit
    for bit: n = 0, 1 and rows past a tile's edge; rows on a few lines
    (long runs of ties) in store order and shuffled; meshes of one, two
    and three digit passes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    for n, box in ((4, 8.0), (32, 64.0), (512, 768.0), (1290, 1290.0)):
        nmesh, inv = (n,) * 3, (n / box,) * 3
        for count in (0, 1, 2, 4095, 4096, 4097, 70001):
            x = torch.rand((count, 3), generator=g, device=dev) * box
            ties = x.clone()
            ties[:, :2] = torch.floor(ties[:, :2] * (3 / box)) * (box / 3)
            for xx in (x, ties, ties[torch.randperm(count, generator=g,
                                                    device=dev)]):
                before = cic.cell_order.launches
                got = cic.cell_order(xx, nmesh, inv).index
                assert cic.cell_order.launches == before + 1
                assert torch.equal(
                    got, cic.cell_order_plain(xx, nmesh, inv).index), (n,
                                                                       count)


@pytest.mark.cuda
def test_paint4_edges_on_cuda():
    """K5 (periodic and homed, a scalar mass and a mass column) against
    its plain version on the edge cases of
    fastpm_torch/ops/readout_cases.py at a 64^3 mesh: uniform and
    clustered rows in cell order, random order, drifted, across the x
    face and the box faces, wrapping in y and z; on rank 1 of 4's
    extended slab with rows beyond it, counted once; the mass conserved
    (the deposited rows' mass)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fastpm_torch.ops import readout_cases as cases
    dev = torch.device("cuda")
    n, box = 64, 128.0
    count = n ** 3 // 2 + 99          # a ragged last block
    nmesh, inv = cases.mesh(n, box)
    slab, ext = cases.slab_of(n, 16, 2, 1)
    masses = torch.rand(count, device=dev) + 0.5
    runs = [(kind, cases.periodic_case(kind, n, box, count), None, nmesh)
            for kind in cases.PERIODIC]
    runs += [(kind, cases.slab_case(kind, n, box, count, slab, ext), slab,
              ext) for kind in cases.SLAB]
    for kind, pos, s, shape in runs:
        x = torch.from_numpy(pos).to(dev)
        valid = (torch.ones(count, dtype=torch.bool, device=dev)
                 if s is None else cic.slab_cell(x, shape, inv, s)[2])
        for mass in (1.5, masses):
            got, want = (torch.zeros(shape, device=dev) for _ in range(2))
            bad = cic.cic_paint4(got, x, inv, mass, s)
            bad_plain = cic.cic_paint4_plain(want, x, inv, mass, s)
            assert int(bad) == int(bad_plain) == int((~valid).sum()), kind
            if s is not None:
                assert int(bad) > 0, kind
            torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-6)
            total = (float(mass[valid].double().sum())
                     if torch.is_tensor(mass) else mass * int(valid.sum()))
            assert float(got.double().sum()) == pytest.approx(
                total, rel=1e-6), kind


@pytest.mark.cuda
def test_open_y_kernels_on_cuda():
    """The open-y mode of homed K1, K2, K5 and K6 (a Pencil: the pencil
    force's extended pencil) against their plain versions at a 64^3
    mesh: rank (1, 0) and rank (0, 1) of a 2 x 2 grid with Hx = Hy = 4,
    rows inside the pencil, in its halo bands and corners and beyond it
    (counted exactly), in cell order and shuffled; a scalar mass and a
    mass column; the readouts with 1 and 3 fields; the launches counted
    under launches_open_y."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    n, box, H, count = 64, 128.0, 4, 200003
    inv = (n / box,) * 3
    g = torch.Generator(device=dev).manual_seed(21)
    cell = box / n
    for r0x, r0y in ((n // 2, 0), (0, n // 2)):
        pencil = cic.Pencil(n, r0x, H, n, r0y, H)
        ext = (n // 2 + 2 * H + 1, n // 2 + 2 * H + 1, n)
        x = torch.rand((count, 3), generator=g, device=dev) * box
        for d, r0 in ((0, r0x), (1, r0y)):
            # the pencil, its halos and 3 planes beyond on each side
            span = n // 2 + 2 * H + 6
            x[:, d] = ((r0 - H - 3 + span * torch.rand(
                count, generator=g, device=dev)) * cell) % box
        base, _f, valid = cic.slab_cell(x, ext, inv, pencil)
        assert 0 < int((~valid).sum()) < count
        key = (base[:, 0] * ext[1] + base[:, 1]) * ext[2] + base[:, 2]
        key = torch.where(valid, key, ext[0] * ext[1] * ext[2])
        xs = x[torch.sort(key, stable=True).indices]
        xr = x[torch.randperm(count, generator=g, device=dev)]
        masses = torch.rand(count, generator=g, device=dev) + 0.5
        fields = [torch.randn(ext, generator=g, device=dev)
                  for _ in range(3)]
        before = {f.__name__: f.launches_open_y for f in (
            cic.cic_paint_homed, cic.cic_paint4, cic.cic_readout_homed,
            cic.cic_readout4)}
        for xx in (xs, xr):
            for mass in (1.5, masses):
                for fn, plain in (
                        (lambda c, m: cic.cic_paint_homed(c, xx, inv,
                                                          pencil, m),
                         lambda c, m: cic.cic_paint_homed_plain(
                             c, xx, inv, pencil, m)),
                        (lambda c, m: cic.cic_paint4(c, xx, inv, m, pencil),
                         lambda c, m: cic.cic_paint4_plain(c, xx, inv, m,
                                                           pencil))):
                    got, want = (torch.zeros(ext, device=dev)
                                 for _ in range(2))
                    bad, bad_plain = fn(got, mass), plain(want, mass)
                    assert int(bad) == int(bad_plain) == int(
                        (~valid).sum())
                    torch.testing.assert_close(got, want, rtol=1e-5,
                                               atol=2e-6)
            for k in (1, 3):
                torch.testing.assert_close(
                    cic.cic_readout_homed(fields[:k], xx, inv, pencil),
                    cic.cic_readout_plain(fields[:k], xx, inv, pencil),
                    rtol=1e-5, atol=2e-6)
            torch.testing.assert_close(
                cic.cic_readout4(*fields, xx, inv, pencil),
                cic.cic_readout4_plain(*fields, xx, inv, pencil),
                rtol=1e-5, atol=2e-6)
        after = {f.__name__: f.launches_open_y for f in (
            cic.cic_paint_homed, cic.cic_paint4, cic.cic_readout_homed,
            cic.cic_readout4)}
        assert {k: after[k] - before[k] for k in after} == dict(
            cic_paint_homed=4, cic_paint4=4, cic_readout_homed=4,
            cic_readout4=2)
