"""K3 and K4 given a cell order, on the CPU: the shared order the
multi-species force computes once per species and step.

cic_paint_into with an order (a CellOrder, or a plain permutation that
is checked first) deposits the rows in it (on the CPU: gathers the
positions and the mass column into it); cic_readout3 with one reads the
rows in it and scatters the values back. On the CPU the plain versions
serve, so these tests run the gathers and the scatter back, and
cell_order's plain version (the card's counting sort by line is held
against it in tests/test_torch_cic.py): the deposit agrees with the
unsorted plain deposit within the paints' atol 2e-6 + rtol 1e-5 (f32
sums in another order) and conserves the mass, and the readout equals
the unordered readout bit for bit (a row's value does not depend on the
order). The pair is also held against the JAX package's factories that
share one prepared sort between paint and readout (make_paint_from_fn,
make_readout3_from_fn, in interpret mode). The geometries are
fastpm_torch/ops/readout_cases.py's, at a 32^3 mesh.
"""

import numpy as np
import pytest
import torch

from fastpm_torch.ops import cic
from fastpm_torch.ops import readout_cases as cases

N, BOX = 32, 64.0
COUNT = 6000
PAINT_TOL = dict(rtol=1e-5, atol=2e-6)
# uniform in store order, clustered, the box boundary, the x face
KINDS = ["random", "clustered", "boundary", "xplane"]


def _inputs(kind):
    """Positions in store order (the case's rows shuffled), a mass
    column, three fields."""
    rng = np.random.default_rng(KINDS.index(kind))
    pos = cases.periodic_case(kind, N, BOX, COUNT)
    pos = pos[rng.permutation(COUNT)]
    mass = rng.uniform(0.5, 1.5, COUNT).astype(np.float32)
    fields = [rng.standard_normal((N,) * 3).astype(np.float32)
              for _ in range(3)]
    return (torch.from_numpy(pos), torch.from_numpy(mass),
            [torch.from_numpy(f) for f in fields])


@pytest.mark.parametrize("kind", KINDS)
def test_paint_into_with_order_matches_plain(kind):
    x, mass, _ = _inputs(kind)
    nmesh, inv = cases.mesh(N, BOX)
    made = cic.cell_order(x, nmesh, inv)
    perm = made.index.clone()
    for m in (1.25, mass):
        want = cic.cic_paint_into_plain(torch.zeros(nmesh), x, inv, m)
        total = float(m.double().sum()) if torch.is_tensor(m) else m * COUNT
        for order in (None, made, perm):
            got = cic.cic_paint_into(torch.zeros(nmesh), x, inv, m, order)
            torch.testing.assert_close(got, want, **PAINT_TOL)
            assert float(got.double().sum()) == pytest.approx(total,
                                                              rel=1e-6)
    # species add into one canvas, each in its own order
    canvas = torch.ones(nmesh)
    cic.cic_paint_into(canvas, x, inv, 1.25, made)
    cic.cic_paint_into(canvas, x[:1000], inv, mass[:1000],
                       cic.cell_order(x[:1000], nmesh, inv))
    want = cic.cic_paint_into_plain(torch.ones(nmesh), x, inv, 1.25)
    cic.cic_paint_into_plain(want, x[:1000], inv, mass[:1000])
    torch.testing.assert_close(canvas, want, **PAINT_TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_readout3_with_order_keeps_rows(kind):
    x, _, fields = _inputs(kind)
    nmesh, inv = cases.mesh(N, BOX)
    want = cic.cic_readout3(*fields, x, inv)
    made = cic.cell_order(x, nmesh, inv)
    for order in (made, made.index.clone()):
        assert torch.equal(cic.cic_readout3(*fields, x, inv, order), want)
    # the order puts the rows in line order (base x plane, then y row)
    line = cic.cell_key(x[made.index], nmesh, inv) // N
    assert bool((line[1:] >= line[:-1]).all())


@pytest.mark.parametrize("kind", KINDS)
def test_cell_order_plain_groups_by_line(kind):
    """cell_order's plain version is the stable sort by the line (base
    plane, base row) of each row's cell: a permutation, lines ascending,
    rows of one line in their given order (the card's counting sort
    leaves that last order free)."""
    x, _, _ = _inputs(kind)
    nmesh, inv = cases.mesh(N, BOX)
    order = cic.cell_order(x, nmesh, inv)
    assert isinstance(order, cic.CellOrder)
    idx = order.index
    assert idx.dtype == torch.int64
    assert torch.equal(torch.sort(idx).values, torch.arange(COUNT))
    line = cic.cell_key(x, nmesh, inv).long() // N
    np.testing.assert_array_equal(
        idx.numpy(), np.lexsort((np.arange(COUNT), line.numpy())))


def test_bad_order_raises():
    x, mass, fields = _inputs("random")
    nmesh, inv = cases.mesh(N, BOX)
    perm = cic.sort_by_cell(x, nmesh, inv)
    dup = perm.clone()
    dup[1] = dup[0]
    bad = [perm[:-1], cic.CellOrder(perm[:-1]), dup,
           torch.cat([perm[1:], torch.tensor([COUNT])]), perm.int(),
           perm.float()]
    for order in bad:
        with pytest.raises(ValueError, match="order"):
            cic.cic_paint_into(torch.zeros(nmesh), x, inv, mass, order)
        with pytest.raises(ValueError, match="order"):
            cic.cic_readout3(*fields, x, inv, order)


@pytest.fixture(scope="module")
def jax_prepared_pair():
    """make_prepare_fn + make_paint_from_fn + make_readout3_from_fn, the
    JAX package's paint and readout sharing one prepared sort, in
    interpret mode on a 16^3 mesh."""
    import jax
    from fastpm_tpu.mesh import PM as JPM
    from fastpm_tpu.ops.paint_pallas import (make_prepare_fn,
                                             make_paint_from_fn)
    from fastpm_tpu.ops.readout_pallas import make_readout3_from_fn
    jpm = JPM(16, 32.0)
    prepare = make_prepare_fn(jpm, C=1024, pad_to=1024)
    paint = make_paint_from_fn(jpm, K=256, C=1024, interpret=True)
    read = make_readout3_from_fn(jpm, K=256, C=1024, interpret=True)

    def run(pos, mass, a, b, c):
        prepared = prepare(pos)
        return paint(prepared, mass), read(prepared, a, b, c)
    return jpm, jax.jit(run)


@pytest.mark.parametrize("kind", ["random", "clustered", "boundary"])
def test_shared_order_matches_jax_prepared(jax_prepared_pair, kind):
    """One CellOrder through K3 and K4 against one prepared sort through
    the JAX paint_from / readout3_from pair: the canvas within the
    paints' tolerance, the rows in the caller's order."""
    import jax.numpy as jnp
    jpm, run = jax_prepared_pair
    rng = np.random.default_rng(21)
    pos = cases.periodic_case(kind, 16, 32.0, 3000)
    pos = pos[rng.permutation(len(pos))]
    fields = [rng.standard_normal((16,) * 3).astype(np.float32)
              for _ in range(3)]
    jcanvas, jvals = run(jnp.asarray(pos), 1.5, *map(jnp.asarray, fields))
    x = torch.from_numpy(pos)
    order = cic.cell_order(x, jpm.Nmesh, jpm.InvCellSize)
    canvas = cic.cic_paint_into(torch.zeros((16,) * 3), x, jpm.InvCellSize,
                                1.5, order)
    np.testing.assert_allclose(canvas.numpy(), np.asarray(jcanvas),
                               **PAINT_TOL)
    vals = cic.cic_readout3(*map(torch.from_numpy, fields), x,
                            jpm.InvCellSize, order)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals),
                               **PAINT_TOL)
