"""The readout's plain versions (K2 and K4 cic_readout_plain, K6
cic_readout4_plain, periodic and on one rank's extended slab) against
the JAX package on the edge geometries of
fastpm_torch/ops/readout_cases.py: cell, store and stale order, sorted
runs across an x face, rows that wrap in y, the last column in z, the
open slab's last plane and the rows beyond it, with 1, 2 and 3 fields.

The oracles are the JAX Painter with backend="never" and the XLA homed
readout (psolver._readout_homed), and the Pallas from8 / from4 factories
in interpret mode fed by their prepare functions, as
tests/test_pallas_paint.py and tests/test_torch_parallel.py run them.
On the CPU the wrappers take the plain versions, so the wrappers are
what is called. Tolerances: atol 2e-6 + rtol 1e-5 for f32 sums in
another order; the from4 factories at the atol 1e-5 their contract
test uses (test_torch_parallel.py:test_periodic_from4_contract).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fastpm_tpu.mesh import PM as JPM
from fastpm_tpu.painter import Painter as JPainter
from fastpm_tpu.parallel import psolver as jps
from fastpm_tpu.ops import paint_pallas as pp
from fastpm_tpu.ops import readout_pallas as rp

from fastpm_torch.ops import cic
from fastpm_torch.ops import readout_cases as cases

N, BOX, COUNT = 16, 64.0, 3000
NLOC, H, RANK = 4, 1, 1                     # rank 1 of 4
ATOL, RTOL = 2e-6, 1e-5


def _fields(shape, k=3, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(k)]


@pytest.fixture(scope="module")
def periodic():
    """The JAX mesh, and the from8 and from4 readouts jitted with their
    prepare, so each compiles once for the module's (mesh, COUNT)."""
    jpm = JPM(N, BOX)
    prep8 = pp.make_prepare_fn(jpm, C=1024, base_only=True)
    prep4 = pp.make_prepare_fn(jpm, C=1024)
    read8 = rp.make_readout3_from8_fn(jpm, K=128, C=1024, interpret=True,
                                      gather_mode="highest")
    read4 = rp.make_readout3_from4_fn(jpm, K=256, C=1024, interpret=True,
                                      gather_mode="highest")
    return (jpm, jax.jit(lambda pos, a, b, c: read8(prep8(pos), a, b, c)),
            jax.jit(lambda pos, a, b, c: read4(prep4(pos), a, b, c)))


@pytest.fixture(scope="module")
def homed():
    """The slab, its extended shape, and the homed from8 and from4
    readouts jitted with their prepare (the rows beyond the slab at
    relx = nx + 1, as the homed force passes them)."""
    slab, ext = cases.slab_of(N, NLOC, H, RANK)
    shape = (ext[0] - 1, N, N)
    jpm = JPM(N, BOX)

    def make(factory, base_only, K):
        prep = pp.make_prepare_homed_fn(shape, C=1024, base_only=base_only)
        read = factory(shape, K=K, C=1024, interpret=True,
                       gather_mode="highest")

        def run(pos, a, b, c):
            relx, iy, iz, frac = jps._cic_rel(jpm, pos, slab.r0, H)
            relx = jnp.where(relx < shape[0], relx, shape[0] + 1)
            return read(prep(relx, iy, iz, frac), a, b, c)
        return jax.jit(run)
    return (slab, ext, make(rp.make_readout3_from8_homed_fn, True, 256),
            make(rp.make_readout3_from4_homed_fn, False, 256))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=atol)


@pytest.mark.parametrize("kind", cases.PERIODIC)
def test_periodic_readout_edges_match_jax(periodic, kind):
    """K2 / K4 (k = 1, 2, 3) against the JAX Painter and the from8
    factory, K6 against the from4 factory and the Painter's sum."""
    jpm, read8, read4 = periodic
    pos = cases.periodic_case(kind, N, BOX, COUNT)
    fs = _fields(jpm.Nmesh)
    ft = [torch.from_numpy(f) for f in fs]
    x = torch.from_numpy(pos)
    painter = JPainter(jpm, "cic", backend="never")
    ref = np.stack([np.asarray(painter.readout(jnp.asarray(f),
                                               jnp.asarray(pos)))
                    for f in fs], axis=-1)
    for k in (1, 2, 3):
        got = cic.cic_readout(ft[:k], x, jpm.InvCellSize)
        assert got.shape == (COUNT, k) and got.dtype == torch.float32
        _close(got, ref[:, :k])
    _close(cic.cic_readout3(*ft, x, jpm.InvCellSize), ref)
    jfs = [jnp.asarray(f) for f in fs]
    _close(cic.cic_readout(ft, x, jpm.InvCellSize),
           read8(jnp.asarray(pos), *jfs))
    got4 = cic.cic_readout4(*ft, x, jpm.InvCellSize)
    _close(got4, read4(jnp.asarray(pos), *jfs), atol=1e-5)
    _close(got4, ref)


@pytest.mark.parametrize("kind", cases.SLAB + ("sorted", "ywrap", "zlast"))
def test_slab_readout_edges_match_jax(homed, kind):
    """Homed K2 (k = 1, 2, 3) against the XLA homed readout and the from8
    homed factory, K6 on the slab against the from4 homed factory: rows
    beyond the slab read zero."""
    slab, ext, read8, read4 = homed
    if kind in cases.SLAB:
        pos = cases.slab_case(kind, N, BOX, COUNT, slab, ext)
    else:
        pos = cases.periodic_case(kind, N, BOX, COUNT)
    inv = cases.mesh(N, BOX)[1]
    fs = _fields(ext, seed=9)
    ft = [torch.from_numpy(f) for f in fs]
    x = torch.from_numpy(pos)
    jfs = [jnp.asarray(f) for f in fs]
    ref = np.asarray(jps._readout_homed(JPM(N, BOX), NLOC, H, slab.r0,
                                        jnp.asarray(pos), jfs))
    _base, _f, valid = cic.slab_cell(x, ext, inv, slab)
    assert 0 < int(valid.sum()) < COUNT
    for k in (1, 2, 3):
        got = cic.cic_readout_homed(ft[:k], x, inv, slab)
        assert got.shape == (COUNT, k)
        _close(got, ref[:, :k])
        assert not got[~valid].any()
    _close(cic.cic_readout_homed(ft, x, inv, slab),
           read8(jnp.asarray(pos), *jfs))
    got4 = cic.cic_readout4(*ft, x, inv, slab)
    assert not got4[~valid].any()
    _close(got4, read4(jnp.asarray(pos), *jfs), atol=1e-5)
    _close(got4, ref)


def test_slab_lastplane_case_covers_its_planes():
    """The last-plane case holds relx = nx - 2 and rows beyond the slab;
    the x-face case holds sorted runs across two planes; the y and z
    cases sit on the last row and column."""
    slab, ext = cases.slab_of(N, NLOC, H, RANK)
    nmesh, inv = cases.mesh(N, BOX)
    x = torch.from_numpy(cases.slab_case("slab_lastplane", N, BOX, COUNT,
                                         slab, ext))
    base, _f, valid = cic.slab_cell(x, ext, inv, slab)
    assert set(base[valid, 0].tolist()) == {ext[0] - 2}
    assert 0 < int((~valid).sum()) < COUNT
    for kind, axis, want in (("xplane", 0, {N // 2 - 1, N // 2}),
                             ("ywrap", 1, {N - 2, N - 1}),
                             ("zlast", 2, {N - 1})):
        x = torch.from_numpy(cases.periodic_case(kind, N, BOX, COUNT))
        base, _f = cic.cell_frac(x, nmesh, inv)
        assert set(base[:, axis].tolist()) <= want | {0}
        assert want <= set(base[:, axis].tolist())
        key = cic.cell_key(x, nmesh, inv)
        assert bool((key[1:] >= key[:-1]).all())


def test_readout4_returns_n_by_3_and_checks_its_arguments():
    """K6's wrapper returns the (N, 3) sum itself, periodic and on a
    slab, and refuses what the kernel does not take."""
    nmesh, inv = cases.mesh(N, BOX)
    slab, ext = cases.slab_of(N, NLOC, H, RANK)
    x = torch.from_numpy(cases.periodic_case("sorted", N, BOX, 100))
    fs = [torch.from_numpy(f) for f in _fields(nmesh)]
    es = [torch.from_numpy(f) for f in _fields(ext)]
    for got in (cic.cic_readout4(*fs, x, inv),
                cic.cic_readout4(*es, x, inv, slab)):
        assert got.shape == (100, 3) and got.dtype == torch.float32
        assert got.is_contiguous()
    with pytest.raises(ValueError, match="positions"):
        cic.cic_readout4(*fs, x.double(), inv)
    with pytest.raises(ValueError, match="positions"):
        cic.cic_readout4(*fs, x[:, :2], inv)
    with pytest.raises(ValueError, match="float32 of one shape"):
        cic.cic_readout4(fs[0], fs[1], es[2], x, inv)
    with pytest.raises(ValueError, match="float32 of one shape"):
        cic.cic_readout4(fs[0], fs[1], fs[2].double(), x, inv)
    with pytest.raises(ValueError, match="bad slab"):
        cic.cic_readout4(*es, x, inv, cic.Slab(N, N, H))
    with pytest.raises(ValueError, match="unsupported mesh"):
        big = torch.zeros(()).expand(1300, 1300, 1300)
        cic.cic_readout4(big, big, big, x, inv)
    with pytest.raises(ValueError, match="1 to 3 fields"):
        cic.cic_readout(fs + fs[:1], x, inv)
