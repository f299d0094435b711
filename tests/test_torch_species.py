"""The port's Solver with the baryon species and with order-preserving
stepping (SolverConfig.order_free=False), against the JAX Solver on the
CPU, both started from one JAX IC delta_k (fastpm_torch.convert):

- order_free=False, fastpm and pm modes, 16^3 on a 32^3 force mesh, 3
  steps: the rows stay in place (id == arange at the end in both), and
  x and v agree row by row, with no sort, at test_torch_solver.py's
  bounds (1e-4 of a cell, 1e-4 of v's rms); every force took the
  multi-species body, stale_every = 3 and rehome = True ignored;
- the baryon case of tests/test_sharded_solver.py:47-91 on one device
  (CDM 16^3 plus an 8^3 baryon lattice with a mass column, gaussian
  softening, the potential and the tidal tensor), by id per species at
  that test's bounds (x atol 2e-3; potential and tidal rtol 2e-3, atol
  1e-5);
- CDM + baryon + ncdm, the baryons shifted half a cell and set up by
  setup_lpt(species=BARYON) (M0 the caller's), the ncdm a coarse
  lattice with a mass column and velocities of its own, by id per
  species at the same bounds;
- a snapshot with the baryon dataset 0/ (ID, Position, Mass) and the
  header's MassTable and TotNumPart, written by each package's writer
  from the same stores and read through both packages' readers;
- an unknown species name raises ValueError.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from fastpm_tpu.powerspectrum import FuncK as JFuncK
from fastpm_tpu.cosmology import Cosmology as JCosmology
from fastpm_tpu import ic as jic
from fastpm_tpu.solver import Solver as JSolver, SolverConfig as JConfig
from fastpm_tpu.store import lattice_store as jlattice_store, Store as JStore

from fastpm_torch.solver import Solver, SolverConfig, BARYON, CDM, NCDM
from fastpm_torch.cosmology import Cosmology
from fastpm_torch.convert import field_from_numpy, store_from_numpy
from fastpm_torch.store import lattice_store

POWERSPEC = os.path.join(os.path.dirname(__file__), "fixtures",
                         "powerspec.txt")
COSMO = dict(h=0.6774, Omega_m=0.307494, T_cmb=0.0, growth_mode="lcdm")


def _dk(js, seed):
    dk, _ = jic.linear_field(js.lptpm, JCosmology(**COSMO),
                             JFuncK.from_file(POWERSPEC), seed=seed, aout=1.0)
    return dk


@pytest.mark.parametrize("mode", ["fastpm", "pm"])
def test_order_preserving_matches_jax(mode):
    nc, box = 16, 64.0
    kw = dict(nc=nc, boxsize=box, time_step=[0.1, 0.4, 0.7, 1.0],
              force_mode=mode, pm_nc_factor=2)
    js = JSolver(JConfig(order_free=False, stale_every=3, need_rand=False,
                         **kw), JCosmology(**COSMO))
    dk = _dk(js, 100)
    js.setup_lpt(dk, 0.1)
    js.evolve()
    s = Solver(SolverConfig(order_free=False, stale_every=3, rehome=True,
                            check_values=True, **kw), Cosmology(**COSMO),
               device="cpu")
    s.setup_lpt(field_from_numpy(np.asarray(dk), "cpu"), 0.1)
    s.evolve()

    jp, p = js.species["cdm"], s.species["cdm"]
    # in place: no sort on either side
    np.testing.assert_array_equal(np.asarray(jp.id), np.arange(nc ** 3))
    np.testing.assert_array_equal(p.id.numpy(), np.arange(nc ** 3))
    dx = p.x.numpy() - np.asarray(jp.x)
    dx -= np.round(dx / box) * box
    assert np.abs(dx).max() < 1e-4 * box / nc
    jv = np.asarray(jp.v)
    assert np.abs(p.v.numpy() - jv).max() < 1e-4 * jv.std()
    assert dict(s.force_paths) == {"multi": 4}
    assert s._stale_since == {}


def _ncdm_columns(box, n=4, seed=5):
    """A 4^3 ncdm lattice staggered by a quarter of its spacing, with a
    mass column and small velocities of its own: (x, v, id, mass)."""
    rng = np.random.RandomState(seed)
    q = (np.indices((n,) * 3).reshape(3, -1).T + 0.25) * (box / n)
    v = rng.normal(scale=0.02, size=q.shape)
    mass = 0.05 * (1 + 0.1 * rng.uniform(size=len(q)))
    return (q.astype(np.float32), v.astype(np.float32),
            np.arange(len(q), dtype=np.int64), mass.astype(np.float32))


def _run_species(case):
    """Both packages' Solvers for `case` ("baryon": tests/
    test_sharded_solver.py:47-91 on one device; "three": CDM, baryons
    set up by 2LPT and ncdm), evolved; returns (JAX solver, port
    solver)."""
    nc, box = 16, 64.0
    kw = dict(nc=nc, boxsize=box, time_step=[0.3, 0.6, 1.0],
              force_mode="fastpm", pm_nc_factor=1, softening_type="gaussian",
              compute_potential=True, compute_tidal=True)
    js = JSolver(JConfig(need_rand=False, **kw), JCosmology(**COSMO))
    s = Solver(SolverConfig(**kw), Cosmology(**COSMO), device="cpu")
    nb = 8
    shift = 0.0 if case == "baryon" else 0.5 * box / nb
    M0 = 0.3 if case == "baryon" else 0.05
    jb = jlattice_store(js.basepm, Nc=nb, shift=shift,
                        columns=("v", "acc", "id"), name="baryon")
    b = lattice_store(s.basepm, Nc=nb, shift=shift,
                      columns=("v", "acc", "id", "potential", "tidal"),
                      name="baryon")
    n = nb ** 3
    jb = jb.replace(M0=M0, mass=jnp.full((n,), M0, jnp.float32),
                    potential=jnp.zeros((n,), jnp.float32),
                    tidal=jnp.zeros((n, 6), jnp.float32), a_x=0.3, a_v=0.3)
    b = b.replace(M0=M0, mass=torch.full((n,), M0), a_x=0.3, a_v=0.3)
    js.add_species("baryon", jb)
    s.add_species(BARYON, b)
    dk = _dk(js, 7)
    js.setup_lpt(dk, 0.3)
    s.setup_lpt(field_from_numpy(np.asarray(dk), "cpu"), 0.3)
    if case == "three":
        js.setup_lpt(dk, 0.3, species="baryon")
        s.setup_lpt(field_from_numpy(np.asarray(dk), "cpu"), 0.3,
                    species=BARYON)
        x, v, ids, mass = _ncdm_columns(box)
        js.add_species("ncdm", JStore(
            x=jnp.asarray(x), v=jnp.asarray(v), acc=jnp.zeros_like(x),
            id=jnp.asarray(ids), mass=jnp.asarray(mass), a_x=0.3, a_v=0.3,
            M0=0.0, name="ncdm"))
        s.add_species(NCDM, store_from_numpy(
            x, v, ids, 0.3, 0.3, mass=mass, M0=0.0, name="ncdm").replace(
                acc=torch.zeros(x.shape)))
    js.evolve()
    s.evolve()
    return js, s


def _by_id(p, cols):
    ids = np.asarray(p.id)
    o = np.argsort(ids, kind="stable")
    return ids[o], [np.asarray(getattr(p, c))[o] for c in cols]


@pytest.mark.parametrize("case", ["baryon", "three"])
def test_species_match_jax(case):
    js, s = _run_species(case)
    names = ("baryon", "cdm") + (("ncdm",) if case == "three" else ())
    assert tuple(s.iter_species()) == names
    assert dict(s.force_paths) == {"multi": 3}
    # the caller's M0: only CDM takes Omega_cdm
    assert s.species[BARYON].M0 == js.species["baryon"].M0
    for name in names:
        a, b = js.species[name], s.species[name]
        cols = ["x", "v"] + (["potential", "tidal"]
                             if b.potential is not None else [])
        ja, want = _by_id(a, cols)
        jb, got = _by_id(b, cols)
        np.testing.assert_array_equal(jb, ja)
        for c, g, w in zip(cols, got, want):
            if c == "x":
                d = g - w
                d -= np.round(d / 64.0) * 64.0
                np.testing.assert_allclose(d, 0, atol=2e-3,
                                           err_msg=name + " x")
            elif c == "v":
                np.testing.assert_allclose(g, w, rtol=0,
                                           atol=2e-4 * w.std() + 1e-7,
                                           err_msg=name + " v")
            else:
                assert np.abs(w).max() > 0
                np.testing.assert_allclose(g, w, rtol=2e-3, atol=1e-5,
                                           err_msg=name + " " + c)
    if case == "three":
        assert s.global_count(NCDM) == 64
        # the nonzero columns: the ncdm moved off its lattice
        assert not np.allclose(s.species[NCDM].x.numpy(),
                               _ncdm_columns(64.0)[0])


def test_baryon_snapshot_matches_jax(tmp_path):
    """One baryon and one CDM store written by each package's writer;
    both files read through both readers: 0/ID, 0/Position, 0/Mass and
    1/ equal, MassTable and TotNumPart equal and the baryon's in slot
    0."""
    from fastpm_tpu.io.snapshots import (write_snapshot as jwrite,
                                         read_species as jread,
                                         read_snapshot_header as jhead)
    from fastpm_torch.io.snapshots import (write_snapshot, read_species,
                                           read_snapshot_header)
    rng = np.random.RandomState(3)
    cols = {}
    for name, n, M0 in (("baryon", 27, 0.25), ("cdm", 64, 1.5)):
        cols[name] = dict(
            x=rng.uniform(0, 32.0, (n, 3)).astype(np.float32),
            v=rng.normal(size=(n, 3)).astype(np.float32),
            id=rng.permutation(n).astype(np.int64),
            mass=(np.full(n, M0, np.float32) if name == "baryon" else None),
            M0=M0)
    meta = dict(a_x=1.0, a_v=1.0, q_nc=(4, 4, 4), q_scale=(8.0,) * 3,
                q_shift=(0.0,) * 3)
    jstores = {name: JStore(x=jnp.asarray(c["x"]), v=jnp.asarray(c["v"]),
                            id=jnp.asarray(c["id"]),
                            mass=None if c["mass"] is None
                            else jnp.asarray(c["mass"]),
                            M0=c["M0"], name=name, **meta)
               for name, c in cols.items()}
    stores = {name: store_from_numpy(c["x"], c["v"], c["id"], 1.0, 1.0,
                                     mass=c["mass"], M0=c["M0"], name=name,
                                     q_nc=(4, 4, 4), q_scale=(8.0,) * 3,
                                     q_shift=(0.0,) * 3)
              for name, c in cols.items()}
    c = dict(h=0.7, Omega_m=0.3, T_cmb=0.0)
    jpath, path = str(tmp_path / "jax"), str(tmp_path / "port")
    jwrite(jpath, JCosmology(**c), jstores, 4, 32.0)
    write_snapshot(path, Cosmology(**c), stores, 4, 32.0)
    heads = [h(p) for p in (jpath, path)
             for h in (jhead, read_snapshot_header)]
    for h in heads:
        np.testing.assert_array_equal(np.ravel(h["TotNumPart"]),
                                      [27, 64, 0, 0, 0, 0])
        np.testing.assert_array_equal(np.ravel(h["MassTable"]),
                                      [0.25, 1.5, 0, 0, 0, 0])
    for ds, name in (("0", "baryon"), ("1", "cdm")):
        reads = [r(p, ds) for p in (jpath, path)
                 for r in (jread, read_species)]
        o = np.argsort(cols[name]["id"])
        for r in reads:
            np.testing.assert_array_equal(
                np.asarray(r["id"]).reshape(-1).astype(np.int64),
                np.arange(len(o)))
            np.testing.assert_array_equal(r["x"], cols[name]["x"][o])
            if name == "baryon":
                np.testing.assert_array_equal(r["mass"].reshape(-1),
                                              cols[name]["mass"][o])
            else:
                assert "mass" not in r
            assert r["_attrs"]["M0"] == pytest.approx(cols[name]["M0"])


def test_unknown_species_raises():
    s = Solver(SolverConfig(nc=8, boxsize=16.0), device="cpu")
    with pytest.raises(ValueError, match="baryon, cdm, ncdm"):
        s.add_species("gas", s.species[CDM])
    assert "gas" not in s.species
