"""The port's massive-neutrino (ncdm) path against the JAX package on the
CPU: the Fermi-Dirac split tables and the split itself, K3 and K4's plain
versions against the Pallas make_paint_fn / make_readout3_fn in
interpret mode, lpt_solve with a growth-rate table, the multi-species
force, and tests/fixtures/ncdm.lua through both CLIs.

The physics is the fixture's: m_ncdm = {0.12, 0.06, 0.02}, 4 shells,
Fibonacci n_side = 2, every_ncdm = 4. Inputs are made with numpy from a
seed and handed to both packages. Tolerances are stated per test; paint
and readout sum in float32 in another order, hence the repo's atol 2e-6
+ rtol 1e-5 for them.
"""

import os
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fastpm_tpu.cosmology import Cosmology as JCosmology
from fastpm_tpu.mesh import PM as JPM
from fastpm_tpu import ncdm as jncdm
from fastpm_tpu.io.bigfile import BigFile

from fastpm_torch.cosmology import Cosmology
from fastpm_torch.mesh import PM
from fastpm_torch.painter import Painter
from fastpm_torch import gravity, ncdm
from fastpm_torch.convert import field_from_numpy, store_from_numpy
from fastpm_torch.ops import cic

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
COSMO = dict(h=0.6711, Omega_m=0.3175, T_cmb=2.7255, N_eff=3.046, N_nu=3,
             m_ncdm=(0.12, 0.06, 0.02), growth_mode="ode")
NC, BOX, EVERY = 16, 128.0, 4
PAINT_TOL = dict(rtol=1e-5, atol=2e-6)


@pytest.fixture(scope="module")
def cosmologies():
    return JCosmology(**COSMO), Cosmology(**COSMO)


@pytest.fixture(scope="module")
def jax_tables(cosmologies):
    """The JAX NcdmInitData per sphere scheme (each builds the 4000-point
    Fermi-Dirac CDF: seconds), built once for the module."""
    jc, _ = cosmologies
    return {scheme: jncdm.NcdmInitData(
        boxsize=BOX, cosmology=jc, z=99.0, n_shells=4, n_side=2, lvk=True,
        sphere_scheme=scheme) for scheme in ("fibonacci", "healpix")}


def _table(c, scheme):
    return ncdm.NcdmInitData(boxsize=BOX, cosmology=c, z=99.0, n_shells=4,
                             n_side=2, lvk=True, sphere_scheme=scheme)


@pytest.mark.parametrize("scheme", ["fibonacci", "healpix"])
def test_fd_tables_match_jax(cosmologies, jax_tables, scheme):
    """The same scipy quadratures in the same order: equal to 1e-12."""
    got, want = _table(cosmologies[1], scheme), jax_tables[scheme]
    assert got.n_split == want.n_split == (20 if scheme == "fibonacci"
                                           else 4 * 48)
    np.testing.assert_allclose(got.vel, want.vel, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got.mass, want.mass, rtol=1e-12, atol=1e-12)
    assert got.mass.sum() == pytest.approx(1.0, rel=1e-12)


def _jax_sites():
    """The ncdm sites of prepare_ncdm: a (NC / EVERY)^3 lattice staggered
    by half a CDM cell, as JAX stores and as numpy."""
    from fastpm_tpu.store import lattice_store as jlattice_store
    sites = jlattice_store(JPM(NC, BOX), Nc=NC // EVERY,
                           columns=("v", "acc", "id"), name="ncdm")
    stag = np.float32(BOX / NC * 0.5)
    return sites.replace(x=sites.x + stag, q_shift=tuple(
        s + float(stag) for s in sites.q_shift))


def _to_port(p, **kw):
    return store_from_numpy(
        np.asarray(p.x), None if p.v is None else np.asarray(p.v),
        None if p.id is None else np.asarray(p.id), p.a_x, p.a_v,
        mass=None if p.mass is None else np.asarray(p.mass),
        M0=p.M0, q_shift=p.q_shift, q_scale=p.q_scale, q_nc=p.q_nc,
        name=p.name, **kw)


def test_split_ncdm_matches_jax(cosmologies, jax_tables):
    """x, v and mass to rtol 1e-6 (float32 products), ids exact."""
    sites = _jax_sites()
    want = jncdm.split_ncdm(jax_tables["fibonacci"], sites)
    port_sites = _to_port(sites)
    port_sites.acc = torch.zeros_like(port_sites.x)
    got = ncdm.split_ncdm(_table(cosmologies[1], "fibonacci"), port_sites)
    assert got.np_local == (NC // EVERY) ** 3 * 20 and got.M0 == 0.0
    assert got.id.dtype == torch.int64
    np.testing.assert_array_equal(got.id.numpy(), np.asarray(want.id))
    for col in ("x", "v", "mass"):
        np.testing.assert_allclose(getattr(got, col).numpy(),
                                   np.asarray(getattr(want, col)),
                                   rtol=1e-6, atol=1e-6)
    assert torch.all(got.acc == 0)


def _positions(kind, n, box, seed):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        pos = rng.uniform(0, box, (n, 3))
    elif kind == "clustered":
        pos = np.concatenate([box * 0.3 + 0.4 * rng.random((n - 500, 3)),
                              rng.uniform(0, box, (500, 3))])
    else:
        # box edges, the origin, cell boundaries, positions equal to the
        # box size (a float32 wrap can produce them)
        g = np.stack(np.meshgrid(*[np.arange(4) * box / 4] * 3,
                                 indexing="ij"), axis=-1).reshape(-1, 3)
        pos = np.concatenate([g, np.full((4, 3), box - 1e-3),
                              np.full((4, 3), box),
                              rng.uniform(0, box, (n - len(g) - 8, 3))])
    # store order, not cell order
    return rng.permutation(pos).astype(np.float32)


KINDS = ["uniform", "clustered", "boundary"]


@pytest.fixture(scope="module")
def pallas_paint():
    """make_paint_fn in interpret mode, built once so that each input
    shape compiles once for the module."""
    from fastpm_tpu.ops.paint_pallas import make_paint_fn
    jpm = JPM(16, 32.0)
    return jpm, make_paint_fn(jpm, K=64, C=1024, interpret=True)


@pytest.fixture(scope="module")
def pallas_readout3():
    from fastpm_tpu.ops.readout_pallas import make_readout3_fn
    jpm = JPM(16, 64.0)
    return jpm, make_readout3_fn(jpm, K=256, C=1024, interpret=True)


@pytest.mark.parametrize("kind", KINDS)
def test_paint_into_plain_matches_pallas(pallas_paint, kind):
    """K3's plain version against make_paint_fn (interpret) with a mass
    column, unsorted; two species added into one canvas equal JAX's
    canvas + out."""
    jpm, paint = pallas_paint
    rng = np.random.default_rng(3)
    pos_a = _positions(kind, 2500, 32.0, seed=1)
    pos_b = _positions("uniform", 700, 32.0, seed=2)
    mass_b = rng.uniform(0.5, 1.5, len(pos_b)).astype(np.float32)

    want_a = np.asarray(paint(jnp.asarray(pos_a), 1.25))
    want = want_a + np.asarray(paint(jnp.asarray(pos_b),
                                     jnp.asarray(mass_b)))
    canvas = torch.zeros((16,) * 3)
    got = cic.cic_paint_into(canvas, torch.from_numpy(pos_a),
                             jpm.InvCellSize, 1.25)
    assert got is canvas
    np.testing.assert_allclose(canvas.numpy(), want_a, **PAINT_TOL)
    cic.cic_paint_into(canvas, torch.from_numpy(pos_b), jpm.InvCellSize,
                       torch.from_numpy(mass_b))
    np.testing.assert_allclose(canvas.numpy(), want, **PAINT_TOL)
    assert float(canvas.sum()) == pytest.approx(
        1.25 * len(pos_a) + mass_b.sum(dtype=np.float64), rel=1e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_readout3_plain_matches_pallas(pallas_readout3, kind):
    """K4's plain version against make_readout3_fn (interpret): rows in
    input order."""
    jpm, readout3 = pallas_readout3
    pos = _positions(kind, 4321, 64.0, seed=4)
    rng = np.random.default_rng(7)
    cs = [rng.standard_normal((16,) * 3).astype(np.float32)
          for _ in range(3)]
    want = np.asarray(readout3(*map(jnp.asarray, cs), jnp.asarray(pos)))
    got = cic.cic_readout3(*map(torch.from_numpy, cs),
                           torch.from_numpy(pos), jpm.InvCellSize)
    assert tuple(got.shape) == (len(pos), 3)
    np.testing.assert_allclose(got.numpy(), want, **PAINT_TOL)


def test_lpt_solve_growth_rate_matches_jax():
    """dx1, dx2 and dv1 through both lpt_solve with the fixture's ncdm
    growth-rate table, at rtol 1e-5 and atol 1e-5 of the largest value
    (float32 rounding of ~13 FFTs)."""
    from fastpm_tpu.lpt import lpt_solve as jlpt_solve
    from fastpm_tpu.powerspectrum import FuncK as JFuncK
    from fastpm_tpu.store import lattice_store as jlattice_store
    from fastpm_tpu import ic as jic
    from fastpm_torch.lpt import lpt_solve
    from fastpm_torch.powerspectrum import FuncK

    jpm = JPM(32, 128.0)
    jc = JCosmology(h=0.6774, Omega_m=0.307494, T_cmb=0.0,
                    growth_mode="lcdm")
    jdk, _ = jic.linear_field(jpm, jc, JFuncK.from_file(
        os.path.join(FIXTURES, "Pncdm.txt")), seed=42, aout=1.0)
    q = np.asarray(jlattice_store(jpm, columns=("id",)).x) + 0.7
    fk = os.path.join(FIXTURES, "fncdm.txt")
    want = jlpt_solve(jpm, jdk, jnp.asarray(q), "1_4", JFuncK.from_file(fk))
    got = lpt_solve(PM(32, 128.0), field_from_numpy(np.asarray(jdk), "cpu"),
                    torch.from_numpy(q), "1_4", FuncK.from_file(fk))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())
    # dv1 is dx1 reweighted by f(k), not a copy of it
    assert float(got[2].abs().max()) > 0
    assert not torch.allclose(got[2], got[0])


@pytest.fixture(scope="module")
def species_pair(cosmologies, jax_tables):
    """A displaced CDM lattice (scalar M0) and the split ncdm species
    (mass column, M0 = 0) as JAX stores."""
    from fastpm_tpu.store import lattice_store as jlattice_store
    rng = np.random.default_rng(11)
    cdm = jlattice_store(JPM(NC, BOX), columns=("v", "acc", "id"),
                         M0=3.5, name="cdm")
    x = np.asarray(cdm.x) + rng.normal(0, 3.0, (NC ** 3, 3))
    cdm = cdm.replace(x=jnp.asarray((x % BOX).astype(np.float32)))
    nu = jncdm.split_ncdm(jax_tables["fibonacci"], _jax_sites())
    return cdm, nu.replace(x=jnp.mod(nu.x, BOX))


def test_multi_species_force_matches_jax(species_pair):
    """Port compute_force against JAX compute_force on CDM + ncdm, on a
    32^3 force mesh: acc per species row by row at rtol 1e-5 and atol
    1e-5 of the largest value; delta_k likewise."""
    from fastpm_tpu import gravity as jgravity
    from fastpm_tpu.painter import Painter as JPainter
    jstores = list(species_pair)
    jpm = JPM(2 * NC, BOX)
    want, jdk = jgravity.compute_force(jpm, JPainter(jpm, "cic"), jstores)

    pm = PM(2 * NC, BOX)
    stores = [_to_port(p) for p in jstores]
    painter = Painter(pm, "cic")
    assert not gravity.carry_eligible(painter, stores)
    got, dk = gravity.compute_force(pm, painter, stores)
    for g, w, p in zip(got, want, stores):
        # rows in their input order
        assert torch.equal(g.id, p.id)
        w = np.asarray(w.acc)
        np.testing.assert_allclose(g.acc.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())
    jdk = np.asarray(jdk)
    np.testing.assert_allclose(dk.numpy(), jdk, rtol=1e-5,
                               atol=1e-5 * np.abs(jdk).max())


def test_carry_force_matches_generic_force(species_pair):
    """One scalar-mass species: compute_force_carry (K1/K2 path, cell
    order) and compute_force (K3/K4 path, row order) agree by id at
    rtol 1e-5 and atol 1e-5 of the largest value."""
    pm = PM(2 * NC, BOX)
    painter = Painter(pm, "cic")
    store = _to_port(species_pair[0])
    assert gravity.carry_eligible(painter, [store])
    carried, dk_c = gravity.compute_force_carry(pm, painter, store)
    (plain,), dk_p = gravity.compute_force(pm, painter, [store])
    order = torch.argsort(carried.id)
    assert torch.equal(carried.id[order], plain.id)
    want = plain.acc.numpy()
    np.testing.assert_allclose(carried.acc[order].numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(dk_c.numpy(), dk_p.numpy(), rtol=1e-5,
                               atol=1e-5 * float(dk_p.abs().max()))


# ---- tests/fixtures/ncdm.lua through both CLIs ----


def _fixture_lua(tmp, out):
    """ncdm.lua with its table paths pointed at this directory's
    fixtures and its outputs at out."""
    src = open(os.path.join(FIXTURES, "ncdm.lua")).read()
    src = re.sub(r'"[^"]*/(\w+\.txt)"',
                 lambda m: '"%s"' % os.path.join(FIXTURES, m.group(1)), src)
    conf = tmp / ("%s.lua" % os.path.basename(out))
    conf.write_text(src.replace("OUTDIR", out))
    return str(conf)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ncdm_cli")
    out_jax, out_torch = str(tmp / "jax"), str(tmp / "torch")

    from fastpm_tpu.config.params import load_params
    from fastpm_tpu.cli import run_fastpm
    from fastpm_tpu.diagnostics import Log
    run_fastpm(load_params(_fixture_lua(tmp, out_jax)), Log(echo=False))

    from fastpm_torch import cli
    assert cli.main([_fixture_lua(tmp, out_torch)], device="cpu") == 0
    return out_jax, out_torch


def _species(path, dataset):
    bf = BigFile(path)
    ids = bf.open_block(dataset + "/ID").read_all().reshape(-1)
    o = np.argsort(ids)
    cols = [bf.open_block("%s/%s" % (dataset, c)).read_all()[o]
            for c in ("Position", "Velocity")]
    mass = (bf.open_block(dataset + "/Mass").read_all()[o]
            if bf.has_block(dataset + "/Mass") else None)
    return ids[o].astype(np.int64), cols[0], cols[1], mass


@pytest.mark.parametrize("dataset", ["1", "2"])
def test_cli_species_agree_by_id(cli_runs, dataset):
    """Both species by id: positions to 1e-4 of a cell, velocities to
    1e-4 of their rms, 2/Mass to rtol 1e-6."""
    a, b = [_species(os.path.join(out, "fastpm_1.0000"), dataset)
            for out in cli_runs]
    n = NC ** 3 if dataset == "1" else (NC // EVERY) ** 3 * 20
    assert len(b[0]) == n
    np.testing.assert_array_equal(b[0], a[0])
    dx = b[1] - a[1]
    dx -= np.round(dx / BOX) * BOX
    assert np.abs(dx).max() < 1e-4 * BOX / NC
    assert np.abs(b[2] - a[2]).max() < 1e-4 * a[2].std()
    if dataset == "1":
        assert a[3] is None and b[3] is None
    else:
        assert (b[3] > 0).all()
        np.testing.assert_allclose(b[3], a[3], rtol=1e-6)


def test_cli_mass_table_matches(cli_runs):
    tables = [np.asarray(BigFile(os.path.join(out, "fastpm_1.0000"))
                         .open_block("Header").attrs.get("MassTable"))
              for out in cli_runs]
    np.testing.assert_allclose(tables[1], tables[0], rtol=1e-12)
    assert tables[1][1] > 0 and tables[1][2] == 0


def test_cli_powerspectrum_rows_agree(cli_runs):
    """One P(k) file per force step; rows at rtol 2e-5, Nmodes equal."""
    out_jax, out_torch = cli_runs
    names = sorted(f for f in os.listdir(out_jax)
                   if f.startswith("powerspec_"))
    assert len(names) == 6
    assert names == sorted(f for f in os.listdir(out_torch)
                           if f.startswith("powerspec_"))
    for name in names:
        want = np.loadtxt(os.path.join(out_jax, name), comments="#")
        got = np.loadtxt(os.path.join(out_torch, name), comments="#")
        np.testing.assert_array_equal(got[:, 2], want[:, 2])   # Nmodes
        np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=2e-5)


def test_unserved_ncdm_options_refused(tmp_path):
    """The neutrino linear response, ncdm k-space input and baryons stay
    refused; m_ncdm and read_linear_growth_rate are served."""
    from fastpm_torch import cli
    from fastpm_torch.config.params import load_params
    from fastpm_torch.solver import Solver, SolverConfig, BARYON
    base = ("nc = 8\nboxsize = 16.0\ntime_step = {0.1, 1.0}\n"
            "pm_nc_factor = 1\nnp_alloc_factor = 1.0\nh = 0.7\n"
            "Omega_m = 0.3\nm_ncdm = {0.06}\n"
            'read_linear_growth_rate = "f.txt"\n')
    particles = "ncdm_freestreaming = false\n"
    conf = tmp_path / "ok.lua"
    conf.write_text(base + particles)
    cli.check_served(load_params(str(conf)))
    # the linear response needs free-streaming ncdm, which has no particles
    for name, extra in (
            ("ncdm_linearresponse", "ncdm_freestreaming = true\n"
             "n_shell = 0\nncdm_linearresponse = true\n"),
            ("read_lineark_ncdm", particles + 'read_lineark_ncdm = "lk"\n')):
        conf = tmp_path / (name + ".lua")
        conf.write_text(base + extra)
        with pytest.raises(SystemExit, match=name):
            cli.main([str(conf)], device="cpu")
    solver = Solver(SolverConfig(nc=8, boxsize=16.0), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        solver.add_species(BARYON, solver.species["cdm"])
