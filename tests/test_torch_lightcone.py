"""The port's lightcone (fastpm_torch/lightcone.py, cli.prepare_lc) and
rand column against the JAX package's.

- Horizon tables: float64, rtol 1e-12; volume_density_from_ell.
- One tile solve on the same store and factors: the same accepted rows,
  with aemit, position and velocity within 1e-6 relative (a few float32
  ulp). They are not equal bit for bit: XLA on the CPU contracts
  multiply-adds and sums the three squares of |x| in its own way even
  between optimization_barriers (x + v * dyyy differs from the once-
  rounded numpy / PyTorch value in about 2.5 % of rows by 1 ulp), while
  the port rounds once per operation, the granularity the JAX code
  documents for the interval ends. The accepted rows, and the slice
  counts of the run below, do not move.
- The rank-emulated rand column equal for rand_ntask 1 and 4.
- One reduced lightcone run through both CLIs (module scope):
  lightcone.lua's physics at nc = 16, boxsize = 128, 4 steps, tiles
  {-1, 0}^3, rand_ntask = 4, lightcone FOF and RFOF, HEALPix maps at
  nside 8, the potential and the tidal tensor, and a snapshot subsampled
  to particle_fraction = 0.5. The "Writing N objects." lines are equal,
  the usmesh slices are equal by id (aemit and positions within 1e-5
  relative: the states differ by the float32 force), the HEALPix ids
  equal, the snapshot holds the same ids, and its Potential and Tidal
  columns agree by id to 1e-4 of each column's rms.
"""

import os
import re

import numpy as np
import pytest
import torch

from fastpm_torch import lightcone as tlc
from fastpm_torch.cosmology import Cosmology
from fastpm_torch.kdk import DriftFactor, KickFactor
from fastpm_torch.convert import store_from_numpy

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
COSMO = dict(h=0.6774, Omega_m=0.307494, T_cmb=0.0, growth_mode="lcdm")


def test_horizon_matches_jax():
    from fastpm_tpu.cosmology import Cosmology as JCosmology
    from fastpm_tpu.lightcone import Horizon as JHorizon
    from fastpm_tpu.lightcone import volume_density_from_ell as jvd
    jh = JHorizon(JCosmology(**COSMO), dh_factor=0.1)
    th = tlc.Horizon(Cosmology(**COSMO), dh_factor=0.1)
    np.testing.assert_allclose(th.xi_a, jh.xi_a, rtol=1e-12)
    a = np.linspace(0.05, 1.0, 97)
    np.testing.assert_allclose(th.distance(a), jh.distance(a), rtol=1e-12)
    for ell, z in ((200, 0.5), (100, 3.0), (200, 0.0)):
        assert tlc.volume_density_from_ell(ell, z, th) == pytest.approx(
            jvd(ell, z, jh), rel=1e-12)
    # the float32 device table as the JAX float32 table
    import jax.numpy as jnp
    af = np.linspace(0.1, 1.0, 1001).astype(np.float32)
    np.testing.assert_array_equal(
        th.distance_device(torch.from_numpy(af)).numpy(),
        np.asarray(jh.distance_jax(jnp.asarray(af))))


@pytest.mark.parametrize("ntask", [1, 4])
def test_rank_emulated_rand_matches_jax(ntask):
    from fastpm_tpu.store import _rank_emulated_rand as jrand
    from fastpm_torch.store import _rank_emulated_rand
    for nc in ((8, 8, 8), (6, 10, 4)):
        np.testing.assert_array_equal(_rank_emulated_rand(nc, 1231584, ntask),
                                      jrand(nc, 1231584, ntask))


def test_lattice_rand_column():
    from fastpm_torch.mesh import PM
    from fastpm_torch.store import lattice_store, _rank_emulated_rand
    p = lattice_store(PM(8, 16.0, device="cpu"), columns=("v", "id", "rand"),
                      rand_ntask=4, rand_seed=7)
    np.testing.assert_array_equal(
        p.rand.numpy(), _rank_emulated_rand((8, 8, 8), 7, 4).astype(np.float32))
    assert p.subsample_mask(0.5).numpy().tolist() == (
        p.rand.numpy() <= 0.5).tolist()
    assert bool(p.subsample_mask(1.0).all())


def test_tile_solve_matches_jax():
    """The crossings of one tile over one drift interval on a displaced
    lattice with velocities and accelerations."""
    import jax.numpy as jnp
    from fastpm_tpu.cosmology import Cosmology as JCosmology
    from fastpm_tpu.kdk import (DriftFactor as JDrift, KickFactor as JKick)
    from fastpm_tpu.lightcone import LightCone as JLightCone
    from fastpm_tpu.lightcone import USMesh as JUSMesh
    from fastpm_tpu.store import Store as JStore
    rng = np.random.RandomState(2)
    nc, box = 24, 128.0
    q = (np.stack(np.meshgrid(*[np.arange(nc)] * 3, indexing="ij"), -1)
         .reshape(-1, 3) + 0.5) * (box / nc)
    n = len(q)
    x = ((q + rng.normal(0, 2.0, q.shape)) % box).astype(np.float32)
    v = rng.normal(0, 5.0, (n, 3)).astype(np.float32)
    acc = rng.normal(0, 3.0, (n, 3)).astype(np.float32)
    ids = np.arange(n)
    rand = rng.uniform(0, 1, n).astype(np.float32)
    a1, a2, ac = 0.55, 0.7, 0.625
    jc = JCosmology(**COSMO)
    jlc = JLightCone(cosmology=jc, fov=360.0, dh_factor=0.05)
    jp = JStore(x=jnp.asarray(x), v=jnp.asarray(v), acc=jnp.asarray(acc),
                id=jnp.asarray(ids.astype(np.uint32)), rand=jnp.asarray(rand),
                a_x=a1, a_v=ac)
    shift = np.array([-box, 0.0, -box])
    jmesh = JUSMesh(jlc, lambda: jp, shift[None], amin=0.1, amax=1.0)
    jrec = jmesh._solve_tile(jp, JDrift(jc, "fastpm", a1, ac, a2),
                             JKick(jc, "fastpm", 0.4, a1, ac), shift, a1, a2)
    c = Cosmology(**COSMO)
    lc = tlc.LightCone(cosmology=c, fov=360.0, dh_factor=0.05)
    p = store_from_numpy(x, v, ids, a1, ac, rand=rand).replace(
        acc=torch.from_numpy(acc))
    mesh = tlc.USMesh(lc, lambda: p, shift[None], amin=0.1, amax=1.0)
    rec = mesh._solve_tile(p, DriftFactor(c, "fastpm", a1, ac, a2),
                           KickFactor(c, "fastpm", 0.4, a1, ac), shift, a1, a2)
    nj = jrec["n"]
    assert rec["n"] == nj > 100
    jr = {k: np.asarray(val)[:nj] for k, val in jrec.items() if k != "n"}
    o = np.argsort(rec["id"].numpy())
    oj = np.argsort(jr["id"].astype(np.int64))
    np.testing.assert_array_equal(rec["id"].numpy()[o], jr["id"][oj])
    np.testing.assert_array_equal(rec["rand"].numpy()[o], jr["rand"][oj])
    for k in ("aemit", "x", "v"):
        want = jr[k][oj]
        np.testing.assert_allclose(rec[k].numpy()[o], want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max(), err_msg=k)


LUA = open(os.path.join(FIXTURES, "lightcone.lua")).read()
for old, new in (("nc = 64", "nc = 16"), ("boxsize = 512", "boxsize = 128"),
                 ("linspace(0.1, 1, 8)", "linspace(0.1, 1, 4)"),
                 ("{-2, -1, 0, 1}", "{-1, 0}"),
                 ("particle_fraction = 1.0", "particle_fraction = 0.5")):
    assert old in LUA
    LUA = LUA.replace(old, new)
LUA += ('write_rfof = "OUTDIR/rfof"\nlc_usmesh_healpix_nside = 8\n'
        'lc_usmesh_nslices = 20\n')


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reduced lightcone.lua through the JAX CLI and the port's on
    the CPU: (log lines, output directory) of each."""
    import jax
    from fastpm_tpu import cli as jcli
    from fastpm_tpu.config.params import load_params as jload
    from fastpm_tpu.diagnostics import Log as JLog
    from fastpm_torch import cli
    from fastpm_torch.config.params import load_params
    from fastpm_torch.diagnostics import Log
    tmp = tmp_path_factory.mktemp("lightcone")
    out = {}
    for name in ("jax", "torch"):
        d = str(tmp / name)
        conf = tmp / (name + ".lua")
        conf.write_text(re.sub(
            r'read_powerspectrum = ".*"', 'read_powerspectrum = "%s"'
            % os.path.join(FIXTURES, "powerspec.txt"),
            LUA.replace("OUTDIR", d)))
        if name == "jax":
            log = JLog(echo=False)
            jcli.run_fastpm(jload(str(conf)), log=log)
        else:
            log = Log(echo=False)
            cli.run_fastpm(load_params(str(conf)), log=log, device="cpu")
        out[name] = (log.lines, d)
    return out


def _objects(lines):
    return [l for l in lines if l.startswith("Writing") and "objects" in l]


def test_lightcone_run_writes_the_same_objects(runs):
    # as a multiset: the snapshot's line comes from its writer thread,
    # at no fixed place among the lightcone's
    want, got = _objects(runs["jax"][0]), _objects(runs["torch"][0])
    assert len(want) > 10
    assert sorted(got) == sorted(want)


def test_lightcone_slices_equal_by_id(runs):
    from fastpm_tpu.io.bigfile import BigFile
    cols = {}
    for name in ("jax", "torch"):
        bf = BigFile(os.path.join(runs[name][1], "usmesh"))
        ids = bf.open_block("1/ID").read_all().reshape(-1)
        o = np.argsort(ids, kind="stable")
        cols[name] = {k: bf.open_block("1/" + k).read_all()[o]
                      for k in ("ID", "Aemit", "Position", "Rand")}
        cols[name]["HEALPIX"] = bf.open_block("HEALPIX/ID").read_all()
        cols[name]["size"] = bf.open_block("1").attrs.get("aemitIndex.size")
    j, t = cols["jax"], cols["torch"]
    assert len(t["ID"]) > 1000
    np.testing.assert_array_equal(t["ID"], j["ID"])
    np.testing.assert_array_equal(t["Rand"], j["Rand"])
    np.testing.assert_array_equal(t["size"], j["size"])
    np.testing.assert_array_equal(t["HEALPIX"], j["HEALPIX"])
    np.testing.assert_allclose(t["Aemit"], j["Aemit"], rtol=1e-5)
    np.testing.assert_allclose(t["Position"], j["Position"], rtol=1e-5,
                               atol=1e-5 * 128)


def test_lightcone_snapshot_potential_tidal(runs):
    from fastpm_tpu.io.bigfile import BigFile
    got = {}
    for name in ("jax", "torch"):
        bf = BigFile(os.path.join(runs[name][1], "fastpm_1.0000"))
        ids = bf.open_block("1/ID").read_all().reshape(-1)
        o = np.argsort(ids)
        got[name] = {k: bf.open_block("1/" + k).read_all()[o]
                     for k in ("ID", "Potential", "Tidal")}
    j, t = got["jax"], got["torch"]
    # the rand <= 0.5 subsample of the 16^3 rows
    assert 1000 < len(t["ID"]) < 3000
    np.testing.assert_array_equal(t["ID"], j["ID"])
    for k in ("Potential", "Tidal"):
        w, g = j[k].reshape(len(j["ID"]), -1), t[k].reshape(len(j["ID"]), -1)
        assert g.shape == w.shape
        for c in range(w.shape[1]):
            np.testing.assert_allclose(g[:, c], w[:, c], rtol=0,
                                       atol=1e-4 * w[:, c].std(),
                                       err_msg="%s[%d]" % (k, c))
