"""The port's pencil (2D) decomposition over gloo ranks against the JAX
package's pencil on as many virtual CPU devices, and the open-y mode of
the homed kernels' plain versions against the JAX package's.

The parent computes the JAX oracles on a (px, py) mesh of
jax.devices()[:px * py] and hands the inputs to px * py gloo ranks
(tests/torch_rank_workers.py, which never imports JAX). The rows are
pencil-blocked (store.lattice_store(blocks=(px, py))), so rank
cx * py + cy holds block b = cx * py + cy, as the JAX package's
index-sharded arrays do. Grids 2 x 2, 1 x 2 and 2 x 1: the lopsided
ones catch swapped axes. Covered: the grid's rings; PencilPM's r2c, c2r
and the force's k-space stage (gravity.acc_fields through c2r_local)
against the JAX c2r_grad3_local shard by shard, the kz pad included
(Nz = 16 and 32 with Py = 2 pad one column); required_halo_planes_pencil; the pencil
multi force with both homed kernels (a scalar mass and a mass column,
the potential and tidal tensor, a halo wider than a pencil, the
overflow count); the pencil carry; v1 over PencilPM; the slab multi's
potential and tidal tensor on 2 ranks; the sharded Solver on 2 x 2
against one rank; read_runpbic on 2 and 4 ranks; the CLI on 4 ranks
(its default -y takes 2 x 2, -y 3 stops, -f takes the slab) against one
rank.

Tolerances: paint and readout atol 2e-6 and rtol 1e-5 against the
plain JAX bodies; acc, the potential and the tidal tensor within 1e-5
of the field's largest value; bad exact.
"""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as PS

from fastpm_tpu.mesh import PM as JPM
from fastpm_tpu.painter import Painter as JPainter
from fastpm_tpu.parallel.pfft import PencilPM as JPencilPM
from fastpm_tpu.parallel.pfft import SlabPM as JSlabPM
from fastpm_tpu.parallel import psolver as jps

import torch_rank_workers as workers
from test_torch_parallel import spawn, jittered_lattice, _cat, _by_id
from fastpm_torch.ops import cic

NC, BOX = 32, 64.0                   # the forces (nzh 17: a pad of 1)
FFT_SHAPE, FFT_BOX = (16, 8, 16), 32.0   # PencilPM (nzh 9: a pad of 1)
POWERSPEC = os.path.join(os.path.dirname(__file__), "fixtures",
                         "powerspec.txt")
SOLVER = dict(nc=16, box=64.0, steps=(0.3, 0.6, 1.0), seed=7)
# the Solver runs of each grid: as is, and with the potential and tidal
# tensor (on 1 x 2 no x halo fits a 16^3 mesh: the v1 force)
SOLVER_VARIANTS = {(2, 2): "plain pot_tid", (1, 2): "pot_tid"}
GRIDS = [(2, 2), (1, 2), (2, 1)]


def pencil_blocked(nc, px, py):
    """The ids of the rows of store.lattice_store(blocks=(px, py)): the
    index that permutes x-major lattice rows into pencil-blocked order
    (test_homed_force.py:296-308)."""
    bx, by = nc // px, nc // py
    i = np.arange(nc ** 3)
    bsz = bx * by * nc
    b, w = i // bsz, i % bsz
    bi, bj = b // py, b % py
    l0 = w // (by * nc)
    rr = w % (by * nc)
    l1, i2 = rr // nc, rr % nc
    return ((bi * bx + l0) * nc + (bj * by + l1)) * nc + i2


def overflow_axis(py):
    """The axis the overflow case pushes a particle along: y, unless the
    grid has one row of pencils."""
    return 1 if py > 1 else 0


def force_cases(px, py):
    """name -> (pencil-blocked positions, (Hx, Hy), mass column or
    None). Case "a" also reads out the potential and tidal tensor."""
    ids = pencil_blocked(NC, px, py)
    nlx, nly = NC // px, NC // py
    cases = {
        "a": (jittered_lattice(NC, BOX, 1.8, 29)[ids], (3, 2), None),
        "mass": (jittered_lattice(NC, BOX, 1.2, 31)[ids], (2, 3),
                 (0.5 + np.random.RandomState(5).rand(NC ** 3))
                 .astype(np.float32)[ids]),
        # halos wider than a pencil: several hops along each ring
        "hop": (jittered_lattice(NC, BOX, 6.0, 23)[ids],
                (nlx + 3, nly + 1), None)}
    # the first particle pushed 5 rows (planes on a grid of py = 1)
    # beyond its pencil, H = 2
    x = jittered_lattice(NC, BOX, 0.0, 0)[ids]
    d = overflow_axis(py)
    x[0, d] = (x[0, d] - 5 * BOX / NC) % BOX
    cases["overflow"] = (x, (2, 2), None)
    return cases


def jax_oracles(px, py, data, cases):
    """The JAX package's results on a (px, py) mesh of virtual devices."""
    mesh = Mesh(np.array(jax.devices()[:px * py]).reshape(px, py),
                ("x", "y"))
    rows, pen, kspec = PS(("x", "y")), PS("x", "y"), PS(None, "x", "y")
    out = {}

    fppm = JPencilPM(JPM(FFT_SHAPE, FFT_BOX), mesh)

    def fft_local(a):
        dk = fppm.r2c_local(a)
        t = fppm.apply_decic(fppm.apply_grad(fppm.apply_pot(dk, 1), 1, 1))
        g = jnp.stack(fppm.c2r_grad3_local(fppm.apply_pot(dk, 0), 1))
        lap = fppm.apply_laplace(dk, 2)
        fk = fppm.apply_fk_interp(dk, jnp.asarray(data["fk_logk"]),
                                  jnp.asarray(data["fk_vals"]))
        return dk, t, g, lap, fk
    res = jax.jit(jax.shard_map(
        fft_local, mesh=mesh, in_specs=pen,
        out_specs=(kspec, kspec, PS(None, "x", "y"), kspec, kspec)))(
        jnp.asarray(data["fft_field"]))
    out.update(zip(("fft_dk", "fft_transfer", "fft_grad3", "fft_laplace",
                    "fft_fk"), map(np.asarray, res)))

    pm = JPM(NC, BOX)
    ppm = JPencilPM(pm, mesh)
    for name, (x, (Hx, Hy), mass) in cases.items():
        out[name + "_req"] = jps.required_halo_planes_pencil(
            pm, mesh, jnp.asarray(x))
        extra = name == "a"

        def local(xx, mm, Hx=Hx, Hy=Hy, has_mass=mass is not None,
                  extra=extra):
            outs, bad, _dk = jps._force_local_homed_pencil_multi(
                ppm, (xx,), (mm if has_mass else 1.0,), "1_4", Hx, Hy,
                compute_potential=extra, compute_tidal=extra)
            return outs[0], bad
        m = mass if mass is not None else np.ones(len(x), np.float32)
        spec_one = dict(acc=rows)
        if extra:
            spec_one.update(potential=rows, tidal=rows)
        res, bad = jax.jit(jax.shard_map(
            local, mesh=mesh, in_specs=(rows, rows),
            out_specs=(spec_one, PS())))(jnp.asarray(x), jnp.asarray(m))
        for k, v in res.items():
            out["%s_%s" % (name, k)] = np.asarray(v)
        out[name + "_bad"] = int(bad)

    # the carry's force: the pencil body at the carry's halo
    Hx, Hy = data["carry_H"]
    out["carry_acc"] = np.asarray(jax.jit(jax.shard_map(
        lambda xx: jps._force_local_homed_pencil_multi(
            ppm, (xx,), (1.0,), "1_4", int(Hx), int(Hy))[0][0]["acc"],
        mesh=mesh, in_specs=rows, out_specs=rows))(
        jnp.asarray(data["carry_x"])))
    out["v1_acc"] = np.asarray(jps.sharded_force_fn(pm, mesh)(
        jnp.asarray(data["a_x"])))

    if "slab_x" in data:
        smesh = Mesh(np.array(jax.devices()[:px * py]), ("x",))
        spm = JSlabPM(pm, smesh, axis="x")

        def slab_local(xx):
            outs, bad, _dk = jps._force_local_homed_multi(
                spm, (xx,), (1.0,), "1_4", int(data["slab_H"]),
                compute_potential=True, compute_tidal=True)
            return outs[0], bad
        s = PS("x")
        res, bad = jax.jit(jax.shard_map(
            slab_local, mesh=smesh, in_specs=s,
            out_specs=(dict(acc=s, potential=s, tidal=s), PS())))(
            jnp.asarray(data["slab_x"]))
        out.update({"slab_" + k: np.asarray(v) for k, v in res.items()})
        out["slab_bad"] = int(bad)
    return out


def write_runpb_ic(path, nc, box, seed=3):
    """A RunPB IC file of an nc^3 lattice displaced by up to a cell, rows
    in a random order: the (x, v, id) read_runpbic takes."""
    from fastpm_torch.io.legacy import write_runpb_snapshot
    rng = np.random.RandomState(seed)
    ids = rng.permutation(nc ** 3).astype(np.int64)
    q = np.stack([(ids // s) % nc for s in (nc * nc, nc, 1)], axis=-1)
    x = ((q + 0.5 + rng.uniform(-1, 1, q.shape)) * (box / nc)) % box
    v = rng.normal(scale=2.0, size=q.shape)
    write_runpb_snapshot(path, x.astype(np.float32), v.astype(np.float32),
                         ids, 0.1, 3.0, box)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(px, py) -> (the JAX oracles, the inputs, the ranks' outputs),
    computed on first use."""
    cache = {}

    def get(px, py):
        if (px, py) in cache:
            return cache[px, py]
        tmp = tmp_path_factory.mktemp("pencil%d%d" % (px, py))
        cases = force_cases(px, py)
        ids = pencil_blocked(NC, px, py)
        data = dict(px=px, py=py, fft_box=FFT_BOX,
                    # a linear-response table over the mesh's |k|
                    fk_logk=np.linspace(-2.5, 1.0, 12).astype(np.float32),
                    fk_vals=np.linspace(-0.05, 0.0, 12).astype(np.float32),
                    fft_field=np.random.RandomState(0).normal(
                        size=FFT_SHAPE).astype(np.float32),
                    force_nc=NC, force_box=BOX, cases=" ".join(cases),
                    carry_x=jittered_lattice(NC, BOX, 2.0, 7)[ids],
                    carry_v=0.01 * jittered_lattice(NC, BOX, 1.0, 8)[ids],
                    carry_id=ids.astype(np.int64), carry_H=(3, 3))
        for name, (x, H, mass) in cases.items():
            data[name + "_x"], data[name + "_H"] = x, H
            if mass is not None:
                data[name + "_mass"] = mass
        if (px, py) == (2, 1):
            data.update(slab_x=jittered_lattice(NC, BOX, 1.5, 41),
                        slab_H=3)
        if px * py == 4 or (px, py) == (2, 1):
            path = str(tmp / "ic")
            write_runpb_ic(path, 16, 64.0)
            data.update(runpb=path, runpb_nc=16, runpb_box=64.0,
                        runpb_a=0.1)
        if (px, py) in SOLVER_VARIANTS:
            data.update(solver_nc=SOLVER["nc"], solver_box=SOLVER["box"],
                        solver_steps=np.asarray(SOLVER["steps"]),
                        solver_ps=POWERSPEC, solver_seed=SOLVER["seed"],
                        solver_variants=SOLVER_VARIANTS[px, py])
        inp = str(tmp / "inputs.npz")
        np.savez(inp, **data)
        spawn(px * py, "pencil", inp, str(tmp))
        ranks = [dict(np.load(str(tmp / ("rank%d.npz" % r))))
                 for r in range(px * py)]
        cache[px, py] = (jax_oracles(px, py, data, cases), data, ranks)
        return cache[px, py]
    return get


def _pencils(ranks, key, px, py, axes=(0, 1)):
    """The ranks' blocks of `key` put together on a px x py grid along
    the two axes (rank cx * py + cy holds block (cx, cy))."""
    return np.concatenate([
        np.concatenate([ranks[cx * py + cy][key] for cy in range(py)],
                       axis=axes[1]) for cx in range(px)], axis=axes[0])


def _close(got, want, what):
    """Within 1e-5 of the field's largest value."""
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale,
                               err_msg=what)


@pytest.mark.parametrize("px,py", GRIDS)
def test_grid_rings(runs, px, py):
    """x-ring: the ranks of one cy in cx order; y-ring: of one cx in cy
    order."""
    _oracle, _data, ranks = runs(px, py)
    for r, out in enumerate(ranks):
        cx, cy = divmod(r, py)
        np.testing.assert_array_equal(out["xring"],
                                      np.arange(px) * py + cy)
        np.testing.assert_array_equal(out["yring"], cx * py + np.arange(py))


@pytest.mark.parametrize("px,py", GRIDS)
def test_pencil_fft_matches_jax(runs, px, py):
    """r2c (the pad's column included), the shard transfers (potential,
    gradient, deCIC, the Laplacian, the linear response's fk interp) and
    the force stage's three fields against c2r_grad3_local shard by
    shard; c2r gives the field back."""
    oracle, data, ranks = runs(px, py)
    for key in ("fft_dk", "fft_transfer", "fft_laplace", "fft_fk"):
        np.testing.assert_allclose(_pencils(ranks, key, px, py, (1, 2)),
                                   oracle[key], atol=1e-5, err_msg=key)
    nzh = FFT_SHAPE[2] // 2 + 1
    dk = _pencils(ranks, "fft_dk", px, py, (1, 2))
    assert dk.shape[2] == -(-nzh // py) * py
    assert not np.any(dk[:, :, nzh:])
    np.testing.assert_allclose(_pencils(ranks, "fft_back", px, py),
                               data["fft_field"], atol=1e-4)
    np.testing.assert_allclose(_pencils(ranks, "fft_grad3", px, py, (1, 2)),
                               oracle["fft_grad3"], atol=1e-5)


@pytest.mark.parametrize("px,py", GRIDS)
def test_required_halo_planes_pencil(runs, px, py):
    oracle, _data, ranks = runs(px, py)
    for name in force_cases(px, py):
        for r in ranks:
            assert tuple(r[name + "_req"]) == tuple(oracle[name + "_req"])
    assert oracle["overflow_req"][overflow_axis(py)] == 5


@pytest.mark.parametrize("hk", workers.HOMED_KERNELS)
@pytest.mark.parametrize("case", ["a", "mass", "hop"])
@pytest.mark.parametrize("px,py", GRIDS)
def test_pencil_multi_matches_jax(runs, px, py, case, hk):
    """acc (and for case a the potential and tidal tensor) against JAX's
    pencil multi, rows in the rank's order."""
    oracle, _data, ranks = runs(px, py)
    assert oracle[case + "_bad"] == 0
    keys = ["acc"] + (["potential", "tidal"] if case == "a" else [])
    for r in ranks:
        assert int(r["%s_%s_bad" % (case, hk)]) == 0
        assert sorted(k.split("_", 2)[2] for k in r
                      if k.startswith("%s_%s_" % (case, hk))
                      and not k.endswith("_bad")) == sorted(keys)
    for k in keys:
        _close(_cat(ranks, "%s_%s_%s" % (case, hk, k)),
               oracle["%s_%s" % (case, k)], "%s %s %s" % (case, hk, k))


@pytest.mark.parametrize("hk", workers.HOMED_KERNELS)
@pytest.mark.parametrize("px,py", GRIDS)
def test_pencil_overflow_counted(runs, px, py, hk):
    """A particle 5 rows (or planes) beyond its pencil with a halo of 2
    is dropped and counted on every rank, as in JAX."""
    oracle, _data, ranks = runs(px, py)
    assert oracle["overflow_bad"] == 1
    for r in ranks:
        assert int(r["overflow_%s_bad" % hk]) == oracle["overflow_bad"]


@pytest.mark.parametrize("hk", workers.HOMED_KERNELS)
@pytest.mark.parametrize("px,py", GRIDS)
def test_pencil_carry_matches_jax(runs, px, py, hk):
    """The order-free pencil carry: the id -> (x, v) map moved bit for
    bit, and acc by id against JAX's pencil body at the same halo."""
    oracle, data, ranks = runs(px, py)
    for r in ranks:
        assert int(r["carry_%s_bad" % hk]) == 0
    ids = _cat(ranks, "carry_%s_id" % hk)
    o = np.argsort(ids, kind="stable")
    jo = np.argsort(data["carry_id"], kind="stable")
    np.testing.assert_array_equal(ids[o], np.arange(NC ** 3))
    for c in ("x", "v"):
        np.testing.assert_array_equal(_cat(ranks, "carry_%s_%s" % (hk, c))[o],
                                      data["carry_" + c][jo])
    _close(_cat(ranks, "carry_%s_acc" % hk)[o], oracle["carry_acc"][jo],
           "carry %s" % hk)


@pytest.mark.parametrize("px,py", GRIDS)
def test_pencil_v1_matches_jax(runs, px, py):
    oracle, _data, ranks = runs(px, py)
    _close(_cat(ranks, "v1_acc"), oracle["v1_acc"], "v1")


def test_slab_multi_potential_tidal_two_ranks(runs):
    """The slab multi body's potential and tidal tensor on 2 ranks
    (psolver.py:527-575)."""
    oracle, _data, ranks = runs(2, 1)
    assert oracle["slab_bad"] == 0
    for r in ranks:
        assert int(r["slab_bad"]) == 0
    for k in ("acc", "potential", "tidal"):
        _close(_cat(ranks, "slab_" + k), oracle["slab_" + k], k)


def test_sharded_solver_pencil_matches_one_rank(runs):
    """2 x 2 ranks against the port's one-rank Solver, by id; every force
    step took the pencil carry."""
    _oracle, _data, ranks = runs(2, 2)
    one = workers.run_solver(SOLVER["nc"], SOLVER["box"], SOLVER["steps"],
                             POWERSPEC, SOLVER["seed"])
    p = one.species["cdm"]
    x0, v0 = _by_id(p.id.numpy(), p.x.numpy(), p.v.numpy())
    x, v = _by_id(_cat(ranks, "solver_plain_id"),
                  _cat(ranks, "solver_plain_x"),
                  _cat(ranks, "solver_plain_v"))
    np.testing.assert_allclose(x, x0, atol=2e-3)
    np.testing.assert_allclose(v, v0, atol=2e-4)
    for r in ranks:
        paths = list(r["solver_plain_paths"])
        assert paths.count("pencil-carry") == len(SOLVER["steps"])
        assert set(paths) <= {"pencil-carry", "overflow"}


@pytest.mark.parametrize("px,py,path", [(2, 2, "pencil-multi"),
                                        (1, 2, "v1")])
def test_sharded_solver_potential_tidal(runs, px, py, path):
    """compute_potential and compute_tidal on a grid: x, v, the potential
    and the tidal tensor by id against one rank's (the potential and
    tidal tensor within 1e-5 of their largest values); every step took
    the pencil multi (2 x 2) or v1 over PencilPM (1 x 2)."""
    _oracle, _data, ranks = runs(px, py)
    one = workers.run_solver(SOLVER["nc"], SOLVER["box"], SOLVER["steps"],
                             POWERSPEC, SOLVER["seed"],
                             compute_potential=True, compute_tidal=True)
    p = one.species["cdm"]
    cols = ("x", "v", "potential", "tidal")
    want = _by_id(p.id.numpy(), *(getattr(p, c).numpy() for c in cols))
    got = _by_id(_cat(ranks, "solver_pot_tid_id"),
                 *(_cat(ranks, "solver_pot_tid_" + c) for c in cols))
    np.testing.assert_allclose(got[0], want[0], atol=2e-3)
    np.testing.assert_allclose(got[1], want[1], atol=2e-4)
    for c, g, w in zip(cols[2:], got[2:], want[2:]):
        _close(g, w, c)
    for r in ranks:
        paths = list(r["solver_pot_tid_paths"])
        assert paths.count(path) == len(SOLVER["steps"])
        assert set(paths) <= {path, "overflow"}


@pytest.mark.parametrize("px,py", [(2, 1), (2, 2)])
def test_read_runpbic_on_ranks(runs, px, py):
    """Every rank reads the file and keeps its slab's (2 ranks) or
    pencil's (2 x 2) rows: by id, the one-rank store bit for bit."""
    _oracle, data, ranks = runs(px, py)
    one = workers.runpb_ic(str(data["runpb"]), 16, 64.0, 0.1)
    nc = 16
    for r, out in enumerate(ranks):
        cx, cy = divmod(r, py)
        q = np.stack([(out["runpb_id"] // s) % nc
                      for s in (nc * nc, nc, 1)], axis=-1)
        assert np.all(q[:, 0] // (nc // px) == cx)
        assert np.all(q[:, 1] // (nc // py) == cy)
    cols = ("x", "v", "dx1", "dx2")
    want = _by_id(one.id.numpy(), *(getattr(one, c).numpy() for c in cols))
    got = _by_id(_cat(ranks, "runpb_id"),
                 *(_cat(ranks, "runpb_" + c) for c in cols))
    np.testing.assert_array_equal(np.sort(_cat(ranks, "runpb_id")),
                                  np.arange(nc ** 3))
    for c, g, w in zip(cols, got, want):
        np.testing.assert_array_equal(g, w, err_msg=c)


# ---- the open-y mode of the homed kernels ------------------------------

# rank (1, 0) of a 2 x 2 grid on 16^3: the pencil starts at plane 8, row
# 0; Hx = 2, Hy = 3
PN, PBOX, PL, P0XY, PH = 16, 32.0, 8, (8, 0), (2, 3)


def _pencil_inputs(n=4000, seed=11):
    """Positions around the pencil, in its halo bands and corners and
    beyond it, a mass column, and the JAX _cic_rel2 of them."""
    rng = np.random.RandomState(seed)
    cell = PBOX / PN
    x = rng.uniform(0, PBOX, (n, 3))
    for d in range(2):
        x[:, d] = (P0XY[d] - PH[d] - 2 + (PL + 2 * PH[d] + 4)
                   * rng.rand(n)) * cell
    x = (x % PBOX).astype(np.float32)
    mass = (0.5 + rng.rand(n)).astype(np.float32)
    return x, mass


def _pencil():
    return cic.Pencil(PN, P0XY[0], PH[0], PN, P0XY[1], PH[1])


def _ext():
    return (PL + 2 * PH[0] + 1, PL + 2 * PH[1] + 1, PN)


def test_pencil_plain_paint_readout_match_jax():
    """cic_paint_homed / cic_paint4 / cic_readout_homed / cic_readout4
    on a Pencil (their plain versions on the CPU) against _paint_homed2
    and _readout_homed2."""
    x, mass = _pencil_inputs()
    jpm = JPM(PN, PBOX)
    inv = jpm.InvCellSize
    xt, mt = torch.from_numpy(x), torch.from_numpy(mass)
    for m, mj in ((1.0, 1.0), (mt, jnp.asarray(mass))):
        want, wbad = jps._paint_homed2(jpm, PL, PL, *PH, *P0XY,
                                       jnp.asarray(x), mass=mj)
        for paint in (lambda c: cic.cic_paint_homed(c, xt, inv, _pencil(), m),
                      lambda c: cic.cic_paint4(c, xt, inv, m, _pencil())):
            canvas = torch.zeros(_ext())
            bad = paint(canvas)
            np.testing.assert_allclose(canvas.numpy(), np.asarray(want),
                                       atol=2e-6, rtol=1e-5)
            assert int(bad) == int(wbad) > 0
    rng = np.random.RandomState(5)
    fs = [rng.standard_normal(_ext()).astype(np.float32) for _ in range(3)]
    ft = [torch.from_numpy(f) for f in fs]
    want = np.asarray(jps._readout_homed2(jpm, PL, PL, *PH, *P0XY,
                                          jnp.asarray(x),
                                          [jnp.asarray(f) for f in fs]))
    for k in (1, 3):
        got = cic.cic_readout_homed(ft[:k], xt, inv, _pencil())
        np.testing.assert_allclose(got.numpy(), want[:, :k], atol=2e-6,
                                   rtol=1e-5)
    got = cic.cic_readout4(*ft, xt, inv, _pencil())
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=1e-5)
    # a row beyond the pencil reads zero
    _b, _f, valid = cic.slab_cell(xt, _ext(), inv, _pencil())
    assert not valid.all() and not got[~valid].any()


@pytest.mark.parametrize("hk", workers.HOMED_KERNELS)
def test_pencil_kernels_match_pallas_open_y(hk):
    """The plain open-y paint and readout against the homed Pallas
    factories with open_y=True in interpret mode, fed by
    make_prepare_homed_fn as the JAX pencil multi feeds them."""
    from fastpm_tpu.ops import paint_pallas as pp
    from fastpm_tpu.ops import readout_pallas as rp
    x, mass = _pencil_inputs(2000, 13)
    jpm = JPM(PN, PBOX)
    inv = jpm.InvCellSize
    shape = (PL + 2 * PH[0], PL + 2 * PH[1], PN)
    relx, rely, iz, frac = jps._cic_rel2(jpm, jnp.asarray(x), *P0XY, *PH)
    valid = (relx < shape[0]) & (rely < shape[1])
    relx = jnp.where(valid, relx, shape[0] + 1)
    prepared = jax.jit(pp.make_prepare_homed_fn(
        shape, C=1024, base_only=hk == "from8"))(relx, rely, iz, frac,
                                                 jnp.asarray(mass))
    make = (pp.make_paint_from8_homed_fn if hk == "from8"
            else pp.make_paint_from4_homed_fn)
    want = np.asarray(make(shape, K=256, C=1024, interpret=True,
                           open_y=True)(prepared))
    canvas = torch.zeros(want.shape)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mass)
    bad = (cic.cic_paint_homed(canvas, xt, inv, _pencil(), mt)
           if hk == "from8"
           else cic.cic_paint4(canvas, xt, inv, mt, _pencil()))
    np.testing.assert_allclose(canvas.numpy(), want, atol=2e-6, rtol=1e-5)
    assert int(bad) == int(np.sum(~np.asarray(valid))) > 0

    prepared = jax.jit(pp.make_prepare_homed_fn(
        shape, C=1024, base_only=hk == "from8"))(relx, rely, iz, frac)
    read = (rp.make_readout3_from8_homed_fn if hk == "from8"
            else rp.make_readout3_from4_homed_fn)
    rng = np.random.RandomState(6)
    fs = [rng.standard_normal(want.shape).astype(np.float32)
          for _ in range(3)]
    wantr = np.asarray(read(shape, K=256, C=1024, interpret=True,
                            gather_mode="highest", open_y=True)(
        prepared, *map(jnp.asarray, fs)))
    ft = [torch.from_numpy(f) for f in fs]
    got = (cic.cic_readout_homed(ft, xt, inv, _pencil()) if hk == "from8"
           else cic.cic_readout4(*ft, xt, inv, _pencil()))
    np.testing.assert_allclose(got.numpy(), wantr, atol=2e-6, rtol=1e-5)


def test_pencil_key_and_check():
    """A Pencil's open y: rely + 1 is never wrapped, the last rows
    inside read the canvas's last row; a wrong Pencil is refused."""
    inv = (PN / PBOX,) * 3
    cell = PBOX / PN
    # base rows P0y - Hy .. P0y + PL + Hy - 1 lie inside (rely 0 ..
    # ny - 2); the next one does not
    ys = (np.arange(-PH[1], PL + PH[1] + 1) + 0.5) * cell
    x = np.stack([np.full(len(ys), (P0XY[0] + 1.5) * cell), ys % PBOX,
                  np.full(len(ys), 0.5 * cell)], -1).astype(np.float32)
    base, _f, valid = cic.slab_cell(torch.from_numpy(x), _ext(), inv,
                                    _pencil())
    assert valid[:-1].all() and not valid[-1]
    np.testing.assert_array_equal(base[:-1, 1].numpy(),
                                  np.arange(len(ys) - 1))
    with pytest.raises(ValueError, match="bad slab"):
        cic.cic_paint_homed(torch.zeros(_ext()), torch.from_numpy(x), inv,
                            cic.Pencil(PN, 0, 2, PN, PN, 3))


# ---- the CLI on 4 ranks ---------------------------------------------

CLI_LUA = """
nc = 16
boxsize = 32.0
time_step = linspace(0.1, 1, 3)
output_redshifts = {0.0}
Omega_m = 0.307494
h       = 0.6774
read_powerspectrum = "%(ps)s"
linear_density_redshift = 0.0
random_seed = 100
force_mode = "fastpm"
kernel_type = "1_4"
growth_mode = "LCDM"
pm_nc_factor = 2
lpt_nc_factor = 1
np_alloc_factor = 4.0
fof_nmin = 8
write_snapshot = "%(out)s/fastpm"
write_powerspectrum = "%(out)s/powerspec"
write_fof = "%(out)s/fastpm"
"""


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """name -> output directory: "one" (one rank), "pencil" (4 ranks,
    the default -y), "slab" (4 ranks, -f), "y3" (4 ranks, -y 3)."""
    import contextlib
    import io
    from fastpm_torch import cli
    tmp = tmp_path_factory.mktemp("cli4")
    outs = {}
    for name, job in (("one", None), ("pencil", "cli"), ("slab", "cli -f"),
                      ("y3", "cli -y 3")):
        out = str(tmp / name)
        conf = tmp / (name + ".lua")
        conf.write_text(CLI_LUA % dict(ps=POWERSPEC, out=out))
        if job is None:
            with contextlib.redirect_stdout(io.StringIO()):
                assert cli.main([str(conf)], device="cpu") == 0
        else:
            spawn(4, job, str(conf), out)
        outs[name] = out
    return outs


def _log(out, rank=0):
    with open(os.path.join(out, "cli.rank%d.txt" % rank)) as f:
        return f.read()


def test_cli_four_ranks_grid(cli_runs):
    """The default -y takes a 2 x 2 grid on 4 ranks and says so; -f takes
    the slab; -y 3 stops every rank."""
    assert ("Using a {'x': 2, 'y': 2} device mesh over 4 devices"
            in _log(cli_runs["pencil"]))
    assert ("Using a {'x': 4} device mesh over 4 devices"
            in _log(cli_runs["slab"]))
    for r in range(4):
        assert "SystemExit: -y 3 does not divide 4 devices" in _log(
            cli_runs["y3"], r)
    assert not os.path.exists(os.path.join(cli_runs["y3"], "fastpm_1.0000"))


@pytest.mark.parametrize("name", ["pencil", "slab"])
def test_cli_four_ranks_outputs(cli_runs, name):
    """Snapshots, P(k) lines and the FOF catalog against one rank, within
    the bounds of test_torch_parallel.py's two-rank CLI tests."""
    from fastpm_torch.io.bigfile import BigFile
    from test_torch_parallel import _snapshot
    one, many = cli_runs["one"], cli_runs[name]
    a, b = (_snapshot(os.path.join(o, "fastpm_1.0000")) for o in (one, many))
    np.testing.assert_array_equal(a[0], np.arange(16 ** 3))
    np.testing.assert_array_equal(b[0], a[0])
    dx = b[1] - a[1]
    dx -= np.round(dx / 32.0) * 32.0
    assert np.abs(dx).max() < 1e-4
    assert np.abs(b[2] - a[2]).max() < 1e-4 * a[2].std()
    names = sorted(f for f in os.listdir(one) if f.startswith("powerspec_"))
    assert len(names) == 3
    assert sorted(f for f in os.listdir(many)
                  if f.startswith("powerspec_")) == names
    for f in names:
        p1, p2 = (np.loadtxt(os.path.join(o, f), comments="#")
                  for o in (one, many))
        np.testing.assert_array_equal(p2[:, 2], p1[:, 2])
        np.testing.assert_allclose(p2[:, :2], p1[:, :2], rtol=2e-5)
    lengths = [BigFile(os.path.join(o, "fastpm_1.0000")).open_block(
        "LL-0.200/Length").read_all() for o in (one, many)]
    assert len(lengths[0]) > 0
    np.testing.assert_array_equal(lengths[1], lengths[0])
