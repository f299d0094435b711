"""The options the port runs over ranks, against the JAX package and
against one rank: the neutrino linear response, PGD, rehoming, restart,
and the CLI's lightcone, RFOF and PGD.

The parent computes the JAX oracles on virtual CPU devices and the
port's one-rank runs; the ranks (gloo, tests/torch_rank_workers.py,
which never imports JAX) run on 2 slab ranks and on a 2 x 2 grid, both
started before the oracles and joined after them. Each rank first runs
its physics job (worker.physics), then its CLI runs, each on a process
group of its own. The Fermi-Dirac integral table is computed once, in
the parent, and handed to the ranks.

Covered:
- (a) the linear response's forces (3 forces on fixed positions, the
  third with its cached halo too narrow, so that it is replayed) against
  the JAX package's sharded LRA force, acc by id at atol 1e-5; the
  history took one update per force, and equals the JAX one; a run of
  2 steps against the port's one-rank run (x, v by id; the history at
  rtol 1e-5) and its history against the JAX run's at rtol 0.03
  (tests/test_torch_lra.py's bound);
- (b) PGD's pgdc after one force against the JAX global
  compute_with_alpha on the same positions, within 1e-5 of its largest
  value;
- (e) the rehome body on 2 slab ranks against the JAX package's
  (psolver.py:770, Pallas in interpret mode), two steps: acc by id at
  atol 1e-5, the same rows owned by each rank, every alive row on its
  slab, x and v moved bit for bit, and ids above 2^40 moved exactly
  (the JAX package is no oracle for such ids: it sends them as
  float32); the rehomed Solver against the dense sharded Solver
  (tests/test_sharded_solver.py:95's bounds), and set_snapshot of the
  rehomed store equal to that of its compacted rows;
- (f) the baryon species (tests/test_sharded_solver.py:47-91's case:
  CDM plus a baryon lattice with a mass column, gaussian softening, the
  potential and the tidal tensor) against the port's one-device run by
  id per species (x atol 2e-3, v atol 2e-4; potential and tidal rtol
  2e-3, atol 1e-5), every force through the homed or pencil multi; and
  SolverConfig(order_free=False) (stale_every = 3 and rehome = True
  ignored) with every rank's rows in place, held row by row against the
  one-device run at the same x and v bounds, and no carry force; both
  one-device runs against the JAX Solver on one device from the same
  delta_k (the baryon case by id per species at the bounds above, v at
  2e-4 of its rms; the ordered run row by row in place at 1e-4 of a
  cell and of v's rms, test_torch_solver.py's bounds);
- (c), (d) the CLI on 2 ranks and on a 2 x 2 grid against one rank: the
  reduced lightcone with RFOF and PGD (usmesh rows by id and aemit,
  HEALPix maps, the halo catalogs' lengths and masses, the z = 0
  snapshot's FOF and RFOF catalogs), the linear response's run (the
  snapshots by id, the Neutrino blocks), and on 2 ranks restarts from a
  one-rank run's snapshot, plain and with the linear response, against
  the same restart on one rank.
"""

import contextlib
import io
import os
import pickle
import re
import time

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as PS

import torch_rank_workers as workers
from test_torch_parallel import _free_port, jittered_lattice
from test_torch_lra import LRA_RUN

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
POWERSPEC = os.path.join(FIXTURES, "powerspec.txt")
NC, BOX, SEED = 16, 64.0, 9
LRA_A = (0.2, 0.5, 0.7)          # the three forces of (a)
RUN_STEPS = (0.2, 0.5, 1.0)      # the runs: 2 steps
GRIDS = [(2, 1), (2, 2)]
# ids of the rehome body's rows: above 2^40, so neither float32 nor
# 32 bits hold them
ID_OFFSET = 2 ** 40
TIMEOUT = 400.0

# tests/fixtures/lightcone.lua cut to 16^3 in a box of 48, 4 steps, 8
# tiles, with RFOF, PGD, HEALPix maps at nside 8 and a snapshot
# subsampled to half
LC_LUA = open(os.path.join(FIXTURES, "lightcone.lua")).read()
for _old, _new in (("nc = 64", "nc = 16"), ("boxsize = 512", "boxsize = 48"),
                   ("linspace(0.1, 1, 8)", "linspace(0.1, 1, 4)"),
                   ("{-2, -1, 0, 1}", "{-1, 0}"),
                   ("particle_fraction = 1.0", "particle_fraction = 0.5")):
    assert _old in LC_LUA
    LC_LUA = LC_LUA.replace(_old, _new)
LC_LUA = re.sub(r'read_powerspectrum = ".*"',
                'read_powerspectrum = "%s"' % POWERSPEC, LC_LUA)
LC_LUA += ('write_rfof = "OUTDIR/rfof"\nlc_usmesh_healpix_nside = 8\n'
           'lc_usmesh_nslices = 20\npgdc = true\n')
# LRA_RUN without the neutrinos (restart of the plain physics)
PLAIN_RUN = re.sub(r"(?m)^(T_cmb|N_eff|N_nu|m_ncdm|n_shell|ncdm_\w+) = .*\n",
                   "", LRA_RUN).replace('"ODE"', '"LCDM"')


def _lua(name):
    """The Lua text of run `name` (lc, lra, plain, and the restarts
    lra_r, plain_r), with %(out)s and %(ps)s to fill."""
    base = name.split("_")[0]
    return {"lc": LC_LUA.replace("OUTDIR", "%(out)s"), "lra": LRA_RUN,
            "plain": PLAIN_RUN}[base]


def _write_lua(tmp, name, tag):
    out = os.path.join(str(tmp), "%s.%s" % (name, tag))
    conf = os.path.join(str(tmp), "%s.%s.lua" % (name, tag))
    with open(conf, "w") as f:
        f.write(_lua(name) % dict(out=out, ps=POWERSPEC))
    return conf, out


def _restart_from(tmp, name):
    """A restart's snapshot: the one-rank straight run's at a = 0.6."""
    return os.path.join(str(tmp), "%s.one" % name.split("_")[0],
                        "fastpm_0.6000")


def _start(nproc, inp, out):
    import torch.multiprocessing as mp
    return mp.start_processes(workers.run, args=(nproc, _free_port(),
                                                 "physics", inp, out),
                              nprocs=nproc, join=False, start_method="spawn")


def _join(ctx, nproc):
    deadline = time.monotonic() + TIMEOUT
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError("physics on %d ranks timed out" % nproc)
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)


def _rehome_layout(x, v, ids, nproc, cap, B, id_dtype, dead_id):
    """Each rank's R = cap + 2B rows: its block of x-major rows alive
    first, dead rows after (test_homed_force.py:_padded_layout)."""
    n = len(x) // nproc
    R = cap + 2 * B
    X = np.zeros((nproc * R, 3), np.float32)
    V = np.zeros((nproc * R, 3), np.float32)
    ID = np.full((nproc * R,), dead_id, id_dtype)
    A = np.zeros((nproc * R,), np.uint8)
    for d in range(nproc):
        X[d * R:d * R + n] = x[d * n:(d + 1) * n]
        V[d * R:d * R + n] = v[d * n:(d + 1) * n]
        ID[d * R:d * R + n] = ids[d * n:(d + 1) * n]
        A[d * R:d * R + n] = 1
    return X, V, ID, A


REHOME = dict(H=3, B=2048, shift=np.array([1.7, -0.9, 0.4], np.float32)
              * (BOX / NC))


def _rehome_inputs():
    x = jittered_lattice(NC, BOX, 1.2, 11)
    v = (0.01 * jittered_lattice(NC, BOX, 1.0, 12)).astype(np.float32)
    cap = NC ** 3 // 2 + 2048
    return x, v, cap


# ---- the JAX oracles ---------------------------------------------------


def _jax_mesh(px, py):
    devs = np.array(jax.devices()[:px * py])
    if py == 1:
        return Mesh(devs, ("x",))
    return Mesh(devs.reshape(px, py), ("x", "y"))


def jax_lra_forces(px, py, x):
    """The JAX package's sharded LRA force (its v1 split on the CPU) on
    a (px, py) mesh: acc and id of each force at LRA_A, and the
    history."""
    from fastpm_tpu.solver import Solver, SolverConfig, CDM
    from fastpm_tpu.cosmology import Cosmology
    s = Solver(SolverConfig(nc=NC, boxsize=BOX, time_step=[LRA_A[0], 1.0],
                            pm_nc_factor=1, need_rand=False),
               Cosmology(**workers.LRA_COSMO), mesh=_jax_mesh(px, py))
    s.setup_linear_response(transfer_redshift=4.0)
    p = s.species[CDM]
    stores = [p.replace(x=jax.device_put(
        jnp.asarray(x[np.asarray(p.id)]), p.x.sharding))]
    out = {}
    for i, a in enumerate(LRA_A):
        stores, _dk = s._sharded_lra_force(s.find_pm(a), stores, a)
        out["acc%d" % i] = np.asarray(stores[0].acc)
        out["id%d" % i] = np.asarray(stores[0].id)
    out["scalefact"] = np.asarray(s.lra.scalefact)
    out["delta_tot"] = np.asarray(s.lra.delta_tot)
    return out


def jax_lra_run():
    """The JAX package's LRA run on one device: its history."""
    from fastpm_tpu.solver import Solver, SolverConfig
    from fastpm_tpu.cosmology import Cosmology
    from fastpm_tpu.powerspectrum import FuncK
    from fastpm_tpu import ic
    c = Cosmology(**workers.LRA_COSMO)
    s = Solver(SolverConfig(nc=NC, boxsize=BOX, time_step=list(RUN_STEPS),
                            pm_nc_factor=1, need_rand=False), c)
    s.setup_linear_response(transfer_redshift=4.0)
    dk, _ = ic.linear_field(s.lptpm, c, FuncK.from_file(POWERSPEC),
                            seed=SEED, aout=1.0)
    s.setup_lpt(dk, RUN_STEPS[0])
    s.evolve()
    return np.asarray(s.lra.scalefact), np.asarray(s.lra.delta_tot)


def jax_pgdc(x, a):
    """PGD's column from the JAX global force's delta_k at x."""
    from fastpm_tpu.mesh import PM as JPM
    from fastpm_tpu.gravity import compute_force
    from fastpm_tpu.painter import Painter
    from fastpm_tpu.store import Store
    from fastpm_tpu.pgd import PGDCorrection
    pm = JPM(NC, BOX)
    _, dk = compute_force(pm, Painter(pm, "cic", 2),
                          [Store(x=jnp.asarray(x), M0=1.0)], "1_4")
    pgd = PGDCorrection()
    return np.asarray(pgd.compute_with_alpha(pm, jnp.asarray(x), dk,
                                             pgd.alpha(a)))


def jax_rehome(x, v, cap):
    """The JAX package's rehome body on a mesh of 2 (Pallas in interpret
    mode), two steps as tests/test_homed_force.py:829: each step's
    (x, v, alive, id, acc, bad), ids as uint32."""
    from fastpm_tpu.mesh import PM as JPM
    from fastpm_tpu.parallel.pfft import SlabPM
    from fastpm_tpu.parallel.psolver import (particle_spec,
                                             _force_local_homed_rehome)
    mesh = _jax_mesh(2, 1)
    spm = SlabPM(JPM(NC, BOX), mesh, axis="x")
    spec = particle_spec(mesh)
    H, B = REHOME["H"], REHOME["B"]

    def local(xx, vv, aa, ii):
        xs, vs, alive, extras, acc, bad, _dk = _force_local_homed_rehome(
            spm, xx, vv, aa, (ii,), "1_4", H, B, pallas=True,
            pallas_interpret=True)
        return xs, vs, alive, extras[0], acc, bad

    step = jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(spec,) * 4,
        out_specs=(spec,) * 5 + (PS(),), check_vma=False))
    X, V, ID, A = _rehome_layout(x, v, np.arange(NC ** 3), 2, cap, B,
                                 np.uint32, 2 ** 31 - 1)
    outs = []
    Xo, Vo, Ao, Io, ACC, bad = step(X, V, A, ID)
    outs.append([np.asarray(a) for a in (Xo, Vo, Ao, Io, ACC)] + [int(bad)])
    m = np.asarray(Ao)[:, None] > 0
    X2 = np.where(m, (np.asarray(Xo) + REHOME["shift"]) % BOX, np.asarray(Xo))
    res = step(X2.astype(np.float32), Vo, Ao, Io)
    outs.append([np.asarray(a) for a in res[:5]] + [int(res[5])])
    return outs


# ---- the runs ----------------------------------------------------------


def jax_species_runs():
    """The JAX Solver on one device, from the port's own delta_k (the
    one-device runs' field): the baryon case of species_run and the
    order_free=False run of run_solver; each solver."""
    from fastpm_torch import ic
    from fastpm_torch.cosmology import Cosmology as TCosmology
    from fastpm_torch.powerspectrum import FuncK as TFuncK
    from fastpm_torch.solver import Solver as TSolver, SolverConfig as TConfig
    from fastpm_tpu.solver import Solver, SolverConfig
    from fastpm_tpu.cosmology import Cosmology
    from fastpm_tpu.store import lattice_store
    cosmo = dict(h=0.6774, Omega_m=0.307494, T_cmb=0.0, growth_mode="lcdm")
    kw = dict(nc=NC, boxsize=BOX, time_step=list(RUN_STEPS), pm_nc_factor=1)
    t = TSolver(TConfig(**kw), TCosmology(**cosmo), device="cpu")
    dk, _ = ic.linear_field(t.lptpm, TCosmology(**cosmo),
                            TFuncK.from_file(POWERSPEC), seed=SEED, aout=1.0)
    dk = jnp.asarray(dk.numpy())
    a0 = RUN_STEPS[0]
    out = {}
    s = Solver(SolverConfig(need_rand=False, softening_type="gaussian",
                            compute_potential=True, compute_tidal=True, **kw),
               Cosmology(**cosmo))
    n = (NC // 2) ** 3
    b = lattice_store(s.basepm, Nc=NC // 2, columns=("v", "acc", "id"),
                      name="baryon")
    s.add_species("baryon", b.replace(
        M0=0.3, mass=jnp.full((n,), 0.3, jnp.float32),
        potential=jnp.zeros((n,), jnp.float32),
        tidal=jnp.zeros((n, 6), jnp.float32), a_x=a0, a_v=a0))
    s.setup_lpt(dk, a0)
    s.evolve()
    out["species"] = s
    s = Solver(SolverConfig(need_rand=False, order_free=False, **kw),
               Cosmology(**cosmo))
    s.setup_lpt(dk, a0)
    s.evolve()
    out["ordered"] = s
    return out


def _one_rank_cli(tmp, name):
    from fastpm_torch import cli
    conf, out = _write_lua(tmp, name, "one")
    argv = [conf]
    if name.endswith("_r"):
        argv = ["-r", _restart_from(tmp, name)] + argv
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(argv, device="cpu") == 0
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' physics outputs and CLI directories (by grid), the JAX
    oracles, the one-rank runs and the inputs."""
    from fastpm_torch import cosmology
    tmp = tmp_path_factory.mktemp("ranks_physics")
    tables = str(tmp / "fd_tables.pkl")
    with open(tables, "wb") as f:
        pickle.dump(cosmology._fd_table(), f)
    # the one-rank CLI runs first: the restarts on ranks start from
    # their snapshots
    one = {name: _one_rank_cli(tmp, name)
           for name in ("lc", "lra", "plain", "lra_r", "plain_r")}

    x = jittered_lattice(NC, BOX, 1.2, 21)
    rx, rv, cap = _rehome_inputs()
    ctxs = {}
    for px, py in GRIDS:
        tag = "%dx%d" % (px, py)
        names = (("lc", "lra", "lra_r", "plain_r") if py == 1
                 else ("lc", "lra"))
        cli = []
        for name in names:
            conf, out = _write_lua(tmp, name, tag)
            args = (["-r", _restart_from(tmp, name)]
                    if name.endswith("_r") else [])
            cli.append(" ".join([out] + args + [conf]))
        data = dict(px=px, py=py, nc=NC, box=BOX, x=x,
                    lra_a=np.asarray(LRA_A), run_steps=np.asarray(RUN_STEPS),
                    ps=POWERSPEC, seed=SEED, fd_tables=tables,
                    cli=";".join(cli),
                    cli_ports=np.asarray([_free_port() for _ in cli]))
        if py == 1:
            X, V, ID, A = _rehome_layout(
                rx, rv, ID_OFFSET + np.arange(NC ** 3), 2, cap, REHOME["B"],
                np.int64, -1)
            data.update(rehome_x=X, rehome_v=V, rehome_id=ID,
                        rehome_alive=A, rehome_B=REHOME["B"],
                        rehome_H=REHOME["H"], rehome_shift=REHOME["shift"])
        inp = str(tmp / ("physics.%s.npz" % tag))
        np.savez(inp, **data)
        os.makedirs(str(tmp / tag))
        ctxs[px, py] = (_start(px * py, inp, str(tmp / tag)), data)

    # meanwhile: the JAX oracles and the one-rank Solver runs
    from fastpm_tpu import cosmology as jcosmology
    from fastpm_tpu import neutrinos_lra as jlra
    jtabs = cosmology._fd_table()
    saved = jcosmology._fd_table, jlra._fd_table
    jcosmology._fd_table = jlra._fd_table = lambda: jtabs
    try:
        oracle = {g: jax_lra_forces(*g, x) for g in GRIDS}
        oracle["run"] = jax_lra_run()
    finally:
        jcosmology._fd_table, jlra._fd_table = saved
    oracle["pgdc"] = jax_pgdc(x, 0.5)
    oracle["rehome"] = jax_rehome(rx, rv, cap)
    oracle.update(jax_species_runs())
    one["run"] = workers.run_solver(NC, BOX, RUN_STEPS, POWERSPEC, SEED,
                                    lra_z=4.0)
    one["dense"] = workers.run_solver(NC, BOX, RUN_STEPS, POWERSPEC, SEED)
    one["species"] = workers.species_run(NC, BOX, RUN_STEPS, POWERSPEC, SEED)
    one["ordered"] = workers.run_solver(NC, BOX, RUN_STEPS, POWERSPEC, SEED,
                                        order_free=False)

    ranks = {}
    for g, (ctx, data) in ctxs.items():
        _join(ctx, g[0] * g[1])
        tag = "%dx%d" % g
        ranks[g] = [dict(np.load(str(tmp / tag / ("rank%d.npz" % r))))
                    for r in range(g[0] * g[1])]
    return dict(tmp=tmp, one=one, oracle=oracle, ranks=ranks, x=x,
                rehome_in=(rx, rv, cap))


def _cat(ranks, key):
    return np.concatenate([r[key] for r in ranks])


def _by_id(ids, *cols):
    o = np.argsort(ids, kind="stable")
    return [c[o] for c in cols]


# ---- (a) the linear response -------------------------------------------


@pytest.mark.parametrize("grid", GRIDS)
def test_lra_forces_match_jax(runs, grid):
    """Each force's acc by id against the JAX sharded LRA force at atol
    1e-5; the third force, whose halo was cached too narrow, was
    replayed, and each force updated the history once, at its a_f."""
    ranks, want = runs["ranks"][grid], runs["oracle"][grid]
    for i in range(len(LRA_A)):
        (acc,) = _by_id(_cat(ranks, "lra_id%d" % i),
                        _cat(ranks, "lra_acc%d" % i))
        (jacc,) = _by_id(want["id%d" % i], want["acc%d" % i])
        np.testing.assert_allclose(acc, jacc, atol=1e-5, err_msg=str(i))
    carry = "pencil-carry" if grid[1] > 1 else "homed-carry"
    for r in ranks:
        np.testing.assert_array_equal(r["lra_calls"], LRA_A)
        assert sorted(r["lra_paths"]) == sorted([carry] * 3 + ["overflow"])


@pytest.mark.parametrize("grid", GRIDS)
def test_lra_force_history_matches_jax(runs, grid):
    """The history after the three forces: the same times as the JAX
    package's, the same deltas within rtol 1e-5 (P(k) summed in other
    orders), on every rank."""
    want = runs["oracle"][grid]
    for r in runs["ranks"][grid]:
        np.testing.assert_allclose(r["lra_scalefact"], want["scalefact"],
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(r["lra_delta_tot"], want["delta_tot"],
                                   rtol=1e-5)


@pytest.mark.parametrize("grid", GRIDS)
def test_lra_run_matches_one_rank(runs, grid):
    """A 2-step run with the response against the port's one-rank run:
    x and v by id (test_torch_parallel.py's bounds), the history at rtol
    1e-5; and the history against the JAX package's run at rtol 0.03."""
    ranks, one = runs["ranks"][grid], runs["one"]["run"]
    p = one.species["cdm"]
    x0, v0 = _by_id(p.id.numpy(), p.x.numpy(), p.v.numpy())
    x, v = _by_id(_cat(ranks, "run_id"), _cat(ranks, "run_x"),
                  _cat(ranks, "run_v"))
    np.testing.assert_allclose(x, x0, atol=2e-3)
    np.testing.assert_allclose(v, v0, atol=2e-4)
    jsf, jdt = runs["oracle"]["run"]
    for r in ranks:
        assert len(r["run_scalefact"]) == len(one.lra.scalefact) == 3
        np.testing.assert_allclose(r["run_scalefact"], one.lra.scalefact,
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(r["run_delta_tot"],
                                   np.asarray(one.lra.delta_tot), rtol=1e-5)
        np.testing.assert_allclose(r["run_scalefact"], jsf, rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(r["run_delta_tot"], jdt, rtol=0.03)
        assert set(r["run_paths"]) <= {"homed-carry", "pencil-carry",
                                       "overflow", "v1"}


# ---- (b) PGD -----------------------------------------------------------


@pytest.mark.parametrize("grid", GRIDS)
def test_pgd_matches_jax(runs, grid):
    """pgdc after one force at a = 0.5 against the JAX global
    compute_with_alpha on the same positions, within 1e-5 of its largest
    value; the force took the homed carry, whose K2 read PGD's fields."""
    ranks, want = runs["ranks"][grid], runs["oracle"]["pgdc"]
    (got,) = _by_id(_cat(ranks, "pgd_id"), _cat(ranks, "pgdc"))
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    carry = "pencil-carry" if grid[1] > 1 else "homed-carry"
    for r in ranks:
        assert list(r["pgd_paths"]) == [carry]


# ---- (e) rehoming ------------------------------------------------------


@pytest.mark.parametrize("step", [1, 2])
def test_rehome_body_matches_jax(runs, step):
    """The rehome body on 2 slab ranks against the JAX package's: no
    overflow, every particle once, acc by id at atol 1e-5, x and v moved
    bit for bit, the same ids owned by each rank and each alive row on
    its rank's slab; the int64 ids above 2^40 arrive exact."""
    ranks = runs["ranks"][2, 1]
    jx, jv, jalive, jid, jacc, jbad = runs["oracle"]["rehome"][step - 1]
    assert jbad == 0
    key = "rehome%d_" % step
    R = len(ranks[0][key + "x"])
    cell = BOX / NC
    owned = []
    for rank, r in enumerate(ranks):
        assert int(r[key + "bad"]) == 0
        m = r[key + "alive"] > 0
        ids = r[key + "id"][m]
        assert ids.dtype == np.int64 and (ids >= ID_OFFSET).all()
        jm = jalive[rank * R:(rank + 1) * R] > 0
        np.testing.assert_array_equal(
            np.sort(ids - ID_OFFSET),
            np.sort(jid[rank * R:(rank + 1) * R][jm].astype(np.int64)))
        bx = np.floor(r[key + "x"][m][:, 0] / cell) % NC
        assert ((bx >= rank * NC // 2) & (bx < (rank + 1) * NC // 2)).all()
        owned.append(m)
    m = np.concatenate(owned)
    ids = _cat(ranks, key + "id")[m] - ID_OFFSET
    np.testing.assert_array_equal(np.sort(ids), np.arange(NC ** 3))
    jm = jalive > 0
    x, v, acc = _by_id(ids, _cat(ranks, key + "x")[m],
                       _cat(ranks, key + "v")[m], _cat(ranks, key + "acc")[m])
    wx, wv, wacc = _by_id(jid[jm].astype(np.int64), jx[jm], jv[jm], jacc[jm])
    np.testing.assert_array_equal(x, wx)
    np.testing.assert_array_equal(v, wv)
    np.testing.assert_allclose(acc, wacc, atol=1e-5)


def test_rehome_solver_matches_dense(runs):
    """SolverConfig(rehome=True) on 2 slab ranks against the dense
    sharded Solver (x atol 1e-4, v atol 2e-5, by id), every force
    through the rehome body; set_snapshot of the rehomed store (dead
    rows in it) equals set_snapshot of its compacted rows."""
    ranks = runs["ranks"][2, 1]
    x0, v0 = _by_id(_cat(ranks, "solver_dense_id"),
                    _cat(ranks, "solver_dense_x"),
                    _cat(ranks, "solver_dense_v"))
    ids = _cat(ranks, "solver_rehomed_id")
    np.testing.assert_array_equal(np.sort(ids), np.arange(NC ** 3))
    x, v = _by_id(ids, _cat(ranks, "solver_rehomed_x"),
                  _cat(ranks, "solver_rehomed_v"))
    np.testing.assert_allclose(x, x0, atol=1e-4)
    np.testing.assert_allclose(v, v0, atol=2e-5)
    for r in ranks:
        assert list(r["solver_rehomed_paths"]) == ["homed-rehome"] * 3
        assert int(r["solver_rehomed_rows"]) > len(r["solver_rehomed_id"])
        for c in ("x", "v", "id"):
            np.testing.assert_array_equal(r["snap_" + c],
                                          r["snap_compact_" + c])


# ---- (f) baryons and order-preserving stepping ----------------------------


def _multi(grid):
    return "pencil-multi" if grid[1] > 1 else "homed-multi"


@pytest.mark.parametrize("grid", GRIDS)
def test_baryon_run_matches_one_device(runs, grid):
    """CDM and baryons over the ranks against the one-device run, by id
    per species; the forces through the multi body of the decomposition
    (a replay after a halo overflow, and the v1 body where no halo width
    fits at z = 0, allowed), never the carry."""
    ranks, one = runs["ranks"][grid], runs["one"]["species"]
    for name in ("baryon", "cdm"):
        p = one.species[name]
        ids0 = p.id.numpy()
        want = _by_id(ids0, *(getattr(p, c).numpy() for c in
                              ("x", "v", "potential", "tidal")))
        key = "species_%s_" % name
        ids = _cat(ranks, key + "id")
        np.testing.assert_array_equal(np.sort(ids), np.sort(ids0))
        got = _by_id(ids, *(_cat(ranks, key + c) for c in
                            ("x", "v", "potential", "tidal")))
        dx = got[0] - want[0]
        dx -= np.round(dx / BOX) * BOX
        assert np.abs(dx).max() < 2e-3, name
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=2e-4,
                                   err_msg=name)
        for g, w, c in zip(got[2:], want[2:], ("potential", "tidal")):
            assert np.abs(w).max() > 0
            np.testing.assert_allclose(g, w, rtol=2e-3, atol=1e-5,
                                       err_msg=name + " " + c)
    for r in ranks:
        paths = list(r["species_paths"])
        assert _multi(grid) in paths and set(paths) <= {
            _multi(grid), "overflow", "v1"}, paths


@pytest.mark.parametrize("grid", GRIDS)
def test_order_preserving_run_matches_one_device(runs, grid):
    """order_free=False over the ranks: each rank's rows are where a
    fresh Solver put them (x-major on the slab, pencil-blocked on the
    2 x 2 grid), x and v row by row against the one-device run, whose
    rows are in id order; the forces as in the baryon run, never the
    carry."""
    from fastpm_torch.mesh import PM
    from fastpm_torch.store import lattice_store
    ranks, one = runs["ranks"][grid], runs["one"]["ordered"]
    p = one.species["cdm"]
    np.testing.assert_array_equal(p.id.numpy(), np.arange(NC ** 3))
    assert dict(one.force_paths) == {"multi": len(RUN_STEPS)}
    blocks = grid if grid[1] > 1 else None
    rows = lattice_store(PM(NC, BOX, device="cpu"), Nc=NC,
                         blocks=blocks).id.numpy()
    ids = _cat(ranks, "ordered_id")
    np.testing.assert_array_equal(ids, rows)
    dx = _cat(ranks, "ordered_x") - p.x.numpy()[ids]
    dx -= np.round(dx / BOX) * BOX
    assert np.abs(dx).max() < 2e-3
    np.testing.assert_allclose(_cat(ranks, "ordered_v"), p.v.numpy()[ids],
                               rtol=0, atol=2e-4)
    for r in ranks:
        paths = list(r["ordered_paths"])
        assert _multi(grid) in paths and set(paths) <= {
            _multi(grid), "overflow", "v1"}, paths


@pytest.mark.parametrize("case", ["species", "ordered"])
def test_one_device_species_runs_match_jax(runs, case):
    """The one-device runs that (f) holds the ranks against, against the
    JAX Solver from the same delta_k: the baryon case by id per species,
    the order-preserving run row by row with the rows in place in
    both."""
    s, js = runs["one"][case], runs["oracle"][case]
    names = ("baryon", "cdm") if case == "species" else ("cdm",)
    assert tuple(s.iter_species()) == names
    for name in names:
        p, jp = s.species[name], js.species[name]
        cols = ("x", "v") + (("potential", "tidal") if case == "species"
                             else ())
        ids, jids = p.id.numpy(), np.asarray(jp.id)
        if case == "ordered":
            np.testing.assert_array_equal(ids, np.arange(NC ** 3))
            np.testing.assert_array_equal(jids, ids)
            got = [getattr(p, c).numpy() for c in cols]
            want = [np.asarray(getattr(jp, c)) for c in cols]
            xtol, vtol = 1e-4 * BOX / NC, 1e-4
        else:
            np.testing.assert_array_equal(np.sort(ids), np.sort(jids))
            got = _by_id(ids, *(getattr(p, c).numpy() for c in cols))
            want = _by_id(jids, *(np.asarray(getattr(jp, c)) for c in cols))
            xtol, vtol = 2e-3, 2e-4
        dx = got[0] - want[0]
        dx -= np.round(dx / BOX) * BOX
        assert np.abs(dx).max() < xtol, name
        assert np.abs(got[1] - want[1]).max() < vtol * want[1].std(), name
        for g, w, c in zip(got[2:], want[2:], cols[2:]):
            assert np.abs(w).max() > 0
            np.testing.assert_allclose(g, w, rtol=2e-3, atol=1e-5,
                                       err_msg=name + " " + c)


# ---- (c), (d) the CLI ----------------------------------------------------


def _cli_dir(runs, name, grid):
    out = os.path.join(str(runs["tmp"]), "%s.%dx%d" % ((name,) + grid))
    for r in range(grid[0] * grid[1]):
        text = open(os.path.join(out, "cli.rank%d.txt" % r)).read()
        assert "SystemExit" not in text and "Traceback" not in text, text
    return out


def _snapshot(path, columns=("Position", "Velocity")):
    from fastpm_torch.io.bigfile import BigFile
    bf = BigFile(path)
    ids = bf.open_block("1/ID").read_all().reshape(-1)
    o = np.argsort(ids)
    return [ids[o]] + [bf.open_block("1/" + c).read_all()[o]
                       for c in columns]


def _usmesh(path):
    from fastpm_torch.io.bigfile import BigFile
    bf = BigFile(path)
    ids = bf.open_block("1/ID").read_all().reshape(-1)
    aemit = bf.open_block("1/Aemit").read_all()
    # a particle crosses once in each tile it reaches: id, then aemit
    o = np.lexsort((aemit, ids))
    out = {k: bf.open_block("1/" + k).read_all()[o]
           for k in ("ID", "Aemit", "Position", "Velocity", "Rand")}
    out["size"] = bf.open_block("1").attrs.get("aemitIndex.size")
    out["Header"] = bf.open_block("Header").attrs.get("TotNumPart")
    for k in ("ID", "Mass", "Rmom"):
        out["HEALPIX/" + k] = bf.open_block("HEALPIX/" + k).read_all()
    for ds in ("LL-0.200", "RFOF"):
        for k in ("Length", "MinID"):
            out["%s/%s" % (ds, k)] = bf.open_block(
                "%s/%s" % (ds, k)).read_all()
    return out


@pytest.mark.parametrize("grid", GRIDS)
def test_cli_lightcone_rfof_pgd(runs, grid):
    """The lightcone with RFOF and PGD through cli.main on ranks against
    one rank: the usmesh rows by id and aemit (ids, Rand and the slices'
    sizes equal, Aemit, Position and Velocity within rtol 1e-5), the
    HEALPix maps (pixels equal, Mass and Rmom at rtol 1e-5), the
    lightcone FOF and RFOF catalogs (lengths and MinID equal, as sets),
    and the z = 0 snapshot's FOF and RFOF catalogs (MinID and Length
    equal, Position within 1e-3 Mpc/h)."""
    from fastpm_torch.io.bigfile import BigFile
    one = runs["one"]["lc"]
    got_dir = _cli_dir(runs, "lc", grid)
    a, b = (_usmesh(os.path.join(d, "usmesh")) for d in (one, got_dir))
    assert len(a["ID"]) > 1000 and len(a["RFOF/Length"]) > 0
    assert len(a["LL-0.200/Length"]) > 0
    np.testing.assert_array_equal(b["Header"], a["Header"])
    for k in ("ID", "Rand", "size", "HEALPIX/ID"):
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    for k in ("Aemit", "Position", "Velocity", "HEALPIX/Mass",
              "HEALPIX/Rmom"):
        np.testing.assert_allclose(b[k], a[k], rtol=1e-5,
                                   atol=1e-5 * np.abs(a[k]).max(), err_msg=k)
    for ds in ("LL-0.200", "RFOF"):
        pairs = [sorted(zip(c["%s/MinID" % ds], c["%s/Length" % ds]))
                 for c in (a, b)]
        assert pairs[1] == pairs[0], ds
    for f, ds in (("fof_1.0000", "LL-0.200"), ("rfof_1.0000", "RFOF")):
        cats = []
        for d in (one, got_dir):
            bf = BigFile(os.path.join(d, f))
            minid = bf.open_block(ds + "/MinID").read_all()
            o = np.argsort(minid)
            cats.append([minid[o]] + [bf.open_block(ds + "/" + k).read_all()[o]
                                      for k in ("Length", "Position")])
        assert len(cats[0][0]) > 0
        np.testing.assert_array_equal(cats[1][0], cats[0][0], err_msg=f)
        np.testing.assert_array_equal(cats[1][1], cats[0][1], err_msg=f)
        np.testing.assert_allclose(cats[1][2], cats[0][2], rtol=0,
                                   atol=1e-3, err_msg=f)


def _neutrino(path):
    from fastpm_torch.io.bigfile import BigFile
    bf = BigFile(path)
    return (np.asarray(bf.open_block("Neutrino").attrs.get("scalefact")),
            bf.open_block("Neutrino/Deltas").read_all())


def _check_snapshots(got, want, a, v_atol):
    """Two snapshots by id: positions within 2e-3 Mpc/h, internal
    velocities (the snapshot's km/s times a / 100) within v_atol."""
    g, w = (_snapshot(os.path.join(d, "fastpm_" + a)) for d in (got, want))
    np.testing.assert_array_equal(g[0], w[0])
    np.testing.assert_array_equal(w[0], np.arange(NC ** 3))
    dx = g[1] - w[1]
    dx -= np.round(dx / BOX) * BOX
    assert np.abs(dx).max() < 2e-3
    np.testing.assert_allclose(g[2] * float(a) / 100.0,
                               w[2] * float(a) / 100.0, rtol=0, atol=v_atol)


@pytest.mark.parametrize("grid", GRIDS)
def test_cli_lra_run_matches_one_rank(runs, grid):
    """The linear response's run through cli.main on ranks against one
    rank: both snapshots by id, and their Neutrino blocks (the times
    equal, the deltas at rtol 1e-5)."""
    one, got = runs["one"]["lra"], _cli_dir(runs, "lra", grid)
    for a in ("0.6000", "1.0000"):
        _check_snapshots(got, one, a, 2e-4)
        (sf1, d1), (sf2, d2) = (_neutrino(os.path.join(d, "fastpm_" + a))
                                for d in (one, got))
        np.testing.assert_array_equal(sf2, sf1)
        np.testing.assert_allclose(d2, d1, rtol=1e-5)


@pytest.mark.parametrize("name", ["plain_r", "lra_r"])
def test_cli_restart_two_ranks(runs, name):
    """-r on 2 ranks from a one-rank run's a = 0.6 snapshot against the
    same restart on one rank: the final snapshot by id (x atol 2e-3, v
    atol 2e-4), no snapshot rewritten at the restart time, and with the
    linear response the history resumed and equal."""
    one, got = runs["one"][name], _cli_dir(runs, name, (2, 1))
    _check_snapshots(got, one, "1.0000", 2e-4)
    assert not os.path.exists(os.path.join(got, "fastpm_0.6000"))
    log = open(os.path.join(got, "cli.rank0.txt")).read()
    assert "Restarting from" in log
    if name == "lra_r":
        assert "Restored neutrino linear-response state" in log
        (sf1, d1), (sf2, d2) = (_neutrino(os.path.join(d, "fastpm_1.0000"))
                                for d in (one, got))
        assert len(sf1) == 5
        np.testing.assert_array_equal(sf2, sf1)
        np.testing.assert_allclose(d2, d1, rtol=1e-5)
