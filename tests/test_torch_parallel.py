"""The port's slab-decomposed force over gloo ranks against the JAX
package's shard_map force on as many virtual CPU devices.

The parent computes the JAX oracles on jax.devices()[:P] and hands the
inputs to P gloo ranks (torch.multiprocessing, spawn) through an .npz;
the ranks run tests/torch_rank_workers.py, which never imports JAX, and
write their rows back. Each rank holds its contiguous block of the rows,
as the JAX package's index-sharded arrays do, so the ranks' outputs
concatenated in rank order are the JAX arrays. Covered, at P = 2 and 4:
comm.Ring's collectives (and P = 1 without a group); SlabPM's FFTs and
shard transfers; the homed force with both homed kernels (halo widths
1-3, particles 2.5 cells across slabs, multi-hop halos, a mass column,
the overflow count); the homed carry; the v1 force and its public
entry points (sharded_force_fn, make_sharded_step); the sharded Solver
against the port's one-rank Solver with the overflow replay; the CLI on
2 ranks against one. The homed kernels' plain versions are held against
the Pallas factories in interpret mode in-process.

Tolerances are the JAX tests' (test_homed_force.py, test_parallel.py):
the two sides sum in other orders (paint, FFT, halo adds).
"""

import os
import socket
import time

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as PS

from fastpm_tpu.mesh import PM as JPM
from fastpm_tpu.parallel.pfft import SlabPM as JSlabPM
from fastpm_tpu.parallel import psolver as jps

import torch_rank_workers as workers
from fastpm_torch.ops import cic
from fastpm_torch.parallel.comm import Ring

NC, BOX = 32, 64.0               # the homed force cases
FFT_NC, FFT_BOX = 16, 32.0       # SlabPM and v1 (test_parallel.py)
POWERSPEC = os.path.join(os.path.dirname(__file__), "fixtures",
                         "powerspec.txt")
# the sharded Solver (test_sharded_solver.py:19-44)
SOLVER = dict(nc=16, box=64.0, steps=(0.3, 0.6, 1.0), seed=7)
# make_sharded_step's kick and drift factors (dda, dyyy)
STEP_COEFFS = (0.05, 0.02)
TIMEOUT = 240.0


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(nproc, job, inp, out):
    """Run torch_rank_workers.run on nproc gloo ranks; raise if one fails
    or the whole takes longer than TIMEOUT."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(workers.run, args=(nproc, _free_port(), job,
                                                inp, out),
                             nprocs=nproc, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError("%s on %d ranks timed out" % (job, nproc))
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)


def jittered_lattice(nc, box, jitter_cells, seed):
    """nc^3 particles in x-major lattice order, displaced by up to
    jitter_cells cells, wrapped (test_homed_force.py:21-29)."""
    cell = box / nc
    g = np.arange(nc) * cell
    q = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    rng = np.random.RandomState(seed)
    x = q + jitter_cells * cell * rng.uniform(-1, 1, q.shape)
    return (x % box).astype(np.float32)


def homed_cases(nproc):
    """name -> (positions, H, mass column or None). nloc = 16 / 8."""
    cases = {}
    for name, (jit, seed, H) in {
            "h1": (0.9, 3, 1), "h2": (0.9, 3, 2), "h3": (0.9, 3, 3),
            "cross": (2.5, 5, 3)}.items():
        cases[name] = (jittered_lattice(NC, BOX, jit, seed), H, None)
    if nproc == 2:
        cases["wide"] = (jittered_lattice(NC, BOX, 6.5, 9), 7, None)
    else:       # H >= nloc: the halo spans two slabs
        for H in (8, 11):
            cases["hop%d" % H] = (jittered_lattice(NC, BOX, 6.5, 9), H, None)
    mass = (0.5 + np.random.RandomState(7).rand(NC ** 3)).astype(np.float32)
    cases["mass"] = (jittered_lattice(NC, BOX, 1.2, 33), 3, mass)
    # the first particle of slab 0 pushed 6 planes beyond the slab's
    # right edge, H = 1
    x = jittered_lattice(NC, BOX, 0.0, 0)
    x[0, 0] = (x[0, 0] + (NC // nproc + 5) * BOX / NC) % BOX
    cases["overflow"] = (x, 1, None)
    return cases


def jax_oracles(nproc, cases, fft_field, carry, v1_x, v1_v):
    """The JAX package's results on nproc virtual devices."""
    mesh = Mesh(np.array(jax.devices()[:nproc]), ("x",))
    spec = PS("x")
    out = {}

    fpm = JPM(FFT_NC, FFT_BOX)
    fspm = JSlabPM(fpm, mesh, axis="x")

    def fft_local(a):
        dk = fspm.r2c_local(a)
        t = fspm.apply_decic(fspm.apply_grad(fspm.apply_pot(dk, 1), 1, 1))
        return dk, t
    dk, t = jax.jit(jax.shard_map(fft_local, mesh=mesh, in_specs=spec,
                                  out_specs=(PS(None, "x"),) * 2))(
        jnp.asarray(fft_field))
    out["fft_dk"], out["fft_transfer"] = np.asarray(dk), np.asarray(t)

    spm = JSlabPM(JPM(NC, BOX), mesh, axis="x")
    for name, (x, H, mass) in cases.items():
        def local(xx, mm, H=H, has_mass=mass is not None):
            outs, bad, _dk = jps._force_local_homed_multi(
                spm, (xx,), (mm if has_mass else 1.0,), "1_4", H)
            return outs[0]["acc"], bad
        m = mass if mass is not None else np.ones(len(x), np.float32)
        acc, bad = jax.jit(jax.shard_map(
            local, mesh=mesh, in_specs=(spec, spec),
            out_specs=(spec, PS())))(jnp.asarray(x), jnp.asarray(m))
        out[name + "_acc"], out[name + "_bad"] = np.asarray(acc), int(bad)

    def carry_local(xx, vv, ii):
        xs, vs, ex, acc, bad, _dk = jps._force_local_homed_carry(
            spm, xx, vv, (ii,), "1_4", carry["H"], pallas=True,
            pallas_interpret=True)
        return xs, vs, ex[0], acc, bad
    res = jax.jit(jax.shard_map(
        carry_local, mesh=mesh, in_specs=(spec,) * 3,
        out_specs=(spec,) * 4 + (PS(),), check_vma=False))(
        jnp.asarray(carry["x"]), jnp.asarray(carry["v"]),
        jnp.asarray(carry["id"].astype(np.uint32)))
    out["carry"] = [np.asarray(a) for a in res]
    x = carry["x"]
    out["carry_xla"] = np.asarray(jax.jit(jax.shard_map(
        lambda xx: jps._force_local_homed(spm, xx, "1_4", carry["H"])[0],
        mesh=mesh, in_specs=spec, out_specs=spec))(jnp.asarray(x)))

    out["v1_acc"] = np.asarray(jps.sharded_force_fn(fpm, mesh)(
        jnp.asarray(v1_x)))
    # the step donates x and v: fresh arrays
    out["step"] = [np.asarray(a) for a in jps.make_sharded_step(fpm, mesh)(
        jnp.asarray(v1_x), jnp.asarray(v1_v), jnp.asarray(STEP_COEFFS))]
    return out


def _cat(ranks, key, axis=0):
    return np.concatenate([r[key] for r in ranks], axis=axis)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """P -> (the JAX oracles, the inputs, the ranks' outputs), computed
    on first use."""
    cache = {}

    def get(nproc):
        if nproc in cache:
            return cache[nproc]
        tmp = tmp_path_factory.mktemp("ranks%d" % nproc)
        rng = np.random.RandomState(0)
        cases = homed_cases(nproc)
        fft_field = rng.normal(size=(FFT_NC,) * 3).astype(np.float32)
        carry = dict(x=jittered_lattice(NC, BOX, 2.0, 7),
                     v=0.01 * jittered_lattice(NC, BOX, 1.0, 8),
                     id=np.arange(NC ** 3, dtype=np.int64), H=3)
        v1_x = (rng.uniform(size=(4096, 3)) * FFT_BOX).astype(np.float32)
        v1_v = rng.normal(size=(4096, 3)).astype(np.float32)
        data = dict(fft_field=fft_field, fft_box=FFT_BOX, force_nc=NC,
                    force_box=BOX, cases=" ".join(cases), v1_x=v1_x,
                    v1_v=v1_v, step_coeffs=np.float32(STEP_COEFFS),
                    v1_nc=FFT_NC, v1_box=FFT_BOX, carry_x=carry["x"],
                    carry_v=carry["v"], carry_id=carry["id"],
                    carry_H=carry["H"])
        for name, (x, H, mass) in cases.items():
            data[name + "_x"], data[name + "_H"] = x, H
            if mass is not None:
                data[name + "_mass"] = mass
        if nproc == 4:
            data.update(solver_nc=SOLVER["nc"], solver_box=SOLVER["box"],
                        solver_steps=np.asarray(SOLVER["steps"]),
                        solver_ps=POWERSPEC, solver_seed=SOLVER["seed"],
                        replay_x=jittered_lattice(SOLVER["nc"],
                                                  SOLVER["box"], 2.5, 11))
        inp = str(tmp / "inputs.npz")
        np.savez(inp, **data)
        spawn(nproc, "cases", inp, str(tmp))
        ranks = [dict(np.load(str(tmp / ("rank%d.npz" % r))))
                 for r in range(nproc)]
        oracle = jax_oracles(nproc, cases, fft_field, carry, v1_x, v1_v)
        cache[nproc] = (oracle, data, ranks)
        return cache[nproc]
    return get


def _check_ring_ops(res, P):
    """res: each rank's ring_ops output."""
    s = P * (P + 1) // 2
    for r, out in enumerate(res):
        for m in range(-P, P + 1):
            np.testing.assert_array_equal(
                out["ppermute_%d" % m],
                np.arange(6) + 100 * ((r - m) % P), err_msg="hop %d" % m)
        np.testing.assert_array_equal(out["psum"], np.arange(4) * s)
        assert float(out["psum_scalar"]) == s
        np.testing.assert_array_equal(out["pmax"], [P - 1, 0])
        want = np.repeat(10 * np.arange(P) + r, 3)[None, :].repeat(2, 0)
        np.testing.assert_array_equal(out["all_to_all"], want)
        want = (10 * np.arange(P) + r)[:, None].repeat(2, 1)
        np.testing.assert_array_equal(out["all_to_all_complex"],
                                      want - 1j * want)
        np.testing.assert_array_equal(
            out["psum_scatter"],
            (np.arange(6 * P).reshape(2 * P, 3) * s)[2 * r:2 * r + 2])
        np.testing.assert_array_equal(
            out["all_gather"], np.repeat(np.arange(P), 2)[:, None]
            .repeat(3, 1))
    np.testing.assert_array_equal(
        res[0]["gather_rows"],
        np.repeat(np.arange(P), np.arange(1, P + 1))[:, None].repeat(2, 1))


@pytest.mark.parametrize("nproc", [1, 2, 4])
def test_ring_collectives(runs, nproc):
    if nproc == 1:
        # one rank, no process group: every hop is a local copy
        out = {k: (v.numpy() if torch.is_tensor(v) else v)
               for k, v in workers.ring_ops(Ring()).items()}
        _check_ring_ops([out], 1)
    else:
        _check_ring_ops(runs(nproc)[2], nproc)


@pytest.mark.parametrize("nproc", [2, 4])
def test_slab_fft_matches_jax(runs, nproc):
    oracle, data, ranks = runs(nproc)
    np.testing.assert_allclose(_cat(ranks, "fft_dk", axis=1),
                               oracle["fft_dk"], atol=1e-5)
    np.testing.assert_allclose(_cat(ranks, "fft_back"), data["fft_field"],
                               atol=1e-4)
    np.testing.assert_allclose(_cat(ranks, "fft_transfer", axis=1),
                               oracle["fft_transfer"], atol=1e-5)


FORCE_CASES = [(2, c) for c in ("h1", "h2", "h3", "cross", "wide", "mass")] \
    + [(4, c) for c in ("h1", "h2", "h3", "cross", "hop8", "hop11", "mass")]


@pytest.mark.parametrize("hk", workers.HOMED_KERNELS)
@pytest.mark.parametrize("nproc,case", FORCE_CASES)
def test_homed_force_matches_jax(runs, nproc, case, hk):
    oracle, data, ranks = runs(nproc)
    assert oracle[case + "_bad"] == 0
    for r in ranks:
        assert int(r["%s_%s_bad" % (case, hk)]) == 0
    np.testing.assert_allclose(_cat(ranks, "%s_%s_acc" % (case, hk)),
                               oracle[case + "_acc"], atol=1e-5)


@pytest.mark.parametrize("hk", workers.HOMED_KERNELS)
@pytest.mark.parametrize("nproc", [2, 4])
def test_homed_overflow_counted(runs, nproc, hk):
    """A particle 6 planes beyond its slab with H = 1 is dropped and
    counted on every rank (the global count), as in JAX."""
    oracle, _data, ranks = runs(nproc)
    assert oracle["overflow_bad"] >= 1
    for r in ranks:
        assert int(r["overflow_%s_bad" % hk]) == oracle["overflow_bad"]


@pytest.mark.parametrize("hk", workers.HOMED_KERNELS)
@pytest.mark.parametrize("nproc", [2, 4])
def test_homed_carry_matches_jax(runs, nproc, hk):
    """The order-free carry against JAX's (Pallas kernels in interpret
    mode): the id -> (x, v, acc) map, x and v moved bit-exactly."""
    oracle, data, ranks = runs(nproc)
    _jx, _jv, jid, jacc, jbad = oracle["carry"]
    assert int(jbad) == 0
    for r in ranks:
        assert int(r["carry_%s_bad" % hk]) == 0
    ids = _cat(ranks, "carry_%s_id" % hk)
    o, jo = np.argsort(ids, kind="stable"), np.argsort(jid, kind="stable")
    np.testing.assert_array_equal(ids[o], data["carry_id"])
    np.testing.assert_array_equal(_cat(ranks, "carry_%s_x" % hk)[o],
                                  data["carry_x"])
    np.testing.assert_array_equal(_cat(ranks, "carry_%s_v" % hk)[o],
                                  data["carry_v"])
    acc = _cat(ranks, "carry_%s_acc" % hk)[o]
    # against the exact f32 XLA homed force at the carry's bounds, and
    # against the Pallas kernels' bf16 hi + lo split weights (good to
    # ~2^-17 of a weight) at the bound test_torch_cic.py holds them to
    np.testing.assert_allclose(acc, oracle["carry_xla"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(acc, jacc[jo], rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("nproc", [2, 4])
def test_v1_force_matches_jax(runs, nproc):
    oracle, _data, ranks = runs(nproc)
    np.testing.assert_allclose(_cat(ranks, "v1_acc"), oracle["v1_acc"],
                               atol=2e-5)


@pytest.mark.parametrize("nproc", [2, 4])
def test_sharded_force_fn_matches_jax(runs, nproc):
    """The public entry point over the v1 body, against the JAX
    package's sharded_force_fn (the v1 bound)."""
    oracle, _data, ranks = runs(nproc)
    np.testing.assert_allclose(_cat(ranks, "sharded_acc"), oracle["v1_acc"],
                               atol=2e-5)


@pytest.mark.parametrize("nproc", [2, 4])
def test_make_sharded_step_matches_jax(runs, nproc):
    """One step (force, kick, drift, wrap) against the JAX package's
    make_sharded_step: acc and v within the v1 bound; x as the distance
    on the periodic box, which a row on a face may cross on one side."""
    oracle, _data, ranks = runs(nproc)
    jx, jv, jacc = oracle["step"]
    np.testing.assert_allclose(_cat(ranks, "step_acc"), jacc, atol=2e-5)
    np.testing.assert_allclose(_cat(ranks, "step_v"), jv, atol=2e-5)
    x = _cat(ranks, "step_x")
    assert x.min() >= 0 and x.max() < FFT_BOX
    dx = x - jx
    dx -= np.round(dx / FFT_BOX) * FFT_BOX
    np.testing.assert_allclose(dx, 0, atol=2e-5)


def _by_id(ids, *cols):
    o = np.argsort(ids)
    return [c[o] for c in cols]


def test_sharded_solver_matches_one_rank(runs):
    """4 ranks against the port's own one-rank Solver (itself held
    against JAX in test_torch_solver.py), by id; every force step took
    the homed carry."""
    _oracle, _data, ranks = runs(4)
    one = workers.run_solver(SOLVER["nc"], SOLVER["box"], SOLVER["steps"],
                             POWERSPEC, SOLVER["seed"])
    p = one.species["cdm"]
    x0, v0 = _by_id(p.id.numpy(), p.x.numpy(), p.v.numpy())
    x, v = _by_id(_cat(ranks, "solver_id"), _cat(ranks, "solver_x"),
                  _cat(ranks, "solver_v"))
    np.testing.assert_allclose(x, x0, atol=2e-3)
    np.testing.assert_allclose(v, v0, atol=2e-4)
    nforce = len(SOLVER["steps"])
    assert dict(one.force_paths) == {"carry": nforce}
    for r in ranks:
        # a halo measured at a = 0.3 may overflow later: the force is
        # then measured again and replayed
        paths = list(r["solver_paths"])
        assert paths.count("homed-carry") == nforce
        assert set(paths) <= {"homed-carry", "overflow"}


def test_cola_solver_two_ranks_matches_one_rank(tmp_path):
    """Force mode cola at 16^3 on 2 gloo ranks against the port's
    one-rank run, by id (the sharded fastpm Solver's bounds); dx1 rides
    the slab force's row permutations unchanged."""
    data = dict(nc=16, box=64.0, steps=np.asarray([0.2, 0.5, 1.0]),
                ps=POWERSPEC, seed=5)
    inp = str(tmp_path / "inputs.npz")
    np.savez(inp, **data)
    spawn(2, "cola", inp, str(tmp_path))
    ranks = [dict(np.load(str(tmp_path / ("rank%d.npz" % r))))
             for r in range(2)]
    one = workers.run_solver(16, 64.0, data["steps"], POWERSPEC, 5,
                             force_mode="cola")
    p = one.species["cdm"]
    x0, v0, d0 = _by_id(p.id.numpy(), p.x.numpy(), p.v.numpy(),
                        p.dx1.numpy())
    x, v, d = _by_id(_cat(ranks, "id"), _cat(ranks, "x"), _cat(ranks, "v"),
                     _cat(ranks, "dx1"))
    np.testing.assert_array_equal(d, d0)
    np.testing.assert_allclose(x, x0, atol=2e-3)
    np.testing.assert_allclose(v, v0, atol=2e-4)
    for r in ranks:
        assert set(r["paths"]) <= {"homed-carry", "overflow"}


def test_solver_replays_overflow(runs):
    """A cached halo of 2 planes with particles 3 planes out: the force
    is discarded, the halo measured again (4) and the force replayed; it
    equals the single-device force."""
    from fastpm_torch.mesh import PM
    from fastpm_torch.painter import Painter
    from fastpm_torch.store import Store
    from fastpm_torch.gravity import compute_force
    _oracle, data, ranks = runs(4)
    for r in ranks:
        assert list(r["replay_paths"]) == ["homed-carry", "overflow"]
        assert int(r["replay_H"]) == 4
    x = torch.from_numpy(data["replay_x"])
    pm = PM(SOLVER["nc"], SOLVER["box"])
    (ref,), _dk = compute_force(pm, Painter(pm), [Store(x=x, M0=1.0)])
    (acc,) = _by_id(_cat(ranks, "replay_id"), _cat(ranks, "replay_acc"))
    np.testing.assert_allclose(acc, ref.acc.numpy(), atol=1e-5)


# ---- the homed kernels' contracts against the Pallas factories --------

KN0, KBOX, KLOC, KH, KR0 = 16, 64.0, 4, 1, 4     # rank 1 of 4, H = 1


def _slab_inputs(n=3000, seed=77):
    """Positions around rank 1's slab (some beyond its halo), a mass
    column, and the JAX _cic_rel inputs of the homed factories (rows
    beyond the slab at relx = nloc + 2H + 1, as the force passes them)."""
    rng = np.random.RandomState(seed)
    cell = KBOX / KN0
    x = rng.uniform(0, KBOX, (n, 3))
    x[:, 0] = (KR0 - 2.5 + (KLOC + 5) * rng.rand(n)) * cell
    x = (x % KBOX).astype(np.float32)
    mass = (0.5 + rng.rand(n)).astype(np.float32)
    relx, iy, iz, frac = jps._cic_rel(JPM(KN0, KBOX), jnp.asarray(x), KR0,
                                      KH)
    nx = KLOC + 2 * KH
    relx = jnp.where(relx < nx, relx, nx + 1)
    return x, mass, (relx, iy, iz, frac)


@pytest.mark.parametrize("hk", workers.HOMED_KERNELS)
def test_homed_paint_contract(hk):
    from fastpm_tpu.ops import paint_pallas as pp
    x, mass, rel = _slab_inputs()
    shape = (KLOC + 2 * KH, KN0, KN0)
    base_only = hk == "from8"
    prepared = jax.jit(pp.make_prepare_homed_fn(
        shape, C=1024, base_only=base_only))(*rel, jnp.asarray(mass))
    make = (pp.make_paint_from8_homed_fn if hk == "from8"
            else pp.make_paint_from4_homed_fn)
    want = np.asarray(make(shape, K=256, C=1024, interpret=True)(prepared))
    canvas = torch.zeros(want.shape)
    slab = cic.Slab(KN0, KR0, KH)
    x_t, m_t = torch.from_numpy(x), torch.from_numpy(mass)
    if hk == "from8":
        bad = cic.cic_paint_homed(canvas, x_t, (KN0 / KBOX,) * 3, slab, m_t)
    else:
        bad = cic.cic_paint4(canvas, x_t, (KN0 / KBOX,) * 3, m_t, slab)
    np.testing.assert_allclose(canvas.numpy(), want, atol=1e-5)
    assert int(bad) == int(np.sum(np.asarray(rel[0]) >= shape[0]))
    assert int(bad) > 0


@pytest.mark.parametrize("hk", workers.HOMED_KERNELS)
def test_homed_readout_contract(hk):
    from fastpm_tpu.ops import paint_pallas as pp
    from fastpm_tpu.ops import readout_pallas as rp
    x, _mass, rel = _slab_inputs()
    shape = (KLOC + 2 * KH, KN0, KN0)
    prepared = jax.jit(pp.make_prepare_homed_fn(
        shape, C=1024, base_only=hk == "from8"))(*rel)
    make = (rp.make_readout3_from8_homed_fn if hk == "from8"
            else rp.make_readout3_from4_homed_fn)
    rng = np.random.RandomState(5)
    fs = [rng.standard_normal((shape[0] + 1, KN0, KN0)).astype(np.float32)
          for _ in range(3)]
    want = np.asarray(make(shape, K=256, C=1024, interpret=True,
                           gather_mode="highest")(
        prepared, *map(jnp.asarray, fs)))
    slab = cic.Slab(KN0, KR0, KH)
    ft = [torch.from_numpy(f) for f in fs]
    inv = (KN0 / KBOX,) * 3
    got = (cic.cic_readout_homed(ft, torch.from_numpy(x), inv, slab)
           if hk == "from8"
           else cic.cic_readout4(*ft, torch.from_numpy(x), inv, slab))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_periodic_from4_contract():
    """K5 and K6 without a slab against make_paint_from4_fn and
    make_readout3_from4_fn (test_pallas_paint.py:102-138)."""
    from fastpm_tpu.ops import paint_pallas as pp
    from fastpm_tpu.ops import readout_pallas as rp
    jpm = JPM(16, 64.0)
    rng = np.random.default_rng(12)
    pos = rng.uniform(0, 64, (4321, 3)).astype(np.float32)
    prepared = jax.jit(pp.make_prepare_fn(jpm, C=1024))(jnp.asarray(pos))
    want = np.asarray(pp.make_paint_from4_fn(jpm, K=256, C=1024,
                                             interpret=True)(prepared))
    canvas = torch.zeros(jpm.Nmesh)
    bad = cic.cic_paint4(canvas, torch.from_numpy(pos), jpm.InvCellSize)
    np.testing.assert_allclose(canvas.numpy(), want, atol=1e-5)
    assert int(bad) == 0
    cs = [rng.standard_normal((16,) * 3).astype(np.float32)
          for _ in range(3)]
    want = np.asarray(rp.make_readout3_from4_fn(
        jpm, K=256, C=1024, interpret=True, gather_mode="highest")(
        prepared, *map(jnp.asarray, cs)))
    got = cic.cic_readout4(*map(torch.from_numpy, cs), torch.from_numpy(pos),
                           jpm.InvCellSize)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


# ---- the CLI on 2 ranks ----------------------------------------------

CLI_LUA = """
nc = 32
boxsize = 96.0
time_step = linspace(0.1, 1, 3)
output_redshifts = {0.0, 0.5}
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
write_snapshot = "%(out)s/fastpm"
write_powerspectrum = "%(out)s/powerspec"
write_fof = "%(out)s/fastpm"
write_whitenoisek = "%(out)s/wn"
write_lineark = "%(out)s/lk"
write_linearr = "%(out)s/lr"
write_nonlineark = "%(out)s/nlk"
write_runpb_snapshot = "%(out)s/runpb"
"""


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """(one-rank output, two-rank output) of the same Lua file."""
    import contextlib
    import io
    from fastpm_torch import cli
    tmp = tmp_path_factory.mktemp("cli")
    outs = []
    for name in ("one", "two"):
        out = str(tmp / name)
        conf = tmp / (name + ".lua")
        conf.write_text(CLI_LUA % dict(ps=POWERSPEC, out=out))
        if name == "one":
            with contextlib.redirect_stdout(io.StringIO()):
                assert cli.main([str(conf)], device="cpu") == 0
        else:
            spawn(2, "cli", str(conf), out)
        outs.append(out)
    return outs


def _snapshot(path, columns=("Position", "Velocity")):
    from fastpm_torch.io.bigfile import BigFile
    bf = BigFile(path)
    ids = bf.open_block("1/ID").read_all().reshape(-1)
    o = np.argsort(ids)
    return [ids[o]] + [bf.open_block("1/" + c).read_all()[o]
                       for c in columns]


@pytest.mark.parametrize("a", ["0.6667", "1.0000"])
def test_cli_two_ranks_snapshots(cli_runs, a):
    """Positions within 1e-4 Mpc/h (1e-4 of a cell is 3e-4), velocities
    within 1e-4 of their rms, by id (the one-device test's bounds)."""
    one, two = (_snapshot(os.path.join(o, "fastpm_" + a)) for o in cli_runs)
    np.testing.assert_array_equal(one[0], np.arange(32 ** 3))
    np.testing.assert_array_equal(two[0], one[0])
    dx = two[1] - one[1]
    dx -= np.round(dx / 96.0) * 96.0
    assert np.abs(dx).max() < 1e-4
    assert np.abs(two[2] - one[2]).max() < 1e-4 * one[2].std()


@pytest.mark.parametrize("a", ["0.6667", "1.0000"])
def test_cli_two_ranks_fof(cli_runs, a):
    from fastpm_torch.io.bigfile import BigFile
    lengths = [BigFile(os.path.join(o, "fastpm_" + a)).open_block(
        "LL-0.200/Length").read_all() for o in cli_runs]
    assert len(lengths[0]) > 0
    np.testing.assert_array_equal(lengths[1], lengths[0])


def test_cli_two_ranks_powerspectrum(cli_runs):
    names = [sorted(f for f in os.listdir(o) if f.startswith("powerspec_"))
             for o in cli_runs]
    assert len(names[0]) == 3 and names[1] == names[0]
    for name in names[0]:
        one, two = (np.loadtxt(os.path.join(o, name), comments="#")
                    for o in cli_runs)
        np.testing.assert_array_equal(two[:, 2], one[:, 2])     # Nmodes
        # %g text (6 digits) of sums over other paint and FFT orders
        np.testing.assert_allclose(two[:, :2], one[:, :2], rtol=2e-5)


@pytest.mark.parametrize("name,block", [
    ("wn", "WhiteNoiseK"), ("lk", "LinearDensityK"),
    ("lr", "LinearDensityR"), ("nlk_1.0000", "DensityK")])
def test_cli_two_ranks_field_files(cli_runs, name, block):
    """Every rank builds the whole linear field and rank 0 writes it: the
    files of two ranks equal one rank's (the white noise and the linear
    field bit for bit); the nonlinear density, painted from the rows
    rank 0 gathers, within rtol 1e-5 and 1e-6 of its largest mode."""
    from fastpm_torch.io.bigfile import BigFile
    one, two = (BigFile(os.path.join(o, name)).open_block(block).read_all()
                for o in cli_runs)
    if block == "DensityK":
        np.testing.assert_allclose(two, one, rtol=1e-5,
                                   atol=1e-6 * np.abs(one).max())
    else:
        np.testing.assert_array_equal(two, one)


def test_cli_two_ranks_runpb(cli_runs):
    from fastpm_torch.io.legacy import read_runpb_snapshot
    one, two = (read_runpb_snapshot(os.path.join(o, "runpb_1.0000.bin"))
                for o in cli_runs)
    oa, ob = np.argsort(one["id"]), np.argsort(two["id"])
    np.testing.assert_array_equal(two["id"][ob], one["id"][oa])
    dx = two["x"][ob] - one["x"][oa]
    dx -= np.round(dx)
    assert np.abs(dx).max() < 1e-4 / 32
    assert np.abs(two["v"][ob] - one["v"][oa]).max() < 1e-4 * one["v"].std()
