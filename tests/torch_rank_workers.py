"""Rank-side code of the port's multi-rank tests
(tests/test_torch_parallel.py).

`run` is started on each rank of a gloo process group with
torch.multiprocessing (start method spawn). It imports torch and the
port only, never jax or the JAX package: the parent computes the JAX
oracles and passes the inputs through an .npz; each rank writes its
results to <out>/rank<r>.npz, rows in its block's order.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

HOMED_KERNELS = ("from8", "from4")


def run(rank, nproc, port, job, inp, out):
    """One rank of `job` ("cases" or "cli")."""
    import faulthandler
    # a rank killed by a signal prints where it was to the test's stderr
    faulthandler.enable()
    torch.set_num_threads(1)
    # gloo on the loopback interface by address: no host name lookups,
    # which a host without name service may fail
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    if job == "cli":
        # the CLI starts the process group itself, as under torchrun
        os.environ.update(WORLD_SIZE=str(nproc), RANK=str(rank),
                          LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(port))
        import contextlib
        import io
        from fastpm_torch import cli
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main([inp], device="cpu")
        return
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d" % port,
                            rank=rank, world_size=nproc)
    try:
        from fastpm_torch.parallel.comm import Ring
        ring = Ring(dist.group.WORLD)
        data = dict(np.load(inp))
        res = {}
        res.update(ring_ops(ring))
        res.update(slab_fft(ring, data))
        res.update(forces(ring, data))
        if "solver_nc" in data:
            res.update(solver(ring, data))
        np.savez(os.path.join(out, "rank%d.npz" % rank), **res)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def ring_ops(ring):
    """Each collective of comm.Ring on data made from the rank."""
    r, P = ring.rank, ring.nproc
    t = torch.arange(6, dtype=torch.float32) + 100 * r
    res = {"ppermute_%d" % m: ring.ppermute(t, m).numpy()
           for m in range(-P, P + 1)}
    res["psum"] = ring.psum(torch.arange(4.0) * (r + 1)).numpy()
    res["psum_scalar"] = np.float64(ring.psum(float(r + 1)))
    res["pmax"] = ring.pmax(torch.tensor([r, -r])).numpy()
    # block j of rank r holds 10 r + j
    a = torch.arange(P, dtype=torch.float32).repeat_interleave(2) + 10 * r
    res["all_to_all"] = ring.all_to_all(a.reshape(2 * P, 1).repeat(1, 3),
                                        split_dim=0, concat_dim=1).numpy()
    c = torch.complex(a, -a).reshape(1, 2 * P)
    res["all_to_all_complex"] = ring.all_to_all(c, split_dim=1,
                                                concat_dim=0).numpy()
    res["psum_scatter"] = ring.psum_scatter(
        torch.arange(2 * P * 3, dtype=torch.float32).reshape(2 * P, 3)
        * (r + 1)).numpy()
    res["all_gather"] = ring.all_gather(torch.full((2, 3), float(r))).numpy()
    rows = ring.gather_rows(torch.full((r + 1, 2), r, dtype=torch.int64))
    if r == 0:
        res["gather_rows"] = rows.numpy()
    return res


def _rows(ring, a):
    """This rank's block of the rows of a (Store.shard's bounds)."""
    n = len(a)
    return torch.from_numpy(np.ascontiguousarray(
        a[n * ring.rank // ring.nproc:n * (ring.rank + 1) // ring.nproc]))


def slab_fft(ring, data):
    """SlabPM r2c, c2r and the shard transfers on the rank's slab."""
    from fastpm_torch.mesh import PM
    from fastpm_torch.parallel.pfft import SlabPM
    field = data["fft_field"]
    pm = PM(field.shape[0], float(data["fft_box"]))
    spm = SlabPM(pm, ring)
    slab = _rows(ring, field)
    dk = spm.r2c_local(slab)
    out = spm.apply_decic(spm.apply_grad(spm.apply_pot(dk, 1), 1, 1))
    return {"fft_dk": dk.numpy(), "fft_back": spm.c2r_local(dk).numpy(),
            "fft_transfer": out.numpy()}


def forces(ring, data):
    """The homed force of every case with both homed kernels, the homed
    carry and the v1 force, on the rank's rows."""
    from fastpm_torch.mesh import PM
    from fastpm_torch.painter import Painter
    from fastpm_torch.store import Store
    from fastpm_torch.parallel.pfft import SlabPM
    from fastpm_torch.parallel import psolver
    pm = PM(int(data["force_nc"]), float(data["force_box"]))
    spm = SlabPM(pm, ring)
    res = {}
    for name in str(data["cases"]).split():
        x = _rows(ring, data[name + "_x"])
        H = int(data[name + "_H"])
        mass = (_rows(ring, data[name + "_mass"])
                if name + "_mass" in data else 1.0)
        for hk in HOMED_KERNELS:
            (acc,), bad, _dk = psolver._force_local_homed_multi(
                spm, (x,), (mass,), "1_4", H, homed_kernel=hk)
            res["%s_%s_acc" % (name, hk)] = acc.numpy()
            res["%s_%s_bad" % (name, hk)] = np.int64(bad)
    x, v = _rows(ring, data["carry_x"]), _rows(ring, data["carry_v"])
    ids = _rows(ring, data["carry_id"])
    for hk in HOMED_KERNELS:
        p, bad, _dk = psolver._force_local_homed_carry(
            spm, Store(x=x, v=v, id=ids), "1_4", int(data["carry_H"]),
            homed_kernel=hk)
        for c in ("x", "v", "id", "acc"):
            res["carry_%s_%s" % (hk, c)] = getattr(p, c).numpy()
        res["carry_%s_bad" % hk] = np.int64(bad)
    pm1 = PM(int(data["v1_nc"]), float(data["v1_box"]))
    (acc,), _dk = psolver._force_local_multi(
        SlabPM(pm1, ring), Painter(pm1, "cic"), (_rows(ring, data["v1_x"]),),
        (1.0,), "1_4")
    res["v1_acc"] = acc.numpy()
    return res


def run_solver(nc, box, time_step, ps, seed, device="cpu", group=None):
    """A Solver (fastpm mode, pm_nc_factor 1) from the port's own linear
    field, evolved; the solver (shared with the parent's one-rank run)."""
    from fastpm_torch.solver import Solver, SolverConfig
    from fastpm_torch.cosmology import Cosmology
    from fastpm_torch.powerspectrum import FuncK
    from fastpm_torch import ic
    c = Cosmology(h=0.6774, Omega_m=0.307494, T_cmb=0.0, growth_mode="lcdm")
    s = Solver(SolverConfig(nc=nc, boxsize=box, time_step=list(time_step),
                            force_mode="fastpm", pm_nc_factor=1,
                            check_values=True), c, device=device,
               group=group)
    dk, _ = ic.linear_field(s.lptpm, c, FuncK.from_file(ps), seed=seed,
                            aout=1.0)
    s.setup_lpt(dk, time_step[0])
    s.evolve()
    return s


def solver(ring, data):
    """The sharded Solver's evolution, and one force whose cached halo
    width is too small for the positions it is given."""
    from fastpm_torch.painter import Painter
    from fastpm_torch.store import Store
    s = run_solver(int(data["solver_nc"]), float(data["solver_box"]),
                   data["solver_steps"], str(data["solver_ps"]),
                   int(data["solver_seed"]), group=ring.group)
    p = s.species["cdm"]
    res = {"solver_x": p.x.numpy(), "solver_v": p.v.numpy(),
           "solver_id": p.id.numpy(),
           "solver_paths": np.array(sorted(s.force_paths.elements()))}
    # the overflow contract: a cached halo width of 2 planes, positions
    # that stray 3 planes; the force is measured again and replayed
    pm = s.find_pm(1.0)
    x = data["replay_x"]
    p = Store(x=_rows(ring, x), v=_rows(ring, np.zeros_like(x)),
              id=_rows(ring, np.arange(len(x))))
    s._halo[pm.Nmesh] = 2
    s.force_paths.clear()
    (p,), _dk = s._sharded_force(pm, Painter(pm, "cic"), [p])
    res.update(replay_acc=p.acc.numpy(), replay_id=p.id.numpy(),
               replay_H=np.int64(s._halo[pm.Nmesh]),
               replay_paths=np.array(sorted(s.force_paths.elements())))
    return res
