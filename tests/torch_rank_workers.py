"""Rank-side code of the port's multi-rank tests
(tests/test_torch_parallel.py, tests/test_torch_pencil.py,
tests/test_torch_ranks_physics.py, tests/test_torch_pfof.py) and of
chip_smoke.py's sharded FOF on gloo ranks.

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
    """One rank of `job` ("cases", "cola", "pencil", "physics", "pfof",
    or "cli" followed by the CLI's flags)."""
    import faulthandler
    # a rank killed by a signal prints where it was to the test's stderr
    faulthandler.enable()
    torch.set_num_threads(1)
    # gloo on the loopback interface by address: no host name lookups,
    # which a host without name service may fail
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    if job.split()[0] == "cli":
        run_cli(rank, nproc, port, job.split()[1:] + [inp], out)
        return
    if job == "pfof":
        run_pfof(rank, nproc, port, inp, out)
        return
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d" % port,
                            rank=rank, world_size=nproc)
    if job == "physics":
        data = dict(np.load(inp))
        try:
            from fastpm_torch.parallel.comm import Grid
            use_fd_tables(str(data["fd_tables"]))
            grid = Grid(dist.group.WORLD, int(data["px"]), int(data["py"]))
            np.savez(os.path.join(out, "rank%d.npz" % rank),
                     **physics(grid, data))
            dist.barrier()
        finally:
            dist.destroy_process_group()
        # then the CLI runs, each on a process group of its own
        for i, argv in enumerate(str(data["cli"]).split(";")):
            argv = argv.split()
            run_cli(rank, nproc, int(data["cli_ports"][i]), argv[1:],
                    argv[0])
        return
    if job == "cola":
        # the cola Solver on the ranks: its LPT columns ride the slab
        # force's row permutations
        try:
            data = dict(np.load(inp))
            s = run_solver(int(data["nc"]), float(data["box"]),
                           data["steps"], str(data["ps"]), int(data["seed"]),
                           group=dist.group.WORLD, force_mode="cola")
            p = s.species["cdm"]
            np.savez(os.path.join(out, "rank%d.npz" % rank), x=p.x.numpy(),
                     v=p.v.numpy(), id=p.id.numpy(), dx1=p.dx1.numpy(),
                     paths=np.array(sorted(s.force_paths.elements())))
            dist.barrier()
        finally:
            dist.destroy_process_group()
        return
    if job == "pencil":
        try:
            from fastpm_torch.parallel.comm import Grid
            data = dict(np.load(inp))
            grid = Grid(dist.group.WORLD, int(data["px"]), int(data["py"]))
            np.savez(os.path.join(out, "rank%d.npz" % rank),
                     **pencil(grid, data))
            dist.barrier()
        finally:
            dist.destroy_process_group()
        return
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


def run_cli(rank, nproc, port, argv, out):
    """cli.main(argv) on this rank: the CLI starts the process group
    itself, as under torchrun; each rank's standard output, and the
    message of a SystemExit, go to <out>/cli.rank<r>.txt."""
    os.environ.update(WORLD_SIZE=str(nproc), RANK=str(rank),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    import contextlib
    import io
    from fastpm_torch import cli
    text = io.StringIO()
    try:
        with contextlib.redirect_stdout(text):
            cli.main(argv, device="cpu")
    except SystemExit as e:
        text.write("SystemExit: %s\n" % e)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "cli.rank%d.txt" % rank), "w") as f:
        f.write(text.getvalue())


def run_pfof(rank, nproc, port, inp, out):
    """The sharded FOF's cases (pfof) on a gloo group whose collectives
    time out (the .npz's "timeout", 60 s by default), so that a rank left
    waiting fails its caller instead of hanging it."""
    import datetime
    data = dict(np.load(inp))
    timeout = datetime.timedelta(seconds=float(data.get("timeout", 60.0)))
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d" % port,
                            rank=rank, world_size=nproc, timeout=timeout)
    try:
        from fastpm_torch.parallel.comm import Ring
        np.savez(os.path.join(out, "rank%d.npz" % rank),
                 **pfof(Ring(dist.group.WORLD), data))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def pfof(ring, data):
    """Each case of data["cases"] on the rank's block of its rows
    (<case>_x, on data["device"], the CPU by default), with <case>_ll and
    <case>_box, once for each of its <case>_kinds: "sharded"
    (fof_labels_sharded, rmax 32: labels, overflow), "auto"
    (fof_labels_sharded_auto: labels), "capacity" (boundary_capacity
    over the ring) or "unequal" (fof_labels_sharded with rank r's block
    cut by r rows), <case>_reps times (1 by default). A RuntimeError or
    ValueError is kept as <case>_<kind>_error; the wall seconds of each
    call (host clock after a synchronise on the card) and the last call's
    outer rounds, ghost capacity, rows of the local pass and fof_link
    launches are kept too."""
    import time
    from fastpm_torch.ops import fof_device
    from fastpm_torch.parallel import pfof as pf
    dev = torch.device(str(data.get("device", "cpu")))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    res = {}
    for name in str(data["cases"]).split():
        x = _rows(ring, data[name + "_x"]).to(dev)
        ll, box = float(data[name + "_ll"]), float(data[name + "_box"])
        for kind in str(data[name + "_kinds"]).split():
            key = "%s_%s_" % (name, kind)
            if kind == "capacity":
                res[key + "capacity"] = np.int64(
                    pf.boundary_capacity(x, ring, box, ll))
                continue
            xk = x[:x.shape[0] - ring.rank] if kind == "unequal" else x
            walls = []
            try:
                for _ in range(int(data.get(name + "_reps", 1))):
                    launches = fof_device.fof_link.launches
                    sync()
                    t0 = time.perf_counter()
                    if kind == "auto":
                        lab = pf.fof_labels_sharded_auto(xk, ll, box, ring)
                    else:
                        lab, overflow = pf.fof_labels_sharded(
                            xk, ll, box, ring, rmax=32)
                        res[key + "overflow"] = np.int64(overflow)
                    sync()
                    walls.append(time.perf_counter() - t0)
            except (RuntimeError, ValueError) as e:
                res[key + "error"] = np.array(str(e))
                continue
            res[key + "wall"] = np.array(walls)
            res[key + "labels"] = lab.cpu().numpy()
            res[key + "launches"] = np.int64(
                fof_device.fof_link.launches - launches)
            for attr in ("rounds", "ghost_cap", "rows"):
                res[key + attr] = np.int64(
                    getattr(pf.fof_labels_sharded, attr))
    return res


def use_fd_tables(path):
    """Take the Fermi-Dirac integral table (cosmology._fd_table, some 18
    s of quadratures a process) from the pickle the parent wrote of its
    own: the same code makes it, so it is the same table."""
    import pickle
    from fastpm_torch import cosmology, neutrinos_lra
    with open(path, "rb") as f:
        tabs = pickle.load(f)
    for mod in (cosmology, neutrinos_lra):
        if hasattr(mod, "_fd_table"):
            mod._fd_table = lambda: tabs


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
    from fastpm_torch import transfers
    from fastpm_torch.mesh import PM
    from fastpm_torch.parallel.pfft import SlabPM
    field = data["fft_field"]
    pm = PM(field.shape[0], float(data["fft_box"]))
    spm = SlabPM(pm, ring)
    slab = _rows(ring, field)
    dk = spm.r2c_local(slab)
    kpm = spm.kpm
    out = transfers.apply_decic(kpm, transfers.apply_grad(
        kpm, transfers.apply_pot(kpm, dk, 1), 1, 1))
    return {"fft_dk": dk.numpy(), "fft_back": spm.c2r_local(dk).numpy(),
            "fft_transfer": out.numpy()}


def forces(ring, data):
    """The homed force of every case with both homed kernels, the homed
    carry, the v1 force and its public entry points (sharded_force_fn,
    one make_sharded_step), on the rank's rows."""
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
            (out,), bad, _dk = psolver._force_local_homed_multi(
                spm, (x,), (mass,), "1_4", H, homed_kernel=hk)
            res["%s_%s_acc" % (name, hk)] = out["acc"].numpy()
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
    x1 = _rows(ring, data["v1_x"])
    (out,), _dk = psolver._force_local_multi(
        SlabPM(pm1, ring), Painter(pm1, "cic"), (x1,), (1.0,), "1_4")
    res["v1_acc"] = out["acc"].numpy()
    # the public entry points over the same body
    res["sharded_acc"] = psolver.sharded_force_fn(pm1, ring)(x1).numpy()
    x, v, acc = psolver.make_sharded_step(pm1, ring)(
        x1.clone(), _rows(ring, data["v1_v"]).clone(), data["step_coeffs"])
    res.update(step_x=x.numpy(), step_v=v.numpy(), step_acc=acc.numpy())
    return res


# the cosmology of the linear response runs (tests/test_torch_lra.py)
LRA_COSMO = dict(h=0.6774, Omega_m=0.307494, T_cmb=2.725, N_eff=3.046,
                 N_nu=3, m_ncdm=(0.3,), ncdm_matterlike=False,
                 ncdm_freestreaming=True, ncdm_linearresponse=True,
                 growth_mode="ode")


def run_solver(nc, box, time_step, ps, seed, device="cpu", group=None,
               force_mode="fastpm", grid=None, lra_z=None, **config):
    """A Solver (pm_nc_factor 1) from the port's own linear field,
    evolved; the solver (shared with the parent's one-rank run). grid: a
    process grid instead of the group's slab; lra_z: the neutrino linear
    response (LRA_COSMO) with its transfer at this redshift; config:
    more SolverConfig fields."""
    from fastpm_torch.solver import Solver, SolverConfig
    from fastpm_torch.cosmology import Cosmology
    from fastpm_torch.powerspectrum import FuncK
    from fastpm_torch import ic
    c = (Cosmology(**LRA_COSMO) if lra_z is not None else
         Cosmology(h=0.6774, Omega_m=0.307494, T_cmb=0.0, growth_mode="lcdm"))
    s = Solver(SolverConfig(nc=nc, boxsize=box, time_step=list(time_step),
                            force_mode=force_mode, pm_nc_factor=1,
                            check_values=True, **config), c, device=device,
               group=group, grid=grid)
    if lra_z is not None:
        s.setup_linear_response(lra_z)
    dk, _ = ic.linear_field(s.lptpm, c, FuncK.from_file(ps), seed=seed,
                            aout=1.0)
    s.setup_lpt(dk, time_step[0])
    s.evolve()
    return s


def species_run(nc, box, time_step, ps, seed, group=None, grid=None):
    """The JAX package's wide-path case (tests/test_sharded_solver.py:
    47-91) in the port: CDM from the port's linear field and an (nc/2)^3
    baryon lattice with a mass column, gaussian softening, the
    potential and the tidal tensor, evolved over the group or grid (the
    baryons pencil-blocked as the CDM where the grid blocks it), or on
    one device; the solver."""
    from fastpm_torch.solver import Solver, SolverConfig, BARYON, CDM
    from fastpm_torch.cosmology import Cosmology
    from fastpm_torch.powerspectrum import FuncK
    from fastpm_torch.store import lattice_store
    from fastpm_torch import ic
    c = Cosmology(h=0.6774, Omega_m=0.307494, T_cmb=0.0, growth_mode="lcdm")
    s = Solver(SolverConfig(nc=nc, boxsize=box, time_step=list(time_step),
                            pm_nc_factor=1, softening_type="gaussian",
                            compute_potential=True, compute_tidal=True,
                            check_values=True), c, device="cpu",
               group=group, grid=grid)
    a0 = float(time_step[0])
    b = lattice_store(s.basepm, Nc=nc // 2, name="baryon",
                      columns=("v", "acc", "id", "potential", "tidal"),
                      blocks=s.species[CDM].home_blocks)
    b = b.replace(M0=0.3, mass=torch.full((b.np_local,), 0.3), a_x=a0,
                  a_v=a0)
    s.add_species(BARYON, b)
    dk, _ = ic.linear_field(s.lptpm, c, FuncK.from_file(ps), seed=seed,
                            aout=1.0)
    s.setup_lpt(dk, a0)
    s.evolve()
    return s


def species_ranks(grid, data):
    """On the grid's ranks: the baryon run (species_run) and phase 7's
    physics with order_free=False (run_solver), each species' columns
    and the force paths."""
    res = {}
    s = species_run(int(data["nc"]), float(data["box"]), data["run_steps"],
                    str(data["ps"]), int(data["seed"]), group=grid.group,
                    grid=grid)
    for name in ("baryon", "cdm"):
        p = s.species[name]
        for c in ("x", "v", "id", "potential", "tidal"):
            res["species_%s_%s" % (name, c)] = getattr(p, c).numpy()
    res["species_paths"] = np.array(sorted(s.force_paths.elements()))
    s = run_solver(int(data["nc"]), float(data["box"]), data["run_steps"],
                   str(data["ps"]), int(data["seed"]), group=grid.group,
                   grid=grid, order_free=False, stale_every=3, rehome=True)
    p = s.species["cdm"]
    res.update(ordered_x=p.x.numpy(), ordered_v=p.v.numpy(),
               ordered_id=p.id.numpy(),
               ordered_paths=np.array(sorted(s.force_paths.elements())))
    return res


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
    (p,), _dk, _eng, _H = s._sharded_force(pm, Painter(pm, "cic"), [p])
    res.update(replay_acc=p.acc.numpy(), replay_id=p.id.numpy(),
               replay_H=np.int64(s._halo[pm.Nmesh]),
               replay_paths=np.array(sorted(s.force_paths.elements())))
    return res


# ---- the pencil decomposition (tests/test_torch_pencil.py) ------------


def pencil(grid, data):
    """On a px x py Grid: the rings' members, PencilPM's FFTs and shard
    transfers, the halo requirement, the pencil multi (both homed
    kernels, a mass column, the potential and tidal tensor, multi-hop,
    the overflow count) and carry, v1 over PencilPM; where the inputs
    ask, the slab multi's potential and tidal tensor over every rank,
    the sharded Solver and read_runpbic."""
    from fastpm_torch import gravity, transfers
    from fastpm_torch.mesh import PM
    from fastpm_torch.painter import Painter
    from fastpm_torch.store import Store
    from fastpm_torch.parallel.pfft import PencilPM, SlabPM
    from fastpm_torch.parallel import psolver
    me = torch.tensor([grid.rank])
    res = {"xring": grid.xring.all_gather(me).numpy(),
           "yring": grid.yring.all_gather(me).numpy()}

    field = data["fft_field"]
    ppm = PencilPM(PM(field.shape, float(data["fft_box"])), grid)
    (x0, y0), (nlx, nly) = ppm.r0, ppm.rshard[:2]
    dk = ppm.r2c_local(torch.from_numpy(np.ascontiguousarray(
        field[x0:x0 + nlx, y0:y0 + nly])))
    kpm = ppm.kpm
    res.update(
        fft_dk=dk.numpy(), fft_back=ppm.c2r_local(dk).numpy(),
        fft_transfer=transfers.apply_decic(kpm, transfers.apply_grad(
            kpm, transfers.apply_pot(kpm, dk, 1), 1, 1)).numpy(),
        # the force's k-space stage: kernel 1_4 is potorder 0, gradorder 1
        fft_grad3=torch.stack(gravity.acc_fields(
            kpm, dk, "1_4", ppm.c2r_local)).numpy(),
        fft_laplace=transfers.apply_laplace(kpm, dk, 2).numpy(),
        fft_fk=transfers.apply_fk_interp(
            kpm, dk, torch.from_numpy(data["fk_logk"]),
            torch.from_numpy(data["fk_vals"])).numpy())

    pm = PM(int(data["force_nc"]), float(data["force_box"]))
    ppm = PencilPM(pm, grid)
    pot_tid = dict(compute_potential=True, compute_tidal=True)
    for name in str(data["cases"]).split():
        x = _rows(grid, data[name + "_x"])
        Hx, Hy = (int(h) for h in data[name + "_H"])
        res[name + "_req"] = np.array(
            psolver.required_halo_planes_pencil(pm, grid, x))
        mass = (_rows(grid, data[name + "_mass"])
                if name + "_mass" in data else 1.0)
        for hk in HOMED_KERNELS:
            (out,), bad, _dk = psolver._force_local_homed_pencil_multi(
                ppm, (x,), (mass,), "1_4", Hx, Hy, homed_kernel=hk,
                **(pot_tid if name == "a" else {}))
            for k, v in out.items():
                res["%s_%s_%s" % (name, hk, k)] = v.numpy()
            res["%s_%s_bad" % (name, hk)] = np.int64(bad)
    x, v = _rows(grid, data["carry_x"]), _rows(grid, data["carry_v"])
    ids = _rows(grid, data["carry_id"])
    Hx, Hy = (int(h) for h in data["carry_H"])
    for hk in HOMED_KERNELS:
        p, bad, _dk = psolver._force_local_homed_pencil_carry(
            ppm, Store(x=x, v=v, id=ids), "1_4", Hx, Hy, homed_kernel=hk)
        for c in ("x", "v", "id", "acc"):
            res["carry_%s_%s" % (hk, c)] = getattr(p, c).numpy()
        res["carry_%s_bad" % hk] = np.int64(bad)
    (out,), _dk = psolver._force_local_multi(
        ppm, Painter(pm, "cic"), (_rows(grid, data["a_x"]),), (1.0,), "1_4")
    res["v1_acc"] = out["acc"].numpy()

    if "slab_x" in data:
        # the slab multi over every rank, x-major rows
        ring = grid.flat
        (out,), bad, _dk = psolver._force_local_homed_multi(
            SlabPM(pm, ring), (_rows(ring, data["slab_x"]),), (1.0,),
            "1_4", int(data["slab_H"]), **pot_tid)
        for k, v in out.items():
            res["slab_" + k] = v.numpy()
        res["slab_bad"] = np.int64(bad)
    # the Solver as is ("plain"), and with the potential and tidal tensor
    # ("pot_tid")
    for variant in str(data.get("solver_variants", "")).split():
        extra = ({} if variant == "plain" else
                 dict(compute_potential=True, compute_tidal=True))
        s = run_solver(int(data["solver_nc"]), float(data["solver_box"]),
                       data["solver_steps"], str(data["solver_ps"]),
                       int(data["solver_seed"]), group=grid.group,
                       grid=grid, **extra)
        p = s.species["cdm"]
        cols = ("x", "v", "id") + (("potential", "tidal") if extra else ())
        res.update({"solver_%s_%s" % (variant, c): getattr(p, c).numpy()
                    for c in cols})
        res["solver_%s_paths" % variant] = np.array(
            sorted(s.force_paths.elements()))
    if "runpb" in data:
        p = runpb_ic(str(data["runpb"]), int(data["runpb_nc"]),
                     float(data["runpb_box"]), float(data["runpb_a"]),
                     grid=grid)
        for c in ("x", "v", "id", "dx1", "dx2"):
            res["runpb_" + c] = getattr(p, c).numpy()
    return res


def runpb_ic(path, nc, box, a0, grid=None):
    """The CDM store a cola Solver sets up from a RunPB IC file
    (cli.prepare_runpbic), on one rank or over a grid."""
    from fastpm_torch.solver import Solver, SolverConfig
    from fastpm_torch.cosmology import Cosmology
    from fastpm_torch.cli import prepare_runpbic
    from fastpm_torch.diagnostics import Log
    c = Cosmology(h=0.6774, Omega_m=0.307494, growth_mode="lcdm")
    s = Solver(SolverConfig(nc=nc, boxsize=box, time_step=[a0, 1.0],
                            force_mode="cola", pm_nc_factor=1,
                            use_shift=True), c, device="cpu",
               grid=grid)
    prepare_runpbic(s, path, a0, Log(echo=False))
    return s.species["cdm"]


# ---- the options of the ranks (tests/test_torch_ranks_physics.py) -------


def physics_solver(data, grid, a_f, **config):
    """A Solver of data's mesh over the grid whose rows sit at the given
    positions (data["x"], in id order), v 0; with lra=True the linear
    response (LRA_COSMO, transfer at z = 4)."""
    from fastpm_torch.solver import Solver, SolverConfig
    from fastpm_torch.cosmology import Cosmology
    lra = config.pop("lra", False)
    c = Cosmology(**LRA_COSMO) if lra else None
    s = Solver(SolverConfig(nc=int(data["nc"]), boxsize=float(data["box"]),
                            time_step=[a_f, 1.0], pm_nc_factor=1, **config),
               c, device="cpu", group=grid.group, grid=grid)
    if lra:
        s.setup_linear_response(4.0)
    p = s.species["cdm"]
    s.species["cdm"] = p.replace(x=torch.from_numpy(data["x"][p.id.numpy()]))
    return s


def physics(grid, data):
    """On the grid's ranks: the linear response's forces (the third with
    a cached halo too small, so that it is replayed) and a run; the
    baryon run and the order-preserving run (species_ranks); PGD's
    column after one force; on a slab of 2, the rehome body on the
    parent's layout (two steps) and the rehomed Solver against the dense
    one, with a snapshot of the rehomed store."""
    from fastpm_torch.store import Store
    from fastpm_torch.parallel.pfft import SlabPM
    from fastpm_torch.parallel import psolver
    res = {}
    a_fs = [float(a) for a in data["lra_a"]]
    s = physics_solver(data, grid, a_fs[0], lra=True)
    pm = s.find_pm(1.0)
    calls, update = [], s.lra.update_from_power

    def counted(k, delta, a):
        calls.append(a)
        return update(k, delta, a)

    s.lra.update_from_power = counted
    for i, a in enumerate(a_fs):
        if i == 2:
            # the halo cached too narrow for the positions
            s._halo[pm.Nmesh] = ("pencil", 1, 1) if grid.py > 1 else 1
        s.force(pm, a)
        p = s.species["cdm"]
        res.update({"lra_acc%d" % i: p.acc.numpy(),
                    "lra_id%d" % i: p.id.numpy()})
    res.update(lra_calls=np.array(calls),
               lra_paths=np.array(sorted(s.force_paths.elements())),
               lra_scalefact=np.asarray(s.lra.scalefact),
               lra_delta_tot=np.asarray(s.lra.delta_tot))
    s = run_solver(int(data["nc"]), float(data["box"]), data["run_steps"],
                   str(data["ps"]), int(data["seed"]), group=grid.group,
                   grid=grid, lra_z=4.0)
    p = s.species["cdm"]
    res.update(run_x=p.x.numpy(), run_v=p.v.numpy(), run_id=p.id.numpy(),
               run_scalefact=np.asarray(s.lra.scalefact),
               run_delta_tot=np.asarray(s.lra.delta_tot),
               run_paths=np.array(sorted(s.force_paths.elements())))

    res.update(species_ranks(grid, data))

    s = physics_solver(data, grid, 0.5, pgdc=True)
    s.force(s.find_pm(0.5), 0.5)
    p = s.species["cdm"]
    res.update(pgd_id=p.id.numpy(), pgdc=p.pgdc.numpy(),
               pgd_paths=np.array(sorted(s.force_paths.elements())))

    if "rehome_x" in data:
        ring = grid.flat
        R = len(data["rehome_x"]) // ring.nproc
        rows = slice(ring.rank * R, (ring.rank + 1) * R)
        spm = SlabPM(s.find_pm(1.0), ring)
        p = Store(x=torch.from_numpy(data["rehome_x"][rows]),
                  v=torch.from_numpy(data["rehome_v"][rows]),
                  id=torch.from_numpy(data["rehome_id"][rows]),
                  alive=torch.from_numpy(data["rehome_alive"][rows]),
                  rehome_bucket=int(data["rehome_B"]))
        for step in (1, 2):
            if step == 2:
                # every alive row moved, then wrapped
                x = p.x + torch.from_numpy(data["rehome_shift"]) * (
                    p.alive[:, None] > 0)
                p = p.replace(x=x).wrap(float(data["box"]))
            p, bad, _dk = psolver._force_local_homed_rehome(
                spm, p, "1_4", int(data["rehome_H"]))
            for c in ("x", "v", "id", "alive", "acc"):
                res["rehome%d_%s" % (step, c)] = getattr(p, c).numpy()
            res["rehome%d_bad" % step] = np.int64(bad)
        for name, extra in (("dense", {}), ("rehomed", dict(rehome=True))):
            s = run_solver(int(data["nc"]), float(data["box"]),
                           data["run_steps"], str(data["ps"]),
                           int(data["seed"]), group=grid.group, **extra)
            p = s.species["cdm"]
            res["solver_%s_paths" % name] = np.array(
                sorted(s.force_paths.elements()))
            if name == "rehomed":
                res["solver_rehomed_rows"] = np.int64(p.np_local)
                # a snapshot of the rehomed store and of its compacted
                # rows, a = 1 -> 1.1
                snaps = [s.set_snapshot(q, s._drift_factor(1.0, 1.0, 1.1),
                                        s._kick_factor(1.0, 1.0, 1.1), 1.1)
                         for q in (p, p.compact())]
                for tag, q in zip(("snap", "snap_compact"), snaps):
                    for c in ("x", "v", "id"):
                        res["%s_%s" % (tag, c)] = getattr(q, c).numpy()
                p = p.compact()
            for c in ("x", "v", "id"):
                res["solver_%s_%s" % (name, c)] = getattr(p, c).numpy()
    return res
