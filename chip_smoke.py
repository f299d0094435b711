#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fastpm_torch) on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, in order (any failure ends the script with a nonzero exit):
1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from fastpm_torch/csrc/ with nvcc (sm_90a);
3. kernel checks at the main path's shapes (256^3 = 16.8 M particles,
   a 512^3 mesh; uniform and clustered particles): each kernel against
   its plain PyTorch version on the card, K2 also with the one 256^3
   field of the 2LPT readouts, and CUDA-event timings of the
   kernel, the plain version, a PyTorch yardstick where one exists, and
   the least time the card could take (bytes at 3.35 TB/s);
4. golden: tests/fixtures/nbodykit.lua through fastpm_torch.cli.main
   writes 1894 FOF objects at a = 0.6667 and 1668 at a = 1.0, and logs
   the input sigma8 0.815897;
5. device agreement: one 32^3 Lua file on the CPU and on the card;
   positions and velocities agree by id;
6. the main path at full size: the nbodykit.lua physics at nc = 256,
   boxsize = 768 on a 512^3 force mesh (B2), 5 time steps, P(k) files
   and a z = 0 snapshot, through fastpm_torch.cli.run_fastpm; the K1 /
   K2 launch counters show every force step went through the kernels;
7. a JSON line of the kernels, the card line again, and the result line.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_FLOPS = 67e12              # H100 SXM float32 peak outside tensor cores

# K1/K2 against their plain versions: f32 sums in another order (atomics
# in run-dependent order), so elementwise atol 2e-6 + rtol 1e-5
ATOL, RTOL = 2e-6, 1e-5

SMALL_LUA = """
nc = %(nc)d
boxsize = %(box)r
time_step = linspace(0.1, 1, %(nstep)d)
output_redshifts = {%(zout)s}
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
"""


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps=10):
    """Mean device time of fn over reps launches after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes, nops):
    """Least time for the work: bytes over the memory rate or float32
    operations over the peak rate, whichever is larger."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / F32_FLOPS * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def make_particles(kind, n, box, dev, seed):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand((n, 3), generator=g, device=dev) * box
    if kind == "clustered":
        # half the particles in 64 gaussian blobs of 3 cells' width
        m = n // 2
        centers = torch.rand((64, 3), generator=g, device=dev) * box
        which = torch.randint(0, 64, (m,), generator=g, device=dev)
        blob = centers[which] + torch.randn(
            (m, 3), generator=g, device=dev) * (3.0 * box / 512)
        x[:m] = blob - torch.floor(blob / box) * box
    return x


def check_kernels(dev, nc=256, nmesh=512, box=768.0, reps=10):
    """Phase 3. Returns the kernels' rows for the JSON line (launch counts
    are filled in after the main path)."""
    import torch
    from fastpm_torch.ops import cic

    mesh = (nmesh,) * 3
    inv = (nmesh / box,) * 3
    n = nc ** 3
    cells = nmesh ** 3
    rows = {"cic_paint": dict(err=0.0), "cic_readout": dict(err=0.0)}
    g = torch.Generator(device=dev).manual_seed(7)
    fields = [torch.randn(mesh, generator=g, device=dev) for _ in range(3)]
    # the 2LPT readouts: one field on the nc^3 LPT mesh
    lpt_field = torch.randn((nc,) * 3, generator=g, device=dev)
    lpt_inv = (nc / box,) * 3
    for kind in ("uniform", "clustered"):
        x = make_particles(kind, n, box, dev, seed=11)
        x = x[cic.sort_by_cell(x, mesh, inv)].contiguous()

        got = cic.cic_paint(x, mesh, inv)
        want = cic.cic_paint_plain(x, mesh, inv)
        diff = (got - want).abs()
        ok = bool((diff <= ATOL + RTOL * want.abs()).all())
        err = float(diff.max())
        print("K1 cic_paint %s: max_abs_err %.3g (atol %g + rtol %g) %s"
              % (kind, err, ATOL, RTOL, "ok" if ok else "FAIL"))
        if not ok or abs(float(got.sum()) - n) > 1e-4 * n:
            raise SystemExit("K1 disagrees with its plain version")
        rows["cic_paint"]["err"] = max(rows["cic_paint"]["err"], err)
        del got, want, diff

        for label, fs, fi in (("3 fields %d^3" % nmesh, fields, inv),
                              ("1 field %d^3" % nc, [lpt_field], lpt_inv)):
            got = cic.cic_readout(fs, x, fi)
            want = cic.cic_readout_plain(fs, x, fi)
            diff = (got - want).abs()
            ok = bool((diff <= ATOL + RTOL * want.abs()).all())
            err = float(diff.max())
            print("K2 cic_readout %s, %s: max_abs_err %.3g (atol %g + "
                  "rtol %g) %s" % (kind, label, err, ATOL, RTOL,
                                   "ok" if ok else "FAIL"))
            if not ok:
                raise SystemExit("K2 disagrees with its plain version")
            rows["cic_readout"]["err"] = max(rows["cic_readout"]["err"], err)
            del got, want, diff

        key = "" if kind == "uniform" else "_" + kind
        rows["cic_paint"]["ms" + key] = time_ms(
            lambda: cic.cic_paint(x, mesh, inv), reps)
        rows["cic_paint"]["plain_ms" + key] = time_ms(
            lambda: cic.cic_paint_plain(x, mesh, inv), reps)
        rows["cic_readout"]["ms" + key] = time_ms(
            lambda: cic.cic_readout(fields, x, inv), reps)
        rows["cic_readout"]["plain_ms" + key] = time_ms(
            lambda: cic.cic_readout_plain(fields, x, inv), reps)
        if kind == "uniform":
            rows["cic_readout"]["library_ms"] = grid_sample_ms(
                fields, x, inv, nmesh, reps)
    torch.cuda.synchronize()

    # bytes: positions read once, the canvas / fields read or written
    # once, the readout values written once. operations: ~40 float ops
    # per particle for weights and indices, + 16 per field gathered
    rows["cic_paint"]["bound"] = bound_ms(12 * n + 4 * cells, 40 * n)
    rows["cic_readout"]["bound"] = bound_ms(12 * n + 3 * 4 * cells
                                            + 12 * n, (40 + 48) * n)
    for name, r in rows.items():
        print("%s: kernel_ms %.4f plain_ms %.4f library_ms %s bound_ms "
              "%.4f (%s) | clustered kernel_ms %.4f plain_ms %.4f"
              % (name, r["ms"], r["plain_ms"],
                 "%.4f" % r["library_ms"] if "library_ms" in r else "null",
                 r["bound"][0], r["bound"][1], r["ms_clustered"],
                 r["plain_ms_clustered"]))
    return rows


def grid_sample_ms(fields, x, inv, nmesh, reps):
    """A PyTorch yardstick for K2, never used by the port: trilinear
    grid_sample (align_corners=True) of the three fields, wrap-padded by
    one plane per axis, at the particles."""
    import torch
    import torch.nn.functional as F
    from fastpm_torch.ops import cic
    padded = torch.stack(fields)
    padded = torch.cat([padded, padded[:, :1]], dim=1)
    padded = torch.cat([padded, padded[:, :, :1]], dim=2)
    padded = torch.cat([padded, padded[:, :, :, :1]], dim=3)[None]
    g = x * torch.tensor(inv, device=x.device)
    # grid (x, y, z) indexes (W, H, D) = (iz, iy, ix); padded size n + 1
    grid = (g.flip(-1) * (2.0 / nmesh) - 1.0).reshape(1, -1, 1, 1, 3)

    def call():
        return F.grid_sample(padded, grid, mode="bilinear",
                             padding_mode="border", align_corners=True)

    out = call()[0, :, :, 0, 0].T
    err = float((out - cic.cic_readout_plain(fields, x, inv)).abs().max())
    print("grid_sample yardstick: max_abs_err vs plain readout %.3g" % err)
    return time_ms(call, reps)


def write_lua(path, text):
    with open(path, "w") as fp:
        fp.write(text)
    return path


def golden(dev, tmp):
    """Phase 4: nbodykit.lua through the CLI on the card."""
    from fastpm_torch import cli
    from fastpm_torch.io.bigfile import BigFile
    out = os.path.join(tmp, "golden")
    src = open(os.path.join(FIXTURES, "nbodykit.lua")).read()
    src = re.sub(r'read_powerspectrum = ".*"', 'read_powerspectrum = "%s"'
                 % os.path.join(FIXTURES, "powerspec.txt"), src)
    conf = write_lua(os.path.join(tmp, "nbodykit.lua"),
                     src.replace("OUTDIR", out))
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([conf], device=dev)
    log = buf.getvalue()
    print("golden: nbodykit.lua (128^3, 256^3 force mesh) ran in %.1f s"
          % (time.perf_counter() - t0))
    if rc != 0 or "Input power spectrum sigma8 0.815897" not in log:
        raise SystemExit("golden: sigma8 0.815897 not logged")
    for name, want in (("fastpm_0.6667", 1894), ("fastpm_1.0000", 1668)):
        n = len(BigFile(os.path.join(out, name)).open_block(
            "LL-0.200/Length").read_all())
        print("golden: %s FOF objects %d (want %d)" % (name, n, want))
        if n != want:
            raise SystemExit("golden: FOF count mismatch")


def read_by_id(path):
    import numpy as np
    from fastpm_torch.io.bigfile import BigFile
    bf = BigFile(path)
    ids = bf.open_block("1/ID").read_all().reshape(-1)
    o = np.argsort(ids)
    return (ids[o], bf.open_block("1/Position").read_all().reshape(-1, 3)[o],
            bf.open_block("1/Velocity").read_all().reshape(-1, 3)[o])


def device_agreement(dev, tmp, nc=32, box=96.0):
    """Phase 5: the same 32^3 run on the CPU and on the card agree by id
    to 1e-4 of a cell in position and 1e-4 of the rms in velocity."""
    import numpy as np
    from fastpm_torch import cli
    res = {}
    for where in ("cpu", dev):
        out = os.path.join(tmp, "agree_" + str(where))
        conf = write_lua(os.path.join(tmp, "agree_%s.lua" % where),
                         SMALL_LUA % dict(
                             nc=nc, box=box, nstep=3, zout="0.0",
                             out=out, ps=os.path.join(FIXTURES,
                                                      "powerspec.txt")))
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main([conf], device=where)
        res[where] = read_by_id(os.path.join(out, "fastpm_1.0000"))
    (ia, xa, va), (ib, xb, vb) = res["cpu"], res[dev]
    dx = xb - xa
    dx -= np.round(dx / box) * box
    ex = float(np.abs(dx).max()) / (box / nc)
    ev = float(np.abs(vb - va).max() / va.std())
    print("device agreement 32^3: max |dx| %.3g cell, max |dv| %.3g rms"
          % (ex, ev))
    if not (np.array_equal(ia, ib) and ex < 1e-4 and ev < 1e-4):
        raise SystemExit("device agreement failed")


def main_path(dev, tmp, nc=256, box=768.0, nstep=5):
    """Phase 6: the full-size run; returns (solver, force steps, rows of
    measurements)."""
    import numpy as np
    import torch
    from fastpm_torch import cli, gravity
    from fastpm_torch.config.params import load_params
    from fastpm_torch.diagnostics import Log
    from fastpm_torch.painter import Painter
    from fastpm_torch.ops import cic

    out = os.path.join(tmp, "main")
    conf = write_lua(os.path.join(tmp, "main.lua"), SMALL_LUA % dict(
        nc=nc, box=box, nstep=nstep, zout="0.0", out=out,
        ps=os.path.join(FIXTURES, "powerspec.txt")))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cic.cic_paint.launches = 0
    cic.cic_readout.launches = 0
    t0 = time.perf_counter()
    log = Log(echo=False)
    solver = cli.run_fastpm(load_params(conf), log=log, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"cic_paint": cic.cic_paint.launches,
                "cic_readout": cic.cic_readout.launches}
    peak = torch.cuda.max_memory_allocated()

    nforce = nstep
    print("main path: %d^3 particles, %d^3 force mesh, %d force steps, "
          "wall %.2f s (IC, 2LPT, steps, P(k), snapshot)"
          % (nc, 2 * nc, nforce, wall))
    print("main path: launches K1 cic_paint %d (want %d), K2 cic_readout "
          "%d (want %d = force steps + 6 LPT readouts)"
          % (launches["cic_paint"], nforce, launches["cic_readout"],
             nforce + 6))
    print("main path: max_memory_allocated %.3f GB"
          % (peak / 1e9))
    if launches != {"cic_paint": nforce, "cic_readout": nforce + 6}:
        raise SystemExit("main path did not run through the kernels")

    # outputs: the z=0 snapshot and one P(k) file per force step
    ids, x, v = read_by_id(os.path.join(out, "fastpm_1.0000"))
    if not (np.array_equal(ids, np.arange(nc ** 3))
            and np.isfinite(x).all() and np.isfinite(v).all()
            and x.min() >= 0 and x.max() < box):
        raise SystemExit("main path: bad snapshot")
    pk_files = sorted(f for f in os.listdir(out)
                      if f.startswith("powerspec_"))
    pk = np.loadtxt(os.path.join(out, pk_files[-1]), comments="#")
    if len(pk_files) != nforce or not np.isfinite(pk).all():
        raise SystemExit("main path: bad power spectrum output")
    print("main path: %s, last line of the log: %s"
          % (pk_files, log.lines[-1]))

    # the force step alone, on the z=0 (clustered) state
    pm = solver.find_pm(1.0)
    painter = Painter(pm, "cic")
    store = solver.species["cdm"]
    force_ms = time_ms(lambda: gravity.compute_force(
        pm, painter, store.wrap(pm.BoxSize)), reps=5)
    print("main path: force step %.2f ms (sort + K1 + FFTs + K2) = "
          "%.4g particle-steps/s" % (force_ms, nc ** 3 / force_ms * 1e3))
    profile_force(lambda: gravity.compute_force(
        pm, painter, store.wrap(pm.BoxSize)))
    return launches


def profile_force(step, top=12):
    """Where the force step's device time goes: torch.profiler over two
    steps, device time by kernel name and the device's busy share of
    the wall time."""
    import torch
    from torch.profiler import profile, ProfilerActivity
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / 2
    rows = [(e.key, e.self_device_time_total / 2, e.count // 2)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print("force profile: device busy %.2f ms of %.2f ms wall per step "
          "(%.1f%% idle)" % (busy / 1e3, wall_us / 1e3,
                             100 * (1 - busy / wall_us)))
    for key, us, count in rows[:top]:
        print("force profile: %8.3f ms %5.1f%% x%d %s"
              % (us / 1e3, 100 * us / busy, count, key[:90]))


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from fastpm_torch.ops import cic, cudalib

    card = card_line()
    print("card: " + card)
    dev = "cuda"

    t0 = time.perf_counter()
    cudalib.get_lib(verbose=True)
    print("build: %.1f s for %s" % (time.perf_counter() - t0,
                                    [os.path.relpath(s, ROOT)
                                     for s in cudalib.SOURCES]))

    rows = check_kernels(dev)
    with tempfile.TemporaryDirectory() as tmp:
        golden(dev, tmp)
        device_agreement(dev, tmp)
        launches = main_path(dev, tmp)

    meta = {
        "cic_paint": ("fastpm_torch/csrc/cic_paint.cu",
                      "fastpm_tpu/ops/paint_pallas.py:1012"),
        "cic_readout": ("fastpm_torch/csrc/cic_readout.cu",
                        "fastpm_tpu/ops/readout_pallas.py:836"),
    }
    kernels = []
    for name, r in rows.items():
        kernels.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1], "launches": launches[name],
            "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1],
            "library_ms": r.get("library_ms"),
            "ms_clustered": r["ms_clustered"],
            "plain_ms_clustered": r["plain_ms_clustered"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
