#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fastpm_torch) on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, in order (any failure ends the script with a nonzero exit):
1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from fastpm_torch/csrc/ (one nvcc per source,
   all started together, sm_90a);
3. K1 / K2 checks at the main path's shapes (256^3 = 16.8 M cell-sorted
   particles, a 512^3 mesh; uniform and clustered particles): each
   kernel against its plain PyTorch version on the card, K2 also with
   2 fields, with the one 256^3 field of the 2LPT readouts (at the
   particles and at the lattice), K1 and K2 on the uniform particles
   drifted by up to a cell in their order (stale) and shuffled (K2 equal
   to the sorted rows bit for bit), and CUDA-event timings of the
   kernel, the plain version, a PyTorch yardstick where one exists, and
   the least time the card could take (bytes at 3.35 TB/s);
4. K3 / K4 checks at the ncdm path's shapes, particles in store order:
   K3 adds 16.8 M CDM particles (scalar mass) and 5.24 M ncdm particles
   (a mass column) into one 512^3 canvas, K4 reads the three 512^3
   force fields at both sets; then both given each species' cell order
   (cell_order, the counting sort by line of csrc/cic_bin.cu, against
   its plain version): against the plain versions, the total mass, K4's
   rows bit for bit, and the same timings, the order's apart;
5. golden: tests/fixtures/nbodykit.lua through fastpm_torch.cli.main
   writes 1894 FOF objects at a = 0.6667 and 1668 at a = 1.0, and logs
   the input sigma8 0.815897; the LCDM and ODE broadband series of
   tests/test_torch_broadband.py (64^3, 8 steps) on the card: 16 lines,
   each exact or within one unit of its last printed digit;
6. device agreement: one 32^3 Lua file, and tests/fixtures/ncdm.lua
   (16^3 CDM + 1280 ncdm), on the CPU and on the card; both species
   agree by id, and 2/Mass agrees;
7. the main path at full size: the nbodykit.lua physics at nc = 256,
   boxsize = 768 on a 512^3 force mesh (B2), 5 time steps, P(k) files
   and a z = 0 snapshot, through fastpm_torch.cli.run_fastpm; the launch
   counters show every force step went through K1 / K2 and none
   through K3 / K4; K1 and K2 at the z = 0 state in cell order;
8. the ncdm path at full width: tests/fixtures/ncdm.lua's physics at
   nc = 256, boxsize = 768 on a 512^3 force mesh (16.8 M CDM + 5.24 M
   ncdm particles), its 6 time steps, through run_fastpm; the cell
   order, K3 and K4 launch twice per force step, K1 never; both
   species' ids complete, the ncdm mass sums to Omega_ncdm * RHO_CRIT *
   boxsize^3, one finite P(k) file per force step; the multi-species
   force step's time and profile; K3 and K4 in the path's own store
   order, and the order + K3 + K4 + gather + scatter back of a force
   step as one device-time sum;
A. the homed kernels at the slab force's shapes: rank 0 of one with
   H = 4, an extended slab of 521 x 512 x 512, 16.8 M cell-sorted
   particles (a 256^3 lattice displaced up to 2 cells, and clustered):
   homed K1 and K5 (scalar mass, and a mass column at 5.24 M
   particles), homed K2 and K6 (sorted, drifted a cell, shuffled), and
   K5 / K6 on the periodic 512^3 mesh, each against its plain version,
   with the same timings (grid_sample the yardstick of the readouts);
   then the readouts' edge cases of fastpm_torch/ops/readout_cases.py
   at 64^3 (K2 and homed K2 with 1-3 fields, K4, K6; runs across an x
   face, rows wrapping in y, the last z column, the slab's last plane
   and the rows beyond it), and K2 on the rows shuffled, bit for bit;
B. the homed slab force (fastpm_torch.parallel) at full width on a
   one-rank NCCL process group started on localhost: the main path's
   z = 0 state (phase 7), H from required_halo_planes, the carry and the
   multi-species body with the from8 (homed K1 / K2) and the from4 (K5 /
   K6) kernels; the launch counters show each went through its kernels;
   accelerations against the single-device compute_force_carry by id;
   each variant's force-step time and peak memory;
C. K7 at the carry sort's shapes: the cell keys of 2^24 particles
   (fastpm_torch.benchlib.example_particles(256, 256.0), a 512^3 mesh)
   one step after a fresh carry sort, with 6 payloads (x, v), block
   sorted with B = 32768: K7 against its plain version with
   torch.equal; sort_ksorted on k-sorted unique keys and
   sort_maybe_ksorted on the step's keys against torch.sort (keys equal,
   rows permuted: an index column rides as float32); the times of a
   merge pass, of torch.sort over the merge's rows with the payload
   gathers, and of the full sort with gathers the fresh carry pays;
D. the benchlib step at full width (256^3 particles, a 512^3 mesh, box
   256), 5 steps each of base, sb32768 (K7; the full sorts the exact
   flag forced are counted), paint4 (K5) and stale3 (a fresh sort every
   3rd step): launch counters, step time, particle-steps/s and peak
   memory per variant; each variant's sorted cell keys against base's,
   and one step of each from base's final state against base's (acc row
   by row, or per cell where rows of a cell come in another order); then
   the stale force against the carry force on the main path's z = 0
   state moved by one more drift: by id, times and profiles, and K1 /
   K2 at that carried order;
9. a JSON line of the kernels, the card line again, and the result line.
"""

import contextlib
import gc
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

# the kernels against their plain versions: f32 sums in another order
# (atomics in run-dependent order), so elementwise atol 2e-6 + rtol 1e-5
ATOL, RTOL = 2e-6, 1e-5

# wrapper name in fastpm_torch.ops.cic (merge_pairs: ops.sort) ->
# (source, the TPU kernel it replaces)
KERNELS = {
    "cic_paint": ("fastpm_torch/csrc/cic_paint.cu",
                  "fastpm_tpu/ops/paint_pallas.py:1012"),
    "cic_readout": ("fastpm_torch/csrc/cic_readout.cu",
                    "fastpm_tpu/ops/readout_pallas.py:836"),
    "cic_paint_into": ("fastpm_torch/csrc/cic_paint_into.cu",
                       "fastpm_tpu/ops/paint_pallas.py:70"),
    # K4 launches K2's kernel with three fields, under its own counter
    "cic_readout3": ("fastpm_torch/csrc/cic_readout.cu",
                     "fastpm_tpu/ops/readout_pallas.py:48"),
    # the homed factories of K1 and K2 (their pallas_call sites), K5, K6
    "cic_paint_homed": ("fastpm_torch/csrc/cic_paint.cu",
                        "fastpm_tpu/ops/paint_pallas.py:946"),
    "cic_readout_homed": ("fastpm_torch/csrc/cic_readout.cu",
                          "fastpm_tpu/ops/readout_pallas.py:764"),
    "cic_paint4": ("fastpm_torch/csrc/cic_paint4.cu",
                   "fastpm_tpu/ops/paint_pallas.py:689"),
    # K2's kernel summing plane by plane, in one pass
    "cic_readout4": ("fastpm_torch/csrc/cic_readout.cu",
                     "fastpm_tpu/ops/readout_pallas.py:371"),
    "merge_pairs": ("fastpm_torch/csrc/bitonic_merge.cu",
                    "fastpm_tpu/ops/sort_pallas.py:92"),
    # K3's cell order: the counting sort that replaces the sort
    # make_paint_fn runs before K3's pallas_call
    "cell_order": ("fastpm_torch/csrc/cic_bin.cu",
                   "fastpm_tpu/ops/paint_pallas.py:212"),
}
HOMED = ("cic_paint_homed", "cic_readout_homed", "cic_paint4",
         "cic_readout4")

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


def wrapper(name):
    """The wrapper of a kernel of KERNELS."""
    from fastpm_torch.ops import cic, sort
    return getattr(sort if name == "merge_pairs" else cic, name)


def reset_peak():
    """Start a new peak-memory count with only live tensors allocated:
    what earlier phases left in reference cycles (a finished Solver is
    one) is freed first, so a path's peak does not depend on when the
    garbage collector last ran."""
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def reset_launches():
    """Set every kernel's launch count, and the carry sort's call and
    fallback counts, to 0."""
    from fastpm_torch.ops import sort
    for name in KERNELS:
        wrapper(name).launches = 0
    sort.carry_sort.calls = 0
    sort.sort_maybe_ksorted.fallbacks = 0


def read_launches():
    return {name: wrapper(name).launches for name in KERNELS}


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
        err = check_close("K1 cic_paint %s" % kind, got,
                          cic.cic_paint_plain(x, mesh, inv))
        if abs(float(got.sum()) - n) > 1e-4 * n:
            raise SystemExit("K1 does not conserve the total mass")
        rows["cic_paint"]["err"] = max(rows["cic_paint"]["err"], err)
        del got

        for label, fs, fi in (("3 fields %d^3" % nmesh, fields, inv),
                              ("2 fields %d^3" % nmesh, fields[:2], inv),
                              ("1 field %d^3" % nc, [lpt_field], lpt_inv)):
            err = check_close("K2 cic_readout %s, %s" % (kind, label),
                              cic.cic_readout(fs, x, fi),
                              cic.cic_readout_plain(fs, x, fi))
            rows["cic_readout"]["err"] = max(rows["cic_readout"]["err"], err)

        key = "" if kind == "uniform" else "_" + kind
        if kind == "uniform":
            # the same particles drifted by up to a cell in their sorted
            # order (the stale force), shuffled (store order), and the
            # 2LPT readouts' one field at the lattice, in lattice order
            g2 = torch.Generator(device=dev).manual_seed(19)
            stale = x + (torch.rand(x.shape, generator=g2, device=dev) * 2
                         - 1) * (box / nmesh)
            stale -= torch.floor(stale / box) * box
            perm = torch.randperm(n, generator=g2, device=dev)
            q = jittered_lattice(nc, box, 0.0, nc, dev, 0)
            # K1 on the same orders: the tile where a block's rows fit
            # one, one global atomic a corner where they do not
            for row_key, label, xx in (
                    ("ms_stale", "stale (sorted, drifted a cell)", stale),
                    ("ms_random", "random order", x[perm])):
                got = cic.cic_paint(xx, mesh, inv)
                err = check_close("K1 cic_paint %s" % label, got,
                                  cic.cic_paint_plain(xx, mesh, inv))
                rows["cic_paint"]["err"] = max(rows["cic_paint"]["err"], err)
                del got
                ms = time_ms(lambda: cic.cic_paint(xx, mesh, inv), reps)
                print("K1 cic_paint %s: kernel_ms %.4f" % (label, ms))
                rows["cic_paint"][row_key] = ms
            for row_key, label, fs, xx, fi in (
                    ("ms_stale", "stale (sorted, drifted a cell)", fields,
                     stale, inv),
                    ("ms_random", "random order", fields, x[perm], inv),
                    (None, "2LPT lattice", [lpt_field], q, lpt_inv)):
                got = cic.cic_readout(fs, xx, fi)
                err = check_close("K2 cic_readout %s, %d field(s)"
                                  % (label, len(fs)), got,
                                  cic.cic_readout_plain(fs, xx, fi))
                rows["cic_readout"]["err"] = max(rows["cic_readout"]["err"],
                                                 err)
                if row_key == "ms_random":
                    back = torch.empty_like(got)
                    back[perm] = got
                    same = torch.equal(back, cic.cic_readout(fs, x, fi))
                    print("K2 cic_readout random order: the sorted rows' "
                          "values bit for bit %s" % same)
                    if not same:
                        raise SystemExit("K2 depends on the particle order")
                ms = time_ms(lambda: cic.cic_readout(fs, xx, fi), reps)
                print("K2 cic_readout %s: kernel_ms %.4f" % (label, ms))
                if row_key is not None:
                    rows["cic_readout"][row_key] = ms
            del stale, perm, q
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
                fields, [x], inv, nmesh, reps)
    torch.cuda.synchronize()

    # bytes: positions read once, the canvas / fields read or written
    # once, the readout values written once. operations: ~40 float ops
    # per particle for weights and indices, + 16 per field gathered
    rows["cic_paint"]["bound"] = bound_ms(12 * n + 4 * cells, 40 * n)
    rows["cic_readout"]["bound"] = bound_ms(12 * n + 3 * 4 * cells
                                            + 12 * n, (40 + 48) * n)
    print_rows(rows)
    return rows


def print_rows(rows):
    for name, r in rows.items():
        if "ms_periodic" in r:
            print("%s periodic mesh: kernel_ms %.4f plain_ms %.4f"
                  % (name, r["ms_periodic"], r["plain_ms_periodic"]))
        print("%s: kernel_ms %.4f plain_ms %.4f library_ms %s bound_ms "
              "%.4f (%s) | clustered kernel_ms %.4f plain_ms %.4f"
              % (name, r["ms"], r["plain_ms"],
                 "%.4f" % r["library_ms"] if "library_ms" in r else "null",
                 r["bound"][0], r["bound"][1], r["ms_clustered"],
                 r["plain_ms_clustered"]))


def check_close(label, got, want):
    """Elementwise atol + rtol against the plain version; returns the
    max abs error and raises SystemExit on a mismatch."""
    diff = (got - want).abs()
    ok = bool((diff <= ATOL + RTOL * want.abs()).all())
    err = float(diff.max())
    print("%s: max_abs_err %.3g (atol %g + rtol %g) %s"
          % (label, err, ATOL, RTOL, "ok" if ok else "FAIL"))
    if not ok:
        raise SystemExit("%s disagrees with its plain version" % label)
    return err


def check_kernels_ncdm(dev, nc=256, nmesh=512, box=768.0, every=4,
                       nsplit=20, reps=10):
    """Phase 4: K3 and K4 at the ncdm path's shapes, particles in store
    order (a random permutation). A row's times are one force step's
    work: K3 paints both species into one canvas, K4 reads the three
    fields at both."""
    import torch
    from fastpm_torch.ops import cic

    mesh = (nmesh,) * 3
    inv = (nmesh / box,) * 3
    n_cdm, n_nu = nc ** 3, (nc // every) ** 3 * nsplit
    cells = nmesh ** 3
    m_cdm = 1.0
    rows = {"cic_paint_into": dict(err=0.0), "cic_readout3": dict(err=0.0),
            "cell_order": dict(err=0.0)}
    g = torch.Generator(device=dev).manual_seed(17)
    fields = [torch.randn(mesh, generator=g, device=dev) for _ in range(3)]
    masses = 0.5 + torch.rand(n_nu, generator=g, device=dev)
    for kind in ("uniform", "clustered"):
        xs = []
        for n, seed in ((n_cdm, 21), (n_nu, 23)):
            x = make_particles(kind, n, box, dev, seed)
            xs.append(x[torch.randperm(n, generator=g, device=dev)])
        x_cdm, x_nu = xs

        def paint(fn, canvas, *orders):
            fn(canvas, x_cdm, inv, m_cdm, *orders[:1])
            return fn(canvas, x_nu, inv, masses, *orders[1:])

        got = paint(cic.cic_paint_into, torch.zeros(mesh, device=dev))
        want = paint(cic.cic_paint_into_plain, torch.zeros(mesh, device=dev))
        err = check_close("K3 cic_paint_into %s, CDM + ncdm" % kind,
                          got, want)
        total = m_cdm * n_cdm + float(masses.double().sum())
        if abs(float(got.double().sum()) - total) > 1e-4 * total:
            raise SystemExit("K3 does not conserve the total mass")
        rows["cic_paint_into"]["err"] = max(rows["cic_paint_into"]["err"],
                                            err)
        for x, label in ((x_cdm, "CDM"), (x_nu, "ncdm")):
            err = check_close(
                "K4 cic_readout3 %s, 3 fields %d^3 at %s" % (kind, nmesh,
                                                            label),
                cic.cic_readout3(*fields, x, inv),
                cic.cic_readout_plain(fields, x, inv))
            rows["cic_readout3"]["err"] = max(rows["cic_readout3"]["err"],
                                              err)

        # the order the multi-species force computes once and hands to
        # both: a permutation with the plain version's line at every
        # position, K3 agrees as before, K4 equals its rows bit for bit
        orders = [cic.cell_order(x, mesh, inv) for x in xs]
        check_order(kind, xs, orders, mesh, inv)
        err = check_close("K3 cic_paint_into %s, CDM + ncdm, given their "
                          "cell orders" % kind, paint(
                              cic.cic_paint_into,
                              torch.zeros(mesh, device=dev), *orders), want)
        rows["cic_paint_into"]["err"] = max(rows["cic_paint_into"]["err"],
                                            err)
        same = all(torch.equal(cic.cic_readout3(*fields, x, inv, o),
                               cic.cic_readout3(*fields, x, inv))
                   for x, o in zip(xs, orders))
        print("K4 cic_readout3 %s, given the cell orders: the rows in "
              "store order bit for bit %s" % (kind, same))
        if not same:
            raise SystemExit("K4 depends on the order it reads in")

        key = "" if kind == "uniform" else "_" + kind
        # repeated adds into one canvas: the work of a force step's paint,
        # given the orders (the kernel alone: it reads the rows through
        # them), and ordering its rows itself
        rows["cic_paint_into"]["ms" + key] = time_ms(
            lambda: paint(cic.cic_paint_into, got, *orders), reps)
        rows["cic_paint_into"]["ms_own_order" + key] = time_ms(
            lambda: paint(cic.cic_paint_into, got), reps)
        rows["cic_readout3"]["ms_given_order" + key] = time_ms(
            lambda: [cic.cic_readout3(*fields, x, inv, o)
                     for x, o in zip(xs, orders)], reps)
        ro = rows["cell_order"]
        ro["ms" + key] = time_ms(
            lambda: [cic.cell_order(x, mesh, inv) for x in xs], reps)
        ro["plain_ms" + key] = time_ms(
            lambda: [cic.cell_order_plain(x, mesh, inv) for x in xs], reps)
        if kind == "uniform":
            # one PyTorch call for the same grouping: torch.sort of the
            # line keys, given the keys
            keys = [cic.cell_key(x, mesh, inv) // nmesh for x in xs]
            ro["library_ms"] = time_ms(
                lambda: [torch.sort(k) for k in keys], reps)
            del keys
        del orders, want
        rows["cic_paint_into"]["plain_ms" + key] = time_ms(
            lambda: paint(cic.cic_paint_into_plain, got), reps)
        rows["cic_readout3"]["ms" + key] = time_ms(
            lambda: [cic.cic_readout3(*fields, x, inv) for x in xs], reps)
        rows["cic_readout3"]["plain_ms" + key] = time_ms(
            lambda: [cic.cic_readout_plain(fields, x, inv) for x in xs],
            reps)
        if kind == "uniform":
            rows["cic_paint_into"]["ms_cdm"] = time_ms(
                lambda: cic.cic_paint_into(got, x_cdm, inv, m_cdm), reps)
            rows["cic_paint_into"]["ms_ncdm"] = time_ms(
                lambda: cic.cic_paint_into(got, x_nu, inv, masses), reps)
            rows["cic_readout3"]["library_ms"] = grid_sample_ms(
                fields, xs, inv, nmesh, reps)
        del got
    torch.cuda.synchronize()

    # bytes: positions, the cell orders (int64) and the ncdm masses read
    # once, the canvas read and written once (K3 adds into it), the
    # fields read once and the values written once (K4). operations: as
    # K1 / K2 per particle
    n = n_cdm + n_nu
    rows["cic_paint_into"]["bound"] = bound_ms(
        12 * n + 8 * n + 4 * n_nu + 2 * 4 * cells, 40 * n)
    rows["cic_readout3"]["bound"] = bound_ms(
        12 * n + 3 * 4 * cells + 12 * n, (40 + 48) * n)
    # positions read once, the order (int64) written once; the line
    # counts (4 B a line) written once. operations: the cell, ~20 a row
    rows["cell_order"]["bound"] = bound_ms(
        12 * n + 8 * n + 4 * nmesh * nmesh, 20 * n)
    print_rows(rows)
    r3, r4 = rows["cic_paint_into"], rows["cic_readout3"]
    print("cic_paint_into uniform: CDM alone %.4f ms, ncdm alone %.4f ms "
          "(each ordering its rows)" % (r3["ms_cdm"], r3["ms_ncdm"]))
    for key in ("", "_clustered"):
        print("random order%s, both species: the cell order %.4f ms apart; "
              "given the orders K3 %.4f ms, K4 + gather + scatter back "
              "%.4f ms (K4 in store order %.4f); K3 ordering its rows "
              "itself %.4f ms" % (
                  key.replace("_", ", "), rows["cell_order"]["ms" + key],
                  r3["ms" + key], r4["ms_given_order" + key],
                  r4["ms" + key], r3["ms_own_order" + key]))
    return rows


def check_order(label, xs, orders, mesh, inv):
    """cell_order's kernel against its plain version: each order is a
    permutation, and the line (base plane * ny + base row) at every
    position equals the plain version's (rows of one line may come in
    any order)."""
    import torch
    from fastpm_torch.ops import cic
    for x, o in zip(xs, orders):
        n = x.shape[0]
        line = cic.cell_key(x, mesh, inv).long() // mesh[2]
        perm = torch.equal(torch.sort(o.index).values,
                           torch.arange(n, device=x.device))
        same = torch.equal(line[o.index],
                           line[cic.cell_order_plain(x, mesh, inv).index])
        print("cell_order %s, %d rows: a permutation %s, the plain "
              "version's line at every position %s" % (label, n, perm,
                                                       same))
        if not (perm and same):
            raise SystemExit("cell_order disagrees with its plain version")


def grid_sample_ms(fields, xs, inv, nmesh, reps, slab=None):
    """A PyTorch yardstick for K2, K4 and K6, never used by the port:
    trilinear grid_sample (align_corners=True) of the three fields,
    wrap-padded by one plane per periodic axis, at each set of particles
    in xs (one call per set, timed together). With a slab the fields are
    extended slabs, open in x: the x coordinate is the plane relx plus
    the fraction."""
    import torch
    import torch.nn.functional as F
    from fastpm_torch.ops import cic
    padded = torch.stack(fields)
    if slab is None:
        padded = torch.cat([padded, padded[:, :1]], dim=1)
    padded = torch.cat([padded, padded[:, :, :1]], dim=2)
    padded = torch.cat([padded, padded[:, :, :, :1]], dim=3)[None]
    size = torch.tensor(padded.shape[2:], device=xs[0].device)
    grids = []
    for x in xs:
        g = x * torch.tensor(inv, device=x.device)
        if slab is not None:
            base, frac, _ = cic.slab_cell(x, tuple(fields[0].shape), inv,
                                          slab)
            g = torch.cat([base[:, :1] + frac[:, :1], g[:, 1:]], dim=1)
        # grid (x, y, z) indexes (W, H, D) = (iz, iy, ix)
        grids.append((g * (2.0 / (size - 1)) - 1.0).flip(-1)
                     .reshape(1, -1, 1, 1, 3).float())

    def call():
        return [F.grid_sample(padded, grid, mode="bilinear",
                              padding_mode="border", align_corners=True)
                for grid in grids]

    err = max(float((out[0, :, :, 0, 0].T
                     - cic.cic_readout_plain(fields, x, inv, slab)).abs()
                     .max())
              for out, x in zip(call(), xs))
    print("grid_sample yardstick%s: max_abs_err vs plain readout %.3g"
          % (" (extended slab)" if slab else "", err))
    return time_ms(call, reps)


def jittered_lattice(nc, box, jitter_cells, nmesh, dev, seed):
    """nc^3 particles at their lattice sites, x-major, each displaced by
    up to jitter_cells cells of an nmesh^3 mesh along each axis,
    wrapped."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    i = torch.arange(nc, device=dev, dtype=torch.float32) * (box / nc)
    x = torch.stack(torch.meshgrid(i, i, i, indexing="ij"),
                    dim=-1).reshape(-1, 3)
    x += ((torch.rand(x.shape, generator=g, device=dev) * 2 - 1)
          * (jitter_cells * box / nmesh))
    return x - torch.floor(x / box) * box


def slab_order(x, ext, inv, slab):
    """The permutation that sorts particles by extended-slab cell, as
    the homed carry does."""
    import torch
    from fastpm_torch.ops import cic
    base, _, _ = cic.slab_cell(x, ext, inv, slab)
    key = (base[:, 0] * ext[1] + base[:, 1]) * ext[2] + base[:, 2]
    return torch.sort(key, stable=True).indices


def check_kernels_homed(dev, nc=256, nmesh=512, box=768.0, H=4, every=4,
                        nsplit=20, reps=10):
    """Phase A: homed K1 and K2, K5 and K6 at the slab force's shapes
    (rank 0 of one, halo H: a canvas of nmesh + 2H + 1 planes), and K5
    and K6 on the periodic mesh."""
    import torch
    from fastpm_torch.ops import cic

    slab = cic.Slab(nmesh, 0, H)
    ext = (nmesh + 2 * H + 1, nmesh, nmesh)
    mesh = (nmesh,) * 3
    inv = (nmesh / box,) * 3
    n, n_col = nc ** 3, (nc // every) ** 3 * nsplit
    cells = ext[0] * ext[1] * ext[2]
    rows = {name: dict(err=0.0) for name in HOMED}
    g = torch.Generator(device=dev).manual_seed(31)
    fields = [torch.randn(ext, generator=g, device=dev) for _ in range(3)]
    periodic = [f[:nmesh] for f in fields]
    masses = 0.5 + torch.rand(n_col, generator=g, device=dev)
    canvas = torch.zeros(ext, device=dev)
    paints = {
        "cic_paint_homed": (
            lambda c, x, m, s: cic.cic_paint_homed(c, x, inv, s, m),
            lambda c, x, m, s: cic.cic_paint_homed_plain(c, x, inv, s, m)),
        "cic_paint4": (
            lambda c, x, m, s: cic.cic_paint4(c, x, inv, m, s),
            lambda c, x, m, s: cic.cic_paint4_plain(c, x, inv, m, s))}
    reads = {
        "cic_readout_homed": (
            lambda fs, x, s: cic.cic_readout_homed(fs, x, inv, s),
            lambda fs, x, s: cic.cic_readout_plain(fs, x, inv, s)),
        "cic_readout4": (
            lambda fs, x, s: cic.cic_readout4(*fs, x, inv, s),
            lambda fs, x, s: cic.cic_readout4_plain(*fs, x, inv, s))}
    for kind in ("uniform", "clustered"):
        x = (jittered_lattice(nc, box, 2.0, nmesh, dev, 13)
             if kind == "uniform" else make_particles(kind, n, box, dev, 11))
        x = x[slab_order(x, ext, inv, slab)].contiguous()
        # the mass-column species: a random subset, still cell-sorted
        x_col = x[torch.randperm(n, generator=g, device=dev)[:n_col]
                  .sort().values].contiguous()
        key = "" if kind == "uniform" else "_" + kind

        def paint(fn, c, x, m, s):
            c.zero_()
            return fn(c, x, m, s)

        for name, (fn, plain) in paints.items():
            for xx, m, label in ((x, 1.0, "scalar mass"),
                                 (x_col, masses, "mass column")):
                bad = paint(fn, canvas, xx, m, slab)
                want = torch.zeros(ext, device=dev)
                bad_plain = plain(want, xx, m, slab)
                err = check_close("%s %s, %s, %d particles, %dx%dx%d"
                                  % (name, kind, label, len(xx), *ext),
                                  canvas, want)
                total = (float(m.double().sum()) if torch.is_tensor(m)
                         else m * len(xx))
                if (int(bad) != 0 or int(bad_plain) != 0 or abs(
                        float(canvas.double().sum()) - total) > 1e-4 * total):
                    raise SystemExit("%s: overflow or mass not conserved"
                                     % name)
                rows[name]["err"] = max(rows[name]["err"], err)
            del want
            rows[name]["ms" + key] = time_ms(
                lambda: paint(fn, canvas, x, 1.0, slab), reps)
            rows[name]["plain_ms" + key] = time_ms(
                lambda: paint(plain, canvas, x, 1.0, slab), reps)
        # K5 on the periodic mesh
        pcanvas, want = (torch.zeros(mesh, device=dev) for _ in range(2))
        fn, plain = paints["cic_paint4"]
        paint(fn, pcanvas, x, 1.0, None)
        plain(want, x, 1.0, None)
        err = check_close("cic_paint4 %s, periodic %d^3" % (kind, nmesh),
                          pcanvas, want)
        del want
        rows["cic_paint4"]["err"] = max(rows["cic_paint4"]["err"], err)
        if kind == "uniform":
            rows["cic_paint4"]["ms_periodic"] = time_ms(
                lambda: paint(fn, pcanvas, x, 1.0, None), reps)
            rows["cic_paint4"]["plain_ms_periodic"] = time_ms(
                lambda: paint(plain, pcanvas, x, 1.0, None), reps)
        del pcanvas

        # the sorted rows drifted by up to a cell (stale), and shuffled
        g2 = torch.Generator(device=dev).manual_seed(37)
        stale = x + (torch.rand(x.shape, generator=g2, device=dev) * 2
                     - 1) * (box / nmesh)
        stale -= torch.floor(stale / box) * box
        shuffled = x[torch.randperm(n, generator=g2, device=dev)]
        for name, (fn, plain) in reads.items():
            for fs, s, label in ((fields, slab, "%dx%dx%d" % ext),
                                 (periodic, None, "periodic %d^3" % nmesh)):
                if s is None and name == "cic_readout_homed":
                    continue
                for order, xx in (("", x), (", stale", stale),
                                  (", random order", shuffled)):
                    err = check_close("%s %s%s, 3 fields %s"
                                      % (name, kind, order, label),
                                      fn(fs, xx, s), plain(fs, xx, s))
                    rows[name]["err"] = max(rows[name]["err"], err)
            rows[name]["ms" + key] = time_ms(lambda: fn(fields, x, slab),
                                             reps)
            rows[name]["plain_ms" + key] = time_ms(
                lambda: plain(fields, x, slab), reps)
            if kind == "uniform":
                rows[name]["library_ms"] = grid_sample_ms(
                    fields, [x], inv, nmesh, reps, slab)
        del stale, shuffled
        if kind == "uniform":
            fn, plain = reads["cic_readout4"]
            rows["cic_readout4"]["ms_periodic"] = time_ms(
                lambda: fn(periodic, x, None), reps)
            rows["cic_readout4"]["plain_ms_periodic"] = time_ms(
                lambda: plain(periodic, x, None), reps)
            rows["cic_readout4"]["library_ms_periodic"] = grid_sample_ms(
                periodic, [x], inv, nmesh, reps)
    torch.cuda.synchronize()

    # as K1 and K2 (check_kernels) on the extended slab: positions read
    # once, the canvas written once or the three fields read once, the
    # values written once
    for name in ("cic_paint_homed", "cic_paint4"):
        rows[name]["bound"] = bound_ms(12 * n + 4 * cells, 40 * n)
    for name in ("cic_readout_homed", "cic_readout4"):
        rows[name]["bound"] = bound_ms(12 * n + 3 * 4 * cells + 12 * n,
                                       (40 + 48) * n)
    print_rows(rows)
    return rows


def check_readout_edges(dev, rows, n=64, box=128.0):
    """Phases 3 and A, edge cases: the geometries of
    fastpm_torch/ops/readout_cases.py (cell, store and stale order, runs
    across an x face, rows wrapping in y, the last column in z, cell
    faces; on rank 1 of 4's extended slab with H = 2 its sorted and stale
    rows and its last plane with the rows beyond) at a 64^3 mesh,
    131,171 particles. Each readout kernel against its plain version (K2
    and homed K2 with 1-3 fields, K4, K6), and K2 on the rows shuffled
    against the sorted rows, bit for bit."""
    import torch
    from fastpm_torch.ops import cic
    from fastpm_torch.ops import readout_cases as cases

    count = n ** 3 // 2 + 99          # a ragged last block
    nmesh, inv = cases.mesh(n, box)
    slab, ext = cases.slab_of(n, n // 4, 2, 1)
    g = torch.Generator(device=dev).manual_seed(43)
    fields = [torch.randn(nmesh, generator=g, device=dev) for _ in range(3)]
    efields = [torch.randn(ext, generator=g, device=dev) for _ in range(3)]
    runs = [(kind, cases.periodic_case(kind, n, box, count), None)
            for kind in cases.PERIODIC]
    runs += [(kind, cases.slab_case(kind, n, box, count, slab, ext), slab)
             for kind in cases.SLAB]
    for kind, pos, s in runs:
        x = torch.from_numpy(pos).to(dev)
        fs = fields if s is None else efields
        k2 = "cic_readout" if s is None else "cic_readout_homed"
        plain = cic.cic_readout_plain(fs, x, inv, s)
        checks = [("%s, %d field%s" % (k2, k, "s" * (k > 1)), k2,
                   (cic.cic_readout(fs[:k], x, inv) if s is None
                    else cic.cic_readout_homed(fs[:k], x, inv, s)),
                   plain[:, :k]) for k in (1, 2, 3)]
        if s is None:
            checks.append(("cic_readout3", "cic_readout3",
                           cic.cic_readout3(*fs, x, inv), plain))
        checks.append(("cic_readout4", "cic_readout4",
                       cic.cic_readout4(*fs, x, inv, s),
                       cic.cic_readout4_plain(*fs, x, inv, s)))
        for label, name, got, want in checks:
            err = check_close("%s edge case %s (%d^3%s)"
                              % (label, kind, n, ", slab" if s else ""),
                              got, want)
            rows[name]["err"] = max(rows[name]["err"], err)
        perm = torch.randperm(count, generator=g, device=dev)
        back = torch.empty_like(plain)
        back[perm] = (cic.cic_readout(fs, x[perm], inv) if s is None
                      else cic.cic_readout_homed(fs, x[perm], inv, s))
        same = torch.equal(back, checks[2][2])
        print("%s edge case %s shuffled: equal to the unshuffled rows bit "
              "for bit %s" % (k2, kind, same))
        if not same:
            raise SystemExit("%s: the shuffled rows disagree" % kind)


def write_lua(path, text):
    with open(path, "w") as fp:
        fp.write(text)
    return path


def golden(dev, tmp):
    """Phase 5: nbodykit.lua through the CLI on the card."""
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


def broadband(dev):
    """Phase 5, second part: the LCDM and ODE broadband series of
    tests/test_torch_broadband.py (the reference's lightcone checks,
    64^3 on 64^3, 8 steps) on the card, through K1 and K2. A line that
    is not printed exactly as the golden must be within one unit of its
    last printed digit (f32 atomics fix no order of the paint's sums),
    and is shown with its unrounded value."""
    import importlib.util
    import math
    from fastpm_torch.powerspectrum import measure_power
    spec = importlib.util.spec_from_file_location(
        "test_torch_broadband", os.path.join(ROOT, "tests",
                                             "test_torch_broadband.py"))
    bb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bb)

    def near(got, want):
        # one unit in the last of %g's 6 significant digits
        unit = 10.0 ** (math.floor(math.log10(abs(want))) - 5)
        return abs(got - want) <= unit * (1 + 1e-9)

    exact = total = 0
    for mode in ("lcdm", "ode"):
        raw = []

        def on_force(event):
            ps = measure_power(event.pm, event.delta_k, ring=event.solver.ring)
            raw.append(ps.large_scale(4) / event.solver.cosmology.growth_info(
                event.a_f).D1 ** 2)

        t0 = time.perf_counter()
        log, var = bb.run_series(mode, dev, on_force)
        print("broadband %s: 64^3, 8 steps in %.1f s" % (
            mode, time.perf_counter() - t0))
        if mode == "ode":
            ok = "%.8f" % var == bb.ODE_VARIANCE
            print("broadband ode: white-noise variance %.8f (want %s) %s"
                  % (var, bb.ODE_VARIANCE, "exact" if ok else
                     "within 1e-8" if abs(var - float(bb.ODE_VARIANCE))
                     <= 1.0000001e-8 else "FAIL"))
            if not abs(var - float(bb.ODE_VARIANCE)) <= 1.0000001e-8:
                raise SystemExit("broadband ode: white-noise variance")
        for i, golden in enumerate(bb.GOLDENS[mode]):
            head, want = golden.split(" = ")
            line = next((l for l in log.lines if l.startswith(head + " = ")),
                        "")
            got = line[len(head) + 3:].split()[0] if line else "nan"
            total += 1
            if log.contains(golden):
                exact += 1
                print("broadband %s: %s = %s exact" % (mode, head, got))
            elif line and near(float(got), float(want)):
                print("broadband %s: %s = %s (unrounded %.9g) against %s: "
                      "one unit in the last digit" % (mode, head, got,
                                                      raw[i], want))
            else:
                raise SystemExit("broadband %s: %s = %s, want %s"
                                 % (mode, head, got, want.strip()))
    print("broadband: %d of %d lines exact, the rest within one unit of "
          "the last printed digit" % (exact, total))


def read_by_id(path, dataset="1", columns=("Position", "Velocity")):
    """(ids, *columns) of one species, sorted by id."""
    import numpy as np
    from fastpm_torch.io.bigfile import BigFile
    bf = BigFile(path)
    ids = bf.open_block(dataset + "/ID").read_all().reshape(-1)
    o = np.argsort(ids)
    return (ids[o],) + tuple(
        bf.open_block("%s/%s" % (dataset, c)).read_all()[o] for c in columns)


def ncdm_lua(tmp, name, nc=None, box=None):
    """tests/fixtures/ncdm.lua with its table paths pointed at FIXTURES
    and its outputs at tmp/name; nc and boxsize replaced when given.
    Returns (path of the Lua file, output directory)."""
    out = os.path.join(tmp, name)
    src = open(os.path.join(FIXTURES, "ncdm.lua")).read()
    src = re.sub(r'"[^"]*/(\w+\.txt)"',
                 lambda m: '"%s"' % os.path.join(FIXTURES, m.group(1)), src)
    if nc is not None:
        src = re.sub(r"(?m)^nc = .*$", "nc = %d" % nc, src)
        src = re.sub(r"(?m)^boxsize = .*$", "boxsize = %r" % box, src)
    return (write_lua(os.path.join(tmp, name + ".lua"),
                      src.replace("OUTDIR", out)), out)


def device_agreement(dev, tmp, nc=32, box=96.0):
    """Phase 6: the same 32^3 run on the CPU and on the card agree by id
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


def ncdm_agreement(dev, tmp, nc=16, box=128.0):
    """Phase 6, second case: tests/fixtures/ncdm.lua on the CPU and on
    the card. Both species agree by id to 1e-4 of a cell in position and
    1e-4 of the rms in velocity, and 2/Mass to 1e-6 relative."""
    import numpy as np
    from fastpm_torch import cli
    snaps = {}
    for where in ("cpu", dev):
        conf, out = ncdm_lua(tmp, "ncdm_agree_%s" % where)
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main([conf], device=where)
        snaps[where] = os.path.join(out, "fastpm_1.0000")
    for dataset, cols in (("1", ("Position", "Velocity")),
                          ("2", ("Position", "Velocity", "Mass"))):
        a, b = (read_by_id(snaps[w], dataset, cols) for w in ("cpu", dev))
        dx = b[1] - a[1]
        dx -= np.round(dx / box) * box
        ex = float(np.abs(dx).max()) / (box / nc)
        ev = float(np.abs(b[2] - a[2]).max() / a[2].std())
        em = (float(np.abs(b[3] / a[3] - 1).max()) if dataset == "2"
              else 0.0)
        print("device agreement ncdm.lua dataset %s (%d particles): max "
              "|dx| %.3g cell, max |dv| %.3g rms, max mass rel err %.3g"
              % (dataset, len(a[0]), ex, ev, em))
        if not (np.array_equal(a[0], b[0]) and ex < 1e-4 and ev < 1e-4
                and em < 1e-6):
            raise SystemExit("ncdm device agreement failed")


def main_path(dev, tmp, nc=256, box=768.0, nstep=5):
    """Phase 7: the main path at full size through run_fastpm; returns
    the launch counts of the run, the solver and its force mesh."""
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
    reset_peak()
    reset_launches()
    t0 = time.perf_counter()
    log = Log(echo=False)
    solver = cli.run_fastpm(load_params(conf), log=log, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()

    nforce = nstep
    print("main path: %d^3 particles, %d^3 force mesh, %d force steps, "
          "wall %.2f s (IC, 2LPT, steps, P(k), snapshot)"
          % (nc, 2 * nc, nforce, wall))
    print("main path: launches K1 cic_paint %d (want %d), K2 cic_readout "
          "%d (want %d = force steps + 6 LPT readouts), K3 %d and K4 %d "
          "(want 0)" % (launches["cic_paint"], nforce,
                        launches["cic_readout"], nforce + 6,
                        launches["cic_paint_into"],
                        launches["cic_readout3"]))
    print("main path: max_memory_allocated %.3f GB"
          % (peak / 1e9))
    if launches != dict({k: 0 for k in KERNELS}, cic_paint=nforce,
                        cic_readout=nforce + 6):
        raise SystemExit("main path did not run through K1 / K2 alone: %s"
                         % launches)

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
    force_ms = time_ms(lambda: gravity.compute_force_carry(
        pm, painter, store.wrap(pm.BoxSize)), reps=5)
    print("main path: force step %.2f ms (sort + K1 + FFTs + K2) = "
          "%.4g particle-steps/s" % (force_ms, nc ** 3 / force_ms * 1e3))
    profile_force(lambda: gravity.compute_force_carry(
        pm, painter, store.wrap(pm.BoxSize)))
    # K1 and K2 alone on the z = 0 state in cell order, as the force
    # paints and reads out
    mesh, inv = tuple(pm.Nmesh), pm.InvCellSize
    x = store.wrap(pm.BoxSize).x
    x = x[cic.sort_by_cell(x, mesh, inv)].contiguous()
    fields = [torch.randn(mesh, device=dev) for _ in range(3)]
    err = check_close("K1 cic_paint at the z = 0 state in cell order",
                      cic.cic_paint(x, mesh, inv),
                      cic.cic_paint_plain(x, mesh, inv))
    rows = {"cic_paint": dict(ms_z0=time_ms(
                lambda: cic.cic_paint(x, mesh, inv)), err=err),
            "cic_readout": dict(ms_z0=time_ms(
                lambda: cic.cic_readout(fields, x, inv)))}
    print("main path: at the z = 0 state in cell order K1 kernel_ms %.4f, "
          "K2 (3 fields) kernel_ms %.4f" % (rows["cic_paint"]["ms_z0"],
                                            rows["cic_readout"]["ms_z0"]))
    del x, fields
    return launches, solver, pm, rows


def ncdm_path(dev, tmp, nc=256, box=768.0):
    """Phase 8: ncdm.lua's physics at full width through run_fastpm;
    returns the launch counts of the run."""
    import numpy as np
    import torch
    from fastpm_torch import cli, gravity
    from fastpm_torch.config.params import load_params
    from fastpm_torch.diagnostics import Log
    from fastpm_torch.painter import Painter
    from fastpm_torch.units import RHO_CRIT

    conf, out = ncdm_lua(tmp, "ncdm_full", nc=nc, box=box)
    params = load_params(conf)
    nforce = len(params.time_step)
    reset_peak()
    reset_launches()
    t0 = time.perf_counter()
    log = Log(echo=False)
    solver = cli.run_fastpm(params, log=log, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    cdm, nu = solver.species["cdm"], solver.species["ncdm"]
    n = cdm.np_local + nu.np_local
    print("ncdm path: %d CDM + %d ncdm particles, %d^3 force mesh, %d "
          "force steps, wall %.2f s (ICs and 2LPT of both species, steps, "
          "P(k), snapshot)" % (cdm.np_local, nu.np_local, 2 * nc, nforce,
                               wall))
    want = dict({k: 0 for k in KERNELS}, cic_readout=6 + 9,
                cic_paint_into=2 * nforce, cic_readout3=2 * nforce,
                cell_order=2 * nforce)
    print("ncdm path: launches %s (want %s: the cell order, K3 and K4 "
          "twice per force step, K2 = 6 CDM + 9 ncdm 2LPT readouts)"
          % (launches, want))
    print("ncdm path: max_memory_allocated %.3f GB" % (peak / 1e9))
    if launches != want:
        raise SystemExit("ncdm path did not run through its cell order, "
                         "K3 and K4")

    snap = os.path.join(out, "fastpm_1.0000")
    for dataset, count in (("1", cdm.np_local), ("2", nu.np_local)):
        ids, x, v = read_by_id(snap, dataset)
        if not (np.array_equal(ids, np.arange(count))
                and np.isfinite(x).all() and np.isfinite(v).all()
                and x.min() >= 0 and x.max() < box):
            raise SystemExit("ncdm path: bad snapshot dataset %s" % dataset)
    mass = read_by_id(snap, "2", ("Mass",))[1].astype(np.float64)
    want_mass = solver.cosmology.Omega_ncdm * RHO_CRIT * box ** 3
    rel = abs(mass.sum() / want_mass - 1)
    print("ncdm path: 2/Mass sum %.10g, Omega_ncdm RHO_CRIT L^3 %.10g, "
          "rel err %.3g" % (mass.sum(), want_mass, rel))
    if not ((mass > 0).all() and rel < 1e-5):
        raise SystemExit("ncdm path: bad ncdm masses")
    pk_files = sorted(f for f in os.listdir(out)
                      if f.startswith("powerspec_"))
    if len(pk_files) != nforce or not all(
            np.isfinite(np.loadtxt(os.path.join(out, f), comments="#")).all()
            for f in pk_files):
        raise SystemExit("ncdm path: bad power spectrum output")
    print("ncdm path: %s, last line of the log: %s"
          % (pk_files, log.lines[-1]))

    # the multi-species force step alone, on the z=0 state
    pm = solver.find_pm(1.0)
    painter = Painter(pm, "cic")
    stores = [p.wrap(pm.BoxSize) for p in (cdm, nu)]

    def step():
        return gravity.compute_force(pm, painter, stores)

    force_ms = time_ms(step, reps=5)
    print("ncdm path: force step %.2f ms (cell sorts, K3 x 2 + FFTs + K4 "
          "x 2) = %.4g particle-steps/s (N = %.1f M)"
          % (force_ms, n / force_ms * 1e3, n / 1e6))
    prof = profile_force(step)
    print("ncdm path: in the force step's profile K3 (deposit_kernel) "
          "%.4f ms, K4 (readout_kernel) %.4f ms"
          % (prof.get("deposit_kernel", 0.0), prof.get("readout_kernel", 0.0)))
    return launches, store_order_rows(dev, pm, stores)


def store_order_rows(dev, pm, stores, reps=10):
    """Phase 8, K3 and K4 in the ncdm path's own store order (its z = 0
    stores): K3 against its plain version, the cell sort's time apart,
    and the force step's K3 + sort + gathers + K4 + scatter back as one
    device-time sum. Returns the rows' entries."""
    import numpy as np
    import torch
    from fastpm_torch.ops import cic

    mesh, inv = tuple(pm.Nmesh), pm.InvCellSize
    xs = [p.x for p in stores]
    masses = [float(np.float32(stores[0].M0)), stores[1].mass]
    fields = [torch.randn(mesh, device=dev) for _ in range(3)]
    canvas = torch.zeros(mesh, device=dev)

    def order():
        return [cic.cell_order(x, mesh, inv) for x in xs]

    def paint(orders, fn=cic.cic_paint_into):
        for x, m, o in zip(xs, masses, orders):
            fn(canvas, x, inv, m, *([o] if o is not None else []))

    def read(orders):
        return [cic.cic_readout3(*fields, x, inv, o)
                for x, o in zip(xs, orders)]

    def whole():
        orders = order()
        paint(orders)
        return read(orders)

    orders = order()
    check_order("in the ncdm path's store order", xs, orders, mesh, inv)
    paint(orders)
    want = canvas.clone().zero_()
    for x, m in zip(xs, masses):
        cic.cic_paint_into_plain(want, x, inv, m)
    err = check_close("K3 cic_paint_into, the ncdm path's store order, "
                      "given the cell orders", canvas, want)
    del want
    r3 = dict(err=err, ms_store_order=time_ms(lambda: paint(orders), reps),
              ms_own_order_store_order=time_ms(lambda: paint([None, None]),
                                               reps))
    ro = dict(ms_store_order=time_ms(order, reps))
    r4 = dict(ms_store_order=time_ms(lambda: read([None, None]), reps),
              ms_given_order_store_order=time_ms(lambda: read(orders), reps))
    total = time_ms(whole, reps)
    print("ncdm path, store order, both species: the cell order %.4f ms; "
          "given the orders K3 %.4f ms, K4 + gather + scatter back %.4f ms "
          "(K4 in store order %.4f); K3 ordering its rows itself %.4f ms"
          % (ro["ms_store_order"], r3["ms_store_order"],
             r4["ms_given_order_store_order"], r4["ms_store_order"],
             r3["ms_own_order_store_order"]))
    print("ncdm path: the cell order + K3 + K4 + gather + scatter back, as "
          "the force step runs them: %.4f ms of device time (the parts: "
          "%.4f; before the shared order K3 + K4 took 6.18 ms, PERF.md)"
          % (total, ro["ms_store_order"] + r3["ms_store_order"]
             + r4["ms_given_order_store_order"]))
    r3["sum_ms_store_order"] = total
    return {"cic_paint_into": r3, "cic_readout3": r4, "cell_order": ro}


def homed_force(dev, store, pm, reps=5):
    """Phase B: the homed slab force at full width on a one-rank NCCL
    group, from the main path's z = 0 state. Returns the launch counts
    of the four force runs (from8 / from4, carry / multi)."""
    import socket
    import numpy as np
    import torch
    import torch.distributed as dist
    from fastpm_torch import gravity
    from fastpm_torch.painter import Painter
    from fastpm_torch.parallel.comm import Ring
    from fastpm_torch.parallel.pfft import SlabPM
    from fastpm_torch.parallel import psolver

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method="tcp://localhost:%d" % port,
                            rank=0, world_size=1)
    try:
        ones = torch.ones(1, device=dev)
        dist.all_reduce(ones)
        ring = Ring(dist.group.WORLD)
        spm = SlabPM(pm, ring)
        store = store.wrap(pm.BoxSize)
        # the measurement (0 on one rank: every particle is in its
        # slab) and one plane of slack over at least 1, as pick_halo
        H = max(1, psolver.required_halo_planes(pm, ring, store.x)) + 1
        m0 = float(np.float32(store.M0))
        n = store.np_local
        print("homed force: one-rank NCCL group (all_reduce %g), %d "
              "particles, %d^3 mesh, H = %d, extended slab %d planes"
              % (float(ones), n, pm.Nmesh[0], H, pm.Nmesh[0] + 2 * H + 1))

        def carry(hk):
            p, bad, _dk = psolver._force_local_homed_carry(
                spm, store, "1_4", H, homed_kernel=hk)
            return p.id, p.acc, bad

        def multi(hk):
            (acc,), bad, _dk = psolver._force_local_homed_multi(
                spm, (store.x,), (m0,), "1_4", H, homed_kernel=hk)
            return store.id, acc, bad

        ref, _dk = gravity.compute_force_carry(pm, Painter(pm, "cic"), store)
        want = ref.acc[torch.argsort(ref.id)]
        scale = float(want.abs().max())
        torch.cuda.synchronize()
        reset_launches()
        results = {}
        for hk in ("from8", "from4"):
            for body, fn in (("carry", carry), ("multi", multi)):
                ids, acc, bad = fn(hk)
                results[hk, body] = (ids, acc, bad)
        torch.cuda.synchronize()
        launches = read_launches()
        print("homed force: launches %s" % {k: launches[k] for k in HOMED})
        if not all(launches[k] == 2 for k in HOMED):
            raise SystemExit("homed force did not run through the homed "
                             "kernels")
        for (hk, body), (ids, acc, bad) in results.items():
            err = float((acc[torch.argsort(ids)] - want).abs().max())
            print("homed force %s %s: bad %d, max |dacc| %.3g = %.3g of "
                  "max |acc| %.4g (bound 1e-5)"
                  % (hk, body, int(bad), err, err / scale, scale))
            if int(bad) != 0 or not err <= 1e-5 * scale:
                raise SystemExit("homed force %s %s disagrees with the "
                                 "single-device force" % (hk, body))
        del results, ref
        for label, step in (
                ("single-device compute_force_carry",
                 lambda: gravity.compute_force_carry(
                     pm, Painter(pm, "cic"), store)),
                ("homed from8 carry", lambda: carry("from8")),
                ("homed from8 multi", lambda: multi("from8")),
                ("homed from4 carry", lambda: carry("from4")),
                ("homed from4 multi", lambda: multi("from4"))):
            reset_peak()
            ms = time_ms(step, reps)
            print("homed force: %s %.2f ms = %.4g particle-steps/s, peak "
                  "%.3f GB" % (label, ms, n / ms * 1e3,
                               torch.cuda.max_memory_allocated() / 1e9))
        profile_force(lambda: carry("from8"))
    finally:
        dist.destroy_process_group()
    return launches


def check_merge(dev, x0, v0, pm, B=32768, reps=10):
    """Phase C: K7 at the carry sort's shapes. x0, v0: the benchlib
    particles; pm their force mesh. Returns K7's row for the JSON line
    (its launch count is filled in after phase D)."""
    import torch
    from fastpm_torch import benchlib
    from fastpm_torch.ops import cic, sort

    # one order-free step: its rows come in the cell order of its input
    x, v, _ = benchlib.make_step_fn(pm, device=dev)(x0, v0, (0.05, 0.02))
    key = cic.cell_key(x, pm.Nmesh, pm.InvCellSize)
    n = key.shape[0]
    pays = [c.contiguous() for c in list(x.unbind(1)) + list(v.unbind(1))]
    cols = sort.block_sort([key] + pays, B)
    torch.cuda.synchronize()
    got = sort.merge_pairs(*cols, B=B)
    want = sort.merge_pairs_plain(*cols, B=B)
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    sorted2b = bool((got[0].view(-1, 2 * B).diff(dim=1) >= 0).all())
    print("K7 merge_pairs: %d rows, B = %d, 6 payloads: equal to the plain "
          "version %s (max_abs_err %.3g), every 2B-run ascending %s"
          % (n, B, same, err, sorted2b))
    if not (same and sorted2b):
        raise SystemExit("K7 disagrees with its plain version")
    del got, want

    # the fast path on k-sorted unique keys (rows displaced < B / 3), and
    # the guarded sort on the step's keys, against torch.sort: an index
    # column (float32, exact below 2^24 rows) shows the rows permuted
    g = torch.Generator(device=dev).manual_seed(41)
    vals = torch.arange(n, device=dev) * 7 + torch.randint(
        -7 * (B // 3), 7 * (B // 3), (n,), generator=g, device=dev)
    ranks = torch.empty(n, dtype=torch.int32, device=dev)
    ranks[torch.sort(vals, stable=True).indices] = torch.arange(
        n, dtype=torch.int32, device=dev)
    idx = torch.arange(n, dtype=torch.float32, device=dev)
    (k, *ps, i), ok = sort.sort_ksorted([ranks] + pays + [idx], B)
    i = i.long()
    fast_ok = (bool(ok) and torch.equal(k, torch.sort(ranks).values)
               and torch.equal(ranks[i], k)
               and all(torch.equal(p[i], q) for p, q in zip(pays, ps)))
    _, step_ok = sort.sort_ksorted([key] + pays, B)
    (k, *ps, i) = sort.sort_maybe_ksorted([key] + pays + [idx], B)
    i = i.long()
    guarded_ok = (torch.equal(k, torch.sort(key).values)
                  and torch.equal(torch.sort(i).values,
                                  torch.arange(n, device=dev))
                  and torch.equal(key[i], k)
                  and all(torch.equal(p[i], q) for p, q in zip(pays, ps)))
    print("sort_ksorted on k-sorted unique keys: flag %s, equal to "
          "torch.sort with the rows permuted %s; on the step's cell keys: "
          "flag %s, sort_maybe_ksorted equal to torch.sort %s"
          % (bool(ok), fast_ok, bool(step_ok), guarded_ok))
    if not (fast_ok and guarded_ok):
        raise SystemExit("the k-sorted sort disagrees with torch.sort")
    del k, ps, i, ranks, vals

    def rows_sort():
        # one PyTorch call per column for a merge pass's function: sort
        # the 2B-runs, gather the payloads
        kr, o = torch.sort(cols[0].view(-1, 2 * B), dim=1)
        return [kr] + [p.view(-1, 2 * B).gather(1, o) for p in cols[1:]]

    def full_sort():
        kf, o = torch.sort(key, stable=True)
        return [kf] + [p[o] for p in pays]

    row = dict(err=err)
    row["ms"] = time_ms(lambda: sort.merge_pairs(*cols, B=B), reps)
    row["plain_ms"] = time_ms(lambda: sort.merge_pairs_plain(*cols, B=B), 3)
    row["library_ms"] = time_ms(rows_sort, reps)
    row["library_ms_full_sort"] = time_ms(full_sort, reps)
    ksorted_ms = time_ms(lambda: sort.sort_maybe_ksorted([key] + pays, B),
                         reps)
    carry = {b: time_ms(lambda: sort.carry_sort(x, v, pm.Nmesh,
                                                pm.InvCellSize, b), reps)
             for b in (B, None)}
    # a pass reads and writes the key and 6 payloads once
    row["bound"] = bound_ms(2 * 28 * n, 0)
    print("merge_pairs: kernel_ms %.4f plain_ms %.4f library_ms %.4f "
          "(torch.sort of the 2B-runs + 6 gathers) full sort + 6 gathers "
          "%.4f ms bound_ms %.4f (%s)"
          % (row["ms"], row["plain_ms"], row["library_ms"],
             row["library_ms_full_sort"], *row["bound"]))
    print("k-sorted sort on the step's keys (block sort, 2 merges, flag%s) "
          "%.4f ms; carry_sort with sort_block %d %.4f ms, full %.4f ms"
          % (", full sort" if not bool(step_ok) else "", ksorted_ms, B,
             carry[B], carry[None]))
    return {"merge_pairs": row}


def benchlib_path(dev, x0, v0, pm, nstep=5, B=32768, every=3):
    """Phase D: the benchlib step at full width, 5 steps of each variant
    from (x0, v0). Returns the launch counts of each variant's run."""
    import torch
    from fastpm_torch import benchlib
    from fastpm_torch.ops import cic, sort

    coeffs = torch.tensor([0.05, 0.02], device=dev)
    n = x0.shape[0]
    fresh, stale = benchlib.make_stale_step_fns(pm, device=dev)
    steps = {"base": benchlib.make_step_fn(pm, device=dev),
             "sb%d" % B: benchlib.make_step_fn(pm, sort_block=B,
                                               device=dev),
             "paint4": benchlib.make_step_fn(pm, paint8=False, device=dev)}
    runs = {name: [fn] * nstep for name, fn in steps.items()}
    runs["stale%d" % every] = [fresh if i % every == 0 else stale
                               for i in range(nstep)]
    zero = {k: 0 for k in KERNELS}
    nfresh = len(range(0, nstep, every))
    want = {"base": dict(zero, cic_paint=nstep, cic_readout=nstep),
            "sb%d" % B: dict(zero, cic_paint=nstep, cic_readout=nstep,
                             merge_pairs=2 * nstep),
            "paint4": dict(zero, cic_paint4=nstep, cic_readout=nstep),
            "stale%d" % every: dict(zero, cic_paint=nstep,
                                    cic_readout=nstep)}
    sorts = dict.fromkeys(runs, nstep)
    sorts["stale%d" % every] = nfresh
    finals, launches = {}, {}
    for name, run in runs.items():
        run[0](x0, v0, coeffs)               # warm-up (cuFFT plans)
        reset_peak()
        reset_launches()
        t0 = time.perf_counter()
        x, v = x0, v0
        for step in run:
            x, v, acc = step(x, v, coeffs)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / nstep
        launches[name] = read_launches()
        print("benchlib %s: %d steps, %.2f ms a step = %.4g particle-steps/s, "
              "peak %.3f GB; carry sorts %d (want %d), full sorts forced by "
              "the k-sorted flag %d; launches %s"
              % (name, nstep, ms, n / ms * 1e3,
                 torch.cuda.max_memory_allocated() / 1e9,
                 sort.carry_sort.calls, sorts[name],
                 sort.sort_maybe_ksorted.fallbacks,
                 {k: c for k, c in launches[name].items() if c}))
        if (launches[name] != want[name]
                or sort.carry_sort.calls != sorts[name]):
            raise SystemExit("benchlib %s did not run through its kernels: "
                             "%s" % (name, launches[name]))
        finals[name] = (x, v)

    # 1. the trajectories: each variant's cells against base's. A
    # particle within an ulp of a cell face may land on either side of
    # it (f32 atomics in the paint), so a few may differ; counted
    def hist(x):
        return torch.bincount(cic.cell_key(x, pm.Nmesh, pm.InvCellSize),
                              minlength=int(pm.Norm))
    hb = hist(finals["base"][0])
    for name in runs:
        if name == "base":
            continue
        moved = int((hist(finals[name][0]) - hb).abs().sum()) // 2
        print("benchlib %s after %d steps: %d of %d particles in another "
              "cell than base's (bound 16)" % (name, nstep, moved, n))
        if moved > 16:
            raise SystemExit("benchlib %s disagrees with base" % name)
    del hb

    # 2. one step of each variant from base's final state: acc row by row
    # in base's (stable) sort order, or per cell for the k-sorted sort,
    # whose rows of one cell come in another order
    xb, vb = finals["base"]
    del finals
    key = cic.cell_key(xb, pm.Nmesh, pm.InvCellSize)
    ks, order = torch.sort(key, stable=True)
    seg = torch.cat([ks.new_zeros(1),
                     torch.cumsum((ks[1:] != ks[:-1]).int(), 0)]).long()

    def per_cell(acc):
        return torch.zeros((int(seg[-1]) + 1, 3), device=dev).index_add_(
            0, seg, acc)

    _, _, want_acc = steps["base"](xb, vb, coeffs)
    scale = float(want_acc.abs().max())
    for name, got, ref in (
            ("sb%d" % B, per_cell(steps["sb%d" % B](xb, vb, coeffs)[2]),
             per_cell(want_acc)),
            ("paint4", steps["paint4"](xb, vb, coeffs)[2], want_acc),
            ("stale%d" % every, stale(xb, vb, coeffs)[2][order], want_acc)):
        err = float((got - ref).abs().max())
        print("benchlib %s, one step from base's state: max |dacc| %.3g = "
              "%.3g of max |acc| %.4g (bound 1e-5)"
              % (name, err, err / scale, scale))
        if not err <= 1e-5 * scale:
            raise SystemExit("benchlib %s disagrees with base" % name)
    return launches


def stale_force(solver, pm, reps=5):
    """Phase D, last part: the stale force against the carry force on the
    main path's z = 0 state (in its carried order) moved by one more
    drift of the path's step size."""
    import torch
    from fastpm_torch import gravity
    from fastpm_torch.kdk import DriftFactor
    from fastpm_torch.ops import cic
    from fastpm_torch.painter import Painter

    painter = Painter(pm, "cic")
    store = solver.species["cdm"].wrap(pm.BoxSize)
    drift = DriftFactor(solver.cosmology, solver.config.force_mode, 1.0,
                        1.1125, 1.225)
    store = solver.drift_one(store, drift, 1.225).wrap(pm.BoxSize)
    carried, _ = gravity.compute_force_carry(pm, painter, store)
    stale, _ = gravity.compute_force_stale(pm, painter, store)
    want = carried.acc[torch.argsort(carried.id)]
    err = float((stale.acc[torch.argsort(stale.id)] - want).abs().max())
    scale = float(want.abs().max())
    print("stale force on the drifted z = 0 state: max |dacc| against the "
          "carry force %.3g = %.3g of max |acc| %.4g (bound 1e-5)"
          % (err, err / scale, scale))
    if not err <= 1e-5 * scale:
        raise SystemExit("the stale force disagrees with the carry force")
    del carried, stale, want
    mesh, inv = tuple(pm.Nmesh), pm.InvCellSize
    fields = [torch.randn(mesh, device=store.x.device) for _ in range(3)]
    err = check_close("K1 cic_paint at the carried order drifted one step",
                      cic.cic_paint(store.x, mesh, inv),
                      cic.cic_paint_plain(store.x, mesh, inv))
    rows = {"cic_paint": dict(err=err, ms_stale_carried=time_ms(
                lambda: cic.cic_paint(store.x, mesh, inv))),
            "cic_readout": dict(ms_stale_carried=time_ms(
                lambda: cic.cic_readout(fields, store.x, inv)))}
    print("stale force: at the carried order drifted one step K1 "
          "kernel_ms %.4f, K2 (3 fields) kernel_ms %.4f"
          % (rows["cic_paint"]["ms_stale_carried"],
             rows["cic_readout"]["ms_stale_carried"]))
    del fields
    n = store.np_local
    for label, fn in (("carry", gravity.compute_force_carry),
                      ("stale", gravity.compute_force_stale)):
        ms = time_ms(lambda: fn(pm, painter, store), reps)
        print("%s force step on the drifted z = 0 state: %.2f ms = %.4g "
              "particle-steps/s" % (label, ms, n / ms * 1e3))
        profile_force(lambda: fn(pm, painter, store))
    return rows


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
    # device ms a step by the port's kernels, for the paths' summaries
    return {name: sum(us for key, us, _ in rows if name in key) / 1e3
            for name in ("deposit_kernel", "readout_kernel")}


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

    t_start = t0 = time.perf_counter()
    cudalib.get_lib(verbose=True)
    print("build: %.1f s for %s" % (time.perf_counter() - t0,
                                    [os.path.relpath(s, ROOT)
                                     for s in cudalib.SOURCES]))

    rows = check_kernels(dev)
    rows.update(check_kernels_ncdm(dev))
    rows.update(check_kernels_homed(dev))
    check_readout_edges(dev, rows)
    # the benchlib particles and mesh of phases C and D
    from fastpm_torch import benchlib
    from fastpm_torch.mesh import PM
    nc = 256
    bpm = PM(2 * nc, float(nc), device=dev)
    x0, v0 = benchlib.example_particles(nc, float(nc), device=dev)
    rows.update(check_merge(dev, x0, v0, bpm))
    with tempfile.TemporaryDirectory() as tmp:
        golden(dev, tmp)
        broadband(dev)
        device_agreement(dev, tmp)
        ncdm_agreement(dev, tmp)
        # each path's launches are read from its own run
        launches, solver, pm, more = main_path(dev, tmp)
        ncdm_launches, more_ncdm = ncdm_path(dev, tmp)
    homed_launches = homed_force(dev, solver.species["cdm"], pm)
    bench_launches = benchlib_path(dev, x0, v0, bpm)
    del x0, v0
    more_stale = stale_force(solver, pm)
    del solver
    for extra in (more, more_ncdm, more_stale):
        for name, r in extra.items():
            err = max(rows[name]["err"], r.pop("err", 0.0))
            rows[name].update(r, err=err)
    for name in ("cic_paint_into", "cic_readout3", "cell_order"):
        launches[name] = ncdm_launches[name]
    for name in HOMED:
        launches[name] = homed_launches[name]
    launches["merge_pairs"] = bench_launches["sb32768"]["merge_pairs"]
    rows["cic_paint4"]["launches_periodic"] = (
        bench_launches["paint4"]["cic_paint4"])

    kernels = []
    for name, r in rows.items():
        source, replaces = KERNELS[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1],
            # K1 and K3: no single PyTorch call deposits with CIC
            # weights (index_add_ needs the corners and weights first,
            # which is the plain version); cell_order: torch.sort of the
            # line keys
            "library_ms": r.get("library_ms")})
        # the other rows of each kernel (K7 has no clustered case: a
        # sorting network does not depend on the data)
        for key, val in r.items():
            if key not in ("err", "bound") and key not in kernels[-1]:
                kernels[-1][key] = val
    print("chip_smoke: every phase, the build included, in %.1f s"
          % (time.perf_counter() - t_start))
    print(json.dumps({"kernels": kernels}))
    print(card)
    # the run used one device, whatever else the machine holds
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
