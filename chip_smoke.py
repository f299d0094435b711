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
   (cell_order, the stable radix sort by line of csrc/cic_bin.cu, equal
   to its plain version bit for bit): against the plain versions, the
   total mass, K4's rows bit for bit, and the same timings, the order's
   apart (torch.sort of the line keys its yardstick); then cell_order
   against its plain version on its edge cases (n = 0, 1, a tile's edge,
   ties in store order and shuffled, a lattice; one to three digit
   passes);
5. golden: tests/fixtures/nbodykit.lua through fastpm_torch.cli.main
   writes 1894 FOF objects at a = 0.6667 and 1668 at a = 1.0 through
   the device FOF (fof_link launched), and logs the input
   sigma8 0.815897; the LCDM and ODE broadband series of
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
   and K5 on the same geometries, periodic and on the slab, with a
   scalar mass and a mass column (the rows beyond the slab counted
   once, the mass conserved);
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
   then K7 against its plain version, bit for bit, on the cases of
   fastpm_torch/ops/merge_cases.py (B = 128 ... 65536, n = 2B and 8B,
   0-8 payloads; unique, equal and 4-valued keys) and on columns 4
   bytes past a 16-byte boundary;
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
E. halos at full width, on the main path's z = 0 state (16.8 M rows, box
   768, ll 0.6): the device FOF's labels bit-equal to the host
   union-find, the device catalog against the host catalog (lengths,
   minid and ihalo exact; the float columns within atol 1e-4); the
   labels' steps timed apart (the column ids and sort, the gather,
   fof_link of csrc/fof_link.cu and its kernels by torch.profiler, the
   least original index); fof_link against fof_link_plain, bit for bit,
   on a clustered slab of the state (x < box / 8) and on the slab with
   4000 rows in one linking cell (whose labels also equal the host's);
   find_halos on an open box (the slab moved outside the box) against
   the host; find_halos device against host;
F. the lightcone goldens: tests/fixtures/lightcone.lua,
   lightcone-healpix.lua and lightcone-rfof.lua through cli.main on the
   card; every golden line of tests/test_golden_lightcone.py is logged
   (usmesh slices, HEALPix pixel counts, z = 0 FOF and RFOF objects);
G. this slice's path at full width: lightcone.lua's physics and
   lightcone settings at nc = 256, boxsize = 2048 (its 8 Mpc/h mean
   separation; 8 steps, 4^3 tiles, the potential and tidal tensor,
   write_fof, HEALPix maps at nside 32) through run_fastpm: wall s, rows
   crossed and written, tile-solve ms per interval, device-FOF ms per
   call, peak memory; the launch counters show the force went through
   the cell order, K3 and K4 (acc, potential, two tidal triples) and
   every FOF through fof_link; every HEALPix device pixel
   that differs from the float64 host pixel is flagged;
H. the force modes at the main path's width: phase 7's physics at nc =
   256, boxsize = 768 on a 512^3 force mesh, 5 steps, once each in
   cola, za and 2lpt and once in cola with PGD (alpha0 0.8, A 4, B 8,
   kl 2, ks 10): each run's force actions (CUDA events), wall s, peak
   memory and launches (K1 once a step, K2 once a step and once more for
   PGD); the carry force step alone on each z = 0 state, and PGD's step
   with its three c2r and its K2 launch apart; first, cola with PGD at
   32^3 on the CPU and on the card agree by id;
I. the neutrino linear response: tests/test_lra.py's LRA_RUN physics at
   nc = 256 (box 1024) on a 512^3 force mesh, 5 steps, through
   run_fastpm; the force step with the response against the plain one,
   its host part (the measure_power fetch, update_from_power) apart,
   the idle share over 2 steps; measure_power's binning of the 512^3
   delta_k on the card (float64 sums into copies of the bins) against
   the host's float64 and float32 sums of the same field; then at 64^3 a straight run and a run
   restarted from its a = 0.6 snapshot agree by id and in history;
J. the 10 cross-mode broadband lines of tests/test_modes.py (64^3, 8
   steps) on the card, each exact or within one unit of its last printed
   digit; fNL-local and two peak constraints through cli.prepare_deltak
   at 64^3 on the card against the CPU, and timed at 256^3; then the
   card's pm and za runs fed the LPT columns the port computed on the
   CPU, each line printed beside the CPU's and the card's own (the
   witness of where the one-unit lines come from);
K. the CLI's files, flags and tools at the main path's width (phase 7's
   physics, 256^3 on 512^3, 5 steps): run 1 through cli.main with -T 1
   -f -m <bound> --profile <dir> writes the white noise, the linear field
   in k and real space, the nonlinear density (K3 and the cell order), a
   RunPB snapshot and the FOF catalog (fof_link); the files' attributes,
   the trace's kernel names, the memory lines and the clocks' table are
   checked; -m below the run's bytes in use ends in MemoryBoundExceeded;
   run 2 from run 1's LinearDensityK agrees with it by id; the tools fof
   (its catalog equal to run 1's), power and paint at 512^3, halobias and
   comparehalos (the cross-correlation of equal catalogs 1) on run 1's
   z = 0 snapshot, each with its wall time, peak memory and launches;
   read_runpbic at 64^3 on the card against the CPU; the main force step
   with the clocks on the card (prof.enable_sync: CUDA events) against
   the step without them, the least block of 10 steps of each over 6
   alternated rounds;
L. the pencil (2D) decomposition: the open-y mode of homed K1, K5, K2
   and K6 (a Pencil) at full width: a 512^3 mesh, box 768, the 16.8 M
   rows of a jittered 256^3 lattice, the extended pencils of ranks (1,
   0) and (0, 1) of a 2 x 2 grid with Hx = Hy = 8 (rows inside, in the
   halo bands and corners, and beyond, counted), each against its plain
   version (bad exact), with the same timings (grid_sample on the
   extended pencil the readouts' yardstick); then the pencil force on a
   one-rank NCCL process group (a 1 x 1 Grid, both rings that rank)
   from the main path's z = 0 state, the carry and the multi with from8
   and from4 at Hx = Hy = 2, against compute_force_carry by id, the
   open-y launches of the four homed kernels counted; the pencil multi
   and the slab multi with the potential and tidal tensor against
   compute_force by id; ms a step and peak memory of the pencil forces
   beside the slab's, and a torch.profiler breakdown of the pencil
   carry;
M. the options the JAX package runs on a device mesh, at full width on a
   one-rank NCCL process group, once on its ring (the slab: homed K1 and
   K2) and once on its 1 x 1 grid (the pencil: their open-y mode),
   through cli.run_fastpm and Solver with group / grid: phase I's linear
   response run against phase I's by id and history; phase H's cola +
   PGD against its pgdc (2e-3 of its largest: two card runs), and PGD
   over the group against one device on one state (1e-4); phase 7's
   physics
   restarted from its a = 0.55 snapshot against its z = 0 state by id;
   phase G's lightcone with write_rfof against its usmesh ids and FOF
   halos (the lightcone's and the z = 0 snapshot's; fof_link launched
   for RFOF too); and on the ring phase 7's
   physics with rehome=True against the dense slab carry, with the rows
   each migration hop moved. Each run's wall, force actions (CUDA
   events), peak memory and launches are printed and checked; the LRA,
   cola + PGD and rehome force steps are timed, and the LRA step and the
   rehome body profiled (device idle share);
N. (run right after phase E, on its state) the sharded FOF over ranks
   (fastpm_torch.parallel.pfof) and the public sharded step, on the main
   path's z = 0 state in id order (16.8 M rows, box 768, ll 0.6):
   fof_labels_sharded_auto on a one-rank NCCL group (every row a ghost
   of itself: a local pass over 3N rows) and on 4 gloo ranks on the one
   card (spawned processes of tests/torch_rank_workers.py, each an
   x-slab of 192, the ghosts through the host), the labels of both
   bit-equal to phase E's; walls, outer rounds, ghost_cap, the local
   pass's rows and fof_link's launches; fof_link against fof_link_plain,
   bit for bit, at rank 0's local pass, timed; one make_sharded_step on
   the group against sharded_force_fn and a kick, drift and wrap by
   hand, with its launches of K3, cell_order and K4;
O. baryons and order-preserving stepping at full width: (O1) phase 7's
   physics with SolverConfig(order_free=False) through Solver from
   prepare_deltak: the rows in id order in place at the end, x and v by
   id within 1e-3 of a cell of phase 7's order-free run, the cell order,
   K3 and K4 once a force step and K1 never, the step beside the carry
   step on phase 7's state; (O2) CDM 256^3, a baryon lattice 256^3
   shifted half a cell with a mass column and ncdm.lua's ncdm (5.24 M),
   gaussian softening, the potential and the tidal tensor, 512^3, 6
   forces: launches per species a force, every column finite, the mass
   sums, ids distinct, a CPU-against-card run at nc = 32 by id per
   species (x, v, potential, tidal; phase 6's bounds), and at its z = 0
   state cell_order, K3 (three species given their orders) and K4
   against their plain versions; (O3) O1 and O2 on a one-rank NCCL
   group, on its ring (homed-multi) and its 1 x 1 grid (O1 pencil-multi;
   O2 v1, its ncdm rows not pencil-blocked), never the carry, against
   O1 (in place too) and O2 by id within 1e-3 of a cell, O2's potential
   and tidal tensor within 1e-2 of their rms. Each run's wall, force
   actions, peak, paths and a force step are printed;
P. (last, on a card that holds nothing else; the peak counts reset
   before each rung) the JAX package's scale: the bytes torch.fft.irfftn
   and the port's c2r (ops/fft.py) allocate beyond their output at
   768^3 (irfftn copies its input; the port's plan takes it); (P1) the 384^3 B2 rung the JAX
   package ran on a 16 GB v5e: the benchlib step (make_step_fn(PM(768,
   384.0)), carry, K1 and K2, x and v donated) on
   example_particles(384, 384.0, seed=0), one warm step and 10 chained
   ones as bench.py:run_one, ms, particle-steps/s, the peak (gate: 16
   GiB) and the buffers live at the step's peak (the allocator's
   history); (P2) 512^3 on a 1024^3 mesh through cli.run_fastpm on phase
   7's Lua (box 768, seed 100; 5 steps, one snapshot at a = 1): launches
   K1 5, K2 11, no other, and the k-space kernel (ops/kspace.py) 15, 3 a
   force; the snapshot by id, then deleted; every P(k)
   bin of k < 0.1 h/Mpc within 2 % of phase 7's at the first and the
   last force (the white noise is nested across resolutions); the force
   step; K1 and K2 against their plain versions at the z = 0 state (the
   plain ones in row chunks); the k-space kernel bit-equal to its plain
   version at the 1024^3 force mesh (kernels 1_4 and eastwood, each
   axis; delta_k of the z = 0 state), timed beside its bound and the
   unfused chain it replaced; the run's transforms all through the
   port's cuFFT plans with no copy of an input (ops/fft.py: fft.stats) and the
   force's four 1024^3 transforms timed each alone; K2 timed on fields
   from the C2R plan and from irfftn, alone and right after the
   transforms (recorded, no gate); find_halos on the state (b = 0.2) and the
   device labels of the x < 48 slab bit-equal to the host union-find's;
   the run's peak and its buffers; (P3) fastpm_torch.measure_halo at
   384^3 (B2, 10 steps) and its JSON line; (P4, recorded, no gate) the
   P1 step at 640^3 on a 1280^3 mesh: whether it fits (an out-of-memory
   error is caught and reported), its peak and ms;
9. a JSON line of the kernels, the card line again, and the result line.
"""

import contextlib
import gc
import glob
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
    # K3's cell order: the stable radix sort that replaces the sort
    # make_paint_fn runs before K3's pallas_call
    "cell_order": ("fastpm_torch/csrc/cic_bin.cu",
                   "fastpm_tpu/ops/paint_pallas.py:212"),
    # the device FOF (ops.fof_device.fof_link: a column table and one
    # union-find sweep), which replaces the JAX package's neighbour sweep
    # and label rounds: XLA code, not a pallas_call
    "fof_link": ("fastpm_torch/csrc/fof_link.cu",
                 "fastpm_tpu/ops/fof_device.py:103"),
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
    from fastpm_torch.ops import cic, sort, fof_device
    if name == "fof_link":
        return fof_device.fof_link
    return getattr(sort if name == "merge_pairs" else cic, name)


def reset_peak():
    """Start a new peak-memory count with only live tensors allocated:
    what earlier phases left in reference cycles (a finished Solver is
    one) is freed first, so a path's peak does not depend on when the
    garbage collector last ran. Returns the bytes still allocated, which
    a path's own peak is counted above."""
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def reset_launches():
    """Set every kernel's launch count (the homed kernels' open-y count
    too, and the k-space kernel's), and the carry sort's call and
    fallback counts, to 0."""
    from fastpm_torch.ops import kspace, sort
    kspace.force_grad_k.launches = 0
    for name in KERNELS:
        wrapper(name).launches = 0
    for name in HOMED:
        wrapper(name).launches_open_y = 0
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
        # both: the plain version's stable order bit for bit, K3 agrees
        # as before, K4 equals its rows bit for bit
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
    """cell_order's kernel against its plain version: each order equals
    the plain version's stable sort by line, bit for bit."""
    import torch
    from fastpm_torch.ops import cic
    for x, o in zip(xs, orders):
        same = torch.equal(o.index, cic.cell_order_plain(x, mesh, inv).index)
        print("cell_order %s, %d rows: equal to the plain version %s"
              % (label, x.shape[0], same))
        if not same:
            raise SystemExit("cell_order disagrees with its plain version")


def check_order_edges(dev, nmesh=512, box=768.0):
    """cell_order against its plain version, bit for bit, on the edge
    cases of the radix sort: n = 0, 1 and rows one past a tile (4096)
    or short of one, rows on a few lines (long runs of ties) in store
    order and shuffled, a lattice in store order, and meshes of one,
    two and three digit passes."""
    import torch
    from fastpm_torch.ops import cic
    g = torch.Generator(device=dev).manual_seed(31)
    q = torch.stack(torch.meshgrid(*[torch.arange(32, device=dev)] * 3,
                                   indexing="ij"), -1).reshape(-1, 3)
    lattice = (q.float() + 0.5) * (box / 32)
    cases = []
    for count in (0, 1, 4095, 4097, 100003):
        x = torch.rand((count, 3), generator=g, device=dev) * box
        ties = x.clone()
        ties[:, :2] = torch.floor(ties[:, :2] * (3 / box)) * (box / 3)
        cases += [("uniform", x), ("ties", ties),
                  ("ties shuffled", ties[torch.randperm(
                      count, generator=g, device=dev)])]
    cases.append(("lattice, store order", lattice))
    for n in (8, 64, nmesh, 1290):
        mesh, inv = (n,) * 3, (n / box,) * 3
        for label, x in cases:
            check_order("%s, %d^3 mesh" % (label, n), [x],
                        [cic.cell_order(x, mesh, inv)], mesh, inv)


def grid_sample_ms(fields, xs, inv, nmesh, reps, slab=None):
    """A PyTorch yardstick for K2, K4 and K6, never used by the port:
    trilinear grid_sample (align_corners=True) of the three fields,
    wrap-padded by one plane per periodic axis, at each set of particles
    in xs (one call per set, timed together). With a slab the fields are
    extended slabs, open in x: the x coordinate is the plane relx plus
    the fraction; with a Pencil extended pencils, open in x and y."""
    import torch
    import torch.nn.functional as F
    from fastpm_torch.ops import cic
    nopen = 0 if slab is None else (2 if isinstance(slab, cic.Pencil)
                                    else 1)
    padded = torch.stack(fields)
    for d in range(nopen, 3):
        padded = torch.cat([padded, padded.narrow(d + 1, 0, 1)], dim=d + 1)
    padded = padded[None]
    size = torch.tensor(padded.shape[2:], device=xs[0].device)
    grids = []
    for x in xs:
        g = x * torch.tensor(inv, device=x.device)
        if slab is not None:
            base, frac, _ = cic.slab_cell(x, tuple(fields[0].shape), inv,
                                          slab)
            g = torch.cat([base[:, :nopen] + frac[:, :nopen],
                           g[:, nopen:]], dim=1)
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
          % ((" (extended slab)", " (extended pencil)")[nopen - 1]
             if slab else "", err))
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


def check_paint4_edges(dev, rows, n=64, box=128.0):
    """Phase A, K5's edge cases: the geometries of
    fastpm_torch/ops/readout_cases.py at a 64^3 mesh, periodic and on
    rank 1 of 4's extended slab with H = 2 (rows beyond it), with a
    scalar mass and a mass column, against the plain version; the
    overflow count exact, the deposited rows' mass conserved."""
    import torch
    from fastpm_torch.ops import cic
    from fastpm_torch.ops import readout_cases as cases

    count = n ** 3 // 2 + 99          # a ragged last block
    nmesh, inv = cases.mesh(n, box)
    slab, ext = cases.slab_of(n, n // 4, 2, 1)
    g = torch.Generator(device=dev).manual_seed(47)
    masses = 0.5 + torch.rand(count, generator=g, device=dev)
    runs = [(kind, cases.periodic_case(kind, n, box, count), None, nmesh)
            for kind in cases.PERIODIC]
    runs += [(kind, cases.slab_case(kind, n, box, count, slab, ext), slab,
              ext) for kind in cases.SLAB]
    for kind, pos, s, shape in runs:
        x = torch.from_numpy(pos).to(dev)
        valid = (torch.ones(count, dtype=torch.bool, device=dev)
                 if s is None else cic.slab_cell(x, shape, inv, s)[2])
        for mass, label in ((1.5, "scalar mass"), (masses, "mass column")):
            got, want = (torch.zeros(shape, device=dev) for _ in range(2))
            bad = int(cic.cic_paint4(got, x, inv, mass, s))
            bad_plain = int(cic.cic_paint4_plain(want, x, inv, mass, s))
            err = check_close("cic_paint4 edge case %s, %s (%d^3%s)"
                              % (kind, label, n, ", slab" if s else ""),
                              got, want)
            rows["cic_paint4"]["err"] = max(rows["cic_paint4"]["err"], err)
            total = (float(mass[valid].double().sum())
                     if torch.is_tensor(mass) else mass * int(valid.sum()))
            if (bad != bad_plain or bad != int((~valid).sum())
                    or abs(float(got.double().sum()) - total)
                    > 1e-6 * total):
                raise SystemExit("cic_paint4 edge case %s: overflow %d "
                                 "(plain %d) or mass not conserved"
                                 % (kind, bad, bad_plain))


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
    sweeps = wrapper("fof_link").launches
    with contextlib.redirect_stdout(buf):
        rc = cli.main([conf], device=dev)
    log = buf.getvalue()
    sweeps = wrapper("fof_link").launches - sweeps
    print("golden: nbodykit.lua (128^3, 256^3 force mesh) ran in %.1f s; "
          "the device FOF (fof_link) launched %d times"
          % (time.perf_counter() - t0, sweeps))
    if sweeps == 0:
        raise SystemExit("golden: the FOF did not run on the device")
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


def main_text(nc, box, nstep, out):
    """Phase 7's Lua text: SMALL_LUA with snapshots at a = 0.55 (the
    third of 5 steps; phase M restarts from it) and a = 1."""
    text = SMALL_LUA % dict(nc=nc, box=box, nstep=nstep, zout="0.0",
                            out=out,
                            ps=os.path.join(FIXTURES, "powerspec.txt"))
    return text.replace("output_redshifts = {0.0}", "aout = {0.55, 1.0}")


def main_path(dev, tmp, nc=256, box=768.0, nstep=5):
    """Phase 7: the main path at full size through run_fastpm; returns
    the launch counts of the run, the solver and its force mesh, the
    kernels' rows and the output directory."""
    import numpy as np
    import torch
    from fastpm_torch import cli, gravity
    from fastpm_torch.config.params import load_params
    from fastpm_torch.diagnostics import Log
    from fastpm_torch.painter import Painter
    from fastpm_torch.ops import cic

    out = os.path.join(tmp, "main")
    conf = write_lua(os.path.join(tmp, "main.lua"),
                     main_text(nc, box, nstep, out))
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
          "wall %.2f s (IC, 2LPT, steps, P(k), snapshots at a = 0.55 and 1)"
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
    return launches, solver, pm, rows, out


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
            (out,), bad, _dk = psolver._force_local_homed_multi(
                spm, (store.x,), (m0,), "1_4", H, homed_kernel=hk)
            return store.id, out["acc"], bad

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


def check_kernels_pencil(dev, nc=256, nmesh=512, box=768.0, H=8, reps=10):
    """Phase L, kernels: the open-y mode of homed K1, K5, K2 and K6 on the
    extended pencils (nmesh / 2 + 2H + 1 planes and rows, nmesh columns)
    of ranks (1, 0) and (0, 1) of a 2 x 2 grid, against their plain
    versions. The 16.8 M rows of a jittered lattice of the whole box lie
    inside the pencil, in its halo bands and corners, and beyond it
    (counted in bad, exactly as the plain version counts them); they
    come sorted by extended cell, those beyond last, as the pencil carry
    sorts them. Returns the four kernels' open-y rows: err, ms, plain_ms,
    bound (the rows' bytes and the canvas's or three fields' once), and
    library_ms (grid_sample on the extended pencil at the rows inside)
    for the readouts."""
    import torch
    from fastpm_torch.ops import cic

    n = nc ** 3
    inv = (nmesh / box,) * 3
    half = nmesh // 2
    ext = (half + 2 * H + 1, half + 2 * H + 1, nmesh)
    cells = ext[0] * ext[1] * ext[2]
    g = torch.Generator(device=dev).manual_seed(41)
    x0 = jittered_lattice(nc, box, 2.0, nmesh, dev, 43)
    masses = 0.5 + torch.rand(n, generator=g, device=dev)
    rows = {name: dict(err=0.0) for name in HOMED}
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
    fields = [torch.randn(ext, generator=g, device=dev) for _ in range(3)]
    canvas = torch.zeros(ext, device=dev)
    for rank, (r0x, r0y) in (("(1, 0)", (half, 0)), ("(0, 1)", (0, half))):
        pencil = cic.Pencil(nmesh, r0x, H, nmesh, r0y, H)
        base, _f, valid = cic.slab_cell(x0, ext, inv, pencil)
        key = (base[:, 0] * ext[1] + base[:, 1]) * ext[2] + base[:, 2]
        order = torch.sort(torch.where(valid, key, cells),
                           stable=True).indices
        x, m_col = x0[order].contiguous(), masses[order].contiguous()
        nout = int((~valid).sum())
        inside = x[:n - nout]
        del base, key, order
        print("pencil kernels: rank %s of 2 x 2, H = %d, extended pencil "
              "%dx%dx%d, %d rows, %d beyond it"
              % (rank, H, *ext, n, nout))
        for name, (fn, plain) in paints.items():
            for m, label in ((1.0, "scalar mass"), (m_col, "mass column")):
                canvas.zero_()
                bad = fn(canvas, x, m, pencil)
                want = torch.zeros(ext, device=dev)
                bad_plain = plain(want, x, m, pencil)
                err = check_close("%s open-y, rank %s, %s" % (name, rank,
                                                              label),
                                  canvas, want)
                del want
                if int(bad) != int(bad_plain) or int(bad) != nout:
                    raise SystemExit("%s open-y: bad %d, plain %d, want %d"
                                     % (name, int(bad), int(bad_plain),
                                        nout))
                rows[name]["err"] = max(rows[name]["err"], err)
            if rank == "(1, 0)":
                rows[name]["ms"] = time_ms(
                    lambda: fn(canvas.zero_(), x, 1.0, pencil), reps)
                rows[name]["plain_ms"] = time_ms(
                    lambda: plain(canvas.zero_(), x, 1.0, pencil), reps)
        for name, (fn, plain) in reads.items():
            for k in ((1, 3) if name == "cic_readout_homed" else (3,)):
                got, want = fn(fields[:k], x, pencil), plain(fields[:k], x,
                                                             pencil)
                err = check_close("%s open-y, rank %s, %d field%s"
                                  % (name, rank, k, "s" * (k > 1)), got,
                                  want)
                if got[n - nout:].any():
                    raise SystemExit("%s open-y: a row beyond the pencil "
                                     "read a value" % name)
                rows[name]["err"] = max(rows[name]["err"], err)
            if rank == "(1, 0)":
                rows[name]["ms"] = time_ms(lambda: fn(fields, x, pencil),
                                           reps)
                rows[name]["plain_ms"] = time_ms(
                    lambda: plain(fields, x, pencil), reps)
                rows[name]["library_ms"] = grid_sample_ms(
                    fields, [inside], inv, nmesh, reps, pencil)
        del x, m_col, inside
    torch.cuda.synchronize()
    # as phase A: the positions read once, the canvas written once or
    # the three fields read once, the values written once
    for name in ("cic_paint_homed", "cic_paint4"):
        rows[name]["bound"] = bound_ms(12 * n + 4 * cells, 40 * n)
    for name in ("cic_readout_homed", "cic_readout4"):
        rows[name]["bound"] = bound_ms(12 * n + 3 * 4 * cells + 12 * n,
                                       (40 + 48) * n)
    for name, r in rows.items():
        print("%s open-y: kernel_ms %.4f plain_ms %.4f library_ms %s "
              "bound_ms %.4f (%s)"
              % (name, r["ms"], r["plain_ms"],
                 "%.4f" % r["library_ms"] if "library_ms" in r else "null",
                 r["bound"][0], r["bound"][1]))
    return rows


def float64_potential(pm, x):
    """The kernel 1_4 potential at x of x's plain CIC deposit (unit
    masses) through float64 FFTs and tables, read out in float32: the
    yardstick of the float32 forces' potential."""
    import torch
    from fastpm_torch.ops import cic
    canvas = cic.cic_paint_plain(x, pm.Nmesh, pm.InvCellSize).double()
    dk = torch.fft.rfftn(canvas / (x.shape[0] / pm.Norm)) / pm.Norm
    del canvas
    kk = sum(torch.as_tensor(pm._tables["kk"][d][pm.k_index(d)],
                             device=x.device).reshape(
                                 [-1 if j == d else 1 for j in range(3)])
             for d in range(3))
    dk *= -torch.where(kk > 0, 1 / torch.where(kk > 0, kk, 1.0), 0.0)
    phi = torch.fft.irfftn(dk * pm.Norm, s=pm.Nmesh).float()
    del dk
    return cic.cic_readout_plain([phi], x, pm.InvCellSize)[:, 0]


def pencil_force(dev, store, pm, reps=5):
    """Phase L, the force: the pencil force on a one-rank NCCL process
    group (a 1 x 1 Grid, both rings that rank) from the main path's
    z = 0 state, the carry and the multi with from8 and from4 at Hx =
    Hy = the measured requirement + 1 (at least 2), against
    compute_force_carry by id; the potential and tidal tensor of the
    pencil multi and of the slab multi against compute_force; ms a step
    and peak memory of every pencil force beside the slab's, and a
    profile of the pencil carry. Returns the open-y launches of the four
    homed kernels in the four force runs."""
    import socket
    import numpy as np
    import torch
    import torch.distributed as dist
    from fastpm_torch import gravity
    from fastpm_torch.ops import cic
    from fastpm_torch.painter import Painter
    from fastpm_torch.parallel.comm import Grid
    from fastpm_torch.parallel.pfft import PencilPM, SlabPM
    from fastpm_torch.parallel import psolver
    from fastpm_torch.store import Store

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method="tcp://localhost:%d" % port,
                            rank=0, world_size=1)
    try:
        grid = Grid(dist.group.WORLD, 1, 1)
        ppm = PencilPM(pm, grid)
        spm = SlabPM(pm, grid.flat)
        store = store.wrap(pm.BoxSize)
        hx, hy = psolver.required_halo_planes_pencil(pm, grid, store.x)
        Hx, Hy = max(1, hx) + 1, max(1, hy) + 1
        H = max(1, psolver.required_halo_planes(pm, grid.flat, store.x)) + 1
        m0 = float(np.float32(store.M0))
        n = store.np_local
        print("pencil force: a 1 x 1 grid on a one-rank NCCL group, %d "
              "particles, %d^3 mesh, Hx = %d, Hy = %d, extended pencil "
              "%dx%dx%d, k shard %s (kz pad %d)"
              % (n, pm.Nmesh[0], Hx, Hy, pm.Nmesh[0] + 2 * Hx + 1,
                 pm.Nmesh[1] + 2 * Hy + 1, pm.Nmesh[2], ppm.kshard,
                 ppm.nzp - ppm.nzh))

        def carry(hk):
            p, bad, _dk = psolver._force_local_homed_pencil_carry(
                ppm, store, "1_4", Hx, Hy, homed_kernel=hk)
            return p.id, p.acc, bad

        def multi(hk, **extra):
            (out,), bad, _dk = psolver._force_local_homed_pencil_multi(
                ppm, (store.x,), (m0,), "1_4", Hx, Hy, homed_kernel=hk,
                **extra)
            return store.id, out, bad

        ref, _dk = gravity.compute_force_carry(pm, Painter(pm, "cic"), store)
        want = ref.acc[torch.argsort(ref.id)]
        scale = float(want.abs().max())
        del ref
        torch.cuda.synchronize()
        reset_launches()
        results = {}
        for hk in ("from8", "from4"):
            results[hk, "carry"] = carry(hk)
            ids, out, bad = multi(hk)
            results[hk, "multi"] = (ids, out["acc"], bad)
        torch.cuda.synchronize()
        launches = {name: wrapper(name).launches_open_y for name in HOMED}
        total = read_launches()
        print("pencil force: open-y launches %s" % launches)
        if (not all(launches[k] == 2 for k in HOMED)
                or any(total[k] != launches[k] for k in HOMED)):
            raise SystemExit("the pencil force did not run through the "
                             "open-y homed kernels: %s" % total)
        for (hk, body), (ids, acc, bad) in results.items():
            err = float((acc[torch.argsort(ids)] - want).abs().max())
            print("pencil force %s %s: bad %d, max |dacc| %.3g = %.3g of "
                  "max |acc| %.4g (bound 1e-5)"
                  % (hk, body, int(bad), err, err / scale, scale))
            if int(bad) != 0 or not err <= 1e-5 * scale:
                raise SystemExit("pencil force %s %s disagrees with the "
                                 "single-device force" % (hk, body))
        del results, want

        # the potential and tidal tensor, pencil and slab, against the
        # single-device force
        one = Store(x=store.x, id=store.id, M0=store.M0,
                    potential=torch.zeros(n, device=dev),
                    tidal=torch.zeros((n, 6), device=dev))
        (ref,), _dk = gravity.compute_force(
            pm, Painter(pm, "cic"), [one], compute_potential=True,
            compute_tidal=True)
        extra = dict(compute_potential=True, compute_tidal=True)
        (sout,), sbad, _dk = psolver._force_local_homed_multi(
            spm, (store.x,), (m0,), "1_4", H, **extra)
        # the float32 FFTs' own error in the potential, which 1/k^2
        # weighs to the box's longest modes: the potential of the same
        # (plain) deposit through float64 FFTs, as a yardstick
        truth = float64_potential(pm, store.x)
        sc = float(truth.abs().max())
        print("potential against the float64 FFTs: single-device %.3g "
              "of max %.4g" % (float((ref.potential - truth).abs().max())
                               / sc, sc))
        for label, (out, bad) in (
                ("pencil multi", multi("from8", **extra)[1:]),
                ("slab multi", (sout, sbad))):
            for k in ("acc", "potential", "tidal"):
                w = getattr(ref, k)
                err = float((out[k] - w).abs().max())
                sc = float(w.abs().max())
                print("%s %s: bad %d, max |d| %.3g = %.3g of max %.4g "
                      "(bound 1e-5)%s" % (
                          label, k, int(bad), err, err / sc, sc,
                          "; against the float64 FFTs %.3g" % (
                              float((out[k] - truth).abs().max())
                              / float(truth.abs().max()))
                          if k == "potential" else ""))
                if int(bad) != 0 or not err <= 1e-5 * sc:
                    raise SystemExit("%s %s disagrees with compute_force"
                                     % (label, k))
        del ref, one, sout, _dk, truth

        # ms a step and peak memory, the slab's beside the pencil's
        for label, step in (
                ("single-device compute_force_carry",
                 lambda: gravity.compute_force_carry(
                     pm, Painter(pm, "cic"), store)),
                ("slab from8 carry", lambda: psolver._force_local_homed_carry(
                    spm, store, "1_4", H)),
                ("pencil from8 carry", lambda: carry("from8")),
                ("pencil from8 multi", lambda: multi("from8")),
                ("pencil from4 carry", lambda: carry("from4")),
                ("pencil from4 multi", lambda: multi("from4"))):
            reset_peak()
            ms = time_ms(step, reps)
            print("pencil force: %s %.2f ms = %.4g particle-steps/s, peak "
                  "%.3f GB" % (label, ms, n / ms * 1e3,
                               torch.cuda.max_memory_allocated() / 1e9))
        profile_force(lambda: carry("from8"), label="pencil carry profile")
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
    check_merge_cases(dev)
    return {"merge_pairs": row}


def check_merge_cases(dev):
    """Phase C, K7's edge cases: every case of
    fastpm_torch/ops/merge_cases.py (each launch form: one tile, a
    cluster, register passes; 16- and 32-bit offsets; no payload to 8;
    unique keys, all keys equal, 4 values) and columns 4 bytes past a
    16-byte boundary, against the plain version, bit for bit."""
    import torch
    from fastpm_torch.ops import merge_cases, sort

    ncases = 0
    for B in merge_cases.BLOCKS:
        for n in (2 * B, 8 * B):
            for P in merge_cases.PAYLOADS:
                for kind in merge_cases.KINDS:
                    keys, pays = merge_cases.bitonic_case(kind, n, B, P)
                    cols = [torch.from_numpy(keys).to(dev)] + [
                        torch.from_numpy(p).to(dev) for p in pays]
                    got = sort.merge_pairs(*cols, B=B)
                    want = sort.merge_pairs_plain(*cols, B=B)
                    if not all(torch.equal(g, w) for g, w in zip(got, want)):
                        raise SystemExit("K7 disagrees with its plain version"
                                         " at B = %d, n = %d, %d payloads, "
                                         "%s keys" % (B, n, P, kind))
                    ncases += 1
    n, B = 8 * 32768, 32768
    keys, pays = merge_cases.bitonic_case("four", n, B, 6)
    cols = []
    for c in [keys] + list(pays):
        buf = torch.empty(n + 1, dtype=torch.from_numpy(c).dtype,
                          device=dev)
        buf[1:] = torch.from_numpy(c).to(dev)
        cols.append(buf[1:])
    same = all(torch.equal(g, w) for g, w in zip(
        sort.merge_pairs(*cols, B=B), sort.merge_pairs_plain(*cols, B=B)))
    print("K7 merge_pairs edge cases: %d cases of merge_cases.py equal to "
          "the plain version; columns 4 bytes past a 16-byte boundary "
          "equal %s" % (ncases, same))
    if not same:
        raise SystemExit("K7 disagrees on unaligned columns")


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


def profile_force(step, top=12, label="force profile",
                  names=("deposit_kernel", "readout_kernel")):
    """Where the force step's device time goes: torch.profiler over two
    steps, device time by kernel name and the device's busy share of
    the wall time. Returns the device ms a step of each kernel in
    names."""
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
    print("%s: device busy %.2f ms of %.2f ms wall per step "
          "(%.1f%% idle)" % (label, busy / 1e3, wall_us / 1e3,
                             100 * (1 - busy / wall_us)))
    for key, us, count in rows[:top]:
        print("%s: %8.3f ms %5.1f%% x%d %s"
              % (label, us / 1e3, 100 * us / busy, count, key[:90]))
    # device ms a step by the port's kernels, for the paths' summaries
    return {name: sum(us for key, us, _ in rows if name in key) / 1e3
            for name in names}


def halos(dev, store, box, nc, ll_frac=0.2, nmin=20, reps=5):
    """Phase E: the device FOF at full width on the main path's z = 0
    state (16.8 M rows, box 768): labels bit-equal to the host
    union-find, the catalog against the host catalog (lengths, minid and
    ihalo exact; the float columns within atol 1e-4, float32 segment
    sums in another order); the steps of the labels timed apart (the
    columns and the sort, the gather, fof_link and its kernels, the
    least original index); fof_link against its plain version, bit for
    bit, on a clustered slab of the state (x < box / 8) and on the slab
    with a crowded linking cell, the latter's labels against the host
    union-find; find_halos on an open box (the slab moved outside the
    box) against the host; find_halos device against host. Returns the
    kernel's row for the JSON line and the host labels of the state's
    rows (phase N's reference)."""
    import numpy as np
    import torch
    from fastpm_torch import fof
    from fastpm_torch.convert import store_from_numpy
    from fastpm_torch.ops import fof_device as fd

    ll = ll_frac * box / nc
    p = store.wrap(box)
    x = p.x.contiguous()
    n = x.shape[0]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lab_d = fd.fof_labels_device(x, ll, box)
    torch.cuda.synchronize()
    labels_first_ms = (time.perf_counter() - t0) * 1e3
    labels_ms = time_ms(lambda: fd.fof_labels_device(x, ll, box), reps)
    sweeps = fd.fof_labels_device.rounds
    t0 = time.perf_counter()
    lab_h = fof.fof_labels(x.cpu().numpy(), ll, box)
    host_labels_ms = (time.perf_counter() - t0) * 1e3
    ndiff = int((lab_d.cpu().numpy() != lab_h).sum())
    same = ndiff == 0
    print("halos: %d rows, ll %.3f: device labels in %d sweep(s), %.3f ms "
          "(first call %.1f ms, host clock); host union-find %.1f ms; "
          "bit-equal %s (%d rows differ)"
          % (n, ll, sweeps, labels_ms, labels_first_ms, host_labels_ms,
             same, ndiff))
    if not same:
        raise SystemExit("halos: device labels differ from the host "
                         "union-find")
    del lab_d

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cat_d, ih_d = fof.find_halos(p, ll, box, nmin=nmin, backend="device")
    torch.cuda.synchronize()
    dev_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    cat_h, ih_h = fof.find_halos(p, ll, box, nmin=nmin, labels=lab_h,
                                 backend="host")
    host_ms = host_labels_ms + (time.perf_counter() - t0) * 1e3
    ok = (cat_d.nhalo == cat_h.nhalo
          and np.array_equal(cat_d.length, cat_h.length)
          and np.array_equal(cat_d.minid, cat_h.minid)
          and np.array_equal(ih_d.cpu().numpy(), ih_h))
    errs = {k: float(np.abs(getattr(cat_d, k) - getattr(cat_h, k)).max())
            if cat_d.nhalo == cat_h.nhalo else float("inf")
            for k in ("x", "v", "rdisp", "vdisp", "rvdisp", "q")}
    print("halos: %d halos (nmin %d), lengths / minid / ihalo exact %s, "
          "float columns max |err| %s; find_halos device %.1f ms, host "
          "%.1f ms (labels + catalog)" % (cat_d.nhalo, nmin, ok, errs,
                                          dev_ms, host_ms))
    if not ok or max(errs.values()) > 1e-4:
        raise SystemExit("halos: the device catalog differs from the host's")
    del cat_d, ih_d, cat_h, ih_h

    # the labels' steps apart, on the full state
    ncol = fd._table_grid(ll, box, n)
    cid = fd._table_ids(x, ncol, box)
    order = fd._table_order(x, cid)
    x_s, cid_s = x[order].contiguous(), cid[order]
    root = fd.fof_link(x_s, cid_s, ncol, box, ll)
    steps = dict(
        sort_ms=time_ms(lambda: fd._table_order(
            x, fd._table_ids(x, ncol, box)), reps),
        gather_ms=time_ms(lambda: (x[order].contiguous(), cid[order]), reps),
        fof_link_ms=time_ms(lambda: fd.fof_link(x_s, cid_s, ncol, box, ll),
                            reps),
        canonical_ms=time_ms(lambda: fd._canonical(root, order), reps))
    print("halos: the labels' steps at %d rows (%d^2 columns): %s"
          % (n, ncol, {k: round(v, 4) for k, v in steps.items()}))
    link_kernels = profile_force(
        lambda: fd.fof_link(x_s, cid_s, ncol, box, ll), top=6,
        label="halos fof_link profile",
        names=("fill_kernel", "gap_kernel", "link_kernel", "root_kernel"))
    del cid, order, x_s, cid_s, root

    def against_plain(xx, label, host=False):
        """fof_link and its plain version on xx, bit for bit; the labels
        against the host union-find if host."""
        nn = xx.shape[0]
        nc_ = fd._table_grid(ll, box, nn)
        ci = fd._table_ids(xx, nc_, box)
        od = fd._table_order(xx, ci)
        xs_, cs_ = xx[od].contiguous(), ci[od]
        got = fd.fof_link(xs_, cs_, nc_, box, ll)
        want = fd.fof_link_plain(xs_, cs_, nc_, box, ll)
        eq = torch.equal(got, want)
        ms = time_ms(lambda: fd.fof_link(xs_, cs_, nc_, box, ll), reps)
        plain = time_ms(lambda: fd.fof_link_plain(xs_, cs_, nc_, box, ll), 1)
        hq = True
        if host:
            hq = np.array_equal(fd._canonical(got, od).cpu().numpy(),
                                fof.fof_labels(xx.cpu().numpy(), ll, box))
        print("halos: fof_link on %s (%d rows, %d^2 columns) against "
              "fof_link_plain: equal %s%s; kernel_ms %.4f plain_ms %.2f"
              % (label, nn, nc_, eq,
                 ", labels equal to the host union-find %s" % hq
                 if host else "", ms, plain))
        if not (eq and hq):
            raise SystemExit("fof_link disagrees with its plain version "
                             "on %s" % label)
        return ms, plain

    # a clustered slab of the state, and the slab with 4000 rows inside
    # one linking cell (a cube of half the linking length; the table's
    # mean is about ten rows a column)
    xs = x[x[:, 0] < box / 8].contiguous()
    ns = xs.shape[0]
    ms, plain_ms = against_plain(xs, "the clustered slab")
    g = torch.Generator(device=dev).manual_seed(37)
    # linking cell 67 of 1280 spans [40.2, 40.8) on each axis
    crowd = 40.25 + torch.rand((4000, 3), generator=g, device=dev) * (0.5 * ll)
    against_plain(torch.cat([xs, crowd]), "the slab with a crowded cell",
                  host=True)
    del crowd

    # an open box: the slab moved far outside [0, box) (a lightcone
    # slice), device against host
    v = (p.v if p.v is not None else torch.zeros_like(p.x))[
        p.x[:, 0] < box / 8]
    xo = xs - 500.0
    po = store_from_numpy(xo.cpu().numpy(), v.cpu().numpy(),
                          np.arange(ns), device=dev, M0=1.0)
    cat_d, ih_d = fof.find_halos(po, ll, box, nmin=nmin, periodic=False,
                                 backend="device")
    cat_h, ih_h = fof.find_halos(po, ll, box, nmin=nmin, periodic=False,
                                 backend="host")
    ok = (cat_d.nhalo == cat_h.nhalo > 0
          and np.array_equal(cat_d.length, cat_h.length)
          and np.array_equal(cat_d.minid, cat_h.minid)
          and np.array_equal(ih_d.cpu().numpy(), ih_h))
    print("halos: open box (%d rows outside the box): %d halos, lengths / "
          "minid / ihalo exact against the host %s" % (ns, cat_d.nhalo, ok))
    if not ok:
        raise SystemExit("halos: the open-box catalog differs from the "
                         "host's")
    del xo, po, v, cat_d, ih_d, cat_h, ih_h

    # bytes: the sorted columns (4 B) and positions (12 B) read once, the
    # roots (4 B) written once: 20 B a row; the pair tests read the
    # neighbours' rows again from cache
    return {"fof_link": dict(
        err=0.0, ms=ms, plain_ms=plain_ms, bound=bound_ms(20 * ns, 0),
        rows=ns, ms_full=steps["fof_link_ms"],
        bound_ms_full=bound_ms(20 * n, 0)[0], rows_full=n,
        kernels_ms_full=link_kernels, sweeps_full=sweeps,
        labels_ms_full=labels_ms, labels_first_call_ms_full=labels_first_ms,
        labels_steps_ms_full=steps, find_halos_device_ms=dev_ms,
        find_halos_host_ms=host_ms, library_ms=None)}, lab_h


def pfof_path(dev, tmp, store, pm, lab_host, box=768.0, nc=256,
              ll_frac=0.2, nproc=4, coeffs=(0.05, 0.02), reps=5):
    """Phase N: the sharded FOF (fastpm_torch.parallel.pfof) and the
    public sharded step at full width, on the main path's z = 0 state in
    id (lattice) order (16.8 M rows, box 768, ll 0.6). lab_host: phase
    E's host labels of the store's rows (bit-equal to the device's).
    1. fof_labels_sharded_auto on a one-rank NCCL group (every row a
       ghost of itself on both sides: the local pass over 3N rows): the
       labels bit-equal to phase E's, wall, outer rounds, ghost_cap,
       rows, launches and peak;
    2. one make_sharded_step on the same group: acc within 4e-7 of max
       |acc| of sharded_force_fn's, x and v equal to the kick, drift and
       wrap by hand on that acc, its launches of K3, cell_order and K4;
    3. fof_labels_sharded_auto on nproc gloo ranks on the one card
       (spawned processes of tests/torch_rank_workers.py, each an x-slab
       of the id-ordered rows, the ghosts through the host): the
       gathered labels bit-equal to phase E's; each rank's walls,
       rounds, ghost_cap and rows;
    4. fof_link against fof_link_plain, bit for bit, at rank 0's local
       pass of step 3 (its rows and the ghosts it received), timed.
    Returns ({kernel: its phase N entries for the JSON line})."""
    import socket
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from fastpm_torch.ops import fof_device as fd
    from fastpm_torch.parallel import pfof, psolver
    from fastpm_torch.parallel.comm import Ring

    def free_port():
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            return sock.getsockname()[1]

    ll = ll_frac * box / nc
    p = store.wrap(box)
    by_id = torch.argsort(p.id)
    x = p.x[by_id].contiguous()
    n = x.shape[0]
    # phase E's labels in id order: the least id-order row of each group
    lab_e = torch.from_numpy(lab_host).to(dev)[by_id]
    want = torch.full((n,), n, dtype=torch.int64, device=dev).scatter_reduce_(
        0, lab_e, torch.arange(n, device=dev), "amin")[lab_e]
    del lab_e
    out = {}

    # ---- 1. one rank, NCCL ----
    dist.init_process_group("nccl", init_method="tcp://localhost:%d"
                            % free_port(), rank=0, world_size=1)
    try:
        ring = Ring(dist.group.WORLD)
        live = reset_peak()
        reset_launches()
        walls = []
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lab = pfof.fof_labels_sharded_auto(x, ll, box, ring)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                got = read_launches()
        peak = torch.cuda.max_memory_allocated() - live
        sh = pfof.fof_labels_sharded
        same = torch.equal(lab, want)
        print("phase N one rank (NCCL): fof_labels_sharded_auto on %d rows, "
              "ll %.3f: walls %s ms (host clock after a synchronise; the "
              "first call first), %d outer rounds, ghost_cap %d, local pass "
              "%d rows, peak %.3f GB over %.3f GB live; labels bit-equal to "
              "phase E's %s" % (n, ll, ["%.2f" % w for w in walls], sh.rounds,
                                sh.ghost_cap, sh.rows, peak / 1e9,
                                live / 1e9, same))
        check_launches("phase N one rank", got, dict(
            {k: 0 for k in KERNELS}, fof_link=sh.rounds))
        if not same:
            raise SystemExit("phase N: the one-rank sharded labels differ "
                             "from phase E's")
        out["fof_link"] = {"launches_phase_n": {"one_rank": got["fof_link"]},
                           "phase_n_one_rank": dict(
                               walls_ms=walls, rounds=sh.rounds,
                               ghost_cap=sh.ghost_cap, rows=sh.rows,
                               peak_gb=peak / 1e9)}
        del lab

        # ---- 2. make_sharded_step on the group ----
        L = torch.tensor(pm.BoxSize, dtype=torch.float32, device=dev)
        x0, v0 = p.x.contiguous(), p.v.contiguous()
        force = psolver.sharded_force_fn(pm, ring)
        step = psolver.make_sharded_step(pm, ring)
        acc_f = force(x0)
        xs, vs = x0.clone(), v0.clone()
        torch.cuda.synchronize()
        reset_launches()
        xs, vs, acc = step(xs, vs, coeffs)
        torch.cuda.synchronize()
        got = read_launches()
        scale = float(acc_f.abs().max())
        err = float((acc - acc_f).abs().max()) / scale
        vh = v0 + acc * float(np.float32(coeffs[0]))
        xh = x0 + vh * float(np.float32(coeffs[1]))
        xh = xh - torch.floor(xh / L) * L
        exact = torch.equal(vs, vh) and torch.equal(xs, xh)
        force_ms = time_ms(lambda: force(x0), reps)
        step_ms = time_ms(lambda: step(x0.clone(), v0.clone(), coeffs), reps)
        print("phase N make_sharded_step (one rank, %d^3 mesh): acc against "
              "sharded_force_fn's max |dacc| %.3g of max |acc| %.4g (bound "
              "4e-7); x and v equal to the kick, drift and wrap by hand %s; "
              "sharded_force_fn %.2f ms, the step %.2f ms with two clones "
              "(CUDA events)" % (pm.Nmesh[0], err, scale, exact, force_ms,
                                 step_ms))
        check_launches("phase N make_sharded_step", got, dict(
            {k: 0 for k in KERNELS}, cic_paint_into=1, cell_order=1,
            cic_readout3=1))
        if not (err <= 4e-7 and exact):
            raise SystemExit("phase N: make_sharded_step disagrees with "
                             "sharded_force_fn and the kick and drift")
        for name in ("cic_paint_into", "cell_order", "cic_readout3"):
            out[name] = {"launches_phase_n": got[name]}
        out["cic_paint_into"].update(phase_n_force_ms=force_ms,
                                     phase_n_step_ms=step_ms)
        del x0, v0, xs, vs, acc, acc_f, xh, vh, force, step
    finally:
        dist.destroy_process_group()

    # ---- 3. nproc gloo ranks on the one card ----
    sys.path.append(os.path.join(ROOT, "tests"))
    import torch_rank_workers as workers
    rdir = os.path.join(tmp, "pfof_ranks")
    os.makedirs(rdir)
    inp = os.path.join(rdir, "inputs.npz")
    np.savez(inp, cases="z0", z0_x=x.cpu().numpy(), z0_ll=ll, z0_box=box,
             z0_kinds="auto", z0_reps=3, device="cuda:0", timeout=300.0)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ctx = mp.start_processes(workers.run, args=(nproc, free_port(), "pfof",
                                                inp, rdir),
                             nprocs=nproc, join=False, start_method="spawn")
    try:
        # a failing rank raises here
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > 600:
                raise SystemExit("phase N: the gloo ranks timed out")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
                proc.join(5)
    spawn_s = time.perf_counter() - t0
    res = [dict(np.load(os.path.join(rdir, "rank%d.npz" % r)))
           for r in range(nproc)]
    lab = np.concatenate([r["z0_auto_labels"] for r in res])
    same = np.array_equal(lab, want.cpu().numpy())
    per = [dict(walls_ms=[round(float(w) * 1e3, 2)
                          for w in r["z0_auto_wall"]],
                rounds=int(r["z0_auto_rounds"]),
                ghost_cap=int(r["z0_auto_ghost_cap"]),
                rows=int(r["z0_auto_rows"]),
                fof_link=int(r["z0_auto_launches"])) for r in res]
    for r, d in enumerate(per):
        print("phase N gloo rank %d of %d (cuda:0): walls %s ms (host clock "
              "after a synchronise; the first call first), %d outer rounds, "
              "ghost_cap %d, local pass %d rows, fof_link launches %d; "
              "overflow 0 (fof_labels_sharded_auto raises otherwise)"
              % (r, nproc, d["walls_ms"], d["rounds"], d["ghost_cap"],
                 d["rows"], d["fof_link"]))
    print("phase N %d gloo ranks: %.1f s from the spawn to the last exit; "
          "labels bit-equal to phase E's %s" % (nproc, spawn_s, same))
    if not same:
        raise SystemExit("phase N: the gloo ranks' labels differ from "
                         "phase E's")
    if any(d["fof_link"] != d["rounds"] for d in per):
        raise SystemExit("phase N: a gloo rank's local pass did not run "
                         "fof_link once a round")
    out["fof_link"]["launches_phase_n"]["gloo_ranks"] = [
        d["fof_link"] for d in per]
    out["fof_link"]["phase_n_gloo_ranks"] = per
    del want

    # ---- 4. fof_link against its plain version at rank 0's local pass ----
    q = n // nproc
    cap = per[0]["ghost_cap"]
    parts = [x[:q]]
    # from rank 1 (the right neighbour) and rank nproc - 1 (the left) their
    # rows whose ball touches slab 0, in the order they arrive
    for r in (1, nproc - 1):
        xb = x[r * q:(r + 1) * q]
        lo, k, _ = pfof._reach(xb[:, 0], nproc, box, ll)
        idx, _over = pfof._pack(pfof._contains(0, lo, k, nproc), cap)
        parts.append(xb[idx])
    xl = torch.cat(parts)
    m = xl.shape[0]
    if m != per[0]["rows"]:
        raise SystemExit("phase N: rank 0's local pass had %d rows, not %d"
                         % (per[0]["rows"], m))
    ncol = fd._table_grid(ll, box, m)
    cid = fd._table_ids(xl, ncol, box)
    od = fd._table_order(xl, cid)
    xs_, cs_ = xl[od].contiguous(), cid[od]
    eq = torch.equal(fd.fof_link(xs_, cs_, ncol, box, ll),
                     fd.fof_link_plain(xs_, cs_, ncol, box, ll))
    ms = time_ms(lambda: fd.fof_link(xs_, cs_, ncol, box, ll), 10)
    plain_ms = time_ms(lambda: fd.fof_link_plain(xs_, cs_, ncol, box, ll), 1)
    # bytes as phase E counts them: 20 B a row
    bound = bound_ms(20 * m, 0)
    print("phase N: fof_link at rank 0's local pass (%d rows, %d^2 columns) "
          "against fof_link_plain: equal %s; kernel_ms %.4f plain_ms %.2f "
          "bound_ms %.4f (%s)" % (m, ncol, eq, ms, plain_ms, bound[0],
                                 bound[1]))
    if not eq:
        raise SystemExit("phase N: fof_link disagrees with its plain "
                         "version at rank 0's local pass")
    out["fof_link"]["phase_n_rank0_pass"] = dict(
        rows=m, max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
        bound_by=bound[1], library_ms=None)
    return out


LIGHTCONE_GOLDENS = {
    # tests/test_golden_lightcone.py:33-65
    "lightcone.lua": ["422564", "569931", "622458", "200849", "262144",
                      "52"],
    "lightcone-healpix.lua": ["20903", "24576", "61170", "74426", "422564"],
    "lightcone-rfof.lua": ["27", "422564", "200849"],
}


def lightcone_lua(tmp, fixture, name, subs=()):
    """A lightcone fixture with its outputs in tmp/name and the power
    spectrum path pointed at FIXTURES; subs: more (pattern, text)
    replacements. Returns (path of the Lua file, output directory)."""
    out = os.path.join(tmp, name)
    src = open(os.path.join(FIXTURES, fixture)).read()
    src = re.sub(r'read_powerspectrum = ".*"', 'read_powerspectrum = "%s"'
                 % os.path.join(FIXTURES, "powerspec.txt"), src)
    for pattern, text in subs:
        src, k = re.subn(pattern, text, src)
        if k != 1:
            raise SystemExit("lightcone_lua: %r not in %s" % (pattern,
                                                             fixture))
    return (write_lua(os.path.join(tmp, name + ".lua"),
                      src.replace("OUTDIR", out)), out)


def lightcone_goldens(dev, tmp):
    """Phase F: the three lightcone fixtures through cli.main on the
    card; every golden line of tests/test_golden_lightcone.py must be
    logged exactly."""
    from fastpm_torch import cli
    for fixture, counts in LIGHTCONE_GOLDENS.items():
        conf, _ = lightcone_lua(tmp, fixture, fixture[:-4])
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main([conf], device=dev)
        lines = buf.getvalue().splitlines()
        got = [l.split()[1] for l in lines
               if l.startswith("Writing ") and l.endswith(" objects.")]
        missing = [c for c in counts
                   if "Writing %s objects." % c not in lines]
        print("lightcone golden %s: %.1f s; objects written %s; goldens %s "
              "%s" % (fixture, time.perf_counter() - t0, got, counts,
                      "all logged" if not missing else
                      "MISSING %s" % missing))
        if rc != 0 or missing:
            raise SystemExit("lightcone golden %s failed" % fixture)


def lightcone_path(dev, tmp, nc=256, box=2048.0):
    """Phase G, this slice's path at full width: lightcone.lua's physics
    and lightcone settings at nc = 256, boxsize = 2048 (the fixture's 8
    Mpc/h mean separation), everything else as the fixture (8 steps, the
    4^3 tiles, dh_factor 0.1, the potential and tidal tensor, write_fof
    at z = 0, HEALPix maps at nside 32) through run_fastpm. The launch
    counters show the force went through the cell order, K3 and K4 and
    every FOF through fof_link; every HEALPix device pixel
    that differs from the float64 host pixel is flagged. Returns the
    launch counts of the run."""
    import numpy as np
    import torch
    from fastpm_torch import cli, fof, healpix, lightcone
    from fastpm_torch.config.params import load_params
    from fastpm_torch.diagnostics import Log

    conf, out = lightcone_lua(tmp, "lightcone.lua", "lightcone_full", (
        (r"(?m)^nc = .*$", "nc = %d" % nc),
        (r"(?m)^boxsize = .*$", "boxsize = %r" % box),
        (r"(?m)^lc_usmesh_fof_padding = .*$",
         "lc_usmesh_fof_padding = 20.0\nlc_usmesh_healpix_nside = 32")))
    params = load_params(conf)

    # measurement hooks: the tile solves of each interval, each FOF and
    # each HEALPix paint, timed with a synchronize on each side
    solve_ms, fof_ms, flags = [], [], dict(rows=0, flagged=0, unflagged=0)
    intersect, find_halos = lightcone.USMesh.intersect, cli.find_halos
    paint = healpix.paint_hpmap_nest_device

    def timed(fn, into):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a, **k)
            torch.cuda.synchronize()
            into.append((time.perf_counter() - t0) * 1e3)
            return r
        return call

    def checked_paint(x, aemit, v, mass, nside, nslices):
        pix, risky = healpix.vec2pix_nest_device(nside, x)
        want = healpix.vec2pix_nest(nside, x.cpu().numpy().astype(
            np.float64))
        bad = (pix.cpu().numpy() != want)
        flags["rows"] += int(x.shape[0])
        flags["flagged"] += int(risky.sum())
        flags["unflagged"] += int((bad & ~risky.cpu().numpy()).sum())
        return paint(x, aemit, v, mass, nside, nslices)

    lightcone.USMesh.intersect = timed(intersect, solve_ms)
    cli.find_halos = timed(find_halos, fof_ms)
    healpix.paint_hpmap_nest_device = checked_paint
    try:
        reset_peak()
        reset_launches()
        t0 = time.perf_counter()
        log = Log(echo=False)
        solver = cli.run_fastpm(params, log=log, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
    finally:
        lightcone.USMesh.intersect = intersect
        cli.find_halos = find_halos
        healpix.paint_hpmap_nest_device = paint
    peak = torch.cuda.max_memory_allocated()
    crossed = [int(l.rsplit("=", 1)[1]) for l in log.lines
               if l.startswith("Unstructured LightCone ready")]
    written = [int(l.split()[1]) for l in log.lines
               if l.startswith("Writing ") and l.endswith(" objects.")]
    nstep = len(params.time_step)
    print("lightcone path: %d^3 particles, box %g, %d steps, %d tiles: "
          "wall %.2f s, max_memory_allocated %.3f GB"
          % (nc, box, nstep, len(params.lc_usmesh_tiles), wall, peak / 1e9))
    print("lightcone path: rows crossed per slice %s; objects written "
          "(HEALPix pixels, FOF halos, usmesh rows, snapshot, z = 0 FOF) %s"
          % (crossed, written))
    print("lightcone path: tile solves ms per interval %s"
          % ["%.1f" % t for t in solve_ms])
    print("lightcone path: device FOF ms per call, in call order (the "
          "z = 0 snapshot's, then each lightcone slice's) %s"
          % ["%.1f" % t for t in fof_ms])
    print("lightcone path: HEALPix rows %d, flagged %d (%.4f), device "
          "pixels that differ from the host's and are not flagged %d"
          % (flags["rows"], flags["flagged"],
             flags["flagged"] / max(1, flags["rows"]), flags["unflagged"]))
    print("lightcone path: launches %s" % {k: c for k, c in launches.items()
                                           if c})
    if flags["unflagged"] or not flags["rows"]:
        raise SystemExit("lightcone path: a HEALPix device pixel differs "
                         "from the host's without a flag")
    want_zero = ("cic_paint", "cic_readout4", "cic_paint4", "merge_pairs",
                 "cic_paint_homed", "cic_readout_homed")
    # the force: the cell order, K3 and K4 (acc, potential, 2 x tidal)
    # once a force step; the 2LPT readouts through K2
    if (launches["cell_order"] != nstep
            or launches["cic_paint_into"] != nstep
            or launches["cic_readout3"] != 4 * nstep
            or launches["fof_link"] == 0
            or any(launches[k] for k in want_zero)):
        raise SystemExit("lightcone path did not run through its kernels: "
                         "%s" % launches)
    if not (sum(crossed) > 0 and any(written)):
        raise SystemExit("lightcone path: no crossings written")
    from fastpm_torch.io.bigfile import BigFile
    bf = BigFile(os.path.join(out, "usmesh"))
    aemit = bf.open_block("1/Aemit").read_all()
    pos = bf.open_block("1/Position").read_all()
    size = bf.open_block("1").attrs.get("aemitIndex.size")
    if not (np.isfinite(pos).all() and (aemit >= 0.1).all()
            and (aemit <= 1.0).all() and int(np.sum(size)) == len(aemit)
            and np.isfinite(bf.open_block("HEALPIX/Mass").read_all()).all()):
        raise SystemExit("lightcone path: bad usmesh output")
    print("lightcone path: usmesh %d rows, aemit in [%.4f, %.4f]"
          % (len(aemit), aemit.min(), aemit.max()))

    # the force's kernels at this path's shapes, on its z = 0 state: the
    # cell order, K3 and K4 with one field (the potential) and three
    # (acc, a tidal triple) against their plain versions
    from fastpm_torch.ops import cic
    pm = solver.find_pm(1.0)
    mesh, inv = tuple(pm.Nmesh), pm.InvCellSize
    x = solver.species["cdm"].wrap(pm.BoxSize).x.contiguous()
    del solver
    order = cic.cell_order(x, mesh, inv)
    canvas = torch.zeros(mesh, device=dev)
    check_close("lightcone path: K3 cic_paint_into given the cell order",
                cic.cic_paint_into(canvas, x, inv, 1.0, order),
                cic.cic_paint_into_plain(torch.zeros_like(canvas), x, inv,
                                         1.0))
    g = torch.Generator(device=dev).manual_seed(29)
    fields = [torch.randn(mesh, generator=g, device=dev) for _ in range(3)]
    for k in (1, 3):
        got = cic.cic_readout_ordered(fields[:k], x, inv, order)
        if not torch.equal(got, cic.cic_readout_plain(fields[:k], x, inv)):
            raise SystemExit("lightcone path: K4 with %d field(s) differs "
                             "from its plain version" % k)
        print("lightcone path: K4 cic_readout_ordered with %d field(s) "
              "given the cell order: equal to its plain version" % k)
    return launches, dict(out=out, wall=wall, launches=launches)


# the PGD parameters of BASELINE.md's config ladder (COLA + PGD)
PGD_LUA = ("pgdc = true\npgdc_alpha0 = 0.8\npgdc_A = 4.0\npgdc_B = 8.0\n"
           "pgdc_kl = 2.0\npgdc_ks = 10.0\n")


def load_test_module(name):
    """A tests/ module (one that imports no JAX at its top) by path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tests", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def timed_forces():
    """Every Solver's force action timed with CUDA events while the
    block runs; yields the list the (start, end) pairs go into."""
    import torch
    from fastpm_torch.solver import Solver
    pairs, do_force = [], Solver.do_force

    def timed(self, *args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        do_force(self, *args)
        end.record()
        pairs.append((start, end))
    Solver.do_force = timed
    try:
        yield pairs
    finally:
        Solver.do_force = do_force


def modes_agreement(dev, tmp, nc=32, box=96.0):
    """Phase H, first part: cola with PGD at 32^3 through cli.main on the
    CPU and on the card agree by id (phase 6's bounds), pgdc too (1e-4
    of its largest value)."""
    import numpy as np
    from fastpm_torch import cli
    res = {}
    for where in ("cpu", dev):
        out = os.path.join(tmp, "cola_agree_" + str(where))
        conf = write_lua(os.path.join(tmp, "cola_agree_%s.lua" % where),
                         SMALL_LUA.replace('"fastpm"', '"cola"') % dict(
                             nc=nc, box=box, nstep=3, zout="0.0", out=out,
                             ps=os.path.join(FIXTURES, "powerspec.txt"))
                         + PGD_LUA)
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main([conf], device=where)
        res[where] = read_by_id(os.path.join(out, "fastpm_1.0000"))
    (ia, xa, va), (ib, xb, vb) = res["cpu"], res[dev]
    dx = xb - xa
    dx -= np.round(dx / box) * box
    ex = float(np.abs(dx).max()) / (box / nc)
    ev = float(np.abs(vb - va).max() / va.std())
    print("modes: cola + PGD 32^3 CPU against the card: max |dx| %.3g "
          "cell, max |dv| %.3g rms" % (ex, ev))
    if not (np.array_equal(ia, ib) and ex < 1e-4 and ev < 1e-4):
        raise SystemExit("cola + PGD device agreement failed")


def modes_path(dev, tmp, nc=256, box=768.0, nstep=5):
    """Phase H: the main path's physics and width (phase 7) in force
    modes cola, za and 2lpt, then cola with PGD (BASELINE.md's ladder):
    each run's force actions (CUDA events, the P(k) handler and PGD
    included), particle-steps/s, wall s, peak memory and launches; then
    on each z = 0 state the carry force step alone (its sort carries
    dx1 and dx2, and pgdc), and PGD's step with its three c2r and its
    K2 launch apart. Returns the PGD run's launches."""
    import dataclasses
    import numpy as np
    import torch
    from fastpm_torch import cli, gravity, transfers
    from fastpm_torch.config.params import load_params
    from fastpm_torch.diagnostics import Log, attach_standard_handlers
    from fastpm_torch.painter import Painter
    from fastpm_torch.solver import Solver
    from fastpm_torch.ops import cic

    modes_agreement(dev, tmp)
    text = SMALL_LUA % dict(nc=nc, box=box, nstep=nstep, zout="0.0",
                            out=os.path.join(tmp, "modes"),
                            ps=os.path.join(FIXTURES, "powerspec.txt"))
    # no files: the runs' outputs are the log and the final state
    text = "\n".join(l for l in text.splitlines()
                     if not l.startswith("write_"))
    params = load_params(write_lua(os.path.join(tmp, "modes.lua"), text))
    launches = None
    for mode, pgd in (("cola", False), ("za", False), ("2lpt", False),
                      ("cola", True)):
        name = mode + (" + PGD" if pgd else "")
        cfg = dataclasses.replace(
            cli.build_config(params), force_mode=mode, pgdc=pgd,
            pgdc_alpha0=0.8, pgdc_A=4.0, pgdc_B=8.0, pgdc_kl=2.0,
            pgdc_ks=10.0)
        base = reset_peak()
        reset_launches()
        t0 = time.perf_counter()
        solver = Solver(cfg, cli.build_cosmology(params), device=dev)
        log = attach_standard_handlers(solver, Log(echo=False))
        dk, _ = cli.prepare_deltak(solver, params, log)
        solver.setup_lpt(dk, params.time_step[0])
        del dk
        with timed_forces() as pairs:
            solver.evolve(cfg.time_step)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run_launches = read_launches()
        peak = torch.cuda.max_memory_allocated() - base
        force_ms = [s.elapsed_time(e) for s, e in pairs]
        p = solver.species["cdm"]
        print("modes %s: %d^3, %d force actions %s ms (CUDA events; P(k) "
              "handler%s included), wall %.2f s, the run's peak %.3f GB "
              "(max_memory_allocated over the %.3f GB live before it)"
              % (name, nc, len(force_ms), ["%.2f" % t for t in force_ms],
                 " and PGD" if pgd else "", wall, peak / 1e9, base / 1e9))
        print("modes %s: launches %s; last log line: %s"
              % (name, {k: c for k, c in run_launches.items() if c},
                 log.lines[-1]))
        # K1 once and K2 once a force step (and once more for PGD), K2
        # for the 2LPT readouts
        want = dict({k: 0 for k in KERNELS}, cic_paint=nstep,
                    cic_readout=nstep * (2 if pgd else 1) + 6)
        if run_launches != want:
            raise SystemExit("modes %s did not run through K1 / K2: %s"
                             % (name, run_launches))
        x = p.x
        if not (bool(torch.isfinite(x).all()) and p.dx1 is not None
                and p.dx2 is not None and (p.pgdc is not None) == pgd):
            raise SystemExit("modes %s: bad final state" % name)
        pm = solver.find_pm(1.0)
        painter = Painter(pm, "cic")
        store = p.wrap(pm.BoxSize)
        step = lambda: gravity.compute_force_carry(pm, painter, store)
        ms = time_ms(step, reps=5)
        print("modes %s: force step %.2f ms (sort carrying x, v, id, dx1, "
              "dx2%s + K1 + FFTs + K2) = %.4g particle-steps/s"
              % (name, ms, ", pgdc" if pgd else "", nc ** 3 / ms * 1e3))
        if pgd:
            launches = run_launches
            # the run's final pgdc by id, phase M's reference
            o = p.id.argsort()
            ref = dict(id=p.id[o].cpu().numpy(), pgdc=p.pgdc[o].cpu().numpy(),
                       force_ms=force_ms, step_ms=ms)
            q, dk = step()
            alpha = solver.pgd.alpha(1.0)
            pgd_ms = time_ms(lambda: solver.pgd.compute_with_alpha(
                pm, q.x, dk, alpha), reps=5)
            pot = solver.pgd._pot_transfer_alpha(pm, dk, alpha)
            c2r_ms = time_ms(lambda: [pm.c2r(transfers.apply_diff(
                pm, pot, d, order=1)) for d in range(3)], reps=5)
            fields = [pm.c2r(transfers.apply_diff(pm, pot, d, order=1))
                      for d in range(3)]
            k2_ms = time_ms(lambda: cic.cic_readout(fields, q.x,
                                                    pm.InvCellSize), reps=5)
            check_close("modes cola + PGD: K2 of PGD's three fields",
                        cic.cic_readout(fields, q.x, pm.InvCellSize),
                        cic.cic_readout_plain(fields, q.x, pm.InvCellSize))
            print("modes cola + PGD: PGD %.2f ms a step: three gradient "
                  "c2r %.2f ms, one K2 launch of three fields %.4f ms"
                  % (pgd_ms, c2r_ms, k2_ms))
            del q, dk, pot, fields
        del solver, p, store, x
    return launches, ref


def check_binning(pm, dk):
    """measure_power's binning on the card (float64 sums into 1024
    copies of the bins) of a 512^3 delta_k against the same field binned
    on the host: a float64 numpy bincount of the same products (P(k) and
    k to 1e-9, the mode counts exactly: a mode in a wrong bin or copy
    moves a bin far more) and the float32 sums in mode order that small
    fields take (P(k) to 1e-3 and k to 1e-2, float32's own error over
    up to 10^6 terms a bin). Returns the card's ms with its fetch."""
    import math
    import numpy as np
    import torch
    from fastpm_torch.powerspectrum import measure_power, _shell_bins
    got = measure_power(pm, dk)
    if _shell_bins(pm)[3] == 1:
        raise SystemExit("binning: a 512^3 field was binned on the host")
    one = measure_power(pm, dk, copies=1)
    b, w, _counts, _n = _shell_bins(pm, 1)
    nbins = pm.Nmesh[0] // 2
    kmode = (torch.sqrt(pm.integer_kk().to(torch.float32))
             * (2 * math.pi / pm.BoxSize[0])).expand(pm.kshape).reshape(-1)
    prod = w * (dk.real * dk.real + dk.imag * dk.imag).reshape(-1)
    bh = b.cpu().numpy()

    def bincount(v):
        return np.bincount(bh, v.cpu().numpy().astype(np.float64),
                           minlength=nbins + 1)[:nbins]

    nm, psum, ksum = bincount(w), bincount(prod), bincount(w * kmode)
    good = nm > 0
    p64 = psum[good] / nm[good] * pm.Volume
    k64 = ksum[good] / nm[good]

    def rel(a, ref):
        return float(np.abs(a[good] / ref - 1).max())

    e64 = (rel(got.p, p64), rel(got.k, k64))
    e32 = (rel(got.p, one.p[good]), rel(got.k, one.k[good]))
    print("binning 512^3 on the card against the host: P(k) %.3g and k "
          "%.3g rel (float64 bincount), P(k) %.3g and k %.3g rel (float32 "
          "in mode order); mode counts %s"
          % (e64 + e32 + ("equal" if np.array_equal(got.Nmodes, nm)
                          else "DIFFER",)))
    if not (np.array_equal(got.Nmodes, nm) and max(e64) <= 1e-9
            and e32[0] <= 1e-3 and e32[1] <= 1e-2):
        raise SystemExit("measure_power's binning on the card disagrees "
                         "with the host's")
    return time_ms(lambda: measure_power(pm, dk), reps=5)


def lra_text(n, b, pmf, out):
    """tests/test_torch_lra.py's LRA_RUN at nc n, boxsize b and
    pm_nc_factor pmf, its files in out."""
    src = load_test_module("test_torch_lra").LRA_RUN % dict(
        out=out, ps=os.path.join(FIXTURES, "powerspec.txt"))
    for pat, rep in ((r"(?m)^nc = .*$", "nc = %d" % n),
                     (r"(?m)^boxsize = .*$", "boxsize = %r" % b),
                     (r"(?m)^pm_nc_factor = .*$",
                      "pm_nc_factor = %d" % pmf)):
        src = re.sub(pat, rep, src)
    return src


def lra_full_text(nc, box, out):
    """Phase I's run: LRA_RUN at full width on a force mesh of twice the
    particles' and no files."""
    return "\n".join(l for l in lra_text(nc, box, 2, out).splitlines()
                     if not l.startswith(("write_", "aout")))


def by_id(store):
    """(id, x, v) of a store's rows in id order, on the host."""
    p = store.compact()
    o = p.id.argsort()
    return tuple(getattr(p, c)[o].cpu().numpy() for c in ("id", "x", "v"))


def lra_path(dev, tmp, nc=256, box=1024.0):
    """Phase I: tests/test_lra.py's LRA_RUN physics (m_ncdm 0.2, n_shell
    0, z_transfer 4, ODE growth, T_cmb 2.725; 5 steps from a = 0.2) at nc
    = 256 with its 4 Mpc/h mean separation on a 512^3 force mesh through
    run_fastpm: wall, launches, peak memory; the force step with the
    response against the plain carry force, the host part (the
    measure_power fetch, update_from_power) apart, and the device's idle
    share over 2 steps. Then at 64^3 a straight run and a run restarted
    from its a = 0.6 snapshot: the history resumed, and the final
    positions and velocities by id at tests/test_lra.py's tolerances."""
    import numpy as np
    import torch
    from fastpm_torch import cli, gravity, transfers
    from fastpm_torch.config.params import load_params_from_string
    from fastpm_torch.diagnostics import Log
    from fastpm_torch.painter import Painter

    text = lra_text
    full = lra_full_text(nc, box, tmp)
    # in-run hooks: each force action (CUDA events), each step's table
    # (host clock from a synchronise: the measure_power fetch, the
    # response update and the table's upload) and its update alone
    from fastpm_torch.neutrinos_lra import DeltaTotTable
    from fastpm_torch.solver import Solver
    table_ms, update_ms = [], []
    lra_table = Solver._lra_table
    update = DeltaTotTable.update_from_power

    def host_clock(fn, into):
        def call(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a)
            into.append((time.perf_counter() - t0) * 1e3)
            return r
        return call

    Solver._lra_table = host_clock(lra_table, table_ms)
    DeltaTotTable.update_from_power = host_clock(update, update_ms)
    try:
        base = reset_peak()
        reset_launches()
        t0 = time.perf_counter()
        log = Log(echo=False)
        with timed_forces() as pairs:
            solver = cli.run_fastpm(load_params_from_string(full), log=log,
                                    device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
    finally:
        Solver._lra_table = lra_table
        DeltaTotTable.update_from_power = update
    peak = torch.cuda.max_memory_allocated() - base
    nforce = 5
    print("lra path: %d^3, box %g, %d^3 force mesh, %d force steps: wall "
          "%.2f s (the host's first Fermi-Dirac table included), the "
          "run's peak %.3f GB (max_memory_allocated over the %.3f GB live "
          "before it), history %d entries"
          % (nc, box, 2 * nc, nforce, wall, peak / 1e9, base / 1e9,
             len(solver.lra.scalefact)))
    print("lra path: force actions %s ms (CUDA events; the P(k) handler "
          "included); the step's table %s ms, of it update_from_power %s "
          "ms (host clock)" % (
              ["%.2f" % s_.elapsed_time(e) for s_, e in pairs],
              ["%.2f" % t for t in table_ms], ["%.2f" % t for t in update_ms]))
    if launches != dict({k: 0 for k in KERNELS}, cic_paint=nforce,
                        cic_readout=nforce + 6):
        raise SystemExit("lra path did not run through K1 / K2: %s"
                         % launches)
    # the run's final state and history, phase M's reference
    ref = dict(zip(("id", "x", "v"), by_id(solver.species["cdm"])),
               scalefact=np.asarray(solver.lra.scalefact),
               delta_tot=np.asarray(solver.lra.delta_tot), wall=wall,
               force_ms=[s_.elapsed_time(e) for s_, e in pairs])
    pm = solver.find_pm(1.0)
    painter = Painter(pm, "cic")
    store = solver.species["cdm"].wrap(pm.BoxSize)
    # steps past the run's end at a new time each, so that each one
    # adds a history entry as a step of the run does
    times = iter(1.0 + 0.01 * np.arange(1, 100))

    def transfer(dk):
        a = float(next(times))
        return transfers.apply_fk_interp(pm, dk,
                                         *solver._lra_table(pm, dk, a))

    lra_step = lambda: gravity.compute_force_carry(pm, painter, store,
                                                   delta_transfer=transfer)
    ms = time_ms(lra_step, reps=5)
    plain_ms = time_ms(lambda: gravity.compute_force_carry(pm, painter,
                                                           store), reps=5)
    _, dk = gravity.compute_force_carry(pm, painter, store)
    pk_ms = check_binning(pm, dk)
    del dk
    print("lra path: force step %.2f ms with the response (a new history "
          "entry each) against %.2f ms without (CUDA events) = %.4g "
          "particle-steps/s; measure_power of the 512^3 delta_k with its "
          "fetch %.2f ms" % (ms, plain_ms, nc ** 3 / ms * 1e3, pk_ms))
    profile_force(lra_step)
    del solver, store

    # restart equivalence at 64^3
    outs = {}
    for name in ("straight", "restart"):
        out = os.path.join(tmp, "lra64_" + name)
        restart = (os.path.join(outs["straight"][1], "fastpm_0.6000")
                   if name == "restart" else None)
        rlog = Log(echo=False)
        s = cli.run_fastpm(load_params_from_string(text(64, 256.0, 1, out)),
                           log=rlog, device=dev, restart=restart)
        outs[name] = (s, out)
        if restart and not rlog.contains("Restored neutrino linear-response"
                                         " state"):
            raise SystemExit("lra restart: the history was not restored")
    (s1, o1), (s2, o2) = outs["straight"], outs["restart"]
    a = read_by_id(os.path.join(o1, "fastpm_1.0000"))
    b = read_by_id(os.path.join(o2, "fastpm_1.0000"))
    ex, ev = (float(np.abs(a[i] - b[i]).max()) for i in (1, 2))
    dt = float(np.abs(np.asarray(s2.lra.delta_tot)
                      / np.asarray(s1.lra.delta_tot) - 1).max())
    print("lra restart 64^3: history %d / %d entries, max |dx| %.3g, "
          "max |dv| %.3g km/s, history rel %.3g"
          % (len(s2.lra.scalefact), len(s1.lra.scalefact), ex, ev, dt))
    if not (len(s2.lra.scalefact) == len(s1.lra.scalefact)
            and np.array_equal(a[0], b[0]) and ex <= 2e-3 and ev <= 2e-1
            and dt <= 0.03
            and not os.path.exists(os.path.join(o2, "fastpm_0.6000"))):
        raise SystemExit("lra restart equivalence failed")
    return launches, ref


def goldens_and_ics(dev, nc=64, nc_full=256):
    """Phase J: the 10 cross-mode broadband lines of tests/test_modes.py
    (pm, cola, zola, za, 2lpt at 64^3, 8 steps) on the card, each exact
    or within one unit of its last printed digit; fNL-local and two
    constraints through cli.prepare_deltak at 64^3 on the card against
    the CPU (relative max |d delta_k| <= 1e-5), and timed at 256^3."""
    import numpy as np
    import torch
    from fastpm_torch import cli
    from fastpm_torch.config.params import load_params_from_string
    from fastpm_torch.solver import Solver

    modes = load_test_module("test_torch_modes")
    exact = total = 0
    for mode, lines in modes.GOLDENS.items():
        t0 = time.perf_counter()
        log = modes.run_mode(mode, dev)
        for golden in lines:
            got = modes.check_line(log, golden)
            total += 1
            exact += got == "exact"
            line = next(l for l in log.lines
                        if l.startswith(golden.split(" = ")[0] + " = "))
            print("modes golden %s: %s (%s)" % (mode, line, got))
            if got is None:
                raise SystemExit("modes golden %s: want %s" % (mode, golden))
        print("modes golden %s: 64^3, 8 steps in %.1f s"
              % (mode, time.perf_counter() - t0))
    print("modes golden: %d of %d lines exact, the rest within one unit "
          "of the last printed digit" % (exact, total))

    ics = load_test_module("test_torch_ic_png")

    class Quiet:
        def info(self, *a):
            pass

    for case, extra in ics.EXTRA.items():
        res = {}
        for where, n, b in (("cpu", nc, 256.0), (dev, nc, 256.0),
                            (dev, nc_full, 1024.0)):
            p = load_params_from_string(ics.LUA % dict(
                nc=n, box=b, ps=os.path.join(FIXTURES, "powerspec.txt"))
                + extra)
            s = Solver(cli.build_config(p), cli.build_cosmology(p),
                       device=where)
            if where != "cpu":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            dk, _ = cli.prepare_deltak(s, p, Quiet())
            if where != "cpu":
                torch.cuda.synchronize()
            res[(str(where), n)] = (dk.cpu().numpy(),
                                    (time.perf_counter() - t0) * 1e3)
            del s, dk
        want, got = res[("cpu", nc)][0], res[(str(dev), nc)][0]
        rel = float(np.abs(got - want).max() / np.abs(want).max())
        print("ics %s: %d^3 card against CPU relative max |d delta_k| "
              "%.3g; prepare_deltak %.1f ms at %d^3 on the card (host "
              "clock)" % (case, nc, rel, res[(str(dev), nc_full)][1],
                          nc_full))
        if not rel <= 1e-5 or not np.isfinite(res[(str(dev), nc_full)][0]
                                               ).all():
            raise SystemExit("ics %s: the card disagrees with the CPU"
                             % case)


def run_mode_fed(mode, device, cols=None):
    """tests/test_torch_modes.py's cross-mode run of one force mode on
    `device`, with the CDM columns x, v (and dx1, dx2 where the mode
    keeps them) right after setup_lpt replaced by `cols` when given.
    Returns (its Log, those columns on the host, the z = 0 Sigma8 of its
    last line unrounded)."""
    import numpy as np
    import torch
    from fastpm_torch import events as ev, ic
    from fastpm_torch.cosmology import Cosmology
    from fastpm_torch.diagnostics import Log, attach_standard_handlers
    from fastpm_torch.powerspectrum import FuncK, measure_power, sigma_tophat
    from fastpm_torch.solver import Solver, SolverConfig
    modes = load_test_module("test_torch_modes")
    cosmo = Cosmology(**modes.COSMO)
    cfg = SolverConfig(nc=64, boxsize=512.0,
                       time_step=list(np.linspace(0.1, 1, 8)),
                       force_mode=mode, pm_nc_factor=1, lpt_nc_factor=1)
    s = Solver(cfg, cosmo, device=device)
    log = attach_standard_handlers(s, Log(echo=False))
    sigma8 = []

    def on_force(event):
        # the line's Sigma8 (diagnostics.write_ps) before its %g
        ps = measure_power(event.pm, event.delta_k, ring=event.solver.ring)
        sigma8.append(sigma_tophat(ps.as_funck(), 8.0)
                      / cosmo.growth_info(event.a_f).D1 ** 2)
    s.event_handlers.on(ev.EVENT_FORCE, ev.STAGE_AFTER, on_force)
    if cols is None:
        dk, _ = ic.linear_field(s.lptpm, cosmo,
                                FuncK.from_file(modes.POWERSPEC), seed=100,
                                aout=1.0, remove_cosmic_variance=True)
        s.setup_lpt(dk, cfg.time_step[0])
    else:
        s.setup_lpt(torch.zeros(s.lptpm.kshape, dtype=torch.complex64,
                                device=device), cfg.time_step[0])
        s.species["cdm"] = s.species["cdm"].replace(
            **{c: t.to(device) for c, t in cols.items()})
    p = s.species["cdm"]
    taken = {c: getattr(p, c).cpu().clone() for c in ("x", "v", "dx1", "dx2")
             if getattr(p, c) is not None}
    if cols is not None and not torch.equal(p.id.cpu(),
                                            torch.arange(64 ** 3)):
        raise SystemExit("lpt witness: the rows are not in lattice order")
    s.evolve()
    return log, taken, sigma8[-1]


def lpt_witness(dev, repeats=3):
    """Phase J, second part: the card's pm and za runs of the cross-mode
    series fed the LPT columns (x, v; za also dx1, dx2) that the port
    computed on the CPU. Each golden line of the fed card run is printed
    beside the CPU's own line and the card's own. The fed run is
    repeated, each run's z = 0 Sigma8 printed unrounded, to show how far
    the card's run-to-run arithmetic (the deposit's float32 atomics)
    moves it. The gate stays the same: each line exact or within one
    unit of its last printed digit."""
    modes = load_test_module("test_torch_modes")
    result = {}
    for mode in ("pm", "za"):
        cpu_log, cols, cpu_s8 = run_mode_fed(mode, "cpu")
        card_log, card_cols, card_s8 = run_mode_fed(mode, dev)
        fed = [run_mode_fed(mode, dev, cols) for _ in range(repeats)]
        for c in cols:
            d = (card_cols[c] - cols[c]).abs()
            print("lpt witness %s: the card's own %s against the CPU's: "
                  "%.4f of the rows differ, max |d| %.3g (max |%s| %.3g)"
                  % (mode, c, float((d.amax(dim=1) > 0).double().mean()),
                     float(d.max()), c, float(cols[c].abs().max())))
        print("lpt witness %s: z = 0 Sigma8 unrounded: CPU %.9g, card %.9g, "
              "card from the CPU's LPT columns %s" % (
                  mode, cpu_s8, card_s8,
                  ", ".join("%.9g" % f[2] for f in fed)))
        for golden in modes.GOLDENS[mode]:
            head = golden.split(" = ")[0]

            def line(log):
                return next(l for l in log.lines
                            if l.startswith(head + " = "))
            checks = [modes.check_line(f[0], golden) for f in fed]
            agree = sum(line(f[0]) == line(cpu_log) for f in fed)
            result["%s %s" % (mode, head)] = dict(
                golden=golden, cpu=line(cpu_log), card=line(card_log),
                card_from_cpu_lpt=[line(f[0]) for f in fed],
                fed_checks=checks, fed_runs_equal_to_cpu=agree)
            print("lpt witness %s: golden  %s\n  CPU        %s\n  card       "
                  "%s\n  card, CPU's LPT columns %s (%s; %d of %d such runs "
                  "print the CPU's line)"
                  % (mode, golden, line(cpu_log), line(card_log),
                     line(fed[0][0]), checks[0], agree, repeats))
            if None in checks:
                raise SystemExit("lpt witness %s: %s" % (mode, golden))
    return result


TOOL_NAMES = ("fof", "power", "paint", "halobias", "comparehalos")
PAINTERS = ("power", "paint", "halobias", "comparehalos")
K_KERNELS = ("cic_paint_into", "cell_order", "fof_link")


def cli_files_tools(dev, tmp, solver, pm, nc=256, box=768.0, nstep=5):
    """Phase K: the CLI's files, flags and tools at the main path's width
    (phase 7's physics: nc = 256, box 768, a 512^3 force mesh, 5 steps).
    Run 1 through cli.main with -T 1 -f -m <bound> --profile <dir> writes
    the white noise, the linear field in k and real space, the nonlinear
    density, a RunPB snapshot and the FOF catalog; each file is checked
    for the JAX package's attributes, the trace for the kernels' names,
    the log for the memory lines and the clocks' table; a second call
    with -m below the run's bytes in use ends in MemoryBoundExceeded.
    Run 2 starts from run 1's LinearDensityK and agrees with it by id.
    Then the tools on run 1's z = 0 snapshot (fof, power --nmesh 512,
    paint --nmesh 512, halobias, comparehalos), each timed with its peak
    memory and its launches; read_runpbic at 64^3 on the card against
    the CPU; and the main force step with the clocks on against the same
    step without them. Returns the launches of K3, cell_order and
    fof_link by part of the phase."""
    import numpy as np
    import torch
    from fastpm_torch import cli, gravity, prof, tools
    from fastpm_torch.io.bigfile import BigFile
    from fastpm_torch.io.legacy import read_runpb_snapshot
    from fastpm_torch.memory import MemoryBoundExceeded
    from fastpm_torch.painter import Painter

    ps = os.path.join(FIXTURES, "powerspec.txt")
    writes = ("write_fof = \"%(out)s/fastpm\"\n"
              "write_whitenoisek = \"%(out)s/wn\"\n"
              "write_lineark = \"%(out)s/lk\"\n"
              "write_linearr = \"%(out)s/lr\"\n"
              "write_nonlineark = \"%(out)s/nlk\"\n"
              "write_runpb_snapshot = \"%(out)s/runpb\"\n")

    def lua(name, extra="", n=nc, b=box, steps=nstep, zout="0.0"):
        out = os.path.join(tmp, name)
        text = SMALL_LUA % dict(nc=n, box=b, nstep=steps, zout=zout, out=out,
                                ps=ps)
        return write_lua(os.path.join(tmp, name + ".lua"),
                         text + extra % dict(out=out)), out

    def run(argv, where=dev):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv, device=where)
        if rc != 0:
            raise SystemExit("phase K: cli.main returned %s" % rc)
        return buf.getvalue()

    launches = {}
    # ---- run 1: every file, every flag ----
    conf, out = lua("k_run1", writes, zout="9.0, 0.0")
    trace_dir = os.path.join(tmp, "k_trace")
    bound_mb = 60000
    reset_peak()
    reset_launches()
    t0 = time.perf_counter()
    text = run(["-T", "1", "-f", "-m", str(bound_mb), "--profile",
                trace_dir, conf])
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t0
    peak1 = torch.cuda.max_memory_allocated()
    got = read_launches()
    launches["write_nonlineark"] = {k: got[k] for k in K_KERNELS}
    print("phase K run 1: %d^3, %d^3 force mesh, %d steps, every file and "
          "flag: wall %.2f s, peak %.3f GB; launches %s"
          % (nc, 2 * nc, nstep, wall1, peak1 / 1e9,
             {k: v for k, v in got.items() if v}))
    if not (got["cic_paint_into"] >= 1 and got["cell_order"] >= 1
            and got["fof_link"] >= 1 and got["cic_paint"] == nstep):
        raise SystemExit("phase K run 1: write_nonlineark / write_fof did "
                         "not launch K3, cell_order and fof_link: %s" % got)
    lines = text.splitlines()
    mem = [l for l in lines if l.startswith("Peak memory usage: device ")]
    in_use = [float(re.search(r"in use ([0-9.e+]+) MB", l).group(1))
              for l in mem]
    clocks = [l for l in lines if re.match(r"(Clock|drift|force|kick|Total)"
                                           r" ", l)]
    print("phase K run 1: %d memory lines, the last: %s" % (len(mem),
                                                           mem[-1]))
    print("phase K run 1: clocks\n  " + "\n  ".join(clocks))
    if len(mem) < 2 or len(clocks) != 5 or max(in_use) * 2 ** 20 >= (
            bound_mb << 20) or peak1 >= (bound_mb << 20):
        raise SystemExit("phase K run 1: memory lines or clocks missing, "
                         "or the bound was not above the run")

    nm = nc // 2 + 1
    want_files = {"wn": ("WhiteNoiseK", [nc, nc, nm]),
                  "lk": ("LinearDensityK", [nc, nc, nm]),
                  "lr": ("LinearDensityR", [nc, nc, nc]),
                  "nlk_1.0000": ("DensityK", [nc, nc, nm])}
    for name, (block, shape) in want_files.items():
        blk = BigFile(os.path.join(out, name)).open_block(block)
        attrs = blk.attrs.asdict()
        data = blk.read_all()
        ok = (sorted(attrs) == ["BoxSize", "Nmesh", "ndarray.ndim",
                                "ndarray.shape", "ndarray.strides"]
              and list(np.ravel(attrs["ndarray.shape"])) == shape
              and int(np.ravel(attrs["Nmesh"])[0]) == nc
              and float(np.ravel(attrs["BoxSize"])[0]) == box
              and data.shape[0] == int(np.prod(shape))
              and np.isfinite(data).all())
        print("phase K run 1: %s/%s %s %s, attributes %s" % (
            name, block, data.dtype, shape, "as the JAX package's" if ok
            else "WRONG"))
        if not ok:
            raise SystemExit("phase K run 1: bad %s" % name)
    rpb = read_runpb_snapshot(os.path.join(out, "runpb_1.0000.bin"))
    ids = np.sort(rpb["id"])
    if not (rpb["aa"] == 1.0 and np.array_equal(ids, np.arange(nc ** 3))
            and np.isfinite(rpb["v"]).all() and rpb["x"].min() >= 0
            and rpb["x"].max() <= 1):
        raise SystemExit("phase K run 1: bad RunPB snapshot")
    print("phase K run 1: RunPB snapshot, %d rows at a = %g" % (
        len(ids), rpb["aa"]))
    trace_path = os.path.join(trace_dir, "trace.json")
    with open(trace_path) as f:
        trace = f.read()
    names = ("deposit_kernel", "readout_kernel", "pass_kernel",
             "link_kernel")
    found = {k: trace.count(k) for k in names}
    print("phase K run 1: the trace (%.1f MB) names the kernels %s"
          % (len(trace) / 1e6, found))
    if not all(found.values()):
        raise SystemExit("phase K run 1: the trace misses a kernel")
    del trace

    # ---- -m below the bytes in use: MemoryBoundExceeded ----
    low = max(1, int(max(in_use) / 2))
    conf_b, out_b = lua("k_bounded")
    caught = None
    t0 = time.perf_counter()
    try:
        run(["-m", str(low), conf_b])
    except MemoryBoundExceeded as e:
        caught = e
    print("phase K: -m %d (half the largest in use, %.0f MB): %s after "
          "%.2f s" % (low, max(in_use), repr(caught),
                      time.perf_counter() - t0))
    if caught is None or os.path.exists(os.path.join(out_b,
                                                     "fastpm_1.0000")):
        raise SystemExit("phase K: the bound did not stop the run")

    # ---- run 2: from run 1's LinearDensityK; run 1 replayed ----
    # The 2LPT state (a = 0.1) is reproduced. The z = 0 rows
    # of two card runs of one field differ by the order of the force's
    # float32 atomics, grown over 5 steps: run 2 must agree with run 1
    # within phase 6's bounds or as closely as run 1 replayed from its
    # seed (3x its largest deviation).
    conf2, out2 = lua("k_run2", 'read_lineark = "%s"\n'
                      % os.path.join(out, "lk"), zout="9.0, 0.0")
    t0 = time.perf_counter()
    run([conf2])
    wall2 = time.perf_counter() - t0
    conf3, out3 = lua("k_replay", zout="9.0, 0.0")
    run([conf3])

    def deviation(a, b):
        dx = b[1] - a[1]
        dx -= np.round(dx / box) * box
        return (np.array_equal(a[0], b[0]),
                float(np.abs(dx).max()) / (box / nc),
                float(np.abs(b[2] - a[2]).max() / a[2].std()))

    dev_k = {}
    for aout in ("0.1000", "1.0000"):
        a = read_by_id(os.path.join(out, "fastpm_" + aout))
        for name, o in (("run 2", out2), ("replay", out3)):
            b = read_by_id(os.path.join(o, "fastpm_" + aout))
            dev_k[(name, aout)] = deviation(a, b)
            bits = all(np.array_equal(u, w) for u, w in zip(a, b))
            print("phase K %s against run 1 at a = %s: ids equal %s, max "
                  "|dx| %.3g cell, max |dv| %.3g rms, bit-equal %s"
                  % ((name, aout) + dev_k[(name, aout)][:1]
                     + dev_k[(name, aout)][1:] + (bits,)))
            # a = 0.1: the snapshot is the 2LPT state kicked by a
            # zero-length factor (8e-17) times the first force: positions
            # bit for bit, velocities within 1e-6 of their rms
            if aout == "0.1000" and not (
                    np.array_equal(a[1], b[1]) and dev_k[(name, aout)][0]
                    and dev_k[(name, aout)][2] <= 1e-6):
                raise SystemExit("phase K %s: the 2LPT state differs from "
                                 "run 1's" % name)
        del a, b
    same = all(np.array_equal(u, w) for u, w in zip(
        read_by_id(os.path.join(out2, "fastpm_1.0000")),
        read_by_id(os.path.join(out3, "fastpm_1.0000"))))
    print("phase K run 2 against the replay (neither profiled) at z = 0: "
          "bit-equal %s" % same)
    ok2, ex, ev = dev_k[("run 2", "1.0000")]
    _, rx, rv = dev_k[("replay", "1.0000")]
    print("phase K run 2 (read_lineark of run 1, wall %.2f s) at z = 0: "
          "max |dx| %.3g cell, max |dv| %.3g rms; run 1 replayed %.3g, "
          "%.3g; phase 6's bounds 1e-4, 1e-4" % (wall2, ex, ev, rx, rv))
    if not (ok2 and ex <= max(1e-4, 3 * rx) and ev <= max(1e-4, 3 * rv)):
        raise SystemExit("phase K run 2 disagrees with run 1")

    # ---- the tools on run 1's z = 0 snapshot ----
    snap = os.path.join(out, "fastpm_1.0000")
    tool_out = os.path.join(tmp, "k_tools")
    os.makedirs(tool_out, exist_ok=True)
    argvs = {
        "fof": [snap, "-o", os.path.join(tool_out, "fof")],
        "power": [os.path.join(tool_out, "power.txt"), "--nmesh", "512",
                  snap],
        "paint": [os.path.join(tool_out, "paint"), snap, "--nmesh", "512"],
        "halobias": [os.path.join(tool_out, "bias.txt"), snap, "--",
                     snap],
        "comparehalos": [os.path.join(tool_out, "cmp.txt"),
                         os.path.join(tool_out, "fof"), "--", snap]}
    timings = {}
    for name in TOOL_NAMES:
        base = reset_peak()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = tools.main([name] + argvs[name], device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_launches()
        launches[name] = {k: got[k] for k in K_KERNELS}
        peak = torch.cuda.max_memory_allocated()
        timings[name] = dict(wall_s=wall, peak_gb=peak / 1e9,
                             own_peak_gb=(peak - base) / 1e9)
        print("phase K tool %s: rc %s, wall %.2f s, peak %.3f GB (%.3f GB "
              "above the %.3f GB live before it), launches %s"
              % (name, rc, wall, peak / 1e9, (peak - base) / 1e9,
                 base / 1e9, launches[name]))
        want = (got["fof_link"] >= 1 if name == "fof"
                else got["cic_paint_into"] >= 1 and got["cell_order"] >= 1)
        if rc != 0 or not want:
            raise SystemExit("phase K tool %s did not run through its "
                             "kernels" % name)
    run_cat, tool_cat = (BigFile(p) for p in (snap, argvs["fof"][2]))
    same = all(np.array_equal(
        run_cat.open_block("LL-0.200/" + c).read_all(),
        tool_cat.open_block("LL-0.200/" + c).read_all())
        for c in ("Length", "MinID"))
    nh = len(tool_cat.open_block("LL-0.200/Length").read_all())
    print("phase K tool fof: %d halos, Length and MinID equal to run 1's "
          "write_fof catalog: %s" % (nh, same))
    if not same or nh == 0:
        raise SystemExit("phase K: the fof tool's catalog differs from "
                         "the run's")
    pk = np.loadtxt(argvs["power"][0])
    field = BigFile(argvs["paint"][0]).open_block("N0512").read_all()
    bias = np.loadtxt(argvs["halobias"][0], ndmin=2).reshape(-1, 4)
    print("phase K tools: power %d bins, finite %s; paint 512^3 mean %.6f "
          "(want 1); halobias %s" % (len(pk), np.isfinite(pk).all(),
                                     float(field.mean(dtype=np.float64)),
                                     bias[:, 3].tolist()))
    if not (np.isfinite(pk).all() and len(pk) > 100
            and abs(field.mean(dtype=np.float64) - 1) < 1e-3
            and np.isfinite(bias).all() and len(bias)):
        raise SystemExit("phase K: bad power, paint or halobias output")
    del field
    worst = 0.0
    for rx_path in sorted(glob.glob(os.path.join(tool_out,
                                                 "cmp-nmin-*-rx.txt"))):
        rx = np.loadtxt(rx_path)
        r1 = np.loadtxt(rx_path.replace("-rx.txt", "-r1.txt"))
        r2 = np.loadtxt(rx_path.replace("-rx.txt", "-r2.txt"))
        good = (rx[:, 3] > 0) & (r1[:, 2] > 0) & (r2[:, 2] > 0)
        corr = rx[good, 2] / np.sqrt(r1[good, 2] * r2[good, 2])
        worst = max(worst, float(np.abs(corr - 1).max()))
    ncmp = len(glob.glob(os.path.join(tool_out, "cmp-nmin-*-rx.txt")))
    print("phase K tool comparehalos: %d thresholds, the fof tool's catalog "
          "against run 1's: max |cross-correlation - 1| %.3g" % (ncmp, worst))
    if ncmp == 0 or not worst <= 1e-5:
        raise SystemExit("phase K: comparehalos' cross-correlation is not 1")

    # ---- read_runpbic at 64^3: the card against the CPU ----
    conf_w, out_w = lua("k_runpb_src", 'write_runpb_snapshot = '
                        '"%(out)s/runpb"\n', n=64, b=192.0, steps=3,
                        zout="9.0")
    run([conf_w], "cpu")
    ic_path = os.path.join(out_w, "runpb_0.1000.bin")
    rows = {}
    for where in ("cpu", dev):
        name = "k_runpbic_%s" % where
        conf_r, out_r = lua(name, 'read_runpbic = "%s"\n' % ic_path, n=64,
                            b=192.0, steps=3)
        t0 = time.perf_counter()
        run([conf_r], where)
        rows[where] = (read_by_id(os.path.join(out_r, "fastpm_1.0000")),
                       time.perf_counter() - t0)
    (a, _), (b, t_card) = rows["cpu"], rows[dev]
    dx = b[1] - a[1]
    dx -= np.round(dx / 192.0) * 192.0
    ex = float(np.abs(dx).max()) / 3.0
    ev = float(np.abs(b[2] - a[2]).max() / a[2].std())
    print("phase K read_runpbic 64^3: card against CPU max |dx| %.3g cell, "
          "max |dv| %.3g rms (card run %.2f s)" % (ex, ev, t_card))
    if not (np.array_equal(a[0], b[0]) and ex < 1e-4 and ev < 1e-4):
        raise SystemExit("phase K: read_runpbic card and CPU disagree")

    # ---- the main step with the clocks on and off ----
    painter = Painter(pm, "cic")
    store = solver.species["cdm"].wrap(pm.BoxSize)

    def step():
        gravity.compute_force_carry(pm, painter, store)

    clocks = []

    def clocked():
        with prof.clock("force") as c:
            step()
        clocks[:] = [c]

    # The step waits on the host between its launches (8-9 % idle), so a
    # block of 10 steps moves with the host's own pauses by more than the
    # clocks cost: 6 rounds of a block each, the order alternated so that
    # a drift of the card's clocks falls on both, with the garbage
    # collector held off, and the least block of each compared.
    prof.reset()
    prof.enable_sync(True)
    off, on = [], []
    gc.collect()
    gc.disable()
    try:
        for r in range(6):
            for fn in ((step, clocked) if r % 2 == 0 else (clocked, step)):
                (off if fn is step else on).append(time_ms(fn, reps=10))
    finally:
        gc.enable()
        prof.enable_sync(False)
    c = clocks[0]
    paired = sorted(b - a for a, b in zip(off, on))
    print("phase K: the main force step without the clocks %s ms, with "
          "them (on the card: CUDA events) %s ms; least %.3f / %.3f, "
          "median of the rounds' differences %.3f ms; the clock read %.3f "
          "ms a step over %d"
          % ([round(v, 3) for v in off], [round(v, 3) for v in on],
             min(off), min(on), (paired[2] + paired[3]) / 2,
             c.time / c.count * 1e3, c.count))
    prof.reset()
    if not abs(min(on) - min(off)) <= 0.3:
        raise SystemExit("phase K: the clocks cost more than 0.3 ms a step")
    return dict(launches=launches, tools=timings, run1_wall_s=wall1,
                run1_peak_gb=peak1 / 1e9, run2_wall_s=wall2,
                step_ms_clocks_off=off, step_ms_clocks_on=on)


def run_launches():
    """The counts of every kernel, and of the homed kernels' launches on
    a Pencil (key name + "_open_y")."""
    out = read_launches()
    out.update({name + "_open_y": wrapper(name).launches_open_y
                for name in HOMED})
    return out


def close_by_id(label, got, want, cell, box, tol=1e-3):
    """Two (id, x, v) triples in id order, each from a run on the card:
    the ids equal, max |dx| in cells (the periodic distance in a box of
    side box: a row at 0 and one at box are one position) and max |dv|
    over the rms of v within tol. Two card runs of one field already
    differ by 1.5-2.0e-4 of a cell at z = 0 (the deposit's float32
    atomics in no fixed order; phase K), so the bound is 5 times that,
    not phase 6's 1e-4 for a CPU run against a card run. Returns the two
    errors."""
    import numpy as np
    dx = got[1] - want[1]
    dx -= np.round(dx / box) * box
    ex = float(np.abs(dx).max()) / cell
    ev = float(np.abs(got[2] - want[2]).max() / want[2].std())
    ok = np.array_equal(got[0], want[0]) and ex <= tol and ev <= tol
    print("%s: ids %s, max |dx| %.3g cell, max |dv| %.3g rms (bounds %g)"
          % (label, "equal" if np.array_equal(got[0], want[0]) else
             "DIFFER", ex, ev, tol))
    if not ok:
        raise SystemExit("%s disagrees" % label)
    return ex, ev


def homed_want(kind, paints, reads, **others):
    """Phase M's expected counts: the homed paint and readout (on a
    Pencil too for the pencil), every other kernel as given or 0."""
    want = dict({k: 0 for k in KERNELS}, **others)
    want.update(cic_paint_homed=paints, cic_readout_homed=reads)
    for name in HOMED:
        want[name + "_open_y"] = want[name] if kind == "pencil" else 0
    return want


def check_launches(label, got, want, skip=()):
    """SystemExit unless every count of want but those in skip is got's."""
    bad = {k: (got[k], want[k]) for k in want
           if k not in skip and got[k] != want[k]}
    print("%s: launches %s" % (label, {k: c for k, c in got.items() if c}))
    if bad:
        raise SystemExit("%s did not run through its kernels (got, want): "
                         "%s" % (label, bad))


def ranks_path(dev, tmp, main_out, main_store, lra_ref, pgd_ref, lc_ref,
               nc=256, nstep=5, box=768.0, lra_box=1024.0, lc_box=2048.0):
    """Phase M: the options the JAX package runs on a device mesh, over
    a one-rank NCCL process group, once on its ring (x-slabs: homed K1
    and K2) and once on its 1 x 1 Grid (pencils: their open-y mode),
    through the entry points (cli.run_fastpm with group / grid, Solver):
    phase I's LRA run against phase I's by id and history; phase H's
    cola + PGD against its pgdc; phase 7's physics restarted from its
    a = 0.55 snapshot against its z = 0 state; phase G's lightcone with
    write_rfof against its usmesh rows and FOF halos; and, on the ring
    only, phase 7's physics with rehome=True against the dense slab
    carry, with the rows each migration moved. Each run's wall, peak
    memory and launches (the counters set to 0 just before it) are
    printed and checked; the LRA, PGD and rehome force steps are timed
    and profiled. Returns {run: launches}."""
    import dataclasses
    import socket
    import numpy as np
    import torch
    import torch.distributed as dist
    from fastpm_torch import cli, gravity
    from fastpm_torch.config.params import load_params, load_params_from_string
    from fastpm_torch.diagnostics import Log, attach_standard_handlers
    from fastpm_torch.io.bigfile import BigFile
    from fastpm_torch.painter import Painter
    from fastpm_torch.parallel import psolver
    from fastpm_torch.parallel.comm import Grid
    from fastpm_torch.solver import Solver

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method="tcp://localhost:%d" % port,
                            rank=0, world_size=1)
    out_launches = {}

    def check(label, got, want, skip=()):
        out_launches[label] = got
        check_launches("phase M " + label, got, want, skip)

    def run(label, fn):
        """fn() -> solver, with the launch counters, the peak and the
        force actions' CUDA events around it."""
        base = reset_peak()
        reset_launches()
        t0 = time.perf_counter()
        with timed_forces() as pairs:
            solver = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = run_launches()
        peak = torch.cuda.max_memory_allocated() - base
        force_ms = [a.elapsed_time(b) for a, b in pairs]
        print("phase M %s: wall %.2f s, force actions %s ms (CUDA events), "
              "the run's peak %.3f GB over %.3f GB live, force paths %s"
              % (label, wall, ["%.2f" % t for t in force_ms], peak / 1e9,
                 base / 1e9, dict(solver.force_paths)))
        return solver, got

    try:
        ones = torch.ones(1, device=dev)
        dist.all_reduce(ones)
        group = dist.group.WORLD
        grids = {"slab": None, "pencil": Grid(group, 1, 1)}
        print("phase M: one-rank NCCL group (all_reduce %g); the slab on "
              "its ring, the pencil on its 1 x 1 grid" % float(ones))
        main_ref = by_id(main_store)
        for kind, grid in grids.items():
            where = dict(device=dev, group=group, grid=grid)
            carry = "pencil-carry" if kind == "pencil" else "homed-carry"

            # ---- phase I's linear response ----
            params = load_params_from_string(lra_full_text(nc, lra_box, tmp))
            solver, got = run("%s LRA" % kind, lambda: cli.run_fastpm(
                params, log=Log(echo=False), **where))
            # the force through the homed kernels, the 2LPT readouts
            # through K2
            check("%s LRA" % kind, got, homed_want(
                kind, nstep, nstep, cic_readout=6))
            close_by_id("phase M %s LRA against phase I by id" % kind,
                        by_id(solver.species["cdm"]),
                        (lra_ref["id"], lra_ref["x"], lra_ref["v"]),
                        lra_box / nc, lra_box)
            rel = float(np.abs(np.asarray(solver.lra.delta_tot)
                               / lra_ref["delta_tot"] - 1).max())
            print("phase M %s LRA: history %d entries, times equal %s, "
                  "deltas rel %.3g of phase I's (bound 1e-4)"
                  % (kind, len(solver.lra.scalefact), np.array_equal(
                      solver.lra.scalefact, lra_ref["scalefact"]), rel))
            if not (np.array_equal(solver.lra.scalefact,
                                   lra_ref["scalefact"]) and rel <= 1e-4):
                raise SystemExit("phase M %s LRA history disagrees" % kind)
            pm = solver.find_pm(1.0)
            times = iter(1.0 + 0.01 * np.arange(1, 100))
            step = lambda: solver.force(pm, float(next(times)))
            ms = time_ms(step, reps=5)
            print("phase M %s LRA: force step %.2f ms with the response (a "
                  "new history entry each; phase I's run force actions %s "
                  "ms on one device)" % (kind, ms, ["%.2f" % t for t in
                                                   lra_ref["force_ms"]]))
            profile_force(step, label="phase M %s LRA force profile" % kind)
            del solver, step

            # ---- phase H's cola + PGD ----
            text = main_text(nc, box, nstep, os.path.join(tmp, "mcola"))
            text = "\n".join(l for l in text.splitlines()
                             if not l.startswith(("write_", "aout")))
            params = load_params_from_string(text)
            cfg = dataclasses.replace(
                cli.build_config(params), force_mode="cola", pgdc=True,
                pgdc_alpha0=0.8, pgdc_A=4.0, pgdc_B=8.0, pgdc_kl=2.0,
                pgdc_ks=10.0)

            def cola_pgd():
                s_ = Solver(cfg, cli.build_cosmology(params), **where)
                log = attach_standard_handlers(s_, Log(echo=False))
                dk, _ = cli.prepare_deltak(s_, params, log)
                s_.setup_lpt(dk, params.time_step[0])
                del dk
                s_.evolve(cfg.time_step)
                return s_

            solver, got = run("%s cola + PGD" % kind, cola_pgd)
            check("%s cola + PGD" % kind, got, homed_want(
                kind, nstep, 2 * nstep, cic_readout=6))
            p = solver.species["cdm"]
            o = p.id.argsort()
            pgdc = p.pgdc[o].cpu().numpy()
            scale = float(np.abs(pgd_ref["pgdc"]).max())
            err = float(np.abs(pgdc - pgd_ref["pgdc"]).max())
            # two card runs differ by the deposit's run-to-run spread,
            # which 5 steps amplify in pgdc (4.5e-4 of its largest in
            # this phase's second run): the runs within 2e-3, and PGD
            # itself within 1e-4 on one state, below
            print("phase M %s cola + PGD against phase H's run: ids equal "
                  "%s, max |d pgdc| %.3g = %.3g of its largest (bound 2e-3)"
                  % (kind, np.array_equal(p.id[o].cpu().numpy(),
                                          pgd_ref["id"]), err, err / scale))
            if not (np.array_equal(p.id[o].cpu().numpy(), pgd_ref["id"])
                    and err <= 2e-3 * scale):
                raise SystemExit("phase M %s: pgdc disagrees with phase H"
                                 % kind)
            # on the run's final state: the force with PGD over the
            # group against the single-device force and PGD
            pm = solver.find_pm(1.0)
            solver.force(pm, 1.0)
            p = solver.species["cdm"]
            q, dk = gravity.compute_force_carry(pm, Painter(pm, "cic"),
                                                p.wrap(pm.BoxSize))
            want = solver.pgd.compute_with_alpha(pm, q.x, dk,
                                                 solver.pgd.alpha(1.0))
            got = p.pgdc[p.id.argsort()]
            want = want[q.id.argsort()]
            err = float((got - want).abs().max() / want.abs().max())
            print("phase M %s PGD on one state: over the group against "
                  "one device, max |d pgdc| %.3g of its largest (bound "
                  "1e-4)" % (kind, err))
            if not err <= 1e-4:
                raise SystemExit("phase M %s: PGD over the group disagrees "
                                 "with one device" % kind)
            del q, dk, got, want
            ms = time_ms(lambda: solver.force(pm, 1.0), reps=5)
            print("phase M %s cola + PGD: force step with PGD %.2f ms "
                  "(phase H on one device: force step %.2f ms, its run's "
                  "force actions %s ms)" % (kind, ms, pgd_ref["step_ms"],
                                           ["%.2f" % t for t in
                                            pgd_ref["force_ms"]]))
            del solver, p

            # ---- phase 7's physics restarted at a = 0.55 ----
            out = os.path.join(tmp, "mrestart_" + kind)
            params = load_params_from_string(main_text(nc, box, nstep, out))
            snap = os.path.join(main_out, "fastpm_0.5500")
            solver, got = run("%s restart" % kind, lambda: cli.run_fastpm(
                params, log=Log(echo=False), restart=snap, **where))
            # forces at a = 0.55, 0.775 and 1
            check("%s restart" % kind, got, homed_want(kind, 3, 3))
            got_ref = by_id(solver.species["cdm"])
            ex = float(np.abs(got_ref[1] - main_ref[1]).max())
            ev = float(np.abs(got_ref[2] - main_ref[2]).max())
            print("phase M %s restart from phase 7's a = 0.55 snapshot: ids "
                  "equal %s, max |dx| %.3g Mpc/h, max |dv| %.3g (internal; "
                  "bounds 2e-3 and 2e-3, phase I's restart bounds), a = 0.55 "
                  "not rewritten %s" % (
                      kind, np.array_equal(got_ref[0], main_ref[0]), ex, ev,
                      not os.path.exists(os.path.join(out,
                                                      "fastpm_0.5500"))))
            if not (np.array_equal(got_ref[0], main_ref[0]) and ex <= 2e-3
                    and ev <= 2e-3 and not os.path.exists(
                        os.path.join(out, "fastpm_0.5500"))):
                raise SystemExit("phase M %s restart disagrees with phase "
                                 "7" % kind)
            del solver, got_ref

            # ---- phase G's lightcone with RFOF ----
            conf, out = lightcone_lua(tmp, "lightcone.lua", "mlc_" + kind, (
                (r"(?m)^nc = .*$", "nc = %d" % nc),
                (r"(?m)^boxsize = .*$", "boxsize = %r" % lc_box),
                (r"(?m)^lc_usmesh_fof_padding = .*$",
                 "lc_usmesh_fof_padding = 20.0\nlc_usmesh_healpix_nside = 32"
                 "\nwrite_rfof = \"%s/rfof\"" % os.path.join(
                     tmp, "mlc_" + kind))))
            params = load_params(conf)
            nlc = len(params.time_step)
            solver, got = run("%s lightcone" % kind, lambda: cli.run_fastpm(
                params, log=Log(echo=False), **where))
            # the force: the homed multi with the potential and the tidal
            # tensor (4 readouts a step); FOF and RFOF through fof_link
            check("%s lightcone" % kind, got, homed_want(
                kind, nlc, 4 * nlc,
                cic_readout=lc_ref["launches"]["cic_readout"]),
                skip=("fof_link",))
            if got["fof_link"] <= lc_ref["launches"]["fof_link"]:
                raise SystemExit("phase M %s lightcone: fof_link %d, not "
                                 "more than phase G's %d without RFOF"
                                 % (kind, got["fof_link"],
                                    lc_ref["launches"]["fof_link"]))
            del solver
            cols = []
            for d in (out, lc_ref["out"]):
                bf = BigFile(os.path.join(d, "usmesh"))
                cols.append((np.sort(bf.open_block("1/ID").read_all()
                                     .reshape(-1)),
                             len(bf.open_block("LL-0.200/Length")
                                 .read_all())))
            (ids, nh), (ids0, nh0) = cols
            common = np.intersect1d(ids, ids0).size
            nrfof = len(BigFile(os.path.join(out, "usmesh")).open_block(
                "RFOF/Length").read_all())
            # the z = 0 snapshot's catalogs: FOF against phase G's, and
            # the RFOF one this run adds
            z0 = [BigFile(os.path.join(d, "fof_1.0000")).open_block(
                "LL-0.200/Length").read_all() for d in (out, lc_ref["out"])]
            rfof0 = BigFile(os.path.join(out, "rfof_1.0000")).open_block(
                "RFOF/Length").read_all()
            print("phase M %s lightcone: usmesh %d rows (phase G %d), "
                  "distinct ids in common %d of %d; lightcone FOF halos %d "
                  "(phase G %d), RFOF halos %d; z = 0 FOF %d halos of %d "
                  "rows (phase G %d of %d), z = 0 RFOF %d halos" % (
                      kind, len(ids), len(ids0), common,
                      np.unique(ids0).size, nh, nh0, nrfof, len(z0[0]),
                      z0[0].sum(), len(z0[1]), z0[1].sum(), len(rfof0)))
            if not (abs(len(ids) - len(ids0)) <= 1e-4 * len(ids0)
                    and common >= (1 - 1e-4) * np.unique(ids0).size
                    and abs(nh - nh0) <= 1e-3 * nh0 and len(z0[1]) > 0
                    and abs(len(z0[0]) - len(z0[1])) <= 1e-3 * len(z0[1])
                    and len(rfof0) > 0):
                raise SystemExit("phase M %s lightcone disagrees with phase "
                                 "G" % kind)
            print("phase M %s lightcone: wall beside phase G's %.2f s"
                  % (kind, lc_ref["wall"]))

        # ---- rehoming on the ring: phase 7's physics, rehome and dense ----
        text = main_text(nc, box, nstep, os.path.join(tmp, "mrehome"))
        text = "\n".join(l for l in text.splitlines()
                         if not l.startswith(("write_", "aout")))
        params = load_params_from_string(text)
        moved = []
        hop = psolver._hop

        def counted_hop(store, ring, h):
            moved.append(int(store.alive.sum()))
            return hop(store, ring, h)

        states = {}
        for name, rehome in (("dense", False), ("rehome", True)):
            cfg = dataclasses.replace(cli.build_config(params),
                                      rehome=rehome)

            def main_physics():
                s_ = Solver(cfg, cli.build_cosmology(params), device=dev,
                            group=group)
                dk, _ = cli.prepare_deltak(s_, params, Log(echo=False))
                s_.setup_lpt(dk, params.time_step[0])
                del dk
                s_.evolve(cfg.time_step)
                return s_

            psolver._hop = counted_hop
            try:
                solver, got = run("slab %s" % name, main_physics)
            finally:
                psolver._hop = hop
            check("slab %s" % name, got, homed_want(
                "slab", nstep, nstep, cic_readout=6))
            paths = dict(solver.force_paths)
            want_path = "homed-rehome" if rehome else "homed-carry"
            if paths != {want_path: nstep}:
                raise SystemExit("phase M slab %s: force paths %s" % (name,
                                                                     paths))
            states[name] = solver
        print("phase M slab rehome: rows sent per hop (to the right, to the "
              "left; a force each) %s of %d particles; the store's rows %d"
              % (moved, nc ** 3, states["rehome"].species["cdm"].np_local))
        close_by_id("phase M slab rehome against the dense slab carry",
                    by_id(states["rehome"].species["cdm"]),
                    by_id(states["dense"].species["cdm"]), box / nc, box)
        # one force step of each body from its own z = 0 state
        pm = states["dense"].find_pm(1.0)
        eng = states["dense"]._engine(pm, False)
        dense = states["dense"].species["cdm"].wrap(pm.BoxSize)
        rehomed = states["rehome"].species["cdm"].wrap(pm.BoxSize)
        H = psolver.pick_halo_rehomed(pm, eng.ring, rehomed)
        Hd = psolver.pick_halo(pm, eng.ring, [dense.x])
        for label, step in (
                ("dense homed carry (H = %d)" % Hd,
                 lambda: psolver._force_local_homed_carry(
                     eng, dense, "1_4", Hd)),
                ("rehome body (H = %d, R = %d rows)" % (H, rehomed.np_local),
                 lambda: psolver._force_local_homed_rehome(
                     eng, rehomed, "1_4", H))):
            reset_peak()
            ms = time_ms(step, reps=5)
            print("phase M slab %s: %.2f ms a force step, peak %.3f GB"
                  % (label, ms, torch.cuda.max_memory_allocated() / 1e9))
        profile_force(lambda: psolver._force_local_homed_rehome(
            eng, rehomed, "1_4", H), label="phase M rehome body profile")
        del states, dense, rehomed
    finally:
        dist.destroy_process_group()
    return out_launches



# ---- phase O: baryons and order-preserving stepping ----------------------

# the kernels of phase O's paths, whose launches the JSON line carries
O_KERNELS = ("cic_paint_into", "cell_order", "cic_readout3",
             "cic_paint_homed", "cic_readout_homed")
# the baryons' mass per particle, as a share of the CDM's (a test mass:
# the cosmology has no Omega_b)
BARYON_SHARE = 0.15


def species_solver(params, cfg, where):
    """Phase O2's three species through the entry points: a Solver of
    cfg, prepare_deltak and setup_lpt (CDM), a baryon lattice of nc^3
    shifted by half a cell with a mass column (BARYON_SHARE of the CDM's
    M0) and the potential and tidal columns, set up by
    setup_lpt(species=BARYON) from the same delta_k, and ncdm.lua's
    split (cli.prepare_ncdm), evolved."""
    import numpy as np
    import torch
    from fastpm_torch import cli
    from fastpm_torch.diagnostics import Log
    from fastpm_torch.solver import Solver, BARYON, CDM
    from fastpm_torch.store import lattice_store
    s = Solver(cfg, cli.build_cosmology(params), **where)
    log = Log(echo=False)
    a0 = float(params.time_step[0])
    dk, _ = cli.prepare_deltak(s, params, log)
    s.setup_lpt(dk, a0)
    nc, box = cfg.nc, cfg.boxsize
    b = lattice_store(s.basepm, Nc=nc, shift=0.5 * box / nc, name="baryon",
                      columns=("v", "acc", "id", "potential", "tidal"))
    M0 = BARYON_SHARE * s.species[CDM].M0
    b = b.replace(M0=M0, mass=torch.full((b.np_local,), float(np.float32(M0)),
                                         device=b.x.device), a_x=a0, a_v=a0)
    s.add_species(BARYON, b)
    del b
    s.setup_lpt(dk, a0, species=BARYON)
    del dk
    cli.prepare_ncdm(s, params, a0, log)
    s.evolve(cfg.time_step)
    return s


def species_config(params):
    """Phase O2's SolverConfig: ncdm.lua's with gaussian softening, the
    potential and the tidal tensor."""
    import dataclasses
    from fastpm_torch import cli
    return dataclasses.replace(cli.build_config(params),
                               softening_type="gaussian",
                               compute_potential=True, compute_tidal=True)


def species_cols(solver):
    """{species: {column: host array in id order}} of a Solver."""
    out = {}
    for name in solver.iter_species():
        p = solver.species[name].compact()
        o = p.id.argsort()
        out[name] = {c: t[o].cpu().numpy() for c, t in p.columns()}
    return out


def species_agreement(dev, tmp, nc=32, box=256.0):
    """Phase O2's CPU-against-card run at nc = 32 (ncdm.lua at box 256):
    each species by id, x within 1e-4 of a cell, v, the potential and
    the tidal tensor within 1e-4 of their rms (phase 6's bounds)."""
    import numpy as np
    from fastpm_torch.config.params import load_params
    conf, _ = ncdm_lua(tmp, "o2_agree", nc=nc, box=box)
    params = load_params(conf)
    cfg = species_config(params)
    cols = {where: species_cols(species_solver(params, cfg,
                                               dict(device=where)))
            for where in ("cpu", dev)}
    a, b = cols["cpu"], cols[dev]
    ok = list(a) == list(b) == ["baryon", "cdm", "ncdm"]
    for name in a:
        ca, cb = a[name], b[name]
        same = np.array_equal(ca["id"], cb["id"])
        dx = cb["x"] - ca["x"]
        dx -= np.round(dx / box) * box
        errs = {"x": float(np.abs(dx).max()) / (box / nc)}
        for c in ("v", "potential", "tidal"):
            if c in ca:
                errs[c] = float(np.abs(cb[c] - ca[c]).max() / ca[c].std())
        print("phase O2 CPU against card %d^3, %s (%d rows): ids equal %s, "
              "max |dx| %.3g cell, %s (of the rms; bounds 1e-4)"
              % (nc, name, len(ca["id"]), same, errs["x"],
                 ", ".join("max |d %s| %.3g" % (c, e) for c, e in errs.items()
                           if c != "x")))
        ok = ok and same and max(errs.values()) < 1e-4
    if not ok:
        raise SystemExit("phase O2: the CPU and the card disagree")


def check_species_kernels(pm, stores, rows):
    """At phase O2's z = 0 state (three species, two with mass columns):
    cell_order of each species against its plain version bit for bit,
    K3 painting the three species given their orders against its plain
    version, and K4 given each order against its plain version."""
    import numpy as np
    import torch
    from fastpm_torch.ops import cic
    mesh, inv = tuple(pm.Nmesh), pm.InvCellSize
    xs = [p.x for p in stores]
    masses = [p.mass if p.mass is not None else float(np.float32(p.M0))
              for p in stores]
    orders = [cic.cell_order(x, mesh, inv) for x in xs]
    check_order("at phase O2's z = 0 state", xs, orders, mesh, inv)
    canvas = torch.zeros(mesh, device=xs[0].device)
    want = torch.zeros_like(canvas)
    for x, m, o in zip(xs, masses, orders):
        cic.cic_paint_into(canvas, x, inv, m, o)
        cic.cic_paint_into_plain(want, x, inv, m)
    rows["cic_paint_into"]["err"] = max(rows["cic_paint_into"]["err"],
                                        check_close(
        "K3 cic_paint_into, phase O2's three species in store order, given "
        "the cell orders", canvas, want))
    del canvas, want
    g = torch.Generator(device=xs[0].device).manual_seed(15)
    fields = [torch.randn(mesh, device=xs[0].device, generator=g)
              for _ in range(3)]
    err = 0.0
    for x, o in zip(xs, orders):
        err = max(err, check_close(
            "K4 cic_readout3, phase O2, %d rows given the cell order"
            % x.shape[0], cic.cic_readout3(*fields, x, inv, o),
            cic.cic_readout_plain(fields, x, inv)))
    rows["cic_readout3"]["err"] = max(rows["cic_readout3"]["err"], err)


def order_path(dev, tmp, main_store, rows, nc=256, nstep=5, box=768.0):
    """Phase O: baryons and order-preserving stepping at full width. O1:
    phase 7's physics with order_free=False through Solver from
    prepare_deltak (rows in place, against phase 7 by id). O2: CDM, a
    baryon lattice with a mass column and ncdm.lua's ncdm, gaussian
    softening, the potential and the tidal tensor (the JAX wide-path
    test's shape at the main path's width), with a CPU-against-card run
    at nc = 32 and the kernels against their plain versions at its
    state. O3: O1 and O2 on a one-rank NCCL group, on its ring (the slab
    multi) and its 1 x 1 grid (the pencil multi for O1; v1 for O2,
    whose ncdm rows are not pencil-blocked), against O1 and O2.
    Each run's launches (the counters set to 0 just before it), wall,
    force actions, peak and force paths are printed and checked, and a
    force step of each is timed. Returns {run: launches}."""
    import dataclasses
    import socket
    import numpy as np
    import torch
    import torch.distributed as dist
    from fastpm_torch import cli, gravity
    from fastpm_torch.config.params import load_params, load_params_from_string
    from fastpm_torch.diagnostics import Log
    from fastpm_torch.painter import Painter
    from fastpm_torch.parallel.comm import Grid
    from fastpm_torch.solver import Solver, BARYON, CDM, NCDM
    from fastpm_torch.units import RHO_CRIT

    out_launches = {}
    t_phase = time.perf_counter()

    def run(label, fn):
        """fn() -> solver, with the launch counters, the peak and the
        force actions' CUDA events around it."""
        base = reset_peak()
        reset_launches()
        t0 = time.perf_counter()
        with timed_forces() as pairs:
            solver = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = run_launches()
        out_launches[label] = got
        peak = torch.cuda.max_memory_allocated() - base
        print("phase %s: wall %.2f s, force actions %s ms (CUDA events), the "
              "run's peak %.3f GB over %.3f GB live, force paths %s"
              % (label, wall, ["%.2f" % a.elapsed_time(b) for a, b in pairs],
                 peak / 1e9, base / 1e9, dict(solver.force_paths)))
        return solver, got

    def check_paths(label, solver, path):
        """Every force through `path` (a replay after an overflow
        allowed); returns the forces run, replays included."""
        paths = dict(solver.force_paths)
        if not (paths.get(path) and set(paths) <= {path, "overflow"}):
            raise SystemExit("phase %s: force paths %s, not %s alone"
                             % (label, paths, path))
        return sum(paths.values())

    def step_ms(label, solver):
        """One force step of the solver's final state, CUDA events."""
        pm = solver.find_pm(1.0)
        ms = time_ms(lambda: solver.force(pm, 1.0), reps=5)
        n = sum(solver.global_count(s) for s in solver.iter_species())
        print("phase %s: force step %.2f ms = %.4g particle-steps/s (N = "
              "%.1f M)" % (label, ms, n / ms * 1e3, n / 1e6))
        return ms

    def in_place(label, store):
        same = torch.equal(store.id, torch.arange(store.np_local,
                                                  device=store.id.device))
        print("phase %s: rows in id order in place (id == arange(%d)) %s"
              % (label, store.np_local, same))
        if not same:
            raise SystemExit("phase %s: the rows moved" % label)

    # ---- O1: phase 7's physics, order_free=False, one card ----
    text = main_text(nc, box, nstep, os.path.join(tmp, "order"))
    text = "\n".join(l for l in text.splitlines()
                     if not l.startswith(("write_", "aout")))
    params1 = load_params_from_string(text)
    cfg1 = dataclasses.replace(cli.build_config(params1), order_free=False)

    def ordered(where):
        def fn():
            s_ = Solver(cfg1, cli.build_cosmology(params1), **where)
            dk, _ = cli.prepare_deltak(s_, params1, Log(echo=False))
            s_.setup_lpt(dk, params1.time_step[0])
            del dk
            s_.evolve(cfg1.time_step)
            return s_
        return fn

    nforce = len(cfg1.time_step)
    solver, got = run("O1 order-preserving", ordered(dict(device=dev)))
    check_paths("O1", solver, "multi")
    check_launches("phase O1", got, dict(
        {k: 0 for k in KERNELS}, cic_readout=6, cic_paint_into=nforce,
        cell_order=nforce, cic_readout3=nforce))
    in_place("O1", solver.species[CDM])
    o1 = by_id(solver.species[CDM])
    close_by_id("phase O1 against phase 7's order-free run by id", o1,
                by_id(main_store), box / nc, box)
    o1_ms = step_ms("O1 order-preserving (cell order, K3, FFTs, K4)", solver)
    pm = solver.find_pm(1.0)
    carry = main_store.wrap(pm.BoxSize)
    carry_ms = time_ms(lambda: gravity.compute_force_carry(
        pm, Painter(pm, "cic"), carry), reps=5)
    print("phase O1: the order-preserving step %.2f ms against the carry "
          "step %.2f ms on phase 7's z = 0 state in the same call: %+.2f ms"
          % (o1_ms, carry_ms, o1_ms - carry_ms))
    in_place("O1 after the timed steps", solver.species[CDM])
    profile_force(lambda: solver.force(pm, 1.0),
                  label="phase O1 force profile")
    del solver, carry

    # ---- O2: three species, one card ----
    species_agreement(dev, tmp)
    conf, _ = ncdm_lua(tmp, "o2_full", nc=nc, box=box)
    params2 = load_params(conf)
    cfg2 = species_config(params2)
    nforce2 = len(cfg2.time_step)
    solver, got = run("O2 three species", lambda: species_solver(
        params2, cfg2, dict(device=dev)))
    check_paths("O2", solver, "multi")
    names = list(solver.iter_species())
    stores = [solver.species[n] for n in names]
    npot = sum(p.potential is not None for p in stores)
    ntid = sum(p.tidal is not None for p in stores)
    counts = {n: solver.global_count(n) for n in names}
    print("phase O2: species %s, potential at %d, tidal tensor at %d"
          % (counts, npot, ntid))
    # per force: a cell order and K3 a species; K4 for acc of each,
    # the potential (one field) and the tidal tensor (two launches of
    # three) of each species with the column; K2: 6 LPT readouts of
    # CDM and of the baryons, 9 of ncdm (dv1)
    check_launches("phase O2", got, dict(
        {k: 0 for k in KERNELS}, cic_readout=6 + 6 + 9,
        cic_paint_into=3 * nforce2, cell_order=3 * nforce2,
        cic_readout3=nforce2 * (3 + npot + 2 * ntid)))
    if names != [BARYON, CDM, NCDM] or counts[BARYON] != nc ** 3:
        raise SystemExit("phase O2: bad species %s" % counts)
    bad = [(n, c) for n, p in zip(names, stores) for c, t in p.columns()
           if t.is_floating_point() and not bool(torch.isfinite(t).all())]
    ids_ok = all(torch.equal(torch.sort(p.id).values,
                             torch.sort(p.id).values.unique())
                 for p in stores)
    mass = {n: (float(p.mass.double().sum()) if p.mass is not None
                else p.M0 * p.np_local) for n, p in zip(names, stores)}
    want = {CDM: solver.species[CDM].M0 * nc ** 3,
            BARYON: float(np.float32(BARYON_SHARE
                                     * solver.species[CDM].M0)) * nc ** 3,
            NCDM: solver.cosmology.Omega_ncdm * RHO_CRIT * box ** 3}
    rel = {n: abs(mass[n] / want[n] - 1) for n in names}
    print("phase O2: every column finite %s, ids distinct %s; mass sums %s, "
          "rel err %s (bound 1e-5)" % (not bad, ids_ok, mass, rel))
    if bad or not ids_ok or max(rel.values()) > 1e-5:
        raise SystemExit("phase O2: non-finite columns %s or bad ids or "
                         "masses" % bad)
    o2 = species_cols(solver)
    o2_ms = step_ms("O2 three species (3 orders, 3 K3, FFTs, 9 K4)", solver)
    pm = solver.find_pm(1.0)
    profile_force(lambda: solver.force(pm, 1.0),
                  label="phase O2 force profile")
    check_species_kernels(pm, [p.wrap(pm.BoxSize) for p in
                               (solver.species[n] for n in names)], rows)
    del solver, stores

    # ---- O3: O1 and O2 on a one-rank NCCL group ----
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method="tcp://localhost:%d" % port,
                            rank=0, world_size=1)
    o3_ms = {}
    try:
        group = dist.group.WORLD
        for kind, grid in (("slab", None), ("pencil", Grid(group, 1, 1))):
            where = dict(device=dev, group=group, grid=grid)
            multi = ("pencil-" if kind == "pencil" else "homed-") + "multi"
            label = "O3 %s O1" % kind
            solver, got = run(label, ordered(where))
            n = check_paths(label, solver, multi)
            check_launches("phase " + label, got, homed_want(
                kind, n, n, cic_readout=6))
            in_place(label, solver.species[CDM])
            close_by_id("phase %s against O1 by id" % label,
                        by_id(solver.species[CDM]), o1, box / nc, box)
            o3_ms[label] = step_ms(label, solver)
            del solver

            label = "O3 %s O2" % kind
            solver, got = run(label, lambda: species_solver(params2, cfg2,
                                                            where))
            lpt = dict(cic_readout=6 + 6 + 9)
            if kind == "slab":
                n = check_paths(label, solver, multi)
                # homed K1 a species; homed K2 reads acc, the potential
                # and two tidal groups at every species
                want = homed_want(kind, 3 * n, 12 * n, **lpt)
            else:
                # the ncdm rows are not pencil-blocked, so the grid takes
                # v1 (fastpm_tpu/solver.py:428-450), as a grid of more
                # ranks does: K3 a species, K4 for acc, the potential and
                # two tidal groups at every species on the gathered mesh
                n = check_paths(label, solver, "v1")
                want = dict({k: 0 for k in KERNELS}, cic_paint_into=3 * n,
                            cell_order=3 * n, cic_readout3=12 * n, **lpt)
            check_launches("phase " + label, got, want)
            cols = species_cols(solver)
            for name in names:
                a, b = o2[name], cols[name]
                close_by_id("phase %s %s against O2 by id" % (label, name),
                            (b["id"], b["x"], b["v"]),
                            (a["id"], a["x"], a["v"]), box / nc, box)
                for c in ("potential", "tidal"):
                    if c not in a:
                        continue
                    # two card runs read up to 3.1e-3 of the tidal
                    # tensor's rms apart (PERF.md section 6)
                    err = float(np.abs(b[c] - a[c]).max() / a[c].std())
                    print("phase %s %s: max |d %s| %.3g of its rms against "
                          "O2 (bound 1e-2)" % (label, name, c, err))
                    if not err <= 1e-2:
                        raise SystemExit("phase %s %s: the %s disagrees "
                                         "with O2" % (label, name, c))
            o3_ms[label] = step_ms(label, solver)
            del solver, cols
    finally:
        dist.destroy_process_group()
    print("phase O: force steps (ms) O1 %.2f (carry %.2f), O2 %.2f, %s; "
          "phase O wall %.1f s" % (o1_ms, carry_ms, o2_ms, {
              k: round(v, 2) for k, v in o3_ms.items()},
              time.perf_counter() - t_phase))
    return out_launches

# ---- phase P: the JAX package's scale on one card ----

# the kernels phase P launches, whose counts go to the JSON line
P_KERNELS = ("cic_paint", "cic_readout", "fof_link")
# P1's gate: the device memory of the v5e that held the 384^3 B2 rung
# (BENCH_NOTES.md:487-503), 16 GiB
P1_GATE_BYTES = 16 * 2 ** 30


def live_at_peak(fn):
    """Run fn with the allocator's history recorded and return (fn's
    result, the peak of the bytes fn allocated, the allocations live at
    that peak as (bytes, the innermost frame of fastpm_torch or of this
    script that made them), largest first). The peak is counted above
    what was allocated before fn; the live set is read from the trace of
    allocations and frees (torch.cuda.memory._snapshot). Without the
    recording API the live set is None."""
    import torch
    mem = torch.cuda.memory
    if not (hasattr(mem, "_record_memory_history")
            and hasattr(mem, "_snapshot")):
        return fn(), None, None
    mem._record_memory_history(enabled="all", context="all",
                               stacks="python", max_entries=1 << 20)
    try:
        out = fn()
        torch.cuda.synchronize()
        snap = mem._snapshot()
    finally:
        mem._record_memory_history(enabled=None)
    trace = snap["device_traces"][torch.cuda.current_device()]
    live, cur, best, at = {}, 0, 0, {}
    for e in trace:
        if e["action"] == "alloc":
            live[e["addr"]] = e
            cur += e["size"]
            if cur > best:
                best, at = cur, dict(live)
        elif e["action"] in ("free_requested", "free") and e["addr"] in live:
            cur -= live.pop(e["addr"])["size"]

    def where(e):
        for f in e.get("frames", []):
            name = f.get("filename", "")
            if "fastpm_torch" in name or name.endswith("chip_smoke.py"):
                return "%s:%d %s" % (os.path.relpath(name, ROOT),
                                     f.get("line", 0), f.get("name", ""))
        return "torch internal"
    return out, best, sorted(((e["size"], where(e)) for e in at.values()),
                             reverse=True)


def print_buffers(label, peak, bufs, top=10):
    """The allocations live at a path's peak, as live_at_peak reads them."""
    if bufs is None:
        print("%s: buffers at the peak not measured (no memory history)"
              % label)
        return
    print("%s: %.3f GB allocated by the path at its peak, %d buffers; the "
          "largest:" % (label, peak / 1e9, len(bufs)))
    for size, where in bufs[:top]:
        print("  %.3f GB  %s" % (size / 1e9, where))


def c2r_extra(dev, n):
    """The bytes torch.fft.irfftn and the port's c2r (ops/fft.py)
    allocate beyond their output on an n^3 mesh, in units of their
    complex input: cuFFT's c2r overwrites its input, so PyTorch copies
    it (and takes a work area); the port's plan is given its input and
    takes its work area alone."""
    import torch
    from fastpm_torch.ops import fft
    out = []
    for c2r in (lambda k: torch.fft.irfftn(k, s=(n,) * 3),
                lambda k: fft.c2r(k, (n,) * 3)):
        k = torch.zeros((n, n, n // 2 + 1), dtype=torch.complex64,
                        device=dev)
        base = reset_peak()
        y = c2r(k)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base - y.numel() * 4
        del k, y
        out.append(extra / (n * n * (n // 2 + 1) * 8))
    return out


def ladder_step(dev, nc, label, nstep=10):
    """The benchlib step of bench.py:run_one (make_step_fn(PM(2 nc, nc)),
    carry, K1 and K2, x and v donated) on example_particles(nc, nc,
    seed=0): one warm step, then nstep chained steps between
    synchronises; one more step under the allocator's history. Returns
    {"peak": the rung's peak bytes, "launches": its launches of
    P_KERNELS before the recorded step}."""
    import torch
    from fastpm_torch import benchlib
    from fastpm_torch.mesh import PM

    torch.cuda.empty_cache()
    base = reset_peak()
    reset_launches()
    t0 = time.perf_counter()
    x, v = benchlib.example_particles(nc, float(nc), seed=0, device=dev)
    setup_s = time.perf_counter() - t0
    pm = PM(2 * nc, float(nc), device=dev)
    step = benchlib.make_step_fn(pm, donate=True, device=dev)
    coeffs = (0.05, 0.02)
    t0 = time.perf_counter()
    x, v, acc = step(x, v, coeffs)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    del acc
    t0 = time.perf_counter()
    for _ in range(nstep):
        x, v, acc = step(x, v, coeffs)
        del acc
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / nstep
    peak = torch.cuda.max_memory_allocated()
    # the wrap x - floor(x / L) * L (the JAX step's) rounds a position a
    # hair below 0 up to L itself, so the box is [0, L]
    ok = bool(torch.isfinite(x).all() and torch.isfinite(v).all()
              and (x >= 0).all() and (x <= nc).all())
    launches = read_launches()
    # the warm step and the chained ones, each one K1 and one K2
    want = dict({k: 0 for k in KERNELS}, cic_paint=nstep + 1,
                cic_readout=nstep + 1)
    (x, v, acc), step_peak, bufs = live_at_peak(lambda: step(x, v, coeffs))
    del x, v, acc
    r = dict(peak=peak, launches={k: launches[k] for k in P_KERNELS})
    print("phase %s: %d^3 particles on a %d^3 mesh (benchlib step, carry, "
          "K1 and K2, x and v donated): %.2f ms a step (%d chained; the "
          "warm step %.2f s, the particles %.1f s on the host) = %.4g "
          "particle-steps/s; max_memory_allocated %.3f GB (%.3f GB "
          "allocated before); launches %s; x, v finite and x in [0, L] %s"
          % (label, nc, 2 * nc, ms, nstep, warm_s, setup_s,
             nc ** 3 / ms * 1e3, peak / 1e9, base / 1e9, r["launches"], ok))
    print_buffers("phase %s step" % label, step_peak, bufs)
    if not ok:
        raise SystemExit("phase %s: the step's x or v is bad" % label)
    if launches != want:
        raise SystemExit("phase %s did not run through K1 / K2 alone "
                         "(want %d of each)" % (label, nstep + 1))
    return r


def read_pk(out):
    """{a: (k, P) of the P(k) file} of the first and the last force of a
    run's output directory."""
    import numpy as np
    files = sorted(f for f in os.listdir(out) if f.startswith("powerspec_"))
    pk = {}
    for f in (files[0], files[-1]):
        a = float(f[len("powerspec_"):-len(".txt")])
        pk[a] = np.loadtxt(os.path.join(out, f), comments="#")[:, :2]
    return pk


def ladder_run(dev, tmp, pk7, nc=512, box=768.0, nstep=5, ll_frac=0.2,
               chunk=1 << 25):
    """P2: 512^3 on a 1024^3 mesh through cli.run_fastpm, phase 7's Lua
    text (box 768, seed 100) with one snapshot at a = 1. Returns the
    launches of the run and of its FOF."""
    import numpy as np
    import torch
    from fastpm_torch import cli, fof, gravity
    from fastpm_torch.config.params import load_params
    from fastpm_torch.diagnostics import Log
    from fastpm_torch.painter import Painter
    from fastpm_torch.ops import cic, fft, kspace, fof_device as fd

    out = os.path.join(tmp, "ladder")
    text = main_text(nc, box, nstep, out).replace("aout = {0.55, 1.0}",
                                                  "aout = {1.0}")
    conf = write_lua(os.path.join(tmp, "ladder.lua"), text)
    torch.cuda.empty_cache()
    base = reset_peak()
    reset_launches()
    t0 = time.perf_counter()
    log = Log(echo=False)
    ffts = dict(fft.stats)
    solver, run_peak, bufs = live_at_peak(
        lambda: cli.run_fastpm(load_params(conf), log=log, device=dev))
    wall = time.perf_counter() - t0
    launches = read_launches()
    ffts = {k: fft.stats[k] - n for k, n in ffts.items()}
    peak = torch.cuda.max_memory_allocated()
    print("phase P2: %d^3 particles, %d^3 force mesh, %d force steps "
          "through cli.run_fastpm (IC, 2LPT, steps, P(k), a snapshot at "
          "a = 1): wall %.2f s (the allocator's history on); "
          "max_memory_allocated %.3f GB (%.3f GB allocated before)"
          % (nc, 2 * nc, nstep, wall, peak / 1e9, base / 1e9))
    print_buffers("phase P2 run", run_peak, bufs)
    print("phase P2: force paths %s; kicks and drifts in place %s"
          % (dict(solver.force_paths), dict(solver.in_place)))
    if not (solver.in_place["kick"] and solver.in_place["drift"]):
        raise SystemExit("phase P2: no kick or no drift ran in place")
    want = dict({k: 0 for k in KERNELS}, cic_paint=nstep,
                cic_readout=nstep + 6)
    print("phase P2: launches K1 %d (want %d), K2 %d (want %d), the rest %s"
          % (launches["cic_paint"], nstep, launches["cic_readout"],
             nstep + 6, {k: n for k, n in launches.items()
                         if k not in ("cic_paint", "cic_readout")}))
    if launches != want:
        raise SystemExit("phase P2 did not run through K1 / K2 alone")
    # one k-space kernel launch a gradient, three a force
    check_launches("phase P2 k-space",
                   {"force_grad_k": kspace.force_grad_k.launches},
                   {"force_grad_k": 3 * nstep})
    # every transform of the run through a plan (the force's 1024^3
    # plans made here, one a direction; the 2LPT's 512^3 by phase 7)
    print("phase P2: the FFTs of the run: %s (fft.stats over the run)"
          % ffts)
    if ffts["copies"]:
        raise SystemExit("phase P2: a transform's input was copied into "
                         "(x, y, z) order")

    # the snapshot, by id, then deleted
    t0 = time.perf_counter()
    snap = os.path.join(out, "fastpm_1.0000")
    ids, x, v = read_by_id(snap)
    # the snapshot's wrap may round a position a hair below 0 up to box
    ok = (np.array_equal(ids, np.arange(nc ** 3)) and np.isfinite(x).all()
          and np.isfinite(v).all() and x.min() >= 0 and x.max() <= box)
    del ids, x, v
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(snap) for f in fs)
    subprocess.run(["rm", "-rf", snap], check=True)
    print("phase P2: snapshot %.2f GB read back by id in %.1f s: ids "
          "arange(%d^3), x and v finite, x in [0, %g]: %s; deleted"
          % (size / 1e9, time.perf_counter() - t0, nc, box, ok))
    if not ok:
        raise SystemExit("phase P2: bad snapshot")

    # P(k) at k < 0.1 against phase 7's: the same linear modes
    pk = read_pk(out)
    worst = 0.0
    for a, want_pk in pk7.items():
        got = pk[a]
        # the bins in file order, the empty k = 0 bin left out
        m = np.flatnonzero((want_pk[:, 0] > 0) & (want_pk[:, 0] < 0.1))
        nb = len(m)
        same_k = np.allclose(got[m, 0], want_pk[m, 0], rtol=1e-4)
        rel = np.abs(got[m, 1] / want_pk[m, 1] - 1)
        worst = max(worst, float(rel.max()))
        print("phase P2: P(k) at a = %g, %d bins of k < 0.1 h/Mpc against "
              "phase 7's (256^3 on 512^3): the same k %s, |P / P7 - 1| max "
              "%.4f (bins: %s)" % (a, nb, same_k, rel.max(),
                                   " ".join("%.4f" % r for r in rel)))
        if not (same_k and rel.max() <= 0.02):
            raise SystemExit("phase P2: P(k) at k < 0.1 departs from phase "
                             "7's by more than 2 %")

    # the force step alone on the z = 0 state, and K1 / K2 against plain
    pm = solver.find_pm(1.0)
    mesh, inv = tuple(pm.Nmesh), pm.InvCellSize
    painter = Painter(pm, "cic")
    store = solver.species["cdm"]
    del solver
    force_ms = time_ms(lambda: gravity.compute_force_carry(
        pm, painter, store.wrap(pm.BoxSize)), reps=3)
    print("phase P2: force step %.2f ms (sort + K1 + FFTs + K2, the store "
          "not donated) = %.4g particle-steps/s"
          % (force_ms, nc ** 3 / force_ms * 1e3))
    # the Solver's force: its wrapped store given up
    out, force_peak, bufs = live_at_peak(lambda: gravity.compute_force_carry(
        pm, painter, store.wrap(pm.BoxSize), donate=True))
    del out
    print_buffers("phase P2 force step (donated, as the Solver's)",
                  force_peak, bufs)
    t0 = time.perf_counter()
    store = store.wrap(pm.BoxSize)
    x = store.x[cic.sort_by_cell(store.x, mesh, inv)].contiguous()
    got = cic.cic_paint(x, mesh, inv)
    want = torch.zeros_like(got)
    for i in range(0, x.shape[0], chunk):
        want += cic.cic_paint_plain(x[i:i + chunk], mesh, inv)
    err1 = check_close("phase P2 K1 at the z = 0 state (%d rows, plain in "
                       "chunks of %d)" % (x.shape[0], chunk), got, want)
    del got, want
    g = torch.Generator(device=dev).manual_seed(11)
    fields = [torch.randn(mesh, generator=g, device=dev) for _ in range(3)]
    err2 = 0.0
    for i in range(0, x.shape[0], chunk):
        xc = x[i:i + chunk]
        err2 = max(err2, check_close(
            "phase P2 K2 (3 fields) rows %d-%d" % (i, i + xc.shape[0]),
            cic.cic_readout(fields, xc, inv),
            cic.cic_readout_plain(fields, xc, inv)))
    del fields
    print("phase P2: K1 and K2 against their plain versions in %.1f s"
          % (time.perf_counter() - t0))
    canvas = cic.cic_paint(x, mesh, inv, 1.0 / x.shape[0])
    dk = fft.r2c(canvas)
    check_kspace(pm, dk)
    check_fft(pm, canvas, dk)
    del canvas
    check_k2_fields(pm, dk, x)
    del x, dk

    # FOF on the z = 0 state (phase E's b = 0.2 of the mean separation);
    # the labels of the x < box / 16 slab against the host union-find
    ll = ll_frac * box / nc
    reset_launches()
    t0 = time.perf_counter()
    cat, _ = fof.find_halos(store, ll, box, nmin=20, backend="device")
    torch.cuda.synchronize()
    fof_s = time.perf_counter() - t0
    xs = store.x[store.x[:, 0] < box / 16].contiguous()
    del store
    t0 = time.perf_counter()
    lab_d = fd.fof_labels_device(xs, ll, box).cpu().numpy()
    dev_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lab_h = fof.fof_labels(xs.cpu().numpy(), ll, box)
    host_s = time.perf_counter() - t0
    same = bool(np.array_equal(lab_d, lab_h))
    fof_launches = read_launches()
    print("phase P2: find_halos (device) on %d rows, ll %.3f Mpc/h (b = "
          "%g): %d halos of 20 or more in %.2f s; the x < %g slab, %d rows: "
          "device labels %.2f s, host union-find %.2f s, bit-equal %s; "
          "fof_link launches %d"
          % (nc ** 3, ll, ll_frac, cat.nhalo, fof_s, box / 16, xs.shape[0],
             dev_s, host_s, same, fof_launches["fof_link"]))
    if not same or not cat.nhalo:
        raise SystemExit("phase P2: the device FOF labels of the slab "
                         "differ from the host union-find's")
    del xs, lab_d, lab_h, cat
    counts = {k: launches[k] for k in P_KERNELS}
    counts["fof_link"] = fof_launches["fof_link"]
    return counts


def check_kspace(pm, dk):
    """The k-space kernel against its plain version at pm's mesh, bit
    for bit, for kernel 1_4 (both cells' and the CLI's default) and
    eastwood (deconvolveorder 2) along each axis; the kernel's ms beside
    its bound (delta_k read and the gradient written once) and the
    unfused chain's (the potential once, then each gradient, as the
    force ran before). Prints and returns the row."""
    import torch
    from fastpm_torch import kernels, transfers
    from fastpm_torch.ops import kspace
    for kernel_type in ("1_4", "eastwood"):
        for d in range(3):
            got = kspace.force_grad_k(pm, dk, d, kernel_type)
            same = torch.equal(got, kspace.force_grad_k_plain(
                pm, dk, d, kernel_type))
            del got
            if not same:
                raise SystemExit("phase P2: the k-space kernel (%s, axis "
                                 "%d) differs from its plain version"
                                 % (kernel_type, d))

    def chain():
        pot = kernels.apply_kernel_transfer(pm, dk, "1_4", "potential")
        for d in range(3):
            transfers.apply_grad(pm, pot, d, 1,
                                 out=pot if d == 2 else None)

    bound = bound_ms(2 * dk.numel() * dk.element_size(), 0)
    row = dict(shape=list(dk.shape), strides=list(dk.stride()),
               equal=True, bound_ms=bound[0], bound_by=bound[1],
               ms=[time_ms(lambda: kspace.force_grad_k(pm, dk, d, "1_4"))
                   for d in range(3)],
               ms_eastwood=time_ms(
                   lambda: kspace.force_grad_k(pm, dk, 0, "eastwood")),
               chain_ms_3=time_ms(chain, reps=3),
               plain_ms=time_ms(lambda: kspace.force_grad_k_plain(
                   pm, dk, 0, "1_4"), reps=3))
    print("phase P2: the k-space kernel at %s: bit-equal to its plain "
          "version (1_4, eastwood, every axis); %s ms a launch against a "
          "bound of %.3f ms (%s); the unfused chain %.2f ms for three "
          "gradients" % (tuple(dk.shape), " ".join("%.3f" % t
                                                  for t in row["ms"]),
                         bound[0], bound[1], row["chain_ms_3"]))
    print("kspace_grad " + json.dumps(row))
    return row


def check_fft(pm, canvas, dk):
    """The force's four transforms at pm's mesh, each alone: the r2c of
    the canvas and the c2r of each gradient of dk (its input refilled
    before each run, the refill's time taken off), against the bound of
    one read and one write and the three-pass ideal; the plans' work
    areas and fft.stats. Prints and returns the row."""
    import torch
    from fastpm_torch.ops import fft, kspace
    shape = tuple(pm.Nmesh)
    buf = torch.empty_like(dk)

    def c2r_ms(g):
        fill = (lambda: buf.copy_(g))
        return (time_ms(lambda: (fill(), fft.c2r(buf, shape)))
                - time_ms(fill))

    c2r = []
    for d in range(3):
        g = kspace.force_grad_k(pm, dk, d, "1_4")
        c2r.append(c2r_ms(g))
        del g
    nbytes = canvas.numel() * 4 + dk.numel() * 8
    bound = bound_ms(nbytes, 0)
    row = dict(shape=list(shape), r2c_ms=time_ms(lambda: fft.r2c(canvas)),
               c2r_ms=c2r, bound_ms=bound[0], ideal_3pass_ms=3 * bound[0],
               work_gb=[fft.work_bytes(shape, s, pm.device) / 1e9
                        for s in ("r2c", "c2r")], stats=dict(fft.stats))
    print("phase P2: the force's transforms at %s, each alone: r2c %.3f "
          "ms, c2r %s ms, against %.3f ms (one read and one write) and "
          "%.3f ms (three passes); work areas %s GB; %s"
          % (shape, row["r2c_ms"], " ".join("%.3f" % t for t in c2r),
             bound[0], 3 * bound[0], row["work_gb"], row["stats"]))
    print("fft_plans " + json.dumps(row))
    return row


def check_k2_fields(pm, dk, x, reps=4):
    """K2 on the z = 0 state's rows in cell order, reading the force's
    three fields as the port's C2R plan makes them and as torch.fft's
    irfftn made them before (its copy and 1/N pass included): each set
    read alone, repeated, and each read right after the three
    transforms that make it, as in the force, its own launch timed by
    events around it. Prints and returns the row (ms a launch)."""
    import torch
    from fastpm_torch.ops import cic, fft, kspace
    shape, inv = tuple(pm.Nmesh), pm.InvCellSize
    make = {"plan": lambda g: fft.c2r(g, shape),
            "irfftn": lambda g: torch.fft.irfftn(g, s=shape)}

    def fields(side):
        return [make[side](kspace.force_grad_k(pm, dk, d, "1_4"))
                for d in range(3)]

    def after(side):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        total = 0.0
        for _ in range(reps):
            f = fields(side)
            start.record()
            cic.cic_readout(f, x, inv)
            end.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(end)
            del f
        return total / reps

    row = {"alone": {}, "after": {}}
    for side in ("plan", "irfftn", "irfftn", "plan"):
        f = fields(side)
        row["alone"].setdefault(side, []).append(
            time_ms(lambda: cic.cic_readout(f, x, inv), reps=reps))
        del f
        row["after"].setdefault(side, []).append(after(side))
    print("phase P2: K2 on %d rows at %s, fields from the C2R plan / "
          "irfftn: alone %s / %s ms, right after their transforms %s / %s "
          "ms" % (x.shape[0], shape,
                  " ".join("%.3f" % t for t in row["alone"]["plan"]),
                  " ".join("%.3f" % t for t in row["alone"]["irfftn"]),
                  " ".join("%.3f" % t for t in row["after"]["plan"]),
                  " ".join("%.3f" % t for t in row["after"]["irfftn"])))
    print("k2_fields " + json.dumps(row))
    return row


def ladder_tool(dev, nc=384):
    """P3: fastpm_torch.measure_halo at 384^3 on the card, through the
    production Solver; its JSON line."""
    import torch
    from fastpm_torch import measure_halo

    torch.cuda.empty_cache()
    base = reset_peak()
    reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc, run_peak, bufs = live_at_peak(
            lambda: measure_halo.main([str(nc)], device=dev))
    wall = time.perf_counter() - t0
    line = buf.getvalue().strip().splitlines()[-1]
    got = json.loads(line)
    peak = torch.cuda.max_memory_allocated()
    launches = read_launches()
    print("phase P3: measure_halo %d^3 (B2, %d^3 mesh, 10 steps) in %.1f "
          "s (the allocator's history on), max_memory_allocated %.3f GB "
          "(%.3f before), launches %s"
          % (nc, 2 * nc, wall, peak / 1e9, base / 1e9,
             {k: launches[k] for k in P_KERNELS}))
    print_buffers("phase P3 run", run_peak, bufs)
    print("phase P3: " + line)
    if rc != 0 or got["nc"] != nc or set(got["H_measured"]) != {
            "P8", "P16", "P32"}:
        raise SystemExit("phase P3: bad measure_halo output")
    # a carry force a step, and K2 for the 2LPT's six readouts
    want = dict({k: 0 for k in KERNELS}, cic_paint=got["steps"],
                cic_readout=got["steps"] + 6)
    if launches != want:
        raise SystemExit("phase P3 did not run through K1 / K2 alone: "
                         "want %s" % {k: want[k] for k in P_KERNELS})
    return {k: launches[k] for k in P_KERNELS}


def cuda_tensors_alive(top=6):
    """The largest CUDA tensors still reachable from Python: (bytes,
    shape, dtype) of each storage's largest tensor, largest first."""
    import torch
    gc.collect()
    best = {}
    for o in gc.get_objects():
        if issubclass(type(o), torch.Tensor) and o.is_cuda:
            key = o.untyped_storage().data_ptr()
            n = o.untyped_storage().nbytes()
            if n > best.get(key, (0,))[0]:
                best[key] = (n, tuple(o.shape), str(o.dtype))
    return sorted(best.values(), reverse=True)[:top]


def scale_ladder(dev, pk7):
    """Phase P: P1 the JAX package's executed 384^3 B2 rung (gate: peak
    at most 16 GiB), P2 512^3 B2 through the production path, P3 the
    halo tool at 384^3, P4 the 640^3 B2 step (recorded: whether it fits).
    Returns {rung: its launches of P_KERNELS}."""
    import torch
    t_p = time.perf_counter()
    print("phase P: %.3f GB allocated by earlier phases; the largest CUDA "
          "tensors reachable: %s" % (reset_peak() / 1e9, [
              "%.3f GB %s %s" % (n / 1e9, shape, dtype)
              for n, shape, dtype in cuda_tensors_alive()]))
    print("phase P: on a 768^3 mesh torch.fft.irfftn allocates %.3f of its "
          "complex input beyond its output (a copy of its input, which "
          "cuFFT's c2r overwrites, and a work area), the port's c2r %.3f "
          "(its work area)" % tuple(c2r_extra(dev, 768)))
    launches = {}
    r = ladder_step(dev, 384, "P1")
    launches["P1"] = r["launches"]
    print("phase P1: peak %.3f GB against the gate %.3f GB (16 GiB, the "
          "v5e's HBM): %s" % (r["peak"] / 1e9, P1_GATE_BYTES / 1e9,
                              "held" if r["peak"] <= P1_GATE_BYTES
                              else "FAIL"))
    if r["peak"] > P1_GATE_BYTES:
        raise SystemExit("phase P1: the 384^3 B2 step's peak is above 16 GiB")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        launches["P2"] = ladder_run(dev, tmp, pk7)
    print("phase P2: %.1f s in all" % (time.perf_counter() - t0))
    launches["P3"] = ladder_tool(dev)
    try:
        launches["P4"] = ladder_step(dev, 640, "P4", nstep=3)["launches"]
        fits = True
    except torch.cuda.OutOfMemoryError as e:
        launches["P4"] = {k: 0 for k in P_KERNELS}
        fits = False
        print("phase P4: 640^3 on a 1280^3 mesh does not fit: %s; "
              "max_memory_allocated %.3f GB" % (
                  str(e).splitlines()[0],
                  torch.cuda.max_memory_allocated() / 1e9))
    gc.collect()
    torch.cuda.empty_cache()
    print("phase P4: 640^3 B2 fits on the card: %s" % fits)
    print("phase P: %.1f s" % (time.perf_counter() - t_p))
    return launches


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
    check_order_edges(dev)
    rows.update(check_kernels_homed(dev))
    check_readout_edges(dev, rows)
    check_paint4_edges(dev, rows)
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
        launches, solver, pm, more, main_out = main_path(dev, tmp)
        # phase P holds its 512^3 run's P(k) against these
        pk7 = read_pk(main_out)
        halo_rows, lab_host = halos(dev, solver.species["cdm"], 768.0, 256)
        rows.update(halo_rows)
        # phase N: the sharded FOF and step on the same state
        n_rows = pfof_path(dev, tmp, solver.species["cdm"], pm, lab_host)
        del lab_host
        ncdm_launches, more_ncdm = ncdm_path(dev, tmp)
        lightcone_goldens(dev, tmp)
        lc_launches, lc_ref = lightcone_path(dev, tmp)
        _modes_launches, pgd_ref = modes_path(dev, tmp)
        _lra_launches, lra_ref = lra_path(dev, tmp)
        goldens_and_ics(dev)
        lpt_witness(dev)
        phase_k = cli_files_tools(dev, tmp, solver, pm)
        # phase M: the options of the ranks on a one-rank group
        m_launches = ranks_path(dev, tmp, main_out, solver.species["cdm"],
                                lra_ref, pgd_ref, lc_ref)
        # phase O: baryons and order-preserving stepping
        o_launches = order_path(dev, tmp, solver.species["cdm"], rows)
    homed_launches = homed_force(dev, solver.species["cdm"], pm)
    # phase L: the pencil's kernels, then its force
    pencil_rows = check_kernels_pencil(dev)
    pencil_launches = pencil_force(dev, solver.species["cdm"], pm)
    bench_launches = benchlib_path(dev, x0, v0, bpm)
    del x0, v0
    more_stale = stale_force(solver, pm)
    del solver, pm, bpm
    # phase P: the scale ladder, on a card that holds nothing else
    p_launches = scale_ladder(dev, pk7)
    for extra in (more, more_ncdm, more_stale):
        for name, r in extra.items():
            err = max(rows[name]["err"], r.pop("err", 0.0))
            rows[name].update(r, err=err)
    for name in ("cic_paint_into", "cic_readout3", "cell_order"):
        launches[name] = ncdm_launches[name]
    for name in HOMED:
        launches[name] = homed_launches[name]
        # phase L: the open-y mode's row and its launches in the pencil
        # force's runs
        r = pencil_rows[name]
        rows[name]["launches_phase_l"] = pencil_launches[name]
        rows[name]["open_y"] = {
            "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r.get("library_ms")}
    launches["merge_pairs"] = bench_launches["sb32768"]["merge_pairs"]
    launches["fof_link"] = lc_launches["fof_link"]
    rows["cic_paint4"]["launches_periodic"] = (
        bench_launches["paint4"]["cic_paint4"])
    # phase M: the launches of each run
    for name in HOMED + ("fof_link", "cic_readout"):
        rows[name]["launches_phase_m"] = {
            run: n[name] for run, n in m_launches.items()}
        if name in HOMED:
            rows[name]["launches_open_y_phase_m"] = {
                run: n[name + "_open_y"] for run, n in m_launches.items()}
    # phase O: the launches of each run
    for name in O_KERNELS:
        rows[name]["launches_phase_o"] = {
            run: n[name] for run, n in o_launches.items()}
        if name in HOMED:
            rows[name]["launches_open_y_phase_o"] = {
                run: n[name + "_open_y"] for run, n in o_launches.items()}
    # phase K: the launches of write_nonlineark (run 1) and of each tool
    for name in K_KERNELS:
        rows[name]["launches_phase_k"] = {
            part: n[name] for part, n in phase_k["launches"].items()}
    print("phase K: " + json.dumps({k: v for k, v in phase_k.items()
                                    if k != "launches"}))
    # phase N: the sharded FOF's and the sharded step's entries
    for name, entries in n_rows.items():
        rows[name].update(entries)
    # phase P: the launches of each rung
    for name in P_KERNELS:
        rows[name]["launches_phase_p"] = {
            rung: n[name] for rung, n in p_launches.items()}

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
