"""Snapshot and halo catalog writers (reference: libfastpmio/io.c:229-640,
src/fastpm.c:take_a_snapshot).

Port of fastpm_tpu/io/snapshots.py: the same files on disk. Store
columns may be tensors on any device; they are copied to host numpy
before writing.

Layout (bigfile, MP-Gadget-compatible):
- Header block: cosmology/growth attrs incl. RSDFactor = 1/(H0 a E(a)),
  MassTable, TotNumPart, unit system (io.c:288-320); ParamFile attr holds
  the full parameter file text for provenance (src/fastpm.c:97-116).
- per-species datasets named "0" (baryon) "1" (cdm) "2" (ncdm) with
  columns Position f4, Velocity f4 (peculiar km/s), ID i8, and Mass f4
  for a species with a per-particle mass (ncdm) (io.c:389-420).
- per-dataset attrs persist the store metadata (q.strides/scale/shift/
  size, a.x, a.v, M0) making restart exact (io.c:446-456).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .bigfile import BigFile
from ..store import Store
from ..cosmology import Cosmology
from ..units import HUBBLE_CONSTANT

__all__ = ["write_snapshot", "write_halo_catalog", "SPECIES_DATASET",
           "LIBFASTPM_VERSION"]

LIBFASTPM_VERSION = "fastpm-torch 0.1"

SPECIES_DATASET = {"baryon": "0", "cdm": "1", "ncdm": "2"}

# store column -> (block name, on-disk dtype)  (io.c:405-423)
COLUMN_BLOCKS = [
    ("x", "Position", "f4"),
    ("dx1", "DX1", "f4"),
    ("dx2", "DX2", "f4"),
    ("v", "Velocity", "f4"),
    ("id", "ID", "i8"),
    ("mass", "Mass", "f4"),
]


def _host(a) -> np.ndarray:
    """A column as a host numpy array (tensors are copied off their
    device)."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def write_snapshot_header(bf: BigFile, c: Cosmology, aout: float,
                          nc: int, boxsize: float,
                          species: Dict[str, Store]) -> float:
    """Returns the RSD factor (logged by the reference, golden value)."""
    hh = bf.create_block("Header")
    a = hh.attrs
    gi = c.growth_info(aout)
    E = c.E(aout)
    rsd = 1.0 / (HUBBLE_CONSTANT * aout * E)

    a.set("NC", np.int64(nc), "i8")
    a.set("BoxSize", float(boxsize), "f8")
    a.set("ScalingFactor", float(aout), "f8")
    a.set("GrowthFactor", float(gi.D1), "f8")
    a.set("GrowthRate", float(gi.f1), "f8")
    a.set("HubbleE", float(E), "f8")
    a.set("RSDFactor", float(rsd), "f8")
    a.set("Omega_cdm", float(c.Omega_cdm), "f8")
    a.set("OmegaM", float(c.Omega_m), "f8")
    a.set("OmegaLambda", float(c.Omega_Lambda), "f8")
    a.set("HubbleParam", float(c.h), "f8")
    a.set("LibFastPMVersion", LIBFASTPM_VERSION)

    mass_table = [0.0] * 6
    tot = [0] * 6
    for name, idx in (("baryon", 0), ("cdm", 1), ("ncdm", 2)):
        p = species.get(name)
        if p is not None:
            mass_table[idx] = p.M0
            tot[idx] = p.np_local
    a.set("Omega0", float(c.Omega_cdm), "f8")
    a.set("TotNumPart", np.asarray(tot, dtype=np.int64), "i8")
    a.set("MassTable", np.asarray(mass_table, dtype=np.float64), "f8")
    a.set("Time", float(aout), "f8")
    a.set("UsePeculiarVelocity", np.int32(1), "i4")
    a.set("UnitLength_in_cm", 3.085678e21 * 1e3, "f8")
    a.set("UnitMass_in_g", 1.989e43, "f8")
    a.set("UnitVelocity_in_cm_per_s", 1e5, "f8")
    return rsd


def _dataset_attrs(block, p: Store):
    """Persist store metadata for exact restart (io.c:446-456)."""
    n0, n1, n2 = p.q_nc
    block.attrs.set("q.strides",
                    np.asarray([n1 * n2, n2, 1], dtype=np.int64), "i8")
    block.attrs.set("q.scale", np.asarray(p.q_scale, dtype=np.float64), "f8")
    block.attrs.set("q.shift", np.asarray(p.q_shift, dtype=np.float64), "f8")
    block.attrs.set("q.size", np.int64(n0 * n1 * n2), "i8")
    block.attrs.set("a.x", float(p.a_x), "f8")
    block.attrs.set("a.v", float(p.a_v), "f8")
    block.attrs.set("M0", float(p.M0), "f8")


def write_species(bf: BigFile, dataset: str, p: Store,
                  sort_by_id: bool = True, n_writers: int = 0):
    """Write a species store as dataset columns (fastpm_store_write),
    sorted by ID. Each column's permute + serialize + write runs on a
    writer pool (the io.c Nwriters-throttled aggregated-IO analog,
    io.c:349-360); n_writers bounds the threads (0 = one per column up
    to 8)."""
    cols = [(name, dtype, _host(getattr(p, attr)))
            for attr, name, dtype in COLUMN_BLOCKS
            if getattr(p, attr, None) is not None]

    root = bf.create_block(dataset)
    _dataset_attrs(root, p)

    order = None
    if sort_by_id:
        for name, _dt, arr in cols:
            if name == "ID":
                order = np.argsort(arr, kind="stable")
                break

    if n_writers <= 0:
        n_writers = min(8, max(1, len(cols)))
    from concurrent.futures import ThreadPoolExecutor

    def write_one(name, dtype, arr):
        if order is not None:
            arr = arr[order]
        bf.create_block(f"{dataset}/{name}",
                        arr.astype(np.dtype(dtype)))

    with ThreadPoolExecutor(max_workers=n_writers) as ex:
        futs = [ex.submit(write_one, name, dtype, arr)
                for name, dtype, arr in cols]
        for f in futs:
            f.result()


def write_snapshot(path: str, c: Cosmology, species: Dict[str, Store],
                   nc: int, boxsize: float,
                   param_text: str = "", sort_by_id: bool = True,
                   n_writers: int = 0) -> float:
    """Full snapshot write. Species stores must already be in snapshot
    units (peculiar km/s velocity; see Solver.set_snapshot). Returns the
    RSD factor. n_writers: concurrent writer threads (CLI -W; 0=auto)."""
    bf = BigFile(path, create=True)
    cdm = species["cdm"]
    rsd = write_snapshot_header(bf, c, cdm.a_x, nc, boxsize, species)
    if param_text:
        bf.open_block("Header").attrs.set("ParamFile", param_text)
    for name, p in species.items():
        write_species(bf, SPECIES_DATASET[name], p, sort_by_id=sort_by_id,
                      n_writers=n_writers)
    return rsd


def write_halo_catalog(path: str, dataset: str, cat, c: Cosmology,
                       aout: float, nc: int, boxsize: float,
                       M0: float = 1.0):
    """Write a FOF/RFOF halo catalog dataset (run_fof, src/fastpm.c:1265;
    column map io.c:405-423: Length i4, Position f4, Velocity f4,
    MinID i8, Rdisp/Vdisp/RVdisp f4, InitialPosition f4).

    The reference writes catalogs sorted by DESCENDING Length
    (fastpm_sort_snapshot with FastPMSnapshotSortByLength radix
    ``-length``, io.c:90-108, invoked at src/fastpm.c:1495,1516 and by
    the offline fof/rfof tools). The mpsort radix leaves equal-Length
    ties rank-order-dependent; here ties break ascending by MinID for
    a deterministic on-disk order."""
    length = np.asarray(cat.length)
    order = np.lexsort((np.asarray(cat.minid), -length.astype(np.int64)))
    bf = BigFile(path, create=True)
    if not bf.has_block("Header"):
        write_snapshot_header(bf, c, aout, nc, boxsize, {})
    root = bf.create_block(dataset)
    root.attrs.set("M0", float(M0), "f8")
    root.attrs.set("a.x", float(aout), "f8")
    root.attrs.set("a.v", float(aout), "f8")
    bf.create_block(f"{dataset}/Length", length[order].astype(np.int32))
    bf.create_block(f"{dataset}/Position",
                    np.asarray(cat.x)[order].astype(np.float32))
    bf.create_block(f"{dataset}/Velocity",
                    np.asarray(cat.v)[order].astype(np.float32))
    bf.create_block(f"{dataset}/MinID",
                    np.asarray(cat.minid)[order].astype(np.int64))
    bf.create_block(f"{dataset}/Rdisp",
                    np.asarray(cat.rdisp)[order].astype(np.float32))
    bf.create_block(f"{dataset}/Vdisp",
                    np.asarray(cat.vdisp)[order].astype(np.float32))
    bf.create_block(f"{dataset}/RVdisp",
                    np.asarray(cat.rvdisp)[order].astype(np.float32))
    if cat.q is not None:
        bf.create_block(f"{dataset}/InitialPosition",
                        np.asarray(cat.q)[order].astype(np.float32))
