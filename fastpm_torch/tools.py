"""Offline post-processing tools (reference: src/fastpm-fof.c,
src/fastpm-rfof.c, python/*.py), run as

    python -m fastpm_torch.tools NAME ARGS

with NAME one of fof, rfof, power, pklin, gadget1, paint, cutslice,
mpgadget, halobias, comparehalos, from-gadget1 (the JAX package's
fastpm-tpu-NAME console tools) or lua (cli.main_lua, fastpm-tpu-lua).

Port of fastpm_tpu/tools.py: the same files and text on disk. The tools
that run FOF or paint take `device` (default: the first CUDA device;
they raise when there is none): fof and rfof run fof.find_halos /
rfof_find_halos (fof_link on the card), and power, paint, halobias and
comparehalos paint through Painter (the cell order and K3 on the card).
pklin, gadget1, cutslice, mpgadget and from-gadget1 are host numpy.
FOF and RFOF recover their parameters from the snapshot's stored
ParamFile attribute, with CLI overrides.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .io.bigfile import BigFile
from .io.snapshots import (read_snapshot_header, read_species,
                           write_halo_catalog)
from .cli import main_lua
from .cosmology import Cosmology
from .device import resolve_device
from .store import Store
from .diagnostics import Log

__all__ = ["main", "TOOLS", "main_fof", "main_rfof", "main_power",
           "main_pklin", "main_gadget1", "main_paint", "main_cutslice",
           "main_mpgadget", "main_halobias", "main_comparehalos",
           "main_from_gadget1", "eisenstein_hu_pk"]


def _scalar(v) -> float:
    """A header attribute (a scalar or a one-element array) as float."""
    return float(np.ravel(v)[0])


def _load_snapshot_store(path: str, device, dataset: str = "1"):
    hdr = read_snapshot_header(path)
    data = read_species(path, dataset)
    attrs = data["_attrs"]
    qsize = int(_scalar(attrs["q.size"]))
    nc = int(round(qsize ** (1 / 3.0)))

    def column(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    store = Store(
        x=column(data["x"].astype(np.float32)),
        v=column(data["v"].astype(np.float32)) if "v" in data else None,
        id=column(data["id"].reshape(-1)),
        a_x=_scalar(attrs["a.x"]), a_v=_scalar(attrs["a.v"]),
        M0=_scalar(attrs["M0"]),
        q_scale=tuple(np.ravel(attrs["q.scale"])),
        q_shift=tuple(np.ravel(attrs["q.shift"])),
        q_nc=(nc, nc, nc))
    return hdr, store


def _cosmology_from_header(hdr) -> Cosmology:
    return Cosmology(h=_scalar(hdr["HubbleParam"]),
                     Omega_m=_scalar(hdr["OmegaM"]),
                     T_cmb=0.0, growth_mode="lcdm")


def _recover_params(path: str):
    """Re-evaluate the stored ParamFile text if present."""
    hdr = read_snapshot_header(path)
    if "ParamFile" not in hdr:
        return None
    from .config.params import load_params_from_string
    try:
        return load_params_from_string(hdr["ParamFile"])
    except Exception:
        return None


def main_fof(argv=None, device=None):
    ap = argparse.ArgumentParser(
        prog="python -m fastpm_torch.tools fof",
        description="Run FOF on an existing snapshot (offline halos)")
    ap.add_argument("snapshot")
    ap.add_argument("-l", "--linking-length", type=float, default=None,
                    help="in units of mean separation (default from "
                    "ParamFile or 0.2)")
    ap.add_argument("-n", "--nmin", type=int, default=None)
    ap.add_argument("-o", "--output", default=None,
                    help="output file (default: append to the snapshot)")
    ns = ap.parse_args(argv)
    device = resolve_device(device)
    log = Log()

    from .fof import find_halos
    hdr, store = _load_snapshot_store(ns.snapshot, device)
    p = _recover_params(ns.snapshot)
    ll_frac = ns.linking_length or (p.fof_linkinglength if p else 0.2)
    nmin = ns.nmin or int(p.fof_nmin if p else 20)
    boxsize = _scalar(hdr["BoxSize"])
    nc = int(_scalar(hdr["NC"]))
    ll = ll_frac * boxsize / nc

    log.info("FOF with linking length %g (%g x mean separation), nmin %d",
             ll, ll_frac, nmin)
    cat, _ = find_halos(store.wrap(boxsize), ll, boxsize, nmin=nmin)
    out = ns.output or ns.snapshot
    dataset = "LL-%05.3f" % ll_frac
    c = _cosmology_from_header(hdr)
    write_halo_catalog(out, dataset, cat, c, store.a_x, nc, boxsize,
                       M0=store.M0)
    log.info("Writing %d objects.", cat.nhalo)
    return 0


def main_rfof(argv=None, device=None):
    ap = argparse.ArgumentParser(
        prog="python -m fastpm_torch.tools rfof",
        description="Run RFOF on an existing snapshot (offline halos)")
    ap.add_argument("snapshot")
    ap.add_argument("-o", "--output", default=None)
    ns = ap.parse_args(argv)
    device = resolve_device(device)
    log = Log()

    from .fof import rfof_find_halos
    hdr, store = _load_snapshot_store(ns.snapshot, device)
    p = _recover_params(ns.snapshot)
    boxsize = _scalar(hdr["BoxSize"])
    nc = int(_scalar(hdr["NC"]))
    sep = boxsize / nc
    c = _cosmology_from_header(hdr)
    z = 1.0 / store.a_x - 1
    kw = dict(nmin=8, linkinglength=0.2 * sep, l1=0.25 * sep,
              l6=0.24 * sep, A1=0.012 * sep, A2=0.06 * sep,
              B1=7.02, B2=6.025)
    if p is not None:
        kw = dict(nmin=int(p.rfof_nmin),
                  linkinglength=p.rfof_linkinglength * sep,
                  l1=p.rfof_l1 * sep, l6=p.rfof_l6 * sep,
                  A1=p.rfof_a1 * sep, A2=p.rfof_a2 * sep,
                  B1=p.rfof_b1, B2=p.rfof_b2)
    log.info("RFOF: assuming z = %g", z)
    cat, _ = rfof_find_halos(store.wrap(boxsize), boxsize, z, c, **kw)
    out = ns.output or ns.snapshot
    write_halo_catalog(out, "RFOF", cat, c, store.a_x, nc, boxsize,
                       M0=store.M0)
    log.info("Writing %d objects.", cat.nhalo)
    return 0


def _density_k(pm, x, boxsize, painter, overdensity=True):
    """r2c of the CIC density of positions x (host (N, 3)) in units of
    the mean (minus 1 where overdensity is set), deCIC-compensated: x
    goes to pm.device as float32, is wrapped into the box and painted
    through the painter (the cell order and K3 on the card)."""
    from . import transfers
    xw = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(
        pm.device)
    xw = xw - torch.floor(xw / boxsize) * boxsize
    rho = painter.paint(xw) / (len(x) / pm.Norm)
    if overdensity:
        rho = rho - 1.0
    return transfers.apply_decic(pm, pm.r2c(rho))


# ---- python/power.py equivalent ----

def main_power(argv=None, device=None):
    """Measure the 1D auto (or cross) power spectrum of snapshot/halo
    catalogs (python/power.py, without the nbodykit dependency).

    usage: python -m fastpm_torch.tools power out.txt cat1 [--dataset 1]
           [--with-rsd] [--nmesh 256] [-- cat2 [--dataset LL-0.200] ...]
    """
    from .mesh import PM
    from .painter import Painter
    from .powerspectrum import measure_power

    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" in argv:
        i = argv.index("--")
        argv, argv2 = argv[:i], argv[i + 1:]
    else:
        argv2 = None

    ap = argparse.ArgumentParser(prog="python -m fastpm_torch.tools power")
    ap.add_argument("output")
    ap.add_argument("--nmesh", type=int, default=256)
    cat_ap = argparse.ArgumentParser()
    cat_ap.add_argument("catalog")
    cat_ap.add_argument("--dataset", default="1")
    cat_ap.add_argument("--with-rsd", dest="rsd", action="store_true")

    # split main args from first catalog args: output [--nmesh N] cat...
    main_args = []
    rest = argv
    while rest and (not main_args or rest[0].startswith("--")):
        if rest[0] == "--nmesh":
            main_args += rest[:2]
            rest = rest[2:]
        else:
            main_args.append(rest[0])
            rest = rest[1:]
    ns = ap.parse_args(main_args)
    device = resolve_device(device)

    def load_deltak(args, pm=None):
        cns = cat_ap.parse_args(args)
        hdr = read_snapshot_header(cns.catalog)
        boxsize = _scalar(hdr["BoxSize"])
        if pm is None:
            pm = PM(ns.nmesh, boxsize, device=device)
        bf = BigFile(cns.catalog)
        x = bf.open_block(f"{cns.dataset}/Position").read_all()
        x = np.asarray(x, dtype=np.float32)
        if cns.rsd:
            v = bf.open_block(f"{cns.dataset}/Velocity").read_all()
            rsd = _scalar(hdr.get("RSDFactor", 0.0))
            x = x.copy()
            x[:, 2] += (v[:, 2] * rsd).astype(np.float32)
        dk = _density_k(pm, x, boxsize, Painter(pm, "cic", 2))
        return pm, dk, len(x)

    pm, dk1, n1 = load_deltak(rest)
    dk2 = None
    if argv2:
        _, dk2, _ = load_deltak(argv2, pm)
    ps = measure_power(pm, dk1, dk2)
    shotnoise = pm.BoxSize[0] ** 3 / n1 if dk2 is None else 0.0
    good = ps.Nmodes > 0
    with open(ns.output, "w") as f:
        f.write("# k p N\n")
        for k, p, n in zip(ps.k[good], ps.p[good], ps.Nmodes[good]):
            f.write("%.8e %.8e %d\n" % (k, p, int(n)))
        f.write("# metadata: shotnoise %g volume %g\n"
                % (shotnoise, pm.BoxSize[0] ** 3))
    print("wrote %s (%d bins)" % (ns.output, int(good.sum())))
    return 0


# ---- python/make-pklin.py equivalent ----

def eisenstein_hu_pk(k, h=0.6774, Omega_m=0.307494, Omega_b=0.0486,
                     ns_index=0.9667, T_cmb=2.7255):
    """Eisenstein & Hu (1998, ApJ 496, 605) transfer function with
    baryon wiggles; returns an UN-normALIZED P(k) = k^ns T(k)^2.
    (The reference generates its input P(k) with nbodykit/CLASS,
    python/make-pklin.py; this is the self-contained analytic stand-in.)
    """
    k = np.asarray(k, dtype=np.float64)
    om, ob = Omega_m, Omega_b
    oc = om - ob
    theta = T_cmb / 2.7
    omh2, obh2 = om * h * h, ob * h * h
    fb, fc = ob / om, oc / om

    # sound horizon & equality (EH98 eqs 2-6)
    zeq = 2.50e4 * omh2 / theta ** 4
    keq = 7.46e-2 * omh2 / theta ** 2          # Mpc^-1
    b1 = 0.313 * omh2 ** -0.419 * (1 + 0.607 * omh2 ** 0.674)
    b2 = 0.238 * omh2 ** 0.223
    zd = 1291.0 * omh2 ** 0.251 / (1 + 0.659 * omh2 ** 0.828) \
        * (1 + b1 * obh2 ** b2)
    Rd = 31.5 * obh2 / theta ** 4 / (zd / 1e3)
    Req = 31.5 * obh2 / theta ** 4 / (zeq / 1e3)
    s = 2.0 / (3 * keq) * np.sqrt(6 / Req) * np.log(
        (np.sqrt(1 + Rd) + np.sqrt(Rd + Req)) / (1 + np.sqrt(Req)))
    ksilk = 1.6 * obh2 ** 0.52 * omh2 ** 0.73 \
        * (1 + (10.4 * omh2) ** -0.95)

    kmpc = k * h                                # 1/Mpc
    q = kmpc / (13.41 * keq)

    # CDM part (eqs 9-12, 17-20)
    a1 = (46.9 * omh2) ** 0.670 * (1 + (32.1 * omh2) ** -0.532)
    a2 = (12.0 * omh2) ** 0.424 * (1 + (45.0 * omh2) ** -0.582)
    alpha_c = a1 ** -fb * a2 ** (-fb ** 3)
    bb1 = 0.944 / (1 + (458 * omh2) ** -0.708)
    bb2 = (0.395 * omh2) ** -0.0266
    beta_c = 1.0 / (1 + bb1 * (fc ** bb2 - 1))

    def T0(q, ac, bc):
        C = 14.2 / ac + 386.0 / (1 + 69.9 * q ** 1.08)
        return np.log(np.e + 1.8 * bc * q) / (
            np.log(np.e + 1.8 * bc * q) + C * q * q)

    f = 1.0 / (1 + (kmpc * s / 5.4) ** 4)
    Tc = f * T0(q, 1.0, beta_c) + (1 - f) * T0(q, alpha_c, beta_c)

    # baryon part (eqs 13-24)
    y = (1 + zeq) / (1 + zd)
    Gy = y * (-6 * np.sqrt(1 + y)
              + (2 + 3 * y) * np.log(
                  (np.sqrt(1 + y) + 1) / (np.sqrt(1 + y) - 1)))
    alpha_b = 2.07 * keq * s * (1 + Rd) ** -0.75 * Gy
    beta_b = 0.5 + fb + (3 - 2 * fb) * np.sqrt((17.2 * omh2) ** 2 + 1)
    beta_node = 8.41 * omh2 ** 0.435
    stilde = s / (1 + (beta_node / (kmpc * s)) ** 3) ** (1.0 / 3)
    x = kmpc * stilde
    jo = np.where(x > 1e-8, np.sin(x) / np.where(x > 1e-8, x, 1.0), 1.0)
    Tb = (T0(q, 1.0, 1.0) / (1 + (kmpc * s / 5.2) ** 2)
          + alpha_b / (1 + (beta_b / (kmpc * s)) ** 3)
          * np.exp(-(kmpc / ksilk) ** 1.4)) * jo

    T = fb * Tb + fc * Tc
    return np.where(k > 0, k ** ns_index * T * T, 0.0)


def main_pklin(argv=None):
    """Generate a linear P(k) table (python/make-pklin.py equivalent,
    Eisenstein-Hu 1998 instead of CLASS), normalized to sigma8."""
    from .powerspectrum import FuncK, sigma_tophat

    ap = argparse.ArgumentParser(prog="python -m fastpm_torch.tools pklin")
    ap.add_argument("output")
    ap.add_argument("--h", type=float, default=0.6774)
    ap.add_argument("--Omega-m", dest="Om", type=float, default=0.307494)
    ap.add_argument("--Omega-b", dest="Ob", type=float, default=0.0486)
    ap.add_argument("--ns", type=float, default=0.9667)
    ap.add_argument("--sigma8", type=float, default=0.8159)
    ns = ap.parse_args(argv)

    k = np.logspace(-3, 2, 10000)
    p = eisenstein_hu_pk(k, h=ns.h, Omega_m=ns.Om, Omega_b=ns.Ob,
                         ns_index=ns.ns)
    s8 = sigma_tophat(FuncK(k, p), 8.0)
    p *= (ns.sigma8 / s8) ** 2
    np.savetxt(ns.output, np.array([k, p]).T)
    print("wrote %s (sigma8 = %g)" % (ns.output, ns.sigma8))
    return 0


# ---- python/convert-to-gadget-1.py equivalent ----

_GADGET1_HEADER = np.dtype([
    ("Npart", ("u4", 6)), ("Massarr", ("f8", 6)),
    ("Time", "f8"), ("Redshift", "f8"),
    ("FlagSfr", "i4"), ("FlagFeedback", "i4"),
    ("Nall", ("u4", 6)), ("FlagCooling", "i4"),
    ("NumFiles", "i4"), ("BoxSize", "f8"),
    ("Omega0", "f8"), ("OmegaLambda", "f8"), ("HubbleParam", "f8"),
    ("FlagAge", "i4"), ("FlagMetals", "i4"),
    ("NallHW", ("u4", 6)), ("flag_entr_ics", "i4")])


def _gadget1_write_block(arr: np.ndarray, f):
    nbytes = np.int32(arr.size * arr.dtype.itemsize)
    nbytes.tofile(f)
    arr.tofile(f)
    nbytes.tofile(f)


def main_gadget1(argv=None):
    """Convert a snapshot to Gadget-1 binary files
    (python/convert-to-gadget-1.py): F77 record blocks
    [header(256) pos vel id], velocity = peculiar / sqrt(a)."""
    import os

    ap = argparse.ArgumentParser(prog="python -m fastpm_torch.tools gadget1")
    ap.add_argument("source")
    ap.add_argument("dest")
    ap.add_argument("--nperfile", type=int, default=1024 * 1024)
    ap.add_argument("--precision", default="f4")
    ns = ap.parse_args(argv)

    hdr = read_snapshot_header(ns.source)
    bf = BigFile(ns.source)
    pos = bf.open_block("1/Position").read_all()
    vel = bf.open_block("1/Velocity").read_all()
    pid = bf.open_block("1/ID").read_all().reshape(-1)
    ntot = len(pos)
    a = float(hdr["Time"])

    g = np.zeros((), dtype=_GADGET1_HEADER)
    g["Time"] = a
    g["Redshift"] = 1.0 / a - 1
    # TotNumPart is the MP-Gadget per-type array [0, N, 0...]
    tot = int(np.sum(hdr["TotNumPart"])) if "TotNumPart" in hdr else ntot
    g["Nall"][1] = np.uint32(tot & 0xFFFFFFFF)
    g["NallHW"][1] = np.uint32(tot >> 32)
    g["BoxSize"] = float(hdr["BoxSize"])
    g["HubbleParam"] = float(hdr["HubbleParam"])
    g["Omega0"] = float(hdr.get("Omega0", hdr.get("OmegaM", 0.0)))
    g["OmegaLambda"] = float(hdr["OmegaLambda"])
    mt = hdr.get("MassTable")
    if mt is not None:
        g["Massarr"][:] = np.asarray(mt, dtype=np.float64)[:6]

    nfile = max(ntot // ns.nperfile, 1)
    g["NumFiles"] = nfile
    dirname = os.path.dirname(os.path.abspath(ns.dest))
    os.makedirs(dirname, exist_ok=True)
    for i in range(nfile):
        start = i * ntot // nfile
        end = (i + 1) * ntot // nfile
        h = g.copy()
        h["Npart"][1] = end - start
        pad = np.zeros(256 - _GADGET1_HEADER.itemsize, dtype="u1")
        with open("%s.%d" % (ns.dest, i), "wb") as f:
            nb = np.int32(256)
            nb.tofile(f); h.tofile(f); pad.tofile(f); nb.tofile(f)
            _gadget1_write_block(
                np.ascontiguousarray(pos[start:end], dtype=ns.precision), f)
            # gadget-1 velocity convention: u = v_peculiar / sqrt(a)
            _gadget1_write_block(np.ascontiguousarray(
                vel[start:end] * a ** -0.5, dtype=ns.precision), f)
            _gadget1_write_block(
                np.ascontiguousarray(pid[start:end], dtype="u8"), f)
    print("wrote %d gadget-1 file(s), %d particles" % (nfile, ntot))
    return 0


# ---- python/paint-dm.py equivalent ----

def main_paint(argv=None, device=None):
    """Paint a snapshot/halo catalog onto a mesh and write the real
    field (python/paint-dm.py; CIC + deCIC here instead of nbodykit's
    interlaced TSC)."""
    from .mesh import PM
    from .painter import Painter

    ap = argparse.ArgumentParser(prog="python -m fastpm_torch.tools paint")
    ap.add_argument("output")
    ap.add_argument("catalog")
    ap.add_argument("--dataset", default="1")
    ap.add_argument("--output-dataset", default=None)
    ap.add_argument("--nmesh", type=int, default=256)
    ns = ap.parse_args(argv)
    device = resolve_device(device)

    hdr = read_snapshot_header(ns.catalog)
    boxsize = _scalar(hdr["BoxSize"])
    bf = BigFile(ns.catalog)
    x = bf.open_block(f"{ns.dataset}/Position").read_all()
    pm = PM(ns.nmesh, boxsize, device=device)
    dk = _density_k(pm, x, boxsize, Painter(pm, "cic", 2),
                    overdensity=False)
    delta1 = pm.c2r(dk).cpu().numpy()

    dsname = ns.output_dataset or ("N%04d" % ns.nmesh)
    out = BigFile(ns.output, create=True)
    blk = out.create_block(dsname, delta1.reshape(-1, 1).astype("f4"))
    blk.attrs.set("ndarray.ndim", np.int32(3), "i4")
    blk.attrs.set("ndarray.shape",
                  np.array([ns.nmesh] * 3, dtype="i8"), "i8")
    blk.attrs.set("BoxSize", np.array([boxsize] * 3), "f8")
    blk.attrs.set("Nmesh", np.int64(ns.nmesh), "i8")
    print("painted %d objects onto %d^3 -> %s/%s"
          % (len(x), ns.nmesh, ns.output, dsname))
    return 0


# ---- python/cutslice.py equivalent ----

def main_cutslice(argv=None):
    """Cut a slab of particles around one halo (python/cutslice.py)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" in argv:
        i = argv.index("--")
        argv, argv2 = argv[:i], argv[i + 1:]
    else:
        raise SystemExit("usage: python -m fastpm_torch.tools cutslice "
                         "out halocat "
                         "[--dataset LL-0.200] [--haloid N] "
                         "[--thickness T] [--los z] -- cat [--dataset 1]")

    ap = argparse.ArgumentParser(prog="python -m fastpm_torch.tools cutslice")
    ap.add_argument("output")
    ap.add_argument("halocat")
    ap.add_argument("--dataset", default="LL-0.200")
    ap.add_argument("--output-dataset", default=None)
    ap.add_argument("--haloid", type=int, default=5)
    ap.add_argument("--los", default="z", choices=["x", "y", "z"])
    ap.add_argument("--thickness", type=float, default=10.0)
    ns = ap.parse_args(argv)
    cap = argparse.ArgumentParser()
    cap.add_argument("catalog")
    cap.add_argument("--dataset", default="1")
    cns = cap.parse_args(argv2)

    hbf = BigFile(ns.halocat)
    hpos = hbf.open_block(f"{ns.dataset}/Position").read_all()
    if ns.haloid >= len(hpos):
        raise SystemExit(f"haloid {ns.haloid} out of range ({len(hpos)})")
    center = hpos[ns.haloid]
    d = "xyz".index(ns.los)

    hdr = read_snapshot_header(cns.catalog)
    boxsize = float(hdr["BoxSize"])
    bf = BigFile(cns.catalog)
    x = bf.open_block(f"{cns.dataset}/Position").read_all()
    dist = np.abs(x[:, d] - center[d])
    dist = np.minimum(dist, boxsize - dist)
    sel = dist <= 0.5 * ns.thickness

    dsname = ns.output_dataset or ("SLICE-%d" % ns.haloid)
    out = BigFile(ns.output, create=True)
    blocks = [("Position", x[sel].astype("f4"))]
    for name, dt in (("Velocity", "f4"), ("ID", "i8")):
        try:
            col = bf.open_block(f"{cns.dataset}/{name}").read_all()
            blocks.append((name, col[sel].astype(dt)))
        except FileNotFoundError:
            pass
    for name, arr in blocks:
        out.create_block(f"{dsname}/{name}", arr)
    root = out.open_block(dsname)
    root.attrs.set("center", np.asarray(center, dtype="f8"), "f8")
    root.attrs.set("thickness", float(ns.thickness), "f8")
    root.attrs.set("los", np.int32(d), "i4")
    print("wrote %d particles in slice around halo %d -> %s/%s"
          % (int(sel.sum()), ns.haloid, ns.output, dsname))
    return 0


# ---- python/convert-to-mpgadget.py equivalent ----

def main_mpgadget(argv=None):
    """Copy Position/Velocity/ID into an MP-Gadget-style bigfile and add
    the per-particle Mass column (python/convert-to-mpgadget.py)."""
    ap = argparse.ArgumentParser(prog="python -m fastpm_torch.tools mpgadget")
    ap.add_argument("source")
    ap.add_argument("dest")
    ns = ap.parse_args(argv)

    src = BigFile(ns.source)
    dst = BigFile(ns.dest, create=True)
    hdr = src.open_block("Header").attrs
    npart = None
    for name in ("Position", "Velocity", "ID"):
        arr = src.open_block(f"1/{name}").read_all()
        dst.create_block(f"1/{name}", arr)
        npart = len(arr)
    mt = np.asarray(hdr.get("MassTable"))
    mass = np.full(npart, mt[1], dtype="f4")
    dst.create_block("1/Mass", mass)
    h = dst.create_block("Header")
    for key in hdr.keys():
        v = hdr.get(key)
        if isinstance(v, str):
            continue   # text attrs (ParamFile) are fastpm-specific
        v = np.atleast_1d(np.asarray(v))
        dt = {"f": "f8", "i": "i8", "u": "i8"}.get(v.dtype.kind)
        if dt:
            h.attrs.set(key, v, dt)
    print("converted %d particles -> %s" % (npart, ns.dest))
    return 0


# ---- python/halobias.py equivalent ----

def main_halobias(argv=None, device=None):
    """Halo bias from the halo-matter cross spectrum:
    b(k) = P_hm / P_mm on large scales (python/halobias.py without the
    Kaiser-model fit; bias per halo-mass bin via --nmin/--nmax/--nn)."""
    from .mesh import PM
    from .painter import Painter
    from .powerspectrum import measure_power

    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" in argv:
        i = argv.index("--")
        argv, argv2 = argv[:i], argv[i + 1:]
    else:
        raise SystemExit("usage: python -m fastpm_torch.tools halobias "
                         "out dmcat [--dataset 1] -- halocat "
                         "[--dataset LL-0.200]")

    ap = argparse.ArgumentParser(
        prog="python -m fastpm_torch.tools halobias")
    ap.add_argument("output")
    ap.add_argument("catalog")
    ap.add_argument("--dataset", default="1")
    ap.add_argument("--nmesh", type=int, default=256)
    ap.add_argument("--nmin", type=int, default=8)
    ap.add_argument("--nmax", type=int, default=1000)
    ap.add_argument("--nn", type=int, default=10)
    ap.add_argument("--kmax", type=float, default=0.04)
    ns = ap.parse_args(argv)
    hap = argparse.ArgumentParser()
    hap.add_argument("catalog")
    hap.add_argument("--dataset", default="LL-0.200")
    hns = hap.parse_args(argv2)
    device = resolve_device(device)

    hdr = read_snapshot_header(ns.catalog)
    boxsize = _scalar(hdr["BoxSize"])
    pm = PM(ns.nmesh, boxsize, device=device)
    painter = Painter(pm, "cic", 2)

    bf = BigFile(ns.catalog)
    xm = bf.open_block(f"{ns.dataset}/Position").read_all()
    dk_m = _density_k(pm, xm, boxsize, painter)
    ps_mm = measure_power(pm, dk_m)

    hbf = BigFile(hns.catalog)
    xh = hbf.open_block(f"{hns.dataset}/Position").read_all()
    length = hbf.open_block(f"{hns.dataset}/Length").read_all()

    edges = np.unique(np.geomspace(ns.nmin, ns.nmax, ns.nn + 1)
                      .astype(int))
    rows = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        sel = (length >= lo) & (length < hi)
        if sel.sum() < 2:
            continue
        dk_h = _density_k(pm, xh[sel], boxsize, painter)
        ps_hm = measure_power(pm, dk_h, dk_m)
        good = (ps_mm.Nmodes > 0) & (ps_mm.k < ns.kmax) & (ps_mm.p > 0)
        b = float(np.sum(ps_hm.p[good] * ps_mm.Nmodes[good])
                  / np.sum(ps_mm.p[good] * ps_mm.Nmodes[good]))
        rows.append((lo, hi, int(sel.sum()), b))
    with open(ns.output, "w") as f:
        f.write("# nmin nmax nhalo bias\n")
        for r in rows:
            f.write("%d %d %d %.6f\n" % r)
    for r in rows:
        print("halos %d-%d (%d): b = %.3f" % r)
    return 0


def main_comparehalos(argv=None, device=None):
    """Compare two (halo) catalogs by auto and cross (k, mu) power in
    redshift space at abundance-matched nmin thresholds
    (python/comparehalos.py). Usage:

      python -m fastpm_torch.tools comparehalos out.txt cat1
          [--dataset D] -- cat2 [--dataset D]

    For each nmin in a logspaced ladder, selects cat1 halos with
    Length >= nmin, bisects cat2's threshold to match the count
    (read_cat_nsel), and writes r1/r2/rx wedge spectra to
    out-nmin-XXXXX-{r1,r2,rx}.txt with columns k mu power Nmodes."""
    from .mesh import PM
    from .painter import Painter
    from .powerspectrum import measure_power_2d

    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" in argv:
        i = argv.index("--")
        argv, argv2 = argv[:i], argv[i + 1:]
    else:
        argv2 = None

    ap = argparse.ArgumentParser(
        prog="python -m fastpm_torch.tools comparehalos")
    ap.add_argument("output")
    ap.add_argument("catalog")
    ap.add_argument("--dataset", default="LL-0.200")
    ap.add_argument("--nmin", type=int, default=8)
    ap.add_argument("--nmax", type=int, default=1000)
    ap.add_argument("--nn", type=int, default=10)
    ap.add_argument("--nmesh", type=int, default=256)
    ap.add_argument("--Nmu", type=int, default=10)
    ns = ap.parse_args(argv)
    if argv2 is not None:
        hap = argparse.ArgumentParser()
        hap.add_argument("catalog")
        hap.add_argument("--dataset", default="LL-0.200")
        ns2 = hap.parse_args(argv2)
    else:
        ns2 = ns
    device = resolve_device(device)

    def read_cat(path, dataset):
        hdr = read_snapshot_header(path)
        bf = BigFile(path)
        x = bf.open_block(f"{dataset}/Position").read_all()
        v = bf.open_block(f"{dataset}/Velocity").read_all()
        length = (bf.open_block(f"{dataset}/Length").read_all()
                  if bf.has_block(f"{dataset}/Length") else None)
        rsd = _scalar(hdr.get("RSDFactor", 0.0))
        xr = np.array(x, dtype=np.float64)
        xr[:, 2] += rsd * v[:, 2]
        return xr, length, _scalar(hdr["BoxSize"])

    x1, len1, box = read_cat(ns.catalog, ns.dataset)
    x2, len2, _ = read_cat(ns2.catalog, ns2.dataset)

    pm = PM(ns.nmesh, box, device=device)
    painter = Painter(pm, "cic", 2)

    nmins = np.unique(np.int32(np.geomspace(ns.nmin, ns.nmax, ns.nn)))
    if len1 is not None:
        nmins = nmins[(nmins >= len1.min()) & (nmins < len1.max())]
    else:
        nmins = np.array([0])

    def match_nsel(length, nsel):
        """Bisect the threshold so len(sel) best matches nsel
        (read_cat_nsel)."""
        if length is None:
            return np.ones(len(x2), bool)
        lo, hi = int(length.min()), int(length.max())
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if (length >= mid).sum() < nsel:
                hi = mid
            else:
                lo = mid
        return length >= lo

    base = ns.output.rsplit(".", 1)[0]
    for nmin1 in nmins:
        sel1 = (len1 >= nmin1) if len1 is not None \
            else np.ones(len(x1), bool)
        if sel1.sum() < 2:
            continue
        sel2 = match_nsel(len2, int(sel1.sum()))
        dk1 = _density_k(pm, x1[sel1], box, painter)
        dk2 = _density_k(pm, x2[sel2], box, painter)
        specs = dict(r1=measure_power_2d(pm, dk1, Nmu=ns.Nmu),
                     r2=measure_power_2d(pm, dk2, Nmu=ns.Nmu),
                     rx=measure_power_2d(pm, dk1, dk2, Nmu=ns.Nmu))
        for tag, r in specs.items():
            path = "%s-nmin-%05d-%s.txt" % (base, nmin1, tag)
            cols = np.stack([r["k"].ravel(), r["mu"].ravel(),
                             r["power"].ravel(),
                             r["Nmodes"].ravel()], axis=-1)
            np.savetxt(path, cols, header="k mu power Nmodes")
        print("nmin = %d (n1=%d n2=%d) finished"
              % (nmin1, int(sel1.sum()), int(sel2.sum())))
    return 0


# ---- python/convert-from-gadget-1.py equivalent ----

def main_from_gadget1(argv=None):
    """Convert Gadget-1 binary files back into a bigfile snapshot
    (python/convert-from-gadget-1.py): velocity u*sqrt(a) -> peculiar,
    Nall+NallHW -> TotNumPart."""
    import glob

    ap = argparse.ArgumentParser(prog="python -m fastpm_torch.tools from-gadget1")
    ap.add_argument("source", help="gadget file base (reads base.N)")
    ap.add_argument("dest")
    ap.add_argument("--precision", default="f4")
    ns = ap.parse_args(argv)

    files = sorted(glob.glob(ns.source + ".*"),
                   key=lambda s: int(s.rsplit(".", 1)[1]))
    if not files:
        files = [ns.source]
    pos_l, vel_l, id_l = [], [], []
    hdr0 = None
    for fn in files:
        with open(fn, "rb") as f:
            nb = np.fromfile(f, "i4", 1)[0]
            assert nb == 256, f"bad header record in {fn}"
            hdr = np.frombuffer(f.read(256), dtype=np.uint8)
            assert np.fromfile(f, "i4", 1)[0] == 256
            g = np.frombuffer(hdr.tobytes()[:_GADGET1_HEADER.itemsize],
                              dtype=_GADGET1_HEADER)[0]
            if hdr0 is None:
                hdr0 = g
            for lst, dt, ncol in ((pos_l, ns.precision, 3),
                                  (vel_l, ns.precision, 3),
                                  (id_l, "u8", 1)):
                nb = np.fromfile(f, "i4", 1)[0]
                arr = np.fromfile(f, dt, nb // np.dtype(dt).itemsize)
                assert np.fromfile(f, "i4", 1)[0] == nb
                lst.append(arr.reshape(-1, ncol) if ncol > 1 else arr)

    a = float(hdr0["Time"])
    pos = np.concatenate(pos_l)
    vel = np.concatenate(vel_l) * np.sqrt(a)   # gadget u -> peculiar
    pid = np.concatenate(id_l)
    tot = (np.int64(hdr0["Nall"][1])
           + (np.int64(hdr0["NallHW"][1]) << 32))

    bf = BigFile(ns.dest, create=True)
    bf.create_block("1/Position", pos.astype("f4"))
    bf.create_block("1/Velocity", vel.astype("f4"))
    bf.create_block("1/ID", pid.astype("i8"))
    h = bf.create_block("Header")
    h.attrs.set("BoxSize", float(hdr0["BoxSize"]), "f8")
    h.attrs.set("Time", a, "f8")
    h.attrs.set("ScalingFactor", a, "f8")
    h.attrs.set("MassTable",
                np.asarray(hdr0["Massarr"], dtype="f8"), "f8")
    h.attrs.set("TotNumPart",
                np.array([0, tot, 0, 0, 0, 0], dtype="i8"), "i8")
    h.attrs.set("HubbleParam", float(hdr0["HubbleParam"]), "f8")
    h.attrs.set("Omega0", float(hdr0["Omega0"]), "f8")
    h.attrs.set("OmegaLambda", float(hdr0["OmegaLambda"]), "f8")
    print("converted %d particles from %d file(s) -> %s"
          % (len(pos), len(files), ns.dest))
    return 0


# NAME -> (entry, takes a device)
TOOLS = {
    "fof": (main_fof, True), "rfof": (main_rfof, True),
    "power": (main_power, True), "pklin": (main_pklin, False),
    "gadget1": (main_gadget1, False), "paint": (main_paint, True),
    "cutslice": (main_cutslice, False), "mpgadget": (main_mpgadget, False),
    "halobias": (main_halobias, True),
    "comparehalos": (main_comparehalos, True),
    "from-gadget1": (main_from_gadget1, False), "lua": (main_lua, False),
}


def main(argv=None, device=None):
    """python -m fastpm_torch.tools NAME ARGS: run tool NAME on ARGS (the
    device tools on `device`, default the first CUDA device)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in TOOLS:
        print("usage: python -m fastpm_torch.tools NAME ARGS, NAME one of: "
              + " ".join(TOOLS), file=sys.stderr)
        return 2
    entry, on_device = TOOLS[argv[0]]
    if on_device:
        return entry(argv[1:], device=device)
    return entry(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
